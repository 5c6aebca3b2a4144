"""traced_bases_per_s.gapfill: traced_bases_per_s
(traced_bases_per_s.py) in the gap-fill cell.  That cell has no steady
rate or tail end to end, so there it moves setup_s, whose warm-up is one
pass of the same calls."""

from gpubench.manifest import reader

read = reader("traced_bases_per_s")
