"""host_ms_per_call.gapfill: host_ms_per_call (host_ms_per_call.py) in the
gap-fill cell.  That cell has no steady rate or tail end to end, so
there it moves setup_s, whose warm-up is one pass of the same calls."""

from gpubench.manifest import reader

read = reader("host_ms_per_call")
