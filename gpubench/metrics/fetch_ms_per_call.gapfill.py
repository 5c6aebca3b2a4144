"""fetch_ms_per_call.gapfill: fetch_ms_per_call
(fetch_ms_per_call.py) in the gap-fill cell.  That cell has no steady
rate or tail end to end, so there it moves setup_s, whose warm-up is one
pass of the same calls."""

from gpubench.manifest import reader

read = reader("fetch_ms_per_call")
