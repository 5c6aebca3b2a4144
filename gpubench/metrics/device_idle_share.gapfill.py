"""device_idle_share.gapfill: device_idle_share (device_idle_share.py) in the
gap-fill cell.  That cell has no steady rate or tail end to end, so
there it moves setup_s, whose warm-up is one pass of the same calls."""

from gpubench.manifest import reader

read = reader("device_idle_share")
