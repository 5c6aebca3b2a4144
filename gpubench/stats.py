"""The statistics of a window: rate, tail, spread."""

from __future__ import annotations

import json
import math
import statistics
import sys


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest value that at
    least 95% of the values do not exceed."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def rate(total: float, seconds: float) -> float:
    """Work over all the time of the window."""
    if seconds <= 0:
        raise ValueError("an empty window")
    return total / seconds


def spread(values) -> float:
    """Interquartile distance over the median, as statistics.quantiles
    gives the quartiles (the contract's measure of a metric's spread)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def last_line(path: str) -> dict:
    with open(path) as fh:
        return json.loads(fh.read().strip().splitlines()[-1])


def bounds(sets) -> dict:
    """For two sets of runs (lists of result-line files), each metric's
    medians, spreads and five times the wider spread (the bound the
    contract asks for, before its floor of 1%)."""
    out = {}
    lines = [[last_line(p) for p in paths] for paths in sets]
    for name in lines[0][0]["metrics"]:
        vals = [[r["metrics"][name]["value"] for r in s] for s in lines]
        spreads = [spread(v) for v in vals]
        out[name] = {"medians": [statistics.median(v) for v in vals],
                     "spreads": spreads, "five_x": 5 * max(spreads)}
    return out


if __name__ == "__main__":
    # python3 gpubench/stats.py SET_A_FILES... -- SET_B_FILES...
    args = sys.argv[1:]
    cut = args.index("--") if "--" in args else len(args)
    sets = [s for s in (args[:cut], args[cut + 1:]) if s]
    print(json.dumps(bounds(sets), indent=1))
