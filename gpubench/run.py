"""Run one cell of the port's benchmark once and print its result line.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout.  The last line of standard output is the
result (JSON); the numbers compared for `correct` and their limits are
the last lines of standard error.  Exits 2 without a result where the
machine lacks the cell's cards, and 1 where a run loads JAX or the JAX
package (gpubench/guard.py) or fails.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one process with few threads: the engines' host work is one Python
# thread, and idle thread pools only add noise to its timing
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    if sys.path and os.path.abspath(sys.path[0]) == os.path.join(
            ROOT, "gpubench"):
        sys.path.pop(0)
    sys.path.insert(0, ROOT)
    from gpubench import guard, harness

    try:
        result = harness.run_cell(a.workload, a.seed, a.seconds,
                                  bool(a.trace), T_START)
    except harness.NoDevice as exc:
        print(f"gpubench: {exc}", file=sys.stderr)
        return 2
    found = guard.forbidden_modules()
    if found:
        print("gpubench: the run loaded " + ", ".join(found),
              file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
