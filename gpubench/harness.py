"""One run of one cell: set-up, the measured window, the check, the line.

The loop is closed and has one caller, as blast, BAR and the nested
refinement call the engines: the next call goes out when the last one's
answers are on the host.  A pass is the workload's calls in their
recorded order; passes cycle through the input variants.

- setup_s: from the start of the process (before torch is imported) to
  the start of the window: imports, the kernels' build or load, the
  inputs made from the seed, one pass over every call (every shape the
  window uses).
- aligned_bases_per_s: query plus target bases of every call whose
  answers came back in the window, over the window's wall seconds (it
  ends when the last call ends).
- call_p95_ms: the 95th percentile (nearest rank) of all the window's
  call latencies, from the call to its answers on the host.
- device_peak_mib: torch.cuda.max_memory_allocated over the window,
  after reset_peak_memory_stats at its start.

A cell reports the end-to-end metrics whose `workloads` name it: where a
rate or tail spreads past the largest bound from run to run, the cell
reads it per layer instead, from the traced window (traced_*).

With --trace 1 the window is traced by torch.profiler and lasts whole
passes, at least min(--seconds, TRACE_WINDOW_S); the per-layer metrics
are read from it by gpubench/metrics/<name>.py.

In the window, the answer of each sampled pair (the longest pair of
every call and `sample_pairs` more per variant, drawn from the seed) is
kept the first time its variant comes round; every later pass's answer
is held against the kept ones and kept only where it differs (up to
MAX_DISTINCT a pair), so the harness's heap does not grow with the
window.  After the window: the device peak is read, the program's state
freed, and every kept answer is compared with the plain reference
(gpubench/reference/); an answer of a later pass equal to a kept one is
counted as compared with it.
Each number compared and its limit (the traffic file's `checks`) is
printed as the last lines of standard error and under "checks", the
last key of the result line.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import subprocess
import sys
import time
import traceback
from types import SimpleNamespace

from . import manifest, stats, tracing, traffic

TRACE_WINDOW_S = 5.0
SAMPLE_STREAM = 1_000_003
MAX_DISTINCT = 16
MIB = 1 << 20


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


def check_device(chips: int):
    import torch
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} cards, the cell asks "
                       f"for {chips}")
    return torch.device("cuda", 0)


def power_limit_w():
    """The card's power limit by nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def choose_sample(workload: dict, variants, seed: int):
    """{(variant, call): [pair index]}: in every variant the longest pair
    (query plus target) of every call and `sample_pairs` more drawn from
    the seed over all the pass's pairs."""
    k = int(workload["sample_pairs"])
    rng = traffic.rng_for(seed, SAMPLE_STREAM)
    out = {}
    for v, calls in enumerate(variants):
        flat = [(c, i) for c, pairs in enumerate(calls)
                for i in range(len(pairs))]
        pick = set()
        for c, pairs in enumerate(calls):
            pick.add((c, max(range(len(pairs)),
                             key=lambda i: len(pairs[i][0]) + len(pairs[i][1]))))
        for j in rng.choice(len(flat), size=min(k, len(flat)),
                            replace=False):
            pick.add(flat[int(j)])
        for c, i in sorted(pick):
            out.setdefault((v, c), []).append(i)
    return out


def launch_cells(args, kwargs) -> int:
    """P x M x band of one launch of a pair engine's wrapper: its first
    argument is (P, M), its band a keyword."""
    q = args[0]
    return int(q.shape[0]) * int(q.shape[1]) * int(kwargs["band"])


@contextlib.contextmanager
def shape_counter(target, ctx, cells=launch_cells):
    """Wrap the driver's launch wrapper to add the cells of each launch,
    cells(args, kwargs), to ctx.computed_cells."""
    mod = importlib.import_module(target[0])
    fn = getattr(mod, target[1])

    def counted(*a, **k):
        ctx.computed_cells += cells(a, k)
        return fn(*a, **k)

    setattr(mod, target[1], counted)
    try:
        yield
    finally:
        setattr(mod, target[1], fn)


def keep(kept_pair, answer):
    """Keep an answer of a sampled pair unless it equals one kept before
    (a sound program repeats its answer for the same inputs).  Answers
    compare with `==` to a bool (drivers/__init__.py)."""
    if len(kept_pair) < MAX_DISTINCT and not any(
            answer == seen for seen in kept_pair):
        kept_pair.append(answer)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, root=manifest.ROOT, log=None):
    """The result line of one run (a dict).  device None: the first
    card, after check_device (the tests pass the CPU)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    bench = manifest.load(root)
    entry, config, workload = manifest.cell(name, bench, root)
    if device is None:
        device = check_device(entry["chips"])
    import torch
    from cactus_tpu_torch.ops import cuda_build

    drv = manifest.driver(workload).Driver(config, workload, device)
    calls = workload["calls"]
    call_bases = [traffic.call_bases(spec) for spec in calls]
    variants = traffic.make_variants(workload, seed)
    sample = choose_sample(workload, variants, seed)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    for c, spec in enumerate(calls):          # every shape of the window
        drv.call(spec, variants[0][c])
    sync()

    # the inputs, live through the window: out of the collector's scans
    gc.collect()
    gc.freeze()
    ctx = SimpleNamespace(computed_cells=0)
    kept = {key: {i: [] for i in idxs} for key, idxs in sample.items()}
    passes = dict.fromkeys(sample, 0)
    latencies, done, bases, failed = [], [], 0, 0
    prof = None
    stack = contextlib.ExitStack()
    if trace:
        stack.enter_context(tracing.spans(drv.spans))
        stack.enter_context(shape_counter(
            drv.launch, ctx, getattr(drv, "launch_cells", launch_cells)))
        act = torch.profiler.ProfilerActivity
        prof = torch.profiler.profile(
            activities=[act.CPU] + ([act.CUDA] if on_card else []))
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    cuda_build.reset_launches()
    window = min(seconds, TRACE_WINDOW_S) if trace else seconds
    with stack:
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        k = 0
        pass_ends = [t0]
        while True:
            c = k % len(calls)
            if c == 0 and k:
                pass_ends.append(time.perf_counter())
            if time.perf_counter() - t0 >= window and (not trace or c == 0):
                break
            v = (k // len(calls)) % len(variants)
            pairs = variants[v][c]
            a = time.perf_counter()
            try:
                with tracing.record(trace):
                    answers = drv.call(calls[c], pairs)
            except Exception:        # a failed call counts as failed
                failed += 1
                answers = None
                if failed == 1:
                    log(traceback.format_exc())
            b = time.perf_counter()
            latencies.append(b - a)
            if answers is not None:
                bases += call_bases[c]
                if (v, c) in kept:
                    passes[(v, c)] += 1
                    for i, kept_pair in kept[(v, c)].items():
                        # an answer that never came is None: wrong
                        keep(kept_pair,
                             answers[i] if i < len(answers) else None)
                if trace:
                    done.append((c, answers))
            k += 1
        sync()
        window_s = time.perf_counter() - t0
        if prof is not None:
            prof.stop()
    gc.unfreeze()
    walls = sorted(b - a for a, b in zip(pass_ends, pass_ends[1:]))
    if walls:
        log(f"{len(walls)} whole passes, {walls[0]:.4f} / "
            f"{walls[len(walls) // 2]:.4f} / {walls[-1]:.4f} s "
            "(least / median / most)")
    launches = cuda_build.launches()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    power = power_limit_w() if on_card else None

    result = {"correct": False, "attempted": len(latencies),
              "failed": failed, "metrics": {}, "device": {
                  "platform": "gpu" if on_card else "cpu",
                  "kind": (torch.cuda.get_device_name(device) if on_card
                           else "cpu"),
                  "count": 1, "memory_peak_bytes": int(peak),
                  "power_limit_w": power}}
    if trace:
        tr = tracing.from_profiler(prof)
        del prof
        spans = tr.calls()
        lo, hi = spans[0][0], spans[-1][1]
        union = tracing.merge((s, e) for _n, s, e in tr.device)
        busy = tracing.covered(union, lo, hi) / 1e6
        ctx.__dict__.update(
            trace=tr, lo=lo, hi=hi, union=union, busy_s=busy,
            window_s=(hi - lo) / 1e6, driver=drv, workload=workload,
            done=done, n_calls=len(latencies), latencies=latencies,
            bases=bases, launches=launches,
            live_cells=sum(drv.live_cells(c, calls[c]) for c, _a in done))
        result["device"].update(busy_s=busy, window_s=ctx.window_s)
        for m in manifest.metrics_of(bench, name, trace=True):
            value = manifest.reader(m["name"])(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        result["breakdown"] = tracing.breakdown(tr, lo, hi)
        del tr, ctx
    else:
        values = {"setup_s": setup_s,
                  "aligned_bases_per_s": stats.rate(bases, window_s),
                  "call_p95_ms": stats.p95(latencies) * 1e3,
                  "device_peak_mib": peak / MIB}
        for m in manifest.metrics_of(bench, name, trace=False):
            result["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}
    del done, latencies
    if on_card:
        torch.cuda.empty_cache()

    # the check, once the window has closed and the peak is read
    t_check = time.perf_counter()
    numbers, compared = check(drv, calls, variants, sample, kept, passes)
    limits = workload["checks"]
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in drv.checks}
    result["correct"] = (failed == 0 and compared > 0 and all(
        numbers[k] <= limits[k] for k in drv.checks))
    log(f"{compared} sampled answers compared with the reference in "
        f"{time.perf_counter() - t_check:.1f} s")
    return result


def check(drv, calls, variants, sample, kept, passes):
    """(the driver's numbers, the answers compared): every kept answer of
    a sampled pair against the reference's, which runs once per call on
    the sampled pairs of every variant.  kept: {(variant, call): {pair:
    [distinct answers]}}; passes: {(variant, call): the passes that sent
    it}, each of whose sampled answers equals a kept one unless
    MAX_DISTINCT others were kept before it."""
    items, compared = [], 0
    for c, spec in enumerate(calls):
        keys = [(v, c) for v in range(len(variants)) if passes.get((v, c))]
        pairs = [variants[v][c][i] for v, _c in keys for i in sample[(v, c)]]
        if not pairs:
            continue
        want = iter(drv.reference(spec, pairs))
        for key in keys:
            for i in sample[key]:
                items.append((spec, variants[key[0]][c][i], kept[key][i],
                              next(want)))
            compared += passes[key] * len(sample[key])
    return drv.compare(items), compared
