"""Readings of the 2D layout on phase 9's graphs, beside control layouts.

    JAX_PLATFORMS=cpu python tests/layout_control_report.py [--seeds N]
        [--work DIR]

Builds the star (100 kb), sv and refmap (20 kb) graphs of chip_smoke.py's
phase 9 with the JAX package's `pangenome` verb on the CPU (--no-viz; the
graphs equal the port's byte for byte), then lays each graph out and
prints one JSON line a graph with the layout_stress and the log error
(`log_error`: mean |log(dist / d)| over sampled same-walk pairs) of:

- over seeds 0..N-1, `jax`: cactus_tpu's layout_2d on its own (threefry)
  draws, and `port`: cactus_tpu_torch's layout_2d on the CPU;
- at seed 0, the seed the pipeline lays out with: `same`, cactus_tpu's
  layout_2d on the port's draws (the reading chip_smoke.py pins), `port`,
  and two controls, layouts a faulty port could write: `x0`, the initial
  layout with no SGD step (iters=0), and `sum`, the port's loop with a
  scatter-sum step in place of sgd_step's scatter-mean.  Each carries
  chip_smoke.pan_mismatches' verdict against `same` (`check`: the empty
  list when it passes), and `log_error_check`, whether its log error is
  at most 1.10x the JAX package's own seed-0 reading.

Takes ~5 min with 4 seeds.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


def sum_step(X, a, u, s, eta, pts, pos, pstart, plen, path_of):
    """cactus_tpu_torch's sgd_step with a scatter-sum: every move of an
    endpoint added in full (the control `sum`)."""
    import torch
    pid = path_of[a]
    lo, ln = pstart[pid], plen[pid]
    mag = torch.exp(u * torch.log(torch.clamp(ln.to(torch.float32),
                                              min=2.0)))
    sgn = torch.where(s < 0.5, -1.0, 1.0)
    b = a + (sgn * mag).to(torch.int32)
    b = torch.minimum(torch.maximum(b, lo), lo + ln - 1)
    d = torch.clamp(torch.abs(pos[a] - pos[b]), min=1.0)
    ia, ib = pts[a], pts[b]
    mu = torch.where(ia == ib, 0.0, torch.clamp(eta / (d * d), max=1.0))
    diff = X[ia] - X[ib]
    dist = torch.sqrt(torch.sum(diff * diff, dim=1) + 1e-9)
    r = ((dist - d) / (2.0 * dist) * mu)[:, None] * diff
    return X + torch.zeros_like(X).index_add_(0, ia, -r).index_add_(0, ib, r)


def log_error(g, X, ref, sample=1 << 16, seed=1) -> float:
    """Mean |log(dist / d)| over same-walk terminus pairs sampled as
    layout_stress samples them (16x as many): d is a pair's distance
    along its walk, dist the layout's."""
    import numpy as np
    from cactus_tpu_torch.pangenome import layout2d as tlay
    ep, pos, pstart, plen = tlay._step_termini(g, ref)
    rng = np.random.default_rng(seed)
    a = rng.integers(0, len(ep), sample)
    path_of = np.repeat(np.arange(len(pstart)), plen)
    lo, ln = pstart[path_of[a]], plen[path_of[a]]
    b = np.clip(a + rng.integers(-np.maximum(ln - 1, 1),
                                 np.maximum(ln, 2)), lo, lo + ln - 1)
    d = np.abs(pos[a] - pos[b])
    keep = d >= 1.0
    a, b, d = a[keep], b[keep], d[keep]
    dist = np.linalg.norm(X[ep[a]] - X[ep[b]], axis=1)
    return float(np.mean(np.abs(np.log(np.maximum(dist, 1e-3) / d))))


def seed0_layouts(g, ref):
    """{name: (2 n, 2) layout} of the seed-0 layouts but `port`."""
    import pangenome_digest_report as pdr
    from cactus_tpu_torch.pangenome import layout2d as tlay
    out = {"same": pdr.jax_layout_on_port_draws(g, ref),
           "x0": tlay.layout_2d(g, ref_name=ref, iters=0, device="cpu")}
    mean_step = tlay.sgd_step
    tlay.sgd_step = sum_step
    try:
        out["sum"] = tlay.layout_2d(g, ref_name=ref, device="cpu")
    finally:
        tlay.sgd_step = mean_step
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--work", default=None,
                    help="keep the graphs there (default: a temporary "
                         "directory, removed at the end)")
    opts = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch
    import chip_smoke as cs
    from cactus_tpu import cli
    from cactus_tpu.io.fasta import Sequence
    from cactus_tpu.pangenome import layout2d as jlay
    from cactus_tpu.testutil import evolver
    from cactus_tpu.utils.trees import parse_newick
    from cactus_tpu_torch.pangenome import layout2d as tlay
    from cactus_tpu_torch.pangenome.graph import read_gfa

    torch.set_num_threads(4)
    work = opts.work or tempfile.mkdtemp(prefix="layout_controls_")
    os.makedirs(work, exist_ok=True)
    try:
        seqfiles, _split = cs.pan_inputs(work, evolver, parse_newick,
                                         Sequence)
        for run, argv in cs.pan_cli_runs(seqfiles, work):
            gfa = os.path.join(argv[2], "pangenome.gfa")
            if not os.path.exists(gfa):
                t0 = time.time()
                assert cli.main(argv + ["--no-viz"]) == 0
                print(f"{run}: graph in {time.time() - t0:.1f} s",
                      file=sys.stderr)
            g, ref = cs.pan_layout_graph(gfa, read_gfa)

            def reading(X):
                return (round(tlay.layout_stress(g, X, ref_name=ref), 6),
                        round(log_error(g, X, ref), 6))

            t0 = time.time()
            seeds = {"jax": [], "port": []}
            for seed in range(opts.seeds):
                seeds["jax"].append(reading(
                    jlay.layout_2d(g, ref_name=ref, seed=seed)))
                seeds["port"].append(reading(
                    tlay.layout_2d(g, ref_name=ref, seed=seed,
                                   device="cpu")))
            row = {name: {"stress": [r[0] for r in vals],
                          "log_error": [r[1] for r in vals],
                          "mean_stress": round(float(np.mean(
                              [r[0] for r in vals])), 6),
                          "median_stress": round(float(np.median(
                              [r[0] for r in vals])), 6)}
                   for name, vals in seeds.items()}
            layouts = seed0_layouts(g, ref)
            layouts["port"] = tlay.layout_2d(g, ref_name=ref, device="cpu")
            pinned = {"lay": {"stress": reading(layouts["same"])[0]}}
            jax_err0 = seeds["jax"][0][1]
            row["seed0"] = {}
            for name, X in layouts.items():
                stress, err = reading(X)
                got = {"lay": {"stress": stress,
                               "finite": bool(np.isfinite(X).all())}}
                row["seed0"][name] = {
                    "stress": stress, "log_error": err,
                    "check": cs.pan_mismatches(got, pinned),
                    "log_error_check": bool(err <= 1.10 * jax_err0)}
            print(f"{run}: layouts in {time.time() - t0:.1f} s",
                  file=sys.stderr)
            print(json.dumps({run: row}), flush=True)
    finally:
        if opts.work is None:
            shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
