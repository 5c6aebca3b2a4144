"""odgi layout / odgi draw analog: path-guided 2D SGD layout.

Reference: graphmap-join runs `odgi layout` + `odgi draw` when asked
for 2D visualizations (refmap/cactus_graphmap_join.py --odgi surface;
odgi's layout is the path-guided SGD of Heumos et al., itself the
stress-majorization SGD of Zheng/Pawar/Goodman).  The algorithm is a
natural device fit: one update step (`sgd_step`, plain PyTorch gathers
and `index_add_` scatters on the caller's device) processes a BATCH of
sampled step pairs at once (odgi updates one pair per thread
iteration), and the epoch loop runs the steps one after another.

Model: every node contributes TWO layout points (its start and end
endpoint), so a node is drawn as a segment.  Training pairs are
(step-terminus, step-terminus) samples from the SAME walk; the target
distance is their nucleotide distance along the walk.  The classic
SGD-stress update moves both points along their difference vector
with step size mu = min(1, eta / d^2), eta decaying exponentially
from d_max^2 (every move fully satisfied) to 0.01.
"""

from __future__ import annotations

import numpy as np

from .graph import PanGraph
from .viz import layout_1d, write_png


def _step_termini(graph: PanGraph, ref_name: str | None):
    """Flatten walks into parallel arrays of (endpoint id, path pos).

    Every step contributes its two node endpoints at the step's start
    and end offsets along the walk (orientation decides which endpoint
    lands where).  Returns (ep, pos, path_start, path_len) where
    `path_start[i]:path_start[i]+path_len[i]` spans walk i's termini.
    """
    eps: list[int] = []
    poss: list[int] = []
    starts: list[int] = []
    lens: list[int] = []
    names = sorted(graph.walks)
    if ref_name in graph.walks:
        names.remove(ref_name)
        names.insert(0, ref_name)
    for name in names:
        starts.append(len(eps))
        off = 0
        for v, o in graph.walks[name]:
            L = graph.node_len(v)
            s_ep, e_ep = (2 * v, 2 * v + 1) if o == 1 else (2 * v + 1, 2 * v)
            eps.append(s_ep)
            poss.append(off)
            eps.append(e_ep)
            poss.append(off + L)
            off += L
        lens.append(len(eps) - starts[-1])
    return (np.asarray(eps, np.int32), np.asarray(poss, np.float32),
            np.asarray(starts, np.int32), np.asarray(lens, np.int32))


def sgd_step(X, a, u, s, eta, pts, pos, pstart, plen, path_of):
    """One batched path-guided SGD update of the points X.

    X is (n_points, 2) for the 2D layout or (n_points,) for the 1D sort.
    a holds the sampled termini (int64), u and s uniform draws in [0, 1)
    for each one: u sets the log-uniform rank distance to its partner on
    the same walk, s its sign.  eta is the step's learning rate (a 0-dim
    float32 tensor); pts maps a terminus to its point, pos to its walk
    offset, path_of to its walk, whose termini are pstart:pstart+plen.
    Moves are applied as a scatter-mean: the sum of an endpoint's moves
    over the count of pairs that hit it (odgi applies pair moves one at a
    time; a batched add of full-strength corrections to one endpoint
    overshoots by the collision count and diverges).  Returns the new X.
    """
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
    if X.dim() == 2:
        dist = torch.sqrt(torch.sum(diff * diff, dim=1) + 1e-9)
        r = ((dist - d) / (2.0 * dist) * mu)[:, None] * diff
    else:
        dist = torch.abs(diff) + 1e-9
        r = (dist - d) / (2.0 * dist) * mu * diff
    acc = torch.zeros_like(X).index_add_(0, ia, -r).index_add_(0, ib, r)
    ones = torch.ones_like(d)
    cnt = (torch.zeros(X.shape[0], dtype=X.dtype, device=X.device)
           .index_add_(0, ia, ones).index_add_(0, ib, ones))
    cnt = torch.clamp(cnt, min=1.0)
    return X + acc / (cnt[:, None] if X.dim() == 2 else cnt)


def _draws(n_ep: int, iters: int, batch: int, seed: int):
    """The SGD's draws, (iters, batch) CPU tensors from a host generator
    seeded from `seed`: a, the sampled termini (int64 in 0..n_ep-1), and u
    and s, uniform in [0, 1) (sgd_step's arguments)."""
    import torch
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    return (torch.randint(0, n_ep, (iters, batch), generator=gen),
            torch.rand((iters, batch), generator=gen),
            torch.rand((iters, batch), generator=gen))


def _sgd(X0: np.ndarray, pts: np.ndarray, pos: np.ndarray,
         pstart: np.ndarray, plen: np.ndarray, iters: int, batch: int,
         seed: int, eta_max: float, lam: float, dev) -> np.ndarray:
    """`iters` sgd_steps on `dev`; eta decays as eta_max * exp(-lam * t).

    The draws come from a host generator seeded from `seed` and move to
    `dev` in one copy, so every device takes the same pairs: a layout on
    the card equals the CPU's up to float rounding.  (The pairs depend on
    the draws and the walks only, never on X.)"""
    import torch
    draws_a, draws_u, draws_s = (x.to(dev) for x in _draws(
        len(pts), iters, batch, seed))

    def as_t(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    pts_t, pos_t = as_t(pts, torch.int64), as_t(pos, torch.float32)
    pstart_t, plen_t = as_t(pstart, torch.int64), as_t(plen, torch.int64)
    path_of = torch.repeat_interleave(
        torch.arange(len(pstart), device=dev), plen_t)
    etas = (as_t(eta_max, torch.float32) * torch.exp(
        as_t(-lam, torch.float32)
        * torch.arange(iters, dtype=torch.float32, device=dev)))
    X = as_t(X0, torch.float32)
    for t in range(iters):
        X = sgd_step(X, draws_a[t], draws_u[t], draws_s[t], etas[t], pts_t,
                     pos_t, pstart_t, plen_t, path_of)
    return X.cpu().numpy()


def layout_2d(graph: PanGraph, ref_name: str | None = None,
              iters: int = 200, batch: int = 1024, seed: int = 0,
              eta_min: float = 0.01, device=None) -> np.ndarray:
    """Path-guided SGD layout.  Returns (2*n_nodes, 2) float32 coords.

    The SGD passes run on `device` (None = the current CUDA device)."""
    from ..ops import resolve_device
    dev = resolve_device(device)

    n = graph.n_nodes
    if n == 0:
        return np.zeros((0, 2), np.float32)
    ep, pos, pstart, plen = _step_termini(graph, ref_name)
    if len(ep) < 2:
        return np.zeros((2 * n, 2), np.float32)

    # init on the 1D layout with a small vertical jitter (odgi layout
    # also seeds from the 1D sort) so SGD starts near a good basin
    off1d = layout_1d(graph, ref_name).astype(np.float32)
    lens = np.asarray([graph.node_len(v) for v in range(n)], np.float32)
    rng = np.random.default_rng(seed)
    X0 = np.empty((2 * n, 2), np.float32)
    X0[0::2, 0] = off1d
    X0[1::2, 0] = off1d + lens
    X0[:, 1] = rng.standard_normal(2 * n).astype(np.float32)

    d_max = float(pos.max()) if len(pos) else 1.0
    eta_max = max(d_max * d_max, 1.0)
    lam = np.log(eta_max / eta_min) / max(iters - 1, 1)
    # steps-per-path weighting: sample a terminus uniformly, then a
    # partner from the same walk at a log-uniform rank distance (the
    # zipfian band odgi uses, cheap to sample on device)
    return _sgd(X0, ep, pos, pstart, plen, iters, batch, seed, eta_max,
                lam, dev)


def write_lay(path: str, graph: PanGraph, X: np.ndarray) -> None:
    """odgi layout's .lay analog as TSV: node, x0, y0, x1, y1."""
    with open(path, "w") as fh:
        fh.write("#node\tx0\ty0\tx1\ty1\n")
        for v in range(graph.n_nodes):
            x0, y0 = X[2 * v]
            x1, y1 = X[2 * v + 1]
            fh.write(f"{v + 1}\t{x0:.3f}\t{y0:.3f}\t{x1:.3f}\t{y1:.3f}\n")


def read_lay(path: str) -> np.ndarray:
    rows = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            _, x0, y0, x1, y1 = line.split("\t")
            rows.append(((float(x0), float(y0)), (float(x1), float(y1))))
    out = np.empty((2 * len(rows), 2), np.float32)
    for i, (p0, p1) in enumerate(rows):
        out[2 * i], out[2 * i + 1] = p0, p1
    return out


def draw(graph: PanGraph, X: np.ndarray, path: str,
         width: int = 800, pad: int = 8) -> None:
    """`odgi draw` analog: rasterize node segments to a PNG.

    Vectorized: all nodes' segments are sampled at once (K points per
    segment, K set by the longest segment in pixels) and splatted into
    the canvas with one fancy-index store.
    """
    n = graph.n_nodes
    if n == 0 or len(X) == 0:
        write_png(path, np.full((16, 16, 3), 255, np.uint8))
        return
    lo = X.min(axis=0)
    hi = X.max(axis=0)
    span = np.maximum(hi - lo, 1e-6)
    scale = (width - 2 * pad) / span.max()
    height = int(np.ceil(span[1] * scale)) + 2 * pad
    height = max(height, 16)
    img = np.full((height, width, 3), 255, np.uint8)

    P = ((X - lo) * scale + pad).astype(np.float32)   # (2n, 2) pixel
    A, B = P[0::2], P[1::2]                           # (n, 2)
    seg_px = np.abs(B - A).max(axis=1)
    K = int(min(max(seg_px.max(), 1) + 1, 4 * width))
    t = np.linspace(0.0, 1.0, K, dtype=np.float32)[None, :, None]
    pts = A[:, None, :] + (B - A)[:, None, :] * t      # (n, K, 2)
    xs = np.clip(pts[..., 0].astype(np.int32), 0, width - 1)
    ys = np.clip(pts[..., 1].astype(np.int32), 0, height - 1)
    # color by node depth (number of walk steps through the node)
    depth = np.zeros(n, np.int64)
    for walk in graph.walks.values():
        for v, _o in walk:
            depth[v] += 1
    dmax = max(int(depth.max()), 1)
    # deep nodes red-shifted, shallow ones slate blue
    frac = (depth / dmax).astype(np.float32)
    col = np.stack([40 + 200 * frac, np.full(n, 60, np.float32),
                    220 - 180 * frac], axis=1).astype(np.uint8)
    colK = np.broadcast_to(col[:, None, :], (n, K, 3))
    img[ys.ravel(), xs.ravel()] = colK.reshape(-1, 3)
    write_png(path, img)


def layout_stress(graph: PanGraph, X: np.ndarray,
                  ref_name: str | None = None,
                  sample: int = 4096, seed: int = 1) -> float:
    """Normalized stress over sampled same-walk pairs (diagnostic)."""
    ep, pos, pstart, plen = _step_termini(graph, ref_name)
    if len(ep) < 2:
        return 0.0
    rng = np.random.default_rng(seed)
    a = rng.integers(0, len(ep), sample)
    path_of = np.repeat(np.arange(len(pstart)), plen)
    lo, ln = pstart[path_of[a]], plen[path_of[a]]
    b = np.clip(a + rng.integers(-np.maximum(ln - 1, 1),
                                 np.maximum(ln, 2)), lo, lo + ln - 1)
    d = np.abs(pos[a] - pos[b])
    keep = d >= 1.0
    if not keep.any():
        return 0.0
    a, b, d = a[keep], b[keep], d[keep]
    dist = np.linalg.norm(X[ep[a]] - X[ep[b]], axis=1)
    return float(np.mean(((dist - d) / d) ** 2))


def sgd_sort(graph: PanGraph, ref_name: str | None = None,
             iters: int | None = None, batch: int = 1024,
             seed: int = 0, device=None) -> np.ndarray:
    """`odgi sort -Y` analog: path-guided 1D SGD node order.

    Same sampled-pair SGD as layout_2d but in one dimension with one
    point per node (odgi's 1D sort), starting from the first-visit
    order, on `device` (None = the current CUDA device).  Returns the
    node permutation (new order, old ids).

    iters defaults to a graph-size-scaled schedule: convergence needs
    the sampled pairs to cover each node several times (odgi scales
    its SGD epochs with path steps the same way).
    """
    from ..ops import resolve_device
    dev = resolve_device(device)

    n = graph.n_nodes
    if n == 0:
        return np.zeros(0, np.int64)
    if iters is None:
        iters = min(2000, max(600, 4 * n))
    ep, pos, pstart, plen = _step_termini(graph, ref_name)
    if len(ep) < 2:
        return np.arange(n, dtype=np.int64)
    node_of = np.asarray(ep) // 2          # terminus → node id
    x0 = layout_1d(graph, ref_name).astype(np.float32)

    eta_max = max(float(pos.max()) ** 2, 1.0)
    eta_min = 0.01
    lam = np.log(eta_max / eta_min) / max(iters - 1, 1)
    x = _sgd(x0, node_of, pos, pstart, plen, iters, batch, seed, eta_max,
             lam, dev)
    return np.argsort(x, kind="stable").astype(np.int64)
