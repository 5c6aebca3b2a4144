"""Phylogenetic model fitting + per-column conservation (phast analog).

Reference surface: cactus-phast runs phyloFit (substitution model from
4d sites) and phyloP (per-base conservation / acceleration scores) over
the hal2maf output (maf/cactus_phast.py:1-18).  Lite equivalents here
under Jukes-Cantor:

 - phylo_fit: maximum-likelihood global rate scale for the guide tree
   against alignment columns (golden-section search over one scalar;
   column likelihoods are one batched Felsenstein pass on the device);
 - phylo_p: per-column log-likelihood-ratio score between a conserved
   model (rate × rho) and the neutral fitted model — positive scores =
   conserved, the phyloP CONACC sign convention.

The Felsenstein pass (`column_ll_multi`) is PyTorch ops in float32 on the
`device` the caller names (None: the current CUDA device), over chunks of
columns under FELSENSTEIN_BUDGET_BYTES; the JAX package's XLA version
(cactus_tpu/phast.py) computes the same messages, normalisations and
1e-30 floors in the same order.
"""

from __future__ import annotations

import numpy as np

from .io.maf import MafBlock
from .phases.reference import jc_matrix
from .utils.trees import Tree

# base code of each byte of a MAF text: ACGT/acgt 0-3, anything else -1
_CODE_OF_BYTE = np.full(256, -1, np.int8)
for _i, _b in enumerate(b"ACGT"):
    _CODE_OF_BYTE[_b] = _CODE_OF_BYTE[_b + 32] = _i


def columns_from_maf(blocks: list[MafBlock], tree: Tree):
    """(C, E, 4) float32 observation tensor from MAF rows (genome-level
    events; gaps/N = missing), plus per-column (ref seq, ref pos).

    The JAX package's loop (cactus_tpu/phast.py) vectorised over each
    row's text: rows in order, each observed base scaling its event's
    four values by 1e-3 and its own back by 1e3 in float32, and a
    column's (ref seq, ref pos) from its first row with a base there."""
    events = [n.name for n in tree.preorder()]
    eidx = {n: i for i, n in enumerate(events)}
    obs_rows = []
    meta = []
    for b in blocks:
        W = b.width
        block_obs = np.ones((W, len(events), 4), dtype=np.float32)
        src_of = np.full(W, -1, np.int64)
        pos_of = np.full(W, -1, np.int64)
        srcs = []
        for r in b.rows:
            e = eidx.get(r.src.split(".", 1)[0])
            if e is None:
                continue
            text = np.frombuffer(r.text.encode(), np.uint8)
            base = text != ord("-")
            ks = np.flatnonzero(base)
            codes = _CODE_OF_BYTE[text[ks]]
            seen = codes >= 0
            kc, cc = ks[seen], codes[seen].astype(np.int64)
            block_obs[kc, e, :] *= 1e-3
            block_obs[kc, e, cc] *= 1e3
            new = ks[src_of[ks] < 0]
            src_of[new] = len(srcs)
            pos_of[new] = r.start + np.cumsum(base)[new] - 1
            srcs.append(r.src)
        obs_rows.append(block_obs)
        meta.extend((srcs[i], p) if i >= 0 else (None, -1)
                    for i, p in zip(src_of.tolist(), pos_of.tolist()))
    if not obs_rows:
        return (np.zeros((0, len(events), 4), np.float32), [])
    return np.concatenate(obs_rows, axis=0), meta


def column_log_likelihoods(obs: np.ndarray, tree: Tree,
                           scale: float, device=None) -> np.ndarray:
    """log P(column | JC, branch lengths × scale) per column, batched."""
    n_edges = sum(1 for n in tree.postorder() if n.parent is not None)
    return column_ll_multi(obs, tree, np.full((1, n_edges), scale),
                           device=device)[0]


# --------------------------------------------------------------------------
# 4d-site extraction (hal4dExtract / msa_view --4d analog)
# --------------------------------------------------------------------------

# codons whose third position is 4-fold degenerate: any NN in this set
_4D_PREFIXES = {"CT", "GT", "TC", "CC", "AC", "GC", "CG", "GG"}


def gff_cds_transcripts(path):
    """Minimal GFF/GTF CDS reader: transcript → (seqid, strand, exons).

    Groups CDS features by (attributes, seqid, strand) — the reference
    feeds cactus-phast a GFF whose CDS rows share a transcript
    attribute (maf/cactus_phast.py --annotation)."""
    tx: dict[tuple, list[tuple[int, int, int]]] = {}
    with open(path) as fh:
        for line in fh:
            if not line.strip() or line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 8 or f[2] != "CDS":
                continue
            frame = int(f[7]) if f[7] in "012" else 0
            attrs = f[8] if len(f) > 8 else ""
            tx.setdefault((attrs, f[0], f[6]), []).append(
                (int(f[3]) - 1, int(f[4]), frame))
    out = []
    for (attrs, seqid, strand), exons in tx.items():
        out.append((seqid, strand, sorted(exons)))
    return out


def four_d_sites(seqs, transcripts) -> dict[str, np.ndarray]:
    """Genome positions of 4-fold-degenerate third codon bases.

    seqs: {seq_name: Sequence}; transcripts from gff_cds_transcripts.
    Returns {seq_name: sorted unique positions} (0-based).
    """
    from .io.fasta import _BASE_OF, revcomp

    found: dict[str, set[int]] = {}
    for seqid, strand, exons in transcripts:
        if seqid not in seqs:
            continue
        codes = seqs[seqid].codes
        gpos = np.concatenate([np.arange(a, b) for a, b, _f in exons]) \
            if exons else np.zeros(0, np.int64)
        cseq = codes[gpos]
        if strand == "-":
            gpos = gpos[::-1]
            cseq = revcomp(cseq)
            frame = exons[-1][2]
        else:
            frame = exons[0][2]
        cseq = cseq[frame:]
        gpos = gpos[frame:]
        n_codons = len(cseq) // 3
        if not n_codons:
            continue
        tri = cseq[:3 * n_codons].reshape(n_codons, 3)
        p3 = gpos[:3 * n_codons].reshape(n_codons, 3)[:, 2]
        letters = _BASE_OF[np.minimum(tri[:, :2], 4)]
        prefixes = [bytes(row).decode() for row in letters]
        keep = np.fromiter((pre in _4D_PREFIXES for pre in prefixes),
                           bool, n_codons)
        keep &= (tri[:, 0] < 4) & (tri[:, 1] < 4)
        found.setdefault(seqid, set()).update(int(x) for x in p3[keep])
    return {s: np.asarray(sorted(v), np.int64) for s, v in found.items()}


def filter_columns_to_sites(obs, meta, sites: dict[str, np.ndarray]):
    """Keep only alignment columns whose reference (src, pos) is a 4d
    site.  meta comes from columns_from_maf."""
    site_sets = {s: set(v.tolist()) for s, v in sites.items()}
    keep = np.fromiter(
        (src is not None and pos in site_sets.get(src, ())
         for src, pos in meta), bool, len(meta))
    return obs[keep], [m for m, k in zip(meta, keep) if k]


def phylo_fit(blocks: list[MafBlock], tree: Tree,
              lo: float = 0.05, hi: float = 8.0,
              tol: float = 1e-3,
              sites: dict[str, np.ndarray] | None = None,
              device=None) -> float:
    """ML rate scale by golden-section search (phyloFit-lite).

    sites: optional 4d-site map (four_d_sites) restricting the fit to
    neutral third-codon columns, as cactus-phast's phyloFit mode does.
    The column likelihoods run on `device`; the observations go there
    once when they fit a quarter of FELSENSTEIN_BUDGET_BYTES."""
    from .ops import resolve_device
    obs, meta = columns_from_maf(blocks, tree)
    if sites is not None and len(obs):
        obs, meta = filter_columns_to_sites(obs, meta, sites)
    if not len(obs):
        return 1.0
    dev = resolve_device(device)
    if obs.nbytes <= FELSENSTEIN_BUDGET_BYTES // 4:
        import torch
        obs = torch.from_numpy(np.ascontiguousarray(obs, np.float32)).to(dev)

    def nll(s):
        return -float(column_log_likelihoods(obs, tree, s,
                                             device=dev).sum())

    gr = (np.sqrt(5) - 1) / 2
    a, b = lo, hi
    c = b - gr * (b - a)
    d = a + gr * (b - a)
    fc, fd = nll(c), nll(d)
    while b - a > tol:
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc = nll(c)
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd = nll(d)
    return (a + b) / 2


def _subtree_events(tree: Tree, name: str) -> set[str]:
    """Event names strictly inside the subtree rooted at `name` (the
    subtree's own edges: every node whose branch lies below it,
    including `name` itself — its branch to the parent belongs to the
    lineage being tested, matching phyloP --subtree)."""
    for n in tree.preorder():
        if n.name == name:
            return {d.name for d in n.preorder()}
    raise ValueError(f"no node named {name!r} in the tree")


# Device-memory budget of one chunk of columns in `column_ll_multi`.  Per
# column, in bytes: its observations, 16 E (E events of 4 float32); the
# messages, at most one (R, 4) float32 row a materialised event, 16 R E;
# the lift's product and sum and the normalised parent in flight, 48 R;
# ll and the norm, 8 R; so 16 R (E + 4) + 16 E bounds it.  A fixed 2 GiB,
# not the free memory, so that the chunking, and the order of work, is
# the same from run to run; at the LRT grid (R = 33) and 10 events that is
# 284,359 columns a chunk.  The values do not depend on the chunking:
# columns are independent.
FELSENSTEIN_BUDGET_BYTES = 2 << 30


def felsenstein_bytes_per_column(R: int, E: int) -> int:
    """Device bytes one column of a `column_ll_multi` chunk takes at its
    peak (the derivation above FELSENSTEIN_BUDGET_BYTES)."""
    return 16 * R * (E + 4) + 16 * E


def _lift(msg, P):
    """msg (R, C, 4) through P (R, 4, 4): out[r, c, a] = sum_b msg[r, c, b]
    P[r, a, b], as multiplies and adds in b order (float32 throughout;
    no matmul, so no TF32 on any card)."""
    out = msg[:, :, 0:1] * P[:, None, :, 0]
    for b in range(1, 4):
        out = out + msg[:, :, b:b + 1] * P[:, None, :, b]
    return out


def _sum4(x):
    """Sum over the last axis of 4, left to right."""
    return ((x[..., 0] + x[..., 1]) + x[..., 2]) + x[..., 3]


def _felsenstein(obs, P, edges, root: int, E: int):
    """The postorder message pass over one chunk of columns: obs (C, E, 4)
    and P (nE, R, 4, 4) float32 on one device; returns ll (R, C)."""
    import torch
    R, C = P.shape[1], obs.shape[0]
    msgs = [obs[None, :, i, :].expand(R, C, 4) for i in range(E)]
    ll = torch.zeros((R, C), dtype=torch.float32, device=obs.device)
    for k, (child, parent) in enumerate(edges):
        lifted = _lift(msgs[child], P[k])
        msgs[child] = None
        msg = msgs[parent] * lifted
        del lifted
        norm = torch.clamp_min(_sum4(msg), 1e-30)
        msgs[parent] = msg / norm[:, :, None]
        del msg
        ll = ll + torch.log(norm)
    return ll + torch.log(torch.clamp_min(0.25 * _sum4(msgs[root]), 1e-30))


def column_ll_multi(obs, tree: Tree, edge_scales: np.ndarray,
                    device=None,
                    budget: int = FELSENSTEIN_BUDGET_BYTES) -> np.ndarray:
    """log P(column) for MANY scale assignments in one batched pass.

    edge_scales (R, n_edges): per-evaluation branch-length multipliers,
    edges in tree.postorder() order (non-root nodes).  Returns (R, C)
    float32 on the host.  One Felsenstein sweep with every rate row on
    the leading axis — the LRT grid costs one device pass, not R — run
    on `device` in chunks of columns of at most `budget` bytes
    (`felsenstein_bytes_per_column`).  obs is a (C, E, 4) host array or
    a float32 tensor (a chunk is sliced from it where it lies)."""
    import torch

    from .ops import resolve_device
    dev = resolve_device(device)
    events = [n.name for n in tree.preorder()]
    eidx = {n: i for i, n in enumerate(events)}
    post = [n for n in tree.postorder() if n.parent is not None]
    R = edge_scales.shape[0]
    Pmats = np.stack([
        np.stack([jc_matrix((n.length or 0.0) * float(edge_scales[r, k]))
                  for r in range(R)])
        for k, n in enumerate(post)])                 # (nE, R, 4, 4)
    edges = [(eidx[n.name], eidx[n.parent.name]) for n in post]
    root = eidx[tree.name]
    E = len(events)
    if not torch.is_tensor(obs):
        obs = np.ascontiguousarray(obs, dtype=np.float32)
    C = obs.shape[0]
    P = torch.from_numpy(Pmats.astype(np.float32)).to(dev)
    step = max(1, budget // felsenstein_bytes_per_column(R, E))
    out = np.empty((R, C), np.float32)
    for c0 in range(0, C, step):
        chunk = torch.as_tensor(obs[c0:c0 + step], device=dev)
        out[:, c0:c0 + step] = _felsenstein(chunk, P, edges, root,
                                            E).cpu().numpy()
    return out


def _chi2_1_neglog10_sf(stat: np.ndarray) -> np.ndarray:
    """-log10 of the chi-square(1df) survival function, stable for
    large statistics (scipy.special.erfc underflows past ~1e-308;
    switch to the asymptotic expansion)."""
    from scipy.special import erfc
    x = np.sqrt(np.maximum(stat, 0.0) / 2.0)
    p = erfc(x)
    small = p < 1e-300
    out = np.where(small, 1.0, -np.log10(np.maximum(p, 1e-300)))
    if np.any(small):
        # erfc(x) ~ exp(-x^2) / (x sqrt(pi))
        xs = x[small]
        out[small] = (xs * xs + np.log(xs * np.sqrt(np.pi))) / np.log(10)
    return out.astype(np.float32)


def phylo_p(blocks: list[MafBlock], tree: Tree,
            neutral_scale: float | None = None,
            rho: float = 0.3, method: str = "ratio",
            mode: str = "CONACC", subtree: str | None = None,
            grid: int = 33, device=None):
    """Per-column conservation scores + reference coordinates.

    method (cactus_phast.py:158 --method; SPH/GERP not offered):
      'ratio' — legacy lite score ll(rho×neutral) − ll(neutral);
      'LRT'   — per-column ML scale over a log grid, statistic
                2·(ll_max − ll_neutral), chi-square(1df) p-value,
                scores are −log10 p signed by the CONACC convention;
      'SCORE' — score test at the neutral model: U²/I with U, I from
                central differences of the log-likelihood in log-scale.
    mode (--phyloPMode): CONACC (signed; positive = conserved),
      CON / ACC (one-sided, clamped at 0), NNEUT (unsigned).
    subtree: name of an internal node — only ITS subtree's branches
      scale in the alternative model (phyloP --subtree lineage track).

    The column likelihoods run on `device`.

    Returns (scores (C,), meta [(ref_seq, ref_pos)])."""
    if neutral_scale is None:
        neutral_scale = phylo_fit(blocks, tree, device=device)
    obs, meta = columns_from_maf(blocks, tree)
    if not len(obs):
        return np.zeros(0, np.float32), []
    post = [n for n in tree.postorder() if n.parent is not None]
    nE = len(post)
    if subtree is not None:
        inside = _subtree_events(tree, subtree)
        sub_mask = np.array([n.name in inside for n in post])
        if not sub_mask.any():
            raise ValueError(f"subtree {subtree!r} has no branches")
    else:
        sub_mask = np.ones(nE, bool)

    def scales_for(rhos: np.ndarray) -> np.ndarray:
        s = np.full((len(rhos), nE), neutral_scale, np.float64)
        s[:, sub_mask] = neutral_scale * rhos[:, None]
        return s

    if method == "ratio":
        ll = column_ll_multi(obs, tree,
                             scales_for(np.array([1.0, rho])),
                             device=device)
        return (ll[1] - ll[0]).astype(np.float32), meta

    if method == "LRT":
        rhos = np.concatenate([np.logspace(np.log10(1 / 16), 0.0,
                                           grid // 2, endpoint=False),
                               [1.0],
                               np.logspace(0.0, np.log10(16.0),
                                           grid - grid // 2)[1:]])
        ll = column_ll_multi(obs, tree, scales_for(rhos), device=device)
        neutral_row = int(np.flatnonzero(rhos == 1.0)[0])
        best = np.argmax(ll, axis=0)
        stat = 2.0 * (ll[best, np.arange(ll.shape[1])]
                      - ll[neutral_row])
        nlp = _chi2_1_neglog10_sf(stat)
        conserved = rhos[best] < 1.0
    elif method == "SCORE":
        h = 0.05
        ll = column_ll_multi(
            obs, tree, scales_for(np.array([1.0 - h, 1.0, 1.0 + h])),
            device=device)
        U = (ll[2] - ll[0]) / (2 * h)
        I = -(ll[2] - 2 * ll[1] + ll[0]) / (h * h)
        # |I|: at fully-conserved columns the log-likelihood is convex
        # in the rate near neutral (observed information < 0) — phast
        # proper divides by the EXPECTED information, which is always
        # positive; the magnitude is the lite stand-in, floored against
        # numerically flat columns
        stat = U * U / np.maximum(np.abs(I), 1e-3)
        nlp = _chi2_1_neglog10_sf(stat)
        conserved = U < 0.0   # likelihood falls as the rate rises
    else:
        raise ValueError(f"unknown phyloP method {method!r}")

    if mode == "CONACC":
        scores = np.where(conserved, nlp, -nlp)
    elif mode == "CON":
        scores = np.where(conserved, nlp, 0.0)
    elif mode == "ACC":
        scores = np.where(conserved, 0.0, nlp)
    elif mode == "NNEUT":
        scores = nlp
    else:
        raise ValueError(f"unknown phyloP mode {mode!r}")
    return scores.astype(np.float32), meta


def write_wig(path, scores: np.ndarray, meta) -> None:
    """Fixed/variable-step wiggle of per-reference-base scores."""
    with open(path, "w") as fh:
        cur = None
        for s, (seq, pos) in zip(scores, meta):
            if seq is None or pos < 0:
                continue
            if seq != cur:
                fh.write(f"variableStep chrom={seq}\n")
                cur = seq
            fh.write(f"{pos + 1} {s:.4f}\n")
