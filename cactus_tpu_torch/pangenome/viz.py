"""odgi viz analog: 1D pangenome raster.

Reference: graphmap-join's `--viz` emits an odgi 1D visualization per
chromosome graph (refmap/cactus_graphmap_join.py:169,399-406 → `odgi
viz`).  Same picture here, dependency-free: the x-axis is a 1D layout
of the graph (nodes at cumulative offsets in first-visit order,
reference walk first — odgi's default sort), one row per path colored
where the path covers that x-bin, inverted-orientation steps darkened,
plus a top band showing per-bin node depth (odgi viz's link/summary
band).  Output is a real PNG written with zlib only.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .graph import PanGraph

# categorical path palette (odgi viz uses a rotating palette too)
_PALETTE = np.array([
    (31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
    (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
    (188, 189, 34), (23, 190, 207), (174, 199, 232), (255, 187, 120),
], np.uint8)


def layout_1d(graph: PanGraph, ref_name: str | None = None) -> np.ndarray:
    """Node id → x offset: first-visit order over walks (ref first)."""
    order: list[int] = []
    seen = np.zeros(graph.n_nodes, bool)
    names = list(graph.walks)
    if ref_name is not None and ref_name in graph.walks:
        names.remove(ref_name)
        names.insert(0, ref_name)
    for name in names:
        for v, _o in graph.walks[name]:
            if not seen[v]:
                seen[v] = True
                order.append(v)
    for v in range(graph.n_nodes):          # unreachable stragglers
        if not seen[v]:
            order.append(v)
    off = np.zeros(graph.n_nodes, np.int64)
    pos = 0
    for v in order:
        off[v] = pos
        pos += graph.node_len(v)
    return off


def render_1d(graph: PanGraph, ref_name: str | None = None,
              width: int = 1024, row_h: int = 8,
              depth_band_h: int = 24) -> np.ndarray:
    """Rasterize to an (H, W, 3) uint8 RGB image."""
    off = layout_1d(graph, ref_name)
    total = int(off.max() + graph.node_len(int(np.argmax(off)))) \
        if graph.n_nodes else 1
    total = max(total, 1)
    width = min(width, max(total, 16))
    scale = width / total
    names = sorted(graph.walks)
    H = depth_band_h + 2 + len(names) * (row_h + 1)
    img = np.full((H, width, 3), 255, np.uint8)

    depth = np.zeros(width, np.int64)
    rows = []
    for pi, name in enumerate(names):
        cov = np.zeros(width, np.int8)      # 0 none, 1 fwd, 2 rev
        for v, o in graph.walks[name]:
            a = int(off[v] * scale)
            b = max(a + 1, int((off[v] + graph.node_len(v)) * scale))
            b = min(b, width)
            cov[a:b] = np.where(cov[a:b] == 0, 1 if o == 1 else 2,
                                cov[a:b])
            depth[a:b] += 1
        rows.append(cov)

    # depth band: darker = deeper (odgi viz's summary strip)
    if depth.max() > 0:
        shade = (255 - (depth / depth.max()) * 220).astype(np.uint8)
        img[:depth_band_h, :, 0] = shade
        img[:depth_band_h, :, 1] = shade
        img[:depth_band_h, :, 2] = 255
    img[depth_band_h:depth_band_h + 2, :, :] = 40

    y = depth_band_h + 2
    for pi, cov in enumerate(rows):
        color = _PALETTE[pi % len(_PALETTE)]
        dark = (color * 0.45).astype(np.uint8)
        band = img[y:y + row_h]
        fwd = cov == 1
        rev = cov == 2
        band[:, fwd] = color
        band[:, rev] = dark
        y += row_h + 1
    return img


def write_png(path: str, img: np.ndarray) -> None:
    """Minimal PNG encoder (8-bit RGB, zlib filter 0 per scanline)."""
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2,
                                            0, 0, 0)))
        fh.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        fh.write(chunk(b"IEND", b""))


def viz(graph: PanGraph, path: str, ref_name: str | None = None,
        width: int = 1024) -> None:
    """`odgi viz -i g.og -o out.png` equivalent."""
    write_png(path, render_1d(graph, ref_name, width=width))
