"""Native BigWig (bbi v4) writer + mini reader.

The reference pipeline shells out to UCSC `wigToBigWig` for
cactus-phast's --bigwig flag (maf/cactus_phast.py:165); this build
writes the kent bbi format directly: common header, chromosome B+
tree, zlib-compressed variable-step wig sections, and an R-tree index
(format per kent/src/inc/bbiFile.h).  Zoom levels are omitted
(zoomLevels=0 is legal bbi; readers compute reductions on the fly),
and the small reader here round-trips files for tests.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

BIGWIG_MAGIC = 0x888FFC26
CHROM_TREE_MAGIC = 0x78CA8C91
RTREE_MAGIC = 0x2468ACE0
_ITEMS_PER_SECTION = 1024
_BLOCK_SIZE = 256


def write_bigwig(path: str,
                 data: dict[str, tuple[np.ndarray, np.ndarray]],
                 chrom_sizes: dict[str, int]) -> None:
    """data: {chrom: (starts (0-based uint32 sorted), values float32)};
    every base spans 1 bp (variable-step, span=1)."""
    chroms = sorted(data)
    chrom_id = {c: i for i, c in enumerate(chroms)}
    key_size = max((len(c) for c in chroms), default=1)

    # ---- build compressed var-step sections
    sections = []          # (chromIx, start, end, payload)
    max_raw = 1
    total_items = 0
    vals_all = []
    for c in chroms:
        starts, vals = data[c]
        starts = np.asarray(starts, np.uint32)
        vals = np.asarray(vals, np.float32)
        assert starts.shape == vals.shape
        total_items += len(starts)
        vals_all.append(vals)
        for s0 in range(0, len(starts), _ITEMS_PER_SECTION):
            st = starts[s0:s0 + _ITEMS_PER_SECTION]
            vv = vals[s0:s0 + _ITEMS_PER_SECTION]
            hdr = struct.pack("<IIIIIBBH", chrom_id[c], int(st[0]),
                              int(st[-1]) + 1, 0, 1, 2, 0, len(st))
            items = np.empty(len(st), dtype=[("s", "<u4"), ("v", "<f4")])
            items["s"] = st
            items["v"] = vv
            raw = hdr + items.tobytes()
            max_raw = max(max_raw, len(raw))
            sections.append((chrom_id[c], int(st[0]), int(st[-1]) + 1,
                             zlib.compress(raw)))

    # ---- file layout
    out = bytearray(b"\0" * 64)                    # common header slot
    total_summary_off = len(out)
    allv = np.concatenate(vals_all) if vals_all else np.zeros(1, np.float32)
    out += struct.pack("<Qdddd", total_items,
                       float(allv.min()), float(allv.max()),
                       float(allv.sum()),
                       float((allv.astype(np.float64) ** 2).sum()))

    chrom_tree_off = len(out)
    out += struct.pack("<IIIIQQ", CHROM_TREE_MAGIC, _BLOCK_SIZE,
                       key_size, 8, len(chroms), 0)
    out += struct.pack("<BBH", 1, 0, len(chroms))  # one leaf node
    for c in chroms:
        out += c.encode().ljust(key_size, b"\0")
        out += struct.pack("<II", chrom_id[c], chrom_sizes[c])

    full_data_off = len(out)
    out += struct.pack("<Q", total_items)
    locs = []
    for cid, s, e, payload in sections:
        locs.append((cid, s, e, len(out), len(payload)))
        out += payload

    full_index_off = len(out)
    out += _rtree(locs, full_index_off)

    out[0:64] = struct.pack("<IHHQQQHHQQIQ", BIGWIG_MAGIC, 4, 0,
                            chrom_tree_off, full_data_off,
                            full_index_off, 0, 0, 0,
                            total_summary_off, max_raw, 0)
    with open(path, "wb") as fh:
        fh.write(out)


def _rtree(locs, index_off: int) -> bytes:
    """One- or two-level R-tree over the data sections."""
    if not locs:
        locs = [(0, 0, 0, 0, 0)]
    s_cix = min(l[0] for l in locs)
    s_base = min(l[1] for l in locs if l[0] == s_cix)
    e_cix = max(l[0] for l in locs)
    e_base = max(l[2] for l in locs if l[0] == e_cix)
    end_data = locs[-1][3] + locs[-1][4]
    head = struct.pack("<IIQIIIIQII", RTREE_MAGIC, _BLOCK_SIZE,
                       len(locs), s_cix, s_base, e_cix, e_base,
                       end_data, _ITEMS_PER_SECTION, 0)
    leaf_item = struct.Struct("<IIIIQQ")
    if len(locs) <= _BLOCK_SIZE:
        body = struct.pack("<BBH", 1, 0, len(locs))
        for cid, s, e, off, size in locs:
            body += leaf_item.pack(cid, s, cid, e, off, size)
        return head + body
    # two levels: root internal node pointing at leaf nodes
    groups = [locs[i:i + _BLOCK_SIZE]
              for i in range(0, len(locs), _BLOCK_SIZE)]
    root = struct.pack("<BBH", 0, 0, len(groups))
    root_size = 4 + len(groups) * 24
    leaf_blobs = []
    offs = []
    cur = index_off + len(head) + root_size
    for g in groups:
        blob = struct.pack("<BBH", 1, 0, len(g))
        for cid, s, e, off, size in g:
            blob += leaf_item.pack(cid, s, cid, e, off, size)
        offs.append(cur)
        leaf_blobs.append(blob)
        cur += len(blob)
    for g, off in zip(groups, offs):
        root += struct.pack("<IIIIQ", g[0][0], g[0][1], g[-1][0],
                            g[-1][2], off)
    return head + root + b"".join(leaf_blobs)


def read_bigwig(path: str):
    """Mini reader: returns ({chrom: (starts, values)}, {chrom: size}).
    Handles files written by write_bigwig (varstep span-1 sections)."""
    buf = open(path, "rb").read()
    (magic, version, zooms, chrom_off, data_off, _index_off, _fc, _dfc,
     _auto, _summ, uncomp, _res) = struct.unpack_from("<IHHQQQHHQQIQ",
                                                      buf, 0)
    assert magic == BIGWIG_MAGIC, hex(magic)
    (tmagic, _bs, key_size, val_size, n_chrom,
     _r) = struct.unpack_from("<IIIIQQ", buf, chrom_off)[:6]
    assert tmagic == CHROM_TREE_MAGIC
    p = chrom_off + 32
    is_leaf, _pad, cnt = struct.unpack_from("<BBH", buf, p)
    assert is_leaf == 1, "mini reader: single-leaf chrom trees only"
    p += 4
    names = {}
    sizes = {}
    for _ in range(cnt):
        key = buf[p:p + key_size].rstrip(b"\0").decode()
        cid, csize = struct.unpack_from("<II", buf, p + key_size)
        names[cid] = key
        sizes[key] = csize
        p += key_size + 8
    (n_items,) = struct.unpack_from("<Q", buf, data_off)
    p = data_off + 8
    out: dict[str, list] = {}
    got = 0
    while got < n_items:
        # sections are zlib streams back to back; decompress greedily
        d = zlib.decompressobj()
        raw = d.decompress(buf[p:])
        consumed = len(buf) - p - len(d.unused_data)
        p += consumed
        (cid, _s, _e, _step, _span, typ, _r8,
         icount) = struct.unpack_from("<IIIIIBBH", raw, 0)
        assert typ == 2, typ
        items = np.frombuffer(raw, dtype=[("s", "<u4"), ("v", "<f4")],
                              count=icount, offset=24)
        out.setdefault(names[cid], []).append(items)
        got += icount
    merged = {}
    for c, parts in out.items():
        allp = np.concatenate(parts)
        merged[c] = (allp["s"].astype(np.int64), allp["v"].copy())
    return merged, sizes
