"""HDF5 export/import of HAL alignments (the reference's storage model).

The reference stores alignments in HDF5 through the hal C++ library
(SURVEY §2.2: submodules hal + cactus2hal; every consumption tool —
halStats, hal2fasta, halValidate — walks that container).  This module
maps the native append-only archive (hal_archive.py) to/from an HDF5
container with HAL's documented STRUCTURE — one group per genome
carrying its parent link, sequence table, DNA and top/bottom segment
arrays — so HDF5-ecosystem tooling (h5py, HDFView, downstream
pipelines) can consume the alignment directly.

Honest caveat: the hal C++ library's exact binary schema (compound
dtype field names, chunking, internal udc metadata) could not be
validated in this environment — the hal submodule is an empty stub and
no reference-produced .hal fixture exists here (zero egress).  The
layout below follows hal's structural model and is documented for
interop work; bit-level compatibility with `halValidate` is NOT
claimed.  Round-trip through this module is exact (tests/test_hal_hdf5).

Layout:
    /                attrs: newick, metadata (JSON), format="cactus_tpu-hal-hdf5"
    /<genome>/       attrs: parent ("" for root)
        SEQUENCE_NAMES   (S,)  vlen str
        SEQUENCE_LENGTHS (S,)  int64
        DNA              (L,)  uint8 base codes 0-4 (4 = N)
        BOTTOM_{SEQ,START,LENGTH,CHILD} segment arrays
        TOP_{SEQ,START,LENGTH,PARENT,ORIENT} segment arrays
"""

from __future__ import annotations

import json

import numpy as np

from ..hal_archive import HalArchive

_BOT_KEYS = (("bot_seq", "BOTTOM_SEQ"), ("bot_start", "BOTTOM_START"),
             ("bot_len", "BOTTOM_LENGTH"), ("bot_name", "BOTTOM_CHILD"))
_TOP_KEYS = (("top_seq", "TOP_SEQ"), ("top_start", "TOP_START"),
             ("top_len", "TOP_LENGTH"), ("top_parent", "TOP_PARENT"),
             ("top_orient", "TOP_ORIENT"))


def export_hdf5(archive: HalArchive, path: str) -> None:
    """Write the archive as an HDF5 HAL container."""
    import h5py

    with h5py.File(path, "w") as h5:
        h5.attrs["format"] = "cactus_tpu-hal-hdf5"
        h5.attrs["newick"] = archive.toc.get("newick", "")
        h5.attrs["metadata"] = json.dumps(archive.toc.get("metadata", {}))
        for ev in archive.genomes():
            g = h5.create_group(ev)
            g.attrs["parent"] = archive.parent(ev) or ""
            seqs = archive.sequences(ev)
            g.create_dataset(
                "SEQUENCE_NAMES",
                data=np.array([n for n, _l in seqs],
                              dtype=h5py.string_dtype()))
            g.create_dataset(
                "SEQUENCE_LENGTHS",
                data=np.array([l for _n, l in seqs], np.int64))
            dna = archive.dna(ev)
            codes = (np.concatenate([s.codes for s in dna.values()])
                     if dna else np.zeros(0, np.uint8))
            g.create_dataset("DNA", data=codes,
                             compression="gzip", compression_opts=1)
            arrays = archive.toc["genomes"][ev]["arrays"]
            for src, dst in _BOT_KEYS + _TOP_KEYS:
                if src in arrays:
                    g.create_dataset(
                        dst, data=np.asarray(archive._load(ev, src)),
                        compression="gzip", compression_opts=1)


def import_hdf5(path: str, out_path: str) -> HalArchive:
    """Read an HDF5 HAL container (as written by export_hdf5) back into
    a native .hal archive at out_path."""
    import h5py

    from ..io.fasta import Sequence

    with h5py.File(path, "r") as h5:
        arc = HalArchive.create(
            out_path, newick=str(h5.attrs.get("newick", "")),
            metadata=json.loads(str(h5.attrs.get("metadata", "{}"))))
        for ev in h5:
            g = h5[ev]
            names = [n.decode() if isinstance(n, bytes) else str(n)
                     for n in g["SEQUENCE_NAMES"][()]]
            lens = [int(x) for x in g["SEQUENCE_LENGTHS"][()]]
            codes = np.asarray(g["DNA"][()], np.uint8)
            seqs, pos = {}, 0
            for n, l in zip(names, lens):
                seqs[n] = Sequence(n, codes[pos:pos + l])
                pos += l
            parent = str(g.attrs.get("parent", "")) or None
            arc.add_dna(ev, seqs, parent=parent)
            if "BOTTOM_SEQ" in g:
                arc.set_bottom(ev, g["BOTTOM_SEQ"][()],
                               g["BOTTOM_START"][()],
                               g["BOTTOM_LENGTH"][()],
                               g["BOTTOM_CHILD"][()])
            if "TOP_SEQ" in g:
                arc.set_top(ev, g["TOP_SEQ"][()], g["TOP_START"][()],
                            g["TOP_LENGTH"][()], g["TOP_PARENT"][()],
                            g["TOP_ORIENT"][()])
    return arc
