"""Alignment update flows: add / replace / remove genomes.

Reference: cactus-update-prepare generates plans to add a genome to a
node or branch of an existing HAL, or replace/remove one, using
halReplaceGenome / halAppendSubtree (update/cactus_update_prepare.py:
456-483,671).  Here updates operate on the AlignmentStore directly:
the guide tree is edited, every ancestor step on the path from the
touched node to the root is invalidated, and a re-run recomputes only
those steps (checkpoint resume covers the rest).  The re-run's device
work runs on `device` (None: the current CUDA device).  store.py is the
JAX package's, byte for byte, so either package updates a store the
other wrote.
"""

from __future__ import annotations

import os

from .config import Config
from .io.fasta import Sequence
from .progressive import ProgressiveAligner, ProgressiveResult
from .store import AlignmentStore
from .utils.trees import Tree


def _invalidate_to_root(store: AlignmentStore, tree: Tree,
                        event: str) -> list[str]:
    """Remove checkpoints for every ancestor on event→root (inclusive)."""
    node = tree.find(event)
    if node is None:
        raise KeyError(f"{event} not in the alignment tree")
    dropped = []
    n = node if not node.is_leaf() else node.parent
    while n is not None:
        for suffix in (".npz", ".json"):
            p = os.path.join(store.root, "steps", n.name + suffix)
            if os.path.exists(p):
                os.remove(p)
        g = os.path.join(store.root, "genomes", n.name + ".npz")
        if os.path.exists(g):
            os.remove(g)
        dropped.append(n.name)
        n = n.parent
    return dropped


def add_genome(store: AlignmentStore, event: str,
               genome: dict[str, Sequence], parent_event: str,
               branch_length: float = 0.1,
               config: Config | None = None,
               min_chain_override: int | None = None,
               log=lambda m: None, device=None) -> ProgressiveResult:
    """Add a new leaf under `parent_event` (add-to-node) and re-align the
    affected ancestors."""
    tree = store.load_tree()
    parent = tree.find(parent_event)
    if parent is None:
        raise KeyError(f"parent event {parent_event} not in tree")
    if tree.find(event) is not None:
        raise ValueError(f"genome {event} already present")
    parent.add_child(Tree(event, branch_length))
    store.save_tree(tree)
    store.save_genome(event, genome)
    dropped = _invalidate_to_root(store, tree, parent_event)
    log(f"add {event} under {parent_event}; recomputing {dropped}")
    return _rerun(store, tree, config, min_chain_override, log, device)


def add_genome_to_branch(store: AlignmentStore, event: str,
                         genome: dict[str, Sequence], sibling_event: str,
                         branch_length: float = 0.1,
                         ancestor_name: str | None = None,
                         split_frac: float = 0.5,
                         config: Config | None = None,
                         min_chain_override: int | None = None,
                         log=lambda m: None, device=None
                         ) -> ProgressiveResult:
    """Add a new leaf to the BRANCH above `sibling_event` (halAddToBranch
    analog, update/cactus_update_prepare.py add --branch): a new ancestor
    splits that branch at `split_frac` of its length, and the new leaf
    attaches to it."""
    tree = store.load_tree()
    sib = tree.find(sibling_event)
    if sib is None or sib.parent is None:
        raise KeyError(f"{sibling_event} has no branch above it")
    if tree.find(event) is not None:
        raise ValueError(f"genome {event} already present")
    anc_name = ancestor_name or f"anc_{event}"
    if tree.find(anc_name) is not None:
        raise ValueError(f"ancestor name {anc_name} already present")
    parent = sib.parent
    old_len = sib.length or 0.0
    anc = Tree(anc_name, old_len * (1.0 - split_frac))
    parent.children[parent.children.index(sib)] = anc
    anc.parent = parent
    sib.length = old_len * split_frac
    anc.children = [sib]
    sib.parent = anc
    anc.add_child(Tree(event, branch_length))
    store.save_tree(tree)
    store.save_genome(event, genome)
    dropped = _invalidate_to_root(store, tree, sibling_event)
    log(f"add {event} to branch above {sibling_event} (new ancestor "
        f"{anc_name}); recomputing {dropped}")
    return _rerun(store, tree, config, min_chain_override, log, device)


def replace_genome(store: AlignmentStore, event: str,
                   genome: dict[str, Sequence],
                   config: Config | None = None,
                   min_chain_override: int | None = None,
                   log=lambda m: None, device=None) -> ProgressiveResult:
    """Swap a leaf's sequences (halReplaceGenome analog)."""
    tree = store.load_tree()
    node = tree.find(event)
    if node is None or not node.is_leaf():
        raise KeyError(f"{event} is not a leaf of the alignment")
    store.save_genome(event, genome)
    dropped = _invalidate_to_root(store, tree, event)
    log(f"replace {event}; recomputing {dropped}")
    return _rerun(store, tree, config, min_chain_override, log, device)


def remove_genome(store: AlignmentStore, event: str,
                  config: Config | None = None,
                  min_chain_override: int | None = None,
                  log=lambda m: None, device=None) -> ProgressiveResult:
    """Drop a leaf; a parent left with one child collapses into it."""
    tree = store.load_tree()
    node = tree.find(event)
    if node is None or not node.is_leaf() or node.parent is None:
        raise KeyError(f"{event} is not a removable leaf")
    parent = node.parent
    dropped = _invalidate_to_root(store, tree, event)
    parent.children.remove(node)
    if len(parent.children) == 1:
        only = parent.children[0]
        if parent.parent is not None:
            # collapse degree-2 ancestor: child inherits summed length
            only.length = (only.length or 0.0) + (parent.length or 0.0)
            gp = parent.parent
            gp.children[gp.children.index(parent)] = only
            only.parent = gp
        else:
            # the ROOT went degree-2: the surviving subtree becomes the
            # whole alignment (halRemoveGenome semantics when a root
            # child is dropped)
            if only.is_leaf():
                raise ValueError(
                    f"removing {event} would leave a single genome "
                    f"({only.name}); an alignment needs at least two")
            only.parent = None
            only.length = None
            tree = only
    g = os.path.join(store.root, "genomes", event + ".npz")
    if os.path.exists(g):
        os.remove(g)
    store.save_tree(tree)
    log(f"remove {event}; recomputing {dropped}")
    return _rerun(store, tree, config, min_chain_override, log, device)


def _rerun(store: AlignmentStore, tree: Tree, config, min_chain_override,
           log, device=None) -> ProgressiveResult:
    genomes = {}
    for node in tree.preorder():
        if node.is_leaf():
            genomes[node.name] = store.load_genome(node.name)
    aligner = ProgressiveAligner(tree, genomes, config=config,
                                 min_chain_override=min_chain_override,
                                 store=store, log=log, device=device)
    return aligner.run()


def refresh_archive(path: str, result: ProgressiveResult,
                    log=lambda m: None) -> None:
    """Rewrite the durable HAL archive after an update (the reference
    re-runs halReplaceGenome / halAppendSubtree against the HDF5 HAL;
    the incremental work already happened in the store rerun, so the
    archive export is a straight dump of the refreshed result)."""
    from .hal_archive import HalArchive
    HalArchive.from_result(path, result)
    log(f"refreshed HAL archive {path}")
