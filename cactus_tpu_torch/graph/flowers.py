"""Flower hierarchy view — the recursive Flower/Chain/Link/Group
decomposition of the cactus data model, derived from the flat block
graph.

Reference: the C API's central types (api/inc/cactusGlobals.h:31-42,
cactusFlower.c / cactusChain.c / cactusLink.c / cactusGroup.c): a
Flower is one subproblem (net); its Groups are adjacency components of
block ends; Chains are cycles/paths of blocks through those groups;
each internal Group of a chain is a Link, and the sequence hanging
inside a Link forms the child Flower recursively.

The TPU-native pipeline resolves alignment on the FLAT representation
(vectorized pinch columns + XOR-label chains, graph/columns.py and
graph/cactus.py) — that is a deliberate redesign, not a limitation:
there is no per-flower work queue to schedule.  This module derives
the same hierarchy as a read-only VIEW for consumers and checks that
expect the reference's decomposition (flower_checkRecursive-style
invariants, pipeline/cactus_consolidated.c:385-511).

Host-side construction with per-chain loops — a parity/validation
surface, not an inner loop.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .cactus import _end_nodes, cactus_chains, chain_outer_ends
from .columns import Blocks


@dataclass
class Link:
    """An internal chain group: the adjacency component between two
    consecutive chain blocks; may host a child flower."""
    group: int
    child: "Flower | None" = None


@dataclass
class Chain:
    id: int
    blocks: list[int]              # ordered member block ids
    outer_ends: tuple[int, int]    # end ids (2*block [+1])
    links: list[Link] = field(default_factory=list)
    is_cycle: bool = False

    @property
    def length(self) -> int:
        return len(self.blocks)


@dataclass
class Group:
    id: int                        # cactus-graph node id
    ends: list[int]                # member end ids
    is_link: bool = False


@dataclass
class Flower:
    """One net: a set of groups at this nesting level + the chains
    whose outer ends live in them."""
    name: str
    groups: list[Group] = field(default_factory=list)
    chains: list[Chain] = field(default_factory=list)
    parent: "Flower | None" = None

    def recursive_flowers(self) -> list["Flower"]:
        out = [self]
        for ch in self.chains:
            for ln in ch.links:
                if ln.child is not None:
                    out.extend(ln.child.recursive_flowers())
        return out

    def total_blocks(self) -> int:
        return sum(len(c.blocks) for f in self.recursive_flowers()
                   for c in f.chains)


def _chain_block_order(members: list[int], node_of_end: np.ndarray,
                       outer: list[int]) -> tuple[list[int], list[int]]:
    """Order a chain's blocks by walking groups from one outer end.

    Returns (ordered blocks, internal link node ids)."""
    if len(members) == 1:
        return members, []
    # adjacency: node → [(block, entering end)]
    by_node: dict[int, list[tuple[int, int]]] = {}
    for b in members:
        for e in (2 * b, 2 * b + 1):
            by_node.setdefault(int(node_of_end[e]), []).append((b, e))
    start_end = outer[0]
    cur_block = start_end // 2
    cur_exit = cur_block * 2 + (1 - start_end % 2)   # other end
    ordered = [cur_block]
    links: list[int] = []
    used = {cur_block}
    while len(ordered) < len(members):
        node = int(node_of_end[cur_exit])
        nxt = [(b, e) for b, e in by_node.get(node, [])
               if b not in used]
        if not nxt:
            break
        links.append(node)
        b, e = nxt[0]
        ordered.append(b)
        used.add(b)
        cur_exit = b * 2 + (1 - e % 2)
    return ordered, links


def flower_decomposition(caf, name: str = "0") -> Flower:
    """Build the recursive flower view from a CafResult."""
    blocks: Blocks = caf.blocks
    alive = caf.alive
    node_of_end, origin = _end_nodes(blocks, alive)
    chain_id, _lens = cactus_chains(blocks, alive)
    outer = chain_outer_ends(blocks, alive, chain_id)

    # group membership: ends of live blocks per node
    ends_of_node: dict[int, list[int]] = {}
    for b in np.flatnonzero(alive):
        for e in (2 * int(b), 2 * int(b) + 1):
            ends_of_node.setdefault(int(node_of_end[e]), []).append(e)

    # chains with ordered blocks + link nodes
    members: dict[int, list[int]] = {}
    for b in np.flatnonzero(alive):
        members.setdefault(int(chain_id[b]), []).append(int(b))
    chains: dict[int, Chain] = {}
    outer_node_of_chain: dict[int, set[int]] = {}
    for c, blks in members.items():
        oe = outer.get(c)
        if oe is None:            # cycle chain: pick any end as entry
            oe = [2 * blks[0], 2 * blks[0] + 1]
            is_cycle = True
        else:
            is_cycle = False
        ordered, link_nodes = _chain_block_order(blks, node_of_end, oe)
        chains[c] = Chain(id=c, blocks=ordered,
                          outer_ends=(oe[0], oe[1]),
                          links=[Link(group=n) for n in link_nodes],
                          is_cycle=is_cycle)
        outer_node_of_chain[c] = {int(node_of_end[oe[0]]),
                                  int(node_of_end[oe[1]])}

    # hierarchy: root flower owns the origin node; a chain belongs to
    # the flower owning its outer nodes; its link nodes seed child
    # flowers
    owner: dict[int, Flower] = {}
    root = Flower(name=name)
    root_nodes = {int(origin)}
    for n in root_nodes:
        owner[n] = root
    pending = dict(chains)
    progress = True
    while pending and progress:
        progress = False
        for c in list(pending):
            ch = pending[c]
            homes = [owner.get(n) for n in outer_node_of_chain[c]]
            homes = [h for h in homes if h is not None]
            if not homes:
                continue
            fl = homes[0]
            fl.chains.append(ch)
            for n in outer_node_of_chain[c]:
                if n not in owner:
                    owner[n] = fl
            for ln in ch.links:
                if ln.group not in owner:
                    child = Flower(name=f"{fl.name}.{c}.{ln.group}",
                                   parent=fl)
                    ln.child = child
                    owner[ln.group] = child
            del pending[c]
            progress = True
    # disconnected components (no path to origin): top-level flowers
    for c in list(pending):
        ch = pending[c]
        root.chains.append(ch)
        for n in outer_node_of_chain[c]:
            owner.setdefault(n, root)
        for ln in ch.links:
            if ln.group not in owner:
                child = Flower(name=f"{root.name}.{c}.{ln.group}",
                               parent=root)
                ln.child = child
                owner[ln.group] = child
        del pending[c]
    # attach group objects
    for n, fl in owner.items():
        fl.groups.append(Group(id=n, ends=ends_of_node.get(n, []),
                               is_link=any(
                                   ln.group == n
                                   for f2 in [fl.parent] if f2
                                   for c2 in f2.chains
                                   for ln in c2.links)))
    return root


def flower_check_recursive(root: Flower, caf) -> list[str]:
    """flower_checkRecursive-style invariants over the view:

     - every live block appears in exactly one chain;
     - every chain's ordered blocks are connected through shared groups;
     - every group belongs to exactly one flower;
     - child flowers hang off links of their parent.
    """
    errs: list[str] = []
    seen_blocks: dict[int, int] = {}
    seen_groups: dict[int, str] = {}
    node_of_end, _origin = _end_nodes(caf.blocks, caf.alive)
    for fl in root.recursive_flowers():
        for g in fl.groups:
            if g.id in seen_groups:
                errs.append(f"group {g.id} in two flowers "
                            f"({seen_groups[g.id]}, {fl.name})")
            seen_groups[g.id] = fl.name
        for ch in fl.chains:
            for b in ch.blocks:
                if b in seen_blocks:
                    errs.append(f"block {b} in two chains")
                seen_blocks[b] = ch.id
            for b1, b2 in zip(ch.blocks, ch.blocks[1:]):
                n1 = {int(node_of_end[2 * b1]),
                      int(node_of_end[2 * b1 + 1])}
                n2 = {int(node_of_end[2 * b2]),
                      int(node_of_end[2 * b2 + 1])}
                if not (n1 & n2):
                    errs.append(f"chain {ch.id}: consecutive blocks "
                                f"{b1},{b2} share no group")
        for ch in fl.chains:
            for ln in ch.links:
                if ln.child is not None and ln.child.parent is not fl:
                    errs.append(f"child flower {ln.child.name} has "
                                "wrong parent")
    live = set(int(b) for b in np.flatnonzero(caf.alive))
    missing = live - set(seen_blocks)
    if missing:
        errs.append(f"{len(missing)} live blocks not in any chain")
    return errs
