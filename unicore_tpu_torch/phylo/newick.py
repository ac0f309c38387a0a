"""Phylogenetic tree structure + Newick serialization.

Unrooted binary trees are stored rooted at an arbitrary internal node
(standard practice); Newick output matches IQ-TREE/FastTree conventions:
`(A:0.1,B:0.2,(C:0.3,D:0.4)95:0.05);` with optional integer support
values on internal nodes.

Copy of unicore_tpu/phylo/newick.py (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Set, Tuple


class Node:
    __slots__ = ("name", "length", "support", "children", "parent")

    def __init__(self, name: Optional[str] = None, length: float = 0.0):
        self.name = name
        self.length = length
        self.support: Optional[float] = None
        self.children: List["Node"] = []
        self.parent: Optional["Node"] = None

    def add(self, child: "Node") -> "Node":
        child.parent = self
        self.children.append(child)
        return child

    @property
    def is_leaf(self) -> bool:
        return not self.children

    def leaves(self) -> List["Node"]:
        if self.is_leaf:
            return [self]
        out = []
        for c in self.children:
            out.extend(c.leaves())
        return out

    def postorder(self) -> List["Node"]:
        out = []
        for c in self.children:
            out.extend(c.postorder())
        out.append(self)
        return out

    # ------------------------------------------------------------------
    def to_newick(self, with_support: bool = True, with_lengths: bool = True) -> str:
        return self._nwk(with_support, with_lengths, root=True) + ";"

    def _nwk(self, ws: bool, wl: bool, root: bool = False) -> str:
        if self.is_leaf:
            s = self.name or ""
        else:
            s = "(" + ",".join(c._nwk(ws, wl) for c in self.children) + ")"
            if ws and self.support is not None and not root:
                s += f"{int(round(self.support))}"
            elif self.name and not root:
                s += self.name
        if wl and not root:
            s += f":{self.length:.10g}"
        return s


def parse_newick(text: str) -> Node:
    text = text.strip()
    if text.endswith(";"):
        text = text[:-1]
    pos = 0

    def parse_node() -> Node:
        nonlocal pos
        node = Node()
        if text[pos] == "(":
            pos += 1
            while True:
                node.add(parse_node())
                if text[pos] == ",":
                    pos += 1
                    continue
                if text[pos] == ")":
                    pos += 1
                    break
            # optional label (support or name)
            label = _read_token()
            if label:
                try:
                    node.support = float(label)
                except ValueError:
                    node.name = label
        else:
            node.name = _read_token()
        if pos < len(text) and text[pos] == ":":
            pos += 1
            node.length = float(_read_token())
        return node

    def _read_token() -> str:
        nonlocal pos
        start = pos
        while pos < len(text) and text[pos] not in ",():;":
            pos += 1
        return text[start:pos]

    return parse_node()


# ---------------------------------------------------------------------------
# Bipartitions (for support mapping and topology comparison)
# ---------------------------------------------------------------------------

def bipartitions(root: Node, restrict: FrozenSet[str] = None) -> Dict[FrozenSet[str], Node]:
    """Map non-trivial bipartition (smaller-side leaf set, canonicalized) ->
    internal node inducing it.

    `restrict`: leaf-name subset — bipartitions of the subtree INDUCED
    on those leaves (each side intersected; trivial/duplicate splits
    collapse), the standard construction for comparing trees on
    non-identical taxon sets (per-gene trees vs a species tree where
    some species lack the gene, genetree.rs:113-143 analog)."""
    all_leaves = frozenset(l.name for l in root.leaves())
    if restrict is not None:
        all_leaves = all_leaves & frozenset(restrict)
    out: Dict[FrozenSet[str], Node] = {}
    for node in root.postorder():
        if node is root or node.is_leaf:
            continue
        below = frozenset(l.name for l in node.leaves())
        if restrict is not None:
            below = below & all_leaves
        other = all_leaves - below
        if len(below) < 2 or len(other) < 2:
            continue
        key = min(below, other, key=lambda s: (len(s), sorted(s)))
        out[frozenset(key)] = node
    return out


def rf_distance(a: Node, b: Node) -> int:
    """Robinson-Foulds distance (symmetric difference of bipartitions)."""
    ba = set(bipartitions(a).keys())
    bb = set(bipartitions(b).keys())
    return len(ba ^ bb)
