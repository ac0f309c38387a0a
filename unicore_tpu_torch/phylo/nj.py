"""Neighbor-joining starting trees from corrected pairwise distances.

Copy of unicore_tpu/phylo/nj.py (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

from typing import List

import numpy as np

from unicore_tpu_torch.alphabets import encode_aa
from unicore_tpu_torch.phylo.newick import Node


def protein_distances(names: List[str], seqs: List[str]) -> np.ndarray:
    """Poisson-corrected p-distances over shared non-gap columns."""
    n = len(seqs)
    codes = np.stack([encode_aa(s) for s in seqs])
    valid = codes < 20
    D = np.zeros((n, n))
    for i in range(n):
        both = valid[i] & valid
        shared = both.sum(axis=1).astype(np.float64)
        diff = ((codes[i] != codes) & both).sum(axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            p = np.where(shared > 0, diff / np.maximum(shared, 1), 0.75)
        p = np.clip(p, 0.0, 0.95 * 19 / 20)
        d = -19.0 / 20.0 * np.log(1.0 - 20.0 * p / 19.0)
        D[i] = d
    np.fill_diagonal(D, 0.0)
    return (D + D.T) / 2.0


def neighbor_joining(D: np.ndarray, names: List[str]) -> Node:
    """Classic NJ; returns an unrooted tree (trifurcating root)."""
    n = len(names)
    if n == 1:
        return Node(names[0])
    if n == 2:
        root = Node()
        a = root.add(Node(names[0], D[0, 1] / 2))
        b = root.add(Node(names[1], D[0, 1] / 2))
        return root

    d = D.astype(np.float64).copy()
    nodes = [Node(nm) for nm in names]
    active = list(range(n))

    while len(active) > 3:
        m = len(active)
        sub = d[np.ix_(active, active)]
        r = sub.sum(axis=1)
        Q = (m - 2) * sub - r[:, None] - r[None, :]
        np.fill_diagonal(Q, np.inf)
        ai, aj = np.unravel_index(np.argmin(Q), Q.shape)
        if ai > aj:
            ai, aj = aj, ai
        i, j = active[ai], active[aj]
        dij = d[i, j]
        li = 0.5 * dij + (r[ai] - r[aj]) / (2 * (m - 2))
        lj = dij - li
        li = max(li, 0.0)
        lj = max(lj, 0.0)
        parent = Node()
        nodes[i].length = li
        nodes[j].length = lj
        parent.add(nodes[i])
        parent.add(nodes[j])
        # distances to the new node
        for kx in active:
            if kx in (i, j):
                continue
            d[i, kx] = d[kx, i] = 0.5 * (d[i, kx] + d[j, kx] - dij)
        nodes[i] = parent
        active.remove(j)

    # join the last three into the root trifurcation
    i, j, k = active
    root = Node()
    nodes[i].length = max(0.5 * (d[i, j] + d[i, k] - d[j, k]), 0.0)
    nodes[j].length = max(0.5 * (d[j, i] + d[j, k] - d[i, k]), 0.0)
    nodes[k].length = max(0.5 * (d[k, i] + d[k, j] - d[i, j]), 0.0)
    root.add(nodes[i])
    root.add(nodes[j])
    root.add(nodes[k])
    return root
