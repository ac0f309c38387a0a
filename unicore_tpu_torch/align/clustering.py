"""Clustering of the alignment graph.

Equivalent of foldseek's clustering stage inside `foldseek cluster`
(cluster.rs:43-55).  Edges are alignment hits that passed coverage /
E-value gating; algorithms:

  * greedy set cover (foldseek/mmseqs --cluster-mode 0, the default):
    repeatedly pick the node covering the most uncovered nodes as a
    representative and assign its uncovered neighbors to it
  * connected components (--cluster-mode 1-ish fallback)

Determinism: ties broken by lowest node index, so the output is stable
across runs/hosts regardless of edge discovery order.
"""

from __future__ import annotations

import heapq
from typing import Dict, Iterable, List, Tuple


def greedy_set_cover(n: int, edges: Iterable[Tuple[int, int]]) -> Dict[int, List[int]]:
    """Return {representative: [members...]} covering all n nodes.

    Every node is implicitly connected to itself.  Members lists start
    with the representative itself (foldseek createtsv emits the rep as
    its own member, cluster.rs:59-64 contract).
    """
    adj: List[set] = [set() for _ in range(n)]
    for a, b in edges:
        if a == b:
            continue
        adj[a].add(b)
        adj[b].add(a)

    covered = [False] * n
    # max-heap keyed by (degree+1, -idx); lazy deletion
    heap = [(-(len(adj[i]) + 1), i) for i in range(n)]
    heapq.heapify(heap)
    clusters: Dict[int, List[int]] = {}
    ncovered = 0

    while ncovered < n and heap:
        negdeg, i = heapq.heappop(heap)
        if covered[i]:
            continue
        # recompute current uncovered-degree; lazy heap entries may be stale
        cur = sum(1 for j in adj[i] if not covered[j]) + 1
        if -negdeg != cur:
            heapq.heappush(heap, (-cur, i))
            continue
        members = [i]
        covered[i] = True
        ncovered += 1
        for j in sorted(adj[i]):
            if not covered[j]:
                covered[j] = True
                ncovered += 1
                members.append(j)
        clusters[i] = members
    # any straggler (isolated, already covered race) becomes a singleton
    for i in range(n):
        if not covered[i]:
            clusters[i] = [i]
            covered[i] = True
    return clusters


def connected_components(n: int, edges: Iterable[Tuple[int, int]]) -> Dict[int, List[int]]:
    parent = list(range(n))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in edges:
        ra, rb = find(a), find(b)
        if ra != rb:
            if ra < rb:
                parent[rb] = ra
            else:
                parent[ra] = rb
    comps: Dict[int, List[int]] = {}
    for i in range(n):
        comps.setdefault(find(i), []).append(i)
    # representative = lowest index (== the root by construction)
    return {root: sorted(members) for root, members in comps.items()}


def write_cluster_tsv(
    path: str, clusters: Dict[int, List[int]], names: List[str]
) -> None:
    """clust.tsv: "representative\tmember" grouped by representative
    (profile.rs:55 depends on this grouping)."""
    with open(path, "w") as f:
        for rep in sorted(clusters):
            rep_name = names[rep]
            for m in clusters[rep]:
                f.write(f"{rep_name}\t{names[m]}\n")
