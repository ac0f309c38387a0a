"""ML tree search: NNI hill-climbing with batched candidate evaluation.

Copy of unicore_tpu/phylo/search.py (host logic) over the port's
LikelihoodEngine: every NNI round builds ALL neighbor topologies as
array-encoded trees and scores them in one batched device pass
(phylo/likelihood.py), or, from 48 taxa, through the incremental
partial-CLV chains.  Branch lengths ride along with their subtrees
(standard NNI approximation) and are re-optimized jointly (autodiff +
adam) after each accepted move.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Tuple

import numpy as np

from unicore_tpu_torch.phylo.likelihood import (
    LikelihoodEngine,
    arrays_to_tree,
    make_root_binary,
    tree_to_arrays,
    unroot,
)
from unicore_tpu_torch.phylo.newick import Node, bipartitions
from unicore_tpu_torch.runtime import logging as msg


def copy_tree(root: Node) -> Node:
    new = Node(root.name, root.length)
    new.support = root.support
    for c in root.children:
        new.add(copy_tree(c))
    return new


def nni_neighbors(root: Node) -> List[Node]:
    """All NNI rearrangements of a binary rooted tree (as new trees).

    Includes the ROOT-EDGE rearrangements: for the unrooted edge the
    root sits on (subtrees A,B | C,D around it), swapping a child of one
    root child with the ENTIRE other root child is only a re-rooting
    no-op — the genuine rearrangements swap B with C or D.  Without
    them the per-round neighborhood is incomplete in a rooting-dependent
    way (measured round 5: a restricted polish could not remove a split
    whose edge carried the root, because no candidate rearranged it)."""
    out: List[Node] = []
    # index nodes by postorder position for stable addressing in copies
    def paths(node: Node, path: Tuple[int, ...]) -> List[Tuple[Tuple[int, ...], Node]]:
        acc = [(path, node)]
        for ci, c in enumerate(node.children):
            acc.extend(paths(c, path + (ci,)))
        return acc

    def get(node: Node, path: Tuple[int, ...]) -> Node:
        for p in path:
            node = node.children[p]
        return node

    for path, v in paths(root, ()):
        if v is root or v.is_leaf or v.parent is None:
            continue
        u = v.parent
        # sibling of v
        sib_idx = 1 - u.children.index(v)
        for child_idx in range(2):
            t = copy_tree(root)
            v2 = get(t, path)
            u2 = v2.parent
            c2 = v2.children[child_idx]
            s2 = u2.children[sib_idx]
            # swap c2 and s2
            v2.children[child_idx] = s2
            s2.parent = v2
            u2.children[sib_idx] = c2
            c2.parent = u2
            out.append(t)

    # root-edge NNIs (both root children internal; 2 distinct unrooted
    # rearrangements — the other two child pairings are their mirrors)
    if len(root.children) == 2 and not root.children[0].is_leaf \
            and not root.children[1].is_leaf:
        for r_idx in range(2):
            t = copy_tree(root)
            L2 = t.children[0]
            R2 = t.children[1]
            b2 = L2.children[1]
            c2 = R2.children[r_idx]
            L2.children[1] = c2
            c2.parent = L2
            R2.children[r_idx] = b2
            b2.parent = R2
            out.append(t)
    return out


def nni_moves_arrays(children: np.ndarray, n: int):
    """Enumerate NNI moves directly on the array encoding with STABLE
    node ids: (v, u, child_idx, sib_idx) swaps children[v][child_idx]
    with children[u][sib_idx] where u = parent(v).  Same move set as
    nni_neighbors, but consumable by the incremental evaluator
    (LikelihoodEngine.loglik_nni_moves) without renumbering."""
    parent = np.zeros(2 * n - 1, dtype=np.int64)
    for k in range(n - 1):
        parent[children[k, 0]] = k + n
        parent[children[k, 1]] = k + n
    moves = []
    for v in range(n, 2 * n - 2):  # internal, non-root
        u = int(parent[v])
        sib_idx = 0 if int(children[u - n, 1]) == v else 1
        for child_idx in (0, 1):
            moves.append((v, u, child_idx, sib_idx))
    # root-edge NNIs (see nni_neighbors): swap a child of root-child L
    # with a child of root-child R.  The (v, u, child_idx, sib_idx)
    # encoding generalizes — u is simply the OTHER node of the edge, and
    # the incremental evaluator's chain [v, u, ancestors-of-u] is the
    # correct dependency order (ancestors of R = the root, whose
    # children rows reference both L and R by stable id).
    root = 2 * n - 2
    L, R = int(children[root - n, 0]), int(children[root - n, 1])
    if L >= n and R >= n:
        moves.append((L, R, 1, 0))
        moves.append((L, R, 1, 1))
    return moves


def apply_nni_move(children: np.ndarray, move) -> np.ndarray:
    """Apply a move from nni_moves_arrays; ids unchanged (the result may
    violate the children<parent postorder convention — canonicalize via
    arrays_to_tree -> tree_to_arrays before feeding global evaluators)."""
    v, u, child_idx, sib_idx = move
    n = children.shape[0] + 1
    out = children.copy()
    c = out[v - n, child_idx]
    out[v - n, child_idx] = out[u - n, sib_idx]
    out[u - n, sib_idx] = c
    return out


def random_nni_walk(root: Node, rng, n_moves: int) -> Node:
    """n random NNI moves applied IN PLACE on a copy — O(n) per move
    (no neighbor enumeration), for cheap bulk candidate generation."""
    t = copy_tree(root)

    def internal_nodes(node: Node, out: List[Node]) -> List[Node]:
        for c in node.children:
            if not c.is_leaf:
                out.append(c)
                internal_nodes(c, out)
        return out

    for _ in range(n_moves):
        cands = [v for v in internal_nodes(t, []) if v.parent is not None]
        if not cands:
            break
        v = cands[rng.randint(len(cands))]
        u = v.parent
        sib_idx = 1 - u.children.index(v)
        child_idx = rng.randint(2)
        c = v.children[child_idx]
        s = u.children[sib_idx]
        v.children[child_idx] = s
        s.parent = v
        u.children[sib_idx] = c
        c.parent = u
    return t


class TreeSearch:
    def __init__(self, engine: LikelihoodEngine, seed: int = 12345):
        self.engine = engine
        self.rng = np.random.RandomState(seed)

    # ------------------------------------------------------------------
    def optimize(
        self,
        start: Node,
        max_rounds: int = 20,
        blen_steps: int = 150,
    ) -> Tuple[Node, float]:
        """NNI hill-climb from a starting (unrooted ok) tree."""
        eng = self.engine
        full_eng = eng
        sub_search = False
        if hasattr(eng, "tips"):
            from unicore_tpu_torch.phylo.likelihood import (
                SEARCH_PATTERN_CAP, subsampled_engine,
            )
            if int(eng.tips.shape[1]) > 2 * SEARCH_PATTERN_CAP:
                # supermatrix scale: search topology on a weighted
                # pattern subsample (unbiased RELL-style estimator;
                # also restores the incremental NNI path's memory
                # budget); final blens/lnL re-optimized on full data
                eng = subsampled_engine(eng, seed=12345)
                sub_search = eng is not full_eng
        root = make_root_binary(copy_tree(start))
        children, blens = tree_to_arrays(root, eng.names)
        blens, ll = eng.optimize_blens(children, blens, steps=blen_steps)
        msg.println_message(f"  start lnL = {ll:.4f}", 4)

        # Incremental (partial-CLV) candidate evaluation pays off once
        # the tree is large: full re-evaluation is O(n) CLV updates per
        # candidate x ~2n candidates = O(n^2) per round; the chain path
        # is O(depth) per candidate.  Small trees keep the simpler
        # full-batch path (also the reference implementation the
        # incremental path is tested against).
        use_inc = hasattr(eng, "loglik_nni_moves") and eng.n >= 48
        if use_inc and hasattr(eng, "tips"):
            # the incremental path caches the FULL base-CLV buffer
            # ((2n-1, C, P, 20) f32); for supermatrix-scale pattern
            # counts that buffer alone exceeds device memory — fall back
            # to the full-batch path, which pattern-chunks internally
            # (likelihood.pattern_chunk_for; config-4 OOM, round 4)
            from unicore_tpu_torch.phylo.likelihood import pattern_chunk_for
            if pattern_chunk_for(eng.n, int(eng._mp["rates"].shape[0]),
                                 int(eng.tips.shape[1])):
                use_inc = False

        for rnd in range(max_rounds):
            if use_inc:
                moves = nni_moves_arrays(children, eng.n)
                if not moves:
                    break
                lls = eng.loglik_nni_moves(children, blens, moves)
                best = int(np.argmax(lls))
                # canonicalize the winning move's arrays (renumber to
                # postorder) for the global evaluators
                cand_children = apply_nni_move(children, moves[best])
                t = arrays_to_tree(cand_children, blens, eng.names)
                cbest, bbest = tree_to_arrays(t, eng.names)
                cb = np.asarray(cbest)[None]
                bb = np.asarray(bbest)[None]
                lls = np.asarray([lls[best]])
                best = 0
            else:
                root = arrays_to_tree(children, blens, eng.names)
                cands = nni_neighbors(root)
                if not cands:
                    break
                arr = [tree_to_arrays(c, eng.names) for c in cands]
                cb = np.stack([a[0] for a in arr])
                bb = np.stack([a[1] for a in arr])
                lls = eng.loglik_batch(cb, bb)
                best = int(np.argmax(lls))
            if lls[best] <= ll + 1e-4:
                # no strictly-better neighbor under fixed branch lengths;
                # re-optimize the best candidate's lengths before giving up
                nb, nll = eng.optimize_blens(cb[best], bb[best], steps=blen_steps)
                if nll > ll + 1e-4:
                    children, blens, ll = cb[best], nb, nll
                    continue
                break
            children, blens = cb[best], bb[best]
            blens, ll = eng.optimize_blens(children, blens, steps=blen_steps)
            msg.println_message(f"  NNI round {rnd + 1}: lnL = {ll:.4f}", 4)

        if sub_search:
            # topology fixed on the subsample; branch lengths and the
            # reported lnL come from the FULL data (pattern-chunked)
            blens, ll = full_eng.optimize_blens(children, blens,
                                                steps=blen_steps)
        return arrays_to_tree(children, blens, eng.names), ll

    # ------------------------------------------------------------------
    def polish_edges(
        self, tree: Node, full_eng, low_keys, blen_steps: int = 150,
        max_rounds: int = 5,
    ) -> Tuple[Node, float, bool]:
        """FULL-data NNI polish restricted to the moves that rearrange
        the given (low-support) bipartitions.

        Rationale (config-4, round 5): at supermatrix scale topology
        search runs on a weighted pattern subsample; the 3 splits it got
        wrong all received UFBoot support 0.0 while every true split
        averaged 99.5 — i.e. the FULL data prefers the true topology and
        the subsampled climb merely stopped short.  Evaluating the
        full-data likelihood for the handful of NNI alternatives around
        low-support edges (fixed branch lengths, pattern-chunked
        loglik_batch; an improvement at fixed lengths is a lower bound
        of the re-optimized one) recovers them at a cost of one small
        candidate batch per round instead of full-neighborhood rounds.

        Splits CREATED by accepted polish moves are themselves unvetted
        and join the low set, so a wrong replacement can be revisited.
        Returns (tree, lnL, changed)."""
        root = make_root_binary(copy_tree(tree))
        children, blens = tree_to_arrays(root, full_eng.names)
        blens, ll = full_eng.optimize_blens(children, blens, steps=blen_steps)
        low = set(low_keys)
        base0 = set(bipartitions(arrays_to_tree(
            children, blens, full_eng.names)).keys())
        changed = False
        for _ in range(max_rounds):
            root = arrays_to_tree(children, blens, full_eng.names)
            base_bips = set(bipartitions(root).keys())
            targets = low | (base_bips - base0)
            cands = []
            for c in nni_neighbors(root):
                removed = base_bips - set(bipartitions(c).keys())
                if removed and removed <= targets:
                    cands.append(c)
            if not cands:
                break
            # rank by SHORT branch-length re-optimization, not fixed
            # lengths: an NNI move's fixed-blens score misranks when the
            # rearranged edges need new lengths, and polish candidate
            # sets are small (2 moves per low edge) so per-candidate
            # re-opt is affordable
            arr = [tree_to_arrays(c, full_eng.names) for c in cands]
            scored = []
            for cc, bb0 in arr:
                nb, nll = full_eng.optimize_blens(
                    cc, bb0, steps=min(blen_steps, 40))
                scored.append((nll, cc, nb))
            nll, cb_best, nb_best = max(scored, key=lambda t: t[0])
            if nll <= ll + 1e-4:
                break
            children, blens = cb_best, nb_best
            blens, ll = full_eng.optimize_blens(
                children, blens, steps=blen_steps)
            changed = True
            msg.println_message(f"  polish: lnL = {ll:.4f}", 4)
        return arrays_to_tree(children, blens, full_eng.names), ll, changed

    # ------------------------------------------------------------------
    def perturb(self, root: Node, n_moves: int = 3) -> Node:
        """Random NNI moves (for raxml-style multi-start)."""
        t = make_root_binary(copy_tree(root))
        for _ in range(n_moves):
            cands = nni_neighbors(t)
            if not cands:
                break
            t = cands[self.rng.randint(len(cands))]
        return t
