"""RELL / UFBoot-style bootstrap supports.

Copy of unicore_tpu/phylo/bootstrap.py (host logic) over the port's
LikelihoodEngine.  IQ-TREE's ultrafast bootstrap evaluates candidate
trees on bootstrap-resampled site likelihoods: with per-pattern
log-likelihood vectors for T candidate trees stacked as (T, P) and R
multinomial weight columns (P, R), per-replicate tree scores are ONE
matrix product (T, P) @ (P, R); the per-replicate winner is an argmax
down the T axis.  Support of a bipartition in the ML tree = fraction of
replicates won by a tree containing it.  The replicate weights come from
numpy's RandomState(seed), so they equal the JAX package's.

Contract: `-B 1000` (iqtree), `-boot 1000` (fasttree), `--all`
(raxml-ng) — tree.rs:143-146.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from unicore_tpu_torch.phylo.newick import Node, bipartitions


def bootstrap_weights(
    pattern_weights: np.ndarray, n_reps: int, seed: int = 12345
) -> np.ndarray:
    """(P, R) multinomial resample counts with n = total sites."""
    rng = np.random.RandomState(seed)
    L = int(round(pattern_weights.sum()))
    probs = pattern_weights / pattern_weights.sum()
    out = rng.multinomial(L, probs, size=n_reps).T.astype(np.float32)  # (P, R)
    return out


def ufboot_supports(
    engine,
    best_tree: Node,
    n_boot: int = 1000,
    seed: int = 12345,
    max_rounds: int = 8,
) -> Node:
    """Per-replicate bootstrap (true `-B 1000` semantics, tree.rs:143).

    IQ-TREE's UFBoot optimizes a tree PER REPLICATE; the round-2 pool-RELL
    approximation scored a fixed candidate set, so splits outside the
    sampled pool could never lose.  Here every replicate follows its own
    weighted NNI hill-climb:

      * replicate r's objective is  site_ll(tree) . w_r  with w_r a
        multinomial resample of the pattern weights;
      * each round expands the NNI neighborhood of every topology that is
        currently some replicate's best (deduplicated by bipartition
        set), evaluates the new topologies' per-pattern log-likelihoods
        in one batched device pass, and lets EVERY replicate adopt any
        new topology that beats its current best under ITS weights
        (scores for all replicates = one (T_new, P) @ (P, R) matmul);
      * convergence: rounds stop when no replicate improves.

    Per-replicate trajectories diverge after round one, so deep splits
    genuinely lose replicates that resample against them.  Support of a
    split = fraction of replicates whose final tree contains it.
    """
    from unicore_tpu_torch.phylo.likelihood import (
        SEARCH_PATTERN_CAP, arrays_to_tree, make_root_binary,
        subsampled_engine, tree_to_arrays,
    )
    from unicore_tpu_torch.phylo.search import (
        apply_nni_move, copy_tree, nni_moves_arrays,
    )

    if hasattr(engine, "tips") and \
            int(engine.tips.shape[1]) > 2 * SEARCH_PATTERN_CAP:
        # supermatrix scale: replicate climbs on the weighted pattern
        # subsample (site resampling OF an unbiased site resample — the
        # support signal survives; full-data climbs would be TFLOP-hours
        # of 20-wide einsums per round)
        engine = subsampled_engine(engine, seed=seed)
    n = engine.n
    W = bootstrap_weights(
        np.asarray(engine.weights, dtype=np.float64), n_boot, seed
    )  # (P, R)

    children_l: list = []
    blens_l: list = []
    keys_l: list = []
    seen = {}

    def add_topo(tree: Node):
        key = frozenset(bipartitions(tree).keys())
        if key in seen:
            return None
        cb, bb = tree_to_arrays(tree, engine.names)
        seen[key] = len(children_l)
        children_l.append(cb)
        blens_l.append(bb)
        keys_l.append(key)
        return seen[key]

    rooted = make_root_binary(copy_tree(best_tree))
    add_topo(rooted)
    sl0 = engine.site_loglik(children_l[0], blens_l[0])[None]  # (1, P)
    scores0 = sl0.astype(np.float64) @ W  # (1, R)
    rep_best = np.zeros(W.shape[1], dtype=np.int64)
    rep_score = scores0[0]

    expanded: set = set()
    for _ in range(max_rounds):
        frontier = [t for t in np.unique(rep_best) if t not in expanded]
        if not frontier:
            break
        new_idx: list = []
        for ti in frontier:
            expanded.add(int(ti))
            base_c, base_b = children_l[ti], blens_l[ti]
            for move in nni_moves_arrays(base_c, n):
                cand = apply_nni_move(base_c, move)
                t = arrays_to_tree(cand, base_b, engine.names)
                idx = add_topo(t)
                if idx is not None:
                    new_idx.append(idx)
        if not new_idx:
            break
        cb = np.stack([children_l[i] for i in new_idx])
        bb = np.stack([blens_l[i] for i in new_idx])
        if hasattr(engine, "site_loglik_batch"):
            sl = engine.site_loglik_batch(cb, bb)  # (T_new, P)
        else:
            sl = np.stack([engine.site_loglik(c, b) for c, b in zip(cb, bb)])
        scores = sl.astype(np.float64) @ W  # (T_new, R)
        col_best = scores.max(axis=0)
        col_arg = scores.argmax(axis=0)
        improved = col_best > rep_score
        if not improved.any():
            break
        rep_best = np.where(improved, np.asarray(new_idx)[col_arg], rep_best)
        rep_score = np.maximum(rep_score, col_best)

    final_bp = bipartitions(best_tree)
    rep_keys = [keys_l[i] for i in rep_best]
    for bp, node in final_bp.items():
        node.support = 100.0 * float(np.mean([bp in k for k in rep_keys]))
    return best_tree


def rell_supports(
    final_tree: Node,
    candidate_trees: Sequence[Node],
    site_logliks: np.ndarray,  # (T, P)
    pattern_weights: np.ndarray,  # (P,)
    n_reps: int = 1000,
    seed: int = 12345,
) -> Node:
    """Annotate the final tree's internal nodes with bootstrap supports."""
    T, P = site_logliks.shape
    W = bootstrap_weights(pattern_weights, n_reps, seed)  # (P, R)
    scores = np.asarray(site_logliks, np.float32) @ W  # (T, R), float32
    winners = np.argmax(scores, axis=0)  # (R,)

    cand_biparts = [set(bipartitions(t).keys()) for t in candidate_trees]
    final_bp = bipartitions(final_tree)
    for bp, node in final_bp.items():
        present = np.array([bp in cand_biparts[t] for t in range(T)])
        support = 100.0 * present[winners].mean()
        node.support = support
    return final_tree
