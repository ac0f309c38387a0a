"""Batched gene-tree inference: the NNI searches of many genes in lockstep.

Counterpart of unicore_tpu/phylo/genebatch.py.  Genes are grouped by
(taxa count, pattern bucket): every engine of a group pads its patterns
to the bucket (zero-weight all-unknown columns), so the group's tips,
weights and per-gene model tensors stack along a leading gene dimension,
and each NNI round scores every active gene's candidate topologies in
one `_loglik_multi_impl` call over a (G, K) batch of genes x candidates.
The JAX package `vmap`s the per-gene candidate `vmap`; here genes and
candidates are two leading batch dimensions of the same block-diagonal
CLV products as phylo/likelihood.py's, flattened into one batch.

The accept/stop logic per gene is TreeSearch.optimize's (its full-batch
branch; genes of 48 taxa or more take the per-gene incremental path in
TreeEngine.infer), so lockstep results match the solo search.  Branch
lengths are optimized per gene, as in the JAX package.  Where
parallel.mesh.local_mesh gives a mesh (several cards), each call splits
its genes over the devices (`_loglik_multi_sharded`).  Not ported: the
search bookkeeping that nothing reads (`TreeSearch.visited`, `_final`).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from unicore_tpu_torch.parallel import mesh as mesh_mod
from unicore_tpu_torch.phylo.likelihood import (
    LikelihoodEngine,
    _blockdiag_pmats,
    _clv_pass,
    arrays_to_tree,
    full_fp32,
    make_root_binary,
    tree_to_arrays,
)
from unicore_tpu_torch.phylo.newick import Node
from unicore_tpu_torch.phylo.search import copy_tree, nni_neighbors
from unicore_tpu_torch.runtime import profiling

_MODEL_KEYS = ("eigvals", "U", "Uinv", "pi", "rates", "props")


def _loglik_multi_impl(children_gk, blens_gk, tips_g, weights_g, eigvals_g, U_g, Uinv_g,
                       pi_g, rates_g, props_g):
    """(G, K) log-likelihoods of K candidate trees for each of G genes.

    children_gk (G, K, n-1, 2), blens_gk (G, K, 2n-1); tips_g (G, n, P, 20)
    and weights_g (G, P) per gene; the model tensors carry the gene
    dimension in front of their own shapes (each gene has its own
    empirical frequencies, alpha and p_inv)."""
    G, K = children_gk.shape[:2]
    n, P = tips_g.shape[1], tips_g.shape[2]
    C = rates_g.shape[-1]
    per_gene = (slice(None), None, None, None)  # broadcast over (K, edges, categories)
    PT = _blockdiag_pmats(blens_gk, rates_g[:, None, None], eigvals_g[per_gene],
                          U_g[per_gene], Uinv_g[per_gene]).transpose(-1, -2)
    leaves = tips_g.repeat(1, 1, 1, C)[:, None].expand(G, K, n, P, C * 20)
    buf, logscale = _clv_pass(children_gk.reshape(G * K, n - 1, 2),
                              PT.reshape(G * K, *PT.shape[2:]),
                              leaves.reshape(G * K, n, P, C * 20), C)
    root = buf[:, -1].reshape(G, K, P, C, 20)
    site_cat = (root @ pi_g[:, None, None, :, None]).squeeze(-1)        # (G, K, P, C)
    log_site_cat = torch.log(torch.clamp(site_cat, min=1e-30)) \
        + logscale[:, -1].reshape(G, K, P, C)
    log_site = torch.logsumexp(log_site_cat + torch.log(props_g)[:, None, None, :], dim=-1)
    return (log_site * weights_g[:, None, :]).sum(-1)


@torch.no_grad()
def _loglik_multi_sharded(mesh, children_gk, blens_gk, tips_g, weights_g, model_g: dict) -> np.ndarray:
    """`_loglik_multi_impl` with the GENE axis split over the devices of
    `mesh`'s first axis (unicore_tpu.phylo.genebatch._loglik_multi_sharded):
    every input (candidates, tips, weights and the per-gene model tensors
    of `model_g`, keyed as _loglik_multi_impl's arguments) rides the gene
    axis, so each device evaluates its own genes.  G is padded to a
    multiple of the shards by repeating gene 0; returns (G, K) on the
    host, at full float32."""
    devices = mesh_mod.shard_devices(mesh)
    G = children_gk.shape[0]
    Gd = mesh_mod.round_up(G, len(devices))

    def split(x, dtype):
        return mesh_mod.shard(mesh_mod.pad_rows(x, Gd), devices, dtype)

    names = sorted(model_g)
    blocks = [split(children_gk, torch.int64), split(blens_gk, torch.float32),
              split(tips_g, torch.float32), split(weights_g, torch.float32)]
    blocks += [split(model_g[k], torch.float32) for k in names]
    outs = []
    with full_fp32():
        for k in range(len(devices)):
            c, b, t, w, *m = (x[k] for x in blocks)
            outs.append(_loglik_multi_impl(c, b, t, w, **dict(zip(names, m))))
    return mesh_mod.gather(outs).numpy()[:G]


# CLV bytes one _loglik_multi_impl call may hold on one device (the budget
# of the likelihood engine's candidate batches)
GENE_BATCH_BYTES = 4e9


def loglik_multi(engines: List[LikelihoodEngine], children_gk: np.ndarray,
                 blens_gk: np.ndarray) -> np.ndarray:
    """(G, K) log-likelihoods of each engine's K candidate topologies, in
    calls over as many genes as keep their CLV buffers under
    GENE_BATCH_BYTES per device; at full float32 (`full_fp32`), without
    autograd.  Where parallel.mesh.local_mesh gives a mesh, each call
    splits its genes over it (`_loglik_multi_sharded`).  Counters:
    `phylo.candidates` (G * K), `phylo.gene_batches` (calls)."""
    e0 = engines[0]
    G, K = children_gk.shape[:2]
    P = int(e0.tips.shape[1])
    C = int(e0._mp["rates"].shape[0])
    dev = e0.device
    mesh = mesh_mod.local_mesh(dev)
    per_gene = K * (2 * e0.n - 1) * P * C * 20 * 4
    step = max(1, int(GENE_BATCH_BYTES // max(per_gene, 1))) * mesh_mod.n_shards(mesh)
    profiling.add_counter("phylo.candidates", G * K)
    outs = []
    with full_fp32(), torch.no_grad():
        for g0 in range(0, G, step):
            gs = engines[g0:g0 + step]
            mp = {k + "_g": torch.stack([e._mp[k] for e in gs]) for k in _MODEL_KEYS}
            cb = np.asarray(children_gk[g0:g0 + step], np.int64)
            bb = np.asarray(blens_gk[g0:g0 + step], np.float32)
            tips, w = torch.stack([e.tips for e in gs]), torch.stack([e.w for e in gs])
            if mesh is not None:
                outs.append(_loglik_multi_sharded(mesh, cb, bb, tips, w, mp))
            else:
                outs.append(_loglik_multi_impl(
                    torch.as_tensor(cb, device=dev), torch.as_tensor(bb, device=dev),
                    tips, w, **mp).cpu().numpy())
            profiling.add_counter("phylo.gene_batches", 1)
    return np.concatenate(outs)


class _GeneSearchState:
    __slots__ = ("engine", "children", "blens", "ll", "active", "rounds")

    def __init__(self, engine: LikelihoodEngine, start: Node, blen_steps: int):
        self.engine = engine
        root = make_root_binary(copy_tree(start))
        children, blens = tree_to_arrays(root, engine.names)
        self.blens, self.ll = engine.optimize_blens(children, blens, steps=blen_steps)
        self.children = children
        self.active = True
        self.rounds = 0


def lockstep_optimize(
    engines: List[LikelihoodEngine],
    starts: List[Node],
    max_rounds: int = 20,
    blen_steps: int = 150,
) -> List[Tuple[Node, float]]:
    """NNI hill-climb for genes sharing (n_taxa, pattern bucket), with
    candidate evaluation batched across genes each round.  Accept logic
    per gene is TreeSearch.optimize's (full-batch branch)."""
    states = [_GeneSearchState(e, t, blen_steps) for e, t in zip(engines, starts)]

    while True:
        live = [s for s in states if s.active]
        if not live:
            break
        cand: List[Tuple[_GeneSearchState, np.ndarray, np.ndarray]] = []
        for s in live:
            root = arrays_to_tree(s.children, s.blens, s.engine.names)
            cs = nni_neighbors(root)
            if not cs:
                s.active = False
                continue
            arr = [tree_to_arrays(c, s.engine.names) for c in cs]
            cand.append((s, np.stack([a[0] for a in arr]), np.stack([a[1] for a in arr])))
        if not cand:
            break
        # genes of one taxa count have the same candidate count; should
        # they not, shorter batches repeat their first row, and the argmax
        # below reads only each gene's own rows
        K = max(cb.shape[0] for _, cb, _ in cand)

        def fill(x):
            return x if x.shape[0] == K else np.concatenate([x, np.repeat(x[:1], K - x.shape[0], 0)])

        lls = loglik_multi([s.engine for s, _, _ in cand],
                           np.stack([fill(cb) for _, cb, _ in cand]),
                           np.stack([fill(bb) for _, _, bb in cand]))
        for (s, cb, bb), ll_k in zip(cand, lls):
            ll_k = ll_k[:cb.shape[0]]
            best = int(np.argmax(ll_k))
            eng = s.engine
            if ll_k[best] <= s.ll + 1e-4:
                nb, nll = eng.optimize_blens(cb[best], bb[best], steps=blen_steps)
                if nll > s.ll + 1e-4:
                    s.children, s.blens, s.ll = cb[best], nb, nll
                else:
                    s.active = False
            else:
                children, blens = cb[best], bb[best]
                blens, ll = eng.optimize_blens(children, blens, steps=blen_steps)
                s.children, s.blens, s.ll = children, blens, ll
            s.rounds += 1
            if s.rounds >= max_rounds:
                s.active = False

    return [(arrays_to_tree(s.children, s.blens, s.engine.names), s.ll) for s in states]


def pattern_bucket(p: int) -> int:
    """Pattern-count bucket: next power of two (min 64); genes of one
    (n_taxa, bucket) group share one pattern width."""
    b = 64
    while b < p:
        b *= 2
    return b
