"""Felsenstein pruning as batched matrix products, in PyTorch.

Counterpart of unicore_tpu/phylo/likelihood.py.  Topology is encoded as
arrays, so one function evaluates any topology of a given size:

  * nodes 0..n-1 are leaves, n..2n-2 internal, root = 2n-2
  * children[(i - n)] = (left, right) node ids, ordered so children < i
  * blens[e] = branch length of the edge above node e (root entry unused)

Per internal node the conditional likelihood vector (CLV) update is

    clv[i] = (clv[l] @ P(t_l)^T) * (clv[r] @ P(t_r)^T)

over (site-patterns, rate-categories * 20) tensors, with the transition
matrices block-diagonal over the categories (one (P, C*20) @ (C*20, C*20)
product per child edge) and per-category log-scaling against underflow;
the zero blocks add exact zeros.  The JAX package `vmap`s one tree's program
over a batch of candidate topologies; here the candidates are an
explicit leading batch dimension, so each node step is one batched
product over all of them.

Everything runs in float32 on the engine's device (runtime/device.py),
and every product runs at full float32 whatever
`torch.set_float32_matmul_precision` says (`full_fp32`): TF32 rounds the
products to a 10-bit mantissa, enough to move lnL by about 1e-3 relative
and flip NNI decisions.  The batched evaluators run without autograd, on
CLV buffers written in place; branch-length optimization differentiates
a separate single-tree pass whose CLVs live in a Python list, because an
in-place write into a tensor a later step reads would break the backward
pass.  The multi-device branch of the JAX engine (`_auto_mesh`,
`_run_batch_sharded`) is not ported: the engine runs on one device.

Site columns are compressed to unique patterns with multiplicities
before upload (classic aliasing), typically a 2-10x site reduction.
"""

from __future__ import annotations

import contextlib
import functools
from typing import List, Tuple

import numpy as np
import torch

from unicore_tpu_torch.alphabets import encode_aa
from unicore_tpu_torch.phylo.models import SubstModel
from unicore_tpu_torch.phylo.newick import Node
from unicore_tpu_torch.runtime import device as device_mod
from unicore_tpu_torch.runtime import profiling


# ---------------------------------------------------------------------------
# alignment -> patterns
# ---------------------------------------------------------------------------

def compress_patterns(msa_codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(n_taxa, L) int codes -> (patterns (n_taxa, P), weights (P,))."""
    cols = np.ascontiguousarray(msa_codes.T)
    uniq, counts = np.unique(cols, axis=0, return_counts=True)
    return uniq.T.copy(), counts.astype(np.float64)


def msa_to_codes(names: List[str], seqs: List[str]) -> np.ndarray:
    """Aligned AA strings -> (n, L) int codes with 20 for gaps/unknown."""
    arr = np.stack([encode_aa(s) for s in seqs]).astype(np.int32)
    return arr


def empirical_frequencies(codes: np.ndarray) -> np.ndarray:
    counts = np.bincount(codes[codes < 20].ravel(), minlength=20).astype(np.float64)
    counts += 1.0  # pseudocount
    return counts / counts.sum()


# ---------------------------------------------------------------------------
# tree <-> arrays
# ---------------------------------------------------------------------------

def tree_to_arrays(root: Node, taxon_order: List[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Binary rooted tree -> (children (n-1, 2), blens (2n-1,)).

    Leaves get ids from taxon_order; internal nodes are numbered in
    postorder (guaranteeing children < parent).  The tree must be binary
    (root with 2 children); callers root unrooted trees first.
    """
    tid = {name: i for i, name in enumerate(taxon_order)}
    n = len(taxon_order)
    children = np.zeros((n - 1, 2), dtype=np.int32)
    blens = np.zeros(2 * n - 1, dtype=np.float64)
    next_internal = [n]

    def assign(node: Node) -> int:
        if node.is_leaf:
            i = tid[node.name]
            blens[i] = max(node.length, 1e-8)
            return i
        assert len(node.children) == 2, "tree must be binary"
        l = assign(node.children[0])
        r = assign(node.children[1])
        i = next_internal[0]
        next_internal[0] += 1
        children[i - n] = (l, r)
        blens[i] = max(node.length, 1e-8)
        return i

    root_id = assign(root)
    assert root_id == 2 * n - 2
    return children, blens


def arrays_to_tree(
    children: np.ndarray, blens: np.ndarray, taxon_order: List[str]
) -> Node:
    n = len(taxon_order)
    nodes = [Node(name) for name in taxon_order] + [Node() for _ in range(n - 1)]
    for i in range(n, 2 * n - 1):
        l, r = children[i - n]
        nodes[i].add(nodes[l])
        nodes[i].add(nodes[r])
    for e in range(2 * n - 2):
        nodes[e].length = float(blens[e])
    return nodes[2 * n - 2]


def make_root_binary(node: Node) -> Node:
    """Root an unrooted (trifurcating-root) tree into binary form by
    splitting the first child off; inverse of unroot()."""
    if len(node.children) == 2:
        return node
    assert len(node.children) >= 3
    first = node.children[0]
    rest = Node()
    for c in node.children[1:]:
        rest.add(c)
    rest.length = 0.0
    new_root = Node()
    new_root.add(first)
    new_root.add(rest)
    return new_root


def unroot(root: Node) -> Node:
    """Collapse a binary root into the standard trifurcation."""
    if len(root.children) != 2:
        return root
    a, b = root.children
    if b.is_leaf and not a.is_leaf:
        a, b = b, a
    if b.is_leaf:  # two-leaf tree
        return root
    merged = Node()
    merged.add(a)
    a.length = a.length + b.length
    for c in b.children:
        merged.add(c)
    merged.support = None
    return merged


# ---------------------------------------------------------------------------
# likelihood core (torch)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def full_fp32():
    """Run float32 matrix products at full float32 (no TF32), whatever the
    process-wide `torch.set_float32_matmul_precision` says; restores it."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _in_full_fp32(fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with full_fp32():
            return fn(*args, **kwargs)
    return wrapper


def _blockdiag_pmats(blens, rates, eigvals, U, Uinv):
    """(..., C*20, C*20) block-diagonal transition matrices, one per entry
    of `blens` (any leading shape), categories stacked on the diagonal."""
    C = rates.shape[0]
    rt = blens[..., None] * rates                        # (..., C)
    expl = torch.exp(rt[..., None] * eigvals)            # (..., C, 20)
    Pm = (U * expl[..., None, :]) @ Uinv                 # (..., C, 20, 20)
    Pm = torch.clamp(Pm, min=1e-12)
    eye = torch.eye(C, dtype=Pm.dtype, device=Pm.device)
    blk = Pm[..., :, :, None, :] * eye[:, None, :, None]  # (..., C, 20, C, 20)
    return blk.reshape(*Pm.shape[:-3], C * 20, C * 20)


def _node_update(ml, mr, ls_l, ls_r, C: int):
    """One internal node from its children's products (…, P, C*20) and
    log-scales (…, P, C): the CLV rescaled by its per-category max, and
    the node's log-scale."""
    clv = ml * mr
    shape = clv.shape
    blocks = clv.reshape(*shape[:-1], C, 20)
    m = torch.clamp(torch.amax(blocks, dim=-1), min=1e-30)   # (…, P, C)
    clv = (blocks / m[..., None]).reshape(shape)
    return clv, ls_l + ls_r + torch.log(m)


def _root_site_loglik(clv, ls, pi, props, C: int):
    """Per-pattern log-likelihood (…, P) from the root's CLV and log-scale."""
    site_cat = clv.reshape(*clv.shape[:-1], C, 20) @ pi       # (…, P, C)
    log_site_cat = torch.log(torch.clamp(site_cat, min=1e-30)) + ls
    return torch.logsumexp(log_site_cat + torch.log(props), dim=-1)


def _site_loglik_tree(children: np.ndarray, blens, tips, eigvals, U, Uinv, pi,
                      rates, props):
    """(P,) per-pattern log-likelihoods of ONE tree, differentiable in
    `blens`: the CLVs live in a Python list indexed by node (no in-place
    writes), and `children` is a host array."""
    n = tips.shape[0]
    C = rates.shape[0]
    PT = _blockdiag_pmats(blens, rates, eigvals, U, Uinv).transpose(-1, -2)
    clvs = list(tips.repeat(1, 1, C).unbind(0))
    scales = [tips.new_zeros((tips.shape[1], C))] * n
    for idx in range(n - 1):
        l, r = int(children[idx, 0]), int(children[idx, 1])
        clv, ls = _node_update(clvs[l] @ PT[l], clvs[r] @ PT[r],
                               scales[l], scales[r], C)
        clvs.append(clv)
        scales.append(ls)
    return _root_site_loglik(clvs[-1], scales[-1], pi, props, C)


def _clv_pass_batch(children_b, blens_b, tips, eigvals, U, Uinv, rates):
    """Postorder CLV pass over a batch of B trees (no autograd): returns
    (buf (B, 2n-1, P, C*20), logscale (B, 2n-1, P, C)).

    Internal node i is written at the same index for every candidate, so
    each step is one slice write; the children differ per candidate and
    are gathered from the buffer."""
    n, P = tips.shape[0], tips.shape[1]
    C = rates.shape[0]
    B = children_b.shape[0]
    PT = _blockdiag_pmats(blens_b, rates, eigvals, U, Uinv).transpose(-1, -2)
    buf = tips.new_empty((B, 2 * n - 1, P, C * 20))
    buf[:, :n] = tips.repeat(1, 1, C)
    logscale = tips.new_zeros((B, 2 * n - 1, P, C))
    ar = torch.arange(B, device=tips.device)
    for idx in range(n - 1):
        l, r = children_b[:, idx, 0], children_b[:, idx, 1]
        clv, ls = _node_update(torch.bmm(buf[ar, l], PT[ar, l]),
                               torch.bmm(buf[ar, r], PT[ar, r]),
                               logscale[ar, l], logscale[ar, r], C)
        buf[:, n + idx] = clv
        logscale[:, n + idx] = ls
    return buf, logscale


def _site_loglik_batch_core(children_b, blens_b, tips, eigvals, U, Uinv, pi,
                            rates, props):
    """(B, P) per-pattern log-likelihoods of a batch of trees."""
    buf, logscale = _clv_pass_batch(children_b, blens_b, tips, eigvals, U, Uinv, rates)
    return _root_site_loglik(buf[:, -1], logscale[:, -1], pi, props, rates.shape[0])


# topology SEARCH happens on at most this many patterns (see
# subsampled_engine); final branch lengths / lnL always use full data
SEARCH_PATTERN_CAP = 8192


def subsampled_engine(eng, k: int = SEARCH_PATTERN_CAP, seed: int = 12345):
    """Weighted-bootstrap pattern subsample of a LikelihoodEngine for
    topology SEARCH.

    k patterns are drawn with replacement proportional to the pattern
    weights; duplicate draws merge into counts rescaled so the total
    site count is preserved — an unbiased RELL-style estimator of the
    log-likelihood.  Topology decisions are robust to site resampling
    (the principle UFBoot rests on), and the subsample bounds the work
    per NNI round and the incremental path's base-CLV cache.  Search
    returns to the FULL engine for final branch lengths and lnL
    (TreeSearch.optimize).  The draws equal the JAX package's (numpy's
    RandomState(seed))."""
    P = int(eng.patterns.shape[1])
    if P <= k:
        return eng
    rng = np.random.RandomState(seed)
    wsum = float(eng.weights.sum())
    probs = np.asarray(eng.weights, np.float64) / wsum
    draws = rng.choice(P, size=k, p=probs)
    idx, cnt = np.unique(draws, return_counts=True)
    sub = object.__new__(type(eng))
    sub.names = eng.names
    sub.n = eng.n
    sub.L = eng.L
    sub.device = eng.device
    sub.patterns = eng.patterns[:, idx]
    sub.weights = (cnt * (wsum / k)).astype(np.float32)
    sub.tips = eng.tips[:, torch.as_tensor(idx, device=eng.device), :]
    sub.w = torch.as_tensor(sub.weights, device=eng.device)
    sub.model = eng.model
    sub._mp = eng._mp
    return sub


def pattern_chunk_for(n_taxa: int, n_cat: int, P: int,
                      budget_bytes: float = 8e8) -> int:
    """Pattern-chunk size bounding the CLV buffer (2n-1, C, chunk, 20)
    f32 to ~`budget_bytes` — 0 when the whole thing already fits.

    Sites are independent, so every likelihood is a SUM over pattern
    chunks; chunking turns the O(nodes * patterns) CLV memory (and the
    saved activations of the branch-length gradient) into
    O(nodes * chunk).  The budgets equal the JAX package's: they decide
    the chunking, and the chunking decides the order of float sums."""
    clv_bytes = (2 * n_taxa - 1) * n_cat * P * 20 * 4
    if clv_bytes <= budget_bytes:
        return 0
    chunk = 1024
    while (2 * n_taxa - 1) * n_cat * (chunk * 2) * 20 * 4 <= budget_bytes \
            and chunk * 2 < P:
        chunk *= 2
    return chunk


def _pad_patterns(tips, weights, chunk: int):
    """Pad the pattern axis to a chunk multiple (all-ones tips with zero
    weight contribute exactly 0 to the summed log-likelihood)."""
    P = tips.shape[1]
    Pp = ((P + chunk - 1) // chunk) * chunk
    if Pp == P:
        return tips, weights
    padn = Pp - P
    tips = torch.cat([tips, tips.new_ones((tips.shape[0], padn, 20))], dim=1)
    weights = torch.cat([weights, weights.new_zeros(padn)])
    return tips, weights


def _chunks(x, chunk: int, dim: int):
    """`x` split along its pattern axis `dim` into chunks of `chunk`
    patterns (one chunk of everything when chunk is 0)."""
    return x.split(chunk, dim=dim) if chunk else [x]


def _loglik_batch_impl(children_b, blens_b, tips, weights, mp, pattern_chunk=0):
    """(B,) log-likelihoods: the sum over pattern chunks of each chunk's
    weighted site log-likelihoods."""
    parts = [(_site_loglik_batch_core(children_b, blens_b, t_k, **mp) * w_k).sum(-1)
             for t_k, w_k in zip(_chunks(tips, pattern_chunk, 1), _chunks(weights, pattern_chunk, 0))]
    return torch.stack(parts).sum(0)


def _site_loglik_batch_impl(children_b, blens_b, tips, mp, pattern_chunk=0):
    """(B, P_padded) per-pattern log-likelihoods, chunk by chunk."""
    return torch.cat([_site_loglik_batch_core(children_b, blens_b, t_k, **mp)
                      for t_k in _chunks(tips, pattern_chunk, 1)], dim=-1)


def _optimize_blens_impl(children, blens0, tips, weights, mp, steps: int,
                         lr: float = 0.05, pattern_chunk: int = 0):
    """Adam on log-branch-lengths, the JAX package's loop step for step:
    value and gradient at x; best_x/best_v updated on a strict `<` before
    the step; the step with optax.adam's defaults (b1 0.9, b2 0.999, eps
    1e-8, eps_root 0); after the last step one more evaluation at the
    final x.  The gradient comes from torch.autograd; with pattern
    chunking it is the sum of the chunks' gradients, each chunk's graph
    freed before the next is built.  Returns (exp(best_x), -best_v)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    chunks = list(zip(_chunks(tips, pattern_chunk, 1), _chunks(weights, pattern_chunk, 0)))

    def negll(x, grad: bool):
        v = x.new_zeros(())
        g = torch.zeros_like(x) if grad else None
        for t_k, w_k in chunks:
            with torch.enable_grad() if grad else contextlib.nullcontext():
                xx = x.detach().requires_grad_(grad)
                vk = -(_site_loglik_tree(children, torch.exp(xx), t_k, **mp) * w_k).sum()
                if grad:
                    g += torch.autograd.grad(vk, xx)[0]
            v = v + vk.detach()
        return v, g

    with torch.no_grad():
        x = torch.log(torch.clamp(blens0, min=1e-7))
        mu = torch.zeros_like(x)
        nu = torch.zeros_like(x)
        best_x = x
        best_v = x.new_tensor(float("inf"))
        for k in range(1, steps + 1):
            v, g = negll(x, grad=True)
            better = v < best_v
            best_x = torch.where(better, x, best_x)
            best_v = torch.where(better, v, best_v)
            mu = (1 - b1) * g + b1 * mu
            nu = (1 - b2) * (g * g) + b2 * nu
            mu_hat = mu / (1 - b1 ** k)
            nu_hat = nu / (1 - b2 ** k)
            x = x + (-lr) * (mu_hat / (torch.sqrt(nu_hat) + eps))
        v, _ = negll(x, grad=False)
        better = v < best_v
        best_x = torch.where(better, x, best_x)
        best_v = torch.where(better, v, best_v)
        profiling.add_counter("phylo.blen_steps", steps)
        return torch.exp(best_x), -best_v


def _loglik_incremental_impl(cl, cr, lb, rb, lsrc, rsrc, base_buf, base_logscale,
                             weights, eigvals, U, Uinv, pi, rates, props):
    """Log-likelihood of B NNI candidates by recomputing ONLY each
    candidate's changed-node chain (the edited edge's two nodes plus
    their ancestors), reading every untouched CLV from the base cache.
    O(depth) CLV updates per candidate instead of O(n).  Chains are
    (B, D) arrays; step t of every candidate runs as one batched product,
    its children read from the chain's earlier steps (src >= 0) or from
    the base cache."""
    C = rates.shape[0]
    B, D = cl.shape
    PLT = _blockdiag_pmats(lb, rates, eigvals, U, Uinv).transpose(-1, -2)  # (B, D, ., .)
    PRT = _blockdiag_pmats(rb, rates, eigvals, U, Uinv).transpose(-1, -2)
    cbuf = base_buf.new_zeros((B, D, *base_buf.shape[1:]))      # (B, D, P, C*20)
    cls = base_buf.new_zeros((B, D, *base_logscale.shape[1:]))  # (B, D, P, C)
    ar = torch.arange(B, device=base_buf.device)

    def child(node, src):
        own = (src >= 0)[:, None, None]
        s = torch.clamp(src, min=0)
        return (torch.where(own, cbuf[ar, s], base_buf[node]),
                torch.where(own, cls[ar, s], base_logscale[node]))

    for t in range(D):
        clv_l, sc_l = child(cl[:, t], lsrc[:, t])
        clv_r, sc_r = child(cr[:, t], rsrc[:, t])
        clv, ls = _node_update(torch.bmm(clv_l, PLT[:, t]), torch.bmm(clv_r, PRT[:, t]),
                               sc_l, sc_r, C)
        cbuf[:, t] = clv
        cls[:, t] = ls
    log_site = _root_site_loglik(cbuf[:, D - 1], cls[:, D - 1], pi, props, C)
    return (log_site * weights).sum(-1)


class LikelihoodEngine:
    """Holds device-resident alignment tensors + model; evaluates trees.

    `device`: where the tensors live and the products run; None resolves
    through runtime/device.py (CUDA unless UNICORE_TPU_TORCH_DEVICE=cpu)."""

    def __init__(self, names: List[str], seqs: List[str], model: SubstModel, device=None):
        self.device = device_mod.resolve(device)
        self.names = list(names)
        codes = msa_to_codes(names, seqs)
        patterns, weights = compress_patterns(codes)
        self.n = len(names)
        self.patterns = patterns
        self.weights = weights.astype(np.float32)
        self.L = codes.shape[1]
        tips = np.zeros((self.n, patterns.shape[1], 20), dtype=np.float32)
        for t in range(self.n):
            col = patterns[t]
            known = col < 20
            tips[t, known, col[known]] = 1.0
            tips[t, ~known, :] = 1.0
        self.tips = torch.as_tensor(tips, device=self.device)
        self.w = torch.as_tensor(self.weights, device=self.device)
        self.set_model(model)

    def set_model(self, model: SubstModel) -> None:
        self.model = model
        rates, props = model.rates_and_props()

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

        self._mp = dict(eigvals=f32(model.eigvals), U=f32(model.U), Uinv=f32(model.Uinv),
                        pi=f32(model.pi), rates=f32(rates), props=f32(props))

    def _batch(self, children_batch, blens_batch):
        return (torch.as_tensor(np.asarray(children_batch, np.int64), device=self.device),
                torch.as_tensor(np.asarray(blens_batch, np.float32), device=self.device))

    def _pattern_chunk(self) -> int:
        return pattern_chunk_for(self.n, int(self._mp["rates"].shape[0]),
                                 int(self.tips.shape[1]))

    def _tree_chunk(self, pchunk: int, cap: int) -> int:
        """Candidates per call: the JAX package's choice, which keeps the
        batch's CLV buffers under ~4 GB."""
        C = int(self._mp["rates"].shape[0])
        P = int(self.tips.shape[1])
        clv_bytes = (2 * self.n - 1) * C * min(P, pchunk or P) * 20 * 4
        return max(1, min(cap, int(4e9 // max(clv_bytes, 1))))

    # -- single tree (routed through the batched entry) -------------------
    def loglik(self, children: np.ndarray, blens: np.ndarray) -> float:
        return float(self.loglik_batch(
            np.asarray(children)[None], np.asarray(blens)[None])[0])

    # -- batched topologies (NNI rounds) --------------------------------
    @_in_full_fp32
    @torch.no_grad()
    def loglik_batch(
        self, children_batch: np.ndarray, blens_batch: np.ndarray,
        chunk: int = 0,
    ) -> np.ndarray:
        """(B,) log-likelihoods of a topology batch, `chunk` candidates per
        call (0: the largest that keeps the CLV stack under ~4 GB)."""
        pchunk = self._pattern_chunk()
        tips, w = self.tips, self.w
        if pchunk:
            tips, w = _pad_patterns(tips, w, pchunk)
        chunk = chunk or self._tree_chunk(pchunk, 16)
        B = children_batch.shape[0]
        profiling.add_counter("phylo.candidates", B)
        outs = []
        for s0 in range(0, B, chunk):
            cb, bb = self._batch(children_batch[s0:s0 + chunk], blens_batch[s0:s0 + chunk])
            outs.append(_loglik_batch_impl(cb, bb, tips, w, self._mp, pchunk).cpu().numpy())
        return np.concatenate(outs)

    # -- per-pattern site log-likelihoods (for RELL bootstrap) ----------
    def site_loglik(self, children: np.ndarray, blens: np.ndarray) -> np.ndarray:
        return self.site_loglik_batch(
            np.asarray(children)[None], np.asarray(blens)[None])[0]

    @_in_full_fp32
    @torch.no_grad()
    def site_loglik_batch(
        self, children_batch: np.ndarray, blens_batch: np.ndarray, chunk: int = 0,
    ) -> np.ndarray:
        """(B, P) per-pattern log-likelihoods for a topology batch
        (RELL/UFBoot candidate scoring)."""
        pchunk = self._pattern_chunk()
        tips = self.tips
        if pchunk:
            tips, _ = _pad_patterns(tips, self.w, pchunk)
        chunk = chunk or self._tree_chunk(pchunk, 32)
        B = children_batch.shape[0]
        profiling.add_counter("phylo.candidates", B)
        outs = []
        for s0 in range(0, B, chunk):
            cb, bb = self._batch(children_batch[s0:s0 + chunk], blens_batch[s0:s0 + chunk])
            outs.append(_site_loglik_batch_impl(cb, bb, tips, self._mp, pchunk).cpu().numpy())
        # pattern padding adds trailing zero-weight columns; slice back
        return np.concatenate(outs)[:, :int(self.tips.shape[1])]

    # -- incremental NNI evaluation (partial-CLV reuse) ------------------
    @_in_full_fp32
    @torch.no_grad()
    def loglik_nni_moves(
        self, children: np.ndarray, blens: np.ndarray,
        moves, chunk: int = 0,
    ) -> np.ndarray:
        """Log-likelihood of every NNI move (v, u, child_idx, sib_idx)
        applied to the base tree, recomputing only each move's
        O(depth) changed-CLV chain against a cached base-CLV pass.

        Node ids stay FIXED under the swap (no postorder renumbering):
        the chain evaluator only needs dependency order within the
        chain, and every untouched subtree's base CLV remains valid.
        """
        n = self.n
        mp = self._mp
        cb, bb = self._batch(np.asarray(children)[None], np.asarray(blens)[None])
        base_buf, base_ls = _clv_pass_batch(cb, bb, self.tips, mp["eigvals"], mp["U"],
                                            mp["Uinv"], mp["rates"])
        base_buf, base_ls = base_buf[0], base_ls[0]
        parent = np.zeros(2 * n - 1, dtype=np.int64)
        for k in range(n - 1):
            parent[children[k, 0]] = k + n
            parent[children[k, 1]] = k + n
        root = 2 * n - 2

        B = len(moves)
        profiling.add_counter("phylo.candidates", B)
        chains = []
        for (v, u, child_idx, sib_idx) in moves:
            # swapped children rows for v and u
            c = int(children[v - n, child_idx])
            s = int(children[u - n, sib_idx])
            v_kids = list(children[v - n])
            v_kids[child_idx] = s
            u_kids = list(children[u - n])
            u_kids[sib_idx] = c
            # chain: v, u, then ancestors of u up to the root
            nodes = [v, u]
            a = u
            while a != root:
                a = int(parent[a])
                nodes.append(a)
            pos = {k: t for t, k in enumerate(nodes)}
            steps = []
            for t, k in enumerate(nodes):
                if k == v:
                    kids = v_kids
                elif k == u:
                    kids = u_kids
                else:
                    kids = list(children[k - n])
                l, r = int(kids[0]), int(kids[1])
                steps.append((
                    l, r, float(blens[l]), float(blens[r]),
                    pos.get(l, -1), pos.get(r, -1),
                ))
            chains.append(steps)

        D = max(len(c) for c in chains)
        arr = np.zeros((6, B, D), dtype=np.float64)
        for b, steps in enumerate(chains):
            while len(steps) < D:
                steps.append(steps[-1])  # repeat root step (idempotent)
            for t, st in enumerate(steps):
                for f in range(6):
                    arr[f, b, t] = st[f]
        dev = self.device
        idx = [torch.as_tensor(arr[f].astype(np.int64), device=dev) for f in (0, 1, 4, 5)]
        lens = [torch.as_tensor(arr[f].astype(np.float32), device=dev) for f in (2, 3)]
        cl, cr, lsrc, rsrc = idx
        lb, rb = lens

        if not chunk:
            C = int(mp["rates"].shape[0])
            per = D * C * int(self.patterns.shape[1]) * 20 * 4
            chunk = max(1, min(64, int(3e9 // max(per, 1))))
        outs = []
        for s0 in range(0, B, chunk):
            sl = slice(s0, s0 + chunk)
            out = _loglik_incremental_impl(
                cl[sl], cr[sl], lb[sl], rb[sl], lsrc[sl], rsrc[sl],
                base_buf, base_ls, self.w, **mp,
            )
            outs.append(out.cpu().numpy())
        return np.concatenate(outs)

    # -- branch-length optimization (adam on log-lengths) ---------------
    @_in_full_fp32
    def optimize_blens(
        self, children: np.ndarray, blens: np.ndarray,
        steps: int = 200, lr: float = 0.05,
    ) -> Tuple[np.ndarray, float]:
        chunk = self._pattern_chunk()
        tips, w = self.tips, self.w
        if chunk:
            tips, w = _pad_patterns(tips, w, chunk)
        blens_opt, ll = _optimize_blens_impl(
            np.asarray(children),
            torch.as_tensor(np.asarray(blens, np.float32), device=self.device),
            tips, w, self._mp, steps=steps, lr=lr, pattern_chunk=chunk,
        )
        out = blens_opt.cpu().numpy().astype(np.float64)
        out[2 * self.n - 2] = 0.0
        return out, float(ll)
