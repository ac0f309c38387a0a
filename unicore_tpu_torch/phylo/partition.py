"""Partitioned-model likelihood (IQ-TREE `-p partitions` equivalent).

Counterpart of unicore_tpu/phylo/partition.py.  The reference emits a
RAxML-style partition file next to the supermatrix (combine_fasta.rs:93,
README.md:214-230 documents `iqtree -p` usage).  This engine implements
the edge-linked partition model: all partitions share the tree topology
and branch lengths, while each partition gets its own empirical AA
frequencies (and therefore its own rate matrix / eigenbasis) and
gamma/invariant mixture built from a shared alpha.

Per-partition tensors are padded to a common pattern count Pmax and
stacked: the partitions are a leading batch axis of the likelihood's
block-diagonal CLV products (phylo/likelihood.py) over the shared
`children` and `blens`, evaluated PART_CHUNK partitions at a time, which
bounds CLV memory to PART_CHUNK x (2n-1, Pmax, C*20) as the JAX
package's `lax.map` over chunks does.  Padded partitions copy the first
partition's model and padded patterns are all-ones tips with weight 0,
so neither contributes.  Branch-length optimization is the likelihood's
Adam loop (`_adam_log_blens`) with one objective term per chunk, its
gradients summed over the chunks; the JAX package's split of that loop
into segments is a worker time-limit workaround and is not kept.  Every
entry point runs at full float32 (`full_fp32`).

Duck-types LikelihoodEngine (loglik / loglik_batch / optimize_blens /
site_loglik / set_model / model / names / n / weights), so TreeSearch
and the UFBoot bootstrap work unchanged.  It has, as in the JAX package,
no `tips`, `patterns`, `loglik_nni_moves` or `site_loglik_batch`: search
and bootstrap therefore run on every pattern, never on the subsample or
the incremental path.
"""

from __future__ import annotations

import functools
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from unicore_tpu_torch.phylo.genebatch import _MODEL_KEYS
from unicore_tpu_torch.phylo.likelihood import (
    _adam_log_blens,
    _blockdiag_pmats,
    _in_full_fp32,
    _node_update,
    compress_patterns,
    empirical_frequencies,
    msa_to_codes,
)
from unicore_tpu_torch.phylo.models import ModelSpec, SubstModel
from unicore_tpu_torch.runtime import device as device_mod
from unicore_tpu_torch.runtime import profiling


def parse_partition_file(path: str) -> List[Tuple[str, int, int]]:
    """RAxML-style lines: "MODEL, name = start-end" (1-based inclusive)."""
    parts: List[Tuple[str, int, int]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            m = re.match(r"[^,]+,\s*(\S+)\s*=\s*(\d+)\s*-\s*(\d+)", line)
            if m:
                parts.append((m.group(1), int(m.group(2)), int(m.group(3))))
    return parts


PART_CHUNK = 8  # partitions evaluated together (CLV memory bound)


def _pad_chunks(n: int, chunk: int) -> int:
    return ((n + chunk - 1) // chunk) * chunk


def _part_site_loglik(children: np.ndarray, blens, tips, eigvals, U, Uinv, pi, rates,
                      props):
    """(G, P) per-pattern log-likelihoods of ONE tree under G partitions'
    models, differentiable in `blens` (2n-1,).  tips (G, n, P, 20) and
    the model tensors carry the partition axis in front of their own
    shapes; the CLVs live in a Python list indexed by node, as in
    likelihood._site_loglik_tree."""
    n = tips.shape[1]
    C = rates.shape[-1]
    PT = _blockdiag_pmats(blens[None], rates[:, None], eigvals[:, None, None],
                          U[:, None, None], Uinv[:, None, None]).transpose(-1, -2)
    clvs = list(tips.repeat(1, 1, 1, C).unbind(1))                   # n x (G, P, C*20)
    scales = [tips.new_zeros((tips.shape[0], tips.shape[2], C))] * n
    for idx in range(n - 1):
        l, r = int(children[idx, 0]), int(children[idx, 1])
        clv, ls = _node_update(clvs[l] @ PT[:, l], clvs[r] @ PT[:, r],
                               scales[l], scales[r], C)
        clvs.append(clv)
        scales.append(ls)
    root = clvs[-1].reshape(*clvs[-1].shape[:-1], C, 20)             # (G, P, C, 20)
    site_cat = (root @ pi[:, None, :, None]).squeeze(-1)             # (G, P, C)
    log_site_cat = torch.log(torch.clamp(site_cat, min=1e-30)) + scales[-1]
    return torch.logsumexp(log_site_cat + torch.log(props)[:, None, :], dim=-1)


class PartitionedLikelihoodEngine:
    """Edge-linked partitioned likelihood over a shared topology.

    `device`: where the tensors live and the products run; None resolves
    through runtime/device.py (CUDA unless UNICORE_TPU_TORCH_DEVICE=cpu)."""

    def __init__(
        self,
        names: List[str],
        seqs: List[str],
        partitions: Sequence[Tuple[str, int, int]],
        spec: Optional[ModelSpec] = None,
        alpha: float = 1.0,
        p_inv: float = 0.0,
        device=None,
    ):
        self.device = device_mod.resolve(device)
        self.names = list(names)
        self.n = len(names)
        self.spec = spec or ModelSpec.parse("JTT+F+G")
        codes_full = msa_to_codes(names, seqs)
        self.L = codes_full.shape[1]

        self._parts = []
        for (pname, start, end) in partitions:
            codes = codes_full[:, start - 1 : end]
            patterns, weights = compress_patterns(codes)
            freqs = empirical_frequencies(codes)
            self._parts.append(
                {"name": pname, "patterns": patterns, "weights": weights, "freqs": freqs}
            )
        self.G = len(self._parts)
        self.Pmax = max(p["patterns"].shape[1] for p in self._parts)

        # stacked, padded tips/weights (padding weight 0 => no contribution)
        self._G_pad = _pad_chunks(self.G, PART_CHUNK)
        tips = np.ones((self._G_pad, self.n, self.Pmax, 20), np.float32)
        w = np.zeros((self._G_pad, self.Pmax), np.float32)
        for g, part in enumerate(self._parts):
            P = part["patterns"].shape[1]
            t = np.zeros((self.n, P, 20), np.float32)
            for i in range(self.n):
                col = part["patterns"][i]
                known = col < 20
                t[i, known, col[known]] = 1.0
                t[i, ~known, :] = 1.0
            tips[g, :, :P, :] = t
            w[g, :P] = part["weights"]
        self._tips = torch.as_tensor(tips, device=self.device)
        self._w = torch.as_tensor(w, device=self.device)

        # concatenated weights over real partitions (for the bootstrap)
        self.weights = np.concatenate([p["weights"] for p in self._parts])
        self._build_models(alpha, p_inv)

    # ------------------------------------------------------------------
    def _build_models(self, alpha: float, p_inv: float) -> None:
        self.alpha, self.p_inv = alpha, p_inv
        per_part = {k: [] for k in _MODEL_KEYS}
        for part in self._parts:
            m = SubstModel.build(
                self.spec, empirical_freqs=part["freqs"], alpha=alpha, p_inv=p_inv
            )
            r, pr = m.rates_and_props()
            for k, v in zip(_MODEL_KEYS, (m.eigvals, m.U, m.Uinv, m.pi, r, pr)):
                per_part[k].append(v)
        # pad to G_pad with copies of the first (weight-0 patterns anyway)
        self._mp = {
            k: torch.as_tensor(
                np.stack(v + [v[0]] * (self._G_pad - self.G)).astype(np.float32),
                device=self.device)
            for k, v in per_part.items()
        }
        # model handle for TreeEngine._optimize_model compatibility
        self.model = SubstModel.build(
            self.spec, empirical_freqs=self._parts[0]["freqs"], alpha=alpha, p_inv=p_inv
        )

    def set_model(self, model: SubstModel) -> None:
        """Shared-parameter update (alpha / p_inv) across partitions."""
        self._build_models(model.alpha, model.p_inv)

    def _chunk_args(self):
        """(tips, weights, model tensors) of each chunk of PART_CHUNK
        partitions."""
        for g0 in range(0, self._G_pad, PART_CHUNK):
            sl = slice(g0, g0 + PART_CHUNK)
            yield self._tips[sl], self._w[sl], {k: v[sl] for k, v in self._mp.items()}

    def _blens(self, blens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(blens, np.float32), device=self.device)

    # ------------------------------------------------------------------
    @_in_full_fp32
    @torch.no_grad()
    def loglik(self, children: np.ndarray, blens: np.ndarray) -> float:
        """Sum of the partitions' log-likelihoods, summed chunk by chunk."""
        b = self._blens(blens)
        children = np.asarray(children)
        parts = [(_part_site_loglik(children, b, tips, **mp) * w).sum()
                 for tips, w, mp in self._chunk_args()]
        profiling.add_counter("phylo.candidates", 1)
        return float(torch.stack(parts).sum())

    def loglik_batch(self, children_batch, blens_batch, chunk: int = 4) -> np.ndarray:
        """One `loglik` per candidate, as the JAX package's loop."""
        out = []
        for c, b in zip(children_batch, blens_batch):
            out.append(self.loglik(c, b))
        return np.asarray(out)

    @_in_full_fp32
    def optimize_blens(self, children, blens, steps: int = 150, lr: float = 0.05):
        children = np.asarray(children)

        def term(tips, w, mp, b):
            return -(_part_site_loglik(children, b, tips, **mp) * w).sum()

        terms = [functools.partial(term, *args) for args in self._chunk_args()]
        b_opt, ll = _adam_log_blens(self._blens(blens), terms, steps, lr)
        out = b_opt.cpu().numpy().astype(np.float64)
        out[2 * self.n - 2] = 0.0
        return out, float(ll)

    @_in_full_fp32
    @torch.no_grad()
    def site_loglik(self, children, blens) -> np.ndarray:
        """Concatenated per-pattern log-likelihoods over real partitions."""
        b = self._blens(blens)
        children = np.asarray(children)
        sl = torch.cat([_part_site_loglik(children, b, tips, **mp)
                        for tips, _, mp in self._chunk_args()]).cpu().numpy()
        profiling.add_counter("phylo.candidates", 1)
        return np.concatenate([sl[g, :part["patterns"].shape[1]]
                               for g, part in enumerate(self._parts)])
