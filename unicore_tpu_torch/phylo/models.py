"""Amino-acid substitution models for likelihood computation.

Model string parity with the reference's tree builders (tree.rs:143-146:
iqtree `-m JTT+F+I+G`, raxml-ng `--model JTT+F+I+G`, fasttree `-gamma`).

Supported components:
  * base exchangeabilities: "JTT", "LG", "WAG", "POISSON", "BLOSUM62"
    — JTT/LG/WAG use the real published rate tables embedded in
    phylo/empirical.py (PAML jones.dat / wag.dat / lg.dat data), so the
    reference's default `JTT+F+I+G` (tree.rs:143-146) is the actual JTT
    model out of the box.  A PAML .dat file in UNICORE_TPU_MODEL_DIR
    still takes precedence (authoritative for reproducing a specific
    PAML distribution).  "BLOSUM62" derives exchangeabilities from
    BLOSUM62 log-odds (r_ij = 2^(s_ij / 2), the Altschul score<->model
    duality), which yields a well-formed reversible AA model.
  * +F  — empirical AA frequencies from the alignment
  * +I  — proportion of invariant sites (optimized)
  * +G  — discrete gamma rate heterogeneity, 4 categories (mean method)

The rate matrix Q = diag-normalized R*pi with eigendecomposition through
the symmetrized form (B = D^(1/2) Q D^(-1/2)), so P(t) = U exp(L t) U^T
is differentiable and MXU-friendly.

Copy of unicore_tpu/phylo/models.py (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
from scipy.stats import gamma as gamma_dist

from unicore_tpu_torch.matrices import BLOSUM62

N_STATES = 20


def _blosum_exchangeabilities() -> np.ndarray:
    s = BLOSUM62[:20, :20].astype(np.float64)
    r = np.power(2.0, s / 2.0)
    np.fill_diagonal(r, 0.0)
    return (r + r.T) / 2.0


def _load_paml_dat(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """PAML .dat: lower-triangle exchangeabilities then frequencies."""
    vals = []
    with open(path) as f:
        for line in f:
            vals.extend(float(x) for x in line.split())
    R = np.zeros((20, 20))
    k = 0
    for i in range(1, 20):
        for j in range(i):
            R[i, j] = R[j, i] = vals[k]
            k += 1
    freqs = np.array(vals[k : k + 20])
    freqs = freqs / freqs.sum()
    return R, freqs


def get_exchangeabilities(name: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    name = name.upper()
    model_dir = os.environ.get("UNICORE_TPU_MODEL_DIR", "")
    for cand in (f"{name.lower()}.dat", f"{name}.dat"):
        p = os.path.join(model_dir, cand)
        if model_dir and os.path.isfile(p):
            return _load_paml_dat(p)
    if name == "POISSON":
        R = np.ones((20, 20))
        np.fill_diagonal(R, 0.0)
        return R, np.full(20, 0.05)
    from unicore_tpu_torch.phylo.empirical import empirical_model, has_model
    if has_model(name):
        return empirical_model(name)
    # unknown names / BLOSUM62 fall back to BLOSUM62-derived
    return _blosum_exchangeabilities(), None


def gamma_rates(alpha: float, ncat: int = 4) -> np.ndarray:
    """Mean rates of ncat equal-probability gamma(alpha, alpha) bins."""
    edges = gamma_dist.ppf(np.linspace(0, 1, ncat + 1), alpha, scale=1.0 / alpha)
    rates = np.empty(ncat)
    # mean of each bin via the incomplete-gamma identity:
    # E[X | a<X<b] * P = alpha/alpha * (F_{a+1}(b) - F_{a+1}(a))
    cdf1 = gamma_dist.cdf(edges, alpha + 1, scale=1.0 / alpha)
    for c in range(ncat):
        rates[c] = (cdf1[c + 1] - cdf1[c]) * ncat
    rates[~np.isfinite(rates)] = 1.0
    rates = rates / (rates.mean() or 1.0)
    return rates


@dataclass
class ModelSpec:
    base: str = "JTT"
    plus_f: bool = False
    plus_i: bool = False
    plus_g: bool = False
    ncat: int = 4

    @classmethod
    def parse(cls, text: str) -> "ModelSpec":
        """Parse "JTT+F+I+G" style strings."""
        parts = text.strip().split("+")
        spec = cls(base=parts[0].upper() or "JTT")
        for p in parts[1:]:
            p = p.upper()
            if p == "F":
                spec.plus_f = True
            elif p == "I":
                spec.plus_i = True
            elif p.startswith("G"):
                spec.plus_g = True
                if len(p) > 1 and p[1:].isdigit():
                    spec.ncat = int(p[1:])
        return spec


@dataclass
class SubstModel:
    """Concrete model: eigendecomposed rate matrix + rate categories."""

    spec: ModelSpec
    pi: np.ndarray                   # (20,)
    eigvals: np.ndarray              # (20,)
    U: np.ndarray                    # (20, 20)  P(t) = U diag(exp(l t)) Uinv
    Uinv: np.ndarray                 # (20, 20)
    alpha: float = 1.0
    p_inv: float = 0.0

    @classmethod
    def build(
        cls,
        spec: ModelSpec,
        empirical_freqs: Optional[np.ndarray] = None,
        alpha: float = 1.0,
        p_inv: float = 0.0,
    ) -> "SubstModel":
        R, base_freqs = get_exchangeabilities(spec.base)
        if spec.plus_f and empirical_freqs is not None:
            pi = empirical_freqs
        elif base_freqs is not None:
            pi = base_freqs
        else:
            pi = np.full(20, 0.05)
        pi = np.clip(pi, 1e-6, None)
        pi = pi / pi.sum()

        Q = R * pi[None, :]
        np.fill_diagonal(Q, 0.0)
        np.fill_diagonal(Q, -Q.sum(axis=1))
        # normalize expected rate to 1
        scale = -float(np.sum(pi * np.diag(Q)))
        Q = Q / scale

        # symmetrize: B = D^1/2 Q D^-1/2 with D = diag(pi)
        d = np.sqrt(pi)
        B = (Q * d[:, None]) / d[None, :]
        B = (B + B.T) / 2.0
        w, V = np.linalg.eigh(B)
        U = V / d[:, None] * 1.0
        U = (V.T / d[None, :]).T  # D^-1/2 V
        Uinv = (V * d[:, None]).T  # V^T D^1/2
        return cls(
            spec=spec, pi=pi, eigvals=w, U=U, Uinv=Uinv,
            alpha=alpha, p_inv=p_inv,
        )

    def rates_and_props(self) -> Tuple[np.ndarray, np.ndarray]:
        """Rate categories and their probabilities (invariant cat first)."""
        if self.spec.plus_g:
            r = gamma_rates(self.alpha, self.spec.ncat)
        else:
            r = np.ones(1)
        if self.spec.plus_i:
            pv = self.p_inv
            rates = np.concatenate([[0.0], r / max(1.0 - pv, 1e-6)])
            props = np.concatenate([[pv], np.full(len(r), (1.0 - pv) / len(r))])
        else:
            rates = r
            props = np.full(len(r), 1.0 / len(r))
        return rates, props

    def transition_matrices(self, t: np.ndarray) -> np.ndarray:
        """P(t) for an array of branch lengths: (..., 20, 20)."""
        t = np.asarray(t)
        expl = np.exp(t[..., None] * self.eigvals)  # (..., 20)
        return np.einsum("ij,...j,jk->...ik", self.U, expl, self.Uinv)
