#!/usr/bin/env python3
"""How far each candidate cause moves phase 3c's CPU likelihood: the lnL
shift of chip_smoke.py phase 3c's candidates 4 and 5 from a clean call,
for each perturbation of the CPU call that a worker's state or a fault
could make.

    python3 scripts/torch_phylo_perturb.py [--taxa N] [--columns L]

On the CPU (no card): phase 3c's inputs (PHYLO: 20 taxa x 8,192 columns,
its first 8 candidates), `cpu.loglik_batch(cb[:8], bb[:8])` under
tf32_requested, clean and then under each of:

  * every OpenMP worker (chip_smoke.OpenMPTeam) rounding up, down or
    toward zero (fesetround), or with FTZ and DAZ set in its MXCSR;
  * candidate 4's batched products (torch.bmm in the likelihood) on
    inputs rounded to bfloat16 (both operands, or the transition
    matrices only), to TF32's 10-bit mantissa (round to nearest) or
    truncated to it;
  * candidate 4's products with another candidate's transition matrices;
  * one 4 KB page (1,024 floats) of candidate 4's CLV or log-scale buffer
    set to zero right after a node writes it, at three nodes.

Prints one line per perturbation: the shift of candidates 4 and 5 in lnL
units from the clean call, and the clean values beside float64_loglik.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import chip_smoke as c  # noqa: E402
from torch_phylo_repro import phylo_inputs  # noqa: E402

ROUNDING = {"up": 0x800, "down": 0x400, "toward zero": 0xC00}  # glibc's FE_* on x86-64
FTZ_DAZ = 0x8040  # MXCSR's flush-to-zero and denormals-are-zero bits
TARGET = 4  # the candidate a per-candidate perturbation reaches


def rounded(x, bits, mode):
    """float32 `x` with its mantissa cut to `bits` bits: round to nearest
    even ("rne") or toward zero ("trunc")."""
    import torch

    i = x.contiguous().view(torch.int32)
    drop = 23 - bits
    if mode == "rne":
        i = i + ((i >> drop) & 1) + (1 << (drop - 1)) - 1
    return (i & ~((1 << drop) - 1)).view(torch.float32)


@contextlib.contextmanager
def every_worker(team, set_env):
    """set_env(fenv words) in every OpenMP worker (and this thread) inside
    the block, the environment restored after."""
    words = (ctypes.c_uint32 * 8)

    def save():
        env = words()
        team.libm.fegetenv(env)
        return bytes(env)

    saved = team.each(save)

    def apply():
        env = words()
        team.libm.fegetenv(env)
        set_env(env)
        team.libm.fesetenv(env)

    team.each(apply)
    try:
        yield
    finally:
        team.each(lambda: team.libm.fesetenv(words.from_buffer_copy(saved[team.gomp.omp_get_thread_num()])))


@contextlib.contextmanager
def bmm_of_target(change):
    """torch.bmm with candidate TARGET's product replaced by change(a, b)."""
    import torch

    real = torch.bmm

    def bmm(a, b):
        out = real(a, b)
        out[TARGET] = change(a, b)
        return out

    torch.bmm = bmm
    try:
        yield
    finally:
        torch.bmm = real


@contextlib.contextmanager
def zeroed_page(node_idx, which):
    """The likelihood's CLV pass with one page of candidate TARGET's CLV
    ("clv") or log-scale ("scale") buffer of internal node n + node_idx
    set to zero once the node is written."""
    import torch

    from unicore_tpu_torch.phylo import likelihood as tl

    real = tl._clv_pass

    def clv_pass(children_b, PT, leaves, C):
        n, P = leaves.shape[-3], leaves.shape[-2]
        B = children_b.shape[0]
        buf = leaves.new_empty((B, 2 * n - 1, P, C * 20))
        buf[:, :n] = leaves
        logscale = leaves.new_zeros((B, 2 * n - 1, P, C))
        ar = torch.arange(B, device=leaves.device)
        for idx in range(n - 1):
            l, r = children_b[:, idx, 0], children_b[:, idx, 1]
            clv, ls = tl._node_update(torch.bmm(buf[ar, l], PT[ar, l]), torch.bmm(buf[ar, r], PT[ar, r]),
                                      logscale[ar, l], logscale[ar, r], C)
            buf[:, n + idx] = clv
            logscale[:, n + idx] = ls
            if idx == node_idx:
                (buf if which == "clv" else logscale)[TARGET, n + idx].view(-1)[:1024] = 0
        return buf, logscale

    tl._clv_pass = clv_pass
    try:
        yield
    finally:
        tl._clv_pass = real


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--taxa", type=int, default=c.PHYLO["n"])
    ap.add_argument("--columns", type=int, default=c.PHYLO["L"])
    args = ap.parse_args(argv)

    import torch

    k = c.PHYLO["cpu_batch"]
    cpu, _, cb, bb = phylo_inputs(None, args.taxa, args.columns)
    cb, bb = cb[:k], bb[:k]

    def call():
        with c.tf32_requested():
            return np.asarray(cpu.loglik_batch(cb, bb), np.float64)

    clean = call()
    f64 = np.asarray(c.float64_loglik(cpu, cb, bb))
    print(f"clean: candidates 4, 5 {clean[4]!r}, {clean[5]!r}; float64 {f64[4]!r}, {f64[5]!r}; "
          f"torch {torch.__version__}, {torch.get_num_threads()} threads; {c.host_cpu()}")
    team = c.OpenMPTeam()
    bf16 = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    cases = [(f"every worker rounding {name}",
              every_worker(team, lambda env, m=m: env.__setitem__(7, (env[7] & ~0x6000) | (m << 3))))
             for name, m in ROUNDING.items()]
    cases.append(("every worker with FTZ and DAZ", every_worker(team, lambda env: env.__setitem__(7, env[7] | FTZ_DAZ))))
    cases += [
        ("candidate 4's products on bfloat16 inputs", bmm_of_target(lambda a, b: bf16(a[TARGET]) @ bf16(b[TARGET]))),
        ("candidate 4's products, transition matrices in bfloat16",
         bmm_of_target(lambda a, b: a[TARGET] @ bf16(b[TARGET]))),
        ("candidate 4's products on TF32 inputs (nearest)",
         bmm_of_target(lambda a, b: rounded(a[TARGET], 10, "rne") @ rounded(b[TARGET], 10, "rne"))),
        ("candidate 4's products on TF32 inputs (truncated)",
         bmm_of_target(lambda a, b: rounded(a[TARGET], 10, "trunc") @ rounded(b[TARGET], 10, "trunc"))),
    ]
    cases += [(f"candidate 4's products with candidate {j}'s transition matrices",
               bmm_of_target(lambda a, b, j=j: a[TARGET] @ b[j])) for j in range(k) if j != TARGET]
    n = cpu.n
    cases += [(f"a page of candidate 4's {which} buffer zeroed at node {n + idx}", zeroed_page(idx, which))
              for which in ("clv", "scale") for idx in (0, (n - 1) // 2, n - 2)]
    for name, ctx in cases:
        with ctx:
            got = call()
        print(f"{name}: {got[4] - clean[4]:+.4f}, {got[5] - clean[5]:+.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
