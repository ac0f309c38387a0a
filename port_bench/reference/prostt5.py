"""Plain reference of ProstT5's AA->3Di prediction, in float32.

The published network (Rostlab/ProstT5's encoder, the original T5 v1.0
stack; Heinzinger et al., NAR Genom. Bioinform. 2024) written out in
plain `torch` operations, one unit at a time and without padding, TF32
off: the embedding, T5's bidirectional relative-position bias (HF's
formula, on the host in float32), per block RMSNorm, self-attention with
no score scaling, RMSNorm, a ReLU FFN, each with a residual add, the
final RMSNorm, then ProstT5's CNN head (conv 7 wide, d_model -> 32,
ReLU, conv 7 wide, 32 -> 20) over the residue positions alone, zero
padded.  Proteins longer than a window are read in overlapping windows
and each residue takes the logits of the window that owns it
(`counts.windows`, `counts.owners`).

It runs layer by layer over all units, so that a layer's weights are
widened to float32 once.  `precision="fp8"` is the control: every
product of the encoder on operands rounded to float8 e4m3 with one scale
a tensor (amax / 448), accumulated in float32.  `precision="bf16_stream"`
is the gauge of how far the network carries rounding: float32 throughout
but for the residual stream, rounded to bfloat16 after each residual add.

It imports nothing of the program and takes nothing the program made:
the weights are the benchmark's, named as `weights.device_state` names
them.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from port_bench import counts

FP8_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    mm = torch.backends.cuda.matmul
    prev = (mm.allow_tf32, torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())
    mm.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        mm.allow_tf32, torch.backends.cudnn.allow_tf32 = prev[0], prev[1]
        torch.set_float32_matmul_precision(prev[2])


def rel_buckets(L: int, n_buckets: int, max_dist: int) -> torch.Tensor:
    """(L, L) bucket of key - query: HF T5's bidirectional rule, float32
    on the host."""
    pos = torch.arange(L)
    rel = pos[None, :] - pos[:, None]
    num = n_buckets // 2
    out = (rel > 0).long() * num
    n = rel.abs()
    max_exact = num // 2
    large = max_exact + (
        torch.log(n.clamp(min=1).float() / max_exact) / math.log(max_dist / max_exact) * (num - max_exact)
    ).long()
    large = large.clamp(max=num - 1)
    return out + torch.where(n < max_exact, n, large)


def _q8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _mm(a: torch.Tensor, b: torch.Tensor, fp8: bool) -> torch.Tensor:
    return torch.matmul(_q8(a), _q8(b)) if fp8 else torch.matmul(a, b)


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def encode_units(units: Sequence[Sequence[int]], state: Dict[str, torch.Tensor], m: Dict,
                 device, precision: str = "float32") -> List[torch.Tensor]:
    """Final hidden states (n, d_model) float32 of each framed unit (a
    sequence of embedding rows)."""
    fp8 = precision == "fp8"
    if precision == "bf16_stream":
        def stream(t):
            return t.to(torch.bfloat16).float()
    else:
        def stream(t):
            return t
    H, dk, eps = m["num_heads"], m["d_kv"], m["layer_norm_epsilon"]
    f32 = {k: v for k, v in state.items() if not k.startswith("encoder.blocks.")}
    embed = f32["encoder.embed.weight"].float()
    table = f32["encoder.rel_bias.weight"].float()
    xs = [embed[torch.as_tensor(list(u), device=device)] for u in units]
    biases: Dict[int, torch.Tensor] = {}
    for x in xs:
        L = x.shape[0]
        if L not in biases:
            b = rel_buckets(L, m["relative_attention_num_buckets"], m["relative_attention_max_distance"])
            biases[L] = table[b.to(device)].permute(2, 0, 1).contiguous()  # (H, L, L)
    for i in range(m["num_layers"]):
        w = {k: state[f"encoder.blocks.{i}.{k}.weight"].float()
             for k in ("ln1", "q", "k", "v", "o", "ln2", "wi", "wo")}
        for j, x in enumerate(xs):
            L = x.shape[0]
            h = _rms(x, w["ln1"], eps)
            q, k, v = (_mm(h, w[n].T, fp8).view(L, H, dk).transpose(0, 1) for n in ("q", "k", "v"))
            s = _mm(q, k.transpose(1, 2), fp8) + biases[L]
            ctx = _mm(torch.softmax(s, dim=-1), v, fp8).transpose(0, 1).reshape(L, H * dk)
            x = stream(x + _mm(ctx, w["o"].T, fp8))
            h = _rms(x, w["ln2"], eps)
            xs[j] = stream(x + _mm(torch.relu(_mm(h, w["wi"].T, fp8)), w["wo"].T, fp8))
        del w
    ln = f32["encoder.final_ln.weight"].float()
    return [_rms(x, ln, eps) for x in xs]


def head_logits(h: torch.Tensor, state: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(r, n_classes) logits of the residue rows `h` (r, d_model)."""
    w1, b1 = state["head.conv1.weight"].float(), state["head.conv1.bias"].float()
    w2, b2 = state["head.conv2.weight"].float(), state["head.conv2.bias"].float()
    y = h.T[None]
    y = torch.relu(F.conv1d(y, w1, b1, padding=w1.shape[2] // 2))
    return F.conv1d(y, w2, b2, padding=w2.shape[2] // 2)[0].T


def token_rows(protein: str, table: Dict) -> List[int]:
    """[prefix, residues..., eos] as embedding rows of the token table."""
    res = table["residues"]
    rows = [res.index(c) if c in res else table["unknown"] for c in protein]
    return [table["prefix"], *rows, table["eos"]]


@torch.inference_mode()
def protein_logits(proteins: Sequence[str], state: Dict[str, torch.Tensor], m: Dict, table: Dict,
                   window: int, overlap: int, device, precision: str = "float32") -> List[np.ndarray]:
    """(len, n_classes) float32 logits of each protein, each residue's from
    the window that owns it."""
    units, where = [], []
    for p, s in enumerate(proteins):
        for k, (st, ln) in enumerate(counts.windows(len(s), window, overlap)):
            units.append(token_rows(s[st : st + ln], table))
            where.append((p, k, st))
    with no_tf32():
        hs = encode_units(units, state, m, device, precision)
        logits = [head_logits(h[1:-1], state).cpu().numpy() for h in hs]
    per: Dict[int, Dict[int, tuple]] = {}
    for (p, k, st), lg in zip(where, logits):
        per.setdefault(p, {})[k] = (st, lg)
    out = []
    for p, s in enumerate(proteins):
        own = counts.owners(len(s), window, overlap)
        rows = np.empty((len(s), logits[0].shape[1]), np.float32)
        for pos, k in enumerate(own):
            st, lg = per[p][k]
            rows[pos] = lg[pos - st]
        out.append(rows)
    return out
