"""Operations and bytes, counted by the benchmark from shapes.

`model_flops` is the FLOP count of the framed units that the inputs need
(never the batches the program formed); `windows` is the engine's output
contract for proteins longer than a window, worked out here again.
`gemm_cost` and `attention_cost` count one launched product or one
attention call, each input byte read once and each output byte written
once.  `peaks` reads the table of the chip's published peaks.

A frozen, adapted copy of chip_smoke.prostt5_bound's arithmetic, which
counts padded batch tokens.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
DTYPE_BYTES = {"bfloat16": 2, "half": 2, "float": 4}


def peaks(kind: str) -> Optional[Dict[str, float]]:
    """The published peaks of the device named `kind`, or None."""
    with open(os.path.join(_HERE, "peaks.json")) as f:
        table = json.load(f)
    return table["devices"].get(kind)


def windows(n: int, window: int, overlap: int) -> List[Tuple[int, int]]:
    """(start, length) of the units a protein of `n` residues is read in:
    one unit up to `window`, else windows of `window` overlapping by
    `overlap`, the last one ending at the protein's end."""
    if n <= window:
        return [(0, n)]
    starts = list(range(0, n - window + 1, window - overlap))
    if starts[-1] + window < n:
        starts.append(n - window)
    return [(s, window) for s in starts]


def owners(n: int, window: int, overlap: int) -> List[int]:
    """For each residue the index of the window whose letter is kept:
    each window owns from the previous one's end less overlap / 2."""
    own = [0] * n
    bound = 0
    for k, (st, ln) in enumerate(windows(n, window, overlap)):
        for p in range(max(bound, st), st + ln):
            own[p] = k
        bound = st + ln - overlap // 2
    return own


def unit_residues(lengths: Iterable[int], window: int, overlap: int) -> List[int]:
    """Residues of every unit the proteins of `lengths` are read in."""
    return [ln for n in lengths for _, ln in windows(n, window, overlap)]


def layer_flops(n: int, m: Dict) -> int:
    """One encoder layer on a framed unit of n tokens: the q, k, v, o and
    FFN products, and q·kᵀ and probs·v."""
    D, F, H, dk = m["d_model"], m["d_ff"], m["num_heads"], m["d_kv"]
    ffn = 2 * D * F if m.get("feed_forward_proj", "relu") == "relu" else 3 * D * F
    return 2 * n * (4 * D * H * dk + ffn) + 4 * H * n * n * dk


def head_flops(r: int, m: Dict) -> int:
    """The CNN head's two convolutions over r residues."""
    C, K = m["cnn_hidden"], m["cnn_kernel"]
    return 2 * r * K * (m["d_model"] * C + C * m["n_classes"])


def model_flops(residues: Iterable[int], m: Dict) -> int:
    """Model FLOPs of units of `residues`, each framed [prefix, residues,
    eos] (n = r + 2)."""
    return sum(m["num_layers"] * layer_flops(r + 2, m) + head_flops(r, m) for r in residues)


def numel(shape: Sequence[int]) -> int:
    out = 1
    for s in shape:
        out *= int(s)
    return out


def matmul_dims(a: Sequence[int], b: Sequence[int]) -> Tuple[int, int, int, int]:
    """(batch, m, k, n) of a product of an (..., m, k) and a (..., k, n)."""
    if len(a) < 2 or len(b) < 2 or a[-1] != b[-2]:
        raise ValueError(f"not a product: {list(a)} x {list(b)}")
    return numel(a[:-2]), int(a[-2]), int(a[-1]), int(b[-1])


def gemm_cost(a: Sequence[int], b: Sequence[int], in_bytes: int, out_bytes: int) -> Tuple[int, int]:
    """(flops, bytes) of one product: A and B read once, C written once."""
    bt, m, k, n = matmul_dims(a, b)
    return 2 * bt * m * k * n, bt * (m * k + k * n) * in_bytes + bt * m * n * out_bytes


def attention_cost(rows: int, heads: int, L: int, d: int) -> Tuple[int, int]:
    """(flops, bytes) of one attention call of `rows` batch rows: q·kᵀ and
    probs·v, 4·rows·heads·L²·d; bf16 q, k, v and output read or written
    once, the float32 relative bias (heads, L, L) and the bool key mask
    (rows, L) read once."""
    flops = 4 * rows * heads * L * L * d
    nbytes = 4 * rows * heads * L * d * 2 + heads * L * L * 4 + rows * L
    return flops, nbytes


def bound_s(flops: float, nbytes: float, pk: Dict[str, float]) -> Tuple[float, str]:
    """(seconds, which) of the least time: the larger of the operations
    over the bf16 peak and the bytes over the peak bandwidth."""
    t_ops, t_bytes = flops / pk["bf16_flops_per_s"], nbytes / pk["hbm_bytes_per_s"]
    return (t_ops, "compute") if t_ops >= t_bytes else (t_bytes, "memory")
