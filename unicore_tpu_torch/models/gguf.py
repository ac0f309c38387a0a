"""Minimal GGUF reader — loads foldseek's `prostt5-f16.gguf` weights.

The reference's weight artifact is a GGUF file fetched by
`foldseek databases ProstT5` (createdb.rs:148-155 checks for the .gguf
and rejects the older cnn.safetensors layout).  This module reads the
GGUF container (v2/v3: header, typed metadata KVs, tensor directory,
aligned data section) for F32/F16 tensors and translates llama.cpp's
T5-encoder tensor names to the HF names consumed by
models/prostt5.py::load_params.  Tensor shapes: GGML stores dimensions
innermost-first (ne[0] fastest); reading data row-major with the
REVERSED dims reproduces the original torch shape, so no transposes are
applied here.

A matching writer exists for round-trip tests (no real GGUF is
available offline).

Copy of unicore_tpu/models/gguf.py (numpy only).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

GGUF_MAGIC = b"GGUF"
# metadata value types
T_U8, T_I8, T_U16, T_I16, T_U32, T_I32, T_F32, T_BOOL, T_STR, T_ARR, T_U64, T_I64, T_F64 = range(13)
GGML_F32, GGML_F16, GGML_Q8_0 = 0, 1, 8
Q8_BLOCK = 32  # ggml q8_0: fp16 scale + 32 int8 quants per block
_Q8_DT = np.dtype([("d", "<f2"), ("q", "i1", (Q8_BLOCK,))])
_SCALAR = {
    T_U8: ("<B", 1), T_I8: ("<b", 1), T_U16: ("<H", 2), T_I16: ("<h", 2),
    T_U32: ("<I", 4), T_I32: ("<i", 4), T_F32: ("<f", 4), T_BOOL: ("<B", 1),
    T_U64: ("<Q", 8), T_I64: ("<q", 8), T_F64: ("<d", 8),
}


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def u32(self) -> int:
        v = struct.unpack_from("<I", self.d, self.o)[0]
        self.o += 4
        return v

    def u64(self) -> int:
        v = struct.unpack_from("<Q", self.d, self.o)[0]
        self.o += 8
        return v

    def string(self) -> str:
        n = self.u64()
        v = self.d[self.o : self.o + n].decode("utf-8", "replace")
        self.o += n
        return v

    def value(self, t: int):
        if t == T_STR:
            return self.string()
        if t == T_ARR:
            et = self.u32()
            n = self.u64()
            return [self.value(et) for _ in range(n)]
        fmt, sz = _SCALAR[t]
        v = struct.unpack_from(fmt, self.d, self.o)[0]
        self.o += sz
        return bool(v) if t == T_BOOL else v


def read_gguf(path: str) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """Returns (metadata, {tensor_name: float32 ndarray})."""
    with open(path, "rb") as f:
        data = f.read()
    r = _Reader(data)
    if data[:4] != GGUF_MAGIC:
        raise ValueError(f"not a GGUF file: {path}")
    r.o = 4
    version = r.u32()
    if version not in (2, 3):
        raise ValueError(f"unsupported GGUF version {version}")
    n_tensors = r.u64()
    n_kv = r.u64()
    meta: Dict = {}
    for _ in range(n_kv):
        key = r.string()
        t = r.u32()
        meta[key] = r.value(t)
    infos: List[Tuple[str, Tuple[int, ...], int, int]] = []
    for _ in range(n_tensors):
        name = r.string()
        nd = r.u32()
        dims = tuple(r.u64() for _ in range(nd))  # ne: innermost first
        dtype = r.u32()
        off = r.u64()
        infos.append((name, dims, dtype, off))
    align = int(meta.get("general.alignment", 32))
    base = (r.o + align - 1) // align * align
    tensors: Dict[str, np.ndarray] = {}
    for name, dims, dtype, off in infos:
        count = int(np.prod(dims)) if dims else 1
        shape = tuple(reversed(dims))  # torch/HF row-major shape
        if dtype == GGML_F32:
            arr = np.frombuffer(data, np.float32, count, base + off)
        elif dtype == GGML_F16:
            arr = np.frombuffer(data, np.float16, count, base + off).astype(np.float32)
        elif dtype == GGML_Q8_0:
            # foldseek also ships quantized ProstT5 variants; q8_0 is the
            # common one (createdb.rs:144-155 artifact family)
            if count % Q8_BLOCK:
                raise ValueError(f"tensor {name}: q8_0 needs count % {Q8_BLOCK} == 0")
            blocks = np.frombuffer(data, _Q8_DT, count // Q8_BLOCK, base + off)
            arr = (blocks["d"].astype(np.float32)[:, None]
                   * blocks["q"].astype(np.float32)).reshape(-1)
        else:
            raise ValueError(f"tensor {name}: unsupported ggml dtype {dtype} "
                             "(F32/F16/Q8_0 weights are expected in prostt5 ggufs)")
        tensors[name] = arr.reshape(shape)
    return meta, tensors


def quantize_q8_0(arr: np.ndarray) -> bytes:
    """ggml q8_0 quantization (per-32 block: d = amax/127, q = round(x/d))."""
    flat = np.ascontiguousarray(arr, dtype=np.float32).reshape(-1)
    if flat.size % Q8_BLOCK:
        raise ValueError(f"q8_0 needs size % {Q8_BLOCK} == 0, got {flat.size}")
    x = flat.reshape(-1, Q8_BLOCK)
    amax = np.abs(x).max(axis=1)
    d = (amax / 127.0).astype(np.float16)
    df = d.astype(np.float32)
    inv = np.where(df > 0, 1.0 / np.where(df > 0, df, 1.0), 0.0)
    q = np.clip(np.rint(x * inv[:, None]), -127, 127).astype(np.int8)
    out = np.empty(x.shape[0], dtype=_Q8_DT)
    out["d"] = d
    out["q"] = q
    return out.tobytes()


# ---------------------------------------------------------------------------
# llama.cpp T5-encoder names -> HF names (prostt5.py::load_params input)
# ---------------------------------------------------------------------------

_STATIC = {
    "token_embd.weight": "shared.weight",
    "enc.output_norm.weight": "encoder.final_layer_norm.weight",
}
_BLK = {
    "attn_norm.weight": "layer.0.layer_norm.weight",
    "attn_q.weight": "layer.0.SelfAttention.q.weight",
    "attn_k.weight": "layer.0.SelfAttention.k.weight",
    "attn_v.weight": "layer.0.SelfAttention.v.weight",
    "attn_o.weight": "layer.0.SelfAttention.o.weight",
    "attn_rel_b.weight": "layer.0.SelfAttention.relative_attention_bias.weight",
    "ffn_norm.weight": "layer.1.layer_norm.weight",
    "ffn_up.weight": "layer.1.DenseReluDense.wi.weight",
    "ffn_down.weight": "layer.1.DenseReluDense.wo.weight",
    # gated variant (v1.1-style checkpoints)
    "ffn_gate.weight": "layer.1.DenseReluDense.wi_0.weight",
}


def gguf_to_hf_tensors(tensors: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Translate tensor names; unknown names pass through unchanged (the
    CNN classifier head keeps its torch names in foldseek's artifact)."""
    gated = any(k.endswith("ffn_gate.weight") for k in tensors)
    out: Dict[str, np.ndarray] = {}
    for name, arr in tensors.items():
        if name in _STATIC:
            out[_STATIC[name]] = arr
            continue
        if name.startswith("enc.blk."):
            rest = name[len("enc.blk."):]
            i, _, tail = rest.partition(".")
            hf_tail = _BLK.get(tail)
            if hf_tail is not None:
                if gated and tail == "ffn_up.weight":
                    hf_tail = "layer.1.DenseReluDense.wi_1.weight"
                out[f"encoder.block.{i}.{hf_tail}"] = arr
                continue
        out[name] = arr
    return out


def vocab_from_gguf(meta: Dict):
    """ProstT5Vocab from the embedded tokenizer (tokenizer.ggml.tokens)."""
    from unicore_tpu_torch.models.tokenizer import _vocab_from_piece_ids

    tokens = meta.get("tokenizer.ggml.tokens")
    if not tokens:
        return None
    return _vocab_from_piece_ids(
        {tok: i for i, tok in enumerate(tokens)}, "gguf"
    )


def find_gguf(model_dir: str) -> Optional[str]:
    if not os.path.isdir(model_dir):
        return None
    cands = sorted(f for f in os.listdir(model_dir) if f.endswith(".gguf"))
    return os.path.join(model_dir, cands[0]) if cands else None


# ---------------------------------------------------------------------------
# writer (tests only — no real GGUF is redistributable offline)
# ---------------------------------------------------------------------------

def write_gguf(path: str, meta: Dict, tensors: Dict[str, np.ndarray],
               quant: Optional[Dict[str, str]] = None) -> None:
    """`quant`: optional {tensor_name: "q8_0"} — unlisted tensors write
    as F16 (the prostt5-f16.gguf layout)."""
    align = 32
    quant = quant or {}

    def s(b: bytearray, v: str) -> None:
        enc = v.encode()
        b += struct.pack("<Q", len(enc)) + enc

    head = bytearray()
    head += GGUF_MAGIC + struct.pack("<IQQ", 3, len(tensors), len(meta))
    for k, v in meta.items():
        s(head, k)
        if isinstance(v, str):
            head += struct.pack("<I", T_STR)
            s(head, v)
        elif isinstance(v, list):
            head += struct.pack("<IIQ", T_ARR, T_STR, len(v))
            for e in v:
                s(head, e)
        elif isinstance(v, int):
            head += struct.pack("<Ii", T_I32, v)
        else:
            raise TypeError(type(v))
    blobs = []
    off = 0
    for name, arr in tensors.items():
        s(head, name)
        dims = tuple(reversed(np.asarray(arr).shape))
        head += struct.pack("<I", len(dims))
        for d in dims:
            head += struct.pack("<Q", d)
        if quant.get(name) == "q8_0":
            head += struct.pack("<IQ", GGML_Q8_0, off)
            blob = quantize_q8_0(np.asarray(arr))
        else:
            head += struct.pack("<IQ", GGML_F16, off)
            blob = np.ascontiguousarray(arr, dtype=np.float16).tobytes()
        pad = (-len(blob)) % align
        blobs.append(blob + b"\x00" * pad)
        off += len(blob) + pad
    with open(path, "wb") as f:
        f.write(head)
        f.write(b"\x00" * ((-len(head)) % align))
        for b in blobs:
            f.write(b)
