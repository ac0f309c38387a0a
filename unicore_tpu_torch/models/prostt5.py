"""ProstT5 AA->3Di translation: a T5 encoder and a CNN head in PyTorch.

Replaces `foldseek createdb --prostt5-model` (createdb.rs:158-166): every
amino-acid sequence is translated to an equal-length 3Di string.  The
network is the ProstT5 architecture — a ProtT5-XL encoder, which is the
*original* T5 (v1.0) encoder stack: 24 layers, d_model 1024, 32 heads
with d_kv 128, d_ff 16384 with a single-`wi` **relu** FFN, T5
relative-position buckets, RMSNorm — followed by the 2-layer
residue-wise CNN head (1024 -> 32 -> 20, kernel 7, same zero padding)
that predicts 3Di states in alphabetical class order
``ACDEFGHIKLMNPQRSTVWY`` (``alphabets.TDI_ALPHABET``).

Inference contract (ProstT5's encoder-only predictor): the encoder input
is ``[<AA2fold>, residue tokens..., </s>]``; the CNN head sees only the
residue hidden states (positions outside the residues are zeroed, which
reproduces the reference's per-sequence slice + zero-padded conv).

Counterpart of unicore_tpu/models/prostt5.py.  The parameters are an
`nn.Module` state in the HF layout (`nn.Linear` weights are (out, in),
the head's `nn.Conv1d` weights (out, in, K)); `init_params` draws JAX's
numbers with the same numpy generator, `state_from_tree` takes JAX's
parameter tree (`convert.prostt5_from_jax`).  The arithmetic follows the
JAX function's casts step by step: RMSNorm's variance in float32, scores
in float32 from bf16 q and k with the bias and the -1e9 mask added in
float32, softmax in float32 cast to bf16 before `probs @ v`, a bf16
residual stream, a float32 CNN head and argmax on float32 logits.
Every entry point runs under `full_precision`: no TF32 in float32
products or convolutions (cuDNN's default), no bf16 split-K reductions
(cuBLAS's default); the caller's settings come back afterwards.  On the
card the score product of a bf16 model is one bf16 GEMM with a float32
output (`out_dtype`), which accumulates in float32 as XLA's
`preferred_element_type=float32` does; elsewhere q and k are widened to
float32 first, which holds bf16 values exactly.  Relative-position
buckets are computed on the host in float32 (`_rel_bucket`), as JAX
computes them, once per offset and cached per length, so the device's
`log` never decides a bucket.  The relative bias and the -1e9 key mask
are the same in every layer, so their sum is made once per forward, in
float32, and added to each chunk of scores in place, a contiguous add;
where a key is valid the mask is 0, so the sum is JAX's
`scores + bias + mask`.  Attention runs over chunks of batch rows of at
most ATTN_CHUNK_BYTES of float32 scores.

Where parallel.mesh.local_mesh gives a mesh (several cards), the engine
predicts data-parallel through parallel/sharding.py's
`make_sharded_predict`, one replica per card, each batch padded to a
multiple of 8 rows per card (the JAX engine's `_dp_setup`).

Training: `build_model(..., trainable=True)` keeps the parameters
trainable, and `train_logits` is the forward of JAX's `loss_fn` under
`full_precision` with autograd; parallel/sharding.py holds the loss, the
Adam step and the sharded model, which runs the blocks through the same
`rms_norm`, `self_attention`, `feed_forward` and `relative_bias_mask`
on slices of the weights.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unicore_tpu_torch.alphabets import TDI_ALPHABET, encode_aa
from unicore_tpu_torch.models.tokenizer import load_vocab
from unicore_tpu_torch.parallel import mesh as mesh_mod
from unicore_tpu_torch.parallel import sharding
from unicore_tpu_torch.runtime import device as device_mod
from unicore_tpu_torch.runtime import logging as msg
from unicore_tpu_torch.runtime import profiling

# Internal token codes.  0..20 are the AA codes from alphabets.py; the
# specials sit above them so "is residue" is `tok < TOK_PREFIX`.
TOK_PREFIX = 21   # <AA2fold> direction token
TOK_EOS = 22      # </s>
TOK_PAD = 23      # <pad>

ATTN_CHUNK_BYTES = 1 << 30  # float32 scores per attention chunk of batch rows
_TDI = np.frombuffer(TDI_ALPHABET.encode(), dtype=np.uint8)  # class index -> 3Di letter


@dataclass(frozen=True)
class T5Config:
    vocab: int = 25           # 20 AA + X + prefix/eos/pad + spare
    d_model: int = 1024
    d_kv: int = 128
    n_heads: int = 32
    d_ff: int = 16384
    n_layers: int = 24
    rel_buckets: int = 32
    rel_max_dist: int = 128
    n_classes: int = 20       # 3Di states
    cnn_hidden: int = 32
    cnn_kernel: int = 7
    ff: str = "relu"          # ProtT5/ProstT5 = original T5: single-wi relu
                              # ("gated-gelu" supported for v1.1-style ckpts)

    @classmethod
    def small(cls) -> "T5Config":
        """Reduced config for tests."""
        return cls(d_model=256, d_kv=32, n_heads=8, d_ff=1024, n_layers=4)


# ---------------------------------------------------------------------------
# parameters: JAX's tree, the port's state
# ---------------------------------------------------------------------------

def _init_tree(cfg: T5Config, seed: int) -> Dict:
    """JAX's init_params before its cast: the same numpy draws, in the
    same order, as a tree of float32 arrays in JAX's layout."""
    rng = np.random.RandomState(seed)

    def mat(*shape, scale=None):
        scale = scale or (1.0 / math.sqrt(shape[0]))
        return (rng.randn(*shape) * scale).astype(np.float32)

    tree: Dict = {
        "embed": mat(cfg.vocab, cfg.d_model, scale=1.0),
        "rel_bias": mat(cfg.rel_buckets, cfg.n_heads, scale=0.1),
        "final_ln": np.ones(cfg.d_model, np.float32),
        "layers": [],
        "cnn": {
            "w1": mat(cfg.cnn_kernel, cfg.d_model, cfg.cnn_hidden),
            "b1": np.zeros(cfg.cnn_hidden, np.float32),
            "w2": mat(cfg.cnn_kernel, cfg.cnn_hidden, cfg.n_classes),
            "b2": np.zeros(cfg.n_classes, np.float32),
        },
    }
    inner = cfg.n_heads * cfg.d_kv
    for _ in range(cfg.n_layers):
        layer = {
            "ln1": np.ones(cfg.d_model, np.float32),
            "q": mat(cfg.d_model, inner),
            "k": mat(cfg.d_model, inner),
            "v": mat(cfg.d_model, inner),
            "o": mat(inner, cfg.d_model),
            "ln2": np.ones(cfg.d_model, np.float32),
            "wo": mat(cfg.d_ff, cfg.d_model),
        }
        if cfg.ff == "gated-gelu":
            layer["wi0"] = mat(cfg.d_model, cfg.d_ff)  # gate
            layer["wi1"] = mat(cfg.d_model, cfg.d_ff)  # linear
        else:
            layer["wi"] = mat(cfg.d_model, cfg.d_ff)   # original T5 relu
        tree["layers"].append(layer)
    return tree


def _tensor(a, dtype) -> torch.Tensor:
    a = np.ascontiguousarray(a, dtype=np.float32)
    return torch.from_numpy(a if a.flags.writeable else a.copy()).to(dtype)


def _default_head() -> Dict[str, np.ndarray]:
    """The head JAX's load_params takes when a checkpoint has no
    `classifier.*`: init_params(T5Config(), 0)["cnn"].  The layers are
    drawn after the head, so a layerless draw gives the same numbers."""
    return _init_tree(replace(T5Config(), n_layers=0), 0)["cnn"]


def _head_state(cnn: Dict, dtype) -> Dict[str, torch.Tensor]:
    """JAX's WIO (K, in, out) conv weights as conv1d's (out, in, K)."""
    return {
        "head.conv1.weight": _tensor(np.transpose(cnn["w1"], (2, 1, 0)), dtype),
        "head.conv1.bias": _tensor(cnn["b1"], dtype),
        "head.conv2.weight": _tensor(np.transpose(cnn["w2"], (2, 1, 0)), dtype),
        "head.conv2.bias": _tensor(cnn["b2"], dtype),
    }


def state_from_tree(tree: Dict, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """JAX's parameter tree (numpy leaves, JAX's (in, out) layout) as the
    port's state (`ProstT5` names, HF layout) in `dtype`."""
    st = {
        "encoder.embed.weight": _tensor(tree["embed"], dtype),
        "encoder.rel_bias.weight": _tensor(tree["rel_bias"], dtype),
        "encoder.final_ln.weight": _tensor(tree["final_ln"], dtype),
    }
    for i, layer in enumerate(tree["layers"]):
        pre = f"encoder.blocks.{i}."
        for name, a in layer.items():
            a = np.asarray(a, np.float32)
            st[pre + name + ".weight"] = _tensor(a if a.ndim == 1 else a.T, dtype)
    st.update(_head_state(tree["cnn"], dtype))
    return st


def init_params(cfg: T5Config, seed: int = 0, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The seeded initialization of JAX's init_params, as the port's state."""
    return state_from_tree(_init_tree(cfg, seed), dtype)


def infer_config(model_dir: Optional[str]) -> Optional[T5Config]:
    """Geometry from the checkpoint's HF config.json (shipped by every
    HF T5 checkpoint; absent from gguf dirs, which are fixed-geometry
    ProstT5-XL)."""
    if not model_dir or not os.path.isdir(model_dir):
        return None
    cj = os.path.join(model_dir, "config.json")
    if not os.path.isfile(cj):
        return None
    try:
        with open(cj) as f:
            d = json.load(f)
    except (OSError, ValueError):
        return None
    if "d_model" not in d:
        return None
    proj = d.get("feed_forward_proj", "relu")
    gated = bool(d.get("is_gated_act")) or str(proj).startswith("gated")
    return T5Config(
        d_model=int(d.get("d_model", 1024)),
        d_kv=int(d.get("d_kv", 128)),
        n_heads=int(d.get("num_heads", 32)),
        d_ff=int(d.get("d_ff", 16384)),
        n_layers=int(d.get("num_layers", 24)),
        rel_buckets=int(d.get("relative_attention_num_buckets", 32)),
        rel_max_dist=int(d.get("relative_attention_max_distance", 128)),
        ff="gated-gelu" if gated else "relu",
    )


# HF tensor name of each per-layer state name
_HF_LAYER = {
    "ln1": "0.layer_norm", "q": "0.SelfAttention.q", "k": "0.SelfAttention.k",
    "v": "0.SelfAttention.v", "o": "0.SelfAttention.o", "ln2": "1.layer_norm",
    "wo": "1.DenseReluDense.wo", "wi": "1.DenseReluDense.wi",
    "wi0": "1.DenseReluDense.wi_0", "wi1": "1.DenseReluDense.wi_1",
}


def load_params(model_dir: str, cfg: T5Config, dtype=torch.bfloat16) -> Optional[Dict[str, torch.Tensor]]:
    """Load from an HF ProstT5 checkpoint dir (safetensors, pytorch_model.bin
    or a foldseek GGUF) or JAX's `prostt5_tpu.npz` export; the port's
    state in `dtype`, or None where the directory holds no weights.

    Embedding rows are gathered from ``shared.weight`` through the
    checkpoint's sentencepiece vocabulary: internal AA codes 0..20 map to
    their real token ids (ids 3.. in ProtT5 frequency order, NOT a
    positional slice), TOK_PREFIX/TOK_EOS/TOK_PAD map to
    ``<AA2fold>``/``</s>``/``<pad>``.
    """
    npz = os.path.join(model_dir, "prostt5_tpu.npz")
    if os.path.isfile(npz):
        tree = _init_tree(cfg, 0)
        with np.load(npz) as raw:
            for key in raw.files:
                node, parts = tree, key.split("/")
                for p in parts[:-1]:
                    node = node[int(p) if p.isdigit() else p]
                node[int(parts[-1]) if parts[-1].isdigit() else parts[-1]] = raw[key]
        return state_from_tree(tree, dtype)

    tensors = _load_hf_tensors(model_dir)
    if tensors is None:
        return None

    def t(name):
        v = tensors.get(name)
        return None if v is None else np.asarray(v, np.float32)

    vocab = load_vocab(model_dir)
    shared = t("shared.weight")
    if shared is None:
        shared = t("encoder.embed_tokens.weight")
    row_ids = np.full(cfg.vocab, vocab.unk_id, dtype=np.int64)
    row_ids[: len(vocab.aa_ids)] = vocab.aa_ids
    row_ids[TOK_PREFIX] = vocab.prefix_id
    row_ids[TOK_EOS] = vocab.eos_id
    row_ids[TOK_PAD] = vocab.pad_id
    if row_ids.max() >= shared.shape[0]:
        msg.println_message(
            f"Warning: vocab id {int(row_ids.max())} out of range for "
            f"shared.weight rows {shared.shape[0]}; clamping (the affected "
            "token embeddings will be wrong — check the tokenizer files).", 1,
        )
        row_ids = np.minimum(row_ids, shared.shape[0] - 1)

    # FFN flavor from the checkpoint names (original T5 = single wi+relu);
    # the model takes its blocks' FFN from the state's names, so a
    # v1.1-style gated checkpoint works even if cfg.ff says "relu".
    gated_ckpt = "encoder.block.0.layer.1.DenseReluDense.wi_0.weight" in tensors
    ffn = ("wi0", "wi1") if gated_ckpt else ("wi",)

    st = {
        "encoder.embed.weight": _tensor(shared[row_ids], dtype),
        "encoder.rel_bias.weight": _tensor(
            t("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"), dtype),
        "encoder.final_ln.weight": _tensor(t("encoder.final_layer_norm.weight"), dtype),
    }
    for i in range(cfg.n_layers):
        for name in ("ln1", "q", "k", "v", "o", "ln2", "wo") + ffn:
            st[f"encoder.blocks.{i}.{name}.weight"] = _tensor(
                t(f"encoder.block.{i}.layer.{_HF_LAYER[name]}.weight"), dtype)
    # CNN head (foldseek's prostt5 CNN checkpoint layout: torch conv2d
    # weights (out, in, 7, 1))
    if t("classifier.0.weight") is not None:
        st["head.conv1.weight"] = _tensor(t("classifier.0.weight")[..., 0], dtype)
        st["head.conv1.bias"] = _tensor(t("classifier.0.bias"), dtype)
        st["head.conv2.weight"] = _tensor(t("classifier.3.weight")[..., 0], dtype)
        st["head.conv2.bias"] = _tensor(t("classifier.3.bias"), dtype)
    else:
        st.update(_head_state(_default_head(), dtype))
    return st


def _load_hf_tensors(model_dir: str) -> Optional[Dict[str, np.ndarray]]:
    st_files = [f for f in os.listdir(model_dir) if f.endswith(".safetensors")] if os.path.isdir(model_dir) else []
    if st_files:
        out = {}
        for f in sorted(st_files):
            out.update(read_safetensors(os.path.join(model_dir, f)))
        return out
    bin_path = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.isfile(bin_path):
        sd = torch.load(bin_path, map_location="cpu", weights_only=True)
        return {k: v.float().numpy() for k, v in sd.items()}
    # foldseek's weight artifact (createdb.rs:148: prostt5-f16.gguf)
    from unicore_tpu_torch.models.gguf import find_gguf, gguf_to_hf_tensors, read_gguf
    gg = find_gguf(model_dir)
    if gg is not None:
        _, tensors = read_gguf(gg)
        return gguf_to_hf_tensors(tensors)
    return None


_ST_DTYPES = {"F32": np.dtype("<f4"), "F16": np.dtype("<f2"), "BF16": np.dtype("<u2")}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """{name: float32 array} of a `.safetensors` file: an 8-byte
    little-endian header length, a JSON header of {name: {dtype, shape,
    data_offsets}}, then the raw little-endian buffers (F32, F16, BF16;
    bf16 widens to float32 by a 16-bit shift)."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = np.frombuffer(data, "<u8", 1, 0)
    header = json.loads(data[8 : 8 + int(n)])
    base = 8 + int(n)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = _ST_DTYPES.get(info["dtype"])
        if dt is None:
            raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']} "
                             "(F32/F16/BF16 are expected in a ProstT5 checkpoint)")
        begin, end = info["data_offsets"]
        a = np.frombuffer(data, dt, (end - begin) // dt.itemsize, base + begin)
        if info["dtype"] == "BF16":
            a = (a.astype(np.uint32) << 16).view(np.float32)
        out[name] = a.astype(np.float32).reshape(info["shape"])
    return out


# ---------------------------------------------------------------------------
# precision guard and relative-position buckets
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def full_precision():
    """Float32 products and convolutions at full float32 (no TF32 in
    cuBLAS or cuDNN) and bf16 products reduced in float32 (no bf16
    split-K reduction), whatever the process-wide settings say; restores
    them.  The counterpart of phylo/likelihood.py::full_fp32 for a model
    that also convolves and multiplies in bf16."""
    cuda = torch.backends.cuda.matmul
    prev = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32,
            cuda.allow_bf16_reduced_precision_reduction)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    cuda.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cudnn.allow_tf32 = prev[1]
        cuda.allow_bf16_reduced_precision_reduction = prev[2]


def _in_full_precision(fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with full_precision(), torch.inference_mode():
            return fn(*args, **kwargs)
    return wrapper


def _rel_bucket(rel_pos: torch.Tensor, n_buckets: int = 32, max_dist: int = 128) -> torch.Tensor:
    """T5 bidirectional relative position bucketing on int tensors (HF's
    rule), in JAX's float32 order: trunc(log(n / 8) / log(16) * 8)."""
    num = n_buckets // 2
    ret = torch.where(rel_pos > 0, num, 0)
    n = rel_pos.abs()
    max_exact = num // 2
    is_small = n < max_exact
    # max(n, max_exact) keeps log() >= 0 where the large branch is unused,
    # so the truncation toward zero matches HF's .long() exactly.
    val_large = max_exact + (
        torch.log(torch.clamp(n, min=max_exact).to(torch.float32) / max_exact)
        / math.log(max_dist / max_exact)
        * (num - max_exact)
    ).to(torch.int32)
    val_large = torch.clamp(val_large, max=num - 1)
    return ret + torch.where(is_small, n, val_large)


@functools.lru_cache(maxsize=16)
def _offset_buckets(L: int, n_buckets: int, max_dist: int) -> torch.Tensor:
    """(2L - 1,) int64 bucket of each offset key - query from -(L - 1) to
    L - 1, computed on the host's CPU.  Runs only where the cache misses:
    `prostt5.bias_table.builds` counts those runs."""
    profiling.add_counter("prostt5.bias_table.builds", 1)
    rel = torch.arange(-(L - 1), L, dtype=torch.int64)
    return _rel_bucket(rel, n_buckets, max_dist).to(torch.int64)


def _bucket_table(L: int, n_buckets: int, max_dist: int, device="cpu") -> torch.Tensor:
    """(L, L) int64 bucket of (key - query) on `device`: the host's
    per-offset buckets, indexed there."""
    pos = torch.arange(L, device=device)
    return _offset_buckets(L, n_buckets, max_dist).to(device)[(pos[None, :] - pos[:, None]) + (L - 1)]


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    """T5's RMSNorm: variance in float32, `(x * rsqrt).astype(x.dtype) * w`."""

    def __init__(self, d: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


def rms_norm(x, w, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


class T5Block(nn.Module):
    """Self-attention then FFN, each pre-normed with a residual add."""

    def __init__(self, cfg: T5Config, gated: bool):
        super().__init__()
        inner = cfg.n_heads * cfg.d_kv
        self.n_heads, self.d_kv = cfg.n_heads, cfg.d_kv
        self.ln1 = RMSNorm(cfg.d_model)
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        self.ln2 = RMSNorm(cfg.d_model)
        if gated:
            self.wi0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
            self.wi1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        else:
            self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x, bias_mask):
        x = x + self_attention(self.ln1(x), self.q.weight, self.k.weight, self.v.weight, self.o.weight,
                               self.d_kv, bias_mask)
        w_in = (self.wi.weight,) if hasattr(self, "wi") else (self.wi0.weight, self.wi1.weight)
        return x + feed_forward(self.ln2(x), w_in, self.wo.weight)


def self_attention(h, wq, wk, wv, wo, d_kv: int, bias_mask):
    """The attention sublayer's output (before the residual add) of the
    normed input `h` (B, L, D): q, k and v through (heads x d_kv, D)
    weights, attention under the (B, heads, L, L) float32 `bias_mask`,
    and the output product through `wo` (D, heads x d_kv).  On a slice
    of the heads (rows of wq/wk/wv, columns of wo) it is that slice's
    share of the whole sublayer's output."""
    B, L, _ = h.shape
    q, k, v = (F.linear(h, w).view(B, L, -1, d_kv).transpose(1, 2) for w in (wq, wk, wv))
    with profiling.span("prostt5.attention", device=q.is_cuda):
        ctx = _attention(q, k, v, bias_mask)
    return F.linear(ctx.transpose(1, 2).reshape(B, L, -1), wo)


def feed_forward(h, w_in, wo):
    """The FFN sublayer's output of the normed input `h`: relu through
    `w_in` = (wi,), or gated-gelu through (wi0, wi1), then `wo`.  On a
    slice of d_ff (rows of w_in, columns of wo) it is that slice's share."""
    if len(w_in) == 1:
        return F.linear(torch.relu(F.linear(h, w_in[0])), wo)
    g = F.gelu(F.linear(h, w_in[0]), approximate="tanh")
    return F.linear(g * F.linear(h, w_in[1]), wo)


def _scores(q, k, bias_mask):
    """float32 q·kᵀ + bias_mask of (n, H, L, d) q and k and an (n, H, L, L)
    float32 bias_mask, the product accumulated in float32: from bf16 q
    and k on the card one bf16 GEMM with a float32 output, else in
    float32 (exact for bf16 values; full float32 under full_precision)."""
    n, H, L, d = q.shape
    q, k = q.reshape(n * H, L, d), k.reshape(n * H, L, d)
    if q.is_cuda and q.dtype == torch.bfloat16:
        s = torch.bmm(q, k.mT, out_dtype=torch.float32)
    else:
        s = torch.bmm(q.float(), k.float().mT)
    return s.view(n, H, L, L).add_(bias_mask)


def _attention(q, k, v, bias_mask):
    """softmax(q·kᵀ + bias_mask) · v over chunks of batch rows, so that
    no float32 score tensor passes ATTN_CHUNK_BYTES; each chunk's scores
    are freed before the next."""
    B, H, L, _ = q.shape
    step = max(1, min(B, ATTN_CHUNK_BYTES // (H * L * L * 4)))
    out = torch.empty_like(v)
    for b0 in range(0, B, step):
        bs = slice(b0, b0 + step)
        s = _scores(q[bs], k[bs], bias_mask[bs])
        p = torch.softmax(s, dim=-1)
        del s
        out[bs] = torch.matmul(p.to(v.dtype), v[bs])
        del p
    return out


def relative_bias_mask(rel_bias, mask, cfg: T5Config):
    """(B, H, L, L) float32 relative bias plus the -1e9 key mask, shared
    by the blocks, of the (buckets, H) `rel_bias` weight (all heads, or
    a slice of them) and the (B, L) bool `mask`."""
    with profiling.span("prostt5.bias_table"):
        buckets = _bucket_table(mask.shape[1], cfg.rel_buckets, cfg.rel_max_dist, mask.device)
    # (1, H, L, L), contiguous: the sum below takes its layout, and
    # the scores' in-place add wants it to match theirs
    bias = rel_bias[buckets].permute(2, 0, 1).float().contiguous()[None]
    attn_mask = torch.where(mask[:, None, None, :], 0.0, -1e9).to(torch.float32)
    return bias + attn_mask


class T5Encoder(nn.Module):
    """Embedding, the block stack (relative bias of block 0 shared by all
    blocks, as in T5) and the final RMSNorm."""

    def __init__(self, cfg: T5Config, gated: bool):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab, cfg.d_model)
        self.rel_bias = nn.Embedding(cfg.rel_buckets, cfg.n_heads)
        self.blocks = nn.ModuleList(T5Block(cfg, gated) for _ in range(cfg.n_layers))
        self.final_ln = RMSNorm(cfg.d_model)

    def forward(self, tokens, mask):
        """tokens (B, L) int; mask (B, L) bool.  Returns (B, L, d_model)."""
        x = self.embed(tokens)
        bias_mask = relative_bias_mask(self.rel_bias.weight, mask, self.cfg)
        for blk in self.blocks:
            x = blk(x, bias_mask)
        return self.final_ln(x)


class CNNHead(nn.Module):
    """Residue-wise conv head: (B, L, D) -> (B, L, n_classes) float32 logits."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        pad = cfg.cnn_kernel // 2
        self.conv1 = nn.Conv1d(cfg.d_model, cfg.cnn_hidden, cfg.cnn_kernel, padding=pad)
        self.conv2 = nn.Conv1d(cfg.cnn_hidden, cfg.n_classes, cfg.cnn_kernel, padding=pad)

    def forward(self, x, res_mask=None):
        x = x.float()
        m = None if res_mask is None else res_mask[:, None, :].float()
        y = x.transpose(1, 2)  # (B, D, L)
        if m is not None:
            y = y * m
        c1, c2 = self.conv1, self.conv2
        y = torch.relu(F.conv1d(y, c1.weight.float(), c1.bias.float(), padding=c1.padding))
        if m is not None:
            y = y * m
        y = F.conv1d(y, c2.weight.float(), c2.bias.float(), padding=c2.padding)
        return y.transpose(1, 2)


class ProstT5(nn.Module):
    """The encoder and the head; `head_cfg` (default `cfg`) sizes the head."""

    def __init__(self, cfg: T5Config, gated: bool = False, head_cfg: Optional[T5Config] = None):
        super().__init__()
        self.encoder = T5Encoder(cfg, gated)
        self.head = CNNHead(head_cfg or cfg)


def build_model(cfg: T5Config, state: Dict[str, torch.Tensor], device, trainable: bool = False) -> ProstT5:
    """The network on `device` holding `state`'s tensors (their dtype);
    the blocks' FFN (relu or gated) follows the state's names, and the
    head's shapes its tensors (the default head is ProstT5-XL's).  Frozen
    for inference, or with `trainable` parameters that take gradients
    (`train_logits`, parallel/sharding.py's training step)."""
    gated = "encoder.blocks.0.wi0.weight" in state
    w1, w2 = state["head.conv1.weight"], state["head.conv2.weight"]
    head_cfg = replace(cfg, d_model=w1.shape[1], cnn_hidden=w1.shape[0], n_classes=w2.shape[0],
                       cnn_kernel=w1.shape[2])
    with torch.device("meta"):
        model = ProstT5(cfg, gated, head_cfg)
    model.load_state_dict({k: v.to(device) for k, v in state.items()}, strict=True, assign=True)
    return model if trainable else model.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# forward pass (the JAX package's function names)
# ---------------------------------------------------------------------------

@_in_full_precision
def encoder_forward(model: ProstT5, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """tokens (B, L) int; mask (B, L) bool.  Returns (B, L, d_model)."""
    return model.encoder(tokens, mask)


@_in_full_precision
def cnn_head(model: ProstT5, x: torch.Tensor, res_mask=None) -> torch.Tensor:
    """(B, L, D) -> (B, L, n_classes) float32 logits.  With `res_mask`
    (B, L) the input and the inter-conv activation are zeroed outside the
    residue span, so every conv window sees what it would see on the
    isolated sliced sequence."""
    return model.head(x, res_mask)


@_in_full_precision
def residue_logits(model: ProstT5, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Encoder + CNN with the ProstT5 residue-slice semantics: hidden
    states at non-residue positions (the <AA2fold> prefix, </s>, padding)
    are zeroed before the CNN."""
    h = model.encoder(tokens, mask)
    return model.head(h, (tokens < TOK_PREFIX) & mask)


def train_logits(model: ProstT5, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The forward of JAX's `loss_fn` (unicore_tpu/parallel/sharding.py):
    the encoder, then the head on every position (no residue mask), as
    (B, L, n_classes) float32 logits under `full_precision` and with
    autograd (not inference_mode)."""
    with full_precision():
        return model.head(model.encoder(tokens, mask))


@_in_full_precision
def predict_3di_codes(model: ProstT5, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """argmax over float32 logits (the first maximum, as jnp.argmax)."""
    return torch.argmax(residue_logits(model, tokens, mask), dim=-1)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def _bucket_len(n: int) -> int:
    b = 128
    while b < n:
        b += 128
    return b


def frame_batch(sequences: List[str], L: int, multiple: int = 8):
    """(tokens, mask) numpy arrays of `sequences` framed
    ``[<AA2fold>, residues..., </s>]`` in rows of length L, the batch
    padded to a multiple of `multiple` rows."""
    with profiling.span("prostt5.frame"):
        B = len(sequences)
        Bp = ((B + multiple - 1) // multiple) * multiple
        toks = np.full((Bp, L), TOK_PAD, dtype=np.int64)
        mask = np.zeros((Bp, L), dtype=bool)
        for r, s in enumerate(sequences):
            codes = encode_aa(s)
            n = len(codes)
            toks[r, 0] = TOK_PREFIX
            toks[r, 1 : n + 1] = codes
            toks[r, n + 1] = TOK_EOS
            mask[r, : n + 2] = True
        return toks, mask


def _copy_in(toks: np.ndarray, mask: np.ndarray, device) -> tuple:
    """A framed batch's tokens and mask on `device`."""
    with profiling.span("prostt5.copy_in"):
        return torch.from_numpy(toks).to(device), torch.from_numpy(mask).to(device)


def _copy_out(codes: torch.Tensor) -> np.ndarray:
    """A batch's codes on the host: the host waits here for the batch's
    forward to end on the device."""
    with profiling.span("prostt5.copy_out"):
        return codes.cpu().numpy()


def _decode(codes3: np.ndarray, chunk: List[int], sequences: List[str], out: List[Optional[str]]) -> None:
    """Each row's 3Di letters, read back at its residue positions, into
    `out` at the row's unit index `chunk[r]`."""
    with profiling.span("prostt5.decode"):
        for r, j in enumerate(chunk):
            out[j] = _TDI[codes3[r, 1 : len(sequences[j]) + 1]].tobytes().decode()


def _cut_windows(sequences: List[str], W: int, V: int) -> List[tuple]:
    """(index, start, residues) of the units `sequences` are read in:
    each sequence up to W whole, longer ones in W-wide windows
    overlapping by V, the last one ending at the sequence's end."""
    with profiling.span("prostt5.stitch"):
        pieces: List[tuple] = []
        for idx, s in enumerate(sequences):
            if len(s) <= W:
                pieces.append((idx, 0, s))
                continue
            starts = list(range(0, len(s) - W + 1, W - V))
            if starts[-1] + W < len(s):
                starts.append(len(s) - W)
            for st in starts:
                pieces.append((idx, st, s[st : st + W]))
        return pieces


def _stitch(sequences: List[str], pieces: List[tuple], piece_3di: List[str], W: int, V: int) -> List[str]:
    """The 3Di string of each sequence from its units' letters: a window
    owns its residues from the previous window's end less V / 2."""
    with profiling.span("prostt5.stitch"):
        out: List[Optional[str]] = [None] * len(sequences)
        chars: Dict[int, list] = {}
        bounds: Dict[int, int] = {}  # orig_idx -> end of previously owned region
        for (idx, st, aa_piece), di in zip(pieces, piece_3di):
            if len(sequences[idx]) <= W:
                out[idx] = di
                continue
            buf = chars.setdefault(idx, ["X"] * len(sequences[idx]))
            own_from = bounds.get(idx, 0)          # midpoint handoff
            own_to = st + len(aa_piece)
            for pos in range(max(own_from, st), own_to):
                buf[pos] = di[pos - st]
            bounds[idx] = st + len(aa_piece) - V // 2
        for idx, buf in chars.items():
            out[idx] = "".join(buf)
        return out  # type: ignore[return-value]


class ProstT5Engine:
    """Batched AA->3Di inference engine on one device, or data-parallel
    over several cards (parallel.mesh.local_mesh).

    Counters (runtime/profiling): `prostt5.load.seconds`,
    `prostt5.batches`, `prostt5.residues`, `prostt5.padded_tokens`,
    `prostt5.shape.<B>x<L>.batches` (batches of B padded rows at bucket
    length L), `prostt5.predict.seconds`, `prostt5.bias_table.builds`
    and, on CUDA, `prostt5.peak_bytes` (the device's peak allocation in
    this process, as torch counts it).

    Spans (runtime/profiling.span, recorded while a profiler records),
    each phase a function of its own: `prostt5.stitch` (cutting windows,
    then stitching them, twice a `predict`), `prostt5.fill` (a bucket's
    batch), `prostt5.frame`, `prostt5.copy_in`, `prostt5.forward` (on
    the device clock too), `prostt5.copy_out` (the host waits there),
    `prostt5.decode`, and inside the model `prostt5.bias_table` and
    `prostt5.attention` (on the device clock too, once a layer).  On a
    card `prostt5.between_batches.device_seconds` is the device-clock
    time from one batch's forward to the next one's within a call."""

    name = "prostt5-torch"

    def __init__(
        self,
        model_dir: Optional[str] = None,
        cfg: Optional[T5Config] = None,
        batch_tokens: int = 64 * 512,
        seed: int = 0,
        dtype=torch.bfloat16,
        max_window: int = 2048,
        overlap: int = 256,
        device=None,
    ):
        # very long proteins are translated in overlapping windows and
        # stitched at overlap midpoints (attention memory is O(L^2); the
        # reference handles long inputs by EXCLUDING them via --max-len,
        # createdb.rs:93-95 — windowing keeps them)
        self.device = device_mod.resolve(device)
        t0 = time.perf_counter()
        self.max_window = max_window
        self.overlap = overlap
        self.cfg = cfg or infer_config(model_dir) or T5Config()
        state = None
        self.loaded_pretrained = False
        if model_dir and os.path.isdir(model_dir):
            state = load_params(model_dir, self.cfg, dtype=dtype)
            self.loaded_pretrained = state is not None
        if state is None:
            if model_dir and model_dir not in ("random", "mock"):
                msg.println_message(
                    f"Warning: no loadable ProstT5 weights under '{model_dir}'; "
                    "using seeded random initialization (offline build). "
                    "Predictions are deterministic but not ProstT5-accurate; "
                    "use model='mock' for the supported offline backend.", 2,
                )
            # bf16 whatever `dtype` says, as JAX's engine draws it
            state = init_params(self.cfg, seed=seed)
        self.model = build_model(self.cfg, state, self.device)
        self.batch_tokens = batch_tokens
        self._dp = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiling.add_counter("prostt5.load.seconds", time.perf_counter() - t0)

    def _dp_setup(self):
        """(shards, sharded predict or None): data-parallel inference over
        parallel.mesh.local_mesh's cards, set up at first use."""
        if self._dp is None:
            mesh = mesh_mod.local_mesh(self.device)
            self._dp = (1, None) if mesh is None else (
                mesh_mod.n_shards(mesh), sharding.make_sharded_predict(self.cfg, self.model, mesh))
        return self._dp

    def predict(self, sequences: List[str]) -> List[str]:
        """AA->3Di with overlap-window stitching for very long inputs.

        Sequences up to `max_window` go through one framed forward pass;
        longer ones are split into `max_window`-wide windows overlapping
        by `overlap`, each translated independently, and the 3Di string
        is stitched with ownership switching at overlap midpoints
        (deterministic; windows see `overlap/2` residues of flanking
        context at every owned position)."""
        pieces = _cut_windows(sequences, self.max_window, self.overlap)
        piece_3di = self._predict_units([p[2] for p in pieces])
        return _stitch(sequences, pieces, piece_3di, self.max_window, self.overlap)

    def _fill(self, sequences: List[str], order: List[int], i: int) -> tuple:
        """(units, L) of the batch that starts at `order[i]`: the bucket of
        its framed length L (prefix + residues + eos) and at most
        batch_tokens // L units (8 to 512), all within that bucket."""
        with profiling.span("prostt5.fill"):
            L = _bucket_len(len(sequences[order[i]]) + 2)
            bs = max(8, min(512, self.batch_tokens // L))
            return [j for j in order[i : i + bs] if len(sequences[j]) + 2 <= L], L

    def _predict_units(self, sequences: List[str]) -> List[str]:
        """Single-window batched forward (each unit framed
        ``[<AA2fold>, residues..., </s>]``, ProstT5's AA->fold direction);
        3Di letters are read back at the residue positions."""
        out: List[Optional[str]] = [None] * len(sequences)
        n_dev, sharded_predict = self._dp_setup()
        cuda = self.device.type == "cuda"
        order = sorted(range(len(sequences)), key=lambda i: len(sequences[i]))
        between = profiling.DeviceGap("prostt5.between_batches")
        t0 = time.perf_counter()
        i = 0
        while i < len(order):
            chunk, L = self._fill(sequences, order, i)
            i += len(chunk)
            toks, mask = frame_batch([sequences[j] for j in chunk], L, 8 * n_dev)
            if sharded_predict is not None:
                with profiling.span("prostt5.forward", device=cuda):
                    codes3 = sharded_predict(toks, mask)
            else:
                tokens, m = _copy_in(toks, mask, self.device)
                between.before()
                with profiling.span("prostt5.forward", device=cuda):
                    codes = predict_3di_codes(self.model, tokens, m)
                between.after(cuda)
                # the last batch's spans, which its copy out waited for,
                # read while the device runs this one
                profiling.read_device_spans()
                codes3 = _copy_out(codes)
            _decode(codes3, chunk, sequences, out)
            profiling.add_counter("prostt5.batches", 1)
            profiling.add_counter("prostt5.residues", sum(len(sequences[j]) for j in chunk))
            profiling.add_counter("prostt5.padded_tokens", toks.size)
            profiling.add_counter(f"prostt5.shape.{toks.shape[0]}x{L}.batches", 1)
        profiling.read_device_spans()
        profiling.add_counter("prostt5.predict.seconds", time.perf_counter() - t0)
        if cuda:
            profiling.set_counter("prostt5.peak_bytes", torch.cuda.max_memory_allocated(self.device))
        return out  # type: ignore[return-value]

    def probe(self) -> bool:
        r = self.predict(["ACDEFGHIKL"])
        return len(r) == 1 and len(r[0]) == 10
