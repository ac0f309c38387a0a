"""The port's ProstT5 (unicore_tpu_torch/models/{prostt5,tokenizer,gguf}.py)
against the JAX package's on the same inputs, on the CPU.

Host pieces are held exactly: the relative-position buckets, the seeded
initialization, infer_config, the loaders' arrays (safetensors, .bin,
npz, GGUF f16 and q8_0, gated, without a head), the vocabulary probes
and GGUF reading/writing.  The modules in float32 within rtol 1e-4 and
atol 1e-4 max|ref| (the same products summed in another order); the
engine's 3Di strings in float32 and bf16 under the tie rule
(torch_port_helpers.assert_same_3di), and a bf16 model's logits within
BF16_SPREAD of JAX's bf16 rounding (assert_bf16_spread), which a bf16
score or a bf16 softmax planted in the port fails."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (  # noqa: F401  (port_env: fixture)
    PREFIX_ID, PROSTT5_DIMS, assert_bf16_spread, assert_same_3di, gguf_tokens, port_env,
    stitched_logits, write_prostt5_checkpoint,
)
from unicore_tpu.models import gguf as jgguf
from unicore_tpu.models import prostt5 as J
from unicore_tpu.models import tokenizer as jtok
from unicore_tpu_torch.convert import prostt5_from_jax
from unicore_tpu_torch.models import gguf as tgguf
from unicore_tpu_torch.models import prostt5 as T
from unicore_tpu_torch.models import tokenizer as ttok

RTOL = 1e-4  # float32 modules: rtol, and atol as a share of max|ref|
LETTERS = "ACDEFGHIKLMNPQRSTVWY"
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfgs(gated=False, dims=None):
    d = dict(dims or PROSTT5_DIMS)
    d["ff"] = "gated-gelu" if gated else "relu"
    return J.T5Config(**d), T.T5Config(**d)


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


def _seqs(rng, lengths):
    return ["".join(rng.choice(list(LETTERS), n)) for n in lengths]


def _close(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())


# ---------------------------------------------------------------------------
# host pieces, exactly
# ---------------------------------------------------------------------------

def test_rel_bucket_equals_jax():
    """Every relative position up to the largest bucket (2,176), in both
    directions, and the (L, L) tables of the engine's cache."""
    rel = np.arange(-2176, 2177)
    for nb, md in ((32, 128), (16, 64)):
        want = np.asarray(J._rel_bucket(jnp.asarray(rel), nb, md))
        got = T._rel_bucket(torch.from_numpy(rel), nb, md).numpy()
        np.testing.assert_array_equal(got, want)
    for L in (3, 128, 640):
        pos = jnp.arange(L)
        want = np.asarray(J._rel_bucket(pos[None, :] - pos[:, None]))
        np.testing.assert_array_equal(T._bucket_table(L, 32, 128).numpy(), want)


@pytest.mark.parametrize("gated", [False, True])
def test_init_params_equals_jax(gated):
    jcfg, tcfg = _cfgs(gated, dims=dict(J.T5Config.small().__dict__, ff="relu"))
    for dtype in ("float32", "bfloat16"):
        want = prostt5_from_jax(_tree(J.init_params(jcfg, seed=3, dtype=JDT[dtype])))
        _assert_same_state(T.init_params(tcfg, seed=3, dtype=TDT[dtype]), want)
    # the default head of a checkpoint without classifier.*
    cnn = _tree(J.init_params(J.T5Config(n_layers=0), 0, jnp.float32)["cnn"])
    for k, v in T._default_head().items():
        np.testing.assert_array_equal(v, cnn[k])


@pytest.mark.parametrize("config", [
    {"d_model": 64, "d_kv": 16, "num_heads": 4, "d_ff": 128, "num_layers": 2},
    {"d_model": 64, "d_ff": 96, "feed_forward_proj": "gated-gelu",
     "relative_attention_num_buckets": 16, "relative_attention_max_distance": 64},
    {"d_model": 32, "is_gated_act": True},
    {"num_layers": 2},   # no d_model: not a T5 config
    "{not json",
    None,                # no config.json
])
def test_infer_config_equals_jax(tmp_path, config):
    if config is not None:
        text = config if isinstance(config, str) else json.dumps(config)
        (tmp_path / "config.json").write_text(text)
    want = J.infer_config(str(tmp_path))
    got = T.infer_config(str(tmp_path))
    assert (got is None) == (want is None)
    if want is not None:
        assert got.__dict__ == want.__dict__
    assert T.infer_config(None) is None and T.infer_config(str(tmp_path / "missing")) is None


@pytest.mark.parametrize("fmt,gated,classifier,rows", [
    ("safetensors", False, True, 150),
    ("bin", False, True, 150),
    ("gguf", False, True, 150),
    ("gguf_q8", False, True, 150),
    ("safetensors", True, True, 150),   # v1.1-style gated checkpoint
    ("bin", False, False, 150),         # no classifier.*: the default head
    ("bin", False, True, 100),          # <AA2fold> past shared.weight: clamped
])
def test_load_params_equals_jax(tmp_path, monkeypatch, fmt, gated, classifier, rows):
    """Without classifier.* JAX takes init_params(T5Config(), 0)["cnn"],
    which draws the whole 1.2 B-parameter model first (about a minute);
    its head is drawn before the layers, so JAX's init_params runs here
    without layers for that one call (test_init_params_equals_jax holds
    the port's default head against JAX's layerless draw)."""
    real = J.init_params
    monkeypatch.setattr(J, "init_params", lambda cfg, seed=0, dtype=jnp.bfloat16: real(
        J.T5Config(n_layers=0) if cfg == J.T5Config() else cfg, seed, dtype))
    write_prostt5_checkpoint(tmp_path, fmt, gated=gated, classifier=classifier, rows=rows)
    jcfg, tcfg = _cfgs(gated=False)  # the FFN follows the checkpoint's names
    for dtype in ("float32", "bfloat16"):
        want = prostt5_from_jax(_tree(J.load_params(str(tmp_path), jcfg, dtype=JDT[dtype])))
        _assert_same_state(T.load_params(str(tmp_path), tcfg, dtype=TDT[dtype]), want)


def test_load_params_npz_equals_jax(tmp_path):
    """JAX's own export, prostt5_tpu.npz: flat "layers/0/q" keys over the
    seeded initialization (keys it lacks keep their seeded values)."""
    jcfg, tcfg = _cfgs()
    src = _tree(J.init_params(jcfg, seed=9, dtype=jnp.float32))
    flat = {"embed": src["embed"] * 2, "cnn/w1": src["cnn"]["w1"] + 1}
    for i, layer in enumerate(src["layers"]):
        flat.update({f"layers/{i}/{k}": v * 0.5 for k, v in layer.items() if k != "ln2"})
    np.savez(tmp_path / "prostt5_tpu.npz", **flat)
    for dtype in ("float32", "bfloat16"):
        want = prostt5_from_jax(_tree(J.load_params(str(tmp_path), jcfg, dtype=JDT[dtype])))
        _assert_same_state(T.load_params(str(tmp_path), tcfg, dtype=TDT[dtype]), want)
    assert T.load_params(str(tmp_path / "none"), tcfg) is None


def test_read_safetensors_equals_the_package(tmp_path):
    from safetensors.numpy import load_file, save_file
    from safetensors.torch import load_file as tload, save_file as tsave

    rng = np.random.RandomState(2)
    arrs = {"a.f32": rng.randn(7, 5).astype(np.float32), "b.f16": rng.randn(3, 4, 2).astype(np.float16),
            "c.scalarish": np.float32([1.5])}
    save_file(arrs, str(tmp_path / "x.safetensors"), metadata={"format": "pt"})
    want = load_file(str(tmp_path / "x.safetensors"))
    got = T.read_safetensors(str(tmp_path / "x.safetensors"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k].astype(np.float32))
    bf = {"w": torch.from_numpy(rng.randn(6, 3).astype(np.float32)).to(torch.bfloat16)}
    tsave(bf, str(tmp_path / "y.safetensors"))
    got = T.read_safetensors(str(tmp_path / "y.safetensors"))
    np.testing.assert_array_equal(got["w"], tload(str(tmp_path / "y.safetensors"))["w"].float().numpy())
    tsave({"i": torch.arange(3)}, str(tmp_path / "z.safetensors"))
    with pytest.raises(ValueError):
        T.read_safetensors(str(tmp_path / "z.safetensors"))


# ---------------------------------------------------------------------------
# vocabulary and GGUF
# ---------------------------------------------------------------------------

def _vocab_files(d, kind):
    pieces = ["<pad>", "</s>", "<unk>"] + ["▁" + c for c in "ARNDCQEGHILKMFPSTWYVXBOUZ"]
    if kind == "tokenizer.json":
        (d / "tokenizer.json").write_text(json.dumps({
            "model": {"type": "Unigram", "vocab": [[p, 0.0] for p in pieces]},
            "added_tokens": [{"id": 40, "content": "<AA2fold>"}, {"id": 41, "content": "<fold2AA>"}]}))
    elif kind == "tokenizer.json, BPE":
        (d / "tokenizer.json").write_text(json.dumps({
            "model": {"vocab": {p: i for i, p in enumerate(pieces)}},
            "added_tokens": [{"id": 77, "content": "<AA2fold>"}]}))
    elif kind == "tokenizer.json without <AA2fold>":  # falls through to added_tokens.json
        (d / "tokenizer.json").write_text(json.dumps({"model": {"vocab": [[p, 0.0] for p in pieces]}}))
        (d / "added_tokens.json").write_text(json.dumps({"<AA2fold>": 140}))
    elif kind == "added_tokens.json":
        (d / "added_tokens.json").write_text(json.dumps({"<fold2AA>": 149, "<AA2fold>": 148}))
    elif kind == "gguf":
        jgguf.write_gguf(str(d / "m.gguf"), {"general.alignment": 32,
                                            "tokenizer.ggml.tokens": gguf_tokens()}, {})
    elif kind == "spiece.model":  # sentencepiece absent or unreadable: the default layout
        (d / "spiece.model").write_bytes(b"\x00sp")


@pytest.mark.parametrize("kind", ["tokenizer.json", "tokenizer.json, BPE",
                                  "tokenizer.json without <AA2fold>", "added_tokens.json",
                                  "gguf", "spiece.model", "nothing"])
def test_load_vocab_equals_jax(tmp_path, kind):
    _vocab_files(tmp_path, kind)
    want, got = jtok.load_vocab(str(tmp_path)), ttok.load_vocab(str(tmp_path))
    np.testing.assert_array_equal(got.aa_ids, want.aa_ids)
    assert (got.prefix_id, got.eos_id, got.pad_id, got.unk_id, got.source) == \
        (want.prefix_id, want.eos_id, want.pad_id, want.unk_id, want.source)
    np.testing.assert_array_equal(ttok.ProstT5Vocab.default().aa_ids, jtok.ProstT5Vocab.default().aa_ids)
    assert ttok.load_vocab(None).source == "default"


def test_gguf_equals_jax(tmp_path):
    """Writer bytes, reader arrays and metadata, q8_0, name translation."""
    rng = np.random.RandomState(4)
    tensors = {"token_embd.weight": rng.randn(8, 64).astype(np.float32),
               "enc.blk.0.ffn_gate.weight": rng.randn(4, 32).astype(np.float32),
               "enc.blk.0.ffn_up.weight": rng.randn(4, 32).astype(np.float32),
               "enc.blk.1.attn_q.weight": rng.randn(2, 3).astype(np.float32),
               "classifier.0.weight": rng.randn(2, 4, 7, 1).astype(np.float32)}
    meta = {"general.alignment": 32, "note": "x", "n": 7, "tokenizer.ggml.tokens": gguf_tokens()}
    quant = {"token_embd.weight": "q8_0", "enc.blk.0.ffn_up.weight": "q8_0"}
    jgguf.write_gguf(str(tmp_path / "j.gguf"), meta, tensors, quant)
    tgguf.write_gguf(str(tmp_path / "t.gguf"), meta, tensors, quant)
    assert (tmp_path / "j.gguf").read_bytes() == (tmp_path / "t.gguf").read_bytes()
    (jm, jt), (tm, tt) = jgguf.read_gguf(str(tmp_path / "j.gguf")), tgguf.read_gguf(str(tmp_path / "j.gguf"))
    assert jm == tm and sorted(jt) == sorted(tt)
    for k in jt:
        np.testing.assert_array_equal(tt[k], jt[k])
    jh, th = jgguf.gguf_to_hf_tensors(jt), tgguf.gguf_to_hf_tensors(tt)
    assert sorted(jh) == sorted(th) and "encoder.block.0.layer.1.DenseReluDense.wi_1.weight" in th
    assert tgguf.quantize_q8_0(tensors["token_embd.weight"]) == jgguf.quantize_q8_0(tensors["token_embd.weight"])
    v = tgguf.vocab_from_gguf(tm)
    assert v.prefix_id == PREFIX_ID and v.source == "gguf"
    assert tgguf.vocab_from_gguf({}) is None
    assert tgguf.find_gguf(str(tmp_path)) == jgguf.find_gguf(str(tmp_path))
    (tmp_path / "bad.gguf").write_bytes(b"GGML" + bytes(20))
    with pytest.raises(ValueError):
        tgguf.read_gguf(str(tmp_path / "bad.gguf"))


# ---------------------------------------------------------------------------
# the modules in float32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gated", [False, True])
def test_modules_float32_equal_jax(gated):
    jcfg, tcfg = _cfgs(gated, dims=dict(J.T5Config.small().__dict__, ff="relu"))
    params = J.init_params(jcfg, seed=5, dtype=jnp.float32)
    model = T.build_model(tcfg, prostt5_from_jax(_tree(params)), "cpu")
    rng = np.random.RandomState(6)
    toks, mask = T.frame_batch(_seqs(rng, [40, 126, 2, 77, 9]) + ["MKVXLBZJWW"], 128)
    jt, jm = jnp.asarray(toks.astype(np.int32)), jnp.asarray(mask)
    tt, tm = torch.from_numpy(toks), torch.from_numpy(mask)
    h_ref = np.asarray(J.encoder_forward(params, jcfg, jt, jm))
    h = T.encoder_forward(model, tt, tm)
    _close(h_ref[mask], h.numpy()[mask])
    res = jm & (jt < J.TOK_PREFIX)
    for rm, trm in ((res, tt.lt(T.TOK_PREFIX) & tm), (None, None)):
        _close(J.cnn_head(params, jcfg, jnp.asarray(h_ref), res_mask=rm),
               T.cnn_head(model, torch.from_numpy(np.array(h_ref)), res_mask=trm).numpy())
    lg_ref = np.asarray(J.residue_logits(params, jcfg, jt, jm))
    _close(lg_ref, T.residue_logits(model, tt, tm).numpy())
    np.testing.assert_array_equal(T.predict_3di_codes(model, tt, tm).numpy()[np.asarray(res)],
                                  np.argmax(lg_ref, -1)[np.asarray(res)])


# ---------------------------------------------------------------------------
# the engine, float32 and bf16
# ---------------------------------------------------------------------------

def _engines(ckpt, dtype, **kw):
    """Both engines on one checkpoint (JAX's seeded fallback is bf16
    whatever its dtype says, so a float32 engine needs weights)."""
    je = J.ProstT5Engine(str(ckpt), dtype=JDT[dtype], **kw)
    te = T.ProstT5Engine(str(ckpt), dtype=TDT[dtype], device="cpu", **kw)
    assert je.loaded_pretrained and te.loaded_pretrained
    return je, te


def _jax_unit_logits(je):
    def unit(piece):
        toks, mask = T.frame_batch([piece], T._bucket_len(len(piece) + 2))
        lg = J.residue_logits(je.params, je.cfg, jnp.asarray(toks.astype(np.int32)), jnp.asarray(mask))
        return np.asarray(lg)[0, 1:len(piece) + 1]
    return unit


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_predict_equals_jax(dtype, port_env):  # noqa: F811
    """A padded batch of mixed lengths (the minimal length 2, ambiguity
    codes, two buckets), then the windowed path at max_window=96,
    overlap=32 on lengths W+1, 160 (exact tiling) and 300."""
    write_prostt5_checkpoint(port_env / "ckpt", "bin", seed=4)
    rng = np.random.RandomState(8)
    seqs = _seqs(rng, [42, 20, 2, 130, 7]) + ["MKVXLBZJWW", "ACDEFGHIKLMNPQRSTVWY"]
    je, te = _engines(port_env / "ckpt", dtype)
    assert_same_3di(seqs, je.predict(seqs), te.predict(seqs), lambda i: _jax_unit_logits(je)(seqs[i]), dtype)
    W, V = 96, 32
    je, te = _engines(port_env / "ckpt", dtype, max_window=W, overlap=V)
    long = _seqs(rng, [W + 1, 160, 300, 50])
    unit = _jax_unit_logits(je)
    assert_same_3di(long, je.predict(long), te.predict(long),
                    lambda i: stitched_logits(long[i], unit, W, V), dtype)


def _bf16_scores(q, k, bias_mask):
    """A cast-order fault: the scores rounded to bf16 before the bias."""
    return torch.matmul(q, k.transpose(-1, -2)).float() + bias_mask


def _bf16_softmax(q, k, v, bias_mask):
    """A cast-order fault: the softmax taken in bf16."""
    return torch.matmul(torch.softmax(T._scores(q, k, bias_mask).to(v.dtype), dim=-1), v)


@pytest.mark.parametrize("fault", [None, "bf16 scores", "bf16 softmax"])
def test_bf16_logits_equal_jax(fault, port_env, monkeypatch):  # noqa: F811
    """bf16 logits of both engines' models on one padded batch within
    assert_bf16_spread of JAX's (JAX's float32 model the measure of its
    bf16 rounding); with a cast-order fault planted in the port, the
    check fails."""
    write_prostt5_checkpoint(port_env / "ckpt", "bin", seed=4)
    je, te = _engines(port_env / "ckpt", "bfloat16")
    j32 = J.ProstT5Engine(str(port_env / "ckpt"), dtype=jnp.float32)
    toks, mask = T.frame_batch(_seqs(np.random.RandomState(8), [42, 20, 2, 126, 7, 90]), 128)
    jt, jm = jnp.asarray(toks.astype(np.int32)), jnp.asarray(mask)
    res = (toks < T.TOK_PREFIX) & mask
    ref = np.asarray(J.residue_logits(je.params, je.cfg, jt, jm))[res]
    f32 = np.asarray(J.residue_logits(j32.params, j32.cfg, jt, jm))[res]
    if fault == "bf16 scores":
        monkeypatch.setattr(T, "_scores", _bf16_scores)
    elif fault == "bf16 softmax":
        monkeypatch.setattr(T, "_attention", _bf16_softmax)
    got = T.residue_logits(te.model, torch.from_numpy(toks), torch.from_numpy(mask)).numpy()[res]
    if fault is None:
        assert_bf16_spread(ref, got, f32)
    else:
        with pytest.raises(AssertionError):
            assert_bf16_spread(ref, got, f32)


def test_engine_padding_invariance_and_counters(port_env):  # noqa: F811
    from unicore_tpu_torch.runtime import profiling

    profiling.reset_counters()
    te = T.ProstT5Engine(None, cfg=T.T5Config.small(), seed=3, device="cpu")
    seq = "MIRGGDIAKGTVLLHKGAPYLVVEREFVNPGKGAAFARVKMK"
    alone = te.predict([seq])[0]
    assert te.predict([seq, "ACDEFG", seq + "AAA"])[0] == alone
    assert len(alone) == len(seq) and te.probe()
    c = profiling.get_counters()
    assert c["prostt5.batches"] == 3 and c["prostt5.residues"] == 2 * len(seq) + 6 + len(seq) + 3 + 10
    assert c["prostt5.padded_tokens"] == 3 * 8 * 128 and c["prostt5.load.seconds"] > 0
    assert next(te.model.parameters()).dtype == torch.bfloat16  # bf16 by default, as in JAX


def test_engine_from_checkpoint_equals_jax(tmp_path, port_env):  # noqa: F811
    """A real-layout checkpoint through both engines (geometry from its
    config.json, bf16), and the seeded fallback of a directory without
    weights, with its warning."""
    write_prostt5_checkpoint(tmp_path / "ckpt", "safetensors", seed=2)
    je, te = J.ProstT5Engine(str(tmp_path / "ckpt")), T.ProstT5Engine(str(tmp_path / "ckpt"), device="cpu")
    assert te.loaded_pretrained and je.loaded_pretrained and te.cfg.__dict__ == je.cfg.__dict__
    seqs = _seqs(np.random.RandomState(1), [33, 61, 2, 120])
    assert_same_3di(seqs, je.predict(seqs), te.predict(seqs), lambda i: _jax_unit_logits(je)(seqs[i]),
                    "bfloat16")
    (tmp_path / "empty").mkdir()
    (tmp_path / "empty" / "config.json").write_text(json.dumps({"d_model": 64, "d_kv": 16, "num_heads": 4,
                                                               "d_ff": 128, "num_layers": 1}))
    te = T.ProstT5Engine(str(tmp_path / "empty"), device="cpu")
    assert not te.loaded_pretrained and te.cfg.n_layers == 1
    want = prostt5_from_jax(_tree(J.init_params(J.infer_config(str(tmp_path / "empty")), 0)))
    _assert_same_state({k: v for k, v in te.model.state_dict().items()}, want)


def test_full_precision_restores_the_callers_settings(port_env):  # noqa: F811
    mm = torch.backends.cuda.matmul
    prev = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32,
            mm.allow_bf16_reduced_precision_reduction)
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    mm.allow_bf16_reduced_precision_reduction = True
    try:
        with T.full_precision():
            assert torch.get_float32_matmul_precision() == "highest"
            assert not torch.backends.cudnn.allow_tf32 and not mm.allow_bf16_reduced_precision_reduction
        T.ProstT5Engine(None, cfg=T.T5Config.small(), device="cpu").probe()
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cudnn.allow_tf32 and mm.allow_bf16_reduced_precision_reduction
    finally:
        torch.set_float32_matmul_precision(prev[0])
        torch.backends.cudnn.allow_tf32 = prev[1]
        mm.allow_bf16_reduced_precision_reduction = prev[2]

