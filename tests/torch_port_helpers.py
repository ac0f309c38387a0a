"""Shared pieces of the PyTorch port's tests (tests/test_torch_*.py).

The port keeps process-global state that xdist's `--dist loadfile` would
otherwise carry from one test file to the next in a worker: the engine
registry (`_FACTORIES`, `_OVERRIDES`), the engines.cfg location, the
E-value calibration caches and the device switch.  `port_env` isolates all
four and pins the port to the CPU: HOME moves to the test's tmp dir, so
the port's fits (~/.cache/unicore_tpu_torch/stats) and the JAX package's
(~/.cache/unicore_tpu/stats) both start empty.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from unicore_tpu_torch.synthetic import PROSTT5_VOCAB_ROWS


@pytest.fixture
def port_env(tmp_path, monkeypatch):
    from unicore_tpu_torch.runtime import registry

    factories, overrides = dict(registry._FACTORIES), dict(registry._OVERRIDES)
    registry.clear_overrides()
    monkeypatch.setenv("UNICORE_TPU_TORCH_ENGINES_CFG", str(tmp_path / "port_engines.cfg"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("UNICORE_TPU_TORCH_DEVICE", "cpu")
    yield tmp_path
    registry._FACTORIES.clear()
    registry._FACTORIES.update(factories)
    registry._OVERRIDES.clear()
    registry._OVERRIDES.update(overrides)


@pytest.fixture
def one_torch_thread():
    """Run the test with one intra-op thread in torch.  The likelihood
    issues many small ops, and with torch's default of one OpenMP thread
    per core, test workers running side by side spin against each other
    and run many times slower than one alone."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def stats_dir(port_env, package: str):
    """The E-value cache of `package` under port_env's HOME."""
    return port_env / "home" / ".cache" / package / "stats"


def need_cuda() -> None:
    """Skip the calling test where there is no card (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")


def random_pairs(rng, B, Lq, Lt, minlen=10, plant=40):
    """Random AA/3Di code pairs with ragged lengths; every other pair gets
    a planted homologous window with a few substitutions and one indel on
    each side, so the gap states are exercised."""
    qa = rng.randint(0, 20, (B, Lq)).astype(np.int32)
    qs = rng.randint(0, 20, (B, Lq)).astype(np.int32)
    ta = rng.randint(0, 20, (B, Lt)).astype(np.int32)
    ts = rng.randint(0, 20, (B, Lt)).astype(np.int32)
    qlen = rng.randint(minlen, Lq + 1, B).astype(np.int32)
    tlen = rng.randint(minlen, Lt + 1, B).astype(np.int32)
    for b in range(0, B, 2):
        w = min(qlen[b], tlen[b], plant)
        src_a, src_s = ta[b, :w].copy(), ts[b, :w].copy()
        cut = w // 2
        # a 3-residue deletion in the query copy, and substitutions
        qa_w = np.concatenate([src_a[:cut], src_a[cut + 3:]])
        qs_w = np.concatenate([src_s[:cut], src_s[cut + 3:]])
        sub = rng.randint(0, len(qa_w), max(1, len(qa_w) // 10))
        qa_w[sub] = rng.randint(0, 20, len(sub))
        qa[b, : len(qa_w)] = qa_w
        qs[b, : len(qs_w)] = qs_w
    return qa, qs, ta, ts, qlen, tlen


LETTERS = "ARNDCQEGHILKMFPSTWYV"

# Inference outputs, port against JAX (both float32; see test_torch_phylo.py)
BLEN_LL_RTOL = 1e-4               # lnL after branch-length optimization
BLEN_ATOL, BLEN_RTOL = 1e-3, 1e-2  # each branch length
SUPPORT_POINTS = 1.0               # UFBoot support, in percent
RESOLVED = 2 * BLEN_ATOL           # a shorter branch may be resolved either way


def _family(rng, n, L):
    base = rng.choice(list(LETTERS), L)
    out = []
    for _ in range(n):
        s = base.copy()
        for _ in range(max(2, L // 40)):
            s[rng.randint(L)] = rng.choice(list(LETTERS))
        out.append("".join(s))
    return out


def write_proteomes(ind, seed=5):
    """Families x species in the style of tests/test_easy_search.py: six
    gene families over four species, one family longer than 1024 (the
    banded path), one missing from a species and one duplicated in
    another (non-core genes)."""
    rng = np.random.RandomState(seed)
    lengths = [60, 90, 130, 200, 1100, 75]
    fams = [_family(rng, 5, L) for L in lengths]
    species = [f"spec{i}" for i in range(4)]
    ind.mkdir()
    for si, sp in enumerate(species):
        with open(ind / f"{sp}.fa", "w") as f:
            for gi, fam in enumerate(fams):
                if gi == 5 and si == 0:
                    continue  # missing
                f.write(f">gene{gi}_{sp} some description\n{fam[si]}\n")
                if gi == 3 and si == 1:
                    f.write(f">gene{gi}b_{sp}\n{fam[4]}\n")  # second copy


def files_of(root):
    """{relative path: bytes} of every file under `root`."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def as_torch(*arrays):
    return tuple(None if a is None else torch.from_numpy(np.ascontiguousarray(a))
                 for a in arrays)


def edges(tree):
    """{split: (length, support)} of an unrooted tree, leaf edges included;
    a split is its smaller side (ties: the sorted-first)."""
    everyone = frozenset(l.name for l in tree.leaves())
    out = {}
    for node in tree.postorder():
        if node is tree:
            continue
        below = frozenset(l.name for l in node.leaves())
        key = min(below, everyone - below, key=lambda s: (len(s), sorted(s)))
        out[key] = (node.length, node.support)
    return out


def assert_same_tree(jt, tt, supported=True):
    """The port's tree `tt` against JAX's `jt` (Newick strings or nodes).

    Every split whose branch is longer than RESOLVED in either tree is in
    both (RF 0 on the resolved splits); a split in one tree only must be
    shorter than RESOLVED in it: a near-zero branch is a polytomy that
    float noise resolves either way (the four-species fixture evolves its
    families as a star).  Branch lengths of common splits within
    BLEN_ATOL + BLEN_RTOL * len.  With `supported`, each tree leaves at
    most one internal split without a support, and the supports both
    write lie in [0, 100] and, on resolved splits, within SUPPORT_POINTS
    of each other.  Both packages leave the root split of the rooted
    search tree without a support when both root children are internal
    (a defect of the reference, kept in the port); re-rootings of one
    tree tie in lnL and float noise picks among them, so whether a tree
    has such a split, and which, may differ between the two."""
    from unicore_tpu_torch.phylo.newick import parse_newick

    je, te = (edges(parse_newick(x if isinstance(x, str) else x.to_newick())) for x in (jt, tt))
    for a, b in ((je, te), (te, je)):
        for k in set(a) - set(b):
            assert a[k][0] <= RESOLVED, (k, a[k])
    assert any(k in te for k in je)
    if supported:
        unlabelled = [sum(len(k) > 1 and e[k][1] is None for k in e) for e in (je, te)]
        assert max(unlabelled) <= 1, unlabelled
    for k in set(je) & set(te):
        (length, sup), (tlen, tsup) = je[k], te[k]
        assert abs(tlen - length) <= BLEN_ATOL + BLEN_RTOL * length, (k, length, tlen)
        if supported and len(k) > 1 and sup is not None and tsup is not None:
            assert 0.0 <= tsup <= 100.0, (k, tsup)
            assert length <= RESOLVED or abs(tsup - sup) <= SUPPORT_POINTS, (k, sup, tsup)


# Gene trees, port against JAX (tests/test_torch_genetree*.py)
GENE_LL_RTOL = 1e-5


def gene_msa(rng, n_taxa, L, mut=0.25):
    """tests/test_genetree_batched.py's chain-evolved gene MSA."""
    base = rng.choice(list(LETTERS), L)
    msa = {}
    prev = base
    for t in range(n_taxa):
        s = prev.copy()
        for i in range(L):
            if rng.rand() < mut:
                s[i] = rng.choice(list(LETTERS))
        msa[f"sp{t}"] = "".join(s)
        prev = s
    return msa


def write_msa(path, msa):
    with open(path, "w") as f:
        for n, s in msa.items():
            f.write(f">{n}\n{s}\n")


def _loglik_of(newick, msa, info, package):
    """The likelihood of a written tree under one package's engine, with
    the model the report names (alpha, p_inv)."""
    if package == "jax":
        from unicore_tpu.phylo import likelihood as L, models as M, newick as N
        kw = {}
    else:
        from unicore_tpu_torch.phylo import likelihood as L, models as M, newick as N
        kw = {"device": "cpu"}
    names, seqs = list(msa), list(msa.values())
    model = M.SubstModel.build(M.ModelSpec.parse(info["model"]),
                               empirical_freqs=L.empirical_frequencies(L.msa_to_codes(names, seqs)),
                               alpha=info["alpha"], p_inv=info["p_inv"])
    eng = L.LikelihoodEngine(names, seqs, model, **kw)
    return eng.loglik(*L.tree_to_arrays(L.make_root_binary(N.parse_newick(newick)), names))


def assert_same_gene_tree(msa, ref, got, supported):
    """The port's (tree, lnL, info) of one gene against JAX's.  The same
    topology (RF 0); every report field but lnL and seconds equal; each
    package's lnL equal, within GENE_LL_RTOL, to either package's
    likelihood of its final tree; then either lnL within GENE_LL_RTOL and
    lengths and supports as assert_same_tree, or the port's lnL the
    higher.  The second case is float32 noise, not a port fault: on a
    branch of ~1e-7 the gradient of the log-length is noise of the size
    of its true value (the entries of P(t) = U exp(Lt) U^-1 are
    differences of O(1) terms), so the Adam loops of the two packages may
    leave such a branch on different sides, and the same topology ends in
    two optima of its branch lengths (tests/test_genetree_batched.py's
    first gene: JAX keeps a leaf branch at 1e-7, the port opens it to
    0.033, 1.31 lnL higher).  Returns True where both ended in one
    optimum."""
    from unicore_tpu_torch.phylo.newick import parse_newick, rf_distance

    (jt, jll, ji), (tt, tll, ti) = ref, got
    assert rf_distance(parse_newick(jt.to_newick()), tt) == 0
    drop = ("lnL", "seconds")
    assert {k: v for k, v in ti.items() if k not in drop} == \
        {k: v for k, v in ji.items() if k not in drop}
    for newick, ll in ((jt.to_newick(), jll), (tt.to_newick(), tll)):
        for package in ("jax", "port"):
            other = _loglik_of(newick, msa, ti, package)
            assert abs(other - ll) <= GENE_LL_RTOL * abs(ll), (package, ll, other)
    if abs(tll - jll) <= GENE_LL_RTOL * abs(jll):
        assert_same_tree(jt, tt, supported=supported)
        return True
    assert tll > jll, (jll, tll)
    return False


# ProstT5 (tests/test_torch_prostt5*.py, tests/test_torch_lookup.py)
PROSTT5_DIMS = dict(d_model=64, d_kv=16, n_heads=4, d_ff=128, n_layers=2, cnn_hidden=8)
PREFIX_ID = 131      # deliberately not the default guess: read from the files
# The tie rule of tests/test_prostt5_parity.py: a 3Di letter may differ
# only where the reference's top-two logit gap is below a tolerance, a
# share of the reference's largest |logit|.  float32: the same products
# summed in another order, ~1e-6 relative; the tolerance is 10x that.
# bf16: both sides take the same casts and differ in the order of their
# sums only.  Measured on the CPU on checkpoints of this file (seeds
# 0-5, 72 sequences of 2-250 residues, logits of scale ~3): through the
# engines (each batching its own way, the reference logits of each
# sequence framed alone) 0.8 % of the letters differ, at top-two gaps up
# to 2^-7.3 of max|logit|, so the bf16 tie tolerance is 2^-6.  The casts
# themselves are held by assert_bf16_spread: on one batch, the RMS
# distance between the two bf16 models' logits is 0.08-0.28 of the
# reference's own bf16 rounding (its RMS distance from the float32 model
# on the same weights) at four geometries up to ProtT5-XL's width, and
# 0.52-0.78 with a cast-order fault planted in the port (scores rounded
# to bf16 before the bias and the softmax, or a bf16 softmax;
# test_bf16_logits_equal_jax).  The limit, BF16_SPREAD, is 0.4.  At
# least MIN_AGREE of the letters must agree.
TIE_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
BF16_SPREAD = 0.4
MIN_AGREE = 0.98


def assert_bf16_spread(ref, got, f32):
    """Logits of a bf16 model `got` against a reference bf16 model's
    `ref`, both of the same casts, and the float32 model's `f32` on the
    same weights and inputs: RMS(got - ref) at most BF16_SPREAD of
    RMS(ref - f32).  Returns that share."""
    ref, got, f32 = (np.asarray(a, np.float64) for a in (ref, got, f32))
    share = np.sqrt(np.mean((got - ref) ** 2) / np.mean((ref - f32) ** 2))
    assert share <= BF16_SPREAD, (share, BF16_SPREAD)
    return share


_GGUF_BLK = {"layer.0.layer_norm.weight": "attn_norm.weight",
             "layer.0.SelfAttention.q.weight": "attn_q.weight",
             "layer.0.SelfAttention.k.weight": "attn_k.weight",
             "layer.0.SelfAttention.v.weight": "attn_v.weight",
             "layer.0.SelfAttention.o.weight": "attn_o.weight",
             "layer.0.SelfAttention.relative_attention_bias.weight": "attn_rel_b.weight",
             "layer.1.layer_norm.weight": "ffn_norm.weight",
             "layer.1.DenseReluDense.wi.weight": "ffn_up.weight",
             "layer.1.DenseReluDense.wi_0.weight": "ffn_gate.weight",
             "layer.1.DenseReluDense.wi_1.weight": "ffn_up.weight",
             "layer.1.DenseReluDense.wo.weight": "ffn_down.weight"}


def gguf_name(hf: str) -> str:
    """llama.cpp's T5-encoder name of an HF tensor (classifier.* keep theirs)."""
    if hf == "shared.weight":
        return "token_embd.weight"
    if hf == "encoder.final_layer_norm.weight":
        return "enc.output_norm.weight"
    if hf.startswith("encoder.block."):
        i, _, tail = hf[len("encoder.block."):].partition(".")
        return f"enc.blk.{i}.{_GGUF_BLK[tail]}"
    return hf


def gguf_tokens(prefix_id=PREFIX_ID):
    from unicore_tpu_torch.models.tokenizer import PROTT5_AA_ORDER

    toks = ["<pad>", "</s>", "<unk>"] + ["▁" + c for c in PROTT5_AA_ORDER]
    toks += [f"<extra_{i}>" for i in range(len(toks), prefix_id)]
    return toks + ["<AA2fold>", "<fold2AA>"]


def write_prostt5_checkpoint(path, fmt="bin", dims=PROSTT5_DIMS, seed=0, gated=False,
                             classifier=True, rows=PROSTT5_VOCAB_ROWS):
    """A synthetic checkpoint directory (synthetic.prostt5_hf_tensors,
    drawn from numpy seed `seed`) of `dims`, with its HF config.json: the
    tensors as `model.safetensors` or `pytorch_model.bin` with
    `added_tokens.json` (<AA2fold> at PREFIX_ID), or a GGUF in f16 or q8_0
    (`gguf`, `gguf_q8`, the tokenizer in its metadata).  Returns the
    tensors."""
    from unicore_tpu_torch.models.prostt5 import T5Config
    from unicore_tpu_torch.synthetic import prostt5_hf_tensors, write_prostt5_json

    rng = np.random.RandomState(seed)
    cfg = T5Config(**dims, ff="gated-gelu" if gated else "relu")
    t = prostt5_hf_tensors(cfg, lambda shape, scale, shift: (rng.randn(*shape) * scale + shift).astype(np.float32),
                           rows, classifier)
    write_prostt5_json(path, cfg, PREFIX_ID if fmt in ("safetensors", "bin") else None, rows)
    if fmt == "safetensors":
        from safetensors.numpy import save_file
        save_file(t, os.path.join(path, "model.safetensors"))
    elif fmt == "bin":
        torch.save({k: torch.from_numpy(v) for k, v in t.items()}, os.path.join(path, "pytorch_model.bin"))
    else:
        from unicore_tpu_torch.models.gguf import write_gguf
        g = {gguf_name(k): v for k, v in t.items()}
        quant = {k: "q8_0" for k, v in g.items() if v.ndim == 2 and v.size % 32 == 0} if fmt == "gguf_q8" else {}
        write_gguf(os.path.join(path, "prostt5.gguf"),
                   {"general.alignment": 32, "tokenizer.ggml.tokens": gguf_tokens()}, g, quant)
    return t


def stitched_logits(seq, unit_logits, W=2048, V=256):
    """(len(seq), C) logits of `seq` as ProstT5Engine.predict reads its
    letters: one unit up to W residues, else W-wide windows overlapping by
    V with ownership handed over at the overlap midpoints.
    `unit_logits(piece)` gives the (len(piece), C) logits of one unit."""
    if len(seq) <= W:
        return unit_logits(seq)
    starts = list(range(0, len(seq) - W + 1, W - V))
    if starts[-1] + W < len(seq):
        starts.append(len(seq) - W)
    out, own_from = None, 0
    for st in starts:
        lg = unit_logits(seq[st:st + W])
        out = np.zeros((len(seq), lg.shape[1]), lg.dtype) if out is None else out
        own_to = st + len(lg)
        lo = max(own_from, st)
        out[lo:own_to] = lg[lo - st:]
        own_from = own_to - V // 2
    return out


def assert_same_3di(seqs, ref, got, ref_logits, dtype):
    """`got` 3Di strings against `ref` under the tie rule: equal lengths,
    3Di letters only, every differing letter where ref_logits(i) (the
    reference's (len, C) logits of sequence i) has a top-two gap below
    TIE_RTOL[dtype] of its largest |logit|, and at least MIN_AGREE of the
    letters equal.  Returns the number of differing letters."""
    from unicore_tpu_torch.alphabets import TDI_ALPHABET

    n_diff = n_all = 0
    for i, (s, r, g) in enumerate(zip(seqs, ref, got)):
        assert len(r) == len(g) == len(s), (i, len(s), len(r), len(g))
        assert set(g) <= set(TDI_ALPHABET), (i, g)
        diff = [p for p in range(len(s)) if r[p] != g[p]]
        n_diff, n_all = n_diff + len(diff), n_all + len(s)
        if diff:
            lg = np.asarray(ref_logits(i), np.float64)
            top = np.sort(lg[diff], axis=-1)
            gaps = top[:, -1] - top[:, -2]
            tol = TIE_RTOL[dtype] * np.abs(lg).max()
            assert np.all(gaps < tol), (i, diff, gaps, tol)
    assert n_diff <= (1 - MIN_AGREE) * n_all, (n_diff, n_all)
    return n_diff
