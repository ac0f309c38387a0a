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
