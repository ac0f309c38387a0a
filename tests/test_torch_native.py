"""The port's native featurizer (unicore_tpu_torch/native, its own copy of
fastio.cpp built with g++ at first use) against its plain version
(align/prefilter.py::featurize_plain) and the JAX package's featurize:
bit-identical bags.  Also its build: hash-keyed under build/, atomic
when processes build at once, and an error, never a quiet fall back,
when g++ is missing or the source does not compile."""

import os
import subprocess
import sys

import numpy as np
import pytest

from unicore_tpu.align import prefilter as jp
from unicore_tpu_torch import native
from unicore_tpu_torch.align import cascade, prefilter
from unicore_tpu_torch.alphabets import encode_aa
from unicore_tpu_torch.runtime import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LETTERS = "ACDEFGHIKLMNPQRSTVWYXBZ"


def _seqs(n, seed, max_len=400):
    """n sequences, lengths 0 to max_len (some shorter than k = 3)."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(0, max_len, n)
    lens[: min(n, 4)] = [0, 1, 2, 3][: min(n, 4)]
    aa = ["".join(rng.choice(list(LETTERS), k)) for k in lens]
    ss = ["".join(rng.choice(list(LETTERS[:20]), k)) for k in lens]
    return aa, ss


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The library built anew into `tmp_path` (not loaded yet)."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    return tmp_path


@pytest.mark.parametrize("n,dim", [(10, 2048), (10, 1000), (200, 2048), (200, 1000), (64, 512)])
def test_featurize_equals_plain_and_jax(n, dim):
    """N below and above 64 (the threaded path), two dims."""
    aa, ss = _seqs(n, seed=n + dim)
    got = prefilter.featurize(aa, ss, dim=dim)
    assert got.dtype == np.float32 and got.shape == (n, dim)
    assert np.array_equal(got, prefilter.featurize_plain(aa, ss, dim=dim))
    assert np.array_equal(got, jp.featurize(aa, ss, dim=dim))
    assert got[4:].sum() > 0 and got[:2].sum() == 0  # lengths 0 and 1 have no 3-mer


def test_featurize_does_not_depend_on_the_thread_count():
    aa, _ = _seqs(300, seed=1)
    codes = [encode_aa(s) for s in aa]
    outs = []
    for nthreads in (1, 3, 8, 0):
        out = np.zeros((300, 777), np.float32)
        native.featurize_native(codes, 4, 777, 1, out, nthreads=nthreads)
        outs.append(out)
    assert all(np.array_equal(outs[0], o) for o in outs[1:])
    assert outs[0].sum() > 0


def test_featurize_of_nothing():
    assert prefilter.featurize([], [], dim=64).shape == (0, 64)
    with pytest.raises(ValueError):
        native.featurize_native([np.array([0, 21])], 3, 64, 0, np.zeros((1, 64), np.float32))
    with pytest.raises(ValueError):
        native.featurize_native([np.array([0, 1])], 3, 64, 0, np.zeros((1, 64), np.float64))


def test_count_fasta(tmp_path):
    (tmp_path / "a.fa").write_text(">a x\nMKV\nLL\n>b\n\n>c\nW\n")
    assert native.count_fasta(str(tmp_path / "a.fa")) == 3
    with pytest.raises(OSError):
        native.count_fasta(str(tmp_path / "missing.fa"))


def test_prefilter_and_cascade_go_through_the_native_library(monkeypatch):
    calls = []
    real = native.featurize_native
    monkeypatch.setattr(native, "featurize_native", lambda *a, **k: calls.append(1) or real(*a, **k))
    aa, ss = _seqs(30, seed=3)
    profiling.reset_counters()
    prefilter.candidate_pairs(aa, ss, device="cpu")
    assert len(calls) == 2 and profiling.get_counters()["prefilter.featurize.seconds"] > 0
    cascade.canopy_assign(aa, ss, device="cpu")
    assert len(calls) == 4


def test_build_is_keyed_by_the_source_and_the_flags(fresh_build):
    so = native.build_library()
    assert so.parent == fresh_build / "build" and so.name.startswith("libufio_")
    assert native.build_library() == so  # reused
    assert native.build_library(flags=native.CXX_FLAGS + ("-DX=1",)) != so
    assert not any(p.suffix == ".so" for p in (native.SOURCE.parent).iterdir())  # never in the package
    aa, ss = _seqs(20, seed=4)
    assert np.array_equal(prefilter.featurize(aa, ss), prefilter.featurize_plain(aa, ss))


def test_processes_building_at_once_share_one_library(fresh_build):
    code = ("import sys; from pathlib import Path; from unicore_tpu_torch import native; "
            "native.BUILD_DIR = Path(sys.argv[1]); print(native.build_library())")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(fresh_build / "build")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert len({o.strip() for o, _ in outs}) == 1
    assert sorted(os.listdir(fresh_build / "build")) == [os.path.basename(outs[0][0].strip())]


def test_missing_compiler_raises(fresh_build, monkeypatch):
    monkeypatch.setenv("PATH", str(fresh_build / "empty"))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        prefilter.featurize(["MKVLAW"], ["DDVVLL"])


def test_failed_build_raises_with_the_compilers_output(fresh_build, monkeypatch):
    bad = fresh_build / "bad.cpp"
    bad.write_text("int ufio_version() { return }\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="error"):
        prefilter.featurize(["MKVLAW"], ["DDVVLL"])
    assert not (fresh_build / "build").exists() or not os.listdir(fresh_build / "build")
