"""The port's search path against the JAX package's, on the CPU, on
inputs made from a numpy seed: `AlignmentEngine.traceback_fill` (the m8
columns of every gated hit, through its three routes), `search` and
`easy-search` through both CLIs (byte-identical files before inference,
the same tree), and `cluster --min-seq-id` (byte-identical clust.tsv)."""

import dataclasses

import numpy as np
import pytest

from torch_port_helpers import (  # noqa: F401  (fixtures)
    LETTERS, assert_same_tree, files_of, one_torch_thread, port_env, write_proteomes,
)
from unicore_tpu.align import engine as jeng_mod
from unicore_tpu.cli import main as jax_main
from unicore_tpu.io.seqdb import SeqDB
from unicore_tpu.models.mock import MockProstT5
from unicore_tpu_torch.align import engine as teng_mod
from unicore_tpu_torch.cli import main as port_main
from unicore_tpu_torch.convert import from_jax_arrays
from unicore_tpu_torch.runtime import profiling

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _hits(seed=31):
    """Sequences and gated-hit windows in both packages' Hit types: pairs
    within mutated families (full windows and a window cut inside both
    sequences), lengths 60-320 so windows fall on both sides of a
    long_threshold of 150, and one unrelated pair of random sequences
    above it that shares no seed (the full-window Gotoh fallback)."""
    rng = np.random.RandomState(seed)
    aa = []
    for L in (60, 120, 240, 320):
        base = rng.choice(list(LETTERS), L)
        for _ in range(3):
            s = base.copy()
            pos = rng.randint(0, L, L // 8)
            s[pos] = rng.choice(list(LETTERS), len(pos))
            cut = rng.randint(10, L - 10)
            aa.append("".join(np.delete(s, slice(cut, cut + rng.randint(1, 4)))))
    aa += ["".join(rng.choice(list(LETTERS), 200)) for _ in range(2)]
    ss = MockProstT5().predict(aa)
    windows = []
    for f in range(4):
        i, j, k = 3 * f, 3 * f + 1, 3 * f + 2
        windows += [(i, j, 0, len(aa[i]) - 1, 0, len(aa[j]) - 1),
                    (k, i, 5, len(aa[k]) - 9, 3, len(aa[i]) - 4)]
    windows.append((12, 13, 0, 199, 0, 199))
    hits = {m: [m.Hit(qidx=q, tidx=t, score=1.0, qstart=a, qend=b, tstart=c, tend=d)
                for q, t, a, b, c, d in windows] for m in (jeng_mod, teng_mod)}
    return jeng_mod.encode_db(aa, ss), hits[jeng_mod], hits[teng_mod]


def test_traceback_fill_matches_jax(port_env):  # noqa: F811
    (q_aa, q_ss), ref, out = _hits()
    je = jeng_mod.AlignmentEngine(jeng_mod.AlignParams(backend="xla", long_threshold=150))
    te = teng_mod.AlignmentEngine(**from_jax_arrays(je.saa, je.s3d, je.params), device="cpu")
    profiling.reset_counters()
    je.traceback_fill(ref, q_aa, q_ss, q_aa, q_ss)
    te.traceback_fill(out, q_aa, q_ss, q_aa, q_ss)
    assert [dataclasses.astuple(h) for h in ref] == [dataclasses.astuple(h) for h in out]
    assert all(h.alnlen > 0 for h in out)
    assert any(h.gapopen > 0 for h in out) and any(h.mismatch > 0 for h in out)
    c = profiling.get_counters()
    # the three routes: batched short windows, banded long ones, and the
    # unrelated pair's full-window Gotoh
    assert c["traceback.batched"] >= 2 and c["traceback.banded"] >= 2
    assert c["traceback.full"] == 1 and c["traceback.dispatches"] >= 1


def _createdb(ind, out):
    db = str(out / "proteome" / "proteome_db")
    assert jax_main(["createdb", str(ind), db, "mock", "-v", "1"]) == 0
    return db


def _reference_db(fasta, path):
    """One sequence per gene family (one species' proteome), named as
    AFDB entries, with its mock 3Di."""
    aa = [line.strip() for line in open(fasta) if not line.startswith(">")]
    SeqDB(names=[f"AF-REF{k}-F1" for k in range(len(aa))], aa_seqs=aa,
          ss_seqs=MockProstT5().predict(aa)).write(str(path))


def test_search_cli_matches_jax(port_env):  # noqa: F811
    """`search -k` with its defaults: the 1,100-residue family takes the
    banded alignment and the banded traceback."""
    ind = port_env / "in"
    write_proteomes(ind)
    db = _createdb(ind, port_env / "db")
    ref_db = port_env / "ref" / "ref_db"
    ref_db.parent.mkdir()
    _reference_db(ind / "spec1.fa", ref_db)
    for main, side in ((jax_main, "jax"), (port_main, "port")):
        profiling.reset_counters()
        argv = ["search", db, str(ref_db), str(port_env / side / "search"), str(port_env / f"{side}_tmp"),
                "-k", "-v", "1"]
        assert main(argv) == 0
    ref, out = files_of(port_env / "jax"), files_of(port_env / "port")
    assert sorted(ref) == sorted(out)
    assert {"search.m8", "search.chk", "search_aln", "search_aln.index"} <= set(out)
    for name in ref:
        assert ref[name] == out[name], name
    m8 = out["search.m8"].decode().splitlines()
    refs = [line.split("\t")[0] for line in m8]
    assert refs == sorted(refs) and len(set(refs)) == 7  # grouped by reference
    c = profiling.get_counters()
    assert c["traceback.batched"] > 0 and c["traceback.banded"] > 0
    assert c["search.hits"] == len(m8)


def _easy_search_inputs(root):
    """tests/test_easy_search.py's fixture: three 60-residue families, one
    copy per species, and a reference DB of one sequence per family."""
    rng = np.random.RandomState(5)

    def family(n, L=60):
        base = rng.choice(list(LETTERS), L)
        out = []
        for _ in range(n):
            s = base.copy()
            for _ in range(2):
                s[rng.randint(L)] = rng.choice(list(LETTERS))
            out.append("".join(s))
        return out

    fams = [family(4) for _ in range(3)]
    ind = root / "in"
    ind.mkdir()
    for si in range(4):
        with open(ind / f"spec{si}.fa", "w") as f:
            for gi, fam in enumerate(fams):
                f.write(f">gene{gi}_spec{si}\n{fam[si]}\n")
    ref_aa = [fam[0] for fam in fams]
    SeqDB(names=[f"AF-REF{gi}-F1" for gi in range(3)], aa_seqs=ref_aa,
          ss_seqs=MockProstT5().predict(ref_aa)).write(str(root / "ref_db"))
    return ind, root / "ref_db"


def test_easy_search_cli_matches_jax(port_env):  # noqa: F811
    ind, ref_db = _easy_search_inputs(port_env)
    for main, side in ((jax_main, "jax"), (port_main, "port")):
        argv = ["easy-search", str(ind), str(ref_db), str(port_env / side), "mock",
                str(port_env / f"{side}_tmp"), "--tree-builder", "fasttree",
                "--tree-options=-gamma -boot 10", "-s", "-c 0.8 -e 10", "-v", "1"]
        assert main(argv) == 0
    ref, out = files_of(port_env / "jax"), files_of(port_env / "port")
    assert sorted(ref) == sorted(out)
    assert {"search/search.m8", "profile/REF0.txt", "profile/copiness.tsv",
            "tree/combined.fasta.partitions", "tree/fasttree.nwk", "tree/tree.chk"} <= set(out)
    for name in ref:
        if name.endswith("fasttree.nwk"):
            assert_same_tree(ref[name].decode(), out[name].decode())
        else:
            assert ref[name] == out[name], name
    # the checkpoints skip every stage on a second run
    before = files_of(port_env / "port")
    assert port_main(argv) == 0
    assert files_of(port_env / "port") == before


def test_cluster_min_seq_id_matches_jax(port_env):  # noqa: F811
    ind = port_env / "in"
    write_proteomes(ind)
    db = _createdb(ind, port_env / "db")
    for main, side in ((jax_main, "jax"), (port_main, "port")):
        profiling.reset_counters()
        argv = ["cluster", db, str(port_env / side / "clust"), str(port_env / f"{side}_tmp"),
                "--cluster-options=-c 0.8 --min-seq-id 0.3", "-v", "1"]
        assert main(argv) == 0
    ref, out = files_of(port_env / "jax"), files_of(port_env / "port")
    assert ref == out and "clust.tsv" in out
    c = profiling.get_counters()
    assert c["traceback.batched"] > 0 and c["traceback.banded"] > 0
