"""The port's slice end to end: `createdb mock -> cluster -> profile`
through unicore_tpu_torch's CLI against unicore_tpu's CLI on the same
proteomes; every file written must be byte-identical."""

import os

import numpy as np

from torch_port_helpers import port_env, stats_dir  # noqa: F401  (fixture)
from unicore_tpu.cli import main as jax_main
from unicore_tpu_torch.cli import main as port_main
from unicore_tpu_torch.runtime import profiling

LETTERS = "ARNDCQEGHILKMFPSTWYV"


def _family(rng, n, L):
    base = rng.choice(list(LETTERS), L)
    out = []
    for _ in range(n):
        s = base.copy()
        for _ in range(max(2, L // 40)):
            s[rng.randint(L)] = rng.choice(list(LETTERS))
        out.append("".join(s))
    return out


def _write_proteomes(ind, seed=5):
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


def _run(main, out, ind, tmp):
    db = str(out / "proteome" / "proteome_db")
    assert main(["createdb", str(ind), db, "mock", "-v", "1"]) == 0
    assert main(["cluster", db, str(out / "cluster" / "clust"), str(tmp), "-v", "1"]) == 0
    assert main(["profile", db, str(out / "cluster" / "clust.tsv"), str(out / "profile"),
                 "-v", "1"]) == 0


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def test_slice_cli_matches_jax(port_env):  # noqa: F811
    ind = port_env / "in"
    _write_proteomes(ind)
    _run(jax_main, port_env / "jax_out", ind, port_env / "jax_tmp")
    profiling.reset_counters()
    _run(port_main, port_env / "port_out", ind, port_env / "port_tmp")

    ref, out = _files(port_env / "jax_out"), _files(port_env / "port_out")
    assert sorted(ref) == sorted(out)
    for name in sorted(ref):
        assert ref[name] == out[name], name
    # the slice really went through every stage, the banded path included
    assert {"proteome/proteome_db.map", "cluster/clust.tsv", "profile/copiness.tsv"} <= set(out)
    assert any(n.startswith("profile/") and n.endswith(".txt") for n in out)
    counters = profiling.get_counters()
    assert counters["rescore.cells"] > 0 and counters["align.cells"] > 0
    assert counters["cluster.hits"] > 0
    # both calibrations were fresh, each in its package's cache under the
    # test's own HOME
    assert any(stats_dir(port_env, "unicore_tpu").iterdir())
    assert any(stats_dir(port_env, "unicore_tpu_torch").iterdir())
