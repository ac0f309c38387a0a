"""The port's slice end to end: `createdb mock -> cluster -> profile`
through unicore_tpu_torch's CLI against unicore_tpu's CLI on the same
proteomes; every file written must be byte-identical."""

from torch_port_helpers import files_of, port_env, stats_dir, write_proteomes  # noqa: F401
from unicore_tpu.cli import main as jax_main
from unicore_tpu_torch.cli import main as port_main
from unicore_tpu_torch.runtime import profiling


def _run(main, out, ind, tmp):
    db = str(out / "proteome" / "proteome_db")
    assert main(["createdb", str(ind), db, "mock", "-v", "1"]) == 0
    assert main(["cluster", db, str(out / "cluster" / "clust"), str(tmp), "-v", "1"]) == 0
    assert main(["profile", db, str(out / "cluster" / "clust.tsv"), str(out / "profile"),
                 "-v", "1"]) == 0


def test_slice_cli_matches_jax(port_env):  # noqa: F811
    ind = port_env / "in"
    write_proteomes(ind)
    _run(jax_main, port_env / "jax_out", ind, port_env / "jax_tmp")
    profiling.reset_counters()
    _run(port_main, port_env / "port_out", ind, port_env / "port_tmp")

    ref, out = files_of(port_env / "jax_out"), files_of(port_env / "port_out")
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
