"""The port's `tree -n` and `easy-core -n` through unicore_tpu_torch's CLI
against unicore_tpu's CLI on the same proteomes: every file written
(per-gene fastas, seqdbs, MSAs, filtered MSAs, combined.fasta and its
partitions, tree.chk) must be byte-identical.  Without -n, tree inference
is not ported: both subcommands exit 5 and write nothing."""

import pytest

from torch_port_helpers import files_of, port_env, write_proteomes  # noqa: F401
from unicore_tpu.cli import main as jax_main
from unicore_tpu_torch.cli import main as port_main
from unicore_tpu_torch.runtime import errors, profiling


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """`python -m unicore_tpu easy-core IN OUT mock TMP -n` on the
    four-species fixture, once for the module: the reference of the
    easy-core test, and the database and core genes of the tree tests."""
    root = tmp_path_factory.mktemp("jax_run")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HOME", str(root / "home"))
        write_proteomes(root / "in")
        assert jax_main(["easy-core", str(root / "in"), str(root / "out"), "mock",
                         str(root / "tmp"), "-n", "-v", "1"]) == 0
    return root


def _assert_same_files(ref_root, out_root):
    ref, out = files_of(ref_root), files_of(out_root)
    assert sorted(ref) == sorted(out)
    for name in sorted(ref):
        assert ref[name] == out[name], name
    return out


@pytest.mark.parametrize("aligner", ["foldmason", "mafft", "mafft-linsi"])
def test_tree_no_inference_matches_jax(port_env, jax_run, aligner):  # noqa: F811
    db = str(jax_run / "out" / "proteome" / "proteome_db")
    argv = ["tree", db, str(jax_run / "out" / "profile")]
    opts = ["-n", "-A", aligner, "-v", "1"]
    assert jax_main(argv + [str(port_env / "jax_tree")] + opts) == 0
    profiling.reset_counters()
    assert port_main(argv + [str(port_env / "port_tree")] + opts) == 0

    out = _assert_same_files(port_env / "jax_tree", port_env / "port_tree")
    genes = sorted(p.name for p in (jax_run / "out" / "profile").glob("*.txt"))
    assert len(genes) >= 3
    msa = "_aa.fa" if aligner == "foldmason" else ".fa"
    for g in genes:
        gene = g[:-4]
        assert f"fasta/{gene}/{gene}{msa}" in out and f"fasta/{gene}/{gene}.fa.filtered" in out
    assert (aligner == "foldmason") == any(n.endswith("_3di.fa") for n in out)
    assert {"combined.fasta", "combined.fasta.partitions", "tree.chk"} <= set(out)
    counters = profiling.get_counters()
    assert counters["msa.dispatches"] > 0 and counters["msa.cells"] > 0
    assert counters["msa.nw.seconds"] > 0 and counters["msa.seconds"] > 0


def test_easy_core_no_inference_matches_jax(port_env, jax_run):  # noqa: F811
    assert port_main(["easy-core", str(jax_run / "in"), str(port_env / "out"), "mock",
                      str(port_env / "tmp"), "-n", "-v", "1"]) == 0
    out = _assert_same_files(jax_run / "out", port_env / "out")
    assert {"cluster/clust.tsv", "profile/copiness.tsv", "tree/combined.fasta",
            "tree/combined.fasta.partitions"} <= set(out)
    assert out["tree/tree.chk"] == b"0"  # -n returns before the checkpoint's "1"


@pytest.mark.parametrize("argv", [
    ["tree", "{db}", "{profile}", "{out}"],
    ["easy-core", "{in}", "{out}", "mock", "{out}/tmp"],
])
def test_inference_not_ported_exits_before_writing(port_env, jax_run, argv):  # noqa: F811
    paths = {"db": str(jax_run / "out" / "proteome" / "proteome_db"),
             "profile": str(jax_run / "out" / "profile"), "in": str(jax_run / "in"),
             "out": str(port_env / "out")}
    argv = [a.format(**paths) for a in argv]
    assert port_main(argv + ["-v", "0"]) == errors.ERR_MODULE_NOT_IMPLEMENTED
    assert not (port_env / "out").exists()


def test_tree_skip_path_leads_to_inference(port_env, jax_run):  # noqa: F811
    """An existing combined.fasta sends the JAX module straight to
    inference, even with -n: the port exits with the typed error there."""
    out = port_env / "out"
    out.mkdir()
    (out / "combined.fasta").write_text(">a\nAC\n")
    argv = ["tree", str(jax_run / "out" / "proteome" / "proteome_db"),
            str(jax_run / "out" / "profile"),
            str(out), "-n", "-v", "0"]
    assert port_main(argv) == errors.ERR_MODULE_NOT_IMPLEMENTED
    assert sorted(p.name for p in out.iterdir()) == ["combined.fasta"]
