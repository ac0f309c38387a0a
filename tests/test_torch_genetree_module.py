"""The port's `gene-tree` module (modules/genetree.py) against the JAX
package's: both run on copies of one tree-module output directory made
from a numpy seed, on the CPU; the files they write must agree (trees
after parsing, as torch_port_helpers.assert_same_tree; everything else
byte for byte).  Counterparts of tests/test_genetree.py and of
tests/test_genetree_batched.py's module test; plus gene-tree's defaults
(iqtree -m JTT+F+I+G -B 1000) on one lockstep group, and a partition
file through both CLIs."""

import shutil
from types import SimpleNamespace

import numpy as np
import pytest

from torch_port_helpers import (  # noqa: F401
    GENE_LL_RTOL as LL_RTOL, assert_same_gene_tree, assert_same_tree, files_of, gene_msa,
    one_torch_thread, port_env, write_msa,
)
from unicore_tpu.phylo import engine as jeng
from unicore_tpu_torch.phylo import engine as teng
from unicore_tpu_torch.phylo.newick import parse_newick

pytestmark = pytest.mark.usefixtures("one_torch_thread", "port_env")


def test_iqtree_defaults_with_ufboot_match_jax():
    """`-m JTT+F+I+G -B 1000`, gene-tree's default, on two 5-taxa genes of
    one (5, 128) lockstep group."""
    rng = np.random.RandomState(8)
    grouped = [gene_msa(rng, 5, L) for L in (70, 84)]
    opts = "-m JTT+F+I+G -B 1000"
    ref = jeng.TreeEngine("iqtree").infer_batched(grouped, options=opts)
    got = teng.TreeEngine("iqtree").infer_batched(grouped, options=opts)
    for msa, r, g in zip(grouped, ref, got):
        assert assert_same_gene_tree(msa, r, g, supported=True)
        assert g[2]["n_patterns"] < 128


def _gt_args(input_dir, **kw):
    a = SimpleNamespace(
        genetree_input=str(input_dir),
        genetree_names="",
        genetree_tree_builder="fasttree",
        genetree_tree_options="-gamma -boot 20",
        genetree_realign=False,
        genetree_aligner="foldmason",
        genetree_aligner_options=None,
        genetree_threshold=50,
    )
    for k, v in kw.items():
        setattr(a, k, v)
    return a


def _make_gene(fasta_dir, gene, msa, stale=True):
    gd = fasta_dir / gene
    gd.mkdir(parents=True)
    write_msa(gd / f"{gene}.fa.filtered", msa)
    if stale:  # stale iqtree output that must be deleted (genetree.rs:117-131)
        (gd / "iqtree.treefile").write_text("(stale);\n")


def _both(tmp_path, make, **kw):
    """Build one input directory, copy it, run each package's module on
    its copy; returns ({file: bytes} of JAX's, of the port's)."""
    from unicore_tpu.modules import genetree as jgt
    from unicore_tpu_torch.modules import genetree as tgt

    make(tmp_path / "jax")
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    jgt.run(_gt_args(tmp_path / "jax", **{k: (v.replace("@", str(tmp_path / "jax"))
                                               if isinstance(v, str) else v) for k, v in kw.items()}))
    tgt.run(_gt_args(tmp_path / "port", **{k: (v.replace("@", str(tmp_path / "port"))
                                                if isinstance(v, str) else v) for k, v in kw.items()}))
    return files_of(tmp_path / "jax"), files_of(tmp_path / "port")


def assert_same_outputs(ref, out, supported=True):
    assert sorted(ref) == sorted(out)
    for name in sorted(ref):
        if name.endswith((".nwk", ".treefile", ".bestTree", ".support")):
            assert_same_tree(ref[name].decode().strip(), out[name].decode().strip(),
                             supported=supported and not name.endswith(".bestTree"))
        else:
            assert ref[name] == out[name], name


def test_genetree_runs_per_gene(tmp_path):
    msa = {
        "sp1": "ACDEFGHIKLMNPQRSTVWY",
        "sp2": "ACDEFGHIKLMNPQRSTVWF",
        "sp3": "ACDEYGHIKLMNPQRSTVWY",
        "sp4": "ACDEYGHIKTMNPQRSTVWY",
    }

    def make(root):
        for gene in ("geneA", "geneB"):
            _make_gene(root / "fasta", gene, msa)

    ref, out = _both(tmp_path, make)
    assert_same_outputs(ref, out)
    for gene in ("geneA", "geneB"):
        assert f"fasta/{gene}/fasttree.nwk" in out
        assert f"fasta/{gene}/iqtree.treefile" not in out  # stale output removed
        t = parse_newick(out[f"fasta/{gene}/fasttree.nwk"].decode())
        assert sorted(l.name for l in t.leaves()) == ["sp1", "sp2", "sp3", "sp4"]


def test_genetree_module_batched_path(tmp_path):
    """Through the CLI's parser, iqtree's report files included."""
    from unicore_tpu.cli import build_parser as jparser, resolve as jresolve
    from unicore_tpu.modules import genetree as jgt
    from unicore_tpu_torch.cli import build_parser as tparser, resolve as tresolve
    from unicore_tpu_torch.modules import genetree as tgt

    rng = np.random.RandomState(7)
    for g in range(3):
        _make_gene(tmp_path / "jax" / "fasta", f"gene{g}", gene_msa(rng, 5, 50), stale=False)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    argv = ["--tree-builder", "iqtree", "--tree-options=-m JTT+F+G"]
    jgt.run(jresolve(jparser().parse_args(["gene-tree", str(tmp_path / "jax")] + argv)))
    tgt.run(tresolve(tparser().parse_args(["gene-tree", str(tmp_path / "port")] + argv)))
    ref, out = files_of(tmp_path / "jax"), files_of(tmp_path / "port")
    assert sorted(ref) == sorted(out)
    for g in range(3):
        d = f"fasta/gene{g}/"
        assert_same_tree(ref[d + "iqtree.treefile"].decode(), out[d + "iqtree.treefile"].decode(),
                         supported=False)
        for f in ("iqtree.iqtree", "iqtree.log"):
            rl, ol = (dict(l.split(": ", 1) for l in x[d + f].decode().splitlines() if ": " in l)
                      for x in (ref, out))
            jll, tll = float(rl.pop("lnL")), float(ol.pop("lnL"))
            assert abs(tll - jll) <= LL_RTOL * abs(jll)
            rl.pop("seconds"), ol.pop("seconds")
            assert rl == ol and int(ol["n_patterns"]) <= 50


def test_genetree_realign(tmp_path):
    """--realign recomputes the MSA from aa.fasta/3di.fasta before trees."""
    seqs = {
        "sp1": "MKVLITGGGSGIGL",
        "sp2": "MKVLITGGSGIGL",
        "sp3": "MKVLITGGGSGIGL",
    }

    def make(root):
        gd = root / "fasta" / "geneA"
        gd.mkdir(parents=True)
        write_msa(gd / "aa.fasta", seqs)
        write_msa(gd / "3di.fasta", {h: "D" * len(s) for h, s in seqs.items()})

    ref, out = _both(tmp_path, make, genetree_realign=True, genetree_threshold=0)
    assert_same_outputs(ref, out)
    msa = out["fasta/geneA/geneA.fa.filtered"].decode()
    assert len({len(l) for l in msa.splitlines() if not l.startswith(">")}) == 1
    assert "fasta/geneA/fasttree.nwk" in out


def test_genetree_name_filter(tmp_path):
    msa = {"sp1": "ACDEFGHIKL", "sp2": "ACDEFGHIKW", "sp3": "ACDQFGHIKL"}

    def make(root):
        for gene in ("geneA", "geneB"):
            _make_gene(root / "fasta", gene, msa)
        (root / "names.txt").write_text("geneB\n")

    ref, out = _both(tmp_path, make, genetree_names="@/names.txt")
    assert_same_outputs(ref, out)
    assert "fasta/geneA/fasttree.nwk" not in out
    assert "fasta/geneA/iqtree.treefile" in out  # not selected: left alone
    assert "fasta/geneB/fasttree.nwk" in out


@pytest.mark.parametrize("builder,options", [("iqtree", "-m JTT+F+G -p parts.nex"),
                                             ("fasttree", "-q parts.nex -gamma")])
def test_genetree_partition_option_exits_before_touching_files(tmp_path, builder, options,
                                                               monkeypatch):
    """A partition file in the tree options was the typed "not yet
    ported" exit; it now runs the partitioned model through both CLIs:
    the stale iqtree.treefile is deleted, and the outputs agree (trees
    after parsing, reports but lnL byte for byte, lnL within
    BLEN_LL_RTOL)."""
    from unicore_tpu.cli import main as jax_main
    from unicore_tpu_torch.cli import main

    monkeypatch.chdir(tmp_path)
    (tmp_path / "parts.nex").write_text("JTT+F+G, p1 = 1-5\nJTT+F+G, p2 = 6-10\n")
    msa = {"a": "ACDEFGHIKL", "b": "ACDFFGHIKW", "c": "ACDWFGYIKL", "d": "MCDWFGYIRL"}
    for side in ("jax", "port"):
        _make_gene(tmp_path / side / "fasta", "geneA", msa)
    for run, side in ((jax_main, "jax"), (main, "port")):
        assert run(["gene-tree", side, "-T", builder, f"--tree-options={options}", "-v", "0"]) == 0
    ref, out = files_of(tmp_path / "jax"), files_of(tmp_path / "port")
    assert "fasta/geneA/iqtree.treefile" in out if builder == "iqtree" else \
        "fasta/geneA/iqtree.treefile" not in out  # the stale one is gone
    reports = [n for n in ref if n.endswith(("iqtree.iqtree", "iqtree.log"))]
    for name in reports:
        r, g = (dict(x.split(": ", 1) for x in d[name].decode().splitlines() if ": " in x)
                for d in (ref, out))
        jll, tll = float(r.pop("lnL")), float(g.pop("lnL"))
        assert abs(tll - jll) <= 1e-4 * abs(jll), (name, jll, tll)
        r.pop("seconds"), g.pop("seconds")
        assert r == g and g["n_partitions"] == "2", name
    assert_same_outputs({k: v for k, v in ref.items() if k not in reports},
                        {k: v for k, v in out.items() if k not in reports})