"""The port's import rule, its copies of the JAX package's host tables,
its device switch, its registry and its CLI surface."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_helpers import files_of, port_env, write_prostt5_checkpoint  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now fails
import unicore_tpu_torch
names = [m.name for m in pkgutil.walk_packages(unicore_tpu_torch.__path__, "unicore_tpu_torch.")
         if not m.name.endswith("__main__")]
for name in names:
    importlib.import_module(name)
assert {"unicore_tpu_torch.align.cascade", "unicore_tpu_torch.phylo.genebatch",
        "unicore_tpu_torch.modules.genetree", "unicore_tpu_torch.modules.config",
        "unicore_tpu_torch.models.prostt5", "unicore_tpu_torch.seq.lookup",
        "unicore_tpu_torch.parallel.mesh", "unicore_tpu_torch.parallel.sharding",
        "unicore_tpu_torch.parallel.dist_check", "unicore_tpu_torch.parallel.collectives",
        "unicore_tpu_torch.native",
        "unicore_tpu_torch.native.build", "unicore_tpu_torch.graft_entry"} <= set(names)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(n for n, m in sys.modules.items() if m is not None
             and (n in ("jax", "unicore_tpu") or n.startswith(("jax.", "unicore_tpu."))))
assert not bad, bad
print(len(names))
"""


def test_port_imports_without_jax_or_unicore_tpu():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 60


def test_host_tables_equal_jax():
    from unicore_tpu import alphabets as ja
    from unicore_tpu import matrices as jm
    from unicore_tpu.align import bias as jbias
    from unicore_tpu.models.mock import MockProstT5 as JaxMock
    from unicore_tpu_torch import alphabets as ta
    from unicore_tpu_torch import matrices as tm
    from unicore_tpu_torch.align import bias as tbias
    from unicore_tpu_torch.models.mock import MockProstT5 as PortMock

    for name in ("BLOSUM62", "MAT3DI"):
        assert np.array_equal(getattr(jm, name), getattr(tm, name)), name
    for fn in ("get_aa_matrix", "get_3di_matrix", "get_3di_background", "default_3di_matrix"):
        assert np.array_equal(getattr(jm, fn)(), getattr(tm, fn)()), fn
    assert (jm.W_AA, jm.W_3DI) == (tm.W_AA, tm.W_3DI)
    for name in ("AA_ALPHABET", "TDI_ALPHABET", "AA_FULL", "TDI_FULL"):
        assert getattr(ja, name) == getattr(ta, name), name
    seqs = ["MKVLAAGIWRT", "ACDEFGHIKLMNPQRSTVWYX" * 3]
    assert JaxMock().predict(seqs) == PortMock().predict(seqs)
    qa = np.stack([ja.encode_aa(seqs[1])[:40]] * 2).astype(np.int32)
    qs = np.stack([ja.encode_3di(JaxMock().predict(seqs)[1])[:40]] * 2).astype(np.int32)
    ql = np.array([40, 31])
    saa, s3d = jm.get_aa_matrix(), jm.get_3di_matrix()
    assert np.array_equal(jbias.composition_bias(qa, qs, ql, saa, s3d, 4.0, 6.0),
                          tbias.composition_bias(qa, qs, ql, saa, s3d, 4.0, 6.0))


def test_device_switch(monkeypatch):
    from unicore_tpu_torch.runtime import device, errors

    assert device.resolve("cpu") == torch.device("cpu")
    monkeypatch.setenv(device.ENV, "cpu")
    assert device.resolve() == torch.device("cpu")
    monkeypatch.delenv(device.ENV)
    if torch.cuda.is_available():
        assert device.resolve().type == "cuda"
    else:  # CUDA by default, and never a quiet fall back to the CPU
        with pytest.raises(errors.UnicoreError):
            device.resolve()
        with pytest.raises(errors.UnicoreError):
            device.resolve("cuda")


def test_registry_defaults_and_overrides(port_env, monkeypatch):  # noqa: F811
    from unicore_tpu_torch.align.engine import AlignmentEngine
    from unicore_tpu_torch.models.prostt5 import ProstT5Engine
    from unicore_tpu_torch.phylo.engine import TreeEngine
    from unicore_tpu_torch.runtime import errors, registry

    assert isinstance(registry.get("foldseek")(None), AlignmentEngine)
    for name in ("iqtree", "fasttree", "raxml-ng"):
        eng = registry.get(name)()
        assert isinstance(eng, TreeEngine)
        assert (eng.schedule, eng.device) == (name, torch.device("cpu"))
    # prostt5 was the typed "not yet ported" exit; it builds the engine
    write_prostt5_checkpoint(port_env / "ckpt")
    eng = registry.get("prostt5")(str(port_env / "ckpt"))
    assert isinstance(eng, ProstT5Engine) and eng.loaded_pretrained and eng.probe()
    assert eng.device == torch.device("cpu")
    with pytest.raises(errors.UnicoreError) as e:
        registry.get("mmseqs")
    assert e.value.err_code == errors.ERR_BINARY_NOT_FOUND
    # an engines.cfg override is resolved before the default
    (port_env / "port_engines.cfg").write_text(
        "# test override\nfoldseek=unicore_tpu_torch.runtime.device:resolve\n")
    registry.load_overrides()
    from unicore_tpu_torch.runtime.device import resolve
    assert registry.get("foldseek") is resolve
    (port_env / "port_engines.cfg").write_text("iqtree=no_such_module:factory\n")
    registry.load_overrides()
    with pytest.raises(errors.UnicoreError):
        registry.get("iqtree")


@pytest.mark.parametrize("name,mode,refine", [
    ("foldmason", "3di+aa", 0), ("mafft", "aa", 0), ("mafft-linsi", "aa", 2)])
def test_registry_msa_engines(port_env, name, mode, refine):  # noqa: F811
    from unicore_tpu_torch.msa.progressive import ProgressiveMSA
    from unicore_tpu_torch.runtime import registry

    eng = registry.get(name)()
    assert isinstance(eng, ProgressiveMSA)
    assert (eng.mode, eng.refine_iters, eng.device) == (mode, refine, torch.device("cpu"))
    assert eng.probe()


@pytest.mark.parametrize("argv", [
    ["search", "db", "target", "out/search", "tmp"],                      # no databases
    ["easy-search", "missing", "target", "out", "mock", "tmp"],           # no input
    ["tree", "db", "in", "out", "--tree-options=-m JTT -p parts.nex"],    # no core genes
])
def test_cli_unported_subcommands_exit_typed(port_env, argv, monkeypatch):  # noqa: F811
    """`search`, `easy-search` and tree options naming a partition file
    were the typed "not yet ported" exit; they are ported.  On a missing
    input each exits with the JAX package's typed code, and writes what
    it writes: the first stage's checkpoint, "0", written before the
    stage reads its input."""
    from unicore_tpu.cli import main as jax_main
    from unicore_tpu_torch.cli import main
    from unicore_tpu_torch.runtime import errors

    codes, written = [], []
    for run, side in ((jax_main, "jax"), (main, "port")):
        (port_env / side / "in" / "fasta").mkdir(parents=True)
        monkeypatch.chdir(port_env / side)
        before = files_of(port_env / side)
        codes.append(run(argv + ["-v", "0"]))
        written.append({k: v for k, v in files_of(port_env / side).items() if k not in before})
    assert codes[0] == codes[1] != 0 and codes[1] != errors.ERR_MODULE_NOT_IMPLEMENTED
    assert written[0] == written[1]
    assert set(written[1]) <= {"out/search.chk", "out/proteome/createdb.chk", "out/tree.chk"}
    assert all(v == b"0" for v in written[1].values())


def test_cli_unported_createdb_options(port_env, monkeypatch):  # noqa: F811
    """A ProstT5 model directory and --afdb-lookup were the typed "not yet
    ported" exit; both run (tests/test_torch_prostt5_cli.py and
    tests/test_torch_lookup.py hold them against the JAX package).
    Without a card and without UNICORE_TPU_TORCH_DEVICE=cpu the model is
    an error, made after the .map and combined_aa.fasta, as in JAX."""
    from unicore_tpu_torch.cli import main
    from unicore_tpu_torch.runtime import errors

    monkeypatch.delenv("UNICORE_TPU_MOCK_PROSTT5", raising=False)
    ind = port_env / "in.fa"
    ind.write_text(">a\nMKVLAAGIW\n")
    out = port_env / "db" / "proteome_db"
    write_prostt5_checkpoint(port_env / "ckpt")
    assert main(["createdb", str(ind), str(out), str(port_env / "ckpt"), "-v", "0"]) == 0
    assert len((port_env / "db" / "proteome_db_ss").read_text().strip("\x00\n")) == 9
    (port_env / "tables" / "md5").mkdir(parents=True)
    for i in range(256):
        (port_env / "tables" / "md5" / f"{i:02x}.tsv").write_text("")
    assert main(["createdb", str(ind), str(out), "mock", "--afdb-lookup", str(port_env / "tables"),
                 "--overwrite", "-v", "0"]) == 0
    assert (port_env / "db" / "converted_aa.fasta").exists()
    if not torch.cuda.is_available():
        monkeypatch.delenv("UNICORE_TPU_TORCH_DEVICE")
        out2 = port_env / "db2" / "proteome_db"
        assert main(["createdb", str(ind), str(out2), str(port_env / "ckpt"), "-v", "0"]) == errors.ERR_GENERAL
        assert sorted(os.listdir(out2.parent)) == ["combined_aa.fasta", "createdb.chk", "proteome_db.map"]
        monkeypatch.setenv("UNICORE_TPU_TORCH_DEVICE", "cpu")
    # UNICORE_TPU_TORCH_COUNTERS: the run's counters and kernel launches as JSON
    monkeypatch.setenv("UNICORE_TPU_TORCH_COUNTERS", str(port_env / "counters.json"))
    assert main(["createdb", str(ind), str(out), "mock", "--overwrite", "-v", "0"]) == 0
    counters = json.loads((port_env / "counters.json").read_text())
    assert counters["kernel.sw.gapped.launches"] == 0
    assert counters["stage.createdb.seconds"] > 0


def test_cluster_cascade_not_yet_ported(port_env, monkeypatch):  # noqa: F811
    """The cascade is ported: above the threshold cluster_db takes it
    (tests/test_torch_cascade.py holds it against the JAX package)."""
    from unicore_tpu_torch.align import cascade
    from unicore_tpu_torch.align.engine import AlignParams
    from unicore_tpu_torch.io.seqdb import SeqDB
    from unicore_tpu_torch.modules.cluster import CASCADE_THRESHOLD, cluster_db

    calls = []
    monkeypatch.setattr(cascade, "cascaded_cluster",
                        lambda db, params: calls.append(len(db)) or ({0: [0, 1, 2]}, []))
    db = SeqDB(names=["a", "b", "c"], aa_seqs=["MKVLA"] * 3, ss_seqs=["DDDDD"] * 3)
    assert cluster_db(db, AlignParams(), cascade_threshold=2) == ({0: [0, 1, 2]}, [])
    assert calls == [3] and CASCADE_THRESHOLD == 5000


def test_stage_writes_a_torch_profiler_trace(tmp_path, monkeypatch):
    from unicore_tpu_torch.runtime import profiling

    monkeypatch.setenv("UNICORE_TPU_TORCH_TRACE_DIR", str(tmp_path / "trace"))
    with profiling.stage("unit"):
        torch.ones(8).sum()
    trace = json.loads((tmp_path / "trace" / "unit.json").read_text())
    assert trace["traceEvents"]
    assert profiling.get_counters()["stage.unit.seconds"] > 0
