"""The port's `config` subcommand (modules/config.py): `--check` reports
the device and probes every engine; `--set-<engine>` writes the port's
own engines.cfg (never ~/.unicore_tpu/ nor a file of the repo), and the
registry resolves what it wrote."""

import os
import subprocess
import sys

import pytest

from torch_port_helpers import port_env  # noqa: F401  (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_config_check_probes_every_engine(port_env):  # noqa: F811
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("UNICORE_TPU_TORCH_ENGINES_CFG")
    res = subprocess.run([sys.executable, "-m", "unicore_tpu_torch", "config", "--check"],
                         cwd=port_env, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert "  cuda available: False, devices: 0, engines run on: cpu" in lines
    for name, engine in (("foldseek", "torch-align"), ("iqtree", "torch-phylo"),
                         ("fasttree", "torch-phylo"), ("raxml-ng", "torch-phylo")):
        assert f"  {name}: ok ({engine})" in lines, res.stdout
    for name in ("foldmason", "mafft", "mafft-linsi"):
        assert any(l.startswith(f"  {name}: ok (") for l in lines), res.stdout
    assert "  mmseqs: no" in lines  # no factory in either registry, as in JAX
    assert not (port_env / "home" / ".unicore_tpu").exists()


def test_config_set_round_trip(port_env, monkeypatch):  # noqa: F811
    from unicore_tpu_torch.cli import main
    from unicore_tpu_torch.msa.progressive import ProgressiveMSA
    from unicore_tpu_torch.runtime import errors, registry

    monkeypatch.delenv("UNICORE_TPU_TORCH_ENGINES_CFG")
    monkeypatch.chdir(port_env)
    repo_cfg = open(os.path.join(REPO, "etc", "engines.cfg")).read()
    cfg = port_env / "home" / ".unicore_tpu_torch" / "engines.cfg"
    factory = "unicore_tpu_torch.runtime.registry:get_override"
    assert main(["config", "--set-mafft", factory, "-v", "0"]) == 0
    assert f"mafft={factory}" in cfg.read_text().splitlines()
    registry.clear_overrides()
    registry.load_overrides()
    assert registry.get("mafft") is registry.get_override  # the override resolves
    assert main(["config", "--set-mafft", "builtin", "-v", "0"]) == 0
    assert "# mafft=builtin" in cfg.read_text().splitlines()
    registry.clear_overrides()
    registry.load_overrides()
    assert isinstance(registry.get("mafft")(), ProgressiveMSA)
    assert main(["config", "--set-iqtree", "no_such_module:factory", "-v", "0"]) == errors.ERR_GENERAL
    assert "# iqtree=builtin" in cfg.read_text().splitlines()  # left as it was
    assert not (port_env / "home" / ".unicore_tpu").exists()
    assert not (port_env / "engines.cfg").exists()
    assert open(os.path.join(REPO, "etc", "engines.cfg")).read() == repo_cfg


@pytest.mark.parametrize("argv", [["config"], ["config", "-v", "3"]])
def test_config_without_options_does_nothing(port_env, argv, capsys):  # noqa: F811
    from unicore_tpu_torch.cli import main

    assert main(argv) == 0
    assert not (port_env / "home" / ".unicore_tpu_torch").exists()
