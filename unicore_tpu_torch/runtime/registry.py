"""Engine registry — the in-process analog of the reference's BinaryPaths.

The reference resolves 8 external binary names through `path.cfg`
(envs/variables.rs:79-144). Here every capability is an in-process engine;
the registry maps the same names to engine factories so that

  * the `config` module can report/probe them (`--check`),
  * tests can swap in fakes without touching the pipeline code,
  * user overrides in `engines.cfg` (same `name=value` format as path.cfg,
    `#` comments) can select alternative backends.

Valid names mirror envs/variables.rs:79-81 plus TPU-native extras.

Counterpart of unicore_tpu/runtime/registry.py.  `foldseek` (the port's
AlignmentEngine), `foldmason`, `mafft` and `mafft-linsi` (its
ProgressiveMSA), `iqtree`, `fasttree` and `raxml-ng` (its TreeEngine
schedules) and `prostt5` (its ProstT5Engine) have default factories
here; every other valid name (`mmseqs`, never invoked) resolves
to a typed ERR_BINARY_NOT_FOUND "not yet ported" unless an override
names a factory.  Each engine runs on the device runtime/device.py
resolves.  Overrides are read from the port's own
engines.cfg: $UNICORE_TPU_TORCH_ENGINES_CFG, ./engines.cfg, or
~/.unicore_tpu_torch/engines.cfg.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

from . import errors as err

# Names kept for parity with the reference's VALID_BINARY set.
VALID_ENGINES = (
    "foldseek",      # -> unicore_tpu_torch.align (pairwise/cluster engine)
    "foldmason",     # -> unicore_tpu_torch.msa 3Di-aware progressive MSA
    "mafft",         # -> unicore_tpu_torch.msa AA-only progressive MSA
    "mafft-linsi",   # -> unicore_tpu_torch.msa AA-only, accurate settings
    "iqtree",        # -> unicore_tpu_torch.phylo ML engine, NNI + UFBoot-style
    "fasttree",      # -> unicore_tpu_torch.phylo approximate-ML schedule
    "raxml-ng",      # -> unicore_tpu_torch.phylo ML engine, raxml-style schedule
    "mmseqs",        # registered but never invoked (parity: variables.rs:80)
    "prostt5",       # -> unicore_tpu_torch.models.prostt5, the AA->3Di translation model
)

_FACTORIES: Dict[str, Callable[[], object]] = {}
_OVERRIDES: Dict[str, str] = {}


def register(name: str, factory: Callable[[], object]) -> None:
    if name not in VALID_ENGINES:
        err.error(err.ERR_GENERAL, f"Unknown engine name: {name}")
    _FACTORIES[name] = factory


def _resolve_override(name: str, spec: str) -> Callable[..., object]:
    """Import a "module:attr" engine factory named in engines.cfg.

    The analog of the reference resolving path.cfg entries to real
    binaries (variables.rs:118-132); a broken entry maps to the same
    typed failure as a missing binary (error_handler.rs BINARY_NOT_FOUND).
    """
    import importlib

    mod_name, _, attr = spec.partition(":")
    try:
        mod = importlib.import_module(mod_name)
        return getattr(mod, attr) if attr else mod  # type: ignore[return-value]
    except (ImportError, AttributeError) as e:
        err.error(
            err.ERR_BINARY_NOT_FOUND,
            f"engine override '{name}={spec}' does not resolve: {e}",
        )
        raise  # unreachable; err.error raises


def get(name: str) -> Callable[..., object]:
    """Resolve an engine factory: engines.cfg override first, then the
    built-in default (the override value "builtin" forces the default).
    A name with neither is a typed "not yet ported" error."""
    ov = _OVERRIDES.get(name)
    if ov and ov != "builtin":
        return _resolve_override(name, ov)
    factory = _FACTORIES.get(name)
    if factory is None:
        err.error(err.ERR_BINARY_NOT_FOUND,
                  f"engine '{name}' is not yet ported to unicore_tpu_torch")
    return factory


def has(name: str) -> bool:
    return name in _FACTORIES


def locate_engines_cfg() -> Optional[str]:
    """Config location probe mirroring variables.rs:66-76.

    `UNICORE_TPU_TORCH_ENGINES_CFG` pins the location outright (even if
    the file does not exist yet); otherwise the first existing file of
    ./engines.cfg and ~/.unicore_tpu_torch/engines.cfg."""
    env = os.environ.get("UNICORE_TPU_TORCH_ENGINES_CFG")
    if env:
        return env
    candidates = [
        os.path.join(os.getcwd(), "engines.cfg"),
        os.path.expanduser("~/.unicore_tpu_torch/engines.cfg"),
    ]
    for c in candidates:
        if os.path.isfile(c):
            return os.path.abspath(c)
    return None


def load_overrides(path: Optional[str] = None) -> Dict[str, str]:
    path = path or locate_engines_cfg()
    if path is None or not os.path.isfile(path):
        return {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            k, v = line.split("=", 1)
            _OVERRIDES[k.strip()] = v.strip()
    return dict(_OVERRIDES)


def get_override(name: str) -> Optional[str]:
    return _OVERRIDES.get(name)


def clear_overrides() -> None:
    """Reset override state (test isolation)."""
    _OVERRIDES.clear()


def _register_defaults() -> None:
    """Lazy default wiring: the engine's modules load when it is made."""

    def _align_engine(params=None):
        from unicore_tpu_torch.align.engine import AlignmentEngine
        return AlignmentEngine(params)

    def _msa_engine_foldmason():
        from unicore_tpu_torch.msa.progressive import ProgressiveMSA
        return ProgressiveMSA(mode="3di+aa")

    def _msa_engine_mafft():
        from unicore_tpu_torch.msa.progressive import ProgressiveMSA
        return ProgressiveMSA(mode="aa")

    def _msa_engine_linsi():
        from unicore_tpu_torch.msa.progressive import ProgressiveMSA
        return ProgressiveMSA(mode="aa", refine_iters=2)

    def _tree_iqtree():
        from unicore_tpu_torch.phylo.engine import TreeEngine
        return TreeEngine(schedule="iqtree")

    def _tree_fasttree():
        from unicore_tpu_torch.phylo.engine import TreeEngine
        return TreeEngine(schedule="fasttree")

    def _tree_raxml():
        from unicore_tpu_torch.phylo.engine import TreeEngine
        return TreeEngine(schedule="raxml-ng")

    def _prostt5(model_dir=None):
        from unicore_tpu_torch.models.prostt5 import ProstT5Engine
        return ProstT5Engine(model_dir)

    defaults = {
        "foldseek": _align_engine,
        "foldmason": _msa_engine_foldmason,
        "mafft": _msa_engine_mafft,
        "mafft-linsi": _msa_engine_linsi,
        "iqtree": _tree_iqtree,
        "fasttree": _tree_fasttree,
        "raxml-ng": _tree_raxml,
        "prostt5": _prostt5,
    }
    for k, v in defaults.items():
        _FACTORIES.setdefault(k, v)


_register_defaults()
