"""config — engine availability checks and overrides.

Counterpart of unicore_tpu/modules/config.py.  The reference validates
external binary paths (modules/config.rs:11-79); here engines are
in-process, so `--check` reports the device (CUDA availability, the
device count and each device's name, where the JAX package prints
`jax.devices()`) and probes each engine end-to-end on tiny inputs on the
device runtime/device.py resolves; `--set-X` records an override in the
port's own engines.cfg (registry.locate_engines_cfg(), else
~/.unicore_tpu_torch/engines.cfg; value "builtin" resets to the default,
any other value is an importable "module:attr" factory path).
"""

from __future__ import annotations

import os

from unicore_tpu_torch.runtime import errors as err
from unicore_tpu_torch.runtime import logging as msg
from unicore_tpu_torch.runtime import registry

_CHECKABLE = (
    "foldseek", "foldmason", "mafft", "mafft-linsi",
    "iqtree", "fasttree", "raxml-ng", "mmseqs",
)


def task_check() -> None:
    import torch

    from unicore_tpu_torch.runtime import device as device_mod

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    try:
        where = device_mod.resolve().type
    except err.UnicoreError:  # CUDA asked for, and there is none
        where = "none"
    msg.println_message("Device status:", 3)
    msg.println_message(f"  cuda available: {torch.cuda.is_available()}, devices: {n}, "
                        f"engines run on: {where}", 3)
    for i in range(n):
        msg.println_message(f"    cuda:{i} {torch.cuda.get_device_name(i)}", 3)
    msg.println_message("Engine status:", 3)
    for name in _CHECKABLE:
        if not registry.has(name) and registry.get_override(name) in (None, "builtin"):
            msg.println_message(f"  {name}: no", 3)
            continue
        if name == "mmseqs":
            msg.println_message(f"  {name}: n/a (never invoked; parity slot)", 3)
            continue
        try:
            engine = registry.get(name)()
            ok = engine.probe() if hasattr(engine, "probe") else True
            msg.println_message(f"  {name}: {'ok' if ok else 'no'} ({getattr(engine, 'name', '?')})", 3)
        except (Exception, err.UnicoreError) as e:  # noqa: BLE001 - report, don't crash the check
            msg.println_message(f"  {name}: no ({e})", 3)


def set_engine(name: str, value: str) -> None:
    cfg = registry.locate_engines_cfg()
    if cfg is None:
        cfg = os.path.expanduser("~/.unicore_tpu_torch/engines.cfg")
    os.makedirs(os.path.dirname(os.path.abspath(cfg)), exist_ok=True)
    entries = {}
    if os.path.isfile(cfg):
        with open(cfg) as f:
            for line in f:
                line = line.strip()
                if line and not line.startswith("#") and "=" in line:
                    k, v = line.split("=", 1)
                    entries[k.strip()] = v.strip()
    if value != "builtin":
        mod_path = value.split(":")[0]
        try:
            __import__(mod_path)
        except ImportError:
            err.error(err.ERR_GENERAL, f"Cannot import engine override module: {mod_path}")
        entries[name] = value
    else:
        entries.pop(name, None)
    with open(cfg, "w") as f:
        f.write("# unicore-tpu-torch engine overrides (name=module:attr or omit for builtin)\n")
        for k in _CHECKABLE:
            if k in entries:
                f.write(f"{k}={entries[k]}\n")
            else:
                f.write(f"# {k}=builtin\n")
    msg.println_message(f"Engine '{name}' set to {value} in {cfg}", 3)


def run(args) -> None:
    if getattr(args, "config_check", False):
        task_check()
        return
    did = False
    for name in _CHECKABLE:
        attr = "config_set_" + name.replace("-", "_")
        val = getattr(args, attr, None)
        if val:
            set_engine(name, val)
            did = True
    if not did:
        msg.println_message("Nothing to do (use --check or --set-<engine>)", 2)
