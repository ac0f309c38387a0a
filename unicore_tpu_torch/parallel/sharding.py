"""Sharded ProstT5 inference.

Counterpart of unicore_tpu/parallel/sharding.py's `make_sharded_predict`,
data-parallel only: the batch goes over the mesh's "dp" axis, and each
distinct device holds one replica of the encoder and the head (a logical
mesh of several shards on one card holds one).  Tensor and sequence
parallelism (tp > 1: `param_pspecs`, `shard_params`) and the training
step (`loss_fn`, `make_train_step`) are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from unicore_tpu_torch.parallel.mesh import Mesh, gather, shard, shard_devices


def make_sharded_predict(cfg, model, mesh: Mesh) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """run(tokens (B, L), mask (B, L)) -> (B, L) 3Di codes on the host,
    the rows split over the mesh's "dp" axis (B a multiple of its size),
    each block through `predict_3di_codes` on its device's replica of
    `model` (a models.prostt5.ProstT5 of config `cfg`)."""
    from unicore_tpu_torch.models.prostt5 import build_model, predict_3di_codes

    tp = mesh.shape.get("tp", 1)
    if tp > 1:
        raise NotImplementedError(
            f"sharded ProstT5 with tp = {tp}: tensor and sequence parallelism "
            "(parallel/sharding.py param_pspecs, shard_params) are the next slice of the port; "
            "use a mesh with tp = 1")
    devices = shard_devices(mesh)
    replicas: Dict[torch.device, torch.nn.Module] = {next(model.parameters()).device: model}
    for dev in devices:
        if dev not in replicas:
            replicas[dev] = build_model(cfg, model.state_dict(), dev)

    def run(tokens: np.ndarray, mask: np.ndarray) -> np.ndarray:
        toks = shard(tokens, devices, torch.int64)
        masks = shard(mask, devices, torch.bool)
        outs = [predict_3di_codes(replicas[d], t, m) for d, t, m in zip(devices, toks, masks)]
        return gather(outs).numpy()

    return run
