"""Hand a JAX engine's state over to the port.

What an alignment engine carries is its two substitution matrices and
its AlignParams.  `from_jax_arrays` takes
them as the JAX engine holds them (numpy arrays and the dataclass, or a
dict of its fields) and returns the keyword arguments of the port's
AlignmentEngine, so both engines score with the same tables:

    AlignmentEngine(**from_jax_arrays(jax_eng.saa, jax_eng.s3d, jax_eng.params),
                    device="cpu")

Fields the port has no use for (the JAX engine's `backend`) are dropped.

A ProstT5 engine carries its parameter tree.  `prostt5_from_jax` takes
it as JAX holds it (`embed`, `rel_bias`, `final_ln`, `layers[i]` with
`q/k/v/o`, `wi` or `wi0/wi1`, `wo`, `ln1/ln2`, and `cnn.w1/b1/w2/b2`;
numpy or JAX arrays) and returns the port's state, so both models
compute with the same weights:

    build_model(cfg, prostt5_from_jax(jax_eng.params), "cpu")

`prostt5_to_jax` goes the other way, from a state, a ProstT5 or a model
sharded over a mesh (parallel/sharding.py, read back by `gather_state`),
to JAX's tree of numpy float32 arrays: trained parameters, or gradients
given as a state (`gather_state(model, grad=True)`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Union

import numpy as np

from unicore_tpu_torch.align.engine import AlignParams


def from_jax_arrays(saa, s3d, params: Union[Mapping[str, Any], Any]) -> Dict[str, Any]:
    fields = dict(params) if isinstance(params, Mapping) else dataclasses.asdict(params)
    names = {f.name for f in dataclasses.fields(AlignParams)}
    return {
        "saa": np.asarray(saa, dtype=np.float32),
        "s3d": np.asarray(s3d, dtype=np.float32),
        "params": AlignParams(**{k: v for k, v in fields.items() if k in names}),
    }


def prostt5_from_jax(params: Mapping[str, Any]):
    """JAX's ProstT5 parameter tree as the port's state (models/prostt5.py
    names and layout), bfloat16 where the tree's leaves are bfloat16,
    else float32 (bf16 leaves widen to float32 exactly on the way)."""
    import torch

    from unicore_tpu_torch.models.prostt5 import state_from_tree

    def leaf(a):
        return np.asarray(np.asarray(a), dtype=np.float32)

    dtype = torch.bfloat16 if np.asarray(params["embed"]).dtype.name == "bfloat16" else torch.float32
    tree = {k: leaf(params[k]) for k in ("embed", "rel_bias", "final_ln")}
    tree["layers"] = [{k: leaf(v) for k, v in layer.items()} for layer in params["layers"]]
    tree["cnn"] = {k: leaf(v) for k, v in params["cnn"].items()}
    return state_from_tree(tree, dtype)


def prostt5_to_jax(model) -> Dict[str, Any]:
    """The port's ProstT5 parameters as JAX's tree (numpy float32, JAX's
    (in, out) and (K, in, out) layouts) from a state, a
    models/prostt5.py::ProstT5 or a parallel/sharding.py::ShardedProstT5."""
    from unicore_tpu_torch.parallel.sharding import ShardedProstT5, gather_state

    if isinstance(model, ShardedProstT5):
        state = gather_state(model)
    elif hasattr(model, "state_dict"):
        state = model.state_dict()
    else:
        state = model

    def a(name):
        return state[name].detach().float().cpu().numpy()

    layers: Dict[int, Dict[str, np.ndarray]] = {}
    for name in state:
        parts = name.split(".")
        if parts[:2] == ["encoder", "blocks"]:
            x = a(name)
            layers.setdefault(int(parts[2]), {})[parts[3]] = x if x.ndim == 1 else np.ascontiguousarray(x.T)
    return {
        "embed": a("encoder.embed.weight"), "rel_bias": a("encoder.rel_bias.weight"),
        "final_ln": a("encoder.final_ln.weight"),
        "layers": [layers[i] for i in sorted(layers)],
        "cnn": {"w1": np.ascontiguousarray(a("head.conv1.weight").transpose(2, 1, 0)), "b1": a("head.conv1.bias"),
                "w2": np.ascontiguousarray(a("head.conv2.weight").transpose(2, 1, 0)), "b2": a("head.conv2.bias")},
    }
