"""Hand a JAX engine's state over to the port.

The slice has no model weights; what an alignment engine carries is its
two substitution matrices and its AlignParams.  `from_jax_arrays` takes
them as the JAX engine holds them (numpy arrays and the dataclass, or a
dict of its fields) and returns the keyword arguments of the port's
AlignmentEngine, so both engines score with the same tables:

    AlignmentEngine(**from_jax_arrays(jax_eng.saa, jax_eng.s3d, jax_eng.params),
                    device="cpu")

Fields the port has no use for (the JAX engine's `backend`) are dropped.
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
