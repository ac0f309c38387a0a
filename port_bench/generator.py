"""The one traffic generator: proteome calls drawn from a seed.

A call is one list of proteins, as `createdb` hands a proteome to the
engine.  Its lengths are the length law's quantiles (i + 0.5) / n of
i = 0 .. n - 1: every call of every seed holds the same set of lengths,
so a seed changes their order and the residues, never the work.  The
residues are drawn from the traffic's composition.  The law and the
proteins a call are the configuration's `deployment`.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, List

import numpy as np

SEED_MOD = 1 << 63


def mix(cfg: Dict, traffic: Dict) -> Dict:
    """The length law, the proteins a call and the composition of a cell."""
    dep = cfg["deployment"]
    return {"length_law": dep["length_law"], "proteins_per_call": int(dep["proteins_per_call"]),
            "composition": traffic["composition"]}


def law_lengths(law: Dict, n: int) -> np.ndarray:
    """(n,) int lengths at the law's quantiles (i + 0.5) / n, ascending."""
    if law["kind"] != "lognormal":
        raise ValueError(f"unknown length law {law['kind']!r}")
    nd = NormalDist()
    mu, sigma = math.log(law["median"]), law["sigma"]
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    lengths = np.rint(np.exp(mu + sigma * z)).astype(np.int64)
    return np.clip(lengths, law["min"], law["max"])


def seed_key(seed: int) -> int:
    return int(seed) % SEED_MOD


def draw_call(m: Dict, seed: int, index: int) -> List[str]:
    """Call `index` of `seed`: the law's lengths in an order drawn from
    the seed and residues drawn from the composition."""
    rng = np.random.default_rng([seed_key(seed), index & 0xFFFFFFFF, 0x5EED])
    lengths = law_lengths(m["length_law"], m["proteins_per_call"])
    lengths = lengths[rng.permutation(len(lengths))]
    letters = sorted(m["composition"])
    p = np.array([m["composition"][c] for c in letters], np.float64)
    codes = rng.choice(len(letters), size=int(lengths.sum()), p=p / p.sum())
    text = np.frombuffer("".join(letters).encode(), np.uint8)[codes].tobytes().decode()
    ends = np.cumsum(lengths)
    return [text[e - n : e] for e, n in zip(ends.tolist(), lengths.tolist())]
