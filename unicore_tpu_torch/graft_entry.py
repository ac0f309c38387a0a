"""Entry points of the port's flagship model and its multi-device dry run.

Counterpart of the JAX package's `__graft_entry__.py`:

* entry() — the forward step of ProstT5 (encoder + CNN head predicting
  3Di codes) at T5Config.small(), with its inputs.
* dryrun_multichip(n) — an n-device (dp, tp) mesh, one step of the sharded
  training step (dp batch sharding, tp weight sharding over d_ff and the
  heads, sp sequence sharding between the encoder and the head) on small
  shapes, sharded inference against one device, then the sharded SW,
  banded SW, NW and likelihood/UFBoot batches against one device.

Both run on the card unless the caller passes CPU devices:

    python -m unicore_tpu_torch.graft_entry          # entry() on the card
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

TIE_RTOL = 1e-5  # float32 3Di codes may differ only where the top two logits are this close (of max|logit|)


def entry(device=None):
    """(fn, (model, tokens, mask)): fn gives the (8, 256) 3Di codes of a
    seeded bf16 T5Config.small() model on `device` (default: the card)."""
    from unicore_tpu_torch.models.prostt5 import T5Config, build_model, init_params, predict_3di_codes
    from unicore_tpu_torch.runtime import device as device_mod

    dev = device_mod.resolve(device)
    cfg = T5Config.small()
    model = build_model(cfg, init_params(cfg, seed=0), dev)
    B, L = 8, 256
    rng = np.random.RandomState(0)
    tokens = torch.as_tensor(rng.randint(0, 20, size=(B, L)), device=dev)
    mask = torch.ones((B, L), dtype=torch.bool, device=dev)

    def fn(model, tokens, mask):
        return predict_3di_codes(model, tokens, mask)

    return fn, (model, tokens, mask)


def same_codes(ref: np.ndarray, got: np.ndarray, logits: np.ndarray, what: str) -> int:
    """Raise unless 3Di codes `got` equal `ref` wherever the reference's
    `logits` have a top-two gap of at least TIE_RTOL of max|logit|;
    returns the number of codes that differ (on ties)."""
    diff = ref != got
    top = np.sort(np.asarray(logits, np.float64)[diff], axis=-1)
    gaps = top[:, -1] - top[:, -2]
    if np.any(gaps >= TIE_RTOL * np.abs(logits).max()):
        raise AssertionError(f"{what}: {int(diff.sum())} codes differ, not all on ties (gaps {gaps})")
    return int(diff.sum())


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> Dict[str, float]:
    """The JAX dry run's checks on the first `n_devices` of `devices`
    (default: the cards; a device may repeat: a logical mesh).  Raises at
    the first disagreement; returns the train step's loss, dp and tp."""
    from unicore_tpu_torch.models.prostt5 import T5Config, build_model, init_params, residue_logits
    from unicore_tpu_torch.parallel import mesh as mesh_mod
    from unicore_tpu_torch.parallel.sharding import (
        gather_state, make_sharded_predict, make_train_step, shard_params,
    )

    cfg = T5Config(d_model=128, d_kv=16, n_heads=8, d_ff=256, n_layers=2)
    # tp must divide the sharded weight dims (heads=8, d_ff=256): use the
    # largest power of two <= 8 dividing n_devices; the rest is dp
    tp = 1
    while tp * 2 <= 8 and n_devices % (tp * 2) == 0:
        tp *= 2
    dp = n_devices // tp
    mesh = mesh_mod.make_mesh(n_devices, dp=dp, tp=tp, devices=devices)
    devs = list(mesh.devices.flat)

    model = shard_params(init_params(cfg, seed=0, dtype=torch.float32), mesh)
    step, init_opt = make_train_step(cfg, mesh, lr=1e-3)
    opt = init_opt(model)
    B, L = dp * 8, 128
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 20, (B, L)).astype(np.int32)
    mask = np.ones((B, L), bool)
    labels = rng.randint(0, 20, (B, L)).astype(np.int32)
    loss = step(model, opt, tokens, mask, labels)
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    print(f"dryrun_multichip ok: mesh dp={dp} tp={tp}, loss={loss:.4f}")

    # ---- sharded ProstT5 inference == single-device inference ----
    single = build_model(cfg, gather_state(model), devs[0])
    codes_sharded = make_sharded_predict(cfg, model, mesh)(tokens, mask)
    tt, mt = torch.as_tensor(tokens, device=devs[0]), torch.as_tensor(mask, device=devs[0])
    logits = residue_logits(single, tt, mt).cpu().numpy()
    n_ties = same_codes(logits.argmax(-1), codes_sharded, logits, "sharded ProstT5")
    print(f"dryrun_multichip ok: ProstT5 inference sharded over dp={dp} tp={tp} "
          f"matches single-device ({codes_sharded.shape}, {n_ties} codes on ties)")

    _dryrun_alignment(devs)
    return {"loss": loss, "dp": dp, "tp": tp}


def _dryrun_alignment(devs) -> None:
    """The dry run's second half: SW, banded SW, NW and the likelihood /
    UFBoot batch sharded over a 1-D mesh of `devs` against one call on
    devs[0], with the JAX dry run's inputs."""
    from unicore_tpu_torch.matrices import BLOSUM62, default_3di_matrix
    from unicore_tpu_torch.ops.banded import sw_forward_banded, sw_forward_banded_sharded, vote_diagonal
    from unicore_tpu_torch.ops.nw_device import nw_forward_bits, nw_forward_bits_sharded
    from unicore_tpu_torch.ops.sw_cuda import sw_forward_cuda, sw_forward_sharded
    from unicore_tpu_torch.parallel.mesh import Mesh
    from unicore_tpu_torch.phylo.bootstrap import bootstrap_weights
    from unicore_tpu_torch.phylo.likelihood import LikelihoodEngine, make_root_binary, tree_to_arrays
    from unicore_tpu_torch.phylo.models import ModelSpec, SubstModel
    from unicore_tpu_torch.phylo.newick import Node

    n = len(devs)
    dev = devs[0]
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    mesh1d = Mesh(arr, ("dp",))

    def on(*xs):
        return [torch.as_tensor(x, device=dev) for x in xs]

    def equal(got, ref, what):
        for a, b in zip(got, ref):
            if not torch.equal(a.cpu(), b.cpu()):
                raise AssertionError(f"{what} mismatch")

    # ---- sharded SW over a 1-D all-device mesh == single-device ----
    rng = np.random.RandomState(1)
    B, L = n * 16, 128
    qa, qs, ta, ts = (rng.randint(0, 20, (B, L)).astype(np.int32) for _ in range(4))
    ln = np.full(B, L, np.int32)
    saa = BLOSUM62.astype(np.float32)
    s3d = default_3di_matrix().astype(np.float32)
    equal(sw_forward_sharded(qa, qs, ta, ts, ln, ln, saa, s3d, mesh1d, gap_window=64),
          sw_forward_cuda(*on(qa, qs, ta, ts, ln, ln, saa, s3d), gap_window=64), "sharded SW")
    print(f"dryrun_multichip ok: SW sharded over {n} devices matches single-device ({B} pairs)")

    # ---- sharded banded SW (long-pair path) == single-device ----
    d0 = np.zeros(B, np.int32)
    for i in range(B):  # plant homology so the voter has diagonals
        ta[i, 20:120] = qa[i, :100]
        ts[i, 20:120] = qs[i, :100]
        d0[i] = vote_diagonal(qa[i], qs[i], ta[i], ts[i]) or 0
    equal(sw_forward_banded_sharded(qa, qs, ta, ts, ln, ln, d0, saa, s3d, mesh1d, W=128, gap_window=64),
          sw_forward_banded(*on(qa, qs, ta, ts, ln, ln, d0, saa, s3d), W=128, gap_window=64),
          "sharded banded SW")
    print(f"dryrun_multichip ok: banded SW sharded over {n} devices matches single-device ({B} long pairs)")

    # ---- sharded MSA merge round (batched profile-profile NW) ----
    Bn, Ln = n * 4, 64
    Sn = rng.randint(-40, 60, (Bn, Ln, Ln)).astype(np.int16)
    n1 = rng.randint(8, Ln + 1, Bn).astype(np.int32)
    n2 = rng.randint(8, Ln + 1, Bn).astype(np.int32)
    equal(nw_forward_bits_sharded(Sn, n1, n2, 110, 30, mesh1d), nw_forward_bits(*on(Sn, n1, n2), 110, 30),
          "sharded NW")
    print(f"dryrun_multichip ok: MSA merge NW sharded over {n} devices matches single-device ({Bn} merges)")

    # ---- sharded likelihood topology batch + UFBoot scoring ----
    AAs = "ARNDCQEGHILKMFPSTWYV"
    base = rng.choice(list(AAs), 60)
    seqs = []
    for _ in range(6):
        s = base.copy()
        pos = rng.choice(60, 15, replace=False)
        s[pos] = rng.choice(list(AAs), len(pos))
        seqs.append("".join(s))
    names = [f"t{i}" for i in range(6)]
    eng = LikelihoodEngine(names, seqs, SubstModel.build(ModelSpec.parse("JTT+G")), device=dev)
    cbs, bbs = [], []
    for _ in range(n * 2):
        order = list(names)
        rng.shuffle(order)
        nodes = [Node(name=nm) for nm in order]
        while len(nodes) > 1:
            a = nodes.pop(rng.randint(len(nodes)))
            c = nodes.pop(rng.randint(len(nodes)))
            p = Node()
            p.add(a)
            p.add(c)
            a.length = c.length = 0.1
            nodes.append(p)
        cb, bb = tree_to_arrays(make_root_binary(nodes[0]), names)
        cbs.append(cb)
        bbs.append(bb)
    cb, bb = np.stack(cbs), np.stack(bbs)
    for fn in ("loglik_batch", "site_loglik_batch"):
        ref, got = getattr(eng, fn)(cb, bb, mesh=False), getattr(eng, fn)(cb, bb, mesh=mesh1d)
        if not np.allclose(ref, got, rtol=2e-5, atol=1e-3):
            raise AssertionError(f"sharded {fn} mismatch")
    W = bootstrap_weights(np.asarray(eng.weights, np.float64), 64)
    if not (np.argmax(ref.astype(np.float64) @ W, 0) == np.argmax(got.astype(np.float64) @ W, 0)).all():
        raise AssertionError("UFBoot replicate winners diverge")
    print(f"dryrun_multichip ok: likelihood/UFBoot batch sharded over {n} devices matches single-device "
          f"({cb.shape[0]} topologies, 64 replicates)")


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", tuple(out.shape))
