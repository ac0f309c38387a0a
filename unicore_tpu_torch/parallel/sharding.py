"""ProstT5 over a mesh: the sharding rules, the training step and sharded
inference.

Counterpart of unicore_tpu/parallel/sharding.py.  Data parallelism (dp)
splits the batch over the mesh's "dp" axis; tensor parallelism (tp) splits
the attention heads and d_ff over its "tp" axis, Megatron style; sequence
parallelism (sp) splits the hidden states along the sequence over "tp"
between the encoder and the CNN head.

The mesh is parallel/mesh.py's single-process `Mesh` of torch devices, as
JAX's dry run runs one process over n devices: one program drives every
shard, and a logical mesh (one card named several times) runs them one
after another on that card.  `shard_params` gives a `ShardedProstT5`:

  * q, k, v, wi, wi0 and wi1 are column-parallel (rows of the (out, in)
    torch weight are split; JAX's P(None, "tp") on its (in, out) arrays),
    o and wo row-parallel (columns split), one leaf per tp slice on the
    devices of the mesh's first dp row;
  * the embedding, rel_bias, the RMSNorms and the head are replicated, one
    leaf on the mesh's first device; each tp shard reads its heads'
    columns of rel_bias.

Other devices along "dp" use copies of these leaves made in each forward
with `.to(device)`, which autograd differentiates, so the dp replicas'
gradients sum into the one leaf (a copy to the same device is the leaf
itself: on a logical mesh there are none).  In each dp group the
replicated work (embedding, RMSNorms, residual adds) runs on the group's
first device; each sublayer's normed input goes to every tp device, each
computes its slice's share of the output (attention over its head group,
or its d_ff slice of the FFN), and the shares are summed on the first
device (the all-reduce).  The head runs on sequence shards, each with the
halo rows its two kernel-7 convolutions need from its neighbours.

Across torch.distributed ranks, one process per device of the mesh as in
JAX after `jax.distributed.initialize`, `shard_params(state, pmesh)` of a
parallel/mesh.py `ProcessMesh` gives a `RankShardedProstT5`: each rank
holds its own tp slice of the split tensors and the replicated ones, its
block of the batch's rows and its sequence block of the head, and the
sums become parallel/collectives.py's collectives (GRAD_REDUCE says
over which ranks each leaf's gradient is summed after the backward).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from unicore_tpu_torch.parallel import collectives as C
from unicore_tpu_torch.parallel.mesh import Mesh, ProcessMesh, gather, shard, shard_devices

COLUMN_PARALLEL = ("q", "k", "v", "wi", "wi0", "wi1")
ROW_PARALLEL = ("o", "wo")


def _layer_name(name: str) -> Optional[str]:
    """`q` of "encoder.blocks.3.q.weight"; None outside the blocks."""
    parts = name.split(".")
    return parts[3] if parts[:2] == ["encoder", "blocks"] else None


def param_pspecs(state: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
    """{state name: spec} of a ProstT5 state (models/prostt5.py names, HF
    (out, in) layout), one entry per tensor dimension as in JAX's
    PartitionSpec: ("tp", None) splits the rows over the mesh's "tp" axis
    (column-parallel), (None, "tp") the columns (row-parallel), () is
    replicated."""
    specs = {}
    for name in state:
        layer = _layer_name(name)
        specs[name] = (("tp", None) if layer in COLUMN_PARALLEL
                       else (None, "tp") if layer in ROW_PARALLEL else ())
    return specs


def _geometry(state: Dict[str, torch.Tensor], tp: int):
    """(n_layers, gated, n_heads) of a ProstT5 state; raises where tp does
    not divide n_heads or d_ff."""
    n_layers = len({n.split(".")[2] for n in state if _layer_name(n)})
    n_heads = state["encoder.rel_bias.weight"].shape[1]
    d_ff = state["encoder.blocks.0.wo.weight"].shape[1] if n_layers else 0
    if n_heads % tp or d_ff % tp:
        raise ValueError(f"tp = {tp} must divide n_heads ({n_heads}) and d_ff ({d_ff})")
    return n_layers, "encoder.blocks.0.wi0.weight" in state, n_heads


def _key(name: str) -> str:
    return name.replace(".", "/")


def _leaf(t: torch.Tensor, device) -> nn.Parameter:
    """A contiguous copy of `t` on `device`, never sharing the caller's
    storage (the optimizer updates leaves in place)."""
    return nn.Parameter(t.detach().to(device, memory_format=torch.contiguous_format, copy=True))


class ShardedProstT5(nn.Module):
    """A ProstT5 state split over a (dp, tp) mesh (`shard_params`): the
    leaves are parameters (float32 ones train), one per tp slice of each
    split tensor and one per replicated tensor."""

    def __init__(self, state: Dict[str, torch.Tensor], mesh: Mesh):
        super().__init__()
        devs = mesh.devices.reshape(mesh.devices.shape[0], -1)
        self.mesh, self.devs = mesh, devs
        self.dp, self.tp = devs.shape
        self.n_layers, self.gated, _ = _geometry(state, self.tp)
        self.specs = param_pspecs(state)
        self.replicated = nn.ParameterDict()
        self.slices = nn.ModuleList(nn.ParameterDict() for _ in range(self.tp))
        for name, t in state.items():
            spec = self.specs[name]
            if not spec:
                self.replicated[_key(name)] = _leaf(t, devs[0, 0])
                continue
            for k, part in enumerate(t.detach().chunk(self.tp, spec.index("tp"))):
                self.slices[k][_key(name)] = _leaf(part, devs[0, k])

    # -- leaves on the devices of dp group d --------------------------------

    def rep(self, name: str, d: int) -> torch.Tensor:
        """Replicated tensor `name` on dp group d's first device."""
        return self.replicated[_key(name)].to(self.devs[d, 0])

    def part(self, name: str, d: int, t: int) -> torch.Tensor:
        """tp slice t of split tensor `name` on device (d, t)."""
        return self.slices[t][_key(name)].to(self.devs[d, t])

    def _tp_sum(self, parts: List[torch.Tensor], d: int) -> torch.Tensor:
        """The tp shards' shares summed on the group's first device."""
        home = self.devs[d, 0]
        acc = parts[0].to(home)
        for p in parts[1:]:
            acc = acc + p.to(home)
        return acc

    # -- forward of one dp group --------------------------------------------

    def encode(self, cfg, tokens: torch.Tensor, mask: torch.Tensor, d: int) -> torch.Tensor:
        """Hidden states (B_d, L, D) of dp group d's rows on its first
        device: models/prostt5.py's T5Encoder, every block's attention per
        head group and FFN per d_ff slice over the tp devices."""
        from unicore_tpu_torch.models import prostt5 as P

        tp, hs = self.tp, cfg.n_heads // self.tp
        x = F.embedding(tokens, self.rep("encoder.embed.weight", d))
        rel = self.rep("encoder.rel_bias.weight", d)
        bias_masks = [P.relative_bias_mask(rel[:, t * hs:(t + 1) * hs].to(self.devs[d, t]),
                                           mask.to(self.devs[d, t]), cfg) for t in range(tp)]
        ffn = ("wi0", "wi1") if self.gated else ("wi",)
        for i in range(self.n_layers):
            pre = f"encoder.blocks.{i}."
            h = P.rms_norm(x, self.rep(pre + "ln1.weight", d))
            x = x + self._tp_sum([P.self_attention(
                h.to(self.devs[d, t]), *(self.part(pre + n + ".weight", d, t) for n in ("q", "k", "v", "o")),
                cfg.d_kv, bias_masks[t]) for t in range(tp)], d)
            h = P.rms_norm(x, self.rep(pre + "ln2.weight", d))
            x = x + self._tp_sum([P.feed_forward(
                h.to(self.devs[d, t]), [self.part(pre + n + ".weight", d, t) for n in ffn],
                self.part(pre + "wo.weight", d, t)) for t in range(tp)], d)
        return P.rms_norm(x, self.rep("encoder.final_ln.weight", d))

    def head(self, h: torch.Tensor, d: int, res_mask: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """Sequence-parallel CNN head of dp group d's hidden states h (B_d,
        L, D): one (B_d, L / tp, n_classes) float32 block of logits per tp
        device, sequence block t on device (d, t).  Equal to
        models/prostt5.py's CNNHead on the whole sequence (with `res_mask`
        as there): each block reads its rows of h with 2 r halo rows on
        each side (r = kernel // 2; two convolutions), zero beyond the
        ends of the sequence, and zeroes the first convolution's output at
        positions outside [0, L) (and off the residues), where the whole
        sequence's second convolution reads zero padding."""
        w = [self.rep(f"head.conv{c}.{p}", d) for c in (1, 2) for p in ("weight", "bias")]
        h, m, n = _pad_for_head(h, res_mask, self.tp, w[0].shape[2] // 2)
        return [_head_block(h, m, t, n, w, self.devs[d, t]) for t in range(self.tp)]

    def _groups(self, tokens, mask):
        devs = shard_devices(self.mesh)
        return shard(tokens, devs, torch.int64), shard(mask, devs, torch.bool)

    def nll_sum(self, cfg, tokens, mask, labels) -> torch.Tensor:
        """Σ nll · mask over the whole batch, on the mesh's first device:
        each dp group's rows through `encode` and `head`, and each
        sequence block's masked NLL summed where it was computed."""
        toks, masks = self._groups(tokens, mask)
        labs = shard(labels, shard_devices(self.mesh), torch.int64)
        sums = []
        for d in range(self.dp):
            h = self.encode(cfg, toks[d], masks[d], d)
            n = h.shape[1] // self.tp
            for t, lg in enumerate(self.head(h, d)):
                dev, cols = self.devs[d, t], slice(t * n, (t + 1) * n)
                sums.append(_nll(lg, labs[d][:, cols].to(dev), masks[d][:, cols].to(dev)))
        return self._tp_sum(sums, 0)

    def residue_logits(self, cfg, tokens, mask) -> torch.Tensor:
        """models/prostt5.py::residue_logits over the mesh: (B, L,
        n_classes) float32 on the mesh's first device."""
        from unicore_tpu_torch.models.prostt5 import TOK_PREFIX

        toks, masks = self._groups(tokens, mask)
        rows = []
        for d in range(self.dp):
            h = self.encode(cfg, toks[d], masks[d], d)
            blocks = self.head(h, d, (toks[d] < TOK_PREFIX) & masks[d])
            rows.append(torch.cat([b.to(self.devs[d, 0]) for b in blocks], dim=1))
        return gather(rows, self.devs[0, 0])


def _pad_for_head(h: torch.Tensor, res_mask: Optional[torch.Tensor], tp: int, r: int):
    """(h, mask, n): the hidden states h (B, L, D) as float32 and the
    (B, L) float32 residue mask (ones where `res_mask` is None), each
    padded with 2 r zero rows at both ends of the sequence (r = the
    head's kernel // 2; two convolutions), and the block length n = L /
    tp.  Raises where tp does not divide L."""
    B, L, _ = h.shape
    if L % tp:
        raise ValueError(f"sequence parallelism: L = {L} is not a multiple of tp = {tp}")
    m = torch.ones(B, L, device=h.device) if res_mask is None else res_mask.float()
    return F.pad(h.float(), (0, 0, 2 * r, 2 * r)), F.pad(m, (2 * r, 2 * r)), L // tp


def _head_block(hp, mp, t: int, n: int, w, dev) -> torch.Tensor:
    """(B, n, n_classes) float32 logits of sequence block t (positions t n
    .. (t + 1) n) of the padded `hp`, `mp` (_pad_for_head) through the
    head's (w1, b1, w2, b2) on `dev`: the block's rows with 2 r halo rows
    on each side, zero beyond the ends of the sequence, and conv1's
    output zeroed at positions outside [0, L) (and off the residues),
    where the whole sequence's conv2 reads zero padding."""
    w1, b1, w2, b2 = (x.to(dev).float() for x in w)
    r = w1.shape[2] // 2
    win = slice(t * n, (t + 1) * n + 4 * r)  # positions t n - 2r .. (t + 1) n + 2r
    y = hp[:, win].to(dev).transpose(1, 2)
    mt = mp[:, win].to(dev)[:, None, :]
    y = torch.relu(F.conv1d(y * mt, w1, b1))
    y = F.conv1d(y * mt[..., r:-r], w2, b2)
    return y.transpose(1, 2)


def _nll(logits, labels, mask) -> torch.Tensor:
    """Σ nll · mask of float32 logits (JAX's log_softmax and take_along_axis)."""
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, labels[..., None])[..., 0]
    return (nll * mask.float()).sum()


# Over which ranks each leaf's gradient is summed after the backward of a
# RankShardedProstT5, keyed by the leaf names of param_pspecs (_leaf_name):
#   * "dp": a split leaf (its rank's slice), or a replicated leaf whose
#     gradient each rank of a tp group already holds whole (to_group's
#     backward sums the tp ranks' parts of every gradient that enters the
#     replicated residual stream, from_group's passes it on as it is):
#     summed over the dp group, the batch's blocks;
#   * "world": a replicated leaf each tp rank sees only part of: rel_bias
#     (each rank's heads' columns) and the head's convolutions (each
#     rank's sequence block): summed over every rank.
GRAD_REDUCE = {
    "q": "dp", "k": "dp", "v": "dp", "o": "dp",
    "wi": "dp", "wi0": "dp", "wi1": "dp", "wo": "dp",
    "embed": "dp", "ln1": "dp", "ln2": "dp", "final_ln": "dp",
    "rel_bias": "world", "conv1": "world", "conv2": "world",
}


def _leaf_name(name: str) -> str:
    """GRAD_REDUCE's key of a state name: `q` of
    "encoder.blocks.3.q.weight", `embed` of "encoder.embed.weight",
    `conv1` of "head.conv1.bias"."""
    return _layer_name(name) or name.split(".")[1]


class RankShardedProstT5(nn.Module):
    """This rank's part of a ProstT5 state over a ProcessMesh (`shard_params`
    with a parallel/mesh.py ProcessMesh): its tp slice of each split
    tensor (param_pspecs) and every replicated tensor, as parameters on
    the mesh's device.  Its forward takes the rank's block of rows (block
    d of B / dp) and, in the head, its sequence block t of L / tp;
    `reduce_grads` sums the gradients by GRAD_REDUCE."""

    def __init__(self, state: Dict[str, torch.Tensor], pmesh: ProcessMesh):
        super().__init__()
        self.mesh, self.tp, self.dp = pmesh, pmesh.tp, pmesh.dp
        self.n_layers, self.gated, self.n_heads = _geometry(state, self.tp)
        self.specs = param_pspecs(state)
        unknown = sorted({_leaf_name(n) for n in state} - GRAD_REDUCE.keys())
        if unknown:
            raise ValueError(f"no gradient reduction rule for {unknown}")
        self.leaves = nn.ParameterDict()
        for name, t in state.items():
            spec = self.specs[name]
            if spec:
                t = t.detach().chunk(self.tp, spec.index("tp"))[pmesh.t]
            self.leaves[_key(name)] = _leaf(t, pmesh.device)

    def leaf(self, name: str) -> nn.Parameter:
        return self.leaves[_key(name)]

    def _to_tp(self, x):
        return C.to_group(x, self.mesh.tp_group, self.mesh.host_comm)

    def _from_tp(self, x):
        return C.from_group(x, self.mesh.tp_group, self.mesh.host_comm)

    def block(self, x) -> torch.Tensor:
        """This rank's dp block (rows d B / dp .. (d + 1) B / dp) of x (B,
        ...) on the mesh's device."""
        t = torch.as_tensor(x)
        B = t.shape[0]
        if B % self.dp:
            raise ValueError(f"a batch of {B} rows does not split over {self.dp} shards; pad it first")
        b = B // self.dp
        return t[self.mesh.d * b:(self.mesh.d + 1) * b].to(self.mesh.device)

    def encode(self, cfg, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Hidden states (B_d, L, D) of this rank's rows, whole on every
        rank of its tp group: models/prostt5.py's T5Encoder, each block's
        attention over this rank's head group and its FFN over this
        rank's d_ff slice, the shares summed over the tp group."""
        from unicore_tpu_torch.models import prostt5 as P

        hs, t = self.n_heads // self.tp, self.mesh.t
        x = F.embedding(tokens, self.leaf("encoder.embed.weight"))
        rel = self.leaf("encoder.rel_bias.weight")[:, t * hs:(t + 1) * hs]
        bias_mask = P.relative_bias_mask(rel, mask, cfg)
        ffn = ("wi0", "wi1") if self.gated else ("wi",)
        for i in range(self.n_layers):
            pre = f"encoder.blocks.{i}."
            w = {n: self.leaf(pre + n + ".weight") for n in ("q", "k", "v", "o", "wo") + ffn}
            h = self._to_tp(P.rms_norm(x, self.leaf(pre + "ln1.weight")))
            x = x + self._from_tp(P.self_attention(h, w["q"], w["k"], w["v"], w["o"], cfg.d_kv, bias_mask))
            h = self._to_tp(P.rms_norm(x, self.leaf(pre + "ln2.weight")))
            x = x + self._from_tp(P.feed_forward(h, [w[n] for n in ffn], w["wo"]))
        return P.rms_norm(x, self.leaf("encoder.final_ln.weight"))

    def head(self, h: torch.Tensor, res_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B_d, L / tp, n_classes) float32 logits of this rank's sequence
        block t of the hidden states h (B_d, L, D), whole on every rank
        of its tp group (ShardedProstT5.head's block t); h enters through
        to_group, so each rank's backward sums every block's gradient."""
        w = [self.leaf(f"head.conv{c}.{p}") for c in (1, 2) for p in ("weight", "bias")]
        hp, mp, n = _pad_for_head(self._to_tp(h), res_mask, self.tp, w[0].shape[2] // 2)
        return _head_block(hp, mp, self.mesh.t, n, w, self.mesh.device)

    def loss(self, cfg, tokens, mask, labels) -> torch.Tensor:
        """JAX's loss_fn over the whole batch (B, L), the same 0-d tensor on
        every rank: this rank's Σ nll · m over its rows and sequence block,
        summed over the world by from_group (its backward is this rank's
        term's), over the world's Σ m (a constant)."""
        toks, msk, labs = self.block(tokens).long(), self.block(mask).bool(), self.block(labels).long()
        n = toks.shape[1] // self.tp
        cols = slice(self.mesh.t * n, (self.mesh.t + 1) * n)
        local = _nll(self.head(self.encode(cfg, toks, msk)), labs[:, cols], msk[:, cols])
        host = self.mesh.host_comm
        count = C.all_reduce(msk[:, cols].float().sum().reshape(1), None, host)[0]
        return C.from_group(local, None, host) / torch.clamp(count, min=1.0)

    def reduce_grads(self) -> None:
        """Sum each leaf's gradient over the ranks GRAD_REDUCE names, one
        all-reduce of the concatenated gradients per group (a leaf without
        a gradient takes zeros, so every rank sends the same sizes)."""
        for kind, group in (("dp", self.mesh.dp_group), ("world", None)):
            leaves = [self.leaf(n) for n in self.specs if GRAD_REDUCE[_leaf_name(n)] == kind]
            if not leaves or C.group_size(group) == 1:
                continue
            for p in leaves:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            flat = C.all_reduce(torch.cat([p.grad.reshape(-1) for p in leaves]), group, self.mesh.host_comm)
            for p, g in zip(leaves, flat.split([p.numel() for p in leaves])):
                p.grad.copy_(g.view_as(p))

    def residue_logits(self, cfg, tokens, mask) -> torch.Tensor:
        """models/prostt5.py::residue_logits over the process mesh: (B, L,
        n_classes) float32 on every rank, each rank's (B / dp, L / tp)
        block all-gathered."""
        from unicore_tpu_torch.models.prostt5 import TOK_PREFIX

        toks, msk = self.block(tokens).long(), self.block(mask).bool()
        lg = self.head(self.encode(cfg, toks, msk), (toks < TOK_PREFIX) & msk)
        host = self.mesh.host_comm
        rows = torch.cat(C.all_gather(lg.contiguous(), self.mesh.tp_group, host), dim=1)
        return torch.cat(C.all_gather(rows, self.mesh.dp_group, host), dim=0)


def shard_params(state: Dict[str, torch.Tensor], mesh: Union[Mesh, ProcessMesh]):
    """`state` (models/prostt5.py names) split over `mesh` by param_pspecs:
    a ShardedProstT5 over a one-process Mesh, this rank's
    RankShardedProstT5 over a ProcessMesh (every rank passes the whole
    state and keeps its part).  Raises where tp does not divide n_heads
    or d_ff."""
    if isinstance(mesh, ProcessMesh):
        return RankShardedProstT5(state, mesh)
    return ShardedProstT5(state, mesh)


def gather_state(sharded, grad: bool = False, names=None) -> Dict[str, torch.Tensor]:
    """A copy of the state of `sharded` on the host, its tp slices joined:
    every tensor, or those in `names` (with `grad`, the leaves' gradients
    instead; None where a leaf has none).  Of a RankShardedProstT5 every
    rank must call it: the slices are all-gathered over the tp group, and
    every rank gets the whole tensors (a split leaf's gradient after
    reduce_grads is the same on every rank of a dp group)."""
    out = {}
    for name, spec in sharded.specs.items():
        if names is not None and name not in names:
            continue
        if isinstance(sharded, RankShardedProstT5):
            x = sharded.leaf(name).grad if grad else sharded.leaf(name)
            if x is None:
                out[name] = None
                continue
            parts = C.all_gather(x, sharded.mesh.tp_group, sharded.mesh.host_comm) if spec else [x]
            parts = [p.detach().to("cpu", copy=True) for p in parts]
            out[name] = torch.cat(parts, dim=spec.index("tp")) if spec else parts[0]
            continue
        if spec:
            leaves = [sharded.slices[t][_key(name)] for t in range(sharded.tp)]
        else:
            leaves = [sharded.replicated[_key(name)]]
        parts = [leaf.grad if grad else leaf for leaf in leaves]
        if any(p is None for p in parts):
            out[name] = None
            continue
        parts = [p.detach().to("cpu", copy=True) for p in parts]
        out[name] = torch.cat(parts, dim=spec.index("tp")) if spec else parts[0]
    return out


def loss_fn(model, cfg, tokens, mask, labels) -> torch.Tensor:
    """JAX's loss_fn: the masked mean NLL of `labels` under the head's
    logits on every position (no residue mask), Σ nll · m / max(Σ m, 1)
    over the whole batch, as a 0-d float32 tensor that takes gradients.

    `model` is a trainable models/prostt5.py::ProstT5 (one device; the
    inputs go to its device), a ShardedProstT5 (its mesh: tokens, mask
    and labels (B, L), B a multiple of dp and L of tp) or a
    RankShardedProstT5 (every rank passes the whole batch and computes
    its block; the loss is the same on every rank, and each rank's
    backward gives its part of the gradients until reduce_grads)."""
    from unicore_tpu_torch.models.prostt5 import full_precision, train_logits

    with full_precision():
        if isinstance(model, RankShardedProstT5):
            return model.loss(cfg, tokens, mask, labels)
        if isinstance(model, ShardedProstT5):
            total = model.nll_sum(cfg, tokens, mask, labels)
            count = torch.as_tensor(mask).to(total.device).float().sum()
        else:
            dev = next(model.parameters()).device
            tokens, mask, labels = (torch.as_tensor(x).to(dev) for x in (tokens, mask, labels))
            total = _nll(train_logits(model, tokens.long(), mask.bool()), labels.long(), mask)
            count = mask.float().sum()
        return total / torch.clamp(count, min=1.0)


def make_train_step(cfg, mesh: Union[Mesh, ProcessMesh, None] = None, lr: float = 1e-4):
    """(step, init_opt), the counterpart of JAX's make_train_step.

    init_opt(model) -> the optimizer of a model from shard_params(...,
    mesh), or of a one-device trainable ProstT5 where `mesh` is None.
    step(model, opt, tokens, mask, labels) -> loss (a float): loss_fn,
    its backward and one Adam update, all under full_precision (float32
    products without TF32).  The update is torch.optim.Adam with betas
    (0.9, 0.999) and eps 1e-8, which computes optax.adam(lr)'s function:
    bias-corrected moments, p -= lr m̂ / (√v̂ + eps); after a step the
    leaves' .grad hold its gradients.

    Over a ProcessMesh every rank calls step on its RankShardedProstT5
    with the whole batch; between the backward and the update
    reduce_grads sums the gradients by GRAD_REDUCE, so the replicated
    leaves take identical updates on every rank."""

    from unicore_tpu_torch.models.prostt5 import full_precision

    def init_opt(model) -> torch.optim.Optimizer:
        return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def step(model, opt, tokens, mask, labels) -> float:
        if getattr(model, "mesh", None) is not mesh:
            raise ValueError("the model is not sharded over this train step's mesh")
        with full_precision():
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(model, cfg, tokens, mask, labels)
            loss.backward()
            if isinstance(model, RankShardedProstT5):
                model.reduce_grads()
            opt.step()
        return loss.item()

    return step, init_opt


def make_sharded_predict(cfg, model, mesh: Union[Mesh, ProcessMesh]) -> Callable[[np.ndarray, np.ndarray], np.ndarray]:
    """run(tokens (B, L), mask (B, L)) -> (B, L) 3Di codes on the host,
    the rows split over the mesh's "dp" axis (B a multiple of its size).

    With tp = 1 and a models/prostt5.py::ProstT5 `model`, each block goes
    through `predict_3di_codes` on its device's replica of the model (a
    logical mesh of several shards of one card holds one).  With tp > 1,
    or a ShardedProstT5 `model`, through the sharded encoder and the
    sequence-parallel head (L a multiple of tp), in the model's dtype.
    Over a ProcessMesh every rank calls run with the whole batch, computes
    its block through its RankShardedProstT5 (`model`, or this rank's
    part of a ProstT5's state) and returns every code, as JAX's predict
    does on a mesh that spans processes."""
    from unicore_tpu_torch.models.prostt5 import build_model, full_precision, predict_3di_codes

    tp = mesh.shape.get("tp", 1)
    if tp > 1 or isinstance(mesh, ProcessMesh) or isinstance(model, (ShardedProstT5, RankShardedProstT5)):
        sharded = (model if isinstance(model, (ShardedProstT5, RankShardedProstT5))
                   else shard_params(model.state_dict(), mesh))

        def run_sharded(tokens: np.ndarray, mask: np.ndarray) -> np.ndarray:
            with full_precision(), torch.inference_mode():
                return torch.argmax(sharded.residue_logits(cfg, tokens, mask), dim=-1).cpu().numpy()

        return run_sharded

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
