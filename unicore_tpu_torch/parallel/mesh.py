"""Device meshes for the pipeline stages.

Counterpart of unicore_tpu/parallel/mesh.py.  A mesh is an array of
`torch.device`s with named axes:

  * "dp" — data parallel: sequence batches (ProstT5 inference, SW pair
    batches, NW merge batches, candidate topologies, gene batches)
  * "tp" — tensor parallel: ProstT5 weight shards over the heads and d_ff
    and sequence shards before its head (parallel/sharding.py)

A data-parallel function splits its batch along dim 0 into one block of
rows per device of the mesh's first axis (`shard`), runs the same
single-device function on every block, and joins the blocks again in
input order (`gather`).  Every shard is queued before any result is
read, so the devices of a multi-card mesh run side by side.  A mesh may
name one device several times (a logical mesh: four shards of
`cuda:0`); its shards then run one after another on that device, and it
holds one replica of what is replicated (`Replicas`).

`local_mesh` is the one place that decides whether the engines shard:
over every card when there is more than one and the caller runs on
CUDA, never on the CPU (the JAX package shards only over several
accelerator devices).

Multi-process: `initialize_distributed` brings up `torch.distributed`
from the JAX package's three environment variables; each rank then
holds its own shard of a batch and exchanges results through
collectives.  `process_mesh` is the counterpart of JAX's global mesh
after `jax.distributed.initialize`: one device per process, rank r at
(d, t) = divmod(r, tp) of a (dp, tp) mesh, with the tp and dp process
groups that parallel/collectives.py and parallel/sharding.py's
`RankShardedProstT5` reduce over.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


class Mesh:
    """An array of `torch.device`s with one name per axis, the attributes
    of `jax.sharding.Mesh` that the engines read: `devices` (an object
    array), `axis_names` and `shape` ({axis name: size})."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of {devices.ndim} axes, {len(axis_names)} names")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def factor_mesh(n: int, tp_max: int = 8) -> Tuple[int, int]:
    """Split n devices into (dp, tp): prefer the largest tp <= tp_max that
    divides n (keeps TP groups small/ICI-local, DP wide)."""
    tp = 1
    for cand in range(min(tp_max, n), 0, -1):
        if n % cand == 0:
            tp = cand
            break
    return n // tp, tp


def cuda_devices() -> List[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _device(d: DeviceLike) -> torch.device:
    """`d` as a torch.device, a card always with its index ("cuda" is the
    current card), so equal devices compare equal."""
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(
    n_devices: Optional[int] = None, dp: Optional[int] = None, tp: Optional[int] = None,
    devices: Optional[Sequence[DeviceLike]] = None,
) -> Mesh:
    """A (dp, tp) mesh over `devices` (default: every CUDA card), the
    first `n_devices` of them if given; (dp, tp) from factor_mesh unless
    both are given."""
    devs = [_device(d) for d in devices] if devices is not None else cuda_devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise RuntimeError("make_mesh: no devices (torch.cuda.device_count() is 0 and none were given)")
    n = len(devs)
    if dp is None or tp is None:
        dp, tp = factor_mesh(n)
    if dp * tp != n:
        raise ValueError(f"mesh {dp}x{tp} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(dp, tp), ("dp", "tp"))


def local_mesh(device: Optional[DeviceLike] = None) -> Optional[Mesh]:
    """A 1-D "dp" mesh over every card when there is more than one and
    `device` (where the caller runs) is a CUDA device; None otherwise."""
    if device is None or torch.device(device).type != "cuda" or torch.cuda.device_count() < 2:
        return None
    devs = cuda_devices()
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr, ("dp",))


def shard_devices(mesh: Mesh) -> List[torch.device]:
    """One device per block of the batch: the devices along the mesh's
    first axis (the first device of each group along the others)."""
    return list(mesh.devices.reshape(mesh.devices.shape[0], -1)[:, 0])


def n_shards(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else int(mesh.devices.shape[0])


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_rows(x, n: int, value=None):
    """`x` (an array or a tensor) with rows appended up to `n` rows:
    filled with `value`, or copies of row 0 when `value` is None."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    extra = n - x.shape[0]
    if extra <= 0:
        return x
    if isinstance(x, torch.Tensor):
        fill = (x[:1].expand(extra, *x.shape[1:]) if value is None
                else x.new_full((extra, *x.shape[1:]), value))
        return torch.cat([x, fill])
    fill = (np.repeat(x[:1], extra, 0) if value is None
            else np.full((extra, *x.shape[1:]), value, x.dtype))
    return np.concatenate([x, fill])


def shard(x, devices: Sequence[torch.device], dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """`x` (an array or a tensor) split along dim 0 into len(devices)
    equal blocks of rows, block k on devices[k].  Host memory is pinned
    where a block goes to a card, so the copies are asynchronous."""
    t = torch.as_tensor(x)
    if dtype is not None:
        t = t.to(dtype)
    n, B = len(devices), t.shape[0]
    if B % n:
        raise ValueError(f"a batch of {B} rows does not split over {n} shards; pad it first")
    to_card = any(d.type == "cuda" for d in devices)
    if t.device.type == "cpu" and to_card:
        t = t.contiguous().pin_memory()
    b = B // n
    return [t[k * b:(k + 1) * b].to(d, non_blocking=d.type == "cuda").contiguous()
            for k, d in enumerate(devices)]


def gather(parts: Sequence[torch.Tensor], device: DeviceLike = "cpu") -> torch.Tensor:
    """The shards' blocks joined along dim 0 on `device` (the host by
    default, which waits for them); a copy to a card is asynchronous."""
    dev = torch.device(device)
    return torch.cat([p.to(dev, non_blocking=dev.type == "cuda") for p in parts])


class Replicas:
    """Copies of one tensor, one per device, each made at first use: what
    a data-parallel function replicates (substitution matrices) is copied
    to a card once, not once per batch."""

    def __init__(self, t: torch.Tensor):
        self._on: Dict[torch.device, torch.Tensor] = {_device(t.device): t}
        self._t = t

    def on(self, device: torch.device) -> torch.Tensor:
        device = _device(device)
        t = self._on.get(device)
        if t is None:
            t = self._on[device] = self._t.to(device)
        return t


def on_device(x, device: torch.device) -> torch.Tensor:
    """`x` (a Replicas, a tensor or an array) on `device`."""
    if isinstance(x, Replicas):
        return x.on(device)
    return torch.as_tensor(x).to(device)


# ---------------------------------------------------------------------------
# multi-process
# ---------------------------------------------------------------------------

ENV_COORDINATOR = "UNICORE_TPU_COORDINATOR"  # host:port of rank 0
ENV_NUM_PROCS = "UNICORE_TPU_NUM_PROCS"
ENV_PROC_ID = "UNICORE_TPU_PROC_ID"


def initialize_distributed(timeout_s: float = 300.0, backend: Optional[str] = None) -> Optional[str]:
    """Bring up torch.distributed when launched as several processes, from
    the JAX package's variables: $UNICORE_TPU_COORDINATOR (host:port),
    $UNICORE_TPU_NUM_PROCS and $UNICORE_TPU_PROC_ID.  With none set it
    does nothing and returns None; else the backend's name.  A second
    call in one process returns the backend already up.

    `backend` None: NCCL when every rank of this host can have a card of
    its own (at least NUM_PROCS cards), each rank then on card
    rank % count; gloo otherwise (NCCL refuses two ranks on one card),
    with collectives on host tensors.  Ranks that compute on the CPU ask
    for "gloo".  The group's set-up and every collective fail after
    `timeout_s` instead of hanging.

    `process_mesh` then places rank r at (d, t) = divmod(r, tp) of a
    (dp, tp) mesh, where JAX's make_mesh puts process r's device once
    `jax.distributed.initialize` has made the global device list (one
    device per process, in process order, reshaped (dp, tp)): the ranks
    of one tp group are consecutive."""
    coord = os.environ.get(ENV_COORDINATOR)
    if not coord:
        return None
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_backend()
    world = int(os.environ.get(ENV_NUM_PROCS, "1"))
    rank = int(os.environ.get(ENV_PROC_ID, "0"))
    if backend is None:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        backend = "nccl" if n_cards >= world else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coord}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return backend


class ProcessMesh:
    """This process's place in a (dp, tp) mesh of torch.distributed ranks
    (`process_mesh`): the world's `dp` and `tp`, this rank's `d` and `t`,
    its one `device`, and the process groups of its tp row (`tp_group`,
    the ranks d tp .. d tp + tp - 1) and of its dp column (`dp_group`,
    the ranks t, t + tp, ...).  Collectives of a card tensor go through a
    host copy where the backend is gloo (`host_comm`)."""

    def __init__(self, dp: int, tp: int, device: torch.device, tp_group, dp_group):
        import torch.distributed as dist

        self.dp, self.tp = dp, tp
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.d, self.t = divmod(self.rank, tp)
        self.device = device
        self.tp_group, self.dp_group = tp_group, dp_group
        self.host_comm = dist.get_backend() == "gloo"

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}

    def __repr__(self) -> str:
        return (f"ProcessMesh(dp={self.dp}, tp={self.tp}, rank {self.rank} at (d, t) = ({self.d}, {self.t}), "
                f"{self.device})")


def process_mesh(dp: Optional[int] = None, tp: Optional[int] = None,
                 device: Optional[DeviceLike] = None, timeout_s: float = 300.0) -> ProcessMesh:
    """The (dp, tp) mesh of the torch.distributed world that
    initialize_distributed brought up ((dp, tp) from factor_mesh(world)
    unless both are given): this rank at (d, t) = divmod(rank, tp), as
    JAX's make_mesh lays out the processes' devices.  Every rank must
    call it, with the same arguments: it makes the tp and dp groups
    (dist.new_group, in one order on every rank; their collectives fail
    after `timeout_s`).

    `device` None is this rank's card: cuda:rank % count under NCCL (the
    card initialize_distributed set), the current card under gloo.  The
    CPU only where the caller asks for it; without a card and without
    "cpu" it raises."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("process_mesh: torch.distributed is not initialized (initialize_distributed)")
    world = dist.get_world_size()
    if dp is None or tp is None:
        dp, tp = factor_mesh(world)
    if dp * tp != world:
        raise ValueError(f"process mesh {dp}x{tp} != {world} ranks")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("process_mesh: no CUDA device; pass device='cpu' to run on the CPU")
        device = "cuda"
    timeout = datetime.timedelta(seconds=timeout_s)
    rank = dist.get_rank()
    groups = {}
    for d in range(dp):
        g = dist.new_group(list(range(d * tp, (d + 1) * tp)), timeout=timeout)
        if rank // tp == d:
            groups["tp"] = g
    for t in range(tp):
        g = dist.new_group(list(range(t, world, tp)), timeout=timeout)
        if rank % tp == t:
            groups["dp"] = g
    return ProcessMesh(dp, tp, _device(device), groups["tp"], groups["dp"])
