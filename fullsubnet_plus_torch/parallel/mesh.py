"""Device meshes, the process group and the placements built on them.

Counterpart of fullsubnet_plus_tpu/parallel/mesh.py:27-119. The JAX package
runs one process per host and a ('data', 'freq') mesh over its chips; XLA
shards the batch over 'data' and inserts the gradient all-reduce. PyTorch
runs one process (a rank) per card, so the port keeps JAX's names and
semantics and does the placement itself:

  * A `Mesh` is a ('data', 'freq') grid of THIS process's own devices, plus
    the ranks of the process group along 'data' (one card each). Its
    `shape["data"]` is the global data axis: local rows times ranks.
  * Data parallelism across ranks: each rank's loader yields its own rows
    (the local batch), the global batch is that times the ranks, and the
    train step all-reduces the flat gradient with the loss appended
    (train/step.py). `row_offset` gives the global index of a rank's first
    row, which `drop_band` needs (dsp/unfold.py); a card's first row is
    that plus its slice's start in `data_sharding`.
  * Within a process, a mesh of several cards splits a batch's rows over
    'data' (`data_sharding`), each shard running on its own card with its
    own copy of the model (`replicated`), for the train step, the eval
    step and the Enhancer; with the model config's `fold_sharding` naming
    'freq', each shard's sub-band fold rows are split again over the cards
    of its 'freq' row (`Mesh.fold_devices`), in training with a backward.
    JAX's per-host mesh over a host's chips maps onto such a mesh, and
    ranks that each hold one compose with it.

A CPU mesh is a grid of "cpu" devices: the placements are then copies in
one memory, which is how the tests hold the splits to one device.
"""

from __future__ import annotations

import copy
import datetime

import numpy as np
import torch
import torch.distributed as dist

from fullsubnet_plus_torch.device import resolve_device

AXES = ("data", "freq")
# a collective waits this long for a peer before it raises: a rank whose
# peer died exits with an error instead of hanging (validation on rank 0
# keeps the others waiting in the score's broadcast)
TIMEOUT_S = 1800.0


class Mesh:
    """A ('data', 'freq') grid of this process's own devices
    (`devices[data, freq]`, torch.device) and the ranks of the process group
    along 'data': `process_count` ranks, this one `process_index`, each with
    the same local grid. `group` is the process group of a distributed run
    (torch.distributed initialized), else None."""

    axis_names = AXES

    def __init__(self, devices, process_count: int = 1, process_index: int = 0, group=None):
        given = np.asarray(devices, dtype=object)
        if given.ndim != 2 or given.size == 0:
            raise ValueError(f"a mesh is a non-empty [data, freq] grid of devices, "
                             f"not {given.shape}")
        grid = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(given[idx])
        if not 0 <= process_index < process_count:
            raise ValueError(f"process {process_index} of {process_count}")
        self.devices = grid
        self.process_count = process_count
        self.process_index = process_index
        self.group = group

    @property
    def shape(self) -> dict:
        data, freq = self.devices.shape
        return {"data": data * self.process_count, "freq": freq}

    @property
    def local_data(self) -> int:
        """This process's cards along 'data' (its batch shards)."""
        return self.devices.shape[0]

    @property
    def data_devices(self) -> list:
        """The card of each of this process's batch shards ('freq' index 0)."""
        return list(self.devices[:, 0])

    def fold_devices(self, row: int, axes) -> list:
        """The cards the sub-band fold of batch shard `row` is split over
        for the model config's `fold_sharding` axes: the shard's 'freq'
        row where the axes name 'freq', else the shard's own card. A fold
        sharded over 'data' alone needs no split here: each batch shard
        already sweeps its own fold rows."""
        unknown = set(axes or ()) - set(AXES)
        if unknown:
            raise ValueError(f"fold_sharding names {sorted(unknown)}; the mesh axes are {AXES}")
        return list(self.devices[row]) if "freq" in (axes or ()) else [self.devices[row, 0]]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, freq={self.shape['freq']}, "
                f"devices={[str(d) for d in self.devices.ravel()]}, "
                f"process {self.process_index} of {self.process_count})")


def check_mesh(mesh) -> Mesh:
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a fullsubnet_plus_torch.parallel.Mesh, not "
                        f"{type(mesh).__name__}")
    return mesh


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """Rank 0, or the only process: the one that writes files."""
    return process_index() == 0


def rank_device(device: str | torch.device, rank: int = 0) -> torch.device:
    """This rank's card: `cuda:{rank % device_count}` for "cuda", the named
    card for "cuda:N", the CPU for "cpu". Raises where CUDA is absent."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def check_distributed_args(coordinator: str | None, num_processes: int | None,
                           process_id: int | None) -> bool:
    """Whether the flags ask for a multi-rank run; raises ValueError where
    they do not make one (a rank out of range, ranks without a coordinator)."""
    if num_processes is None or num_processes <= 1:
        if process_id not in (None, 0):
            raise ValueError(f"process id {process_id} of a single-process run")
        return False
    if not coordinator or ":" not in coordinator:
        raise ValueError(f"{num_processes} processes need a coordinator host:port, "
                         f"not {coordinator!r}")
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not in 0..{num_processes - 1}")
    return True


def initialize_distributed(coordinator: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None, *, device="cuda") -> None:
    """The process group of a multi-rank run; a no-op for one process.

    `coordinator` is rank 0's "host:port" rendezvous, `num_processes` the
    number of ranks, `process_id` this rank, `device` the rank's device: the
    card unless the caller asks for the CPU (a card where there is none
    raises RuntimeError; nothing falls back to gloo on the CPU). The backend
    is NCCL where each rank has a card of its own, and gloo for a CPU
    `device` or where the ranks outnumber the visible cards, so that some
    share one (gloo carries CUDA tensors through the host; NCCL refuses two
    ranks on one card). A CUDA rank's card becomes its current device.
    Collectives wait TIMEOUT_S for a peer."""
    if not check_distributed_args(coordinator, num_processes, process_id):
        return
    device = resolve_device(device)
    own_card = device.type == "cuda" and num_processes <= torch.cuda.device_count()
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if own_card else "gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def make_mesh(data: int | None = None, freq: int = 1, devices=None) -> Mesh:
    """A ('data', 'freq') mesh: `data` is the global data axis (None: every
    device of this process on it, times the ranks), over `devices` (this
    process's; by default every CUDA card, or in a multi-rank run this
    rank's current card). In a multi-rank run every rank holds the same
    local grid, so `data` must divide over the ranks."""
    ranks = process_count()
    if devices is None:
        if not torch.cuda.is_available():
            raise ValueError("make_mesh without CUDA needs its devices, e.g. ['cpu'] * n")
        devices = ([torch.device("cuda", torch.cuda.current_device())] if ranks > 1 else
                   [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    devices = [torch.device(d) for d in devices]
    if freq < 1:
        raise ValueError(f"freq {freq} < 1")
    if data is None:
        if len(devices) % freq:
            raise ValueError(f"{len(devices)} devices do not divide into freq={freq}")
        data = len(devices) // freq * ranks
    if data < 1 or data % ranks:
        raise ValueError(f"a data axis of {data} does not divide over {ranks} rank(s)")
    local = data // ranks
    if local * freq > len(devices):
        raise ValueError(f"mesh {data}x{freq} needs {local * freq} devices on each of "
                         f"{ranks} rank(s); this one has {len(devices)}")
    grid = np.empty((local, freq), dtype=object)
    for i, d in enumerate(devices[:local * freq]):
        grid[i // freq, i % freq] = d
    return Mesh(grid, ranks, process_index(), dist.group.WORLD if dist.is_initialized() else None)


def auto_mesh(batch_size: int, devices=None) -> Mesh | None:
    """The largest data-parallel mesh fed by per-rank batches of
    `batch_size` (JAX's auto_mesh). Multi-rank: every rank's devices on
    'data', freq 1; the global batch must divide over them (with one card a
    rank it always does). One process: the largest prefix of `devices`
    whose count divides the batch; None where that is one device."""
    ranks = process_count()
    devices = (list(devices) if devices is not None
               else list(make_mesh().devices.ravel()) if torch.cuda.is_available() else [])
    n = len(devices)
    if ranks > 1:
        if batch_size * ranks % (n * ranks):
            raise ValueError(f"the global batch {batch_size * ranks} ({batch_size} a rank x "
                             f"{ranks} ranks) does not divide over {n * ranks} devices")
        return make_mesh(data=n * ranks, freq=1, devices=devices)
    data = n
    while data > 1 and batch_size % data:
        data -= 1
    return make_mesh(data=data, freq=1, devices=devices[:data]) if data > 1 else None


def data_sharding(mesh: Mesh, rows: int) -> list:
    """[(device, slice)]: this process's `rows` split evenly over its 'data'
    cards. Raises, as jit does for JAX's data_sharding, where they do not
    divide."""
    parts = mesh.local_data
    if rows % parts:
        raise ValueError(f"a batch of {rows} rows does not divide over the {parts} 'data' "
                         f"card(s) of this process ({mesh})")
    size = rows // parts
    return [(dev, slice(i * size, (i + 1) * size)) for i, dev in enumerate(mesh.data_devices)]


def row_offset(mesh: Mesh | None, rows: int) -> int:
    """The global index of this rank's first row when every rank feeds
    `rows` (the counterpart of globalize_batch: the rows stay local, and the
    offset is what the global batch's row order needs)."""
    return 0 if mesh is None else mesh.process_index * rows


def replicated(mesh: Mesh, module: torch.nn.Module) -> list:
    """One copy of `module` on each of the mesh's 'data' cards, the module
    itself on the first (it must lie there already). The copies hold the
    module's values at the call; `sync_replicas` copies them again."""
    first = mesh.data_devices[0]
    where = next(module.parameters()).device
    if where != first and not (where.type == first.type == "cuda" and first.index is None):
        raise ValueError(f"the module lies on {where}, the mesh's first card is {first}")
    out = [module]
    for dev in mesh.data_devices[1:]:
        out.append(copy.deepcopy(module).to(dev))
    return out


@torch.no_grad()
def sync_replicas(replicas: list) -> None:
    """Copy the first replica's parameters and buffers into the others."""
    source = list(replicas[0].parameters()) + list(replicas[0].buffers())
    for replica in replicas[1:]:
        for t, s in zip(list(replica.parameters()) + list(replica.buffers()), source):
            t.copy_(s, non_blocking=True)


def _comm_device(mesh: Mesh) -> torch.device:
    """Where a collective's tensors must lie: this rank's card under NCCL,
    the CPU under gloo."""
    if dist.get_backend(mesh.group) == "nccl":
        return mesh.data_devices[0]
    return torch.device("cpu")


def all_reduce_sum_(tensor: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """Sum `tensor` over the ranks in place (every rank receives the same
    bits); no-op without a process group."""
    if mesh is None or mesh.group is None:
        return tensor
    if tensor.device != _comm_device(mesh):  # a CUDA tensor under gloo
        host = tensor.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=mesh.group)
        return tensor.copy_(host)
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=mesh.group)
    return tensor


def agreed_min(value: int, mesh: Mesh | None) -> int:
    """The least of every rank's `value` (e.g. an epoch's batch count)."""
    if mesh is None or mesh.group is None:
        return value
    t = torch.tensor([value], dtype=torch.int64, device=_comm_device(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.group)
    return int(t.item())


def broadcast_float(value: float, mesh: Mesh | None, src: int = 0) -> float:
    """Rank `src`'s `value` on every rank (float64)."""
    if mesh is None or mesh.group is None:
        return float(value)
    t = torch.tensor([value], dtype=torch.float64, device=_comm_device(mesh))
    dist.broadcast(t, src=src, group=mesh.group)
    return float(t.item())


def barrier(mesh: Mesh | None) -> None:
    if mesh is not None and mesh.group is not None:
        if dist.get_backend(mesh.group) == "nccl":
            dist.barrier(group=mesh.group, device_ids=[mesh.data_devices[0].index])
        else:
            dist.barrier(group=mesh.group)
