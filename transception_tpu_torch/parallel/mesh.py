"""The data axis across cards, the port's counterpart of
transception_tpu/parallel/mesh.py.

JAX runs one program over a (data, model) device mesh and GSPMD shards
the batch on 'data'. The port runs one process a card (a rank), joined
in a torch.distributed process group: NCCL on the card, gloo where the
caller asks for the CPU (the tests). A data-parallel train step over R
ranks is the one-process step on the global batch (GSPMD's semantics):
each rank takes its contiguous 1/R of every global batch, the BatchNorm
moments and the soft-Dice sums are summed over the ranks inside the
forward (global_sum), the drop-path and dropout masks are drawn for the
global batch from the shared generator and each rank keeps its rows
(global_rand), and DistributedDataParallel averages the gradients.

The model ('model', tensor-parallel) axis is not ported (ROADMAP.md §1
item 4): make_mesh refuses tp_size > 1.

Ranks come from torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT) or from spawn, which the CLIs call to start
their --dp_size ranks themselves. A world of one makes no process group
unless the caller forces one.
"""

from __future__ import annotations

import contextlib
import os
import socket
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

from transception_tpu_torch.core.device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class DataMesh:
    """This process's place on the data axis: its rank of `world`, its
    device, and the process group (None for a world of one without one)."""

    rank: int
    world: int
    device: torch.device
    group: Optional[object] = None
    owns_group: bool = False

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of n (n divisible by the world)."""
        if n % self.world:
            raise ValueError(f"{n} rows do not divide over the "
                             f"{self.world} ranks of the data axis")
        b = n // self.world
        return slice(self.rank * b, (self.rank + 1) * b)

    def close(self) -> None:
        """Destroy the process group if make_mesh made it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()


def launched() -> bool:
    """Whether this process is one rank of a launch (a process group
    exists, or torchrun's or spawn's environment is set)."""
    return dist.is_initialized() or "WORLD_SIZE" in os.environ


def launch_world() -> int:
    """The launch's world size (1 where this process is no rank of one)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def data_size(dp_size: int, device: DeviceLike = "cuda") -> int:
    """The ranks dp_size asks for: dp_size <= 0 means every visible card
    (mesh.py:30-35 of the JAX package), or the launch's world where this
    process is a rank; the CPU counts as one device. Raises, before any
    work, when the card needs more cards than are visible, with both
    counts."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dp_size if dp_size > 0 else launch_world()
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have == 0 and dp_size <= 1:
        resolve_device(dev)  # raises: no card
    if dp_size <= 0:
        dp_size = launch_world() if launched() else have
    if dp_size > have:
        raise RuntimeError(f"mesh {dp_size}x1 needs {dp_size} cards, have "
                           f"{have} (visible CUDA devices)")
    return dp_size


def make_mesh(dp_size: int = -1, tp_size: int = 1,
              device: DeviceLike = "cuda", force: bool = False) -> DataMesh:
    """This process's DataMesh for a data axis of dp_size ranks
    (data_size) and a model axis of tp_size (1 only).

    A world of one makes no process group unless one exists or `force`
    is set (then a group of one rank over localhost). Above one, the
    process must be one rank of a launch of dp_size ranks (torchrun or
    spawn): the group is joined from the environment, NCCL on the card
    and gloo on the CPU, and each rank takes the card of its LOCAL_RANK.
    There is no fallback between backends or devices."""
    if tp_size > 1:
        raise NotImplementedError(
            f"tp_size {tp_size}: the tensor-parallel ('model') axis is not "
            f"ported (ROADMAP.md §1 item 4); the port shards the data axis "
            f"only")
    dp = data_size(dp_size, device)
    dev = resolve_device(device)
    if dp == 1 and not (force or launched()):
        return DataMesh(0, 1, dev)
    owns = False
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ and not (force and dp == 1):
            raise RuntimeError(
                f"dp_size {dp} needs {dp} ranks: start them with torchrun "
                f"--nproc_per_node {dp}, or through cli.train / cli.test "
                f"--dp_size {dp}, which start them")
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://localhost:{free_port()}",
                world_size=1, rank=0)
        owns = True
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != dp:
        raise RuntimeError(f"dp_size {dp}: the process group has {world} "
                           f"ranks")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    return DataMesh(rank, world, dev, dist.group.WORLD, owns)


# ---- the train step's reductions over the global batch ----

_ACTIVE: Optional[DataMesh] = None


@contextlib.contextmanager
def data_parallel(mesh: Optional[DataMesh]) -> Iterator[None]:
    """Inside, BatchNorm's train moments and the loss's Dice sums reduce
    over the mesh's ranks (global_sum) and the drop-path and dropout masks
    are drawn for the global batch (global_rand). A mesh without a process
    group changes nothing."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = mesh if mesh is not None and mesh.group is not None else None
    try:
        yield
    finally:
        _ACTIVE = prev


def active() -> Optional[DataMesh]:
    return _ACTIVE


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the ranks' gradients, so each
    rank gets the gradient of the sum of every rank's loss. Each rank's
    loss is the global one (up to its own CE mean), and
    DistributedDataParallel's mean divides the R copies back out."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the active mesh's ranks, differentiably; x itself
    outside data_parallel. The collective runs on the current stream's
    order (NCCL waits for it), where the kernels launch too."""
    m = _ACTIVE
    return x if m is None else _AllReduceSum.apply(x.contiguous(), m.group)


def global_rand(shape: Sequence[int], gen: Optional[torch.Generator],
                device) -> torch.Tensor:
    """torch.rand(shape) of this rank's rows: under data_parallel the
    draw is of the global batch (dim 0 times the world) and the rank keeps
    its contiguous rows, so every rank advances the shared generator as the
    one-process step does and the masks are its masks."""
    m = _ACTIVE
    shape = tuple(shape)
    if m is None:
        return torch.rand(shape, generator=gen, device=device)
    b = shape[0]
    u = torch.rand((b * m.world,) + shape[1:], generator=gen, device=device)
    return u[m.rank * b:(m.rank + 1) * b]


# ---- eval and bookkeeping collectives ----

def gather_rows(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Every rank's x (the same shape on each), concatenated in rank order
    along dim 0; on every rank."""
    if mesh.group is None:
        return x
    x = x.contiguous()
    outs = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(outs, x, group=mesh.group)
    return torch.cat(outs)


def mean_over_ranks(x: torch.Tensor, mesh: Optional[DataMesh]
                    ) -> torch.Tensor:
    """x averaged over the ranks (not differentiated)."""
    if mesh is None or mesh.group is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=mesh.group)
    return y / mesh.world


def broadcast_floats(values: Sequence[float], mesh: Optional[DataMesh]
                     ) -> List[float]:
    """Rank 0's values on every rank."""
    if mesh is None or mesh.group is None:
        return list(values)
    t = torch.tensor(list(values), dtype=torch.float64, device=mesh.device)
    dist.broadcast(t, 0, group=mesh.group)
    return t.tolist()


# ---- starting ranks ----

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, fn: Callable, args: tuple,
               results) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    out = fn(*args)
    if rank == 0:
        results.put(out)


def spawn(fn: Callable, world: int, args: tuple = ()):
    """Run fn(*args) in `world` new processes, one rank each (torchrun's
    environment set, rank r on card r), and return rank 0's result (which
    must pickle). A rank that fails fails the call (join raises)."""
    import torch.multiprocessing as mp
    results = mp.get_context("spawn").SimpleQueue()
    ranks = mp.start_processes(_rank_main, args=(world, free_port(), fn,
                                                 args, results),
                               nprocs=world, join=False,
                               start_method="spawn")
    out = None
    # Drain the queue while waiting: a rank blocked on a full pipe would
    # never exit.
    while not ranks.join(timeout=0.5):
        if not results.empty():
            out = results.get()
    return results.get() if not results.empty() else out
