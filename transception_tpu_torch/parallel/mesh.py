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

The model ('model', tensor-parallel) axis: make_mesh(dp, tp) lays the
dp·tp ranks out as the JAX mesh reshapes its devices, (dp, tp), so rank
r = d·tp + t; the data group is the ranks of equal t, the model group
those of equal d. The JAX package's TP rules (_TP_RULES, mesh.py:62-120
there) pick the weights that shard over the model group; shard_layout
applies them to the port's state_dict keys (the reference's torch names),
the model's modules run their shards (shard_model), and shard_state_dict /
gather_state_dict move state between the full layout and a rank's shards.
The collectives of the model axis are in parallel/tensor.py.

Ranks come from torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT) or from spawn, which the CLIs call to start
their --dp_size ranks themselves. A world of one makes no process group
unless the caller forces one.
"""

from __future__ import annotations

import contextlib
import os
import re
import socket
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

from transception_tpu_torch.core.device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class DataMesh:
    """This process's place on the (data, model) mesh: its rank d of the
    `world` ranks of the data axis, its device, and the data axis's
    process group (None where the data axis has one rank and no group was
    asked for); on the model axis its place t of `tp` and the model group
    (None at tp 1)."""

    rank: int
    world: int
    device: torch.device
    group: Optional[object] = None
    owns_group: bool = False
    tp: int = 1
    t: int = 0
    model_group: Optional[object] = None

    @property
    def is_main(self) -> bool:
        """Rank (0, 0): the one that logs and writes."""
        return self.rank == 0 and self.t == 0

    @property
    def axis(self):
        """The model axis (parallel.tensor.ModelAxis), None at tp 1."""
        if self.tp == 1:
            return None
        from transception_tpu_torch.parallel.tensor import ModelAxis
        return ModelAxis(self.tp, self.t, self.model_group)

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


def data_size(dp_size: int, device: DeviceLike = "cuda",
              tp_size: int = 1) -> int:
    """The data-axis ranks dp_size asks for beside a model axis of
    tp_size: dp_size <= 0 means every visible card over tp_size
    (mesh.py:30-35 of the JAX package), or the launch's world over
    tp_size where this process is a rank; the CPU counts as one device.
    Raises, before any work, when the mesh needs more cards than are
    visible, with both counts (mesh.py:36-37 there)."""
    dev = torch.device(device)
    tp = max(tp_size, 1)
    if dev.type != "cuda":
        return dp_size if dp_size > 0 else max(launch_world() // tp, 1)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have == 0 and dp_size <= 1 and tp == 1:
        resolve_device(dev)  # raises: no card
    if dp_size <= 0:
        dp_size = max((launch_world() if launched() else have) // tp, 1)
    if dp_size * tp > have:
        raise RuntimeError(f"mesh {dp_size}x{tp} needs {dp_size * tp} "
                           f"cards, have {have} (visible CUDA devices)")
    return dp_size


def make_mesh(dp_size: int = -1, tp_size: int = 1,
              device: DeviceLike = "cuda", force: bool = False,
              backend: Optional[str] = None) -> DataMesh:
    """This process's DataMesh for a data axis of dp_size ranks
    (data_size) and a model axis of tp_size: dp·tp ranks, rank r at
    (d, t) = divmod(r, tp), as the JAX make_mesh reshapes its devices to
    (dp, tp).

    A world of one makes no process group unless one exists or `force`
    is set (then a group of one rank over localhost). Above one, the
    process must be one rank of a launch of dp·tp ranks (torchrun or
    spawn): the group is joined from the environment, NCCL on the card
    and gloo on the CPU (or `backend`), and each rank takes the card of
    its LOCAL_RANK. gloo on the card lets ranks share a card (it takes
    CUDA tensors for all_reduce and broadcast; NCCL refuses), so the count
    of cards is not checked then. At tp > 1 every rank makes the data and
    model groups, in the same order. There is no fallback between
    backends or devices."""
    tp = max(tp_size, 1)
    dp = data_size(dp_size, "cpu" if backend == "gloo" else device, tp)
    n = dp * tp
    dev = resolve_device(device)
    if n == 1 and not (force or launched()):
        return DataMesh(0, 1, dev)
    owns = False
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ and not (force and n == 1):
            what = f"dp_size {dp}" + (f" x tp_size {tp}" if tp > 1 else "")
            raise RuntimeError(
                f"{what} needs {n} ranks: start them with torchrun "
                f"--nproc_per_node {n}, or through cli.train / cli.test "
                f"--dp_size {dp}" + (f" --tp_size {tp}" if tp > 1 else "")
                + ", which start them")
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://localhost:{free_port()}",
                world_size=1, rank=0)
        owns = True
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise RuntimeError(f"mesh {dp}x{tp}: the process group has {world} "
                           f"ranks")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if tp == 1:
        return DataMesh(rank, world, dev, dist.group.WORLD, owns)
    data = [dist.new_group([d * tp + t for d in range(dp)])
            for t in range(tp)]
    model = [dist.new_group([d * tp + t for t in range(tp)])
             for d in range(dp)]
    d, t = divmod(rank, tp)
    return DataMesh(d, dp, dev, data[t] if dp > 1 else None, owns, tp, t,
                    model[d])


# ---- the model axis's weight layout (transception_tpu/parallel/mesh.py:
# 62-120) ----

# (state_dict key regex, the dim that shards) of a weight: the JAX rules on
# the port's keys (torch's Linear weight is (out, in), flax's kernel (in,
# out): the kernel's out-feature axis is dim 0 here). The non-bridge FFNs'
# fc1 on its output features (column-parallel) and fc2 on its input
# features (row-parallel); every qkv / qkv_linear on its output features;
# no output projection (the JAX comments give the reasons).
_TP_RULES = (
    (re.compile(r"^(?!.*bridge_layer).*(mix_ffn|mlp|mixffn)\d*\.fc1\.weight$"),
     0),
    (re.compile(r"^(?!.*bridge_layer).*(mix_ffn|mlp|mixffn)\d*\.fc2\.weight$"),
     1),
    (re.compile(r".*\.qkv(_linear)?\.weight$"), 0),
)
# With vectorize_paths (the JAX default) the JAX tree stacks each MHCA
# stage's per-path encoders (mhca_blks_stacked), so their kernels are 3-D
# there and param_shard_rules, which shards 2-D kernels only, leaves them
# replicated; so does the port, by key. Without it (the per-path layout,
# mhca_blks_{i}) they are 2-D, and the rules shard each MHCA block's qkv
# and its FFN's fc1 and fc2 as any other's.
_STACKED = ".mhca_blks."
# The vectors and the depthwise conv of a hidden-sharded FFN, which shard
# with its fc1 (dim 0), and the bias of a column-parallel qkv: replicated
# in the JAX tree, where GSPMD computes the same values from the whole
# tensor; the port keeps each rank's channels.
_FFN_COMPANIONS = ("fc1.bias", "dwconv.dwconv.weight", "dwconv.dwconv.bias",
                   "norm1.weight", "norm1.bias")


def param_shard_rules(key: str, value, stacked: bool = True
                      ) -> Optional[int]:
    """The dim of weight `key` that the JAX rules shard over the model
    axis, or None (replicated): 2-D weights only, and in the stacked MHCA
    layout (`stacked`, vectorize_paths) never an MHCA block's."""
    if getattr(value, "ndim", 0) == 2 and not (stacked and _STACKED in key):
        for rule, dim in _TP_RULES:
            if rule.match(key):
                return dim
    return None


def shard_layout(tensors: Dict[str, torch.Tensor], tp: int,
                 stacked: bool = True) -> Dict[str, int]:
    """{state_dict key: sharded dim} of a model's tensors (key -> tensor or
    shape) at tp ranks of the model axis, in the stacked MHCA layout or
    (stacked=False, vectorize_paths=False) the per-path one: the weights
    of param_shard_rules whose sharded dim divides by tp (else replicated,
    as shard_params falls back), and with a sharded FFN fc1 its
    companions, with a qkv its bias. Empty at tp 1."""
    if tp <= 1:
        return {}
    out = {}
    for key, v in tensors.items():
        dim = param_shard_rules(key, v, stacked)
        if dim is None or tuple(v.shape)[dim] % tp:
            continue
        out[key] = dim
        base = key[:-len("weight")]
        if key.endswith(".fc1.weight"):
            ffn = key[:-len("fc1.weight")]
            out.update({ffn + c: 0 for c in _FFN_COMPANIONS
                        if ffn + c in tensors})
        elif base + "bias" in tensors and dim == 0 and \
                re.match(r".*\.qkv(_linear)?\.$", base):
            out[base + "bias"] = 0
    return out


def shard_model(model: torch.nn.Module, axis) -> Dict[str, int]:
    """Shard `model` in place over the model axis `axis`
    (parallel.tensor.ModelAxis) by shard_layout in the MHCA layout of the
    model's config (vectorize_paths): each FFN whose fc1 the rules shard
    keeps its hidden channels (its shard_), each qkv its output features,
    gathered after the product (Linear "gather"; an MHCA block's qkv in
    the per-path layout, whose K5 fold then runs K5's sharded form). With
    the model's config asking for the bridge's sequence sharding
    (bridge_seq_shard_axis "model") and more than one rank, the original
    bridge (a BridgeBlock4 under `model.bridge`; MISSFormer's bridge
    layers, which the JAX MISSFormer builds without the axis, stay
    whole) shards its sequence over the axis (BridgeBlock4.seq_shard_);
    the parameters whose gradients are then partial on each rank are
    recorded for the train state in model.partial_grads (names; empty
    without it). Returns the layout;
    raises if a sharded weight sits in a module that has no sharded
    form."""
    full = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    cfg = getattr(model, "cfg", None)
    layout = shard_layout(model.state_dict(), axis.size,
                          getattr(cfg, "vectorize_paths", True))
    for key in layout:
        if key.endswith(".fc1.weight"):
            ffn = model.get_submodule(key[:-len(".fc1.weight")])
            if not hasattr(ffn, "shard_"):
                raise NotImplementedError(
                    f"{key}: {type(ffn).__name__} has no hidden-sharded "
                    f"form")
            ffn.shard_(axis)
        elif re.match(r".*\.qkv(_linear)?\.weight$", key):
            model.get_submodule(key[:-len(".weight")]).shard_(axis,
                                                              "gather")
    for key, t in model.state_dict().items():
        want = list(full[key])
        if key in layout:
            want[layout[key]] //= axis.size
        if list(t.shape) != want:
            raise RuntimeError(f"{key}: sharded to {tuple(t.shape)}, the "
                               f"layout says {tuple(want)}")
    bridge = getattr(model, "bridge", None)
    model.partial_grads = ()
    if getattr(cfg, "bridge_seq_shard_axis", "") == "model" and \
            hasattr(bridge, "seq_shard_"):
        model.partial_grads = tuple(
            "bridge." + n for n in bridge.seq_shard_(axis))
    return layout


def shard_state_dict(sd: Dict[str, torch.Tensor], layout: Dict[str, int],
                     tp: int, t: int) -> Dict[str, torch.Tensor]:
    """Rank t's shards of a full-layout state dict (the other entries as
    they are)."""
    out = dict(sd)
    for key, dim in layout.items():
        if key in sd:
            n = sd[key].shape[dim] // tp
            out[key] = sd[key].narrow(dim, t * n, n).clone()
    return out


def gather_state_dict(sd: Dict[str, torch.Tensor], layout: Dict[str, int],
                      axis) -> Dict[str, torch.Tensor]:
    """The full layout of a rank's state dict, on every rank of the model
    axis `axis` (parallel.tensor.ModelAxis; a collective: every rank of
    the model group calls it)."""
    out = dict(sd)
    for key, dim in layout.items():
        if key in sd:
            out[key] = axis.gather(sd[key].detach(), dim, grad=False)
    return out


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
    """The values of the data axis's rank 0 (the first rank of mesh.group)
    on every rank of the group."""
    if mesh is None or mesh.group is None:
        return list(values)
    t = torch.tensor(list(values), dtype=torch.float64, device=mesh.device)
    dist.broadcast(t, dist.get_global_rank(mesh.group, 0), group=mesh.group)
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
