"""Build and bind the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with
a plain C interface (no PyTorch headers: seconds per file), loaded with
ctypes. Libraries are keyed by a hash of the sources and flags and built
at first use into `transception_tpu_torch/build/` (git-ignored); `build()`
starts one nvcc per missing library, all at once.

Every kernel is a torch.library operator of the namespace
`transception_torch` (`define`): its CUDA implementation is the ctypes
launch (which counts the launch), its CPU implementation the kernel's
plain version, and its fake implementation gives the output's shape and
dtype, so that torch.export traces a wrapper routed to its kernel and a
loaded artifact runs (and counts) the same launches as the eager forward.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from collections import Counter
from pathlib import Path
from typing import Callable, Dict, FrozenSet, Iterable, Union

import torch

# Shared libraries, one per csrc/<name>.cu.
KERNELS = ("etb_attention", "mixffn", "bridge_attention", "expand_head",
           "mhca_block", "linear_attention", "patch_expand",
           "bridge_attention_bwd", "mixffn_bwd", "bridge_attention_folded")
# Names of the kernel switch: one per forward kernel. bridge_attention and
# mixffn carry their backward kernels (K10, K11) with them; mixffn_skip
# (K9) is built into the mixffn library.
SWITCHES = frozenset(("etb_attention", "mixffn", "bridge_attention",
                      "expand_head", "mhca_block", "linear_attention",
                      "patch_expand", "bridge_attention_folded",
                      "mixffn_skip"))

_PKG = Path(__file__).resolve().parents[2]
_SRC = _PKG / "csrc"
_BUILD = _PKG / "build"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[tuple, ctypes._CFuncPtr] = {}
_on: FrozenSet[str] = SWITCHES
# Launches per (kernel name, shape key), tallied by each wrapper where it
# bumps its kernel's counter (ops.kernels.shape_counts).
shape_launches: Counter = Counter()
# Wrapper calls per kernel name that chose the kernel (its switch on),
# whatever the device: on the CPU the plain version runs in its place, so
# this counts what a card would launch (ops.kernels.routed_counts).
routed: Counter = Counter()


@contextlib.contextmanager
def enabled(kernels: Union[bool, Iterable[str]]):
    """The kernels that are on for the calls made inside: True (all, the
    default), False (none) or an iterable of switch names. A kernel that
    is off sends its wrapper to the plain version, on the card too. The
    model sets it per call (ops.kernels.kernel_set): every kernel in eval,
    the train step's set in training, none with use_kernels=False."""
    global _on
    if kernels is True or kernels is False:
        new = SWITCHES if kernels else frozenset()
    else:
        new = frozenset(kernels)
        if new - SWITCHES:
            raise ValueError(f"unknown kernels {sorted(new - SWITCHES)}")
    prev, _on = _on, new
    try:
        yield
    finally:
        _on = prev


def active() -> FrozenSet[str]:
    """The kernels the caller's `enabled` scope has on (all by default);
    a model's forward runs those of its kernel set that are among them."""
    return _on


def plain(name: str, t) -> bool:
    """The one kernel-or-plain decision of every wrapper: the plain version
    with kernel `name` switched off, or for a CPU tensor while autograd
    records (grad mode on: autograd then differentiates the plain version
    itself); else the kernel's operator (`define`), which launches the
    kernel for a CUDA tensor and runs the same plain version for a CPU
    one (an eval forward under no_grad, a trace for torch.export). A call
    with the switch on is counted in `routed`."""
    if name not in _on:
        return True
    routed[name] += 1
    return t.device.type == "cpu" and torch.is_grad_enabled()


def tally(name: str, *key) -> None:
    """One launch of kernel `name` at `key`: its input's shape and whatever
    else picks another instantiation of the kernel."""
    shape_launches[(name,) + key] += 1


def needs_graph(*tensors) -> bool:
    """Whether autograd would record a result of these inputs (lists of
    tensors are looked into)."""
    if not torch.is_grad_enabled():
        return False
    flat = []
    for t in tensors:
        flat.extend(t if isinstance(t, (list, tuple)) else (t,))
    return any(isinstance(t, torch.Tensor) and t.requires_grad for t in flat)


def forward_only(name: str, *tensors) -> None:
    """Guard of a kernel that has no backward (K4, the eval argmax head):
    its result would carry no graph, so every gradient upstream would
    silently be lost. Raises instead when autograd records and an input
    requires grad."""
    if needs_graph(*tensors):
        raise RuntimeError(
            f"{name} kernel has no backward: call it under torch.no_grad() "
            f"or switch it off (ops.kernels.enabled) while training")


class _PlainBackward(torch.autograd.Function):
    """Forward: `kernel(*tensors)`, the inputs saved. Backward: autograd of
    `plain(*tensors)` recomputed from detached copies of the saved inputs
    (the JAX custom VJPs whose backward is jax.vjp of the jnp mirror)."""

    @staticmethod
    def forward(ctx, kernel, plain_fn, *tensors):
        ctx.plain = plain_fn
        ctx.save_for_backward(*tensors)
        return kernel(*tensors)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
            wrt = [x for x, n in zip(xs, need) if n]
            grads = iter(torch.autograd.grad(ctx.plain(*xs), wrt, g))
        return (None, None) + tuple(next(grads) if n else None
                                    for n in need)


def with_plain_backward(kernel, plain_fn, *tensors):
    """kernel(*tensors) on the card, differentiable where autograd records:
    its backward is autograd of plain_fn(*tensors), the kernel's plain
    version, recomputed from the saved inputs. Both take the same flat
    tensors (the wrapper binds everything else)."""
    if not needs_graph(*tensors):
        return kernel(*tensors)
    return _PlainBackward.apply(kernel, plain_fn, *tensors)


# ---- the kernels as torch.library operators ----

NAMESPACE = "transception_torch"
_LIB = torch.library.Library(NAMESPACE, "DEF")
# Operator name -> its CPU implementation, the kernel's plain version with
# the operator's signature (utils.profiling costs an operator as it).
PLAIN_OPS: Dict[str, Callable] = {}


def define(name: str, schema: str, cuda: Callable, cpu: Callable,
           fake: Callable):
    """Register kernel `name` as the operator transception_torch::name with
    `schema` ("(Tensor x, ..., float eps) -> Tensor"): `cuda` the launch
    (it checks its inputs, raises on what the kernel does not take, never
    falls back, and counts the launch), `cpu` the plain version, `fake`
    the output's shape and dtype (FakeTensor, meta tensors, torch.export).
    A launch plan is worked out inside `cuda`, on the card that runs it,
    so none is a constant of an exported program. Returns the operator's
    overload, which the wrappers call."""
    _LIB.define(name + schema)
    _LIB.impl(name, cuda, "CUDA")
    _LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    PLAIN_OPS[name] = cpu
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(_SRC.glob("*.cuh")) + [_SRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named library that is not built yet, one nvcc each,
    all started together. Returns seconds per library built; raises with
    nvcc's output if any build fails."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(_SRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    secs, failed = {}, []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        secs[n] = time.perf_counter() - t0
        if p.returncode != 0:
            failed.append(f"--- {n} (rc {p.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return secs


def build_log(name: str) -> Union[str, None]:
    """nvcc's -Xptxas -v report (registers, shared memory, spills) of
    library `name`, kept beside it when it was built; None if it is not
    built."""
    kept = _lib_path(name).with_suffix(".log")
    return kept.read_text() if kept.exists() else None


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library `name`, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry `symbol` of kernel library `name` (built and loaded if
    needed) with its ctypes signature, an int return and `argtypes`, bound
    once."""
    lib = load(name)
    fn = _entries.get((name, symbol))
    if fn is None:
        fn = getattr(lib, symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _entries[(name, symbol)] = fn
    return fn


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a kernel entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


# The element types of the forward kernels' activations and weights: bf16,
# and fp32 for the fp32 forms (the published eval protocol's dtype).
DTYPES = (torch.bfloat16, torch.float32)


def element_dtype(name: str, *tensors, dtypes=DTYPES) -> torch.dtype:
    """The one element type of a kernel call's tensors; raises ValueError
    unless they all have it and it is one of `dtypes` (a kernel takes no
    fp16 and no mix)."""
    dts = {t.dtype for t in tensors}
    if len(dts) != 1 or next(iter(dts)) not in dtypes:
        names = "/".join(str(d).replace("torch.", "") for d in dtypes)
        raise ValueError(f"{name} kernel takes {names} tensors of one dtype, "
                         f"got {sorted(str(d) for d in dts)}")
    return next(iter(dts))


def symbol(base: str, dtype) -> str:
    """The C entry of a kernel's form at `dtype`: `base`, or `base`_f32."""
    return base + ("_f32" if dtype == torch.float32 else "")


def tag(t) -> str:
    """The element-type part of a launch's tally key."""
    return "fp32" if t.dtype == torch.float32 else "bf16"


def weight(t, dtype):
    """A weight as the kernels read it at element type `dtype`: contiguous
    and 16-byte aligned (cp.async)."""
    return aligned(t.to(dtype).contiguous())


def f32(t):
    """A vector parameter as the kernels read it: contiguous fp32."""
    return t.to(torch.float32).contiguous()


def aligned(t):
    """t contiguous and 32-byte aligned (the kernels' 16-byte cp.async and
    vector loads need 16)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 32 else t


def workspace(sizes, device):
    """One allocation for a launch's intermediates, each at a 256-byte
    aligned offset: the tensor, to be held until the launch is enqueued
    (the allocator then reuses it in stream order), and a pointer to each
    piece, in the order of `sizes` (bytes)."""
    offs, total = [], 0
    for nbytes in sizes:
        offs.append(total)
        total += -(-nbytes // 256) * 256
    ws = torch.empty(total, device=device, dtype=torch.uint8)
    return ws, [ctypes.c_void_p(ws.data_ptr() + o) for o in offs]


def sms(t) -> int:
    """The SM count of the card that holds tensor t (a launch plan's
    fill target)."""
    return torch.cuda.get_device_properties(t.device).multi_processor_count


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
