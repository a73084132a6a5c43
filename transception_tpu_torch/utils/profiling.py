"""Profiling and observability, the port's counterpart of
transception_tpu/utils/profiling.py: a wall-clock timer of an eager call,
a throughput meter, a flop and byte count with the H100's roofline bound,
torch.profiler traces (TensorBoard / Chrome JSON), the device time of one
call read from such a trace, and per-section times of the model.

The card's numbers come from the card: on the CPU, device_time_per_call
returns (None, None), as the JAX function does where the trace has no
device plane.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import shutil
import tempfile
import time
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from transception_tpu_torch.ops.kernels import NAMESPACE, _build

# The H100 SXM's dense bf16 tensor-core peak and HBM3 bandwidth, the
# bound cost_analysis reports (its "optimal_seconds").
H100_FLOPS = 989e12
H100_BYTES = 3.35e12
# The trace events of work on the card (the Chrome trace's categories).
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_jitted(fn: Callable, *args, iters: int = 20,
                warmup: int = 2) -> float:
    """Wall seconds per call of fn(*args): eager (the port has no jit),
    after `warmup` calls, the card synchronised before the first and after
    the last timed call."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters


def throughput(fn: Callable, *args, batch: int, iters: int = 20) -> float:
    """Images (slices) per second of fn(*args) on a batch of `batch`."""
    return batch / time_jitted(fn, *args, iters=iters)


# ---- cost_analysis: flops and bytes ----

_VIEWLESS = ("empty", "new_empty", "empty_like", "empty_strided")


def _tensor_bytes(tree) -> int:
    leaves, _ = tree_flatten(tree)
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


class _BytesMode(TorchDispatchMode):
    """Sums the bytes of every operator's tensor inputs and outputs (views
    and allocations move none); a kernel operator counts as its plain
    version does (_plain_cost)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if func.namespace == NAMESPACE:
            self.bytes += _plain_cost(func, args, kwargs)[1]
        elif not func.is_view and name not in _VIEWLESS:
            self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


_costs: Dict[tuple, Tuple[int, int]] = {}
# The dispatch keys of the caller of cost_analysis (autograd's included
# outside inference_mode): a mode's handler runs below autograd, where
# torch.matmul decomposes otherwise, so _plain_cost restores them for the
# plain version.
_keys = (torch._C._dispatch_tls_local_include_set(),
         torch._C._dispatch_tls_local_exclude_set())


def _signature(x):
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, dict):
        return tuple(sorted((k, _signature(v)) for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_signature(v) for v in x)
    return x


def _plain_cost(func, args, kwargs) -> Tuple[int, int]:
    """(flops, bytes) of kernel operator `func`: those of its plain version
    (its CPU implementation, ops.kernels._build.PLAIN_OPS) run once more
    on the same inputs, with the dispatch keys of a plain call, counted as
    cost_analysis counts PyTorch's own operators. So a forward reports the same work whether a kernel or its
    plain version computes it. Kept per operator and input signature."""
    key = (func.name(), _signature(args), _signature(kwargs),
           torch.is_inference_mode_enabled())
    if key not in _costs:
        from torch.utils._python_dispatch import _disable_current_modes
        plain = _build.PLAIN_OPS[func._overloadpacket.__name__]
        with _disable_current_modes(), \
                torch._C._ForceDispatchKeyGuard(*_keys):
            _costs[key] = _count(plain, *args, **kwargs)
    return _costs[key]


def _count(fn: Callable, *args, **kwargs) -> Tuple[int, int]:
    """(flops, bytes) of fn(*args, **kwargs): FlopCounterMode over the
    byte count, so that both see the operators FlopCounterMode
    decomposes into."""
    from torch.utils.flop_counter import FlopCounterMode
    counter, nbytes = FlopCounterMode(display=False), _BytesMode()
    with nbytes, counter:
        fn(*args, **kwargs)
    return counter.get_total_flops(), nbytes.bytes


_registered = False


def register_flop_formulas() -> None:
    """A FlopCounterMode formula for every kernel operator of the port
    (its plain version's flops, _plain_cost): without one its products
    would count as zero. Registered once."""
    global _registered
    if _registered:
        return
    from torch.utils.flop_counter import register_flop_formula
    for name in _build.PLAIN_OPS:
        packet = getattr(getattr(torch.ops, NAMESPACE), name)

        def formula(*args, out_val=None, _op=packet.default, **kwargs):
            return _plain_cost(_op, args, kwargs)[0]
        register_flop_formula(packet, get_raw=True)(formula)
    _registered = True


def cost_analysis(fn: Callable, *args) -> Dict[str, float]:
    """Flop and byte counts of one call fn(*args), run as given (a forward
    under torch.no_grad calls the kernels' operators where they are on):
    "flops" from torch.utils.flop_counter.FlopCounterMode (products and
    convolutions; each kernel operator at its plain version's count,
    register_flop_formulas); "bytes accessed", the input and output bytes
    of every operator the call dispatches (views and allocations none;
    each kernel operator as its plain version's operators), as XLA counts
    its figure over HLO operators; "optimal_seconds", the H100 SXM bound
    max(flops / 989e12, bytes / 3.35e12). A kernel path and its plain
    path report the same numbers for the same forward.

    "bytes accessed" is the unfused count: every intermediate that a
    kernel keeps on chip is counted as if its plain version's operators
    wrote and read it, so it is the same work whatever implements it, but
    it is no lower bound of a kernel path's traffic, nor is
    "optimal_seconds" one of its time (the published b=32 bf16 forward's
    optimal_seconds is above its kernel path's busy time on an H100). A
    roofline share is not to be taken from them; the per-kernel bounds
    (each kernel's own inputs read and outputs written once) are
    chip_smoke.py's."""
    global _keys
    register_flop_formulas()
    _keys = (torch._C._dispatch_tls_local_include_set(),
             torch._C._dispatch_tls_local_exclude_set())
    flops, nbytes = _count(fn, *args)
    return {"flops": float(flops), "bytes accessed": float(nbytes),
            "optimal_seconds": max(flops / H100_FLOPS, nbytes / H100_BYTES)}


# ---- traces and device time ----

def _activities():
    from torch.profiler import ProfilerActivity
    return [ProfilerActivity.CUDA] if torch.cuda.is_available() else [
        ProfilerActivity.CPU]


@contextlib.contextmanager
def trace(logdir: str):
    """A torch.profiler trace of the host and the card around a block,
    written under `logdir` as a Chrome trace JSON that TensorBoard's
    profiler plugin reads (tensorboard_trace_handler)."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.cuda.is_available() else [])
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        try:
            yield
        finally:
            _sync()


def parse_trace(trace_dir: str) -> Optional[dict]:
    """The card's work in the Chrome traces (*.pt.trace.json) under
    `trace_dir`, one call a file (device_time_per_call writes them so):
    {"call_times_s": the span of each call from its first device event's
    start to its last one's end, idle gaps inside included (the JAX
    figure is an XLA module's span on the device);
    "busy_times_s": each call's summed device busy time;
    "kernel_times_s": {kernel name: total seconds}}, or None where no
    file holds a device event (a CPU run)."""
    spans, busy, by_name = [], [], {}
    for path in sorted(glob.glob(os.path.join(trace_dir, "**",
                                              "*.pt.trace.json"),
                                 recursive=True)):
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        dev = [e for e in events if e.get("cat") in DEVICE_CATEGORIES
               and "dur" in e]
        if not dev:
            continue
        start = min(e["ts"] for e in dev)
        end = max(e["ts"] + e["dur"] for e in dev)
        spans.append((end - start) / 1e6)
        busy.append(sum(e["dur"] for e in dev) / 1e6)
        for e in dev:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e6
    if not spans:
        return None
    return {"call_times_s": spans, "busy_times_s": busy,
            "kernel_times_s": by_name}


def device_time_per_call(call: Callable, iters: int = 5,
                         trace_dir: Optional[str] = None):
    """Median device time of `call()`: each of `iters` calls traced on its
    own (torch.profiler, the card's activity only, the card synchronised
    at its end) into {trace_dir}/call_NNN.pt.trace.json, its span read by
    parse_trace. Returns (seconds, parsed), or (None, None) when the
    traces hold no device event (a CPU run), as the JAX function does.
    trace_dir defaults to a fresh directory under the temporary one."""
    from torch.profiler import profile
    trace_dir = trace_dir or tempfile.mkdtemp(prefix="device_time_")
    shutil.rmtree(trace_dir, ignore_errors=True)
    os.makedirs(trace_dir)
    for i in range(iters):
        with profile(activities=_activities()) as prof:
            call()
            _sync()
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"call_{i:03d}.pt.trace.json"))
    parsed = parse_trace(trace_dir)
    if parsed is None:
        return None, None
    times = sorted(parsed["call_times_s"])
    return times[len(times) // 2], parsed


def profile_model_sections(cfg=None, batch: int = 32, log=print,
                           device="cuda") -> Dict[str, float]:
    """Wall times of the encoder, the bridge and the whole published model
    (cfg's MSTransception) built standalone on `device`, each on the real
    upstream activations (zeros in, as the JAX function), and the decoder
    as the whole minus the other two (time_jitted, eval, no_grad; the
    kernels of kernels.kernel_set(cfg, False))."""
    from transception_tpu_torch.core.config import (
        TransceptionConfig,
        fold_table,
    )
    from transception_tpu_torch.core.device import resolve_device
    from transception_tpu_torch.models.bridge import (
        BridgeBlock4,
        BridgeGeometry,
    )
    from transception_tpu_torch.models.msvit import MSViT
    from transception_tpu_torch.models.transception import MSTransception
    from transception_tpu_torch.ops import kernels
    from transception_tpu_torch.ops.common import init_weights

    cfg = cfg or TransceptionConfig()
    dev = resolve_device(device)
    dt = cfg.compute_dtype

    def build(module):
        init_weights(module, torch.Generator().manual_seed(0))
        return module.to(dev).eval()

    x = torch.zeros(batch, cfg.img_size, cfg.img_size, 3, device=dev)
    results: Dict[str, float] = {}
    with torch.no_grad(), kernels.enabled(kernels.kernel_set(cfg, False)):
        backbone = build(MSViT(cfg))
        xb = x.to(dt)
        results["encoder_s"] = time_jitted(backbone, xb)
        enc = backbone(xb)
        geo = BridgeGeometry(cfg.img_size, cfg.dims, cfg.bridge_dim)
        bridge = build(BridgeBlock4(geo, cfg.bridge_heads,
                                    cfg.br_ch_att_list,
                                    cfg.reduction_ratios, dt,
                                    fold_table(cfg)))
        results["bridge_s"] = time_jitted(bridge, enc)
        del backbone, bridge, enc
        model = MSTransception(cfg, dev)
        results["full_s"] = time_jitted(model, x)
    results["decoder_s"] = max(
        results["full_s"] - results["encoder_s"] - results["bridge_s"], 0.0)
    results["slices_per_s"] = batch / results["full_s"]
    if log:
        for k, v in results.items():
            log(f"{k}: {v:.6f}")
    return results


if __name__ == "__main__":
    profile_model_sections()
