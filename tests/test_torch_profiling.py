"""utils/profiling.py of the port (the JAX package's function names) on
the CPU: cost_analysis gives the same flops and bytes with the kernels
routed on and off, the flops of one EfficientTransformerBlock equal a
count by hand, every kernel operator has a flop formula, parse_trace
reads a call's span and busy time from a Chrome trace, and the device
time of a CPU run is (None, None), as the JAX function returns it where
the trace has no device plane. No JAX, no card."""

import dataclasses
import json

import pytest
import torch
import torch_threads  # noqa: F401 (torch's threads per xdist worker)

from transception_tpu_torch.core.config import (
    TransceptionConfig,
    fold_table,
)
from transception_tpu_torch.models.transception import MSTransception
from transception_tpu_torch.ops import kernels
from transception_tpu_torch.ops.attention import EfficientTransformerBlock
from transception_tpu_torch.ops.common import init_weights
from transception_tpu_torch.ops.kernels import _build
from transception_tpu_torch.utils import profiling

TINY = dict(img_size=32, dtype="float32", stage1_layers=1,
            num_path=(1, 1, 1), num_layers=(1, 1, 1))
# Fold switches pinned, so that use_kernels=False runs the kernel path's
# structure: the default folds and every fold on.
FOLDS = {"default": dict(etb_attn_fold=True, etb_ffn_fold=True),
         "all-on": dict(bridge_attn_fold=True, bridge_ffn_use_pallas=True,
                        etb_attn_fold=True, etb_ffn_fold=True,
                        mhca_ffn_fold=True, mhca_block_fold=False)}


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
@pytest.mark.parametrize("folds", sorted(FOLDS))
def test_kernel_and_plain_paths_cost_the_same(folds, mode):
    x = torch.randn(2, 32, 32, 1, generator=torch.Generator().manual_seed(0))
    costs = {}
    for on in (True, False):
        cfg = TransceptionConfig(**TINY, **FOLDS[folds], use_kernels=on)
        m = MSTransception(cfg, device="cpu")
        kernels.reset_launches()
        with getattr(torch, mode)():
            costs[on] = profiling.cost_analysis(m, x)
        assert bool(kernels.routed_counts()) == on
    assert costs[True] == costs[False]
    c = costs[True]
    assert set(c) == {"flops", "bytes accessed", "optimal_seconds"}
    assert c["flops"] > 1e8 and c["bytes accessed"] > 1e7
    assert c["optimal_seconds"] == max(c["flops"] / 989e12,
                                       c["bytes accessed"] / 3.35e12)


@pytest.mark.parametrize("fold", [True, False])
def test_etb_flops_by_hand(fold):
    """One ETB at C = 64 on a 8² map, batch 2: the q, k, v and
    reprojection products (4 · 2BNC²), the linear attention's two
    products (2 · 2BNC², one head of C), fc1 and fc2 (2 · 2BNC·4C) and
    the depthwise 3x3 (2BN·4C·9), folded into K1 and K2 or not."""
    B, s, Cc = 2, 8, 64
    Nn, hid = s * s, 4 * Cc
    cfg = TransceptionConfig(etb_attn_fold=fold, etb_ffn_fold=fold,
                             dtype="float32")
    blk = EfficientTransformerBlock(Cc, torch.float32, fold_table(cfg))
    init_weights(blk, torch.Generator().manual_seed(0))
    blk.eval()
    x = torch.randn(B, Nn, Cc)
    want = (2 * B * Nn * (6 * Cc * Cc) + 2 * B * Nn * 2 * Cc * hid
            + 2 * B * Nn * hid * 9)
    kernels.reset_launches()
    with torch.no_grad():
        got = profiling.cost_analysis(blk, x, s, s)["flops"]
    assert got == want
    assert set(kernels.routed_counts()) == (
        {"etb_attention", "mixffn"} if fold else {"linear_attention"})


def test_every_operator_has_a_flop_formula():
    from torch.utils.flop_counter import flop_registry
    profiling.register_flop_formulas()
    profiling.register_flop_formulas()  # once only
    for name in _build.PLAIN_OPS:
        packet = getattr(getattr(torch.ops, kernels.NAMESPACE), name)
        assert packet in flop_registry, name


def test_parse_trace_reads_span_and_busy(tmp_path):
    """A call's span runs from its first device event's start to its last
    one's end (the idle gap inside counted), busy sums the events; host
    events do not count."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 100.0, "dur": 10.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 115.0,
         "dur": 5.0},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 150.0, "dur": 50.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0,
         "dur": 1000.0}]
    (tmp_path / "call_000.pt.trace.json").write_text(
        json.dumps({"traceEvents": events}))
    (tmp_path / "call_001.pt.trace.json").write_text(
        json.dumps({"traceEvents": events[:1]}))
    got = profiling.parse_trace(str(tmp_path))
    assert got["call_times_s"] == pytest.approx([100e-6, 10e-6])
    assert got["busy_times_s"] == pytest.approx([65e-6, 10e-6])
    assert got["kernel_times_s"]["k1"] == pytest.approx(70e-6)
    (tmp_path / "call_000.pt.trace.json").unlink()
    (tmp_path / "call_001.pt.trace.json").write_text(
        json.dumps({"traceEvents": events[3:]}))
    assert profiling.parse_trace(str(tmp_path)) is None


def test_device_time_of_a_cpu_run_is_none(tmp_path):
    calls = []
    out = profiling.device_time_per_call(lambda: calls.append(
        torch.ones(4) @ torch.ones(4)), iters=2, trace_dir=str(tmp_path))
    assert out == (None, None) and len(calls) == 2
    assert len(list(tmp_path.glob("call_*.pt.trace.json"))) == 2


def test_timers_and_sections():
    m = torch.nn.Linear(4, 4)
    x = torch.randn(3, 4)
    t = profiling.time_jitted(m, x, iters=3, warmup=1)
    assert t > 0
    assert profiling.throughput(m, x, batch=3, iters=3) > 0
    lines = []
    cfg = TransceptionConfig(**TINY)
    res = profiling.profile_model_sections(cfg, batch=2, log=lines.append,
                                           device="cpu")
    assert set(res) == {"encoder_s", "bridge_s", "decoder_s", "full_s",
                        "slices_per_s"}
    assert all(v >= 0 for v in res.values()) and len(lines) == 5
    assert res["slices_per_s"] == pytest.approx(2 / res["full_s"])


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.ones(8) @ torch.ones(8)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    assert json.loads(files[0].read_text())["traceEvents"]


def test_cost_of_a_tiny_dataclass_config_is_stable():
    """The cost of a kernel operator is kept per signature: two runs of
    one forward give one count."""
    cfg = dataclasses.replace(TransceptionConfig(**TINY), **FOLDS["all-on"])
    m = MSTransception(cfg, device="cpu")
    x = torch.zeros(1, 32, 32, 1)
    with torch.no_grad():
        assert profiling.cost_analysis(m, x) == profiling.cost_analysis(m, x)
