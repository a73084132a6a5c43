"""Host time of a kernel launch through its torch.library operator against
the same launch called directly, on the card, in one process: the cost
that registering the kernels as operators adds to each launch.

    python3 scripts/torch_op_overhead.py [--calls 2000] [--repeats 8]

For two kernels of the published forward, linear_attention (K6, three
tensors, at the stage-4 factorized attention's q/k/v (1, 8, 49, 40)) and
etb_attention (K1, eleven tensors, at (1, 196, 320)), both bf16 and under
torch.inference_mode as the predictor runs them: `repeats` rounds, each
timing `calls` back-to-back calls of the operator (`OP`) and of its CUDA
implementation called directly (`_launch`), in the order operator,
direct, direct, operator, on the host's clock from the first call to the
last (the card synchronised before each block), with CUDA events over
the same block beside it: where the events' time is the host's, the
card waited on the host, and the block timed the host's cost a launch.
Then one b=32 bf16 argmax forward of the published model counts its
launches, and `repeats` x 10 forwards give its wall time. Prints one
JSON line: per kernel every block's host and event microseconds a call,
the medians and the operator's less the direct call's, the forward's
launches and wall, the mean of the two kernels' differences times those
launches, and the card's name and power limit and torch's version.
Exits non-zero without a card. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _cases():
    from transception_tpu_torch.ops.kernels import etb_attention as ea
    from transception_tpu_torch.ops.kernels import linear_attention as la

    g = torch.Generator().manual_seed(0)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g).to("cuda", dtype)

    q, k, v = (rand(1, 8, 49, 40) for _ in range(3))
    C = 320
    etb = (rand(1, 196, C),) + tuple(
        rand(*s, dtype=torch.float32) for s in
        ((C,), (C,), (C, C), (C,), (C, C), (C,), (C, C), (C,), (C, C),
         (C,)))
    return {"linear_attention": (la.OP, la._launch,
                                 (q, k, v, False, 40 ** -0.5)),
            "etb_attention": (ea.OP, ea._launch, etb + (1e-5,))}


def _block_us(fn, args, calls):
    """(host, events) microseconds a call over `calls` calls of fn."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.record()
    for _ in range(calls):
        fn(*args)
    b.record()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e6 / calls, a.elapsed_time(b) * 1e3 / calls


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--calls", type=int, default=2000)
    p.add_argument("--repeats", type=int, default=8)
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    from transception_tpu_torch.core.config import TransceptionConfig
    from transception_tpu_torch.models.transception import MSTransception
    from transception_tpu_torch.ops import kernels
    from transception_tpu_torch.ops.kernels import _build

    _build.build()
    out = {}
    with torch.inference_mode():
        for name, (op, launch, a) in _cases().items():
            torch.testing.assert_close(op(*a), launch(*a), rtol=0, atol=0)
            for fn in (op, launch):
                _block_us(fn, a, 50)
            host = {"operator": [], "direct": []}
            events = {"operator": [], "direct": []}
            for _ in range(args.repeats):
                for which in ("operator", "direct", "direct", "operator"):
                    fn = op if which == "operator" else launch
                    h, e = _block_us(fn, a, args.calls)
                    host[which].append(h)
                    events[which].append(e)
            med = {k: statistics.median(v) for k, v in host.items()}
            out[name] = {
                "host_us_a_call": host, "events_us_a_call": events,
                "median_host_us": med,
                "median_events_us": {k: statistics.median(v)
                                     for k, v in events.items()},
                "operator_less_direct_us": med["operator"] - med["direct"]}
    model = MSTransception(TransceptionConfig(), "cuda", seed=0)
    x = torch.rand(32, 224, 224, 1,
                   generator=torch.Generator().manual_seed(0)).cuda()

    def fwd():
        with torch.inference_mode():
            return model(x, argmax=True)

    for _ in range(3):
        fwd()
    torch.cuda.synchronize()
    kernels.reset_launches()
    fwd()
    torch.cuda.synchronize()
    n = sum(kernels.launch_counts().values())
    wall = []
    for _ in range(args.repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fwd()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3 / 10)
    diff = statistics.fmean(
        v["operator_less_direct_us"] for v in out.values())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "kernels": out, "forward_launches": n, "forward_wall_ms": wall,
        "median_forward_wall_ms": statistics.median(wall),
        "operator_cost_a_forward_ms": diff * n / 1e3,
        "card": card, "torch": torch.__version__}))


if __name__ == "__main__":
    main()
