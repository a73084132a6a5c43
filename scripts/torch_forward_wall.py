"""Time the published model's eval forward on the card from the port in
any checkout, so that two versions (say, kernel launches through ctypes
against the same launches as torch.library operators) can be compared in
one run on one card.

    python3 scripts/torch_forward_wall.py [--root DIR] [--label NAME]
        [--batch 32] [--dtype bfloat16] [--iters 20] [--repeats 5]

Imports `transception_tpu_torch` from DIR (default: this checkout), builds
its kernels there, and times MSTransception(TransceptionConfig(dtype))'s
argmax forward (the predictor's) on a (batch, 224, 224, 1) input drawn
from a seeded generator: `repeats` times, the host's wall clock over
`iters` forwards (the card synchronised before and after) and CUDA events
over the same span. Prints one JSON line with every repeat, the medians,
the card's name and power limit and torch's version. Exits non-zero
without a card. Imports nothing of JAX.
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


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    p.add_argument("--label", default=None)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--repeats", type=int, default=5)
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from transception_tpu_torch.core.config import TransceptionConfig
    from transception_tpu_torch.models.transception import MSTransception
    from transception_tpu_torch.ops.kernels import _build

    _build.build()
    model = MSTransception(TransceptionConfig(dtype=args.dtype), "cuda",
                           seed=0)
    g = torch.Generator().manual_seed(0)
    x = torch.rand(args.batch, 224, 224, 1, generator=g).cuda()

    def fwd():
        with torch.inference_mode():
            return model(x, argmax=True)

    for _ in range(3):
        fwd()
    torch.cuda.synchronize()
    wall, events = [], []
    for _ in range(args.repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        for _ in range(args.iters):
            fwd()
        b.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3 / args.iters)
        events.append(a.elapsed_time(b) / args.iters)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "label": args.label or args.root, "batch": args.batch,
        "dtype": args.dtype, "iters": args.iters, "wall_ms": wall,
        "events_ms": events, "median_wall_ms": statistics.median(wall),
        "median_events_ms": statistics.median(events), "card": card,
        "torch": torch.__version__}))


if __name__ == "__main__":
    main()
