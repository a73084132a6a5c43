"""Device time of the PyTorch port's b=32 forward on one CUDA card, for the
port in any checkout, so that two commits can be compared in one run.

    python3 scripts/torch_profile_forward.py [--root DIR] [--label NAME]

Imports `transception_tpu_torch` from DIR (default: this checkout), builds
its kernels there, builds the published `TransceptionConfig()` model at
full width (random weights, seed 0), and profiles forwards of a seeded
batch of 32 slices (argmax head, kernels on) with torch.profiler: device
busy time, wall time, idle share, device activities, cudaLaunchKernel
calls, the port's kernels summed by name, and the device time and
launches per forward of the kernels named in NAMED (K4, K7, by the
substring of their CUDA kernel's name). Prints one JSON line per
profiled forward (--repeats, default 3) and exits non-zero without a card.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter
from pathlib import Path

import torch

# Substrings of the port's kernel names (every csrc/ kernel has one).
PORT = ("etb_", "lin_", "mixffn_", "bridge_attention", "expand_head",
        "mhca_", "patch_expand", "linear_attention", "rows_kernel",
        "cols_kernel", "sum_partials")
# Kernels whose device time per forward is reported on its own.
NAMED = {"K4 expand_head": "expand_head_kernel",
         "K7 patch_expand": "patch_expand_kernel"}


def profile(model, x) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    with torch.inference_mode():
        model(x, argmax=True)
        torch.cuda.synchronize()
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(x, argmax=True)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    by_name, calls = Counter(), Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3
            calls[e.name] += 1
    busy = sum(by_name.values())
    port = {n: t for n, t in by_name.items() if any(k in n for k in PORT)}
    return dict(
        busy_ms=busy, wall_ms=wall, idle_share=1 - busy / wall,
        device_activities=sum(1 for e in prof.events()
                              if e.device_type == DeviceType.CUDA),
        launch_calls=sum(1 for e in prof.events()
                         if e.name.startswith("cudaLaunchKernel")),
        port_ms=sum(port.values()),
        named={k: dict(ms=round(sum(t for n, t in by_name.items()
                                    if sub in n), 4),
                       launches=sum(c for n, c in calls.items() if sub in n))
               for k, sub in NAMED.items()},
        port_top={n[:80]: round(t, 4) for n, t in
                  sorted(port.items(), key=lambda kv: -kv[1])[:8]})


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA card: this profile needs one")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from transception_tpu_torch.core.config import TransceptionConfig
    from transception_tpu_torch.models.transception import MSTransception
    from transception_tpu_torch.ops.kernels import _build

    _build.build()
    model = MSTransception(TransceptionConfig(), device="cuda", seed=0)
    gen = torch.Generator().manual_seed(0)
    x = (torch.rand((32, 224, 224, 1), generator=gen) * 2 - 1).cuda()
    for i in range(args.repeats):
        out = profile(model, x)
        print(json.dumps(dict(label=args.label, repeat=i,
                              root=str(Path(args.root).resolve()),
                              device=torch.cuda.get_device_name(0), **out)),
              flush=True)


if __name__ == "__main__":
    main()
