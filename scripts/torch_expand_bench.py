"""Time the port's expand kernels, K4 (expand_head) and K7 (patch_expand),
from the port in any checkout, so that two versions can be compared in
one run on one card.

    python3 scripts/torch_expand_bench.py [--root DIR] [--label NAME]

Imports `transception_tpu_torch` from DIR (default: this checkout), builds
its two expand libraries there, and at the serving shapes (b=32: K4 at
(32, 3136, 64) -> the (32, 224, 224) class map; K7 at the p = 2 expanders
of decoders 3/2/1 and the x4 expander of the logits path, in the shuffled
and the pre-shuffle layout) prints one JSON line: per kernel and shape the
disagreement with the plain version (K4: the fraction of ids that differ;
K7: max |kernel - plain|), the time a launch with CUDA events over 20
launches (host enqueue included) and the device time a launch from
torch.profiler over 10. Inputs are drawn from a seeded generator. Exits
non-zero without a card. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch


def events_ms(fn, n=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def device_ms(fn, name, n=10):
    """Device ms a launch of the kernels whose name holds `name`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ts = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
          if e.device_type == DeviceType.CUDA and name in e.name]
    return sum(ts) / max(1, len(ts))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA card: this benchmark needs one")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from transception_tpu_torch.ops.kernels import _build
    from transception_tpu_torch.ops.kernels import expand_head as eh
    from transception_tpu_torch.ops.kernels import patch_expand as pe

    _build.build(["expand_head", "patch_expand"])
    gen = torch.Generator().manual_seed(0)

    def rand(*shape, scale=1.0, shift=0.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * scale + shift).to(
            "cuda", dtype)

    bf = torch.bfloat16
    out = dict(label=args.label, root=str(Path(args.root).resolve()),
               device=torch.cuda.get_device_name(0))
    hargs = (rand(32, 3136, 64, dtype=bf), rand(1024, 64, scale=0.125),
             rand(64, scale=0.1, shift=1.0), rand(64, scale=0.1),
             rand(9, 64, scale=0.125), rand(9, scale=0.02))

    def k4():
        return eh.expand_head(*hargs, p=4, c=64, shuffle=(56, 56))

    want = eh.expand_head_plain(*hargs, p=4, c=64, shuffle=(56, 56))
    out["K4 (32,3136,64)"] = dict(
        mismatch=(k4() != want).float().mean().item(), ms=events_ms(k4),
        device_ms=device_ms(k4, "expand_head_kernel"))
    for B, H, C, p in ((32, 7, 512, 2), (32, 14, 320, 2), (32, 28, 128, 2),
                       (32, 56, 64, 4)):
        c = C // 2 if p == 2 else C
        kargs = (rand(B, H * H, C, dtype=bf),
                 rand(p * p * c, C, scale=C ** -0.5),
                 rand(c, scale=0.1, shift=1.0), rand(c, scale=0.2))
        for shuffle in ((H, H), None):
            def k7(a=kargs, p=p, c=c, shuffle=shuffle):
                return pe.patch_expand(*a, p=p, c=c, shuffle=shuffle)
            plain = pe.patch_expand_plain(*kargs, p=p, c=c, shuffle=shuffle)
            layout = "shuffled" if shuffle else "pre-shuffle"
            out[f"K7 ({B},{H * H},{C}) p={p} {layout}"] = dict(
                err=(k7().float() - plain.float()).abs().max().item(),
                ms=events_ms(k7), device_ms=device_ms(k7, "patch_expand"))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
