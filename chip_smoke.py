"""GPU smoke run of the PyTorch port (transception_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (any failed check exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
  3. each kernel against its plain PyTorch version at every shape the
     serving path gives it (bf16), with timings of kernel, plain version
     and, where one exists, a single PyTorch library call. A kernel that
     adds its input back is held on its branch alone (output minus
     input), and a planted fault in the plain version must fail the same
     check;
  4. the published MSTransception at full width (224², bf16, random
     weights from a seed) through make_predictor(...).predict_volume on a
     synthetic 48-slice 512² volume, batch 32, with launch counters;
  5. the kernel path against use_kernels=False on the same weights, and
     both against an fp32 model (logits and class maps), for three
     weight seeds;
  6. forward time at batch 32, kernels on and off;
  7. device busy time and idle share of one forward (torch.profiler).
The last line is {"ok": true, "device": {...}}; the two lines before it
list each kernel with its launches, error, times and bound, and the
card's name and power limit.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak, FLOP/s
HBM_BYTES = 3.35e12   # H100 SXM HBM3 bandwidth, bytes/s
BATCH = 32
# Long reports (nvcc's register/shared-memory report, the profiler table).
OUT_DIR = Path(os.environ.get("SMOKE_OUT_DIR",
                              Path(__file__).resolve().parent / "smoke_out"))


def log(*a):
    print(*a, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound_ms(nbytes, flops):
    t_b, t_f = nbytes / HBM_BYTES * 1e3, flops / BF16_FLOPS * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def rand(gen, shape, scale=1.0, shift=0.0, dtype=torch.float32):
    t = torch.randn(shape, generator=gen) * scale + shift
    return t.to("cuda", dtype)


def err_check(name, got, want, rel_tol, base=None):
    """max|got - want| against rel_tol x max|want|; with `base` (the input
    a residual kernel adds back) the branch alone is held: got - base
    against want - base, so the residual cannot hide it."""
    got, want = got.float(), want.float()
    if base is not None:
        got, want = got - base.float(), want - base.float()
    err = (got - want).abs().max().item()
    ref = want.abs().max().item()
    ok = math.isfinite(err) and err <= rel_tol * ref
    what = " branch" if base is not None else ""
    log(f"  {name}:{what} max_abs_err {err:.6g} (max|plain{what}| "
        f"{ref:.6g}, tolerance {rel_tol} x that) {'ok' if ok else 'FAIL'}")
    return err, ok


def kernel_cases(gen):
    """One dict per (kernel, main-path shape): kernel fn, plain fn, library
    fn or None, bytes, flops, tolerance, and for the residual kernels the
    input added back (`base`) and a planted fault the check must reject."""
    from transception_tpu_torch.ops.kernels import (
        bridge_attention as ba,
        etb_attention as ea,
        expand_head as eh,
        linear_attention as la,
        mhca_block as mb,
        mixffn as mf,
        patch_expand as pe,
    )
    B = BATCH
    cases = []

    def case(name, label, kfn, pfn, nbytes, flops, tol, lfn=None, base=None,
             fault=None):
        cases.append(dict(name=name, label=label, kfn=kfn, pfn=pfn, lfn=lfn,
                          nbytes=nbytes, flops=flops, tol=tol, base=base,
                          fault=fault))

    # K1: peaked softmaxes (keys and queries scaled up) so the attention
    # branch is of the order of x; fault: keys negated (ctx changes only).
    for N, C in ((3136, 64), (784, 128), (196, 320)):
        x = rand(gen, (B, N, C), 0.25, dtype=torch.bfloat16)
        sc = C ** -0.5
        wq, wk, wv, wp = (rand(gen, (C, C), f * sc) for f in (2, 4, 2, 2))
        v = [rand(gen, (C,), 0.1, 1.0), rand(gen, (C,), 0.1)] + [
            rand(gen, (C,), 0.02) for _ in range(4)]
        args = (x, v[0], v[1], wq, v[2], wk, v[3], wv, v[4], wp, v[5])
        bad = args[:5] + (-wk,) + args[6:]
        case("etb_attention", f"({B},{N},{C})",
             lambda a=args: ea.etb_attention(*a),
             lambda a=args: ea.etb_attention_plain(*a),
             2 * B * N * C * 2 + 4 * C * C * 2, 12 * B * N * C * C, 0.02,
             base=x, fault=("keys negated",
                            lambda a=bad: ea.etb_attention_plain(*a)))
    # K2: fault: the depthwise taps negated.
    for s, C in ((56, 64), (28, 128), (14, 320)):
        hid = 4 * C
        x = rand(gen, (B, s * s, C), dtype=torch.bfloat16)
        args = (x, rand(gen, (C,), 0.1, 1.0), rand(gen, (C,), 0.1),
                rand(gen, (hid, C), C ** -0.5), rand(gen, (hid,), 0.02),
                rand(gen, (hid, 1, 3, 3), 0.3), rand(gen, (hid,), 0.02),
                rand(gen, (hid,), 0.1, 1.0), rand(gen, (hid,), 0.1),
                rand(gen, (C, hid), hid ** -0.5), rand(gen, (C,), 0.02))
        bad = args[:5] + (-args[5],) + args[6:]
        case("mixffn", f"({B},{s * s},{C}) hidden {hid}",
             lambda a=args, s=s: mf.mixffn_ln_skip(*a, s=s),
             lambda a=args, s=s: mf.mixffn_ln_skip_plain(*a, s=s),
             2 * B * s * s * C * 2 + 2 * C * hid * 2 + 9 * hid * 2,
             4 * B * s * s * C * hid + 18 * B * s * s * hid, 0.02,
             base=x, fault=("depthwise taps negated",
                            lambda a=bad, s=s: mf.mixffn_ln_skip_plain(
                                *a, s=s)))
    N, M, d = 6076, 784, 64
    q = rand(gen, (B, 1, N, d), dtype=torch.bfloat16)
    k = rand(gen, (B, 1, M, d), dtype=torch.bfloat16)
    vv = rand(gen, (B, 1, M, d), dtype=torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    case("bridge_attention", f"q ({B},1,{N},{d}) kv ({B},1,{M},{d})",
         lambda a=(q, k, vv): ba.bridge_attention(*a, d ** -0.5),
         lambda a=(q, k, vv): ba.bridge_attention_plain(*a, d ** -0.5),
         2 * B * N * d * 2 + 2 * B * M * d * 2, 4 * B * N * M * d, 0.02,
         lfn=lambda a=(q, k, vv): sdpa(*a, scale=d ** -0.5))
    N, C, c, p, ncls = 3136, 64, 64, 4, 9
    x = rand(gen, (B, N, C), dtype=torch.bfloat16)
    args = (x, rand(gen, (p * p * c, C), (1.0 / C) ** 0.5),
            rand(gen, (c,), 0.1, 1.0), rand(gen, (c,), 0.1),
            rand(gen, (ncls, c), (1.0 / c) ** 0.5), rand(gen, (ncls,), 0.02))
    case("expand_head", f"({B},{N},{C}) -> ids ({B},{N},{p * p})",
         lambda a=args: eh.expand_head(*a, p=p, c=c),
         lambda a=args: eh.expand_head_plain(*a, p=p, c=c),
         B * N * C * 2 + B * N * p * p + p * p * c * C * 2,
         2 * B * N * C * p * p * c + 2 * B * N * p * p * c * ncls, 1e-3)
    # K5: the qkv weight scaled up so softmax(K) is peaked and Q · ctx is
    # of the order of the CRPE term; fault: the key rows of qkv negated.
    for s, C in ((28, 64), (14, 128)):
        hid, heads, N = 4 * C, 8, s * s
        chs = [h * C // heads for _, h in ((3, 2), (5, 3), (7, 3))]
        x = rand(gen, (B, N, C), 0.5, dtype=torch.bfloat16)
        wqkv = rand(gen, (3 * C, C), 3 * C ** -0.5)
        rest = (rand(gen, (3 * C,), 0.02),
                [rand(gen, (n, 1, k, k), 1.0 / k) for n, k in
                 zip(chs, (3, 5, 7))],
                [rand(gen, (n,), 0.02) for n in chs],
                rand(gen, (C, C), C ** -0.5), rand(gen, (C,), 0.02),
                rand(gen, (C,), 0.1, 1.0), rand(gen, (C,), 0.1),
                rand(gen, (hid, C), C ** -0.5), rand(gen, (hid,), 0.02),
                rand(gen, (hid, 1, 3, 3), 0.3), rand(gen, (hid,), 0.02),
                rand(gen, (hid,), 0.1, 1.0), rand(gen, (hid,), 0.1),
                rand(gen, (C, hid), hid ** -0.5), rand(gen, (C,), 0.02))
        head = (x, rand(gen, (C, 1, 3, 3), 0.3), rand(gen, (C,), 0.02),
                rand(gen, (C,), 0.1, 1.0), rand(gen, (C,), 0.1))
        args = head + (wqkv,) + rest
        wbad = wqkv.clone()
        wbad[C:2 * C] *= -1
        bad = head + (wbad,) + rest
        case("mhca_block", f"({B},{N},{C}) heads {heads} hidden {hid}",
             lambda a=args, s=s: mb.mhca_block(*a, s=s, heads=8),
             lambda a=args, s=s: mb.mhca_block_plain(*a, s=s, heads=8),
             2 * B * N * C * 2 + (4 * C * C + 2 * C * hid + 9 * hid) * 2,
             B * N * (8 * C * C + 4 * C * C // heads + 78 * C
                      + 4 * C * hid + 18 * hid), 0.02,
             base=x, fault=("key rows of qkv negated",
                            lambda a=bad, s=s: mb.mhca_block_plain(
                                *a, s=s, heads=8)))
    # K6: stage-4 factorized attention, q/k/v (B, 8, 49, 40).
    q, k, v = (rand(gen, (B, 8, 49, 40), f, dtype=torch.bfloat16)
               for f in (1.0, 3.0, 1.0))
    case("linear_attention", f"q/k/v ({B},8,49,40)",
         lambda a=(q, k, v): la.linear_attention(*a),
         lambda a=(q, k, v): la.linear_attention_plain(*a),
         4 * B * 8 * 49 * 40 * 2, 4 * B * 8 * 49 * 40 * 40, 0.02)
    # K7: the p = 2 expanders of decoders 3/2/1.
    for N, C in ((49, 512), (196, 320), (784, 128)):
        c = C // 2
        x = rand(gen, (B, N, C), dtype=torch.bfloat16)
        args = (x, rand(gen, (4 * c, C), C ** -0.5),
                rand(gen, (c,), 0.1, 1.0), rand(gen, (c,), 0.1))
        case("patch_expand", f"({B},{N},{C}) -> ({B},{N},{4 * c})",
             lambda a=args, c=c: pe.patch_expand(*a, p=2, c=c),
             lambda a=args, c=c: pe.patch_expand_plain(*a, p=2, c=c),
             B * N * C * 2 + B * N * 4 * c * 2 + 4 * c * C * 2,
             2 * B * N * C * 4 * c, 0.02)
    return cases


# Launches per forward of each kernel at each of its kernel_cases shapes.
PER_FORWARD = {"etb_attention": (4, 2, 2), "mixffn": (4, 2, 2),
               "bridge_attention": (3,), "expand_head": (1,),
               "mhca_block": (9, 24), "linear_attention": (9,),
               "patch_expand": (1, 1, 1)}


def kernel_phase():
    """Phase 3. Returns per-kernel sums over one forward's launches."""
    from transception_tpu_torch.ops import kernels
    seen = {}
    summary = {}
    gen = torch.Generator().manual_seed(1)
    for cs in kernel_cases(gen):
        name, label = cs["name"], cs["label"]
        i = seen.get(name, 0)
        seen[name] = i + 1
        mult = PER_FORWARD[name][i]
        got, want = cs["kfn"](), cs["pfn"]()
        torch.cuda.synchronize()
        if got.shape != want.shape:
            fail(f"{name} {label}: shape {tuple(got.shape)} vs "
                 f"{tuple(want.shape)}")
        if name == "expand_head":
            err = (got != want).float().mean().item()
            ok = err <= cs["tol"]
            log(f"  {name} {label}: id mismatch fraction {err:.6g} "
                f"(tolerance {cs['tol']}) {'ok' if ok else 'FAIL'}")
        else:
            err, ok = err_check(f"{name} {label}", got, want, cs["tol"],
                                cs["base"])
        if not ok:
            fail(f"{name} disagrees with its plain version")
        if cs["fault"] is not None:
            what, ffn = cs["fault"]
            _, caught = err_check(f"  planted fault ({what}) vs plain",
                                  ffn(), want, cs["tol"], cs["base"])
            if caught:
                fail(f"{name}: the check does not see a planted fault")
        ms, pms = cuda_ms(cs["kfn"]), cuda_ms(cs["pfn"], iters=5)
        lms = cuda_ms(cs["lfn"]) if cs["lfn"] else None
        bms, by = bound_ms(cs["nbytes"], cs["flops"])
        log(f"    ms {ms:.4f} plain_ms {pms:.4f} library_ms "
            f"{lms if lms is None else round(lms, 4)} bound_ms {bms:.4f} "
            f"({by}) x{mult} per forward")
        s = summary.setdefault(name, {
            "name": name, "route": "cuda",
            "source": f"transception_tpu_torch/csrc/{name}.cu",
            "replaces": getattr(kernels, name).REPLACES,
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "library_ms": None if lms is None else 0.0,
            "_bytes": 0, "_flops": 0})
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["ms"] += mult * ms
        s["plain_ms"] += mult * pms
        s["bound_ms"] += mult * bms
        if lms is not None:
            s["library_ms"] += mult * lms
        s["_bytes"] += mult * cs["nbytes"]
        s["_flops"] += mult * cs["flops"]
    for s in summary.values():
        s["bound_by"] = bound_ms(s.pop("_bytes"), s.pop("_flops"))[1]
    return summary


LAUNCHES_PER_FORWARD = {k: sum(v) for k, v in PER_FORWARD.items()}


def compare_paths(model, x, seed):
    """Logits and class maps of the kernel path against the plain path on
    the same weights and against an fp32 plain model; fails past the
    thresholds. Returns the plain bf16 model."""
    from transception_tpu_torch.core.config import TransceptionConfig
    from transception_tpu_torch.models.transception import MSTransception
    plain = MSTransception(TransceptionConfig(use_kernels=False), "cuda")
    plain.load_state_dict(model.state_dict())
    ref = MSTransception(TransceptionConfig(dtype="float32",
                                            use_kernels=False), "cuda")
    ref.load_state_dict(model.state_dict())
    with torch.inference_mode():
        lk, lp, lr = model(x), plain(x), ref(x)
        ik, ip, ir = (m(x, argmax=True) for m in (model, plain, ref))
    torch.cuda.synchronize()
    if not all(torch.isfinite(t).all() for t in (lk, lp, lr)):
        fail("non-finite logits")

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    def agree(a, b):
        return (a == b).float().mean().item()

    r_kp, a_kp = rel(lk, lp), agree(ik, ip)
    r_kr, r_pr = rel(lk, lr), rel(lp, lr)
    a_kr, a_pr = agree(ik, ir), agree(ip, ir)
    log(f"  weight seed {seed}: logits {tuple(lk.shape)} max|kernel-plain|/"
        f"max|plain| {r_kp:.6g} (threshold 0.05); vs fp32 model: kernel "
        f"{r_kr:.6g}, plain {r_pr:.6g}")
    log(f"  weight seed {seed}: class maps kernel-plain agreement {a_kp:.6f} "
        f"(threshold 0.98); vs fp32 model: kernel {a_kr:.6f}, plain "
        f"{a_pr:.6f} (kernel may trail plain by at most 0.005)")
    if r_kp > 0.05 or a_kp < 0.98 or a_kr < a_pr - 0.005:
        fail("kernel path disagrees with the plain path")
    return plain


def model_phase():
    from transception_tpu_torch.core.config import TransceptionConfig
    from transception_tpu_torch.eval.inference import (
        make_predictor,
        resize_slices,
    )
    from transception_tpu_torch.models.transception import MSTransception
    from transception_tpu_torch.ops import kernels

    cfg = TransceptionConfig()
    t0 = time.perf_counter()
    model = MSTransception(cfg, device="cuda", seed=0)
    log(f"  model built: {sum(p.numel() for p in model.parameters())} "
        f"params, {time.perf_counter() - t0:.1f} s")
    vol = np.random.default_rng(0).random((48, 512, 512), dtype=np.float32)
    predict = make_predictor(model, cfg.img_size, BATCH)
    predict.predict_volume(vol[:BATCH])  # warm-up (cuDNN plans, caches)
    torch.cuda.synchronize()

    kernels.reset_launches()
    t0 = time.perf_counter()
    pred = predict.predict_volume(vol)
    torch.cuda.synchronize()
    vol_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    n_fwd = math.ceil(vol.shape[0] / BATCH)
    log(f"  predict_volume: {pred.shape} {pred.dtype} in {vol_s:.3f} s, "
        f"{n_fwd} forwards, launches {counts}")
    if pred.shape != (48, 224, 224) or pred.dtype != np.uint8:
        fail(f"predict_volume output {pred.shape} {pred.dtype}")
    if pred.max() >= cfg.num_classes:
        fail(f"class id {pred.max()} out of range")
    for name in counts:
        per = LAUNCHES_PER_FORWARD[name]
        if counts[name] != per * n_fwd:
            fail(f"{name}: {counts[name]} launches, want {per} x {n_fwd}")
    log(f"  classes present: {np.bincount(pred.ravel(), minlength=9)}")

    # Phase 5: kernel path vs plain path on the same weights, and both
    # against an fp32 model (plain, no TF32) as the noise floor of bf16,
    # for three weight seeds.
    sl = resize_slices(vol[:BATCH], cfg.img_size)
    x = torch.from_numpy((sl - 0.5) / 0.5).cuda()[..., None]
    plain = None
    for seed in (0, 1, 2):
        m = model if seed == 0 else MSTransception(cfg, "cuda", seed)
        p = compare_paths(m, x, seed)
        if seed == 0:
            plain = p
        else:
            del m, p

    # Phase 6: forward time at batch 32.
    def fwd(m):
        with torch.inference_mode():
            return m(x, argmax=True)

    t_on = cuda_ms(lambda: fwd(model), iters=10)
    t_off = cuda_ms(lambda: fwd(plain), iters=5)
    t_on2 = cuda_ms(lambda: fwd(model), iters=10)
    log(f"  forward b={BATCH} argmax: kernels {t_on:.3f} / {t_on2:.3f} "
        f"ms/batch ({BATCH * 1e3 / min(t_on, t_on2):.1f} slices/s), plain "
        f"{t_off:.3f} ms/batch ({BATCH * 1e3 / t_off:.1f} slices/s)")
    log(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    log("phase 7: device time of one kernel-path forward (torch.profiler)")
    profile_forward(lambda: fwd(model))
    return counts


def profile_forward(fn):
    """Device busy time, idle share and the top kernels of one forward."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        log("  the profiler saw no device activity: not measured")
        return
    by_name = Counter()
    for e in kern:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    ours = sum(t for n, t in by_name.items() if any(
        k in n for k in ("etb_", "mixffn_ln_skip", "bridge_attention_kernel",
                         "expand_head_kernel", "mhca_", "patch_expand_kernel",
                         "linear_attention_kernel")))
    log(f"  {len(kern)} device activities, busy {busy:.3f} ms of "
        f"{wall_ms:.3f} ms wall (idle share {1 - busy / wall_ms:.3f}); "
        f"port kernels {ours:.3f} ms")
    for name, t in by_name.most_common(12):
        log(f"    {t:9.3f} ms  {name[:90]}")
    (OUT_DIR / "chip_smoke_profile.txt").write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total",
                                  row_limit=60))


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    import transception_tpu_torch  # noqa: F401  (fails outside the repo)
    from transception_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = gpu_line()
    log(f"phase 1: {card}")
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    log("phase 2: build kernels")
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"  built {sorted(secs)} in {time.perf_counter() - t0:.1f} s "
        f"(per library {({k: round(v, 1) for k, v in secs.items()})})")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke_ptxas.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in _build.build_logs.items()))

    log("phase 3: kernels vs plain versions (bf16, batch 32)")
    summary = kernel_phase()

    log("phase 4-6: published model through predict_volume")
    counts = model_phase()

    rows = []
    for name, s in summary.items():
        s["launches"] = counts[name]
        rows.append({k: s[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    log(json.dumps({"kernels": rows}))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
