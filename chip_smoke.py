"""GPU smoke run of the PyTorch port (transception_tpu_torch) on one card
(phase 14 also spawns ranks on every other visible card).

    python3 chip_smoke.py

Phases (any failed check exits non-zero):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel);
     the ptxas report (registers, spills) of the kernels redesigned for
     registers and the card's tensor cores, K3, K10, K8, K4, K7 (and the
     fp32 forms in their libraries, K3's, K8's and K10's on 3xTF32) and
     every stage of K1, K2, K5, K6, K9 and K11, which must not spill;
  3. each kernel against its plain PyTorch version at every shape the
     serving path gives it in any fold configuration (bf16, batch 32) and
     at the shapes the "pallas" train step gives K1, K5-K7 and K9 (batch
     24), with timings of kernel, plain version and, where one exists, a
     single PyTorch library call. A kernel that adds its input back is
     held on its branch alone (output minus input), and a planted fault in
     the plain version must fail the same check. K4 and K7 are held in
     both layouts (the shuffled one the model asks for, and pre-shuffle
     order), K7 also at the logits path's x4 shape, K4 also at batch 1,
     both at maps that leave a partial token tile (checks off the main
     path are logged, not rows of the kernels line); and the fp32 forms
     (K1, K2, K5, K6, K3, K8, K7 in both layouts) at every shape the fp32
     eval forward gives them in the published model, its K8 fold
     configurations and the ablation variants (K8's fp32 form beside
     "SDPA fp32 + 2 F.linear + add", K2 at the bridge folds, K6 at the ETB
     maps and the 4-stage backbone's 56² stage; K3 and K8 also at ragged
     stream tiles, N = 129 and 300), and those the fp32 "pallas" train
     step gives K1, K5, K6, K7 and K9 (batch 24), against their fp32
     plain versions with TF32 off within FP32_TOL, each with a planted
     fault, bounds at the fp32 FFMA peak (K3's and K8's, which multiply as
     3xTF32 on the tensor cores, at TF32X3_FLOPS with the FFMA bound
     logged beside), K3 beside SDPA at fp32; the bf16 shapes of phase
     13's batch-8 forwards; the legacy models' (phase 15) K6 shapes at
     batch 32 (bf16 and fp32) and 24 (bf16) and K7's x4 expand in the
     shuffled layout at batch 24 (bf16 and fp32); and K3's, K8's and K10's
     fp32 forms with a NaN in an input, which must come out where the
     plain version's does;
  4. the published MSTransception at full width (224², bf16, random
     weights from a seed) through make_predictor(...).predict_volume on a
     synthetic 48-slice 512² volume, batch 32, with launch counters;
  5. the kernel path against use_kernels=False on the same weights and
     the same fold structure, and both against an fp32 model (logits and
     class maps), for three weight seeds;
  6. forward time at batch 32, kernels on and off (same structure);
  7. device busy time and idle share of one forward (torch.profiler), the
     device time of each stage of K1, K2, K5 and K6 and of K4 and K7 by
     kernel name, and the device activities per forward;
     then 5-7 at fp32: the published model at dtype float32 on its fp32
     kernels against its plain path (logits, class maps, launches exactly
     launches_per_forward), forward time and device busy time;
  8. the train step's kernels against their plain versions at every shape
     the published train step gives them (bf16, batch 24): the bridge
     attention (K3) and its backward (K10), the MixFFN backward (K11) and
     the grouped MixFFN forward (K2), the backwards and K2 each with a
     planted fault the check must reject (K3 and K10 with their share of
     the bound and their factor against SDPA), and K8 at batch 24 (the sp
     and para bridges and MISSFormer's keep it in training; also at fp32,
     MISSFormer's fp32 step); and for each kernel whose
     backward is autograd of its plain version (K1, K5-K9), one backward
     through its autograd Function against autograd of the plain version;
     then the same at fp32 (TF32 off): K3, K10, K11 and K2 at every fp32
     train shape within FP32_TOL, planted faults, bounds at the fp32 peak
     (K3's and K10's, 3xTF32, at TF32X3_FLOPS with the FFMA bound logged
     beside), K3 and K10 beside SDPA at fp32, and K10 also at ragged
     shapes (N 300 against M 800 and 240, B·h above 1; held, not rows);
  9. the published MSTransception train step (TrainConfig(): batch 24,
     wide head, SGD + cosine schedule) in three train modes (default,
     ffn_flash_train, and "pallas": use_pallas_train with mhca_ffn_fold
     and drop_path_rate 0.1): Trainer.train on the on-device synthetic
     stream (device_data) with the launch counts per step held to
     models.transception.launches_per_step, a checkpoint, the in-training
     eval (on one small synthetic volume, its launches per chunk held to
     launches_per_forward) and a resume;
     one step against the plain path (use_kernels=False) from the same
     weights on the same batch with the same drop-path masks (loss, every
     gradient leaf, BatchNorm stats) with planted faults in K10, K11 and
     K9; the loss falling over repeated steps on one batch; step time and
     peak memory, kernels on and off; device time of one step
     (torch.profiler); then each mode at TransceptionConfig(dtype=
     "float32"): one step on the fp32 kernels against the plain path
     within FP32_LIMITS, launches exactly launches_per_step, planted
     faults in the fp32 K10, K11 and K9, step time and peak memory,
     device busy time of a step (torch.profiler);
 10. the fold grid: the published model (b=32) under each fold
     configuration of FOLD_GRID, with the launches per forward held to
     models.transception.launches_per_forward (argmax and logits
     forwards), the class maps to "folds-off"'s, the kernel path to
     use_kernels=False under the same config, and the forward time; then
     the three configurations with bridge_attn_fold once at fp32, on K8's
     fp32 form (launches exact, kernel vs plain within phase 5's fp32
     limits);
 11. volume eval: the published model through run_inference on one
     synthetic 512² volume's first 8 slices (its log lines, launches per
     chunk, the wall time split into load, resample, forward, back-resize
     and the wait for the metrics, and the metric thread's time), the two
     on-card resample paths against the host path with TF32 off and on
     (two volumes), the full-resolution class maps of the kernels against
     the plain path, and cli.test.main in-process on run_inference's
     volume: bf16 --is_savenii from a .pth of the same weights, which
     must give run_inference's means and volumes that load back; one pass of the fp32 default (the fp32 kernels,
     launches per chunk held to launches_per_forward, finite means); fp16
     with the kernels on, which must raise before any work, naming --dtype
     float32, --dtype bfloat16 and --no_pallas;
 12. the train CLI (cli.train.main in-process at --dp_size 1, else its
     defaults: bf16, the published model, b=24, augment, 4 loader
     threads) on Synapse-format
     .npz slices of 512² written for the run: log lines, a checkpoint, the
     end-of-run eval on one small synthetic volume (finite dice/HD95,
     per-class lines), results.tsv, launches per step and per eval chunk exact; a
     second call resuming under --profile (its trace); --throughput at
     bf16 and fp32; a step's wall time beside its device busy time with
     the host loader, at both dtypes.
 13. the ablation family (models/registry.py) at full width: the four
     variants (4-stage and casa backbones, sp and para bridges) through
     predict_volume at b=32 in bf16 and fp32 (launches exactly
     launches_per_forward, the kernel path against use_kernels=False and
     at bf16 against an fp32 model, forward time) and one b=24 train step
     each in the default mode against the plain path (the bf16 step
     limits, launches exactly launches_per_step); one bf16 forward at b=8
     for each other IFF mode, each token MLP and no bridge, held the same
     way; cli.test.main with --have_bridge sp at its fp32 default on one
     64² synthetic volume (every K8 call the fp32 kernel, none its plain
     version); cli.train.main --model mstransception_para --dp_size 1 for
     2 steps with its end-of-run eval on that volume.
 14. data parallelism (parallel.mesh): a process group over NCCL of
     torch.cuda.device_count() ranks (forced at one rank on a one-card
     machine); one b=24 step through the data-parallel Trainer in bf16
     default, bf16 ffn_flash_train and fp32 default against the
     one-process Trainer's step (phase 9's limits, launches exactly
     launches_per_step, bit equality logged; ms a step, DP and one
     process, CUDA events over DP_TIME_STEPS); the test CLI's
     slice-sharded eval against --dp_size 1 (means, per-case lines, class
     maps);
     --dp_size beyond the cards refused; with two cards or more, the same
     at world 2 (and at every card) in spawned ranks.
 15. the legacy model family (models/legacy.py: transception, missformer,
     effmissformer, resinception, resinception_135) at full width,
     TransceptionConfig()'s head_count 8 and dilated schedules: each
     through predict_volume at b=32 in bf16 and fp32 (launches exactly
     legacy.launches_per_forward; the kernel path against use_kernels=False
     within phase 13's limits; forward time), one b=24 bf16 train step on
     the kernels, on the plain path and at fp32 on the plain path (the
     kernel step's distance from the fp32 step at most BF16_LIMITS beyond
     the plain step's; kernel against plain within BF16_LIMITS, but for
     the two ResInception models, whose bf16 noise floor, logged, is above
     them); an fp32 kernel step for MISSFormer and the ResInceptions within
     FP32_LIMITS; launches exactly legacy.launches_per_step; step time),
     each model's times on one line with the card's name and power limit; cli.test.main --model missformer at its fp32 default on one
     64² synthetic volume; cli.train.main --model resinception for
     CLI_STEPS steps (the checkpoint's BatchNorm statistics against the
     trained model's, and restored into a fresh model), then a call that
     resumes from it for one more step.
 16. ISIC 2018 (data/isic.py) on the published model at 2 classes:
     dice_eval at b=32 over synthetic lesions and a preprocessed .npz
     written for the run, bf16 and fp32, kernels against use_kernels=False
     (per-image masks >= 0.99 equal at bf16, at fp32 every pixel but
     near-ties of the plain path's logits; the mean-dice gap; launches exactly launches_per_forward(argmax=False));
     a b=24 train step on the Trainer's ISIC batch at bf16 and fp32
     against the plain step (BF16_LIMITS / FP32_LIMITS, launches exactly
     launches_per_step); cli.test --dataset ISIC.
 17. the serving export (serve/export.py): cli.export of the published
     model at --export_batch 32, bf16, its program's kernel operators
     those the eager forward launches; loaded in a fresh process that
     never imports the models, its logits against the eager forward's
     (bit for bit, or within two eager runs' spread) and its launches
     exactly launches_per_forward(argmax=False); --plain_xla for the CPU
     (one block a stage), run in a process that sees no card, against the
     eager CPU forward.
 18. remat: the b=24 bf16 "pallas" step (drop path 0.1) twice without and
     once with TransceptionConfig.remat, two steps each: losses,
     gradients, parameters, BatchNorm statistics within twice the
     run-to-run spread, the generators' states equal, launches exactly
     launches_per_step (the recompute's included), peak memory of both
     beside the card's name and power limit.
 19. utils/profiling.py on the b=32 bf16 logits forward:
     device_time_per_call against CUDA events around the same traced
     calls (each within 10%), cost_analysis of the kernel
     and the plain path (equal flops and bytes), profile_model_sections.
 20. the tensor-parallel axis: (a) K2's and K11's hidden-sharded forms
     (mixffn_tp, mixffn_tp_bwd) at the ETB folds of the train steps
     (b=24), tp 2 and 4, bf16 and fp32, each shard's stages in turn with
     the partials summed in rank order, against the unsharded kernel and
     the sharded plain stages (phase 8's limits, planted faults), each
     stage timed; (b) a tp=2 step (published widths, one block and one
     path a stage) as two spawned ranks sharing card 0 over gloo, in the
     default, flash and pallas modes at bf16 and flash at fp32, against
     the one-process step (phase 9's limits, launches exactly
     launches_per_step(cfg, tp)), the flash checkpoint resumed in one
     process; NCCL tp 2 with two cards, dp2 x tp2 and tp 4 with four;
     (c) --tp_size beyond the cards refused before any work.
 21. the bridge's sequence sharding (bridge_seq_shard_axis "model"):
     (a) K2's and K11's row-block forms (a block of map rows with its
     halo rows) at every bridge scale tp 2 and 4 split (b=24, C = 64·m,
     bf16 and fp32) against their plain versions, the interior rows
     against the full-map K2, the blocks' K11 gradients summed against
     the full-map K11 (planted faults: the halo rows dropped, their dx
     left out), rank 0's block timed; (b) K3, K10 and K8 on each rank's
     query rows (3038 and 1519 of 6076) against the full-stream launch,
     dk/dv summed (fault: not summed); (c) a sequence-sharded tp=2 step
     in phase 20's four modes as two gloo ranks on card 0 against phase
     20's one-process step (phase 9's limits, launches exactly
     launches_per_step), its checkpoint resumed in one process, and the
     sharded eval forward (the bridge's folds on) at bf16 and fp32
     against the one process (class maps, logits, launches).
 22. the legacy models under TP, the per-path MHCA layout and
     --debug_nans: (a) K5's sharded form (the per-path layout's MHCA
     block under the model axis: its qkv columns, the gathered q|k|v, its
     FFN shard) and K9's hidden-sharded form at tp 2 and 4 on one card
     (b=32 and the b=24 shapes of (b)), bf16 and fp32, each rank's stages
     in turn, against the unsharded kernel and the sharded plain stages
     (phase 3's limits, a planted fault), rank 0's stages timed; (b) the
     per-path layout's tp=2 "pallas" step and sharded eval forward
     (published widths, three paths, one block a stage) as two gloo ranks
     on card 0 against one process (phase 9's limits, class maps,
     launches exactly launches_per_step / launches_per_forward); (c)
     MISSFormer's tp=2 step the same way; (d) a planted NaN under
     --debug_nans (cli.common.nan_checks) raising FloatingPointError.
Every launch of the main-path runs (phases 4, 5-7 at fp32, 9, 10, 11, 12,
13, 14, 15, 16, 18, 20, 21 and 22) is tallied by shape
(ops.kernels.shape_counts); each shape must have been measured in phase
3, 8, 20 (a), 21 (a, b) or 22 (a). The last line is {"ok": true, "device":
{...}}; the two lines before it list each kernel at each shape (one row
per shape) with its launches in those runs, its error and its per-launch
times and bound, then the card's name and power limit. Before them, per
run, each kernel's launches and summed times.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak, FLOP/s
FP32_FLOPS = 67e12    # H100 SXM fp32 peak outside the tensor cores (FFMA)
# fp32-accurate products as 3 TF32 products each (3xTF32) on the tensor
# cores' dense TF32 peak: the bound of K3's, K8's and K10's fp32 forms,
# which multiply so (their FFMA bound at FP32_FLOPS is logged beside it).
TF32X3_FLOPS = 495e12 / 3
# The fp32 kernels against their fp32 plain versions (TF32 off), stated
# before the first card run: max|kernel - plain| <= FP32_TOL x max|plain|
# (branch alone for the residual kernels); the fp32 forward's logits within
# FP32_LOGITS_TOL x max|logit| of the plain path's, its class maps at
# least FP32_AGREE equal.
FP32_TOL = 1e-4
FP32_LOGITS_TOL = 1e-3
FP32_AGREE = 0.999
HBM_BYTES = 3.35e12   # H100 SXM HBM3 bandwidth, bytes/s
BATCH = 32
TRAIN_BATCH = 24      # TrainConfig().batch_size
# Long reports (nvcc's register/shared-memory report, the profiler table).
OUT_DIR = Path(os.environ.get("SMOKE_OUT_DIR",
                              Path(__file__).resolve().parent / "smoke_out"))


def _combo(attn, ffn, etb, etb_ffn=True):
    return dict(bridge_attn_fold=attn, bridge_ffn_use_pallas=ffn,
                etb_attn_fold=etb, etb_ffn_fold=etb_ffn)


# The fold configurations the JAX package's users pick among: the eight of
# its sweep (scripts/measure_folds.py:56-67; the MHCA switches at their
# defaults, the ETB FFN fold on unless named), plus the MHCA block unfolded
# with its FFN fold off and on. (name, TransceptionConfig overrides.)
FOLD_GRID = (
    ("all-on", _combo(True, True, True)),
    ("attn-off", _combo(False, True, True)),
    ("ffn-off", _combo(True, False, True)),
    ("etb-off", _combo(True, True, False)),
    ("ffn-only", _combo(False, True, False)),
    ("etb-only", _combo(False, False, True)),
    ("etbffn-off", _combo(False, False, True, etb_ffn=False)),
    ("folds-off", _combo(False, False, False)),
    ("mhca-unfolded", dict(mhca_block_fold=False, mhca_ffn_fold=False)),
    ("mhca-ffn-fold", dict(mhca_block_fold=False, mhca_ffn_fold=True)),
)


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


def bound_ms(nbytes, flops, peak=BF16_FLOPS):
    """The least time of a kernel's work: its bytes at the HBM rate or its
    operations at `peak` (the bf16 tensor-core rate, FP32_FLOPS for the
    fp32 forms on the CUDA cores, TF32X3_FLOPS for those on 3xTF32),
    whichever is longer."""
    t_b, t_f = nbytes / HBM_BYTES * 1e3, flops / peak * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def ffma_note(nbytes, flops, peak):
    """For a kernel bound at TF32X3_FLOPS, its bound at the FFMA peak
    too (the other fp32 forms' yardstick), for the log line."""
    if peak != TF32X3_FLOPS:
        return ""
    return f"; FFMA bound_ms {bound_ms(nbytes, flops, FP32_FLOPS)[0]:.4f}"


def against(ms, bms, lms):
    """A kernel's share of its bound and its factor against the library
    call computing the same function (per launch)."""
    lib = "no library call" if lms is None else \
        f"{ms / lms:.2f}x the library call"
    return f"share of bound {bms / ms:.4f}, {lib}"


def ptxas_report(log_text):
    """(kernel, registers, spill store bytes, spill load bytes, static
    shared bytes) per entry function of one nvcc -Xptxas -v report."""
    import re
    rows = []
    for part in log_text.split("Compiling entry function")[1:]:
        name = re.search(r"'([^']+)'", part).group(1)
        # The short name: the mangled identifier (length-prefixed) that
        # names a kernel, with a template's mangled arguments.
        for m in re.finditer(r"(?=(\d+)([A-Za-z_]\w*))", name):
            n, ident = int(m.group(1)), m.group(2)
            short = ident[:n]
            if len(ident) >= n and (short.endswith("_kernel")
                                    or short == "sum_partials"):
                tmpl = re.match(r"I(\w+?)EEv", name[m.start(2) + n:])
                name = short + (f"<{tmpl.group(1)}>" if tmpl else "")
                break
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", part)
        smem = re.search(r"(\d+) bytes smem", part)
        rows.append((name, int(regs.group(1)) if regs else -1,
                     int(spill.group(1)) if spill else -1,
                     int(spill.group(2)) if spill else -1,
                     int(smem.group(1)) if smem else 0))
    return rows


def launched_key(name, fn):
    """Call fn, one kernel wrapper call, and return the shape key its
    launch tallied (ops.kernels.shape_counts) with fn's result; fails
    unless it launched kernel `name` exactly once."""
    from transception_tpu_torch.ops import kernels
    kernels.reset_launches()
    out = fn()
    tallied = kernels.shape_counts()
    if len(tallied) != 1 or list(tallied.values()) != [1] or \
            next(iter(tallied))[0] != name:
        fail(f"{name}: one wrapper call tallied {tallied}")
    return next(iter(tallied)), out


def record(measured, key, label, err, ms, pms, lms, nbytes, flops,
           peak=BF16_FLOPS):
    """One kernel at one shape (its tally key): error and times per launch
    against the bound (operations at `peak`). A shape measured twice keeps
    its first times and the larger error."""
    name = key[0]
    if key in measured:
        measured[key]["max_abs_err"] = max(measured[key]["max_abs_err"],
                                           err)
        return
    bms, by = bound_ms(nbytes, flops, peak)
    # K9 and K2's hidden-sharded form share K2's library, K11's its own.
    src = {"mixffn_skip": "mixffn", "mixffn_tp": "mixffn",
           "mixffn_tp_bwd": "mixffn_bwd", "mixffn_skip_tp": "mixffn",
           "mhca_block_tp": "mhca_block"}.get(name, name)
    measured[key] = {
        "name": name, "shape": label, "route": "cuda",
        "source": f"transception_tpu_torch/csrc/{src}.cu",
        "replaces": replaces(name), "max_abs_err": err, "ms": ms,
        "plain_ms": pms, "bound_ms": bms, "bound_by": by, "library_ms": lms}


def pinned(cfg):
    """cfg with its seven fold switches resolved for eval: the structure
    stays the same when use_kernels is switched off."""
    import dataclasses

    from transception_tpu_torch.core.config import fold_switches
    sw = fold_switches(cfg, training=False)
    return dataclasses.replace(
        cfg, bridge_attn_fold=sw.bridge_attn,
        bridge_ffn_use_pallas=sw.bridge_ffn, etb_attn_fold=sw.etb_attn,
        etb_ffn_fold=sw.etb_ffn, mhca_block_fold=sw.mhca_block,
        mhca_ffn_fold=sw.mhca_ffn, sp_bridge_fold=sw.sp_bridge)


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


def compare(name, label, got, want, tol, base=None):
    """A kernel's result against its plain version: class ids (K4) by the
    fraction that differ, everything else by err_check."""
    if name != "expand_head":
        return err_check(f"{name} {label}", got, want, tol, base)
    err = (got != want).float().mean().item()
    ok = err <= tol
    log(f"  {name} {label}: id mismatch fraction {err:.6g} (tolerance "
        f"{tol}) {'ok' if ok else 'FAIL'}")
    return err, ok


def _k1_args(gen, B, N, C, dt):
    """K1's input and parameters, peaked softmaxes (keys and queries scaled
    up) so the attention branch is of the order of x, and the planted
    fault: the keys negated (the context changes only)."""
    x = rand(gen, (B, N, C), 0.25, dtype=dt)
    sc = C ** -0.5
    wq, wk, wv, wp = (rand(gen, (C, C), f * sc) for f in (2, 4, 2, 2))
    v = [rand(gen, (C,), 0.1, 1.0), rand(gen, (C,), 0.1)] + [
        rand(gen, (C,), 0.02) for _ in range(4)]
    args = (x, v[0], v[1], wq, v[2], wk, v[3], wv, v[4], wp, v[5])
    return x, args, args[:5] + (-wk,) + args[6:]


def _k2_args(gen, B, s, C, gsz, dt):
    """K2's input and parameters (the caller's LN over groups of gsz
    channels) and the planted fault: the depthwise taps negated."""
    hid = 4 * C
    x = rand(gen, (B, s * s, C), dtype=dt)
    args = (x, rand(gen, (gsz,), 0.1, 1.0), rand(gen, (gsz,), 0.1),
            rand(gen, (hid, C), C ** -0.5), rand(gen, (hid,), 0.02),
            rand(gen, (hid, 1, 3, 3), 0.3), rand(gen, (hid,), 0.02),
            rand(gen, (hid,), 0.1, 1.0), rand(gen, (hid,), 0.1),
            rand(gen, (C, hid), hid ** -0.5), rand(gen, (C,), 0.02))
    return x, args, args[:5] + (-args[5],) + args[6:]


def _k5_args(gen, B, s, C, dt):
    """K5's input and parameters, the qkv weight scaled up so softmax(K) is
    peaked and Q · ctx is of the order of the CRPE term, and the planted
    fault: the key rows of qkv negated."""
    hid, heads, N = 4 * C, 8, s * s
    chs = [h * C // heads for _, h in ((3, 2), (5, 3), (7, 3))]
    x = rand(gen, (B, N, C), 0.5, dtype=dt)
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
    wbad = wqkv.clone()
    wbad[C:2 * C] *= -1
    return x, head + (wqkv,) + rest, head + (wbad,) + rest


def _k7_args(gen, B, N, C, c, p, dt):
    """K7's input and parameters and the planted fault: the LN bias
    dropped."""
    x = rand(gen, (B, N, C), dtype=dt)
    args = (x, rand(gen, (p * p * c, C), C ** -0.5),
            rand(gen, (c,), 0.1, 1.0), rand(gen, (c,), 0.2))
    return args, args[:3] + (torch.zeros_like(args[3]),)


def _expand_head_cases(gen, B, case):
    """K4 in both layouts: at the serving batch (the shuffled map is the
    main path's), at batch 1 (make_predictor(batch=1)) and at a map that
    leaves a partial token tile. Fault: class 0's head bias raised by 1,
    so that it wins more often."""
    from transception_tpu_torch.ops.kernels import expand_head as eh
    C, c, p, ncls = 64, 64, 4, 9
    w = rand(gen, (p * p * c, C), (1.0 / C) ** 0.5)
    ls, lb = rand(gen, (c,), 0.1, 1.0), rand(gen, (c,), 0.1)
    hw, hb = rand(gen, (ncls, c), (1.0 / c) ** 0.5), rand(gen, (ncls,), 0.02)
    hb_bad = hb.clone()
    hb_bad[0] += 1.0
    for b, (H, W), on_path in ((B, (56, 56), True), (1, (56, 56), False),
                               (2, (25, 40), False)):
        N = H * W
        x = rand(gen, (b, N, C), dtype=torch.bfloat16)
        args, bad = (x, w, ls, lb, hw, hb), (x, w, ls, lb, hw, hb_bad)
        for shuffle in ((H, W), None):
            out = (f"({b},{p * H},{p * W})" if shuffle else
                   f"({b},{N},{p * p}) pre-shuffle")
            kw = dict(p=p, c=c, shuffle=shuffle)
            case("expand_head", f"({b},{N},{C}) -> ids {out}",
                 lambda a=args, kw=kw: eh.expand_head(*a, **kw),
                 lambda a=args, kw=kw: eh.expand_head_plain(*a, **kw),
                 b * N * C * 2 + b * N * p * p + p * p * c * C * 2,
                 2 * b * N * C * p * p * c + 2 * b * N * p * p * c * ncls,
                 1e-3, fault=("class 0's head bias raised by 1",
                              lambda a=bad, kw=kw: eh.expand_head_plain(
                                  *a, **kw)),
                 main=on_path and shuffle is not None)


def _patch_expand_cases(gen, B, case, train):
    """K7 in both layouts: the p = 2 expanders of decoders 3/2/1 and, when
    serving, the x4 expander of decoder 0 on the logits path ((B, 3136,
    64) -> 1024) and two maps that leave a partial token tile; the
    shuffled layout at B is the main path's. Fault: the LN bias dropped."""
    from transception_tpu_torch.ops.kernels import patch_expand as pe
    maps = [(B, 7, 7, 512, 2, True), (B, 14, 14, 320, 2, True),
            (B, 28, 28, 128, 2, True)]
    if not train:
        maps += [(B, 56, 56, 64, 4, True), (3, 5, 10, 128, 2, False),
                 (2, 25, 40, 64, 4, False)]
    for b, H, W, C, p, on_path in maps:
        N, c = H * W, C // 2 if p == 2 else C
        args, bad = _k7_args(gen, b, N, C, c, p, torch.bfloat16)
        for shuffle in ((H, W), None):
            out = (f"({b},{p * p * N},{c})" if shuffle else
                   f"({b},{N},{p * p * c}) pre-shuffle")
            kw = dict(p=p, c=c, shuffle=shuffle)
            case("patch_expand", f"({b},{N},{C}) -> {out}",
                 lambda a=args, kw=kw: pe.patch_expand(*a, **kw),
                 lambda a=args, kw=kw: pe.patch_expand_plain(*a, **kw),
                 b * N * C * 2 + b * N * p * p * c * 2 + p * p * c * C * 2,
                 2 * b * N * C * p * p * c, 0.02,
                 fault=("LN bias dropped",
                        lambda a=bad, kw=kw: pe.patch_expand_plain(*a, **kw)),
                 main=on_path and shuffle is not None)


def _k8_args(gen, k, v, dt):
    """K8's inputs against k/v (B, 1, M, 64) at dtype dt: x and res, wq
    scaled up so the softmax is peaked and the branch (output minus res)
    is of the order of v; the planted fault (the out-projection bias
    dropped); the library call computing the same function (SDPA on the
    same q/k/v plus two F.linear and the add, in dt); bytes and flops."""
    B, _, M, d = k.shape
    N = 6076
    x, res = (rand(gen, (B, N, d), dtype=dt) for _ in range(2))
    wq, wp = rand(gen, (d, d), 4 * d ** -0.5), rand(gen, (d, d), d ** -0.5)
    bq, bp = rand(gen, (d,), 0.1), rand(gen, (d,), 0.5)
    args = (x, res, wq, bq, k, v, wp, bp, d ** -0.5)
    bad = args[:7] + (torch.zeros_like(bp),) + args[8:]
    w = [t.to(dt) for t in (wq, bq, wp, bp)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lin = torch.nn.functional.linear

    def lib():
        qq = lin(x, w[0], w[1])[:, None]
        return lin(sdpa(qq, k, v, scale=d ** -0.5)[:, 0], w[2], w[3]) + res

    es = torch.finfo(dt).bits // 8
    nbytes = 3 * B * N * d * es + 2 * B * M * d * es + 2 * d * d * es \
        + 2 * d * 4
    flops = 4 * B * N * M * d + 4 * B * N * d * d
    return args, bad, lib, nbytes, flops


def _serving_only_cases(gen, B, case):
    """The serving path's K2, K3, K8 and K4 shapes (the train step's K2
    and K3 are held in phase 8)."""
    from transception_tpu_torch.ops.kernels import (
        bridge_attention as ba,
        mixffn as mf,
    )
    # K2 at the ETB FFN folds.
    for s, C in ((56, 64), (28, 128), (14, 320)):
        hid = 4 * C
        x, args, bad = _k2_args(gen, B, s, C, C, torch.bfloat16)
        case("mixffn", f"({B},{s * s},{C}) hidden {hid}",
             lambda a=args, s=s: mf.mixffn_ln_skip(*a, s=s),
             lambda a=args, s=s: mf.mixffn_ln_skip_plain(*a, s=s),
             2 * B * s * s * C * 2 + 2 * C * hid * 2 + 9 * hid * 2,
             4 * B * s * s * C * hid + 18 * B * s * s * hid, 0.02,
             base=x, fault=("depthwise taps negated",
                            lambda a=bad, s=s: mf.mixffn_ln_skip_plain(
                                *a, s=s)))
    # K2 at the bridge's eval folds (bridge_ffn_use_pallas): scales 1-3
    # with norm2 as a grouped LN of 64 channels; at the MHCA FFN folds of
    # stages 2-3 (mhca_block_fold off, mhca_ffn_fold on; LN eps 1e-6).
    for s, C, groups, eps_ln, where in (
            (56, 64, 1, 1e-5, "bridge"), (28, 128, 2, 1e-5, "bridge"),
            (14, 320, 5, 1e-5, "bridge"), (28, 64, 1, 1e-6, "MHCA"),
            (14, 128, 1, 1e-6, "MHCA")):
        hid = 4 * C
        x, args, bad = _k2_args(gen, B, s, C, C // groups, torch.bfloat16)
        kw = dict(s=s, groups=groups, eps_ln=eps_ln)
        case("mixffn", f"({B},{s * s},{C}) hidden {hid} groups {groups} "
             f"({where} fold)",
             lambda a=args, kw=kw: mf.mixffn_ln_skip(*a, **kw),
             lambda a=args, kw=kw: mf.mixffn_ln_skip_plain(*a, **kw),
             2 * B * s * s * C * 2 + 2 * C * hid * 2 + 9 * hid * 2,
             4 * B * s * s * C * hid + 18 * B * s * s * hid, 0.02,
             base=x, fault=("depthwise taps negated",
                            lambda a=bad, kw=kw: mf.mixffn_ln_skip_plain(
                                *a, **kw)))
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
    # K8: the folded bridge attention (_k8_args).
    args, bad, lib, nbytes, flops = _k8_args(gen, k, vv, torch.bfloat16)
    case("bridge_attention_folded",
         f"x/res ({B},{N},{d}) kv ({B},1,{M},{d})",
         lambda a=args: ba.bridge_attention_folded(*a),
         lambda a=args: ba.bridge_attention_folded_plain(*a),
         nbytes, flops, 0.02, lfn=lib, base=args[1],
         fault=("out-projection bias dropped",
                lambda a=bad: ba.bridge_attention_folded_plain(*a)))
    _expand_head_cases(gen, B, case)

def kernel_cases(gen, B=BATCH, train=False):
    """One dict per (kernel, main-path shape) at batch B: kernel fn, plain
    fn, library fn or None, bytes, flops, tolerance, and for the residual
    kernels the input added back (`base`) and a planted fault the check
    must reject (K9 has one too). train=False: every shape the serving
    path gives a kernel in any fold configuration; train=True: the forward
    kernels of the "pallas" train step that phase 8 does not hold (K1, K5
    on the rate-0 blocks, K6 on the unfolded MHCA blocks, K7, K9).
    main=False marks a check off the main path (another layout, batch or
    tail): held, not recorded."""
    from transception_tpu_torch.ops.kernels import (
        etb_attention as ea,
        linear_attention as la,
        mhca_block as mb,
        mixffn as mf,
    )
    cases = []

    def case(name, label, kfn, pfn, nbytes, flops, tol, lfn=None, base=None,
             fault=None, main=True):
        cases.append(dict(name=name, label=label, kfn=kfn, pfn=pfn, lfn=lfn,
                          nbytes=nbytes, flops=flops, tol=tol, base=base,
                          fault=fault, main=main))

    # K1 (_k1_args).
    for N, C in ((3136, 64), (784, 128), (196, 320)):
        x, args, bad = _k1_args(gen, B, N, C, torch.bfloat16)
        case("etb_attention", f"({B},{N},{C})",
             lambda a=args: ea.etb_attention(*a),
             lambda a=args: ea.etb_attention_plain(*a),
             2 * B * N * C * 2 + 4 * C * C * 2, 12 * B * N * C * C, 0.02,
             base=x, fault=("keys negated",
                            lambda a=bad: ea.etb_attention_plain(*a)))
    if not train:
        _serving_only_cases(gen, B, case)
    # K5 (_k5_args); in the train step with drop path only stage 2's
    # rate-0 blocks.
    for s, C in ((28, 64),) if train else ((28, 64), (14, 128)):
        hid, heads, N = 4 * C, 8, s * s
        x, args, bad = _k5_args(gen, B, s, C, torch.bfloat16)
        case("mhca_block", f"({B},{N},{C}) heads {heads} hidden {hid}",
             lambda a=args, s=s: mb.mhca_block(*a, s=s, heads=8),
             lambda a=args, s=s: mb.mhca_block_plain(*a, s=s, heads=8),
             2 * B * N * C * 2 + (4 * C * C + 2 * C * hid + 9 * hid) * 2,
             B * N * (8 * C * C + 4 * C * C // heads + 78 * C
                      + 4 * C * hid + 18 * hid), 0.02,
             base=x, fault=("key rows of qkv negated",
                            lambda a=bad, s=s: mb.mhca_block_plain(
                                *a, s=s, heads=8)))
    # K6: the factorized attention (scaled) at stage 4, q/k/v
    # (B, 8, 49, 40), and with mhca_block_fold off (or drop path in the
    # train step) at stages 2-3; the ETB attention (the softmax of Q) with
    # etb_attn_fold off.
    mhca = ((8, 49, 40, False), (8, 784, 8, False), (8, 196, 16, False))
    etb = ((1, 3136, 64, True), (1, 784, 128, True), (1, 196, 320, True))
    # The 4-stage backbone's stage 1 (56², C = 64): its blocks run
    # unfolded in eval, as in JAX (kernels.mhca_block.takes).
    stage56 = ((8, 3136, 8, False),)
    for h, N, dh, q_sm in mhca if train else mhca + etb + stage56:
        q, k, v = (rand(gen, (B, h, N, dh), f, dtype=torch.bfloat16)
                   for f in (1.0, 3.0, 1.0))
        sc = 1.0 if q_sm else dh ** -0.5
        case("linear_attention",
             f"q/k/v ({B},{h},{N},{dh}) q_softmax {q_sm}",
             lambda a=(q, k, v, q_sm, sc): la.linear_attention(*a),
             lambda a=(q, k, v, q_sm, sc): la.linear_attention_plain(*a),
             4 * B * h * N * dh * 2, 4 * B * h * N * dh * dh, 0.02)
    _patch_expand_cases(gen, B, case, train)
    # K9: the MHCA FFNs of the blocks with drop path (train step only);
    # fault: the fc2 bias dropped (b2 drawn large enough to show).
    for s, C in ((28, 64), (14, 128)) if train else ():
        hid, N = 4 * C, s * s
        args = (rand(gen, (B, N, C), dtype=torch.bfloat16),
                rand(gen, (hid, C), C ** -0.5), rand(gen, (hid,), 0.02),
                rand(gen, (hid, 1, 3, 3), 0.3), rand(gen, (hid,), 0.02),
                rand(gen, (hid,), 0.1, 1.0), rand(gen, (hid,), 0.1),
                rand(gen, (C, hid), hid ** -0.5), rand(gen, (C,), 0.5))
        bad = args[:8] + (torch.zeros_like(args[8]),)
        case("mixffn_skip", f"({B},{N},{C}) hidden {hid}",
             lambda a=args, s=s: mf.mixffn_skip(*a, s=s),
             lambda a=args, s=s: mf.mixffn_skip_plain(*a, s=s),
             2 * B * N * C * 2 + 2 * C * hid * 2 + 9 * hid * 2,
             4 * B * N * C * hid + 18 * B * N * hid, 0.02,
             fault=("fc2 bias dropped",
                    lambda a=bad, s=s: mf.mixffn_skip_plain(*a, s=s)))
    return cases


def fp32_kernel_cases(gen, B=BATCH, train=False):
    """The fp32 forms at every shape the fp32 eval forward of the default
    config launches them (TransceptionConfig(dtype="float32"), batch B),
    against their fp32 plain versions with TF32 off, within FP32_TOL: K1
    at the three ETB maps, K2 at the ETB FFN folds, K5 at stages 2-3, K6 at
    stage 4, K3 on the bridge stream, K7 at the three p = 2 expands
    (shuffled) and the x4 expand in both layouts (pre-shuffle before the
    published model's fp32 head, shuffled on the legacy models' logits
    heads), each p = 2 K7 also in its other layout (held, not a row).
    train=True: the forward
    kernels of the fp32 "pallas" train step that phase 8 does not hold
    (K1 at the three ETB maps, K5 on stage 2's rate-0 blocks, K6 on the
    MHCA blocks with drop path, K7 at the p = 2 expands, K9 at the drop-path
    blocks' FFNs). Inputs and planted faults are the bf16 cases' (_k1_args,
    ...), K6 and K3 with a fault of their own; bytes at 4 a value,
    operations at FP32_FLOPS, K3's and K8's (3xTF32) at TF32X3_FLOPS. K3
    and K8 also at ragged stream tiles (N = 129, 300; held, not rows)."""
    from transception_tpu_torch.ops.kernels import (
        bridge_attention as ba,
        etb_attention as ea,
        linear_attention as la,
        mhca_block as mb,
        mixffn as mf,
        patch_expand as pe,
    )
    cases = []
    f32 = torch.float32

    def case(name, label, kfn, pfn, nbytes, flops, lfn=None, base=None,
             fault=None, main=True, peak=FP32_FLOPS):
        cases.append(dict(name=name, label=f"{label} fp32", kfn=kfn, pfn=pfn,
                          lfn=lfn, nbytes=nbytes, flops=flops, tol=FP32_TOL,
                          base=base, fault=fault, main=main, peak=peak))

    for N, C in ((3136, 64), (784, 128), (196, 320)):
        x, args, bad = _k1_args(gen, B, N, C, f32)
        case("etb_attention", f"({B},{N},{C})",
             lambda a=args: ea.etb_attention(*a),
             lambda a=args: ea.etb_attention_plain(*a),
             2 * B * N * C * 4 + 4 * C * C * 4, 12 * B * N * C * C,
             base=x, fault=("keys negated",
                            lambda a=bad: ea.etb_attention_plain(*a)))
    for s, C in () if train else ((56, 64), (28, 128), (14, 320)):
        hid = 4 * C  # the ETB FFN folds
        x, args, bad = _k2_args(gen, B, s, C, C, f32)
        case("mixffn", f"({B},{s * s},{C}) hidden {hid}",
             lambda a=args, s=s: mf.mixffn_ln_skip(*a, s=s),
             lambda a=args, s=s: mf.mixffn_ln_skip_plain(*a, s=s),
             2 * B * s * s * C * 4 + 2 * C * hid * 4 + 9 * hid * 4,
             4 * B * s * s * C * hid + 18 * B * s * s * hid,
             base=x, fault=("depthwise taps negated",
                            lambda a=bad, s=s: mf.mixffn_ln_skip_plain(
                                *a, s=s)))
    for s, C in ((28, 64),) if train else ((28, 64), (14, 128)):
        hid, heads, N = 4 * C, 8, s * s  # stages 2-3
        x, args, bad = _k5_args(gen, B, s, C, f32)
        case("mhca_block", f"({B},{N},{C}) heads {heads} hidden {hid}",
             lambda a=args, s=s: mb.mhca_block(*a, s=s, heads=8),
             lambda a=args, s=s: mb.mhca_block_plain(*a, s=s, heads=8),
             2 * B * N * C * 4 + (4 * C * C + 2 * C * hid + 9 * hid) * 4,
             B * N * (8 * C * C + 4 * C * C // heads + 78 * C
                      + 4 * C * hid + 18 * hid),
             base=x, fault=("key rows of qkv negated",
                            lambda a=bad, s=s: mb.mhca_block_plain(
                                *a, s=s, heads=8)))
    # K6 at stage 4, and in training on the MHCA blocks with drop path at
    # stages 2-4 (the factorized attention, scaled; fault: the keys
    # negated, which moves only the context).
    # With etb_attn_fold off (the fold grid's "etb-off" at fp32) the ETB
    # attention (the softmax of Q); the 4-stage backbone's 56² stage.
    shapes = ((8, 49, 40, False), (8, 784, 8, False), (8, 196, 16, False)) \
        if train else ((8, 49, 40, False), (1, 3136, 64, True),
                       (1, 784, 128, True), (1, 196, 320, True),
                       (8, 3136, 8, False))
    for h, N, dh, q_sm in shapes:
        q, k, v = (rand(gen, (B, h, N, dh), f) for f in (1.0, 3.0, 1.0))
        sc = 1.0 if q_sm else dh ** -0.5
        case("linear_attention", f"q/k/v ({B},{h},{N},{dh}) q_softmax {q_sm}",
             lambda a=(q, k, v, q_sm, sc): la.linear_attention(*a),
             lambda a=(q, k, v, q_sm, sc): la.linear_attention_plain(*a),
             4 * B * h * N * dh * 4, 4 * B * h * N * dh * dh,
             fault=("keys negated", lambda a=(q, -k, v, q_sm, sc):
                    la.linear_attention_plain(*a)))
    if train:
        _fp32_train_only_cases(gen, B, case)
        return cases
    # K3 on the bridge stream; the library call SDPA at fp32 with TF32 off
    # (fault: the keys' first channel zeroed).
    N, M, d = 6076, 784, 64
    q = rand(gen, (B, 1, N, d))
    k = rand(gen, (B, 1, M, d))
    vv = rand(gen, (B, 1, M, d))
    kbad = k.clone()
    kbad[..., 0] = 0
    sdpa = torch.nn.functional.scaled_dot_product_attention
    case("bridge_attention", f"q ({B},1,{N},{d}) kv ({B},1,{M},{d})",
         lambda a=(q, k, vv): ba.bridge_attention(*a, d ** -0.5),
         lambda a=(q, k, vv): ba.bridge_attention_plain(*a, d ** -0.5),
         2 * B * N * d * 4 + 2 * B * M * d * 4, 4 * B * N * M * d,
         lfn=lambda a=(q, k, vv): sdpa(*a, scale=d ** -0.5),
         fault=("first key channel zeroed", lambda a=(q, kbad, vv):
                ba.bridge_attention_plain(*a, d ** -0.5)),
         peak=TF32X3_FLOPS)
    # K3 at ragged stream tiles: 129 and 300 rows against the 192-row
    # blocks (held; the main path's stream is 6076 rows).
    for n in (129, 300):
        qr = q[:2, :, :n].contiguous()
        kv = (k[:2], vv[:2], kbad[:2])
        case("bridge_attention", f"q (2,1,{n},{d}) kv (2,1,{M},{d})",
             lambda a=(qr,) + kv[:2]: ba.bridge_attention(*a, d ** -0.5),
             lambda a=(qr,) + kv[:2]: ba.bridge_attention_plain(
                 *a, d ** -0.5),
             2 * 2 * n * d * 4 + 2 * 2 * M * d * 4, 4 * 2 * n * M * d,
             fault=("first key channel zeroed", lambda a=(qr, kv[2], kv[1]):
                    ba.bridge_attention_plain(*a, d ** -0.5)),
             main=False)
    # K8's fp32 form (the fp32 sp and para bridges, the fold grid's K8
    # configurations at fp32); the library call at fp32 (_k8_args).
    args, bad, lib, nbytes, flops = _k8_args(gen, k, vv, f32)
    case("bridge_attention_folded",
         f"x/res ({B},{N},{d}) kv ({B},1,{M},{d})",
         lambda a=args: ba.bridge_attention_folded(*a),
         lambda a=args: ba.bridge_attention_folded_plain(*a),
         nbytes, flops, lfn=lib, base=args[1],
         fault=("out-projection bias dropped",
                lambda a=bad: ba.bridge_attention_folded_plain(*a)),
         peak=TF32X3_FLOPS)
    for n in (129, 300):  # K8 at ragged stream tiles (held)
        ar = tuple(t[:2, :n].contiguous() for t in args[:2]) + \
            args[2:4] + (args[4][:2], args[5][:2]) + args[6:]
        br = ar[:7] + bad[7:8] + ar[8:]
        case("bridge_attention_folded",
             f"x/res (2,{n},{d}) kv (2,1,{M},{d})",
             lambda a=ar: ba.bridge_attention_folded(*a),
             lambda a=ar: ba.bridge_attention_folded_plain(*a),
             0, 0, base=ar[1],
             fault=("out-projection bias dropped",
                    lambda a=br: ba.bridge_attention_folded_plain(*a)),
             main=False)
    # K2 at the bridge's folds (the fp32 sp and para bridges, the fold
    # grid's bridge_ffn_use_pallas at fp32): norm2 as a grouped LN of 64
    # channels at scales 1-3.
    for s, C, groups in ((56, 64, 1), (28, 128, 2), (14, 320, 5)):
        hid = 4 * C
        x, fargs, fbad = _k2_args(gen, B, s, C, C // groups, f32)
        kw = dict(s=s, groups=groups, eps_ln=1e-5)
        case("mixffn", f"({B},{s * s},{C}) hidden {hid} groups {groups} "
             f"(bridge fold)",
             lambda a=fargs, kw=kw: mf.mixffn_ln_skip(*a, **kw),
             lambda a=fargs, kw=kw: mf.mixffn_ln_skip_plain(*a, **kw),
             2 * B * s * s * C * 4 + 2 * C * hid * 4 + 9 * hid * 4,
             4 * B * s * s * C * hid + 18 * B * s * s * hid,
             base=x, fault=("depthwise taps negated",
                            lambda a=fbad, kw=kw: mf.mixffn_ln_skip_plain(
                                *a, **kw)))
    # K7: the main path's layouts are rows (the x4 expand's pre-shuffle
    # layout before the published model's fp32 argmax head, its shuffled
    # one on the legacy models' logits heads, phase 15).
    for H, W, C, p, main_shuffled in ((7, 7, 512, 2, True),
                                      (14, 14, 320, 2, True),
                                      (28, 28, 128, 2, True),
                                      (56, 56, 64, 4, None)):
        N, c = H * W, C // 2 if p == 2 else C
        args, bad = _k7_args(gen, B, N, C, c, p, f32)
        for shuffle in ((H, W), None):
            out = (f"({B},{p * p * N},{c})" if shuffle else
                   f"({B},{N},{p * p * c}) pre-shuffle")
            kw = dict(p=p, c=c, shuffle=shuffle)
            case("patch_expand", f"({B},{N},{C}) -> {out}",
                 lambda a=args, kw=kw: pe.patch_expand(*a, **kw),
                 lambda a=args, kw=kw: pe.patch_expand_plain(*a, **kw),
                 B * N * C * 4 + B * N * p * p * c * 4 + p * p * c * C * 4,
                 2 * B * N * C * p * p * c,
                 fault=("LN bias dropped",
                        lambda a=bad, kw=kw: pe.patch_expand_plain(*a, **kw)),
                 main=main_shuffled in (None, shuffle is not None))
    return cases


def _fp32_train_only_cases(gen, B, case):
    """The fp32 "pallas" train step's K7 (the three p = 2 expands, the
    shuffled layout a row) and K9 (the drop-path blocks' FFNs at 28² and
    14²; fault: the fc2 bias dropped)."""
    from transception_tpu_torch.ops.kernels import (
        mixffn as mf,
        patch_expand as pe,
    )
    f32 = torch.float32
    for H, C in ((7, 512), (14, 320), (28, 128)):
        N, c, p = H * H, C // 2, 2
        args, bad = _k7_args(gen, B, N, C, c, p, f32)
        for shuffle in ((H, H), None):
            out = (f"({B},{p * p * N},{c})" if shuffle else
                   f"({B},{N},{p * p * c}) pre-shuffle")
            kw = dict(p=p, c=c, shuffle=shuffle)
            case("patch_expand", f"({B},{N},{C}) -> {out}",
                 lambda a=args, kw=kw: pe.patch_expand(*a, **kw),
                 lambda a=args, kw=kw: pe.patch_expand_plain(*a, **kw),
                 B * N * C * 4 + B * N * p * p * c * 4 + p * p * c * C * 4,
                 2 * B * N * C * p * p * c,
                 fault=("LN bias dropped",
                        lambda a=bad, kw=kw: pe.patch_expand_plain(*a, **kw)),
                 main=shuffle is not None)
    for s, C in ((28, 64), (14, 128)):
        hid, N = 4 * C, s * s
        args = (rand(gen, (B, N, C)), rand(gen, (hid, C), C ** -0.5),
                rand(gen, (hid,), 0.02), rand(gen, (hid, 1, 3, 3), 0.3),
                rand(gen, (hid,), 0.02), rand(gen, (hid,), 0.1, 1.0),
                rand(gen, (hid,), 0.1), rand(gen, (C, hid), hid ** -0.5),
                rand(gen, (C,), 0.5))
        bad = args[:8] + (torch.zeros_like(args[8]),)
        case("mixffn_skip", f"({B},{N},{C}) hidden {hid}",
             lambda a=args, s=s: mf.mixffn_skip(*a, s=s),
             lambda a=args, s=s: mf.mixffn_skip_plain(*a, s=s),
             2 * B * N * C * 4 + 2 * C * hid * 4 + 9 * hid * 4,
             4 * B * N * C * hid + 18 * B * N * hid,
             fault=("fc2 bias dropped",
                    lambda a=bad, s=s: mf.mixffn_skip_plain(*a, s=s)))


# Phase 13's forwards of the other IFF modes, token MLPs and no bridge.
VARIANT_BATCH = 8


def small_batch_cases(gen, B=VARIANT_BATCH):
    """The bf16 serving shapes at batch B that phase 13's argmax forwards
    of the default structure launch: K1 and K2 at the ETB maps, K3, K5, K6
    at stage 4, the three p = 2 K7 expands and K4 (kernel_cases' main
    rows at B, without the fold-only and logits-only shapes)."""
    def launched(cs):
        n, label = cs["name"], cs["label"]
        if n in ("bridge_attention_folded", "mixffn_skip"):
            return False
        if n == "mixffn":
            return "groups" not in label
        if n == "linear_attention":
            return f"({B},8,49,40)" in label
        if n == "patch_expand":  # not the logits path's x4 expand
            return not label.startswith(f"({B},3136,64)")
        return True
    return [cs for cs in kernel_cases(gen, B) if cs["main"] and launched(cs)]


# Phase 15's kernel shapes (the legacy model family).
LEGACY_NAMES = ("transception", "missformer", "effmissformer",
                "resinception", "resinception_135")
# K6's (h, N, d) on the legacy models at 224² that no other phase holds
# (the softmax of Q, scale 1): the two-branch encoder's head_count-8
# blocks over 26²+28², 12²+14² and 5²+7² tokens (dil_conv 1); EffMiT's
# stage-4 blocks; ResInception's one-head blocks over three ('15') and four
# ('135') streams of 28², 14² and 7² (RES_K6). The ETB maps' are
# kernel_cases'.
RES_K6 = ((1, 2352, 128), (1, 588, 320), (1, 147, 512), (1, 3136, 128),
          (1, 784, 320), (1, 196, 512))
LEGACY_K6 = ((8, 1460, 16), (8, 340, 40), (8, 74, 64), (1, 49, 512)) \
    + RES_K6
ETB_K6 = ((1, 3136, 64), (1, 784, 128), (1, 196, 320))


def legacy_kernel_cases(gen):
    """Phase 15's shapes that no other case holds: K6 at LEGACY_K6 in bf16
    and fp32 at batch BATCH (the forwards) and, with the ETB maps, in bf16
    at TRAIN_BATCH (the train steps), and ResInception's with the ETB maps
    in fp32 at TRAIN_BATCH (its fp32 steps); K7's x4 expand in the
    shuffled layout of the logits head at TRAIN_BATCH, bf16 and fp32 (the
    fp32 steps). Faults: the keys negated (K6), the LN bias dropped
    (K7)."""
    from transception_tpu_torch.ops.kernels import (
        linear_attention as la,
        patch_expand as pe,
    )
    cases = []

    def case(name, label, kfn, pfn, nbytes, flops, fault, fp32):
        cases.append(dict(
            name=name, label=label + (" fp32" if fp32 else ""), kfn=kfn,
            pfn=pfn, lfn=None, nbytes=nbytes, flops=flops,
            tol=FP32_TOL if fp32 else 0.02, base=None, fault=fault,
            main=True, peak=FP32_FLOPS if fp32 else BF16_FLOPS))

    for B, dt, shapes in ((BATCH, torch.bfloat16, LEGACY_K6),
                          (BATCH, torch.float32, LEGACY_K6),
                          (TRAIN_BATCH, torch.bfloat16, LEGACY_K6 + ETB_K6),
                          (TRAIN_BATCH, torch.float32, RES_K6 + ETB_K6)):
        es = torch.finfo(dt).bits // 8
        for h, N, d in shapes:
            q, k, v = (rand(gen, (B, h, N, d), f, dtype=dt)
                       for f in (1.0, 3.0, 1.0))
            a, bad = (q, k, v, True, 1.0), (q, -k, v, True, 1.0)
            case("linear_attention", f"q/k/v ({B},{h},{N},{d}) q_softmax "
                 f"True", lambda a=a: la.linear_attention(*a),
                 lambda a=a: la.linear_attention_plain(*a),
                 4 * B * h * N * d * es, 4 * B * h * N * d * d,
                 ("keys negated", lambda a=bad: la.linear_attention_plain(
                     *a)), es == 4)
    B, N, C, p = TRAIN_BATCH, 3136, 64, 4
    for dt in (torch.bfloat16, torch.float32):
        es = torch.finfo(dt).bits // 8
        args, bad = _k7_args(gen, B, N, C, C, p, dt)
        kw = dict(p=p, c=C, shuffle=(56, 56))
        case("patch_expand", f"({B},{N},{C}) -> ({B},{p * p * N},{C})",
             lambda a=args, kw=kw: pe.patch_expand(*a, **kw),
             lambda a=args, kw=kw: pe.patch_expand_plain(*a, **kw),
             B * N * C * es + B * N * p * p * C * es + p * p * C * C * es,
             2 * B * N * C * p * p * C,
             ("LN bias dropped", lambda a=bad, kw=kw: pe.patch_expand_plain(
                 *a, **kw)), es == 4)
    return cases


def replaces(name):
    """The TPU kernel a counter's kernel replaces (file:line)."""
    from transception_tpu_torch.ops import kernels
    for n, mod, attr in kernels.COUNTERS:
        if n == name:
            return getattr(mod, {"launches": "REPLACES",
                                 "bwd_launches": "BWD_REPLACES",
                                 "folded_launches": "FOLDED_REPLACES",
                                 "skip_launches": "SKIP_REPLACES",
                                 "tp_launches": "TP_REPLACES",
                                 "tp_bwd_launches": "TP_BWD_REPLACES",
                                 "skip_tp_launches": "SKIP_TP_REPLACES"
                                 }[attr])
    raise KeyError(name)


def kernel_phase():
    """Phase 3. Returns the measurements per kernel and shape key."""
    measured = {}
    gen = torch.Generator().manual_seed(1)
    cases = kernel_cases(gen) + kernel_cases(gen, TRAIN_BATCH, train=True) \
        + fp32_kernel_cases(gen) \
        + fp32_kernel_cases(gen, TRAIN_BATCH, train=True) \
        + small_batch_cases(gen) + legacy_kernel_cases(gen)
    for cs in cases:
        name, label = cs["name"], cs["label"]
        key, got = launched_key(name, cs["kfn"])
        want = cs["pfn"]()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"{name} {label}: {tuple(got.shape)} {got.dtype} vs "
                 f"{tuple(want.shape)} {want.dtype}")
        err, ok = compare(name, label, got, want, cs["tol"], cs["base"])
        if not ok:
            fail(f"{name} disagrees with its plain version")
        if cs["fault"] is not None:
            what, ffn = cs["fault"]
            _, caught = compare(name, f"  planted fault ({what}) vs plain",
                                ffn(), want, cs["tol"], cs["base"])
            if caught:
                fail(f"{name}: the check does not see a planted fault")
        ms = cuda_ms(cs["kfn"])
        if not cs["main"]:
            log(f"    ms {ms:.4f} per launch (off the main path: not a row "
                f"of the kernels line)")
            continue
        pms = cuda_ms(cs["pfn"], iters=5)
        lms = cuda_ms(cs["lfn"]) if cs["lfn"] else None
        peak = cs.get("peak", BF16_FLOPS)
        bms, by = bound_ms(cs["nbytes"], cs["flops"], peak)
        log(f"    ms {ms:.4f} plain_ms {pms:.4f} library_ms "
            f"{lms if lms is None else round(lms, 4)} bound_ms {bms:.4f} "
            f"({by}) per launch; {against(ms, bms, lms)}"
            f"{ffma_note(cs['nbytes'], cs['flops'], peak)}")
        record(measured, key, label, err, ms, pms, lms, cs["nbytes"],
               cs["flops"], peak)
    nan_checks(gen)
    return measured


def nan_checks(gen):
    """K3's, K8's and K10's fp32 forms (3xTF32) with a NaN planted as a
    CUDA operation makes it (0x7fffffff) in q, k, v, x, Wq or Wp (K10: q,
    k, v or g): NaN where the plain version has NaN, the rest within
    FP32_TOL (K8 on its branch, K10 per gradient)."""
    from transception_tpu_torch.ops.kernels import bridge_attention as ba

    def r(*shape, s=1.0):
        return (torch.randn(shape, generator=gen) * s).to("cuda")

    q, k, v = r(2, 1, 300, 64), r(2, 1, 784, 64), r(2, 1, 784, 64)
    x, res = r(2, 300, 64), r(2, 300, 64)
    k3 = (ba.bridge_attention, ba.bridge_attention_plain, [q, k, v, 0.125])
    k8 = (ba.bridge_attention_folded, ba.bridge_attention_folded_plain,
          [x, res, r(64, 64, s=0.2), r(64), k, v, r(64, 64, s=0.2), r(64),
           0.125])
    for name, (kfn, pfn, args), i, at in (
            ("K3 q row", k3, 0, (0, 0, 5, 3)),
            ("K3 k key", k3, 1, (0, 0, 17, 3)),
            ("K3 v key", k3, 2, (0, 0, 17, 3)),
            ("K8 x row", k8, 0, (0, 5, 3)), ("K8 Wq", k8, 2, (5, 3)),
            ("K8 Wp", k8, 6, (5, 3))):
        args = list(args)
        args[i] = args[i].clone()
        args[i].view(torch.int32)[at] = 0x7FFFFFFF
        got, want = kfn(*args), pfn(*args)
        if kfn is ba.bridge_attention_folded:
            got, want = got - res, want - res
        torch.cuda.synchronize()
        nan = want.isnan()
        same = bool(nan.any()) and torch.equal(got.isnan(), nan)
        err = 0.0
        if same and not nan.all():
            err = ((got - want)[~nan].abs().max()
                   / want[~nan].abs().max()).item()
        ok = same and err <= FP32_TOL
        log(f"  NaN in {name} (fp32): {int(nan.sum())} NaN outputs, the "
            f"kernel's {'the same' if same else 'NOT the same'}; the rest "
            f"within {err:.3g} of max|plain| {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name}: a NaN does not come out as in the plain version")
    g = r(2, 1, 300, 64)
    for which, i, at in (("q row", 0, (0, 0, 5, 3)),
                         ("k key", 1, (0, 0, 17, 3)),
                         ("v key", 2, (0, 0, 17, 3)),
                         ("g row", 3, (0, 0, 5, 3))):
        args = [q, k, v, g]
        args[i] = args[i].clone()
        args[i].view(torch.int32)[at] = 0x7FFFFFFF
        got = ba.bridge_attention_bwd(*args, 0.125)
        want = ba.bridge_attention_bwd_plain(*args, 0.125)
        torch.cuda.synchronize()
        counts, ok = [], any(bool(w.isnan().any()) for w in want)
        for a, b in zip(got, want):
            nan = b.isnan()
            same = torch.equal(a.isnan(), nan)
            err = 0.0
            if same and not nan.all():
                err = ((a - b)[~nan].abs().max()
                       / b[~nan].abs().max()).item()
            counts.append(f"{int(nan.sum())}{'' if same else ' NOT the same'}"
                          f" ({err:.3g})")
            ok &= same and err <= FP32_TOL
        log(f"  NaN in K10 {which} (fp32): NaN dq/dk/dv, the kernel's "
            f"against the plain version's, the rest's error: "
            f"{', '.join(counts)} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"K10 {which}: a NaN does not come out as in the plain "
                 f"version")


def compare_paths(model, x, seed):
    """Logits and class maps of the kernel path against the plain path on
    the same weights and against an fp32 plain model, both with the kernel
    model's structure (pinned); fails past the thresholds. Returns the
    plain bf16 model."""
    import dataclasses

    from transception_tpu_torch.models.transception import MSTransception
    cfg = pinned(model.cfg)
    plain = MSTransception(dataclasses.replace(cfg, use_kernels=False),
                           "cuda")
    plain.load_state_dict(model.state_dict())
    ref = MSTransception(dataclasses.replace(cfg, dtype="float32",
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
    from transception_tpu_torch.models.transception import (
        MSTransception,
        launches_per_forward,
    )
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
    counts, tallies = kernels.launch_counts(), kernels.shape_counts()
    n_fwd = math.ceil(vol.shape[0] / BATCH)
    log(f"  predict_volume: {pred.shape} {pred.dtype} in {vol_s:.3f} s, "
        f"{n_fwd} forwards, launches {counts}")
    if pred.shape != (48, 224, 224) or pred.dtype != np.uint8:
        fail(f"predict_volume output {pred.shape} {pred.dtype}")
    if pred.max() >= cfg.num_classes:
        fail(f"class id {pred.max()} out of range")
    for name, per in launches_per_forward(cfg).items():
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
    profile_device(lambda: fwd(model), "forward")
    return (tallies, n_fwd), x


def fp32_model_phase(x):
    """Phases 5-7 at fp32, the published protocol's dtype: the published
    model at TransceptionConfig(dtype="float32") (seed-0 weights) on its
    fp32 kernels against its plain path (use_kernels=False, the same
    weights and fold structure) on the b=32 slices x, TF32 off: logits
    within FP32_LOGITS_TOL x max|logit|, class maps at least FP32_AGREE
    equal, the argmax forward's launches exactly launches_per_forward(cfg),
    then its time (CUDA events and host wall clock) against the plain
    path's and its device busy time and idle share (torch.profiler).
    Returns the launches per shape key of one argmax forward."""
    import dataclasses

    from transception_tpu_torch.core.config import TransceptionConfig
    from transception_tpu_torch.models.transception import (
        MSTransception,
        launches_per_forward,
    )
    from transception_tpu_torch.ops import kernels

    cfg = TransceptionConfig(dtype="float32")
    per = launches_per_forward(cfg)
    model = MSTransception(cfg, "cuda", seed=0)
    plain = MSTransception(dataclasses.replace(pinned(cfg), use_kernels=False),
                           "cuda")
    plain.load_state_dict(model.state_dict())

    def fwd(m, argmax=True):
        with torch.inference_mode():
            return m(x, argmax=argmax)

    fwd(model)  # warm-up (cuDNN plans, kernel plans)
    torch.cuda.synchronize()
    kernels.reset_launches()
    ik = fwd(model)
    torch.cuda.synchronize()
    counts, tallies = kernels.launch_counts(), kernels.shape_counts()
    log(f"  fp32 forward launches {({k: n for k, n in counts.items() if n})}"
        f"; launches_per_forward {({k: n for k, n in per.items() if n})}")
    if counts != per:
        fail("the fp32 forward's launches are not launches_per_forward(cfg)")
    ip = fwd(plain)
    lk, lp = fwd(model, False), fwd(plain, False)
    torch.cuda.synchronize()
    if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
        fail("non-finite fp32 logits")
    rel = ((lk - lp).abs().max() / lp.abs().max()).item()
    agree = (ik == ip).float().mean().item()
    log(f"  fp32 logits {tuple(lk.shape)} max|kernel-plain|/max|plain| "
        f"{rel:.6g} (tolerance {FP32_LOGITS_TOL}); class maps agreement "
        f"{agree:.6f} (threshold {FP32_AGREE})")
    if rel > FP32_LOGITS_TOL or agree < FP32_AGREE:
        fail("the fp32 kernel path disagrees with the fp32 plain path")
    t_on = cuda_ms(lambda: fwd(model), iters=10)
    t_off = cuda_ms(lambda: fwd(plain), iters=5)
    t_on2 = cuda_ms(lambda: fwd(model), iters=10)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        fwd(model)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    log(f"  fp32 forward b={BATCH} argmax: kernels {t_on:.3f} / {t_on2:.3f} "
        f"ms/batch (events), wall {min(walls):.3f}-{max(walls):.3f} ms "
        f"(host clock, 5 runs); plain {t_off:.3f} ms/batch")
    log("phase 7 (fp32): device time of one fp32 kernel-path forward")
    profile_device(lambda: fwd(model), "forward_fp32")
    return tallies


def stage_of(name):
    """'K2 fc1', 'K5 attn', 'K1 ctx', ... for a kernel of the staged
    forwards (K1, K2, K5, K6, K9: the owner is the first template argument
    of the shared stages), 'K11 ...' for the backward's, 'K4 expand+head'
    and 'K7 expand' for the two kernels on the expand body; None for any
    other kernel."""
    import re
    m = re.search(r"(expand_head|patch_expand)_kernel", name)
    if m:  # the expand body with its head or store epilogue
        return "K4 expand+head" if m.group(1) == "expand_head" else \
            "K7 expand"
    m = re.search(r"mixffn_gemm_kernel<(\d+), \w+, \w+, (\w+), \d+, \d+, "
                  r"(\d)[,>]", name)
    if m:
        kid, aln, epi = m.group(1), m.group(2) == "true", int(m.group(3))
        names = ({(True, 1): "qkv", (False, 2): "proj"} if kid == "1" else
                 {(True, 1): "fc1", (False, 2): "fc2", (True, 3): "qkv",
                  (False, 4): "proj"})
        what = names.get((aln, epi), "products")
        return f"K{kid} {'fc1+fc2' if kid == '9' else what}"
    # The linear-attention core's stages (K1 and K6, named by their KID)
    # and K6's head body.
    m = re.search(r"lin_([a-z]+)_kernel(?:<(\d+)[,>])?", name)
    if m:
        return f"K{m.group(2) or 6} {m.group(1)}"
    m = re.search(r"mixffn_convrows_kernel<(\d+)[,>]", name)
    if m:
        return f"K{m.group(1)} rows"
    m = re.search(r"mhca_([a-z]+)_kernel", name)
    if m:
        return f"K5 {m.group(1)}"
    m = re.search(r"mixffn_bwd_([a-z]+)_kernel", name)
    return f"K11 {m.group(1)}" if m else None


def profile_device(fn, label):
    """Device busy time, idle share and the top kernels of one call,
    from a trace of the device alone (a fraction of a full trace's cost
    on a train step's ~14k launches)."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        log("  the profiler saw no device activity: not measured")
        return
    by_name, calls = Counter(), Counter()
    for e in kern:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3
        calls[e.name] += 1
    busy = sum(by_name.values())
    port = {n: t for n, t in by_name.items() if any(
        k in n for k in ("lin_", "mixffn_", "bridge_attention_kernel",
                         "bridge_attention_f32_kernel",
                         "bridge_attention_folded_kernel",
                         "bridge_attention_folded_f32_kernel",
                         "expand_head_kernel", "mhca_", "patch_expand_kernel",
                         "linear_attention_kernel", "rows_kernel",
                         "cols_kernel", "rows32_kernel", "cols32_kernel",
                         "sum_partials"))}
    log(f"  {len(kern)} device activities, busy {busy:.3f} ms of "
        f"{wall_ms:.3f} ms wall (idle share {1 - busy / wall_ms:.3f}); "
        f"port kernels {sum(port.values()):.3f} ms")
    for name, t in by_name.most_common(12):
        log(f"    {t:9.3f} ms  {name[:90]}")
    # Every port kernel by name (K11's stages one by one), then the stages
    # of the staged kernels summed by owner and stage.
    for name, t in sorted(port.items(), key=lambda kv: -kv[1]):
        log(f"    port {t:9.3f} ms  {name[:110]}")
    stages, stage_calls = Counter(), Counter()
    for name, t in port.items():
        what = stage_of(name)
        if what:
            stages[what] += t
            stage_calls[what] += calls[name]
    for what, t in sorted(stages.items()):
        log(f"    stage {what}: {t:.3f} ms per {label}, "
            f"{stage_calls[what]} launches")
    (OUT_DIR / f"chip_smoke_profile_{label}.txt").write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total",
                                  row_limit=60))


# ---- the train step (phases 8-9) ----

# Distinct (s, C, hidden, groups, eps_ln) of the MixFFN folds of the flash
# train step: ETB stage 1 + decoder_0 and bridge scale 1 (56², 64), MHCA
# stage 2 (28², 64, LN eps 1e-6), ETB decoder_1 (28², 128), bridge scale 2
# (28², 128, 2 groups), MHCA stage 3 (14², 128, eps 1e-6), ETB decoder_2
# (14², 320), bridge scale 3 (14², 320, 5 groups). The 7x7 FFNs (MHCA
# stage 4, bridge scale 4) stay plain.
FFN_SHAPES = ((56, 64, 256, 1, 1e-5), (28, 64, 256, 1, 1e-6),
              (28, 128, 512, 1, 1e-5), (28, 128, 512, 2, 1e-5),
              (14, 128, 512, 1, 1e-6), (14, 320, 1280, 1, 1e-5),
              (14, 320, 1280, 5, 1e-5))
# The train modes of phase 9: name -> (TransceptionConfig overrides,
# Trainer steps). "pallas" keeps the eval kernels in training
# (use_pallas_train) with the MHCA FFN fold and drop path at 0.1 (a stated
# choice: the reference trains at 0.0), which sends the FFNs of the MHCA
# blocks whose rate is above 0 through K9. Launches per step:
# models.transception.launches_per_step(cfg).
TRAIN_MODES = {
    "default": ({}, 3),
    "flash": (dict(ffn_flash_train=True), 3),
    "pallas": (dict(use_pallas_train=True, mhca_ffn_fold=True,
                    drop_path_rate=0.1), 2)}
DROP_SEED = 7         # the drop-path generator of the one-step comparisons
BWD_TOL = 0.02        # each gradient within 2% of its own max
TRAIN_STEPS = 5       # repeated-batch steps; the loss must fall from 1 to 5
LOSS_TOL = 0.01       # kernel vs plain path: loss within 1%
# Gradient limits of one step against the plain path, between the sound
# readings (global 0.0013 default / 0.0027 flash) and the planted faults'
# (0.0637 for K11's tap gradient zeroed, 0.125 for K10's dv zeroed).
LEAF_TOL = 0.03       # per leaf |g_k - g_p| <= 0.03 |g_p| + 1e-3 |g_p|_all
GLOBAL_TOL = 0.01     # all leaves |g_k - g_p| <= 0.01 |g_p|_all
BN_TOL = 0.01         # running stats within 1% of their max (+1e-4)


def grads_check(name, got, want, names, tol=BWD_TOL):
    """Each of `got` against `want` within tol x its own max."""
    worst, ok = 0.0, True
    for n, a, b in zip(names, got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"{name} {n}: {tuple(a.shape)} {a.dtype} vs "
                 f"{tuple(b.shape)} {b.dtype}")
        a, b = a.float(), b.float()
        err = (a - b).abs().max().item()
        ref = b.abs().max().item()
        good = math.isfinite(err) and err <= tol * ref
        worst = max(worst, err)
        ok &= good
        if not good:
            log(f"    {name} {n}: max_abs_err {err:.6g} vs max|plain| "
                f"{ref:.6g} FAIL")
    return worst, ok


def train_kernel_phase(measured, dt=torch.bfloat16):
    """Phase 8. K3 and its backward K10, K11 and the grouped K2 at the
    train step's shapes, added to `measured` per kernel and shape key; at
    dt=float32 their fp32 forms, within FP32_TOL of their fp32 plain
    versions (TF32 off), bounds at FP32_FLOPS (K3's and K10's at
    TF32X3_FLOPS) and K3 and K10 beside SDPA at fp32, K10 also at ragged
    shapes (held, not rows). The plain backwards' checks run at bf16."""
    from transception_tpu_torch.ops.kernels import (
        bridge_attention as ba,
        mixffn as mf,
    )
    fp32 = dt == torch.float32
    gen = torch.Generator().manual_seed(12 if fp32 else 2)
    B = TRAIN_BATCH
    es = 4 if fp32 else 2
    tol, btol = (FP32_TOL, FP32_TOL) if fp32 else (0.02, BWD_TOL)
    peak = FP32_FLOPS if fp32 else BF16_FLOPS
    tag = " fp32" if fp32 else ""

    # K3 and K10 at the bridge's shapes; K10's fault: dk's sign flipped.
    N, M, d = 6076, 784, 64
    q, k, v, g = (rand(gen, (B, 1, n, d), dtype=dt) for n in (N, M, M, N))
    sc = d ** -0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    label = f"q ({B},1,{N},{d}) kv ({B},1,{M},{d}){tag}"
    with torch.no_grad():
        key, got = launched_key(
            "bridge_attention", lambda: ba.bridge_attention(q, k, v, sc))
        err, ok = err_check(f"bridge_attention {label}", got,
                            ba.bridge_attention_plain(q, k, v, sc), tol)
        if not ok:
            fail("bridge_attention disagrees with its plain version")
        ms = cuda_ms(lambda: ba.bridge_attention(q, k, v, sc))
        pms = cuda_ms(lambda: ba.bridge_attention_plain(q, k, v, sc),
                      iters=5)
        lms = cuda_ms(lambda: sdpa(q, k, v, scale=sc))
    nbytes, flops = 2 * B * N * d * es + 2 * B * M * d * es, \
        4 * B * N * M * d
    k3peak = TF32X3_FLOPS if fp32 else peak  # K3's, K10's fp32 forms: 3xTF32
    bms, by = bound_ms(nbytes, flops, k3peak)
    log(f"    ms {ms:.4f} plain_ms {pms:.4f} library_ms (SDPA) {lms:.4f} "
        f"bound_ms {bms:.4f} ({by}) per launch; {against(ms, bms, lms)}"
        f"{ffma_note(nbytes, flops, k3peak)}")
    record(measured, key, label, err, ms, pms, lms, nbytes, flops, k3peak)
    names = ("dq", "dk", "dv")
    key, got = launched_key("bridge_attention_bwd",
                            lambda: ba.bridge_attention_bwd(q, k, v, g, sc))
    want = ba.bridge_attention_bwd_plain(q, k, v, g, sc)
    torch.cuda.synchronize()
    err, ok = grads_check("bridge_attention_bwd", got, want, names, btol)
    log(f"  bridge_attention_bwd q/g ({B},1,{N},{d}) k/v ({B},1,{M},{d})"
        f"{tag}: max_abs_err {err:.6g} (each of dq/dk/dv within {btol} x "
        f"its max) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("bridge_attention_bwd disagrees with its plain version")
    bad = (want[0], -want[1], want[2])
    if grads_check("  planted fault (dk negated)", bad, want, names,
                   btol)[1]:
        fail("bridge_attention_bwd: the check does not see a planted fault")
    log("    planted fault (dk negated) rejected")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = sdpa(*leaves, scale=sc)
    ms = cuda_ms(lambda: ba.bridge_attention_bwd(q, k, v, g, sc))
    pms = cuda_ms(lambda: ba.bridge_attention_bwd_plain(q, k, v, g, sc),
                  iters=3)
    lms = cuda_ms(lambda: torch.autograd.grad(out, leaves, g,
                                              retain_graph=True))
    nbytes = (3 * N + 4 * M) * d * es * B
    flops = 10 * B * N * M * d
    bms, by = bound_ms(nbytes, flops, k3peak)
    log(f"    ms {ms:.4f} plain_ms {pms:.4f} library_ms (SDPA backward) "
        f"{lms:.4f} bound_ms {bms:.4f} ({by}) per launch; "
        f"{against(ms, bms, lms)}{ffma_note(nbytes, flops, k3peak)}")
    record(measured, key, label, err, ms, pms, lms, nbytes, flops, k3peak)
    _folded_train_case(measured, gen, k, v)
    if fp32:
        _k10_ragged_fp32(gen, names)
    del q, k, v, g, got, want, bad, leaves, out

    # K11 and the grouped K2 at every fold of the flash train step (and,
    # of them, the "pallas" step's).
    names = ("dx", "dlts", "dltb", "dw1", "db1", "ddw", "ddwb", "dls", "dlb",
             "dw2", "db2")
    for i, (s, C, hid, groups, eps_ln) in enumerate(FFN_SHAPES):
        gsz = C // groups
        x = rand(gen, (B, s * s, C), dtype=dt)
        gy = rand(gen, (B, s * s, C), dtype=dt)
        p = (rand(gen, (gsz,), 0.1, 1.0).repeat(groups),
             rand(gen, (gsz,), 0.1).repeat(groups),
             rand(gen, (hid, C), C ** -0.5), rand(gen, (hid,), 0.02),
             rand(gen, (hid, 1, 3, 3), 0.3), rand(gen, (hid,), 0.02),
             rand(gen, (hid,), 0.1, 1.0), rand(gen, (hid,), 0.1),
             rand(gen, (C, hid), hid ** -0.5), rand(gen, (C,), 0.02))
        label = f"({B},{s * s},{C}) hidden {hid} groups {groups} eps_ln " \
                f"{eps_ln}{tag}"
        kw = dict(s=s, groups=groups, eps_ln=eps_ln)
        key, got = launched_key("mixffn_bwd", lambda: mf.mixffn_ln_skip_bwd(
            x, *p, gy, **kw))
        want = mf.mixffn_ln_skip_bwd_plain(x, *p, gy, **kw)
        torch.cuda.synchronize()
        err, ok = grads_check(f"mixffn_bwd {label}", got, want, names, btol)
        log(f"  mixffn_bwd {label}: max_abs_err {err:.6g} (dx and each "
            f"parameter gradient within {btol} x its max) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail("mixffn_bwd disagrees with its plain version")
        # Faults: the depthwise-tap gradient dropped, or the halo: dx
        # without the conv transpose's neighbour rows (plain backward
        # with the taps zeroed in the dd correlation only).
        if i % 2 == 0:
            what = "tap gradient dropped"
            bad = want[:5] + (torch.zeros_like(want[5]),) + want[6:]
        else:
            what = "halo rows dropped from dx"
            pz = p[:4] + (torch.zeros_like(p[4]),) + p[5:]
            dh0 = mf.mixffn_ln_skip_bwd_plain(x, *pz, gy, **kw)
            bad = (dh0[0],) + want[1:]
        if grads_check(f"  planted fault ({what})", bad, want, names,
                       btol)[1]:
            fail("mixffn_bwd: the check does not see a planted fault")
        log(f"    planted fault ({what}) rejected")
        ms = cuda_ms(lambda: mf.mixffn_ln_skip_bwd(x, *p, gy, **kw))
        pms = cuda_ms(lambda: mf.mixffn_ln_skip_bwd_plain(x, *p, gy, **kw),
                      iters=3)
        n = B * s * s
        nbytes = 3 * n * C * es + (2 * C * hid + 9 * hid) * es + (
            2 * C * hid + 13 * hid + 3 * C) * 4 + (5 * hid + 3 * C) * 4
        flops = 10 * n * C * hid + 54 * n * hid
        bms, by = bound_ms(nbytes, flops, peak)
        log(f"    ms {ms:.4f} plain_ms {pms:.4f} bound_ms {bms:.4f} ({by}) "
            f"per launch")
        record(measured, key, label, err, ms, pms, None, nbytes, flops,
               peak)
        # K2 forward at the same fold (grouped LN where groups > 1): the
        # branch alone; fault: the taps negated.
        lts, ltb = p[0][:gsz], p[1][:gsz]
        fargs = (x, lts, ltb) + p[2:]
        with torch.no_grad():
            key, got = launched_key("mixffn", lambda: mf.mixffn_ln_skip(
                *fargs, **kw))
            want = mf.mixffn_ln_skip_plain(*fargs, **kw)
            torch.cuda.synchronize()
            err, ok = err_check(f"mixffn (train fold) {label}", got, want,
                                tol, base=x)
            if not ok:
                fail("mixffn disagrees with its plain version")
            badf = fargs[:5] + (-fargs[5],) + fargs[6:]
            _, caught = err_check("  planted fault (taps negated) vs plain",
                                  mf.mixffn_ln_skip_plain(*badf, **kw), want,
                                  tol, base=x)
            if caught:
                fail("mixffn: the check does not see a planted fault")
            kms = cuda_ms(lambda: mf.mixffn_ln_skip(*fargs, **kw))
            kpms = cuda_ms(lambda: mf.mixffn_ln_skip_plain(*fargs, **kw),
                           iters=5)
        log(f"    forward ms {kms:.4f} plain_ms {kpms:.4f} per launch")
        record(measured, key, label, err, kms, kpms, None,
               2 * n * C * es + 2 * C * hid * es + 9 * hid * es,
               4 * n * C * hid + 18 * n * hid, peak)
        del x, gy, p, got, want, bad
    if not fp32:
        plain_backward_checks(gen)


def _k10_ragged_fp32(gen, names):
    """K10's fp32 form at ragged shapes: 300 query rows (ragged against
    the rows kernel's 128-row blocks and the columns kernel's 32-row
    chunks) against 800 keys (whole 32-key chunks, a last 112-key tile
    with one warp of keys), 816 keys (a short last 32-key chunk, a last
    tile with two warps of keys) and 240 keys (both short, B·h 6), each
    gradient within FP32_TOL of its max, with its planted fault (dk
    negated); logged, not rows of the kernels line."""
    from transception_tpu_torch.ops.kernels import bridge_attention as ba
    for B, h, N, M in ((2, 1, 300, 800), (2, 1, 300, 816),
                       (3, 2, 300, 240)):
        q, k, v, g = (rand(gen, (B, h, n, 64)) for n in (N, M, M, N))
        got = ba.bridge_attention_bwd(q, k, v, g, 0.125)
        want = ba.bridge_attention_bwd_plain(q, k, v, g, 0.125)
        torch.cuda.synchronize()
        err, ok = grads_check("bridge_attention_bwd", got, want, names,
                              FP32_TOL)
        log(f"  bridge_attention_bwd q/g ({B},{h},{N},64) k/v "
            f"({B},{h},{M},64) fp32: max_abs_err {err:.6g} (each of "
            f"dq/dk/dv within {FP32_TOL} x its max) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail("bridge_attention_bwd fp32 disagrees with its plain version "
                 "at a ragged shape")
        bad = (want[0], -want[1], want[2])
        if grads_check("  planted fault (dk negated)", bad, want, names,
                       FP32_TOL)[1]:
            fail("bridge_attention_bwd: the check does not see a planted "
                 "fault")
        log("    planted fault (dk negated) rejected")


def _folded_train_case(measured, gen, k, v):
    """K8 at the train step's batch at k's dtype (_k8_args): the sp and
    para bridges keep it in training (phase 13), as MISSFormer's bridge
    does (phase 15, also at fp32), its backward autograd of the plain
    version. The branch alone, with the planted fault; the fp32 form
    within FP32_TOL, bound at TF32X3_FLOPS."""
    from transception_tpu_torch.ops.kernels import bridge_attention as ba
    fp32 = k.dtype == torch.float32
    tol, peak = (FP32_TOL, TF32X3_FLOPS) if fp32 else (0.02, BF16_FLOPS)
    args, bad, lib, nbytes, flops = _k8_args(gen, k, v, k.dtype)
    B, N, d = args[0].shape
    label = f"x/res ({B},{N},{d}) kv ({B},1,{k.shape[2]},{d})" + (
        " fp32" if fp32 else "")
    with torch.no_grad():
        key, got = launched_key("bridge_attention_folded",
                                lambda: ba.bridge_attention_folded(*args))
        want = ba.bridge_attention_folded_plain(*args)
        err, ok = err_check(f"bridge_attention_folded {label}", got, want,
                            tol, base=args[1])
        if not ok:
            fail("bridge_attention_folded disagrees with its plain version")
        if err_check("  planted fault (out-projection bias dropped) vs "
                     "plain", ba.bridge_attention_folded_plain(*bad), want,
                     tol, base=args[1])[1]:
            fail("bridge_attention_folded: the check does not see a "
                 "planted fault")
        ms = cuda_ms(lambda: ba.bridge_attention_folded(*args))
        pms = cuda_ms(lambda: ba.bridge_attention_folded_plain(*args),
                      iters=5)
        lms = cuda_ms(lib)
    bms, by = bound_ms(nbytes, flops, peak)
    log(f"    ms {ms:.4f} plain_ms {pms:.4f} library_ms {lms:.4f} bound_ms "
        f"{bms:.4f} ({by}) per launch; {against(ms, bms, lms)}"
        f"{ffma_note(nbytes, flops, peak)}")
    record(measured, key, label, err, ms, pms, lms, nbytes, flops, peak)


def plain_backward_checks(gen):
    """The plain backwards of K1 and K5-K9 (the "pallas" train step): one
    backward through each kernel's autograd Function (the kernel's
    forward, then autograd of the plain version recomputed from the saved
    inputs) against autograd of the plain version, at one train-step shape
    each: every input's gradient within BWD_TOL of its own max, and the
    forward launched the kernel once. A wrong save or argument order in a
    wrapper fails here."""
    from transception_tpu_torch.ops.kernels import (
        bridge_attention as ba,
        etb_attention as ea,
        linear_attention as la,
        mhca_block as mb,
        mixffn as mf,
        patch_expand as pe,
    )
    B, bf = TRAIN_BATCH, torch.bfloat16

    def ffn(C, hid):
        return [rand(gen, (hid, C), C ** -0.5), rand(gen, (hid,), 0.02),
                rand(gen, (hid, 1, 3, 3), 0.3), rand(gen, (hid,), 0.02),
                rand(gen, (hid,), 0.1, 1.0), rand(gen, (hid,), 0.1),
                rand(gen, (C, hid), hid ** -0.5), rand(gen, (C,), 0.1)]

    C = 128  # K1 at decoder 1
    etb = [rand(gen, (B, 784, C), 0.25, dtype=bf),
           rand(gen, (C,), 0.1, 1.0), rand(gen, (C,), 0.1)]
    for f in (2, 4, 2, 2):
        etb += [rand(gen, (C, C), f * C ** -0.5), rand(gen, (C,), 0.02)]
    C, s = 64, 28  # K5 at stage 2, block 0
    chs = [h * C // 8 for h in (2, 3, 3)]
    mhca = ([rand(gen, (B, s * s, C), 0.5, dtype=bf),
             rand(gen, (C, 1, 3, 3), 0.3), rand(gen, (C,), 0.02),
             rand(gen, (C,), 0.1, 1.0), rand(gen, (C,), 0.1),
             rand(gen, (3 * C, C), 3 * C ** -0.5), rand(gen, (3 * C,), 0.02)]
            + [rand(gen, (n, 1, k, k), 1.0 / k)
               for n, k in zip(chs, (3, 5, 7))]
            + [rand(gen, (n,), 0.02) for n in chs]
            + [rand(gen, (C, C), C ** -0.5), rand(gen, (C,), 0.02),
               rand(gen, (C,), 0.1, 1.0), rand(gen, (C,), 0.1)]
            + ffn(C, 4 * C))

    def mhca_call(fn):
        return lambda *a: fn(*a[:7], list(a[7:10]), list(a[10:13]),
                             *a[13:], s=s, heads=8)

    N, M, d = 6076, 784, 64  # K8 at the bridge
    fold = [rand(gen, (B, N, d), dtype=bf), rand(gen, (B, N, d), dtype=bf),
            rand(gen, (d, d), 4 * d ** -0.5), rand(gen, (d,), 0.1),
            rand(gen, (B, 1, M, d), dtype=bf),
            rand(gen, (B, 1, M, d), dtype=bf),
            rand(gen, (d, d), d ** -0.5), rand(gen, (d,), 0.5)]
    cases = (
        ("etb_attention", f"({B},784,128)", ea.etb_attention,
         ea.etb_attention_plain, etb),
        ("mhca_block", f"({B},{s * s},{C}) heads 8", mhca_call(mb.mhca_block),
         mhca_call(mb.mhca_block_plain), mhca),
        ("linear_attention", f"q/k/v ({B},8,196,16)",
         lambda *a: la.linear_attention(*a, False, 0.25),
         lambda *a: la.linear_attention_plain(*a, False, 0.25),
         [rand(gen, (B, 8, 196, 16), f, dtype=bf) for f in (1.0, 3.0, 1.0)]),
        ("patch_expand", f"({B},196,320) -> ({B},784,160)",
         lambda *a: pe.patch_expand(*a, p=2, c=160, shuffle=(14, 14)),
         lambda *a: pe.patch_expand_plain(*a, p=2, c=160, shuffle=(14, 14)),
         [rand(gen, (B, 196, 320), dtype=bf),
          rand(gen, (640, 320), 320 ** -0.5), rand(gen, (160,), 0.1, 1.0),
          rand(gen, (160,), 0.1)]),
        ("bridge_attention_folded", f"x/res ({B},{N},{d}) kv ({B},1,{M},{d})",
         lambda *a: ba.bridge_attention_folded(*a, d ** -0.5),
         lambda *a: ba.bridge_attention_folded_plain(*a, d ** -0.5), fold),
        ("mixffn_skip", f"({B},784,64) hidden 256",
         lambda *a: mf.mixffn_skip(*a, s=28),
         lambda *a: mf.mixffn_skip_plain(*a, s=28),
         [rand(gen, (B, 784, 64), dtype=bf)] + ffn(64, 256)))
    for name, label, kfn, pfn, args in cases:
        leaves = [t.requires_grad_() for t in args]
        _, out = launched_key(name, lambda: kfn(*leaves))
        g = rand(gen, tuple(out.shape), dtype=out.dtype)
        got = torch.autograd.grad(out, leaves, g)
        want = torch.autograd.grad(pfn(*leaves), leaves, g)
        torch.cuda.synchronize()
        names = [f"d{i}" for i in range(len(leaves))]
        err, ok = grads_check(f"{name} plain backward", got, want, names)
        log(f"  {name} plain backward {label}: max_abs_err {err:.6g} over "
            f"{len(leaves)} input gradients (each within {BWD_TOL} x its "
            f"max) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name}: the Function's backward disagrees with autograd "
                 f"of its plain version")
        del leaves, out, got, want


def _train_cfg(mode, **kw):
    from transception_tpu_torch.core.config import TransceptionConfig
    return TransceptionConfig(**dict(TRAIN_MODES[mode][0], **kw))


def _gen(seed):
    return None if seed is None else torch.Generator(
        device="cuda").manual_seed(seed)


def _one_step(model, sd0, img, lbl, seed=None, wide_head=True, classes=9):
    """One train step of `model` from the weights sd0, its drop-path masks
    drawn from a generator seeded `seed`, with the wide head (the legacy
    models: without), over `classes` classes: loss, gradients and buffers
    after the step (on the host)."""
    from transception_tpu_torch.core.config import TrainConfig
    from transception_tpu_torch.train.state import TrainState
    from transception_tpu_torch.train.trainer import make_train_step
    model.load_state_dict(sd0)
    st = TrainState(model, TrainConfig(), 2211 // TRAIN_BATCH)
    met = make_train_step(st, classes, 0.4, 0.6, wide_head=wide_head,
                          gen=_gen(seed))(img, lbl)
    torch.cuda.synchronize()
    return (float(met["loss"]),
            {n: p.grad.float().cpu() for n, p in model.named_parameters()},
            {n: b.float().cpu() for n, b in model.named_buffers()})


# The fp32 train step's limits, kernels against the plain path (TF32 off),
# stated before the first card run. Both paths are fp32 throughout and
# differ by the order of fp32 sums alone (the kernels' forms ~1e-6 of the
# plain versions' scale a launch), which a step's forward and backward
# through train-mode BatchNorm grows by a few orders of magnitude at
# most; a bf16 rounding left in anywhere is ~4e-3 a value. So: the loss
# within 1e-4, all leaves within 1e-3 in relative norm, each leaf within
# 1e-2 of its norm + 1e-4 of the global norm (a leaf with an exact
# gradient of 0, a bias before a train-mode BatchNorm, holds noise), BN
# stats within 1e-3 of their max (+1e-4): ten times tighter than bf16's.
FP32_LIMITS = dict(loss=1e-4, glob=1e-3, leaf=1e-2, leaf_abs=1e-4, bn=1e-3)
BF16_LIMITS = dict(loss=LOSS_TOL, glob=GLOBAL_TOL, leaf=LEAF_TOL,
                   leaf_abs=1e-3, bn=BN_TOL)


def _compare_steps(tag, k, p, ref=None, lim=BF16_LIMITS, held=True):
    """Kernel step k against plain step p (and both against an fp32
    reference): loss, every gradient leaf, the BatchNorm stats, within
    `lim`. Returns whether all checks hold; held=False logs the reading
    without a verdict (a comparison that is not a check)."""
    (lk, gk, bk), (lp, gp, bp) = k, p
    G = math.sqrt(sum(float(g.square().sum()) for g in gp.values()))
    dall = math.sqrt(sum(float((gk[n] - g).square().sum())
                         for n, g in gp.items()))
    worst, worst_n, cut = 0.0, "", []
    for n, g in gp.items():
        e = float((gk[n] - g).norm())
        r = e / (lim["leaf"] * float(g.norm()) + lim["leaf_abs"] * G)
        if r > worst:
            worst, worst_n = r, n
        if float(g.abs().max()) > 0 and float(gk[n].abs().max()) == 0:
            cut.append(n)
    bn = max((float((bk[n] - b).abs().max()) / (lim["bn"] * float(
        b.abs().max()) + 1e-4) for n, b in bp.items()), default=0.0)
    loss_ok = abs(lk - lp) <= lim["loss"] * abs(lp)
    ok = (loss_ok and dall <= lim["glob"] * G and worst <= 1.0 and not cut
          and bn <= 1.0)
    msg = (f"  {tag}: loss kernel {lk:.8f} plain {lp:.8f}; gradients "
           f"|g_k - g_p|/|g_p| over all {len(gp)} leaves {dall / G:.3g} "
           f"(limit {lim['glob']}); worst leaf at {worst:.3f} of its limit "
           f"({worst_n}); {len(cut)} leaves zero on the kernel path only; "
           f"BN stats at {bn:.3f} of their limit")
    if ref is not None:
        gr = ref[1]
        R = math.sqrt(sum(float(g.square().sum()) for g in gr.values()))
        for name, gx in (("kernel", gk), ("plain", gp)):
            e = math.sqrt(sum(float((gx[n] - g).square().sum())
                              for n, g in gr.items()))
            msg += f"; {name} vs fp32 {e / R:.5f}"
    log(msg + ((" ok" if ok else " FAIL") if held else
               " (logged, not held)"))
    return ok


@contextlib.contextmanager
def trainer_evals(test_ds=None):
    """Inside: each in-training eval of a Trainer (train.trainer's
    run_inference) recorded, with its launches per kernel and per shape
    key and its chunks of BATCH slices (so that the train steps' launches
    are the run's minus these); on `test_ds` when given, in place of
    make_test_dataset's."""
    from transception_tpu_torch.ops import kernels
    from transception_tpu_torch.train import trainer as tm
    rec = {"counts": Counter(), "tallies": Counter(), "chunks": 0,
           "evals": 0}
    real_run, real_ds = tm.run_inference, tm.make_test_dataset

    def run(model, ds, *a, **k):
        c0 = Counter(kernels.launch_counts())
        t0 = Counter(kernels.shape_counts())
        out = real_run(model, ds, *a, **k)
        torch.cuda.synchronize()
        rec["counts"] += Counter(kernels.launch_counts()) - c0
        rec["tallies"] += Counter(kernels.shape_counts()) - t0
        rec["chunks"] += sum(math.ceil(ds.get(i)["image"].shape[0] / BATCH)
                             for i in range(len(ds)))
        rec["evals"] += 1
        return out

    tm.run_inference = run
    if test_ds is not None:
        tm.make_test_dataset = lambda cfg: test_ds
    try:
        yield rec
    finally:
        tm.run_inference, tm.make_test_dataset = real_run, real_ds


def held_run(what, counts, ev, steps, per_step, per_fwd):
    """A Trainer or CLI run's launches: each kernel's, less its evals',
    exactly steps x launches_per_step, and the evals' exactly their
    chunks x launches_per_forward."""
    for name in per_step:
        n_ev = ev["counts"][name]
        if n_ev != ev["chunks"] * per_fwd[name]:
            fail(f"{what}: {name} launched {n_ev} times in {ev['evals']} "
                 f"evals of {ev['chunks']} chunks, want "
                 f"{per_fwd[name]} a chunk (launches_per_forward)")
        if counts[name] - n_ev != steps * per_step[name]:
            fail(f"{what}: {name} {counts[name] - n_ev} launches in {steps} "
                 f"steps, want {steps} x {per_step[name]} "
                 f"(launches_per_step)")


def _logged_losses(text):
    """The losses of a Trainer log's iteration lines."""
    import re
    return [float(v) for v in re.findall(
        r"iteration \d+ : lr \S+ loss (\S+)", text)]


# Phases 9 and 12's in-training evals: one synthetic volume of 64² (the
# default test set, two of 512², costs ~45 s of host metrics an eval;
# phase 11 runs it).
PHASE9_EVAL_HW = 64


def train_phase():
    """Phase 9. Returns the launches per shape key of the flash- and
    pallas-mode Trainer runs' train steps, with their step counts."""
    import shutil

    from transception_tpu_torch.core.config import DataConfig, TrainConfig
    from transception_tpu_torch.data.device_synthetic import (
        DeviceSyntheticStream,
    )
    from transception_tpu_torch.data.synapse import SyntheticVolumeDataset
    from transception_tpu_torch.models.transception import (
        MSTransception,
        launches_per_forward,
        launches_per_step,
    )
    from transception_tpu_torch.ops import kernels
    from transception_tpu_torch.ops.kernels import (
        bridge_attention as ba,
        mixffn as mf,
    )
    from transception_tpu_torch.train.state import TrainState
    from transception_tpu_torch.train.trainer import Trainer, make_train_step

    tallies_out = {}
    batch = DeviceSyntheticStream(TRAIN_BATCH, 224, 9, device="cuda").batch(0)
    img, lbl = batch["image"], batch["label"]
    for mode, (_, steps) in TRAIN_MODES.items():
        log(f"  -- train mode {mode} --")
        per_step = launches_per_step(_train_cfg(mode))
        per_fwd = launches_per_forward(_train_cfg(mode))
        seed = DROP_SEED if mode == "pallas" else None
        # Trainer: a few steps on the on-device stream, a checkpoint, the
        # in-training eval, a resume.
        t0 = time.perf_counter()
        out = OUT_DIR / f"train_{mode}"
        shutil.rmtree(out, ignore_errors=True)
        tcfg = TrainConfig(output_dir=str(out))
        dcfg = DataConfig(dataset="synthetic", device_data=True)
        vols = SyntheticVolumeDataset(length=1, hw=PHASE9_EVAL_HW)
        tr = Trainer(_train_cfg(mode), tcfg, dcfg, device="cuda")
        with trainer_evals(vols) as ev:
            kernels.reset_launches()
            st, hist = tr.train(max_steps=steps)
            torch.cuda.synchronize()
            counts, tallies = kernels.launch_counts(), kernels.shape_counts()
        losses = _logged_losses((out / "log.txt").read_text())
        log(f"  Trainer.train(max_steps={steps}): logged losses {losses}, "
            f"eval {hist}, launches {counts} "
            f"({time.perf_counter() - t0:.1f} s)")
        if st.step != steps or not losses or \
                not np.isfinite(losses + hist["dice"] + hist["hd95"]).all() \
                or len(hist["dice"]) != 1 or ev["evals"] != 1:
            fail(f"Trainer run: step {st.step}, losses {losses}, {hist}")
        held_run(f"Trainer {mode}", counts, ev, steps, per_step, per_fwd)
        if mode != "default":
            tallies_out[mode] = (Counter(tallies) - ev["tallies"], steps)
        ckpt = out / "ckpt" / f"step_{steps:08d}.pt"
        if not ckpt.exists():
            fail(f"no checkpoint {ckpt}")
        del tr, st
        tr = Trainer(_train_cfg(mode), tcfg, dcfg, device="cuda")
        with trainer_evals(vols):
            st, more = tr.train(max_steps=steps + 1)
        text = (out / "log.txt").read_text()
        if st.step != steps + 1 or len(more["dice"]) != 1 or \
                "resumed from" not in text or \
                f"iteration {steps + 1} : lr" not in text:
            fail(f"resume: step {st.step}, {more}")
        log(f"  resumed from {ckpt.name}: step {steps + 1} loss "
            f"{_logged_losses(text)[-1]:.4f}; log: "
            f"{text.strip().splitlines()[-2][:120]}")
        shutil.rmtree(out / "ckpt")
        del tr, st
        torch.cuda.empty_cache()

        # One step against the plain path and an fp32 reference, the same
        # drop-path masks in all three (one generator seed).
        sd0 = {k: v.clone() for k, v in MSTransception(
            _train_cfg(mode), "cuda", seed=0).state_dict().items()}
        ref_m = MSTransception(_train_cfg(mode, dtype="float32",
                                          use_kernels=False), "cuda")
        ref = _one_step(ref_m, sd0, img, lbl, seed)
        del ref_m
        plain_m = MSTransception(_train_cfg(mode, use_kernels=False), "cuda")
        plain = _one_step(plain_m, sd0, img, lbl, seed)
        del plain_m
        model = MSTransception(_train_cfg(mode), "cuda")
        kernels.reset_launches()
        kern = _one_step(model, sd0, img, lbl, seed)
        counts = kernels.launch_counts()
        if counts != per_step:
            fail(f"one step launched {counts}, want {per_step}")
        if not _compare_steps(f"{mode} one step, kernels vs plain", kern,
                              plain, ref):
            fail("the kernel path's train step disagrees with the plain path")
        # Planted faults, each in the module's operator handle that the
        # autograd Function calls: (what, module, operator, the operator
        # with the fault given the operator).
        def on_out(hook):
            return lambda o: lambda *a: hook(o(*a))

        faults = [("K10 dv zeroed", ba, "BWD_OP", on_out(
            lambda r: r[:2] + (torch.zeros_like(r[2]),)))]
        if mode == "flash":
            faults.append(("K11 tap gradient zeroed", mf, "BWD_OP",
                           on_out(lambda r: r[:5] + (
                               torch.zeros_like(r[5]),) + r[6:])))
        if mode == "pallas":
            faults.append(("K9 taps negated", mf, "SKIP_OP",
                           lambda o: lambda *a: o(*a[:3], -a[3], *a[4:])))
        for what, mod, attr, wrap in faults:
            orig = getattr(mod, attr)
            setattr(mod, attr, wrap(orig))
            try:
                bad = _one_step(model, sd0, img, lbl, seed)
            finally:
                setattr(mod, attr, orig)
            if _compare_steps(f"  planted fault ({what})", bad, plain):
                fail(f"the gradient check does not see a planted fault "
                     f"({what})")
        del kern, plain, ref, bad

        # The loss on one repeated batch falls over TRAIN_STEPS steps.
        model.load_state_dict(sd0)
        st = TrainState(model, TrainConfig(), 2211 // TRAIN_BATCH)
        fn = make_train_step(st, 9, 0.4, 0.6, wide_head=True,
                             gen=_gen(seed))
        losses = [float(fn(img, lbl)["loss"]) for _ in range(TRAIN_STEPS)]
        log(f"  {TRAIN_STEPS} steps on one batch: losses "
            f"{[round(x, 5) for x in losses]}")
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            fail("the loss does not fall on a repeated batch")

        # Step time in turns (kernels, plain, plain, kernels) and the peak
        # memory of each path alone.
        def timed(m):
            return _step_time(m, img, lbl, seed, 3)

        k_ms1, k_mem, kfn = timed(model)
        del model, kfn
        torch.cuda.empty_cache()
        plain_m = MSTransception(_train_cfg(mode, use_kernels=False), "cuda")
        p_ms1, p_mem, pfn = timed(plain_m)
        p_ms2 = cuda_ms(lambda: pfn(img, lbl), iters=3, warmup=0)
        del plain_m, pfn
        torch.cuda.empty_cache()
        model = MSTransception(_train_cfg(mode), "cuda")
        k_ms2, _, kfn = timed(model)
        k_ms = min(k_ms1, k_ms2)
        log(f"  train step b={TRAIN_BATCH} {mode}: kernels {k_ms1:.3f} / "
            f"{k_ms2:.3f} ms ({TRAIN_BATCH * 1e3 / k_ms:.1f} img/s), plain "
            f"{p_ms1:.3f} / {p_ms2:.3f} ms "
            f"({TRAIN_BATCH * 1e3 / min(p_ms1, p_ms2):.1f} img/s); peak "
            f"memory kernels {k_mem / 2**30:.2f} GiB, plain "
            f"{p_mem / 2**30:.2f} GiB")
        profile_device(lambda: kfn(img, lbl), f"train_{mode}")
        del model, kfn, sd0
        torch.cuda.empty_cache()
    return tallies_out


def _step_time(model, img, lbl, seed, iters, warmup=1):
    """ms a train step of `model` on one batch (CUDA events over `iters`
    steps after one and `warmup`), the peak memory of a step and the step
    function."""
    from transception_tpu_torch.core.config import TrainConfig
    from transception_tpu_torch.train.state import TrainState
    from transception_tpu_torch.train.trainer import make_train_step
    st = TrainState(model, TrainConfig(), 2211 // TRAIN_BATCH)
    fn = make_train_step(st, 9, 0.4, 0.6, wide_head=True, gen=_gen(seed))
    fn(img, lbl)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(lambda: fn(img, lbl), iters=iters, warmup=warmup)
    return ms, torch.cuda.max_memory_allocated(), fn


def fp32_train_phase():
    """Phase 9 at fp32: the published train step at
    TransceptionConfig(dtype="float32") in the three train modes, TF32
    off: one step on the kernels against use_kernels=False from the same
    weights, batch and drop-path masks within FP32_LIMITS, its launches
    exactly launches_per_step; planted faults in the fp32 K10 (every mode),
    K11 (flash) and K9 (pallas) must fail the same check; step time and
    peak memory, kernels on and off; device busy time of a kernel step
    (torch.profiler). Returns the launches per shape key of each mode's
    kernel step."""
    from transception_tpu_torch.data.device_synthetic import (
        DeviceSyntheticStream,
    )
    from transception_tpu_torch.models.transception import (
        MSTransception,
        launches_per_step,
    )
    from transception_tpu_torch.ops import kernels
    from transception_tpu_torch.ops.kernels import (
        bridge_attention as ba,
        mixffn as mf,
    )

    out = {}
    batch = DeviceSyntheticStream(TRAIN_BATCH, 224, 9, device="cuda").batch(0)
    img, lbl = batch["image"], batch["label"]
    for mode in TRAIN_MODES:
        log(f"  -- fp32 train mode {mode} --")
        cfg = _train_cfg(mode, dtype="float32")
        per_step = launches_per_step(cfg)
        seed = DROP_SEED if mode == "pallas" else None
        sd0 = {k: v.clone() for k, v in MSTransception(
            cfg, "cuda", seed=0).state_dict().items()}
        plain_m = MSTransception(_train_cfg(mode, dtype="float32",
                                            use_kernels=False), "cuda")
        plain = _one_step(plain_m, sd0, img, lbl, seed)
        p_ms, p_mem, _ = _step_time(plain_m, img, lbl, seed, 3)
        del plain_m
        torch.cuda.empty_cache()
        model = MSTransception(cfg, "cuda")
        kernels.reset_launches()
        kern = _one_step(model, sd0, img, lbl, seed)
        counts = kernels.launch_counts()
        out[mode] = kernels.shape_counts()
        if counts != per_step:
            fail(f"fp32 {mode}: one step launched {counts}, want {per_step}")
        log(f"  fp32 {mode} one step: launches {counts} = "
            f"launches_per_step")
        if not _compare_steps(f"fp32 {mode} one step, kernels vs plain",
                              kern, plain, lim=FP32_LIMITS):
            fail("the fp32 kernel path's train step disagrees with the "
                 "plain path")

        def on_out(hook):
            return lambda o: lambda *a: hook(o(*a))

        faults = [("fp32 K10 dv zeroed", ba, "BWD_OP", on_out(
            lambda r: r[:2] + (torch.zeros_like(r[2]),)))]
        if mode == "flash":
            faults.append(("fp32 K11 tap gradient zeroed", mf, "BWD_OP",
                           on_out(lambda r: r[:5] + (
                               torch.zeros_like(r[5]),) + r[6:])))
        if mode == "pallas":
            faults.append(("fp32 K9 taps negated", mf, "SKIP_OP",
                           lambda o: lambda *a: o(*a[:3], -a[3], *a[4:])))
        for what, mod, attr, wrap in faults:
            orig = getattr(mod, attr)
            setattr(mod, attr, wrap(orig))
            try:
                bad = _one_step(model, sd0, img, lbl, seed)
            finally:
                setattr(mod, attr, orig)
            if _compare_steps(f"  planted fault ({what})", bad, plain,
                              lim=FP32_LIMITS):
                fail(f"the fp32 gradient check does not see a planted "
                     f"fault ({what})")
        k_ms, k_mem, kfn = _step_time(model, img, lbl, seed, 3)
        log(f"  fp32 train step b={TRAIN_BATCH} {mode}: kernels {k_ms:.3f} "
            f"ms ({TRAIN_BATCH * 1e3 / k_ms:.1f} img/s), plain {p_ms:.3f} ms "
            f"({TRAIN_BATCH * 1e3 / p_ms:.1f} img/s); peak memory kernels "
            f"{k_mem / 2**30:.2f} GiB, plain {p_mem / 2**30:.2f} GiB")
        profile_device(lambda: kfn(img, lbl), f"train_fp32_{mode}")
        del model, sd0, kern, plain, bad, kfn
        torch.cuda.empty_cache()
    return out


AGREE_MIN = 0.98  # class maps against "folds-off" (the JAX sweep's check)


def fold_grid_phase(x):
    """Phase 10. The published model (224², bf16, b=32, random weights
    from seed 0) under every configuration of FOLD_GRID: launches per
    forward against launches_per_forward, class maps against "folds-off",
    the kernel path against use_kernels=False on the same weights and
    config, forward time (CUDA events, best of two); then the three
    configurations with bridge_attn_fold (K8) once at fp32, on K8's fp32
    form. Returns the launches per shape key of each configuration's
    argmax and logits forwards and of the fp32 ones."""
    import dataclasses

    from transception_tpu_torch.core.config import TransceptionConfig
    from transception_tpu_torch.models.transception import (
        MSTransception,
        launches_per_forward,
    )
    from transception_tpu_torch.ops import kernels
    sd, ids, tallies = None, {}, {}

    def run(m, argmax):
        with torch.inference_mode():
            return m(x, argmax=argmax)

    for name, over in FOLD_GRID:
        cfg = pinned(TransceptionConfig(**over))
        model = MSTransception(cfg, "cuda", seed=0)
        if sd is None:
            sd = model.state_dict()
        else:
            model.load_state_dict(sd)
        run(model, True)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        ids[name] = run(model, True)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        tallies[name] = kernels.shape_counts()
        want = launches_per_forward(cfg)
        # The logits forward: K7 at the x4 expander in place of K4.
        kernels.reset_launches()
        logits = run(model, False)
        torch.cuda.synchronize()
        l_counts = kernels.launch_counts()
        tallies[f"{name} logits"] = kernels.shape_counts()
        l_want = launches_per_forward(cfg, argmax=False)
        ms = min(cuda_ms(lambda: run(model, True), iters=1, warmup=0)
                 for _ in range(2))
        plain = MSTransception(dataclasses.replace(cfg, use_kernels=False),
                               "cuda")
        plain.load_state_dict(sd)
        p_ids, p_logits = run(plain, True), run(plain, False)
        del plain
        torch.cuda.synchronize()
        rel = ((logits - p_logits).abs().max()
               / p_logits.abs().max()).item()
        agree_p = (ids[name] == p_ids).float().mean().item()
        short = {k: n for k, n in counts.items() if n}
        log(f"  {name}: launches {short}; {ms:.3f} ms/forward "
            f"({BATCH * 1e3 / ms:.1f} slices/s); vs use_kernels=False: "
            f"logits {rel:.6g} of max|plain| (threshold 0.05), class maps "
            f"{agree_p:.6f} (threshold {AGREE_MIN})")
        if counts != want:
            fail(f"{name}: launches {counts}, want {want}")
        if l_counts != l_want:
            fail(f"{name} logits: launches {l_counts}, want {l_want}")
        if not torch.isfinite(logits).all() or rel > 0.05 or \
                agree_p < AGREE_MIN:
            fail(f"{name}: the kernel path disagrees with the plain path")
        del model, logits, p_logits, p_ids
        torch.cuda.empty_cache()
    ref = ids["folds-off"]
    for name, got in ids.items():
        a = (got == ref).float().mean().item()
        log(f"  {name}: class maps vs folds-off {a:.6f} "
            f"(threshold {AGREE_MIN})")
        if a < AGREE_MIN:
            fail(f"{name}: class maps disagree with folds-off")
    # The configurations that run K8, once at fp32 (its fp32 form): the
    # argmax forward's launches exactly launches_per_forward, logits and
    # class maps against use_kernels=False within phase 5's fp32 limits.
    for name, over in FOLD_GRID:
        cfg = pinned(TransceptionConfig(dtype="float32", **over))
        if not cfg.bridge_attn_fold:
            continue
        model = MSTransception(cfg, "cuda", seed=0)
        model.load_state_dict(sd)
        run(model, True)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        k_ids = run(model, True)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        tallies[f"{name} fp32"] = kernels.shape_counts()
        plain = MSTransception(dataclasses.replace(cfg, use_kernels=False),
                               "cuda")
        plain.load_state_dict(sd)
        lk, lp, p_ids = run(model, False), run(plain, False), run(plain, True)
        torch.cuda.synchronize()
        rel = ((lk - lp).abs().max() / lp.abs().max()).item()
        agree = (k_ids == p_ids).float().mean().item()
        log(f"  {name} fp32: launches {({k: n for k, n in counts.items() if n})}"
            f"; vs use_kernels=False: logits {rel:.6g} of max|plain| "
            f"(tolerance {FP32_LOGITS_TOL}), class maps {agree:.6f} "
            f"(threshold {FP32_AGREE})")
        if counts != launches_per_forward(cfg):
            fail(f"{name} fp32: launches {counts}, want "
                 f"{launches_per_forward(cfg)}")
        if counts["bridge_attention_folded"] == 0:
            fail(f"{name} fp32: K8's fp32 form never launched")
        if not torch.isfinite(lk).all() or rel > FP32_LOGITS_TOL or \
                agree < FP32_AGREE:
            fail(f"{name} fp32: the kernel path disagrees with the plain "
                 f"path")
        del model, plain, lk, lp
        torch.cuda.empty_cache()
    return tallies


VOLUME_AGREE = 0.99   # on-card resample against the host spline path
RESAMPLE_TOL = 1e-6   # |on-card spline - host spline|, with TF32 on
# Slices of 512² kept from each synthetic volume: its metric passes (HD95
# on random labels) and its NIfTI export (gzip) cost seconds a slice on
# the host; the whole smoke must stay within its time limit.
VOLUME_SLICES = 8


class _FirstSlices:
    """The first `d` slices of each volume of a volume dataset."""

    def __init__(self, ds, d):
        self.ds, self.d = ds, d

    def __len__(self):
        return len(self.ds)

    def get(self, idx):
        v = dict(self.ds.get(idx))
        v["image"], v["label"] = v["image"][:self.d], v["label"][:self.d]
        return v


def volume_phase():
    """Phase 11. The published model (224², bf16, seed-0 weights) through
    the volume evaluation of eval/inference.py on SyntheticVolumeDataset
    volumes of 512², their first VOLUME_SLICES slices: run_inference on
    the host spline path (its log lines, launches per chunk, the wall
    time split) on the first volume; the two on-card resample paths
    against the host path's class maps with TF32 off and switched on
    globally, on the first two volumes; the full-resolution class maps
    of the kernels against the plain path (predict_volume and the
    back-resize, no metrics); and cli.test.main in-process on the first
    volume (bf16 --is_savenii from a .pth of the same weights:
    run_inference's means, volumes that load back and equal the host
    path's class maps; one pass of the fp32 default on the fp32 kernels;
    fp16 with the kernels on raises before any work). The metrics (HD95
    on random labels, seconds a slice on the host) and the NIfTI export
    run on one volume a pass, so that the whole smoke stays within its
    time limit. Returns the launches per shape key of its kernel
    forwards and their number."""
    import dataclasses
    import tempfile

    from transception_tpu_torch.cli import test as cli
    from transception_tpu_torch.core.config import TransceptionConfig
    from transception_tpu_torch.data import synapse
    from transception_tpu_torch.data.synapse import SyntheticVolumeDataset
    from transception_tpu_torch.eval import inference as inf
    from transception_tpu_torch.eval.nifti import load_nifti
    from transception_tpu_torch.models.transception import (
        MSTransception,
        launches_per_forward,
    )
    from transception_tpu_torch.ops import kernels

    cfg = TransceptionConfig()
    per = launches_per_forward(cfg)
    model = MSTransception(cfg, "cuda", seed=0)
    ds = _FirstSlices(SyntheticVolumeDataset(length=2, hw=512),
                      VOLUME_SLICES)
    vols = [ds.get(i) for i in range(len(ds))]
    chunks = [math.ceil(v["image"].shape[0] / BATCH) for v in vols]
    # The metric passes' set: the first volume alone (the same case).
    ds1 = _FirstSlices(SyntheticVolumeDataset(length=1, hw=512),
                       VOLUME_SLICES)
    total, n_fwd = Counter(), 0

    def counted(what, n_chunks, fn, per=per):
        """fn() with the launch counters reset before and read after;
        fails unless each kernel launched per x n_chunks times (per:
        launches_per_forward of the run's config)."""
        nonlocal n_fwd
        kernels.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        for name, n in per.items():
            if counts[name] != n * n_chunks:
                fail(f"{what}: {name} {counts[name]} launches, want {n} x "
                     f"{n_chunks} chunks")
        log(f"  {what}: launches {({k: n for k, n in counts.items() if n})}"
            f" = launches_per_forward x {n_chunks} chunks")
        total.update(kernels.shape_counts())
        n_fwd += n_chunks
        return out

    # 1. run_inference on the host spline path.
    stats = []
    t0 = time.perf_counter()
    means = counted("run_inference", chunks[0], lambda: inf.run_inference(
        model, ds1, cfg.num_classes, cfg.img_size, BATCH,
        log=lambda s: log(f"    {s}"), stats=stats))
    log(f"  run_inference: {time.perf_counter() - t0:.3f} s for "
        f"{len(ds1)} volume of {vols[0]['image'].shape}")
    for i, st in enumerate(stats):
        log(f"  volume {i} wall seconds: " + ", ".join(
            f"{k} {st[k]:.3f}" for k in ("load", "resample", "forward",
                                         "back_resize", "save",
                                         "metrics_wait")) +
            f"; metric thread {st['metrics']:.3f} ({cfg.num_classes - 1} "
            f"classes, DSC and HD95)")

    # 2. The on-card resample paths against the host path's class maps,
    # with the script's TF32 switches off and then with TF32 on globally:
    # the predictor's products must not take it.
    host = inf.make_predictor(model, cfg.img_size, BATCH)
    want = counted("host predict_volume", sum(chunks), lambda: [
        inf._resize_pred_back(host.predict_volume(v["image"]),
                              *v["image"].shape[1:]) for v in vols])
    dres = inf.make_predictor(model, cfg.img_size, BATCH,
                              device_resample=True)
    dev = inf.make_device_predictor(model, cfg.img_size, BATCH)

    def on_card(tf32):
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            sl = vols[0]["image"][:BATCH]
            a_h, a_w = inf._operators(*sl.shape[1:], cfg.img_size,
                                      torch.device("cuda"))
            got = inf._resample(torch.from_numpy(sl).cuda(), a_h, a_w)
            err = (got.cpu() - torch.from_numpy(
                inf.resize_slices(sl, cfg.img_size))).abs().max().item()
            log(f"  TF32 {'on' if tf32 else 'off'}: on-card spline vs host "
                f"spline max_abs_err {err:.3g} (tolerance {RESAMPLE_TOL})")
            if err > RESAMPLE_TOL:
                fail("the on-card resample disagrees with the host spline")
            t0 = time.perf_counter()
            got_r = counted(f"make_predictor(device_resample=True), TF32 "
                            f"{tf32}", sum(chunks), lambda: [
                                inf._resize_pred_back(
                                    dres.predict_volume(v["image"]),
                                    *v["image"].shape[1:]) for v in vols])
            t1 = time.perf_counter()
            got_d = counted(f"make_device_predictor, TF32 {tf32}",
                            sum(chunks),
                            lambda: [dev(v["image"]) for v in vols])
            t2 = time.perf_counter()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        for what, got, secs in (("device_resample", got_r, t1 - t0),
                                ("device predictor", got_d, t2 - t1)):
            agree = np.mean([(g == w).mean() for g, w in zip(got, want)])
            log(f"  TF32 {'on' if tf32 else 'off'}: {what} class maps vs "
                f"host path {agree:.6f} (threshold {VOLUME_AGREE}), "
                f"{secs:.3f} s for both volumes")
            if agree < VOLUME_AGREE:
                fail(f"{what} disagrees with the host spline path")
        if not all((a == b).all() for a, b in zip(got_d, got_r)):
            fail("the device predictor's gather is not the host "
                 "back-resize of the same forward")
        return got_r

    got_r = on_card(False)
    got_r32 = on_card(True)
    moved = 1 - np.mean([(a == b).mean() for a, b in zip(got_r32, got_r)])
    log(f"  TF32 on moves {moved:.6f} of the device_resample class maps; "
        f"the spline did not move, the forward did")

    # 3. Kernels against the plain path on the same weights: the
    # full-resolution class maps of test_single_volume's path
    # (predict_volume, then the back-resize), without its metrics.
    plain = MSTransception(dataclasses.replace(cfg, use_kernels=False),
                           "cuda")
    plain.load_state_dict(model.state_dict())
    v = vols[0]
    k_pred = counted("kernel predict_volume", chunks[0],
                     lambda: inf._resize_pred_back(
                         host.predict_volume(v["image"]),
                         *v["image"].shape[1:]))
    p_pred = inf._resize_pred_back(
        inf.make_predictor(plain, cfg.img_size, BATCH).predict_volume(
            v["image"]), *v["image"].shape[1:])
    agree = (k_pred == p_pred).mean()
    log(f"  kernel vs plain full-resolution class maps {agree:.6f} "
        f"(threshold {AGREE_MIN})")
    if agree < AGREE_MIN:
        fail("volume eval: the kernel path disagrees with the plain path")
    del plain

    # 4. The CLI in-process, from a .pth of the same weights, on
    # run_inference's volume: one bf16 run with --is_savenii, one run of
    # the fp32 default (the published protocol) on the fp32 kernels, and
    # fp16 with the kernels on, which must raise before it reads or builds
    # anything.
    @contextlib.contextmanager
    def cli_on_ds1():
        real = synapse.make_test_dataset
        synapse.make_test_dataset = lambda data_cfg: ds1
        try:
            yield
        finally:
            synapse.make_test_dataset = real

    with tempfile.TemporaryDirectory(
            dir=Path(__file__).resolve().parent) as tmp, cli_on_ds1():
        pth = f"{tmp}/seed0.pth"
        torch.save(model.state_dict(), pth)
        args = ["--dataset", "synthetic", "--weight_pth", pth]
        t0 = time.perf_counter()
        got = counted("cli.test bf16 --is_savenii", chunks[0],
                      lambda: cli.main(args + [
                          "--dtype", "bfloat16", "--output_dir",
                          f"{tmp}/bf16", "--is_savenii"]))
        log(f"  cli.test bf16: {got} in {time.perf_counter() - t0:.3f} s, "
            f"run_inference {means}")
        if got != means:
            fail("cli.test.main disagrees with run_inference")
        for v, want_h in zip(vols[:len(ds1)], want):
            for kind in ("img", "pred", "gt"):
                arr, sp = load_nifti(f"{tmp}/bf16/predictions/"
                                     f"{v['case_name']}_{kind}.nii.gz")
                if arr.shape != v["image"].shape or sp != (1.0, 1.0, 1.0):
                    fail(f"{kind}.nii.gz: {arr.shape} {sp}")
                if kind == "pred" and not (arr == want_h).all():
                    fail("the saved class maps are not the host path's")
        log("  cli.test --is_savenii: 3 volumes per case load back, the "
            "class maps equal the host path's")
        per32 = launches_per_forward(TransceptionConfig(dtype="float32"))
        t0 = time.perf_counter()
        got32 = counted("cli.test fp32 default", chunks[0],
                        lambda: cli.main(args + ["--output_dir",
                                                 f"{tmp}/fp32"]), per32)
        log(f"  cli.test fp32 default (fp32 kernels, TF32 off): {got32} in "
            f"{time.perf_counter() - t0:.3f} s")
        if not all(math.isfinite(v) for v in got32):
            fail("the fp32 CLI run's means are not finite")
        if torch.backends.cudnn.allow_tf32 or \
                torch.backends.cuda.matmul.allow_tf32:
            fail("the fp32 CLI run left TF32 on")
        try:
            cli.main(args + ["--dtype", "float16", "--output_dir",
                             f"{tmp}/fp16"])
        except ValueError as e:
            said = all(w in str(e) for w in ("--dtype float32",
                                             "--dtype bfloat16",
                                             "--no_pallas"))
            log(f"  cli.test fp16 with the kernels on raises: {e}")
        else:
            said = False
        if not said or os.path.exists(f"{tmp}/fp16"):
            fail("the fp16 CLI run with the kernels on did not refuse "
                 "before any work, naming --dtype float32, --dtype bfloat16 "
                 "and --no_pallas")
    return total, n_fwd


# Phase 12: the train CLI on Synapse-format .npz slices of 512² written for
# the run (CLI_SLICES: two batches of 24 an epoch), CLI_STEPS steps, then a
# resume to one more under --profile; --throughput's warm-up step and 20.
CLI_SLICES = 48
CLI_STEPS = 2
THROUGHPUT_STEPS = 21


def _write_synapse_slices(root, n, hw=512):
    """n Synapse-format train slices, {case}_sliceNNN.npz with 'image'
    (fp32 in [0, 1)) and 'label' (classes 0-8 stored as fp32) of hw²,
    under root/npz, and their names in root/lists/train.txt."""
    rng = np.random.default_rng(12)
    (root / "npz").mkdir()
    (root / "lists").mkdir()
    names = [f"case{i // 16:04d}_slice{i % 16:03d}" for i in range(n)]
    for name in names:
        np.savez(root / "npz" / f"{name}.npz",
                 image=rng.random((hw, hw), dtype=np.float32),
                 label=rng.integers(0, 9, (hw, hw)).astype(np.float32))
    (root / "lists" / "train.txt").write_text("\n".join(names) + "\n")
    return names


def loader_step_profile(root, dtype, warm=1, steps=5, profiled=1):
    """The published train step (b=24, wide head) fed by the host loader
    from the .npz slices under root (augment, zoom to 224², 4 threads):
    wall ms a step over `steps` steps after `warm`, beside the device busy
    ms a step of `profiled` more under torch.profiler (device activity
    only: its event processing is seconds a step); and the loader alone,
    ms a batch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from transception_tpu_torch.core.config import (
        TrainConfig,
        TransceptionConfig,
    )
    from transception_tpu_torch.data.loader import HostDataLoader, to_device
    from transception_tpu_torch.data.synapse import SynapseSliceDataset
    from transception_tpu_torch.models.transception import MSTransception
    from transception_tpu_torch.train.state import TrainState
    from transception_tpu_torch.train.trainer import make_train_step

    names = (root / "lists" / "train.txt").read_text().split()
    (root / "lists" / "train_rep.txt").write_text("\n".join(names * 6))
    ds = SynapseSliceDataset(str(root / "npz"), str(root / "lists"), 224,
                             augment=True, split="train_rep")
    ld = HostDataLoader(ds, TRAIN_BATCH, seed=1234, num_workers=4)
    it = iter(ld)
    t0 = time.perf_counter()
    for _ in range(4):
        next(it)
    host_ms = (time.perf_counter() - t0) / 4 * 1e3
    it.close()
    dev = torch.device("cuda")
    model = MSTransception(TransceptionConfig(dtype=dtype), dev, seed=0)
    st = TrainState(model, TrainConfig(), len(ld))
    fn = make_train_step(st, 9, 0.4, 0.6, wide_head=True)
    ld.set_epoch(1)
    it = iter(ld)
    for _ in range(warm):
        fn(*to_device(next(it), dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn(*to_device(next(it), dev))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(profiled):
            fn(*to_device(next(it), dev))
        torch.cuda.synchronize()
        pwall = (time.perf_counter() - t0) / profiled * 1e3
    it.close()
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3 / profiled
    log(f"  host loader + train step, {dtype}, b={TRAIN_BATCH}: wall "
        f"{wall:.1f} ms a step ({TRAIN_BATCH * 1e3 / wall:.1f} img/s); "
        f"device busy {busy:.1f} ms a step of {pwall:.1f} ms profiled wall "
        f"(idle share {1 - busy / pwall:.3f}); the loader alone "
        f"{host_ms:.1f} ms a batch (augment and zoom of 24 slices of 512², "
        f"4 threads)")
    del model, st, fn
    torch.cuda.empty_cache()


def cli_phase():
    """Phase 12. The train CLI (cli.train.main, in-process at --dp_size
    1, whose default would start a rank on every visible card) at its
    defaults: bf16, the published TransceptionConfig() at 224², b=24,
    augment on, 4 loader threads, on Synapse-format .npz slices of 512²
    written for the run, with the in-training eval on one small synthetic
    volume (as phase 9's: the default test set, two volumes of 512² with
    uniform random labels, costs ~45 s of host HD95 an eval, and phase 11
    runs it three times). Held: the iteration
    log lines, the checkpoint, the eval's per-class lines and finite
    dice/HD95 histories, results.tsv, the launches of each train step
    exactly launches_per_step and of each eval chunk launches_per_forward;
    a second call that resumes from the checkpoint under --profile (its
    trace file); --throughput at bf16 and at --dtype float32 (their
    lines, launches exactly 21 x launches_per_step without the wide
    head); and the wall time of a step fed by the host loader beside its
    device busy time, at both dtypes. Returns the launches per shape key
    of the train steps, the evals and the throughput steps, with their
    counts."""
    import io
    import re
    import tempfile

    from transception_tpu_torch.cli import train as cli
    from transception_tpu_torch.core.config import TransceptionConfig
    from transception_tpu_torch.data.synapse import SyntheticVolumeDataset
    from transception_tpu_torch.models.transception import (
        launches_per_forward,
        launches_per_step,
    )
    from transception_tpu_torch.ops import kernels

    cfg = TransceptionConfig()
    per_step, per_fwd = launches_per_step(cfg), launches_per_forward(cfg)
    steps_t, evals_t, chunks = Counter(), Counter(), 0
    small = SyntheticVolumeDataset(length=1, hw=PHASE9_EVAL_HW)
    runs = []
    with tempfile.TemporaryDirectory(
            dir=Path(__file__).resolve().parent) as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        _write_synapse_slices(root, CLI_SLICES)
        log(f"  wrote {CLI_SLICES} Synapse-format .npz train slices of 512² "
            f"in {time.perf_counter() - t0:.1f} s")
        out = root / "out"
        argv = ["--dataset", "Synapse", "--root_path", str(root / "npz"),
                "--list_dir", str(root / "lists"), "--num_workers", "4",
                "--output_dir", str(out), "--dp_size", "1"]
        for n_steps, extra in ((CLI_STEPS, []),
                               (CLI_STEPS + 1, ["--profile"])):
            t0 = time.perf_counter()
            with trainer_evals(small) as ev:
                kernels.reset_launches()
                st, hist = cli.main(argv + ["--max_steps", str(n_steps)]
                                    + extra)
                torch.cuda.synchronize()
                counts, tallies = (kernels.launch_counts(),
                                   kernels.shape_counts())
            secs = time.perf_counter() - t0
            text = (out / "log.txt").read_text()
            losses = _logged_losses(text)
            ran = n_steps - (0 if not extra else CLI_STEPS)
            log(f"  cli.train --max_steps {n_steps} {' '.join(extra)}: "
                f"{secs:.1f} s; logged losses {losses}; eval {hist}; "
                f"{ev['evals']} eval of {ev['chunks']} chunks")
            ckpt = out / "ckpt" / f"step_{n_steps:08d}.pt"
            if st.step != n_steps or len(losses) != 1 + bool(extra) or \
                    not np.isfinite(losses + hist["dice"]
                                    + hist["hd95"]).all() or \
                    len(hist["dice"]) != 1 or ev["evals"] != 1 or \
                    f"iteration {n_steps} : lr" not in text or \
                    text.count("Mean class 8 mean_dice") != 1 + bool(extra) \
                    or not ckpt.exists():
                fail(f"cli.train --max_steps {n_steps}: step {st.step}, "
                     f"losses {losses}, eval {hist}")
            held_run(f"cli.train --max_steps {n_steps}", counts, ev, ran,
                     per_step, per_fwd)
            steps_t += Counter(tallies) - ev["tallies"]
            evals_t += ev["tallies"]
            chunks += ev["chunks"]
            rows = (out / "results.tsv").read_text().splitlines()
            if rows[0] != "\tmean_dice\tmean_hd95" or len(rows) != 2 or \
                    float(rows[1].split("\t")[1]) != hist["dice"][0]:
                fail(f"results.tsv: {rows}")
            log(f"    results.tsv: {rows}; launches of a step = "
                f"launches_per_step, of an eval chunk launches_per_forward")
            if extra:
                trace = out / "profile" / "trace.json"
                if "resumed from" not in text or not trace.exists() or \
                        trace.stat().st_size == 0:
                    fail("the --profile call did not resume or left no "
                         "trace")
                log(f"    resumed from step {CLI_STEPS}; --profile trace "
                    f"{trace.stat().st_size / 2**20:.1f} MiB")
            del st
            torch.cuda.empty_cache()
        runs.append(("per train CLI step", steps_t, CLI_STEPS + 1))
        runs.append(("per forward, train CLI eval", evals_t, chunks))

        for dtype in ("bfloat16", "float32"):
            want = {k: THROUGHPUT_STEPS * n for k, n in launches_per_step(
                TransceptionConfig(dtype=dtype), wide_head=False).items()}
            buf = io.StringIO()
            kernels.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                got = cli.main(["--throughput", "--dtype", dtype,
                                "--dp_size", "1"])
            torch.cuda.synchronize()
            line = buf.getvalue().strip().splitlines()[-1]
            log(f"  cli.train --throughput --dtype {dtype}: {line} "
                f"({time.perf_counter() - t0:.1f} s)")
            counts = kernels.launch_counts()
            if got != (None, None) or counts != want or not re.fullmatch(
                    r"train throughput: [0-9.]+ imgs/s \([0-9.]+ ms/step at "
                    rf"batch {TRAIN_BATCH}\)", line):
                fail(f"--throughput --dtype {dtype}: {line}, launches "
                     f"{counts}, want {want}")
            runs.append((f"per --throughput step, {dtype}",
                         kernels.shape_counts(), THROUGHPUT_STEPS))
            torch.cuda.empty_cache()

        for dtype in ("bfloat16", "float32"):
            loader_step_profile(root, dtype)
    return runs


# Phase 13: the registry's ablation variants (models/registry.py), and the
# other IFF modes, token MLPs and no bridge at VARIANT_BATCH.
VARIANTS = ("mstransception_4stage", "mstransception_casa",
            "mstransception_sp", "mstransception_para")
VARIANT_GRID = tuple((f"concat {c}", dict(concat=c)) for c in (
    "normal", "3d", "se", "skn", "cbam", "cam", "cam_fact")) + (
    ("token_mlp mix", dict(token_mlp="mix")),
    ("token_mlp mlp", dict(token_mlp="mlp")),
    ("have_bridge none", dict(have_bridge="none")))
VARIANT_EVAL_HW = 64  # the small synthetic test volume of the CLI runs
# The variants' forwards and steps: one block and one path a stage (every
# block's shapes, fewer blocks; the 4-stage backbone's depth is fixed).
VARIANT_DEPTH = dict(num_layers=(1, 1, 1), num_path=(1, 1, 1))


def _paths_agree(what, model, x, fp32, build=None):
    """The kernel path of `model` against use_kernels=False on the same
    weights and pinned structure, on slices x: logits and class maps
    within phase 5's limits (bf16: 0.05 of max|plain| and 0.98 equal, and
    against an fp32 plain model the kernel's maps at most 0.005 less
    equal than the plain path's; fp32: FP32_LOGITS_TOL and FP32_AGREE).
    build(cfg) makes the other models (an MSTransception by default).
    Returns (kernel ms, plain ms) of the class-id forward (CUDA events;
    eval.inference.class_ids)."""
    import dataclasses

    from transception_tpu_torch.eval.inference import class_ids
    from transception_tpu_torch.models.transception import MSTransception
    build = build or (lambda c: MSTransception(c, "cuda"))
    cfg = dataclasses.replace(pinned(model.cfg), use_kernels=False)
    plain = build(cfg)
    plain.load_state_dict(model.state_dict())

    def fwd(m, argmax=True):
        with torch.inference_mode():
            return class_ids(m, x) if argmax else m(x)

    lk, lp = fwd(model, False), fwd(plain, False)
    ik, ip = fwd(model), fwd(plain)
    torch.cuda.synchronize()
    rel = ((lk - lp).abs().max() / lp.abs().max()).item()
    agree = (ik == ip).float().mean().item()
    tol, amin = (FP32_LOGITS_TOL, FP32_AGREE) if fp32 else (0.05, AGREE_MIN)
    ms = cuda_ms(lambda: fwd(model), iters=3, warmup=1)
    pms = cuda_ms(lambda: fwd(plain), iters=2, warmup=1)
    msg = (f"  {what}: vs use_kernels=False logits {rel:.6g} of max|plain| "
           f"(tolerance {tol}), class maps {agree:.6f} (threshold {amin})")
    trails = False
    if not fp32:
        ref = build(dataclasses.replace(cfg, dtype="float32"))
        ref.load_state_dict(model.state_dict())
        ir = fwd(ref)
        a_kr, a_pr = ((i == ir).float().mean().item() for i in (ik, ip))
        trails = a_kr < a_pr - 0.005
        msg += (f"; vs an fp32 model kernel {a_kr:.6f}, plain {a_pr:.6f} "
                f"(kernel may trail plain by at most 0.005)")
        del ref
    log(msg + f"; forward b={x.shape[0]} argmax {ms:.3f} ms (plain "
        f"{pms:.3f} ms)")
    if not torch.isfinite(lk).all() or rel > tol or agree < amin or trails:
        fail(f"{what}: the kernel path disagrees with the plain path")
    del plain
    return ms, pms


def variants_phase():
    """Phase 13. The four ablation variants of the registry at full width
    (224², widths 64/128/320/512, random weights from seed 0) and
    VARIANT_DEPTH (one block and one path a stage): each
    through make_predictor(...).predict_volume on BATCH slices of 512² at
    bf16 and at fp32 (launches exactly launches_per_forward, the kernel
    path against the plain path, forward time), and one train step at
    TRAIN_BATCH in the default train mode against the plain path from the
    same weights with the same dropout and drop-path masks (the bf16 step
    limits; launches exactly launches_per_step). Then one bf16 argmax
    forward at VARIANT_BATCH for each other IFF mode, each token MLP and
    no bridge against its plain path, launches exact; cli.test.main with
    --have_bridge sp at its fp32 default on one small synthetic volume,
    which must launch K8's fp32 form on every routed call and never its
    plain version; cli.train.main --model mstransception_para for
    CLI_STEPS steps on the on-card synthetic stream with its end-of-run
    eval on that volume. Returns the runs' launches per shape key."""
    import dataclasses
    import tempfile

    from transception_tpu_torch.cli import test as test_cli
    from transception_tpu_torch.cli import train as train_cli
    from transception_tpu_torch.core.config import TransceptionConfig
    from transception_tpu_torch.data import synapse
    from transception_tpu_torch.data.device_synthetic import (
        DeviceSyntheticStream,
    )
    from transception_tpu_torch.eval.inference import (
        make_predictor,
        resize_slices,
    )
    from transception_tpu_torch.models.registry import model_config
    from transception_tpu_torch.models.transception import (
        MSTransception,
        launches_per_forward,
        launches_per_step,
    )
    from transception_tpu_torch.ops import kernels
    from transception_tpu_torch.ops.kernels import bridge_attention as ba

    runs = []
    vol = np.random.default_rng(13).random((BATCH, 512, 512),
                                           dtype=np.float32)
    x = torch.from_numpy((resize_slices(vol, 224) - 0.5) / 0.5).cuda()[
        ..., None]
    batch = DeviceSyntheticStream(TRAIN_BATCH, 224, 9, device="cuda").batch(1)
    img, lbl = batch["image"], batch["label"]
    for name in VARIANTS:
        for dtype in ("bfloat16", "float32"):
            t0 = time.perf_counter()
            cfg = model_config(name, TransceptionConfig(dtype=dtype,
                                                        **VARIANT_DEPTH))
            model = MSTransception(cfg, "cuda", seed=0)
            predict = make_predictor(model, cfg.img_size, BATCH)
            predict.predict_volume(vol)  # warm-up
            torch.cuda.synchronize()
            kernels.reset_launches()
            pred = predict.predict_volume(vol)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            runs.append((f"per forward, {name} {dtype}",
                         kernels.shape_counts(), 1))
            short = {k: n for k, n in counts.items() if n}
            log(f"  {name} {dtype}: predict_volume {pred.shape} "
                f"{pred.dtype}, launches {short}")
            if pred.shape != (BATCH, 224, 224) or pred.dtype != np.uint8:
                fail(f"{name} {dtype}: predict_volume output {pred.shape}")
            if counts != launches_per_forward(cfg):
                fail(f"{name} {dtype}: launches {counts}, want "
                     f"{launches_per_forward(cfg)}")
            _paths_agree(f"{name} {dtype}", model, x, dtype == "float32")
            log(f"    {time.perf_counter() - t0:.1f} s")
            del model, predict
            torch.cuda.empty_cache()
        # One train step (bf16, default mode) against the plain path.
        t0 = time.perf_counter()
        cfg = model_config(name, TransceptionConfig(**VARIANT_DEPTH))
        model = MSTransception(cfg, "cuda", seed=0)
        sd0 = {k: t.clone() for k, t in model.state_dict().items()}
        kernels.reset_launches()
        k_step = _one_step(model, sd0, img, lbl, DROP_SEED)
        counts = kernels.launch_counts()
        runs.append((f"per {name} train step", kernels.shape_counts(), 1))
        if counts != launches_per_step(cfg):
            fail(f"{name} train step: launches {counts}, want "
                 f"{launches_per_step(cfg)}")
        del model
        plain = MSTransception(dataclasses.replace(cfg, use_kernels=False),
                               "cuda")
        p_step = _one_step(plain, sd0, img, lbl, DROP_SEED)
        if not _compare_steps(f"{name} train step b={TRAIN_BATCH}, "
                              f"launches {({k: n for k, n in counts.items() if n})}",
                              k_step, p_step):
            fail(f"{name}: the kernel train step disagrees with the plain "
                 f"path")
        log(f"    {time.perf_counter() - t0:.1f} s")
        del plain, sd0, k_step, p_step
        torch.cuda.empty_cache()

    x8 = x[:VARIANT_BATCH]
    for name, over in VARIANT_GRID:
        cfg = TransceptionConfig(**over, **VARIANT_DEPTH)
        model = MSTransception(cfg, "cuda", seed=0)
        with torch.inference_mode():
            model(x8, argmax=True)  # warm-up
            torch.cuda.synchronize()
            kernels.reset_launches()
            model(x8, argmax=True)
            torch.cuda.synchronize()
        counts = kernels.launch_counts()
        runs.append((f"per forward, {name} b={VARIANT_BATCH}",
                     kernels.shape_counts(), 1))
        if counts != launches_per_forward(cfg):
            fail(f"{name}: launches {counts}, want "
                 f"{launches_per_forward(cfg)}")
        _paths_agree(f"{name} b={VARIANT_BATCH}, launches "
                     f"{({k: n for k, n in counts.items() if n})}", model, x8,
                     False)
        del model
        torch.cuda.empty_cache()

    small = synapse.SyntheticVolumeDataset(length=1, hw=VARIANT_EVAL_HW)
    chunks = math.ceil(small.get(0)["image"].shape[0] / BATCH)
    with tempfile.TemporaryDirectory(
            dir=Path(__file__).resolve().parent) as tmp:
        # The test CLI with --have_bridge sp at its fp32 default.
        t0 = time.perf_counter()
        sp_cfg = TransceptionConfig(have_bridge="sp", dtype="float32")
        model = MSTransception(sp_cfg, "cuda", seed=0)
        torch.save(model.state_dict(), f"{tmp}/sp.pth")
        del model
        plain_calls = []
        real_plain, real_ds = ba.bridge_attention_folded_plain, \
            synapse.make_test_dataset

        def counted_plain(*a, **k):
            plain_calls.append(1)
            return real_plain(*a, **k)

        ba.bridge_attention_folded_plain = counted_plain
        synapse.make_test_dataset = lambda cfg: small
        try:
            kernels.reset_launches()
            means = test_cli.main(["--dataset", "synthetic", "--have_bridge",
                                   "sp", "--weight_pth", f"{tmp}/sp.pth",
                                   "--output_dir", f"{tmp}/sp"])
            torch.cuda.synchronize()
        finally:
            ba.bridge_attention_folded_plain = real_plain
            synapse.make_test_dataset = real_ds
        counts, routed = kernels.launch_counts(), kernels.routed_counts()
        tallies = kernels.shape_counts()
        runs.append(("per forward, cli.test --have_bridge sp (fp32)",
                     tallies, chunks))
        want = {k: n * chunks
                for k, n in launches_per_forward(sp_cfg).items()}
        k8 = {key: n for key, n in tallies.items()
              if key[0] == "bridge_attention_folded"}
        log(f"  cli.test --have_bridge sp (fp32 default): means {means}; "
            f"launches {({k: n for k, n in counts.items() if n})} over "
            f"{chunks} chunks; K8 launches by shape {k8}; K8 plain calls "
            f"{len(plain_calls)} ({time.perf_counter() - t0:.1f} s)")
        if counts != want or not k8 or \
                any(key[-1] != "fp32" for key in k8) or plain_calls or \
                routed.get("bridge_attention_folded") != \
                counts["bridge_attention_folded"] or \
                not all(math.isfinite(v) for v in means):
            fail("cli.test --have_bridge sp did not run K8's fp32 form on "
                 "every call, or its launches are not launches_per_forward")

        # The train CLI with the para bridge.
        t0 = time.perf_counter()
        para = model_config("mstransception_para", TransceptionConfig())
        out = Path(tmp) / "para"
        with trainer_evals(small) as ev:
            kernels.reset_launches()
            st, hist = train_cli.main([
                "--model", "mstransception_para", "--dataset", "synthetic",
                "--device_data", "--max_steps", str(CLI_STEPS),
                "--dp_size", "1", "--output_dir", str(out)])
            torch.cuda.synchronize()
            counts, tallies = kernels.launch_counts(), kernels.shape_counts()
        losses = _logged_losses((out / "log.txt").read_text())
        log(f"  cli.train --model mstransception_para --max_steps "
            f"{CLI_STEPS}: logged losses {losses}, eval {hist}, launches "
            f"{({k: n for k, n in counts.items() if n})} "
            f"({time.perf_counter() - t0:.1f} s)")
        if st.model.cfg.have_bridge != "para" or st.step != CLI_STEPS or \
                not losses or not np.isfinite(
                    losses + hist["dice"] + hist["hd95"]).all() or \
                ev["evals"] != 1:
            fail(f"cli.train para: step {st.step}, losses {losses}, {hist}")
        held_run("cli.train para", counts, ev, CLI_STEPS,
                 launches_per_step(para), launches_per_forward(para))
        runs.append(("per para train CLI step",
                     Counter(tallies) - ev["tallies"], CLI_STEPS))
        runs.append(("per forward, para train CLI eval", ev["tallies"],
                     ev["chunks"]))
        del st
        torch.cuda.empty_cache()
    return runs


# ---- phase 14: data parallelism on the card ----

# One b=24 step each through the data-parallel Trainer: (label,
# TransceptionConfig overrides, the limits of phase 9 for its dtype).
DP_MODES = (("bf16 default", {}, BF16_LIMITS),
            ("bf16 flash", dict(ffn_flash_train=True), BF16_LIMITS),
            ("fp32 default", dict(dtype="float32"), FP32_LIMITS))
DP_EVAL_HW = 64       # the test CLI's one synthetic volume


def _dp_trainer(overrides, out, mesh=None):
    """A Trainer of the published model (TrainConfig(): b=24, wide head;
    weights from its seed) on `mesh` (None: the one-process Trainer)."""
    from transception_tpu_torch.core.config import (
        DataConfig,
        TrainConfig,
        TransceptionConfig,
    )
    from transception_tpu_torch.parallel.mesh import DataMesh
    from transception_tpu_torch.train.trainer import Trainer
    if mesh is None:
        mesh = DataMesh(0, 1, torch.device("cuda", 0))
    return Trainer(TransceptionConfig(**overrides),
                   TrainConfig(output_dir=str(out)),
                   DataConfig(dataset="synthetic"), device="cuda",
                   mesh=mesh)


DP_TIME_STEPS = 3     # steps timed after the compared one (CUDA events)


def _dp_step(tr, img, lbl):
    """One Trainer step on this rank's rows of the global batch: (the
    global loss, gradients, buffers) on the host, as _one_step gives
    them, and the ms of a step over DP_TIME_STEPS more (the weights move
    on; the result is taken first)."""
    _, step = tr.init_state(2211 // TRAIN_BATCH)
    rows = tr.mesh.rows(img.shape[0])
    met = step(img[rows], lbl[rows])
    torch.cuda.synchronize()
    m = tr.model
    res = (float(met["loss"]),
           {n: p.grad.float().cpu() for n, p in m.named_parameters()},
           {n: b.float().cpu() for n, b in m.named_buffers()})
    return res, cuda_ms(lambda: step(img[rows], lbl[rows]),
                        iters=DP_TIME_STEPS, warmup=0)


def _bits_equal(a, b):
    """Leaves of (loss, grads, buffers) a and b with the same bits."""
    same = sum(torch.equal(x, b[1][n]) for n, x in a[1].items()) + sum(
        torch.equal(x, b[2][n]) for n, x in a[2].items())
    return a[0] == b[0], same, len(a[1]) + len(a[2])


def _dp_volume():
    from transception_tpu_torch.data.synapse import SyntheticVolumeDataset
    return SyntheticVolumeDataset(length=1, hw=DP_EVAL_HW)


def _dp_test_cli(dp, weights, out, read=True):
    """cli.test.main --dp_size dp at its fp32 default on one synthetic
    volume of DP_EVAL_HW² (--is_savenii): (means, and where `read` the
    per-case and mean log lines and the saved class maps)."""
    import re

    from transception_tpu_torch.cli import test as test_cli
    from transception_tpu_torch.data import synapse
    from transception_tpu_torch.eval.nifti import load_nifti
    real = synapse.make_test_dataset
    synapse.make_test_dataset = lambda cfg: _dp_volume()
    try:
        means = test_cli.main(["--dataset", "synthetic", "--dp_size",
                               str(dp), "--weight_pth", str(weights),
                               "--output_dir", str(out), "--is_savenii"])
        torch.cuda.synchronize()
    finally:
        synapse.make_test_dataset = real
    lines, pred = None, None
    if read:
        lines = re.findall(r"\] (idx .*|Mean class .*|Testing .*)",
                           (out / "test_log" / "eval.txt").read_text())
        pred = load_nifti(str(out / "predictions" /
                              "synthetic_vol_0_pred.nii.gz"))[0]
    return means, lines, pred


def _dp_rank(out_dir, weights):
    """One rank of phase 14's multi-card run (spawned; the group from its
    environment): the DP_MODES steps on its rows, saved for the parent,
    and its share of the test CLI's sharded eval."""
    from transception_tpu_torch.data.device_synthetic import (
        DeviceSyntheticStream,
    )
    from transception_tpu_torch.parallel.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(int(os.environ["WORLD_SIZE"]), device="cuda")
    out = Path(out_dir)
    batch = DeviceSyntheticStream(TRAIN_BATCH, 224, 9,
                                  device=mesh.device).batch(0)
    for label, over, _ in DP_MODES:
        tr = _dp_trainer(over, out / f"r{mesh.rank}", mesh)
        res, ms = _dp_step(tr, batch["image"], batch["label"])
        torch.save(res, out / f"rank{mesh.rank}_{label}.pt")
        if mesh.is_main:
            print(f"  DP {label} world {mesh.world}: {ms:.1f} ms a step "
                  f"(rank 0, {TRAIN_BATCH // mesh.world} rows)", flush=True)
        del tr
        torch.cuda.empty_cache()
    res = _dp_test_cli(mesh.world, weights, out / "cli", mesh.is_main)
    torch.save(res, out / f"rank{mesh.rank}_cli.pt")
    mesh.close()


def dp_phase():
    """Phase 14. Data parallelism (parallel.mesh) on the card: a process
    group over NCCL of torch.cuda.device_count() ranks, forced at one rank
    where the machine has one card. One b=24 step through the data-parallel
    Trainer (DistributedDataParallel, global-batch BatchNorm and Dice) in
    each of DP_MODES against the one-process Trainer's step from the same
    weights on the same batch (loss, every gradient leaf, BatchNorm stats
    within phase 9's limits; launches exactly launches_per_step; whether
    the bits are equal is logged; the ms of a step of each, CUDA events
    over DP_TIME_STEPS more steps); the test CLI's slice-sharded eval
    (with the group up) against --dp_size 1 (means, per-case lines, class
    maps); --dp_size beyond the cards refused before any work. With two
    cards or more, the same steps and eval at world 2 (spawned ranks, a
    card each): rank 0 against the one-process step, rank 1's bits equal
    to rank 0's. Returns the runs' launches per shape key."""
    import shutil

    from transception_tpu_torch.cli import train as train_cli
    from transception_tpu_torch.core.config import TransceptionConfig
    from transception_tpu_torch.data.device_synthetic import (
        DeviceSyntheticStream,
    )
    from transception_tpu_torch.models.transception import (
        MSTransception,
        launches_per_forward,
        launches_per_step,
    )
    from transception_tpu_torch.ops import kernels
    from transception_tpu_torch.parallel.mesh import make_mesh, spawn

    cards = torch.cuda.device_count()
    out = OUT_DIR / "dp"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    batch = DeviceSyntheticStream(TRAIN_BATCH, 224, 9, device="cuda").batch(0)
    img, lbl = batch["image"], batch["label"]
    refs, one_ms = {}, {}
    for label, over, _ in DP_MODES:
        tr = _dp_trainer(over, out / "one")
        refs[label], one_ms[label] = _dp_step(tr, img, lbl)
        del tr
        torch.cuda.empty_cache()
    weights = out / "w.pth"
    torch.save(MSTransception(TransceptionConfig(dtype="float32"), "cuda",
                              seed=0).state_dict(), weights)
    one_cli = _dp_test_cli(1, weights, out / "cli_one")

    runs = []
    mesh = make_mesh(cards, device="cuda", force=True) if cards == 1 \
        else None
    if mesh is not None:
        log(f"  process group: NCCL, world {mesh.world} (forced: "
            f"{cards} card)")
        try:
            for label, over, lim in DP_MODES:
                tr = _dp_trainer(over, out / "dp", mesh)
                want = launches_per_step(tr.model.cfg)
                kernels.reset_launches()
                got, ms = _dp_step(tr, img, lbl)
                counts = kernels.launch_counts()
                runs.append((f"per DP {label} train step",
                             kernels.shape_counts(), 1 + DP_TIME_STEPS))
                want = {k: n * (1 + DP_TIME_STEPS) for k, n in want.items()}
                if counts != want:
                    fail(f"DP {label}: launched {counts}, want {want}")
                n_bn = sum(type(mod).__name__ == "BatchNorm"
                           for mod in tr.model.modules())
                log(f"  DP {label}: {ms:.1f} ms a step, one process "
                    f"{one_ms[label]:.1f} ms (CUDA events over "
                    f"{DP_TIME_STEPS} steps; {n_bn} BatchNorm layers, an "
                    f"all-reduce each forward and backward)")
                eq = _bits_equal(got, refs[label])
                log(f"  DP {label}: launches {counts} = "
                    f"{1 + DP_TIME_STEPS} x launches_per_step; bits equal "
                    f"to one process: loss {eq[0]}, {eq[1]} of {eq[2]} "
                    f"leaves")
                if not _compare_steps(f"DP {label} (world {mesh.world}) vs "
                                      f"one process", got, refs[label],
                                      lim=lim):
                    fail(f"the data-parallel {label} step disagrees with "
                         f"the one-process step")
                del tr
                torch.cuda.empty_cache()
            kernels.reset_launches()
            dp_cli = _dp_test_cli(mesh.world, weights, out / "cli_dp")
            chunks = math.ceil(_dp_volume().get(0)["image"].shape[0] / BATCH)
            counts = kernels.launch_counts()
            runs.append(("per forward, sharded cli.test eval (fp32)",
                         kernels.shape_counts(), chunks))
            want = {k: n * chunks for k, n in launches_per_forward(
                TransceptionConfig(dtype="float32")).items()}
            if counts != want:
                fail(f"sharded cli.test: launched {counts}, want {want}")
        finally:
            mesh.close()
        _same_eval(f"cli.test sharded over world {mesh.world}", dp_cli,
                   one_cli)

    for argv in (["--dp_size", str(cards + 1)],):
        try:
            train_cli.main(argv + ["--output_dir", str(out / "refused")])
        except RuntimeError as e:
            log(f"  cli.train {' '.join(argv)}: refused before any work: "
                f"{e}")
            if f"needs {cards + 1} cards, have {cards}" not in str(e):
                fail(f"--dp_size {cards + 1}: the refusal does not name "
                     f"the counts")
        else:
            fail(f"cli.train --dp_size {cards + 1} did not raise")
        if (out / "refused" / "log.txt").exists():
            fail("the refused run started work")

    if cards < 2:
        log("  a multi-card run was not possible here: one card "
            "(torch.cuda.device_count() == 1); world 2 not run")
        return runs
    for world in sorted({2, cards}):
        t0 = time.perf_counter()
        wdir = out / f"world{world}"
        wdir.mkdir()
        spawn(_dp_rank, world, (str(wdir), str(weights)))
        for label, _, lim in DP_MODES:
            log(f"  one process {label}: {one_ms[label]:.1f} ms a step")
            r0 = torch.load(wdir / f"rank0_{label}.pt", weights_only=False)
            if not _compare_steps(f"DP {label} (world {world}, rank 0) vs "
                                  f"one process", r0, refs[label], lim=lim):
                fail(f"world {world}: the {label} step disagrees with the "
                     f"one-process step")
            for r in range(1, world):
                rr = torch.load(wdir / f"rank{r}_{label}.pt",
                                weights_only=False)
                eq = _bits_equal(rr, r0)
                if not eq[0] or eq[1] != eq[2]:
                    fail(f"world {world} {label}: rank {r} holds other bits "
                         f"than rank 0 ({eq})")
            log(f"  DP {label} world {world}: ranks hold equal bits")
        _same_eval(f"cli.test sharded over world {world}",
                   torch.load(wdir / "rank0_cli.pt", weights_only=False),
                   one_cli)
        log(f"  world {world}: {time.perf_counter() - t0:.1f} s")
    return runs


def _same_eval(what, got, want):
    """The sharded test CLI's means, per-case lines and class maps against
    the one-process run's."""
    (gm, gl, gp), (wm, wl, wp) = got, want
    same = gm == wm and gl == wl and np.array_equal(gp, wp)
    log(f"  {what}: means {gm} vs {wm}; {len(gl)} log lines "
        f"{'equal' if gl == wl else 'DIFFER'}; class maps "
        f"{'equal' if np.array_equal(gp, wp) else 'DIFFER'}")
    if not same:
        fail(f"{what} disagrees with --dp_size 1")


# ---- phase 15: the legacy model family ----

LEGACY_STEP_ITERS = 2  # train steps timed (CUDA events) after one
# The legacy models whose bf16 train step, between two plain paths that
# differ only in the fp32 summation order of K6's context (the plain
# version, and the same with the context summed over two halves of N:
# _k6_context_in_halves), already differs by more than BF16_LIMITS allow
# (on an H100: ResInception by 0.77% of the gradients' norm with its
# stage-2 conv3x3 weight at 1.9x its leaf limit, '135' by 1.05% with a
# leaf at 1.2x; the train-mode BatchNorm of the MultiRes branches
# amplifies a bf16 rounding's flip). Their bf16 kernel step is held to the
# fp32 reference (_trails_reference) and their fp32 kernel step to the
# fp32 plain step within FP32_LIMITS; the bf16 kernel-vs-plain comparison
# and that noise floor are logged.
NOISY_STEPS = ("resinception", "resinception_135")


def _trails_reference(tag, k, p, r, lim=BF16_LIMITS):
    """Kernel step k and plain step p (bf16) against the fp32 plain step
    r from the same weights on the same batch: the kernel's distance from
    r exceeds the plain step's by at most `lim` (loss by lim['loss'] of
    r's; all leaves by lim['glob'] of |g_r|; each leaf by lim['leaf'] of
    its |g_r| plus lim['leaf_abs'] of |g_r|; BN stats by lim['bn'] of
    their max plus 1e-4), and no leaf is zero on the kernel path alone.
    Returns whether all hold."""
    (lk, gk, bk), (lp, gp, bp), (lr, gr, br) = k, p, r

    def dist(g):
        return math.sqrt(sum(float((g[n] - t).square().sum())
                             for n, t in gr.items()))

    G = math.sqrt(sum(float(t.square().sum()) for t in gr.values()))
    ek, ep = dist(gk), dist(gp)
    worst, worst_n, cut = 0.0, "", []
    for n, t in gr.items():
        extra = float((gk[n] - t).norm()) - float((gp[n] - t).norm())
        q = extra / (lim["leaf"] * float(t.norm()) + lim["leaf_abs"] * G)
        if q > worst:
            worst, worst_n = q, n
        if float(gp[n].abs().max()) > 0 and float(gk[n].abs().max()) == 0:
            cut.append(n)
    bn = max(((float((bk[n] - t).abs().max())
               - float((bp[n] - t).abs().max()))
              / (lim["bn"] * float(t.abs().max()) + 1e-4)
              for n, t in br.items()), default=0.0)
    loss_ok = abs(lk - lr) <= abs(lp - lr) + lim["loss"] * abs(lr)
    ok = loss_ok and ek <= ep + lim["glob"] * G and worst <= 1.0 and \
        not cut and bn <= 1.0
    log(f"  {tag}, against the fp32 plain step: loss kernel {lk:.8f} plain "
        f"{lp:.8f} fp32 {lr:.8f}; gradients |g - g_fp32|/|g_fp32| kernel "
        f"{ek / G:.5f} plain {ep / G:.5f} (kernel may trail by "
        f"{lim['glob']}); worst leaf's excess at {worst:.3f} of its limit "
        f"({worst_n}); {len(cut)} leaves zero on the kernel path only; BN "
        f"stats' excess at {bn:.3f} of their limit "
        f"{'ok' if ok else 'FAIL'}")
    return ok


@contextlib.contextmanager
def _k6_context_in_halves():
    """Inside: K6's plain version with the context Ksᵀ·V summed in fp32
    over the two halves of N, then added (another summation order, the
    same rounding points): the plain path's own bf16 noise floor."""
    from transception_tpu_torch.ops.kernels import linear_attention as la
    real = la.linear_attention_plain

    def halves(q, k, v, q_softmax=False, scale=1.0):
        dt, n = v.dtype, k.shape[2] // 2
        ks = torch.softmax(k.float(), dim=2).to(dt).float()
        vf = v.float()
        ctx = (torch.matmul(ks[..., :n, :].transpose(-1, -2), vf[..., :n, :])
               + torch.matmul(ks[..., n:, :].transpose(-1, -2),
                              vf[..., n:, :])).to(dt)
        qu = torch.softmax(q.float(), dim=3).to(dt) if q_softmax else q
        return (torch.matmul(qu.float(), ctx.float()) * scale).to(dt)

    la.linear_attention_plain = halves
    try:
        yield
    finally:
        la.linear_attention_plain = real


def _legacy_step_ms(model, img, lbl):
    """ms a train step of legacy `model` on one batch (CUDA events)."""
    from transception_tpu_torch.core.config import TrainConfig
    from transception_tpu_torch.train.state import TrainState
    from transception_tpu_torch.train.trainer import make_train_step
    st = TrainState(model, TrainConfig(), 2211 // TRAIN_BATCH)
    fn = make_train_step(st, 9, 0.4, 0.6)
    return cuda_ms(lambda: fn(img, lbl), iters=LEGACY_STEP_ITERS, warmup=1)


def legacy_phase():
    """Phase 15. The legacy models of the registry (models/legacy.py) at
    full width (224², widths 64/128/320/512, TransceptionConfig()'s
    head_count 8 and dilated schedules, random weights from seed 0): each
    through make_predictor(...).predict_volume on BATCH slices of 512² at
    bf16 and at fp32 (launches exactly legacy.launches_per_forward, the
    kernel path against use_kernels=False within phase 13's limits,
    forward time), one bf16 train step at TRAIN_BATCH on the kernels and
    on the plain path and one fp32 plain step from the same weights
    (launches exactly legacy.launches_per_step): the kernel step trails
    the plain step against the fp32 one by at most BF16_LIMITS
    (_trails_reference), and, but for NOISY_STEPS, matches the plain step
    within BF16_LIMITS; MISSFormer's and NOISY_STEPS' fp32 kernel step
    against the fp32 plain step within FP32_LIMITS; step times. Then
    cli.test.main --model missformer at its fp32 default on one small
    synthetic volume, and cli.train.main --model resinception for
    CLI_STEPS steps, its checkpoint's BatchNorm statistics against the
    trained model's and a fresh model's restored from it, and a second
    call that resumes from it for one more step. Returns the runs'
    launches per shape key."""
    import dataclasses
    import tempfile

    from transception_tpu_torch.cli import test as test_cli
    from transception_tpu_torch.cli import train as train_cli
    from transception_tpu_torch.core.config import (
        TrainConfig,
        TransceptionConfig,
    )
    from transception_tpu_torch.data import synapse
    from transception_tpu_torch.data.device_synthetic import (
        DeviceSyntheticStream,
    )
    from transception_tpu_torch.eval.inference import (
        make_predictor,
        resize_slices,
    )
    from transception_tpu_torch.models import legacy
    from transception_tpu_torch.models.registry import create_model
    from transception_tpu_torch.ops import kernels
    from transception_tpu_torch.train.state import TrainState

    def short(counts):
        return {k: n for k, n in counts.items() if n}

    runs = []
    card = gpu_line()
    vol = np.random.default_rng(15).random((BATCH, 512, 512),
                                           dtype=np.float32)
    x = torch.from_numpy((resize_slices(vol, 224) - 0.5) / 0.5).cuda()[
        ..., None]
    batch = DeviceSyntheticStream(TRAIN_BATCH, 224, 9, device="cuda").batch(1)
    img, lbl = batch["image"], batch["label"]
    for name in LEGACY_NAMES:
        t0 = time.perf_counter()
        times = []
        for dtype in ("bfloat16", "float32"):
            cfg = TransceptionConfig(dtype=dtype)
            model = create_model(name, cfg, "cuda", seed=0)
            predict = make_predictor(model, cfg.img_size, BATCH)
            predict.predict_volume(vol)  # warm-up
            torch.cuda.synchronize()
            kernels.reset_launches()
            pred = predict.predict_volume(vol)
            torch.cuda.synchronize()
            counts = kernels.launch_counts()
            runs.append((f"per forward, {name} {dtype}",
                         kernels.shape_counts(), 1))
            log(f"  {name} {dtype}: predict_volume {pred.shape} "
                f"{pred.dtype}, launches {short(counts)}")
            if pred.shape != (BATCH, 224, 224) or pred.dtype != np.uint8:
                fail(f"{name} {dtype}: predict_volume output {pred.shape}")
            want = legacy.launches_per_forward(name, cfg)
            if counts != want:
                fail(f"{name} {dtype}: launches {counts}, want {want}")
            times.append(_paths_agree(
                f"{name} {dtype}", model, x, dtype == "float32",
                lambda c: create_model(name, c, "cuda")))
            del model, predict
            torch.cuda.empty_cache()
        # One b=24 step: bf16 on the kernels, on the plain path and, the
        # reference, fp32 on the plain path; fp32 on the kernels for
        # MISSFormer and the models of NOISY_STEPS.
        cfg = TransceptionConfig()
        sd0 = {k: t.clone() for k, t in create_model(
            name, cfg, "cuda", seed=0).state_dict().items()}
        steps = {}
        fp32_kernels = name in NOISY_STEPS + ("missformer",)
        for tag, over in (("bf16 kernels", {}),
                          ("bf16 plain", dict(use_kernels=False)),
                          ("fp32 plain", dict(use_kernels=False,
                                              dtype="float32")),
                          ("fp32 kernels", dict(dtype="float32"))):
            if tag == "fp32 kernels" and not fp32_kernels:
                continue
            c = dataclasses.replace(cfg, **over)
            model = create_model(name, c, "cuda")
            kernels.reset_launches()
            steps[tag] = _one_step(model, sd0, img, lbl, wide_head=False)
            counts = kernels.launch_counts()
            if c.use_kernels:
                runs.append((f"per {name} {c.dtype} train step",
                             kernels.shape_counts(), 1))
            want = legacy.launches_per_step(name, c)
            if counts != want:
                fail(f"{name} {tag} train step: launches {counts}, want "
                     f"{want}")
            if tag != "fp32 plain" or fp32_kernels:
                steps[tag + " ms"] = _legacy_step_ms(model, img, lbl)
            del model
            torch.cuda.empty_cache()
        k, p, r = (steps[t] for t in ("bf16 kernels", "bf16 plain",
                                      "fp32 plain"))
        what = f"{name} bf16 train step b={TRAIN_BATCH}, launches " \
               f"{short(legacy.launches_per_step(name, cfg))}"
        ok = _trails_reference(what, k, p, r)
        if name in NOISY_STEPS:
            _compare_steps(what + " (BF16_LIMITS below this model's bf16 "
                           "noise floor)", k, p, ref=r, held=False)
            with _k6_context_in_halves():
                m2 = create_model(name, dataclasses.replace(
                    cfg, use_kernels=False), "cuda")
                p2 = _one_step(m2, sd0, img, lbl, wide_head=False)
            del m2
            _compare_steps(f"{name} noise floor: the plain step with K6's "
                           f"context summed over two halves of N vs the "
                           f"plain step", p2, p, held=False)
        else:
            ok = _compare_steps(what, k, p, ref=r) and ok
        if "fp32 kernels" in steps:
            ok = _compare_steps(f"{name} fp32 train step b={TRAIN_BATCH}",
                                steps["fp32 kernels"], r,
                                lim=FP32_LIMITS) and ok
        if not ok:
            fail(f"{name}: the kernel train step disagrees with the plain "
                 f"path")
        fp32_ms = (f"; fp32 kernels {steps['fp32 kernels ms']:.3f} plain "
                   f"{steps['fp32 plain ms']:.3f}"
                   if "fp32 kernels" in steps else "")
        (fb, fbp), (ff, ffp) = times
        log(f"  {name}: forward b={BATCH} ms, CUDA events: bf16 kernels "
            f"{fb:.3f} plain {fbp:.3f}; fp32 kernels {ff:.3f} plain "
            f"{ffp:.3f}; train step b={TRAIN_BATCH} ms: bf16 kernels "
            f"{steps['bf16 kernels ms']:.3f} plain "
            f"{steps['bf16 plain ms']:.3f}{fp32_ms} ({card}; "
            f"{time.perf_counter() - t0:.1f} s)")
        del steps, k, p, r, sd0
        torch.cuda.empty_cache()

    small = synapse.SyntheticVolumeDataset(length=1, hw=VARIANT_EVAL_HW)
    chunks = math.ceil(small.get(0)["image"].shape[0] / BATCH)
    real_ds = synapse.make_test_dataset
    with tempfile.TemporaryDirectory(
            dir=Path(__file__).resolve().parent) as tmp:
        # The test CLI with --model missformer at its fp32 default.
        t0 = time.perf_counter()
        mf_cfg = TransceptionConfig(dtype="float32")
        model = create_model("missformer", mf_cfg, "cuda", seed=0)
        torch.save(model.state_dict(), f"{tmp}/missformer.pth")
        del model
        synapse.make_test_dataset = lambda cfg: small
        try:
            kernels.reset_launches()
            means = test_cli.main(["--dataset", "synthetic", "--model",
                                   "missformer", "--weight_pth",
                                   f"{tmp}/missformer.pth", "--output_dir",
                                   f"{tmp}/missformer"])
            torch.cuda.synchronize()
        finally:
            synapse.make_test_dataset = real_ds
        counts, tallies = kernels.launch_counts(), kernels.shape_counts()
        runs.append(("per forward, cli.test --model missformer (fp32)",
                     tallies, chunks))
        want = {k: n * chunks for k, n in
                legacy.launches_per_forward("missformer", mf_cfg).items()}
        log(f"  cli.test --model missformer (fp32 default): means {means}; "
            f"launches {short(counts)} over {chunks} chunks "
            f"({time.perf_counter() - t0:.1f} s)")
        if counts != want or \
                any(key[-1] != "fp32" for key in tallies) or \
                not all(math.isfinite(v) for v in means):
            fail("cli.test --model missformer: launches not "
                 "launches_per_forward, a launch not fp32, or non-finite "
                 "means")

        # The train CLI with --model resinception, then a resume.
        res = TransceptionConfig()
        out = Path(tmp) / "resinception"
        argv = ["--model", "resinception", "--dataset", "synthetic",
                "--device_data", "--dp_size", "1", "--output_dir", str(out)]
        for steps in (CLI_STEPS, CLI_STEPS + 1):
            t0 = time.perf_counter()
            with trainer_evals(small) as ev:
                kernels.reset_launches()
                st, hist = train_cli.main(argv + ["--max_steps", str(steps)])
                torch.cuda.synchronize()
                counts, tallies = kernels.launch_counts(), \
                    kernels.shape_counts()
            text = (out / "log.txt").read_text()
            losses = _logged_losses(text)
            ran = steps - (CLI_STEPS if steps > CLI_STEPS else 0)
            log(f"  cli.train --model resinception --max_steps {steps}: "
                f"step {st.step}, eval {hist}, launches {short(counts)} "
                f"({time.perf_counter() - t0:.1f} s)")
            if type(st.model).__name__ != "ResInceptionTransception" or \
                    st.step != steps or not losses or not np.isfinite(
                        losses + hist["dice"] + hist["hd95"]).all() or \
                    ev["evals"] != 1:
                fail(f"cli.train resinception: step {st.step}, losses "
                     f"{losses}, {hist}")
            held_run(f"cli.train resinception to step {steps}", counts, ev,
                     ran, legacy.launches_per_step("resinception", res),
                     legacy.launches_per_forward("resinception", res))
            runs.append((f"per resinception train CLI step (to {steps})",
                         Counter(tallies) - ev["tallies"], ran))
            runs.append((f"per forward, resinception train CLI eval (to "
                         f"{steps})", ev["tallies"], ev["chunks"]))
            if steps == CLI_STEPS:
                # BatchNorm statistics: the checkpoint's are the trained
                # model's, bit for bit, moved from their init, and a
                # fresh model restored from it holds them.
                ckpt = sorted((out / "ckpt").glob("step_*.pt"))[-1]
                bn = {k: t for k, t in st.model.state_dict().items()
                      if "running_" in k}
                fresh = create_model("resinception", res, "cuda", seed=5)
                TrainState(fresh, TrainConfig(), 1).load_state_dict(
                    torch.load(ckpt, map_location="cuda",
                               weights_only=True))
                back = fresh.state_dict()
                moved = sum(not torch.equal(t, torch.zeros_like(t)) and
                            not torch.equal(t, torch.ones_like(t))
                            for t in bn.values())
                same = all(torch.equal(back[k], t) for k, t in bn.items())
                log(f"  resinception checkpoint {ckpt.name}: {len(bn)} "
                    f"BatchNorm statistics, {moved} moved from their init, "
                    f"restored bit for bit: {same}")
                if not bn or moved != len(bn) or not same:
                    fail("resinception's BatchNorm statistics did not "
                         "round-trip through the checkpoint")
                del fresh, back
            elif f"resumed from {out / 'ckpt'}" not in text:
                fail("cli.train resinception did not resume from its "
                     "checkpoint")
            del st
            torch.cuda.empty_cache()
    return runs


# ---- phases 16-19: ISIC 2018, the serving export, remat, profiling ----

ISIC_IMAGES = 32      # synthetic lesions a dice_eval: one batch of BATCH
ISIC_AGREE = 0.99     # bf16 per-image masks, kernels against the plain path
ISIC_NPZ = 8          # preprocessed images written for the run (256², RGB)


def _isic_eval(model, ds, out_dir):
    """dice_eval of `model` over `ds` in batches of BATCH, its masks saved
    under out_dir (.npy where the machine has no PIL): (mean dice, {case:
    mask}, launches, shape tallies, its log lines)."""
    import shutil

    from transception_tpu_torch.data.isic import dice_eval
    from transception_tpu_torch.ops import kernels
    shutil.rmtree(out_dir, ignore_errors=True)
    lines = []
    kernels.reset_launches()
    d = dice_eval(model, ds, model.cfg.img_size, batch=BATCH,
                  log=lines.append, save_path=str(out_dir), device="cuda")
    torch.cuda.synchronize()
    counts, tallies = kernels.launch_counts(), kernels.shape_counts()
    masks = {}
    for p in sorted(out_dir.iterdir()):
        if p.suffix == ".npy":
            masks[p.stem] = np.load(p) > 0
        elif p.suffix == ".png":
            from PIL import Image
            masks[p.stem] = np.asarray(Image.open(p)) > 127
    return d, masks, counts, tallies, lines


def _isic_ties(plain, ds, lines, mk, mp, name):
    """fp32 masks that differ between the kernel and plain paths: each
    differing pixel must be a near-tie, its two logits on the plain path
    within FP32_LOGITS_TOL x max|logit| (the fp32 forward's logits limit,
    phase 5), where the paths' fp32 sums in another order may pick either
    class. Logs the pixels and their margins."""
    cases = [ln.split()[1] for ln in lines if ln.startswith("case ")]
    worst, top = 0.0, 0.0
    for i, case in enumerate(cases):
        bad = mk[f"{case}_pred"] != mp[f"{case}_pred"]
        if not bad.any():
            continue
        x = torch.from_numpy(ds.get(i, np.random.default_rng(0))["image"])
        with torch.inference_mode():
            logits = plain(x[None].cuda())[0].float().cpu()
        margin = (logits[..., 1] - logits[..., 0]).abs()[
            torch.from_numpy(bad)]
        worst = max(worst, float(margin.max()))
        top = max(top, float(logits.abs().max()))
    log(f"  isic fp32 {name}: the differing pixels' logit margins on the "
        f"plain path up to {worst:.3g}, max|logit| {top:.3g} (limit "
        f"{FP32_LOGITS_TOL} x max)")
    if worst > FP32_LOGITS_TOL * top:
        fail(f"isic fp32 {name}: a pixel differs beyond a near-tie "
             f"(margin {worst:.3g})")


def _held_forwards(what, counts, cfg, n_fwd, argmax=False):
    from transception_tpu_torch.models.transception import (
        launches_per_forward,
    )
    for name, per in launches_per_forward(cfg, argmax=argmax).items():
        if counts[name] != per * n_fwd:
            fail(f"{what}: {name} launched {counts[name]} times, want "
                 f"{per} x {n_fwd} (launches_per_forward)")


def isic_phase():
    """Phase 16: ISIC 2018 (data/isic.py) on the published model at 224²
    with 2 classes. dice_eval at b=32 over SyntheticISICDataset and over a
    preprocessed .npz written for the run, bf16 and fp32, the kernels
    against use_kernels=False on the same weights: per-image masks agree on
    >= ISIC_AGREE of the pixels at bf16, and at fp32 on every pixel but
    near-ties (_isic_ties; differing pixels counted), the mean-dice gap
    logged, launches exactly
    launches_per_forward(argmax=False) a batch; one b=24 train step on an
    ISIC batch of the Trainer's loader (dataset="isic": augmented
    3-channel lesions) at bf16 and at fp32 against the plain step within
    BF16_LIMITS / FP32_LIMITS, launches exactly launches_per_step; the test
    CLI with --dataset ISIC (bf16, --is_savenii: a mask per case)."""
    import dataclasses
    import shutil

    from transception_tpu_torch.cli import test as test_cli
    from transception_tpu_torch.core.config import (
        DataConfig,
        TransceptionConfig,
    )
    from transception_tpu_torch.core.device import fp32_exact
    from transception_tpu_torch.data.isic import SyntheticISICDataset
    from transception_tpu_torch.data.loader import HostDataLoader, to_device
    from transception_tpu_torch.data.synapse import (
        make_test_dataset,
        make_train_dataset,
    )
    from transception_tpu_torch.models.transception import (
        MSTransception,
        launches_per_step,
    )
    from transception_tpu_torch.ops import kernels

    out = OUT_DIR / "isic"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    rng = np.random.default_rng(0)
    npz = out / "isic_test.npz"
    np.savez(npz, image=rng.random((ISIC_NPZ, 256, 256, 3),
                                   dtype=np.float32),
             label=(rng.random((ISIC_NPZ, 256, 256)) > 0.5).astype(
                 np.float32))
    absent = str(out / "absent")
    sets = {"synthetic": SyntheticISICDataset(length=ISIC_IMAGES,
                                              img_size=224),
            "npz": make_test_dataset(DataConfig(
                dataset="isic", test_path=str(npz), img_size=224,
                num_classes=2))}
    if type(sets["npz"]).__name__ != "ISICPreprocessedDataset":
        fail(f"make_test_dataset picked {type(sets['npz']).__name__} for "
             f"an .npz")
    runs = []
    for dtype in ("bfloat16", "float32"):
        cfg = pinned(TransceptionConfig(num_classes=2, dtype=dtype))
        with fp32_exact(dtype == "float32"):
            model = MSTransception(cfg, "cuda", seed=0)
            plain = MSTransception(dataclasses.replace(cfg,
                                                       use_kernels=False),
                                   "cuda", seed=0)
            plain.load_state_dict(model.state_dict())
            for name, ds in sets.items():
                t0 = time.perf_counter()
                dk, mk, ck, tk, lines = _isic_eval(
                    model, ds, out / f"{dtype}_{name}_kernels")
                secs = time.perf_counter() - t0
                dp, mp, cp, _, _ = _isic_eval(
                    plain, ds, out / f"{dtype}_{name}_plain")
                n_fwd = math.ceil(len(ds) / BATCH)
                _held_forwards(f"isic {dtype} {name}", ck, cfg, n_fwd)
                if any(cp.values()):
                    fail(f"isic {dtype} {name}: the plain path launched "
                         f"{cp}")
                if len(mk) != len(ds) or set(mk) != set(mp):
                    fail(f"isic {dtype} {name}: {len(mk)} masks saved for "
                         f"{len(ds)} images")
                agree = [float((mk[c] == mp[c]).mean()) for c in mk]
                differ = sum(int((mk[c] != mp[c]).sum()) for c in mk)
                per_case = sum(ln.startswith("case ") for ln in lines)
                log(f"  isic {dtype} {name}: {len(mk)} images, mean dice "
                    f"kernels {dk:.6f} plain {dp:.6f} (gap "
                    f"{abs(dk - dp):.3g}); masks agree {min(agree):.6f} "
                    f"worst image, {differ} pixels differ in all; "
                    f"{per_case} case lines; {secs:.2f} s")
                if per_case != len(ds) or not np.isfinite(dk):
                    fail(f"isic {dtype} {name}: {per_case} case lines, "
                         f"dice {dk}")
                if dtype == "bfloat16" and min(agree) < ISIC_AGREE:
                    fail(f"isic bf16 {name}: an image's masks agree on "
                         f"{min(agree):.4f} < {ISIC_AGREE}")
                if dtype == "float32" and differ:
                    _isic_ties(plain, ds, lines, mk, mp, name)
                runs.append((f"per forward, isic {dtype} {name}", tk,
                             n_fwd))
            del model, plain
            torch.cuda.empty_cache()

    # One b=24 train step on an ISIC batch, kernels against plain.
    dc = DataConfig(dataset="isic", root_path=absent, img_size=224,
                    num_classes=2)
    train_ds = make_train_dataset(dc)
    batch = next(iter(HostDataLoader(train_ds, TRAIN_BATCH, seed=1234,
                                     num_workers=8)))
    img, lbl = to_device(batch, torch.device("cuda"))
    if tuple(img.shape) != (TRAIN_BATCH, 224, 224, 3) or \
            int(lbl.max()) > 1:
        fail(f"isic train batch {tuple(img.shape)}, labels up to "
             f"{int(lbl.max())}")
    for dtype, lim in (("bfloat16", BF16_LIMITS), ("float32", FP32_LIMITS)):
        cfg = TransceptionConfig(num_classes=2, dtype=dtype)
        with fp32_exact(dtype == "float32"):
            k = MSTransception(cfg, "cuda", seed=0)
            p = MSTransception(dataclasses.replace(cfg, use_kernels=False),
                               "cuda", seed=0)
            sd0 = {n: t.clone() for n, t in k.state_dict().items()}
            kernels.reset_launches()
            sk = _one_step(k, sd0, img, lbl, classes=2)
            counts, tallies = kernels.launch_counts(), kernels.shape_counts()
            want = launches_per_step(cfg)
            if counts != want:
                fail(f"isic {dtype} step: launches {counts}, want {want}")
            sp = _one_step(p, sd0, img, lbl, classes=2)
            if not _compare_steps(f"isic {dtype} step b={TRAIN_BATCH}", sk,
                                  sp, lim=lim):
                fail(f"isic {dtype} step: kernels against plain beyond "
                     f"the limits")
            runs.append((f"per isic {dtype} train step", tallies, 1))
            del k, p, sd0
            torch.cuda.empty_cache()

    # The test CLI with --dataset ISIC (no data at --test_path: the 256
    # synthetic lesions), bf16, masks saved.
    cfg = TransceptionConfig(num_classes=2)
    pth = out / "isic.pth"
    torch.save(MSTransception(cfg, "cuda", seed=0).state_dict(), pth)
    kernels.reset_launches()
    t0 = time.perf_counter()
    dice, hd95 = test_cli.main([
        "--dataset", "ISIC", "--weight_pth", str(pth), "--test_path", absent,
        "--dtype", "bfloat16", "--eval_batch", str(BATCH), "--is_savenii",
        "--output_dir", str(out / "cli")])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts, tallies = kernels.launch_counts(), kernels.shape_counts()
    saved = list((out / "cli" / "predictions").iterdir())
    text = (out / "cli" / "test_log" / "eval.txt").read_text()
    n_fwd = math.ceil(256 / BATCH)
    log(f"  cli.test --dataset ISIC: mean dice {dice:.6f}, hd95 {hd95}, "
        f"{len(saved)} masks saved, {secs:.2f} s")
    if hd95 != 0.0 or not np.isfinite(dice) or len(saved) != 256 or \
            "over 256 images" not in text:
        fail("cli.test --dataset ISIC: wrong result or log")
    _held_forwards("cli.test --dataset ISIC", counts, cfg, n_fwd)
    runs.append(("per forward, cli.test ISIC", tallies, n_fwd))
    return runs


# A fresh process that loads an exported artifact and runs it on a saved
# input: it imports the kernels' registration (load_exported), never the
# models; prints the launches of one call and what it imported.
EXPORT_LOADER = """
import json, sys
import numpy as np
import torch
flags = json.loads(sys.argv[4])
torch.backends.cuda.matmul.allow_tf32 = flags["matmul_tf32"]
torch.backends.cudnn.allow_tf32 = flags["cudnn_tf32"]
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \\
    flags["bf16_reduction"]
from transception_tpu_torch.ops import kernels
from transception_tpu_torch.serve.export import load_exported
fn = load_exported(sys.argv[1])
x = np.load(sys.argv[2])
fn(x)
if fn.device.type == "cuda":
    torch.cuda.synchronize()
kernels.reset_launches()
out = fn(x)
if fn.device.type == "cuda":
    torch.cuda.synchronize()
np.save(sys.argv[3], out.float().cpu().numpy())
print(json.dumps({"models": "transception_tpu_torch.models" in sys.modules,
                  "jax": "jax" in sys.modules, "device": str(fn.device),
                  "cuda": torch.cuda.is_available(),
                  "launches": kernels.launch_counts()}))
"""


# The loader processes started, each stopped when phase 17 ends.
_LOADERS = []


def _load_exported_elsewhere(artifact, x_path, out_path, cpu=False):
    """Start a fresh process (EXPORT_LOADER) that runs `artifact` on the
    input saved at x_path into out_path, on the card or, with `cpu`,
    where no card is visible; _loaded collects it."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    if cpu:
        env["CUDA_VISIBLE_DEVICES"] = ""
    # This process's numerics switches (TF32, bf16 reductions), so that
    # the loaded program runs with the eager forward's.
    flags = json.dumps({
        "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_tf32": torch.backends.cudnn.allow_tf32,
        "bf16_reduction": torch.backends.cuda.matmul
        .allow_bf16_reduced_precision_reduction})
    proc = subprocess.Popen([sys.executable, "-c", EXPORT_LOADER,
                             str(artifact), str(x_path), str(out_path),
                             flags], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    _LOADERS.append(proc)
    return proc, artifact, out_path, time.perf_counter()


def _loaded(started):
    """The result of a loader that _load_exported_elsewhere started:
    (what it printed, its output, seconds from its start to its end)."""
    proc, artifact, out_path, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"loading {artifact} in a fresh process: no end in 600 s")
    secs = time.perf_counter() - t0
    if proc.returncode:
        fail(f"loading {artifact} in a fresh process: {stderr[-3000:]}")
    info = json.loads(stdout.strip().splitlines()[-1])
    return info, np.load(out_path), secs


# The CPU leg of phase 17 at the published widths, one block a stage.
CPU_EXPORT_DEPTH = dict(stage1_layers=1, num_layers=(1, 1, 1),
                        num_path=(1, 1, 1))


def export_phase():
    """Phase 17: the serving export (serve/export.py, cli/export.py).
    cli.export on the published model (weights from a .pth) at
    --export_batch 32, bf16, for the card: the program's kernel operators;
    loaded in a fresh process that never imports the models, its logits
    against the eager forward's (bit for bit, or within two eager runs'
    own spread) and its launches against launches_per_forward(argmax=
    False); --plain_xla --platforms cpu at fp32 (batch 2, the published
    widths at CPU_EXPORT_DEPTH), loaded in a process that sees no card,
    against the eager CPU forward (1e-5 of max|logit|)."""
    import shutil

    from transception_tpu_torch.cli import export as export_cli
    from transception_tpu_torch.core.config import TransceptionConfig
    from transception_tpu_torch.models.transception import (
        MSTransception,
        launches_per_forward,
    )
    from transception_tpu_torch.ops import kernels
    from transception_tpu_torch.serve.export import load_exported

    out = OUT_DIR / "export"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    cfg = TransceptionConfig()
    model = MSTransception(cfg, "cuda", seed=0)
    pth = out / "w.pth"
    torch.save(model.state_dict(), pth)
    t0 = time.perf_counter()
    art = export_cli.main(["--weight_pth", str(pth), "--out",
                           str(out / "model.pt2"), "--export_batch",
                           str(BATCH)])
    export_s = time.perf_counter() - t0
    fn = load_exported(art)
    ops = Counter(str(n.target).split(".")[1]
                  for n in fn.program.graph.nodes
                  if n.op == "call_function"
                  and str(n.target).startswith(kernels.NAMESPACE))
    per = {k: n for k, n in launches_per_forward(cfg, argmax=False).items()
           if n}
    log(f"  cli.export b={BATCH} bf16: {os.path.getsize(art)} bytes in "
        f"{export_s:.1f} s; kernel operators in the program {dict(ops)}")
    if dict(ops) != per:
        fail(f"export: the program calls {dict(ops)}, the eager forward "
             f"launches {per}")
    del fn
    x = np.random.default_rng(3).random((BATCH, 224, 224, 1),
                                        dtype=np.float32)
    np.save(out / "x.npy", x)
    xt = torch.from_numpy(x).cuda()
    # Under no_grad, as the program was traced and as it runs.
    with torch.no_grad():
        e1 = model(xt).float().cpu().numpy()
        e2 = model(xt).float().cpu().numpy()
    spread = float(np.abs(e1 - e2).max())
    # The card's loader runs while this process exports the CPU leg and
    # starts its loader (the loaders' seconds include that overlap).
    on_card = _load_exported_elsewhere(art, out / "x.npy", out / "y.npy")
    try:
        cpu_model = _export_legs(on_card, export_cli, out, x, e1, spread,
                                 cfg)
    finally:
        for proc in _LOADERS:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    del model, cpu_model
    torch.cuda.empty_cache()


def _export_legs(on_card, export_cli, out, x, e1, spread, cfg):
    """Phase 17 after the card's export: the --plain_xla CPU leg exported
    and its loader started, then both loaders' results held. Returns the
    CPU leg's model."""
    from transception_tpu_torch.core.config import TransceptionConfig
    from transception_tpu_torch.models.transception import (
        MSTransception,
        launches_per_forward,
    )
    # --plain_xla for the CPU, loaded where no card is visible: the
    # published widths at one block a stage (CPU_EXPORT_DEPTH; the full
    # depth took ~115 s of the host's time to trace and run).
    x2 = x[:2]
    np.save(out / "x2.npy", x2)
    cpu_model = MSTransception(TransceptionConfig(
        dtype="float32", **CPU_EXPORT_DEPTH), "cpu")
    small_pth = out / "w_small.pth"
    torch.save(cpu_model.state_dict(), small_pth)
    depth = ["--stage1_layers", str(CPU_EXPORT_DEPTH["stage1_layers"])] + [
        a for k in ("num_layers", "num_path") for a in (
            f"--{k}", ",".join(map(str, CPU_EXPORT_DEPTH[k])))]
    t0 = time.perf_counter()
    plain_art = export_cli.main([
        "--weight_pth", str(small_pth), "--out", str(out / "plain.pt2"),
        "--export_batch", "2", "--plain_xla", "--platforms", "cpu",
        "--dtype", "float32", *depth])
    plain_s = time.perf_counter() - t0
    on_cpu = _load_exported_elsewhere(plain_art, out / "x2.npy",
                                      out / "y2.npy", cpu=True)
    info, got, secs = _loaded(on_card)
    d = float(np.abs(got - e1).max())
    log(f"  loaded in a fresh process ({secs:.1f} s): models imported "
        f"{info['models']}, jax {info['jax']}, device {info['device']}; "
        f"max|exported - eager| {d:.3g} (two eager runs {spread:.3g}); "
        f"launches {info['launches']}")
    if info["models"] or info["jax"] or info["device"] != "cuda:0":
        fail(f"export: the loading process imported the models or ran "
             f"elsewhere: {info}")
    if d > spread:
        fail(f"export: exported logits {d:.3g} from the eager forward's, "
             f"beyond two eager runs' spread {spread:.3g}")
    want = launches_per_forward(cfg, argmax=False)
    if info["launches"] != want:
        fail(f"export: the loaded program launched {info['launches']}, "
             f"want {want}")
    info, got, secs = _loaded(on_cpu)
    with torch.no_grad():
        want_cpu = cpu_model(torch.from_numpy(x2)).numpy()
    d = float(np.abs(got - want_cpu).max())
    top = float(np.abs(want_cpu).max())
    log(f"  --plain_xla --platforms cpu: exported in {plain_s:.1f} s, run "
        f"in a process with no card ({secs:.1f} s, cuda visible "
        f"{info['cuda']}): max|exported - eager CPU| {d:.3g} of max "
        f"{top:.3g}, launches {sum(info['launches'].values())}")
    if info["cuda"] or info["device"] != "cpu" or d > 1e-5 * top or \
            any(info["launches"].values()):
        fail("export --plain_xla on the CPU: wrong device, launches or "
             "logits")
    return cpu_model


REMAT_STEPS = 2


def _remat_run(cfg, img, lbl):
    """REMAT_STEPS "pallas" steps of a fresh model of `cfg` (drop-path
    generator DROP_SEED): losses, the last gradients, parameters and
    buffers, the generator's state, launches and shape tallies, peak
    memory of the steps (bytes)."""
    from transception_tpu_torch.core.config import TrainConfig
    from transception_tpu_torch.models.transception import MSTransception
    from transception_tpu_torch.ops import kernels
    from transception_tpu_torch.train.state import TrainState
    from transception_tpu_torch.train.trainer import make_train_step
    m = MSTransception(cfg, "cuda", seed=0)
    gen = _gen(DROP_SEED)
    st = TrainState(m, TrainConfig(), 2211 // TRAIN_BATCH, gen)
    step = make_train_step(st, 9, 0.4, 0.6, wide_head=True, gen=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    losses = [float(step(img, lbl)["loss"]) for _ in range(REMAT_STEPS)]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    res = dict(losses=losses,
               grads={n: p.grad.float().cpu()
                      for n, p in m.named_parameters()},
               params={n: p.detach().float().cpu()
                       for n, p in m.named_parameters()},
               bn={n: b.float().cpu() for n, b in m.named_buffers()},
               gen=gen.get_state(), counts=kernels.launch_counts(),
               tallies=kernels.shape_counts(), peak=peak, secs=secs)
    del m, st, step
    torch.cuda.empty_cache()
    return res


def _max_diff(a, b):
    return max(float((a[n] - t).abs().max()) for n, t in b.items())


def remat_phase():
    """Phase 18: TransceptionConfig.remat on the published model, b=24
    bf16 in the "pallas" mode (drop path 0.1): REMAT_STEPS steps with remat
    off twice and on once from the same weights, batch and generator seed.
    The run-to-run spread of the kernels (off against off) is logged; on
    against off must be within twice it for the losses, the gradients, the
    parameters and the BatchNorm statistics (0 where the spread is 0), and
    the generators' states must be equal; launches exactly REMAT_STEPS x
    launches_per_step (the recompute's included); peak memory of both."""
    import dataclasses

    from transception_tpu_torch.models.transception import launches_per_step

    g = torch.Generator().manual_seed(11)
    img = torch.rand(TRAIN_BATCH, 224, 224, 1, generator=g).cuda()
    lbl = torch.randint(0, 9, (TRAIN_BATCH, 224, 224), generator=g).cuda()
    cfg = _train_cfg("pallas")
    off1, off2 = _remat_run(cfg, img, lbl), _remat_run(cfg, img, lbl)
    rcfg = dataclasses.replace(cfg, remat=True)
    on = _remat_run(rcfg, img, lbl)
    card = gpu_line()
    parts = ("grads", "params", "bn")
    spread = {k: _max_diff(off1[k], off2[k]) for k in parts}
    spread["loss"] = max(abs(a - b) for a, b in zip(off1["losses"],
                                                    off2["losses"]))
    diff = {k: _max_diff(on[k], off1[k]) for k in parts}
    diff["loss"] = max(abs(a - b) for a, b in zip(on["losses"],
                                                  off1["losses"]))
    log(f"  remat b={TRAIN_BATCH} bf16 pallas, {REMAT_STEPS} steps: losses "
        f"off {off1['losses']} on {on['losses']}; max|on - off| "
        f"{ {k: f'{v:.3g}' for k, v in diff.items()} }, run-to-run spread "
        f"(off, off) { {k: f'{v:.3g}' for k, v in spread.items()} }; "
        f"generator state equal {torch.equal(on['gen'], off1['gen'])}")
    log(f"  remat peak memory ({card}): off "
        f"{off1['peak'] / 2**30:.3f} GiB, on {on['peak'] / 2**30:.3f} GiB; "
        f"{REMAT_STEPS} steps (wall, after the first run's warm-up) off "
        f"{off2['secs']:.3f} s, on {on['secs']:.3f} s")
    bad = [k for k in diff if diff[k] > 2 * spread[k]]
    if bad:
        fail(f"remat: {bad} beyond twice the run-to-run spread")
    if not torch.equal(on["gen"], off1["gen"]) or \
            not torch.equal(off1["gen"], off2["gen"]):
        fail("remat: the drop-path generator's state differs")
    for c, run in ((cfg, off1), (rcfg, on)):
        want = {k: REMAT_STEPS * n for k, n in launches_per_step(c).items()}
        if run["counts"] != want:
            fail(f"remat={c.remat}: launches {run['counts']}, want {want}")
    if on["peak"] >= off1["peak"]:
        fail("remat: no less peak memory than without it")
    return [("per remat pallas train step", on["tallies"], REMAT_STEPS)]


DEVICE_TIME_TOL = 0.10  # device_time_per_call against CUDA events


def profiling_phase():
    """Phase 19: utils/profiling.py on the published b=32 bf16 logits
    forward: device_time_per_call (the median span of 5 traced calls)
    against CUDA events recorded around each of the same calls, inside
    its traced window: every call's span must be within DEVICE_TIME_TOL
    of its events, whose excess over the span is the host's time before
    the first launch and after the last, on the card's clock; the median
    of 5 untraced calls' events beside them (the profiler's cost on the
    host-bound forward, measured); cost_analysis on the kernel path and
    on the plain path (use_kernels=False, the same structure), whose
    flops and bytes must be equal; and profile_model_sections' four
    times."""
    import dataclasses

    from transception_tpu_torch.core.config import TransceptionConfig
    from transception_tpu_torch.models.transception import MSTransception
    from transception_tpu_torch.ops import kernels
    from transception_tpu_torch.utils import profiling

    cfg = pinned(TransceptionConfig())
    model = MSTransception(cfg, "cuda", seed=0)
    x = torch.rand(BATCH, 224, 224, 1,
                   generator=torch.Generator().manual_seed(5)).cuda()

    def fwd():
        with torch.inference_mode():
            return model(x)

    def event_ms():
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fwd()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    pairs = []

    def traced_fwd():
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fwd()
        b.record()
        pairs.append((a, b))

    fwd()
    untraced = sorted(event_ms() for _ in range(5))[2]
    dev_s, parsed = profiling.device_time_per_call(
        traced_fwd, iters=5, trace_dir=str(OUT_DIR / "device_time"))
    card = gpu_line()
    if dev_s is None:
        fail("device_time_per_call saw no device activity on the card")
    torch.cuda.synchronize()
    ev = [a.elapsed_time(b) for a, b in pairs]
    spans = [t * 1e3 for t in parsed["call_times_s"]]
    if len(spans) != len(ev):
        fail(f"device_time_per_call read {len(spans)} spans of "
             f"{len(ev)} calls")
    ratios = [t / e for t, e in zip(spans, ev)]
    busy = sorted(parsed["busy_times_s"])[len(parsed["busy_times_s"]) // 2]
    mid = sorted(ev)[len(ev) // 2]
    log(f"  device_time_per_call b={BATCH} bf16 logits ({card}): span "
        f"{dev_s * 1e3:.3f} ms (busy {busy * 1e3:.3f} ms, "
        f"{len(parsed['kernel_times_s'])} kernel names); CUDA events "
        f"around the same traced calls {mid:.3f} ms (median), span/events "
        f"by call " + ", ".join(f"{r:.4f}" for r in ratios)
        + "; events less span (host before the first launch and after the "
        "last) " + ", ".join(f"{e - t:.3f}" for t, e in zip(spans, ev))
        + f" ms; untraced calls' events {untraced:.3f} ms (median of 5): "
        f"traced/untraced {mid / untraced:.3f}")
    if any(abs(r - 1) > DEVICE_TIME_TOL for r in ratios):
        fail(f"device_time_per_call: a call's span is not within "
             f"{DEVICE_TIME_TOL:.0%} of CUDA events around the same call")
    plain = MSTransception(dataclasses.replace(cfg, use_kernels=False),
                           "cuda", seed=0)
    costs = {}
    for name, m in (("kernels", model), ("plain", plain)):
        t0 = time.perf_counter()
        with torch.inference_mode():
            costs[name] = profiling.cost_analysis(m, x)
        log(f"  cost_analysis {name}: {costs[name]} "
            f"({time.perf_counter() - t0:.1f} s)")
    if costs["kernels"] != costs["plain"]:
        fail("cost_analysis: the kernel and plain paths report different "
             "work")
    del plain, model
    torch.cuda.empty_cache()
    secs = profiling.profile_model_sections(TransceptionConfig(),
                                            batch=BATCH, log=None)
    log(f"  profile_model_sections b={BATCH} bf16 ({card}): "
        + ", ".join(f"{k} {v:.1f}" if k == "slices_per_s" else
                    f"{k} {v * 1e3:.3f} ms" for k, v in secs.items()))


# ---- phase 20: the tensor-parallel ('model') axis ----

# The ETB FFN folds of the flash and "pallas" train steps, (s, C, hidden),
# the folds the TP rules shard (parallel.mesh.shard_layout): stage 1 and
# decoder_0 (56², 64), decoder_1 (28², 128), decoder_2 (14², 320).
TP_SHAPES = ((56, 64, 256), (28, 128, 512), (14, 320, 1280))
TP_SIZES = (2, 4)
TP_MAIN = 2   # the model axis of the steps: two ranks share the one card
TP_WIDE = 4   # and of the NCCL flash step with four cards
# The steps' depth: one block a stage and one path a stage at the
# published widths and map sides (every shape one the full model launches).
TP_DEPTH = dict(num_layers=(1, 1, 1), num_path=(1, 1, 1))
TP_MODES = (("bf16 default", {}, BF16_LIMITS),
            ("bf16 flash", dict(ffn_flash_train=True), BF16_LIMITS),
            ("bf16 pallas", dict(use_pallas_train=True, mhca_ffn_fold=True,
                                 drop_path_rate=0.1), BF16_LIMITS),
            ("fp32 flash", dict(ffn_flash_train=True, dtype="float32"),
             FP32_LIMITS))
TP_CKPT_MODE = "bf16 flash"  # its checkpoint resumes in one process
TP_TIME_STEPS = 2            # steps timed after the compared ones


def _tp_shards(p, tp, r):
    """Rank r's shards of (lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2)."""
    lts, ltb, w1, b1, dw, dwb, ls, lb, w2, b2 = p
    n = w1.shape[0] // tp
    k = slice(r * n, (r + 1) * n)
    return lts, ltb, w1[k], b1[k], dw[k], dwb[k], ls[k], lb[k], w2[:, k], b2


def _tp_forward(x, p, s, tp, ops, fault=False):
    """K2's hidden-sharded form over tp shards in one process: each
    rank's stages in turn (ops: the operators, or the plain stages), the
    partials summed in rank order. fault: each rank normalises by its own
    partial sums (the planted fault: the sum left out). Returns (out, the
    summed sums)."""
    fc1, fc2, out = ops
    hid = p[2].shape[0]
    sh = [_tp_shards(p, tp, r) for r in range(tp)]
    part = [fc1(x, *q[:6], s, 1, 1e-5, hid) for q in sh]
    st = sum(pt[1] for pt in part)
    pp = sum(fc2(h, *q[4:9], stp if fault else st, s, hid, 1e-5)
             for (h, stp), q in zip(part, sh))
    return out(pp, p[9], x), st


def _tp_backward(x, g, p, s, tp, st, ops, fault=False):
    """K11's hidden-sharded form over tp shards in one process, as
    _tp_forward: the eleven gradients of mixffn_ln_skip_bwd, the shards'
    pieces concatenated. fault: the LN backward's sums left unsummed."""
    rows, dh, ln = ops
    hid = p[2].shape[0]
    sh = [_tp_shards(p, tp, r) for r in range(tp)]
    rr = [rows(x, g, *q[:9], st, s, 1, hid, 1e-5, 1e-5) for q in sh]
    m = sum(r[5] for r in rr)
    dd = [dh(*r[:5], g, q[4], q[6], q[2], st, r[5] if fault else m, s, hid,
             1e-5) for r, q in zip(rr, sh)]
    dx, dlts, dltb, db2 = ln(x, g, sum(d[0] for d in dd), p[0], 1, 1e-5)

    def cat(src, i, dim=0):
        return torch.cat([t[i] for t in src], dim)

    return (dx, dlts, dltb, cat(dd, 1), cat(dd, 2), cat(dd, 3), cat(dd, 4),
            cat(rr, 6), cat(rr, 7), cat(dd, 5, 1), db2)


def _tallied(name, fn):
    """fn's result and the one shape key of kernel `name` its launches
    tallied."""
    from transception_tpu_torch.ops import kernels
    kernels.reset_launches()
    out = fn()
    keys = [k for k in kernels.shape_counts() if k[0] == name]
    if len(keys) != 1:
        fail(f"{name}: tallied {kernels.shape_counts()}")
    return keys[0], out


def tp_kernel_phase(measured):
    """Phase 20 (a). K2's and K11's hidden-sharded forms on the card at
    every ETB fold of the flash and pallas train steps at b=24, tp 2 and
    4, bf16 and fp32: each shard's stages launched in turn and the
    partials summed in rank order, against the unsharded kernel (K2, K11)
    and against the sharded plain stages, within phase 8's limits (the
    forward's branch alone); a planted fault each (the sums over the
    hidden width left out) must fail. Each stage of rank 0's shard timed
    (CUDA events), the bound of a shard's work (its flops and bytes). The
    shapes of the steps (tp 2; with four cards tp 4 at bf16, the NCCL
    tp 4 step's) join `measured`; the others are logged."""
    from transception_tpu_torch.ops.kernels import mixffn as mf
    kops = (mf.TP_FC1_OP, mf.TP_FC2_OP, mf.TP_OUT_OP)
    pops = (mf.tp_fc1_plain, mf.tp_fc2_plain, mf.tp_out_plain)
    kbops = (mf.TP_BWD_ROWS_OP, mf.TP_BWD_DH_OP, mf.TP_BWD_LN_OP)
    pbops = (mf.tp_bwd_rows_plain, mf.tp_bwd_dh_plain, mf.tp_bwd_ln_plain)
    names = ("dx", "dlts", "dltb", "dw1", "db1", "ddw", "ddwb", "dls", "dlb",
             "dw2", "db2")
    B = TRAIN_BATCH
    gen = torch.Generator().manual_seed(20)
    for dt in (torch.bfloat16, torch.float32):
        fp32 = dt == torch.float32
        es, tag = (4, " fp32") if fp32 else (2, "")
        tol, btol = (FP32_TOL, FP32_TOL) if fp32 else (0.02, BWD_TOL)
        peak = FP32_FLOPS if fp32 else BF16_FLOPS
        for s, C, hid in TP_SHAPES:
            n = B * s * s
            x = rand(gen, (B, n // B, C), dtype=dt)
            gy = rand(gen, (B, n // B, C), dtype=dt)
            p = (rand(gen, (C,), 0.1, 1.0), rand(gen, (C,), 0.1),
                 rand(gen, (hid, C), C ** -0.5), rand(gen, (hid,), 0.02),
                 rand(gen, (hid, 1, 3, 3), 0.3), rand(gen, (hid,), 0.02),
                 rand(gen, (hid,), 0.1, 1.0), rand(gen, (hid,), 0.1),
                 rand(gen, (C, hid), hid ** -0.5), rand(gen, (C,), 0.02))
            with torch.no_grad():
                whole = mf.mixffn_ln_skip(x, *p, s=s)
                whole_g = mf.mixffn_ln_skip_bwd(x, *p, gy, s=s)
            for tp in TP_SIZES:
                hl = hid // tp
                label = f"({B},{s * s},{C}) hidden {hid}, tp {tp} " \
                        f"({hl} a rank){tag}"
                with torch.no_grad():
                    fkey, (got, st) = _tallied(mf.TP_NAME, lambda: _tp_forward(
                        x, p, s, tp, kops))
                    want, _ = _tp_forward(x, p, s, tp, pops)
                    err, ok = err_check(f"mixffn_tp {label} vs sharded "
                                        f"plain", got, want, tol, base=x)
                    e2, ok2 = err_check(f"mixffn_tp {label} vs unsharded "
                                        f"K2", got, whole, tol, base=x)
                    if not (ok and ok2):
                        fail("the sharded K2 disagrees")
                    bad, _ = _tp_forward(x, p, s, tp, pops, fault=True)
                    if err_check("  planted fault (the LN's sums not "
                                 "summed)", bad, want, tol, base=x)[1]:
                        fail("mixffn_tp: the check does not see a fault")
                    bkey, gk = _tallied(mf.TP_BWD_NAME, lambda: _tp_backward(
                        x, gy, p, s, tp, st, kbops))
                    gp = _tp_backward(x, gy, p, s, tp, st, pbops)
                    torch.cuda.synchronize()
                    gp = tuple(t.to(w.dtype) for t, w in zip(gp, gk))
                    berr, bok = grads_check(f"mixffn_tp_bwd {label}", gk,
                                            gp, names, btol)
                    berr2, bok2 = grads_check(f"mixffn_tp_bwd {label} vs "
                                              f"K11", gk, whole_g, names,
                                              btol)
                    log(f"  mixffn_tp_bwd {label}: max_abs_err {berr:.6g} "
                        f"vs sharded plain, {berr2:.6g} vs unsharded K11 "
                        f"(each within {btol} x its max) "
                        f"{'ok' if bok and bok2 else 'FAIL'}")
                    if not (bok and bok2):
                        fail("the sharded K11 disagrees")
                    badg = _tp_backward(x, gy, p, s, tp, st, pbops,
                                        fault=True)
                    badg = tuple(t.to(w.dtype) for t, w in zip(badg, gk))
                    if grads_check("  planted fault (the LN backward's sums "
                                   "not summed)", badg, gp, names, btol)[1]:
                        fail("mixffn_tp_bwd: the check does not see a "
                             "fault")
                    log("    planted faults rejected")
                    # Rank 0's shard, stage by stage.
                    q = _tp_shards(p, tp, 0)
                    h0, _ = mf.TP_FC1_OP(x, *q[:6], s, 1, 1e-5, hid)
                    pp = mf.TP_FC2_OP(h0, *q[4:9], st, s, hid, 1e-5)
                    rr = mf.TP_BWD_ROWS_OP(x, gy, *q[:9], st, s, 1, hid,
                                           1e-5, 1e-5)
                    dxn = mf.TP_BWD_DH_OP(*rr[:5], gy, q[4], q[6], q[2], st,
                                          rr[5], s, hid, 1e-5)[0]
                    fwd = {
                        "fc1": (lambda: mf.TP_FC1_OP(x, *q[:6], s, 1, 1e-5,
                                                     hid),
                                lambda: mf.tp_fc1_plain(x, *q[:6], s, 1,
                                                        1e-5, hid)),
                        "fc2": (lambda: mf.TP_FC2_OP(h0, *q[4:9], st, s,
                                                     hid, 1e-5),
                                lambda: mf.tp_fc2_plain(h0, *q[4:9], st, s,
                                                        hid, 1e-5)),
                        "out": (lambda: mf.TP_OUT_OP(pp, p[9], x),
                                lambda: mf.tp_out_plain(pp, p[9], x))}
                    bwd = {
                        "rows": (lambda: mf.TP_BWD_ROWS_OP(
                            x, gy, *q[:9], st, s, 1, hid, 1e-5, 1e-5),
                            lambda: mf.tp_bwd_rows_plain(
                                x, gy, *q[:9], st, s, 1, hid, 1e-5, 1e-5)),
                        "dh": (lambda: mf.TP_BWD_DH_OP(
                            *rr[:5], gy, q[4], q[6], q[2], st, rr[5], s, hid,
                            1e-5), lambda: mf.tp_bwd_dh_plain(
                            *rr[:5], gy, q[4], q[6], q[2], st, rr[5], s, hid,
                            1e-5)),
                        "ln": (lambda: mf.TP_BWD_LN_OP(x, gy, dxn, p[0], 1,
                                                       1e-5),
                               lambda: mf.tp_bwd_ln_plain(x, gy, dxn, p[0],
                                                          1, 1e-5))}
                    for form, stages, key, e, nbytes, flops in (
                            (mf.TP_NAME, fwd, fkey, max(err, e2),
                             2 * n * C * es + (2 * C * hl + 9 * hl) * es
                             + 2 * n * C * 4 + 2 * n * 8,
                             4 * n * C * hl + 18 * n * hl),
                            (mf.TP_BWD_NAME, bwd, bkey, max(berr, berr2),
                             3 * n * C * es + (2 * C * hl + 9 * hl) * es
                             + (2 * C * hl + 13 * hl + 3 * C) * 4
                             + 2 * n * C * 4 + 3 * n * 8,
                             10 * n * C * hl + 54 * n * hl)):
                        t = {k: (cuda_ms(f), cuda_ms(pf, iters=3))
                             for k, (f, pf) in stages.items()}
                        ms = sum(a for a, _ in t.values())
                        pms = sum(b for _, b in t.values())
                        bms, by = bound_ms(nbytes, flops, peak)
                        log(f"    {form} {label}: rank 0's stages "
                            + ", ".join(f"{k} {a:.4f} ms (plain {b:.4f})"
                                        for k, (a, b) in t.items())
                            + f"; ms {ms:.4f} plain_ms {pms:.4f} bound_ms "
                            f"{bms:.4f} ({by}) per launch, library call "
                            f"none")
                        if tp == TP_MAIN or (
                                tp == TP_WIDE and not fp32 and
                                torch.cuda.device_count() >= TP_WIDE):
                            record(measured, key, label, e, ms, pms, None,
                                   nbytes, flops, peak)
            del x, gy, p, whole, whole_g


def _tp_trainer(over, out, mesh=None):
    """A Trainer of the published widths at TP_DEPTH (TrainConfig(): b=24,
    wide head; weights from its seed) on `mesh` (None: one process); the
    overrides' "model", a registry name (phase 22's legacy step), builds
    that model of the config."""
    from transception_tpu_torch.core.config import (
        DataConfig,
        TrainConfig,
        TransceptionConfig,
    )
    from transception_tpu_torch.models.registry import create_model
    from transception_tpu_torch.parallel.mesh import DataMesh
    from transception_tpu_torch.train.trainer import Trainer
    if mesh is None:
        mesh = DataMesh(0, 1, torch.device("cuda", 0))
    over = dict(over)
    name = over.pop("model", None)
    cfg = TransceptionConfig(**dict(TP_DEPTH, **over))
    tc = TrainConfig(output_dir=str(out), tp_size=mesh.tp)
    model = None if name is None else create_model(name, cfg, mesh.device,
                                                   seed=tc.seed)
    return Trainer(cfg, tc, DataConfig(dataset="synthetic"), device="cuda",
                   mesh=mesh, model=model)


def _want_step(tr, tp):
    """launches_per_step of a Trainer's model at tp (a legacy model's:
    models.legacy.launches_per_step, which the axis does not change)."""
    from transception_tpu_torch.models import legacy
    from transception_tpu_torch.models.transception import (
        MSTransception,
        launches_per_step,
    )
    if isinstance(tr.model, MSTransception):
        return launches_per_step(tr.model.cfg, tp=tp)
    return legacy.launches_per_step(type(tr.model).__name__.lower(),
                                    tr.model.cfg)


def _tp_rank(out_dir, backend, dp, tp, labels, evals=()):
    """One rank of phase 20 (b) or 21 (c) (spawned): the modes `labels`
    (TP_MODES, SP_MODES) on a dp x tp mesh over `backend` (gloo: every
    rank on card 0; NCCL: a card each), one step each on its data rank's
    rows, the counters and tallies of the step, the gathered gradients;
    in TP_CKPT_MODE and SP_CKPT_MODE the checkpoint and the next step;
    then the ms of a step; then the eval forwards `evals` (SP_EVALS,
    _sp_evals). Rank (0, 0) saves the results."""
    from transception_tpu_torch.data.device_synthetic import (
        DeviceSyntheticStream,
    )
    from transception_tpu_torch.ops import kernels
    from transception_tpu_torch.parallel.mesh import (
        gather_state_dict,
        make_mesh,
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if backend == "gloo":
        os.environ["LOCAL_RANK"] = "0"
    mesh = make_mesh(dp, tp, device="cuda", backend=backend)
    out = Path(out_dir)
    batch = DeviceSyntheticStream(TRAIN_BATCH, 224, 9,
                                  device=mesh.device).batch(0)
    rows = mesh.rows(TRAIN_BATCH)
    img, lbl = batch["image"][rows], batch["label"][rows]
    res = {}

    def taken(tr, met):
        torch.cuda.synchronize()
        g = gather_state_dict({n: p.grad for n, p in
                               tr.model.named_parameters()}, tr.layout,
                              mesh.axis)
        return (float(met["loss"]), {n: t.float().cpu() for n, t in g.items()},
                {n: b.float().cpu() for n, b in tr.model.named_buffers()})

    try:
        for label in labels:
            tr = _tp_trainer(_mode(label)[0],
                             out / f"{label}_{mesh.rank}_{mesh.t}", mesh)
            state, step = tr.init_state(2211 // TRAIN_BATCH)
            kernels.reset_launches()
            met = step(img, lbl)
            r = {"step": taken(tr, met), "counts": kernels.launch_counts(),
                 "shapes": dict(kernels.shape_counts()),
                 "want": _want_step(tr, tp)}
            if label in (TP_CKPT_MODE, SP_CKPT_MODE):
                r["ckpt"] = tr.save_checkpoint(state)
                r["next"] = taken(tr, step(img, lbl))
            r["ms"] = cuda_ms(lambda: step(img, lbl), iters=TP_TIME_STEPS,
                              warmup=0)
            res[label] = r
            del tr, state, step
            torch.cuda.empty_cache()
        if evals:
            res["evals"] = _sp_evals(img, mesh,
                                     out / f"evals_{mesh.rank}_{mesh.t}",
                                     evals)
        if mesh.is_main:
            torch.save(res, out / "rank0.pt")
    finally:
        mesh.close()


def tp_phase():
    """Phase 20 (b, c). A tp=2 train step on the card: two spawned ranks
    share card 0 over the gloo backend on CUDA tensors (NCCL refuses two
    ranks on one card; the CLIs keep NCCL, a card a rank), in the default,
    flash and pallas modes at bf16 and the flash mode at fp32, each
    against the one-process Trainer's step from the same weights on the
    same batch within phase 9's limits, its launches exactly
    launches_per_step(cfg, tp) (the ETB FFN folds on the hidden-sharded
    K2 and K11), its ms logged (gloo stages each sum through the host:
    not TP's speed). The flash mode's checkpoint (rank (0, 0), the full
    layout) resumes in one process and gives the ranks' next step. With
    two cards or more, tp 2 over NCCL a card a rank; with four, dp2 x tp2
    and tp 4.
    cli.train --tp_size beyond the cards is refused before any work.
    Returns the runs' launches per shape key."""
    import shutil

    from transception_tpu_torch.cli import train as train_cli
    from transception_tpu_torch.data.device_synthetic import (
        DeviceSyntheticStream,
    )
    from transception_tpu_torch.parallel.mesh import spawn

    cards = torch.cuda.device_count()
    out = OUT_DIR / "tp"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    batch = DeviceSyntheticStream(TRAIN_BATCH, 224, 9, device="cuda").batch(0)
    img, lbl = batch["image"], batch["label"]
    refs, one_ms = {}, {}
    for label, over, _ in TP_MODES:
        tr = _tp_trainer(over, out / "one")
        refs[label], one_ms[label] = _ONE_STEP[label] = _dp_step(tr, img,
                                                                 lbl)
        del tr
        torch.cuda.empty_cache()
    runs = []
    meshes = [("gloo", 1, TP_MAIN, [m[0] for m in TP_MODES])]
    if cards >= 2:
        meshes.append(("nccl", 1, 2, [TP_CKPT_MODE]))
    if cards >= 4:
        meshes += [("nccl", 2, 2, [TP_CKPT_MODE]),
                   ("nccl", 1, TP_WIDE, [TP_CKPT_MODE])]
    for backend, dp, tp, labels in meshes:
        t0 = time.perf_counter()
        where = (f"{backend}, dp{dp} x tp{tp}"
                 + (", every rank on card 0" if backend == "gloo" else
                    ", a card a rank"))
        wdir = out / f"{backend}_dp{dp}_tp{tp}"
        wdir.mkdir()
        spawn(_tp_rank, dp * tp, (str(wdir), backend, dp, tp, labels))
        res = torch.load(wdir / "rank0.pt", weights_only=False)
        for label in labels:
            r, lim = res[label], dict((m[0], m[2]) for m in TP_MODES)[label]
            if r["counts"] != r["want"]:
                fail(f"TP {label} ({where}): launched {r['counts']}, want "
                     f"launches_per_step {r['want']}")
            runs.append((f"per TP {label} train step ({where}, rank 0)",
                         r["shapes"], 1))
            log(f"  TP {label} ({where}): launches = launches_per_step "
                f"(mixffn_tp {r['counts']['mixffn_tp']}, mixffn_tp_bwd "
                f"{r['counts']['mixffn_tp_bwd']}, mixffn "
                f"{r['counts']['mixffn']}); {r['ms']:.1f} ms a step (CUDA "
                f"events over {TP_TIME_STEPS} steps"
                + ("; gloo sums through the host: not TP's speed"
                   if backend == "gloo" else "")
                + f"), one process {one_ms[label]:.1f} ms")
            if not _compare_steps(f"TP {label} ({where}) vs one process",
                                  r["step"], refs[label], lim=lim):
                fail(f"the tp {label} step disagrees with the one-process "
                     f"step")
            if "ckpt" in r:
                tr = _tp_trainer(dict(m[:2] for m in TP_MODES)[label],
                                 wdir / "resumed")
                state, step = tr.init_state(2211 // TRAIN_BATCH)
                tr.restore_checkpoint(state, r["ckpt"])
                met = step(img, lbl)
                torch.cuda.synchronize()
                nxt = (float(met["loss"]),
                       {n: p.grad.float().cpu()
                        for n, p in tr.model.named_parameters()},
                       {n: b.float().cpu() for n, b in tr.model.named_buffers()})
                if not _compare_steps(f"TP {label} ({where}): its checkpoint "
                                      f"resumed in one process, next step "
                                      f"vs the ranks'", nxt, r["next"],
                                      lim=lim):
                    fail("the tp checkpoint does not resume to the ranks' "
                         "next step")
                del tr, state, step
                torch.cuda.empty_cache()
        log(f"  {where}: {time.perf_counter() - t0:.1f} s")
    tp = 2 if cards == 1 else cards + 1
    try:
        train_cli.main(["--tp_size", str(tp), "--output_dir",
                        str(out / "refused")])
    except RuntimeError as e:
        log(f"  cli.train --tp_size {tp}: refused before any work: {e}")
        if f"needs {tp} cards, have {cards}" not in str(e):
            fail(f"--tp_size {tp}: the refusal does not name the counts")
    else:
        fail(f"cli.train --tp_size {tp} did not raise")
    if (out / "refused" / "log.txt").exists():
        fail("the refused run started work")
    if cards < 2:
        log("  NCCL tp runs were not possible here: one card "
            "(torch.cuda.device_count() == 1)")
    return runs


# ---- phase 21: the bridge's sequence sharding ----

# The bridge scales whose FFN fold runs K2 (mixffn.takes), (side, m): C =
# 64·m channels in m LN groups, hidden 4·C; the fused stream's tokens.
SP_SCALES = ((56, 1), (28, 2), (14, 5))
SP_STREAM = 6076
SP_AXIS = dict(bridge_seq_shard_axis="model")
SP_MODES = tuple((f"SP {label}", dict(over, **SP_AXIS), lim)
                 for label, over, lim in TP_MODES)
SP_CKPT_MODE = "SP bf16 flash"
# The sequence-sharded eval forward (the bridge's attention and FFN folds
# on: K8 on the query rows, K2 on the map rows) at tp 2 against the one
# process: (label, overrides, least share of equal class-map pixels).
SP_EVALS = (("SP eval bf16", dict(bridge_attn_fold=True,
                                  bridge_ffn_use_pallas=True, **SP_AXIS),
             0.98),
            ("SP eval fp32", dict(bridge_attn_fold=True,
                                  bridge_ffn_use_pallas=True, dtype="float32",
                                  **SP_AXIS), FP32_AGREE))
_ONE_STEP = {}  # phase 20's one-process steps by TP_MODES label


def _mode(label):
    """(overrides, limits) of a TP_MODES, SP_MODES, SP_EVALS, PATH_MODES,
    PATH_EVALS or LEGACY_TP_MODES label."""
    for lab, over, lim in TP_MODES + SP_MODES + SP_EVALS + PATH_MODES + \
            PATH_EVALS + LEGACY_TP_MODES:
        if lab == label:
            return over, lim
    fail(f"no mode {label}")


def _sp_blocks(s, tp):
    """Each rank's block of an s-row map on a model axis of tp ranks: its
    rows [r0, r1) and the rows [a, b) that K2 and K11 run, with the halo
    rows (mixffn.halo_rows)."""
    from transception_tpu_torch.ops.kernels.mixffn import halo_rows
    h = s // tp
    return [(r * h, (r + 1) * h) + halo_rows(s, r * h, (r + 1) * h)
            for r in range(tp)]


def _keep(tp, fp32):
    """Whether a rank-0 shape at tp joins the kernels line: the gloo tp 2
    step's, and with four cards the NCCL tp 4 flash step's (bf16)."""
    return tp == TP_MAIN or (tp == TP_WIDE and not fp32 and
                             torch.cuda.device_count() >= TP_WIDE)


def sp_kernel_phase(measured):
    """Phase 21 (a, b). (a) K2's and K11's row-block forms at every bridge
    scale a model axis of 2 or 4 ranks splits (56², 28² and 14² at tp 2;
    56² and 28² at tp 4), b=24, C = 64·m, bf16 and fp32: each rank's
    block with its halo rows against the block's plain version (phase 8's
    limits, K2 on its branch), the interior rows against the full-map
    K2's, the blocks' K11 gradients (dx scattered to the rows each block
    read) summed against the full-map K11's; planted faults: a block
    without its halo rows, and the sum of the blocks' dx without the halo
    rows' share. (b) K3 and K10 on each rank's query rows of the 6076-row
    stream (3038 at tp 2, 1519 at tp 4) against the full-stream launch's
    rows, the shards' dk and dv summed against the full launch's (the
    fault: rank 0's alone); K8 on each rank's query rows against the
    full-stream launch's. Rank 0's launches timed (CUDA events) against
    their bound; its shapes that the tp 2 step launches (with four cards
    also the tp 4 flash step's) join `measured`, the others are
    logged."""
    from transception_tpu_torch.ops.kernels import (
        bridge_attention as ba,
        mixffn as mf,
    )
    names = ("dx", "dlts", "dltb", "dw1", "db1", "ddw", "ddwb", "dls", "dlb",
             "dw2", "db2")
    B = TRAIN_BATCH
    gen = torch.Generator().manual_seed(21)
    for dt in (torch.bfloat16, torch.float32):
        fp32 = dt == torch.float32
        es, tag = (4, " fp32") if fp32 else (2, "")
        tol, btol = (FP32_TOL, FP32_TOL) if fp32 else (0.02, BWD_TOL)
        peak = FP32_FLOPS if fp32 else BF16_FLOPS
        for s, m in SP_SCALES:
            C, hid, gsz = 64 * m, 256 * m, 64
            kw = dict(s=s, groups=m)
            x = rand(gen, (B, s * s, C), dtype=dt)
            gy = rand(gen, (B, s * s, C), dtype=dt)
            p = (rand(gen, (gsz,), 0.1, 1.0).repeat(m),
                 rand(gen, (gsz,), 0.1).repeat(m),
                 rand(gen, (hid, C), C ** -0.5), rand(gen, (hid,), 0.02),
                 rand(gen, (hid, 1, 3, 3), 0.3), rand(gen, (hid,), 0.02),
                 rand(gen, (hid,), 0.1, 1.0), rand(gen, (hid,), 0.1),
                 rand(gen, (C, hid), hid ** -0.5), rand(gen, (C,), 0.02))

            def fargs(xx):
                return (xx, p[0][:gsz], p[1][:gsz]) + p[2:]

            with torch.no_grad():
                whole = mf.mixffn_ln_skip(*fargs(x), **kw)
                whole_g = mf.mixffn_ln_skip_bwd(x, *p, gy, **kw)
            for tp in TP_SIZES:
                if s % tp:
                    continue
                summed = [torch.zeros_like(t, dtype=torch.float32)
                          for t in whole_g]
                halo_less = torch.zeros_like(summed[0])
                for r, (r0, r1, a, b) in enumerate(_sp_blocks(s, tp)):
                    inner = slice((r0 - a) * s, (r1 - a) * s)
                    rows = slice(r0 * s, r1 * s)
                    xe = x[:, a * s:b * s].contiguous()
                    ge = torch.zeros_like(xe)
                    ge[:, inner] = gy[:, rows]
                    label = (f"({B},{(b - a) * s},{C}) hidden {hid} groups "
                             f"{m}: map rows {a}-{b} of {s}² (tp {tp} rank "
                             f"{r}'s rows {r0}-{r1} with halo rows){tag}")
                    with torch.no_grad():
                        fkey, got = launched_key(
                            "mixffn", lambda: mf.mixffn_ln_skip(
                                *fargs(xe), **kw))
                        e1, ok1 = err_check(
                            f"mixffn block {label} vs its plain version",
                            got, mf.mixffn_ln_skip_plain(*fargs(xe), **kw),
                            tol, base=xe)
                        e2, ok2 = err_check(
                            "    its rows vs the full-map K2's",
                            got[:, inner], whole[:, rows], tol,
                            base=x[:, rows])
                        if not (ok1 and ok2):
                            fail("the K2 row block disagrees")
                        bad = mf.mixffn_ln_skip_plain(
                            *fargs(x[:, rows].contiguous()), **kw)
                        if err_check("    planted fault (halo rows dropped) "
                                     "vs the full-map rows", bad,
                                     whole[:, rows], tol,
                                     base=x[:, rows])[1]:
                            fail("mixffn block: the check does not see a "
                                 "planted fault")
                    bkey, gk = launched_key(
                        "mixffn_bwd", lambda: mf.mixffn_ln_skip_bwd(
                            xe, *p, ge, **kw))
                    gp = mf.mixffn_ln_skip_bwd_plain(xe, *p, ge, **kw)
                    torch.cuda.synchronize()
                    berr, bok = grads_check(f"mixffn_bwd block {label}", gk,
                                            gp, names, btol)
                    log(f"  mixffn_bwd block {label}: max_abs_err "
                        f"{berr:.6g} vs its plain version (each gradient "
                        f"within {btol} x its max) {'ok' if bok else 'FAIL'}")
                    if not bok:
                        fail("the K11 row block disagrees")
                    summed[0][:, a * s:b * s] += gk[0].float()
                    halo_less[:, rows] += gk[0][:, inner].float()
                    for i in range(1, len(gk)):
                        summed[i] += gk[i].float()
                    if r:
                        continue
                    n = B * (b - a) * s
                    ms = cuda_ms(lambda: mf.mixffn_ln_skip(*fargs(xe), **kw))
                    pms = cuda_ms(lambda: mf.mixffn_ln_skip_plain(
                        *fargs(xe), **kw), iters=5)
                    bms_ = cuda_ms(lambda: mf.mixffn_ln_skip_bwd(
                        xe, *p, ge, **kw))
                    bpms = cuda_ms(lambda: mf.mixffn_ln_skip_bwd_plain(
                        xe, *p, ge, **kw), iters=3)
                    fb = (2 * n * C * es + 2 * C * hid * es + 9 * hid * es,
                          4 * n * C * hid + 18 * n * hid)
                    bb = (3 * n * C * es + (2 * C * hid + 9 * hid) * es + (
                        2 * C * hid + 13 * hid + 3 * C) * 4 + (
                        5 * hid + 3 * C) * 4,
                        10 * n * C * hid + 54 * n * hid)
                    keep = _keep(tp, fp32)
                    for what, key, e, k_ms, p_ms, (nb, fl) in (
                            ("mixffn", fkey, max(e1, e2), ms, pms, fb),
                            ("mixffn_bwd", bkey, berr, bms_, bpms, bb)):
                        bound, by = bound_ms(nb, fl, peak)
                        log(f"    {what} block {label}: ms {k_ms:.4f} "
                            f"plain_ms {p_ms:.4f} bound_ms {bound:.4f} "
                            f"({by}) per launch, library call none"
                            + ("" if keep else " (logged, not a row)"))
                        if keep:
                            record(measured, key, label, e, k_ms, p_ms, None,
                                   nb, fl, peak)
                got_g = tuple(t.to(w.dtype) for t, w in zip(summed, whole_g))
                err, ok = grads_check(f"mixffn_bwd blocks at tp {tp} summed",
                                      got_g, whole_g, names, btol)
                log(f"  mixffn_bwd ({B},{s * s},{C}) tp {tp}: the blocks' "
                    f"gradients summed vs the full-map K11's: max_abs_err "
                    f"{err:.6g} (each within {btol} x its max) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    fail("the K11 row blocks do not sum to the full map")
                bad = (halo_less.to(whole_g[0].dtype),) + got_g[1:]
                if grads_check("  planted fault (the halo rows' dx left out "
                               "of the sum)", bad, whole_g, names, btol)[1]:
                    fail("mixffn_bwd blocks: the check does not see a "
                         "planted fault")
                log("    planted fault (the halo rows' dx left out) rejected")
            del x, gy, p, whole, whole_g

        # (b) K3, K10 and K8 on the query rows of the fused stream; their
        # library calls: SDPA, its backward, SDPA + two F.linear + add.
        N, M, d = SP_STREAM, 784, 64
        sc = d ** -0.5
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lin = torch.nn.functional.linear
        q, k, v, g = (rand(gen, (B, 1, n, d), dtype=dt) for n in (N, M, M, N))
        k3peak = TF32X3_FLOPS if fp32 else peak
        with torch.no_grad():
            whole = ba.bridge_attention(q, k, v, sc)
        whole_g = ba.bridge_attention_bwd(q, k, v, g, sc)
        args, _, _, nb8, fl8 = _k8_args(gen, k, v, dt)
        with torch.no_grad():
            whole8 = ba.bridge_attention_folded(*args)
        for tp in TP_SIZES:
            n = N // tp
            dkv = [torch.zeros_like(t, dtype=torch.float32)
                   for t in whole_g[1:]]
            for r in range(tp):
                rows = slice(r * n, (r + 1) * n)
                qs, gs = q[:, :, rows].contiguous(), g[:, :, rows].contiguous()
                label = (f"q ({B},1,{n},{d}) kv ({B},1,{M},{d}): tp {tp} "
                         f"rank {r}'s query rows{tag}")
                with torch.no_grad():
                    key3, got = launched_key(
                        "bridge_attention",
                        lambda: ba.bridge_attention(qs, k, v, sc))
                    e3, ok = err_check(f"bridge_attention {label} vs the "
                                       f"full stream's rows", got,
                                       whole[:, :, rows], tol)
                    e3p, okp = err_check("    vs its plain version", got,
                                         ba.bridge_attention_plain(qs, k, v,
                                                                   sc), tol)
                    if not (ok and okp):
                        fail("bridge_attention on query rows disagrees")
                key10, gk = launched_key(
                    "bridge_attention_bwd",
                    lambda: ba.bridge_attention_bwd(qs, k, v, gs, sc))
                e10, ok = grads_check(
                    f"bridge_attention_bwd {label}", gk,
                    (whole_g[0][:, :, rows].contiguous(),) + tuple(
                        ba.bridge_attention_bwd_plain(qs, k, v, gs, sc)[1:]),
                    ("dq", "dk", "dv"), btol)
                if not ok:
                    fail("bridge_attention_bwd on query rows disagrees")
                for acc, t in zip(dkv, gk[1:]):
                    acc += t.float()
                if r == 0:
                    first_dk = gk[1]
                xs, rs = (t[:, rows].contiguous() for t in args[:2])
                sargs = (xs, rs) + args[2:]
                with torch.no_grad():
                    key8, got8 = launched_key(
                        "bridge_attention_folded",
                        lambda: ba.bridge_attention_folded(*sargs))
                    e8, ok = err_check(
                        f"bridge_attention_folded x/res ({B},{n},{d}): tp "
                        f"{tp} rank {r}'s query rows{tag} vs the full "
                        f"stream's rows", got8, whole8[:, rows], tol,
                        base=rs)
                    if not ok:
                        fail("bridge_attention_folded on query rows "
                             "disagrees")
                if r:
                    continue
                keep = _keep(tp, fp32)
                leaves = [x.clone().requires_grad_() for x in (qs, k, v)]
                out = sdpa(*leaves, scale=sc)
                w8 = [x.to(dt) for x in sargs[2:4] + sargs[6:8]]

                def lib8():
                    qq = lin(xs, w8[0], w8[1])[:, None]
                    return lin(sdpa(qq, k, v, scale=sc)[:, 0], w8[2],
                               w8[3]) + rs

                for what, key, e, fn, pfn, lfn, nb, fl, pk in (
                        ("bridge_attention", key3, max(e3, e3p),
                         lambda: ba.bridge_attention(qs, k, v, sc),
                         lambda: ba.bridge_attention_plain(qs, k, v, sc),
                         lambda: sdpa(qs, k, v, scale=sc),
                         2 * B * n * d * es + 2 * B * M * d * es,
                         4 * B * n * M * d, k3peak),
                        ("bridge_attention_bwd", key10, e10,
                         lambda: ba.bridge_attention_bwd(qs, k, v, gs, sc),
                         lambda: ba.bridge_attention_bwd_plain(qs, k, v, gs,
                                                               sc),
                         lambda: torch.autograd.grad(out, leaves, gs,
                                                     retain_graph=True),
                         (3 * n + 4 * M) * d * es * B, 10 * B * n * M * d,
                         k3peak),
                        ("bridge_attention_folded", key8, e8,
                         lambda: ba.bridge_attention_folded(*sargs),
                         lambda: ba.bridge_attention_folded_plain(*sargs),
                         lib8, nb8 - 3 * B * (N - n) * d * es,
                         fl8 * n // N, peak if not fp32 else TF32X3_FLOPS)):
                    ms, pms = cuda_ms(fn), cuda_ms(pfn, iters=3)
                    with torch.no_grad() if what != "bridge_attention_bwd" \
                            else contextlib.nullcontext():
                        lms = cuda_ms(lfn)
                    bound, by = bound_ms(nb, fl, pk)
                    # K8 runs in the sharded eval forward only (logged).
                    row = keep and what != "bridge_attention_folded"
                    log(f"    {what} {label}: ms {ms:.4f} plain_ms "
                        f"{pms:.4f} library_ms {lms:.4f} bound_ms "
                        f"{bound:.4f} ({by}) "
                        f"per launch; {against(ms, bound, lms)}"
                        + ("" if row else " (logged, not a row)"))
                    if row:
                        record(measured, key, label, e, ms, pms, lms, nb,
                               fl, pk)
                del leaves, out
            got_kv = tuple(t.to(w.dtype) for t, w in zip(dkv, whole_g[1:]))
            err, ok = grads_check(f"bridge_attention_bwd tp {tp} dk/dv "
                                  f"summed", got_kv, whole_g[1:],
                                  ("dk", "dv"), btol)
            log(f"  bridge_attention_bwd tp {tp}: the shards' dk and dv "
                f"summed vs the full stream's: max_abs_err {err:.6g} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail("the query shards' dk/dv do not sum to the full "
                     "stream's")
            if grads_check("  planted fault (rank 0's dk alone, not summed)",
                           (first_dk, got_kv[1]), whole_g[1:], ("dk", "dv"),
                           btol)[1]:
                fail("bridge_attention_bwd shards: the check does not see "
                     "a planted fault")
            log("    planted fault (dk not summed) rejected")
        del q, k, v, g, whole, whole_g, args, whole8


def _sp_evals(img, mesh=None, out=None, labels=None):
    """The eval forwards `labels` (SP_EVALS' by default; PATH_EVALS') of
    the TP_DEPTH model (the Trainer's weights) on `img`, on `mesh` (None:
    one process): the logits and the class maps of rank 0's, the launches
    of the two forwards and their shape tallies."""
    from transception_tpu_torch.ops import kernels
    res = {}
    for label in labels or [e[0] for e in SP_EVALS]:
        tr = _tp_trainer(_mode(label)[0], (out or OUT_DIR / "sp") / label,
                         mesh)
        model = tr.model.eval()
        kernels.reset_launches()
        with torch.no_grad():
            logits = model(img)
            maps = model(img, argmax=True)
        torch.cuda.synchronize()
        res[label] = {"logits": logits.float().cpu(), "maps": maps.cpu(),
                      "counts": kernels.launch_counts(),
                      "shapes": dict(kernels.shape_counts())}
        del tr, model
        torch.cuda.empty_cache()
    return res


def sp_phase():
    """Phase 21 (c). A sequence-sharded tp=2 step on the card (the
    bridge_seq_shard_axis "model" config at the published widths, one
    block and one path a stage, b=24): two spawned ranks share card 0
    over gloo, as phase 20's, in the default, flash and pallas modes at
    bf16 and the flash mode at fp32, each against phase 20's one-process
    step of the same mode (the sharding is the identity at tp 1) within
    phase 9's limits, its launches exactly launches_per_step(cfg, tp=2);
    the flash mode's checkpoint resumed in one process gives the ranks'
    next step; with two cards or more NCCL tp 2, with four dp2 x tp2 and
    tp 4. The sharded eval forward (the bridge's folds on: K8 and K2 on
    the blocks) at tp 2, bf16 and fp32, against the one-process forward:
    the share of equal class-map pixels at least SP_EVALS' limit, the
    logits' difference and whether they are bit-equal logged, its
    launches launches_per_forward(cfg, tp=2) a forward. Returns the step
    runs' launches per shape key."""
    import shutil

    from transception_tpu_torch.core.config import TransceptionConfig
    from transception_tpu_torch.data.device_synthetic import (
        DeviceSyntheticStream,
    )
    from transception_tpu_torch.models.transception import (
        launches_per_forward,
    )
    from transception_tpu_torch.parallel.mesh import spawn

    cards = torch.cuda.device_count()
    out = OUT_DIR / "sp"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    batch = DeviceSyntheticStream(TRAIN_BATCH, 224, 9, device="cuda").batch(0)
    img, lbl = batch["image"], batch["label"]
    for label, over, _ in TP_MODES:
        if label not in _ONE_STEP:
            tr = _tp_trainer(over, out / "one")
            _ONE_STEP[label] = _dp_step(tr, img, lbl)
            del tr
            torch.cuda.empty_cache()
    one_eval = _sp_evals(img, out=out / "one_eval")
    runs = []
    labels = [m[0] for m in SP_MODES]
    meshes = [("gloo", 1, TP_MAIN, labels, [e[0] for e in SP_EVALS])]
    if cards >= 2:
        meshes.append(("nccl", 1, 2, [SP_CKPT_MODE], []))
    if cards >= 4:
        meshes += [("nccl", 2, 2, [SP_CKPT_MODE], []),
                   ("nccl", 1, TP_WIDE, [SP_CKPT_MODE], [])]
    for backend, dp, tp, steps, evals in meshes:
        t0 = time.perf_counter()
        where = (f"{backend}, dp{dp} x tp{tp}"
                 + (", every rank on card 0" if backend == "gloo" else
                    ", a card a rank"))
        wdir = out / f"{backend}_dp{dp}_tp{tp}"
        wdir.mkdir()
        spawn(_tp_rank, dp * tp, (str(wdir), backend, dp, tp, steps, evals))
        res = torch.load(wdir / "rank0.pt", weights_only=False)
        for label in steps:
            r, lim = res[label], _mode(label)[1]
            ref, one_ms = _ONE_STEP[label[len("SP "):]]
            if r["counts"] != r["want"]:
                fail(f"{label} ({where}): launched {r['counts']}, want "
                     f"launches_per_step {r['want']}")
            runs.append((f"per {label} train step ({where}, rank 0)",
                         r["shapes"], 1))
            blocks = sorted({k[1] for k in r["shapes"]
                             if k[0] in ("mixffn", "bridge_attention")})
            log(f"  {label} ({where}): launches = launches_per_step "
                f"(bridge_attention {r['counts']['bridge_attention']}, "
                f"mixffn {r['counts']['mixffn']}, mixffn_tp "
                f"{r['counts']['mixffn_tp']}) at rank 0's shapes {blocks}; "
                f"{r['ms']:.1f} ms a step (CUDA events over "
                f"{TP_TIME_STEPS} steps"
                + ("; gloo sums through the host: not SP's speed"
                   if backend == "gloo" else "")
                + f"), one process {one_ms:.1f} ms")
            if not _compare_steps(f"{label} ({where}) vs one process",
                                  r["step"], ref, lim=lim):
                fail(f"the {label} step disagrees with the one-process "
                     f"step")
            if "ckpt" in r:
                tr = _tp_trainer(_mode(label)[0], wdir / "resumed")
                state, step = tr.init_state(2211 // TRAIN_BATCH)
                tr.restore_checkpoint(state, r["ckpt"])
                met = step(img, lbl)
                torch.cuda.synchronize()
                nxt = (float(met["loss"]),
                       {n: p.grad.float().cpu()
                        for n, p in tr.model.named_parameters()},
                       {n: b.float().cpu()
                        for n, b in tr.model.named_buffers()})
                if not _compare_steps(f"{label} ({where}): its checkpoint "
                                      f"resumed in one process, next step "
                                      f"vs the ranks'", nxt, r["next"],
                                      lim=lim):
                    fail("the SP checkpoint does not resume to the ranks' "
                         "next step")
                del tr, state, step
                torch.cuda.empty_cache()
        for label in evals:
            got, want = res["evals"][label], one_eval[label]
            cfg = TransceptionConfig(**TP_DEPTH, **_mode(label)[0])
            lpf = Counter(launches_per_forward(cfg, argmax=False, tp=tp))
            lpf.update(launches_per_forward(cfg, argmax=True, tp=tp))
            if got["counts"] != dict(lpf):
                fail(f"{label} ({where}): launched {got['counts']}, want "
                     f"launches_per_forward {dict(lpf)}")
            agree = float((got["maps"] == want["maps"]).float().mean())
            diff = float((got["logits"] - want["logits"]).abs().max())
            same = torch.equal(got["logits"], want["logits"])
            least = _mode(label)[1]
            log(f"  {label} ({where}) vs one process: class maps {agree:.6f}"
                f" equal (at least {least}), logits max |diff| {diff:.6g} "
                f"(max |logit| {float(want['logits'].abs().max()):.4g}), "
                f"bit-equal {same}; launches = launches_per_forward(cfg, "
                f"tp={tp}) x (logits + argmax) "
                f"{'ok' if agree >= least else 'FAIL'}")
            if agree < least:
                fail(f"the {label} forward disagrees with the one process")
        log(f"  {where}: {time.perf_counter() - t0:.1f} s")
    if cards < 2:
        log("  NCCL SP runs were not possible here: one card "
            "(torch.cuda.device_count() == 1)")
    return runs


# ---- phase 22: the legacy models under TP, the per-path MHCA layout and
# --debug_nans ----

# The per-path layout (vectorize_paths False) at the published widths, all
# three paths and one block a stage: its "pallas" step (the rate-0 block
# of stage 2 as K5's sharded form on each path, stage 3's drop-path FFN
# as K9's hidden-sharded form) and its eval forward (K5's sharded form at
# 28² and 14²), both on the step's batch; MISSFormer's step (its blocks'
# FFNs sharded and plain, its bridge whole on K8, K2 and K11).
PATH = dict(vectorize_paths=False, num_path=(3, 3, 3))
PATH_MODES = (("paths bf16 pallas", dict(PATH, use_pallas_train=True,
                                         mhca_ffn_fold=True,
                                         drop_path_rate=0.1), BF16_LIMITS),)
PATH_EVALS = (("paths eval bf16", dict(PATH), 0.98),)
LEGACY_TP_MODES = (("missformer bf16", dict(model="missformer"),
                    BF16_LIMITS),)
# (B, s, C) of phase 22 (a): b=32 (the serving batch, logged) and
# the b=24 shapes phase 22 (b) launches at tp 2 (rows of the kernels
# line): K5's sharded form at 28² and 14² (the eval forward; the step's
# at 28²), K9's at 14² (the step's drop-path block).
K5_TP_SHAPES = ((BATCH, 28, 64), (BATCH, 14, 128), (TRAIN_BATCH, 28, 64),
                (TRAIN_BATCH, 14, 128))
K9_TP_SHAPES = ((BATCH, 28, 64), (BATCH, 14, 128), (TRAIN_BATCH, 14, 128))
K5_TP_OPS = ("mhca_block_tp", "mhca_block_tp_attn", "mhca_block_tp_fc1",
             "mhca_block_tp_fc2", "mixffn_tp_out")
K9_TP_OPS = ("mixffn_skip_tp", "mixffn_tp_fc2", "mixffn_skip_tp_out")


def _ops(names, kernel):
    """The operators `names` (kernel) or their plain versions, the
    operators' CPU implementations (_build.PLAIN_OPS), run on the card's
    tensors."""
    from transception_tpu_torch.ops.kernels import _build
    return [getattr(torch.ops.transception_torch, n).default if kernel
            else _build.PLAIN_OPS[n] for n in names]


def _k5_tp(a, s, tp, ops, fault=False):
    """K5's sharded form over tp ranks in one process: each rank's qkv
    columns (stages 1-2) gathered in rank order, stages 3-5 on the whole
    q|k|v, the FFN's sharded stages with the partial sums summed in rank
    order (ops: K5_TP_OPS' operators or plain versions). fault: each
    rank's hidden LN normalised by its own partial sums."""
    qkv_op, attn_op, fc1_op, fc2_op, out_op = ops
    (x, cpe_w, cpe_b, l1s, l1b, wqkv, bqkv, cws, cbs, wp, bp, l2s, l2b, w1,
     b1, dw, dwb, ls, lb, w2, b2) = a
    C, hid = x.shape[-1], w1.shape[0]
    nq, n = 3 * C // tp, hid // tp
    fronts = [qkv_op(x, cpe_w, cpe_b, l1s, l1b, wqkv[r * nq:(r + 1) * nq],
                     bqkv[r * nq:(r + 1) * nq], s, n, hid, 1e-6)
              for r in range(tp)]
    qkv = torch.cat([q for _, q in fronts], -1)
    x2 = attn_op(qkv, fronts[0][0], list(cws), list(cbs), wp, bp, s, 8)
    sh = [(w1[k], b1[k], dw[k], dwb[k], ls[k], lb[k], w2[:, k])
          for k in (slice(r * n, (r + 1) * n) for r in range(tp))]
    part = [fc1_op(x2, l2s, l2b, *q[:4], s, 1e-6, hid) for q in sh]
    st = sum(pt[1] for pt in part)
    pp = sum(fc2_op(h, *q[2:7], stp if fault else st, s, hid, 1e-5)
             for (h, stp), q in zip(part, sh))
    return out_op(pp, b2, x2)


def _k9_tp(a, s, tp, ops, fault=False):
    """K9's hidden-sharded form over tp ranks in one process, as _k5_tp's
    FFN (ops: K9_TP_OPS')."""
    fc1_op, fc2_op, out_op = ops
    x, w1, b1, dw, dwb, ls, lb, w2, b2 = a
    hid = w1.shape[0]
    n = hid // tp
    sh = [(w1[k], b1[k], dw[k], dwb[k], ls[k], lb[k], w2[:, k])
          for k in (slice(r * n, (r + 1) * n) for r in range(tp))]
    part = [fc1_op(x, *q[:4], s, hid) for q in sh]
    st = sum(pt[1] for pt in part)
    pp = sum(fc2_op(h, *q[2:7], stp if fault else st, s, hid, 1e-5)
             for (h, stp), q in zip(part, sh))
    return out_op(pp, b2, x.dtype)


def _k9_args(gen, B, s, C, dt):
    hid, N = 4 * C, s * s
    return (rand(gen, (B, N, C), dtype=dt), rand(gen, (hid, C), C ** -0.5),
            rand(gen, (hid,), 0.02), rand(gen, (hid, 1, 3, 3), 0.3),
            rand(gen, (hid,), 0.02), rand(gen, (hid,), 0.1, 1.0),
            rand(gen, (hid,), 0.1), rand(gen, (C, hid), hid ** -0.5),
            rand(gen, (C,), 0.5))


def tp_mhca_kernel_phase(measured):
    """Phase 22 (a). K5's sharded form (the per-path MHCA layout's block
    under the model axis: ops/kernels/mhca_block.py tp_*) and K9's
    hidden-sharded form (mixffn.py skip_tp_*) on the card, at tp 2 and 4
    simulated on one card (each rank's stages launched in turn, the qkv
    columns gathered and the partial sums summed in rank order), bf16 and
    fp32, at K5_TP_SHAPES and K9_TP_SHAPES: against the unsharded kernel
    (K5, K9) and against the sharded plain stages, within phase 3's limits
    (bf16 2% of max|plain|, fp32 1e-4; K5 on its branch); a planted fault
    each (the hidden LN's sums left out) must fail. Rank 0's stages timed
    (CUDA events, ms a launch) against the bound of its work (its qkv
    columns, the whole attention, its FFN shard). The tp 2 shapes of
    phase 22 (b) join `measured`; the others are logged."""
    from transception_tpu_torch.ops.kernels import mhca_block as mb
    from transception_tpu_torch.ops.kernels import mixffn as mf
    gen = torch.Generator().manual_seed(22)
    recorded = {(TRAIN_BATCH, 28, 64, "k5"), (TRAIN_BATCH, 14, 128, "k5"),
                (TRAIN_BATCH, 14, 128, "k9")}
    for dt in (torch.bfloat16, torch.float32):
        fp32 = dt == torch.float32
        es, tag = (4, " fp32") if fp32 else (2, "")
        tol = FP32_TOL if fp32 else 0.02
        peak = FP32_FLOPS if fp32 else BF16_FLOPS
        for kind, shapes in (("k5", K5_TP_SHAPES), ("k9", K9_TP_SHAPES)):
            for B, s, C in shapes:
                hid, N = 4 * C, s * s
                T = B * N
                if kind == "k5":
                    x, a, _ = _k5_args(gen, B, s, C, dt)
                    name, ops = mb.TP_NAME, K5_TP_OPS
                    run = functools.partial(_k5_tp, a, s)
                    with torch.no_grad():
                        whole = mb.mhca_block(*a, s=s, heads=8)
                    base = x
                else:
                    a = _k9_args(gen, B, s, C, dt)
                    name, ops = mf.SKIP_TP_NAME, K9_TP_OPS
                    run = functools.partial(_k9_tp, a, s)
                    with torch.no_grad():
                        whole = mf.mixffn_skip(*a, s=s)
                    base = None
                kops, pops = _ops(ops, True), _ops(ops, False)
                for tp in TP_SIZES:
                    hl, nq = hid // tp, 3 * C // tp
                    label = (f"({B},{N},{C}) hidden {hid}, tp {tp} ({hl} a "
                             f"rank" + (f", qkv {nq} of {3 * C}"
                                         if kind == "k5" else "") + f"){tag}")
                    with torch.no_grad():
                        key, got = _tallied(name, lambda: run(tp, kops))
                        want = run(tp, pops)
                        err, ok = err_check(f"{name} {label} vs sharded "
                                            f"plain", got, want, tol, base)
                        e2, ok2 = err_check(f"{name} {label} vs unsharded "
                                            f"kernel", got, whole, tol, base)
                        if not (ok and ok2):
                            fail(f"the sharded {name} disagrees")
                        bad = run(tp, pops, fault=True)
                        if err_check("  planted fault (the hidden LN's sums "
                                     "not summed)", bad, want, tol,
                                     base)[1]:
                            fail(f"{name}: the check does not see a fault")
                        # Rank 0's launch: its stages, the others' parts
                        # of the gathered q|k|v and the sums as inputs.
                        ms = _rank0_ms(kind, a, s, tp, kops)
                        pms = _rank0_ms(kind, a, s, tp, pops, iters=2)
                    w = (2 * C * hl + 9 * hl) * es + 2 * T * C * es \
                        + T * 8 * 2 + T * C * 4 * 2
                    f = 4 * T * C * hl + 18 * T * hl
                    if kind == "k5":
                        w += (nq * C + C * C) * es + T * 3 * C * es
                        f += T * (2 * C * nq + 2 * C * C + 4 * C * C // 8
                                  + 78 * C)
                    bms, by = bound_ms(w, f, peak)
                    log(f"    {name} {label}: rank 0's stages ms {ms:.4f} "
                        f"plain_ms {pms:.4f} bound_ms {bms:.4f} ({by}) per "
                        f"launch, library call none; "
                        f"{against(ms, bms, None)}")
                    if tp == TP_MAIN and not fp32 and \
                            (B, s, C, kind) in recorded:
                        record(measured, key, label, max(err, e2), ms, pms,
                               None, w, f, peak)
                del a, whole


def _rank0_ms(kind, a, s, tp, ops, iters=10):
    """CUDA-event ms of rank 0's stages of K5's sharded form (kind "k5":
    its qkv columns, the attention on the whole q|k|v, its FFN shard, the
    out stage) or K9's, with the other ranks' parts (gathered columns,
    summed partials) made once outside the clock."""
    if kind == "k5":
        qkv_op, attn_op, fc1_op, fc2_op, out_op = ops
        (x, cpe_w, cpe_b, l1s, l1b, wqkv, bqkv, cws, cbs, wp, bp, l2s, l2b,
         w1, b1, dw, dwb, ls, lb, w2, b2) = a
        C, hid = x.shape[-1], w1.shape[0]
        nq, n = 3 * C // tp, hid // tp
        q0 = (w1[:n], b1[:n], dw[:n], dwb[:n], ls[:n], lb[:n], w2[:, :n])
        x1, part = qkv_op(x, cpe_w, cpe_b, l1s, l1b, wqkv[:nq], bqkv[:nq],
                          s, n, hid, 1e-6)
        qkv = torch.cat([part] * tp, -1)
        x2 = attn_op(qkv, x1, list(cws), list(cbs), wp, bp, s, 8)
        h, st = fc1_op(x2, l2s, l2b, *q0[:4], s, 1e-6, hid)
        p = fc2_op(h, *q0[2:7], st, s, hid, 1e-5)

        def rank0():
            qkv_op(x, cpe_w, cpe_b, l1s, l1b, wqkv[:nq], bqkv[:nq], s, n,
                   hid, 1e-6)
            attn_op(qkv, x1, list(cws), list(cbs), wp, bp, s, 8)
            fc1_op(x2, l2s, l2b, *q0[:4], s, 1e-6, hid)
            fc2_op(h, *q0[2:7], st, s, hid, 1e-5)
            out_op(p, b2, x2)
    else:
        fc1_op, fc2_op, out_op = ops
        x, w1, b1, dw, dwb, ls, lb, w2, b2 = a
        hid = w1.shape[0]
        n = hid // tp
        q0 = (w1[:n], b1[:n], dw[:n], dwb[:n], ls[:n], lb[:n], w2[:, :n])
        h, st = fc1_op(x, *q0[:4], s, hid)
        p = fc2_op(h, *q0[2:7], st, s, hid, 1e-5)

        def rank0():
            fc1_op(x, *q0[:4], s, hid)
            fc2_op(h, *q0[2:7], st, s, hid, 1e-5)
            out_op(p, b2, x.dtype)
    return cuda_ms(rank0, iters=iters, warmup=1)


def paths_phase():
    """Phase 22 (b, c, d). (b) The per-path layout's tp=2 "pallas" step
    (PATH_MODES) and sharded eval forward (PATH_EVALS) at the published
    widths, all three paths and one block a stage, b=24: two spawned
    ranks share card 0 over gloo (as phase 20's), against the one-process
    step and forward of the same config (phase 9's limits; maps at least
    0.98 equal), launches exactly launches_per_step(cfg, tp=2) and
    launches_per_forward(cfg, tp=2): K5's sharded form 3 a step and 6 a
    forward, K9's 3 a step. (c) MISSFormer's tp=2 step (LEGACY_TP_MODES)
    the same way, its launches models.legacy.launches_per_step's. (d) A
    NaN planted in a weight of the card's model under --debug_nans
    (cli.common.nan_checks) raises FloatingPointError naming its module.
    Returns the runs' launches per shape key."""
    import shutil

    from transception_tpu_torch.cli.common import nan_checks
    from transception_tpu_torch.core.config import TransceptionConfig
    from transception_tpu_torch.data.device_synthetic import (
        DeviceSyntheticStream,
    )
    from transception_tpu_torch.models.transception import (
        MSTransception,
        launches_per_forward,
    )
    from transception_tpu_torch.parallel.mesh import spawn

    out = OUT_DIR / "paths"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    batch = DeviceSyntheticStream(TRAIN_BATCH, 224, 9, device="cuda").batch(0)
    img, lbl = batch["image"], batch["label"]
    steps = PATH_MODES + LEGACY_TP_MODES
    refs = {}
    for label, over, _ in steps:
        tr = _tp_trainer(over, out / "one")
        refs[label] = _dp_step(tr, img, lbl)
        del tr
        torch.cuda.empty_cache()
    evals = [e[0] for e in PATH_EVALS]
    one_eval = _sp_evals(img, out=out / "one_eval", labels=evals)
    t0 = time.perf_counter()
    where = "gloo, dp1 x tp2, every rank on card 0"
    wdir = out / "gloo_dp1_tp2"
    wdir.mkdir()
    spawn(_tp_rank, TP_MAIN, (str(wdir), "gloo", 1, TP_MAIN,
                              [m[0] for m in steps], evals))
    res = torch.load(wdir / "rank0.pt", weights_only=False)
    runs = []
    for label, _, lim in steps:
        r = res[label]
        ref, one_ms = refs[label]
        if r["counts"] != r["want"]:
            fail(f"{label} ({where}): launched {r['counts']}, want "
                 f"launches_per_step {r['want']}")
        runs.append((f"per {label} train step ({where}, rank 0)",
                     r["shapes"], 1))
        n = {k: v for k, v in r["counts"].items() if v}
        log(f"  {label} ({where}): launches = launches_per_step {n}; "
            f"{r['ms']:.1f} ms a step (CUDA events over {TP_TIME_STEPS} "
            f"steps; gloo sums through the host: not TP's speed), one "
            f"process {one_ms:.1f} ms")
        if not _compare_steps(f"{label} ({where}) vs one process",
                              r["step"], ref, lim=lim):
            fail(f"the tp {label} step disagrees with the one-process step")
    for label in evals:
        got, want = res["evals"][label], one_eval[label]
        cfg = TransceptionConfig(**dict(TP_DEPTH, **_mode(label)[0]))
        lpf = Counter(launches_per_forward(cfg, argmax=False, tp=TP_MAIN))
        lpf.update(launches_per_forward(cfg, argmax=True, tp=TP_MAIN))
        if got["counts"] != dict(lpf):
            fail(f"{label} ({where}): launched {got['counts']}, want "
                 f"launches_per_forward {dict(lpf)}")
        agree = float((got["maps"] == want["maps"]).float().mean())
        diff = float((got["logits"] - want["logits"]).abs().max())
        least = _mode(label)[1]
        log(f"  {label} ({where}) vs one process: class maps {agree:.6f} "
            f"equal (at least {least}), logits max |diff| {diff:.6g} (max "
            f"|logit| {float(want['logits'].abs().max()):.4g}), bit-equal "
            f"{torch.equal(got['logits'], want['logits'])}; launches = "
            f"launches_per_forward(cfg, tp={TP_MAIN}) x (logits + argmax) "
            f"(mhca_block_tp {got['counts']['mhca_block_tp']}) "
            f"{'ok' if agree >= least else 'FAIL'}")
        if agree < least:
            fail(f"the {label} forward disagrees with the one process")
        # K5's sharded form at the eval's shapes (its other kernels run
        # at shapes and counts of the earlier phases' sharded evals).
        runs.append((f"per {label} logits + argmax forwards ({where}, rank "
                     f"0), mhca_block_tp", {
                         k: v for k, v in got["shapes"].items()
                         if k[0] == "mhca_block_tp"}, 1))
    log(f"  {where}: {time.perf_counter() - t0:.1f} s")
    # (d) --debug_nans on the card.
    model = MSTransception(TransceptionConfig(**TP_DEPTH), "cuda")
    planted = "backbone.patch_embed_stage2.patch_embeds.0.patch_conv.dwconv"
    with torch.no_grad():
        model.get_submodule(planted).weight.view(-1)[0] = float("nan")
        try:
            with nan_checks(model):
                model(img[:2])
        except FloatingPointError as e:
            log(f"  --debug_nans: a NaN planted in {planted}.weight raised "
                f"FloatingPointError: {e}")
            if planted not in str(e):
                fail("--debug_nans named another module")
        else:
            fail("--debug_nans: the planted NaN did not raise")
    del model
    torch.cuda.empty_cache()
    return runs


def run_summary(what, tallies, per, measured):
    """Per kernel, the launches of one run (`tallies`, divided by `per`
    forwards or steps) and their summed kernel, plain, bound and library
    ms from the per-launch measurements of their shapes."""
    sums = {}
    for key, n in sorted(tallies.items()):
        m = measured[key]
        t = sums.setdefault(m["name"], [0, 0.0, 0.0, 0.0, 0.0])
        t[0] += n / per
        for i, k in enumerate(("ms", "plain_ms", "bound_ms"), 1):
            t[i] += n / per * m[k]
        if t[4] is not None and m["library_ms"] is not None:
            t[4] += n / per * m["library_ms"]
        else:
            t[4] = None
    for name, (n, ms, pms, bms, lms) in sums.items():
        lib = "none" if lms is None else f"{lms:.4f} ms"
        log(f"  {what}: {name} {n:g} launches, kernel {ms:.4f} ms, plain "
            f"{pms:.4f} ms, bound {bms:.4f} ms, library call {lib}")


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
    reports = {k: _build.build_log(k) for k in _build.KERNELS}
    (OUT_DIR / "chip_smoke_ptxas.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in reports.items()))
    # The bridge attention kernels (K3, K10, K8), the MixFFN forward's and
    # backward's stages (K2, K9, K11), the MHCA block's (K5), the
    # linear-attention stages of K1 and K6 and the expand body's K4 and K7
    # are built for registers alone: their ptxas report, and no spills.
    for lib in ("bridge_attention", "bridge_attention_bwd",
                "bridge_attention_folded", "mixffn", "mixffn_bwd",
                "mhca_block", "etb_attention", "linear_attention",
                "expand_head", "patch_expand"):
        if reports[lib] is None:
            fail(f"{lib}: no ptxas report")
        for fn, regs, st, ld, smem in ptxas_report(reports[lib]):
            log(f"  ptxas {lib}: {fn} {regs} registers, spill "
                f"stores {st} B, spill loads {ld} B, static smem {smem} B")
            if st or ld:
                fail(f"{lib}: {fn} spills registers")

    log("phase 3: kernels vs plain versions (bf16 and fp32, batch 32)")
    t0 = time.perf_counter()
    measured = kernel_phase()
    log(f"  phase 3: {time.perf_counter() - t0:.1f} s")

    log("phase 4-6: published model through predict_volume")
    t0 = time.perf_counter()
    (fwd_tallies, n_fwd), x = model_phase()
    log(f"  phases 4-7: {time.perf_counter() - t0:.1f} s")

    log(f"phase 5-7 (fp32): the published model at fp32, batch {BATCH}")
    t0 = time.perf_counter()
    fp32_tallies = fp32_model_phase(x)
    log(f"  phases 5-7 (fp32): {time.perf_counter() - t0:.1f} s")

    log(f"phase 8: train-step kernels vs plain versions (bf16, batch "
        f"{TRAIN_BATCH})")
    t0 = time.perf_counter()
    train_kernel_phase(measured)
    log(f"  phase 8: {time.perf_counter() - t0:.1f} s")

    log(f"phase 8 (fp32): train-step kernels vs plain versions (fp32, "
        f"batch {TRAIN_BATCH})")
    t0 = time.perf_counter()
    train_kernel_phase(measured, torch.float32)
    log(f"  phase 8 (fp32): {time.perf_counter() - t0:.1f} s")

    log(f"phase 9: the published train step, batch {TRAIN_BATCH}")
    t0 = time.perf_counter()
    step_tallies = train_phase()
    log(f"  phase 9: {time.perf_counter() - t0:.1f} s")

    log(f"phase 9 (fp32): the published train step at fp32, batch "
        f"{TRAIN_BATCH}")
    t0 = time.perf_counter()
    fp32_step_tallies = fp32_train_phase()
    log(f"  phase 9 (fp32): {time.perf_counter() - t0:.1f} s")

    log(f"phase 10: the fold grid, published model, batch {BATCH}")
    t0 = time.perf_counter()
    grid_tallies = fold_grid_phase(x)
    log(f"  phase 10: {time.perf_counter() - t0:.1f} s")

    log("phase 11: volume eval, published model, SyntheticVolumeDataset")
    t0 = time.perf_counter()
    vol_tallies, n_vol = volume_phase()
    log(f"  phase 11: {time.perf_counter() - t0:.1f} s")

    log("phase 12: the train CLI, published model, Synapse .npz slices")
    t0 = time.perf_counter()
    cli_runs = cli_phase()
    log(f"  phase 12: {time.perf_counter() - t0:.1f} s")

    log("phase 13: the ablation variants (4-stage, casa, sp, para; the IFF "
        "modes, token MLPs, no bridge)")
    t0 = time.perf_counter()
    variant_runs = variants_phase()
    log(f"  phase 13: {time.perf_counter() - t0:.1f} s")

    log(f"phase 14: data parallelism, published model, batch {TRAIN_BATCH}")
    t0 = time.perf_counter()
    dp_runs = dp_phase()
    log(f"  phase 14: {time.perf_counter() - t0:.1f} s")

    log("phase 15: the legacy models (transception, missformer, "
        "effmissformer, resinception, resinception_135)")
    t0 = time.perf_counter()
    legacy_runs = legacy_phase()
    log(f"  phase 15: {time.perf_counter() - t0:.1f} s")

    log("phase 16: ISIC 2018, published model at 2 classes")
    t0 = time.perf_counter()
    isic_runs = isic_phase()
    log(f"  phase 16: {time.perf_counter() - t0:.1f} s")

    log("phase 17: the serving export (torch.export, kernel operators)")
    t0 = time.perf_counter()
    export_phase()
    log(f"  phase 17: {time.perf_counter() - t0:.1f} s")

    log(f"phase 18: remat, published train step, batch {TRAIN_BATCH}")
    t0 = time.perf_counter()
    remat_runs = remat_phase()
    log(f"  phase 18: {time.perf_counter() - t0:.1f} s")

    log(f"phase 19: utils/profiling.py, published forward, batch {BATCH}")
    t0 = time.perf_counter()
    profiling_phase()
    log(f"  phase 19: {time.perf_counter() - t0:.1f} s")

    log(f"phase 20: the tensor-parallel axis (K2's and K11's "
        f"hidden-sharded forms; a tp={TP_MAIN} step, batch {TRAIN_BATCH})")
    t0 = time.perf_counter()
    tp_kernel_phase(measured)
    log(f"  phase 20 (a): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tp_runs = tp_phase()
    log(f"  phase 20 (b, c): {time.perf_counter() - t0:.1f} s")

    log(f"phase 21: the bridge's sequence sharding (K2's and K11's row "
        f"blocks, K3/K10/K8 on query rows; a tp={TP_MAIN} SP step, batch "
        f"{TRAIN_BATCH})")
    t0 = time.perf_counter()
    sp_kernel_phase(measured)
    log(f"  phase 21 (a, b): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sp_runs = sp_phase()
    log(f"  phase 21 (c): {time.perf_counter() - t0:.1f} s")

    log("phase 22: the legacy models under TP, the per-path MHCA layout "
        "(K5's and K9's sharded forms) and --debug_nans")
    t0 = time.perf_counter()
    tp_mhca_kernel_phase(measured)
    log(f"  phase 22 (a): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths_runs = paths_phase()
    log(f"  phase 22 (b, c, d): {time.perf_counter() - t0:.1f} s")

    # The main-path runs: phase 4's forwards, phase 9's flash and pallas
    # Trainer steps and fp32 steps, phase 10's forward per configuration,
    # phase 11's volume-eval forwards, phase 12's train CLI steps, evals
    # and throughput steps, phase 13's variant forwards, steps and CLI
    # runs, phase 14's data-parallel steps and sharded eval (world 1; the
    # ranks of a multi-card run are other processes), phase 15's legacy
    # forwards, steps and CLI runs, phases 16 and 18's runs, and rank 0's
    # steps of phases 20, 21 and 22 (the tp, SP, per-path and legacy tp
    # steps). Every launch's shape must have been measured in phase 3, 8,
    # 20 (a), 21 (a, b) or 22 (a), and every measured shape launched.
    runs = [("per forward, default config", fwd_tallies, n_fwd),
            ("per forward, fp32 default config", fp32_tallies, 1)] + [
        (f"per {mode} train step", t, n)
        for mode, (t, n) in step_tallies.items()] + [
        (f"per fp32 {mode} train step", t, 1)
        for mode, t in fp32_step_tallies.items()] + [
        (f"per forward, {name}", t, 1) for name, t in grid_tallies.items()
    ] + [("per forward, volume eval", vol_tallies, n_vol)] + cli_runs \
        + variant_runs + dp_runs + legacy_runs + isic_runs + remat_runs \
        + tp_runs + sp_runs + paths_runs
    total = Counter()
    for _, t, _ in runs:
        total.update(t)
    unmeasured = set(total) - set(measured)
    if unmeasured:
        fail(f"launched at shapes no phase measured: {sorted(unmeasured)}")
    log("kernel time per run (launches x the per-launch times of phases 3 "
        "and 8)")
    for what, t, per in runs:
        run_summary(what, t, per, measured)
    rows = []
    for key, m in measured.items():
        if not total[key]:
            fail(f"{m['name']} {m['shape']}: never launched on the main "
                 f"path")
        rows.append(dict(m, launches=total[key]))
    from transception_tpu_torch.ops import kernels
    idle = {name for name, _, _ in kernels.COUNTERS} - {
        r["name"] for r in rows}
    if idle:
        fail(f"kernels never launched on the main path: {sorted(idle)}")
    log(json.dumps({"kernels": rows}))
    log(gpu_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
