#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gaot_torch) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Four paths run through the port's entry points, and the fx and elasticity
recipes train through the port's CLI:
  - the fx main path: the Poisson-Gauss recipe (8192 nodes, 64x64 latent
    grid, config/examples/time_indep/poisson_gauss.json), batch 64;
  - the 3D flagship of scripts/train_demo.py::run_3d: 32768 nodes in
    [-1, 1]^3, a 64^3 latent grid, kNN graphs (k = 8), a UViT at patch 4
    (S = 4096 tokens) with 8 heads of dim 24, batch 4;
  - the long-sequence path: the same model at patch 2 (S = 32768), batch 1;
  - the vx flagship of bench.py::build_vx_workload: a mesh per sample, 16
    samples of 8192 nodes each in [-1, 1]^2, the 64x64 grid, degree-bucketed
    encoder and decoder with in-degree-grouped transpose graphs, the fx
    path's UViT, batch 16.

Phases (any failure exits nonzero; no phase carries on past its own
failure):
  0. the card: torch.cuda must be available; prints nvidia-smi's name and
     power limit; TF32 off for fp32 products.
  1. build: compiles every hand-written kernel (gaot_torch/csrc/*.cu) with
     one nvcc per source, all at once; logs, from nvcc's -Xptxas -v, the
     registers, shared memory and spills of the bf16 flash forward and
     backward, the multiply-reduces and the SwiGLU kernels and of every kernel
     that spills; fails if a bf16 SwiGLU kernel spills.
  1b. widths: the flash forward (with and without the LSE) and backward at
     every head dim from 8 to 128 and at 136, 256, 1024 (and 8192 at
     S = 128), bf16 and fp32, and the SwiGLU forward and backward at
     M = 128, 384, 512, 640, 768, 896, 1024, (4096, F 896) and (128,
     F 29056) in bf16 and M = 256, 640 in fp32, each against its plain
     version on the card at a small shape.
  2. per-kernel checks at each path's shapes, forward and backward kernels:
     each kernel against its plain PyTorch version on the card (bf16 and
     fp32), with CUDA-event timings of the kernel, the plain version and one
     PyTorch library call computing the same function (a yardstick only),
     and the least time the card could take (bound_ms). The multiply-reduces,
     which read their neighbour rows by index, run on each path's own graphs
     (every degree bucket, in-degree group and transpose graph of a step),
     timed also beside the parent's pair (the row gather, then the
     pre-gathered kernel) and the library pair (index_select, then einsum);
     two calls of each must give the same bits (on the vx path, b = 1 and
     C = 64, on the batch's graphs flattened over its samples: every
     degree bucket, masked, the reorder of the bucketed rows to query order
     and its gradient, and every in-degree group). The flash backward
     is checked once per TPU regime it replaces, at the S its path runs:
     1024 (monolithic), 4096 (q-tiled) and 32768 (the two-kernel long
     backward, which serves S > 4096; plain versions one head at a time),
     and at S = 8192 besides; two backward calls on the same inputs must
     give the same bits.
  3. the forward of the main path, the flagship and the vx flagship at full width with
     seeded random weights: at a small batch the kernel route on the card
     against the plain route on the CPU (fp32 and bf16; the flagship's fp32
     also on an anisotropic lattice), then the path's batch in bf16 with
     the launch counters read around one forward, its timing, and a
     torch.profiler breakdown of its device time by kernel.
  4. the training step (forward, masked MSE, backward through the kernels'
     gradients, AdamW with the 'mix' schedule) of the same paths, checked
     the same way (the loss and every parameter's gradient; fp32 once more
     with the geometric embedding's features fed identically to both
     sides, under a bound ten times tighter), then at the
     path's batch in bf16 with the launch counters read around one step, a
     few more steps on one batch, the step timing and its torch.profiler
     breakdown; the long-sequence path's step is driven the same way,
     without the check. No forward or step profile may hold PyTorch's row
     gather (vectorized_gather_kernel).
  5. the trainer: the fx recipe (the example config read from disk, its
     sizes, paths and, for run A, compute dtype changed) trained through the
     port's CLI on synthetic Poisson-Gauss-shaped data written from seed 0
     (tests/synthetic.py's layout, 8192 nodes), train/val/test 512 / 64 /
     128 samples, 6 epochs, validation every 2. Run A (bf16) through
     gaot_torch.cli.main in this process, under a device-only profiler: its
     launch counts must equal the training step's table times the training
     steps plus the forward's times the evaluation batches, its routes the
     kernels, its loss must fall, its metric be finite, its checkpoint, loss
     record and CSV row exist, and PyTorch's row gather run only for the
     loader's batch selects (two a batch), none in the model. Run B resumes run A's
     checkpoint through `python -m gaot_torch.cli -c` in a subprocess: the
     checkpoint's update count goes from 48 to 96 and its first loss is
     below run A's. Run C is the example's fp32: its loss falls and no
     SwiGLU kernel launches.
  5b. the vx trainer: the elasticity recipe (config/examples/time_indep/
     elasticity.json read from disk, a mesh per sample) trained through
     gaot_torch.cli.main on synthetic data at the Elasticity layout
     (tests/torch_synthetic.py: 972 points a sample, one c and one u
     channel, seed 0), batch 32, train/val/test 256 / 32 / 64 samples, 6
     epochs, in the example's own fp32 (no SwiGLU launch), under a
     device-only profiler: its launches must equal
     the step's and forward's tables (derived from the graphs the trainer
     builds) times its steps and evaluation batches, its routes the
     kernels, its loss fall, its metric be finite, its checkpoint, loss
     record and CSV row exist, and PyTorch's row gather run only for the
     loader's batch selects (one per buffer on the card a batch), none in
     the model.
  6. prints one JSON line listing every kernel of the four paths (the fx
     main path's launches are those of the trainer's run A; the vx
     entries' those of the vx flagship's training step and forward).
The last line is {"ok": true, "device": {...}}.
"""
import copy
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(HERE, "config", "examples", "time_indep", "poisson_gauss.json")

# Published H100 SXM peaks (NVIDIA data sheet, dense): device memory rate,
# bf16 tensor-core rate, fp32 rate outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
# exp2 on the special-function units: 16 results per clock per SM at compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput), 132 SMs at the 1.98 GHz boost clock of the H100 SXM data sheet.
PEAK_EXP2 = 16 * 132 * 1.98e9

NUM_NODES, LATENT, BATCH, SEQ = 8192, (64, 64), 64, 1024
STEPS_PER_EPOCH = 2048 // BATCH     # the config's train_size / batch_size

# Launches of each kernel in one batch-64 forward (evaluation) and in one
# training step. The encoder graph is bucketed (4 degree buckets, 4
# in-degree groups), the decoder dense with a flat transpose graph: the
# forward reduces once per bucket and once for the dense graph, and once
# more to put the bucketed rows back in query order (6); the step adds d_f
# per in-degree group and for the transpose graph (5) and that reorder's
# gradient (1); d_coef once per bucket and for the dense graph (5).
FORWARD_LAUNCHES = {"multiply_reduce_k": 6, "flash_attention_fwd": 3,
                    "fused_ffn_fwd": 3}
TRAIN_LAUNCHES = {"multiply_reduce_k": 12, "multiply_reduce_b": 5,
                  "flash_attention_fwd_lse": 3, "flash_attention_bwd": 3,
                  "fused_ffn_fwd": 3, "fused_ffn_bwd": 3}

# The 3D flagship: the model and optimizer config of
# scripts/train_demo.py:174-199 (run_3d), copied; its epochs and train size
# from the README's run of it (README.md:257: `train_demo.py 6 32768 48 3d`).
NODES_3D, LATENT_3D, BATCH_3D, SEQ_3D = 32768, (64, 64, 64), 4, 4096
STEPS_PER_EPOCH_3D = 48 // BATCH_3D
CONFIG_3D = {
    "model": {
        "latent_tokens_size": list(LATENT_3D),
        "args": {
            "magno": {"coord_dim": 3, "radius": 0.05, "hidden_size": 32,
                      "mlp_layers": 2, "lifting_channels": 16,
                      "neighbor_strategy": "knn", "max_neighbors": 8},
            "transformer": {"patch_size": 4, "hidden_size": 192,
                            "num_layers": 3},
        },
    },
    "optimizer": {
        "name": "adamw",
        "args": {"lr": 8e-4, "weight_decay": 1e-5, "epoch": 6,
                 "eval_every_eps": 2, "scheduler": "mix", "max_lr": 1e-3,
                 "min_lr": 1e-4, "final_lr": 5e-5},
    },
}
# Launches derived from the kNN graphs: k = 8 pads to K = 8 < 12, so both
# graphs keep the dense layout with a flat transpose graph (no degree
# buckets). The forward reduces once per graph (2); the step adds d_f over
# each transpose graph (2) and d_coef of each graph (2). One flash call per
# UViT layer (3). The SwiGLU width M = 192 fails the JAX package's gate
# (M % 128), so the FFN takes the plain three products: no SwiGLU launch.
FORWARD_LAUNCHES_3D = {"multiply_reduce_k": 2, "flash_attention_fwd": 3}
TRAIN_LAUNCHES_3D = {"multiply_reduce_k": 4, "multiply_reduce_b": 2,
                     "flash_attention_fwd_lse": 3, "flash_attention_bwd": 3}
# The long-sequence path: the flagship at patch 2, S = 32^3 = 32768 tokens
# (the regime gaot_tpu/ops/pallas/flash_attention.py:301-302 names), batch
# 1, on the flagship's graphs; same launches per step.
PATCH_LONG, BATCH_LONG, SEQ_LONG = 2, 1, 32768
# The flagship's fp32 card-vs-CPU checks again on a lattice with another
# spacing on each axis (that of tests/test_torch_3d.py). On the cubic
# lattice most kNN neighbourhoods of a node are the 8 corners of its cell,
# whose covariance has one eigenvalue three times over; on this one they
# are not.
AXIS_SCALE_3D = (1.0, 0.85, 0.7)

# The vx flagship of bench.py::build_vx_workload (bench.py:168-298): 16
# samples a batch, 8192 nodes a sample in [-1, 1]^2 with its own
# coordinates (Morton-ordered), the 64x64 latent grid, radius 0.033,
# degree-bucketed encoder and decoder with in-degree-grouped transpose
# graphs, MAGNO hidden 64 with 3 MLP layers and lifting 64, the UViT of the
# fx path (3 layers, hidden 256, 8 heads of dim 32, patch 2: S = 1024,
# SwiGLU 1024), bf16, AdamW with 'mix'. One batch of samples is built.
VX_NODES, VX_BATCH, VX_CHECK_BATCH = 8192, 16, 2
CONFIG_VX = {
    "model": {
        "latent_tokens_size": list(LATENT),
        "args": {
            "magno": {"coord_dim": 2, "radius": 0.033, "hidden_size": 64,
                      "mlp_layers": 3, "lifting_channels": 64},
            "transformer": {"patch_size": 2, "hidden_size": 256, "num_layers": 3},
        },
    },
    "optimizer": {"name": "adamw",
                  "args": {"lr": 8e-4, "weight_decay": 1e-5, "epoch": 1000}},
}

SOURCES = {   # kernel: (source, the TPU kernel's pallas_call it replaces)
    "multiply_reduce_k": ("gaot_torch/csrc/multiply_reduce.cu",
                          "gaot_tpu/ops/pallas/multiply_reduce.py:105"),
    "multiply_reduce_b": ("gaot_torch/csrc/multiply_reduce.cu",
                          "gaot_tpu/ops/pallas/multiply_reduce.py:146"),
    "flash_attention_fwd": ("gaot_torch/csrc/flash_attention.cu",
                            "gaot_tpu/ops/pallas/flash_attention.py:495"),
    "flash_attention_fwd_lse": ("gaot_torch/csrc/flash_attention.cu",
                                "gaot_tpu/ops/pallas/flash_attention.py:484"),
    "flash_attention_bwd": ("gaot_torch/csrc/flash_attention_bwd.cu",
                            "gaot_tpu/ops/pallas/flash_attention.py:416"),
    "flash_attention_bwd_tiled": ("gaot_torch/csrc/flash_attention_bwd.cu",
                                  "gaot_tpu/ops/pallas/flash_attention.py:439"),
    "flash_attention_bwd_long": ("gaot_torch/csrc/flash_attention_bwd.cu",
                                 "gaot_tpu/ops/pallas/flash_attention.py:180,199"),
    "fused_ffn_fwd": ("gaot_torch/csrc/fused_ffn.cu",
                      "gaot_tpu/ops/pallas/fused_ffn.py:136"),
    "fused_ffn_bwd": ("gaot_torch/csrc/fused_ffn.cu",
                      "gaot_tpu/ops/pallas/fused_ffn.py:174"),
}


class Path(NamedTuple):
    """One path the script drives: its config, host graphs and batches."""

    name: str
    cfg: object                 # GAOTConfig (model and optimizer)
    coords: object              # [N, d] float32
    lat: object                 # [Q, d] float32
    enc: list
    dec: list
    seq: int                    # UViT tokens
    check_batch: int            # card vs CPU plain route (0: no check)
    check_dtypes: tuple         # of the check: "fp32", "bf16"
    batch: int                  # the path's batch, driven in bf16 (0: not driven)
    steps_per_epoch: int
    forward_launches: dict
    train_launches: dict
    vx: object = None           # vx: the split's host buffers (a mesh per sample)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """CUDA-event time of one call: ``iters`` calls issued back to back
    after warm-up, over their count. Timing one call between two events
    would add the host's time to issue it to the kernel's, most of the time
    of a reduce of a few MB (kernel_ab.py times both ways)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10) -> float:
    """Device time per call: the self device time of every kernel that
    ``iters`` calls ran (torch.profiler), over their count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    if us <= 0:
        fail("the profiler saw no device time")
    return us / iters / 1e3


def bound_ms(nbytes: float, ops: float, peak_ops: float, exps: float = 0.0):
    """Least time the card could take: the larger of the bytes over the
    memory rate, the products' operations over their unit's peak rate and
    the exponentials over the special-function rate. Returns the ms, "bytes"
    or "operations", and the term that binds."""
    terms = {"bytes": nbytes / PEAK_BYTES, "products": ops / peak_ops,
             "exp2": exps / PEAK_EXP2}
    term = max(terms, key=terms.get)
    return terms[term] * 1e3, "bytes" if term == "bytes" else "operations", term


def compare(name, got, want, rtol, atol):
    """max |got - want| must stay within atol + rtol·|want| everywhere."""
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} or non-finite")
    diff = (got - want).abs()
    err = float(diff.max())
    worst = float((diff - rtol * want.abs()).max())
    ok = worst <= atol
    log(f"  {name}: max_abs_err={err:.3e} (tolerance atol {atol:g} + rtol "
        f"{rtol:g}·|ref|) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def compare_grad(name, got, want, rel):
    """A gradient: max |got - want| within ``rel`` of its largest entry
    (small entries are sums that cancel)."""
    return compare(name, got, want, 0.0, rel * float(want.float().abs().max()))


def phase_card():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]   # name, power limit
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


# The kernels whose ptxas report the build logs, beside that of every kernel
# that spills: the bf16 flash forward and backward, the multiply-reduces and
# the SwiGLU kernels; the bf16 SwiGLU kernels (the forward and backward rows fused at
# M = 128 and 256, the producer and the GEMM that serve every other width)
# may not spill.
PTXAS_LOGGED = ("flash_fwd_bf16", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16",
                "mulred_k_kernel", "mulred_b_kernel", "ffn_")
NO_SPILL = ("ffn_fwd_fused", "ffn_bwd_rows", "ffn_gemm", "ffn_produce")


def phase_build():
    from gaot_torch.ops.cuda import build

    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f}s wall "
        + " ".join(f"{k}={v:.1f}s" for k, v in secs.items()))
    # nvcc -Xptxas -v, per entry function (mangled name): its spills, its
    # registers and static shared memory (the bf16 flash kernels and the
    # SwiGLU kernels take theirs dynamically).
    for lib, out in build.ptxas_info.items():
        if "C7515" in out:   # ptxas inserted waits between a kernel's wgmmas
            log(f"  ptxas {lib}: {out.count('C7515')} kernels with serialised wgmma (C7515)")
        for entry in out.split("Compiling entry function ")[1:]:
            name = entry.split("'")[1]
            if not (any(k in name for k in PTXAS_LOGGED)
                    or re.search(r"[1-9]\d* bytes spill", entry)):
                continue
            facts = [ln.split(":", 1)[-1].strip() for ln in entry.splitlines()[1:]
                     if "spill" in ln or "registers" in ln]
            log(f"  ptxas {lib}: {name}: " + "; ".join(facts))
            if any(k in name for k in NO_SPILL) and re.search(r"[1-9]\d* bytes spill", entry):
                fail(f"{name} spills registers")


def phase_widths(rnd):
    """The widths the kernels take beyond the paths' own, against their
    plain versions at the tolerances of the per-kernel checks: the flash
    forward (with and without the LSE) and backward at every templated head
    dim and at 136, 256, 1024 and, at S = 128, 8192 (the route with D at
    run time); the SwiGLU forward and backward at the tuned widths besides
    256, at widths of the general route (640-1024, M 4096 with F 896, F
    29056 at M 128), in bf16, and in fp32 at M = 256 and 640."""
    import torch

    from gaot_torch.ops.cuda import flash_attention as fa
    from gaot_torch.ops.cuda import fused_ffn as ff

    def flash(b, s, h, hkv, d, dtype):
        bf16 = dtype == torch.bfloat16
        name = f"D={d} S={s} {str(dtype)[6:]}"
        tol = (1e-2, 2e-3) if bf16 else (1e-4, 1e-5)
        qkv = rnd(b, s, h + 2 * hkv, d).to(dtype)
        q, k, v = qkv[:, :, :h], qkv[:, :, h:h + hkv], qkv[:, :, h + hkv:]
        compare(f"widths flash fwd {name}", fa.flash_attention(q, k, v),
                fa.attention_plain(q, k, v), *tol)
        out, lse = fa.flash_attention_lse(q, k, v)
        want_out, want_lse = fa.attention_plain(q, k, v, with_lse=True)
        compare(f"widths flash fwd+LSE {name} out", out, want_out, *tol)
        compare(f"widths flash fwd+LSE {name} lse", lse, want_lse, 1e-5, 1e-4)
        dout = rnd(b, s, h, d).to(dtype)
        got = fa.flash_attention_bwd(q, k, v, out, dout, lse)
        want = fa.attention_bwd_plain(q, k, v, out, dout)
        for n, g, wt in zip("qkv", got, want):
            compare_grad(f"widths flash bwd {name} d{n}", g, wt, 3e-2 if bf16 else 1e-4)

    b, s, h, hkv = 2, 257, 6, 3          # ragged S, GQA 6:3
    wide = (136, 256, 1024)
    log(f"widths: flash attention at head dims {fa.TEMPLATED_HEAD_DIMS[0]}.."
        f"{fa.TEMPLATED_HEAD_DIMS[-1]} and {wide}, B={b} S={s} H={h} Hkv={hkv}, "
        f"and D=8192 at B=1 S=128 H=2 Hkv=1:")
    for d in fa.TEMPLATED_HEAD_DIMS + wide:
        for dtype in (torch.bfloat16, torch.float32):
            flash(b, s, h, hkv, d, dtype)
    for dtype in (torch.bfloat16, torch.float32):
        flash(1, 128, 2, 1, 8192, dtype)
    # The route with D at run time, timed at two head dims (bf16, B=1, H=4,
    # S=4096) beside SDPA and its autograd; its bound counts the work the
    # function needs, not the scores the route recomputes per 128 columns.
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for d in (256, 1024):
        bb, ss, hh = 1, 4096, 4
        qkv = rnd(bb, ss, 3, hh, d).bfloat16()
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out, lse = fa.flash_attention_lse(q, k, v)
        dout = rnd(bb, ss, hh, d).bfloat16()
        ops, exps = 4.0 * bb * hh * ss * ss * d, float(bb * hh * ss * ss)
        bnd = bound_ms(4 * bb * ss * hh * d * 2, ops, PEAK_BF16, exps)
        bnd_b = bound_ms(8 * bb * ss * hh * d * 2, 2.5 * ops, PEAK_BF16, exps)
        t_f = time_ms(lambda: fa.flash_attention(q, k, v), iters=3, warmup=1)
        t_b = time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, dout, lse), iters=3,
                      warmup=1)
        leaves = [t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v)]
        o_l = sdpa(*leaves)
        g_l = dout.transpose(1, 2).contiguous()
        t_lf = time_ms(lambda: sdpa(*leaves), iters=3, warmup=1)
        t_lb = time_ms(lambda: torch.autograd.grad(o_l, leaves, g_l, retain_graph=True),
                       iters=3, warmup=1)
        log(f"    wide flash D={d} B={bb} S={ss} H={hh} bf16: fwd kernel_ms={t_f:.4f} "
            f"(SDPA {t_lf:.4f}, bound {bnd[0]:.4f}); bwd kernel_ms={t_b:.4f} "
            f"(SDPA autograd {t_lb:.4f}, bound {bnd_b[0]:.4f})")
        del qkv, q, k, v, out, lse, dout, leaves, o_l, g_l

    r = 200
    cases = [(m, 256, torch.bfloat16) for m in (128, 384, 512, 640, 768, 896, 1024)]
    cases += [(4096, 896, torch.bfloat16), (128, 29056, torch.bfloat16),
              (256, 256, torch.float32), (640, 256, torch.float32)]
    log(f"widths: fused SwiGLU, R={r}, (M, F, dtype) in "
        f"{[(m, f, str(dt)[6:]) for m, f, dt in cases]}:")
    for m, f, dtype in cases:
        bf16 = dtype == torch.bfloat16
        name = f"M={m} F={f} {str(dtype)[6:]}"
        x = rnd(r, m).to(dtype)
        w1 = (rnd(f, m) / m ** 0.5).to(dtype)
        w3 = (rnd(f, m) / m ** 0.5).to(dtype)
        w2 = (rnd(m, f) / f ** 0.5).to(dtype)
        # bf16: one bf16 ulp of the output; fp32: sums in other orders.
        compare(f"widths fused_ffn fwd {name}", ff.fused_ffn(x, w1, w3, w2),
                ff.fused_ffn_plain(x, w1, w3, w2), *((1e-2, 1e-2) if bf16 else (1e-4, 1e-5)))
        dout = rnd(r, m).to(dtype)
        got = ff.fused_ffn_bwd(x, w1, w3, w2, dout)
        want = ff.fused_ffn_bwd_plain(x, w1, w3, w2, dout)
        for n, g, wt in zip(("dx", "dw1", "dw3", "dw2"), got, want):
            compare_grad(f"widths fused_ffn bwd {name} {n}", g, wt, 2e-2 if bf16 else 1e-4)
    torch.cuda.synchronize()


def _lattice(shape):
    import numpy as np

    axes = [np.linspace(-1, 1, n) for n in shape]
    lat = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, len(shape))
    return lat.astype(np.float32)


def _host_graphs(cfg, num_nodes, latent, what, axis_scale=None):
    """Seeded nodes uniform in [-1, 1]^d, the latent lattice (each axis
    times ``axis_scale`` where given) and the host graphs from the port's
    own builder, configured by the model's MAGNO config; logs the build
    time."""
    import numpy as np

    from gaot_torch.data.graph_builder import GraphBuilder

    magno = cfg.model.args.magno
    coords = np.random.default_rng(0).uniform(
        -1, 1, (num_nodes, len(latent))).astype(np.float32)
    lat = _lattice(latent)
    if axis_scale is not None:
        lat = lat * np.asarray(axis_scale, np.float32)
    builder = GraphBuilder.from_magno_config(magno)
    t0 = time.perf_counter()
    enc, dec = builder.build_fx_graphs(coords, lat, magno.radius, magno.scales)
    log(f"{what} graphs: strategy={builder.strategy} search={builder.search_method} "
        f"host_build_s={time.perf_counter() - t0:.2f}")
    return coords, lat, enc, dec


def _host_graphs_vx(cfg, what):
    """The vx flagship's split: VX_BATCH samples of VX_NODES seeded nodes
    uniform in [-1, 1]^2, each its own, the latent lattice, and the split's
    graphs from the port's builder as the trainer builds them (Morton
    order, shared degree buckets, in-degree-grouped transpose graphs); logs
    the build time and the layout. Returns (coords [S, N_pad, 2], lattice,
    encoder, decoder, the split's buffers)."""
    import numpy as np

    from gaot_torch.data.graph_builder import GraphBuilder, vx_graph_buffers

    magno = cfg.model.args.magno
    x = np.random.default_rng(0).uniform(-1, 1, (VX_BATCH, VX_NODES, 2)).astype(np.float32)
    lat = _lattice(LATENT)
    builder = GraphBuilder.from_magno_config(magno)
    t0 = time.perf_counter()
    split = builder.build_all_vx_graphs(
        {"test": {"x": x}}, lat, magno.radius, magno.scales, build_train=False,
        with_transpose=True, bucketing=True)["test"]
    bufs = vx_graph_buffers(split)
    bufs.pop("node_perm")

    def fmt(g):
        if hasattr(g, "bucket_ks"):
            return " ".join(f"{r}x{k}" for r, k in zip(g.bucket_rows, g.bucket_ks))
        return f"dense K={g.indices.shape[-1]}"
    log(f"{what} graphs: {VX_BATCH} samples x {VX_NODES} nodes (N_pad "
        f"{split.coords.shape[1]}), search={builder.search_method} host_build_s="
        f"{time.perf_counter() - t0:.2f}; encoder buckets {fmt(split.encoder[0])}; "
        f"decoder buckets {fmt(split.decoder[0])}")
    return split.coords, lat, split.encoder, split.decoder, bufs


def _vx_tables(graphs, layers: int, ffn: bool) -> tuple:
    """The launches of one vx forward and one training step, from a batch's
    graphs (FxGraphs; per scale and side a FlatGraph with its in-degree
    grouped transpose graph): the forward reduces once per bucket and,
    where the rows were bucketed, once more to put them back in query
    order; the step adds d_f once per in-degree group, that reorder's
    gradient, and d_coef once per bucket. One flash call per UViT layer;
    the SwiGLU where ``ffn``."""
    fwd_k = step_k = step_b = 0
    for g in graphs.encoder + graphs.decoder:
        nb, perm = len(g.buckets), int(g.perm is not None)
        fwd_k += nb + perm
        step_k += nb + len(g.tgraph.groups) + 2 * perm
        step_b += nb
    fwd = {"multiply_reduce_k": fwd_k, "flash_attention_fwd": layers}
    train = {"multiply_reduce_k": step_k, "multiply_reduce_b": step_b,
             "flash_attention_fwd_lse": layers, "flash_attention_bwd": layers}
    if ffn:
        fwd["fused_ffn_fwd"] = layers
        train.update(fused_ffn_fwd=layers, fused_ffn_bwd=layers)
    return fwd, train


def _row(err, ms, plain_ms, lib_ms, bound, per, dtype="bf16", **extra):
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound[0], bound_by=bound[1], per=per, dtype=dtype, **extra)


def _pair_ms(fn_k, fn_parent, fn_lib, fn_plain):
    """The four times of one call: the kernel, the parent's pair (a row
    gather, then the pre-gathered kernel), the library pair (index_select,
    then einsum) and the plain version."""
    return {key: time_ms(fn) for key, fn in (("ms", fn_k), ("parent_pair_ms", fn_parent),
                                             ("library_ms", fn_lib), ("plain_ms", fn_plain))}


def _distinct_rows(idx, mask=None) -> int:
    import torch

    return int(torch.unique(idx if mask is None else idx[mask]).numel())


def check_multiply_reduce(rnd, b, c, cases, what):
    """The index-reading multiply_reduce_k (the forward over each graph the
    step reduces, d_f over each transpose graph or in-degree group) and
    multiply_reduce_b (d_coef of each forward) on the path's real graphs
    and indices, lanes W = b·C, against their plain versions (bf16 and
    fp32); two calls of each must give the same bits. In bf16, each is
    timed beside the parent's pair (the row gather, then the pre-gathered
    kernel), the library pair (index_select, then einsum) and the plain
    version; the bound counts the bytes the fused function must move and
    the products it makes, over the slots it reads (a masked slot loads
    nothing): coefficients (valid slots × C; C for a coefficient of one
    broadcast over every slot, as the row reorders take it), indices of
    those slots and the masks, the output, and each distinct source row
    once. multiply_reduce_b reads every slot."""
    import torch

    from gaot_torch.ops.cuda import multiply_reduce as mr

    w = b * c
    keys = ("ms", "parent_pair_ms", "library_ms", "plain_ms", "bytes", "ops", "err")
    agg = {name: dict.fromkeys(keys, 0.0) for name in ("multiply_reduce_k",
                                                        "multiply_reduce_b")}

    def record(name, label, err, times=None, nbytes=0.0, ops=0.0):
        a = agg[name]
        a["err"] = max(a["err"], err)
        if times is None:
            return
        for key, val in times.items():
            a[key] += val
        a["bytes"] += nbytes
        a["ops"] += ops
        bnd = bound_ms(nbytes, ops, PEAK_FP32)[0]
        log(f"    {label}: kernel_ms={times['ms']:.4f} parent_pair_ms="
            f"{times['parent_pair_ms']:.4f} library_ms={times['library_ms']:.4f} "
            f"plain_ms={times['plain_ms']:.4f} bound_ms={bnd:.4f} "
            f"({nbytes / times['ms'] / 1e6:.0f} GB/s)")

    def same_bits(label, fn):
        if not torch.equal(fn(), fn()):
            fail(f"{label}: two calls on the same inputs differ")

    log(f"multiply_reduce_k / multiply_reduce_b ({what}), W = {b}·{c}, on the "
        f"path's graphs:")
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        size = 2 if bf16 else 4
        dt = str(dtype)[6:]
        for case in cases["forward"]:
            idx, n_src = case["idx"], case["n_src"]
            # vx: masked slots load nothing. The row reorders have no d_coef
            # and take a coefficient of one, broadcast, as the model does
            # (gaot_torch/ops/gather_apply.py::_take_rows).
            mask, d_coef = case.get("mask"), case.get("d_coef", True)
            q, k = idx.shape
            src, dout = rnd(n_src, w).to(dtype), rnd(q, w).to(dtype)
            coef = (src.new_ones(c).expand(q, k, c) if case.get("ones")
                    else rnd(q, k, c).to(dtype))
            label = f"{case['name']} [{q}, {k}] {dt}"
            # fp32: K-term sums in another order, whose rounding grows with K.
            tol = (8e-3, 1e-2) if bf16 else (1e-5, 1e-5 * max(1.0, k / 16))
            kern = lambda: mr.gather_multiply_reduce_k(src, idx, coef, b, mask=mask)
            err = compare(f"mulred_k fwd {label}", kern(),
                          mr.gather_multiply_reduce_k_plain(src, idx, coef, b,
                                                            mask=mask), *tol)
            same_bits(f"mulred_k fwd {label}", kern)
            if d_coef:
                kern_b = lambda: mr.gather_multiply_reduce_b(src, idx, dout, b)
                # fp32: b-term sums in another order.
                tol_b = (8e-3, 1e-2) if bf16 else (2e-5, 5e-5)
                err_b = compare(f"mulred_b {label}", kern_b(),
                                mr.gather_multiply_reduce_b_plain(src, idx, dout, b),
                                *tol_b)
                same_bits(f"mulred_b {label}", kern_b)
            if not bf16:
                record("multiply_reduce_k", label, err)
                if d_coef:
                    record("multiply_reduce_b", label, err_b)
                continue
            idx_t = idx.t().reshape(-1)
            # The parent's pre-gathered kernel takes a dense coefficient.
            c4 = coef.contiguous()
            coef_km = c4.transpose(0, 1)
            gath_km = lambda: src.index_select(0, idx_t).view(k, q, w)
            rows = lambda: src.index_select(0, idx.reshape(-1)).view(q, k, b, c)
            d3 = dout.view(q, b, c)
            isz = idx.element_size()
            # The kernel reads the mask, then the index, the coefficient and
            # the row of each valid slot only.
            valid = int(mask.sum()) if mask is not None else q * k
            nbytes = (((c if case.get("ones") else valid * c) + q * w
                       + _distinct_rows(idx, mask) * w) * size
                      + valid * isz + (q * k if mask is not None else 0))
            times = _pair_ms(kern, lambda: mr.multiply_reduce_k(coef_km, gath_km(), b),
                             lambda: torch.einsum("qkc,qkbc->qbc", c4, rows()),
                             lambda: mr.gather_multiply_reduce_k_plain(src, idx, coef, b,
                                                                       mask=mask))
            record("multiply_reduce_k", f"fwd {label}", err, times, nbytes,
                   2.0 * valid * w)
            if not d_coef:
                continue
            times = _pair_ms(kern_b, lambda: mr.multiply_reduce_b(gath_km(), dout, b),
                             lambda: torch.einsum("qkbc,qbc->qkc", rows(), d3),
                             lambda: mr.gather_multiply_reduce_b_plain(src, idx, dout, b))
            record("multiply_reduce_b", f"d_coef {label}", err_b, times,
                   (q * w + q * k * c + _distinct_rows(idx) * w) * size + q * k * isz,
                   2.0 * q * k * w)
        for case in cases["d_f"]:
            tq, ep, tm, row_map = case["query"], case["edge_pos"], case["mask"], case["row_map"]
            q, k = tq.shape
            n_out = case["n_out"]
            dout2 = rnd(case["n_dout"], w).to(dtype)
            table = rnd(case["n_edges"], c).to(dtype)
            out = torch.zeros(n_out, w, dtype=dtype, device="cuda")
            kw = dict(coef_idx=ep, mask=tm)
            if row_map is not None:
                kw.update(row_map=row_map, out=out)
            label = f"{case['name']} [{q}, {k}] {dt}"
            tol = (8e-3, 1e-2) if bf16 else (1e-5, 1e-5 * max(1.0, k / 16))
            kern = lambda: mr.gather_multiply_reduce_k(dout2, tq, table, b, **kw)
            got = kern()
            want = mr.gather_multiply_reduce_k_plain(dout2, tq, table, b, coef_idx=ep,
                                                     mask=tm)
            if row_map is not None:
                got = got[row_map]
            err = compare(f"mulred_k d_f {label}", got, want, *tol)
            same_bits(f"mulred_k d_f {label}", lambda: kern().clone())
            if not bf16:
                record("multiply_reduce_k", label, err)
                continue
            tm_km = tm.t()[..., None]
            ep_t, tq_t = ep.t().reshape(-1), tq.t().reshape(-1)

            def parent():
                cg = torch.where(tm_km, table.index_select(0, ep_t).view(k, q, c), 0)
                return mr.multiply_reduce_k(cg, dout2.index_select(0, tq_t).view(k, q, w), b)

            def library():
                cf = torch.where(tm[..., None],
                                 table.index_select(0, ep.reshape(-1)).view(q, k, c), 0)
                rows = dout2.index_select(0, tq.reshape(-1)).view(q, k, b, c)
                return torch.einsum("qkc,qkbc->qbc", cf, rows)

            valid = int(tm.sum())
            isz = tq.element_size()
            nbytes = ((valid * c + q * w + _distinct_rows(tq, tm) * w) * size
                      + valid * 2 * isz + q * k + (q * isz if row_map is not None else 0))
            times = _pair_ms(kern, parent, library,
                             lambda: mr.gather_multiply_reduce_k_plain(
                                 dout2, tq, table, b, coef_idx=ep, mask=tm))
            record("multiply_reduce_k",
                   f"d_f {label} (valid slots {valid / (q * k):.2f})", err, times,
                   nbytes, 2.0 * valid * w)
        torch.cuda.empty_cache()
    nf, nd = len(cases["forward"]), len(cases["d_f"])
    nb = sum(case.get("d_coef", True) for case in cases["forward"])
    rows = {}
    for name, per in (("multiply_reduce_k",
                       f"sum of the {nf + nd} calls of one training step (the "
                       f"forward runs {cases.get('forward_calls', nf)}); "
                       f"parent_pair_ms: the row gathers and the pre-gathered kernel"),
                      ("multiply_reduce_b",
                       f"sum of the {nb} calls of one training step; "
                       f"parent_pair_ms: the row gather and the pre-gathered kernel")):
        a = agg[name]
        rows[name] = _row(a["err"], a["ms"], a["plain_ms"], a["library_ms"],
                          bound_ms(a["bytes"], a["ops"], PEAK_FP32), per,
                          parent_pair_ms=a["parent_pair_ms"])
        log(f"  {name} ({what}), all calls: kernel_ms={a['ms']:.4f} "
            f"parent_pair_ms={a['parent_pair_ms']:.4f} library_ms={a['library_ms']:.4f} "
            f"plain_ms={a['plain_ms']:.4f} bound_ms={rows[name]['bound_ms']:.4f}")
    return rows


def _by_kv_head(fn, q, k, v, *rest):
    """``fn`` on one kv-head (with its group of q-heads, and the same heads
    of ``rest``) at a time, the outputs joined on their head axis: a plain
    version holds several fp32 [B, H, S, S] tensors, 34 GB each at H = 8,
    S = 32768, and 4.3 GB for one head."""
    import torch

    hkv = k.shape[2]
    g = q.shape[2] // hkv
    parts = [fn(q[:, :, j * g:(j + 1) * g], k[:, :, j:j + 1], v[:, :, j:j + 1],
                *(t[:, :, j * g:(j + 1) * g] for t in rest)) for j in range(hkv)]
    # [B, S, heads, D] outputs join on dim 2, a [B, heads, S] LSE on dim 1.
    join = lambda ts: torch.cat(ts, dim=2 if ts[0].dim() == 4 else 1)
    if isinstance(parts[0], torch.Tensor):
        return join(parts)
    return tuple(join(ts) for ts in zip(*parts))


def check_flash(rnd, bb, s, h, d, with_eval=True):
    """The forward (with the LSE output, and without it where
    ``with_eval``) and the backward at (B, S, H = Hkv, D). The plain versions
    run one kv-head at a time where one fp32 [B, H, S, S] tensor would pass
    8 GiB. Returns rows keyed "fwd", "fwd_lse" and "bwd" (bf16)."""
    import torch

    from gaot_torch.ops.cuda import flash_attention as fa

    rows = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    split = 4 * bb * h * s * s > 2 ** 33
    plain_fwd, plain_bwd = fa.attention_plain, fa.attention_bwd_plain
    if split:
        plain_fwd = lambda q, k, v, **kw: _by_kv_head(
            lambda *a: fa.attention_plain(*a, **kw), q, k, v)
        plain_bwd = lambda *a: _by_kv_head(fa.attention_bwd_plain, *a)
    log(f"flash attention, B={bb} H=Hkv={h} S={s} D={d}"
        + (" (plain versions one kv-head at a time):" if split else ":"))
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        bf16 = dtype == torch.bfloat16
        peak = PEAK_BF16 if bf16 else PEAK_FP32
        # q/k/v as views of one [B, S, 3·H·D] buffer
        qkv = rnd(bb, s, 3, h, d).to(dtype)
        q, k_, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k_, v))
        tol = (1e-2, 2e-3) if bf16 else (1e-4, 1e-5)
        isz = q.element_size()
        fwd_ops, exps = 4.0 * bb * h * s * s * d, float(bb * h * s * s)
        if with_eval:
            err = compare(f"flash fwd {name}", fa.flash_attention(q, k_, v),
                          plain_fwd(q, k_, v), *tol)
            bnd = bound_ms(4 * bb * s * h * d * isz, fwd_ops, peak, exps)
            t_k = time_ms(lambda: fa.flash_attention(q, k_, v))
            t_p = time_ms(lambda: plain_fwd(q, k_, v), iters=5, warmup=1)
            t_l = time_ms(lambda: sdpa(qh, kh, vh))
            log(f"    fwd {name}: kernel_ms={t_k:.4f} plain_ms={t_p:.4f} "
                f"library_ms={t_l:.4f} bound_ms={bnd[0]:.4f} ({bnd[2]} binds; "
                f"{fwd_ops / t_k / 1e9:.1f} TFLOP/s)")
            if bf16:
                rows["fwd"] = _row(err, t_k, t_p, t_l, bnd, "one call", S=s, D=d)
        out, lse = fa.flash_attention_lse(q, k_, v)
        want_out, want_lse = plain_fwd(q, k_, v, with_lse=True)
        err_lse = max(compare(f"flash fwd+LSE {name} out", out, want_out, *tol),
                      compare(f"flash fwd+LSE {name} lse", lse, want_lse, 1e-5, 1e-4))
        del want_out, want_lse
        bnd_lse = bound_ms(4 * bb * s * h * d * isz + 4 * bb * h * s, fwd_ops, peak, exps)
        t_kl = time_ms(lambda: fa.flash_attention_lse(q, k_, v))
        t_pl = time_ms(lambda: plain_fwd(q, k_, v, with_lse=True), iters=5, warmup=1)
        # One aten call returns the output and the natural-log row LSE (the
        # base-2 LSE times ln 2): the flash entry for bf16, the
        # memory-efficient entry for fp32.
        if bf16:
            lib_lse = lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                qh, kh, vh)[:2]
        else:
            lib_lse = lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
                qh, kh, vh, None, True)[:2]
        t_ll = time_ms(lib_lse)
        gap = float((lib_lse()[1][..., :s].float() / math.log(2) - lse).abs().max())
        log(f"    fwd+LSE {name}: kernel_ms={t_kl:.4f} plain_ms={t_pl:.4f} "
            f"library_ms={t_ll:.4f} (its LSE / ln 2 within {gap:.3e} of the "
            f"kernel's) bound_ms={bnd_lse[0]:.4f}")

        dout = rnd(bb, s, h, d).to(dtype)
        got = fa.flash_attention_bwd(q, k_, v, out, dout, lse)
        # No float atomics: a second call gives the same bits.
        same = all(torch.equal(a, b_) for a, b_ in
                   zip(got, fa.flash_attention_bwd(q, k_, v, out, dout, lse)))
        log(f"  flash bwd {name}: two calls bitwise identical: {same}")
        if not same:
            fail(f"flash bwd {name}: two calls on the same inputs differ")
        want = plain_bwd(q, k_, v, out, dout)
        # bf16: the kernel normalises p from the LSE where the plain version
        # folds the TPU kernel's per-row scales, so bf16 rounds at other
        # places; fp32: S-term sums in another order.
        rel = 3e-2 if bf16 else 1e-4
        err_bwd = max(compare_grad(f"flash bwd {name} d{n}", g, wt, rel)
                      for n, g, wt in zip("qkv", got, want))
        del got, want
        bwd_ops = 10.0 * bb * h * s * s * d
        bnd_bwd = bound_ms(8 * bb * s * h * d * isz + 4 * bb * h * s, bwd_ops,
                           peak, exps)
        t_kb = time_ms(lambda: fa.flash_attention_bwd(q, k_, v, out, dout, lse))
        t_pb = time_ms(lambda: plain_bwd(q, k_, v, out, dout), iters=3, warmup=1)
        leaves = [t.detach().requires_grad_(True) for t in (qh, kh, vh)]
        o_l = sdpa(*leaves)
        g_l = dout.transpose(1, 2).contiguous()
        t_lb = time_ms(lambda: torch.autograd.grad(o_l, leaves, g_l, retain_graph=True))
        log(f"    bwd {name}: kernel_ms={t_kb:.4f} plain_ms={t_pb:.4f} "
            f"library_ms={t_lb:.4f} bound_ms={bnd_bwd[0]:.4f} ({bnd_bwd[2]} binds; "
            f"{bwd_ops / t_kb / 1e9:.1f} TFLOP/s)")
        del o_l, leaves, qkv, out, lse, dout
        torch.cuda.empty_cache()
        if bf16:
            rows["fwd_lse"] = _row(err_lse, t_kl, t_pl, t_ll, bnd_lse, "one call",
                                   S=s, D=d)
            rows["bwd"] = _row(err_bwd, t_kb, t_pb, t_lb, bnd_bwd, "one call",
                               S=s, D=d)
    return rows


def check_ffn(rnd, r: int = BATCH * SEQ, extras: bool = True):
    """The SwiGLU forward and backward at R tokens (the fx shape by
    default), M = 256, F = 1024, bf16: against the plain versions, timed 20
    back to back and by profiler device time per call, beside the library's
    three products (and autograd of them); then, with ``extras``, the fp32
    kernels at the same shape (times logged), and the general route's
    forward and backward at M = 1024, F = 3584."""
    import torch

    from gaot_torch.ops.cuda import fused_ffn as ff

    rows = {}
    silu = torch.nn.functional.silu
    m, f = 256, 1024
    log(f"fused SwiGLU, R={r} M={m} F={f} (bf16):")

    def weights(m, f, dtype):
        return ((rnd(f, m) / m ** 0.5).to(dtype), (rnd(f, m) / m ** 0.5).to(dtype),
                (rnd(m, f) / f ** 0.5).to(dtype))

    x = rnd(r, m).bfloat16()
    w1, w3, w2 = weights(m, f, torch.bfloat16)
    err = compare("fused_ffn fwd bfloat16", ff.fused_ffn(x, w1, w3, w2),
                  ff.fused_ffn_plain(x, w1, w3, w2), 1e-2, 1e-2)
    ops = 6.0 * r * m * f
    bnd = bound_ms((2 * r * m + 3 * m * f) * 2, ops, PEAK_BF16, exps=float(r * f))
    kern = lambda: ff.fused_ffn(x, w1, w3, w2)
    lib = lambda: (silu(x @ w1.t()) * (x @ w3.t())) @ w2.t()
    t_k, t_l = time_ms(kern), time_ms(lib)
    d_k, d_l = device_ms(kern), device_ms(lib)
    t_p = time_ms(lambda: ff.fused_ffn_plain(x, w1, w3, w2))
    log(f"    fwd: kernel_ms={t_k:.4f} (device {d_k:.4f}) plain_ms={t_p:.4f} "
        f"library_ms={t_l:.4f} (device {d_l:.4f}) bound_ms={bnd[0]:.4f} ({bnd[2]} binds; "
        f"{ops / t_k / 1e9:.1f} TFLOP/s)")
    rows["fused_ffn_fwd"] = _row(err, t_k, t_p, t_l, bnd, "one call", device_ms=d_k,
                                 library_device_ms=d_l)

    dout = rnd(r, m).bfloat16()
    got = ff.fused_ffn_bwd(x, w1, w3, w2, dout)
    want = ff.fused_ffn_bwd_plain(x, w1, w3, w2, dout)
    # dh1 and dh3 are rounded to bf16 from fp32 sums taken in other orders:
    # a few land on the neighbouring bf16 value.
    err_bwd = max(compare_grad(f"fused_ffn bwd {n}", g, wt, 2e-2)
                  for n, g, wt in zip(("dx", "dw1", "dw3", "dw2"), got, want))
    del got, want
    ops_b = 16.0 * r * m * f
    bnd_b = bound_ms(3 * r * m * 2 + 3 * m * f * (2 + 4), ops_b, PEAK_BF16,
                     exps=float(r * f))
    kern_b = lambda: ff.fused_ffn_bwd(x, w1, w3, w2, dout)
    leaves = [t.detach().requires_grad_(True) for t in (x, w1, w3, w2)]
    xl, w1l, w3l, w2l = leaves
    out = (silu(xl @ w1l.t()) * (xl @ w3l.t())) @ w2l.t()
    lib_b = lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)
    t_kb, t_lb = time_ms(kern_b), time_ms(lib_b)
    d_kb, d_lb = device_ms(kern_b), device_ms(lib_b)
    t_pb = time_ms(lambda: ff.fused_ffn_bwd_plain(x, w1, w3, w2, dout), iters=5)
    log(f"    bwd: kernel_ms={t_kb:.4f} (device {d_kb:.4f}) plain_ms={t_pb:.4f} "
        f"library_ms={t_lb:.4f} (device {d_lb:.4f}) bound_ms={bnd_b[0]:.4f} ({bnd_b[2]} "
        f"binds; {ops_b / t_kb / 1e9:.1f} TFLOP/s)")
    rows["fused_ffn_bwd"] = _row(err_bwd, t_kb, t_pb, t_lb, bnd_b, "one call",
                                 device_ms=d_kb, library_device_ms=d_lb)
    del out, leaves, dout
    if not extras:
        del x, w1, w3, w2
        torch.cuda.empty_cache()
        return rows

    # fp32 (exact FMA on the CUDA cores) at the same shape, and the general
    # route at a width the tuned forward does not take: times logged.
    x32 = x.float()
    w32 = [w.float() for w in (w1, w3, w2)]
    d32 = rnd(r, m)
    t_f = time_ms(lambda: ff.fused_ffn(x32, *w32), iters=3, warmup=1)
    t_fb = time_ms(lambda: ff.fused_ffn_bwd(x32, *w32, d32), iters=3, warmup=1)
    log(f"    fp32: fwd kernel_ms={t_f:.4f} bound_ms="
        f"{bound_ms(0, ops, PEAK_FP32)[0]:.4f}; bwd kernel_ms={t_fb:.4f} bound_ms="
        f"{bound_ms(0, ops_b, PEAK_FP32)[0]:.4f}")
    del x32, w32, d32, x, w1, w3, w2
    m, f = 1024, 3584
    x = rnd(r, m).bfloat16()
    w1, w3, w2 = weights(m, f, torch.bfloat16)
    dout = rnd(r, m).bfloat16()
    t_g = time_ms(lambda: ff.fused_ffn(x, w1, w3, w2), iters=5, warmup=1)
    t_gb = time_ms(lambda: ff.fused_ffn_bwd(x, w1, w3, w2, dout), iters=5, warmup=1)
    t_gl = time_ms(lambda: (silu(x @ w1.t()) * (x @ w3.t())) @ w2.t(), iters=5, warmup=1)
    log(f"    general route, R={r} M={m} F={f} bf16: fwd kernel_ms={t_g:.4f} "
        f"(library {t_gl:.4f}, bound {bound_ms(0, 6.0 * r * m * f, PEAK_BF16)[0]:.4f}); "
        f"bwd kernel_ms={t_gb:.4f} (bound {bound_ms(0, 16.0 * r * m * f, PEAK_BF16)[0]:.4f})")
    del x, w1, w3, w2, dout
    torch.cuda.empty_cache()
    return rows


def _reduce_cases(path: Path, what: str):
    """The calls multiply_reduce_k makes in one training step of ``path``,
    on the graphs the model is given (``prepare_fx_device_graphs``, on the
    card): "forward", each graph or degree bucket reduced (idx [Q, K] into
    n_src source rows; multiply_reduce_b runs on the same) and the reorder
    of bucketed rows to query order with its gradient (a coefficient of
    one; no d_coef), and "d_f", each flat transpose graph or in-degree
    group (query, edge_pos, mask [N, Kt]; n_dout rows of dout, n_edges
    coefficient rows, n_out output rows; a group writes its rows through
    row_map), as ``gaot_torch/ops/gather_apply.py::df_calls`` makes them."""
    from gaot_torch.data.graph_builder import prepare_fx_device_graphs
    from gaot_torch.ops.gather_apply import FlatGraph, df_calls
    from gaot_torch.ops.padding import BucketedGraph

    n, nq = path.coords.shape[0], path.lat.shape[0]
    enc, dec, enc_t, dec_t = prepare_fx_device_graphs(
        path.enc, path.dec, n, nq, path.cfg.model.args.magno, device="cuda")
    cases = {"forward": [], "d_f": []}
    desc = []
    for side, g, t, n_src in (("encoder", enc[0], enc_t and enc_t[0], n),
                              ("decoder", dec[0], dec_t and dec_t[0], nq)):
        if isinstance(g, BucketedGraph):
            rows = sum(bk.indices.shape[0] for bk in g.buckets)
            cases["forward"] += [dict(name=f"{side} bucket", idx=bk.indices, n_src=n_src)
                                 for bk in g.buckets]
            edges = sum(bk.indices.numel() for bk in g.buckets)
            fg = FlatGraph(g.buckets, (None,) * len(g.buckets), rows, None, None, None,
                           g.tgraph, 1)
            for tq, ep, tm, rm in df_calls(fg, edges):
                cases["d_f"].append(dict(
                    name=f"{side} in-degree group", query=tq, edge_pos=ep, mask=tm,
                    row_map=rm, n_out=n_src, n_dout=rows, n_edges=edges))
            cases["forward"] += [
                dict(name=f"{side} rows to query order", idx=g.inv_perm[:, None],
                     n_src=rows, d_coef=False, ones=True),
                dict(name=f"{side} rows to query order, gradient", idx=g.perm[:, None],
                     mask=g.row_valid[:, None], n_src=g.inv_perm.shape[0], d_coef=False,
                     ones=True)]
            desc.append(f"{side} buckets {[tuple(bk.indices.shape) for bk in g.buckets]}, "
                        f"in-degree groups {[tuple(gr.mask.shape[1:]) for gr in g.tgraph.groups]}")
            continue
        q = g.indices.shape[0]
        cases["forward"].append(dict(name=f"{side} dense", idx=g.indices, n_src=n_src))
        cases["d_f"].append(dict(name=f"{side} transpose", query=t.query,
                                 edge_pos=t.edge_pos, mask=t.mask, row_map=None,
                                 n_out=n_src, n_dout=q, n_edges=g.indices.numel()))
        desc.append(f"{side} dense {tuple(g.indices.shape)}, transpose "
                    f"{tuple(t.mask.shape)} (mean in-degree "
                    f"{float(t.mask.sum(1).float().mean()):.1f})")
    log(f"{what} reduce graphs: " + "; ".join(desc))
    want = path.train_launches["multiply_reduce_k"]
    got = len(cases["forward"]) + len(cases["d_f"])
    if got != want:
        fail(f"{what}: expected {want} multiply-reduce calls, the graphs give {got}")
    return cases


def _vx_reduce_cases(path: Path, what: str, device="cuda"):
    """The multiply-reduce calls of one vx training step at the path's
    batch, on its graphs flattened over the batch as the model takes them
    (``vx_flat_graphs``; b = 1, sample s's ids offset by its slot):
    "forward", each degree bucket (masked) and the reorder of bucketed
    rows to query order with its gradient (masked by the valid rows; a
    coefficient of one; no d_coef); "d_f", each in-degree group
    (``df_calls``)."""
    from gaot_torch.ops.gather_apply import df_calls

    graphs, _, _ = _graph_args(path, path.batch, device)
    b, n, nq = path.batch, path.coords.shape[1], path.lat.shape[0]
    cases = {"forward": [], "d_f": [], "forward_calls": 0}
    desc = []
    for side, vg, n_src, n_q in (("encoder", graphs.encoder[0], n, nq),
                                 ("decoder", graphs.decoder[0], nq, n)):
        cases["forward"] += [dict(name=f"{side} bucket", idx=bk.indices, mask=bk.mask,
                                  n_src=b * n_src) for bk in vg.buckets]
        edges = sum(bk.indices.numel() for bk in vg.buckets)
        for tq, ep, tm, rm in df_calls(vg, edges // b):
            cases["d_f"].append(dict(name=f"{side} in-degree group", query=tq,
                                     edge_pos=ep, mask=tm, row_map=rm, n_out=b * n_src,
                                     n_dout=b * vg.rows, n_edges=edges))
        cases["forward_calls"] += len(vg.buckets)
        if vg.perm is not None:
            cases["forward"] += [
                dict(name=f"{side} rows to query order", idx=vg.inv_perm[:, None],
                     n_src=b * vg.rows, d_coef=False, ones=True),
                dict(name=f"{side} rows to query order, gradient", idx=vg.perm[:, None],
                     mask=vg.row_valid[:, None], n_src=b * n_q, d_coef=False, ones=True)]
            cases["forward_calls"] += 1
        desc.append(f"{side} buckets {[tuple(bk.indices.shape) for bk in vg.buckets]}, "
                    f"in-degree groups {[tuple(c[0].shape) for c in df_calls(vg, 1)]}")
    log(f"{what} reduce graphs (batch {b}, flattened): " + "; ".join(desc))
    want = path.train_launches["multiply_reduce_k"]
    got = len(cases["forward"]) + len(cases["d_f"])
    if got != want:
        fail(f"{what}: expected {want} multiply-reduce calls, the graphs give {got}")
    return cases


def _graph_args(path: Path, b: int, device):
    """The model's graph arguments for a batch of ``b`` samples, its
    coordinates and its node mask: fx, the shared graphs on ``device``, the
    nodes and None; vx, the first ``b`` samples' buffers on ``device`` as
    the loader gives them, their coordinates and node mask."""
    import torch

    from gaot_torch.data.graph_builder import (
        prepare_fx_device_graphs,
        vx_flat_graphs,
        vx_layout,
    )
    from gaot_torch.train.static_trainer import FxGraphs

    lat = torch.from_numpy(path.lat).to(device)
    if path.vx is not None:
        batch = {k: v[:b] for k, v in path.vx.items()}
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in {**batch, **vx_layout(batch, b)}.items()}
        graphs = FxGraphs(lat, *vx_flat_graphs(batch, len(path.enc)))
        return graphs, batch["x"], batch["node_mask"]
    e, d, et, dt = prepare_fx_device_graphs(path.enc, path.dec, path.coords.shape[0],
                                            path.lat.shape[0], path.cfg.model.args.magno,
                                            device=device)
    return FxGraphs(lat, e, d, et, dt), torch.from_numpy(path.coords).to(device), None


def _model(path: Path, dtype, device):
    import torch

    from gaot_torch.models import GAOT

    model = GAOT(1, 1, path.cfg.model, dtype=dtype, device=device,
                 generator=torch.Generator().manual_seed(0)).eval()
    if model.pos_emb.shape[0] != path.seq:
        fail(f"{path.name}: the model has {model.pos_emb.shape[0]} tokens, "
             f"expected {path.seq}")
    return model


def _batch(seed, path: Path):
    import numpy as np

    rng = np.random.default_rng(seed)
    shape = (max(path.batch, path.check_batch), path.coords.shape[-2], 1)
    pndata = rng.normal(size=shape).astype(np.float32)
    target = rng.normal(size=shape).astype(np.float32)
    return pndata, target


def _expect_launches(what, counts, want):
    full = dict.fromkeys(counts, 0)
    full.update(want)
    if counts != full:
        fail(f"{what}: launch counts {counts}, expected {full}")


def _check_dtypes(path: Path):
    import torch

    return [(name, {"fp32": None, "bf16": torch.bfloat16}[name])
            for name in path.check_dtypes] if path.check_batch else []


def phase_forward(path: Path):
    import torch

    from gaot_torch.ops import cuda as kernels
    from gaot_torch.train.static_trainer import eval_step
    from gaot_torch.utils.routing import format_routes, reset_routes

    pndata, target = _batch(1, path)
    n, cb = path.coords.shape[-2], path.check_batch
    out = {}
    for name, dtype in _check_dtypes(path):
        mg = {dev: (_model(path, dtype, dev), _graph_args(path, cb, dev))
              for dev in ("cuda", "cpu")}
        t = lambda a, dev: torch.from_numpy(a[:cb]).to(dev)
        preds = {}
        for dev, (model, (graphs, coord, nmask)) in mg.items():
            pred, _ = eval_step(model, graphs, coord, t(pndata, dev), t(target, dev),
                                torch.ones(cb, dtype=torch.bool, device=dev), nmask)
            preds[dev] = pred.float().cpu()
        got, want = preds["cuda"], preds["cpu"]
        if got.shape != (cb, n, 1) or not torch.isfinite(got).all():
            fail(f"{path.name} batch-{cb} {name} forward: shape {tuple(got.shape)} "
                 f"or non-finite")
        rel = float((got - want).norm() / want.norm())
        scale = float(want.abs().max())
        if dtype is None:
            ok = torch.allclose(got, want, rtol=1e-3, atol=1e-3 * scale)
            tol = f"rtol 1e-3, atol 1e-3·max|ref| = {1e-3 * scale:.2e}"
        else:
            ok = rel <= 2e-2
            tol = "relative L2 <= 2e-2 (bf16 rounds at other places on the CPU)"
        log(f"{path.name} forward batch {cb} {name}: card vs CPU plain route "
            f"rel_l2={rel:.3e} max_abs={float((got - want).abs().max()):.3e} ({tol}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{path.name} batch-{cb} {name} forward disagrees with the CPU plain route")
        out[name] = rel
        del mg, preds, got, want
    if not path.batch:
        return out

    model = _model(path, torch.bfloat16, "cuda")
    graphs, xc, nmask = _graph_args(path, path.batch, "cuda")
    xp = torch.from_numpy(pndata).cuda()
    xt = torch.from_numpy(target).cuda()
    smask = torch.ones(path.batch, dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_routes()
    kernels.reset_launches()
    pred, loss = eval_step(model, graphs, xc, xp, xt, smask, nmask)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"{path.name} forward batch {path.batch} bf16 (S = {path.seq}): "
        f"launches {launches}")
    log(f"  routes: {format_routes()}")
    _expect_launches(f"{path.name} forward", launches, path.forward_launches)
    if pred.shape != (path.batch, n, 1) or not torch.isfinite(pred).all() \
            or not torch.isfinite(loss):
        fail(f"{path.name} batch-{path.batch} forward: wrong shape or non-finite output")
    peak = torch.cuda.max_memory_allocated()
    run = lambda: eval_step(model, graphs, xc, xp, xt, smask, nmask)
    log(f"  forward_ms {fmt_times(host_times(run, 10), path.batch)} "
        f"max_memory_allocated={peak / 2**30:.3f} GiB loss={float(loss):.4f}")
    profile_step(run, f"{path.name} forward")
    out["launches"] = launches
    del model, graphs
    torch.cuda.empty_cache()
    return out


def host_times(run, n: int) -> list:
    """Host-clock ms of ``run`` with a synchronise after each, after three
    warm-up runs."""
    import torch

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def fmt_times(times: list, batch: int) -> str:
    return (f"median={statistics.median(times):.3f} min={min(times):.3f} "
            f"max={max(times):.3f} ({len(times)} runs) samples_per_s="
            f"{batch / statistics.median(times) * 1e3:.1f}")


def _share_embedding(model, feats: list, record: bool):
    """Forward pre-hooks on each geometric embedding's MLP that append its
    input features to ``feats`` (``record``) or, in the same call order,
    replace them with the recorded ones."""
    def hook(_, args):
        if record:
            feats.append(args[0].detach().cpu())
            return None
        return (feats.pop(0).to(args[0].device),) + args[1:]

    mods = [m for n, m in model.named_modules() if n.endswith("geoembed.mlp")]
    if not mods:
        fail("the model has no geometric embedding to share")
    for m in mods:
        m.register_forward_pre_hook(hook)


def phase_train(path: Path):
    import torch

    from gaot_torch.ops import cuda as kernels
    from gaot_torch.train.schedules import make_optimizer
    from gaot_torch.train.static_trainer import train_step
    from gaot_torch.utils.routing import format_routes, reset_routes

    ocfg = path.cfg.optimizer
    pndata, target = _batch(2, path)
    cb = path.check_batch
    # fp32 again with the geometric embedding's features fed identically
    # to both sides: it holds everything downstream of them, the kernels
    # included, apart from the embedding's own rounding.
    checks = [(name, dtype, False) for name, dtype in _check_dtypes(path)]
    checks += [(f"{name}, embedding shared", dtype, True)
               for name, dtype, _ in checks if dtype is None]
    for name, dtype, shared in checks:
        res, feats = {}, []
        for dev in ("cpu", "cuda"):
            model = _model(path, dtype, dev)
            graphs, coord, nmask = _graph_args(path, cb, dev)
            if shared:
                _share_embedding(model, feats, record=dev == "cpu")
            opt, sched = make_optimizer(ocfg, model.parameters(), path.steps_per_epoch)
            grads = {}
            opt.register_step_pre_hook(lambda *_: grads.update(
                {n: p.grad.detach().float().cpu()
                 for n, p in model.named_parameters()}))
            t = lambda a: torch.from_numpy(a[:cb]).to(dev)
            loss = train_step(model, opt, sched, 0, graphs, coord, t(pndata),
                              t(target), torch.ones(cb, dtype=torch.bool, device=dev),
                              nmask)
            res[dev] = (float(loss), grads)
            del model, graphs, opt
        if feats:
            fail(f"{path.name}: {len(feats)} recorded embedding inputs unused")
        (loss_c, g_c), (loss_p, g_p) = res["cuda"], res["cpu"]
        if set(g_c) != set(g_p) or not all(torch.isfinite(g).all() for g in g_c.values()):
            fail(f"{path.name} batch-{cb} {name} training step: missing or non-finite "
                 f"gradients")
        gc = torch.cat([g_c[n].reshape(-1) for n in sorted(g_c)])
        gp = torch.cat([g_p[n].reshape(-1) for n in sorted(g_p)])
        rel = float((gc - gp).norm() / gp.norm())
        per = {n: float((g_c[n] - g_p[n]).abs().max()
                        / g_p[n].abs().max().clamp(min=1e-30)) for n in g_p}
        worst_name = max(per, key=per.get)
        worst = per[worst_name]
        worst3 = ", ".join(f"{n} {per[n]:.2e}" for n in sorted(per, key=per.get)[-3:])
        loss_rel = abs(loss_c - loss_p) / abs(loss_p)
        if shared:
            # Everything but the embedding's rounding: about 12x the worst
            # reading of the first runs, 8.3e-06 (the attention projections).
            ok = loss_rel <= 1e-5 and worst <= 1e-4
            tol = "loss rel 1e-5; each gradient within 1e-4 of its largest entry"
        elif dtype is None:
            # fp32 sums in other orders, through the whole backward; the
            # statistical embedding's features (one-pass moments, closed-form
            # eigenvalues) round differently on the two sides, which the 3D
            # paths' decoder embedding carries to about 6e-4.
            ok = loss_rel <= 1e-4 and worst <= 1e-3
            tol = "loss rel 1e-4; each gradient within 1e-3 of its largest entry"
        else:
            # bf16 rounds at other places on the CPU. The per-tensor bound
            # holds the small leaves (norms, biases, one bucket's coef MLP),
            # which the global L2 cannot see; it is about 5x the main path's
            # worst reading, 1.9e-2.
            ok = loss_rel <= 2e-2 and rel <= 5e-2 and worst <= 1e-1
            tol = ("loss rel 2e-2; relative L2 over all gradients <= 5e-2; each "
                   "gradient within 1e-1 of its largest entry")
        log(f"{path.name} train step batch {cb} {name}: card vs CPU plain route loss "
            f"{loss_c:.6f} vs {loss_p:.6f} (rel {loss_rel:.2e}); gradients "
            f"({len(g_p)} tensors) rel_l2={rel:.3e} worst_per_tensor={worst:.3e} "
            f"({worst_name}) ({tol}) {'ok' if ok else 'MISMATCH'}")
        log(f"  worst three tensors: {worst3}")
        if not ok:
            fail(f"{path.name} batch-{cb} {name} training step disagrees with the CPU "
                 f"plain route")
        del res, g_c, g_p, gc, gp
    if not path.batch:
        return None, None

    model = _model(path, torch.bfloat16, "cuda")
    graphs, xc, nmask = _graph_args(path, path.batch, "cuda")
    opt, sched = make_optimizer(ocfg, model.parameters(), path.steps_per_epoch)
    xp, xt = torch.from_numpy(pndata).cuda(), torch.from_numpy(target).cuda()
    smask = torch.ones(path.batch, dtype=torch.bool, device="cuda")
    step = [0]

    def run():
        loss = train_step(model, opt, sched, step[0], graphs, xc, xp, xt, smask, nmask)
        step[0] += 1
        return loss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_routes()
    kernels.reset_launches()
    losses = [run()]
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"{path.name} train step batch {path.batch} bf16 (S = {path.seq}): "
        f"launches {launches}")
    log(f"  routes: {format_routes()}")
    _expect_launches(f"{path.name} training step", launches, path.train_launches)
    losses += [run() for _ in range(4)]
    losses = [float(v) for v in losses]
    log(f"  AdamW 'mix' losses on one batch, steps 0-4: "
        + " ".join(f"{v:.5f}" for v in losses))
    if not all(map(math.isfinite, losses)):
        fail(f"{path.name} batch-{path.batch} training step: non-finite loss")
    peak = torch.cuda.max_memory_allocated()
    times = host_times(run, 10)
    log(f"  step_ms {fmt_times(times, path.batch)} "
        f"max_memory_allocated={peak / 2**30:.3f} GiB")
    profile_step(run, f"{path.name} training step")
    del model, graphs, opt
    torch.cuda.empty_cache()
    return launches, statistics.median(times)


def profile_step(run, what: str, steps: int = 10, top: int = 20):
    """Where a step's time goes: steps issued back to back (no synchronise
    in between), timed on the host clock without and then with
    torch.profiler; prints the device-busy time per step, the device's idle
    share, the kernels per step, and the kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
    # Device-side kernels only: the host ops that launched them, and the
    # device ranges of user annotations (such as the optimizer's step), carry
    # the same device time again.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and not e.is_user_annotation
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / steps / 1e3
    if busy_ms <= 0:
        fail(f"the profiler saw no device time in the {what}")
    log(f"  pipelined {what} ({steps} back to back): wall_ms={wall * 1e3:.3f} "
        f"device_busy_ms={busy_ms:.3f} idle_share={1 - busy_ms / (wall * 1e3):.3f} "
        f"kernels_per_step={sum(e.count for e in events) / steps:.0f}")
    events.sort(key=lambda e: -e.self_device_time_total)
    for e in events[:top]:
        log(f"    {e.self_device_time_total / 1e3 / steps:9.4f} ms "
            f"{e.count / steps:6.1f} calls  {e.key[:100]}")
    # The AGNO apply reads its rows by index: PyTorch's row gather (the
    # index_select of a leading axis) must not run on any path.
    gathers = [e for e in events if "vectorized_gather_kernel" in e.key]
    log(f"  row gathers (vectorized_gather_kernel) per step: "
        f"{sum(e.count for e in gathers) / steps:.1f} calls, "
        f"{sum(e.self_device_time_total for e in gathers) / 1e3 / steps:.4f} ms")
    if gathers:
        fail(f"the {what} still runs PyTorch's row gather")


# The trainer phase: the fx recipe trained through the CLI on synthetic
# Poisson-Gauss-shaped data (tests/synthetic.py's layout) at the recipe's
# 8192 nodes and full width, cut to these split sizes and epochs
# (the example: 2048 / 128 / 256 samples, 1000 epochs).
TRAINER_SIZES = {"train_size": 512, "val_size": 64, "test_size": 128}
TRAINER_EPOCHS = 6


def _trainer_config(folder: str, name: str, ckpt_of: str = None, **setup) -> tuple:
    """The example config, read from disk, with the trainer phase's sizes,
    the data and every output path in ``folder`` (run ``name``'s own; the
    checkpoint that of run ``ckpt_of`` where given) and ``setup`` merged in.
    Returns (the written config's path, the config)."""
    with open(CONFIG) as f:
        raw = json.load(f)
    raw["setup"].update(setup)
    raw["dataset"].update(TRAINER_SIZES, base_path=folder)
    raw["optimizer"]["args"]["epoch"] = TRAINER_EPOCHS
    out = lambda run, f: os.path.join(folder, run, f)
    raw["path"] = {"ckpt_path": out(ckpt_of or name, "ckpt"),
                   "loss_path": out(name, "loss.png"),
                   "result_path": out(name, "result.png"),
                   "database_path": out(name, "db.csv")}
    path = os.path.join(folder, f"{name}.json")
    with open(path, "w") as f:
        json.dump(raw, f, indent=1)
    return path, raw


def _trainer_launches(raw: dict, bf16: bool) -> tuple:
    """The launches a fit of ``raw`` must make: the training step's table
    times the training steps, plus the forward's times the evaluation
    batches (a validation every eval_every_eps epochs, then test()); no
    SwiGLU launch in fp32 (the fused kernel serves bf16 under "auto").
    Returns (launches, steps, evaluation batches)."""
    ds, args = raw["dataset"], raw["optimizer"]["args"]
    batches = lambda n: math.ceil(n / min(ds["batch_size"], n))
    steps = args["epoch"] * batches(ds["train_size"])
    evals = (args["epoch"] // args["eval_every_eps"] * batches(ds["val_size"])
             + batches(ds["test_size"]))
    want = {}
    for table, n in ((TRAIN_LAUNCHES, steps), (FORWARD_LAUNCHES, evals)):
        for k, v in table.items():
            if bf16 or not k.startswith("fused_ffn"):
                want[k] = want.get(k, 0) + v * n
    return want, steps, evals


def _cli_in_process(cfg_path: str, what: str, profile: bool = False):
    """``gaot_torch.cli.main(["-c", cfg_path])`` in this process, its
    output captured and logged, the launch counters and routes reset before
    and read after. Returns (launches, the printed routes, seconds, the
    profiler or None, the output)."""
    import contextlib
    import io

    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from gaot_torch import cli
    from gaot_torch.ops import cuda as kernels
    from gaot_torch.utils.routing import reset_routes

    buf = io.StringIO()
    prof = torch_profile(activities=[ProfilerActivity.CUDA]) if profile else None
    torch.cuda.synchronize()
    reset_routes()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf), (prof or contextlib.nullcontext()):
            rc = cli.main(["-c", cfg_path])
            torch.cuda.synchronize()
    finally:
        for line in buf.getvalue().splitlines():
            log(f"  [{what}] {line}")
    secs = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if rc != 0:
        fail(f"trainer {what}: gaot_torch.cli.main returned {rc}")
    routes = [ln for ln in buf.getvalue().splitlines()
              if ln.startswith("[gaot_torch] kernel routes:")]
    if len(routes) != 1:
        fail(f"trainer {what}: expected one kernel-routes line, got {len(routes)}")
    return launches, dict(kv.split("=", 1) for kv in routes[0].split(": ", 1)[1].split()
                          if "=" in kv), secs, prof, buf.getvalue()


def _steady_rate(output: str, train_size: int) -> tuple:
    """From a fit's printed evaluations ("epoch E/N ... at T s"): the
    seconds to the first evaluation, and the samples/s from it to the last
    (the later epochs and their validations, without the first epoch's
    warm-up)."""
    marks = [(int(m.group(1)), float(m.group(2))) for m in re.finditer(
        r"^epoch (\d+)/\d+ .* at ([0-9.]+) s$", output, re.M)]
    if len(marks) < 2:
        fail(f"expected two or more evaluation lines, got {len(marks)}")
    (e0, t0), (e1, t1) = marks[0], marks[-1]
    return t0, (e1 - e0) * train_size / (t1 - t0)


def _run_record(raw: dict) -> tuple:
    """(the loss record, the last CSV row) a run wrote."""
    import csv

    import numpy as np

    paths = raw["path"]
    rec = np.load(paths["loss_path"][:-4] + ".npz")
    with open(paths["database_path"], newline="") as f:
        rows = list(csv.DictReader(f))
    if len(rows) != 1:
        fail(f"{paths['database_path']}: {len(rows)} rows, expected 1")
    return {k: rec[k] for k in rec.files}, rows[0]


def _ckpt_step(raw: dict) -> int:
    import torch

    from gaot_torch.train.checkpoint import checkpoint_file

    return torch.load(checkpoint_file(raw["path"]["ckpt_path"]), map_location="cpu",
                      weights_only=True)["step"]


def _check_run(what: str, raw: dict, launches: dict, routes: dict, want: dict,
               ffn_route: str) -> tuple:
    """A fit's checks: the launch counts, the routes, a falling loss, a
    finite metric, its files. Returns (the loss record, the CSV row)."""
    from gaot_torch.train.checkpoint import checkpoint_file

    _expect_launches(f"trainer {what}", launches, want)
    agno = routes.get("agno", "").split("+")
    if not all(r.endswith(":cuda") for r in agno) or routes.get("attn") != "cuda" \
            or routes.get("ffn") != ffn_route:
        fail(f"trainer {what}: routes {routes}; expected agno on the kernels, "
             f"attn=cuda, ffn={ffn_route}")
    rec, row = _run_record(raw)
    losses = rec["losses"]
    err = float(row["relative error (direct)"])
    sps = float(row["samples_per_sec"])
    log(f"trainer {what}: train losses {' '.join(f'{v:.5f}' for v in losses)}; "
        f"val losses {' '.join(f'{v:.5f}' for v in rec['val_losses'])}; "
        f"relative error (direct) {err:.5f}; training time "
        f"{float(row['training time']):.3f} s; samples_per_sec {sps:.1f}; "
        f"nparams {row['nparams']}")
    if not losses[-1] < losses[0]:
        fail(f"trainer {what}: the train loss did not fall ({losses})")
    if not (math.isfinite(err) and sps > 0):
        fail(f"trainer {what}: relative error {err}, samples_per_sec {sps}")
    if not os.path.exists(checkpoint_file(raw["path"]["ckpt_path"])):
        fail(f"trainer {what}: no checkpoint")
    return rec, row


def phase_trainer(card: str, step_ms: float):
    """Phase 5: the fx recipe trained through the CLI (module docstring)."""
    import tempfile

    import torch
    from torch.autograd import DeviceType

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from synthetic import make_static_fx_dataset

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="gaot_trainer_") as folder:
        with open(CONFIG) as f:
            name = json.load(f)["dataset"]["name"]
        n = sum(TRAINER_SIZES.values())
        make_static_fx_dataset(os.path.join(folder, f"{name}.npz"), num_samples=n,
                               num_nodes=NUM_NODES, seed=0)
        log(f"trainer data: {n} samples x {NUM_NODES} nodes (seed 0), splits "
            f"{TRAINER_SIZES}, {TRAINER_EPOCHS} epochs")

        # Run A: bf16, in this process, under a device-only profiler.
        cfg_a, raw_a = _trainer_config(folder, "run_a", compute_dtype="bfloat16")
        want_a, steps, evals = _trainer_launches(raw_a, bf16=True)
        torch.cuda.reset_peak_memory_stats()
        launches_a, routes_a, secs_a, prof, out_a = _cli_in_process(
            cfg_a, "run A bf16", profile=True)
        peak_a = torch.cuda.max_memory_allocated()
        log(f"trainer run A: {steps} training steps, {evals} evaluation batches; "
            f"launches {launches_a}; routes {routes_a}; {secs_a:.1f} s in the CLI")
        rec_a, row_a = _check_run("run A bf16", raw_a, launches_a, routes_a, want_a,
                                  "cuda")
        if _ckpt_step(raw_a) != steps:
            fail(f"trainer run A: the checkpoint's step is {_ckpt_step(raw_a)}, "
                 f"expected {steps}")
        t_prof = time.perf_counter()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                  and e.self_device_time_total > 0]
        busy_s = sum(e.self_device_time_total for e in events) / 1e6
        # PyTorch's row gather runs only where the loader selects a batch's
        # samples from the split buffers on the device (index_select: one
        # for u, one for c, per batch); the model runs none.
        gathers = [e for e in events if "vectorized_gather_kernel" in e.key]
        n_gathers = sum(e.count for e in gathers)
        loader_gathers = 2 * (steps + evals)
        train_s = float(row_a["training time"])
        log(f"trainer run A device profile (the whole CLI run, read in "
            f"{time.perf_counter() - t_prof:.1f} s): device busy {busy_s:.3f} s of "
            f"{secs_a:.3f} s, kernels {sum(e.count for e in events)}; row gathers "
            f"(vectorized_gather_kernel) {n_gathers} in "
            f"{sum(e.self_device_time_total for e in gathers) / 1e3:.3f} ms, the "
            f"loader's batch selects {loader_gathers}, the model's "
            f"{n_gathers - loader_gathers}")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"    {e.self_device_time_total / 1e3:10.3f} ms {e.count:7d} calls  "
                f"{e.key[:90]}")
        if n_gathers != loader_gathers:
            fail("trainer run A: the model runs PyTorch's row gather "
                 "(vectorized_gather_kernel) beside the loader's batch selects")
        sps_a = float(row_a["samples_per_sec"])
        first_a, steady_a = _steady_rate(out_a, TRAINER_SIZES["train_size"])
        log(f"trainer run A bf16 ({card}): training time {train_s:.3f} s, "
            f"samples_per_sec {sps_a:.1f} (under the device profiler; "
            f"{first_a:.3f} s to the first evaluation, {steady_a:.1f} samples/s "
            f"after it), max_memory_allocated {peak_a / 2**30:.3f} GiB; the bare "
            f"training step of phase 4 (fx, batch {BATCH}): median {step_ms:.3f} ms "
            f"= {BATCH / step_ms * 1e3:.1f} samples/s")

        # Run B: resume from run A's checkpoint, through the real command line.
        cfg_b, raw_b = _trainer_config(folder, "run_b", ckpt_of="run_a",
                                       compute_dtype="bfloat16", ckpt=True)
        before = _ckpt_step(raw_b)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "gaot_torch.cli", "-c", cfg_b],
                              cwd=HERE, capture_output=True, text=True, timeout=600)
        for line in (proc.stdout + proc.stderr).splitlines()[-40:]:
            log(f"  [run B] {line}")
        if proc.returncode != 0:
            fail(f"trainer run B: python -m gaot_torch.cli exited {proc.returncode}")
        after = _ckpt_step(raw_b)
        rec_b, row_b = _run_record(raw_b)
        first_b, steady_b = _steady_rate(proc.stdout, TRAINER_SIZES["train_size"])
        log(f"trainer run B bf16 ({card}; resume, subprocess, "
            f"{time.perf_counter() - t0:.1f} s): checkpoint step {before} -> {after}; "
            f"train losses {' '.join(f'{v:.5f}' for v in rec_b['losses'])}; "
            f"samples_per_sec {float(row_b['samples_per_sec']):.1f} (no profiler; "
            f"{first_b:.3f} s to the first evaluation, {steady_b:.1f} samples/s after "
            f"it), training time {float(row_b['training time']):.3f} s")
        if (before, after) != (steps, 2 * steps):
            fail(f"trainer run B: checkpoint step {before} -> {after}, expected "
                 f"{steps} -> {2 * steps}")
        if not rec_b["losses"][0] < rec_a["losses"][0]:
            fail("trainer run B: its first train loss is not below run A's first")
        if not math.isfinite(float(row_b["relative error (direct)"])):
            fail("trainer run B: non-finite relative error")

        # Run C: the example as it stands (fp32 compute).
        cfg_c, raw_c = _trainer_config(folder, "run_c")
        want_c, _, _ = _trainer_launches(raw_c, bf16=False)
        launches_c, routes_c, secs_c, _, out_c = _cli_in_process(cfg_c, "run C fp32")
        first_c, steady_c = _steady_rate(out_c, TRAINER_SIZES["train_size"])
        log(f"trainer run C fp32 ({card}): launches {launches_c}; routes {routes_c}; "
            f"{secs_c:.1f} s in the CLI; {first_c:.3f} s to the first evaluation, "
            f"{steady_c:.1f} samples/s after it")
        _check_run("run C fp32", raw_c, launches_c, routes_c, want_c, "plain")
    log(f"trainer phase: {time.perf_counter() - t_phase:.1f} s")
    return launches_a


# Phase 5b: the elasticity recipe (config/examples/time_indep/elasticity.json,
# a mesh per sample) trained through the CLI on synthetic data at the
# Elasticity layout (tests/torch_synthetic.py: 972 points a sample in
# [0, 1]^2, one c and one u channel), the example's batch of 32 and its
# fp32, cut to these split sizes and epochs (the example: 1024 / 128 / 256
# samples, 500 epochs).
ELASTICITY = os.path.join(HERE, "config", "examples", "time_indep", "elasticity.json")
VX_TRAINER_SIZES = {"train_size": 256, "val_size": 32, "test_size": 64}
VX_TRAINER_EPOCHS = 6


def phase_vx_trainer(card: str, step_ms: float):
    """Phase 5b: the elasticity recipe through the CLI (module docstring).
    Returns the run's launches."""
    import tempfile

    import torch
    from torch.autograd import DeviceType

    from gaot_torch.train.static_trainer import StaticTrainer

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_synthetic import ELASTICITY_POINTS, make_elasticity_dataset

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="gaot_vx_trainer_") as folder:
        with open(ELASTICITY) as f:
            raw = json.load(f)
        n = sum(VX_TRAINER_SIZES.values())
        make_elasticity_dataset(os.path.join(folder, f"{raw['dataset']['name']}.npz"),
                                num_samples=n, seed=0)
        raw["dataset"].update(VX_TRAINER_SIZES, base_path=folder)
        raw["optimizer"]["args"]["epoch"] = VX_TRAINER_EPOCHS
        raw["path"] = {k: os.path.join(folder, "run", os.path.basename(v))
                       for k, v in raw["path"].items()}
        raw["path"]["result_path"] = os.path.join(folder, "run", "result.png")
        cfg_path = os.path.join(folder, "elasticity.json")
        with open(cfg_path, "w") as f:
            json.dump(raw, f, indent=1)
        log(f"vx trainer data: {n} samples x {ELASTICITY_POINTS} points (seed 0), "
            f"splits {VX_TRAINER_SIZES}, {VX_TRAINER_EPOCHS} epochs, batch "
            f"{raw['dataset']['batch_size']}, fp32")

        # The tables from the graphs the trainer builds (a trainer made
        # from the same config, not fitted); fp32 runs no SwiGLU kernel.
        # The loader selects a batch with one index_select (PyTorch's row
        # gather) per buffer on the card: the coordinates, the node mask,
        # u, c and every graph buffer (the layout beside them is placed
        # once, not selected).
        probe = StaticTrainer(copy.deepcopy(raw))
        batch = next(iter(probe.train_loader))
        graphs = probe._batch_graphs(batch)
        tcfg = probe.model_config.args.transformer
        fwd, train = _vx_tables(graphs, tcfg.num_layers, ffn=False)
        per_batch = sum(isinstance(v, torch.Tensor) and v.is_cuda
                        for k, v in batch.items()
                        if k not in probe.train_loader.layout_keys)
        ds, args = probe.dataset_config, probe.optimizer_config.args
        batches = lambda k: math.ceil(k / min(ds.batch_size, k))
        steps = args.epoch * batches(ds.train_size)
        evals = args.epoch // args.eval_every_eps * batches(ds.val_size) \
            + batches(ds.test_size)
        want = {k: train.get(k, 0) * steps + fwd.get(k, 0) * evals
                for k in set(train) | set(fwd)}
        log(f"vx trainer tables: a step {train}, a forward {fwd}; {steps} steps, "
            f"{evals} evaluation batches; the loader's row gathers {per_batch} a batch")
        del probe, batch, graphs
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        launches, routes, secs, prof, out = _cli_in_process(cfg_path, "elasticity fp32",
                                                            profile=True)
        peak = torch.cuda.max_memory_allocated()
        log(f"vx trainer: launches {launches}; routes {routes}; {secs:.1f} s in the CLI")
        rec, row = _check_run("elasticity fp32", raw, launches, routes, want, "plain")
        if not all(r == "vx:cuda" for r in routes["agno"].split("+")):
            fail(f"vx trainer: agno routes {routes['agno']}, expected vx:cuda")
        if _ckpt_step(raw) != steps:
            fail(f"vx trainer: the checkpoint's step is {_ckpt_step(raw)}, expected {steps}")
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                  and e.self_device_time_total > 0]
        busy_s = sum(e.self_device_time_total for e in events) / 1e6
        n_gathers = sum(e.count for e in events if "vectorized_gather_kernel" in e.key)
        loader_gathers = per_batch * (steps + evals)
        log(f"vx trainer device profile: busy {busy_s:.3f} s of {secs:.3f} s, kernels "
            f"{sum(e.count for e in events)}; row gathers (vectorized_gather_kernel) "
            f"{n_gathers}, the loader's batch selects {loader_gathers}, the model's "
            f"{n_gathers - loader_gathers}")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"    {e.self_device_time_total / 1e3:10.3f} ms {e.count:7d} calls  "
                f"{e.key[:90]}")
        if n_gathers != loader_gathers:
            fail("vx trainer: the model runs PyTorch's row gather "
                 "(vectorized_gather_kernel) beside the loader's batch selects")
        first, steady = _steady_rate(out, VX_TRAINER_SIZES["train_size"])
        log(f"vx trainer elasticity fp32 ({card}): training time "
            f"{float(row['training time']):.3f} s, samples_per_sec "
            f"{float(row['samples_per_sec']):.1f} (under the device profiler; "
            f"{first:.3f} s to the first evaluation, {steady:.1f} samples/s after it), "
            f"max_memory_allocated {peak / 2**30:.3f} GiB; the vx flagship's bare "
            f"step (batch {VX_BATCH}, 8192 nodes): median {step_ms:.3f} ms")
    log(f"vx trainer phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def _entries(rows, names, launches, path: str, suffix: str = ""):
    """Kernel-line entries for ``rows`` (check key -> row), named by
    ``names`` (check key -> kernel name in SOURCES) plus ``suffix`` and
    counted by ``launches`` (check key -> launches on the path's run)."""
    out = []
    for key, row in rows.items():
        src, rep = SOURCES[names[key]]
        out.append({"name": names[key] + suffix, "route": "cuda", "source": src,
                    "replaces": rep, "launches": launches[key], "path": path, **row})
    return out


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "gaot_torch")):
        fail("gaot_torch/ not found next to chip_smoke.py: run it from a "
             "checkout of the repository")
    sys.path.insert(0, HERE)
    import torch

    from gaot_torch.core.config import GAOTConfig, load_experiment_config, merge_config

    card = phase_card()
    phase_build()

    cfg = load_experiment_config(CONFIG)
    main_path = Path("fx main path", cfg,
                     *_host_graphs(cfg, NUM_NODES, LATENT, "fx main path"), seq=SEQ,
                     check_batch=4, check_dtypes=("fp32", "bf16"), batch=BATCH,
                     steps_per_epoch=STEPS_PER_EPOCH, forward_launches=FORWARD_LAUNCHES,
                     train_launches=TRAIN_LAUNCHES)
    cfg3 = merge_config(GAOTConfig, CONFIG_3D)
    flagship = Path("3D flagship", cfg3,
                    *_host_graphs(cfg3, NODES_3D, LATENT_3D, "3D flagship"), seq=SEQ_3D,
                    check_batch=1, check_dtypes=("fp32", "bf16"), batch=BATCH_3D,
                    steps_per_epoch=STEPS_PER_EPOCH_3D,
                    forward_launches=FORWARD_LAUNCHES_3D,
                    train_launches=TRAIN_LAUNCHES_3D)
    aniso = flagship._replace(
        name="3D flagship, anisotropic lattice", check_dtypes=("fp32",), batch=0,
        **dict(zip(("coords", "lat", "enc", "dec"), _host_graphs(
            cfg3, NODES_3D, LATENT_3D, "3D anisotropic", axis_scale=AXIS_SCALE_3D))))
    cfg_long = copy.deepcopy(cfg3)
    cfg_long.model.args.transformer.patch_size = PATCH_LONG
    long_path = flagship._replace(name="3D long", cfg=cfg_long, seq=SEQ_LONG,
                                  check_batch=0, batch=BATCH_LONG)
    cfg_vx = merge_config(GAOTConfig, CONFIG_VX)
    coords_vx, lat_vx, enc_vx, dec_vx, bufs_vx = _host_graphs_vx(cfg_vx, "vx flagship")
    vx_path = Path("vx flagship", cfg_vx, coords_vx, lat_vx, enc_vx, dec_vx, seq=SEQ,
                   check_batch=VX_CHECK_BATCH, check_dtypes=("fp32", "bf16"),
                   batch=VX_BATCH, steps_per_epoch=1, forward_launches={},
                   train_launches={}, vx=bufs_vx)
    fwd_vx, train_vx = _vx_tables(_graph_args(vx_path, VX_BATCH, "cpu")[0],
                                  cfg_vx.model.args.transformer.num_layers, ffn=True)
    vx_path = vx_path._replace(forward_launches=fwd_vx, train_launches=train_vx)
    log(f"vx flagship launches: a forward {fwd_vx}; a training step {train_vx}")
    cases = _reduce_cases(main_path, "fx main path")
    cases3 = _reduce_cases(flagship, "3D flagship")
    cases_vx = _vx_reduce_cases(vx_path, "vx flagship")

    gen = torch.Generator(device="cuda").manual_seed(1)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    phase_widths(rnd)
    tcfg3 = cfg3.model.args.transformer
    h3 = tcfg3.attn_config.num_heads
    d3 = tcfg3.hidden_size // h3
    c3 = cfg3.model.args.magno.lifting_channels
    checks = {
        "main": {**check_multiply_reduce(rnd, BATCH, 64, cases, "fx main path"),
                 **check_flash(rnd, BATCH, SEQ, 8, 32), **check_ffn(rnd)},
        "3d": {**check_multiply_reduce(rnd, BATCH_3D, c3, cases3, "3D flagship"),
               **check_flash(rnd, BATCH_3D, SEQ_3D, h3, d3)},
        "long": {**check_multiply_reduce(rnd, BATCH_LONG, c3, cases3, "3D long"),
                 **check_flash(rnd, BATCH_LONG, SEQ_LONG, h3, d3, with_eval=False)},
        "vx": {**check_multiply_reduce(rnd, 1, cfg_vx.model.args.magno.lifting_channels,
                                       cases_vx, "vx flagship"),
               **check_flash(rnd, VX_BATCH, SEQ, 8, 32),
               **check_ffn(rnd, VX_BATCH * SEQ, extras=False)},
    }
    # The long backward's regime at a length where the plain versions hold
    # all heads at once; logged only.
    check_flash(rnd, 1, 8192, h3, d3, with_eval=False)
    torch.cuda.empty_cache()

    fwd = phase_forward(main_path)
    train, step_ms = phase_train(main_path)
    fwd3 = phase_forward(flagship)
    train3, _ = phase_train(flagship)
    phase_forward(aniso)
    phase_train(aniso)
    train_long, _ = phase_train(long_path)
    fwd_v = phase_forward(vx_path)
    train_v, step_ms_vx = phase_train(vx_path)
    trained = phase_trainer(card, step_ms)
    trained_vx = phase_vx_trainer(card, step_ms_vx)

    main_names = {k: k for k in SOURCES}
    main_names.update(fwd="flash_attention_fwd", fwd_lse="flash_attention_fwd_lse",
                      bwd="flash_attention_bwd")
    # The main path's launches are those of the trainer's run A, through
    # the CLI (its step and forward per call: phase 4's and phase 3's).
    main_counts = {k: trained[main_names[k]] for k in checks["main"]}
    names3 = dict(main_names, bwd="flash_attention_bwd_tiled")
    count = lambda run, keys: {k: run[main_names[k]] for k in keys}
    counts3 = count(train3, ("multiply_reduce_k", "multiply_reduce_b", "fwd_lse", "bwd"))
    counts3["fwd"] = fwd3["launches"]["flash_attention_fwd"]
    names_long = dict(main_names, bwd="flash_attention_bwd_long")
    counts_long = count(train_long, checks["long"])
    # The vx entries: the flagship's training step (its forward for the
    # flash forward without the LSE); the elasticity run's are logged.
    counts_vx = {k: train_v[main_names[k]] for k in checks["vx"] if k != "fwd"}
    counts_vx["fwd"] = fwd_v["launches"]["flash_attention_fwd"]
    log(f"vx trainer (elasticity) launches, by kernel: {trained_vx}")
    kernels_line = (_entries(checks["main"], main_names, main_counts, "fx main path")
                    + _entries(checks["3d"], names3, counts3, "3D flagship", "@3d")
                    + _entries(checks["long"], names_long, counts_long, "3D long",
                               "@long")
                    + _entries(checks["vx"], main_names, counts_vx, "vx flagship", "@vx"))
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
