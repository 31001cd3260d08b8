#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gaot_torch) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits nonzero; no phase carries on past its own
failure):
  0. the card: torch.cuda must be available; prints nvidia-smi's name and
     power limit; TF32 off for fp32 products.
  1. build: compiles every hand-written kernel (gaot_torch/csrc/*.cu) with
     one nvcc per source, all at once.
  2. per-kernel checks at the fx main path's shapes (Poisson-Gauss width,
     batch 64), forward and backward kernels: each kernel against its plain
     PyTorch version on the card, with CUDA-event timings of the kernel, the
     plain version and one PyTorch library call computing the same function
     (a yardstick only), and the least time the card could take (bound_ms).
  3. the fx GAOT forward at full width (8192 nodes, 64x64 latent grid,
     config/examples/time_indep/poisson_gauss.json) with seeded random
     weights: at batch 4 the kernel route on the card against the plain
     route on the CPU (fp32 and bf16), then at batch 64 in bf16 with the
     launch counters read around one forward, its timing, and a
     torch.profiler breakdown of its device time by kernel.
  4. the fx training step (forward, masked MSE, backward through the
     kernels' gradients, AdamW with the 'mix' schedule) at the same width:
     at batch 4 the loss and every parameter's gradient on the card against
     the CPU plain route (fp32 and bf16), then at batch 64 in bf16 with the
     launch counters read around one step, a few more steps on one batch,
     the step timing and its torch.profiler breakdown.
  5. prints one JSON line listing every kernel of the two paths.
The last line is {"ok": true, "device": {...}}.
"""
import json
import math
import os
import statistics
import subprocess
import sys
import time

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

NUM_NODES, LATENT, BATCH = 8192, (64, 64), 64
STEPS_PER_EPOCH = 2048 // BATCH     # the config's train_size / batch_size

# Launches of each kernel in one batch-64 forward (evaluation) and in one
# training step.
FORWARD_LAUNCHES = {"multiply_reduce_k": 5, "flash_attention_fwd": 3,
                    "fused_ffn_fwd": 3}
TRAIN_LAUNCHES = {"multiply_reduce_k": 10, "multiply_reduce_b": 5,
                  "flash_attention_fwd_lse": 3, "flash_attention_bwd": 3,
                  "fused_ffn_fwd": 3, "fused_ffn_bwd": 3}
SOURCES = {   # kernel: (source, the TPU kernel's pallas_call it replaces)
    "multiply_reduce_k": ("gaot_torch/csrc/multiply_reduce.cu",
                          "gaot_tpu/ops/pallas/multiply_reduce.py:105"),
    "multiply_reduce_b": ("gaot_torch/csrc/multiply_reduce.cu",
                          "gaot_tpu/ops/pallas/multiply_reduce.py:146"),
    "flash_attention_fwd": ("gaot_torch/csrc/flash_attention.cu",
                            "gaot_tpu/ops/pallas/flash_attention.py:495"),
    "flash_attention_fwd_lse": ("gaot_torch/csrc/flash_attention.cu",
                                "gaot_tpu/ops/pallas/flash_attention.py:484"),
    "flash_attention_bwd": ("gaot_torch/csrc/flash_attention.cu",
                            "gaot_tpu/ops/pallas/flash_attention.py:416"),
    "fused_ffn_fwd": ("gaot_torch/csrc/fused_ffn.cu",
                      "gaot_tpu/ops/pallas/fused_ffn.py:136"),
    "fused_ffn_bwd": ("gaot_torch/csrc/fused_ffn.cu",
                      "gaot_tpu/ops/pallas/fused_ffn.py:174"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    log(smi.stdout.strip().splitlines()[0])     # name, power limit
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    from gaot_torch.ops.cuda import build

    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f}s wall "
        + " ".join(f"{k}={v:.1f}s" for k, v in secs.items()))
    for name, out in build.ptxas_info.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


def _main_path_graphs():
    """Host graphs of the main path, from the port's own builder."""
    import numpy as np

    from gaot_torch.core.config import load_experiment_config
    from gaot_torch.data.graph_builder import GraphBuilder

    cfg = load_experiment_config(CONFIG)
    magno = cfg.model.args.magno
    rng = np.random.default_rng(0)
    coords = rng.uniform(-1, 1, (NUM_NODES, 2)).astype(np.float32)
    axes = [np.linspace(-1, 1, LATENT[0]), np.linspace(-1, 1, LATENT[1])]
    lat = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 2)
    lat = lat.astype(np.float32)
    builder = GraphBuilder.from_magno_config(magno)
    t0 = time.perf_counter()
    enc, dec = builder.build_fx_graphs(coords, lat, magno.radius, magno.scales)
    return cfg, coords, lat, enc, dec, builder, time.perf_counter() - t0


def _row(err, ms, plain_ms, library_ms, bound, per, dtype="bf16"):
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound[0], bound_by=bound[1], per=per, dtype=dtype)


def check_multiply_reduce(rnd, shapes, df_shapes):
    """multiply_reduce_k at the forward's and d_f's shapes, multiply_reduce_b
    at the forward's gathered shapes."""
    import torch

    from gaot_torch.ops.cuda import multiply_reduce as mr

    b, c = BATCH, 64
    w = b * c
    rows = {}
    agg = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
           "ops": 0.0, "err": 0.0}
    for title, kq in (("forward: encoder buckets, dense decoder", shapes),
                      ("d_f: encoder in-degree groups, decoder transpose graph",
                       df_shapes)):
        log(f"multiply_reduce_k ({title}), W = 64·64:")
        for dtype in (torch.bfloat16, torch.float32):
            for k, q in kq:
                coef = rnd(q, k, c).to(dtype).transpose(0, 1)      # K-major view
                gath = rnd(k, q, w).to(dtype)
                tol = (8e-3, 1e-2) if dtype == torch.bfloat16 else (1e-5, 1e-5)
                err = compare(f"mulred_k {str(dtype)[6:]} K={k} Q={q}",
                              mr.multiply_reduce_k(coef, gath, b),
                              mr.multiply_reduce_k_plain(coef, gath, b), *tol)
                if dtype != torch.bfloat16:
                    continue
                nbytes = (k * q * w + k * q * c + q * w) * gath.element_size()
                ops = 2.0 * k * q * w
                bnd = bound_ms(nbytes, ops, PEAK_FP32)[0]
                t_k = time_ms(lambda: mr.multiply_reduce_k(coef, gath, b))
                t_p = time_ms(lambda: mr.multiply_reduce_k_plain(coef, gath, b))
                g4 = gath.view(k, q, b, c)
                t_l = time_ms(lambda: torch.einsum("kqc,kqbc->qbc", coef, g4))
                log(f"    K={k} Q={q}: kernel_ms={t_k:.4f} plain_ms={t_p:.4f} "
                    f"library_ms={t_l:.4f} bound_ms={bnd:.4f} "
                    f"({nbytes / t_k / 1e6:.0f} GB/s)")
                for key, val in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l),
                                 ("bytes", nbytes), ("ops", ops)):
                    agg[key] += val
                agg["err"] = max(agg["err"], err)
    rows["multiply_reduce_k"] = _row(
        agg["err"], agg["ms"], agg["plain_ms"], agg["library_ms"],
        bound_ms(agg["bytes"], agg["ops"], PEAK_FP32),
        "sum of the 10 main-path shapes (one training step; the forward runs "
        "the first 5)")

    log("multiply_reduce_b (d_coef of the forward's gathered rows), W = 64·64:")
    agg = dict.fromkeys(agg, 0.0)
    for dtype in (torch.bfloat16, torch.float32):
        for k, q in shapes:
            gath = rnd(k, q, w).to(dtype)
            dout = rnd(q, w).to(dtype)
            # fp32: 64-term sums in another order.
            tol = (8e-3, 1e-2) if dtype == torch.bfloat16 else (2e-5, 5e-5)
            err = compare(f"mulred_b {str(dtype)[6:]} K={k} Q={q}",
                          mr.multiply_reduce_b(gath, dout, b),
                          mr.multiply_reduce_b_plain(gath, dout, b), *tol)
            if dtype != torch.bfloat16:
                continue
            nbytes = (k * q * w + q * w + k * q * c) * gath.element_size()
            ops = 2.0 * k * q * w
            bnd = bound_ms(nbytes, ops, PEAK_FP32)[0]
            t_k = time_ms(lambda: mr.multiply_reduce_b(gath, dout, b))
            t_p = time_ms(lambda: mr.multiply_reduce_b_plain(gath, dout, b))
            g4, d3 = gath.view(k, q, b, c), dout.view(q, b, c)
            t_l = time_ms(lambda: torch.einsum("kqbc,qbc->kqc", g4, d3))
            log(f"    K={k} Q={q}: kernel_ms={t_k:.4f} plain_ms={t_p:.4f} "
                f"library_ms={t_l:.4f} bound_ms={bnd:.4f} "
                f"({nbytes / t_k / 1e6:.0f} GB/s)")
            for key, val in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l),
                             ("bytes", nbytes), ("ops", ops)):
                agg[key] += val
            agg["err"] = max(agg["err"], err)
    rows["multiply_reduce_b"] = _row(
        agg["err"], agg["ms"], agg["plain_ms"], agg["library_ms"],
        bound_ms(agg["bytes"], agg["ops"], PEAK_FP32),
        "sum of the 5 main-path shapes (one training step)")
    return rows


def check_flash(rnd):
    """The forward (with and without the LSE output) and the backward."""
    import torch

    from gaot_torch.ops.cuda import flash_attention as fa

    rows = {}
    bb, s, h, d = BATCH, 1024, 8, 32
    sdpa = torch.nn.functional.scaled_dot_product_attention
    log("flash attention, B=64 H=Hkv=8 S=1024 D=32:")
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        bf16 = dtype == torch.bfloat16
        peak = PEAK_BF16 if bf16 else PEAK_FP32
        # q/k/v as views of one [B, S, 3·H·D] buffer
        qkv = rnd(bb, s, 3, h, d).to(dtype)
        q, k_, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        tol = (1e-2, 2e-3) if bf16 else (1e-4, 1e-5)
        err = compare(f"flash fwd {name}", fa.flash_attention(q, k_, v),
                      fa.attention_plain(q, k_, v), *tol)
        out, lse = fa.flash_attention_lse(q, k_, v)
        want_out, want_lse = fa.attention_plain(q, k_, v, with_lse=True)
        err_lse = max(compare(f"flash fwd+LSE {name} out", out, want_out, *tol),
                      compare(f"flash fwd+LSE {name} lse", lse, want_lse, 1e-5, 1e-4))
        isz = q.element_size()
        fwd_ops, exps = 4.0 * bb * h * s * s * d, float(bb * h * s * s)
        bnd = bound_ms(4 * bb * s * h * d * isz, fwd_ops, peak, exps)
        t_k = time_ms(lambda: fa.flash_attention(q, k_, v))
        t_p = time_ms(lambda: fa.attention_plain(q, k_, v), iters=5, warmup=1)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k_, v))
        t_l = time_ms(lambda: sdpa(qh, kh, vh))
        log(f"    fwd {name}: kernel_ms={t_k:.4f} plain_ms={t_p:.4f} "
            f"library_ms={t_l:.4f} bound_ms={bnd[0]:.4f} ({bnd[2]} binds; "
            f"{fwd_ops / t_k / 1e9:.1f} TFLOP/s)")
        bnd_lse = bound_ms(4 * bb * s * h * d * isz + 4 * bb * h * s, fwd_ops, peak, exps)
        t_kl = time_ms(lambda: fa.flash_attention_lse(q, k_, v))
        t_pl = time_ms(lambda: fa.attention_plain(q, k_, v, with_lse=True),
                       iters=5, warmup=1)
        # One aten call returns the output and the natural-log row LSE (the
        # base-2 LSE times ln 2): the flash entry for bf16, the
        # memory-efficient entry for fp32.
        if bf16:
            lib_lse = lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                qh, kh, vh)[:2]
        else:
            lib_lse = lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
                qh, kh, vh, None, True)[:2]
        lse_gap = float((lib_lse()[1][..., :s].float() / math.log(2) - lse).abs().max())
        t_ll = time_ms(lib_lse)
        log(f"    fwd+LSE {name}: kernel_ms={t_kl:.4f} plain_ms={t_pl:.4f} "
            f"library_ms={t_ll:.4f} (its LSE / ln 2 within {lse_gap:.3e} of the "
            f"kernel's) bound_ms={bnd_lse[0]:.4f}")

        dout = rnd(bb, s, h, d).to(dtype)
        got = fa.flash_attention_bwd(q, k_, v, out, dout, lse)
        want = fa.attention_bwd_plain(q, k_, v, out, dout)
        # bf16: the kernel normalises p from the LSE where the plain version
        # folds the TPU kernel's per-row scales, so bf16 rounds at other
        # places; fp32: 1024-term sums in another order.
        rel = 3e-2 if bf16 else 1e-4
        err_bwd = max(compare_grad(f"flash bwd {name} d{n}", g, wt, rel)
                      for n, g, wt in zip("qkv", got, want))
        del got, want
        bwd_ops = 10.0 * bb * h * s * s * d
        bnd_bwd = bound_ms(8 * bb * s * h * d * isz + 4 * bb * h * s, bwd_ops,
                           peak, exps)
        t_kb = time_ms(lambda: fa.flash_attention_bwd(q, k_, v, out, dout, lse))
        t_pb = time_ms(lambda: fa.attention_bwd_plain(q, k_, v, out, dout),
                       iters=3, warmup=1)
        leaves = [t.detach().requires_grad_(True) for t in (qh, kh, vh)]
        o_l = sdpa(*leaves)
        g_l = dout.transpose(1, 2).contiguous()
        t_lb = time_ms(lambda: torch.autograd.grad(o_l, leaves, g_l,
                                                   retain_graph=True))
        log(f"    bwd {name}: kernel_ms={t_kb:.4f} plain_ms={t_pb:.4f} "
            f"library_ms={t_lb:.4f} bound_ms={bnd_bwd[0]:.4f} ({bnd_bwd[2]} binds; "
            f"{bwd_ops / t_kb / 1e9:.1f} TFLOP/s)")
        del o_l, leaves
        if bf16:
            rows["flash_attention_fwd"] = _row(err, t_k, t_p, t_l, bnd, "one call")
            rows["flash_attention_fwd_lse"] = _row(err_lse, t_kl, t_pl, t_ll,
                                                   bnd_lse, "one call")
            rows["flash_attention_bwd"] = _row(err_bwd, t_kb, t_pb, t_lb, bnd_bwd,
                                               "one call")
    return rows


def check_ffn(rnd):
    import torch

    from gaot_torch.ops.cuda import fused_ffn as ff

    rows = {}
    log("fused SwiGLU, R=65536 M=256 F=1024 (bf16):")
    r, m, f = BATCH * 1024, 256, 1024
    x = rnd(r, m).bfloat16()
    w1 = (rnd(f, m) / m ** 0.5).bfloat16()
    w3 = (rnd(f, m) / m ** 0.5).bfloat16()
    w2 = (rnd(m, f) / f ** 0.5).bfloat16()
    err = compare("fused_ffn fwd bfloat16", ff.fused_ffn(x, w1, w3, w2),
                  ff.fused_ffn_plain(x, w1, w3, w2), 1e-2, 1e-2)
    ops = 6.0 * r * m * f
    bnd = bound_ms((2 * r * m + 3 * m * f) * 2, ops, PEAK_BF16, exps=float(r * f))
    t_k = time_ms(lambda: ff.fused_ffn(x, w1, w3, w2))
    t_p = time_ms(lambda: ff.fused_ffn_plain(x, w1, w3, w2))
    silu = torch.nn.functional.silu
    t_l = time_ms(lambda: (silu(x @ w1.t()) * (x @ w3.t())) @ w2.t())
    log(f"    fwd: kernel_ms={t_k:.4f} plain_ms={t_p:.4f} library_ms={t_l:.4f} "
        f"bound_ms={bnd[0]:.4f} ({bnd[2]} binds; {ops / t_k / 1e9:.1f} TFLOP/s)")
    rows["fused_ffn_fwd"] = _row(err, t_k, t_p, t_l, bnd, "one call")

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
    t_kb = time_ms(lambda: ff.fused_ffn_bwd(x, w1, w3, w2, dout))
    t_pb = time_ms(lambda: ff.fused_ffn_bwd_plain(x, w1, w3, w2, dout), iters=5)
    leaves = [t.detach().requires_grad_(True) for t in (x, w1, w3, w2)]
    xl, w1l, w3l, w2l = leaves
    out = (silu(xl @ w1l.t()) * (xl @ w3l.t())) @ w2l.t()
    t_lb = time_ms(lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True))
    log(f"    bwd: kernel_ms={t_kb:.4f} plain_ms={t_pb:.4f} library_ms={t_lb:.4f} "
        f"bound_ms={bnd_b[0]:.4f} ({bnd_b[2]} binds; {ops_b / t_kb / 1e9:.1f} TFLOP/s)")
    rows["fused_ffn_bwd"] = _row(err_bwd, t_kb, t_pb, t_lb, bnd_b, "one call")
    return rows


def phase_kernels(shapes, df_shapes):
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    rows = check_multiply_reduce(rnd, shapes, df_shapes)
    rows.update(check_flash(rnd))
    rows.update(check_ffn(rnd))
    torch.cuda.empty_cache()
    return rows


def _model_and_graphs(cfg, lat, enc, dec, dtype, device):
    import torch

    from gaot_torch.data.graph_builder import prepare_fx_device_graphs
    from gaot_torch.models import GAOT
    from gaot_torch.train.static_trainer import FxGraphs

    e, d, et, dt = prepare_fx_device_graphs(enc, dec, NUM_NODES, lat.shape[0],
                                            cfg.args.magno, device=device)
    graphs = FxGraphs(torch.from_numpy(lat).to(device), e, d, et, dt)
    model = GAOT(1, 1, cfg, dtype=dtype, device=device,
                 generator=torch.Generator().manual_seed(0)).eval()
    return model, graphs


def _batch(seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    pndata = rng.normal(size=(BATCH, NUM_NODES, 1)).astype(np.float32)
    target = rng.normal(size=(BATCH, NUM_NODES, 1)).astype(np.float32)
    return pndata, target


def _expect_launches(what, counts, want):
    full = dict.fromkeys(counts, 0)
    full.update(want)
    if counts != full:
        fail(f"{what}: launch counts {counts}, expected {full}")


def phase_forward(cfg, coords, lat, enc, dec):
    import torch

    from gaot_torch.ops import cuda as kernels
    from gaot_torch.train.static_trainer import eval_step
    from gaot_torch.utils.routing import format_routes, reset_routes

    pndata, target = _batch(1)
    out = {}
    for name, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        mg = {dev: _model_and_graphs(cfg, lat, enc, dec, dtype, dev)
              for dev in ("cuda", "cpu")}
        t = lambda a, dev: torch.from_numpy(a[:4]).to(dev)
        preds = {}
        for dev, (model, graphs) in mg.items():
            pred, _ = eval_step(model, graphs, torch.from_numpy(coords).to(dev),
                                t(pndata, dev), t(target, dev),
                                torch.ones(4, dtype=torch.bool, device=dev))
            preds[dev] = pred.float().cpu()
        got, want = preds["cuda"], preds["cpu"]
        if got.shape != (4, NUM_NODES, 1) or not torch.isfinite(got).all():
            fail(f"batch-4 {name} forward: shape {tuple(got.shape)} or non-finite")
        rel = float((got - want).norm() / want.norm())
        scale = float(want.abs().max())
        if dtype is None:
            ok = torch.allclose(got, want, rtol=1e-3, atol=1e-3 * scale)
            tol = f"rtol 1e-3, atol 1e-3·max|ref| = {1e-3 * scale:.2e}"
        else:
            ok = rel <= 2e-2
            tol = "relative L2 <= 2e-2 (bf16 rounds at other places on the CPU)"
        log(f"forward batch 4 {name}: card vs CPU plain route rel_l2={rel:.3e} "
            f"max_abs={float((got - want).abs().max()):.3e} ({tol}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"batch-4 {name} forward disagrees with the CPU plain route")
        out[name] = rel
        if dtype is None:
            del mg
            continue

        model, graphs = mg["cuda"]
        del mg["cpu"]
        xc = torch.from_numpy(coords).cuda()
        xp = torch.from_numpy(pndata).cuda()
        xt = torch.from_numpy(target).cuda()
        smask = torch.ones(BATCH, dtype=torch.bool, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_routes()
        kernels.reset_launches()
        pred, loss = eval_step(model, graphs, xc, xp, xt, smask)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        log(f"forward batch {BATCH} bf16: launches {launches}")
        log(f"  routes: {format_routes()}")
        _expect_launches("forward", launches, FORWARD_LAUNCHES)
        if pred.shape != (BATCH, NUM_NODES, 1) or not torch.isfinite(pred).all() \
                or not torch.isfinite(loss):
            fail("batch-64 forward: wrong shape or non-finite output")
        peak = torch.cuda.max_memory_allocated()
        run = lambda: eval_step(model, graphs, xc, xp, xt, smask)
        log(f"  forward_ms {fmt_times(host_times(run, 10))} "
            f"max_memory_allocated={peak / 2**30:.3f} GiB loss={float(loss):.4f}")
        profile_step(run, "forward")
        out["launches"] = launches
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


def fmt_times(times: list) -> str:
    return (f"median={statistics.median(times):.3f} min={min(times):.3f} "
            f"max={max(times):.3f} ({len(times)} runs) samples_per_s="
            f"{BATCH / statistics.median(times) * 1e3:.1f}")


def phase_train(cfg, coords, lat, enc, dec):
    import torch

    from gaot_torch.ops import cuda as kernels
    from gaot_torch.train.schedules import make_optimizer
    from gaot_torch.train.static_trainer import train_step
    from gaot_torch.utils.routing import format_routes, reset_routes

    mcfg, ocfg = cfg.model, cfg.optimizer
    pndata, target = _batch(2)
    for name, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        res = {}
        for dev in ("cuda", "cpu"):
            model, graphs = _model_and_graphs(mcfg, lat, enc, dec, dtype, dev)
            opt, sched = make_optimizer(ocfg, model.parameters(), STEPS_PER_EPOCH)
            grads = {}
            opt.register_step_pre_hook(lambda *_: grads.update(
                {n: p.grad.detach().float().cpu()
                 for n, p in model.named_parameters()}))
            t = lambda a: torch.from_numpy(a[:4]).to(dev)
            loss = train_step(model, opt, sched, 0, graphs,
                              torch.from_numpy(coords).to(dev), t(pndata),
                              t(target), torch.ones(4, dtype=torch.bool, device=dev))
            res[dev] = (float(loss), grads)
            del model, graphs, opt
        (loss_c, g_c), (loss_p, g_p) = res["cuda"], res["cpu"]
        if set(g_c) != set(g_p) or not all(torch.isfinite(g).all() for g in g_c.values()):
            fail(f"batch-4 {name} training step: missing or non-finite gradients")
        gc = torch.cat([g_c[n].reshape(-1) for n in sorted(g_c)])
        gp = torch.cat([g_p[n].reshape(-1) for n in sorted(g_p)])
        rel = float((gc - gp).norm() / gp.norm())
        per = {n: float((g_c[n] - g_p[n]).abs().max()
                        / g_p[n].abs().max().clamp(min=1e-30)) for n in g_p}
        worst_name = max(per, key=per.get)
        worst = per[worst_name]
        loss_rel = abs(loss_c - loss_p) / abs(loss_p)
        if dtype is None:
            # fp32 sums in other orders, through the whole backward.
            ok = loss_rel <= 1e-4 and worst <= 1e-3
            tol = "loss rel 1e-4; each gradient within 1e-3 of its largest entry"
        else:
            # bf16 rounds at other places on the CPU. The per-tensor bound
            # holds the small leaves (norms, biases, one bucket's coef MLP),
            # which the global L2 cannot see; it is about 5x the worst
            # reading, 1.9e-2.
            ok = loss_rel <= 2e-2 and rel <= 5e-2 and worst <= 1e-1
            tol = ("loss rel 2e-2; relative L2 over all gradients <= 5e-2; each "
                   "gradient within 1e-1 of its largest entry")
        log(f"train step batch 4 {name}: card vs CPU plain route loss "
            f"{loss_c:.6f} vs {loss_p:.6f} (rel {loss_rel:.2e}); gradients "
            f"({len(g_p)} tensors) rel_l2={rel:.3e} worst_per_tensor={worst:.3e} "
            f"({worst_name}) ({tol}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"batch-4 {name} training step disagrees with the CPU plain route")
        del res, g_c, g_p, gc, gp

    model, graphs = _model_and_graphs(mcfg, lat, enc, dec, torch.bfloat16, "cuda")
    opt, sched = make_optimizer(ocfg, model.parameters(), STEPS_PER_EPOCH)
    xc = torch.from_numpy(coords).cuda()
    xp, xt = torch.from_numpy(pndata).cuda(), torch.from_numpy(target).cuda()
    smask = torch.ones(BATCH, dtype=torch.bool, device="cuda")
    step = [0]

    def run():
        loss = train_step(model, opt, sched, step[0], graphs, xc, xp, xt, smask)
        step[0] += 1
        return loss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_routes()
    kernels.reset_launches()
    losses = [run()]
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"train step batch {BATCH} bf16: launches {launches}")
    log(f"  routes: {format_routes()}")
    _expect_launches("training step", launches, TRAIN_LAUNCHES)
    losses += [run() for _ in range(4)]
    losses = [float(v) for v in losses]
    log(f"  AdamW 'mix' losses on one batch, steps 0-4: "
        + " ".join(f"{v:.5f}" for v in losses))
    if not all(map(math.isfinite, losses)):
        fail("batch-64 training step: non-finite loss")
    peak = torch.cuda.max_memory_allocated()
    log(f"  step_ms {fmt_times(host_times(run, 10))} "
        f"max_memory_allocated={peak / 2**30:.3f} GiB")
    profile_step(run, "training step")
    return launches


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


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "gaot_torch")):
        fail("gaot_torch/ not found next to chip_smoke.py: run it from a "
             "checkout of the repository")
    sys.path.insert(0, HERE)
    import torch

    phase_card()
    phase_build()

    cfg, coords, lat, enc, dec, builder, graph_s = _main_path_graphs()
    from gaot_torch.ops.padding import (TransposeGraph, bucketize_graph,
                                        degree_group_tgraph, transpose_graph)

    bg = bucketize_graph(enc[0], NUM_NODES)
    shapes = [(g.indices.shape[1], g.indices.shape[0]) for g in bg.buckets]
    shapes.append((dec[0].indices.shape[1], dec[0].indices.shape[0]))
    t = bg.tgraph
    groups = degree_group_tgraph(TransposeGraph(t.edge_pos[None], t.query[None],
                                                t.mask[None])).groups
    df_shapes = [(g.mask.shape[2], g.mask.shape[1]) for g in groups]
    dec_t = transpose_graph(dec[0], lat.shape[0])
    df_shapes.append((dec_t.mask.shape[1], dec_t.mask.shape[0]))
    log(f"graphs: search={builder.search_method} host_build_s={graph_s:.2f} "
        f"encoder {tuple(enc[0].indices.shape)} buckets (K, Q) {shapes[:-1]}; "
        f"decoder dense {tuple(dec[0].indices.shape)}; d_f (K, N): encoder "
        f"in-degree groups {df_shapes[:-1]}, decoder transpose {df_shapes[-1]}")
    if len(shapes) + len(df_shapes) != TRAIN_LAUNCHES["multiply_reduce_k"]:
        fail(f"expected 10 multiply-reduce shapes, got {shapes} and {df_shapes}")

    rows = phase_kernels(shapes, df_shapes)
    fwd = phase_forward(cfg.model, coords, lat, enc, dec)
    train = phase_train(cfg, coords, lat, enc, dec)

    kernels_line = []
    for name, row in rows.items():
        src, rep = SOURCES[name]
        launches = train[name] if name in TRAIN_LAUNCHES else fwd["launches"][name]
        kernels_line.append({"name": name, "route": "cuda", "source": src,
                             "replaces": rep, "launches": launches, **row})
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
