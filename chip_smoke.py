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
     batch 64): each kernel against its plain PyTorch version on the card,
     with CUDA-event timings of the kernel, the plain version and one
     PyTorch library call computing the same function (a yardstick only),
     and the least time the card could take (bound_ms).
  3. the fx GAOT forward at full width (8192 nodes, 64x64 latent grid,
     config/examples/time_indep/poisson_gauss.json) with seeded random
     weights: at batch 4 the kernel route on the card against the plain
     route on the CPU (fp32 and bf16), then at batch 64 in bf16 with the
     launch counters read around one forward, its timing, and a
     torch.profiler breakdown of its device time by kernel.
  4. prints one JSON line listing every kernel of the path.
The last line is {"ok": true, "device": {...}}.
"""
import json
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

    cfg = load_experiment_config(CONFIG).model
    rng = np.random.default_rng(0)
    coords = rng.uniform(-1, 1, (NUM_NODES, 2)).astype(np.float32)
    axes = [np.linspace(-1, 1, LATENT[0]), np.linspace(-1, 1, LATENT[1])]
    lat = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 2)
    lat = lat.astype(np.float32)
    builder = GraphBuilder.from_magno_config(cfg.args.magno)
    t0 = time.perf_counter()
    enc, dec = builder.build_fx_graphs(coords, lat, cfg.args.magno.radius,
                                       cfg.args.magno.scales)
    return cfg, coords, lat, enc, dec, builder, time.perf_counter() - t0


def phase_kernels(shapes):
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from gaot_torch.ops.cuda import flash_attention as fa
    from gaot_torch.ops.cuda import fused_ffn as ff
    from gaot_torch.ops.cuda import multiply_reduce as mr

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)
    rows = {}
    b, c = BATCH, 64
    w = b * c

    log("multiply_reduce_k (encoder buckets, dense decoder), W = 64·64:")
    agg = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
           "ops": 0.0, "err": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for k, q in shapes:
            coef = rnd(q, k, c).to(dtype).transpose(0, 1)      # K-major view
            gath = rnd(k, q, w).to(dtype)
            tol = (8e-3, 1e-2) if dtype == torch.bfloat16 else (1e-5, 1e-5)
            err = compare(f"mulred {str(dtype)[6:]} K={k} Q={q}",
                          mr.multiply_reduce_k(coef, gath, b),
                          mr.multiply_reduce_k_plain(coef, gath, b), *tol)
            if dtype != torch.bfloat16:
                continue
            isz = gath.element_size()
            nbytes = (k * q * w + k * q * c + q * w) * isz
            ops = 2.0 * k * q * w
            bnd = bound_ms(nbytes, ops, PEAK_FP32)[0]
            t_k = time_ms(lambda: mr.multiply_reduce_k(coef, gath, b))
            t_p = time_ms(lambda: mr.multiply_reduce_k_plain(coef, gath, b))
            g4 = gath.view(k, q, b, c)
            t_l = time_ms(lambda: torch.einsum("kqc,kqbc->qbc", coef, g4))
            log(f"    K={k} Q={q}: kernel_ms={t_k:.4f} plain_ms={t_p:.4f} "
                f"library_ms={t_l:.4f} bound_ms={bnd:.4f} "
                f"({nbytes / t_k / 1e6:.0f} GB/s)")
            agg["ms"] += t_k
            agg["plain_ms"] += t_p
            agg["library_ms"] += t_l
            agg["bytes"] += nbytes
            agg["ops"] += ops
            agg["err"] = max(agg["err"], err)
    rows["multiply_reduce_k"] = dict(
        max_abs_err=agg["err"], ms=agg["ms"], plain_ms=agg["plain_ms"],
        library_ms=agg["library_ms"],
        bound_ms=bound_ms(agg["bytes"], agg["ops"], PEAK_FP32)[0],
        bound_by=bound_ms(agg["bytes"], agg["ops"], PEAK_FP32)[1])

    log("flash attention forward, B=64 H=Hkv=8 S=1024 D=32:")
    bb, s, h, d = BATCH, 1024, 8, 32
    for dtype in (torch.bfloat16, torch.float32):
        # q/k/v as the block makes them: views of one [B, S, 3·H·D] buffer
        qkv = rnd(bb, s, 3, h, d).to(dtype)
        q, k_, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        tol = (1e-2, 2e-3) if dtype == torch.bfloat16 else (1e-4, 1e-5)
        err = compare(f"flash {str(dtype)[6:]}", fa.flash_attention(q, k_, v),
                      fa.attention_plain(q, k_, v), *tol)
        nbytes = 4 * bb * s * h * d * q.element_size()
        ops = 4.0 * bb * h * s * s * d
        peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
        bnd, by, term = bound_ms(nbytes, ops, peak, exps=float(bb * h * s * s))
        t_k = time_ms(lambda: fa.flash_attention(q, k_, v))
        t_p = time_ms(lambda: fa.attention_plain(q, k_, v), iters=5, warmup=1)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k_, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        t_l = time_ms(lambda: sdpa(qh, kh, vh))
        log(f"    {str(dtype)[6:]}: kernel_ms={t_k:.4f} plain_ms={t_p:.4f} "
            f"library_ms={t_l:.4f} bound_ms={bnd:.4f} ({term} binds; "
            f"{ops / t_k / 1e9:.1f} TFLOP/s)")
        if dtype == torch.bfloat16:
            rows["flash_attention_fwd"] = dict(
                max_abs_err=err, ms=t_k, plain_ms=t_p, library_ms=t_l,
                bound_ms=bnd, bound_by=by)

    log("fused SwiGLU forward, R=65536 M=256 F=1024 (bf16):")
    r, m, f = BATCH * 1024, 256, 1024
    x = rnd(r, m).bfloat16()
    w1 = (rnd(f, m) / m ** 0.5).bfloat16()
    w3 = (rnd(f, m) / m ** 0.5).bfloat16()
    w2 = (rnd(m, f) / f ** 0.5).bfloat16()
    err = compare("fused_ffn bfloat16", ff.fused_ffn(x, w1, w3, w2),
                  ff.fused_ffn_plain(x, w1, w3, w2), 1e-2, 1e-2)
    nbytes = (2 * r * m + 3 * m * f) * 2
    ops = 6.0 * r * m * f
    bnd, by, term = bound_ms(nbytes, ops, PEAK_BF16, exps=float(r * f))
    t_k = time_ms(lambda: ff.fused_ffn(x, w1, w3, w2))
    t_p = time_ms(lambda: ff.fused_ffn_plain(x, w1, w3, w2))
    silu = torch.nn.functional.silu
    t_l = time_ms(lambda: (silu(x @ w1.t()) * (x @ w3.t())) @ w2.t())
    log(f"    kernel_ms={t_k:.4f} plain_ms={t_p:.4f} library_ms={t_l:.4f} "
        f"bound_ms={bnd:.4f} ({term} binds; {ops / t_k / 1e9:.1f} TFLOP/s)")
    rows["fused_ffn_fwd"] = dict(max_abs_err=err, ms=t_k, plain_ms=t_p,
                                 library_ms=t_l, bound_ms=bnd, bound_by=by)
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


def phase_forward(cfg, coords, lat, enc, dec):
    import numpy as np
    import torch

    from gaot_torch.ops import cuda as kernels
    from gaot_torch.train.static_trainer import eval_step
    from gaot_torch.utils.routing import format_routes, reset_routes

    rng = np.random.default_rng(1)
    pndata = rng.normal(size=(BATCH, NUM_NODES, 1)).astype(np.float32)
    target = rng.normal(size=(BATCH, NUM_NODES, 1)).astype(np.float32)

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
        want_launches = {"multiply_reduce_k": 5, "flash_attention_fwd": 3,
                         "fused_ffn_fwd": 3}
        if launches != want_launches:
            fail(f"launch counts {launches}, expected {want_launches}")
        if pred.shape != (BATCH, NUM_NODES, 1) or not torch.isfinite(pred).all() \
                or not torch.isfinite(loss):
            fail("batch-64 forward: wrong shape or non-finite output")
        peak = torch.cuda.max_memory_allocated()
        times = []
        for _ in range(3):
            eval_step(model, graphs, xc, xp, xt, smask)
        torch.cuda.synchronize()
        for _ in range(10):
            t0 = time.perf_counter()
            eval_step(model, graphs, xc, xp, xt, smask)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        log(f"  forward_ms median={med * 1e3:.3f} min={min(times) * 1e3:.3f} "
            f"max={max(times) * 1e3:.3f} (10 runs) samples_per_s="
            f"{BATCH / med:.1f} max_memory_allocated={peak / 2**30:.3f} GiB "
            f"loss={float(loss):.4f}")
        profile_forward(lambda: eval_step(model, graphs, xc, xp, xt, smask))
        out["launches"] = launches
    return out


def profile_forward(run, steps: int = 10, top: int = 20):
    """Where the forward's time goes: forwards issued back to back (no
    synchronise in between), timed on the host clock without and then with
    torch.profiler; prints the device-busy time per forward, the device's
    idle share, the kernels per forward, and the kernels by device time."""
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
    # Device-side events only: the host ops that launched them carry the
    # same device time again.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / steps / 1e3
    if busy_ms <= 0:
        fail("the profiler saw no device time in the forward")
    log(f"  pipelined forward ({steps} back to back): wall_ms={wall * 1e3:.3f} "
        f"device_busy_ms={busy_ms:.3f} idle_share={1 - busy_ms / (wall * 1e3):.3f} "
        f"kernels_per_forward={sum(e.count for e in events) / steps:.0f}")
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
    from gaot_torch.ops.padding import bucketize_graph

    bg = bucketize_graph(enc[0], NUM_NODES)
    shapes = [(g.indices.shape[1], g.indices.shape[0]) for g in bg.buckets]
    shapes.append((dec[0].indices.shape[1], dec[0].indices.shape[0]))
    log(f"graphs: search={builder.search_method} host_build_s={graph_s:.2f} "
        f"encoder {tuple(enc[0].indices.shape)} buckets (K, Q) {shapes[:-1]}; "
        f"decoder dense {tuple(dec[0].indices.shape)}")
    if len(shapes) != 5:
        fail(f"expected 4 encoder buckets and a dense decoder, got {shapes}")

    rows = phase_kernels(shapes)
    fwd = phase_forward(cfg, coords, lat, enc, dec)

    sources = {"multiply_reduce_k": ("gaot_torch/csrc/multiply_reduce.cu",
                                     "gaot_tpu/ops/pallas/multiply_reduce.py:105"),
               "flash_attention_fwd": ("gaot_torch/csrc/flash_attention.cu",
                                       "gaot_tpu/ops/pallas/flash_attention.py:495"),
               "fused_ffn_fwd": ("gaot_torch/csrc/fused_ffn.cu",
                                 "gaot_tpu/ops/pallas/fused_ffn.py:136")}
    kernels_line = []
    for name, row in rows.items():
        src, rep = sources[name]
        kernels_line.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": fwd["launches"][name], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "per": ("sum of the 5 main-path shapes (one forward)"
                    if name == "multiply_reduce_k" else "one call"),
            "dtype": "bf16"})
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
