#!/usr/bin/env python3
"""Kernel and step times of several checkouts of the repository, side by
side in one run on one NVIDIA card.

    python3 kernel_ab.py ROOT [ROOT ...]          # e.g. old . . old
    python3 kernel_ab.py --build ROOT [ROOT ...]
    python3 kernel_ab.py --only fused_ffn --kernels-only ROOT [ROOT ...]
    python3 kernel_ab.py --only agno --kernels-only ROOT [ROOT ...]
    python3 kernel_ab.py --examples ROOT [ROOT ...]

ROOT is the root of a checkout (its gaot_torch/, chip_smoke.py and config/
are enough). Each ROOT runs in a process of its own, in the order given, so
a checkout named twice is measured twice, with the others in between. That
process imports the gaot_torch of its ROOT, builds its kernels if needed,
and times, on tensors made from one seed:
  - multiply_reduce_b at every (K, Q) one training step of each path runs
    (the shapes chip_smoke.py logs as "reduce shapes"), lanes W = b·C;
  - the bf16 flash forward, without and with the LSE, and the backward
    (dQ, dK, dV from the forward's output and LSE) at each path's shape,
    the backward with its largest error against the plain version where
    that fits the card (not at S = 32768); the same three in fp32 (the
    dtype the example configs train in) at the fx shape and at naca0012's
    (B = 32), with TF32 off; the same three, bf16 and fp32, of the route
    above head dim 128 at B 1, H 4 and (D, S) = (256, 4096), (512, 2048),
    (1024, 1024), (1024, 4096);
  - the bf16 SwiGLU forward and backward at the fx shape (R = 65536,
    M = 256, F = 1024) and at the other fused width (M = 128, F = 512),
    with their largest error against the plain versions;
  - the AGNO apply, forward and forward + backward (d_coef, d_f), of each
    path's encoder and decoder graph at its batch and channels, on the
    graphs the model is given (``bucketed_gather_multiply_reduce`` for the
    fx main path's bucketed encoder, ``gather_multiply_reduce_nbc``
    otherwise): the public functions, so every checkout times its own
    route through them;
  - with the flash cases, one fp32 SGEMM (8192^3, TF32 off): the rate the
    card reaches in fp32 products, with the precision settings it ran
    under and the name of the kernel cuBLAS chose; and the kernels one
    backward call of the route above head dim 128 launches;
  - the PyTorch library call that computes the same function (einsum; SDPA,
    or its aten entry that also returns the LSE (the flash entry in bf16,
    the memory-efficient one in fp32), and SDPA's autograd; the
    SwiGLU's three products, and autograd of them);
each on three yardsticks:
  single   median of 20 calls, each timed alone between two CUDA events:
           the host's time to issue the call, then its device time;
  batched  20 calls issued back to back between two CUDA events, over their
           count: the host issues a call while the card runs the one
           before, so this reads the longer of the two;
  device   the device time of the kernels the calls ran (torch.profiler),
           per call.
Then it drives the fx main path's and the 3D flagship's batch forward and
training step (bf16, seeded random weights) through the drive of ROOT's own
chip_smoke.py, without its card-vs-CPU checks, which logs their host-clock
medians, device busy time and idle share.

--only KERNEL times that kernel's cases alone; --kernels-only skips the
paths' drive.

--build compiles each ROOT's kernels from nothing, one ROOT after another,
and reports the seconds each took.

--examples trains the example configs as shipped, in fp32, through each
ROOT's own chip_smoke.py (its phases 5, 5b and 5d, on their synthetic
data): the fx recipe (run C), elasticity and naca0012, whose training step
is also timed eager and captured as a CUDA graph; it reports each run's
samples/s after its first evaluation and naca0012's step ms both ways.

Prints each process's log, then a table of every number by ROOT and run;
writes them to chiprun_out/kernel_ab.json.
"""
import argparse
import importlib.util
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "chiprun_out", "kernel_ab.json")

# path: (b, C, [(K, Q) of each multiply_reduce_b launch of one training step])
MULRED_B = {"fx": (64, 64, [(5, 1536), (8, 1664), (12, 1024), (24, 128), (8, 8192)]),
            "3d": (4, 16, [(8, 262144), (8, 32768)]),
            "long": (1, 16, [(8, 262144), (8, 32768)])}
# path: (B, S, H = Hkv, D) of its flash calls
FLASH = {"fx": (64, 1024, 8, 32), "3d": (4, 4096, 8, 24), "long": (1, 32768, 8, 24)}
# path: (B, S, H = Hkv, D) of the fp32 flash cases
FLASH_F32 = {"fx": (64, 1024, 8, 32), "naca": (32, 1024, 8, 32)}
# (B, S, H = Hkv, D) of the route above head dim 128, bf16 and fp32 (no path
# runs it)
FLASH_WIDE = [(1, 4096, 4, 256), (1, 2048, 4, 512), (1, 1024, 4, 1024), (1, 4096, 4, 1024)]
# (R, M, F) of the fx path's SwiGLU calls, and of the other fused width
SWIGLU = {"fx": (65536, 256, 1024), "M128": (65536, 128, 512)}
ITERS = 20


def single_ms(fn):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def batched_ms(fn):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def device_ms(fn):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
    if us <= 0:
        raise RuntimeError("the profiler saw no device time")
    return us / ITERS / 1e3


def kernel_names(fn, tries=3):
    """{device kernel name: launches} of one call (torch.profiler): the
    fullest of ``tries`` traces, since a trace can lose records (the device
    yardstick of a process whose traces lose them reads short)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.key: e.count for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation}
        if sum(names.values()) > sum(best.values()):
            best = names
    return best


def yardsticks(fn):
    return {"single": single_ms(fn), "batched": batched_ms(fn), "device": device_ms(fn)}


def kernel_times(only=None):
    """{case: {"kernel" | "library": {yardstick: ms}}} at the paths' shapes;
    multiply_reduce_b's cases are also summed over a path's shapes. With
    `only`, the cases of that kernel alone."""
    import torch

    from gaot_torch.ops.cuda import flash_attention as fa
    from gaot_torch.ops.cuda import multiply_reduce as mr

    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    res = {}
    for path, (b, c, shapes) in MULRED_B.items() if only in (None, "multiply_reduce_b") else ():
        total = {}
        for k, q in shapes:
            gath = rnd(k, q, b * c).bfloat16()
            dout = rnd(q, b * c).bfloat16()
            err = float((mr.multiply_reduce_b(gath, dout, b).float()
                         - mr.multiply_reduce_b_plain(gath, dout, b).float()).abs().max())
            g4, d3 = gath.view(k, q, b, c), dout.view(q, b, c)
            case = {"kernel": yardsticks(lambda: mr.multiply_reduce_b(gath, dout, b)),
                    "library": yardsticks(lambda: torch.einsum("kqbc,qbc->kqc", g4, d3)),
                    "max_abs_err": err}
            res[f"multiply_reduce_b {path} K={k} Q={q} b={b} C={c}"] = case
            for who in ("kernel", "library"):
                for y, v in case[who].items():
                    total.setdefault(who, {}).setdefault(y, 0.0)
                    total[who][y] += v
        res[f"multiply_reduce_b {path} (sum of {len(shapes)} shapes)"] = total
    sdpa = torch.nn.functional.scaled_dot_product_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [(path, shape, torch.bfloat16) for path, shape in FLASH.items()]
    cases += [(path, shape, torch.float32) for path, shape in FLASH_F32.items()]
    cases += [("wide", shape, dtype) for shape in FLASH_WIDE
              for dtype in (torch.bfloat16, torch.float32)]
    for path, (bb, s, h, d), dtype in cases if only in (None, "flash") else ():
        qkv = rnd(bb, s, 3, h, d).to(dtype)           # q, k, v: views of one buffer
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        shape = f"B={bb} S={s} H={h} D={d}"
        if dtype == torch.float32:
            shape = "fp32 " + shape
        if dtype == torch.float32 or d > 256:   # the flash entry takes bf16 up to D 256
            lib_lse = lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
                qh, kh, vh, None, True)
        else:
            lib_lse = lambda: torch.ops.aten._scaled_dot_product_flash_attention(qh, kh, vh)
        if path != "long":
            res[f"flash fwd {path} {shape}"] = {
                "kernel": yardsticks(lambda: fa.flash_attention(q, k, v)),
                "library": yardsticks(lambda: sdpa(qh, kh, vh))}
        res[f"flash fwd+LSE {path} {shape}"] = {
            "kernel": yardsticks(lambda: fa.flash_attention_lse(q, k, v)),
            "library": yardsticks(lib_lse)}
        out, lse = fa.flash_attention_lse(q, k, v)
        dout = rnd(bb, s, h, d).to(dtype)
        case = {"kernel": yardsticks(lambda: fa.flash_attention_bwd(q, k, v, out, dout, lse))}
        if path == "wide":   # the kernels one backward call launches
            case["kernels_per_call"] = sum(kernel_names(
                lambda: fa.flash_attention_bwd(q, k, v, out, dout, lse)).values())
        leaves = [t.detach().requires_grad_(True) for t in (qh, kh, vh)]
        o_l, g_l = sdpa(*leaves), dout.transpose(1, 2).contiguous()
        case["library"] = yardsticks(
            lambda: torch.autograd.grad(o_l, leaves, g_l, retain_graph=True))
        del leaves, o_l, g_l
        if 4 * bb * h * s * s <= 2 ** 33:   # the plain version's fp32 [B, H, S, S]
            # dQ, dK, dV: the largest error over their largest value
            got = fa.flash_attention_bwd(q, k, v, out, dout, lse)
            want = fa.attention_bwd_plain(q, k, v, out, dout)
            case["max_rel_err"] = max(
                float((g.float() - w.float()).abs().max() / w.float().abs().max())
                for g, w in zip(got, want))
            del got, want
        res[f"flash bwd {path} {shape}"] = case
        del qkv, q, k, v, qh, kh, vh, out, lse, dout
        torch.cuda.empty_cache()
    if only in (None, "flash"):
        # The rate the card reaches in fp32 products without TF32: one
        # cuBLAS SGEMM, a yardstick for the fp32 flash kernels, with the
        # precision settings it ran under and the kernel cuBLAS chose (its
        # name says whether the products ran in fp32, TF32 or split).
        a, b = rnd(8192, 8192), rnd(8192, 8192)
        matmul = torch.backends.cuda.matmul
        info = {"float32_matmul_precision": torch.get_float32_matmul_precision(),
                "allow_tf32": matmul.allow_tf32,
                "fp32_precision": getattr(matmul, "fp32_precision", "(not in this torch)"),
                "kernels": kernel_names(lambda: a @ b)}
        res["sgemm fp32 8192^3 (TF32 off)"] = {"library": yardsticks(lambda: a @ b),
                                               "info": info}
        del a, b
    from gaot_torch.ops.cuda import fused_ffn as ff

    silu = torch.nn.functional.silu
    for what, (r, m, f) in SWIGLU.items() if only in (None, "fused_ffn") else ():
        shape = f"{what} R={r} M={m} F={f}"
        x, dout = rnd(r, m).bfloat16(), rnd(r, m).bfloat16()
        w1, w3 = (rnd(f, m) / m ** 0.5).bfloat16(), (rnd(f, m) / m ** 0.5).bfloat16()
        w2 = (rnd(m, f) / f ** 0.5).bfloat16()
        err = float((ff.fused_ffn(x, w1, w3, w2).float()
                     - ff.fused_ffn_plain(x, w1, w3, w2).float()).abs().max())
        res[f"fused_ffn fwd {shape}"] = {
            "kernel": yardsticks(lambda: ff.fused_ffn(x, w1, w3, w2)),
            "library": yardsticks(lambda: (silu(x @ w1.t()) * (x @ w3.t())) @ w2.t()),
            "max_abs_err": err}
        # dx, dW1, dW3, dW2: the largest error over their largest value
        got = ff.fused_ffn_bwd(x, w1, w3, w2, dout)
        want = ff.fused_ffn_bwd_plain(x, w1, w3, w2, dout)
        err = max(float((g.float() - w.float()).abs().max() / w.float().abs().max())
                  for g, w in zip(got, want))
        del got, want
        leaves = [t.detach().requires_grad_(True) for t in (x, w1, w3, w2)]
        out = (silu(leaves[0] @ leaves[1].t()) * (leaves[0] @ leaves[2].t())) @ leaves[3].t()
        res[f"fused_ffn bwd {shape}"] = {
            "kernel": yardsticks(lambda: ff.fused_ffn_bwd(x, w1, w3, w2, dout)),
            "library": yardsticks(lambda: torch.autograd.grad(out, leaves, dout,
                                                              retain_graph=True)),
            "max_rel_err": err}
        del x, dout, w1, w3, w2, leaves, out
        torch.cuda.empty_cache()
    return res


def _load_chip_smoke(root):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_of_root", os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def agno_times(root):
    """{case: {"kernel": {yardstick: ms}}}: the AGNO apply of each path's
    two graphs, forward and forward + backward (d_coef and d_f), on the
    graphs the model is given (bf16, B and C of the path): the fx main
    path's bucketed encoder (``bucketed_gather_multiply_reduce``) and dense
    decoder, the 3D flagship's and the long path's dense encoder and
    decoder (``gather_multiply_reduce_nbc``)."""
    import torch

    from gaot_torch.core.config import GAOTConfig, load_experiment_config, merge_config
    from gaot_torch.data.graph_builder import prepare_fx_device_graphs
    from gaot_torch.ops import gather_apply as ga
    from gaot_torch.ops.padding import BucketedGraph

    cs = _load_chip_smoke(root)
    cfg = load_experiment_config(cs.CONFIG)
    cfg3 = merge_config(GAOTConfig, cs.CONFIG_3D)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda").bfloat16()
    res = {}
    graphs3 = None
    for path, c, bb in (("fx", cfg, cs.BATCH), ("3d", cfg3, cs.BATCH_3D),
                        ("long", cfg3, cs.BATCH_LONG)):
        magno = c.model.args.magno
        if path == "fx":
            coords, lat, enc, dec = cs._host_graphs(c, cs.NUM_NODES, cs.LATENT, path)
        elif graphs3 is None:
            graphs3 = cs._host_graphs(c, cs.NODES_3D, cs.LATENT_3D, path)
        if path != "fx":
            coords, lat, enc, dec = graphs3
        n, nq, ch = coords.shape[0], lat.shape[0], magno.lifting_channels
        e, d, et, dt = prepare_fx_device_graphs(enc, dec, n, nq, magno, device="cuda")
        for side, g, t, n_src in (("encoder", e[0], et and et[0], n),
                                  ("decoder", d[0], dt and dt[0], nq)):
            f = rnd(n_src, bb, ch).requires_grad_(True)
            if isinstance(g, BucketedGraph):
                coefs = [rnd(*bk.indices.shape, ch).requires_grad_(True)
                         for bk in g.buckets]
                idx = [bk.indices for bk in g.buckets]
                fwd = lambda: ga.bucketed_gather_multiply_reduce(coefs, f, idx, g.tgraph)
                leaves = coefs + [f]
                shape = f"buckets {[tuple(i.shape) for i in idx]}"
            else:
                coef = rnd(*g.indices.shape, ch).requires_grad_(True)
                fwd = lambda: ga.gather_multiply_reduce_nbc(coef, f, g.indices, t.edge_pos,
                                                            t.query, t.mask)
                leaves = [coef, f]
                shape = f"{tuple(g.indices.shape)}, transpose {tuple(t.mask.shape)}"
            dout = rnd(*fwd().shape)

            def step():
                return torch.autograd.grad(fwd(), leaves, dout)

            with torch.no_grad():
                res[f"agno fwd {path} {side} {shape} B={bb} C={ch}"] = {
                    "kernel": yardsticks(fwd)}
            res[f"agno fwd+bwd {path} {side} {shape} B={bb} C={ch}"] = {
                "kernel": yardsticks(step)}
            del f, leaves, dout
            torch.cuda.empty_cache()
    return res


def drive_paths(root):
    """The batch forward and training step of the fx main path and the 3D
    flagship through ROOT's chip_smoke.py (launch counts checked there)."""
    cs = _load_chip_smoke(root)
    from gaot_torch.core.config import GAOTConfig, load_experiment_config, merge_config

    cs.phase_card()
    cfg = load_experiment_config(cs.CONFIG)
    cfg3 = merge_config(GAOTConfig, cs.CONFIG_3D)
    paths = [
        cs.Path("fx main path", cfg, *cs._host_graphs(cfg, cs.NUM_NODES, cs.LATENT,
                                                      "fx main path"),
                seq=cs.SEQ, check_batch=0, check_dtypes=(), batch=cs.BATCH,
                steps_per_epoch=cs.STEPS_PER_EPOCH, forward_launches=cs.FORWARD_LAUNCHES,
                train_launches=cs.TRAIN_LAUNCHES),
        cs.Path("3D flagship", cfg3, *cs._host_graphs(cfg3, cs.NODES_3D, cs.LATENT_3D,
                                                      "3D flagship"),
                seq=cs.SEQ_3D, check_batch=0, check_dtypes=(), batch=cs.BATCH_3D,
                steps_per_epoch=cs.STEPS_PER_EPOCH_3D,
                forward_launches=cs.FORWARD_LAUNCHES_3D,
                train_launches=cs.TRAIN_LAUNCHES_3D)]
    for path in paths:
        cs.phase_forward(path)
        cs.phase_train(path)


def examples(root):
    """Phase 5 (runs A to C), 5b and 5d of ROOT's chip_smoke.py."""
    import torch

    cs = _load_chip_smoke(root)
    card = cs.phase_card()
    cs.phase_build()
    gen = torch.Generator(device="cuda").manual_seed(1)
    cs.phase_trainer(card, float("nan"))
    cs.phase_vx_trainer(card, float("nan"))
    cs.phase_naca(card, lambda *s: torch.randn(*s, generator=gen, device="cuda"))


def child(root, build_only, only, kernels_only, with_examples=False):
    sys.path.insert(0, root)
    import torch

    import gaot_torch
    from gaot_torch.ops.cuda import build

    if not os.path.abspath(gaot_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {gaot_torch.__file__}, not the gaot_torch of {root}")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    if with_examples:
        examples(root)
        return
    if build_only:
        shutil.rmtree(build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    secs = build.build_all()
    result = {"build_wall_s": time.perf_counter() - t0, "build_s": secs}
    if not build_only:
        result["kernels"] = kernel_times(only)
        if only in (None, "agno"):
            result["kernels"].update(agno_times(root))
    print("RESULT " + json.dumps(result), flush=True)
    if not (build_only or kernels_only):
        drive_paths(root)


TIMES = re.compile(r"(forward_ms|step_ms) median=([\d.]+) min=([\d.]+) max=([\d.]+)")
EXAMPLES = {   # what: the chip_smoke.py log line that holds it
    "run C fp32 samples/s": re.compile(r"trainer run C fp32 .* ([\d.]+) samples/s after it"),
    "elasticity fp32 samples/s": re.compile(
        r"vx trainer elasticity fp32 .* ([\d.]+) samples/s after it"),
    "naca0012 step ms eager": re.compile(r"phase 11 naca0012 .*: step ms eager ([\d.]+) /"),
    "naca0012 step ms graph": re.compile(r"phase 11 naca0012 .*: step ms eager [\d.]+ / "
                                         r"graph ([\d.]+)"),
}
PIPE = re.compile(r"pipelined (.*) \(\d+ back to back\): wall_ms=([\d.]+) "
                  r"device_busy_ms=([\d.]+) idle_share=([\d.]+)")


def parse(out):
    """The child's RESULT line and its paths' timings, or (--examples) the
    examples' numbers."""
    result = None
    found = {what: float(m[1]) for line in out.splitlines()
             for what, rx in EXAMPLES.items() for m in [rx.search(line)] if m}
    if found:
        return {"examples": found}
    for line in out.splitlines():
        if line.startswith("RESULT "):
            result = json.loads(line[len("RESULT "):])
            continue
        m = TIMES.search(line)
        if m:
            result.setdefault("host", []).append(
                {"median": float(m[2]), "min": float(m[3]), "max": float(m[4])})
        m = PIPE.search(line)
        if m:
            result["host"][-1].update(what=m[1], wall=float(m[2]), busy=float(m[3]),
                                      idle=float(m[4]))
    return result


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--build", action="store_true",
                    help="only build each ROOT's kernels from nothing, and time it")
    ap.add_argument("--only", choices=("multiply_reduce_b", "flash", "fused_ffn", "agno"),
                    help="time this kernel's cases alone")
    ap.add_argument("--kernels-only", action="store_true",
                    help="time the kernels, without driving the paths")
    ap.add_argument("--examples", action="store_true",
                    help="train the fp32 example configs through each ROOT's chip_smoke.py")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    roots = [os.path.abspath(r) for r in args.roots]
    if args.child:
        child(roots[0], args.build, args.only, args.kernels_only, args.examples)
        return 0
    runs = []
    for i, root in enumerate(roots):
        cmd = [sys.executable, os.path.abspath(__file__), "--child", root]
        if args.build:
            cmd.append("--build")
        if args.only:
            cmd += ["--only", args.only]
        if args.kernels_only:
            cmd.append("--kernels-only")
        if args.examples:
            cmd.append("--examples")
        print(f"=== run {i}: {root}", flush=True)
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=root)
        print(proc.stdout, flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-8000:], file=sys.stderr, flush=True)
            print(f"kernel_ab FAILED: run {i} ({root}) exited {proc.returncode}",
                  file=sys.stderr)
            return 1
        runs.append({"root": root, **parse(proc.stdout)})
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT + (".build" if args.build else ".examples" if args.examples else ""),
              "w") as f:
        json.dump(runs, f, indent=1)
    if args.examples:
        print("=== examples (one column per run, in order)")
        for what in EXAMPLES:
            print(f"{what}: " + " ".join(f"{r['examples'].get(what, float('nan')):.3f}"
                                         for r in runs))
        return 0
    print("=== table (ms; one column per run, in order)")
    for i, r in enumerate(runs):
        print(f"run {i}: {r['root']}: build wall {r['build_wall_s']:.1f}s "
              + " ".join(f"{k}={v:.1f}s" for k, v in r["build_s"].items()))
    if args.build:
        return 0
    for case in runs[0]["kernels"]:
        for who in ("kernel", "library"):
            if who not in runs[0]["kernels"][case]:
                continue
            for y in ("single", "batched", "device"):
                vals = " ".join(f"{r['kernels'][case][who][y]:.4f}" for r in runs)
                print(f"{case} | {who} | {y}: {vals}")
        for key in ("max_abs_err", "max_rel_err", "kernels_per_call"):
            if key in runs[0]["kernels"][case]:
                vals = " ".join(f"{r['kernels'][case].get(key, float('nan')):.3g}"
                                for r in runs)
                print(f"{case} | {key}: {vals}")
        for r in runs:
            if "info" in r["kernels"][case]:
                print(f"{case} | info: {json.dumps(r['kernels'][case]['info'])}")
    for j, h in enumerate(runs[0].get("host", [])):
        for key in ("median", "wall", "busy", "idle"):
            vals = " ".join(f"{r['host'][j][key]:.3f}" for r in runs)
            print(f"{h['what']} | {key}: {vals}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
