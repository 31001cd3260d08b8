"""Training traffic: the recipe's own fit loop, epochs back to back.

Set-up makes the data from the seed, builds the measured program's
``StaticTrainer`` from the configuration (data read from the written file,
graphs built on the host, model, AdamW with the 'mix' schedule), loads the
benchmark's weights into it, and takes the route the recipe's fit takes
(``steps_route``: on the card the epoch path, one training step captured as
a CUDA graph and replayed). The first epoch runs through
``train_epoch`` as every later one does; its first three steps are read
for the check (the losses; after step 1 the gradients, as AdamW's first
moment holds them; the weights after each step). One validation warms the
evaluation forward.

The window: cycles of ``eval_every_eps`` epochs, each through
``train_epoch`` (the tables copied in, the k steps replayed), then the
training loss read and ``validate`` over the validation split, as the fit
does; it closes at the first cycle's end past ``--seconds`` (a validation
ends in a read of its loss, a device barrier). ``train_samples_per_s`` is
every training sample of the window over its seconds.

The check, once the window has closed and the program's state is freed:
the plain reference takes the same weights and data and three steps of
its own on the first epoch's batches. The numbers: the worst step's loss
gap (``loss_gap``) and the first step's (``first_loss_gap``); the worst
gap between the program's loss of a later step and the reference's loss
of the program's own weights of the step before on that step's batch and
draws (``step_loss_gap``: the reference follows the program step by step,
so that what a later step draws or computes is judged apart from what the
weights carry over from the steps before); the worst leaf's gap of first-gradient
norms (``grad_gap``) and the median leaf's (``grad_median_gap``), the
worst leaf's gap of the norms of the weights' change over the three steps
(``update_gap``; leaves whose reference gradient is under a thousandth of
the median leaf's left out), each leaf's gap over the reference's norm of
that leaf or the median leaf's, whichever is larger. A cell compares those
its limits file names.
"""
from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import counts, data, harness, trace
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train
from benchmark.reference.precision import reference_precision

FIRST_STEPS = 3


def _edges(graph) -> int:
    """Valid edges of a program graph (dense or degree-bucketed)."""
    buckets = getattr(graph, "buckets", None) or (graph,)
    return int(sum(int(b.mask.sum()) for b in buckets))


def build_program(ctx) -> None:
    """The data, the trainer with the benchmark's weights (``ctx`` gains
    ``arrays``, ``trainer``, ``shapes``, ``w0`` and ``graph_build_s``)."""
    cfg, s = ctx.config, ctx.seeds
    from gaot_torch.data.graph_builder import GraphBuilder
    from gaot_torch.ops.cuda import build as kernel_build
    from gaot_torch.train import static_trainer
    from gaot_torch.train.static_trainer import StaticTrainer

    ctx.mark("import")
    if ctx.device == "cuda":
        kernel_build.build_all()          # compiles only what is missing or stale
        ctx.mark("kernel build")
    sizes = data.split_sizes(cfg["config"])
    ctx.arrays = data.make(cfg["data"], sum(sizes.values()), s["data"])
    ctx.folder = harness.scratch_dir()
    data.write(ctx.arrays, ctx.folder, cfg["config"]["dataset"]["name"])
    raw = harness.program_config(cfg, s["program"], ctx.folder, ctx.device)
    ctx.mark("data")

    # A span around each call into the host graph build (search, padding,
    # buckets, transpose graphs), summed.
    spent = [0.0]
    originals = []

    def timed(owner, name):
        fn = getattr(owner, name)
        originals.append((owner, name, fn))

        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[0] += time.perf_counter() - t0
        setattr(owner, name, wrapper)

    for owner, name in ((GraphBuilder, "build_fx_graphs"),
                        (GraphBuilder, "build_all_vx_graphs"),
                        (static_trainer, "prepare_fx_device_graphs")):
        timed(owner, name)
    try:
        ctx.trainer = StaticTrainer(raw)
    finally:
        for owner, name, fn in originals:
            setattr(owner, name, fn)
    ctx.graph_build_s = spent[0]
    ctx.mark(f"trainer (graph build {spent[0]:.3f} s)")
    a = ctx.arrays
    ctx.shapes = ref_model.Shapes(cfg["config"]["model"], a["c"].shape[-1], a["u"].shape[-1])
    w = ref_model.init_weights(ctx.shapes, s["weights"], ctx.device)
    ctx.trainer.model.load_state_dict(w, strict=True)
    ctx.w0 = {k: v.detach().cpu().clone() for k, v in w.items()}
    del w
    ctx.mark("weights")


def model_shapes(ctx, batch: int) -> counts.ModelShapes:
    sh, a = ctx.shapes, ctx.arrays
    return counts.ModelShapes(
        batch=batch, nodes=a["c"].shape[2], latent=int(np.prod(sh.grid)), cin=sh.cin,
        cout=sh.cout, lift=sh.lift, hidden=sh.hidden, mlp_layers=sh.mlp_layers,
        coord_dim=sh.d, tokens=sh.tokens, width=sh.width, heads=sh.heads, ffn=sh.ffn,
        layers=sh.layers, dtype=ctx.config["dtype"])


def batch_edges(ctx, batch: int):
    """(encoder, decoder) edges of a batch of ``batch`` samples: a shared
    graph's once; per-sample graphs at the training split's mean, thinned
    by ``max_neighbors`` where the recipe samples its edges."""
    tr = ctx.trainer
    if tr.coord_mode == "fx":
        return _edges(tr.graphs.encoder[0]), _edges(tr.graphs.decoder[0])
    bufs = tr.train_loader.host_buffers
    cap = tr.model_config.args.magno.max_neighbors
    out = []
    for side in ("enc", "dec"):
        deg = 0
        j = 0
        while f"{side}_b{j}_mask_0" in bufs:
            d = bufs[f"{side}_b{j}_mask_0"].sum(-1)
            deg = deg + (np.minimum(d, cap) if cap else d).sum(-1)
            j += 1
        if j == 0:
            d = bufs[f"{side}_mask_0"].sum(-1)
            deg = (np.minimum(d, cap) if cap else d).sum(-1)
        out.append(int(round(float(np.mean(deg)) * batch)))
    return tuple(out)


def _hook_steps(program, after):
    """Call ``after(t)`` after step t of the next epoch (t from 1)."""
    count = [0]
    target = program.captured if program.captured is not None else program
    name = "replay" if program.captured is not None else "_body"
    inner = getattr(target, name)

    def stepped():
        inner()
        count[0] += 1
        after(count[0])
    setattr(target, name, stepped)
    return lambda: delattr(target, name)


def setup(ctx) -> None:
    build_program(ctx)
    tr = ctx.trainer
    from gaot_torch.train.graphed import EpochProgram

    route, why = tr.steps_route()
    on_card = ctx.device == "cuda"
    if on_card and route != "graph":
        raise RuntimeError(f"the recipe's fit takes route {route!r} ({why}); the cell "
                           "measures the captured epoch path")
    ctx.route = route
    ctx.program = EpochProgram(tr, capture=on_card)
    names = {id(p): n for n, p in tr.model.named_parameters()}
    beta1 = tr.optimizer.param_groups[0]["betas"][0]
    first = {}

    def after(t):
        if t < FIRST_STEPS:
            first.setdefault("params_at", []).append(
                {n: p.detach().cpu().clone() for n, p in tr.model.named_parameters()})
        if t == 1:
            first["grad"] = {names[id(p)]: (tr.optimizer.state[p]["exp_avg"] / (1 - beta1))
                             .detach().cpu() for g in tr.optimizer.param_groups
                             for p in g["params"]}
        if t == FIRST_STEPS:
            first["params"] = {n: p.detach().cpu().clone()
                               for n, p in tr.model.named_parameters()}

    unhook = _hook_steps(ctx.program, after)
    try:
        losses, _ = tr.train_epoch(ctx.program)
    finally:
        unhook()
    first["losses"] = [float(v) for v in losses[:FIRST_STEPS].cpu()]
    ctx.first = first
    ctx.capture_s = (ctx.program.captured.capture_s
                     if ctx.program.captured is not None else None)
    ctx.mark(f"first epoch (capture {ctx.capture_s or 0.0:.3f} s)")
    tr.validate(tr.val_loader)
    ctx.mark("validation")


def window(ctx) -> dict:
    tr, prog = ctx.trainer, ctx.program
    every = tr.optimizer_config.args.eval_every_eps
    bsz = tr.train_loader.batch_size
    val_batches = len(tr.val_loader) if tr.val_loader is not None else 0
    samples = steps = bad = 0
    traced = {}

    def cycle(events=None):
        nonlocal samples, steps, bad
        stack = []
        for _ in range(every):
            if events is not None:
                e0 = torch.cuda.Event(enable_timing=True)
                e0.record()
            with record_function("bench.train_epoch"):
                losses, done = tr.train_epoch(prog)
            if events is not None:
                e1 = torch.cuda.Event(enable_timing=True)
                e1.record()
                events.append((e0, e1, len(losses)))
            stack.append(losses)
            samples += done
            steps += len(losses)
        with record_function("bench.read_losses"):
            losses = torch.cat(stack)
            float(losses.mean())
            bad += int((~torch.isfinite(losses)).sum())
        with record_function("bench.validate"):
            tr.validate(tr.val_loader)

    _sync(ctx)
    t0 = time.perf_counter()
    while True:
        if ctx.trace and not traced:
            # The first whole cycles of the window, ``traced_seconds`` or more.
            events = []

            def stretch():
                t1 = time.perf_counter()
                cycle(events)
                while time.perf_counter() - t1 < ctx.traffic.get("traced_seconds", 0):
                    cycle(events)
            traced["trace"] = trace.traced(stretch)
            traced["step_ms"] = (sum(a.elapsed_time(b) for a, b, _ in events)
                                 / sum(k for _, _, k in events))
            traced["steps"] = sum(k for _, _, k in events)
            traced["val_batches"] = val_batches * len(events) // every
        else:
            cycle()
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    _sync(ctx)
    window_s = time.perf_counter() - t0
    ctx.attempted, ctx.failed = steps, bad
    ctx.window_s = window_s
    readings = {"graph_build_s": ctx.graph_build_s, "capture_s": ctx.capture_s,
                "mode": "train", **traced}
    if traced:
        m = model_shapes(ctx, bsz)
        enc, dec = batch_edges(ctx, bsz)
        shared = tr.coord_mode == "fx"
        readings.update(
            shapes=m, enc_edges=enc, dec_edges=dec, shared_graph=shared,
            step_flops=counts.step_flops(m, enc, dec, shared),
            forward_flops=counts.forward_flops(m, enc, dec, shared),
            attn_bound_s=counts.attention_step_bound_s(m),
            attn_forward_bound_s=counts.attention_forward_bound_s(m),
            reduce_bound_s=counts.reduce_step_bound_s(m, enc, dec, shared),
            reduce_forward_bound_s=counts.reduce_step_bound_s(m, enc, dec, shared,
                                                              backward=False))
    ctx.readings = readings
    return {"train_samples_per_s": samples / window_s}


def _sync(ctx) -> None:
    if ctx.device == "cuda":
        torch.cuda.synchronize()


def release(ctx) -> None:
    """Free the program's state (graph, trainer) before the reference runs."""
    prog = getattr(ctx, "program", None)
    if prog is not None and prog.captured is not None:
        prog.captured.release()
    ctx.program = ctx.trainer = None
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaves(first: dict, ref: dict, w0: dict) -> dict:
    """Each step's loss on both sides and, a leaf each, the norms of the
    first gradient (``grad``: program, reference) and of the weights'
    change over the steps (``change``), and the median leaf's reference
    gradient norm."""
    gr = {k: _norm(v.cpu()) for k, v in ref["grad"].items()}
    return {"losses": list(zip(first["losses"], ref["losses"])),
            "followed": list(zip(first["losses"][1:], ref["followed"])),
            "grad": {k: (_norm(first["grad"][k]), gr[k]) for k in gr},
            "change": {k: (_norm(first["params"][k] - w0[k]),
                           _norm(ref["params"][k].cpu() - w0[k])) for k in gr},
            "median_grad": statistics.median(gr.values())}


def _leaf_gaps(pairs: dict, median: float) -> dict:
    return {k: abs(p - r) / max(r, median) for k, (p, r) in pairs.items()}


def compare(lv: dict) -> list:
    """[(name, value)] of the gaps (module docstring) from :func:`leaves`;
    ``first_loss_gap`` is the first step's alone."""
    gaps = [abs(a - b) / abs(b) for a, b in lv["losses"]]
    g = _leaf_gaps(lv["grad"], lv["median_grad"]).values()
    moved = {k: v for k, v in lv["change"].items()
             if lv["grad"][k][1] >= 1e-3 * lv["median_grad"]}
    d = _leaf_gaps(moved, statistics.median(r for _, r in moved.values()))
    step_gaps = [abs(a - b) / abs(b) for a, b in lv["followed"]]
    return [("loss_gap", max(gaps)), ("first_loss_gap", gaps[0]),
            ("step_loss_gap", max(step_gaps)),
            ("grad_gap", max(g)), ("grad_median_gap", statistics.median(g)),
            ("update_gap", max(d.values()))]


def detail(lv: dict, worst: int = 3) -> dict:
    """The leaves of the largest gradient and change gaps and those the
    change leaves out, from :func:`leaves` (for a calibration's record)."""
    med_g = lv["median_grad"]
    moved = {k: v for k, v in lv["change"].items() if lv["grad"][k][1] >= 1e-3 * med_g}
    med_d = statistics.median(r for _, r in moved.values())
    g = _leaf_gaps(lv["grad"], med_g)
    d = _leaf_gaps(moved, med_d)
    return {"losses": lv["losses"], "followed": lv["followed"],
            "grad": [(k, g[k], *lv["grad"][k]) for k in sorted(g, key=g.get)[::-1][:worst]],
            "update": [(k, d[k], *moved[k]) for k in sorted(d, key=d.get)[::-1][:worst]],
            "left_out": sorted(set(lv["change"]) - set(moved)), "median_grad": med_g,
            "median_change": med_d}


def reference_steps(ctx, tf32: bool = False, follow=None, **fault) -> dict:
    """The reference's first steps, following ``follow``'s weights after
    each step but the last (``fault``: one that
    :func:`~benchmark.reference.train.train_steps` plants)."""
    cfg = ctx.config
    with reference_precision(tf32):
        prep = ref_train.prepare(ctx.arrays, cfg["config"], cfg["data"], ctx.device)
        return ref_train.train_steps(ctx.w0, prep, cfg["config"], ctx.seeds["program"],
                                     FIRST_STEPS, ctx.device, follow=follow, **fault)


def check(ctx) -> list:
    release(ctx)
    ref = reference_steps(ctx, follow=ctx.first["params_at"])
    ctx.leaves = leaves(ctx.first, ref, ctx.w0)
    return compare(ctx.leaves)


def _as_program(steps: dict) -> dict:
    cpu = lambda d: {k: v.cpu() for k, v in d.items()}  # noqa: E731
    return {"losses": steps["losses"], "grad": cpu(steps["grad"]),
            "params_at": [cpu(p) for p in steps["params_at"]], "params": cpu(steps["params"])}


def _against_reference(ctx, program: dict) -> list:
    """The check's numbers of ``program`` (another side's first steps)."""
    return compare(leaves(program, reference_steps(ctx, follow=program["params_at"]), ctx.w0))


def control(ctx) -> list:
    """The check's numbers with the reference in TF32 put in the program's
    place (the nearest precision below the configuration's float32)."""
    return _against_reference(ctx, _as_program(reference_steps(ctx, tf32=True)))


def faults(ctx) -> dict:
    """The check's numbers with the reference put in the program's place
    and a fault planted in it: half of each batch left out (the mean over
    the rest); where the recipe drops edges, draws that do not advance
    from step to step (as a captured step whose generator is not
    registered with its graph would replay them). A step that leaves the
    state unchanged reads an update gap of 1 and needs no run."""
    planted = {"half_batch": {"keep": 0.5}}
    magno = ctx.config["config"]["model"]["args"]["magno"]
    if magno.get("sampling_strategy") and magno.get("max_neighbors"):
        planted["frozen_draws"] = {"frozen_draws": True}
    return {name: _against_reference(ctx, _as_program(reference_steps(ctx, **kw)))
            for name, kw in planted.items()}
