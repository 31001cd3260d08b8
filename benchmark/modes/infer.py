"""Inference traffic: a closed loop of evaluation requests, one in flight.

Set-up builds the measured program as the training mode does (data from
the seed, the recipe's ``StaticTrainer``, the benchmark's weights), then a
pool of ``pool_requests`` requests, each ``request_samples`` held-out
samples (validation and test splits) drawn from the seed, normalised with
the training split's statistics as the recipe normalises and placed on the
card once, as the trainer's loaders place a split for its evaluation. Two
requests warm the evaluation forward.

The window: requests back to back, cycling through the pool; a request is
``StaticTrainer._eval`` (the batch placed on the card, the model's eager
evaluation forward, the masked MSE) and its prediction copied to the host,
timed from its dispatch to the copy's end. ``infer_samples_per_s`` is every
predicted sample over the window's seconds, ``infer_ms_p95`` the 95th
percentile of all its requests. A request is kept for the check where a
draw from the seed (one in ``sample_every``) picks it.

The check, once the window has closed and the program's state is freed:
the plain reference predicts every kept request's samples from the same
weights and inputs, and the worst sample's relative L2 gap of prediction
(``pred_gap``) is compared.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import counts, harness, trace
from benchmark.modes import train as train_mode
from benchmark.reference import train as ref_train
from benchmark.reference.precision import reference_precision


def pool_rows(ctx) -> list:
    """The dataset rows of each request of the pool: ``request_samples``
    held-out rows (validation and test splits) drawn from the seed."""
    ds, tf = ctx.config["config"]["dataset"], ctx.traffic
    total = ctx.arrays["u"].shape[0]
    held = np.r_[ds["train_size"]:ds["train_size"] + ds["val_size"],
                 total - ds["test_size"]:total]
    rng = np.random.default_rng(ctx.seeds["traffic"])
    n = tf["request_samples"]
    return [np.sort(rng.choice(held, n, replace=n > len(held)))
            for _ in range(tf["pool_requests"])]


def setup(ctx) -> None:
    train_mode.build_program(ctx)
    if ctx.trainer.coord_mode != "fx":
        raise NotImplementedError("inference requests of a mesh per sample carry their "
                                  "meshes' graphs; this mode serves one point cloud")
    ds = ctx.config["config"]["dataset"]
    a = ctx.arrays
    ctx.pool_rows = pool_rows(ctx)
    # The recipe's normalisation (the training split's statistics), made here.
    stats = {}
    for name in ("c", "u"):
        flat = a[name][:ds["train_size"], 0].reshape(-1, a[name].shape[-1])
        stats[name] = flat.mean(0), flat.std(0) + 1e-10

    def normalised(name, rows):
        mean, std = stats[name]
        z = (a[name][rows, 0] - mean) / std
        return torch.from_numpy(np.ascontiguousarray(z, dtype=np.float32)).to(ctx.device)

    ctx.pool = [{"c": normalised("c", r), "u": normalised("u", r),
                 "sample_mask": np.ones(len(r), dtype=bool)} for r in ctx.pool_rows]
    ctx.keep_draw = np.random.default_rng(ctx.seeds["traffic"] + 1)
    ctx.mark("pool")
    for i in range(2):
        _request(ctx, ctx.pool[i % len(ctx.pool)])
    ctx.mark("warm-up requests")


def _request(ctx, batch) -> np.ndarray:
    pred, _ = ctx.trainer._eval(batch)
    return pred.cpu().numpy()


def window(ctx) -> dict:
    every = ctx.traffic["sample_every"]
    times, kept = [], []
    samples = bad = 0
    fwd_events = []
    traced = {}
    on_card = ctx.device == "cuda"

    def one(i, events=None):
        nonlocal samples, bad
        j = i % len(ctx.pool)
        t0 = time.perf_counter()
        if events is not None:
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
        with record_function("bench.request"):
            pred, _ = ctx.trainer._eval(ctx.pool[j])
            if events is not None:
                e1 = torch.cuda.Event(enable_timing=True)
                e1.record()
                events.append((e0, e1))
            out = pred.cpu().numpy()
        times.append(time.perf_counter() - t0)
        samples += out.shape[0]
        with record_function("bench.check_finite"):
            bad += int(not np.isfinite(out).all())
        if ctx.keep_draw.random() * every < 1.0:
            kept.append((j, out))

    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    i = 0
    while True:
        if ctx.trace and i == 0:
            # Requests, at least ``traced_seconds`` of them.
            def stretch():
                nonlocal i
                t1 = time.perf_counter()
                while time.perf_counter() - t1 < ctx.traffic.get("traced_seconds", 0) or i == 0:
                    one(i, fwd_events)
                    i += 1
            traced["trace"] = trace.traced(stretch)
            traced_requests = i
        else:
            one(i, fwd_events if (ctx.trace and on_card) else None)
            i += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    window_s = time.perf_counter() - t0
    ctx.attempted, ctx.failed, ctx.window_s = i, bad, window_s
    ctx.kept = kept
    if not kept:                       # the draw kept none: the last request
        ctx.kept = [((i - 1) % len(ctx.pool), None)]
    readings = {"graph_build_s": ctx.graph_build_s, "mode": "infer", **traced}
    if traced:
        n = ctx.traffic["request_samples"]
        m = train_mode.model_shapes(ctx, n)
        enc, dec = train_mode.batch_edges(ctx, n)
        shared = ctx.trainer.coord_mode == "fx"
        readings.update(
            shapes=m, enc_edges=enc, dec_edges=dec, shared_graph=shared,
            requests=traced_requests,
            forward_ms=float(np.mean([a.elapsed_time(b) for a, b in fwd_events])),
            forward_flops=counts.forward_flops(m, enc, dec, shared),
            attn_forward_bound_s=counts.attention_forward_bound_s(m))
    ctx.readings = readings
    return {"infer_samples_per_s": samples / window_s,
            "infer_ms_p95": harness.percentile(times, 95) * 1e3}


def reference_predictions(ctx, rows_list, tf32: bool = False):
    cfg = ctx.config
    with reference_precision(tf32):
        prep = ref_train.prepare(ctx.arrays, cfg["config"], cfg["data"], ctx.device)
        return [ref_train.predict(ctx.w0, prep, list(r), ctx.device).numpy()
                for r in rows_list]


def pred_gap(pred: np.ndarray, ref: np.ndarray) -> float:
    """The worst sample's ‖pred − ref‖ / ‖ref‖."""
    p = pred.reshape(pred.shape[0], -1).astype(np.float64)
    r = ref.reshape(ref.shape[0], -1).astype(np.float64)
    return float(np.max(np.linalg.norm(p - r, axis=1) / np.linalg.norm(r, axis=1)))


def check(ctx) -> list:
    if any(out is None for _, out in ctx.kept):
        # No request kept: predict the last one again after the window.
        j = ctx.kept[0][0]
        ctx.kept = [(j, _request(ctx, ctx.pool[j]))]
    train_mode.release(ctx)
    distinct = sorted({j for j, _ in ctx.kept})
    refs = dict(zip(distinct, reference_predictions(ctx, [ctx.pool_rows[j] for j in distinct])))
    return [("pred_gap", max(pred_gap(out, refs[j]) for j, out in ctx.kept))]


def control(ctx) -> list:
    """The check's number with the reference in TF32 put in the program's
    place, over the whole pool."""
    rows = ctx.pool_rows
    low = reference_predictions(ctx, rows, tf32=True)
    ref = reference_predictions(ctx, rows)
    return [("pred_gap", max(pred_gap(a, b) for a, b in zip(low, ref)))]
