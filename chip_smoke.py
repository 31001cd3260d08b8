#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (gaot_torch) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Five paths run through the port's entry points, and the fx, elasticity,
sequential and naca0012 recipes train through the port's CLI (the
elasticity recipe also with a nonlinear transform, node_embedding and the
graph cache):
  - the fx main path: the Poisson-Gauss recipe (8192 nodes, 64x64 latent
    grid, config/examples/time_indep/poisson_gauss.json), batch 64;
  - the 3D flagship of scripts/train_demo.py::run_3d: 32768 nodes in
    [-1, 1]^3, a 64^3 latent grid, kNN graphs (k = 8), a UViT at patch 4
    (S = 4096 tokens) with 8 heads of dim 24, batch 4;
  - the long-sequence path: the same model at patch 2 (S = 32768), batch 1;
  - the vx flagship of bench.py::build_vx_workload: a mesh per sample, 16
    samples of 8192 nodes each in [-1, 1]^2, the 64x64 grid, degree-bucketed
    encoder and decoder with in-degree-grouped transpose graphs, the fx
    path's UViT, batch 16;
  - the sequential main path: config/examples/time_dep/ns_gauss.json at
    full width on the Poseidon sets' 128x128 lattice (16384 nodes, one
    point cloud), input 4 (u 2, the start time, the time difference),
    output 2, batch 64, and its autoregressive rollout.

Phases (any failure exits nonzero; no phase carries on past its own
failure):
  0. the card: torch.cuda must be available; prints nvidia-smi's name and
     power limit; TF32 off for fp32 products.
  1. build: compiles every hand-written kernel (gaot_torch/csrc/*.cu) with
     one nvcc per source, all at once; logs, from nvcc's -Xptxas -v, the
     registers, shared memory and spills of the bf16 and fp32 flash forward
     and backward, the multiply-reduces and the SwiGLU kernels and of every
     kernel that spills; fails if a bf16 SwiGLU kernel spills.
  1b. widths: the flash forward (with and without the LSE) and backward at
     every head dim from 8 to 128 and at 136, 256, 1024 (and 8192 at
     S = 128), bf16 and fp32, and the SwiGLU forward and backward at
     M = 128, 384, 512, 640, 768, 896, 1024, (4096, F 896) and (128,
     F 29056) in bf16 and M = 256, 640 in fp32, each against its plain
     version on the card at a small shape; then the fp32 flash kernels at
     every templated head dim at the edges of their tiles (S = 1 and one
     below and above 16, 32, 64 and 128 rows, GQA 4:2), and the routes
     above 128 (bf16 on wgmma, fp32 as split-TF32 wgmmas) at D = 136 and
     264 at theirs; the routes above 128 timed at four (D, S) beside SDPA
     (fp32 with its FFMA and split-TF32 bound shares), at D = 256,
     S = 4096 held against the plain versions, two kernels a backward. In
     phase 2 the fx path's reduces and the SwiGLU are timed in fp32 too
     (the example's dtype; the SwiGLU at M = 256 and 640 beside the three
     fp32 products), and the bf16 general SwiGLU route (every width but
     M = 128, 256) is held at M = 1024, F = 3584 against the plain
     versions (two backward calls bit for bit, 2 and 3 kernels a call),
     timed beside the library's three products and their autograd, and
     driven through one bf16 training step of the fx path at UViT hidden
     512 against the plain products' step. Just before the kernels line, a
     line of each phase's seconds (also on standard error).
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
  4b. the rollout of the sequential path (gaot_torch/models/rollout.py):
     at batch 2 the card's fp32 rollout against the CPU plain route's,
     every step within 1e-3 of that step's largest entry (the bf16 rollout's
     relative L2 by step logged); at batch 64 in bf16, each predict mode
     (7 / 1 / 4 forwards): launches equal to the forward's table times the
     forwards, ms a rollout and a forward, and (autoregressive) a profile
     with no row gather. Phases 2-4 run on this path too: its reduces on
     its own graphs, the launch tables derived from them.
  5c. the sequential trainer: run A, ns_gauss.json read from disk, bf16,
     through gaot_torch.cli.main in this process under a device-only
     profiler, on synthetic data at the Poseidon layout (tests/
     torch_synthetic.py: u [S, 21, 16384, 2], seed 0; the 21 steps cut to
     15), train/val/test 128 / 16 / 32 samples (3584 pairs an epoch), 2
     epochs with a validation each: launches equal to the step's table
     times 112 steps plus the forward's times 14 validation batches and 12
     rollout forwards, falling
     loss, the three rollout errors finite, checkpoint, loss record, CSV
     row, the kernels' routes, and PyTorch's row gather only in the
     loader's pair assembly (one index_select a batch). Run B, ce_crp.json
     in its own fp32 (4 channels, time_der) through gaot_torch.cli.main in
     this process, 64 / 16 / 32 samples, 2 epochs with a validation
     each: falling loss, finite errors, no SwiGLU (ffn=plain). Run C, vx
     sequential through SequentialTrainer (tests/synthetic.py's layout at
     4096 nodes a sample), 48 / 8 / 8 samples, batch 16, 2 epochs, fp32:
     launches equal to the tables of the trainer's graphs, falling loss,
     finite errors.
  5d. the naca0012 recipe (config/examples/time_indep/naca0012.json read
     from disk: vx, edge drop with sampling_strategy "max_neighbors" and
     max_neighbors 32) trained through gaot_torch.cli.main on synthetic
     data at the airfoil layout (tests/torch_synthetic.py: 6144 nodes a
     sample clustered around a NACA 0012 profile, seed 0), batch 32,
     128 / 16 / 32 samples, 6 epochs, its fp32, under a device-only
     profiler: launches equal to the tables of the CLI trainer's own graphs
     times its steps and evaluation batches, falling loss, finite metric,
     checkpoint, loss record, CSV row, the run's row gathers logged; then
     on that trainer: the encoder's degree histogram and the share of its
     edges each step's drop keeps (every bucket wider than 32 thinned to
     min(degree, 32) of its own edges, the decoder's graphs untouched), the
     same batch-32 step with and without the drop (launches, ms, device
     busy, kernels) and the evaluation forward, each profile without a row
     gather but the drop's reads of its uniforms (drawn in query order, one
     index_select a thinned bucket), the card against the CPU plain route
     at batch 2 on the
     same dropped masks (drawn once on the CPU; fp32 bounds of phase 4),
     and the multiply-reduces on the batch's masks with holes (ratio 0.5,
     then max_neighbors 32) against their plain versions, twice bit for
     bit.
  6. attention dropout 0.1 on the fx main path's bf16 step at batch 64:
     the route plain-dropout (no flash launch, every other launch the
     table's), a finite loss, the keep share of the three layers' draws
     within 4 sigma of 0.9, step ms, peak memory and a profile; at rate 0
     with a generator the step's launch table unchanged.
  7. the pointnet embedding (max pooling): the fx main path's forward and
     step (batch-4 fp32 check against the CPU, batch-64 bf16 launches,
     timings, profiles, no row gather) and the vx flagship's batch-2 fp32
     check.
  8. the model options no example sets, on the vx flagship's graphs: each
     of linear_kernelonly, nonlinear and nonlinear_kernelonly, and linear
     with node_embedding (the nonlinear ones on dense graphs, as the
     trainers build them): the batch-2 fp32 card vs CPU check of the
     forward and the step (phase 4's bounds), then the batch-16 bf16 step
     with its launch table held exactly (linear_kernelonly and
     node_embedding the linear vx table; the nonlinear transforms no
     multiply-reduce launch, their per-edge body as the reference runs it,
     and at most two row gathers a side and scale, its feature rows and
     their gradient rows), its median, peak memory and profile. Without
     transpose graphs
     (magno.use_transpose_backward false): the fx main path's step and the
     vx flagship's against the same steps with them, same weights and
     batch (the same loss bits; fp32 gradients within 1e-4 of each
     tensor's largest entry, bf16 within phase 4's bounds; launches less
     the d_f reduces and nothing else), then phase 4's drive of each
     (card vs CPU, launch table, median both ways). Then the elasticity
     recipe with transform_type nonlinear, node_embedding and
     dataset.graph_cache_dir, twice through gaot_torch.cli.main in this
     process (phase 5b's data cut to 64 / 16 / 16 samples, 2 epochs): the
     second run reads the cache from disk and gives the same losses bit for
     bit; both set-up times logged.
  10. multi-GPU training (gaot_torch/parallel/): (10.1) the fx recipe at
     phase 5's sizes, epochs and validation cadence through torchrun at one
     rank on NCCL with setup.distributed (in phase 12's torchrun process,
     which runs before the rest of phase 10): a falling loss, one CSV row,
     launches equal to phase 5's tables times its steps, samples/s (the CSV
     row's and the rate after the first evaluation) beside run B's, its
     like for like (a subprocess of the CLI, no profiler); (10.4) the
     checkpoint tools: 10.1's checkpoint exported and imported again, bit for
     bit; (10.2) two ranks on the one card over gloo (subprocesses of this
     script, --rank; LOCAL_RANK 0, init_distributed(..., backend="gloo")) at
     dp 2, mp 2 (tensor parallelism) and spatial_parallel at mp 2: an fp32
     check at a global batch of 8 (the loss within 1e-6 relative of one
     process on the card, every gradient and the weights after 3 AdamW
     steps within 1e-4 of their tensor's largest entry), then a bf16 step
     at a global batch of 64 (the launch table derived from the rank's
     graphs held exactly; at dp also per-rank ms and, from a profile, the
     device time of NCCL's kernels and of every copy in the step, gloo's
     round trips of the all-reduces through the host among them; two ranks
     share the card: not a multi-card speed; tp's and sp's are not timed,
     their gloo round trips through the host bind); then on vx data (a mesh
     per sample), spatial_parallel at mp 2 in one start of two ranks, one
     process's runs before them in this process: sp-vx, the vx flagship's
     model
     through the trainer on synthetic meshes of 8192 nodes (each rank's cut
     graphs through the graph cache: its second trainer must hit it), fp32
     at a global batch of 4 against one process (the bounds above, the
     weights under sp's), then bf16 at 16 (the launch table derived from
     the rank's cut graphs held exactly); naca-sp, one
     fp32 step of naca0012.json (edge drop to 32 neighbours) at a global
     batch of 4, the loss and gradients against one process; elasticity-sp,
     elasticity.json fitted 2 epochs in fp32, its train and validation
     losses and test metric within 1e-5 of one process's; (10.3) with
     two cards or more the fx runs over NCCL, one rank a card, else logged
     as not run; the kernels at the ranks' shapes for the line below,
     measured in a process of their own (the fx rows) and in rank 0 (the vx
     reduces on its cut graphs of its bf16 batch).
  11. setup.epoch_scan on the card (gaot_torch/train/graphed.py), before
     phase 10 (the script's own process has profiled nothing after phase
     10's ranks), "eager" the step issued from the host, "the graph" the
     step captured once as a CUDA graph and replayed: (11.4) the fx recipe
     at phase 5's data and sizes (bf16) and ns_gauss.json at phase 5c's
     (bf16, 2 epochs, a validation each, its rollout) through
     gaot_torch.cli.main with epoch_scan "always" (route steps=graph) and
     "never" (steps=per-step): the loss records and the test metrics within
     1e-6 relative, samples/s both ways, and on the ns_gauss trainer the
     autoregressive rollout as a loop of forwards and as one replayed graph
     (the same bits, ms a forward both ways); (11.1) one fx training step
     at batch 64 with every call of its six kernels recorded, each call
     captured alone and replayed: its outputs equal to the eager call's bit
     for bit, timed both ways; (11.2, on the fx trainer of 11.4) two epochs
     through the per-step path, then from the same weights, optimizer state
     and generator through the captured epoch path: the same loss bits on
     every step, every weight within 1e-6 of its tensor's largest entry;
     then both ways (the step body issued from the host against its
     replay) the step's median ms, device busy, idle share and kernels a
     step (equal), the capture's seconds and peak memory; (11.3) the same
     on the ns_gauss trainer (batch 64), on the vx flagship's step (phase
     4's model, graphs and batch, 8 steps) and, inside phase 5d, on the
     naca0012 trainer (edge drop, fp32), where each step's uniforms summed
     must equal eager's bit for bit and change every step.
  12. the epoch path under several ranks (train/graphed.py), after phase
     11 and before the rest of phase 10 (its process runs 10.1's fit too):
     one card holds one NCCL rank, so the phase runs in a torchrun process
     of one rank on NCCL (--ddp-graph): (12b) every function of
     parallel/comm.py on that one-rank group, fp32 and bf16, forward and
     backward, captured and replayed on new inputs: equal to its eager
     calls bit for bit, the same NCCL kernels a call (none: over one rank
     NCCL launches no kernel); (12c) the fx recipe through
     gaot_torch.cli.main with setup.distributed and epoch_scan "always"
     (route steps=graph) and "never", the model wrapped in DDP over the
     one-rank group first (smoke code: the trainer wraps DDP only at
     dp > 1): the loss records within 1e-6, samples/s after the first
     evaluation beside 10.1's and 11.4's, the DDP graph's break-even;
     (12a) on that trainer two epochs of the per-step path and, from the
     same state, of the captured epoch path (11 warm-up steps, DDP's
     recipe) replayed step by step: the same loss bits, every weight after
     every step within 1e-6 of eager's, the wrappers' launches 12 times the
     step's table, and both ways the step's ms, idle share, kernels and
     NCCL kernels a step (equal). With two cards or more 12a
     also at dp 2 and tp 2 (the trainer's own DDP and tensor parallelism),
     one rank a card, before it, else logged as not run.
  9. prints one JSON line listing every kernel of the five paths (the fx
     main path's launches are those of the trainer's run A; @fp32, the
     fp32 flash kernels at the fx shape with run C's launches (the example
     as shipped trains in fp32); the vx
     entries' those of the vx flagship's training step and forward; the
     sequential entries', @seq, those of run A; the naca0012 entries,
     @naca, the multiply-reduces on its thinned masks with its CLI run's
     launches; @dp, @tp, @sp, @sp-vx, phase 10's, with rank 0's launches in
     one bf16 step; then the captured steps' entries, @graph: the fx
     step's kernels with 11.1's replayed times, @graph-vx, @graph-seq,
     @graph-naca: phase 2's times, launches the wrappers' count in each
     graph run, two warm-up steps and the capture; @graph-ddp, phase 12a's:
     phase 2's times, eleven warm-up steps and the capture).
The earlier phases pin setup.epoch_scan to "never", so that their launch
counts and profiles are the per-step path's.
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
# TF32 tensor-core rate (dense), which the split-TF32 products of the fp32
# flash route above head dim 128 run at, three passes a product.
PEAK_TF32 = 495e12
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

# The sequential main path: config/examples/time_dep/ns_gauss.json at full
# width (MAGNO hidden 64, 3 MLP layers, lifting 64, radius 0.033, the 64x64
# latent grid; the default UViT, 3 x 256, 8 heads of dim 32, patch 2,
# SwiGLU 1024) on the Poseidon sets' 128x128 lattice on [0, 1]^2 (16384
# nodes) under the example's global_scaling, input 4 (u 2, the start time,
# the time difference), output 2, batch 64, bf16; rollouts at its
# max_time_diff 14 and time_step 2 (7 / 1 / 4 forwards).
SEQ_CONFIG = os.path.join(HERE, "config", "examples", "time_dep", "ns_gauss.json")
CE_CONFIG = os.path.join(HERE, "config", "examples", "time_dep", "ce_crp.json")
SEQ_GRID, SEQ_CHECK_BATCH = 128, 2

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
    channels: tuple = (1, 1)    # the model's input and output channels
    row_gathers: int = 0        # PyTorch row gathers a forward or step must run
    embed_check: bool = True    # phase 4's check again with the embedding shared


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


def device_events(calls, what: str, warm=None):
    """The device kernels (``key_averages``, user annotations left out)
    that ``calls()`` runs under torch.profiler, synchronised at the end.
    The profiler runs a warm-up cycle (``warm()``, by default ``calls()``)
    before the traced one (a schedule of one warm-up and one active step):
    late in this script's process, traces begun cold lost the records of
    their first kernels.
    A trace that holds no device event is taken again, at most twice more
    (the profiler's device tracing now and then delivers none on the
    H100), a second after the last; a third empty trace fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for run in (warm or calls, calls):   # the warm-up cycle, then the traced one
                run()
                torch.cuda.synchronize()
                prof.step()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                  and e.self_device_time_total > 0]
        if events:
            return events
        log(f"  the profiler saw no device time in the {what} (trace {attempt + 1})")
        time.sleep(1.0)
    fail(f"the profiler saw no device time in the {what}")


def device_ms(fn, iters: int = 10) -> float:
    """Device time per call: the self device time of every kernel that
    ``iters`` calls ran (torch.profiler), over their count."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = device_events(lambda: [fn() for _ in range(iters)], "timed calls", warm=fn)
    return sum(e.self_device_time_total for e in events) / iters / 1e3


def bound_ms(nbytes: float, ops: float, peak_ops: float, exps: float = 0.0):
    """Least time the card could take: the larger of the bytes over the
    memory rate, the products' operations over their unit's peak rate and
    the exponentials over the special-function rate. Returns the ms, "bytes"
    or "operations", and the term that binds."""
    terms = {"bytes": nbytes / PEAK_BYTES, "products": ops / peak_ops,
             "exp2": exps / PEAK_EXP2}
    term = max(terms, key=terms.get)
    return terms[term] * 1e3, "bytes" if term == "bytes" else "operations", term


def compare(name, got, want, rtol, atol, quiet=False):
    """max |got - want| must stay within atol + rtol·|want| everywhere;
    ``quiet`` logs a mismatch only."""
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)} or non-finite")
    diff = (got - want).abs()
    err = float(diff.max())
    worst = float((diff - rtol * want.abs()).max())
    ok = worst <= atol
    if not (quiet and ok):
        log(f"  {name}: max_abs_err={err:.3e} (tolerance atol {atol:g} + rtol "
            f"{rtol:g}·|ref|) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def compare_grad(name, got, want, rel, atol=0.0, quiet=False):
    """A gradient: max |got - want| within ``rel`` of its largest entry
    (small entries are sums that cancel), plus ``atol``."""
    return compare(name, got, want, 0.0, rel * float(want.float().abs().max()) + atol,
                   quiet=quiet)


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
# that spills: the flash forward and backward, the multiply-reduces and
# the SwiGLU kernels; the SwiGLU kernels may not spill: bf16 (the forward
# and backward rows fused at M = 128 and 256 with their weight-gradient
# GEMM, and the warp-specialized kernel that serves every other width) and
# fp32 (ffn_tf32_*: the split-TF32 producer, GEMM and transposes).
PTXAS_LOGGED = ("flash_fwd_bf16", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16",
                "flash_fwd_f32", "flash_bwd_dq_f32", "flash_bwd_dkv_f32", "flash_wide_",
                "mulred_k_kernel", "mulred_b_kernel", "ffn_")
NO_SPILL = ("ffn_fwd_fused", "ffn_bwd_rows", "ffn_gemm", "ffn_ws", "ffn_tf32_")


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


# The edges of the fp32 flash kernels' tiles (gaot_torch/csrc/flash_f32.cuh):
# resident blocks of 128 rows (64 above D = 32), streamed tiles of 16, 32 or
# 64 rows; one row, and one row below and above each.
FP32_FLASH_EDGES = (1, 15, 17, 31, 33, 63, 65, 127, 129)


def phase_widths(rnd):
    """The widths the kernels take beyond the paths' own, against their
    plain versions at the tolerances of the per-kernel checks: the flash
    forward (with and without the LSE) and backward at every templated head
    dim and at 136, 256, 264, 520, 1024 and, at S = 128, 8192 (the routes
    with D at run time; two backward calls there give the same bits), those
    routes at 136 and 264 also at the edges of their tiles, bf16 and fp32,
    and timed at four shapes (at D = 256, S = 4096 also held against the
    plain versions, two kernels a backward); the SwiGLU
    forward and backward at the tuned widths besides 256, at widths of the
    general route (640-1024, M 4096 with F 896, F 29056 at M 128), in bf16,
    and in fp32 at M 128-1024, R 1, 129 and 200, F 128 and 29056 (two
    backward calls bit for bit); the fp32 flash kernels at the edges of
    their tiles (FP32_FLASH_EDGES)."""
    import torch

    from gaot_torch.ops.cuda import flash_attention as fa
    from gaot_torch.ops.cuda import fused_ffn as ff

    t_phase = time.perf_counter()

    def flash(b, s, h, hkv, d, dtype, quiet=False):
        bf16 = dtype == torch.bfloat16
        name = f"D={d} S={s} {str(dtype)[6:]}"
        tol = (1e-2, 2e-3) if bf16 else (1e-4, 1e-5)
        qkv = rnd(b, s, h + 2 * hkv, d).to(dtype)
        q, k, v = qkv[:, :, :h], qkv[:, :, h:h + hkv], qkv[:, :, h + hkv:]
        compare(f"widths flash fwd {name}", fa.flash_attention(q, k, v),
                fa.attention_plain(q, k, v), *tol, quiet=quiet)
        out, lse = fa.flash_attention_lse(q, k, v)
        want_out, want_lse = fa.attention_plain(q, k, v, with_lse=True)
        compare(f"widths flash fwd+LSE {name} out", out, want_out, *tol, quiet=quiet)
        compare(f"widths flash fwd+LSE {name} lse", lse, want_lse, 1e-5, 1e-4, quiet=quiet)
        dout = rnd(b, s, h, d).to(dtype)
        got = fa.flash_attention_bwd(q, k, v, out, dout, lse)
        want = fa.attention_bwd_plain(q, k, v, out, dout)
        for n, g, wt in zip("qkv", got, want):
            # At S = 1, dQ and dK are zero up to rounding (dS = p (dP - delta)
            # with O = V): the card tests' absolute floor of 1e-5. In bf16 they
            # are held to the exact zero: the plain version rounds dO times the
            # scale to bf16 before dP, which leaves up to 1e-2 there.
            floor = 1e-5 if s == 1 and n != "v" else 0.0
            if floor and bf16:
                wt = torch.zeros_like(wt)
            compare_grad(f"widths flash bwd {name} d{n}", g, wt, 3e-2 if bf16 else 1e-4,
                         atol=floor, quiet=quiet)
        if d > fa.TEMPLATED_HEAD_DIMS[-1]:
            again = fa.flash_attention_bwd(q, k, v, out, dout, lse)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                fail(f"widths flash bwd {name}: two calls differ")

    b, s, h, hkv = 2, 257, 6, 3          # ragged S, GQA 6:3
    wide = (136, 256, 264, 520, 1024)
    log(f"widths: flash attention at head dims {fa.TEMPLATED_HEAD_DIMS[0]}.."
        f"{fa.TEMPLATED_HEAD_DIMS[-1]} and {wide}, B={b} S={s} H={h} Hkv={hkv}, "
        f"and D=8192 at B=1 S=128 H=2 Hkv=1:")
    for d in fa.TEMPLATED_HEAD_DIMS + wide:
        for dtype in (torch.bfloat16, torch.float32):
            flash(b, s, h, hkv, d, dtype)
    for dtype in (torch.bfloat16, torch.float32):
        flash(1, 128, 2, 1, 8192, dtype)
    t0 = time.perf_counter()
    for d in fa.TEMPLATED_HEAD_DIMS:
        for s_edge in FP32_FLASH_EDGES:
            flash(1, s_edge, 4, 2, d, torch.float32, quiet=True)
    log(f"widths: fp32 flash at head dims {fa.TEMPLATED_HEAD_DIMS[0]}.."
        f"{fa.TEMPLATED_HEAD_DIMS[-1]}, S in {FP32_FLASH_EDGES}, B=1 H=4 Hkv=2: forward, "
        f"LSE and backward within their bounds ({time.perf_counter() - t0:.1f} s)")
    # The routes above 128 at the edges of their tiles (bf16: 128 queries,
    # 128 keys and 64-key tiles, 64-query tiles in dK/dV; fp32: blocks of 128
    # rows, tiles of 64), one slice (136) and a ragged second one (264).
    t0 = time.perf_counter()
    edges = FP32_FLASH_EDGES + (255, 257)
    for d in (136, 264):
        for dtype in (torch.bfloat16, torch.float32):
            for s_edge in edges:
                flash(1, s_edge, 4, 2, d, dtype, quiet=True)
    log(f"widths: bf16 and fp32 flash at head dims 136 and 264, S in {edges}, B=1 H=4 "
        f"Hkv=2: forward, LSE and backward within their bounds, backward bit for bit "
        f"twice ({time.perf_counter() - t0:.1f} s)")
    # The routes with D at run time, timed (20 calls back to back) at four
    # shapes (B=1, H=4), bf16 and fp32, beside SDPA and its autograd; the
    # bound counts the work the function needs, not the scores the routes
    # recompute for each output slice. fp32 states two bounds: the FFMA one
    # (the fp32 rate of the CUDA cores) and the split-TF32 one (three TF32
    # tensor-core passes a product), which its kernels run at. At the first
    # shape the forward, LSE and backward are held against the plain
    # versions (the longest sums), and each backward is two kernels (the
    # profiler's count of one call).
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for d, ss in ((256, 4096), (512, 2048), (1024, 4096), (1024, 1024)):
        for dtype in (torch.bfloat16, torch.float32):
            bb, hh = 1, 4
            bf16 = dtype == torch.bfloat16
            name = f"D={d} B={bb} S={ss} H={hh} {str(dtype)[6:]}"
            qkv = rnd(bb, ss, 3, hh, d).to(dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            out, lse = fa.flash_attention_lse(q, k, v)
            dout = rnd(bb, ss, hh, d).to(dtype)
            if (d, ss) == (256, 4096):
                tol = (1e-2, 2e-3) if bf16 else (1e-4, 1e-5)
                want_out, want_lse = fa.attention_plain(q, k, v, with_lse=True)
                compare(f"wide flash fwd {name}", fa.flash_attention(q, k, v), want_out, *tol)
                compare(f"wide flash fwd+LSE {name} out", out, want_out, *tol)
                compare(f"wide flash fwd+LSE {name} lse", lse, want_lse, 1e-5, 1e-4)
                got = fa.flash_attention_bwd(q, k, v, out, dout, lse)
                for n, g, wt in zip("qkv", got, fa.attention_bwd_plain(q, k, v, out, dout)):
                    compare_grad(f"wide flash bwd {name} d{n}", g, wt, 3e-2 if bf16 else 1e-4)
                # A trace can lose records, never add them: the largest of three.
                n_kernels = max(sum(e.count for e in device_events(
                    lambda: fa.flash_attention_bwd(q, k, v, out, dout, lse),
                    f"wide flash bwd {name}")) for _ in range(3))
                log(f"  wide flash bwd {name}: {n_kernels} kernels a call")
                if n_kernels != 2:
                    fail(f"wide flash bwd {name}: {n_kernels} kernels a call, not 2")
                del want_out, want_lse, got
            ops, exps = 4.0 * bb * hh * ss * ss * d, float(bb * hh * ss * ss)
            peak, size = (PEAK_BF16, 2) if bf16 else (PEAK_FP32, 4)
            bnd = bound_ms(4 * bb * ss * hh * d * size, ops, peak, exps)
            bnd_b = bound_ms(8 * bb * ss * hh * d * size, 2.5 * ops, peak, exps)
            t_f = time_ms(lambda: fa.flash_attention(q, k, v))
            t_b = time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, dout, lse))
            leaves = [t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v)]
            o_l = sdpa(*leaves)
            g_l = dout.transpose(1, 2).contiguous()
            t_lf = time_ms(lambda: sdpa(*leaves))
            t_lb = time_ms(lambda: torch.autograd.grad(o_l, leaves, g_l, retain_graph=True))
            split = ""
            if not bf16:
                sf = bound_ms(4 * bb * ss * hh * d * size, 3 * ops, PEAK_TF32, exps)[0]
                sb = bound_ms(8 * bb * ss * hh * d * size, 7.5 * ops, PEAK_TF32, exps)[0]
                split = (f"; split-TF32 bounds fwd {sf:.4f} ({sf / t_f:.1%}) bwd {sb:.4f} "
                         f"({sb / t_b:.1%}), FFMA shares {bnd[0] / t_f:.1%} "
                         f"{bnd_b[0] / t_b:.1%}")
            log(f"    wide flash {name}: fwd "
                f"kernel_ms={t_f:.4f} (SDPA {t_lf:.4f}, bound {bnd[0]:.4f}); bwd "
                f"kernel_ms={t_b:.4f} (SDPA autograd {t_lb:.4f}, bound {bnd_b[0]:.4f})"
                + split)
            del qkv, q, k, v, out, lse, dout, leaves, o_l, g_l

    # bf16 at R 200; fp32 (the split-TF32 kernels: 128-row tiles, 64
    # columns of F a producer tile, K in chunks of 32, the transposed K = R
    # operands padded to 32 rows) at ragged R, one row and one row past a
    # tile, every M from 128 to 1024, F 128 and the gate's widest, 29056;
    # two fp32 backward calls give the same bits.
    cases = [(m, 256, torch.bfloat16, 200) for m in (128, 384, 512, 640, 768, 896, 1024)]
    cases += [(4096, 896, torch.bfloat16, 200), (128, 29056, torch.bfloat16, 200)]
    cases += [(m, 256, torch.float32, 200) for m in (128, 256, 384, 512, 640, 1024)]
    cases += [(128, 256, torch.float32, 1), (256, 256, torch.float32, 129),
              (128, 128, torch.float32, 200), (128, 29056, torch.float32, 200)]
    log(f"widths: fused SwiGLU, (M, F, dtype, R) in "
        f"{[(m, f, str(dt)[6:], r) for m, f, dt, r in cases]}:")
    for m, f, dtype, r in cases:
        bf16 = dtype == torch.bfloat16
        name = f"M={m} F={f} {str(dtype)[6:]} R={r}"
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
        if not bf16:
            again = ff.fused_ffn_bwd(x, w1, w3, w2, dout)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"widths fused_ffn bwd {name}: two calls differ")
    torch.cuda.synchronize()
    log(f"widths phase: {time.perf_counter() - t_phase:.1f} s")


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


def _host_graphs_vx(cfg, what, bucketing=True, with_transpose=True):
    """The vx flagship's split: VX_BATCH samples of VX_NODES seeded nodes
    uniform in [-1, 1]^2, each its own, the latent lattice, and the split's
    graphs from the port's builder as the trainer builds them (Morton
    order; by default shared degree buckets and in-degree-grouped transpose
    graphs); logs the build time and the layout. Returns (coords
    [S, N_pad, 2], lattice, encoder, decoder, the split's buffers)."""
    import numpy as np

    from gaot_torch.data.graph_builder import GraphBuilder, vx_graph_buffers

    magno = cfg.model.args.magno
    x = np.random.default_rng(0).uniform(-1, 1, (VX_BATCH, VX_NODES, 2)).astype(np.float32)
    lat = _lattice(LATENT)
    builder = GraphBuilder.from_magno_config(magno)
    t0 = time.perf_counter()
    split = builder.build_all_vx_graphs(
        {"test": {"x": x}}, lat, magno.radius, magno.scales, build_train=False,
        with_transpose=with_transpose, bucketing=bucketing)["test"]
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


def _seq_host_graphs(cfg, what):
    """The Poseidon lattice (SEQ_GRID^2 nodes on [0, 1]^2) and the latent
    grid over the metadata domain, both through the config's coordinate
    scaler fitted on the latent grid (as the trainer fits it), and the host
    graphs from the port's builder; logs the build time and the layout."""
    import numpy as np

    from gaot_torch.data.graph_builder import GraphBuilder
    from gaot_torch.utils.scaling import CoordinateScaler

    def unit_lattice(n):
        ax = np.linspace(0, 1, n)
        return np.stack(np.meshgrid(ax, ax, indexing="ij"), -1).reshape(-1, 2)

    magno = cfg.model.args.magno
    scaler = CoordinateScaler(target_range=(-1, 1), mode=cfg.dataset.coord_scaling)
    lat = scaler(unit_lattice(cfg.model.latent_tokens_size[0])).astype(np.float32)
    coords = scaler(unit_lattice(SEQ_GRID)).astype(np.float32)
    builder = GraphBuilder.from_magno_config(magno)
    t0 = time.perf_counter()
    enc, dec = builder.build_fx_graphs(coords, lat, magno.radius, magno.scales)
    log(f"{what} graphs: {coords.shape[0]} nodes, search={builder.search_method} "
        f"host_build_s={time.perf_counter() - t0:.2f}; encoder [Q, K] "
        f"{tuple(enc[0].indices.shape)}, decoder {tuple(dec[0].indices.shape)}")
    return coords, lat, enc, dec


def _tables(graphs, layers: int, ffn: bool) -> tuple:
    """The launches of one forward and one training step, from the model's
    graphs (FxGraphs): per scale and side, the forward reduces once per
    degree bucket (a dense graph is one) and, where the rows were bucketed,
    once more to put them back in query order; the step adds d_f once per
    in-degree group (a flat transpose graph is one), that reorder's
    gradient, and d_coef once per bucket. fx graphs are BucketedGraphs or
    PaddedGraphs with a separate transpose graph; vx graphs FlatGraphs.
    One flash call per UViT layer; the SwiGLU where ``ffn``."""
    fwd_k = step_k = step_b = 0
    sides = list(zip(graphs.encoder, graphs.encoder_t or [None] * len(graphs.encoder)))
    sides += zip(graphs.decoder, graphs.decoder_t or [None] * len(graphs.decoder))
    for g, t in sides:
        if hasattr(g, "buckets"):
            nb, perm = len(g.buckets), int(g.perm is not None)
            groups = len(g.tgraph.groups) if g.tgraph is not None else 0
        else:
            nb, perm, groups = 1, 0, 1 if t is not None else 0
        fwd_k += nb + perm
        step_k += nb + groups + 2 * perm
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


def check_multiply_reduce(rnd, b, c, cases, what, fp32_rows=None):
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
    once. multiply_reduce_b reads every slot. With ``fp32_rows``, a dict,
    the fp32 calls are timed too (beside the library pair and the plain
    version) and that dict takes their rows."""
    import torch

    from gaot_torch.ops.cuda import multiply_reduce as mr

    w = b * c
    keys = ("ms", "parent_pair_ms", "library_ms", "plain_ms", "bytes", "ops", "err")
    agg = {(name, dt): dict.fromkeys(keys, 0.0)
           for name in ("multiply_reduce_k", "multiply_reduce_b") for dt in ("bf16", "fp32")}

    def record(name, dt, label, err, times=None, nbytes=0.0, ops=0.0):
        a = agg[name, dt]
        a["err"] = max(a["err"], err)
        if times is None:
            return
        for key, val in times.items():
            a[key] += val
        a["bytes"] += nbytes
        a["ops"] += ops
        bnd = bound_ms(nbytes, ops, PEAK_FP32)[0]
        parent = (f" parent_pair_ms={times['parent_pair_ms']:.4f}"
                  if "parent_pair_ms" in times else "")
        log(f"    {label}: kernel_ms={times['ms']:.4f}{parent} "
            f"library_ms={times['library_ms']:.4f} plain_ms={times['plain_ms']:.4f} "
            f"bound_ms={bnd:.4f} ({nbytes / times['ms'] / 1e6:.0f} GB/s)")

    def same_bits(label, fn):
        if not torch.equal(fn(), fn()):
            fail(f"{label}: two calls on the same inputs differ")

    def pair_ms(fn_k, fn_parent, fn_lib, fn_plain, bf16):
        # fp32 (no parent pair): the kernel, the library pair, the plain version.
        if bf16:
            return _pair_ms(fn_k, fn_parent, fn_lib, fn_plain)
        return {key: time_ms(fn) for key, fn in (("ms", fn_k), ("library_ms", fn_lib),
                                                 ("plain_ms", fn_plain))}

    log(f"multiply_reduce_k / multiply_reduce_b ({what}), W = {b}·{c}, on the "
        f"path's graphs:")
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        size = 2 if bf16 else 4
        dt = str(dtype)[6:]
        kind = "bf16" if bf16 else "fp32"
        timed = bf16 or fp32_rows is not None
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
            if not timed:
                record("multiply_reduce_k", kind, label, err)
                if d_coef:
                    record("multiply_reduce_b", kind, label, err_b)
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
            times = pair_ms(kern, lambda: mr.multiply_reduce_k(coef_km, gath_km(), b),
                            lambda: torch.einsum("qkc,qkbc->qbc", c4, rows()),
                            lambda: mr.gather_multiply_reduce_k_plain(src, idx, coef, b,
                                                                      mask=mask), bf16)
            record("multiply_reduce_k", kind, f"fwd {label}", err, times, nbytes,
                   2.0 * valid * w)
            if not d_coef:
                continue
            times = pair_ms(kern_b, lambda: mr.multiply_reduce_b(gath_km(), dout, b),
                            lambda: torch.einsum("qkbc,qbc->qkc", rows(), d3),
                            lambda: mr.gather_multiply_reduce_b_plain(src, idx, dout, b),
                            bf16)
            record("multiply_reduce_b", kind, f"d_coef {label}", err_b, times,
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
            if not timed:
                record("multiply_reduce_k", kind, label, err)
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
            times = pair_ms(kern, parent, library,
                            lambda: mr.gather_multiply_reduce_k_plain(
                                dout2, tq, table, b, coef_idx=ep, mask=tm), bf16)
            record("multiply_reduce_k", kind,
                   f"d_f {label} (valid slots {valid / (q * k):.2f})", err, times,
                   nbytes, 2.0 * valid * w)
        torch.cuda.empty_cache()
    nf, nd = len(cases["forward"]), len(cases["d_f"])
    nb = sum(case.get("d_coef", True) for case in cases["forward"])
    rows = {}
    for name, per in (("multiply_reduce_k",
                       f"sum of the {nf + nd} calls of one training step (the "
                       f"forward runs {cases.get('forward_calls', nf)})"),
                      ("multiply_reduce_b", f"sum of the {nb} calls of one training step")):
        for kind, out_rows in (("bf16", rows), ("fp32", fp32_rows)):
            if out_rows is None:
                continue
            a = agg[name, kind]
            extra = {}
            if kind == "bf16":
                extra["parent_pair_ms"] = a["parent_pair_ms"]
            pair = ("; parent_pair_ms: the row gather(s) and the pre-gathered kernel"
                    if kind == "bf16" else "")
            out_rows[name] = _row(a["err"], a["ms"], a["plain_ms"], a["library_ms"],
                                  bound_ms(a["bytes"], a["ops"], PEAK_FP32), per + pair,
                                  kind, **extra)
            parent = (f" parent_pair_ms={a['parent_pair_ms']:.4f}" if kind == "bf16" else "")
            log(f"  {name} ({what}, {kind}), all calls: kernel_ms={a['ms']:.4f}{parent} "
                f"library_ms={a['library_ms']:.4f} plain_ms={a['plain_ms']:.4f} "
                f"bound_ms={out_rows[name]['bound_ms']:.4f}")
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


def check_flash(rnd, bb, s, h, d, with_eval=True, row_dtype="bfloat16", fp32_rows=None):
    """The forward (with the LSE output, and without it where
    ``with_eval``) and the backward at (B, S, H = Hkv, D). The plain versions
    run one kv-head at a time where one fp32 [B, H, S, S] tensor would pass
    8 GiB. Returns rows keyed "fwd", "fwd_lse" and "bwd" (of ``row_dtype``,
    "bfloat16" or "float32"); ``fp32_rows``, a dict, takes the float32 rows
    besides."""
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
        dt = "bf16" if bf16 else "fp32"
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
            if name == row_dtype:
                rows["fwd"] = _row(err, t_k, t_p, t_l, bnd, "one call", dt, S=s, D=d)
            if not bf16 and fp32_rows is not None:
                fp32_rows["fwd"] = _row(err, t_k, t_p, t_l, bnd, "one call", dt, S=s, D=d)
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
        kept = [rows] if name == row_dtype else []
        if not bf16 and fp32_rows is not None:
            kept.append(fp32_rows)
        for r in kept:
            r["fwd_lse"] = _row(err_lse, t_kl, t_pl, t_ll, bnd_lse, "one call", dt, S=s, D=d)
            r["bwd"] = _row(err_bwd, t_kb, t_pb, t_lb, bnd_bwd, "one call", dt, S=s, D=d)
    return rows


def check_ffn(rnd, r: int = BATCH * SEQ, f: int = 1024):
    """The SwiGLU forward and backward at R tokens (the fx shape by
    default), M = 256, F (1024 by default), bf16: against the plain versions, timed 20
    back to back and by profiler device time per call, beside the library's
    three products (and autograd of them). The general route:
    :func:`check_ffn_general`; the fp32 kernels: :func:`check_ffn_f32`."""
    import torch

    from gaot_torch.ops.cuda import fused_ffn as ff

    rows = {}
    silu = torch.nn.functional.silu
    m = 256
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
    del out, leaves, dout, x, w1, w3, w2
    torch.cuda.empty_cache()
    return rows


def _ffn_kernels(fn, what: str, want: int):
    """The SwiGLU kernels one ``fn()`` launches: the fullest of up to five
    traces (a trace can lose records, never add them), each led by a small
    kernel (late in this script's process the profiler has lost the first
    kernel of a trace of one call). Returns (their count, their device ms,
    the events)."""
    import torch

    def calls():
        torch.ones(1, device="cuda").add_(1)
        fn()

    best = []
    for _ in range(5):
        evs = [e for e in device_events(calls, what) if "ffn_" in e.key]
        if sum(e.count for e in evs) > sum(e.count for e in best):
            best = evs
        if sum(e.count for e in best) >= want:
            break
    return (sum(e.count for e in best), sum(e.self_device_time_total for e in best) / 1e3, best)


def check_ffn_general(rnd, r: int = BATCH * SEQ, m: int = 1024, f: int = 3584) -> dict:
    """The bf16 general SwiGLU route (every width the gate takes but M = 128,
    256: csrc/fused_ffn.cu's warp-specialized producer and GEMM, ffn_ws) at R
    rows, M 1024, F 3584: the forward and the four gradients against the
    plain versions at check_ffn's bf16 tolerances (forward rtol 1e-2, atol
    1e-2; gradients 2e-2 of each largest entry), two backward calls bit for
    bit, the kernels a call launches (2 forward, 3 backward: the fullest of
    up to five traces), and timed (20 calls back to back) beside the
    library's three products and their autograd, with the bound and the
    share of it each reaches. The plain versions run their fp32 products
    with TF32 allowed: every operand of theirs holds bf16 values, which TF32
    holds exactly, so the products are fp32's (in FFMA they would take
    about a minute at this shape). Returns the rows of the @general
    entries."""
    import torch

    from gaot_torch.ops.cuda import fused_ffn as ff

    silu = torch.nn.functional.silu
    name = f"bf16 general route R={r} M={m} F={f}"
    log(f"fused SwiGLU, {name}:")
    x, dout = rnd(r, m).bfloat16(), rnd(r, m).bfloat16()
    w = ((rnd(f, m) / m ** 0.5).bfloat16(), (rnd(f, m) / m ** 0.5).bfloat16(),
         (rnd(m, f) / f ** 0.5).bfloat16())
    kern = lambda: ff.fused_ffn(x, *w)
    kern_b = lambda: ff.fused_ffn_bwd(x, *w, dout)
    plain = lambda: ff.fused_ffn_plain(x, *w)
    plain_b = lambda: ff.fused_ffn_bwd_plain(x, *w, dout)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        want = plain()
        t_p = time_ms(plain, iters=3, warmup=0)
        err = compare(f"fused_ffn fwd {name}", kern(), want, 1e-2, 1e-2)
        del want
        got, want = kern_b(), plain_b()
        t_pb = time_ms(plain_b, iters=3, warmup=0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    err_b = max(compare_grad(f"fused_ffn bwd {name} {n}", g, wt, 2e-2)
                for n, g, wt in zip(("dx", "dw1", "dw3", "dw2"), got, want))
    del want
    again = kern_b()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"fused_ffn bwd {name}: two calls differ")
    del got, again
    n_f, d_f, evs_f = _ffn_kernels(kern, f"fused_ffn {name}", 2)
    n_b, d_b, evs_b = _ffn_kernels(kern_b, f"fused_ffn {name}", 3)
    for what, n, evs in (("forward", n_f, evs_f), ("backward", n_b, evs_b)):
        log(f"  fused_ffn {name}: {n} kernels a {what} call: " + "; ".join(
            f"{e.key[:60]} {e.self_device_time_total / 1e3:.4f} ms" for e in evs))
    if (n_f, n_b) != (2, 3):
        fail(f"fused_ffn {name}: {n_f} and {n_b} kernels a call, not 2 and 3")
    leaves = [t.detach().requires_grad_(True) for t in (x, *w)]
    xl, w1l, w3l, w2l = leaves
    out = (silu(xl @ w1l.t()) * (xl @ w3l.t())) @ w2l.t()
    lib = lambda: (silu(x @ w[0].t()) * (x @ w[1].t())) @ w[2].t()
    lib_b = lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)
    t_k, t_l, t_kb, t_lb = (time_ms(fn) for fn in (kern, lib, kern_b, lib_b))
    ops = 6.0 * r * m * f
    rows = {}
    for key, what, o, nb, t, d, tl, tp, e, n in (
            ("fused_ffn_fwd", "fwd", ops, (2 * r * m + 3 * m * f) * 2, t_k, d_f, t_l, t_p, err,
             n_f),
            ("fused_ffn_bwd", "bwd", 16 / 6 * ops, 3 * r * m * 2 + 3 * m * f * (2 + 4), t_kb, d_b,
             t_lb, t_pb, err_b, n_b)):
        bnd = bound_ms(nb, o, PEAK_BF16, exps=float(r * f))
        log(f"    {name} {what}: kernel_ms={t:.4f} (device {d:.4f}) library_ms={tl:.4f} "
            f"plain_ms={tp:.4f} (TF32 on bf16 operands) bound_ms={bnd[0]:.4f} ({bnd[2]} binds; "
            f"{bnd[0] / t:.1%} of it; {o / t / 1e9:.1f} TFLOP/s); "
            f"{'below' if t < tl else 'above'} the library by {max(t, tl) / min(t, tl):.2f}x")
        rows[key] = _row(e, t, tp, tl, bnd, "one call", device_ms=d, kernels_per_call=n,
                         shape=f"R={r} M={m} F={f}",
                         plain="fp32 products with TF32 allowed (exact on bf16 operands)")
    del x, dout, w, leaves, out
    torch.cuda.empty_cache()
    return rows


# The fx main path's UViT at a width of the general SwiGLU route: hidden 512
# (M 512, F 2048, which the JAX gate sends to the kernel and the fused
# kernels do not take; 8 heads of dim 64), one bf16 step at this batch.
GENERAL_HIDDEN, GENERAL_BATCH = 512, 8


def phase_general_ffn(path: Path) -> dict:
    """The bf16 general SwiGLU route on a model path: ``path`` (the fx main
    path) with its UViT at hidden GENERAL_HIDDEN, one bf16 training step at
    batch GENERAL_BATCH with transformer.fused_ffn "auto" (the kernels)
    beside "off" (the plain three products), from the same weights and
    batch: 3 forward and 3 backward SwiGLU launches a step under auto and
    none under off, the losses within 1e-2 of each other and all gradients
    within a relative L2 of 5e-2 (the bf16 step bound of PERF.md's
    agreement metric; both sides round to bf16, at other places). Returns
    the auto step's launches."""
    import torch

    layers = path.cfg.model.args.transformer.num_layers
    steps = {}
    for mode in ("auto", "off"):
        cfg = copy.deepcopy(path.cfg)
        cfg.model.args.transformer.hidden_size = GENERAL_HIDDEN
        cfg.model.args.transformer.fused_ffn = mode
        steps[mode] = _step_grads(path._replace(name=f"{path.name}, hidden {GENERAL_HIDDEN}, "
                                                f"fused_ffn {mode}", cfg=cfg),
                                  GENERAL_BATCH, torch.bfloat16)
    (loss_a, grads_a, launches_a), (loss_o, grads_o, launches_o) = steps["auto"], steps["off"]
    for mode, launches, want in (("auto", launches_a, layers), ("off", launches_o, 0)):
        got = (launches.get("fused_ffn_fwd", 0), launches.get("fused_ffn_bwd", 0))
        if got != (want, want):
            fail(f"general SwiGLU step, fused_ffn {mode}: launches {got} a step, not "
                 f"({want}, {want})")
    rel = abs(loss_a - loss_o) / max(abs(loss_o), 1e-30)
    ga = torch.cat([grads_a[k].reshape(-1) for k in sorted(grads_o)])
    go = torch.cat([grads_o[k].reshape(-1) for k in sorted(grads_o)])
    l2 = float((ga - go).norm() / go.norm())
    log(f"general SwiGLU step (fx main path, UViT hidden {GENERAL_HIDDEN}: M "
        f"{GENERAL_HIDDEN}, F {4 * GENERAL_HIDDEN}; batch {GENERAL_BATCH}, bf16), fused_ffn auto "
        f"vs off: loss {loss_a:.6f} / {loss_o:.6f} (relative {rel:.2e}, bound 1e-2); gradients "
        f"relative L2 {l2:.3e} (bound 5e-2); SwiGLU launches a step "
        f"{launches_a.get('fused_ffn_fwd')} + {launches_a.get('fused_ffn_bwd')} auto, 0 + 0 off")
    if not (rel <= 1e-2 and l2 <= 5e-2):
        fail("general SwiGLU step: the kernels' step disagrees with the plain products'")
    return launches_a


def check_ffn_f32(rnd, r: int = BATCH * SEQ, f: int = 1024) -> dict:
    """The fp32 SwiGLU kernels (split-TF32 products on the tensor cores) at
    the fx shape's R rows, M = 256 and 640, F: against the plain versions
    (the three fp32 products, TF32 off) at the fp32 bounds of the widths
    phase (forward rtol 1e-4, atol 1e-5; gradients 1e-4 of each largest
    entry), two backward calls bit for bit, the kernels one call launches
    (2 forward, 4 backward: the fullest of up to five traces, whose
    kernels' device ms are logged and summed), and timed (20 calls back to
    back) beside the library's three fp32 products and their autograd and
    the plain versions (no other profile: late in this script's process
    traces have lost records, and this check adds as few as it can), with the
    FFMA bound (the CUDA cores' fp32 rate) and the split-TF32 one (three
    TF32 passes a product, the kernels' route) and each one's share. Returns
    the M = 256 rows (the fx width) for the kernels line; their bound_ms is
    the split-TF32 one."""
    import torch

    from gaot_torch.ops.cuda import fused_ffn as ff

    silu = torch.nn.functional.silu
    rows = {}
    for m in (256, 640):
        name = f"fp32 R={r} M={m} F={f}"
        log(f"fused SwiGLU, {name}:")
        x, dout = rnd(r, m), rnd(r, m)
        w = (rnd(f, m) / m ** 0.5, rnd(f, m) / m ** 0.5, rnd(m, f) / f ** 0.5)
        if torch.backends.cuda.matmul.allow_tf32:
            fail("the fp32 SwiGLU's plain versions would run their products in TF32")
        err = compare(f"fused_ffn fwd {name}", ff.fused_ffn(x, *w),
                      ff.fused_ffn_plain(x, *w), 1e-4, 1e-5)
        got = ff.fused_ffn_bwd(x, *w, dout)
        want = ff.fused_ffn_bwd_plain(x, *w, dout)
        err_b = max(compare_grad(f"fused_ffn bwd {name} {n}", g, wt, 1e-4)
                    for n, g, wt in zip(("dx", "dw1", "dw3", "dw2"), got, want))
        del want
        again = ff.fused_ffn_bwd(x, *w, dout)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"fused_ffn bwd {name}: two calls differ")
        del got, again
        kern = lambda: ff.fused_ffn(x, *w)
        kern_b = lambda: ff.fused_ffn_bwd(x, *w, dout)
        n_calls, dev = {}, {}
        for what, fn, want in (("forward", kern, 2), ("backward", kern_b, 4)):
            n_calls[what], dev[what], best = _ffn_kernels(fn, f"fused_ffn {name}", want)
            log(f"  fused_ffn {name}: {n_calls[what]} kernels a {what} call: " + "; ".join(
                f"{e.key[:48]} {e.self_device_time_total / 1e3:.4f} ms" for e in best))
        n_f, n_b = n_calls["forward"], n_calls["backward"]
        if (n_f, n_b) != (2, 4):
            fail(f"fused_ffn {name}: {n_f} and {n_b} kernels a call, not 2 and 4")
        leaves = [t.detach().requires_grad_(True) for t in (x, *w)]
        xl, w1l, w3l, w2l = leaves
        out = (silu(xl @ w1l.t()) * (xl @ w3l.t())) @ w2l.t()
        lib = lambda: (silu(x @ w[0].t()) * (x @ w[1].t())) @ w[2].t()
        lib_b = lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)
        t_k, t_l, t_kb, t_lb = (time_ms(fn) for fn in (kern, lib, kern_b, lib_b))
        t_p = time_ms(lambda: ff.fused_ffn_plain(x, *w), iters=5)
        t_pb = time_ms(lambda: ff.fused_ffn_bwd_plain(x, *w, dout), iters=5)
        ops = 6.0 * r * m * f
        nbytes, nbytes_b = (2 * r * m + 3 * m * f) * 4, 3 * r * m * 4 + 3 * m * f * 8
        bounds = {}
        for what, o, nb, t, d, tl, tp in (("fwd", ops, nbytes, t_k, dev["forward"], t_l, t_p),
                                          ("bwd", 16 / 6 * ops, nbytes_b, t_kb,
                                           dev["backward"], t_lb, t_pb)):
            ffma, split = bound_ms(nb, o, PEAK_FP32), bound_ms(nb, 3 * o, PEAK_TF32)
            bounds[what] = (ffma, split)
            log(f"    {name} {what}: kernel_ms={t:.4f} (device {d:.4f}) library_ms={tl:.4f} "
                f"plain_ms={tp:.4f}; FFMA bound {ffma[0]:.4f} "
                f"({ffma[0] / t:.1%}), split-TF32 bound {split[0]:.4f} ({split[0] / t:.1%}); "
                f"{o / t / 1e9:.1f} TFLOP/s of fp32 work; "
                f"{'below' if t < tl else 'above'} the library by {max(t, tl) / min(t, tl):.2f}x")
        if m == 256:
            rows["fused_ffn_fwd"] = _row(err, t_k, t_p, t_l, bounds["fwd"][1], "one call",
                                         "fp32", device_ms=dev["forward"],
                                         ffma_bound_ms=bounds["fwd"][0][0],
                                         kernels_per_call=n_f)
            rows["fused_ffn_bwd"] = _row(err_b, t_kb, t_pb, t_lb, bounds["bwd"][1], "one call",
                                         "fp32", device_ms=dev["backward"],
                                         ffma_bound_ms=bounds["bwd"][0][0],
                                         kernels_per_call=n_b)
        del x, dout, w, leaves, out
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
    graphs, _, _ = _graph_args(path, path.batch, device)
    return _flat_reduce_cases(graphs, path.batch, path.coords.shape[1],
                              path.lat.shape[0], what,
                              path.train_launches["multiply_reduce_k"])


def _flat_reduce_cases(graphs, b: int, n: int, nq: int, what: str, want: int,
                       rows=None):
    """:func:`_vx_reduce_cases` of the FlatGraphs ``graphs`` of a vx batch
    of ``b`` samples, n padded nodes and nq latent queries a sample (the
    encoder's and the decoder's query rows ``rows``, a rank's under spatial
    parallelism; default nq and n); ``want``: the multiply-reduce calls of
    its training step."""
    from gaot_torch.ops.gather_apply import df_calls

    cases = {"forward": [], "d_f": [], "forward_calls": 0}
    desc = []
    rows = rows or (nq, n)
    for side, vg, n_src, n_q in (("encoder", graphs.encoder[0], n, rows[0]),
                                 ("decoder", graphs.decoder[0], nq, rows[1])):
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

    model = GAOT(*path.channels, path.cfg.model, dtype=dtype, device=device,
                 generator=torch.Generator().manual_seed(0)).eval()
    if model.pos_emb.shape[0] != path.seq:
        fail(f"{path.name}: the model has {model.pos_emb.shape[0]} tokens, "
             f"expected {path.seq}")
    return model


def _batch(seed, path: Path):
    import numpy as np

    rng = np.random.default_rng(seed)
    shape = (max(path.batch, path.check_batch), path.coords.shape[-2])
    pndata = rng.normal(size=shape + path.channels[:1]).astype(np.float32)
    target = rng.normal(size=shape + path.channels[1:]).astype(np.float32)
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
        if got.shape != (cb, n, path.channels[1]) or not torch.isfinite(got).all():
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
    if pred.shape != (path.batch, n, path.channels[1]) or not torch.isfinite(pred).all() \
            or not torch.isfinite(loss):
        fail(f"{path.name} batch-{path.batch} forward: wrong shape or non-finite output")
    peak = torch.cuda.max_memory_allocated()
    run = lambda: eval_step(model, graphs, xc, xp, xt, smask, nmask)
    times = host_times(run, 10)
    log(f"  forward_ms {fmt_times(times, path.batch)} "
        f"max_memory_allocated={peak / 2**30:.3f} GiB loss={float(loss):.4f}")
    profile_step(run, f"{path.name} forward", gathers=path.row_gathers)
    out["launches"] = launches
    out["ms"] = statistics.median(times)
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
    if path.cfg.model.args.magno.embedding_method == "statistical" and path.embed_check:
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
    profile_step(run, f"{path.name} training step", gathers=path.row_gathers)
    del model, graphs, opt
    torch.cuda.empty_cache()
    return launches, statistics.median(times)


def profile_step(run, what: str, steps: int = 10, top: int = 20, gathers: int = 0):
    """Where a step's time goes: steps issued back to back (no synchronise
    in between), timed on the host clock without and then with
    torch.profiler; prints the device-busy time per step, the device's idle
    share, the kernels per step, and the kernels by device time. Fails if
    PyTorch's row gather runs more than ``gathers`` times a step."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps
    # Device-side kernels only: the host ops that launched them, and the
    # device ranges of user annotations (such as the optimizer's step), carry
    # the same device time again.
    events = device_events(lambda: [run() for _ in range(steps)], what, warm=run)
    busy_ms = sum(e.self_device_time_total for e in events) / steps / 1e3
    kernels_per_step = sum(e.count for e in events) / steps
    log(f"  pipelined {what} ({steps} back to back): wall_ms={wall * 1e3:.3f} "
        f"device_busy_ms={busy_ms:.3f} idle_share={1 - busy_ms / (wall * 1e3):.3f} "
        f"kernels_per_step={kernels_per_step:.0f}")
    events.sort(key=lambda e: -e.self_device_time_total)
    for e in events[:top]:
        log(f"    {e.self_device_time_total / 1e3 / steps:9.4f} ms "
            f"{e.count / steps:6.1f} calls  {e.key[:100]}")
    # The AGNO apply reads its rows by index: PyTorch's row gather (the
    # index_select of a leading axis) must not run on any path but the
    # nonlinear transforms' per-edge body, which reads its feature rows and
    # their gradient rows with it (``gathers``; ``index_select`` takes
    # another kernel for some buffer alignments, so that is a ceiling).
    found = [e for e in events if "vectorized_gather_kernel" in e.key]
    per_step = sum(e.count for e in found) / steps
    log(f"  row gathers (vectorized_gather_kernel) per step: {per_step:.1f} calls "
        f"(at most {gathers}), "
        f"{sum(e.self_device_time_total for e in found) / 1e3 / steps:.4f} ms")
    if per_step > gathers:
        fail(f"the {what} runs PyTorch's row gather {per_step} times a step, "
             f"at most {gathers} expected")
    return {"wall_ms": wall * 1e3, "busy_ms": busy_ms, "kernels": kernels_per_step,
            "by_name": {e.key: e.count / steps for e in events}}


def phase_rollout(path: Path):
    """Phase 4b: ``autoregressive_predict`` on the sequential path (module
    docstring). The statistics are those of seeded trajectories on the
    path's nodes; the initial states are seeded too. Returns, per predict
    mode, (forwards, launches, median ms of a rollout)."""
    import numpy as np
    import torch

    from gaot_torch.data.sequential import compute_sequential_stats
    from gaot_torch.models.rollout import autoregressive_predict
    from gaot_torch.ops import cuda as kernels
    from gaot_torch.train import predict_mode_indices
    from gaot_torch.train.sequential_trainer import PREDICT_MODES

    ds = path.cfg.dataset
    t_values = np.linspace(0, 1, 21)[:ds.max_time_diff + 1]
    rng = np.random.default_rng(7)
    n, (cin, cout) = path.coords.shape[0], path.channels
    u = rng.normal(size=(2, len(t_values), n, cout)).astype(np.float32)
    stats = compute_sequential_stats(u, None, t_values, max_time_diff=ds.max_time_diff,
                                     time_step=ds.time_step)
    x0 = np.zeros((path.batch, n, cin), np.float32)
    x0[..., :cout] = rng.normal(size=(path.batch, n, cout))

    def rollout(model, graphs, coord, x, indices):
        return autoregressive_predict(model, x, indices, t_values, stats, ds.stepper_mode,
                                      graphs, coord)

    # Batch 2: the card against the CPU plain route, fp32 (every step within
    # 1e-3 of its largest entry) and bf16 (relative L2 of each step, logged).
    ti = predict_mode_indices("autoregressive", ds.max_time_diff, ds.time_step)
    cb = SEQ_CHECK_BATCH
    preds = {}
    for dev, dtype in (("cpu", None), ("cuda", None), ("cuda", torch.bfloat16)):
        graphs, coord, _ = _graph_args(path, cb, dev)
        preds[dev, dtype] = rollout(_model(path, dtype, dev), graphs, coord,
                                    torch.from_numpy(x0[:cb]).to(dev), ti).float().cpu()
    want = preds["cpu", None]
    errs = [float((preds["cuda", None][:, i] - want[:, i]).abs().max()
                  / want[:, i].abs().max()) for i in range(want.shape[1])]
    rel_bf16 = [float((preds["cuda", torch.bfloat16][:, i] - want[:, i]).norm()
                      / want[:, i].norm()) for i in range(want.shape[1])]
    ok = all(math.isfinite(e) and e <= 1e-3 for e in errs)
    log(f"{path.name} rollout batch {cb} ({ds.stepper_mode}, {len(ti) - 1} steps): card "
        f"vs CPU plain route, fp32 max error over each step's largest entry "
        f"{' '.join(f'{e:.2e}' for e in errs)} (each within 1e-3) "
        f"{'ok' if ok else 'MISMATCH'}; bf16 relative L2 by step "
        f"{' '.join(f'{e:.2e}' for e in rel_bf16)}")
    if not ok:
        fail(f"{path.name}: the fp32 rollout disagrees with the CPU plain route")
    del preds

    model = _model(path, torch.bfloat16, "cuda")
    graphs, coord, _ = _graph_args(path, path.batch, "cuda")
    x = torch.from_numpy(x0).cuda()
    out = {}
    for mode in PREDICT_MODES:
        ti = predict_mode_indices(mode, ds.max_time_diff, ds.time_step)
        forwards = len(ti) - 1
        torch.cuda.synchronize()
        kernels.reset_launches()
        pred = rollout(model, graphs, coord, x, ti)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        _expect_launches(f"{path.name} rollout ({mode})", launches,
                         {k: v * forwards for k, v in path.forward_launches.items()})
        if pred.shape != (path.batch, forwards, n, cout) or not torch.isfinite(pred).all():
            fail(f"{path.name} rollout ({mode}): shape {tuple(pred.shape)} or non-finite")
        run = lambda: rollout(model, graphs, coord, x, ti)
        times = host_times(run, 5)
        ms = statistics.median(times)
        log(f"{path.name} rollout ({mode}) batch {path.batch} bf16: {forwards} forwards, "
            f"launches {launches}; rollout_ms median={ms:.3f} min={min(times):.3f} "
            f"max={max(times):.3f}, {ms / forwards:.3f} ms a forward")
        if mode == "autoregressive":
            profile_step(run, f"{path.name} rollout ({mode})", steps=3)
        out[mode] = (forwards, launches, ms)
    del model, graphs
    torch.cuda.empty_cache()
    return out


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
    raw["setup"].update({"epoch_scan": "never", **setup})
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


def _cli_profiled(cfg_path: str, raw: dict, what: str):
    """``_cli_in_process`` under the device-only profiler, its trace held
    whole: it must hold one multiply-reduce kernel for each launch the
    wrappers counted. The profiler's device tracing now and then delivers
    no trace, or part of one, on the H100, and a row-gather count read from
    such a trace says nothing; the run is then taken again (its CSV row
    removed first), at most twice more, a second after the last. Returns
    (launches, routes, seconds, the device kernels, the output)."""
    from torch.autograd import DeviceType

    for attempt in range(3):
        launches, routes, secs, prof, out = _cli_in_process(cfg_path, what, profile=True)
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                  and e.self_device_time_total > 0]
        traced = sum(e.count for e in events if "mulred_" in e.key)
        counted = launches["multiply_reduce_k"] + launches["multiply_reduce_b"]
        if traced == counted:
            return launches, routes, secs, events, out
        log(f"  [{what}] the trace holds {traced} multiply-reduce kernels of the "
            f"{counted} launched, {sum(e.count for e in events)} kernels in all "
            f"(trace {attempt + 1})")
        if os.path.exists(raw["path"]["database_path"]):
            os.remove(raw["path"]["database_path"])
        time.sleep(1.0)
    fail(f"trainer {what}: three device traces in a row missed kernels the run launched")


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
        launches_a, routes_a, secs_a, events, out_a = _cli_profiled(
            cfg_a, raw_a, "run A bf16")
        peak_a = torch.cuda.max_memory_allocated()
        log(f"trainer run A: {steps} training steps, {evals} evaluation batches; "
            f"launches {launches_a}; routes {routes_a}; {secs_a:.1f} s in the CLI")
        rec_a, row_a = _check_run("run A bf16", raw_a, launches_a, routes_a, want_a,
                                  "cuda")
        if _ckpt_step(raw_a) != steps:
            fail(f"trainer run A: the checkpoint's step is {_ckpt_step(raw_a)}, "
                 f"expected {steps}")
        busy_s = sum(e.self_device_time_total for e in events) / 1e6
        # PyTorch's row gather runs only where the loader selects a batch's
        # samples from the split buffers on the device (index_select: one
        # for u, one for c, per batch); the model runs none.
        gathers = [e for e in events if "vectorized_gather_kernel" in e.key]
        n_gathers = sum(e.count for e in gathers)
        loader_gathers = 2 * (steps + evals)
        train_s = float(row_a["training time"])
        log(f"trainer run A device profile (the whole CLI run): device busy "
            f"{busy_s:.3f} s of "
            f"{secs_a:.3f} s, kernels {sum(e.count for e in events)}; row gathers "
            f"(vectorized_gather_kernel) {n_gathers} in "
            f"{sum(e.self_device_time_total for e in gathers) / 1e3:.3f} ms, the "
            f"loader's batch selects {loader_gathers}, the model's "
            f"{n_gathers - loader_gathers}")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"    {e.self_device_time_total / 1e3:10.3f} ms {e.count:7d} calls  "
                f"{e.key[:90]}")
        if n_gathers != loader_gathers:
            fail(f"trainer run A: {n_gathers} row gathers (vectorized_gather_kernel) "
                 f"where the loader's batch selects are {loader_gathers}: the model "
                 f"runs PyTorch's row gather beside them")
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
        rates = {"sps_b": float(row_b["samples_per_sec"]), "first_b": first_b,
                 "steady_b": steady_b}
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
        rates["launches_c"] = launches_c
    log(f"trainer phase: {time.perf_counter() - t_phase:.1f} s")
    return launches_a, rates


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
        raw["setup"]["epoch_scan"] = "never"
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
        fwd, train = _tables(graphs, tcfg.num_layers, ffn=False)
        per_batch = sum(isinstance(v, torch.Tensor) and v.is_cuda
                        for k, v in batch.items()
                        if k not in probe.train_loader.layout)
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
        launches, routes, secs, events, out = _cli_profiled(cfg_path, raw,
                                                            "elasticity fp32")
        peak = torch.cuda.max_memory_allocated()
        log(f"vx trainer: launches {launches}; routes {routes}; {secs:.1f} s in the CLI")
        rec, row = _check_run("elasticity fp32", raw, launches, routes, want, "plain")
        if not all(r == "vx:cuda" for r in routes["agno"].split("+")):
            fail(f"vx trainer: agno routes {routes['agno']}, expected vx:cuda")
        if _ckpt_step(raw) != steps:
            fail(f"vx trainer: the checkpoint's step is {_ckpt_step(raw)}, expected {steps}")
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
            fail(f"vx trainer: {n_gathers} row gathers (vectorized_gather_kernel) "
                 f"where the loader's batch selects are {loader_gathers}: the model "
                 f"runs PyTorch's row gather beside them")
        first, steady = _steady_rate(out, VX_TRAINER_SIZES["train_size"])
        log(f"vx trainer elasticity fp32 ({card}): training time "
            f"{float(row['training time']):.3f} s, samples_per_sec "
            f"{float(row['samples_per_sec']):.1f} (under the device profiler; "
            f"{first:.3f} s to the first evaluation, {steady:.1f} samples/s after it), "
            f"max_memory_allocated {peak / 2**30:.3f} GiB; the vx flagship's bare "
            f"step (batch {VX_BATCH}, 8192 nodes): median {step_ms:.3f} ms")
    log(f"vx trainer phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


# Phase 5c: the sequential trainer. Run A: ns_gauss.json in bf16, cut to
# these split sizes and epochs (the example: 1024 / 128 / 256 samples, 500
# epochs); run B: ce_crp.json in its own fp32, cut the same way; both with
# a validation every epoch (the examples: every 2), so that their two
# epochs give two losses; both on synthetic data at the Poseidon layout
# (tests/torch_synthetic.py: 21 snapshots of the 128x128 lattice, seed 0).
# Run C: vx sequential (tests/synthetic.py::make_sequential_vx_dataset's
# layout, a mesh per sample, fixed over 15 steps) at the ns_gauss model's
# full width, fp32.
SEQ_SIZES = {"train_size": 128, "val_size": 16, "test_size": 32}
SEQ_EPOCHS = 2        # a validation each: the example validates every 2
CE_SIZES = {"train_size": 64, "val_size": 16, "test_size": 32}
CE_EPOCHS = 2
VXSEQ_SIZES = {"train_size": 48, "val_size": 8, "test_size": 8}
VXSEQ_NODES, VXSEQ_BATCH, VXSEQ_EPOCHS = 4096, 16, 2
VXSEQ_META = "_chip_smoke/seq_vx"


def _seq_example(folder: str, config: str, run: str, sizes: dict, epochs: int,
                 eval_every: int = None, **setup) -> tuple:
    """An example config read from disk with ``sizes``, ``epochs`` (and a
    validation every ``eval_every`` epochs where given), its data and every
    output path in ``folder`` (under ``run``) and ``setup`` merged in.
    Returns (the written config's path, the config)."""
    with open(config) as f:
        raw = json.load(f)
    raw["setup"].update({"epoch_scan": "never", **setup})
    raw["dataset"].update(sizes, base_path=folder)
    raw["optimizer"]["args"]["epoch"] = epochs
    if eval_every is not None:
        raw["optimizer"]["args"]["eval_every_eps"] = eval_every
    raw["path"] = {k: os.path.join(folder, run, os.path.basename(v))
                   for k, v in raw["path"].items()}
    path = os.path.join(folder, f"{run}.json")
    with open(path, "w") as f:
        json.dump(raw, f, indent=1)
    return path, raw


def _seq_plan(trainer, graphs, ffn: bool) -> tuple:
    """What a fit of ``trainer`` (a SequentialTrainer, not fitted) must
    launch: the training step's table times the steps, plus the forward's
    times the validation batches and the rollout forwards of test() (each
    predict mode's steps for each test batch). Returns (launches, steps,
    validation batches, rollout forwards)."""
    from gaot_torch.train import predict_mode_indices
    from gaot_torch.train.sequential_trainer import PREDICT_MODES

    ds, args = trainer.dataset_config, trainer.optimizer_config.args
    fwd, train = _tables(graphs, trainer.model_config.args.transformer.num_layers, ffn)
    steps = args.epoch * len(trainer.train_loader)
    vals = args.epoch // args.eval_every_eps * len(trainer.val_loader)
    t_lim = min(ds.max_time_diff, trainer.splits["test"]["u"].shape[1] - 1)
    modes = PREDICT_MODES if ds.predict_mode == "all" else (ds.predict_mode,)
    n_test = trainer.splits["test"]["u"].shape[0]
    rollouts = math.ceil(n_test / min(ds.batch_size, n_test)) * sum(
        len(predict_mode_indices(m, t_lim, ds.time_step)) - 1 for m in modes)
    want = {k: train.get(k, 0) * steps + fwd.get(k, 0) * (vals + rollouts)
            for k in set(train) | set(fwd)}
    return want, steps, vals, rollouts


def _check_seq_errors(what: str, row: dict) -> None:
    errs = {k: float(row[f"relative error ({k})"]) for k in ("direct", "auto2", "auto4")}
    log(f"trainer {what}: rollout relative errors {errs}")
    if not all(map(math.isfinite, errs.values())):
        fail(f"trainer {what}: a rollout error is not finite ({errs})")


def phase_seq_trainer(card: str, step_ms: float, rollout: dict):
    """Phase 5c: the sequential examples through the CLI and vx sequential
    through SequentialTrainer (module docstring). Returns run A's
    launches."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from gaot_torch.core import metadata as meta
    from gaot_torch.ops import cuda as kernels
    from gaot_torch.train import SequentialTrainer
    from gaot_torch.utils.routing import format_routes, reset_routes

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from synthetic import make_sequential_vx_dataset
    from torch_synthetic import POSEIDON_GRID, POSEIDON_STEPS, make_poseidon_sequential_dataset

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="gaot_seq_trainer_") as folder:
        # Run A: ns_gauss.json in bf16 through gaot_torch.cli.main, in this
        # process, under a device-only profiler.
        cfg_a, raw_a = _seq_example(folder, SEQ_CONFIG, "run_a", SEQ_SIZES, SEQ_EPOCHS,
                                    eval_every=1, compute_dtype="bfloat16")
        n_a = sum(SEQ_SIZES.values())
        t0 = time.perf_counter()
        make_poseidon_sequential_dataset(
            os.path.join(folder, f"{raw_a['dataset']['name']}.npz"), n_a, channels=2, seed=0)
        log(f"sequential trainer data (run A): {n_a} samples x {POSEIDON_STEPS} steps x "
            f"{POSEIDON_GRID}^2 nodes x 2 channels (seed 0, written in "
            f"{time.perf_counter() - t0:.1f} s), splits {SEQ_SIZES}, {SEQ_EPOCHS} epochs")
        # The tables from the graphs a trainer of the same config builds
        # (not fitted). The loader assembles each batch's pairs on the card
        # with one index_select (PyTorch's row gather) for u (both steps),
        # none for c (the set has none).
        probe = SequentialTrainer(copy.deepcopy(raw_a))
        want_a, steps, vals, rollouts = _seq_plan(probe, probe.graphs, ffn=True)
        per_batch = probe.train_loader.row_selects
        pairs = probe.train_loader.num_samples
        log(f"sequential run A plan: {pairs} training pairs a epoch, {steps} steps, "
            f"{vals} validation batches, {rollouts} rollout forwards; launches {want_a}; "
            f"the loader's row gathers {per_batch} a batch")
        del probe
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        launches_a, routes_a, secs_a, events, out_a = _cli_profiled(
            cfg_a, raw_a, "seq run A bf16")
        peak_a = torch.cuda.max_memory_allocated()
        log(f"sequential run A: launches {launches_a}; routes {routes_a}; "
            f"{secs_a:.1f} s in the CLI")
        rec_a, row_a = _check_run("seq run A bf16", raw_a, launches_a, routes_a, want_a,
                                  "cuda")
        _check_seq_errors("seq run A bf16", row_a)
        if _ckpt_step(raw_a) != steps:
            fail(f"sequential run A: the checkpoint's step is {_ckpt_step(raw_a)}, "
                 f"expected {steps}")
        busy_s = sum(e.self_device_time_total for e in events) / 1e6
        n_gathers = sum(e.count for e in events if "vectorized_gather_kernel" in e.key)
        loader_gathers = per_batch * (steps + vals)
        log(f"sequential run A device profile: busy {busy_s:.3f} s of {secs_a:.3f} s, "
            f"kernels {sum(e.count for e in events)}; row gathers "
            f"(vectorized_gather_kernel) {n_gathers}, the loader's pair assembly "
            f"{loader_gathers} ({per_batch} a batch x {steps} steps + {vals} validation "
            f"batches), the model's and the rollout's {n_gathers - loader_gathers}")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"    {e.self_device_time_total / 1e3:10.3f} ms {e.count:7d} calls  "
                f"{e.key[:90]}")
        if n_gathers != loader_gathers:
            fail(f"sequential run A: {n_gathers} row gathers (vectorized_gather_kernel) "
                 f"where the loader's pair assembly runs {loader_gathers}: PyTorch's "
                 f"row gather runs beside it")
        first, steady = _steady_rate(out_a, pairs)
        fwd_ms = rollout["autoregressive"][2] / rollout["autoregressive"][0]
        log(f"sequential run A bf16 ({card}): training time "
            f"{float(row_a['training time']):.3f} s, samples (pairs) per s "
            f"{float(row_a['samples_per_sec']):.1f} (under the device profiler; "
            f"{first:.3f} s to the first evaluation, {steady:.1f} pairs/s after it), "
            f"max_memory_allocated {peak_a / 2**30:.3f} GiB; the bare step (batch "
            f"{BATCH}, 16384 nodes): median {step_ms:.3f} ms = "
            f"{BATCH / step_ms * 1e3:.1f} pairs/s; a rollout forward {fwd_ms:.3f} ms")
        os.remove(os.path.join(folder, f"{raw_a['dataset']['name']}.npz"))

        # Run B: ce_crp.json in its own fp32, through gaot_torch.cli.main.
        cfg_b, raw_b = _seq_example(folder, CE_CONFIG, "run_b", CE_SIZES, CE_EPOCHS,
                                    eval_every=1)
        make_poseidon_sequential_dataset(
            os.path.join(folder, f"{raw_b['dataset']['name']}.npz"),
            sum(CE_SIZES.values()), channels=4, seed=0)
        # In this process: phase 5's run B and phase 8 start the CLI as a
        # command of its own.
        _, routes_b, secs_b, _, _ = _cli_in_process(cfg_b, "seq run B")
        rec_b, row_b = _check_run("seq run B fp32", raw_b, {}, routes_b, {}, "plain")
        _check_seq_errors("seq run B fp32", row_b)
        log(f"sequential run B fp32 ({card}; ce_crp, 4 channels, in process, "
            f"{secs_b:.1f} s): samples (pairs) per s "
            f"{float(row_b['samples_per_sec']):.1f}, training time "
            f"{float(row_b['training time']):.3f} s; ffn={routes_b.get('ffn')} (no "
            f"SwiGLU launch in fp32)")

        # Run C: vx sequential through SequentialTrainer, fp32.
        make_sequential_vx_dataset(os.path.join(folder, "seq_vx.npz"),
                                   num_samples=sum(VXSEQ_SIZES.values()),
                                   num_nodes=VXSEQ_NODES, seed=0)
        meta.DATASET_METADATA[VXSEQ_META] = meta.Metadata(
            periodic=False, group_u="u", group_c="c", group_x="x", type="gaot",
            domain_x=([0, 0], [1, 1]), domain_t=(0, 1), fix_x=False,
            active_variables=[0], chunked_variables=[0], num_variable_chunks=1,
            signed={"u": [True], "c": [True]}, names={"u": ["$u$"], "c": ["$c$"]},
            global_mean=[0.0], global_std=[1.0])
        _, raw_c = _seq_example(folder, SEQ_CONFIG, "run_c", VXSEQ_SIZES, VXSEQ_EPOCHS,
                                eval_every=1)
        raw_c["dataset"].update(name="seq_vx", metaname=VXSEQ_META,
                                batch_size=VXSEQ_BATCH, stepper_mode="output")
        try:
            t0 = time.perf_counter()
            trainer = SequentialTrainer(raw_c)
            graphs = trainer._batch_graphs(trainer.place_batch(next(iter(trainer.val_loader))))
            want_c, steps_c, vals_c, rollouts_c = _seq_plan(trainer, graphs, ffn=False)
            log(f"sequential run C (vx, {VXSEQ_NODES} nodes a sample, batch {VXSEQ_BATCH}, "
                f"fp32): trainer built in {time.perf_counter() - t0:.1f} s; {steps_c} "
                f"steps, {vals_c} validation batches, {rollouts_c} rollout forwards; "
                f"launches {want_c}")
            torch.cuda.synchronize()
            reset_routes()
            kernels.reset_launches()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                trainer.fit()
                torch.cuda.synchronize()
            for line in buf.getvalue().splitlines():
                log(f"  [seq run C] {line}")
            launches_c = kernels.launch_counts()
            routes_c = dict(kv.split("=", 1) for kv in format_routes().split())
        finally:
            del meta.DATASET_METADATA[VXSEQ_META]
        _expect_launches("sequential run C (vx)", launches_c, want_c)
        if not all(r == "vx:cuda" for r in routes_c["agno"].split("+")) \
                or routes_c.get("attn") != "cuda":
            fail(f"sequential run C: routes {routes_c}")
        losses = [float(v) for v in np.load(raw_c["path"]["loss_path"][:-4] + ".npz")["losses"]]
        _check_seq_errors("seq run C vx fp32", trainer.datarow)
        log(f"sequential run C vx fp32 ({card}): launches {launches_c}; routes {routes_c}; "
            f"train losses {' '.join(f'{v:.5f}' for v in losses)}; samples (pairs) per s "
            f"{trainer.datarow['samples_per_sec']:.1f}")
        if not losses[-1] < losses[0]:
            fail(f"sequential run C: the train loss did not fall ({losses})")
        del trainer, graphs
        torch.cuda.empty_cache()
    log(f"sequential trainer phase: {time.perf_counter() - t_phase:.1f} s")
    return launches_a


# Phase 5d: the naca0012 recipe (config/examples/time_indep/naca0012.json, a
# mesh per sample, edge drop with sampling_strategy "max_neighbors" and
# max_neighbors 32) trained through the CLI on synthetic data at the airfoil
# layout (tests/torch_synthetic.py::make_naca_dataset: 6144 nodes a sample
# clustered around a NACA 0012 profile in the metadata domain, 3 c channels
# and 1 u channel, seed 0), the example's batch of 32 and its fp32, cut to
# these split sizes and epochs (the example: 1024 / 128 / 256 samples, 500
# epochs).
NACA = os.path.join(HERE, "config", "examples", "time_indep", "naca0012.json")
NACA_SIZES = {"train_size": 128, "val_size": 16, "test_size": 32}
NACA_EPOCHS = 6
NACA_CHECK_BATCH = 2
# Degree bins of the encoder's histogram.
DEGREE_BINS = (0, 1, 8, 16, 32, 64, 128, 256, 512)


def _thin(graphs, strategy: str, generator, **kw):
    """The FlatGraphs ``graphs`` (FxGraphs) with every bucket's mask thinned
    by ``apply_edge_drop_mask`` (new masks; the graphs given untouched)."""
    from gaot_torch.ops.edge_drop import apply_edge_drop_mask

    def side(gs):
        return [g._replace(buckets=tuple(
            b._replace(mask=apply_edge_drop_mask(b.mask, generator, strategy, **kw))
            for b in g.buckets)) for g in gs]
    return graphs._replace(encoder=side(graphs.encoder), decoder=side(graphs.decoder))


def _bucket_rows_valid(vg):
    """Per bucket of a FlatGraph, its rows' validity [S·R_j] (all True
    where the graph has no pad rows)."""
    import torch

    s = vg.num_samples
    if vg.row_valid is None:
        return [torch.ones(b.mask.shape[0], dtype=torch.bool, device=b.mask.device)
                for b in vg.buckets]
    rv = vg.row_valid.view(s, vg.rows)
    out, base = [], 0
    for b in vg.buckets:
        rj = b.mask.shape[0] // s
        out.append(rv[:, base:base + rj].reshape(-1))
        base += rj
    return out


def _naca_drop_statistics(trainer, batches, m: int):
    """The encoder's degree histogram over the training split (valid rows),
    and the share of its valid edges each step's drop keeps, on every
    training batch: each bucket wider than ``m`` keeps min(degree, m) edges
    a row and nothing outside the graph's mask; the buckets at most ``m``
    wide, and every decoder bucket, keep their mask (no draw)."""
    import numpy as np
    import torch

    gen = torch.Generator(device="cuda").manual_seed(1)
    degs, shares = [], []
    for batch in batches:
        graphs = trainer._batch_graphs(trainer.place_batch(batch))
        kept = valid = 0
        for vg in graphs.encoder:
            dropped = trainer.model.encoder._drop_edges(vg, gen)
            for b, d, rv in zip(vg.buckets, dropped.buckets, _bucket_rows_valid(vg)):
                deg = b.mask.sum(-1)
                degs.append(deg[rv].cpu())
                if b.mask.shape[-1] <= m:
                    if d.mask is not b.mask:
                        fail(f"naca0012: the drop drew on an encoder bucket of K "
                             f"{b.mask.shape[-1]} <= {m}")
                elif not torch.equal(d.mask.sum(-1), deg.clamp(max=m)) \
                        or (d.mask & ~b.mask).any():
                    fail(f"naca0012: an encoder bucket of K {b.mask.shape[-1]} was not "
                         f"thinned to min(degree, {m}) of its own edges")
                kept += int(d.mask.sum())
                valid += int(b.mask.sum())
        for vg in graphs.decoder:
            dropped = trainer.model.decoder._drop_edges(vg, gen)
            if any(d.mask is not b.mask for b, d in zip(vg.buckets, dropped.buckets)):
                fail("naca0012: the drop touched a decoder graph")
        shares.append(kept / valid)
    deg = torch.cat(degs).numpy()
    hist, _ = np.histogram(deg, bins=list(DEGREE_BINS) + [max(int(deg.max()) + 1, 513)])
    log(f"naca0012 encoder degrees over the training split ({len(deg)} rows): "
        + ", ".join(f"[{lo}, {hi}) {c}" for lo, hi, c in zip(
            DEGREE_BINS, list(DEGREE_BINS[1:]) + ["max"], hist))
        + f"; max {int(deg.max())}, mean {deg.mean():.2f}; rows above {m}: "
        f"{int((deg > m).sum())} ({(deg > m).mean():.4f}); the edges of those rows "
        f"{deg[deg > m].sum() / deg.sum():.4f} of all")
    log(f"naca0012 edge drop: the share of the encoder's edges kept a step, over "
        f"{len(shares)} training batches: mean {np.mean(shares):.4f} min "
        f"{min(shares):.4f} max {max(shares):.4f}; every decoder graph untouched")
    return float(np.mean(shares))


def _drop_reads(graphs, magno) -> int:
    """The row reads of edge drop's uniforms in a training step
    (``ops/edge_drop.py::drop_edges``, one ``index_select``, PyTorch's row
    gather, a thinned bucket): each bucket of a bucketed graph wider than
    ``max_neighbors`` (every bucket under ``ratio``)."""
    m = magno.max_neighbors if magno.sampling_strategy == "max_neighbors" else 0
    return sum(b.mask.shape[-1] > m for g in graphs.encoder + graphs.decoder
               if g.perm is not None for b in g.buckets)


def _naca_drop_cost(trainer, batch, train_table):
    """The same batch-32 fp32 step with and without the edge drop: launches
    (each the step's table), step ms and the profile's device busy, idle
    share and kernels a step; then the evaluation forward's profile. No
    profile may hold PyTorch's row gather but the drop's reads of its
    uniforms (:func:`_drop_reads`)."""
    import torch

    from gaot_torch.ops import cuda as kernels
    from gaot_torch.train.static_trainer import eval_step, train_step

    magno = trainer.model_config.args.magno
    placed = trainer.place_batch(batch)
    graphs, coord, nmask = trainer._model_args(placed)
    gen = torch.Generator(device="cuda").manual_seed(4)
    smask = trainer.sample_mask(placed)
    strategy = magno.sampling_strategy

    def run():
        return train_step(trainer.model, trainer.optimizer, trainer.schedule, 0,
                          graphs, coord, placed["c"], placed["u"], smask, nmask,
                          None, gen)

    out = {}
    try:
        for label, strat in (("with the drop", strategy), ("without", None)):
            magno.sampling_strategy = strat
            torch.cuda.synchronize()
            kernels.reset_launches()
            run()
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
            _expect_launches(f"naca0012 step {label}", launches, train_table)
            times = host_times(run, 10)
            # The drop's uniforms are drawn in query order and each thinned
            # bucket reads its rows' (one index_select a bucket).
            prof = profile_step(run, f"naca0012 training step {label}",
                                gathers=_drop_reads(graphs, magno) if strat else 0)
            log(f"  naca0012 step {label} (batch {placed['c'].shape[0]}, fp32): "
                f"launches {launches}; step_ms {fmt_times(times, placed['c'].shape[0])}")
            out[label] = dict(prof, ms=statistics.median(times))
    finally:
        magno.sampling_strategy = strategy
    profile_step(lambda: eval_step(trainer.model, graphs, coord, placed["c"], placed["u"],
                                   smask, nmask), "naca0012 forward (evaluation)")
    a, b = out["with the drop"], out["without"]
    log(f"naca0012: the drop adds {a['ms'] - b['ms']:.3f} ms to the step median "
        f"({a['ms']:.3f} vs {b['ms']:.3f}), {a['busy_ms'] - b['busy_ms']:.3f} ms of "
        f"device busy ({a['busy_ms']:.3f} vs {b['busy_ms']:.3f}) and "
        f"{a['kernels'] - b['kernels']:.0f} kernels ({a['kernels']:.0f} vs "
        f"{b['kernels']:.0f})")
    return out


def _naca_agreement(trainer, batch):
    """Batch 2: the card's route against the CPU plain route on the same
    dropped masks, drawn once on the CPU and copied to the card; the model's
    seeded fp32 weights in training mode; the forward (rtol 1e-3, atol 1e-3
    of its largest entry), the masked loss (rel 1e-4) and every gradient
    within 1e-3 of its largest entry."""
    import torch

    from gaot_torch.data.graph_builder import vx_flat_graphs, vx_layout
    from gaot_torch.models import GAOT
    from gaot_torch.train.static_trainer import FxGraphs, masked_mse

    cb = NACA_CHECK_BATCH
    keep = [k for k, v in batch.items() if isinstance(v, torch.Tensor)
            and k not in trainer.train_loader.layout]
    bufs = {k: batch[k][:cb].cpu().numpy() for k in keep}
    bufs.update(vx_layout(bufs, cb))
    nscales = len(trainer.model_config.args.magno.scales)
    gen = torch.Generator().manual_seed(2)
    res, dropped = {}, None
    for dev in ("cpu", "cuda"):
        b = {k: torch.from_numpy(v).to(dev) for k, v in bufs.items()}
        graphs = FxGraphs(trainer.latent.to(dev), *vx_flat_graphs(b, nscales))
        model = GAOT(trainer.num_input_channels, trainer.num_output_channels,
                     trainer.model_config, dtype=None, device=dev,
                     generator=torch.Generator().manual_seed(0)).train()
        if dropped is None:
            dropped = (
                [model.encoder._drop_edges(g, gen) for g in graphs.encoder],
                [model.decoder._drop_edges(g, gen) for g in graphs.decoder])
            thinned = sum(int(a.mask.sum() - d.mask.sum())
                          for g, dg in zip(graphs.encoder, dropped[0])
                          for a, d in zip(g.buckets, dg.buckets))
        take = lambda gs, ds: [g._replace(buckets=tuple(
            bk._replace(mask=d.mask.to(dev)) for bk, d in zip(g.buckets, dg.buckets)))
            for g, dg in zip(gs, ds)]
        graphs = graphs._replace(encoder=take(graphs.encoder, dropped[0]),
                                 decoder=take(graphs.decoder, dropped[1]))
        pred = model(graphs.latent_tokens_coord, b["x"], b["c"], graphs.encoder,
                     graphs.decoder)
        loss = masked_mse(pred, b["u"], torch.ones(cb, dtype=torch.bool, device=dev),
                          b["node_mask"])
        loss.backward()
        res[dev] = (pred.detach().float().cpu(), float(loss.detach()),
                    {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()})
        del model, graphs
    (pg, lg, gg), (pc, lc, gc) = res["cuda"], res["cpu"]
    scale = float(pc.abs().max())
    ok_fwd = bool(torch.allclose(pg, pc, rtol=1e-3, atol=1e-3 * scale))
    per = {n: float((gg[n] - gc[n]).abs().max() / gc[n].abs().max().clamp(min=1e-30))
           for n in gc}
    worst = max(per, key=per.get)
    loss_rel = abs(lg - lc) / abs(lc)
    ok = ok_fwd and loss_rel <= 1e-4 and per[worst] <= 1e-3 \
        and all(torch.isfinite(g).all() for g in gg.values())
    log(f"naca0012 batch {cb} fp32, the same dropped masks on both sides ({thinned} "
        f"encoder edges dropped): forward max_abs {float((pg - pc).abs().max()):.3e} "
        f"(rtol 1e-3, atol 1e-3·max|ref| = {1e-3 * scale:.2e}); loss {lg:.6f} vs {lc:.6f} "
        f"(rel {loss_rel:.2e}, bound 1e-4); worst gradient {per[worst]:.3e} of its "
        f"largest entry ({worst}; bound 1e-3) {'ok' if ok else 'MISMATCH'}")
    if not ok or thinned <= 0:
        fail("naca0012: the card disagrees with the CPU plain route on dropped masks, "
             "or nothing was dropped")


def phase_naca(card: str, rnd):
    """Phase 5d: the naca0012 recipe through the CLI (module docstring).
    Returns (the run's launches, the multiply-reduce rows on its dropped
    masks, phase 11.3's results on its trainer)."""
    import tempfile

    import torch
    from torch.autograd import DeviceType

    from gaot_torch import cli

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_synthetic import NACA_POINTS, make_naca_dataset

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="gaot_naca_") as folder:
        with open(NACA) as f:
            raw = json.load(f)
        n = sum(NACA_SIZES.values())
        t0 = time.perf_counter()
        make_naca_dataset(os.path.join(folder, f"{raw['dataset']['name']}.npz"),
                          num_samples=n, seed=0)
        raw["dataset"].update(NACA_SIZES, base_path=folder)
        raw["setup"]["epoch_scan"] = "never"
        raw["optimizer"]["args"]["epoch"] = NACA_EPOCHS
        raw["path"] = {k: os.path.join(folder, "run", os.path.basename(v))
                       for k, v in raw["path"].items()}
        cfg_path = os.path.join(folder, "naca0012.json")
        with open(cfg_path, "w") as f:
            json.dump(raw, f, indent=1)
        magno = raw["model"]["args"]["magno"]
        log(f"naca0012 data: {n} samples x {NACA_POINTS} nodes clustered around the "
            f"profile (seed 0, {time.perf_counter() - t0:.1f} s), splits {NACA_SIZES}, "
            f"{NACA_EPOCHS} epochs, batch {raw['dataset']['batch_size']}, fp32, "
            f"sampling_strategy {magno['sampling_strategy']!r}, max_neighbors "
            f"{magno['max_neighbors']}")

        # The trainer the CLI runs, kept for its graphs and the checks after
        # the fit.
        ran = []
        run_config = cli.run_config

        def keep_trainer(path):
            ran.append(run_config(path))
            return ran[-1]

        cli.run_config = keep_trainer
        try:
            torch.cuda.reset_peak_memory_stats()
            launches, routes, secs, prof, out = _cli_in_process(cfg_path, "naca0012 fp32",
                                                                profile=True)
        finally:
            cli.run_config = run_config
        peak = torch.cuda.max_memory_allocated()
        trainer = ran[0]
        batches = list(trainer.train_loader)
        graphs = trainer._batch_graphs(trainer.place_batch(batches[0]))
        fwd, train = _tables(graphs, trainer.model_config.args.transformer.num_layers,
                             ffn=False)
        ds, args = trainer.dataset_config, trainer.optimizer_config.args
        nb = lambda k: math.ceil(k / min(ds.batch_size, k))
        steps = args.epoch * nb(ds.train_size)
        evals = args.epoch // args.eval_every_eps * nb(ds.val_size) + nb(ds.test_size)

        want = {k: train.get(k, 0) * steps + fwd.get(k, 0) * evals
                for k in set(train) | set(fwd)}
        log(f"naca0012 tables (the trainer's graphs): a step {train}, a forward {fwd}; "
            f"{steps} steps, {evals} evaluation batches; launches {launches}; routes "
            f"{routes}; {secs:.1f} s in the CLI")
        rec, row = _check_run("naca0012 fp32", raw, launches, routes, want, "plain")
        if not all(r == "vx:cuda" for r in routes["agno"].split("+")):
            fail(f"naca0012: agno routes {routes['agno']}, expected vx:cuda")
        if _ckpt_step(raw) != steps:
            fail(f"naca0012: the checkpoint's step is {_ckpt_step(raw)}, expected {steps}")
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                  and e.self_device_time_total > 0]
        busy_s = sum(e.self_device_time_total for e in events) / 1e6
        # The loader selects each batch's buffers with index_select, which
        # takes PyTorch's row gather for some of them and other kernels for
        # the rest, by the buffers' sizes and alignment: its count a batch
        # varies, so the model's share is held by the step's and the
        # forward's profiles below (no row gather), not by a difference.
        n_gathers = sum(e.count for e in events if "vectorized_gather_kernel" in e.key)
        log(f"naca0012 device profile: busy {busy_s:.3f} s of {secs:.3f} s, kernels "
            f"{sum(e.count for e in events)}; row gathers (vectorized_gather_kernel) "
            f"{n_gathers}, {n_gathers / (steps + evals):.2f} a batch (the loader's "
            f"selects of {sum(isinstance(v, torch.Tensor) for v in batches[0].values())} "
            f"buffers)")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"    {e.self_device_time_total / 1e3:10.3f} ms {e.count:7d} calls  "
                f"{e.key[:90]}")
        first, steady = _steady_rate(out, NACA_SIZES["train_size"])
        log(f"naca0012 fp32 ({card}): training time {float(row['training time']):.3f} s, "
            f"samples_per_sec {float(row['samples_per_sec']):.1f} (under the device "
            f"profiler; {first:.3f} s to the first evaluation, {steady:.1f} samples/s "
            f"after it), max_memory_allocated {peak / 2**30:.3f} GiB")

        _naca_drop_statistics(trainer, batches, trainer.model_config.args.magno.max_neighbors)
        _naca_drop_cost(trainer, batches[0], train)
        _naca_agreement(trainer, batches[0])
        # Phase 11.3 on this trainer: its epoch path captured, edge drop and
        # all, against its per-step path.
        with _Draws() as draws:
            graph = _trainer_graph(f"naca0012 (edge drop to {magno['max_neighbors']}, "
                                   f"fp32, batch {raw['dataset']['batch_size']})",
                                   trainer, card, draws)

        # The multiply-reduces on the batch's masks with holes: ratio 0.5 on
        # every bucket, then the example's max_neighbors 32 (the rows the
        # kernels line reports).
        gen = torch.Generator(device="cuda").manual_seed(5)
        b = batches[0]["c"].shape[0]
        n_pad, nq = batches[0]["x"].shape[1], trainer.latent.shape[0]
        c = trainer.model_config.args.magno.lifting_channels
        for label, kw in (("ratio 0.5", dict(sample_ratio=0.5)),
                          ("max_neighbors 32", dict(max_neighbors=32))):
            thinned = _thin(graphs, label.split()[0], gen, **kw)
            what = f"naca0012, {label}"
            rows = check_multiply_reduce(
                rnd, 1, c, _flat_reduce_cases(thinned, b, n_pad, nq, what,
                                              train["multiply_reduce_k"]), what)
        # The flash kernels at the UViT's shapes here (batch 32, S = 1024, 8
        # heads of dim 32), the example's fp32 in the rows.
        tcfg = trainer.model_config.args.transformer
        heads = tcfg.attn_config.num_heads
        rows.update(check_flash(rnd, b, SEQ, heads, tcfg.hidden_size // heads,
                                row_dtype="float32"))
        del trainer, graphs, batches
        torch.cuda.empty_cache()
    log(f"naca0012 phase: {time.perf_counter() - t_phase:.1f} s")
    return launches, rows, graph


# Phase 6: attention dropout at this rate on the fx main path's training step
# (batch 64, bf16): the plain attention with dropout in place of the flash
# kernels, as the JAX package routes it.
ATTN_DROPOUT = 0.1


def phase_attn_dropout(path: Path, step_ms: float):
    """Phase 6 (module docstring)."""
    import torch

    from gaot_torch.models import transformer
    from gaot_torch.ops import cuda as kernels
    from gaot_torch.train.schedules import make_optimizer
    from gaot_torch.train.static_trainer import train_step
    from gaot_torch.utils.routing import format_routes, reset_routes

    cfg = copy.deepcopy(path.cfg)
    cfg.model.args.transformer.attn_config.atten_dropout = ATTN_DROPOUT
    pndata, target = _batch(2, path)
    xp, xt = torch.from_numpy(pndata).cuda(), torch.from_numpy(target).cuda()
    smask = torch.ones(path.batch, dtype=torch.bool, device="cuda")
    graphs, xc, nmask = _graph_args(path, path.batch, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    for rate, drop_path in ((ATTN_DROPOUT, path._replace(cfg=cfg)), (0.0, path)):
        model = _model(drop_path, torch.bfloat16, "cuda")
        opt, sched = make_optimizer(path.cfg.optimizer, model.parameters(),
                                    path.steps_per_epoch)
        step = [0]

        def run():
            loss = train_step(model, opt, sched, step[0], graphs, xc, xp, xt, smask,
                              nmask, None, gen)
            step[0] += 1
            return loss

        counted = []
        draw = transformer.dropout_keep

        def count_keep(*a, **kw):
            keep = draw(*a, **kw)
            counted.append((keep.sum(), keep.numel()))
            return keep

        transformer.dropout_keep = count_keep
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_routes()
            kernels.reset_launches()
            loss = float(run())
            torch.cuda.synchronize()
        finally:
            transformer.dropout_keep = draw
        launches = kernels.launch_counts()
        routes = format_routes()
        peak = torch.cuda.max_memory_allocated()
        if rate == 0.0:
            # The existing table, the flash kernels included.
            _expect_launches("fx step at attention dropout 0, with a generator",
                             launches, TRAIN_LAUNCHES)
            if counted or "attn=cuda" not in routes:
                fail(f"fx step at attention dropout 0: routes {routes}, {len(counted)} "
                     f"keep draws")
            log(f"fx step at attention dropout 0 with a generator: launches {launches} "
                f"(the table), routes {routes}")
            del model, opt
            continue
        want = {k: v for k, v in TRAIN_LAUNCHES.items() if not k.startswith("flash")}
        _expect_launches("fx step with attention dropout", launches, want)
        kept = sum(int(s) for s, _ in counted)
        total = sum(n for _, n in counted)
        share = kept / total
        sigma = math.sqrt(ATTN_DROPOUT * (1 - ATTN_DROPOUT) / total)
        ok = ("attn=plain-dropout" in routes and math.isfinite(loss)
              and len(counted) == path.cfg.model.args.transformer.num_layers
              and abs(share - (1 - ATTN_DROPOUT)) <= 4 * sigma)
        log(f"fx step with attention dropout {ATTN_DROPOUT} (batch {path.batch}, bf16): "
            f"routes {routes}; launches {launches}; loss {loss:.5f}; keep share "
            f"{share:.6f} of {total} weights in {len(counted)} layers (1 - rate = "
            f"{1 - ATTN_DROPOUT}, 4 sigma = {4 * sigma:.2e}); max_memory_allocated "
            f"{peak / 2**30:.3f} GiB {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail("fx step with attention dropout: route, loss, layers or keep share")
        times = host_times(run, 5)
        log(f"  step_ms {fmt_times(times, path.batch)}; the step at rate 0 (phase 4): "
            f"median {step_ms:.3f} ms")
        profile_step(run, "fx training step with attention dropout", steps=5)
        del model, opt
        torch.cuda.empty_cache()


def phase_pointnet(main_path: Path, vx_path: Path, step_ms: float):
    """Phase 7: the pointnet embedding (max pooling) on the fx main path
    (the batch-4 fp32 check against the CPU, then the batch-64 bf16 forward
    and step with their launch tables, timings and profiles) and the fp32
    check on a batch of 2 of the vx flagship."""
    def pointnet(path):
        cfg = copy.deepcopy(path.cfg)
        cfg.model.args.magno.embedding_method = "pointnet"
        cfg.model.args.magno.pooling = "max"
        return cfg

    fx = main_path._replace(name="fx main path, pointnet", cfg=pointnet(main_path),
                            check_dtypes=("fp32",))
    fwd = phase_forward(fx)
    _, ms = phase_train(fx)
    vx = vx_path._replace(name="vx flagship, pointnet", cfg=pointnet(vx_path),
                          check_dtypes=("fp32",), batch=0)
    phase_forward(vx)
    phase_train(vx)
    log(f"pointnet (max pooling), fx main path batch {main_path.batch} bf16: forward "
        f"median {fwd['ms']:.3f} ms, step median {ms:.3f} ms; the statistical "
        f"embedding's step (phase 4) {step_ms:.3f} ms")


# Phase 8: the MAGNO options that the examples do not set, on the vx
# flagship's graphs, and the training steps without transpose graphs; then
# the elasticity recipe with a nonlinear transform, node_embedding and the
# graph cache, twice through the CLI.
VX_OPTIONS = {   # run: MAGNO overrides
    "linear_kernelonly": {"transform_type": "linear_kernelonly"},
    "nonlinear": {"transform_type": "nonlinear"},
    "nonlinear_kernelonly": {"transform_type": "nonlinear_kernelonly"},
    "node_embedding": {"node_embedding": True},
}
CACHE_EPOCHS = 2
# The cache runs' splits: the vx trainer phase's data cut to these sizes
# (the check is the cache's hit and the losses it repeats, not the fit).
CACHE_SIZES = {"train_size": 64, "val_size": 16, "test_size": 16}


def _with_magno(path: Path, name: str, **over) -> Path:
    """``path`` renamed, its config's MAGNO options ``over`` changed."""
    cfg = copy.deepcopy(path.cfg)
    for k, v in over.items():
        setattr(cfg.model.args.magno, k, v)
    return path._replace(name=f"{path.name}, {name}", cfg=cfg)


def _step_grads(path: Path, b: int, dtype):
    """One training step of ``path`` on the card at batch ``b`` (the
    model's seeded weights, the path's seeded batch): (loss, every
    parameter's gradient, the launches)."""
    import torch

    from gaot_torch.ops import cuda as kernels
    from gaot_torch.train.schedules import make_optimizer
    from gaot_torch.train.static_trainer import train_step

    pndata, target = _batch(2, path)
    model = _model(path, dtype, "cuda")
    graphs, coord, nmask = _graph_args(path, b, "cuda")
    opt, sched = make_optimizer(path.cfg.optimizer, model.parameters(),
                                path.steps_per_epoch)
    grads = {}
    opt.register_step_pre_hook(lambda *_: grads.update(
        {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}))
    t = lambda a: torch.from_numpy(a[:b]).cuda()
    torch.cuda.synchronize()
    kernels.reset_launches()
    loss = train_step(model, opt, sched, 0, graphs, coord, t(pndata), t(target),
                      torch.ones(b, dtype=torch.bool, device="cuda"), nmask)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    del model, graphs, opt
    torch.cuda.empty_cache()
    return float(loss), grads, launches


def _without_transpose(on: Path, off: Path, table_on: dict):
    """The step without transpose graphs against the step with them, on
    the card with the same weights and batch: the same loss bits (the
    forward is the same); every gradient within 1e-4 of its tensor's
    largest entry in fp32 at the check batch, and in bf16 at the path's
    batch within phase 4's bf16 bounds (relative L2 5e-2, each tensor 1e-1);
    the launches those of the step with them less its d_f reduces. Returns
    the d_f launches that went."""
    import torch

    for b, dtype, name in ((on.check_batch, None, "fp32"),
                           (on.batch, torch.bfloat16, "bf16")):
        loss_on, g_on, l_on = _step_grads(on, b, dtype)
        loss_off, g_off, l_off = _step_grads(off, b, dtype)
        per = {n: float((g_off[n] - g_on[n]).abs().max()
                        / g_on[n].abs().max().clamp(min=1e-30)) for n in g_on}
        cat = lambda g: torch.cat([g[n].reshape(-1) for n in sorted(g)])
        rel = float((cat(g_off) - cat(g_on)).norm() / cat(g_on).norm())
        worst = max(per, key=per.get)
        ok = (loss_on == loss_off and set(g_on) == set(g_off)
              and all(torch.isfinite(g).all() for g in g_off.values())
              and (per[worst] <= 1e-4 if dtype is None
                   else rel <= 5e-2 and per[worst] <= 1e-1))
        log(f"{off.name}: step batch {b} {name} against the step with transpose "
            f"graphs: loss {loss_off:.6f} vs {loss_on:.6f}; gradients rel_l2={rel:.3e} "
            f"worst_per_tensor={per[worst]:.3e} ({worst}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{off.name}: the step without transpose graphs disagrees with the "
                 f"step with them ({name})")
    gone = {k: l_on[k] - l_off[k] for k in l_on if l_on[k] != l_off[k]}
    want = {"multiply_reduce_k": table_on["multiply_reduce_k"]
            - off.train_launches["multiply_reduce_k"]}
    log(f"{off.name}: launches a step {l_off}; with transpose graphs {l_on}; gone {gone}")
    if gone != want or l_on != {**dict.fromkeys(l_on, 0), **table_on}:
        fail(f"{off.name}: launches {l_off} against {l_on}: expected only the d_f "
             f"reduces {want} to go")
    return gone["multiply_reduce_k"]


def _cache_runs(card: str):
    """The elasticity recipe with transform_type nonlinear, node_embedding
    and dataset.graph_cache_dir, run twice through ``gaot_torch.cli.main``
    in this process (the vx trainer phase's data at CACHE_SIZES,
    CACHE_EPOCHS epochs, its fp32): the first builds and writes the cache,
    the second reads it from disk; both give the same losses bit for bit.
    Returns the set-up seconds of both (to the start of the fit)."""
    import tempfile

    import numpy as np

    from gaot_torch.train.base_trainer import BaseTrainer

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from torch_synthetic import make_elasticity_dataset

    with tempfile.TemporaryDirectory(prefix="gaot_cache_") as folder:
        with open(ELASTICITY) as f:
            raw = json.load(f)
        n = sum(CACHE_SIZES.values())
        make_elasticity_dataset(os.path.join(folder, f"{raw['dataset']['name']}.npz"),
                                num_samples=n, seed=0)
        raw["model"]["args"]["magno"].update(transform_type="nonlinear",
                                             node_embedding=True)
        raw["dataset"].update(CACHE_SIZES, base_path=folder,
                              graph_cache_dir=os.path.join(folder, "cache"))
        raw["setup"]["epoch_scan"] = "never"
        raw["optimizer"]["args"]["epoch"] = CACHE_EPOCHS
        raw["optimizer"]["args"]["eval_every_eps"] = 1
        runs = []
        for run in ("first", "second"):
            cfg = copy.deepcopy(raw)
            cfg["path"] = {k: os.path.join(folder, run, os.path.basename(v))
                           for k, v in raw["path"].items()}
            cfg["path"]["result_path"] = os.path.join(folder, run, "result.png")
            cfg_path = os.path.join(folder, f"{run}.json")
            with open(cfg_path, "w") as f:
                json.dump(cfg, f, indent=1)
            fits, fit = [], BaseTrainer.fit

            def timed_fit(self, *a, **kw):
                fits.append(time.perf_counter())
                return fit(self, *a, **kw)

            BaseTrainer.fit = timed_fit
            try:
                t0 = time.perf_counter()
                _, routes, secs, _, out = _cli_in_process(cfg_path, f"cache {run}")
            finally:
                BaseTrainer.fit = fit
            setup_s = fits[0] - t0
            rec, row = _run_record(cfg)
            hit = "Graph cache hit" in out
            log(f"cache run {run} ({card}): {secs:.3f} s in all, set-up {setup_s:.3f} s, "
                f"cache hit {hit}; losses {' '.join(f'{v:.6f}' for v in rec['losses'])}; "
                f"relative error {float(row['relative error (direct)']):.5f}; {routes}")
            if hit != (run == "second"):
                fail(f"cache run {run}: cache hit {hit}")
            if routes.get("agno") != "vx-plain" or routes.get("attn") != "cuda":
                fail(f"cache run {run}: routes {routes}, expected agno=vx-plain and "
                     f"attn=cuda")
            if not (np.isfinite(rec["losses"]).all()
                    and math.isfinite(float(row["relative error (direct)"]))):
                fail(f"cache run {run}: non-finite loss or metric")
            runs.append((rec, setup_s))
        (rec1, s1), (rec2, s2) = runs
        for k in ("losses", "val_losses"):
            if not np.array_equal(rec1[k], rec2[k]):
                fail(f"cache runs: the {k} differ ({rec1[k]} vs {rec2[k]})")
        if len(os.listdir(os.path.join(folder, "cache"))) != 1:
            fail("cache runs: expected one cache file")
    return s1, s2


def phase_options(card: str, main_path: Path, vx_path: Path, step_ms: float,
                  step_ms_vx: float):
    """Phase 8 (module docstring)."""
    t_phase = time.perf_counter()
    layers = vx_path.cfg.model.args.transformer.num_layers
    scales = len(vx_path.cfg.model.args.magno.scales)
    dense = dict(zip(("coords", "lat", "enc", "dec", "vx"), _host_graphs_vx(
        vx_path.cfg, "vx flagship, dense (the nonlinear transforms' layout)",
        bucketing=False)))
    results = {}
    for name, over in VX_OPTIONS.items():
        # node_embedding's fp32 gradient check reads 9.4e-4 of the largest
        # entry in the decoder embedding's first layer on the H100 (bound
        # 1e-3): the check again with the embedding's features shared holds
        # the rest under phase 4's 1e-4.
        path = _with_magno(vx_path, name, **over)._replace(
            check_dtypes=("fp32",), embed_check=name == "node_embedding")
        if name.startswith("nonlinear"):
            # The JAX trainers keep these graphs dense and the models drop
            # their transpose graphs: the per-edge body runs plain, no
            # multiply-reduce in the AGNO. PyTorch's row gather reads its
            # feature rows (``gather_rows``) and, in the backward, their
            # gradient rows in index order: two a side and scale.
            path = path._replace(**dense, row_gathers=4 * scales)
            fwd, train = _tables(_graph_args(path, VX_BATCH, "cpu")[0], layers, ffn=True)
            fwd = {k: v for k, v in fwd.items() if not k.startswith("multiply_reduce")}
            train = {k: v for k, v in train.items() if not k.startswith("multiply_reduce")}
            log(f"{path.name}: no multiply-reduce launch in the AGNO (the per-edge "
                f"body, as the reference runs it); a forward {fwd}, a step {train}")
        else:
            fwd, train = vx_path.forward_launches, vx_path.train_launches
            log(f"{path.name}: the linear vx tables, a forward {fwd}, a step {train}")
        path = path._replace(forward_launches=fwd, train_launches=train)
        phase_forward(path._replace(batch=0))
        _, results[name] = phase_train(path)

    # Without transpose graphs: the fx main path's step and the vx flagship's.
    off_ms = {}
    for on, step_on in ((main_path, step_ms), (vx_path, step_ms_vx)):
        off = _with_magno(on, "no transpose graphs", use_transpose_backward=False)
        off = off._replace(check_dtypes=("fp32",), embed_check=False)
        if on.vx is not None:
            off = off._replace(**dict(zip(("coords", "lat", "enc", "dec", "vx"),
                                          _host_graphs_vx(off.cfg, off.name,
                                                          with_transpose=False))))
        b = on.batch if on.vx is not None else 1
        fwd, train = _tables(_graph_args(off, b, "cpu")[0], layers, ffn=True)
        off = off._replace(forward_launches=fwd, train_launches=train)
        gone = _without_transpose(on, off, on.train_launches)
        _, ms = phase_train(off)
        off_ms[on.name] = ms
        log(f"{off.name} ({card}): step median {ms:.3f} ms against {step_on:.3f} ms "
            f"with transpose graphs (phase 4): the scatter d_f in place of {gone} d_f "
            f"reduces costs {ms - step_on:+.3f} ms a step")

    setup_first, setup_hit = _cache_runs(card)
    log(f"phase 8 ({card}): vx flagship batch {VX_BATCH} bf16 step medians "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in results.items())
        + f" (linear {step_ms_vx:.3f} ms, phase 4); without transpose graphs "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in off_ms.items())
        + f"; elasticity set-up {setup_first:.3f} s building the cache, "
        f"{setup_hit:.3f} s on its hit")
    log(f"options phase: {time.perf_counter() - t_phase:.1f} s")


# Phase 10: multi-GPU training (gaot_torch/parallel/). The fx recipe at
# phase 5's sizes, epochs and cadence through torchrun at one rank on NCCL
# (10.1, in phase 12's torchrun process); then two ranks on the
# one card over gloo (NCCL refuses two ranks on one device), each a
# subprocess of this script (``--rank``) that joins the group itself, at
# dp 2, at mp 2 (tensor parallelism) and with spatial_parallel at mp 2: an
# fp32 check at a global batch of 8 against one process on the card, then a
# bf16 step at a global batch of 64 (launch table; at dp also per-rank ms
# and the device time of NCCL's kernels and every copy), the three modes in
# one start of the ranks. With two cards or more the same runs go over NCCL,
# one rank a card. Then the checkpoint tools' round trip.
MESH_RUNS = {   # mode: setup of the two ranks
    "dp": {"data_parallel": 2, "model_parallel": 1},
    "tp": {"data_parallel": 1, "model_parallel": 2},
    "sp": {"data_parallel": 1, "model_parallel": 2, "spatial_parallel": True},
}
MESH_SIZES = {"train_size": 64, "val_size": 8, "test_size": 8}
MESH_CHECK_BATCH, MESH_CHECK_STEPS, MESH_TIME_STEPS = 8, 3, 4
# The modes whose bf16 step is timed and profiled: over gloo on one card
# tp's and sp's times are those of their all-reduces' round trips through
# the host (seconds a step), not of the card; their launches are counted.
MESH_TIMED = ("dp",)
RANK_TIMEOUT = 420
# 10.2's vx runs, spatial_parallel at mp 2 on two ranks, in one start of
# the ranks (mode "vx"): sp-vx, the vx flagship's model (CONFIG_VX) on
# synthetic meshes of VX_NODES nodes (tests/synthetic.py::
# make_static_vx_dataset's layout, seed 0) through the trainer, its graph
# cache shared by each rank's two trainers (fp32 at a global batch of 4,
# then bf16 at VX_BATCH); naca-sp, naca0012.json (edge drop to 32) one fp32
# step at a global batch of 4; elasticity-sp, elasticity.json fitted 2
# epochs in fp32. Each against one process on the card.
SP2 = {"data_parallel": 1, "model_parallel": 2, "spatial_parallel": True}
VX_MESH_SIZES = {"train_size": 16, "val_size": 4, "test_size": 4}
VX_MESH_CHECK_BATCH = 4
NACA_MESH_SIZES = {"train_size": 4, "val_size": 2, "test_size": 2}
ELASTICITY_MESH_SIZES = {"train_size": 32, "val_size": 8, "test_size": 8}
ELASTICITY_MESH_EPOCHS, ELASTICITY_MESH_BATCH = 2, 8


def _mesh_config(folder: str, name: str, batch: int, bf16: bool, **setup) -> dict:
    """The example config with phase 10's split sizes, ``batch`` and the
    compute dtype, outputs under ``folder``/``name``."""
    with open(CONFIG) as f:
        raw = json.load(f)
    raw["setup"].update({"epoch_scan": "never", **setup},
                        compute_dtype="bfloat16" if bf16 else "float32")
    raw["dataset"].update(MESH_SIZES, base_path=folder, batch_size=batch)
    out = lambda f: os.path.join(folder, name, f)
    raw["path"] = {"ckpt_path": out("ckpt"), "loss_path": out("loss.png"),
                   "result_path": out("result.png"), "database_path": out("db.csv")}
    return raw


def _vx_mesh_config(folder: str, run: str, name: str, batch: int, bf16: bool = False,
                    **setup) -> dict:
    """The config of one of 10.2's vx runs (``run``: "sp-vx", "naca-sp" or
    "elasticity-sp"; comment above), its data under ``folder``, its
    outputs under ``folder``/``name``."""
    out = lambda f: os.path.join(folder, name, f)
    paths = {"ckpt_path": out("ckpt"), "loss_path": out("loss.png"),
             "result_path": out("result.png"), "database_path": out("db.csv")}
    if run == "sp-vx":
        raw = copy.deepcopy(CONFIG_VX)
        raw["setup"] = {"seed": 0, "trainer_name": "static", "train": True}
        raw["dataset"] = {"name": "vxmesh", "metaname": "compressible_flow/naca0012",
                          "base_path": folder, "shuffle": True,
                          "graph_cache_dir": os.path.join(folder, "cache"),
                          **VX_MESH_SIZES}
    else:
        with open(NACA if run == "naca-sp" else ELASTICITY) as f:
            raw = json.load(f)
        raw["dataset"].update(NACA_MESH_SIZES if run == "naca-sp"
                              else ELASTICITY_MESH_SIZES, base_path=folder)
        raw["optimizer"]["args"].update(epoch=ELASTICITY_MESH_EPOCHS, eval_every_eps=1)
    raw["setup"].update({"epoch_scan": "never", **setup},
                        compute_dtype="bfloat16" if bf16 else "float32")
    raw["dataset"]["batch_size"] = batch
    raw["path"] = paths
    return raw


def _vx_mesh_runs(rank: int, folder: str, setup: dict) -> dict:
    """10.2's three vx runs in this process (``setup``: the ranks', or one
    process's): sp-vx's fp32 steps and (ranks only) its bf16 step, with the
    reduces and the SwiGLU at rank 0's shapes checked and timed in rank 0;
    naca-sp's step, elasticity-sp's fit."""
    import contextlib
    import io

    import numpy as np
    import torch

    from gaot_torch.data.graph_builder import VxCounts
    from gaot_torch.ops import cuda as kernels
    from gaot_torch.train import StaticTrainer

    ranks = setup.get("spatial_parallel", False)
    tag = "rank" if ranks else "one"
    out = {}
    with _quiet():
        trainer = StaticTrainer(_vx_mesh_config(folder, "sp-vx", f"vx_{tag}_check",
                                                VX_MESH_CHECK_BATCH, **setup))
    w0 = {k: v.float().cpu().clone() for k, v in trainer.full_state().items()}
    out["sp-vx"] = (*_mesh_steps(trainer, MESH_CHECK_STEPS), w0)
    del trainer
    torch.cuda.empty_cache()

    if ranks:
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            trainer = StaticTrainer(_vx_mesh_config(folder, "sp-vx", "vx_rank_time",
                                                    VX_BATCH, True, **setup))
        out["cache_hit"] = "Graph cache hit" in said.getvalue()
        placed = trainer.place_batch(next(iter(trainer.train_loader)))
        trainer.train_step(placed)
        torch.cuda.synchronize()
        kernels.reset_launches()
        trainer.train_step(placed)
        torch.cuda.synchronize()
        out["launches"] = kernels.launch_counts()
        graphs = trainer._batch_graphs(placed)
        out["table"] = _tables(graphs, trainer.model_config.args.transformer.num_layers,
                               ffn=True)[1]
        sp = trainer.spatial
        out["counts"] = tuple(VxCounts(sp.num_nodes, trainer.latent.shape[0],
                                       sp.latent[1] - sp.latent[0],
                                       sp.nodes[1] - sp.nodes[0]))
        out["buckets"] = {side: [tuple(b.indices.shape) for b in getattr(graphs, side)[0]
                                 .buckets] for side in ("encoder", "decoder")}
        # Not timed (MESH_TIMED): sp's step over gloo times the host.
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        # The kernels at rank 0's shapes (its cut graphs of this batch) for
        # the @sp-vx entries, while rank 1 waits: the process that ran the
        # ranks keeps no profiler work for after them.
        torch.distributed.barrier()
        if rank == 0:
            gen = torch.Generator(device="cuda").manual_seed(1)
            rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
            counts = VxCounts(*out["counts"])
            what = "vx @sp-vx rank 0"
            cases = _flat_reduce_cases(graphs, VX_BATCH, counts.nodes, counts.latent,
                                       what, out["table"]["multiply_reduce_k"],
                                       rows=(counts.enc_rows, counts.dec_rows))
            out["rows"] = {**check_multiply_reduce(
                rnd, 1, trainer.model_config.args.magno.lifting_channels, cases, what),
                **check_ffn(rnd, VX_BATCH * SEQ // 2)}
        torch.distributed.barrier()
        del trainer, placed, graphs
        torch.cuda.empty_cache()

    with _quiet():
        trainer = StaticTrainer(_vx_mesh_config(folder, "naca-sp", f"naca_{tag}",
                                                VX_MESH_CHECK_BATCH, **setup))
    losses, grads, _ = _mesh_steps(trainer, 1)
    out["naca-sp"] = (losses, grads)
    del trainer
    torch.cuda.empty_cache()

    raw = _vx_mesh_config(folder, "elasticity-sp", f"elasticity_{tag}",
                          ELASTICITY_MESH_BATCH, **setup)
    with _quiet():
        trainer = StaticTrainer(raw)
        trainer.fit(verbose=False)
    if rank == 0:
        rec = np.load(raw["path"]["loss_path"][:-4] + ".npz")
        out["elasticity-sp"] = (rec["losses"].tolist(), rec["val_losses"].tolist(),
                                trainer.datarow["relative error (direct)"])
    del trainer
    torch.cuda.empty_cache()
    return out


def _mesh_steps(trainer, steps: int):
    """``steps`` training steps on the loader's first batches: (the losses,
    the first step's gradients after DDP, joined over the model axis, the
    full weights after the steps)."""
    from gaot_torch.parallel.mesh import full_state_dict

    grads = []
    step = trainer.optimizer.step

    def capture(*a, **k):
        grads.append({n: g.float().cpu() for n, g in full_state_dict(
            {n: p.grad for n, p in trainer.model.named_parameters()},
            trainer.tp_specs, trainer.mesh).items()})
        return step(*a, **k)

    trainer.optimizer.step = capture
    it = iter(trainer.train_loader)
    losses = [float(trainer.train_step(next(it))) for _ in range(steps)]
    trainer.optimizer.step = step
    return losses, grads[0], {k: v.float().cpu() for k, v in trainer.full_state().items()}


def _copy_events(events):
    """The profile's NCCL kernels and every copy: over gloo the
    all-reduces' round trips through the host are copies, but so are the
    step's other copies (its sample mask, DDP's bucket copies), which this
    does not tell apart."""
    return [e for e in events
            if re.search(r"nccl|allreduce|all_reduce|memcpy", e.key, re.I)]


def _rank_child(argv) -> int:
    """``chip_smoke.py --rank MODES RANK WORLD STORE FOLDER BACKEND``: one
    rank of a phase 10 run (module comment above): the MODES (a comma list:
    the fx modes of MESH_RUNS, or "vx", the vx runs) in turn, each writing
    its results to FOLDER/MODE.rankR.pt."""
    modes, rank, world, store, folder, backend = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, HERE)
    import torch
    import torch.distributed as dist

    from gaot_torch.core.config import SetUpConfig
    from gaot_torch.parallel import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(SetUpConfig(distributed=True, device="cuda", process_id=rank,
                                 num_processes=world,
                                 coordinator_address=f"file://{store}"),
                     backend=backend)
    for mode in modes.split(","):
        out = (_vx_mesh_runs(rank, folder, dict(SP2, distributed=True)) if mode == "vx"
               else _mesh_mode(mode, rank, folder))
        torch.save(dict(out, device=torch.cuda.current_device()),
                   os.path.join(folder, f"{mode}.rank{rank}.pt"))
        torch.cuda.empty_cache()
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _mesh_mode(mode: str, rank: int, folder: str) -> dict:
    """One fx mode of 10.2 / 10.3 in this rank: the fp32 check's steps, then
    the bf16 step's launches (timed and profiled at MESH_TIMED)."""
    import torch

    from gaot_torch.ops import cuda as kernels
    from gaot_torch.ops.cuda import fused_ffn
    from gaot_torch.train import StaticTrainer

    out = {}
    torch.cuda.reset_peak_memory_stats()
    setup = dict(MESH_RUNS[mode], distributed=True)
    with _quiet():
        trainer = StaticTrainer(_mesh_config(folder, f"{mode}_check", MESH_CHECK_BATCH,
                                             False, **setup))
    losses, grads, weights = _mesh_steps(trainer, MESH_CHECK_STEPS)
    if rank == 0:
        out.update(losses=losses, grads=grads, weights=weights)
    del trainer, grads, weights
    torch.cuda.empty_cache()

    with _quiet():
        trainer = StaticTrainer(_mesh_config(folder, f"{mode}_time", BATCH, True, **setup))
    placed = trainer.place_batch(next(iter(trainer.train_loader)))
    trainer.train_step(placed)
    torch.cuda.synchronize()
    kernels.reset_launches()
    trainer.train_step(placed)
    torch.cuda.synchronize()
    out["launches"] = kernels.launch_counts()
    layers = trainer.model_config.args.transformer.num_layers
    ffn = trainer.model.processor.encoder_layers[0].ffn
    tokens = placed["c"].shape[0] * (SEQ // (trainer.mesh.mp if trainer.spatial else 1))
    out["ffn_width"] = ffn.ffn_hidden_size
    out["table"] = _tables(trainer.graphs, layers, fused_ffn.supported(
        tokens, ffn.w1.weight.shape[1], ffn.ffn_hidden_size, torch.bfloat16) > 0)[1]
    out["local_batch"] = placed["c"].shape[0]
    if mode in MESH_TIMED:
        out["ms"] = time_ms(lambda: trainer.train_step(placed), iters=MESH_TIME_STEPS,
                            warmup=1)
        events = _profile_once(lambda: trainer.train_step(placed))
        copies = _copy_events(events)
        out["busy_ms"] = sum(e.self_device_time_total for e in events) / 1e3
        out["copy_ms"] = sum(e.self_device_time_total for e in copies) / 1e3
        out["copy_events"] = [(e.key[:60], e.count, e.self_device_time_total / 1e3)
                              for e in copies]
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def _quiet():
    """The trainer's prints kept out of the log (the results are logged)."""
    import contextlib
    import io

    return contextlib.redirect_stdout(io.StringIO())


def _profile_once(fn):
    """The device kernels of one ``fn()`` under torch.profiler (one trace,
    no retake: the ranks must run the same steps)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
            and e.self_device_time_total > 0]


def _run_ranks(cmds, what: str, envs, folder: str, echo: bool = False,
               timeout: float = RANK_TIMEOUT):
    """Start every command at once (output to files under ``folder``) and
    wait for all, each within ``timeout`` seconds; a failure or a timeout
    stops the others and fails the phase. Logs the last lines of each
    output (all of it with ``echo``)."""
    logs = [os.path.join(folder, f"{what.replace(' ', '_')}.{i}.log")
            for i in range(len(cmds))]
    files = [open(path, "w") for path in logs]
    procs = [subprocess.Popen(c, cwd=HERE, env=e, stdout=f, stderr=subprocess.STDOUT)
             for c, e, f in zip(cmds, envs, files)]
    deadline = time.monotonic() + timeout
    bad = []
    try:
        for i, p in enumerate(procs):
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                bad.append(f"process {i} timed out after {timeout} s")
                break
            if p.returncode != 0:
                bad.append(f"process {i} exited {p.returncode}")
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    for i, path in enumerate(logs):
        with open(path) as f:
            lines = f.read().splitlines()
        for line in lines if echo else lines[-(40 if bad else 8):]:
            log(f"  [{what} {i}] {line}")
    if bad:
        fail(f"{what}: {'; '.join(bad)}")


def _nccl_one_rank(card: str, run: dict, rates: dict):
    """10.1's checks, of the fx recipe's fit through gaot_torch.cli.main in
    phase 12's torchrun process (``run``: its config, launches, seconds and
    output): launches equal to phase 5's tables times its steps, a falling
    loss, one CSV row; its samples/s beside phase 5's run B's (``rates``)."""
    raw = run["raw"]
    want, steps, evals = _trainer_launches(raw, bf16=True)
    _expect_launches("phase 10.1 (torchrun, NCCL, one rank)", run["launches"], want)
    rec, row = _run_record(raw)
    sps = float(row["samples_per_sec"])
    first, steady = _steady_rate(run["out"], TRAINER_SIZES["train_size"])
    log(f"phase 10.1 ({card}): in phase 12's torchrun process (--nproc_per_node=1, "
        f"NCCL), {steps} steps and {evals} evaluation batches in {run['secs']:.1f} s; "
        f"launches {run['launches']} (phase 5's tables x its steps); train losses "
        f"{' '.join(f'{v:.5f}' for v in rec['losses'])}; samples_per_sec {sps:.1f}, "
        f"{first:.3f} s to the first evaluation, {steady:.1f} samples/s after it "
        f"(phase 5's run B, the same epochs and cadence in a subprocess of the CLI: "
        f"{rates['sps_b']:.1f}, {rates['first_b']:.3f} s, {rates['steady_b']:.1f})")
    if not rec["losses"][-1] < rec["losses"][0]:
        fail(f"phase 10.1: the train loss did not fall ({rec['losses']})")
    rates["steady_nccl1"] = steady


def _mesh_reference(folder: str):
    """One process on the card: the fp32 check's losses, first gradients and
    weights after the steps."""
    import torch

    from gaot_torch.train import StaticTrainer

    with _quiet():
        trainer = StaticTrainer(_mesh_config(folder, "one_check", MESH_CHECK_BATCH,
                                             False))
    w0 = {k: v.float().cpu() for k, v in trainer.full_state().items()}
    ref = (*_mesh_steps(trainer, MESH_CHECK_STEPS), w0)
    graphs = (trainer.coord.cpu().numpy(), trainer.latent.cpu().numpy())
    del trainer
    torch.cuda.empty_cache()
    return ref, graphs


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _against_one(what: str, batch: int, got, ref, sp: bool) -> None:
    """Ranks' fp32 steps (losses, first gradients, weights after the steps)
    against one process's (``ref``, with the weights before the steps): the
    first loss within 1e-6 relative, every gradient and weight within 1e-4
    of its tensor's largest entry (no weights: gradients only)."""
    losses, grads, weights, w0 = ref
    if abs(got[0][0] - losses[0]) > 1e-6 * abs(losses[0]):
        fail(f"{what}: fp32 loss {got[0][0]!r}, one process {losses[0]!r}")
    g_err = max(_rel(got[1][k], v) for k, v in grads.items())
    w_over, note = [], ""
    if weights is not None:
        w_rel = sorted(((_rel(got[2][k], v), k) for k, v in weights.items()),
                       reverse=True)
        # AdamW divides each gradient entry by its own running scale, so an
        # entry whose gradient sits at the rounding level takes a full-size
        # step of either sign: under sp (sums in another order: the
        # embedding's statistics over both ranks' queries) the weights are
        # held within 1e-4 of their largest entry plus 1e-2 of their largest
        # update.
        upd = {k: float((v - w0[k]).abs().max()) for k, v in weights.items()}
        w_over = [k for k, v in weights.items()
                  if float((got[2][k] - v).abs().max())
                  > 1e-4 * float(v.abs().max()) + (1e-2 * upd[k] if sp else 0.0)]
        log(f"  {what}: the weights farthest from one process's: " + "; ".join(
            f"{k} {e:.3e} of its max {float(weights[k].abs().max()):.3e} "
            f"(its largest update {upd[k]:.3e})" for e, k in w_rel[:4]))
        note = (f", weights after {len(losses)} AdamW steps within {w_rel[0][0]:.3e}"
                f" (bound 1e-4{' + 1e-2 of its largest update' if sp else ''})")
    log(f"phase 10 {what}: fp32 global batch {batch}: losses {got[0]} vs one process "
        f"{losses}; gradients within {g_err:.3e} of each tensor's largest entry{note}")
    if g_err > 1e-4 or w_over:
        fail(f"{what}: gradients {g_err:.3e} of the largest entry from one "
             f"process's; weights beyond the bound: {w_over}")


def _mesh_run(card: str, folder: str, ref, backend: str, cards: int):
    """10.2 / 10.3: the fx modes of MESH_RUNS on two ranks, in one start of
    them; the checks against ``ref``. Returns each mode's ranks' results."""
    import torch

    modes = list(MESH_RUNS)
    store = os.path.join(folder, f"store_{backend}")
    cmds = [[sys.executable, os.path.join(HERE, "chip_smoke.py"), "--rank", ",".join(modes),
             str(r), "2", store, folder, backend] for r in range(2)]
    envs = [dict(os.environ, PYTHONPATH=HERE, LOCAL_RANK=str(r if cards > 1 else 0))
            for r in range(2)]
    t0 = time.perf_counter()
    _run_ranks(cmds, f"fx {backend}", envs, folder)
    results = {}
    for mode in modes:
        res = results[mode] = [
            torch.load(os.path.join(folder, f"{mode}.rank{r}.pt"), weights_only=False)
            for r in range(2)]
        where = (f"two ranks on {cards} card{'s' if cards > 1 else ''} (devices "
                 f"{[r['device'] for r in res]}), {backend}")
        got = res[0]
        _against_one(f"{mode} ({where}, {card})", MESH_CHECK_BATCH,
                     (got["losses"], got["grads"], got["weights"]), ref, mode == "sp")
        for r, out in enumerate(res):
            _expect_launches(f"{mode} rank {r} bf16 step", out["launches"], out["table"])
            timed = (f"{out['ms']:.3f} ms (CUDA events, {MESH_TIME_STEPS} steps), device "
                     f"busy {out['busy_ms']:.3f} ms, " if "ms" in out else "")
            copies = (f"; NCCL kernels and all copies in the step (gloo's all-reduce "
                      f"round trips among them) {out['copy_ms']:.3f} ms device "
                      f"{out['copy_events']}" if "ms" in out else "")
            log(f"phase 10 {mode} rank {r} ({where}, {card}): bf16 step at global batch "
                f"{BATCH} (local {out['local_batch']}, SwiGLU width {out['ffn_width']}): "
                f"{timed}peak {out['peak_gib']:.2f} GiB; launches {out['launches']}"
                f"{copies}")
    log(f"phase 10 fx modes {modes} ({backend}, one start of two ranks): "
        f"{time.perf_counter() - t0:.1f} s")
    return results


def _vx_mesh_run(card: str, folder: str, vx_checks: dict):
    """10.2's vx runs (comment above): the data, one process's runs on the
    card, then the two ranks' (over gloo, sharing the card) and the checks
    against them; the reduces and the SwiGLU at rank 0's shapes, measured in
    rank 0. Returns (the @sp-vx kernel rows, rank 0's launches in its bf16
    step)."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from synthetic import make_static_vx_dataset
    from torch_synthetic import make_elasticity_dataset, make_naca_dataset

    t0 = time.perf_counter()
    vx_dir = os.path.join(folder, "vx")
    os.makedirs(vx_dir)
    make_static_vx_dataset(os.path.join(vx_dir, "vxmesh.npz"),
                           num_samples=sum(VX_MESH_SIZES.values()), num_nodes=VX_NODES,
                           seed=0)
    for config, sizes, make in ((NACA, NACA_MESH_SIZES, make_naca_dataset),
                                (ELASTICITY, ELASTICITY_MESH_SIZES,
                                 make_elasticity_dataset)):
        with open(config) as f:
            name = json.load(f)["dataset"]["name"]
        make(os.path.join(vx_dir, f"{name}.npz"), num_samples=sum(sizes.values()), seed=0)
    # One process's runs in this process (they profile nothing), then the
    # two ranks' in processes of their own.
    t1 = time.perf_counter()
    with _quiet():
        one = _vx_mesh_runs(0, vx_dir, {})
    torch.cuda.empty_cache()
    log(f"phase 10 vx, 1 process (this one): {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    _run_ranks([[sys.executable, os.path.join(HERE, "chip_smoke.py"), "--rank", "vx",
                 str(r), "2", os.path.join(vx_dir, "store_vx"), vx_dir, "gloo"]
                for r in range(2)], "vx gloo 2",
               [dict(os.environ, PYTHONPATH=HERE, LOCAL_RANK="0")] * 2, vx_dir)
    log(f"phase 10 vx, 2 processes: {time.perf_counter() - t1:.1f} s")
    res = [torch.load(os.path.join(vx_dir, f"vx.rank{r}.pt"), weights_only=False)
           for r in range(2)]
    where = f"two ranks on 1 card, gloo, {card}"
    _against_one(f"sp-vx ({where})", VX_MESH_CHECK_BATCH, res[0]["sp-vx"][:3],
                 one["sp-vx"], True)
    _against_one(f"naca-sp ({where}; edge drop to 32)", VX_MESH_CHECK_BATCH,
                 (*res[0]["naca-sp"], None), (*one["naca-sp"], None, None), True)
    (losses, vals, metric), (losses1, vals1, metric1) = (res[0]["elasticity-sp"],
                                                         one["elasticity-sp"])
    log(f"phase 10 elasticity-sp ({where}): {ELASTICITY_MESH_EPOCHS} epochs fp32, "
        f"train losses {losses} vs one process {losses1}, validation {vals} vs {vals1}, "
        f"metric {metric!r} vs {metric1!r}")
    if not (np.allclose(losses, losses1, rtol=1e-5, atol=0)
            and np.allclose(vals, vals1, rtol=1e-5, atol=0)
            and abs(metric - metric1) <= 1e-5 * abs(metric1)):
        fail("elasticity-sp: the two ranks' fit differs from one process's beyond 1e-5")
    for r, out in enumerate(res):
        if not out["cache_hit"]:
            fail(f"sp-vx rank {r}: the second trainer missed the rank's graph cache")
        _expect_launches(f"sp-vx rank {r} bf16 step", out["launches"], out["table"])
        log(f"phase 10 sp-vx rank {r} ({where}): bf16 step at global batch {VX_BATCH} "
            f"(a rank's cut graphs: counts {out['counts']}, buckets {out['buckets']}): "
            f"peak {out['peak_gib']:.2f} GiB; launches {out['launches']}")
    rows = {**res[0]["rows"],
            **{k: v for k, v in vx_checks.items() if k in ("fwd_lse", "bwd")}}
    for key, row in res[0]["rows"].items():
        log(f"  {key} (vx @sp-vx rank 0, in the rank): " + " ".join(
            f"{k}={row[k]:.4f}" for k in ("ms", "plain_ms", "library_ms", "bound_ms")
            if isinstance(row.get(k), float)) + f" max_abs_err={row['max_abs_err']:.3e}")
    log(f"phase 10 vx: {time.perf_counter() - t0:.1f} s (the ranks' speeds are not "
        "multi-card speeds: two processes share one card over gloo)")
    return rows, res[0]["launches"]


def _tools_round_trip(cfg_path: str, raw: dict, folder: str):
    """10.4: export 10.1's checkpoint, import it again: the weights bit for
    bit."""
    import torch

    from gaot_torch.tools import export_torch_ckpt, import_torch_ckpt
    from gaot_torch.train.checkpoint import checkpoint_file

    raw = copy.deepcopy(raw)
    raw["setup"]["distributed"] = False
    path = os.path.join(folder, "tools.json")
    with open(path, "w") as f:
        json.dump(raw, f)
    with _quiet():
        exported = export_torch_ckpt.main(path, None, os.path.join(folder, "exported.pt"))
        imported = import_torch_ckpt.main(path, exported, os.path.join(folder, "imported"))
    want = torch.load(checkpoint_file(raw["path"]["ckpt_path"]), map_location="cpu",
                      weights_only=True)["model"]
    got_e = torch.load(exported, weights_only=True)["model"]
    got_i = torch.load(imported, weights_only=True)
    for name, got in (("export", got_e), ("import", got_i["model"])):
        if got.keys() != want.keys() or not all(
                torch.equal(got[k].cpu(), want[k]) for k in want):
            fail(f"phase 10.4: the {name} differs from 10.1's checkpoint")
    if got_i["step"] != 0:
        fail(f"phase 10.4: the import's update count is {got_i['step']}")
    log(f"phase 10.4: 10.1's checkpoint exported ({len(got_e)} tensors) and imported "
        "again, bit for bit, update count 0")


def phase_mesh(card: str, main_checks: dict, vx_checks: dict, nccl1: dict):
    """Phase 10 (module comment above) after 10.1, whose fit (``nccl1``,
    phase 12's) the checkpoint tools read. Returns the kernel rows and
    launches of the @dp, @tp, @sp and @sp-vx entries: {suffix: (rows,
    launches)}."""
    import tempfile

    import torch

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from synthetic import make_static_fx_dataset

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    with tempfile.TemporaryDirectory(prefix="gaot_mesh_") as folder:
        with open(CONFIG) as f:
            name = json.load(f)["dataset"]["name"]
        _tools_round_trip(nccl1["cfg"], nccl1["raw"], folder)

        # The meshes read a split of MESH_SIZES from a folder of their own.
        mesh_dir = os.path.join(folder, "mesh")
        os.makedirs(mesh_dir)
        make_static_fx_dataset(os.path.join(mesh_dir, f"{name}.npz"),
                               num_samples=sum(MESH_SIZES.values()),
                               num_nodes=NUM_NODES, seed=0)
        ref, (coord, lat) = _mesh_reference(mesh_dir)
        torch.cuda.empty_cache()
        results = _mesh_run(card, mesh_dir, ref, "gloo", 1)
        if cards >= 2:
            _mesh_run(card, mesh_dir, ref, "nccl", 2)
        else:
            log(f"phase 10.3: {cards} card on this machine: the two-card NCCL runs "
                "did not run (a limit of the machine; the two-rank runs above ran)")

        # The kernels at the ranks' shapes, for the kernels line, in a
        # process of its own: the profiler of this process, which has run
        # every phase so far, saw no device time after the ranks in earlier
        # runs of this script on the H100 (three empty traces in a row).
        inputs = os.path.join(folder, "rows_in.pt")
        torch.save({"coord": coord, "lat": lat, "ffn_width": results["tp"][0]["ffn_width"],
                    "tables": {m: results[m][0]["table"] for m in ("dp", "sp")}}, inputs)
        _run_ranks([[sys.executable, os.path.join(HERE, "chip_smoke.py"), "--mesh-rows",
                     inputs]], "mesh rows", [dict(os.environ, PYTHONPATH=HERE)], folder,
                   echo=True)
        rows = torch.load(inputs + ".rows", weights_only=False)
    entries = {"@dp": (rows["dp"], results["dp"][0]["launches"]),
               "@tp": ({**{k: v for k, v in main_checks.items()
                           if k.startswith("multiply")}, **rows["tp"]},
                       results["tp"][0]["launches"]),
               "@sp": ({**rows["sp"], **{k: v for k, v in main_checks.items()
                                         if k in ("fwd_lse", "bwd")}},
                       results["sp"][0]["launches"])}
    # The vx runs; their kernels are measured in rank 0 for the same reason.
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="gaot_mesh_vx_") as folder:
        entries["@sp-vx"] = _vx_mesh_run(card, folder, vx_checks)
    log(f"multi-GPU phase: {time.perf_counter() - t_phase:.1f} s")
    return entries


def _mesh_rows(argv) -> int:
    """``chip_smoke.py --mesh-rows IN``: phase 10's fx kernel rows at the
    ranks' shapes (@dp: a rank's half batch; @tp: half the heads and the
    SwiGLU width; @sp: rank 0's cut graphs and half the tokens), from the
    phase's inputs IN, written to IN.rows."""
    (inputs,) = argv
    sys.path.insert(0, HERE)
    import torch

    from gaot_torch.core.config import load_experiment_config
    from gaot_torch.data.graph_builder import GraphBuilder
    from gaot_torch.parallel.spatial import cut_rows, spatial_shard

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    got = torch.load(inputs, weights_only=False)
    coord, lat, tables = got["coord"], got["lat"], got["tables"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    cfg = load_experiment_config(CONFIG)
    magno = cfg.model.args.magno
    enc, dec = GraphBuilder.from_magno_config(magno).build_fx_graphs(
        coord, lat, magno.radius, magno.scales)
    rows = {"dp": {**check_multiply_reduce(rnd, BATCH // 2, 64, _reduce_cases(
        _mesh_path(cfg, coord, lat, enc, dec, tables["dp"]), "fx @dp"), "fx @dp"),
        **check_flash(rnd, BATCH // 2, SEQ, 8, 32, with_eval=False),
        **check_ffn(rnd, BATCH // 2 * SEQ)}}
    rows["tp"] = {**check_flash(rnd, BATCH, SEQ, 8 // 2, 32, with_eval=False),
                  **check_ffn(rnd, BATCH * SEQ, f=got["ffn_width"])}
    shard = spatial_shard(cfg.model.latent_tokens_size,
                          cfg.model.args.transformer.patch_size, coord.shape[0], None, 0, 2)
    sp_path = _mesh_path(cfg, coord, lat, [cut_rows(g, *shard.latent) for g in enc],
                         [cut_rows(g, *shard.nodes) for g in dec], tables["sp"])
    rows["sp"] = {**check_multiply_reduce(rnd, BATCH, 64, _reduce_cases(sp_path, "fx @sp"),
                                          "fx @sp rank 0"),
                  **check_ffn(rnd, BATCH * SEQ // 2)}
    torch.save(rows, inputs + ".rows")
    return 0


def _mesh_path(cfg, coord, lat, enc, dec, table) -> Path:
    """A Path of the trainer's graphs (cut to a rank's rows under sp)."""
    return Path("fx mesh", cfg, coord, lat, enc, dec, seq=SEQ, check_batch=0,
                check_dtypes=(), batch=BATCH, steps_per_epoch=1, forward_launches={},
                train_launches=table)


# Phase 11: setup.epoch_scan on the card (train/graphed.py): the training
# step captured once as a CUDA graph and replayed, against the per-step
# path ("eager"), from the same weights, optimizer state and generators.
# The graph must give the per-step path's loss bits on every step and, after
# the last, every weight within GRAPH_WEIGHT_BOUND of its tensor's largest
# entry (both routes run one step body and the same capturable AdamW:
# equal bits are expected; the bound is what must hold). Timings: the step
# body issued from the host ("eager") against its replay (the same
# kernels, so the kernels a step must be equal), each with its median,
# device busy, idle share and peak memory; the per-step path's median
# beside them.
GRAPH_EPOCHS = 2
GRAPH_WEIGHT_BOUND = 1e-6
GRAPH_STEPS = 8               # the steps of the captured steps of 11.3's paths
GRAPH_KERNEL_SLACK = 0.005    # of the kernels a step (above)
GRAPH_SEQ_EPOCHS = 2          # 11.4's ns_gauss fits (phase 5c's sizes)


def _weights(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _hold(what: str, losses_g, losses_e, w_g: dict, w_e: dict) -> float:
    """The graph's losses bit for bit the eager ones, its weights within
    GRAPH_WEIGHT_BOUND of each tensor's largest entry. Returns the worst."""
    import torch

    losses_g, losses_e = losses_g.float().cpu(), losses_e.float().cpu()
    if not torch.isfinite(losses_g).all() or not torch.equal(losses_g, losses_e):
        fail(f"{what}: the graph's losses {losses_g.tolist()} are not the eager "
             f"losses {losses_e.tolist()} bit for bit")
    worst, name = 0.0, None
    for k, want in w_e.items():
        err = float((w_g[k].float() - want.float()).abs().max()
                    / want.float().abs().max().clamp(min=1e-30))
        if err >= worst:
            worst, name = err, k
    log(f"{what}: {len(losses_g)} steps, the same loss bits both ways "
        f"({' '.join(f'{v:.6f}' for v in losses_g.tolist()[:4])} ...); weights after: "
        f"worst {worst:.3e} of the tensor's largest entry ({name}; bound "
        f"{GRAPH_WEIGHT_BOUND:g})")
    if worst > GRAPH_WEIGHT_BOUND:
        fail(f"{what}: weights after the graph's steps differ from eager's by {worst:.3e}")
    return worst


def _both_ways(what: str, eager, graph, batch: int, gathers: int):
    """The step both ways: median ms of 10 synchronised steps, the profile
    of 10 back to back (busy, idle share, kernels a step by name). Each
    hand-written kernel must run as often a step both ways, and the
    kernels a step in all within GRAPH_KERNEL_SLACK of each other: the
    same ops, but PyTorch picks an element-wise kernel's vector width by
    its buffers' alignment, which the graph's memory pool lays out
    otherwise, so a few names differ (they are logged). A trace can lose
    device records (from one to a few dozen in 10 steps, on the H100 with
    either way), never add one: where the counts disagree, both ways are
    traced again, at most twice, and each name keeps its largest count."""
    out, names = {}, {}
    for way, run in (("eager", eager), ("graph", graph)):
        times = host_times(run, 10)
        prof = profile_step(run, f"{what}, {way}", gathers=gathers, top=6)
        out[way] = {"ms": statistics.median(times), "busy_ms": prof["busy_ms"],
                    "idle": 1 - prof["busy_ms"] / prof["wall_ms"],
                    "kernels": prof["kernels"], "wall_ms": prof["wall_ms"]}
        names[way] = prof["by_name"]
        log(f"  {what} {way}: step_ms {fmt_times(times, batch)}")
    for trace in range(3):
        diff = {k: (names["eager"].get(k, 0), names["graph"].get(k, 0))
                for k in set(names["eager"]) | set(names["graph"])
                if names["eager"].get(k, 0) != names["graph"].get(k, 0)}
        ours = {k: v for k, v in diff.items()
                if any(m in k for m in ("mulred", "flash", "ffn_"))}
        e, g = (sum(names[way].values()) for way in ("eager", "graph"))
        if diff:
            log(f"  {what}: kernels a step by name that differ (eager, graph): "
                + "; ".join(f"{k[:70]} {a:.1f} {b:.1f}"
                            for k, (a, b) in sorted(diff.items())[:12]))
        if not ours and abs(e - g) <= GRAPH_KERNEL_SLACK * e:
            break
        if trace == 2:
            fail(f"{what}: {g} kernels a replayed step against {e} eager"
                 + (f"; the hand-written kernels differ: {ours}" if ours else ""))
        log(f"  {what}: {g} kernels a replayed step against {e} eager (trace "
            f"{trace + 1}): both ways traced again, each name keeping its largest count")
        for way, run in (("eager", eager), ("graph", graph)):
            for ev in device_events(lambda: [run() for _ in range(10)], f"{what}, {way}",
                                    warm=run):
                names[way][ev.key] = max(names[way].get(ev.key, 0), ev.count / 10)
    for way, k in (("eager", e), ("graph", g)):
        out[way].update(kernels=k, by_name=names[way])
    return out


def _per_step_epochs(trainer, mats, after_step=None):
    """The per-step path over the epochs ``mats`` (index matrices): each
    row's batch from the loader, ``train_step``. Returns the losses."""
    import torch

    loader, losses = trainer.train_loader, []
    for idx, mask in mats:
        for j in range(len(idx)):
            batch = loader.get_batch(idx[j])
            batch["sample_mask"] = mask[j]
            losses.append(trainer.train_step(batch).reshape(1))
            if after_step is not None:
                after_step()
    return torch.cat(losses)


def _trainer_graph(what: str, trainer, card: str, draws=None,
                   phase: str = "11") -> dict:
    """11.2 / 11.3 (and 12a) on a trainer: GRAPH_EPOCHS epochs through the
    per-step path, the weights kept after every step, then, from the same
    state, through the captured epoch path replayed step by step: its loss
    bits and its weights after every step held against eager's; ``draws``
    (11.3 naca0012) a :class:`_Draws` that records each step's draws both
    ways. Then the timings both ways. Returns the results."""
    import torch

    from gaot_torch.ops import cuda as kernels
    from gaot_torch.train.graphed import EpochProgram, Snapshot
    from gaot_torch.train.schedules import lr_table

    loader = trainer.train_loader
    snap = Snapshot(trainer.model, trainer.optimizer, [trainer.generator])
    step0 = trainer.step
    mats = [loader.epoch_index_matrix() for _ in range(GRAPH_EPOCHS)]
    kept = []

    def after_step():
        kept.append(_weights(trainer.model))
        if draws is not None:
            draws.step()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eager = _per_step_epochs(trainer, mats, after_step)
    torch.cuda.synchronize()
    peak_e = torch.cuda.max_memory_allocated()
    snap.restore()
    trainer.step = step0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    program = EpochProgram(trainer, capture=True)
    # Captured before the first epoch's replays, the draws' sink in place
    # (the capture records its writes; the warm-up steps' are cleared
    # before each epoch).
    if draws is not None:
        draws.epoch(program)
    program.load(*mats[0], lr_table(trainer.schedule, trainer.step, len(mats[0][0])))
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    graph, steps, worst = [], iter(kept), 0.0
    for idx, mask in mats:
        if draws is not None:
            draws.epoch(program)
        program.load(idx, mask, lr_table(trainer.schedule, trainer.step, len(idx)))
        for _ in range(len(idx)):
            program.captured.replay()
            want = next(steps)
            for k, v in _weights(trainer.model).items():
                worst = max(worst, float((v.float() - want[k].float()).abs().max()
                                         / want[k].float().abs().max().clamp(min=1e-30)))
        trainer.step += len(idx)
        graph.append(program.losses.clone())
        if draws is not None:
            draws.read()
    torch.cuda.synchronize()
    peak_g = torch.cuda.max_memory_allocated()
    if worst > GRAPH_WEIGHT_BOUND:
        fail(f"phase {phase} {what}: a replayed step's weights differ from eager's by "
             f"{worst:.3e}")
    _hold(f"phase {phase} {what}", torch.cat(graph), eager, _weights(trainer.model),
          kept[-1])
    capture_s, warmup = program.captured.capture_s, program.captured.warmup
    log(f"  {what}: every weight after every replayed step within {worst:.3e} of "
        f"eager's; capture {capture_s:.3f} s ({warmup} warm-up steps undone, then the "
        f"capture); launches through the wrappers in the warm-up steps and the "
        f"capture {launches} (each replay launches the captured step's); peak memory "
        f"eager {peak_e / 2**30:.3f} GiB, graph {peak_g / 2**30:.3f} GiB")
    if draws is not None:
        draws.hold()
    # Timings: the body issued step by step against its replay, and the
    # per-step path on one placed batch.
    plain = EpochProgram(trainer, capture=False)
    idx, mask = mats[0]
    trainer.train_epoch(plain, mats[0])
    b = loader.batch_size
    # Row gathers a step: the batch's selects (one a buffer) and the three
    # tables' rows.
    res = _both_ways(f"{what} step", plain._body, program.captured.replay, b,
                     gathers=len(program.bufs) + 3)
    batch = trainer.place_batch(dict(loader.get_batch(idx[0]), sample_mask=mask[0]))
    per_step = statistics.median(host_times(lambda: trainer.train_step(batch), 10))
    res.update(capture_s=capture_s, warmup=warmup, peak_e=peak_e, peak_g=peak_g,
               worst=worst, launches=launches, per_step_ms=per_step, replays=len(kept))
    # Freed now (CapturedStep.release): the program and its step refer to
    # each other, and NCCL's communicator is not destroyed while a graph
    # that captured it lives.
    program.captured.release()
    log(f"phase {phase} {what} ({card}): step ms eager {res['eager']['ms']:.3f} / graph "
        f"{res['graph']['ms']:.3f} (the per-step path {per_step:.3f}); busy "
        f"{res['eager']['busy_ms']:.3f} / {res['graph']['busy_ms']:.3f} ms; idle share "
        f"{res['eager']['idle']:.3f} / {res['graph']['idle']:.3f}; kernels a step "
        f"{res['eager']['kernels']:.0f} both ways; capture {capture_s:.3f} s; peak "
        f"{peak_e / 2**30:.3f} / {peak_g / 2**30:.3f} GiB")
    del program, plain
    torch.cuda.empty_cache()
    return res


class _Draws:
    """Each step's edge-drop draws, summed in float64 in draw order (the
    uniforms the masks are thinned by): eager into one sum a step
    (:meth:`step` closes it), the graph into slot t of a [k] buffer by the
    epoch program's step counter (:meth:`epoch` before an epoch,
    :meth:`read` after). Installed around both ways, so the step body
    carries the same sums in each."""

    def __init__(self):
        from gaot_torch.ops import edge_drop

        self.mod, self.orig = edge_drop, edge_drop.uniform
        self.eager, self.graph = [], []
        self.acc = self.program = self.buf = None

    def _record(self, *a, **kw):
        import torch

        u = self.orig(*a, **kw)
        s = u.sum(dtype=torch.float64).view(1)
        if self.program is None:
            self.acc = s if self.acc is None else self.acc + s
        else:
            self.buf.index_add_(0, self.program.t, s)
        return u

    def __enter__(self):
        self.mod.uniform = self._record
        return self

    def __exit__(self, *exc):
        self.mod.uniform = self.orig

    def step(self):
        if self.acc is None:
            fail("naca0012: a training step drew no edge-drop uniforms")
        self.eager.append(self.acc)
        self.acc = None

    def epoch(self, program):
        import torch

        self.program = program
        if self.buf is None:
            self.buf = torch.zeros(program.losses.shape[0], dtype=torch.float64,
                                   device=program.losses.device)
        self.buf.zero_()

    def read(self):
        self.graph.append(self.buf.clone())

    def hold(self):
        import torch

        e, g = torch.cat(self.eager).cpu(), torch.cat(self.graph).cpu()
        moved = bool((e[1:] != e[:-1]).all())
        log(f"  naca0012 edge drop: each step's uniforms summed, eager "
            f"{' '.join(f'{v:.4f}' for v in e.tolist()[:4])} ...; the replays' "
            f"equal bit for bit: {torch.equal(e, g)}; a new draw every step: {moved}")
        if not torch.equal(e, g):
            fail("naca0012: the replayed steps' edge-drop draws differ from eager's")
        if not moved:
            fail("naca0012: the replayed steps repeat one draw")


def _path_graph(path: Path, card: str, dtype=None, profile: bool = True) -> dict:
    """11.3 on a driven path (phase 4's model, graphs and one batch, in
    ``dtype``, bf16 by default): GRAPH_STEPS steps of the step body
    (``step_update`` at the schedule's first rate) issued from the host,
    then, from the same state, the same steps captured and replayed; the
    timings both ways (with ``profile``, :func:`_both_ways`'s profiles;
    else the medians of 10 synchronised steps alone)."""
    import torch

    dtype = dtype or torch.bfloat16

    from gaot_torch.ops import cuda as kernels
    from gaot_torch.train.graphed import CapturedStep, Snapshot
    from gaot_torch.train.schedules import make_optimizer
    from gaot_torch.train.static_trainer import step_update

    model = _model(path, dtype, "cuda")
    graphs, xc, nmask = _graph_args(path, path.batch, "cuda")
    opt, sched = make_optimizer(path.cfg.optimizer, model.parameters(),
                                path.steps_per_epoch)
    pndata, target = _batch(2, path)
    xp, xt = torch.from_numpy(pndata).cuda(), torch.from_numpy(target).cuda()
    smask = torch.ones(path.batch, dtype=torch.bool, device="cuda")
    lr = torch.tensor(sched(0), dtype=torch.float64, device="cuda")
    n = GRAPH_STEPS
    losses = torch.zeros(n, device="cuda")
    t = torch.zeros(1, dtype=torch.int64, device="cuda")

    def body():
        loss = step_update(model, opt, lr, graphs, xc, xp, xt, smask, nmask)
        losses.index_copy_(0, t, loss.float().view(1))
        t.add_(1).remainder_(n)

    snap = Snapshot(model, opt, [])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(n):
        body()
    torch.cuda.synchronize()
    peak_e = torch.cuda.max_memory_allocated()
    eager, w_e = losses.clone(), _weights(model)
    snap.restore()
    t.zero_()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    step = CapturedStep(body, model, opt, reset=t.zero_)
    capture_s = step.capture()
    for _ in range(n):
        step.replay()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    peak_g = torch.cuda.max_memory_allocated()
    what = f"{path.name} (batch {path.batch}, {str(dtype)[6:]})"
    worst = _hold(f"phase 11 {what}", losses.clone(), eager, _weights(model), w_e)
    if not profile:
        res = {way: {"ms": statistics.median(host_times(run, 10))}
               for way, run in (("eager", body), ("graph", step.replay))}
        res.update(capture_s=capture_s, launches=launches, replays=n)
        log(f"phase 11 {what} ({card}): step ms eager {res['eager']['ms']:.3f} / graph "
            f"{res['graph']['ms']:.3f}; capture {capture_s:.3f} s; peak "
            f"{peak_e / 2**30:.3f} / {peak_g / 2**30:.3f} GiB; launches in the graph's run "
            f"{launches}")
        del step, model, opt, graphs
        torch.cuda.empty_cache()
        return res
    res = _both_ways(f"{path.name} step", body, step.replay, path.batch,
                     gathers=path.row_gathers)
    res.update(capture_s=capture_s, peak_e=peak_e, peak_g=peak_g, worst=worst,
               launches=launches, replays=n)
    log(f"phase 11 {what} ({card}): step ms eager {res['eager']['ms']:.3f} / graph "
        f"{res['graph']['ms']:.3f}; busy {res['eager']['busy_ms']:.3f} / "
        f"{res['graph']['busy_ms']:.3f} ms; idle share {res['eager']['idle']:.3f} / "
        f"{res['graph']['idle']:.3f}; kernels a step {res['eager']['kernels']:.0f} both "
        f"ways; capture {capture_s:.3f} s; peak {peak_e / 2**30:.3f} / "
        f"{peak_g / 2**30:.3f} GiB; launches in the graph's run {launches}")
    del step, model, opt, graphs
    torch.cuda.empty_cache()
    return res


def phase_ffn_on(path: Path, card: str) -> dict:
    """The fx main path's fp32 training step at its batch with
    transformer.fused_ffn "on" (the fp32 SwiGLU kernels) beside "auto" (the
    route every example takes: fp32 runs the plain three products, as
    gaot_tpu routes it). One step each from the same weights and batch: the
    loss and every gradient within 1e-3 of each tensor's largest entry (the
    fp32 step bound of PERF.md's agreement metric), 3 forward and 3
    backward SwiGLU launches a step under "on" and none under "auto". Then
    each setting's step eager and captured (:func:`_path_graph` in fp32:
    the graph's loss bits and weights against eager's, its SwiGLU launches
    by the wrappers' counts; no profile, whose traces lose records late in
    this process), the ms on a line of their own. This measures the kernels on a model path;
    it changes no route. Returns the "on" step's launches."""
    import torch

    layers = path.cfg.model.args.transformer.num_layers
    paths, steps = {}, {}
    for mode in ("auto", "on"):
        cfg = copy.deepcopy(path.cfg)
        cfg.model.args.transformer.fused_ffn = mode
        paths[mode] = path._replace(name=f"{path.name}, fused_ffn {mode}", cfg=cfg)
        steps[mode] = _step_grads(paths[mode], path.batch, torch.float32)
    (loss_a, grads_a, launches_a), (loss_o, grads_o, launches_o) = steps["auto"], steps["on"]
    for mode, launches, want in (("auto", launches_a, 0), ("on", launches_o, layers)):
        got = (launches.get("fused_ffn_fwd", 0), launches.get("fused_ffn_bwd", 0))
        if got != (want, want):
            fail(f"phase 11b fused_ffn {mode}: SwiGLU launches {got} a step, not "
                 f"({want}, {want})")
    rel = abs(loss_o - loss_a) / max(abs(loss_a), 1e-30)
    worst, name = 0.0, None
    for k, want in grads_a.items():
        compare_grad(f"phase 11b fp32 step, fused_ffn on vs auto, {k}", grads_o[k], want,
                     1e-3, quiet=True)
        err = float((grads_o[k] - want).abs().max() / want.abs().max().clamp(min=1e-30))
        if err >= worst:
            worst, name = err, k
    log(f"phase 11b fx fp32 step (batch {path.batch}), fused_ffn on vs auto: loss "
        f"{loss_o:.6f} / {loss_a:.6f} (relative {rel:.2e}, bound 1e-3); gradients worst "
        f"{worst:.3e} of the tensor's largest entry ({name}; bound 1e-3); SwiGLU launches "
        f"a step {launches_o.get('fused_ffn_fwd')} + {launches_o.get('fused_ffn_bwd')} on, "
        f"0 + 0 auto")
    if not rel <= 1e-3:
        fail(f"phase 11b: the fp32 step's loss under fused_ffn on differs from auto's by {rel:.2e}")
    ms = {mode: _path_graph(paths[mode], card, torch.float32, profile=False)
          for mode in ("auto", "on")}
    for mode, per_step in (("auto", 0), ("on", layers)):
        # Two warm-up steps and the capture launch the kernels; replays do not.
        got = tuple(ms[mode]["launches"][k] for k in ("fused_ffn_fwd", "fused_ffn_bwd"))
        if got != (3 * per_step,) * 2:
            fail(f"phase 11b fused_ffn {mode}: SwiGLU launches {got} in the graph's run, "
                 f"not {3 * per_step} each")
    log(f"phase 11b fx fp32 step ms (batch {path.batch}; {card}), eager / graph: fused_ffn "
        + ", ".join(f"{mode} {ms[mode]['eager']['ms']:.3f} / {ms[mode]['graph']['ms']:.3f}"
                    for mode in ("on", "auto")))
    return launches_o


# 11.1: the kernels of the fx step, each call captured alone. The wrappers'
# launching functions are wrapped for one eager step to record their calls
# (module, function, kernel name or None for the flash forward, the index
# of the argument the kernel writes into or None where it returns its
# outputs).
_LAUNCHERS = (("multiply_reduce", "_launch_k", "multiply_reduce_k", 6),
              ("multiply_reduce", "_launch_b", "multiply_reduce_b", 3),
              ("flash_attention", "_forward_kernel", None, None),
              ("flash_attention", "flash_attention_bwd", "flash_attention_bwd", None),
              ("fused_ffn", "_forward_kernel", "fused_ffn_fwd", None),
              ("fused_ffn", "fused_ffn_bwd", "fused_ffn_bwd", None))


def _record_launches(run) -> list:
    """The kernel calls ``run()`` makes: (kernel, function, args, kwargs,
    output argument), their tensors kept alive."""
    from gaot_torch.ops import cuda as kernels

    mods = {m.__name__.rsplit(".", 1)[1]: m for m in kernels.WRAPPERS}
    calls, saved = [], []
    for mod, attr, name, out_arg in _LAUNCHERS:
        fn = getattr(mods[mod], attr)
        saved.append((mods[mod], attr, fn))

        def wrapped(*a, _fn=fn, _name=name, _out=out_arg, **kw):
            lse = kw.get("with_lse", a[3] if len(a) > 3 else False)
            calls.append((_name or ("flash_attention_fwd_lse" if lse
                                    else "flash_attention_fwd"), _fn, a, kw, _out))
            return _fn(*a, **kw)

        setattr(mods[mod], attr, wrapped)
    try:
        run()
    finally:
        for m, attr, fn in saved:
            setattr(m, attr, fn)
    return calls


def _captured_call(name: str, fn, a, kw, out_arg):
    """One recorded kernel call run eagerly and captured alone (11.1):
    (the replay's max difference from the eager call, which must be 0, the
    replayed ms, the eager ms)."""
    import torch

    out = a[out_arg] if out_arg is not None else None
    if out is not None:
        before = out.clone()
        row_map = a[5] if name == "multiply_reduce_k" else None
        if row_map is None:
            before.fill_(float("nan"))
        else:
            before.index_fill_(0, row_map.long(), float("nan"))

    def call():
        if out is not None:
            out.copy_(before)
            fn(*a, **kw)
            return [out]
        res = fn(*a, **kw)
        return [r for r in (res if isinstance(res, tuple) else (res,)) if r is not None]

    want = [r.clone() for r in call()]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = call()
    graph.replay()
    torch.cuda.synchronize()
    same = len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    if not same:
        fail(f"phase 11.1: {name} captured alone differs from its eager call "
             f"(max {err:.3e})")
    eager_ms = time_ms(lambda: fn(*a, **kw))
    g20 = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g20):
        for _ in range(20):
            fn(*a, **kw)
    return err, time_ms(g20.replay, iters=5, warmup=1) / 20, eager_ms


def _kernels_captured(trainer, card: str) -> dict:
    """11.1: one eager fx training step at batch 64 with its kernel calls
    recorded; each call then run eagerly and captured alone, its replay's
    outputs against the eager call's bit for bit (an output the kernel
    writes into is set to NaN where it writes, before each), and timed
    both ways: 20 calls back to back eagerly and a graph of 20 calls
    replayed (CUDA events). Returns, per kernel, (its max difference, the
    replayed ms, the eager ms): summed over the step's calls for the
    reduces, a call's mean for the rest, as phase 2's rows count them."""
    import torch

    loader = trainer.train_loader
    idx, mask = loader.epoch_index_matrix()
    batch = trainer.place_batch(dict(loader.get_batch(idx[0]), sample_mask=mask[0]))
    calls = _record_launches(lambda: trainer.train_step(batch))
    torch.cuda.synchronize()
    per = {}
    for name, fn, a, kw, out_arg in calls:
        with torch.no_grad():
            err, graph_ms, eager_ms = _captured_call(name, fn, a, kw, out_arg)
        p = per.setdefault(name, [0.0, [], []])
        p[0] = max(p[0], err)
        p[1].append(graph_ms)
        p[2].append(eager_ms)
    out = {}
    for name, (err, g, e) in per.items():
        agg = sum if name.startswith("multiply_reduce") else statistics.mean
        out[name] = (err, agg(g), agg(e), len(g))
        log(f"phase 11.1 {name}: {len(g)} calls of one fx step (batch {BATCH}, bf16) "
            f"captured alone, each equal to its eager call bit for bit; "
            f"{'summed' if agg is sum else 'a call'}: replayed {agg(g):.4f} ms, eager "
            f"{agg(e):.4f} ms ({card})")
    torch.cuda.empty_cache()
    return out


def _cli_kept(cfg_path: str, what: str):
    """``_cli_in_process`` with the trainer the CLI ran kept. Returns
    (launches, routes, seconds, output, trainer)."""
    from gaot_torch import cli

    ran, run_config = [], cli.run_config

    def keep(path):
        ran.append(run_config(path))
        return ran[-1]

    cli.run_config = keep
    try:
        launches, routes, secs, _, out = _cli_in_process(cfg_path, what)
    finally:
        cli.run_config = run_config
    return launches, routes, secs, out, ran[0]


def _cli_both_ways(make, what: str) -> dict:
    """11.4: one recipe through ``gaot_torch.cli.main`` with
    ``setup.epoch_scan`` "always" and "never" (``make(mode)`` writes its
    config): the route line, the same loss record and test metrics within
    GRAPH_WEIGHT_BOUND relative, samples/s both ways. Returns, per mode,
    (the CSV row, the trainer, seconds to the first evaluation, samples/s
    after it), and the steps after which the graph has repaid its first
    epoch."""
    import numpy as np

    runs = {}
    for mode in ("always", "never"):
        cfg_path, raw = make(mode)
        launches, routes, secs, out, trainer = _cli_kept(cfg_path, f"{what} {mode}")
        rec, row = _run_record(raw)
        first, steady = _steady_rate(out, trainer.train_loader.num_samples)
        want = "graph" if mode == "always" else "per-step"
        if routes.get("steps") != want:
            fail(f"phase 11.4 {what} {mode}: route steps={routes.get('steps')}, "
                 f"expected {want}")
        log(f"phase 11.4 {what}, epoch_scan {mode}: steps={routes['steps']}; train "
            f"losses {' '.join(f'{v:.6f}' for v in rec['losses'])}; samples_per_sec "
            f"{float(row['samples_per_sec']):.1f} ({steady:.1f} after the first "
            f"evaluation, {first:.3f} s to it); training time "
            f"{float(row['training time']):.3f} s; {secs:.1f} s in the CLI; launches "
            f"{launches}")
        runs[mode] = (rec, row, trainer, first, steady)
    (rec_g, row_g, trainer, first_g, steady_g), (rec_e, row_e, _, first_e, steady_e) = (
        runs["always"], runs["never"])
    # The fit's steps at which the graph's first epoch (its warm-up and
    # capture) is repaid by its faster steps after it.
    b = trainer.train_loader.batch_size
    saved = b / steady_e - b / steady_g
    even = (first_g - first_e) / saved if saved > 0 else float("inf")
    log(f"phase 11.4 {what}: the graph's first epoch takes {first_g - first_e:.3f} s "
        f"more to the first evaluation, its later steps {saved * 1e3:.3f} ms less each "
        f"(steady rates): break-even after {even:.0f} steps")
    worst = 0.0
    for key in ("losses", "val_losses"):
        a, b = np.asarray(rec_g[key], np.float64), np.asarray(rec_e[key], np.float64)
        if a.shape != b.shape:
            fail(f"phase 11.4 {what}: {key} of {a.shape} against {b.shape}")
        worst = max(worst, float(np.max(np.abs(a - b) / np.abs(b))))
    metrics = sorted(k for k in row_e if k.startswith("relative error") and row_e[k])
    for k in metrics:
        a, b = float(row_g[k]), float(row_e[k])
        worst = max(worst, abs(a - b) / abs(b))
    bitwise = all(np.array_equal(rec_g[k], rec_e[k]) for k in ("losses", "val_losses"))
    log(f"phase 11.4 {what}: the loss records and {metrics} both ways within "
        f"{worst:.3e} relative (bound {GRAPH_WEIGHT_BOUND:g}; loss records bit for bit: "
        f"{bitwise}); samples_per_sec graph {float(row_g['samples_per_sec']):.1f}, "
        f"per-step {float(row_e['samples_per_sec']):.1f}")
    if worst > GRAPH_WEIGHT_BOUND:
        fail(f"phase 11.4 {what}: the two routes' trajectories differ by {worst:.3e}")
    # Per mode: (the CSV row, the trainer, seconds to the first evaluation,
    # samples/s after it); the break-even in steps.
    return {m: run[1:] for m, run in runs.items()}, even


def _rollout_both_ways(trainer, card: str) -> dict:
    """11.4: the ns_gauss trainer's autoregressive rollout on one test batch,
    issued forward by forward and as one replayed graph: the same bits, and
    ms a forward both ways (median of 5 synchronised rollouts)."""
    import torch

    from gaot_torch.data.loader import BatchLoader
    from gaot_torch.data.sequential import RolloutTestBatcher
    from gaot_torch.train import predict_mode_indices
    from gaot_torch.train.graphed import RolloutProgram

    cfg = trainer.dataset_config
    test = trainer.splits["test"]
    ti = predict_mode_indices("autoregressive", min(cfg.max_time_diff,
                                                    test["u"].shape[1] - 1), cfg.time_step)
    batcher = RolloutTestBatcher(test["u"], test["c"], ti, trainer.stats)
    batch = next(iter(BatchLoader(len(batcher), cfg.batch_size, batcher.get_batch)))
    placed = trainer.place_batch({k: v for k, v in batch.items() if k != "target"})
    trainer.model.eval()
    out, ms = {}, {}
    for way, capture in (("loop", False), ("graph", True)):
        program = RolloutProgram(trainer.model, ti, trainer.t_values, trainer.stats,
                                 trainer.stepper_mode,
                                 lambda p: trainer._model_args(p)[:2], capture=capture)
        out[way] = program(placed)
        ms[way] = statistics.median(host_times(lambda: program(placed), 5)) / (len(ti) - 1)
        del program
    if not torch.equal(out["loop"], out["graph"]):
        fail("phase 11.4: the replayed rollout differs from the loop of forwards")
    log(f"phase 11.4 ns_gauss rollout (autoregressive, {len(ti) - 1} forwards, batch "
        f"{placed['input'].shape[0]}, {card}): ms a forward loop {ms['loop']:.3f} / graph "
        f"{ms['graph']:.3f}, the same bits")
    return ms


def phase_graph(card: str, vx_path: Path) -> dict:
    """Phase 11 (module docstring) but 11.3's naca0012, which runs on phase
    5d's trainer. Returns the results."""
    import tempfile

    import torch

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from synthetic import make_static_fx_dataset
    from torch_synthetic import make_poseidon_sequential_dataset

    t_phase = time.perf_counter()
    res = {}
    with tempfile.TemporaryDirectory(prefix="gaot_graph_") as folder:
        with open(CONFIG) as f:
            name = json.load(f)["dataset"]["name"]
        make_static_fx_dataset(os.path.join(folder, f"{name}.npz"),
                               num_samples=sum(TRAINER_SIZES.values()),
                               num_nodes=NUM_NODES, seed=0)
        fx, res["fx_break_even"] = _cli_both_ways(lambda mode: _trainer_config(
            folder, f"fx_{mode}", compute_dtype="bfloat16", epoch_scan=mode),
            "fx recipe (phase 5's sizes, bf16)")
        res["fx_steady"] = {m: run[3] for m, run in fx.items()}
        trainer = fx["always"][1]
        del fx
        res["kernels"] = _kernels_captured(trainer, card)
        res["fx"] = _trainer_graph(f"fx main path (poisson_gauss, bf16, batch {BATCH})",
                                   trainer, card)
        del trainer
        torch.cuda.empty_cache()

        with open(SEQ_CONFIG) as f:
            seq_name = json.load(f)["dataset"]["name"]
        make_poseidon_sequential_dataset(os.path.join(folder, f"{seq_name}.npz"),
                                         sum(SEQ_SIZES.values()), channels=2, seed=0)
        seq, _ = _cli_both_ways(lambda mode: _seq_example(
            folder, SEQ_CONFIG, f"seq_{mode}", SEQ_SIZES, GRAPH_SEQ_EPOCHS, eval_every=1,
            compute_dtype="bfloat16", epoch_scan=mode),
            "ns_gauss (bf16, rollout)")
        trainer = seq["always"][1]
        del seq
        res["rollout_ms"] = _rollout_both_ways(trainer, card)
        res["seq"] = _trainer_graph(
            f"sequential (ns_gauss, bf16, batch {trainer.train_loader.batch_size})",
            trainer, card)
        del trainer
        torch.cuda.empty_cache()
    res["vx"] = _path_graph(vx_path, card)
    log(f"graph phase: {time.perf_counter() - t_phase:.1f} s")
    return res


# Phase 12: the epoch path under several ranks on the card (train/graphed.py):
# the training step captured with its NCCL collectives inside the graph.
# One card holds one NCCL rank (NCCL refuses two ranks on one device, and a
# gloo collective cannot be captured), so the phase runs in a torchrun
# process of one rank on NCCL (``--ddp-graph``): (12b) every function of
# parallel/comm.py on that one-rank group, forward and backward, captured
# and replayed against eager calls bit for bit, the NCCL kernels of one
# call each way; (12c) the fx recipe through gaot_torch.cli.main with
# setup.distributed and epoch_scan "always" and "never", the model wrapped
# in DDP over the one-rank group before the fit (smoke code: at one rank
# the trainer does not wrap it): the route line, the same loss records,
# samples/s after the first evaluation and the DDP graph's break-even
# (phase 11.4's method); (12a) on that trainer GRAPH_EPOCHS epochs of the
# per-step path (DDP eager), then from the same state the captured epoch
# path, replayed step by step: the loss bits and every weight after every
# step within GRAPH_WEIGHT_BOUND of eager's; the wrappers' launches in the
# graph's run (the DDP warm-up steps and the capture); then both ways the
# step's ms, busy, idle share and kernels a step, the NCCL kernels a step
# equal (over one rank NCCL launches none, eager or captured: a one-rank
# sum in place runs no kernel on the H100's NCCL 2.28). The process also
# runs 10.1's fit, between 12c and 12a. With two
# cards or more, 12a also on two ranks, one a card, at dp 2 and tp 2 (the
# trainer's own DDP and tensor parallelism).
DDP_GRAPH_MODES = {"dp": MESH_RUNS["dp"], "tp": MESH_RUNS["tp"]}
DDP_GRAPH_TIMEOUT = 300       # a torchrun start of phase 12 (about 80 s at one rank)


def _nccl_kernels(by_name: dict) -> float:
    return sum(v for k, v in by_name.items() if "nccl" in k.lower())


def _comm_captured() -> dict:
    """12b on the world group (one NCCL rank): each function of
    parallel/comm.py, fp32 and bf16, captured once (forward and, for the
    autograd ones, the backward of a fixed upstream gradient) on a static
    input and replayed on a new one, against the eager call on that input
    bit for bit. Returns {name: (NCCL kernels of the eager call, of the
    replay)}."""
    import torch
    import torch.distributed as dist

    from gaot_torch.parallel import comm

    group = dist.group.WORLD
    fns = {"all_reduce": (lambda x: comm.all_reduce(x, group), False),
           "all_gather": (lambda x: comm.all_gather(x, group, 1), False),
           "copy_to_group": (lambda x: comm.copy_to_group(x, group), True),
           "reduce_from_group": (lambda x: comm.reduce_from_group(x, group), True),
           "gather_along": (lambda x: comm.gather_along(x, group, 1), True),
           "sum_over": (lambda x: comm.sum_over(x, group), True)}
    gen = torch.Generator(device="cuda").manual_seed(3)
    rnd = lambda dtype: torch.randn(8, 256, 64, generator=gen, device="cuda").to(dtype)
    out = {}
    for name, (fn, grad) in fns.items():
        counts = []
        for dtype in (torch.float32, torch.bfloat16):
            up = rnd(dtype)

            def call(x):
                x = x.detach().requires_grad_(grad)
                y = fn(x)
                return [y] + ([torch.autograd.grad(y, x, up)[0]] if grad else [])

            static = rnd(dtype)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                call(static)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                got = call(static)
            x = rnd(dtype)
            static.copy_(x)
            graph.replay()
            want = call(x)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                fail(f"phase 12b: {name} ({dtype}) replayed differs from its eager call")
            counts.append(tuple(_nccl_kernels({e.key: e.count for e in device_events(
                run, f"{name} {way}")}) for way, run in (("eager", lambda: call(x)),
                                                         ("graph", graph.replay))))
            del graph
        out[name] = counts
        log(f"phase 12b {name}: fp32 and bf16, forward{' and backward' if grad else ''} "
            f"captured on the one-rank NCCL group and replayed on new inputs: equal to "
            f"the eager calls bit for bit; NCCL kernels a call (eager, replay) {counts}")
        if any(e != g for e, g in counts):
            fail(f"phase 12b: {name}'s replay runs other NCCL kernels than its eager call")
    return out


def _graph_on_ranks(trainer, what: str, card: str) -> dict:
    """12a on a trainer whose step runs collectives: ``_trainer_graph``
    (eager and the captured epoch path, the loss bits and weights after
    every step, both ways traced), the wrappers' launches in the warm-up
    steps and the capture, and the NCCL kernels a step, which must be equal
    both ways. Returns the results."""
    res = _trainer_graph(what, trainer, card, phase="12a")
    launches, warmup = res["launches"], res["warmup"]
    for k, v in TRAIN_LAUNCHES.items():
        if launches.get(k, 0) != (warmup + 1) * v:
            fail(f"phase 12a {what}: {k} launched {launches.get(k, 0)} times in the "
                 f"warm-up and the capture, {(warmup + 1) * v} expected")
    nccl = {way: _nccl_kernels(res[way].pop("by_name")) for way in ("eager", "graph")}
    log(f"phase 12a {what}: NCCL kernels a step eager {nccl['eager']:.1f} / replayed "
        f"{nccl['graph']:.1f}")
    if nccl["eager"] != nccl["graph"]:
        fail(f"phase 12a {what}: {nccl['graph']} NCCL kernels a replayed step against "
             f"{nccl['eager']} eager")
    res["nccl"] = nccl
    return res


def _ddp_fit(fit):
    """``BaseTrainer.fit`` that first wraps a model no DDP wraps in DDP over
    the world group (one NCCL rank), built on a side stream as the trainer
    builds its own where it captures (smoke code)."""
    def wrapped(self, *a, **kw):
        import torch
        import torch.distributed as dist
        from torch.nn.parallel import DistributedDataParallel

        if self.train_model is self.model:
            side = torch.cuda.Stream()
            with torch.cuda.stream(side):
                self.train_model = DistributedDataParallel(
                    self.model, process_group=dist.group.WORLD, broadcast_buffers=False,
                    static_graph=True)
            torch.cuda.current_stream().wait_stream(side)
        return fit(self, *a, **kw)
    return wrapped


def _ddp_graph_child(argv) -> int:
    """``chip_smoke.py --ddp-graph FOLDER OUT MODE``, launched by torchrun:
    phase 12 in this rank (MODE "one": 12b, 12c and 12a over one NCCL rank;
    "dp" or "tp": 12a on the trainer's own mesh of two ranks, one a card);
    rank 0 writes the results to OUT."""
    folder, out_path, mode = argv
    sys.path.insert(0, HERE)
    import torch
    import torch.distributed as dist

    from gaot_torch.core.config import SetUpConfig
    from gaot_torch.parallel import init_distributed
    from gaot_torch.train import StaticTrainer
    from gaot_torch.train.base_trainer import BaseTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(SetUpConfig(distributed=True, device="cuda"))
    res = {"nccl_version": torch.cuda.nccl.version(), "torch": torch.__version__,
           "world": dist.get_world_size(), "device": torch.cuda.current_device()}
    log(f"phase 12 ({mode}): rank {dist.get_rank()} of {res['world']} on device "
        f"{res['device']}, NCCL {res['nccl_version']}, torch {res['torch']}")
    if mode == "one":
        res["comm"] = _comm_captured()
        fit = BaseTrainer.fit
        BaseTrainer.fit = _ddp_fit(fit)
        try:
            runs, res["break_even"] = _cli_both_ways(lambda m: _trainer_config(
                folder, f"ddp_{m}", compute_dtype="bfloat16", distributed=True,
                epoch_scan=m), "fx recipe, DDP over one NCCL rank")
        finally:
            BaseTrainer.fit = fit
        res["steady"] = {m: run[3] for m, run in runs.items()}
        trainer = runs["always"][1]
        del runs
        # 10.1: the fx recipe as a user runs it here (at one rank no DDP).
        cfg_path, raw = _trainer_config(folder, "nccl1", compute_dtype="bfloat16",
                                        distributed=True)
        launches, _, secs, _, out = _cli_in_process(cfg_path, "torchrun 1 rank")
        res["nccl1"] = {"cfg": cfg_path, "raw": raw, "launches": launches, "secs": secs,
                        "out": out}
        what = f"fx main path, DDP over one NCCL rank (bf16, batch {BATCH})"
    else:
        with _quiet():
            trainer = StaticTrainer(_trainer_config(
                folder, f"graph_{mode}", compute_dtype="bfloat16", distributed=True,
                epoch_scan="always", **DDP_GRAPH_MODES[mode])[1])
        if trainer.steps_route()[0] != "graph":
            fail(f"phase 12a {mode}: route {trainer.steps_route()}")
        what = f"fx main path at {mode} 2 (bf16, global batch {BATCH})"
    torch.cuda.empty_cache()
    res["graph"] = _graph_on_ranks(trainer, what, torch.cuda.get_device_name())
    if dist.get_rank() == 0:
        torch.save(res, out_path)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _cli_two_cards(card: str, folder: str) -> None:
    """12c at dp 2 on two cards: ``torchrun --nproc_per_node=2 -m
    gaot_torch.cli`` of the fx recipe with epoch_scan "always": it exits 0
    (its process group, joined by the run, destroyed after the graph is
    released), its route line reads steps=graph, its loss falls."""
    cfg_path, raw = _trainer_config(folder, "cli_dp2", compute_dtype="bfloat16",
                                    distributed=True, epoch_scan="always",
                                    **DDP_GRAPH_MODES["dp"])
    t0 = time.perf_counter()
    _run_ranks([[sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node=2", "-m", "gaot_torch.cli", "-c", cfg_path]],
               "torchrun cli dp2", [dict(os.environ, PYTHONPATH=HERE)], folder,
               echo=True, timeout=DDP_GRAPH_TIMEOUT)
    with open(os.path.join(folder, "torchrun_cli_dp2.0.log")) as f:
        out = f.read()
    rec, row = _run_record(raw)
    first, steady = _steady_rate(out, TRAINER_SIZES["train_size"])
    log(f"phase 12c dp 2 ({card}, two cards): torchrun of the CLI in "
        f"{time.perf_counter() - t0:.1f} s; {float(row['samples_per_sec']):.1f} samples/s, "
        f"{steady:.1f} after the first evaluation ({first:.3f} s to it)")
    if "steps=graph" not in out or not rec["losses"][-1] < rec["losses"][0]:
        fail("phase 12c dp 2: no steps=graph route line, or the loss did not fall")


def phase_ddp_graph(card: str, rates: dict, graph: dict, folder: str) -> dict:
    """Phase 12 (comment above) in ``folder``, which keeps 10.1's outputs for
    phase 10: the torchrun process of one NCCL rank (and 10.1's checks of
    the fit it ran), then with two cards or more the two-rank runs. Returns
    the one-rank results."""
    import torch

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from synthetic import make_static_fx_dataset

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    with open(CONFIG) as f:
        name = json.load(f)["dataset"]["name"]
    make_static_fx_dataset(os.path.join(folder, f"{name}.npz"),
                           num_samples=sum(TRAINER_SIZES.values()),
                           num_nodes=NUM_NODES, seed=0)
    runs = ([(m, 2) for m in DDP_GRAPH_MODES] if cards >= 2 else []) + [("one", 1)]
    out = {}
    for mode, world in runs:
        path = os.path.join(folder, f"ddp_graph_{mode}.pt")
        _run_ranks([[sys.executable, "-m", "torch.distributed.run", "--standalone",
                     f"--nproc_per_node={world}", os.path.join(HERE, "chip_smoke.py"),
                     "--ddp-graph", folder, path, mode]], f"torchrun {mode}",
                   [dict(os.environ, PYTHONPATH=HERE)], folder, echo=True,
                   timeout=DDP_GRAPH_TIMEOUT)
        out[mode] = torch.load(path, weights_only=False)
    if cards >= 2:
        _cli_two_cards(card, folder)
    one = out["one"]
    _nccl_one_rank(card, one["nccl1"], rates)
    g = one["graph"]
    log(f"phase 12 ({card}; NCCL {one['nccl_version']}, torch {one['torch']}): the fx "
        f"recipe's DDP-captured step over one NCCL rank {g['graph']['ms']:.3f} ms (idle "
        f"share {g['graph']['idle']:.3f}) against eager {g['eager']['ms']:.3f} "
        f"(idle {g['eager']['idle']:.3f}) and phase 11.2's one-process graph "
        f"{graph['fx']['graph']['ms']:.3f}; capture {g['capture_s']:.3f} s with "
        f"{g['warmup']} warm-up steps; NCCL kernels a step {g['nccl']}; samples/s "
        f"after the first evaluation through torchrun: DDP graph "
        f"{one['steady']['always']:.1f}, DDP per-step {one['steady']['never']:.1f}, "
        f"10.1's per-step {rates['steady_nccl1']:.1f}, 11.4's one-process graph "
        f"{graph['fx_steady']['always']:.1f}; break-even of the DDP graph "
        f"{one['break_even']:.0f} steps (11.4's one-process graph in this run: "
        f"{graph['fx_break_even']:.0f})")
    for mode in DDP_GRAPH_MODES:
        if mode in out:
            g = out[mode]["graph"]
            log(f"phase 12a {mode} 2 (two cards): step ms eager {g['eager']['ms']:.3f} / "
                f"graph {g['graph']['ms']:.3f}, NCCL kernels a step {g['nccl']}")
        else:
            log(f"phase 12a {mode} 2: {cards} card on this machine: the two-rank "
                "captured runs did not run (a limit of the machine)")
    log(f"DDP graph phase: {time.perf_counter() - t_phase:.1f} s")
    return one


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
    import tempfile

    import torch

    from gaot_torch.core.config import GAOTConfig, load_experiment_config, merge_config

    t_main = time.perf_counter()
    marks = []

    def mark(what):
        marks.append((what, time.perf_counter() - t_main))
        log(f"[{marks[-1][1]:.1f} s] {what} done")

    card = phase_card()
    phase_build()
    mark("phase 1 (card, build)")

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
    cfg_seq = load_experiment_config(SEQ_CONFIG)
    seq_path = Path("sequential main path", cfg_seq,
                    *_seq_host_graphs(cfg_seq, "sequential main path"), seq=SEQ,
                    check_batch=SEQ_CHECK_BATCH, check_dtypes=("fp32", "bf16"),
                    batch=cfg_seq.dataset.batch_size,
                    steps_per_epoch=math.ceil(cfg_seq.dataset.train_size * 28
                                              / cfg_seq.dataset.batch_size),
                    forward_launches={}, train_launches={}, channels=(4, 2))
    fwd_seq, train_seq = _tables(_graph_args(seq_path, 1, "cpu")[0],
                                 cfg_seq.model.args.transformer.num_layers, ffn=True)
    seq_path = seq_path._replace(forward_launches=fwd_seq, train_launches=train_seq)
    log(f"sequential main path launches (from its graphs): a forward {fwd_seq}; a "
        f"training step {train_seq}")
    cfg_vx = merge_config(GAOTConfig, CONFIG_VX)
    coords_vx, lat_vx, enc_vx, dec_vx, bufs_vx = _host_graphs_vx(cfg_vx, "vx flagship")
    vx_path = Path("vx flagship", cfg_vx, coords_vx, lat_vx, enc_vx, dec_vx, seq=SEQ,
                   check_batch=VX_CHECK_BATCH, check_dtypes=("fp32", "bf16"),
                   batch=VX_BATCH, steps_per_epoch=1, forward_launches={},
                   train_launches={}, vx=bufs_vx)
    fwd_vx, train_vx = _tables(_graph_args(vx_path, VX_BATCH, "cpu")[0],
                                  cfg_vx.model.args.transformer.num_layers, ffn=True)
    vx_path = vx_path._replace(forward_launches=fwd_vx, train_launches=train_vx)
    log(f"vx flagship launches: a forward {fwd_vx}; a training step {train_vx}")
    cases = _reduce_cases(main_path, "fx main path")
    cases3 = _reduce_cases(flagship, "3D flagship")
    cases_vx = _vx_reduce_cases(vx_path, "vx flagship")
    cases_seq = _reduce_cases(seq_path, "sequential main path")

    gen = torch.Generator(device="cuda").manual_seed(1)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    phase_widths(rnd)
    fp32_ffn = check_ffn_f32(rnd)
    mark("phase 1b (widths, the fp32 SwiGLU)")
    tcfg3 = cfg3.model.args.transformer
    h3 = tcfg3.attn_config.num_heads
    d3 = tcfg3.hidden_size // h3
    c3 = cfg3.model.args.magno.lifting_channels
    fp32_fx = {}   # the fp32 flash rows at the fx shape (the @fp32 entries)
    checks = {
        "main": {**check_multiply_reduce(rnd, BATCH, 64, cases, "fx main path",
                                         fp32_rows=fp32_fx),
                 **check_flash(rnd, BATCH, SEQ, 8, 32, fp32_rows=fp32_fx), **check_ffn(rnd)},
        "fp32-on": fp32_ffn,
        "3d": {**check_multiply_reduce(rnd, BATCH_3D, c3, cases3, "3D flagship"),
               **check_flash(rnd, BATCH_3D, SEQ_3D, h3, d3)},
        "long": {**check_multiply_reduce(rnd, BATCH_LONG, c3, cases3, "3D long"),
                 **check_flash(rnd, BATCH_LONG, SEQ_LONG, h3, d3, with_eval=False)},
        "vx": {**check_multiply_reduce(rnd, 1, cfg_vx.model.args.magno.lifting_channels,
                                       cases_vx, "vx flagship"),
               **check_flash(rnd, VX_BATCH, SEQ, 8, 32),
               **check_ffn(rnd, VX_BATCH * SEQ)},
    }
    # The bf16 general SwiGLU route: its kernels at M 1024, F 3584, and a
    # model step through them (the fx main path at UViT hidden 512).
    checks["general"] = check_ffn_general(rnd)
    general_launches = phase_general_ffn(main_path)
    # The sequential path's reduces on its own graphs; its flash and SwiGLU
    # shapes are the fx main path's (B 64, S 1024, D 32; M 256, F 1024), so
    # its rows share those times.
    checks["seq"] = {**check_multiply_reduce(rnd, seq_path.batch, 64, cases_seq,
                                             "sequential main path"),
                     **{k: v for k, v in checks["main"].items()
                        if not k.startswith("multiply_reduce")}}
    # The long backward's regime at a length where the plain versions hold
    # all heads at once; logged only.
    check_flash(rnd, 1, 8192, h3, d3, with_eval=False)
    torch.cuda.empty_cache()
    mark("phase 2")

    fwd = phase_forward(main_path)
    train, step_ms = phase_train(main_path)
    fwd3 = phase_forward(flagship)
    train3, _ = phase_train(flagship)
    phase_forward(aniso)
    phase_train(aniso)
    train_long, _ = phase_train(long_path)
    fwd_v = phase_forward(vx_path)
    train_v, step_ms_vx = phase_train(vx_path)
    phase_forward(seq_path)
    _, step_ms_seq = phase_train(seq_path)
    rollouts = phase_rollout(seq_path)
    mark("phases 3-4b")
    trained, rates = phase_trainer(card, step_ms)
    trained_vx = phase_vx_trainer(card, step_ms_vx)
    trained_seq = phase_seq_trainer(card, step_ms_seq, rollouts)
    trained_naca, checks_naca, graph_naca = phase_naca(card, rnd)
    mark("phases 5-5d")
    phase_attn_dropout(main_path, step_ms)
    phase_pointnet(main_path, vx_path, step_ms)
    mark("phases 6-7")
    phase_options(card, main_path, vx_path, step_ms, step_ms_vx)
    mark("phase 8")
    # Phase 11 before phase 10: the script's own process has seen no device
    # time in its profiles after phase 10's ranks.
    graph = phase_graph(card, vx_path)
    graph["naca"] = graph_naca
    mark("phase 11")
    ffn_on = phase_ffn_on(main_path, card)
    mark("phase 11b (fp32 step, fused_ffn on)")
    # Phase 12 before the rest of phase 10: its torchrun process runs 10.1's
    # fit, whose checkpoint 10.4 reads.
    with tempfile.TemporaryDirectory(prefix="gaot_torchrun_") as folder:
        ddp_graph = phase_ddp_graph(card, rates, graph, folder)
        mark("phase 12 (with 10.1)")
        meshes = phase_mesh(card, checks["main"], checks["vx"], ddp_graph["nccl1"])
        mark("phase 10")

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
                    + _entries(checks["vx"], main_names, counts_vx, "vx flagship", "@vx")
                    # The sequential entries: ns_gauss run A's launches
                    # (through the CLI: steps, validation and rollouts).
                    + _entries(checks["seq"], main_names,
                               {k: trained_seq[main_names[k]] for k in checks["seq"]},
                               "sequential main path", "@seq")
                    # The naca0012 entries: the reduces on its masks thinned
                    # to max_neighbors 32 and the fp32 flash kernels at its
                    # shapes, with the CLI run's launches.
                    + _entries(checks_naca, main_names,
                               {k: trained_naca[main_names[k]] for k in checks_naca},
                               "naca0012", "@naca")
                    # The fp32 flash kernels at the fx shape, with the
                    # launches of the trainer's run C (the example's fp32).
                    + _entries(fp32_fx, main_names,
                               {k: rates["launches_c"][main_names[k]] for k in fp32_fx},
                               "fx main path, run C (fp32)", "@fp32")
                    # The fp32 SwiGLU kernels at the fx shape, with the
                    # launches of phase 11b's eager fp32 step under
                    # fused_ffn "on" (no example sets it).
                    + _entries(checks["fp32-on"], main_names,
                               {k: ffn_on[k] for k in checks["fp32-on"]},
                               "fx main path, fp32 step, fused_ffn on", "@fp32-on")
                    # The bf16 general route at M 1024, F 3584, with the
                    # launches of its model step (UViT hidden 512; no example
                    # runs this route).
                    + _entries(checks["general"], main_names,
                               {k: general_launches[k] for k in checks["general"]},
                               f"fx main path at UViT hidden {GENERAL_HIDDEN}, bf16 step",
                               "@general"))
    # The multi-GPU entries: the kernels at a rank's shapes, with rank 0's
    # launches in one bf16 training step of its mesh run (phase 10).
    for suffix, (rows, launches) in meshes.items():
        path = "vx flagship" if suffix == "@sp-vx" else "fx main path"
        kernels_line += _entries(rows, main_names,
                                 {k: launches[main_names[k]] for k in rows},
                                 f"{path} {suffix[1:]} x 2 ranks", suffix)
    # The captured steps' entries (phase 11): on the fx main path each
    # kernel's calls of one step captured alone and replayed (11.1), the
    # other paths with phase 2's kernel times; launches: the wrappers'
    # count in the graph's run (two warm-up steps and the capture, each
    # replay launching the captured step's kernels again).
    step_keys = ("multiply_reduce_k", "multiply_reduce_b", "fwd_lse", "bwd",
                 "fused_ffn_fwd", "fused_ffn_bwd")
    for suffix, rows, run, path in (("@graph", checks["main"], graph["fx"], "fx main path"),
                                    ("@graph-vx", checks["vx"], graph["vx"], "vx flagship"),
                                    ("@graph-seq", checks["seq"], graph["seq"],
                                     "sequential main path"),
                                    ("@graph-naca", checks_naca, graph["naca"], "naca0012")):
        picked = {}
        for k in step_keys:
            if k not in rows or not run["launches"][main_names[k]]:
                continue
            row = dict(rows[k])
            note = (f"{run['replays']} replays of the captured step; launches: "
                    f"2 warm-up steps and the capture")
            if suffix == "@graph":
                err, g_ms, e_ms, n = graph["kernels"][main_names[k]]
                row.update(ms=g_ms, eager_ms=e_ms, graph_vs_eager_err=err)
                note += (f"; ms: the {n} calls of one step, each captured alone and "
                         "replayed (eager_ms: the same calls issued back to back), "
                         "equal to the eager calls bit for bit, so max_abs_err "
                         "against the plain version is phase 2's")
            else:
                note += "; ms: the eager call (phase 2), the captured kernel the same"
            row["per"] = f"{row.get('per', '')}; {note}"
            picked[k] = row
        kernels_line += _entries(picked, main_names,
                                 {k: run["launches"][main_names[k]] for k in picked},
                                 f"{path}, captured step", suffix)
    # The DDP-captured step's entries (phase 12a, one NCCL rank): phase 2's
    # rows at the fx shapes, launches the wrappers' count in the graph's run
    # (the DDP warm-up steps and the capture).
    g = ddp_graph["graph"]
    picked = {}
    for k in step_keys:
        row = dict(checks["main"][k])
        row["per"] = (f"{row.get('per', '')}; {g['replays']} replays of the step captured "
                      f"under DDP over one NCCL rank; launches: {g['warmup']} warm-up "
                      "steps and the capture; ms: the eager call (phase 2)")
        picked[k] = row
    kernels_line += _entries(picked, main_names,
                             {k: g["launches"][main_names[k]] for k in picked},
                             "fx main path, DDP-captured step", "@graph-ddp")
    # Each phase's seconds (from the marks) on one line, also on standard
    # error: the kernels line alone passes the 24 KB that the end of a
    # standard-output log may keep.
    mark("the kernel entries")
    ends = [0.0] + [t for _, t in marks]
    secs = "phase seconds: " + "; ".join(
        f"{what} {t - t0:.1f}" for (what, t), t0 in zip(marks, ends)) + f"; total {ends[-1]:.1f}"
    log(secs)
    print(secs, file=sys.stderr, flush=True)
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(_rank_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--mesh-rows"]:
        sys.exit(_mesh_rows(sys.argv[2:]))
    if sys.argv[1:2] == ["--ddp-graph"]:
        sys.exit(_ddp_graph_child(sys.argv[2:]))
    sys.exit(main())
