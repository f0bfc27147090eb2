#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``
with ``nvcc`` (sm_90a, one ``nvcc`` per library, started together),
holds each kernel against its plain PyTorch version at the shapes its
path gives it, then drives the port's paths at the paper's sizes and
checks their labels against the ``torch`` backend (plain torch on the
card, sweeps and loop alike: it launches no kernel), against the same
solve on CPU tensors where the kernel's order of updates matters, and
against scipy's connected components:

* the main path, ``repro_torch.solve(g)`` (Contour C-2 on the ``cuda``
  kernels, its fixpoint loop on the card: ``converged_early`` does the
  loop's step, ``pointer_jump`` the jump rounds, and the host reads the
  loop's state once per ``converged.CHUNK`` iterations), and C-11mm,
  whose order-1 sweeps run ``scatter_min``; before it, ``fused_relax``
  and ``scatter_min`` are held against their plain versions on hub
  graphs, slices and edge limits, their counts (updates before the test
  of the output label, hot slots) against the plain replays, their SASS
  for the warp combine (``contour_hopper``), and timed in four label
  states of each main-path graph; after it, ``converged_early``,
  ``labels_unchanged`` and ``pointer_jump`` are held against their plain
  versions in the same states and at the solve's fixed point (the
  predicate there also timed right after a jump round, as the loop
  meets it, after an L2 flush, and on a pass whose one witness is at
  its end), and the
  warm solve is timed at several chunk sizes and traced with
  ``torch.profiler`` for the card's idle share;
* the asynchronous path, ``solve(g, backend="cuda_async")`` on the
  in-order sweep kernel ``mm2``;
* the baseline families, ``solve(g, algorithm=a)`` for FastSV and label
  propagation (their hookings on ``scatter_min``, their no-change test on
  ``labels_unchanged``) and Rem's union-find (on the host), against scipy
  and against the same solves on CPU tensors at the check scale, and a
  FastSV iteration timed with and without the freeze of its state;
* the frontier path, ``solve(g, sampling=2, compact_every=2,
  sampling_strategy=s)`` for every sampling strategy, staged;
* the streaming path, ``StreamingConnectivity(n).ingest(src, dst,
  validate=False)`` over the main path's graphs' own edges in batches of
  2**20 (device tensors), against scipy, the ``torch`` backend's stream
  bit for bit, ``resolve()`` and a checkpoint round trip, with the
  kernels of each delta solve (``fused_relax``, ``converged_early``,
  ``pointer_jump``) counted; at the check scale, against the same stream
  on CPU tensors after every batch;
* the serving path, ``run_simulation`` (the serving engine under four
  query threads and an ingest thread) at 4,194,304 vertices, 250,000
  queries and 250 ingests, against scipy and a ``torch``-backend stream,
  a sample of its answers against the final labels; then two injected
  crashes recovered from checkpoints and the write-ahead log, with no
  acknowledged ingest lost and the clean run's labels;
* the out-of-core path, ``OutOfCoreContraction(chunks).run()`` (the
  edges on the host, the labels and one chunk on the card, each chunk
  copied through pinned buffers on a copy stream while the chunk before
  it folds on ``fused_relax``, ``converged_early`` and ``pointer_jump``):
  rmat(22,16)'s host arrays in chunks of 2**20 with no edge list of it on
  the card, R-MAT generated chunk by chunk, the async path's mesh, the
  star forest that needs two rounds, and ``solve(g,
  algorithm="out_of_core")``; against scipy, the in-core solve, the
  ``torch`` backend's run after every round (on rmat(22,16)) and the CPU
  run after every round (at the check scale); the peak device bytes
  against the edge list's 8m; each round split into pads, copies (their
  GB/s beside one pinned copy timed alone), folds and contraction, with
  host syncs and the card's idle share over round 0;
* the recovery path, ``oocore_with_recovery`` with a fault in the middle
  of round 0 and one at a round boundary, and ``stream_with_recovery``
  over rmat(20,16)'s edges with two faults, each against its clean run
  bit for bit;
* the mesh phase, after the recovery path (``connectivity.distributed``
  over ``torch.distributed``): ``solve(g, mesh=mesh)`` on a 1-rank NCCL
  mesh in this process on the main path's graphs, dense, at
  ``local_rounds`` 1 and 3, bit for bit the ``torch`` backend's mesh
  solve and scipy's labels, with the warm wall beside dense C-2's, host
  syncs and the card's idle share (``mesh_path``), and the stream's
  mesh path over 8 batches of 2**20 of rmat's edges, its state after
  every batch against the ``torch`` backend's (``mesh_stream``); then 4
  gloo ranks spawned on the card (NCCL takes one rank a card; gloo
  stages through the host) solving the async path's graphs, dense and
  on the frontier, from host arrays saved once and mapped by every rank
  (``mesh_ranks``), and the elastic shrink 4 -> 3 -> 2
  (``mesh_elastic``); the ranks' launches are summed into the kernels
  line;
* fleets of small graphs through ``solve_batch`` (1024 x rmat(12,16),
  256 x delaunay_like(14), a ragged fleet of 512): every lane against
  scipy, its solo solve and the ``torch`` backend's fleet, walls, host
  syncs and the launches of each route; C-11mm's walls on the rmat and
  ragged fleets and C-Syn's on the rmat fleet beside the ``torch``
  backend's; K1, K6, K2 and K7 fleet ran their lane route
  (``fleet.fleet_route``: each lane's labels in shared memory) and are
  held on both routes against their plain versions and timed, with
  ``labels_unchanged_batched`` (C-Syn's test: live and at the fixed
  point); then ``algorithm="auto"`` and the autotuner;
* the float kernels' entry points, ``fused_rmsnorm(x, w)`` and
  ``flash_attention(q, k, v)``, at mistral-nemo-12b's widths (d_model
  5120; 32 heads, 8 KV heads, head dim 128) over 8 x 4096 and 2 x 4096
  tokens, after ``rmsnorm_rows`` and ``flash_mha`` were held against
  their plain versions there and at other widths of the repo's models;
  both in bfloat16 and float16; ``flash_attention``'s 16-bit kernel is
  also shown to run on ``wgmma`` and TMA in both types (its SASS), with
  its rate and SDPA's error beside it;
* right after them, the LM serving path (``lm_path``):
  ``repro_torch.launch.serve.BatchedServer`` over ``repro_torch.models``
  at mistral-nemo-12b's full width and depth (40 layers, 12,247,782,400
  bfloat16 weights drawn on the card from a seeded generator) serving
  prompts of 4096, 1024, 512 and 37 tokens on 2 slots, 16 new tokens
  each: every request against the same request served alone, the
  4096-token prefill and a decode step timed beside their bounds, a
  decode step under ``torch.profiler``, the peak memory; the reference's
  prefill/decode consistency at 2 layers (and printed at 40), bfloat16
  against float32 logits of the same weights, a smoke config on the card
  against CPU tensors, and ``flash_mha``/``rmsnorm_rows`` against the
  path's ``attend_chunked``/``apply_norm`` on its own tensors (the path
  itself launches none of the port's kernels, as the reference's models
  call none).  Its weights are freed before the next phase;
* then the other LM families (``lm_families``), one model at a time at
  full width, each freed before the next: deepseek-moe-16b (28 layers,
  16,375,728,128 bfloat16 weights), arctic-480b on 2 of its 35 layers
  (~27.7 B bfloat16 weights; 35 do not fit the card), xlstm-125m,
  zamba2-2.7b and seamless-m4t-large-v2 (float32 weights, bfloat16
  compute), served as nemo is (prompts of 4096, 1024, 512 and 37
  tokens; arctic 1024 and 37; the encoder-decoder's stub frames), each
  request against it served alone, the longest prefill and a decode
  step timed beside bounds that count the experts a token meets, no
  attention in recurrent layers and the encoder's frames (an MoE decode
  also with the activated experts only), a decode step under
  ``torch.profiler``, the MoE drops of the longest prefill, the
  prefill/decode consistency in float32 at 2 layers (4 for xlstm, 6 for
  zamba2, 2 + 2 for seamless, 1 for arctic; bfloat16 printed), and the
  smoke config on the card against CPU tensors.  None of them launches
  a kernel of the port;
* then the training path (``train_path``): ``repro_torch.train``'s step
  (AdamW, the backward through ``torch.autograd.grad``, remat ``full``)
  on olmo-1b at full width and depth (16 layers, 1,177,026,560 float32
  parameters and both moments drawn on the card) over
  ``launch.train.build_batch_fn``'s batches of 8 x 2048 tokens: a
  warm-up step, 3 steps timed one by one beside the step's bound
  (``roofline.model_flops`` at the bf16 rate plus AdamW's bytes), one
  under ``torch.profiler``, the peak memory, every loss and grad norm
  finite and the loss falling, the aten ops' device time; at 2 layers a
  step run twice and remat ``full`` against ``none`` bit for bit,
  ``grad_accum=2`` against 1, ``run_with_recovery`` with two faults and
  ``train_loop`` resumed from its checkpoint (on local disk) against the
  run that never stopped, bit for bit; and one
  step of every arch's smoke config in float32 on the card against CPU
  tensors.  It launches no kernel of the port;
* inside it, on its olmo-1b state, the roofline path (``roofline_path``):
  the train step priced op by op on ``meta`` tensors
  (``roofline.op_cost``, as ``launch.dryrun`` prices a rank) and run once
  on the card under the same counting mode, which must see the same aten
  ops, FLOPs and bytes; the same for one mistral-nemo-12b decode step
  against 4096 positions; the three roofline terms (``roofline.HW_H100``)
  beside each step's measured ms, the traced peak against
  ``max_memory_allocated``; after the kernels line, the dry-run's
  ``contour-cc`` round on a 1-rank mesh at rmat(22,16)'s n and m, which
  must equal K1 + K7 + K6's entries of the kernels line (one
  ``{"roofline": ...}`` line).  It launches no kernel of the port;
* then the LM on a mesh (``lm_mesh``): on a 1-rank NCCL mesh in this
  process (FileStore rendezvous), one olmo-1b train step at full width
  and depth from the state of the mesh-less step (loss, grad norm and
  parameters within ``TRAIN_CPU_TOL``, whether bit for bit printed, its
  CUDA-event ms beside the mesh-less step's) and mistral-nemo-12b's
  serving config (``tp``) prefilling 4096 tokens and decoding 16 greedy
  tokens, which must equal the mesh-less ones; then ``LM_MESH_RANKS``
  gloo ranks sharing the card on ``make_host_mesh(2)``, full width, 2
  layers, float32: olmo-1b's train steps under ``fsdp`` and ``tp``,
  nemo's prefill and decode under ``tp`` with its cache's positions
  sharded, deepseek-moe-16b's steps, prefill and decode under ``ep``,
  each against the same model run without a mesh on rank 0 within the
  CPU tests' limits, each rank's parameter and moment bytes equal to
  the sum of its blocks (``shardings_for``), its peak bytes, and the
  collectives a step (calls and bytes; host-staged gloo, not NCCL).  It
  launches no kernel of the port.  The graphs are made after it.

Every phase prints one JSON line with its seconds; any failed check
raises and the script exits non-zero.  The lines before the last are the
card's name and power limit (as ``nvidia-smi`` prints them) and one
``{"kernels": [...]}`` object, with each kernel's launches summed over
the paths; the last line is ``{"ok": true, "device": {...}}``.

Run from the root of a checkout, on a machine with one CUDA GPU::

    python3 chip_smoke.py

It needs numpy, scipy, torch built for CUDA and ``nvcc``; it imports
nothing of JAX.  float32 matrix products stay float32 (TF32 off), so the
plain versions are exact references.  Without a CUDA device it exits
with code 1 and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
import zlib
from collections import Counter
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch import (Graph, StreamingConnectivity, solve,  # noqa: E402
                         solve_batch, stack_graphs)
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import ARCHS, get_arch  # noqa: E402
from repro_torch.connectivity import SAMPLING_STRATEGIES, minmap  # noqa: E402
from repro_torch.connectivity import fastsv  # noqa: E402
from repro_torch.connectivity import oocore  # noqa: E402
from repro_torch.connectivity import (  # noqa: E402
    OutOfCoreContraction, oocore_with_recovery,
    resilient_distributed_contour, stream_with_recovery)
from repro_torch.connectivity import contour  # noqa: E402
from repro_torch.connectivity import frontier as fr  # noqa: E402
from repro_torch.connectivity import planner  # noqa: E402
from repro_torch.connectivity.solvers import device_degree_skew  # noqa: E402
from repro_torch.graphs import generators as gen  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.contour_mm import blocked, kernel, ops  # noqa: E402
from repro_torch.kernels.contour_mm import fleet  # noqa: E402
from repro_torch.kernels.contour_mm import converged as cv  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, mha_ref)
from repro_torch.kernels.flash_attention import \
    kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.fused_rmsnorm import (  # noqa: E402
    fused_rmsnorm, rmsnorm_ref)
from repro_torch.kernels.fused_rmsnorm import \
    kernel as rms_kernel  # noqa: E402
from repro_torch.launch.serve import BatchedServer, Request  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.train import build_batch_fn, train_loop  # noqa: E402
from repro_torch.models import attention as lm_attn  # noqa: E402
from repro_torch.models import common as lm_common  # noqa: E402
from repro_torch.models import mlp as lm_mlp  # noqa: E402
from repro_torch.models import transformer as lm_tfm  # noqa: E402
from repro_torch.models.model import build_model, lm_param_specs  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.optim.adamw import init_opt_state  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.roofline import (HW_H100, analyze_program,  # noqa: E402
                                  count_params, model_flops)
from repro_torch.roofline.op_cost import price  # noqa: E402
from repro_torch.train import (init_train_state,  # noqa: E402
                               make_train_step)
from repro_torch.runtime import mesh as rt_mesh  # noqa: E402
from repro_torch.runtime.mesh import AbstractMesh  # noqa: E402
from repro_torch.runtime import (FaultInjector, Mesh,  # noqa: E402
                                 ShardLossFault, SimulatedFault,
                                 run_with_recovery)
from repro_torch.serving import ConnectivityEngine  # noqa: E402
from repro_torch.serving.simulate import (  # noqa: E402
    WorkloadSpec, make_ingest_plan, run_simulation)

DEVICE = "cuda"
# rmat(22, 16) is the size of the paper's soc-LiveJournal1
RMAT_EDGE_FACTOR = 16
# calls per CUDA-event or host-clock timing
REPS = 20
# warm solves of a fleet on the torch backend (0.01-0.65 s each) per mean
PLAIN_FLEET_REPS = 3
# cycles the card spins before a timed call (about 0.1 ms at 1.98 GHz):
# more than the host takes to enqueue one call
HOLD_CYCLES = 200_000
# launches per timing of the in-order sweep kernel mm2: one launch walks
# every edge on one thread and takes seconds at the async path's sizes
ASYNC_REPS = 3
# mm2's (window, depth, cache slots) at which every branch of its protocol
# fires, checked on the small graphs named in MM2_TINY_ON
MM2_TINY = [(1, 1, 1), (3, 2, 1), (4, 4, 2), (7, 5, 8)]
MM2_TINY_ON = ("path_unshuffled(65536)", "star(65536)")
# the chunk sizes (iterations between two reads of the loop's state) at
# which the warm C-2 solve is timed
CHUNKS = (1, 2, 3, 4, 6, 8, 16)
# the frontier schedule the repo's drivers run (benchmarks/connectivity.py,
# examples/quickstart.py)
FRONTIER = {"sampling": 2, "compact_every": 2}
# H100 SXM published peaks (NVIDIA data sheet, roofline.analysis.HW_H100)
# behind each bound_ms: HBM bandwidth, and the float32 rate outside the
# tensor cores, the table's closest entry for the kernels' int32
# min/compare work
HBM_BYTES_PER_S = HW_H100["hbm_bw"]
ALU_OPS_PER_S = HW_H100["alu_ops"]
# dense bf16 and fp16 tensor-core rate: the least time of attention's
# products
BF16_TENSOR_OPS_PER_S = HW_H100["peak_flops"]
# mistral-nemo-12b (src/repro/configs/mistral_nemo_12b.py): d_model, query
# heads, KV heads, head dim
NEMO = {"d": 5120, "H": 32, "Hkv": 8, "hd": 128}
# the streaming path: each main-path graph's own edges, in order, in
# batches of this many edges (device tensors, validate=False: the
# pre-validated device stream), and the batch at the check scale
STREAM_BATCH = 1 << 20
CHECK_STREAM_BATCH = 1 << 16
# the serving path: 250,000 queries and 250 ingests of 65,536 edges into
# 4,194,304 vertices (16.4M edges, rmat(22)'s vertex count)
SERVE_SPEC = WorkloadSpec(n_vertices=4_194_304, n_queries=250_000,
                          zipf_a=1.3, burst_mean=64, write_ratio=0.001,
                          edges_per_batch=65_536, n_query_threads=4,
                          window=4096, seed=0)
# its recovery run (benchmarks/serving.py's fault schedule and cadence):
# 40 ingests and 20,000 queries, two injected crashes
RECOVERY_SPEC = dataclasses.replace(SERVE_SPEC, n_queries=20_000,
                                    write_ratio=0.002)
RECOVERY_FAIL_AT = ((3, "pre"), (17, "pre"))
RECOVERY_CHECKPOINT_EVERY = 8
# answers of the serving run held against its final labels
ANSWER_SAMPLE = 10_000
# the time the two phases are meant to take together at most (printed
# beside their seconds; the serving run's wall is the host's, which
# varies with the machine's load, so it is reported, not a check)
STREAM_SERVE_BUDGET_S = 120.0
# the out-of-core path: rmat(22,16)'s host arrays in chunks of 2**20 (62
# chunks), R-MAT generated chunk by chunk (scale 20, 64 chunks of 2**18),
# the async path's delaunay_like(21) in chunks of 2**17 (48), the star
# forest that needs two rounds, and the check scale (64 chunks of 2**14)
OOCORE_CHUNK = 1 << 20
OOCORE_GENERATED = {"scale": 20, "edge_factor": 16, "chunk_edges": 1 << 18}
OOCORE_MESH_CHUNK = 1 << 17
OOCORE_STAR = {"k": 16, "b": 1024}
OOCORE_CHECK = {"scale": 16, "edge_factor": 16, "chunk_edges": 1 << 14}
# the recovery path: the out-of-core mesh with a fault in the middle of
# round 0 and one at the boundary of round 1; rmat(20,16)'s edges streamed
# in batches of 2**20 with two faults and a checkpoint every 4 batches
STREAM_RECOVERY_FAIL_AT = ((3, "pre"), (11, "post_write"))
STREAM_RECOVERY_CHECKPOINT_EVERY = 4
# one pinned copy timed alone: the host-to-device ceiling the out-of-core
# copies are read against
PINNED_PROBE_BYTES = 8 << 20
# the time the out-of-core and recovery phases are meant to take together
# at most (reported, as STREAM_SERVE_BUDGET_S)
OOCORE_BUDGET_S = 120.0
# the fleet path (solve_batch): 1024 x rmat(12,16) and 256 x
# delaunay_like(14) (4,194,304 labels each fleet), and a ragged fleet of
# 512 graphs of 2**8..2**14 vertices (drawn with BATCH_SEED) over rmat,
# path, grid and star; each graph seeded by its place in its fleet
BATCH_RMAT = {"count": 1024, "scale": 12}
BATCH_DELAUNAY = {"count": 256, "scale": 14}
BATCH_RAGGED = {"count": 512, "scales": (8, 14)}
BATCH_SEED = 21
# the time the fleet and auto phases are meant to take together at most
# (reported, as the other budgets)
BATCH_AUTO_BUDGET_S = 90.0
# the mesh phase (connectivity.distributed): a 1-rank NCCL mesh in this
# process on the main path's graphs and the stream's mesh path over
# MESH_STREAM_BATCHES batches of STREAM_BATCH of rmat's edges; then
# MESH_RANKS gloo ranks sharing the card (NCCL refuses two ranks on one
# card; gloo stages CUDA tensors through the host) on the async path's
# graphs, each case dense and on the frontier, and the elastic shrink on
# those ranks, one rank lost at each of the blocks of MESH_FAIL_AT
MESH_RANKS = 4
MESH_LOCAL_ROUNDS = (1, 3)
MESH_SCHEDULES = ((0, 0), (FRONTIER["sampling"], FRONTIER["compact_every"]))
MESH_STREAM_BATCHES = 8
MESH_FAIL_AT = ((1, "round"), (2, "round"))
# a rank's collectives give up after this long, and the spawn after this:
# a hung rank ends the run with a non-zero exit
MESH_COLLECTIVE_TIMEOUT_S = 120
MESH_SPAWN_TIMEOUT_S = 300
# the time the mesh phase is meant to take at most (reported)
MESH_BUDGET_S = 60.0
# the LM serving path (launch.serve.BatchedServer over models/):
# mistral-nemo-12b at full width and depth, weights drawn on the card from
# a seeded generator in bfloat16; 4 requests on 2 slots, prompts drawn
# with np.random.default_rng(0).  4096 >= flash_block_threshold and a
# multiple of both chunks, so that prompt runs attend_chunked; the others
# attend_full
LM_ARCH = "mistral-nemo-12b"
LM_PROMPTS = (4096, 1024, 512, 37)
LM_MAX_NEW = 16
LM_SLOTS = 2
LM_MAX_LEN = 4112
LM_SEED = 0
# prefill/decode consistency: tests/test_models.py:71-106's batch, tokens,
# prompt and atol = rtol, at full width with 2 layers (a check) and at 40
# (printed)
LM_CONSISTENCY = {"layers": 2, "batch": 2, "tokens": 12, "prompt": 8,
                  "tol": 2e-2}
# the card against CPU tensors: a smoke config in float32, the same
# carried-across weights, prefill and decode logits within atol = rtol
LM_CPU_TOL = 1e-4
# bfloat16 logits against float32 logits of the same weights (full width,
# 2 layers): rms(bf16 - f32) / rms(f32) at most this (PERF.md: twice the
# 0.0097 read on the CPU at a quarter and an eighth of the width)
LM_BF16_REL_RMS = 0.02
# timed calls of a prefill and of a decode step (CUDA events)
LM_PREFILL_REPS = 3
LM_DECODE_REPS = 20
# the time the LM phase is meant to take at most (reported)
LM_BUDGET_S = 120.0
# the LM families beside the decoders (lm_families, right after lm_path):
# (arch, layers kept or None for all, prompts), each at full width,
# served as lm_path serves nemo, one model at a time; arctic-480b keeps 2
# of its 35 layers (35 are 953.7 GB in bfloat16, the card holds 80)
LM_FAMILIES = (("deepseek-moe-16b", None, LM_PROMPTS),
               ("arctic-480b", 2, (1024, 37)),
               ("xlstm-125m", None, LM_PROMPTS),
               ("zamba2-2.7b", None, LM_PROMPTS),
               ("seamless-m4t-large-v2", None, LM_PROMPTS))
# the time the families' phase is meant to take at most (reported)
LM_FAMILIES_BUDGET_S = 240.0
# the families' consistency check runs in float32 (bfloat16 is printed
# beside it: the reference's own bfloat16 misses 2e-2 at full width on
# xlstm-125m at 4 layers, 0.082, and zamba2-2.7b at 6, 0.0625, where its
# float32 gives 2.2e-5 and 1.2e-5; PERF.md); its weights, drawn anew,
# at most this many bytes (else one repetition of the unit)
LM_F32_CHECK_BYTES = 60e9
# the training path (train_path, right after lm_families): olmo-1b at full
# width and depth (configs/olmo_1b.py: float32 parameters and moments,
# bf16 compute, remat "full"), batches of 8 sequences of 2048 tokens (its
# context) from launch.train.build_batch_fn; a warm-up step, then
# TRAIN_STEPS steps timed one by one (CUDA events), one more under
# torch.profiler
TRAIN_ARCH = "olmo-1b"
TRAIN_BATCH, TRAIN_SEQ = 8, 2048
TRAIN_STEPS = 3
TRAIN_SEED = 0
# OLMo-1B's peak learning rate (arXiv:2402.00838, 4e-4) reached over 10
# steps (at 1e-3 reached in 2 steps the loss rose to 15.4 at the fourth
# step on an H100: PERF.md §6)
TRAIN_OPT = OptConfig(peak_lr=4e-4, warmup_steps=10, decay_steps=100)
# AdamW's bytes a parameter: the parameter, its gradient and both
# moments read, the parameter and both moments written, float32 each
ADAMW_BYTES_A_PARAM = 7 * 4
# the checks at 2 of olmo-1b's 16 layers (full width): remat "full"
# against "none" and grad_accum 2 against 1 at the timed batch's shape;
# the recovery and resume runs (TRAIN_CHECK_STEPS steps, checkpoints on
# local disk every TRAIN_CHECKPOINT_EVERY, faults before the steps of
# TRAIN_FAIL_AT) at batches of 2 x 512
TRAIN_CHECK_LAYERS = 2
TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 512
TRAIN_CHECK_STEPS = 6
TRAIN_CHECKPOINT_EVERY = 2
TRAIN_FAIL_AT = (3, 5)
# grad_accum=2 against grad_accum=1 on the card (bf16 compute): the loss
# and grad_norm at these relative limits, the parameters at the
# reference's own test_grad_accum_matches_full_batch limits.  The card
# showed a loss equal bit for bit, grad norms 1.8e-5 apart and parameters
# 7.9e-5 apart (AdamW's first update, lr 4e-5, is g/|g|: one coordinate's
# sign, 2 lr); with the embedding's gradient summed in bfloat16, as the
# reference's scatter-add sums it, the grad norms were 1.45e-2 apart
# (H100 80GB HBM3, 700 W; PERF.md §6)
TRAIN_ACCUM_TOL = {"loss_rtol": 1e-5, "grad_norm_rtol": 1e-4,
                   "param_atol": 2e-3, "param_rtol": 1e-2}
# the card against CPU tensors, one step of every arch's smoke config in
# float32 from one carried-across state: the CPU tests' limits
# (tests/test_torch_train_step.py)
TRAIN_CPU_TOL = {"loss_rtol": 1e-5, "grad_norm_rtol": 1e-4,
                 "param_atol": 2e-3, "param_rtol": 1e-2}
# the time the training phase is meant to take at most (reported)
TRAIN_BUDGET_S = 120.0
# the LM on a mesh (lm_mesh, right after train_path): a 1-rank mesh of
# LM_MESH_BACKEND in this process (olmo-1b's train step as train_path
# runs it; nemo's serving config prefilling LM_MESH_NEMO_PROMPT tokens
# and decoding LM_MESH_NEMO_NEW), then LM_MESH_RANKS gloo ranks sharing
# the card on make_host_mesh(LM_MESH_TP), full width, LM_MESH_LAYERS
# layers, float32 (LM_MESH_CASES: arch, profile, what runs, train
# steps).  The collectives are host-staged gloo (~0.3 GB/s on an H100
# 80GB HBM3 at 700 W): olmo's fsdp step moves 3.5 GB, deepseek's ep step
# 2.9 GB, an ep forward 0.5 GB (PERF.md §6), so the steps and decodes are
# few
LM_MESH_BACKEND = "nccl"
LM_MESH_NEMO_PROMPT, LM_MESH_NEMO_NEW = 4096, 16
LM_MESH_RANKS, LM_MESH_TP, LM_MESH_LAYERS = 4, 2, 2
LM_MESH_TRAIN_BATCH, LM_MESH_TRAIN_SEQ = 4, 256
LM_MESH_SERVE_BATCH, LM_MESH_PROMPT, LM_MESH_NEW = 2, 512, 2
LM_MESH_CASES = (("olmo-1b", "fsdp", ("train",), 2),
                 ("olmo-1b", "tp", ("train",), 2),
                 ("mistral-nemo-12b", "tp", ("serve",), 0),
                 ("deepseek-moe-16b", "ep", ("train", "serve"), 1))
# logits of a mesh against no mesh in float32: the CPU tests' limit
# (tests/test_torch_lm_mesh.py)
LM_MESH_LOGITS_TOL = 1e-4
# the gloo ranks' train steps run the CPU tests' optimizer (AdamW's eps at
# 1e-4, so that its first update g / (|g| + eps) is well conditioned, and
# the whole lr from the first step) and are held to their limits; on top,
# each leaf's change over the steps against the mesh-less change:
# max |d_mesh - d_plain| <= LM_MESH_STEP_RTOL * max |d_plain|, which an
# update skipped or scaled wrongly (a clip scale that differs between the
# ranks) misses by a ratio near 1
LM_MESH_OPT = OptConfig(peak_lr=1e-3, warmup_steps=1, decay_steps=10,
                        eps=1e-4)
LM_MESH_TOL = {"loss_rtol": 1e-4, "grad_norm_rtol": 1e-4,
               "param_atol": 1e-4, "param_rtol": 1e-4}
LM_MESH_STEP_RTOL = 1e-2
LM_MESH_BUDGET_S = 120.0
# the roofline path (roofline_path, inside train_path on its olmo-1b
# state): the train step priced op by op on meta tensors
# (roofline.op_cost, as launch.dryrun prices a rank) and run once on the
# card under the same counting mode, which must see the same ops, FLOPs
# and bytes; the same for one decode step of LM_ARCH against
# LM_PROMPTS[0] positions (timed over ROOFLINE_DECODE_REPS calls); each
# traced peak against the card's max_memory_allocated within
# ROOFLINE_PEAK_RTOL (the bytes resident beside the step's arguments
# added); then the contour-cc cell on a 1-rank mesh at the main path's
# rmat n and m, whose round must equal K1 + K7 + K6's entries of the
# kernels line
ROOFLINE_PEAK_RTOL = 0.10
ROOFLINE_DECODE_REPS = 10
ROOFLINE_BUDGET_S = 60.0
# kernel against plain version in float32, (atol, rtol, rms_rel) by working
# type: every element within |a - b| <= atol + rtol * |b|, and the whole
# output within rms(a - b) <= rms_rel * rms(b).  Both versions compute in
# float32 and round once to the working type, so a sound kernel differs
# from its plain version where the two float32 results straddle a
# rounding boundary, by one unit in the last place (at most 2**-7 * |b|
# in bfloat16, inside rtol).  rms_rel holds the output as a whole: a fault
# of a few thousandths on every element (a key tile skipped, products
# rounded to bfloat16) stays inside each element's bound where attention's
# outputs are small (|o| ~ 0.03 at S = 4096) but not inside rms_rel.
# Readings and a faulty kernel held to these limits: PERF.md
# float16's limits are tighter than bfloat16's: it keeps three more bits
# (one unit in its last place is at most 2**-10 |b|, inside rtol = 2e-3),
# and its split P leaves ~1e-5 of rms(b) in attention (the CPU replay,
# tests/test_torch_flash_replay.py), where one float16 P leaves ~2.6e-4,
# past rms_rel = 1e-4.
RMS_TOL = {torch.bfloat16: (1e-2, 1e-2, 5e-4),
           torch.float16: (1e-3, 2e-3, 1e-4),
           torch.float32: (1e-5, 1e-5, 1e-5)}
FLASH_TOL = {torch.bfloat16: (4e-3, 1e-2, 5e-4),
             torch.float16: (1e-3, 2e-3, 1e-4),
             torch.float32: (1e-5, 1e-4, 1e-5)}

REPLACES = {
    "fused_relax": "src/repro/kernels/contour_mm/blocked.py:236 "
                   "(fused_relax_pallas)",
    "scatter_min": "src/repro/kernels/contour_mm/blocked.py:92 "
                   "(binned_scatter_min_pallas)",
    "mm2": "src/repro/kernels/contour_mm/kernel.py:53 (mm2_pallas)",
    # no Pallas counterpart: XLA inside the reference's lax.while_loop
    # (src/repro/connectivity/contour.py:244)
    "converged_early": "src/repro/connectivity/minmap.py:88 "
                       "(converged_early; no Pallas counterpart, XLA-fused "
                       "in the reference's loop)",
    "labels_unchanged": "src/repro/connectivity/contour.py:238 "
                        "(jnp.all(L_new == L), also fastsv.py:61 and "
                        "lp.py:42; no Pallas counterpart, XLA-fused)",
    "pointer_jump": "src/repro/connectivity/minmap.py:75 (pointer_jump; no "
                    "Pallas counterpart, XLA-fused in the reference's loop)",
    "rmsnorm_rows": "src/repro/kernels/fused_rmsnorm/kernel.py:31 "
                    "(rmsnorm_rows)",
    "flash_mha": "src/repro/kernels/flash_attention/kernel.py:77 "
                 "(flash_mha)",
    # the fleet's entry points: the same TPU kernels and XLA steps, which
    # the reference's solve_batch runs under jax.vmap
    # (src/repro/connectivity/batch.py:109)
    "fused_relax_batched": "src/repro/kernels/contour_mm/blocked.py:236 "
                           "(fused_relax_pallas, vmapped by solve_batch)",
    "scatter_min_batched": "src/repro/kernels/contour_mm/blocked.py:92 "
                           "(binned_scatter_min_pallas, vmapped by "
                           "solve_batch)",
    "converged_early_batched": "src/repro/connectivity/minmap.py:88 "
                               "(converged_early, vmapped by solve_batch; "
                               "no Pallas counterpart, XLA-fused)",
    "labels_unchanged_batched": "src/repro/connectivity/contour.py:238 "
                                "(jnp.all(L_new == L), vmapped by "
                                "solve_batch; no Pallas counterpart)",
    "pointer_jump_batched": "src/repro/connectivity/minmap.py:75 "
                            "(pointer_jump, vmapped by solve_batch; no "
                            "Pallas counterpart)",
}
SOURCE = "src/repro_torch/kernels/contour_mm/csrc/contour_mm.cu"
MM2_SOURCE = "src/repro_torch/kernels/contour_mm/csrc/mm2.cu"
CONVERGED_SOURCE = "src/repro_torch/kernels/contour_mm/csrc/converged.cu"
FLEET_SOURCE = "src/repro_torch/kernels/contour_mm/csrc/fleet.cu"
RMSNORM_SOURCE = "src/repro_torch/kernels/fused_rmsnorm/csrc/rmsnorm.cu"
FLASH_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                "flash_attention.cu")
# (library, its module) for every kernel library of the port
LIBRARIES = ((blocked.LIBRARY, blocked), (kernel.LIBRARY, kernel),
             (cv.LIBRARY, cv), (fleet.LIBRARY, fleet),
             (rms_kernel.LIBRARY, rms_kernel),
             (flash_kernel.LIBRARY, flash_kernel))
# every kernel wrapper of the port, by name; each counts its launches
WRAPPERS = {"fused_relax": blocked.fused_relax,
            "scatter_min": blocked.scatter_min, "mm2": kernel.mm2,
            "converged_early": cv.converged_early,
            "labels_unchanged": cv.labels_unchanged,
            "pointer_jump": cv.pointer_jump,
            "rmsnorm_rows": rms_kernel.rmsnorm_rows,
            "flash_mha": flash_kernel.flash_mha,
            "fused_relax_batched": blocked.fused_relax_batched,
            "scatter_min_batched": blocked.scatter_min_batched,
            "converged_early_batched": cv.converged_early_batched,
            "labels_unchanged_batched": cv.labels_unchanged_batched,
            "pointer_jump_batched": cv.pointer_jump_batched}
KERNEL_NAMES = tuple(WRAPPERS)
# the fleet's entry points with two routes (fleet.fleet_route), each
# counted on its own
ROUTED = ("fused_relax_batched", "converged_early_batched",
          "scatter_min_batched", "pointer_jump_batched")
ROUTES = ("lane", "global")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Mean device time of ``fn()`` over ``REPS`` calls (CUDA events).

    The card first spins for ``HOLD_CYCLES`` so that the host enqueues the
    calls ahead of it: a kernel shorter than its call's host time is then
    timed on the card alone, not at the host's pace."""
    for _ in range(2):
        fn()
    sync()
    torch.cuda._sleep(HOLD_CYCLES * REPS)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / REPS


def time_each_ms(fn, setup=None) -> float:
    """Mean device time of ``fn()`` alone over ``REPS`` calls, each between
    its own pair of CUDA events, with ``setup()`` (untimed) before each;
    the card spins before each setup, as in :func:`time_ms`, and once
    for all the calls before the first, so that the host has enqueued
    each call when its first event is reached (a spin a call alone let a
    wrapper's host time reach into the window of a call shorter than
    it)."""
    for _ in range(2):
        if setup is not None:
            setup()
        fn()
    sync()
    pairs = []
    torch.cuda._sleep(HOLD_CYCLES * REPS)
    for _ in range(REPS):
        torch.cuda._sleep(HOLD_CYCLES)
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    sync()
    return sum(s.elapsed_time(e) for s, e in pairs) / REPS


_flush = []


def flush_l2() -> None:
    """Write a buffer of four times the card's L2, so that the next call
    reads its inputs from HBM, as it does inside a solve, where the sweep
    between two calls streams the edges through L2."""
    if not _flush:
        l2 = torch.cuda.get_device_properties(0).L2_cache_size
        _flush.append(torch.empty(l2, dtype=torch.int32, device=DEVICE))
    _flush[0].fill_(0)


def host_ms(fn) -> float:
    """Mean host-clock time of ``fn()`` to ``synchronize()``, ``REPS``
    calls."""
    for _ in range(2):
        fn()
    sync()
    total = 0.0
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        sync()
        total += time.perf_counter() - t0
    return total / REPS * 1e3


def torch_backend_warm_ms(run) -> float:
    """Mean host-clock time of ``run(backend="torch")`` to
    ``synchronize()``, ``PLAIN_FLEET_REPS`` calls (the caller has made
    the cold call)."""
    sync()
    t0 = time.perf_counter()
    for _ in range(PLAIN_FLEET_REPS):
        run(backend="torch")
        sync()
    return (time.perf_counter() - t0) / PLAIN_FLEET_REPS * 1e3


def raises(fn, error) -> bool:
    try:
        fn()
    except error:
        return True
    return False


def bound(bytes_moved: int, ops: int, rate: float = ALU_OPS_PER_S) -> dict:
    """The least time of the work: bytes over the HBM rate against
    operations over ``rate``."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_moved, "ops": ops}


def launch_counts() -> dict:
    return {name: WRAPPERS[name].launches for name in KERNEL_NAMES}


def reset_launch_counts() -> None:
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    for name in ROUTED:
        WRAPPERS[name].routes.update(dict.fromkeys(ROUTES, 0))


def route_counts() -> dict:
    """The launches of each route of the fleet's routed entry points."""
    return {name: dict(WRAPPERS[name].routes) for name in ROUTED}


def host_syncs(fn) -> dict:
    """Synchronizing operations in one call of ``fn``, as torch's sync
    debug mode flags them (the device-to-host reads of a solve): the
    total, and the count at each source line that made one, named by the
    innermost frame of the port's package (or of this script) on the
    stack at the time."""
    sites = Counter()
    ours = (str(ROOT / "src" / "repro_torch"), str(ROOT / "chip_smoke.py"))

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        for frame in reversed(traceback.extract_stack()[:-1]):
            if frame.filename.startswith(ours):
                filename, lineno = frame.filename, frame.lineno
                break
        sites[f"{Path(filename).name}:{lineno}"] += 1

    sync()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sync()
    return {"total": sum(sites.values()), "sites": dict(sites)}


def plain_solve(g, **options):
    """``solve(g, backend="torch", **options)``, the plain reference: it
    must launch no kernel (the counts are read around it and set to 0
    again after)."""
    reset_launch_counts()
    res = solve(g, backend="torch", **options)
    launched = {k: v for k, v in launch_counts().items() if v}
    reset_launch_counts()
    if launched:
        raise AssertionError(f"the torch backend launched kernels: "
                             f"{launched}")
    return res


def cpu_copy(g) -> Graph:
    return Graph(src=g.src.cpu(), dst=g.dst.cpu(), n_vertices=g.n_vertices)


def same_result(a, b, what: str) -> None:
    """Labels, iterations, converged and edges_visited, bit for bit."""
    for field in ("labels", "iterations", "converged", "edges_visited"):
        if not torch.equal(getattr(a, field).cpu(), getattr(b, field).cpu()):
            raise AssertionError(f"{what}: {field} differs")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def c2_states(g, count: int):
    """Identity labels and the first ``count`` C-2 iterations' labels."""
    L = torch.arange(g.n_vertices, dtype=torch.int32, device=g.device)
    states = [L]
    for _ in range(count):
        L = minmap.pointer_jump(minmap.mm_relax(L, g.src, g.dst, 2))
        states.append(L)
    return states


def scipy_labels(g) -> np.ndarray:
    """Min-vertex-id component labels from scipy's connected_components."""
    return scipy_labels_of(*g.to_numpy())


def scipy_labels_of(s: np.ndarray, d: np.ndarray, n: int) -> np.ndarray:
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    adj = coo_matrix((np.ones(len(s), np.int8), (s, d)), shape=(n, n))
    _, lab = connected_components(adj.tocsr(), directed=False)
    _, first = np.unique(lab, return_index=True)  # min id per component
    return first[lab].astype(np.int32)


def live_pairs(L, src, dst) -> int:
    """(edge, target) pairs of a fused sweep that can lower their label:
    the atomics a kernel with one atomic per such pair issues."""
    ls, ld = L[src], L[dst]
    l2s, l2d = L[ls], L[ld]
    z = torch.minimum(l2s, l2d)
    return int((z < ls).sum() + (z < ld).sum() + (z < l2s).sum()
               + (z < l2d).sum())


def sweep_checks(graphs: dict) -> dict:
    """K1 and K2 against their plain versions, and the card's red counts
    against the replays', on small graphs.

    On every graph and state: ``fused_relax`` at edge limits None, 0, 1,
    31, 33 and m // 2, on the edge list and on ``src[1:]``, ``dst[1:]``
    (a base 4 bytes past a 16-byte boundary); ``scatter_min`` on the
    order-1 stream, whole and from its second update, with and without a
    ``valid`` mask.  The counts that depend only on the input (updates
    before the test of the output label, hot slots) must equal the
    replays' exactly; the updates are printed per item beside the
    one-atomic-per-live-update count of the kernels that came before."""
    err = {"fused_relax": 0, "scatter_min": 0}
    checks, counts = 0, {}
    for name, g in graphs.items():
        rows = []
        for i, L in enumerate(c2_states(g, 3)):
            row = {"state": i}
            m = g.n_edges
            for off in (0, 1):
                src, dst = g.src[off:], g.dst[off:]
                for limit in (None, 0, 1, 31, 33, (m - off) // 2):
                    a, c = blocked.fused_relax_sweep(L, src, dst, limit,
                                                     counts=True)
                    b = blocked.fused_relax_plain(L, src, dst, limit)
                    _, want = blocked.fused_relax_combined_replay(
                        L, src, dst, limit)
                    err["fused_relax"] = max(err["fused_relax"],
                                             max_abs_err(a, b))
                    if {key: c[key] for key in want} != want:
                        raise AssertionError(
                            f"fused_relax on {name}, state {i}, offset "
                            f"{off}, limit {limit}: {c} on the card, "
                            f"{want} in the replay")
                    checks += 1
                    if off == 0 and limit is None:
                        row["fused_reds_per_edge"] = \
                            want["reds_before_test"] / m
                        row["fused_hot_slots"] = want["hot_slots"]
                        row["fused_old_per_edge"] = live_pairs(
                            L, g.src, g.dst) / m
            t, v = minmap.mm_update_stream(L, g.src, g.dst, 1)
            valid = torch.arange(t.shape[0], device=t.device) % 3 > 0
            for off in (0, 1):
                for vd in (None, valid[off:]):
                    a, c = blocked.scatter_min_sweep(L, t[off:], v[off:], vd,
                                                     counts=True)
                    b = blocked.scatter_min_plain(L, t[off:], v[off:], vd)
                    _, want = blocked.scatter_min_combined_replay(
                        L, t[off:], v[off:], vd)
                    err["scatter_min"] = max(err["scatter_min"],
                                             max_abs_err(a, b))
                    if {key: c[key] for key in want} != want:
                        raise AssertionError(
                            f"scatter_min on {name}, state {i}: {c} on the "
                            f"card, {want} in the replay")
                    checks += 1
                    if off == 0 and vd is None:
                        k = t.shape[0]
                        row["scatter_reds_per_update"] = \
                            want["reds_before_test"] / k
                        row["scatter_hot_slots"] = want["hot_slots"]
                        row["scatter_old_per_update"] = int(
                            (v < L[t]).sum()) / k
            rows.append(row)
        counts[name] = rows
    sync()
    return {"err": err, "checks": checks, "red_counts": counts}


def per_item(counts: dict, items: int) -> dict:
    """A kernel's counts (``blocked.COUNTERS``) per item; hot slots as
    they are."""
    return {key: (value if key == "hot_slots" else value / items)
            for key, value in counts.items()}


def sweep_times(name, g) -> list:
    """K1 and K2 in each of the four ``c2_states`` at the main path's
    size, as the main path calls them (no wait for the range flag): device
    ms, and per item the counts of ``blocked.COUNTERS`` beside the live
    (target, condition) pairs, each an atomic in the kernels that came
    before the dedupe, the test and the combine."""
    rows = []
    for i, L in enumerate(c2_states(g, 3)):
        t, v = minmap.mm_update_stream(L, g.src, g.dst, 1)
        _, fc = blocked.fused_relax_sweep(L, g.src, g.dst, counts=True)
        _, sc = blocked.scatter_min_sweep(L, t, v, counts=True)
        rows.append({
            "state": i,
            "fused_relax_ms": time_ms(lambda: blocked.fused_relax(
                L, g.src, g.dst, check=False)),
            "scatter_min_ms": time_ms(lambda: blocked.scatter_min(
                L, t, v, check=False)),
            "fused_per_edge": per_item(fc, g.n_edges),
            "fused_old_per_edge": live_pairs(L, g.src, g.dst) / g.n_edges,
            "scatter_per_update": per_item(sc, t.shape[0]),
            "scatter_old_per_update": int((v < L[t]).sum()) / t.shape[0],
        })
        del t, v
    emit({"phase": "sweep_states", "graph": name, "states": rows})
    return rows


def phase_kernels(full: dict, star, small: dict) -> dict:
    """Phase 3: each sweep kernel against its plain version, then its
    times at the main path's sizes.

    ``full`` maps names to the main path's graphs, rmat first: the checks
    and the kernels line's times are on it, the times in every state on
    each.  ``small`` maps names to the graphs of :func:`sweep_checks`."""
    g = next(iter(full.values()))
    states = c2_states(g, 3)
    m = g.n_edges
    err = {"fused_relax": 0, "scatter_min": 0}
    checks = 0
    gen_ = torch.Generator(device=g.device).manual_seed(0)
    for L in states:
        for limit in (None, m // 2):
            a = blocked.fused_relax(L, g.src, g.dst, edge_limit=limit)
            b = blocked.fused_relax_plain(L, g.src, g.dst, limit)
            sync()
            err["fused_relax"] = max(err["fused_relax"], max_abs_err(a, b))
            checks += 1
        for order in (1, 2, 3):
            t, v = minmap.mm_update_stream(L, g.src, g.dst, order)
            valid = torch.rand(t.shape, device=g.device, generator=gen_) < 0.5
            for vd in (None, valid):
                a = blocked.scatter_min(L, t, v, vd)
                b = blocked.scatter_min_plain(L, t, v, vd)
                sync()
                err["scatter_min"] = max(err["scatter_min"],
                                         max_abs_err(a, b))
                checks += 1
            del t, v, valid
    # hub contention: every spoke's update lands on one vertex
    sL = torch.arange(star.n_vertices, dtype=torch.int32, device=g.device)
    st, sv = minmap.mm_update_stream(sL, star.src, star.dst, 2)
    for name, a, b in (
            ("scatter_min", blocked.scatter_min(sL, st, sv),
             blocked.scatter_min_plain(sL, st, sv)),
            ("fused_relax", blocked.fused_relax(sL, star.src, star.dst),
             blocked.fused_relax_plain(sL, star.src, star.dst))):
        sync()
        err[name] = max(err[name], max_abs_err(a, b))
        checks += 1
    # the small graphs, slices and edge limits, with the red counts
    small_checks = sweep_checks(small)
    checks += small_checks["checks"]
    for name in err:
        err[name] = max(err[name], small_checks["err"][name])
    if any(err.values()):
        raise AssertionError(f"kernel differs from its plain version: {err}")
    # one endpoint outside [0, n): each kernel raises IndexError
    bad = g.src.clone()
    bad[m // 2] = g.n_vertices
    for call in (lambda: blocked.fused_relax(states[0], bad, g.dst),
                 lambda: blocked.scatter_min(states[0], bad, g.dst)):
        if not raises(call, IndexError):
            raise AssertionError("a kernel took an id outside [0, n)")
        checks += 1
    del bad

    # times at the main path's shapes: the first sweep (identity labels);
    # order 2 for fused_relax (every C-2 sweep), order 1 for scatter_min
    # (C-11mm's warm-up sweeps); called as the main path calls them,
    # without waiting for the range flag; then every state of both graphs
    L0 = states[0]
    n = g.n_vertices
    t1, v1 = minmap.mm_update_stream(L0, g.src, g.dst, 1)
    t1_long = t1.long()
    k = int(t1.shape[0])
    fused = {
        "name": "fused_relax", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["fused_relax"],
        "max_abs_err": err["fused_relax"],
        "ms": time_ms(
            lambda: blocked.fused_relax(L0, g.src, g.dst, check=False)),
        "plain_ms": time_ms(
            lambda: blocked.fused_relax_plain(L0, g.src, g.dst)),
        "library_ms": None,
        "shape": {"n": n, "m": m},
        # read L, src, dst once, write L_out once; per edge one min for z
        # and four compares against the gathered labels
        **bound(*blocked.fused_relax_work(n, m)),
    }
    scatter = {
        "name": "scatter_min", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["scatter_min"],
        "max_abs_err": err["scatter_min"],
        "ms": time_ms(
            lambda: blocked.scatter_min(L0, t1, v1, check=False)),
        "plain_ms": time_ms(lambda: blocked.scatter_min_plain(L0, t1, v1)),
        "library_ms": time_ms(
            lambda: L0.scatter_reduce(0, t1_long, v1, "amin")),
        "shape": {"n": n, "updates": k, "order": 1},
        # read L, targets, values once, write L_out once; one compare per
        # update
        **bound(4 * n + 8 * k + 4 * n, k),
    }
    del t1, v1, t1_long
    per_state = {name: sweep_times(name, graph)
                 for name, graph in full.items()}
    for entry, key in ((fused, "fused_relax_ms"), (scatter, "scatter_min_ms")):
        entry["ms_by_state"] = {name: [r[key] for r in rows]
                                for name, rows in per_state.items()}
    sk = int(st.shape[0])
    _, fc = blocked.fused_relax_sweep(sL, star.src, star.dst, counts=True)
    _, sc = blocked.scatter_min_sweep(sL, st, sv, counts=True)
    hub = {
        "graph": f"star({star.n_vertices})", "updates": sk,
        "scatter_min_ms": time_ms(
            lambda: blocked.scatter_min(sL, st, sv, check=False)),
        "scatter_reduce_ms": time_ms(
            lambda: sL.scatter_reduce(0, st.long(), sv, "amin")),
        "fused_relax_ms": time_ms(
            lambda: blocked.fused_relax(sL, star.src, star.dst, check=False)),
        "scatter_per_update": per_item(sc, sk),
        "scatter_old_per_update": int((sv < sL[st]).sum()) / sk,
        "fused_per_edge": per_item(fc, star.n_edges),
        "fused_old_per_edge": live_pairs(sL, star.src, star.dst)
        / star.n_edges,
        **bound(8 * star.n_vertices + 8 * sk, sk),
    }
    hub["scatter_min_x_bound"] = hub["scatter_min_ms"] / hub["bound_ms"]
    emit({"phase": "kernels_vs_plain", "checks": checks,
          "states": len(states), "fused_relax": fused,
          "scatter_min": scatter, "red_counts": small_checks["red_counts"],
          "hub_contention": hub})
    emit({"phase": "contour_hopper", **contour_hopper()})
    return {"fused_relax": fused, "scatter_min": scatter}


def contour_hopper() -> dict:
    """What shows the sweep kernels' design in their SASS on sm_90: the
    warp combine (``MATCH``, and ``REDUX`` for the group's minimum), and
    reds whose result is unused (``REDG``, no ``ATOMG``); raises unless
    both kernels have all three and neither has ``ATOMG``."""
    library = _build.library_path(blocked.LIBRARY, blocked.SOURCES)
    ops = ("MATCH", "REDUX", "REDG", "ATOMG")
    sass = {}
    for name in ("fused_relax_kernel", "scatter_min_kernel"):
        found = sass_counts(library, name, ops)
        if len(found) != 1:
            raise AssertionError(f"{name}: {len(found)} functions in the "
                                 "SASS")
        sass[name] = counts = next(iter(found.values()))
        if not all(counts[op] for op in ops[:3]) or counts["ATOMG"]:
            raise AssertionError(f"{name}'s SASS lacks MATCH, REDUX or "
                                 f"REDG, or issues ATOMG: {counts}")
    return {"sass": sass}


def phase_mm2(small, full) -> dict:
    """Phase 3b: ``mm2`` against ``mm2_plain``, then its times.

    ``small`` and ``full`` map names to graphs.  On the small ones:
    identity labels and one mid-run state, with and without
    ``edge_limit``, in the edge order and reversed; on the unshuffled path
    and the star also at tiny window, depth and cache sizes
    (``MM2_TINY``), where the cache's evictions, the window check's
    refusals and the slow path all fire; an endpoint outside ``[0, n)``
    must raise.
    On the full-size ones (the async path's): the first sweep, where the
    plain Python loop takes seconds, then ``ASYNC_REPS`` timed launches,
    and one launch that counts where the consumer's label reads came
    from, per edge.
    """
    err, checks = 0, 0
    for name, g in small.items():
        sizes = [None] + (MM2_TINY if name in MM2_TINY_ON else [])
        for L in c2_states(g, 1):
            for src, dst in ((g.src, g.dst), (g.src.flip(0), g.dst.flip(0))):
                for limit in (None, g.n_edges // 2 + 1):
                    b = kernel.mm2_plain(L, src, dst, limit)
                    for size in sizes:
                        if size is None:
                            a = kernel.mm2(L, src, dst, edge_limit=limit)
                        else:
                            a = kernel.sweep(L, src, dst, limit,
                                             window=size[0], depth=size[1],
                                             cache_slots=size[2])
                        sync()
                        err = max(err, max_abs_err(a, b))
                        checks += 1
    g = next(iter(small.values()))
    bad = g.src.clone()
    bad[g.n_edges // 2] = g.n_vertices
    L0 = torch.arange(g.n_vertices, dtype=torch.int32, device=g.device)
    if not raises(lambda: kernel.mm2(L0, bad, g.dst), IndexError):
        raise AssertionError("mm2 took an id outside [0, n)")
    checks += 1
    shapes = {}
    for name, g in full.items():
        L0 = torch.arange(g.n_vertices, dtype=torch.int32, device=g.device)
        a = kernel.mm2(L0, g.src, g.dst, check=False)
        sync()
        t0 = time.perf_counter()
        b = kernel.mm2_plain(L0, g.src, g.dst)
        sync()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max(err, max_abs_err(a, b))
        checks += 1
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ASYNC_REPS):
            kernel.mm2(L0, g.src, g.dst, check=False)
        end.record()
        sync()
        c, counts = kernel.sweep(L0, g.src, g.dst, counts=True)
        err = max(err, max_abs_err(c, b))
        checks += 1
        n, m = g.n_vertices, g.n_edges
        ms = start.elapsed_time(end) / ASYNC_REPS
        shapes[name] = {
            "shape": {"n": n, "m": m}, "plain_ms": plain_ms, "ms": ms,
            "us_per_edge": ms * 1e3 / m,
            "per_edge": {k: v / m for k, v in counts.items()},
            # read src, dst and L once, write L once; per edge one min for
            # z and four compares
            **bound(8 * m + 8 * n, 5 * m),
        }
        del a, b, c
    if err:
        raise AssertionError(f"mm2 differs from mm2_plain: {err}")
    emit({"phase": "mm2_vs_plain", "checks": checks, "max_abs_err": err,
          "sizes": {"window": kernel.WINDOW, "depth": kernel.DEPTH,
                    "cache_slots": kernel.CACHE_SLOTS, "tiny": MM2_TINY},
          "full_size": shapes})
    first = next(iter(shapes.values()))
    return {"name": "mm2", "route": "cuda", "source": MM2_SOURCE,
            "replaces": REPLACES["mm2"], "max_abs_err": err,
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            # no PyTorch call computes an in-order sequential sweep
            "library_ms": None, "shape": first["shape"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "bytes": first["bytes"], "ops": first["ops"],
            "us_per_edge": first["us_per_edge"],
            "per_edge": first["per_edge"]}


def iteration_parts(g, L) -> dict:
    """Device ms of each step of one C-2 iteration at labels ``L``, as the
    loop enqueues them: the sweep, the jump round and the test that does
    the loop's step (a fresh state before each, untimed); the plain test
    beside it; and a whole iteration enqueued past the fixed point (the
    done word set: the sweep returns, the jump copies, the test skips).
    The jump round is timed with L2 flushed before each call, as the
    sweep before it leaves L2 in the loop."""
    state = cv.loop_state(g.device)
    done = cv.done_word(state)

    def iteration():
        L1 = blocked.fused_relax(L, g.src, g.dst, check=False, done=done)
        L1 = cv.pointer_jump(L1, done)
        cv.converged_early(L1, g.src, g.dst, state=state)

    out = {
        "fused_relax_ms": time_ms(
            lambda: blocked.fused_relax(L, g.src, g.dst, check=False)),
        "pointer_jump_ms": time_each_ms(lambda: cv.pointer_jump(L),
                                        setup=flush_l2),
        "converged_early_ms": time_each_ms(
            lambda: cv.converged_early(L, g.src, g.dst, state=state),
            setup=state.zero_),
        "converged_early_plain_ms": time_ms(
            lambda: cv.converged_early_plain(L, g.src, g.dst)),
    }
    state.fill_(0)
    done.fill_(1)
    out["frozen_iteration_ms"] = time_ms(iteration)
    return out


def replay(g, iters: int, labels=None):
    """The dense C-2 loop's device work for ``iters`` iterations with no
    host read: per iteration the sweep, the jump round and the test with
    the loop's step, then the final jump."""
    L = (torch.arange(g.n_vertices, dtype=torch.int32, device=g.device)
         if labels is None else labels)
    state = cv.loop_state(g.device)
    done = cv.done_word(state)
    for _ in range(iters):
        L = ops.mm_relax_backend(L, g.src, g.dst, order=2, backend="cuda",
                                 done=done)
        L = cv.pointer_jump(L, done)
        cv.converged_early(L, g.src, g.dst, state=state)
    return cv.pointer_jump(L)


def loop_cost(g, res) -> dict:
    """A warm C-2 solve against the same device work with no host read.

    :func:`replay` enqueues the solve's iterations back to back.  The
    difference in host-clock time is what the loop's reads of its state
    (one a chunk) and the facade's host work add, beside the iterations
    enqueued past the fixed point.  The replay's device time bounds the
    solve's busy time from above, so ``1 - replay_device_ms / solve_ms``
    bounds the device's idle share inside the solve from below.
    """
    iters = int(res.iterations)
    if not torch.equal(replay(g, iters), res.labels):
        raise AssertionError("the replay does not repeat the solve")
    solve_ms = host_ms(lambda: solve(g))
    replay_ms = host_ms(lambda: replay(g, iters))
    replay_device_ms = time_ms(lambda: replay(g, iters))
    return {"iterations": iters, "chunk": cv.CHUNK, "solve_ms": solve_ms,
            "replay_ms": replay_ms, "replay_device_ms": replay_device_ms,
            "host_reads_ms": solve_ms - replay_ms,
            "host_reads_ms_per_iteration": (solve_ms - replay_ms) / iters,
            "idle_share_at_least": 1 - replay_device_ms / solve_ms}


def chunk_sweep(g, iterations: int) -> dict:
    """The warm C-2 solve at each chunk size k (``converged.CHUNK``):
    host-clock ms (mean of ``REPS``), host syncs, and the reads of the
    loop's state, which must be ceil(iterations / k)."""
    shipped = cv.CHUNK
    out = {}
    try:
        for k in CHUNKS:
            cv.CHUNK = k
            syncs = host_syncs(lambda: solve(g))
            reads = sum(count for site, count in syncs["sites"].items()
                        if site.startswith("converged.py"))
            if reads != -(-iterations // k):
                raise AssertionError(f"chunk {k}: {reads} reads of the "
                                     f"loop's state for {iterations} "
                                     "iterations")
            out[str(k)] = {"warm_ms": host_ms(lambda: solve(g)),
                           "host_syncs": syncs["total"], "loop_reads": reads}
    finally:
        cv.CHUNK = shipped
    return out


def device_idle(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the card's busy time
    (the union of its kernels, copies and sets), the span from the first
    to the last of them, the host wall of the call, and the idle share of
    each."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA)
    if not spans:
        return {"device_events": 0, "wall_ms": wall_ms,
                "idle_share": "not measured (no device events traced)"}
    busy, end = 0, spans[0][0]
    for a, b in spans:
        busy += max(0, b - max(a, end))
        end = max(end, b)
    span_ms = (end - spans[0][0]) / 1e6
    return {"device_events": len(spans), "busy_ms": busy / 1e6,
            "span_ms": span_ms, "wall_ms": wall_ms,
            "idle_share_of_span": 1 - busy / 1e6 / span_ms,
            "idle_share_of_wall": 1 - busy / 1e6 / wall_ms}


def drive(g, name: str, variant: str, reference: np.ndarray) -> dict:
    """One main-path solve with the launch counts read around it."""
    torch.cuda.reset_peak_memory_stats()
    sync()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = solve(g, variant=variant)
    sync()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    plain = plain_solve(g, variant=variant)
    sync()
    for field in ("labels", "iterations", "converged", "edges_visited"):
        if not torch.equal(getattr(res, field), getattr(plain, field)):
            raise AssertionError(f"{name} {variant}: {field} differs from "
                                 "the torch backend")
    if not bool(res.converged):
        raise AssertionError(f"{name} {variant}: not converged")
    if not np.array_equal(res.labels.cpu().numpy(), reference):
        raise AssertionError(f"{name} {variant}: labels differ from scipy")
    # the same solve again, with the allocator's blocks already cached
    t0 = time.perf_counter()
    solve(g, variant=variant)
    sync()
    wall_warm = time.perf_counter() - t0
    out = {"phase": "main_path", "graph": name, "variant": variant,
           "n": g.n_vertices, "m": g.n_edges, "wall_s": wall,
           "wall_warm_s": wall_warm,
           "host_syncs": host_syncs(lambda: solve(g, variant=variant)),
           "iterations": int(res.iterations),
           "edges_visited": float(res.edges_visited),
           "edges_per_s": float(res.edges_visited) / wall,
           "peak_bytes": peak, "launches": launches,
           "provenance": list(res.provenance or ()),
           "n_components": res.n_components}
    reads = sum(count for site, count in out["host_syncs"]["sites"].items()
                if site.startswith("converged.py"))
    out["loop_reads"] = reads
    if reads > -(-out["iterations"] // cv.CHUNK):
        raise AssertionError(f"{name} {variant}: {reads} reads of the loop's "
                             f"state for {out['iterations']} iterations")
    if variant == "C-2":
        L0 = torch.arange(g.n_vertices, dtype=torch.int32, device=g.device)
        out["parts_first_iteration"] = iteration_parts(g, L0)
        out["parts_at_fixed_point"] = iteration_parts(g, res.labels)
        out["loop_cost"] = loop_cost(g, res)
        out["chunk_sweep"] = chunk_sweep(g, out["iterations"])
        out["profiled_solve"] = device_idle(lambda: solve(g))
    emit(out)
    out["labels"] = res.labels
    return out


def drive_async(g, name: str, reference: np.ndarray, options: dict,
                on_cpu: bool) -> dict:
    """One ``cuda_async`` solve with the launch counts read around it.

    Its labels must equal scipy's; with ``on_cpu`` the same solve on CPU
    tensors (through ``mm2_plain``) must give the same labels,
    iterations, converged and edges_visited, bit for bit: the in-order
    sweep's result depends on the order of its updates.
    """
    torch.cuda.reset_peak_memory_stats()
    sync()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = solve(g, backend="cuda_async", **options)
    sync()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if not bool(res.converged):
        raise AssertionError(f"{name} cuda_async {options}: not converged")
    if not np.array_equal(res.labels.cpu().numpy(), reference):
        raise AssertionError(f"{name} cuda_async {options}: labels differ "
                             "from scipy")
    t0 = time.perf_counter()
    solve(g, backend="cuda_async", **options)
    sync()
    wall_warm = time.perf_counter() - t0
    out = {"phase": "async_path", "graph": name, "options": options,
           "n": g.n_vertices, "m": g.n_edges, "wall_s": wall,
           "wall_warm_s": wall_warm, "iterations": int(res.iterations),
           "edges_visited": float(res.edges_visited),
           "edges_per_s": float(res.edges_visited) / wall,
           "peak_bytes": peak, "launches": launches,
           "provenance": list(res.provenance or ()),
           "n_components": res.n_components}
    if on_cpu:
        t0 = time.perf_counter()
        cpu = solve(cpu_copy(g), backend="cuda_async", **options)
        out["cpu_solve_s"] = time.perf_counter() - t0
        same_result(res, cpu, f"{name} cuda_async {options} against CPU "
                    "tensors")
    emit(out)
    return out


def frontier_parts(g) -> dict:
    """Device ms of the frontier's steps at the full edge list, with the
    labels of one C-2 iteration: each strategy's preparation (and the
    two halves of kout's occurrence rank), one general contraction, the
    largest-component filter, the convergence check, and the final
    compression (CUDA events, mean of ``REPS``)."""
    n, m = g.n_vertices, g.n_edges
    L1 = c2_states(g, 1)[1]
    out = {f"prepare_{s}_ms": time_ms(
        lambda s=s: fr.prepare_sampling(s, g.src, g.dst, n))
        for s in SAMPLING_STRATEGIES}
    # kout's preparation is two occurrence ranks: a stable argsort and a
    # cummax over m each
    idx = torch.arange(m, dtype=torch.int64, device=g.device)
    out["occurrence_rank_ms"] = time_ms(lambda: fr._occurrence_rank(g.src))
    out["argsort_stable_ms"] = time_ms(
        lambda: torch.argsort(g.src, stable=True))
    out["cummax_ms"] = time_ms(lambda: torch.cummax(idx, 0))
    out["contract_ms"] = time_ms(
        lambda: fr.contract_edges(L1, g.src, g.dst, m))
    out["largest_component_filter_ms"] = time_ms(
        lambda: fr.contract_edges(L1, g.src, g.dst, m, only_label=(
            fr.largest_component_label(L1, n))))
    out["converged_check_ms"] = time_ms(
        lambda: fr.masked_converged_early(L1, g.src, g.dst, m))
    out["compress_full_ms"] = time_ms(lambda: fr.compress_full(L1))
    return out


def drive_frontier(g, name: str, strategy: str,
                   reference: np.ndarray) -> dict:
    """One frontier solve on the default backend, with the launch counts
    read around it; bit for bit against the ``torch`` backend."""
    options = dict(FRONTIER, sampling_strategy=strategy)
    torch.cuda.reset_peak_memory_stats()
    sync()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = solve(g, **options)
    sync()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    same_result(res, plain_solve(g, **options),
                f"{name} {options} against the torch backend")
    if not bool(res.converged):
        raise AssertionError(f"{name} {options}: not converged")
    if not np.array_equal(res.labels.cpu().numpy(), reference):
        raise AssertionError(f"{name} {options}: labels differ from scipy")
    out = {"phase": "frontier_path", "graph": name, "options": options,
           "n": g.n_vertices, "m": g.n_edges, "wall_s": wall,
           "wall_warm_ms": host_ms(lambda: solve(g, **options)),
           "host_syncs": host_syncs(lambda: solve(g, **options)),
           "iterations": int(res.iterations),
           "edges_visited": float(res.edges_visited),
           "edges_per_s": float(res.edges_visited) / wall,
           "peak_bytes": peak, "launches": launches,
           "provenance": list(res.provenance or ())}
    emit(out)
    return out


def witness_at_the_end(g, fixed):
    """Labels that fail the predicate on one vertex only, a label one hop
    from its root (as ``tests/test_torch_cuda.py``'s ``witness_last``):
    the vertex that first appears latest in the edge list, among those of
    components of three or more vertices.  Returns the labels and the
    index of the first edge that is a witness."""
    m, n = g.n_edges, g.n_vertices
    edge = torch.arange(m, device=g.device)
    first = torch.full((n,), m, dtype=torch.long, device=g.device)
    first.scatter_reduce_(0, g.src.long(), edge, "amin")
    first.scatter_reduce_(0, g.dst.long(), edge, "amin")
    size = torch.bincount(fixed.long(), minlength=n)[fixed.long()]
    v = int(torch.where(size >= 3, first, -1).argmax())
    root = int(fixed[v])
    ids = torch.arange(n, device=g.device)
    u = int(torch.nonzero((fixed == root) & (ids != root) & (ids != v))[0])
    L = fixed.clone()
    L[v] = u
    return L, int(first[v])


def phase_converged(full: dict) -> dict:
    """K6 (``converged_early``, ``labels_unchanged``) against its plain
    versions on the card, at the main path's shapes.

    ``full`` maps names to (graph, its C-2 solve's labels), rmat first.
    On each graph, the four C-2 label states and the solve's fixed point:
    the predicate's flag over every edge, over the frontier's prefix
    limits (the sampling prefix m // 4, and m // 2) and m - 1 (a tail of
    m % 4 edges), and on ``src[1:]``, ``dst[1:]`` (not 16-byte aligned:
    the scalar kernel) must equal the plain version's; the no-change
    test's flag on each state against the next (changed) and against a
    copy of itself (unchanged, a full pass) too.  Times: the kernel with
    the loop's step (a fresh state before each call, untimed) against the
    plain version, per state; at the fixed point also right after a
    ``pointer_jump`` of the same labels (the labels as the loop's test
    meets them, which the kernels line quotes) and after an L2 flush; and
    on the first graph a full pass whose only witness is at its end
    (:func:`witness_at_the_end`)."""
    mismatches, checks, rows = [], 0, {}
    first = None
    for name, (g, fixed) in full.items():
        m, n = g.n_edges, g.n_vertices
        states = c2_states(g, 3) + [fixed]
        state = cv.loop_state(g.device)
        per = []
        for i, L in enumerate(states):
            label = i if i < 4 else "fixed"
            for limit in (None, fr.sample_prefix_m(m), m // 2, m - 1):
                got = bool(cv.converged_early(L, g.src, g.dst, limit))
                want = bool(cv.converged_early_plain(L, g.src, g.dst, limit))
                if got != want:
                    mismatches.append(("converged_early", name, label, limit))
                checks += 1
            if (bool(cv.converged_early(L, g.src[1:], g.dst[1:]))
                    != bool(cv.converged_early_plain(L, g.src[1:],
                                                     g.dst[1:]))):
                mismatches.append(("converged_early", name, label, "[1:]"))
            checks += 1
            same = L.clone()
            nxt = states[i + 1] if i + 1 < len(states) else L.flip(0)
            for b in (same, nxt):
                if (bool(cv.labels_unchanged(L, b))
                        != bool(cv.labels_unchanged_plain(L, b))):
                    mismatches.append(("labels_unchanged", name, label))
                checks += 1
            per.append({
                "state": label,
                "converged": bool(cv.converged_early_plain(L, g.src, g.dst)),
                "converged_early_ms": time_each_ms(
                    lambda: cv.converged_early(L, g.src, g.dst, state=state),
                    setup=state.zero_),
                "plain_ms": time_ms(
                    lambda: cv.converged_early_plain(L, g.src, g.dst)),
                "labels_unchanged_ms": time_each_ms(
                    lambda: cv.labels_unchanged(L, same, state=state),
                    setup=state.zero_),
                "labels_unchanged_changed_ms": time_each_ms(
                    lambda: cv.labels_unchanged(L, nxt, state=state),
                    setup=state.zero_),
                "labels_unchanged_plain_ms": time_ms(
                    lambda: cv.labels_unchanged_plain(L, same)),
            })
            del same, nxt
        if per[-1]["converged"] is not True:
            raise AssertionError(f"{name}: the solve's labels fail the "
                                 "predicate")
        # the fixed point as the loop's test meets it: just written by a
        # jump round (a no-op there), and after an L2 flush
        jumped = [fixed]

        def after_jump():
            jumped[0] = cv.pointer_jump(fixed)
            state.zero_()

        per[-1]["converged_early_after_jump_ms"] = time_each_ms(
            lambda: cv.converged_early(jumped[0], g.src, g.dst, state=state),
            setup=after_jump)
        if not torch.equal(jumped[0], fixed):
            raise AssertionError(f"{name}: a jump round moves the fixed "
                                 "point")
        per[-1]["converged_early_flushed_ms"] = time_each_ms(
            lambda: cv.converged_early(fixed, g.src, g.dst, state=state),
            setup=lambda: (flush_l2(), state.zero_()))
        del jumped
        if first is None:
            late, edge = witness_at_the_end(g, fixed)
            if (bool(cv.converged_early(late, g.src, g.dst))
                    or bool(cv.converged_early_plain(late, g.src, g.dst))):
                raise AssertionError(f"{name}: a label one hop from its "
                                     "root passes the predicate")
            checks += 1
            rows[f"{name} witness at edge {edge} of {m}"] = {
                "first_witness_at": edge / m,
                "converged_early_ms": time_each_ms(
                    lambda: cv.converged_early(late, g.src, g.dst,
                                               state=state),
                    setup=state.zero_),
                "flushed_ms": time_each_ms(
                    lambda: cv.converged_early(late, g.src, g.dst,
                                               state=state),
                    setup=lambda: (flush_l2(), state.zero_()))}
            del late
        rows[name] = per
        if first is None:
            fixed_copy = fixed.clone()
            first = {
                "shape": {"n": n, "m": m, "state": "fixed point"},
                "converged_early": {
                    "ms": per[-1]["converged_early_after_jump_ms"],
                    "ms_setting": "fixed point, right after a pointer_jump "
                                  "of the same labels, as in the loop",
                    "warm_ms": per[-1]["converged_early_ms"],
                    "flushed_ms": per[-1]["converged_early_flushed_ms"],
                    "plain_ms": per[-1]["plain_ms"],
                    # read src, dst (8m) and the labels once (4n); per edge
                    # three compares
                    **bound(*cv.converged_early_work(n, m))},
                "labels_unchanged": {
                    "ms": per[-1]["labels_unchanged_ms"],
                    "plain_ms": per[-1]["labels_unchanged_plain_ms"],
                    "library_ms": time_ms(
                        lambda: torch.equal(fixed, fixed_copy)),
                    # read both arrays once; one compare an element
                    **bound(*cv.labels_unchanged_work(n))},
            }
            del fixed_copy
    if mismatches:
        raise AssertionError(f"K6 differs from its plain version: "
                             f"{mismatches}")
    emit({"phase": "converged_vs_plain", "checks": checks,
          "states": rows,
          "bounds": {name: first[name]["bound_ms"]
                     for name in ("converged_early", "labels_unchanged")}})
    out = {}
    for name in ("converged_early", "labels_unchanged"):
        out[name] = {"name": name, "route": "cuda",
                     "source": CONVERGED_SOURCE,
                     "replaces": REPLACES[name], "max_abs_err": 0,
                     "library_ms": None, "shape": first["shape"],
                     "ms_by_state": {g: [r[f"{name}_ms"] for r in rows[g]]
                                     for g in rows if g in full},
                     **first[name]}
    return out


def phase_jump(full: dict) -> dict:
    """K7 (``pointer_jump``) against its plain version on the card: in the
    four C-2 label states and at the fixed point of each graph in
    ``full`` (as for :func:`phase_converged`), with the done word absent,
    clear and set; times per state (each call after a flush of L2, as in
    the loop, where the sweep before a jump evicts the labels), the
    kernels line's on the first graph's identity labels."""
    err, checks, rows, first = 0, 0, {}, None
    for name, (g, fixed) in full.items():
        n = g.n_vertices
        word = {d: torch.tensor([d], dtype=torch.int32, device=g.device)
                for d in (0, 1)}
        per = []
        for i, L in enumerate(c2_states(g, 3) + [fixed]):
            for done in (None, word[0], word[1]):
                a = cv.pointer_jump(L, done)
                b = cv.pointer_jump_plain(L, done)
                sync()
                err = max(err, max_abs_err(a, b))
                checks += 1
                del a, b
            per.append({"state": i if i < 4 else "fixed",
                        "ms": time_each_ms(lambda: cv.pointer_jump(L),
                                           setup=flush_l2),
                        "frozen_ms": time_each_ms(
                            lambda: cv.pointer_jump(L, word[1]),
                            setup=flush_l2),
                        "plain_ms": time_each_ms(
                            lambda: cv.pointer_jump_plain(L),
                            setup=flush_l2)})
        rows[name] = per
        if first is None:
            first = {"shape": {"n": n, "state": 0}, "ms": per[0]["ms"],
                     "plain_ms": per[0]["plain_ms"],
                     # read L once and write the output once (the gather
                     # L[L] reads the same input again); one min an element
                     **bound(*cv.pointer_jump_work(n))}
    if err:
        raise AssertionError(f"pointer_jump differs from its plain "
                             f"version: {err}")
    emit({"phase": "jump_vs_plain", "checks": checks, "states": rows})
    return {"name": "pointer_jump", "route": "cuda", "source":
            CONVERGED_SOURCE, "replaces": REPLACES["pointer_jump"],
            "max_abs_err": err, "library_ms": None,
            "ms_by_state": {g: [r["ms"] for r in rows[g]] for g in rows},
            **first}


def fastsv_freeze_cost(g) -> dict:
    """Device ms of one FastSV iteration from the identity labels as the
    loop enqueues it (the iteration, then the no-change test with the
    loop's step; a fresh state before each call, untimed), with and
    without the freeze that keeps ``(f, gf)`` once the done word is set
    (two ``torch.where`` over n), and of the freeze alone."""
    u = torch.cat([g.src, g.dst])
    v = torch.cat([g.dst, g.src])
    f = torch.arange(g.n_vertices, dtype=torch.int32, device=g.device)
    state = cv.loop_state(g.device)
    done = cv.done_word(state)

    def bare():
        f1, gf1 = fastsv.iteration(f, f, u, v, done)
        cv.labels_unchanged(gf1, f, state=state)

    def frozen():
        f1, gf1 = fastsv.freeze(done, (f, f),
                                fastsv.iteration(f, f, u, v, done))
        cv.labels_unchanged(gf1, f, state=state)

    new = fastsv.iteration(f, f, u, v, done)
    out = {"iteration_ms": time_each_ms(bare, setup=state.zero_),
           "iteration_with_freeze_ms": time_each_ms(frozen,
                                                    setup=state.zero_),
           "freeze_ms": time_ms(lambda: fastsv.freeze(done, (f, f), new))}
    out["freeze_share"] = 1 - out["iteration_ms"] / out[
        "iteration_with_freeze_ms"]
    return out


def drive_baseline(g, name: str, algorithm: str, reference: np.ndarray,
                   on_cpu: bool, dense_warm_ms=None) -> dict:
    """One solve of a baseline family with the launch counts read around
    it: labels equal to scipy's; with ``on_cpu`` the same solve on CPU
    tensors must give the same labels, iterations and converged."""
    sync()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = solve(g, algorithm=algorithm)
    sync()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if not bool(res.converged):
        raise AssertionError(f"{name} {algorithm}: not converged")
    if res.labels.device.type != "cuda":
        raise AssertionError(f"{name} {algorithm}: labels on "
                             f"{res.labels.device}")
    if not np.array_equal(res.labels.cpu().numpy(), reference):
        raise AssertionError(f"{name} {algorithm}: labels differ from scipy")
    if algorithm != "union_find":
        for kernel_name in ("scatter_min", "labels_unchanged"):
            if launches[kernel_name] <= 0:
                raise AssertionError(f"{name} {algorithm} did not launch "
                                     f"{kernel_name}")
    # Rem is a Python loop over the edges: one warm solve
    reps = 1 if algorithm == "union_find" else 3
    t0 = time.perf_counter()
    for _ in range(reps):
        solve(g, algorithm=algorithm)
        sync()
    iters = int(res.iterations)
    out = {"phase": "baseline_path", "graph": name, "algorithm": algorithm,
           "n": g.n_vertices, "m": g.n_edges, "wall_s": wall,
           "wall_warm_ms": (time.perf_counter() - t0) / reps * 1e3,
           "iterations": iters, "converged": bool(res.converged),
           "launches": launches, "n_components": res.n_components}
    # edges swept: every edge once an iteration (a union-find pass is one)
    out["edges_per_s"] = iters * g.n_edges / (out["wall_warm_ms"] / 1e3)
    if dense_warm_ms is None:
        solve(g)
        sync()
        t0 = time.perf_counter()
        for _ in range(3):
            solve(g)
            sync()
        dense_warm_ms = (time.perf_counter() - t0) / 3 * 1e3
    out["dense_c2_warm_ms"] = dense_warm_ms
    out["x_dense_c2"] = out["wall_warm_ms"] / dense_warm_ms
    if algorithm != "union_find":
        out["host_syncs"] = host_syncs(
            lambda: solve(g, algorithm=algorithm))["total"]
    if on_cpu:
        t0 = time.perf_counter()
        cpu = solve(cpu_copy(g), algorithm=algorithm)
        out["cpu_solve_s"] = time.perf_counter() - t0
        for field in ("labels", "iterations", "converged"):
            if not torch.equal(getattr(res, field).cpu(), getattr(cpu, field)):
                raise AssertionError(f"{name} {algorithm}: {field} differs "
                                     "from the solve on CPU tensors")
    emit(out)
    return out


def edge_batches(g, batch: int) -> list:
    """The graph's edges in order, as views of its tensors, ``batch`` at
    a time."""
    return [(g.src[i:i + batch], g.dst[i:i + batch])
            for i in range(0, g.n_edges, batch)]


def stream_graph(g, batch: int, count=None, **options):
    """A stream fed the graph's edge batches (the first ``count``)."""
    eng = StreamingConnectivity(g.n_vertices, **options)
    for src, dst in edge_batches(g, batch)[:count]:
        eng.ingest(src, dst, validate=False)
    return eng


def same_state(a: dict, b: dict, what: str) -> None:
    """Two streams' state dicts, key by key, bit for bit."""
    if sorted(a) != sorted(b):
        raise AssertionError(f"{what}: keys differ")
    for key, x in a.items():
        y = b[key]
        if isinstance(x, torch.Tensor):
            same = (x.dtype == y.dtype and x.shape == y.shape
                    and torch.equal(x, y.to(x.device)))
        else:
            same = type(x) is type(y) and x == y
        if not same:
            raise AssertionError(f"{what}: {key} differs")


def round_trip(g, batch: int, uninterrupted: dict, what: str,
               **options) -> dict:
    """Half the batches, a checkpoint, a restore onto the card, the rest:
    the state dict must equal the uninterrupted stream's."""
    batches = edge_batches(g, batch)
    half = len(batches) // 2
    with tempfile.TemporaryDirectory(prefix="stream_ckpt_") as directory:
        mgr = CheckpointManager(directory)
        first = stream_graph(g, batch, half, **options)
        sync()
        t0 = time.perf_counter()
        first.save(mgr)
        mgr.wait()
        save_s = time.perf_counter() - t0
        del first
        t0 = time.perf_counter()
        resumed, step = StreamingConnectivity.restore(mgr, **{
            k: v for k, v in options.items() if k != "store_edges"})
        sync()
        restore_s = time.perf_counter() - t0
    if step != half or resumed.device.type != torch.device(DEVICE).type:
        raise AssertionError(f"{what}: restored step {step} on "
                             f"{resumed.device}")
    for src, dst in batches[half:]:
        resumed.ingest(src, dst, validate=False)
    same_state(resumed.state_dict(), uninterrupted,
               f"{what}: restored stream")
    return {"batches": len(batches), "saved_at": half, "save_s": save_s,
            "restore_s": restore_s}


def drive_stream(g, name: str, reference: np.ndarray) -> dict:
    """The streaming path on a main-path graph: its own edges in order,
    ``STREAM_BATCH`` at a time, as device tensors.

    The labels after the last batch must equal scipy's, with every batch
    converged, and ``resolve()`` must leave them as they are; the same
    stream on the ``torch`` backend (plain torch on the card, no kernel)
    must give the same labels and counters bit for bit; the stream must
    have launched the sweep, the test and the jump kernels.  The host's
    reads an ingest are counted on a second run (with ``store_edges=
    False``), which a checkpoint round trip must then reproduce."""
    batches = edge_batches(g, STREAM_BATCH)
    torch.cuda.reset_peak_memory_stats()
    sync()
    reset_launch_counts()
    eng = StreamingConnectivity(g.n_vertices)
    ms, iterations = [], []
    t_all = time.perf_counter()
    for src, dst in batches:
        before = int(eng.snapshot().iterations)
        t0 = time.perf_counter()
        eng.ingest(src, dst, validate=False)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        iterations.append(int(eng.snapshot().iterations) - before)
    wall = time.perf_counter() - t_all
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    missing = [k for k in ("fused_relax", "converged_early", "pointer_jump")
               if launches[k] <= 0]
    if missing:
        raise AssertionError(f"stream {name}: did not launch {missing}")
    snap = eng.snapshot()
    if not bool(snap.converged):
        raise AssertionError(f"stream {name}: not converged")
    if not np.array_equal(snap.labels.cpu().numpy(), reference):
        raise AssertionError(f"stream {name}: labels differ from scipy")
    reset_launch_counts()
    plain = stream_graph(g, STREAM_BATCH, backend="torch")
    launched = {k: v for k, v in launch_counts().items() if v}
    if launched:
        raise AssertionError(f"the torch backend's stream launched "
                             f"kernels: {launched}")
    same_result(snap, plain.snapshot(), f"stream {name} (torch backend)")
    del plain
    reset_launch_counts()
    labels = eng.labels.clone()
    t0 = time.perf_counter()
    eng.resolve()
    sync()
    resolve_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(eng.labels, labels):
        raise AssertionError(f"stream {name}: resolve() changed the labels")
    for k, v in launch_counts().items():
        launches[k] += v
    out = {"phase": "stream_path", "graph": name, "n": g.n_vertices,
           "m": g.n_edges, "batch": STREAM_BATCH, "batches": len(batches),
           "wall_s": wall,
           "ingest_ms": {"p50": float(np.percentile(ms, 50)),
                         "p90": float(np.percentile(ms, 90)),
                         "first": ms[0], "max": max(ms)},
           "edges_per_s": g.n_edges / wall,
           "iterations_per_batch": iterations,
           "iterations": int(snap.iterations),
           "edges_visited": float(snap.edges_visited),
           "resolve_ms": resolve_ms, "peak_bytes": peak,
           "launches": launches, "n_components": eng.n_components,
           "provenance": list(snap.provenance or ())}
    del eng, snap
    held = []
    syncs = host_syncs(lambda: held.append(
        stream_graph(g, STREAM_BATCH, store_edges=False)))
    out["host_syncs_per_ingest"] = syncs["total"] / len(batches)
    out["host_syncs"] = syncs
    out["checkpoint"] = round_trip(g, STREAM_BATCH, held[0].state_dict(),
                                   f"stream {name}", store_edges=False)
    del held
    out["profiled_first_8_batches"] = device_idle(
        lambda: stream_graph(g, STREAM_BATCH, 8))
    emit(out)
    return out


def stream_vs_cpu(g, name: str) -> dict:
    """At the check scale: the stream on the card equals the same stream
    on CPU tensors after every batch, state dict and all, and a
    checkpoint round trip with the edge store reproduces it."""
    sync()
    reset_launch_counts()
    card = StreamingConnectivity(g.n_vertices)
    cpu = StreamingConnectivity(g.n_vertices, device="cpu")
    batches = edge_batches(g, CHECK_STREAM_BATCH)
    t0 = time.perf_counter()
    for i, (src, dst) in enumerate(batches):
        card.ingest(src, dst, validate=False)
        cpu.ingest(src.cpu(), dst.cpu())
        same_state(cpu.state_dict(), card.state_dict(),
                   f"stream {name}, batch {i}: card vs cpu")
    launches = launch_counts()
    out = {"phase": "stream_path", "graph": name, "check": "card_vs_cpu",
           "batch": CHECK_STREAM_BATCH, "batches": len(batches),
           "wall_s": time.perf_counter() - t0, "launches": launches,
           "checkpoint": round_trip(g, CHECK_STREAM_BATCH,
                                    card.state_dict(), f"stream {name}")}
    emit(out)
    return out


class RecordingEngine(ConnectivityEngine):
    """The engine, with every point query's answer kept beside it (the
    future's callback runs where the answer is set)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.answers = []

    def submit_query(self, kind, u=None, v=None, *, timeout=None):
        fut = super().submit_query(kind, u, v, timeout=timeout)
        if kind != "n_components":
            fut.add_done_callback(
                lambda f, q=(kind, u, v): self.answers.append((q, f)))
        return fut


def serve(spec, **engine_kwargs) -> tuple:
    """``run_simulation`` on the card; returns the report, the final
    labels, the launches and the engine."""
    sync()
    reset_launch_counts()
    eng = RecordingEngine(spec.n_vertices, **engine_kwargs)
    try:
        report, labels = run_simulation(spec, engine=eng)
    finally:
        eng.close()
    if eng.device.type != torch.device(DEVICE).type:
        raise AssertionError(f"the engine ran on {eng.device}")
    return report, labels, launch_counts(), eng


def phase_serve() -> list:
    """The serving path: ``run_simulation`` at ``SERVE_SPEC``, its labels
    against scipy and against a ``torch``-backend stream fed the same
    plan, a sample of its answers against the final labels; then the
    recovery run against a clean run of the same spec."""
    t0 = time.perf_counter()
    report, labels, launches, eng = serve(SERVE_SPEC)
    wall = time.perf_counter() - t0
    n_batches = SERVE_SPEC.n_ingest_batches
    if report["failures"] or report["acked_batches"] != n_batches:
        raise AssertionError(f"serve: {report['failures']} failures, "
                             f"{report['acked_batches']} of {n_batches} "
                             f"acked: {report['failure_sample']}")
    plan = make_ingest_plan(SERVE_SPEC)
    src = np.concatenate([s for s, _ in plan])
    dst = np.concatenate([d for _, d in plan])
    if not np.array_equal(labels, scipy_labels_of(src, dst,
                                                  SERVE_SPEC.n_vertices)):
        raise AssertionError("serve: final labels differ from scipy")
    reset_launch_counts()
    plain = StreamingConnectivity(SERVE_SPEC.n_vertices, backend="torch")
    for s, d in plan:
        plain.ingest(s, d)
    if any(launch_counts().values()):
        raise AssertionError("the torch backend's stream launched kernels")
    if not np.array_equal(labels, plain.labels.cpu().numpy()):
        raise AssertionError("serve: final labels differ from the torch "
                             "backend's stream")
    del plain
    rng = np.random.default_rng(0)
    answers = eng.answers
    checked = min(ANSWER_SAMPLE, len(answers))
    wrong = 0
    for i in rng.choice(len(answers), checked, replace=False):
        (kind, u, v), fut = answers[i]
        got = fut.result()
        if kind == "same_component":
            # components only merge: a True stays true
            wrong += bool(got) and labels[u] != labels[v]
        else:
            # labels only decrease
            wrong += got < labels[u]
    if wrong:
        raise AssertionError(f"serve: {wrong} sampled answers contradict "
                             "the final labels")
    out = {"phase": "serve_path", "spec": dataclasses.asdict(SERVE_SPEC),
           "wall_s": wall, "latency_ms": report["latency_ms"],
           "throughput_qps": report["throughput_qps"],
           "ingest_visibility_ms": report["ingest_visibility_ms"],
           "ingest_batches_per_s": report["ingest_batches_per_s"],
           "batch_size_hist": report["batch_size_hist"],
           "queue_depth_hist": report["queue_depth_hist"],
           "counters": report["counters"], "final": report["final"],
           "acked_batches": report["acked_batches"],
           "failures": report["failures"], "answers_checked": checked,
           "launches": launches}
    emit(out)
    del eng, answers

    t0 = time.perf_counter()
    clean, clean_labels, clean_launches, _ = serve(RECOVERY_SPEC)
    with tempfile.TemporaryDirectory(prefix="serve_ckpt_") as directory:
        faulty, faulty_labels, faulty_launches, _ = serve(
            RECOVERY_SPEC, manager=CheckpointManager(directory),
            fault_injector=FaultInjector(fail_at=RECOVERY_FAIL_AT),
            checkpoint_every=RECOVERY_CHECKPOINT_EVERY,
            recoverable=(SimulatedFault,))
    n_batches = RECOVERY_SPEC.n_ingest_batches
    for what, rep in (("clean", clean), ("faulty", faulty)):
        if rep["failures"] or rep["acked_batches"] != n_batches:
            raise AssertionError(f"recovery ({what}): {rep['failures']} "
                                 f"failures, {rep['acked_batches']} of "
                                 f"{n_batches} acked")
    lost = n_batches - faulty["final"]["n_batches"]
    same = np.array_equal(faulty_labels, clean_labels)
    if (faulty["counters"]["restarts"] != len(RECOVERY_FAIL_AT) or lost
            or not same):
        raise AssertionError(
            f"recovery: {faulty['counters']['restarts']} restarts, {lost} "
            f"acknowledged ingests lost, labels equal: {same}")
    recovery = {"phase": "serve_recovery",
                "spec": dataclasses.asdict(RECOVERY_SPEC),
                "fail_at": RECOVERY_FAIL_AT,
                "checkpoint_every": RECOVERY_CHECKPOINT_EVERY,
                "wall_s": time.perf_counter() - t0,
                "restarts": faulty["counters"]["restarts"],
                "replayed_batches": faulty["counters"]["replayed_batches"],
                "checkpoints": faulty["counters"]["checkpoints"],
                "acked_ingest_loss": lost,
                "labels_crc32": faulty["final"]["labels_crc32"],
                "clean_labels_crc32": clean["final"]["labels_crc32"],
                "launches": {k: clean_launches[k] + faulty_launches[k]
                             for k in KERNEL_NAMES}}
    emit(recovery)
    return [out, recovery]


class RoundClock:
    """The parts of each out-of-core round while it is open: host seconds
    of the pads, the folds and the contraction, and the card's time of
    the host-to-device copies (CUDA events on the copy stream around
    each; the copy stream's wait for the fold two chunks back is inside,
    and is over by then, the host having read that fold's results), by
    wrapping the engine's functions."""

    def __init__(self):
        self.rounds = []
        self._saved = []

    def _patch(self, owner, name, wrap):
        fn = getattr(owner, name)
        self._saved.append((owner, name, fn))
        setattr(owner, name, wrap(fn))

    def _timed(self, key):
        def wrap(fn):
            def timed(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.rounds[-1][key] += time.perf_counter() - t0
            return timed
        return wrap

    def __enter__(self):
        clock = self

        def wrap_copy(copy):
            def timed_copy(pipe, slot):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(pipe.stream)
                copy(pipe, slot)
                end.record(pipe.stream)
                part = clock.rounds[-1]
                part["copies"].append((start, end))
                part["copy_bytes"] += pipe.host[slot].numel() * 4
            return timed_copy

        def wrap_round(run_round):
            def timed_round(eng):
                clock.rounds.append({"pad_s": 0.0, "fold_s": 0.0,
                                     "contract_s": 0.0, "copies": [],
                                     "copy_bytes": 0})
                t0 = time.perf_counter()
                record = run_round(eng)
                clock.rounds[-1]["round_s"] = time.perf_counter() - t0
                return record
            return timed_round

        self._patch(oocore, "_pad_chunk", self._timed("pad_s"))
        self._patch(oocore, "_fold_chunk", self._timed("fold_s"))
        self._patch(OutOfCoreContraction, "_contract",
                    self._timed("contract_s"))
        self._patch(oocore._ChunkPipeline, "_copy", wrap_copy)
        self._patch(OutOfCoreContraction, "run_round", wrap_round)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved = []

    def report(self) -> list:
        """Each round's seconds by part; the copies' device seconds and
        GB/s; ``other_s`` is the rest of the round (the chunks' reads or
        generation, the waits on the pinned buffers)."""
        sync()
        out = []
        for part in self.rounds:
            copy_s = sum(a.elapsed_time(b) for a, b in part["copies"]) / 1e3
            out.append({
                "round_s": part["round_s"], "pad_s": part["pad_s"],
                "fold_s": part["fold_s"], "contract_s": part["contract_s"],
                "other_s": part["round_s"] - part["pad_s"] - part["fold_s"]
                - part["contract_s"],
                "copy_s": copy_s, "copy_bytes": part["copy_bytes"],
                "copy_gbps": (part["copy_bytes"] / copy_s / 1e9
                              if copy_s else None)})
        return out


def pinned_copy_gbps() -> float:
    """GB/s of one pinned ``PINNED_PROBE_BYTES`` host-to-device copy,
    timed alone (CUDA events, mean of ``REPS``)."""
    host = torch.zeros(PINNED_PROBE_BYTES // 4, dtype=torch.int32,
                       pin_memory=True)
    dev = torch.empty_like(host, device=DEVICE)
    ms = time_ms(lambda: dev.copy_(host, non_blocking=True))
    return PINNED_PROBE_BYTES / ms / 1e6


def same_round(a: dict, b: dict, what: str) -> None:
    """Two out-of-core state dicts (numpy leaves), key by key, bit for
    bit."""
    if sorted(a) != sorted(b):
        raise AssertionError(f"{what}: keys differ")
    for key, x in a.items():
        y = b[key]
        if (x.dtype != y.dtype or x.shape != y.shape
                or not np.array_equal(x, y)):
            raise AssertionError(f"{what}: {key} differs")


def same_finish(a, b, what: str) -> None:
    """Two ``finish()`` 4-tuples (labels, iterations, converged,
    edges_visited), bit for bit."""
    for field, x, y in zip(("labels", "iterations", "converged",
                            "edges_visited"), a, b):
        if not torch.equal(x.cpu(), y.cpu()):
            raise AssertionError(f"{what}: {field} differs")


def materialized(chunks) -> tuple:
    """A chunk source's graph on the card and scipy's labels of it."""
    g = chunks.materialize(device=DEVICE)
    return g, scipy_labels(g)


def oocore_rounds(eng) -> tuple:
    """Every round of ``eng`` with its state dict after each, then the
    finish."""
    states = []
    while not eng.finished_streaming:
        eng.run_round()
        states.append(eng.state_dict())
    out = eng.finish()
    sync()
    return states, out


def oocore_twin(source, states, out, what: str, **options) -> None:
    """The same run on other terms (``options``) equals ``states`` after
    every round and ``out`` at the end."""
    eng = OutOfCoreContraction(source, **options)
    for i, want in enumerate(states):
        eng.run_round()
        same_round(eng.state_dict(), want, f"{what}, round {i}")
    if not eng.finished_streaming:
        raise AssertionError(f"{what}: more rounds than the card's run")
    same_finish(eng.finish(), out, f"{what}, finish")


def oocore_row(name: str, source, reference, ceiling: float, *,
               twin: bool = False, **options) -> tuple:
    """One out-of-core run on the card, its parts and checks.

    The labels must equal scipy's and the in-core solve's on the card
    (``reference()`` gives the graph on the card and scipy's labels; it
    runs after the peak is read), the survivors must shrink every round,
    and the run must launch the sweep, test and jump kernels.  With
    ``twin`` the same run on the ``torch`` backend (no kernel) must equal
    it after every round and at the end.  Round 0 runs twice more: under
    torch's sync debug mode (host syncs) and under the profiler (the
    card's idle share).  Returns the printed line and the result."""
    sync()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launch_counts()
    clock = RoundClock()
    t0 = time.perf_counter()
    with clock:
        eng = OutOfCoreContraction(source, **options)
        states, out = oocore_rounds(eng)
    wall = time.perf_counter() - t0
    peak = oocore.device_peak_bytes()
    launches = launch_counts()
    missing = [k for k in ("fused_relax", "converged_early", "pointer_jump")
               if launches[k] <= 0]
    if missing:
        raise AssertionError(f"oocore {name}: did not launch {missing}")
    chain = [source.n_edges] + eng.round_counts
    if not all(b < a for a, b in zip(chain, chain[1:])):
        raise AssertionError(f"oocore {name}: survivors {chain} do not "
                             "shrink every round")
    labels, iterations, converged, visited = out
    if not bool(converged):
        raise AssertionError(f"oocore {name}: not converged")
    g, ref = reference()
    if not np.array_equal(labels.cpu().numpy(), ref):
        raise AssertionError(f"oocore {name}: labels differ from scipy")
    if not torch.equal(solve(g).labels, labels):
        raise AssertionError(f"oocore {name}: labels differ from the "
                             "in-core solve")
    del g
    if twin:
        reset_launch_counts()
        oocore_twin(source, states, out, f"oocore {name} (torch backend)",
                    backend="torch", **options)
        if any(launch_counts().values()):
            raise AssertionError("the torch backend's out-of-core run "
                                 "launched kernels")
    del states
    syncs = host_syncs(
        lambda: OutOfCoreContraction(source, **options).run_round())
    idle = device_idle(
        lambda: OutOfCoreContraction(source, **options).run_round())
    parts = clock.report()
    copied = sum(p["copy_bytes"] for p in parts)
    copy_s = sum(p["copy_s"] for p in parts)
    row = {"phase": "oocore_path", "graph": name,
           "n": source.n_vertices, "m": source.n_edges,
           "chunk_edges": source.chunk_edges, "chunks": source.n_chunks,
           "options": options, "wall_s": wall,
           "rounds": len(eng.round_counts), "decay": eng.round_counts,
           "round_cap_exhausted": eng.round_cap_exhausted,
           "provenance": list(eng.provenance()),
           "iterations": int(iterations), "edges_visited": float(visited),
           "round_parts": parts,
           "h2d_bytes": copied,
           "h2d_gbps": copied / copy_s / 1e9 if copy_s else None,
           "pinned_copy_gbps": ceiling,
           "host_syncs_round0": syncs["total"],
           "host_syncs_round0_per_chunk": syncs["total"] / source.n_chunks,
           "host_syncs_sites": syncs["sites"], "idle_round0": idle,
           "peak_bytes": peak, "base_bytes": base,
           "peak_bytes_of_the_run": peak - base,
           "peak_bytes_estimate": eng.peak_bytes_estimate(),
           "edge_list_bytes": oocore.EDGE_BYTES * source.n_edges,
           "peak_above_estimate": peak - base > eng.peak_bytes_estimate(),
           "torch_backend_twin": twin, "launches": launches}
    return row, out


def phase_oocore(rmat_host: tuple, mesh_host: tuple, ref_rmat: np.ndarray,
                 rmat_name: str, mesh_name: str) -> tuple:
    """The out-of-core path (module docstring); returns the printed lines
    and the mesh's result and round count, which the recovery path holds
    its recovered runs against."""
    ceiling = pinned_copy_gbps()
    rows = []

    # stress: rmat(22,16)'s host arrays; no edge list of it on the card
    src, dst, n = rmat_host
    m = int(src.shape[0])
    row, _ = oocore_row(
        rmat_name, gen.ArrayChunks(src, dst, n, OOCORE_CHUNK),
        lambda: (Graph.from_numpy(src, dst, n, device=DEVICE), ref_rmat),
        ceiling, twin=True)
    if row["peak_bytes"] >= oocore.EDGE_BYTES * m:
        raise AssertionError(f"oocore {rmat_name}: peak {row['peak_bytes']}"
                             f" bytes >= the edge list's {8 * m}")
    rows.append(row)
    emit(row)

    # the facade on the graph in core
    g = Graph.from_numpy(src, dst, n, device=DEVICE)
    reset_launch_counts()
    t0 = time.perf_counter()
    res = solve(g, algorithm="out_of_core", oocore_chunk_edges=OOCORE_CHUNK)
    sync()
    facade_s = time.perf_counter() - t0
    if not np.array_equal(res.labels.cpu().numpy(), ref_rmat):
        raise AssertionError("oocore facade: labels differ from scipy")
    prov = list(res.provenance or ())
    if not (any(e.startswith("oocore:rounds=") for e in prov)
            and any(f"chunk={OOCORE_CHUNK}" in e for e in prov)):
        raise AssertionError(f"oocore facade: provenance {prov}")
    rows.append({"phase": "oocore_path", "graph": rmat_name,
                 "check": "facade", "wall_s": facade_s, "provenance": prov,
                 "launches": launch_counts()})
    emit(rows[-1])
    del g, res

    # generator-fed: the chunks never exist together on the host
    chunks = gen.rmat_chunks(**OOCORE_GENERATED)

    row, _ = oocore_row(
        f"rmat_chunks({OOCORE_GENERATED['scale']},"
        f"{OOCORE_GENERATED['edge_factor']})", chunks,
        lambda: materialized(chunks), ceiling)
    if row["peak_bytes_of_the_run"] >= row["edge_list_bytes"]:
        raise AssertionError(f"oocore generated: peak "
                             f"{row['peak_bytes_of_the_run']} >= "
                             f"{row['edge_list_bytes']}")
    rows.append(row)
    emit(row)

    # the mesh, where more than one round is likeliest
    src, dst, n = mesh_host
    mesh_ref = scipy_labels_of(src, dst, n)
    row, mesh_out = oocore_row(
        mesh_name, gen.ArrayChunks(src, dst, n, OOCORE_MESH_CHUNK),
        lambda: (Graph.from_numpy(src, dst, n, device=DEVICE), mesh_ref),
        ceiling)
    # the fold keeps at most three label arrays (n is 16 buckets here, so
    # the labels dominate): the run's peak within the estimate
    if row["peak_above_estimate"]:
        raise AssertionError(f"oocore {mesh_name}: peak "
                             f"{row['peak_bytes_of_the_run']} above the "
                             f"estimate {row['peak_bytes_estimate']}")
    rows.append(row)
    emit(row)

    # the star forest: at least two rounds, as the reference's gate row
    star = gen.star_forest_chunks(**OOCORE_STAR)
    row, _ = oocore_row(
        f"star_forest({OOCORE_STAR['k']},{OOCORE_STAR['b']})", star,
        lambda: materialized(star), ceiling, oocore_local_iters=1)
    if row["rounds"] < 2:
        raise AssertionError(f"oocore star forest: {row['rounds']} round")
    rows.append(row)
    emit(row)

    # the check scale: the card against CPU tensors after every round
    chunks = gen.rmat_chunks(**OOCORE_CHECK)
    reset_launch_counts()
    t0 = time.perf_counter()
    states, out = oocore_rounds(OutOfCoreContraction(chunks))
    launches = launch_counts()
    oocore_twin(chunks, states, out, "oocore check scale: cpu vs card",
                device="cpu")
    rows.append({"phase": "oocore_path",
                 "graph": f"rmat_chunks({OOCORE_CHECK['scale']},"
                          f"{OOCORE_CHECK['edge_factor']})",
                 "check": "card_vs_cpu", "rounds": len(states),
                 "chunks": chunks.n_chunks,
                 "wall_s": time.perf_counter() - t0, "launches": launches})
    emit(rows[-1])
    return rows, mesh_out, rows[3]["rounds"]


def phase_recovery(mesh_host: tuple, mesh_out: tuple, mesh_rounds: int,
                   stream_host: tuple, mesh_name: str,
                   stream_name: str) -> list:
    """The recovery path: ``oocore_with_recovery`` on the mesh with a
    fault in the middle of round 0 and one at the boundary of round 1
    (on the star forest when the mesh takes one round), against the clean
    runs, and a fresh engine resumed from the last checkpoint; then
    ``stream_with_recovery`` with two faults against the clean stream."""
    rows = []
    src, dst, n = mesh_host
    mesh = gen.ArrayChunks(src, dst, n, OOCORE_MESH_CHUNK)
    star = gen.star_forest_chunks(**OOCORE_STAR)
    runs = [(mesh_name, mesh, {}, mesh_out,
             [(mesh.n_chunks // 2, "oocore_chunk")]
             + ([(1, "oocore_round")] if mesh_rounds > 1 else []))]
    if mesh_rounds == 1:
        star_opts = {"oocore_local_iters": 1}
        star_out = oocore_rounds(OutOfCoreContraction(star, **star_opts))[1]
        runs.append((f"star_forest({OOCORE_STAR['k']},{OOCORE_STAR['b']})",
                     star, star_opts, star_out, [(1, "oocore_round")]))
    for name, source, options, clean, fail_at in runs:
        reset_launch_counts()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="oocore_ckpt_") as directory:
            mgr = CheckpointManager(directory)
            res, stats = oocore_with_recovery(
                source, mgr, fault_injector=FaultInjector(
                    fail_at=tuple(fail_at)), **options)
            sync()
            wall = time.perf_counter() - t0
            launches = launch_counts()
            got = (res.labels, res.iterations, res.converged,
                   res.edges_visited)
            same_finish(got, clean, f"oocore recovery {name}")
            if stats.restarts != len(fail_at) or \
                    stats.replayed_rounds != len(fail_at):
                raise AssertionError(f"oocore recovery {name}: {stats} for "
                                     f"{len(fail_at)} faults")
            resumed = OutOfCoreContraction(source, **options)
            resumed.restore(mgr)
            same_finish(oocore_rounds(resumed)[1], clean,
                        f"oocore recovery {name}: resumed engine")
        rows.append({"phase": "recovery_path", "entry": "oocore_with_recovery",
                     "graph": name, "fail_at": fail_at, "wall_s": wall,
                     "stats": dict(stats), "launches": launches})
        emit(rows[-1])

    src, dst, n = stream_host
    batches = [(src[i:i + STREAM_BATCH], dst[i:i + STREAM_BATCH])
               for i in range(0, src.shape[0], STREAM_BATCH)]
    clean = StreamingConnectivity(n)
    for s, d in batches:
        clean.ingest(s, d)
    reset_launch_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="stream_ckpt_") as directory:
        eng, stats = stream_with_recovery(
            batches, n, CheckpointManager(directory),
            checkpoint_every=STREAM_RECOVERY_CHECKPOINT_EVERY,
            fault_injector=FaultInjector(fail_at=STREAM_RECOVERY_FAIL_AT))
    sync()
    wall = time.perf_counter() - t0
    if stats["restarts"] != len(STREAM_RECOVERY_FAIL_AT):
        raise AssertionError(f"stream recovery: {stats}")
    same_state(eng.state_dict(), clean.state_dict(), "stream recovery")
    rows.append({"phase": "recovery_path", "entry": "stream_with_recovery",
                 "graph": stream_name, "batch": STREAM_BATCH,
                 "batches": len(batches),
                 "fail_at": STREAM_RECOVERY_FAIL_AT,
                 "checkpoint_every": STREAM_RECOVERY_CHECKPOINT_EVERY,
                 "wall_s": wall, "stats": stats,
                 "launches": launch_counts()})
    emit(rows[-1])
    return rows


def summed_launches(rows) -> dict:
    """Each kernel's launches summed over ``rows`` (ranks or cases)."""
    return {name: sum(r["launches"][name] for r in rows)
            for name in KERNEL_NAMES}


def check_mesh_launches(what: str, launches: dict) -> None:
    """The distributed path runs K1, K6 and K7 on every shard."""
    idle = [k for k in ("fused_relax", "converged_early", "pointer_jump")
            if launches[k] <= 0]
    if idle:
        raise AssertionError(f"{what}: launched no {idle}")


def mesh_path_row(g, name: str, mesh, local_rounds: int,
                  reference: np.ndarray, dense_ms: float) -> dict:
    """``solve(g, mesh=mesh, local_rounds=...)`` on a 1-rank NCCL mesh,
    dense: launches, bit for bit against the ``torch`` backend's mesh
    solve, scipy's labels, the warm wall beside dense C-2's, host syncs
    and the card's idle share."""
    what = f"mesh_path {name} local_rounds={local_rounds}"
    options = {"mesh": mesh, "local_rounds": local_rounds}
    sync()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = solve(g, **options)
    sync()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    check_mesh_launches(what, launches)
    reset_launch_counts()
    plain = solve(g, backend="torch", **options)
    sync()
    launched = {k: v for k, v in launch_counts().items() if v}
    if launched:
        raise AssertionError(f"{what}: the torch backend launched "
                             f"{launched}")
    same_result(res, plain, what)
    if not bool(res.converged):
        raise AssertionError(f"{what}: not converged")
    if not np.array_equal(res.labels.cpu().numpy(), reference):
        raise AssertionError(f"{what}: labels differ from scipy")
    warm_ms = host_ms(lambda: solve(g, **options))
    syncs = host_syncs(lambda: solve(g, **options))
    row = {"phase": "mesh_path", "graph": name, "process_group": "nccl",
           "ranks": 1, "local_rounds": local_rounds, "schedule": "dense",
           "n": g.n_vertices, "m": g.n_edges, "wall_s": wall,
           "warm_ms": warm_ms, "dense_c2_warm_ms": dense_ms,
           "warm_over_dense_c2": warm_ms / dense_ms,
           "iterations": int(res.iterations),
           "edges_visited": float(res.edges_visited),
           "host_syncs": syncs,
           "profiled_solve": device_idle(lambda: solve(g, **options)),
           "launches": launches, "provenance": list(res.provenance or ())}
    emit(row)
    return row


def mesh_stream_row(host: tuple, name: str, mesh) -> dict:
    """The stream's mesh path on a 1-rank NCCL mesh: ``MESH_STREAM_BATCHES``
    batches of ``STREAM_BATCH`` of the graph's edges (device tensors,
    ``validate=False``), the whole ``state_dict()`` after every batch
    against the same engine on the ``torch`` backend."""
    src, dst, n = host
    card = StreamingConnectivity(n, mesh=mesh)
    plain = StreamingConnectivity(n, mesh=mesh, backend="torch")
    per_batch, ingest_ms = [], []
    for b in range(MESH_STREAM_BATCHES):
        lo = b * STREAM_BATCH
        bs = torch.from_numpy(src[lo:lo + STREAM_BATCH]).to(DEVICE)
        bd = torch.from_numpy(dst[lo:lo + STREAM_BATCH]).to(DEVICE)
        sync()
        reset_launch_counts()
        t0 = time.perf_counter()
        card.ingest(bs, bd, validate=False)
        sync()
        ingest_ms.append((time.perf_counter() - t0) * 1e3)
        per_batch.append({"launches": launch_counts()})
        reset_launch_counts()
        plain.ingest(bs, bd, validate=False)
        launched = {k: v for k, v in launch_counts().items() if v}
        if launched:
            raise AssertionError(f"mesh_stream: the torch backend launched "
                                 f"{launched}")
        same_state(card.state_dict(), plain.state_dict(),
                   f"mesh_stream {name} batch {b}")
    launches = summed_launches(per_batch)
    check_mesh_launches("mesh_stream", launches)
    snap = card.snapshot()
    row = {"phase": "mesh_stream", "graph": name, "process_group": "nccl",
           "ranks": 1, "batch": STREAM_BATCH, "batches": MESH_STREAM_BATCHES,
           "ingest_ms": ingest_ms, "ingest_ms_p50": float(np.median(ingest_ms)),
           "iterations": int(snap.iterations),
           "edges_visited": float(snap.edges_visited),
           "launches": launches}
    emit(row)
    return row


def rank_graph(directory: str, spec: dict):
    """A graph the parent saved with ``np.save``, on the host, mapped (copy
    on write) from its files, and its scipy labels."""
    src = np.load(f"{directory}/{spec['key']}.src.npy", mmap_mode="c")
    dst = np.load(f"{directory}/{spec['key']}.dst.npy", mmap_mode="c")
    ref = np.load(f"{directory}/{spec['key']}.labels.npy", mmap_mode="r")
    return Graph(src=torch.from_numpy(src), dst=torch.from_numpy(dst),
                 n_vertices=spec["n"]), ref


def mesh_rank(rank: int, world: int, store: str, job: dict) -> None:
    """One of ``MESH_RANKS`` gloo ranks on the card (a spawned process):
    every case of ``job["graphs"]`` through ``solve(g, mesh=...)`` with
    the graph on the host (each rank copies its own block to the card),
    held bit for bit against the ``torch`` backend's and scipy's; then
    the elastic shrink.  Writes ``rank<r>.json`` into ``job["dir"]``."""
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MESH_COLLECTIVE_TIMEOUT_S))
    try:
        mesh = Mesh(np.arange(world), ("data",))
        blocked.load_library()
        cv.load_library()
        torch.zeros(1, device=mesh.device)
        out = {"rank": rank, "device": str(mesh.device), "cases": []}
        for name, spec in job["graphs"].items():
            g, ref = rank_graph(job["dir"], spec)
            for sampling, compact_every in MESH_SCHEDULES:
                for local_rounds in MESH_LOCAL_ROUNDS:
                    what = (f"mesh_ranks {name} rank {rank} local_rounds="
                            f"{local_rounds} sampling={sampling} "
                            f"compact_every={compact_every}")
                    options = {"mesh": mesh, "local_rounds": local_rounds,
                               "sampling": sampling,
                               "compact_every": compact_every}
                    sync()
                    reset_launch_counts()
                    t0 = time.perf_counter()
                    res = solve(g, **options)
                    sync()
                    wall = time.perf_counter() - t0
                    launches = launch_counts()
                    reset_launch_counts()
                    plain = solve(g, backend="torch", **options)
                    launched = {k: v for k, v in launch_counts().items() if v}
                    if launched:
                        raise AssertionError(f"{what}: the torch backend "
                                             f"launched {launched}")
                    same_result(res, plain, what)
                    labels = res.labels.cpu().numpy()
                    if not np.array_equal(labels, ref):
                        raise AssertionError(f"{what}: labels differ from "
                                             "scipy")
                    out["cases"].append({
                        "graph": name, "local_rounds": local_rounds,
                        "sampling": sampling, "compact_every": compact_every,
                        "iterations": int(res.iterations),
                        "converged": bool(res.converged),
                        "edges_visited": float(res.edges_visited),
                        "labels_crc32": zlib.crc32(labels.tobytes()),
                        "wall_s": wall, "launches": launches})
        # last: the shrink sheds ranks, which then leave
        g, ref = rank_graph(job["dir"], job["graphs"][job["elastic"]])
        injector = FaultInjector(
            fail_at=MESH_FAIL_AT,
            exc_factory=lambda step, site: ShardLossFault(1))
        sync()
        reset_launch_counts()
        t0 = time.perf_counter()
        res, stats = resilient_distributed_contour(
            g, block_rounds=1, fault_injector=injector)
        sync()
        out["elastic"] = {
            "graph": job["elastic"], "wall_s": time.perf_counter() - t0,
            "stats": stats, "provenance": list(res.provenance),
            "iterations": int(res.iterations),
            "converged": bool(res.converged),
            "labels_equal_scipy": bool(np.array_equal(
                res.labels.cpu().numpy(), ref)),
            "launches": launch_counts()}
        with open(f"{job['dir']}/rank{rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(world: int, store: str, job: dict, timeout_s: float) -> float:
    """``world`` processes of :func:`mesh_rank`; raises if one fails or
    the spawn outlives ``timeout_s`` (the ranks are then killed).  Returns
    the spawn's seconds."""
    t0 = time.perf_counter()
    ctx = mp.start_processes(mesh_rank, args=(world, store, job),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {world} mesh ranks still run after "
                                   f"{timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    return time.perf_counter() - t0


def mesh_rank_rows(outs: list, spawn_s: float) -> list:
    """The ranks' cases, each the same on every rank, with the launches
    summed over the ranks; and the elastic shrink's row."""
    rows = []
    agreed = ("iterations", "converged", "edges_visited", "labels_crc32")
    for i, case in enumerate(outs[0]["cases"]):
        each = [out["cases"][i] for out in outs]
        for key in agreed:
            if len({json.dumps(c[key]) for c in each}) != 1:
                raise AssertionError(f"mesh_ranks {case['graph']} case {i}: "
                                     f"the ranks' {key} differ")
        launches = summed_launches(each)
        check_mesh_launches(f"mesh_ranks {case['graph']}", launches)
        rows.append({"phase": "mesh_ranks", "graph": case["graph"],
                     "process_group": "gloo", "ranks": len(outs),
                     "devices": sorted({out["device"] for out in outs}),
                     "host_staged": True,
                     **{k: case[k] for k in ("local_rounds", "sampling",
                                             "compact_every", *agreed)},
                     "wall_s_max": max(c["wall_s"] for c in each),
                     "launches": launches})
        emit(rows[-1])
    elastic = [out["elastic"] for out in outs]
    survivors = [e for e in elastic if "shed" not in e["stats"]]
    want = [[MESH_RANKS - k, 1] for k in range(len(MESH_FAIL_AT) + 1)]
    shed = sorted(e["stats"]["shed"] for e in elastic if e not in survivors)
    for e in survivors:
        if e["stats"]["mesh_history"] != want or not e["converged"] \
                or not e["labels_equal_scipy"]:
            raise AssertionError(f"mesh_elastic: {e['stats']}, converged "
                                 f"{e['converged']}, labels equal scipy "
                                 f"{e['labels_equal_scipy']}")
    if len(survivors) != MESH_RANKS - len(MESH_FAIL_AT) \
            or shed != [block for block, _ in MESH_FAIL_AT]:
        raise AssertionError(f"mesh_elastic: {len(survivors)} survivors, "
                             f"shed at blocks {shed}")
    launches = summed_launches(elastic)
    check_mesh_launches("mesh_elastic", launches)
    rows.append({"phase": "mesh_elastic", "graph": elastic[0]["graph"],
                 "process_group": "gloo", "ranks": len(outs),
                 "host_staged": True, "fail_at": MESH_FAIL_AT,
                 "mesh_history": want, "shed_at_blocks": shed,
                 "stats": survivors[0]["stats"],
                 "provenance": survivors[0]["provenance"],
                 "iterations": survivors[0]["iterations"],
                 "wall_s_max": max(e["wall_s"] for e in elastic),
                 "spawn_s": spawn_s, "launches": launches})
    emit(rows[-1])
    return rows


def phase_mesh(main_graphs: dict, rank_graphs: dict, stream_name: str,
               elastic_name: str) -> list:
    """The mesh phase.  ``main_graphs`` and ``rank_graphs``: name ->
    ((src, dst, n) on the host, scipy labels).  First a 1-rank NCCL mesh
    in this process (FileStore rendezvous): ``mesh_path`` on each main
    graph at each of ``MESH_LOCAL_ROUNDS``, then ``mesh_stream`` on
    ``stream_name``, and the process group is destroyed; then
    ``MESH_RANKS`` gloo ranks on the card over ``rank_graphs``, saved
    once with ``np.save`` for the ranks to map (``mesh_ranks``), and the
    elastic shrink on ``elastic_name`` (``mesh_elastic``)."""
    rows = []
    with tempfile.TemporaryDirectory(prefix="mesh_") as directory:
        dist.init_process_group("nccl", init_method=f"file://{directory}/nccl",
                                rank=0, world_size=1)
        try:
            mesh = Mesh(np.array([0]), ("data",))
            for name, ((src, dst, n), ref) in main_graphs.items():
                g = Graph.from_numpy(src, dst, n, device=DEVICE)
                dense_ms = host_ms(lambda: solve(g))
                rows += [mesh_path_row(g, name, mesh, local_rounds, ref,
                                       dense_ms)
                         for local_rounds in MESH_LOCAL_ROUNDS]
                del g
            rows.append(mesh_stream_row(main_graphs[stream_name][0],
                                        stream_name, mesh))
        finally:
            dist.destroy_process_group()
        graphs = {}
        for i, (name, ((src, dst, n), ref)) in enumerate(rank_graphs.items()):
            key = f"graph{i}"
            np.save(f"{directory}/{key}.src.npy", src)
            np.save(f"{directory}/{key}.dst.npy", dst)
            np.save(f"{directory}/{key}.labels.npy", ref)
            graphs[name] = {"key": key, "n": n}
        job = {"dir": directory, "graphs": graphs, "elastic": elastic_name}
        spawn_s = spawn_ranks(MESH_RANKS, f"{directory}/gloo", job,
                              MESH_SPAWN_TIMEOUT_S)
        outs = []
        for rank in range(MESH_RANKS):
            with open(f"{directory}/rank{rank}.json") as f:
                outs.append(json.load(f))
    return rows + mesh_rank_rows(outs, spawn_s)


def fleet_graphs(kind: str) -> list:
    """A fleet's graphs on the host (``device="cpu"``): ``rmat``,
    ``delaunay`` or ``ragged`` (``BATCH_*``)."""
    if kind == "rmat":
        return [gen.rmat(BATCH_RMAT["scale"], edge_factor=RMAT_EDGE_FACTOR,
                         seed=i, device="cpu")
                for i in range(BATCH_RMAT["count"])]
    if kind == "delaunay":
        # delaunay_like is a grid: every seed gives the same graph
        one = gen.delaunay_like(BATCH_DELAUNAY["scale"], device="cpu")
        return [one] * BATCH_DELAUNAY["count"]
    lo, hi = BATCH_RAGGED["scales"]
    scales = np.random.default_rng(BATCH_SEED).integers(
        lo, hi + 1, BATCH_RAGGED["count"])
    make = (lambda s, i: gen.rmat(s, edge_factor=RMAT_EDGE_FACTOR, seed=i,
                                  device="cpu"),
            lambda s, i: gen.path(1 << s, seed=i, device="cpu"),
            lambda s, i: gen.delaunay_like(s, device="cpu"),
            lambda s, i: gen.star(1 << s, seed=i, device="cpu"))
    return [make[i % 4](int(s), i) for i, s in enumerate(scales)]


def fleet_name(kind: str) -> str:
    if kind == "rmat":
        return (f"{BATCH_RMAT['count']} x rmat({BATCH_RMAT['scale']},"
                f"{RMAT_EDGE_FACTOR})")
    if kind == "delaunay":
        return (f"{BATCH_DELAUNAY['count']} x "
                f"delaunay_like({BATCH_DELAUNAY['scale']})")
    lo, hi = BATCH_RAGGED["scales"]
    return (f"ragged {BATCH_RAGGED['count']} x 2^{lo}..2^{hi} "
            "(rmat, path, grid, star)")


def on_card(g) -> Graph:
    return Graph(src=g.src.to(DEVICE), dst=g.dst.to(DEVICE),
                 n_vertices=g.n_vertices)


def lane_alone(name: str, launches: dict, routes: dict) -> None:
    """Every routed entry point that a fleet's solve launched took the
    lane route alone."""
    for k in ROUTED:
        if launches[k] and (routes[k]["lane"] <= 0 or routes[k]["global"]):
            raise AssertionError(f"{name}: {k} did not take the lane route "
                                 f"alone: {routes[k]}")


def drive_fleet(kind: str) -> tuple:
    """One fleet through ``solve_batch`` on the card: labels of every lane
    equal scipy's, the ``torch`` backend's fleet bit for bit (launching no
    kernel), the loop of solo solves lane for lane; cold and warm walls,
    the solo loop's wall, iterations, host syncs, launches and the card's
    idle share.  Returns the printed line and the batched graph."""
    t0 = time.perf_counter()
    graphs = fleet_graphs(kind)
    host, sizes = stack_graphs(graphs, with_sizes=True)
    refs, seen = [], {}
    for g in graphs:
        if id(g) not in seen:
            seen[id(g)] = scipy_labels_of(*g.to_numpy())
        refs.append(seen[id(g)])
    batched = on_card(host)
    solo = [on_card(g) for g in graphs]
    setup_s = time.perf_counter() - t0
    lanes_b, m_pad = (int(x) for x in batched.src.shape)
    name = fleet_name(kind)

    def run(**options):
        return solve_batch(batched, batch_sizes=sizes, **options)

    sync()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = run()
    sync()
    cold_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    routes = route_counts()
    for k in ("fused_relax_batched", "converged_early_batched",
              "pointer_jump_batched"):
        if launches[k] <= 0:
            raise AssertionError(f"{name}: did not launch {k}")
    lane_alone(name, launches, routes)
    single = {k: v for k, v in launches.items()
              if v and not k.endswith("_batched")}
    if single:
        raise AssertionError(f"{name}: the fleet launched {single}")
    if not bool(res.converged.all()):
        raise AssertionError(f"{name}: a lane did not converge")
    for i, lane in enumerate(res.unstack()):
        if not np.array_equal(lane.labels.cpu().numpy(), refs[i]):
            raise AssertionError(f"{name}: lane {i} differs from scipy")
    warm_ms = host_ms(run) if lanes_b * m_pad < (1 << 26) else None
    if warm_ms is None:
        t0 = time.perf_counter()
        for _ in range(3):
            run()
            sync()
        warm_ms = (time.perf_counter() - t0) / 3 * 1e3
    reset_launch_counts()
    t0 = time.perf_counter()
    plain = run(backend="torch")
    sync()
    plain_cold_ms = (time.perf_counter() - t0) * 1e3
    if any(launch_counts().values()):
        raise AssertionError(f"{name}: the torch backend's fleet launched "
                             f"{launch_counts()}")
    same_result(res, plain, f"{name}: the torch backend's fleet")
    plain_warm_ms = torch_backend_warm_ms(run)
    # the loop of solo solves, each graph as it is (its own n and m)
    for g in solo[:2]:
        solve(g)
    sync()
    t0 = time.perf_counter()
    outs = [solve(g) for g in solo]
    sync()
    solo_ms = (time.perf_counter() - t0) * 1e3
    its = res.iterations.cpu()
    for i, (one, lane) in enumerate(zip(outs, res.unstack())):
        if int(one.iterations) != int(its[i]) or not torch.equal(
                one.labels, lane.labels):
            raise AssertionError(f"{name}: lane {i} differs from its solo "
                                 "solve")
    del outs
    syncs = host_syncs(run)
    idle = device_idle(run)
    real_m = sum(g.n_edges for g in graphs)
    row = {"phase": "batch_path", "fleet": name, "B": lanes_b,
           "n_pad": batched.n_vertices, "m_pad": m_pad,
           "labels": lanes_b * batched.n_vertices,
           "sum_n": sum(sizes), "padded_edges": lanes_b * m_pad,
           "real_edges": real_m,
           "padding_x": lanes_b * m_pad / max(real_m, 1),
           "batched_cold_ms": cold_ms, "batched_warm_ms": warm_ms,
           "solo_loop_ms": solo_ms,
           "solo_over_batched": solo_ms / warm_ms,
           "torch_backend_cold_ms": plain_cold_ms,
           "torch_backend_warm_ms": plain_warm_ms,
           "torch_backend_warm_reps": PLAIN_FLEET_REPS,
           "iterations_max": int(its.max()),
           "iterations_mean": float(its.float().mean()),
           "host_syncs": syncs["total"], "host_syncs_sites": syncs["sites"],
           "profiled": idle, "launches": launches, "routes": routes,
           "provenance": list(res.provenance or ()),
           "setup_s": setup_s}
    emit(row)
    return row, batched, sizes


def fleet_check_scale() -> dict:
    """Eight small graphs and a lane warm-started with an edge-free chain
    (it changes if the lane is not frozen once its test passes): the
    card's fleet against the CPU's, bit for bit, in every variant."""
    def fleet(device):
        gs = [gen.rmat(8, edge_factor=RMAT_EDGE_FACTOR, seed=1,
                       device=device),
              gen.path(200, seed=2, device=device),
              gen.grid2d(12, 20, device=device),
              gen.star(100, seed=3, device=device),
              gen.rmat(7, edge_factor=4, seed=4, device=device),
              gen.path(50, seed=5, device=device),
              gen.grid2d(5, 5, device=device),
              gen.star(64, seed=6, device=device)]
        n = max(g.n_vertices for g in gs)
        warm = [torch.arange(g.n_vertices, dtype=torch.int32, device=device)
                for g in gs]
        chain = torch.arange(n, dtype=torch.int32, device=device)
        chain[100:] -= 1
        warm[6] = chain
        return gs, warm

    card, card_warm = fleet(DEVICE)
    cpu, cpu_warm = fleet("cpu")
    checks = 0
    reset_launch_counts()
    for variant in contour.VARIANTS + ("C-3",):
        for warm in (False, True):
            a = solve_batch(card, variant=variant,
                            warm_start=card_warm if warm else None)
            b = solve_batch(cpu, variant=variant,
                            warm_start=cpu_warm if warm else None)
            same_result(a, b, f"fleet check scale {variant} warm={warm}: "
                              "card vs cpu")
            checks += 1
    out = {"phase": "batch_path", "check": "card_vs_cpu", "B": len(card),
           "cases": checks, "launches": launch_counts(),
           "routes": route_counts()}
    emit(out)
    return out


def witness_edges(L, src, dst, n: int) -> tuple:
    """The edges a test of the fleet must read in this state: each lane's
    up to its first witness (all of them where it has none), and the
    labels those edges gather (at most three an edge, at most n a
    lane)."""
    lanes_b, m = (int(x) for x in src.shape)
    Lv = L.view(lanes_b, n)
    lw, lv = Lv.gather(1, src.long()), Lv.gather(1, dst.long())
    bad = (lw != lv) | (lw != L[lw.long()]) | (lv != L[lv.long()])
    edges = torch.where(bad.any(1), bad.int().argmax(1) + 1, m)
    return int(edges.sum()), int(torch.clamp(3 * edges, max=n).sum())


def witness_labels(a, b, n: int) -> int:
    """The labels the no-change test of the fleet must read in this
    state: each lane's up to its first difference (all of them where it
    has none)."""
    diff = (a != b).view(-1, n)
    return int(torch.where(diff.any(1), diff.int().argmax(1) + 1, n).sum())


def fleet_kernels(batched: Graph, fixed: torch.Tensor) -> dict:
    """The fleet's entry points against their plain versions on the rmat
    fleet (identity labels, one C-2 iteration, the fixed point, and a
    lane with a label outside it; no lane frozen, and every other lane
    frozen), K1, K6, K2 (the order-1 stream, ``run = m``) and K7 on each
    route (the lane route at :func:`fleet.fleet_route`'s c, at c = 1 and
    at c = 4, the global route), the no-change test after a jump round
    and after a C-Syn sweep, and their entries of the kernels line:
    times on each route at the first sweep (K1, K2's order-1 stream), the
    fixed point and the live fleet after one iteration (K6; the no-change
    test after C-Syn's first sweep) and after an L2 flush (K7)."""
    lanes_b, m = (int(x) for x in batched.src.shape)
    n = batched.n_vertices
    src, dst = batched.src, batched.dst
    off = blocked.lane_offsets(lanes_b, n, DEVICE)
    L0 = (torch.arange(n, dtype=torch.int32, device=DEVICE)
          .expand(lanes_b, n) + off).reshape(-1).contiguous()
    L1 = cv.pointer_jump_batched_plain(
        blocked.fused_relax_batched_plain(L0, src, dst, n), n)
    Lf = (fixed + off).reshape(-1).contiguous()
    # lane 0's vertices 1 and 2 point into lane 1
    Lx = L1.clone()
    Lx[1], Lx[2] = n, n + 1
    half = torch.zeros((lanes_b, 4), dtype=torch.int32, device=DEVICE)
    half[1::2, cv.DONE] = 1
    route = {kind: fleet.fleet_route(n, lanes_b, m, kind)
             for kind in ("relax", "converged")}
    route["scatter"] = fleet.scatter_route(n, lanes_b, m)
    route["jump"] = fleet.jump_route(n, lanes_b)
    if any(r.route != "lane" for r in route.values()):
        raise AssertionError(f"the rmat fleet is not on the lane route: "
                             f"{route}")

    def variants(kind):
        """The routes held to the plain version."""
        return (route[kind], fleet.FleetRoute("lane", 1),
                fleet.FleetRoute("lane", 4), fleet.GLOBAL)

    err = Counter()
    checks = 0
    for L in (L0, L1, Lf, Lx):
        for lanes in (None, half):
            want = blocked.fused_relax_batched_plain(L, src, dst, n, lanes)
            err["fused_relax_batched"] = max(
                err["fused_relax_batched"], max_abs_err(
                    blocked.fused_relax_batched(L, src, dst, n, lanes),
                    want), *(max_abs_err(blocked.fused_relax_batched_on(
                        r, L, src, dst, n, lanes), want)
                        for r in variants("relax")))
            del want
            t, v = contour.mm_update_stream_batched(L, src, dst, n, 1)
            want = blocked.scatter_min_batched_plain(L, t, v, n, lanes)
            err["scatter_min_batched"] = max(
                err["scatter_min_batched"], max_abs_err(
                    blocked.scatter_min_batched(L, t, v, n, lanes), want),
                max_abs_err(blocked.scatter_min_batched(
                    L, t, v, n, lanes, run=m), want),
                *(max_abs_err(blocked.scatter_min_batched_on(
                    r, L, t, v, n, lanes, run=m), want)
                  for r in variants("scatter")))
            del t, v, want
            want = cv.pointer_jump_batched_plain(L, n, lanes)
            err["pointer_jump_batched"] = max(
                err["pointer_jump_batched"], max_abs_err(
                    cv.pointer_jump_batched(L, n, lanes), want),
                *(max_abs_err(cv.pointer_jump_batched_on(r, L, n, lanes),
                              want) for r in variants("jump")))
            del want
            jumped = cv.pointer_jump_batched_plain(L, n)
            swept = blocked.fused_relax_batched_plain(L, src, dst, n)
            early = [cv.converged_early_batched] + [
                lambda *a, r=r: cv.converged_early_batched_on(r, *a)
                for r in variants("converged")]
            for key, fns, plain, args in (
                    ("converged_early_batched", early,
                     cv.converged_early_batched_plain, (L, src, dst, n)),
                    ("labels_unchanged_batched",
                     [cv.labels_unchanged_batched],
                     cv.labels_unchanged_batched_plain, (jumped, L, n)),
                    ("labels_unchanged_batched",
                     [cv.labels_unchanged_batched],
                     cv.labels_unchanged_batched_plain, (swept, L, n))):
                b = cv.fleet_state(lanes_b, DEVICE)
                if lanes is not None:
                    b.lanes.copy_(lanes)
                plain(*args, b)
                for fn in fns:
                    a = cv.fleet_state(lanes_b, DEVICE)
                    if lanes is not None:
                        a.lanes.copy_(lanes)
                    fn(*args, a)
                    err[key] = max(err[key], max_abs_err(a.lanes, b.lanes),
                                   max_abs_err(a.fleet, b.fleet))
            del jumped, swept
            checks += 1
    sync()
    if any(err.values()):
        raise AssertionError(f"the fleet's kernels differ from their plain "
                             f"versions: {dict(err)}")
    del Lx
    t1, v1 = contour.mm_update_stream_batched(L0, src, dst, n, 1)
    t1_long = t1.long()
    k = int(t1.shape[0])
    state = cv.fleet_state(lanes_b, DEVICE)

    def fresh():
        state.lanes.zero_()
        state.fleet.zero_()

    def relax_ms(r):
        return time_ms(lambda: blocked.fused_relax_batched_on(
            r, L0, src, dst, n))

    def early_ms(L, r):
        return time_each_ms(lambda: cv.converged_early_batched_on(
            r, L, src, dst, n, state), setup=fresh)

    lane_relax, lane_early = route["relax"], route["converged"]
    relax_routes = {
        "lane": {"source": FLEET_SOURCE,
                 "blocks_per_lane": lane_relax.blocks_per_lane,
                 "ms": relax_ms(lane_relax)},
        "global": {"source": SOURCE, "ms": relax_ms(fleet.GLOBAL)}}
    early_routes = {
        "lane": {"source": FLEET_SOURCE,
                 "blocks_per_lane": lane_early.blocks_per_lane,
                 "ms": early_ms(Lf, lane_early),
                 "live_ms": early_ms(L1, lane_early)},
        "global": {"source": CONVERGED_SOURCE, "ms": early_ms(
            Lf, fleet.GLOBAL), "live_ms": early_ms(L1, fleet.GLOBAL)}}
    def scatter_ms(r):
        return time_ms(lambda: blocked.scatter_min_batched_on(
            r, L0, t1, v1, n, run=m))

    def jump_ms(r):
        return time_each_ms(lambda: cv.pointer_jump_batched_on(r, L0, n),
                            setup=flush_l2)

    scatter_routes = {
        "lane": {"source": FLEET_SOURCE,
                 "blocks_per_lane": route["scatter"].blocks_per_lane,
                 "ms": scatter_ms(route["scatter"]),
                 "c1_ms": scatter_ms(fleet.FleetRoute("lane", 1)),
                 "c4_ms": scatter_ms(fleet.FleetRoute("lane", 4))},
        "global": {"source": SOURCE, "ms": scatter_ms(fleet.GLOBAL)}}
    jump_routes = {
        "lane": {"source": FLEET_SOURCE,
                 "blocks_per_lane": route["jump"].blocks_per_lane,
                 "ms": jump_ms(route["jump"]),
                 "c1_ms": jump_ms(fleet.FleetRoute("lane", 1)),
                 "c4_ms": jump_ms(fleet.FleetRoute("lane", 4))},
        "global": {"source": CONVERGED_SOURCE,
                   "ms": jump_ms(fleet.GLOBAL)}}
    live_edges, live_labels = witness_edges(L1, src, dst, n)
    Lf_copy = Lf.clone()
    # C-Syn's first iteration: one order-2 sweep from identity, no jump
    L_syn = blocked.fused_relax_batched_plain(L0, src, dst, n)
    syn_labels = witness_labels(L_syn, L0, n)

    def unchanged_ms(a, b):
        return time_each_ms(lambda: cv.labels_unchanged_batched(
            a, b, n, state), setup=fresh)
    shape = {"B": lanes_b, "n": n, "m": m, "labels": lanes_b * n}
    entries = {
        "fused_relax_batched": {
            "source": FLEET_SOURCE, "state": "identity (the first sweep)",
            "ms": relax_routes["lane"]["ms"], "routes": relax_routes,
            "plain_ms": time_ms(lambda: blocked.fused_relax_batched_plain(
                L0, src, dst, n)),
            "library_ms": None,
            **bound(8 * lanes_b * n + 8 * lanes_b * m, 5 * lanes_b * m)},
        "scatter_min_batched": {
            "source": FLEET_SOURCE, "state": "identity, order-1 stream",
            "updates": k, "ms": scatter_routes["lane"]["ms"],
            "routes": scatter_routes,
            "plain_ms": time_ms(lambda: blocked.scatter_min_batched_plain(
                L0, t1, v1, n)),
            "library_ms": time_ms(
                lambda: L0.scatter_reduce(0, t1_long, v1, "amin")),
            **bound(8 * lanes_b * n + 8 * k, k)},
        "converged_early_batched": {
            "source": FLEET_SOURCE, "state": "fixed point, every lane",
            "ms": early_routes["lane"]["ms"], "routes": early_routes,
            "live": {"state": "one C-2 iteration from identity",
                     "ms": early_routes["lane"]["live_ms"],
                     "edges_to_first_witness": live_edges,
                     **bound(8 * live_edges + 4 * live_labels,
                             3 * live_edges)},
            "plain_ms": time_each_ms(lambda: cv.converged_early_batched_plain(
                Lf, src, dst, n, state), setup=fresh),
            "library_ms": None,
            **bound(8 * lanes_b * m + 4 * lanes_b * n, 3 * lanes_b * m)},
        "labels_unchanged_batched": {
            "source": CONVERGED_SOURCE, "state": "fixed point, every lane",
            "ms": unchanged_ms(Lf, Lf_copy),
            "live": {"state": "one C-Syn iteration from identity",
                     "ms": unchanged_ms(L_syn, L0),
                     "plain_ms": time_each_ms(
                         lambda: cv.labels_unchanged_batched_plain(
                             L_syn, L0, n, state), setup=fresh),
                     "labels_to_first_witness": syn_labels,
                     **bound(8 * syn_labels, syn_labels)},
            "plain_ms": time_each_ms(
                lambda: cv.labels_unchanged_batched_plain(
                    Lf, Lf_copy, n, state), setup=fresh),
            "library_ms": None,
            **bound(8 * lanes_b * n, lanes_b * n)},
        "pointer_jump_batched": {
            "source": FLEET_SOURCE, "state": "identity, L2 flushed",
            "ms": jump_routes["lane"]["ms"], "routes": jump_routes,
            "plain_ms": time_each_ms(
                lambda: cv.pointer_jump_batched_plain(L0, n),
                setup=flush_l2),
            "library_ms": None,
            **bound(8 * lanes_b * n, lanes_b * n)},
    }
    emit({"phase": "batch_kernels_vs_plain", "checks": checks,
          "shape": shape, "routes": {k: r._asdict() for k, r in route.items()},
          "times": {k: {f: e[f] for f in ("ms", "plain_ms", "library_ms",
                                          "bound_ms")}
                    for k, e in entries.items()},
          "route_times": {"fused_relax_batched": relax_routes,
                          "converged_early_batched": early_routes,
                          "scatter_min_batched": scatter_routes,
                          "pointer_jump_batched": jump_routes},
          "live": {k: entries[k]["live"] for k in (
              "converged_early_batched", "labels_unchanged_batched")}})
    return {name: {"name": name, "route": "cuda",
                   "replaces": REPLACES[name], "max_abs_err": err[name],
                   "shape": shape, **entry}
            for name, entry in entries.items()}


# the entry points a fleet's variant must launch (drive_variant)
VARIANT_LAUNCHES = {
    # its two order-1 sweeps run K2 fleet, its jumps K7 fleet
    "C-11mm": ("scatter_min_batched", "pointer_jump_batched"),
    # an order-2 sweep and the no-change test an iteration, no jump
    "C-Syn": ("fused_relax_batched", "labels_unchanged_batched")}


def drive_variant(name: str, batched: Graph, sizes, variant: str) -> dict:
    """A fleet's ``variant`` (C-11mm or C-Syn): the entry points of
    :data:`VARIANT_LAUNCHES` launched, each routed one on the lane route
    alone, the result bit for bit the ``torch`` backend's; cold and warm
    walls (host clock, warm = mean of ``REPS``) beside the ``torch``
    backend's fleet (warm = mean of ``PLAIN_FLEET_REPS``)."""
    def run(**options):
        return solve_batch(batched, batch_sizes=sizes, variant=variant,
                           **options)

    sync()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = run()
    sync()
    cold_ms = (time.perf_counter() - t0) * 1e3
    launches, routes = launch_counts(), route_counts()
    for k in VARIANT_LAUNCHES[variant]:
        if launches[k] <= 0:
            raise AssertionError(f"{name}: the fleet's {variant} did not "
                                 f"launch {k}")
    lane_alone(f"{name} {variant}", launches, routes)
    warm_ms = host_ms(run)
    t0 = time.perf_counter()
    plain = run(backend="torch")
    sync()
    plain_cold_ms = (time.perf_counter() - t0) * 1e3
    same_result(res, plain, f"{name}: the fleet's {variant} against the "
                            "torch backend's")
    plain_warm_ms = torch_backend_warm_ms(run)
    its = res.iterations.cpu()
    row = {"phase": "batch_path", "fleet": name, "variant": variant,
           "batched_cold_ms": cold_ms, "batched_warm_ms": warm_ms,
           "torch_backend_cold_ms": plain_cold_ms,
           "torch_backend_warm_ms": plain_warm_ms,
           "torch_backend_warm_reps": PLAIN_FLEET_REPS,
           "iterations_max": int(its.max()),
           "iterations_mean": float(its.float().mean()),
           "launches": launches, "routes": routes}
    emit(row)
    return row


def phase_batch() -> tuple:
    """The fleet path (module docstring); returns the printed lines and
    the kernels line's entries of the fleet's entry points."""
    rows = []
    row, batched, sizes = drive_fleet("rmat")
    rows.append(row)
    # the order-1 sweeps: C-11mm's warm-up runs K2's fleet entry point;
    # C-Syn runs the no-change test
    rows.append(drive_variant(row["fleet"], batched, sizes, "C-11mm"))
    rows.append(drive_variant(row["fleet"], batched, sizes, "C-Syn"))
    fixed = solve_batch(batched).labels
    kernels = fleet_kernels(batched, fixed)
    # launches a solve of the fleet's path: dense C-2 on the rmat fleet,
    # C-11mm for K2's order-1 sweeps and C-Syn for the no-change test
    by_key = {"scatter_min_batched": rows[1],
              "labels_unchanged_batched": rows[2]}
    for key, entry in kernels.items():
        source = by_key.get(key, rows[0])
        entry["launches_per_solve"] = {
            "path": f"{source['fleet']}, {source.get('variant', 'C-2')}",
            "launches": source["launches"][key],
            **({"routes": source["routes"][key]} if key in ROUTED else {})}
    del batched, fixed
    for kind in ("delaunay", "ragged"):
        row, batched, sizes = drive_fleet(kind)
        rows.append(row)
        if kind == "ragged":
            rows.append(drive_variant(row["fleet"], batched, sizes,
                                      "C-11mm"))
        del batched
    rows.append(fleet_check_scale())
    return rows, kernels


def drive_auto(g, name: str, reference: np.ndarray, dense_ms: float) -> dict:
    """``solve(g, algorithm="auto")`` on the card: the cost model's choice
    and the skew computed where the edges lie, labels equal to scipy's,
    the wall beside dense C-2's."""
    sync()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = solve(g, algorithm="auto")
    sync()
    cold_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    if not np.array_equal(res.labels.cpu().numpy(), reference):
        raise AssertionError(f"auto {name}: labels differ from scipy")
    skew = device_degree_skew(g.src, g.dst, g.n_vertices)
    t0 = time.perf_counter()
    for _ in range(3):
        solve(g, algorithm="auto")
        sync()
    warm_ms = (time.perf_counter() - t0) / 3 * 1e3
    out = {"phase": "auto_path", "graph": name, "n": g.n_vertices,
           "m": g.n_edges, "choice": res.provenance[0],
           "provenance": list(res.provenance), "degree_skew": skew,
           "avg_degree": 2 * g.n_edges / g.n_vertices,
           "skew_ms": host_ms(lambda: device_degree_skew(
               g.src, g.dst, g.n_vertices)),
           "auto_cold_ms": cold_ms, "auto_warm_ms": warm_ms,
           "dense_c2_warm_ms": dense_ms, "x_dense_c2": warm_ms / dense_ms,
           "iterations": int(res.iterations),
           "host_syncs": host_syncs(
               lambda: solve(g, algorithm="auto"))["total"],
           "launches": launches}
    emit(out)
    return out


def drive_autotune(g, name: str, reference: np.ndarray) -> dict:
    """``planner.autotune`` on ``g`` into a cache under a temporary
    ``REPRO_TORCH_TUNING_CACHE``: its timings table, then one solve that
    records ``origin=tuned``."""
    env = planner.cache.ENV_CACHE_PATH
    saved = os.environ.get(env)
    with tempfile.TemporaryDirectory() as d:
        os.environ[env] = str(Path(d) / "tuning.json")
        try:
            reset_launch_counts()
            t0 = time.perf_counter()
            plan, timings = planner.autotune(g)
            tune_s = time.perf_counter() - t0
            res = solve(g, sampling=2, compact_every=2)
            sync()
            launches = launch_counts()
            entry = planner.cache.entries()
        finally:
            if saved is None:
                os.environ.pop(env, None)
            else:
                os.environ[env] = saved
    if not res.provenance[0].startswith(f"plan:{plan.backend} origin=tuned"):
        raise AssertionError(f"autotune {name}: the solve after tuning "
                             f"recorded {res.provenance[0]}")
    if not np.array_equal(res.labels.cpu().numpy(), reference):
        raise AssertionError(f"autotune {name}: labels differ from scipy")
    out = {"phase": "auto_path", "graph": name, "check": "autotune",
           "timings_s": timings, "winner": planner.plan_label(plan),
           "tune_s": tune_s, "provenance": list(res.provenance),
           "cache_keys": sorted(entry), "launches": launches}
    emit(out)
    return out


def float_err(a: torch.Tensor, b: torch.Tensor, tol: tuple) -> dict:
    """Kernel output ``a`` against plain output ``b`` in float32, ``tol`` =
    (atol, rtol, rms_rel): max |a - b|, how far the worst element lies past
    ``atol + rtol * |b|`` (<= 0 when every element is inside), and
    rms(a - b) / rms(b) beside its limit ``rms_rel``."""
    atol, rtol, rms_rel = tol
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    return {"max_abs_err": float(diff.max()),
            "excess": float((diff - atol - rtol * b.abs()).max()),
            "rel_rms_err": float(diff.square().mean().sqrt()
                                 / b.square().mean().sqrt()),
            "rel_rms_limit": rms_rel,
            "finite": bool(torch.isfinite(a).all())}


def check_close(what: str, err: dict) -> None:
    if (not err["finite"] or err["excess"] > 0
            or not err["rel_rms_err"] <= err["rel_rms_limit"]):
        raise AssertionError(f"{what}: kernel differs from its plain "
                             f"version: {err}")


def randn(shape, dtype, gen_) -> torch.Tensor:
    return torch.randn(shape, device=DEVICE, generator=gen_).to(dtype)


def rmsnorm_bound(rows: int, d: int, dtype) -> dict:
    # read x, write y, read w (float32); per element a square-add, a
    # scale and a weight product
    size = torch.finfo(dtype).bits // 8
    return bound(2 * rows * d * size + 4 * d, 4 * rows * d)


def flash_bound(b, h, hkv, t, s, hd, causal, dtype) -> dict:
    # q, k, v read once, o written once; two products of 2 * T * S * hd
    # operations a head, half of them past the diagonal when causal
    size = torch.finfo(dtype).bits // 8
    ops = 4 * b * h * t * s * hd // (2 if causal else 1)
    rate = (BF16_TENSOR_OPS_PER_S if dtype in (torch.bfloat16, torch.float16)
            else ALU_OPS_PER_S)
    return bound(size * hd * (2 * b * h * t + 2 * b * hkv * s), ops, rate)


def phase_rmsnorm_vs_plain() -> dict:
    """``rmsnorm_rows`` against ``rmsnorm_rows_plain`` on the card."""
    gen_ = torch.Generator(device=DEVICE).manual_seed(0)
    cases = [
        # mistral-nemo-12b's d_model over 8 x 4096 tokens
        ("nemo", 32768, NEMO["d"], torch.bfloat16, torch.bfloat16),
        # yi-6b's d_model, a ragged row count
        ("yi", 4095, 4096, torch.float32, torch.float32),
        ("small", 7, 128, torch.float32, torch.float32),
        ("bf16_x_f32_w", 4096, NEMO["d"], torch.bfloat16,
         torch.float32),
        ("nemo_f16", 32768, NEMO["d"], torch.float16, torch.float16),
        ("f16_x_f32_w", 4095, 4096, torch.float16, torch.float32),
    ]
    out, worst = {}, 0.0
    for name, rows, d, x_dtype, w_dtype in cases:
        x = randn((rows, d), x_dtype, gen_)
        w = randn((d,), w_dtype, gen_)
        a = rms_kernel.rmsnorm_rows(x, w)
        b = rms_kernel.rmsnorm_rows_plain(x, w)
        sync()
        err = float_err(a, b, RMS_TOL[x_dtype])
        check_close(f"rmsnorm_rows {name}", err)
        worst = max(worst, err["max_abs_err"])
        out[name] = {"shape": [rows, d], "x": str(x_dtype),
                     "w": str(w_dtype), **err}
        del x, w, a, b
    emit({"phase": "rmsnorm_vs_plain", "checks": len(cases), "cases": out,
          "max_abs_err": worst})
    return {"max_abs_err": worst}


def phase_flash_vs_plain() -> dict:
    """``flash_mha`` against ``flash_mha_plain`` on the card, and the
    inputs it must refuse."""
    gen_ = torch.Generator(device=DEVICE).manual_seed(1)
    H, Hkv, hd = NEMO["H"], NEMO["Hkv"], NEMO["hd"]
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    cases = [
        # (name, b, h, hkv, t, s, hd, causal, dtype)
        ("nemo_causal", 2, H, Hkv, 4096, 4096, hd, True, bf16),
        ("nemo", 2, H, Hkv, 4096, 4096, hd, False, bf16),
        ("nemo_ragged", 2, H, Hkv, 4000, 4000, hd, True, bf16),
        ("nemo_t1024_s4096", 2, H, Hkv, 1024, 4096, hd, True, bf16),
        # zamba2-2.7b and xlstm-125m's heads
        ("zamba2_hd80", 2, 32, 32, 1024, 1024, 80, True, bf16),
        ("xlstm_hd192", 2, 4, 4, 1024, 1024, 192, True, bf16),
        ("mqa", 2, H, 1, 1024, 1024, hd, True, bf16),
        ("nemo_f32", 2, H, Hkv, 512, 512, hd, True, f32),
        ("nemo_causal_f16", 2, H, Hkv, 4096, 4096, hd, True, f16),
        ("nemo_ragged_f16", 2, H, Hkv, 4000, 4000, hd, True, f16),
        ("xlstm_hd192_f16", 2, 4, 4, 1024, 1024, 192, True, f16),
        ("zamba2_hd80_f16", 2, 32, 32, 1024, 1024, 80, False, f16),
    ]
    out, worst = {}, 0.0
    for name, b, h, hkv, t, s, d, causal, dtype in cases:
        q = randn((b, h, t, d), dtype, gen_)
        k = randn((b, hkv, s, d), dtype, gen_)
        v = randn((b, hkv, s, d), dtype, gen_)
        a = flash_kernel.flash_mha(q, k, v, causal=causal)
        sync()
        ref = flash_kernel.flash_mha_plain(q, k, v, causal=causal)
        sync()
        err = float_err(a, ref, FLASH_TOL[dtype])
        check_close(f"flash_mha {name}", err)
        worst = max(worst, err["max_abs_err"])
        out[name] = {"shape": [b, h, hkv, t, s, d], "causal": causal,
                     "dtype": str(dtype), **err}
        del q, k, v, a, ref
    torch.cuda.empty_cache()
    # inputs the kernel does not take raise before any launch; a launch
    # held to the 48 KB of shared memory it gets without asking is refused
    # and raises
    q = randn((1, 4, 64, 128), bf16, gen_)
    kv = randn((1, 2, 64, 128), bf16, gen_)
    bad = randn((1, 2, 8, 260), bf16, gen_)
    # a contiguous view one element into a buffer: not 16-byte aligned
    q_offset = randn((q.numel() + 1,), bf16, gen_)[1:].view(q.shape)
    refused = [
        ("hd260", lambda: flash_kernel.flash_mha(bad, bad, bad), ValueError),
        ("h_not_multiple", lambda: flash_kernel.flash_mha(
            q[:, :3].contiguous(), kv, kv), ValueError),
        ("cpu_mixed", lambda: flash_kernel.flash_mha(q, kv.cpu(), kv),
         ValueError),
        ("misaligned", lambda: flash_kernel.flash_mha(q_offset, kv, kv),
         ValueError),
        ("smem_48k", lambda: flash_kernel.launch(
            q, kv, kv, torch.empty_like(q), True, 48 * 1024), RuntimeError),
    ]
    for name, call, error in refused:
        if not raises(call, error):
            raise AssertionError(f"flash_mha took {name}")
    emit({"phase": "flash_vs_plain", "checks": len(cases) + len(refused),
          "cases": out, "refused": [r[0] for r in refused],
          "max_abs_err": worst})
    return {"max_abs_err": worst}


def path_run(name: str, fn) -> tuple:
    """``fn()`` once with every launch count set to 0 just before and read
    just after; returns its output and the counts."""
    sync()
    reset_launch_counts()
    t0 = time.perf_counter()
    y = fn()
    sync()
    wall = time.perf_counter() - t0
    return y, {"phase": name, "wall_s": wall, "launches": launch_counts()}


def phase_rmsnorm_path() -> dict:
    """``fused_rmsnorm(x, w)`` at mistral-nemo-12b's width over 8 x 4096
    tokens, bfloat16, with its times beside its
    bound, its plain version and ``torch.nn.functional.rms_norm`` (timed
    only)."""
    gen_ = torch.Generator(device=DEVICE).manual_seed(2)
    d = NEMO["d"]
    x = randn((8, 4096, d), torch.bfloat16, gen_)
    w = randn((d,), torch.bfloat16, gen_)
    y, run = path_run("rmsnorm_path", lambda: fused_rmsnorm(x, w))
    if run["launches"]["rmsnorm_rows"] <= 0:
        raise AssertionError("fused_rmsnorm did not launch rmsnorm_rows")
    if y.shape != x.shape or y.dtype != x.dtype:
        raise AssertionError(f"fused_rmsnorm gave {y.dtype} {y.shape}")
    err = float_err(y, rmsnorm_ref(x, w), RMS_TOL[x.dtype])
    check_close("fused_rmsnorm", err)
    rows = x.numel() // d
    run.update({
        "shape": {"rows": rows, "d": d, "dtype": "bfloat16"}, **err,
        "ms": time_ms(lambda: fused_rmsnorm(x, w)),
        "plain_ms": time_ms(lambda: fused_rmsnorm(x, w, backend="torch")),
        "library_ms": time_ms(lambda: torch.nn.functional.rms_norm(
            x, (d,), w, eps=1e-5)),
        **rmsnorm_bound(rows, d, x.dtype)})
    # the same call in float16
    x, w = x.half(), w.half()
    y = fused_rmsnorm(x, w)
    if y.dtype != torch.float16:
        raise AssertionError(f"fused_rmsnorm gave {y.dtype} for float16")
    err = float_err(y, rmsnorm_ref(x, w), RMS_TOL[x.dtype])
    check_close("fused_rmsnorm float16", err)
    run["float16"] = {
        **err, "ms": time_ms(lambda: fused_rmsnorm(x, w)),
        "plain_ms": time_ms(lambda: fused_rmsnorm(x, w, backend="torch")),
        "library_ms": time_ms(lambda: torch.nn.functional.rms_norm(
            x, (d,), w, eps=1e-5)),
        **rmsnorm_bound(rows, d, x.dtype)}
    emit(run)
    return run


def phase_flash_path() -> dict:
    """``flash_attention(q, k, v)`` (causal) at mistral-nemo-12b's heads
    over 2 x 4096 tokens, bfloat16, with its times
    beside its bound, its plain version and
    ``scaled_dot_product_attention`` (timed only)."""
    gen_ = torch.Generator(device=DEVICE).manual_seed(3)
    b, t, H, Hkv, hd = 2, 4096, NEMO["H"], NEMO["Hkv"], NEMO["hd"]
    q = randn((b, H, t, hd), torch.bfloat16, gen_)
    k = randn((b, Hkv, t, hd), torch.bfloat16, gen_)
    v = randn((b, Hkv, t, hd), torch.bfloat16, gen_)
    o, run = path_run("flash_path", lambda: flash_attention(q, k, v))
    if run["launches"]["flash_mha"] <= 0:
        raise AssertionError("flash_attention did not launch flash_mha")
    if o.shape != q.shape or o.dtype != q.dtype:
        raise AssertionError(f"flash_attention gave {o.dtype} {o.shape}")
    err = float_err(o, mha_ref(q, k, v), FLASH_TOL[q.dtype])
    check_close("flash_attention", err)
    del o
    torch.cuda.empty_cache()
    run.update({
        "shape": {"B": b, "H": H, "Hkv": Hkv, "T": t, "S": t, "hd": hd,
                  "causal": True, "dtype": "bfloat16"}, **err,
        "ms": time_ms(lambda: flash_attention(q, k, v)),
        "plain_ms": time_ms(lambda: flash_attention(q, k, v,
                                                    backend="torch")),
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)),
        "smem_bytes": flash_kernel.smem_bytes(hd, q.dtype),
        **flash_bound(b, H, Hkv, t, t, hd, True, q.dtype)})
    # the same call in float16
    qh, kh, vh = q.half(), k.half(), v.half()
    o = flash_attention(qh, kh, vh)
    if o.dtype != torch.float16:
        raise AssertionError(f"flash_attention gave {o.dtype} for float16")
    err = float_err(o, mha_ref(qh, kh, vh), FLASH_TOL[qh.dtype])
    check_close("flash_attention float16", err)
    del o
    torch.cuda.empty_cache()
    run["float16"] = {
        **err, "ms": time_ms(lambda: flash_attention(qh, kh, vh)),
        "plain_ms": time_ms(lambda: flash_attention(qh, kh, vh,
                                                    backend="torch")),
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, enable_gqa=True)),
        **flash_bound(b, H, Hkv, t, t, hd, True, qh.dtype)}
    del qh, kh, vh
    emit(run)
    emit({"phase": "flash_hopper", **flash_hopper(q, k, v, run)})
    torch.cuda.empty_cache()
    return run


def flash_hopper(q, k, v, run: dict) -> dict:
    """What shows the 16-bit kernel's design on the card: its rate on the
    counted FLOP and on the FLOP its tensor cores issue (1.5x: the split P
    multiplies V twice; the causal diagonal tiles, computed whole, add ~3%
    more at T = 4096 that neither count includes), in bfloat16 and
    (``run["float16"]``) float16; SDPA's own error against ``mha_ref`` on
    the bfloat16 ``q``, ``k``, ``v`` and on their float16 copies (it
    rounds P to the input's type, so in bfloat16 it is expected past the
    rms limit); and the ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load)
    instructions in each bfloat16 and float16 instance's SASS; raises if
    an instance is missing or has none of either."""
    sdpa_err = {}
    for dtype in (torch.bfloat16, torch.float16):
        qd, kd, vd = q.to(dtype), k.to(dtype), v.to(dtype)
        sdpa = torch.nn.functional.scaled_dot_product_attention(
            qd, kd, vd, is_causal=True, enable_gqa=True)
        err = float_err(sdpa, mha_ref(qd, kd, vd), FLASH_TOL[dtype])
        err["within_flash_tol"] = (err["excess"] <= 0 and
                                   err["rel_rms_err"] <= err["rel_rms_limit"])
        sdpa_err[str(dtype)] = err
        del qd, kd, vd, sdpa
    sass = sass_counts(_build.library_path(flash_kernel.LIBRARY,
                                           flash_kernel.SOURCES),
                       "flash_wgmma_kernel", ("HGMMA", "UTMALDG"))
    instances = {dtype: [name for name in sass if mangled in name]
                 for dtype, mangled in (("bfloat16", "nv_bfloat16"),
                                        ("float16", "__half"))}
    if any(len(names) != len(flash_kernel.HEAD_DIM_BUCKETS)
           for names in instances.values()) or not all(
            all(counts.values()) for counts in sass.values()):
        raise AssertionError(f"16-bit flash instances missing or without "
                             f"wgmma or TMA loads in their SASS: {sass}")
    f16 = run["float16"]
    return {"tflops_counted": run["ops"] / run["ms"] / 1e9,
            "tflops_issued": 1.5 * run["ops"] / run["ms"] / 1e9,
            "float16_tflops_counted": f16["ops"] / f16["ms"] / 1e9,
            "float16_tflops_issued": 1.5 * f16["ops"] / f16["ms"] / 1e9,
            "sdpa_vs_mha_ref": sdpa_err, "sass": sass}


def sass_counts(library: Path, kernel_name: str, opcodes) -> dict:
    """Occurrences of each opcode in the SASS of every function of the
    library whose (mangled) name holds ``kernel_name``, from
    ``cuobjdump -sass``, by function."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts = {}
    for section in sass.split("Function : ")[1:]:
        name, _, body = section.partition("\n")
        if kernel_name in name:
            counts[name.strip()] = {op: body.count(op) for op in opcodes}
    return counts


def float_kernel_entry(name: str, source: str, checked: dict,
                       path: dict) -> dict:
    """A float kernel's entry of the kernels line, from its check phase
    and its path phase."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name],
            "max_abs_err": checked["max_abs_err"], "ms": path["ms"],
            "plain_ms": path["plain_ms"], "library_ms": path["library_ms"],
            "shape": path["shape"], "bound_ms": path["bound_ms"],
            "bound_by": path["bound_by"], "bytes": path["bytes"],
            "ops": path["ops"]}


def lm_events_ms(fn, reps: int) -> tuple:
    """Mean host-clock wall (to ``synchronize()``) and device time (CUDA
    events) of ``fn()`` over ``reps`` calls after a warm one, in ms, and
    the last call's output."""
    fn()
    sync()
    walls, pairs = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        sync()
        walls.append(time.perf_counter() - t0)
        pairs.append((start, end))
    return (sum(walls) / reps * 1e3,
            sum(a.elapsed_time(b) for a, b in pairs) / reps, out)


def lm_bounds(model, prompt: int, cache, kept=None) -> dict:
    """The least times of a prefill of ``prompt`` tokens and of a decode
    step against its ``cache`` (``prompt + 1`` valid positions), for
    every family.

    Prefill: its products at the bf16 tensor-core rate, 2 operations a
    weight a token it meets (a shared block's weights once a use; an
    encoder's and the cross K/V projections' once a frame, the stub's
    ``max(prompt // 2, 4)``; the LM head at the last position only; an
    MoE layer's experts only for the assignments it keeps, ``kept``
    summed over the layers, or every token's top-k), and attention's two
    products in every attention layer (causal halves; the encoder's and
    the cross-attention's whole), none in a recurrent layer (the GLA and
    sLSTM recurrences' own products, under 0.1% of the weights' at these
    widths, are not counted).  Decode: at the HBM rate, every weight the
    step reads once (not the embedding table, the frontend projections,
    the encoder or the cross K/V projections), the valid K/V, the cross
    K/V, and each recurrent state read and written; for an MoE model also
    with only the activated experts (top-k a layer) read."""
    config = model.config
    d, vp, hd = config.d_model, config.padded_vocab, config.hd
    size = torch.finfo(config.param_dtype).bits // 8
    count = {path: int(np.prod(spec.shape)) for path, spec in
             lm_common.tree_leaves_with_path(model.param_specs(),
                                             lm_common.is_spec)}

    def total(keep) -> int:
        return sum(n for path, n in count.items() if keep(path))

    def expert(path: str) -> bool:
        return path.rsplit(".", 1)[-1] in ("w_up_e", "w_gate_e", "w_down_e")

    def cross_kv(path: str) -> bool:
        return ".cross_attn.w" in path and path[-2:] in ("wk", "wv")

    frontend = total(lambda p: p in ("embed.patch_proj", "embed.frame_proj"))
    table = count["embed.tok_embed"]
    read = sum(count.values()) - frontend - (
        0 if config.tie_embeddings else table)
    pair_ops = 4 * hd * config.n_heads        # both products, a q-k pair
    t = prompt
    if config.family == "audio":
        frames = max(prompt // 2, 4)
        enc_plan, dec_plan = model.enc_plan, model.dec_plan
        weight_ops = 2 * frames * total(
            lambda p: p.startswith("encoder.") or p == "embed.frame_proj") \
            + 2 * t * total(lambda p: p.startswith("decoder.")
                            and not cross_kv(p)) \
            + 2 * frames * total(cross_kv)
        attn_ops = pair_ops * (enc_plan.n_repeat * frames * frames
                               + dec_plan.n_repeat * t * frames)
        causal_ops = pair_ops * dec_plan.n_repeat * t * t
        read -= total(lambda p: p.startswith("encoder.") or cross_kv(p))
    else:
        plan = model.plan
        n_attn = sum(b in lm_tfm._ATTN_BLOCKS for b in plan.prefix) + \
            plan.n_repeat * (sum(b in lm_tfm._ATTN_BLOCKS for b in plan.unit)
                             + (plan.shared in lm_tfm._ATTN_BLOCKS))
        shared = total(lambda p: p.startswith("backbone.shared."))
        weight_ops = 2 * t * (total(lambda p: p.startswith("backbone.")
                                    and not expert(p)) - shared
                              + shared * plan.n_repeat)
        attn_ops, causal_ops = 0, pair_ops * n_attn * t * t
        if config.n_experts:
            n_moe = plan.n_repeat
            per_expert = total(expert) // (n_moe * config.n_experts)
            kept = t * config.top_k * n_moe if kept is None else kept
            weight_ops += 2 * kept * per_expert
            activated = read - total(expert) + \
                config.top_k * per_expert * n_moe
    weight_ops += 2 * d * vp                  # the LM head, last position
    state_bytes = kv_token = 0
    for path, leaf in lm_common.tree_leaves_with_path(
            cache, lambda x: isinstance(x, (torch.Tensor, int))):
        if not isinstance(leaf, torch.Tensor):
            continue
        nbytes = leaf.numel() * leaf.element_size()
        name = path.rsplit(".", 1)[-1]
        if name in ("k", "v"):                # positions: the third last
            kv_token += nbytes // leaf.shape[-3]
        else:                                 # cross K/V read; states r+w
            state_bytes += nbytes * (1 if name.startswith("cross") else 2)
    cache_bytes = (prompt + 1) * kv_token + state_bytes
    prefill_ops = weight_ops + attn_ops + causal_ops // 2
    out = {
        "prefill_ops": prefill_ops,
        "prefill_bound_ms": prefill_ops / BF16_TENSOR_OPS_PER_S * 1e3,
        "prefill_bound_ms_every_block":
            (weight_ops + attn_ops + causal_ops) / BF16_TENSOR_OPS_PER_S
            * 1e3,
        "decode_bytes": read * size + cache_bytes,
        "decode_bound_ms": (read * size + cache_bytes) / HBM_BYTES_PER_S
        * 1e3,
        "decode_weights_bound_ms": read * size / HBM_BYTES_PER_S * 1e3,
        "kv_bytes_a_token": kv_token, "state_bytes": state_bytes}
    if config.n_experts:
        out.update({
            "kept_assignments": kept,
            "decode_activated_bytes": activated * size + cache_bytes,
            "decode_activated_bound_ms": (activated * size + cache_bytes)
            / HBM_BYTES_PER_S * 1e3})
    return out


def lm_batch(config, tokens: torch.Tensor, frames=None) -> dict:
    """A prefill batch of ``tokens`` (B, T) with the server's stub inputs:
    ``patch_embeds`` of zeros for a ``patch_stub`` frontend and, for an
    ``audio_stub`` one, ``frames`` or zeros at ``max(T // 2, 4)``."""
    b, t = tokens.shape
    batch = {"tokens": tokens}
    if config.frontend == "patch_stub":
        batch["patch_embeds"] = torch.zeros(
            (b, min(config.n_frontend_tokens, t), config.d_model),
            device=tokens.device)
    if config.frontend == "audio_stub":
        batch["frame_embeds"] = frames if frames is not None else \
            torch.zeros((b, max(t // 2, 4), config.d_model),
                        device=tokens.device)
    return batch


def lm_consistency(model, params, config) -> dict:
    """The reference's prefill/decode criterion (tests/test_models.py:
    71-106): prefill ``prompt`` tokens, decode the rest one at a time; the
    last step's logits against the whole sequence's prefill at its last
    position.  ``excess`` > 0 where an element lies past atol + rtol |b|.
    An encoder-decoder encodes the same seeded frames in both."""
    c = LM_CONSISTENCY
    rng = np.random.default_rng(3)
    tokens = torch.as_tensor(rng.integers(0, config.vocab_size,
                                          (c["batch"], c["tokens"])),
                             device=DEVICE)
    frames = torch.as_tensor(rng.standard_normal(
        (c["batch"], c["tokens"] // 2, config.d_model)), dtype=torch.float32,
        device=DEVICE)
    with torch.inference_mode():
        full, _ = model.prefill(params, lm_batch(config, tokens, frames))
        logits, cache = model.prefill(
            params, lm_batch(config, tokens[:, :c["prompt"]], frames),
            max_len=c["tokens"])
        for i in range(c["prompt"], c["tokens"]):
            logits, cache = model.decode_step(params, tokens[:, i:i + 1],
                                              cache)
    a, b = logits[:, -1].float(), full[:, -1].float()
    diff = (a - b).abs()
    return {"max_abs_diff": float(diff.max()),
            "excess": float((diff - c["tol"] - c["tol"] * b.abs()).max()),
            "max_abs_logit": float(b.abs().max()), "tol": c["tol"]}


def numpy_lm_params(config, seed: int):
    """Seeded float32 numpy weights in the reference's layout (ones and
    zeros where the specs say): what ``interop.lm_params_from_numpy``
    carries onto a device."""
    rng = np.random.default_rng(seed)

    def draw(spec):
        if spec.init in ("zeros", "ones"):
            return np.full(spec.shape, spec.init == "ones", np.float32)
        return (rng.standard_normal(spec.shape) * spec.scale).astype(
            np.float32)

    return lm_common.tree_map(draw, lm_param_specs(config), lm_common.is_spec)


def lm_card_vs_cpu(arch: str = LM_ARCH) -> dict:
    """The smoke config of ``arch`` in float32 on the card and on CPU
    tensors, the same carried-across weights (and seeded frames for an
    encoder-decoder): prefill and 4 decode steps' logits within
    ``LM_CPU_TOL``, greedy tokens equal."""
    config = get_arch(arch).smoke_config().replace(
        dtype=torch.float32, param_dtype=torch.float32)
    tree = numpy_lm_params(config, LM_SEED)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, config.vocab_size, (2, 12))
    frames = rng.standard_normal((2, 6, config.d_model)).astype(np.float32)
    outs = {}
    for dev in (DEVICE, "cpu"):
        model = build_model(config, device=dev)
        params = model.load_params(
            interop.lm_params_from_numpy(tree, config, device=dev))
        with torch.inference_mode():
            logits, cache = model.prefill(params, lm_batch(
                config, torch.as_tensor(tokens[:, :8], device=dev),
                torch.as_tensor(frames, device=dev)), max_len=12)
            out = [logits.cpu()]
            for i in range(8, 12):
                logits, cache = model.decode_step(
                    params, torch.as_tensor(tokens[:, i:i + 1], device=dev),
                    cache)
                out.append(logits.cpu())
        outs[dev] = out
    worst = 0.0
    for a, b in zip(outs[DEVICE], outs["cpu"]):
        worst = max(worst, float((a - b).abs().max()))
        if not torch.allclose(a, b, atol=LM_CPU_TOL, rtol=LM_CPU_TOL) or \
                not torch.equal(a.argmax(-1), b.argmax(-1)):
            raise AssertionError(f"LM card against CPU ({arch}): max "
                                 f"|diff| {float((a - b).abs().max())}")
    return {"arch": arch, "config": "smoke float32",
            "steps": len(outs["cpu"]),
            "max_abs_diff": worst, "tol": LM_CPU_TOL}


def lm_two_layers(config) -> dict:
    """``config`` at 2 layers, full width, weights drawn on the card:
    the prefill/decode consistency check, and bfloat16 against float32
    logits of the same weights (``LM_BF16_REL_RMS``)."""
    c2 = config.replace(n_layers=LM_CONSISTENCY["layers"])
    model = build_model(c2, device=DEVICE)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(LM_SEED))
    consistency = lm_consistency(model, params, c2)
    if consistency["excess"] > 0:
        raise AssertionError(f"LM prefill/decode consistency at "
                             f"{c2.n_layers} layers: {consistency}")
    c32 = c2.replace(dtype=torch.float32, param_dtype=torch.float32)
    model32 = build_model(c32, device=DEVICE)
    params32 = model32.load_params(params)
    tokens = torch.as_tensor(np.random.default_rng(4).integers(
        0, config.vocab_size, (2, 64)), device=DEVICE)
    with torch.inference_mode():
        a, _ = model.prefill(params, {"tokens": tokens})
        b, _ = model32.prefill(params32, {"tokens": tokens})
    a, b = a.float(), b.float()
    rel = float((a - b).square().mean().sqrt() / b.square().mean().sqrt())
    if not rel <= LM_BF16_REL_RMS:
        raise AssertionError(f"LM bfloat16 against float32: relative rms "
                             f"{rel} > {LM_BF16_REL_RMS}")
    return {"layers": c2.n_layers, "consistency": consistency,
            "bf16_vs_f32": {"rel_rms": rel, "bound": LM_BF16_REL_RMS,
                            "max_abs_diff": float((a - b).abs().max())}}


def lm_cross_checks(params, config, tokens) -> tuple:
    """K5 and K4 on the LM path's own tensors: layer 0's ``q, k, v`` of
    ``tokens`` against the path's ``attend_chunked`` (run in float32 from
    the same bfloat16 values: the function K5 computes; the path's own
    bfloat16 run rounds P to bfloat16 before P·V, and its error against
    that float32 run is reported beside), within ``FLASH_TOL``; and
    ``rmsnorm_rows`` against the path's ``apply_norm`` on the residual
    stream after layer 0 (layer 1's ``ln_attn``), within ``RMS_TOL``.
    Returns the errors and the run with the kernels' launches."""
    bf16 = config.dtype
    t = tokens.shape[1]
    unit = params["backbone"]["unit"][0]
    layer0, layer1 = lm_tfm._layer(unit, 0), lm_tfm._layer(unit, 1)
    chunks = {"q_chunk": config.attn_chunk_q,
              "kv_chunk": config.attn_chunk_kv}
    with torch.inference_mode():
        x = params["embed"]["tok_embed"][tokens].to(bf16)
        h = lm_common.apply_norm(x, layer0["ln_attn"], config)
        q, k, v = lm_attn._project_qkv(layer0["attn"], h, config)
        pos = torch.arange(t, device=DEVICE)
        cos, sin = lm_common.rope_angles(pos, config.hd, config.rope_theta)
        q, k = lm_common.apply_rope(q, cos, sin), lm_common.apply_rope(
            k, cos, sin)
        ctx = lm_tfm.placed(lm_tfm.BlockCtx(config, "train", pos, 0))
        x1, _, _ = lm_tfm._apply_attn_mlp(layer0, x, ctx, None,
                                          lm_tfm._attn_mlp_specs(config))
        path_f32 = lm_attn.attend_chunked(
            q.float(), k.float(), v.float(), causal=True, **chunks).to(bf16)
        path_bf16 = lm_attn.attend_chunked(q, k, v, causal=True, **chunks)
        norm = lm_common.apply_norm(x1, layer1["ln_attn"], config)
        heads = [a.transpose(1, 2).contiguous() for a in (q, k, v)]
        flash, run = path_run("lm_crosscheck", lambda: (
            flash_kernel.flash_mha(*heads, causal=True).transpose(1, 2),
            rms_kernel.rmsnorm_rows(x1.reshape(-1, config.d_model),
                                    layer1["ln_attn"]["scale"])))
    flash, rms = flash
    if run["launches"]["flash_mha"] != 1 or \
            run["launches"]["rmsnorm_rows"] != 1:
        raise AssertionError(f"LM cross-checks: {run['launches']}")
    attn_err = float_err(flash, path_f32, FLASH_TOL[bf16])
    check_close("flash_mha against the LM path's attend_chunked", attn_err)
    norm_err = float_err(rms.reshape(norm.shape), norm, RMS_TOL[bf16])
    check_close("rmsnorm_rows against the LM path's apply_norm", norm_err)
    return {"flash_mha_vs_attend_chunked": {
                "shape": list(q.shape), **attn_err,
                "path_bf16_vs_f32": float_err(path_bf16, path_f32,
                                              FLASH_TOL[bf16]),
                "flash_vs_path_bf16": float_err(flash, path_bf16,
                                                FLASH_TOL[bf16])},
            "rmsnorm_rows_vs_apply_norm": {"shape": list(x1.shape),
                                           **norm_err}}, run


def phase_lm(card: str) -> list:
    """The LM serving path at ``LM_ARCH``'s full width and depth:
    ``BatchedServer.serve`` of ``LM_PROMPTS`` on ``LM_SLOTS`` slots (the
    path run, with every kernel count 0 before it: it launches none of the
    port's kernels, as the reference's models call none), each request
    served alone (bit for bit), the prefill of the longest prompt and a
    decode step timed beside their bounds, a decode step under
    ``torch.profiler``, the peak memory; the consistency checks at 40
    layers (printed) and 2 (a check), bfloat16 against float32, the card
    against CPU tensors, and K4/K5 on the path's own tensors.  Returns
    the runs whose launches the kernels line sums."""
    t_phase = time.perf_counter()
    config = get_arch(LM_ARCH).config
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = BatchedServer(config, n_slots=LM_SLOTS, max_len=LM_MAX_LEN,
                           rng_seed=LM_SEED, device=DEVICE)
    sync()
    build_s = time.perf_counter() - t0
    model, params = server.model, server.params
    n_params = sum(p.numel() for p in model.parameters())
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, config.vocab_size, n).astype(np.int32)
               for n in LM_PROMPTS]

    def requests(ids):
        return [Request(rid=i, prompt=prompts[i], max_new_tokens=LM_MAX_NEW)
                for i in ids]

    reqs = requests(range(len(prompts)))
    served, run = path_run("lm_serve", lambda: server.serve(reqs))
    if any(run["launches"].values()):
        raise AssertionError(f"the LM path launched kernels: "
                             f"{run['launches']}")
    if sorted(served) != list(range(len(prompts))) or not all(
            r.done and len(served[r.rid]) == LM_MAX_NEW for r in reqs):
        raise AssertionError(f"LM serve: {served}")
    generated = sum(len(v) for v in served.values())
    # check 1: every request's tokens equal the same request served alone
    alone = {}
    for i in range(len(prompts)):
        alone.update(server.serve(requests([i])))
    if alone != served:
        raise AssertionError(f"LM serve: batched {served} != alone {alone}")
    # the longest prompt's prefill, then a decode step against its cache
    # (the step writes position 4096 of the same cache every call)
    tokens = torch.as_tensor(prompts[0], dtype=torch.int64,
                             device=DEVICE)[None]
    with torch.inference_mode():
        prefill_wall, prefill_ms, (logits, cache) = lm_events_ms(
            lambda: model.prefill(params, {"tokens": tokens},
                                  max_len=LM_MAX_LEN), LM_PREFILL_REPS)
        last = logits[0, -1].argmax().view(1, 1)

        def decode():
            return model.decode_step(params, last, cache)

        decode_wall, decode_ms, _ = lm_events_ms(decode, LM_DECODE_REPS)
        decode_trace = device_idle(decode)
    peak = torch.cuda.max_memory_allocated()
    bounds = lm_bounds(model, LM_PROMPTS[0], cache)
    consistency40 = lm_consistency(model, params, config)
    cross, cross_run = lm_cross_checks(params, config, tokens)
    del server, model, params, cache, logits, last
    torch.cuda.empty_cache()
    two = lm_two_layers(config)
    torch.cuda.empty_cache()
    cpu = lm_card_vs_cpu()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    run.update({
        "phase": "lm_path", "nvidia_smi": card, "arch": LM_ARCH,
        "n_layers": config.n_layers, "d_model": config.d_model,
        "n_params": n_params, "dtype": str(config.param_dtype),
        "build_s": build_s,
        "requests": {"prompts": list(LM_PROMPTS), "max_new_tokens": LM_MAX_NEW,
                     "slots": LM_SLOTS, "max_len": LM_MAX_LEN},
        "served_tokens": generated, "serve_wall_s": run["wall_s"],
        "tokens_per_s": generated / run["wall_s"],
        "alone_equals_batched": True,
        "prefill": {"tokens": LM_PROMPTS[0], "wall_ms": prefill_wall,
                    "device_ms": prefill_ms,
                    "bound_ms": bounds["prefill_bound_ms"],
                    "bound_ms_every_block":
                        bounds["prefill_bound_ms_every_block"],
                    "ops": bounds["prefill_ops"]},
        "decode_step": {"cache_len": LM_PROMPTS[0], "wall_ms": decode_wall,
                        "device_ms": decode_ms,
                        "bound_ms": bounds["decode_bound_ms"],
                        "weights_bound_ms": bounds["decode_weights_bound_ms"],
                        "bytes": bounds["decode_bytes"],
                        "profiled": decode_trace},
        "kv_bytes_a_token": bounds["kv_bytes_a_token"],
        "peak_bytes": peak,
        "consistency_40_layers": consistency40, "two_layers": two,
        "card_vs_cpu": cpu, "cross_checks": cross,
        "seconds": seconds, "budget_s": LM_BUDGET_S,
        "within_budget": seconds <= LM_BUDGET_S})
    emit(run)
    return [run, cross_run]


def moe_drops(model, params, batch: dict, max_len: int) -> dict:
    """The top-k assignments each MoE layer of a prefill of ``batch``
    drops past capacity: each layer's router and dispatch run once more
    on its input (``mlp.route``), outside every timed call."""
    layers = []
    inner = lm_mlp.moe_apply

    def counting(p, x, config, *placed):
        xf = x.reshape(-1, config.d_model)
        keep = lm_mlp.route(p, xf, config)[4]
        layers.append((int((~keep).sum()), keep.numel(), keep.shape[0]))
        return inner(p, x, config, *placed)

    lm_mlp.moe_apply = counting
    try:
        with torch.inference_mode():
            model.prefill(params, batch, max_len=max_len)
    finally:
        lm_mlp.moe_apply = inner
    config = model.config
    tokens = batch["tokens"].numel()
    groups = lm_mlp.moe_groups(tokens, config)
    dropped = sum(n for n, _, _ in layers)
    assigned = sum(n for _, n, _ in layers)
    return {"tokens": tokens, "moe_layers": len(layers), "groups": groups,
            "capacity": lm_mlp._capacity(tokens // groups, config),
            "assignments": assigned, "dropped": dropped,
            "kept": assigned - dropped,
            "dropped_by_layer": [n for n, _, _ in layers]}


def lm_cut(model, params):
    """``model``'s config and weights cut to ``LM_CONSISTENCY["layers"]``
    layers, or to the fewest whole repetitions of its unit past its
    prefix that reach them (xlstm: 4, 3 mLSTM and an sLSTM; zamba2: 6
    Mamba2 and one use of the shared block), an encoder-decoder to that
    many of each; the weights as views of ``params``.  MoE at
    ``capacity_factor=8`` (drop-free, where the reference's own test
    holds the criterion)."""
    config, n = model.config, LM_CONSISTENCY["layers"]

    def cut(tree, reps):
        return {**tree, "unit": [lm_common.tree_map(
            lambda t: t[:reps], u, torch.is_tensor) for u in tree["unit"]]}

    if config.family == "audio":
        return (config.replace(n_enc_layers=n, n_dec_layers=n),
                {**params, "encoder": cut(params["encoder"], n),
                 "decoder": cut(params["decoder"], n)})
    plan = model.plan
    reps = max(1, -(-(n - len(plan.prefix)) // len(plan.unit)))
    c = config.replace(n_layers=len(plan.prefix) + reps * len(plan.unit))
    if config.n_experts:
        c = c.replace(capacity_factor=8.0)
    return c, {**params, "backbone": cut(params["backbone"], reps)}


def lm_depth(config):
    """A config's layers, an encoder-decoder's as [encoder, decoder]."""
    if config.family == "audio":
        return [config.n_enc_layers, config.n_dec_layers]
    return config.n_layers


def lm_family(card: str, arch: str, layers, prompts) -> dict:
    """One model of ``LM_FAMILIES`` at full width: built with seeded
    weights drawn on the card, ``BatchedServer.serve`` of ``prompts`` on
    ``LM_SLOTS`` slots (every launch count 0 before, none after: the path
    launches none of the port's kernels), each request served alone, the
    longest prompt's prefill and a decode step against its cache timed
    beside their bounds (CUDA events), the step's device events and idle
    share, the peak memory and the weights' bytes; the MoE drops of that
    prefill; the prefill/decode consistency at the depth of
    :func:`lm_cut`, held in float32 (weights drawn anew once the served
    model is freed) and read in bfloat16 on the served weights' views;
    the smoke config on the card against CPU tensors.
    The model's weights and caches are freed before it returns."""
    t_model = time.perf_counter()
    config = get_arch(arch).config
    if layers is not None:
        config = config.replace(n_layers=layers)
    max_len = max(prompts) + LM_MAX_NEW
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = BatchedServer(config, n_slots=LM_SLOTS, max_len=max_len,
                           rng_seed=LM_SEED, device=DEVICE)
    sync()
    build_s = time.perf_counter() - t0
    model, params = server.model, server.params
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    rng = np.random.default_rng(0)
    texts = [rng.integers(0, config.vocab_size, n).astype(np.int32)
             for n in prompts]

    def requests(ids):
        return [Request(rid=i, prompt=texts[i], max_new_tokens=LM_MAX_NEW)
                for i in ids]

    reqs = requests(range(len(texts)))
    served, run = path_run(f"lm_family {arch}", lambda: server.serve(reqs))
    if any(run["launches"].values()):
        raise AssertionError(f"{arch}: the LM path launched kernels: "
                             f"{run['launches']}")
    if sorted(served) != list(range(len(texts))) or not all(
            r.done and len(served[r.rid]) == LM_MAX_NEW for r in reqs):
        raise AssertionError(f"{arch} serve: {served}")
    alone = {}
    for i in range(len(texts)):
        alone.update(server.serve(requests([i])))
    if alone != served:
        raise AssertionError(f"{arch} serve: batched {served} != alone "
                             f"{alone}")
    batch = lm_batch(config, torch.as_tensor(
        texts[0], dtype=torch.int64, device=DEVICE)[None])
    with torch.inference_mode():
        prefill_wall, prefill_ms, (logits, cache) = lm_events_ms(
            lambda: model.prefill(params, batch, max_len=max_len),
            LM_PREFILL_REPS)
        last = logits[0, -1].argmax().view(1, 1)

        def decode():
            return model.decode_step(params, last, cache)

        decode_wall, decode_ms, _ = lm_events_ms(decode, LM_DECODE_REPS)
        decode_trace = device_idle(decode)
    peak = torch.cuda.max_memory_allocated()
    drops = moe_drops(model, params, batch, max_len) \
        if config.n_experts else None
    bounds = lm_bounds(model, prompts[0], cache,
                       kept=drops["kept"] if drops else None)
    cut_config, cut_tree = lm_cut(model, params)
    cut_model = build_model(cut_config, device=DEVICE)
    consistency_bf16 = lm_consistency(
        cut_model, cut_model.load_params(cut_tree), cut_config)
    plan = getattr(model, "plan", None)
    del server, model, params, cache, logits, last, cut_model, cut_tree
    torch.cuda.empty_cache()
    c32 = cut_config.replace(dtype=torch.float32, param_dtype=torch.float32)
    if plan is not None and 4 * sum(
            int(np.prod(spec.shape)) for _, spec in
            lm_common.tree_leaves_with_path(lm_param_specs(c32),
                                            lm_common.is_spec)) \
            > LM_F32_CHECK_BYTES:
        c32 = c32.replace(n_layers=len(plan.prefix) + len(plan.unit))
    model32 = build_model(c32, device=DEVICE)
    consistency = lm_consistency(model32, model32.init(torch.Generator(
        device=DEVICE).manual_seed(LM_SEED)), c32)
    if consistency["excess"] > 0:
        raise AssertionError(f"{arch} prefill/decode consistency in "
                             f"float32: {consistency}")
    del model32
    torch.cuda.empty_cache()
    cpu = lm_card_vs_cpu(arch)
    torch.cuda.empty_cache()
    decode_bound = {"bound_ms": bounds["decode_bound_ms"],
                    "weights_bound_ms": bounds["decode_weights_bound_ms"],
                    "bytes": bounds["decode_bytes"]}
    if config.n_experts:
        decode_bound.update(
            activated_bound_ms=bounds["decode_activated_bound_ms"],
            activated_bytes=bounds["decode_activated_bytes"])
    run.update({
        "phase": "lm_family", "nvidia_smi": card, "arch": arch,
        "family": config.family, "n_layers": config.n_layers,
        "published_layers": get_arch(arch).config.n_layers,
        "d_model": config.d_model, "n_params": n_params,
        "dtype": str(config.dtype), "param_dtype": str(config.param_dtype),
        "weight_bytes": weight_bytes, "build_s": build_s,
        "requests": {"prompts": list(prompts), "max_new_tokens": LM_MAX_NEW,
                     "slots": LM_SLOTS, "max_len": max_len},
        "served_tokens": sum(len(v) for v in served.values()),
        "serve_wall_s": run["wall_s"],
        "tokens_per_s": sum(len(v) for v in served.values()) / run["wall_s"],
        "alone_equals_batched": True,
        "prefill": {"tokens": prompts[0], "wall_ms": prefill_wall,
                    "device_ms": prefill_ms,
                    "bound_ms": bounds["prefill_bound_ms"],
                    "bound_ms_every_block":
                        bounds["prefill_bound_ms_every_block"],
                    "ops": bounds["prefill_ops"]},
        "decode_step": {"cache_len": prompts[0], "wall_ms": decode_wall,
                        "device_ms": decode_ms, **decode_bound,
                        "profiled": decode_trace},
        "kv_bytes_a_token": bounds["kv_bytes_a_token"],
        "state_bytes": bounds["state_bytes"], "moe_drops": drops,
        "peak_bytes": peak,
        "consistency": {
            "float32": {"layers": lm_depth(c32), **consistency},
            "bfloat16": {"layers": lm_depth(cut_config), **consistency_bf16,
                         "held": False}},
        "card_vs_cpu": cpu, "seconds": time.perf_counter() - t_model})
    emit(run)
    return run


def phase_lm_families(card: str) -> list:
    """``LM_FAMILIES`` one model at a time (:func:`lm_family`), then the
    phase's wall beside ``LM_FAMILIES_BUDGET_S``.  Returns the runs whose
    launches (all 0) the kernels line sums."""
    t0 = time.perf_counter()
    runs = [lm_family(card, arch, layers, prompts)
            for arch, layers, prompts in LM_FAMILIES]
    seconds = time.perf_counter() - t0
    emit({"phase": "lm_families_done", "nvidia_smi": card,
          "archs": [r["arch"] for r in runs], "seconds": seconds,
          "budget_s": LM_FAMILIES_BUDGET_S,
          "within_budget": seconds <= LM_FAMILIES_BUDGET_S})
    return runs


def train_bounds(model, n_params: int) -> dict:
    """The least time of one train step of ``model`` on
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens: ``model_flops``'s 6·N·D at
    the bf16 tensor-core rate plus AdamW's bytes over the HBM rate; and
    the FLOPs that the count leaves out: the tied head's products (6 a
    weight a token), attention's T² products (QKᵀ and PV, forward and
    backward: 3 x 4·B·H·T²·hd a layer, all of T² as ``attend_full``
    computes them) and remat's second forward (2·N·D)."""
    config = model.config
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = model_flops(model, "train", TRAIN_SEQ, TRAIN_BATCH)
    adamw_bytes = ADAMW_BYTES_A_PARAM * n_params
    flops_ms = flops / BF16_TENSOR_OPS_PER_S * 1e3
    adamw_ms = adamw_bytes / HBM_BYTES_PER_S * 1e3
    head = 6.0 * config.d_model * config.padded_vocab * tokens
    attention = 3 * 4.0 * TRAIN_BATCH * config.n_heads * TRAIN_SEQ ** 2 \
        * config.hd * config.n_layers
    remat = 2.0 * count_params(model) * tokens \
        if config.remat != "none" else 0.0
    return {"model_flops": flops, "flops_bound_ms": flops_ms,
            "adamw_bytes": adamw_bytes, "adamw_bound_ms": adamw_ms,
            "bound_ms": flops_ms + adamw_ms,
            "left_out_flops": {"tied_head": head, "attention_t2": attention,
                               "remat_forward": remat},
            "bound_ms_with_left_out": flops_ms + adamw_ms
            + (head + attention + remat) / BF16_TENSOR_OPS_PER_S * 1e3}


# aten ops whose device time is a product's (the tensor-core GEMMs)
PRODUCT_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")


def op_split(fn, top: int = 15) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the aten ops' own
    device time, the ``top`` largest by name with their calls, and the
    products' (``PRODUCT_OPS``) share of the whole."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync()

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    ops = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    ops.sort(key=device_us, reverse=True)
    total = sum(device_us(e) for e in ops)
    products = sum(device_us(e) for e in ops if e.key in PRODUCT_OPS)
    return {"device_ms": total / 1e3, "products_ms": products / 1e3,
            "products_share": products / total if total else None,
            "top": [{"op": e.key, "calls": e.count,
                     "device_ms": device_us(e) / 1e3} for e in ops[:top]]}


def train_leaves(state) -> list:
    return lm_common.tree_leaves_with_path(tuple(state), torch.is_tensor)


def same_training(a, b, what: str) -> None:
    """Two training states, every leaf bit for bit."""
    for (path, x), (_, y) in zip(train_leaves(a), train_leaves(b)):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: {path} differs "
                                 f"(max |diff| {float((x - y).abs().max())})")


def train_close(a, b, tol: dict) -> dict:
    """The largest |diff| of two training states' parameters, and whether
    every element lies within ``param_atol + param_rtol |b|``."""
    worst, excess = 0.0, -np.inf
    for (_, x), (_, y) in zip(lm_common.tree_leaves_with_path(
            a.params, torch.is_tensor), lm_common.tree_leaves_with_path(
            b.params, torch.is_tensor)):
        x, y = x.float().cpu(), y.float().cpu()
        diff = (x - y).abs()
        worst = max(worst, float(diff.max()))
        excess = max(excess, float((diff - tol["param_atol"]
                                    - tol["param_rtol"] * y.abs()).max()))
    return {"max_abs_diff": worst, "excess": excess}


def rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def train_card_vs_cpu(arch: str) -> dict:
    """One train step of ``arch``'s smoke config in float32 on the card
    and on CPU tensors, from one carried-across state (seeded numpy
    weights, zero moments): the loss, ``grad_norm`` and every parameter
    within ``TRAIN_CPU_TOL``."""
    config = get_arch(arch).smoke_config().replace(dtype=torch.float32)
    tree = numpy_lm_params(config, LM_SEED)
    zeros = lm_common.tree_map(np.zeros_like, tree,
                               lambda x: isinstance(x, np.ndarray))
    host = (tree, {"m": zeros, "v": zeros, "step": np.int32(0)})
    batch = build_batch_fn(config, 2, 16, seed=1, device="cpu")(0)
    outs = {}
    for dev in (DEVICE, "cpu"):
        model = build_model(config, device=dev)
        state = interop.train_state_from_numpy(host, config, TRAIN_OPT,
                                               device=dev)
        outs[dev] = make_train_step(model, TRAIN_OPT)(state, batch)
    (card, m_card), (cpu, m_cpu) = outs[DEVICE], outs["cpu"]
    close = train_close(card, cpu, TRAIN_CPU_TOL)
    out = {"arch": arch, "loss_rel": rel(m_card["loss"], m_cpu["loss"]),
           "grad_norm_rel": rel(m_card["grad_norm"], m_cpu["grad_norm"]),
           **close}
    if out["loss_rel"] > TRAIN_CPU_TOL["loss_rtol"] or \
            out["grad_norm_rel"] > TRAIN_CPU_TOL["grad_norm_rtol"] or \
            close["excess"] > 0:
        raise AssertionError(f"train step card against CPU: {out}")
    return out


def train_checks(card: str) -> dict:
    """olmo-1b at ``TRAIN_CHECK_LAYERS`` layers, full width, on the card
    as a user runs it (no ``torch.use_deterministic_algorithms``: the
    step repeats bit for bit without it, which the first check holds):
    one step run twice, and remat ``full`` against ``none``, bit for bit,
    ``grad_accum`` 2 against 1 within ``TRAIN_ACCUM_TOL``, at the timed
    batch's shape; ``run_with_recovery`` with faults at ``TRAIN_FAIL_AT``
    and ``train_loop`` resumed from its checkpoint, each against
    ``train_loop`` run straight through, bit for bit, checkpoints on
    local disk."""
    config = get_arch(TRAIN_ARCH).config.replace(n_layers=TRAIN_CHECK_LAYERS)
    model = build_model(config, device=DEVICE)
    state = init_train_state(
        model, torch.Generator(device=DEVICE).manual_seed(TRAIN_SEED),
        TRAIN_OPT)
    batch = build_batch_fn(config, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEED,
                           device=DEVICE)(0)
    step = make_train_step(model, TRAIN_OPT)
    full, again = step(state, batch), step(state, batch)[0]
    same_training(full[0], again, "a step run twice")
    del again
    none = make_train_step(build_model(
        config.replace(remat="none"), device=DEVICE), TRAIN_OPT)(state, batch)
    same_training(full[0], none[0], "remat full against none")
    if not all(torch.equal(full[1][k], none[1][k]) for k in full[1]):
        raise AssertionError("remat full against none: metrics")
    del none
    accum, m2 = make_train_step(model, TRAIN_OPT, 2)(state, batch)
    m1 = full[1]
    accum_check = {"loss_rel": rel(m2["loss"], m1["loss"]),
                   "grad_norm_rel": rel(m2["grad_norm"], m1["grad_norm"]),
                   **train_close(accum, full[0], TRAIN_ACCUM_TOL),
                   "tol": TRAIN_ACCUM_TOL}
    if accum_check["loss_rel"] > TRAIN_ACCUM_TOL["loss_rtol"] or \
            accum_check["grad_norm_rel"] > TRAIN_ACCUM_TOL["grad_norm_rtol"] \
            or accum_check["excess"] > 0:
        raise AssertionError(f"grad_accum 2 against 1: {accum_check}")
    del accum, full, state
    recovery = train_recovery(config)
    torch.cuda.empty_cache()
    return {"layers": TRAIN_CHECK_LAYERS, "repeatable": True,
            "remat_full_equals_none": True, "grad_accum": accum_check,
            **recovery}


def train_recovery(config) -> dict:
    """``run_with_recovery`` (faults at ``TRAIN_FAIL_AT``) and
    ``train_loop`` resumed from its own checkpoint, each against
    ``train_loop`` run straight through, bit for bit."""
    kw = dict(batch=TRAIN_CHECK_BATCH, seq=TRAIN_CHECK_SEQ, log_every=0,
              opt=TRAIN_OPT, seed=TRAIN_SEED, device=DEVICE)
    straight = train_loop(config, steps=TRAIN_CHECK_STEPS, **kw)["state"]
    model = build_model(config, device=DEVICE)
    step = make_train_step(model, TRAIN_OPT)
    batch_at = build_batch_fn(config, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ,
                              TRAIN_SEED, device=DEVICE)
    init = init_train_state(
        model, torch.Generator(device=DEVICE).manual_seed(TRAIN_SEED),
        TRAIN_OPT)
    events = []
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="train_ckpt_") as directory:
        final, stats = run_with_recovery(
            lambda state, k: step(state, batch_at(k))[0], init,
            TRAIN_CHECK_STEPS, CheckpointManager(directory, keep=3,
                                                 async_save=False),
            checkpoint_every=TRAIN_CHECKPOINT_EVERY,
            fault_injector=FaultInjector(fail_at=TRAIN_FAIL_AT),
            on_event=lambda ev, k: events.append((ev, k)))
        recovery_s = time.perf_counter() - t0
        checkpoint_bytes = sum(
            f.stat().st_size for f in Path(directory).rglob("*.npy"))
    if stats["restarts"] != len(TRAIN_FAIL_AT):
        raise AssertionError(f"train recovery: {stats}")
    same_training(final, straight, "run_with_recovery against straight")
    del final, init
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="train_resume_") as directory:
        half = TRAIN_CHECK_STEPS // 2
        train_loop(config, steps=half, ckpt_dir=directory,
                   checkpoint_every=half, **kw)
        resumed = train_loop(config, steps=TRAIN_CHECK_STEPS,
                             ckpt_dir=directory, checkpoint_every=half, **kw)
    resume_s = time.perf_counter() - t0
    if resumed["steps_run"] != TRAIN_CHECK_STEPS - half:
        raise AssertionError(f"train_loop resume ran "
                             f"{resumed['steps_run']} steps")
    same_training(resumed["state"], straight, "train_loop resume against "
                  "straight")
    return {"recovery": {"steps": TRAIN_CHECK_STEPS,
                         "fail_at": list(TRAIN_FAIL_AT), "events": events,
                         **stats, "seconds": recovery_s,
                         "kept_checkpoint_bytes": checkpoint_bytes,
                         "bit_for_bit": True},
            "resume": {"from_step": half, "steps_run": resumed["steps_run"],
                       "seconds": resume_s, "bit_for_bit": True}}


def phase_train(card: str) -> list:
    """The training path at olmo-1b's full width and depth: the state
    drawn on the card, a warm-up step, ``TRAIN_STEPS`` steps timed one
    by one (every launch count 0 before, none after: the path launches
    none of the port's kernels), one more step under ``torch.profiler``,
    the peak memory, the bounds (:func:`train_bounds`); every loss and
    ``grad_norm`` finite and the last timed loss below the first step's;
    then :func:`train_checks` at 2 layers and :func:`train_card_vs_cpu`
    on every arch's smoke config.  Returns the run whose launches (all
    0) the kernels line sums."""
    t_phase = time.perf_counter()
    config = get_arch(TRAIN_ARCH).config
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(config, device=DEVICE)
    state = init_train_state(
        model, torch.Generator(device=DEVICE).manual_seed(TRAIN_SEED),
        TRAIN_OPT)
    sync()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    batch_at = build_batch_fn(config, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEED,
                              device=DEVICE)
    step = make_train_step(model, TRAIN_OPT)
    t0 = time.perf_counter()
    state, metrics = step(state, batch_at(0))
    first_loss = float(metrics["loss"])
    warm_s = time.perf_counter() - t0
    losses, norms, walls, pairs = [first_loss], \
        [float(metrics["grad_norm"])], [], []
    sync()
    reset_launch_counts()
    for k in range(1, TRAIN_STEPS + 1):
        batch = batch_at(k)
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        state, metrics = step(state, batch)
        end.record()
        sync()
        walls.append(time.perf_counter() - t0)
        pairs.append((start, end))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    launches = launch_counts()
    if any(launches.values()):
        raise AssertionError(f"the train path launched kernels: {launches}")
    step_ms = [a.elapsed_time(b) for a, b in pairs]
    batch = batch_at(TRAIN_STEPS + 1)
    profiled = device_idle(lambda: step(state, batch))
    peak = torch.cuda.max_memory_allocated()
    split = op_split(lambda: step(state, batch))
    bounds = train_bounds(model, n_params)
    non_embedding = count_params(model)
    mean_ms = sum(step_ms) / len(step_ms)
    roofline = phase_roofline(card, model, state, batch, step, mean_ms,
                              bounds)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    run = {"phase": "train_path", "nvidia_smi": card, "arch": TRAIN_ARCH,
           "n_layers": config.n_layers, "d_model": config.d_model,
           "n_params": n_params, "count_params": non_embedding,
           "dtype": str(config.dtype), "param_dtype": str(config.param_dtype),
           "moment_dtype": str(TRAIN_OPT.moment_dtype),
           "remat": config.remat, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "tokens_a_step": tokens, "init_s": init_s,
           "warm_step_s": warm_s, "step_ms": step_ms, "step_ms_mean": mean_ms,
           "step_wall_ms": [w * 1e3 for w in walls],
           "tokens_per_s": tokens / (mean_ms / 1e3),
           **bounds, "step_over_bound": mean_ms / bounds["bound_ms"],
           "losses": losses, "grad_norms": norms, "profiled": profiled,
           "op_split": split, "peak_bytes": peak, "launches": launches,
           "roofline_path": roofline}
    emit({**run, "phase": "train_path_steps"})
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        raise AssertionError(f"train path: losses {losses}, grad norms "
                             f"{norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train path: the loss did not fall: {losses}")
    del model, state, metrics, step
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = train_checks(card)
    checks_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = [train_card_vs_cpu(arch) for arch in sorted(ARCHS)]
    cpu_s = time.perf_counter() - t0
    seconds = time.perf_counter() - t_phase
    run.update({"checks": checks, "checks_s": checks_s, "card_vs_cpu": cpu,
                "card_vs_cpu_s": cpu_s, "seconds": seconds,
                "budget_s": TRAIN_BUDGET_S,
                "within_budget": seconds <= TRAIN_BUDGET_S})
    emit(run)
    return [run]


def meta_twin(tree):
    """``tree`` with each tensor a ``meta`` tensor of its shape and type."""
    return lm_common.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree,
        torch.is_tensor)


def priced_on_both(what: str, card_fn, card_args, meta_fn,
                   meta_args) -> tuple:
    """One program priced by ``roofline.op_cost`` on ``meta`` tensors
    (after one untraced call, which fills the model's memos as the card's
    earlier calls did) and run once on the card under the same counting
    mode: the ops, FLOPs and bytes must be equal; the traced peak (its
    arguments included) against ``max_memory_allocated`` over the card's
    call, with the bytes resident beside the arguments added.  Returns
    (the row, the card's Cost, its Memory)."""
    meta_fn(*meta_args)
    _, meta_cost, meta_memory = price(meta_fn, *meta_args)
    sync()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, cost, memory = price(card_fn, *card_args)
    sync()
    peak = torch.cuda.max_memory_allocated()
    del out
    got = {k: getattr(cost, k) for k in ("ops", "flops", "bytes")}
    want = {k: getattr(meta_cost, k) for k in ("ops", "flops", "bytes")}
    if got != want:
        raise AssertionError(f"{what}: the card's program {got} is not the "
                             f"meta program {want}")
    expected = resident - memory.argument_bytes + memory.peak_bytes
    gap = peak / expected - 1
    row = {**got, "traced_peak_bytes": memory.peak_bytes,
           "traced_peak_bytes_on_meta": meta_memory.peak_bytes,
           "argument_bytes": memory.argument_bytes,
           "resident_bytes_before": resident,
           "max_memory_allocated": peak,
           "expected_max_memory_allocated": expected,
           "peak_gap": gap}
    if abs(gap) > ROOFLINE_PEAK_RTOL:
        raise AssertionError(f"{what}: max_memory_allocated {peak} is "
                             f"{gap:+.1%} from the traced peak's {expected}")
    return row, cost, memory


def terms(cost, memory, kind: str, measured_ms: float, **known) -> dict:
    """The three roofline terms of one card's program, in ms, beside its
    measured device ms."""
    rep = analyze_program(cost, memory, arch="", shape="", mesh_name="card",
                          kind=kind, n_devices=1)
    return {"compute_ms": rep.t_compute * 1e3,
            "memory_ms": rep.t_memory * 1e3,
            "collective_ms": rep.t_collective * 1e3,
            "dominant": rep.dominant, "measured_ms": measured_ms, **known}


def phase_roofline(card: str, model, state, batch, step,
                   step_ms: float, bounds: dict) -> dict:
    """``roofline_path`` on ``train_path``'s model and state: (a) the
    step's and a ``LM_ARCH`` decode step's programs priced on ``meta``
    equal the card's (:func:`priced_on_both`), their three terms beside
    the measured ms; (b) the step's compute term beside the prediction
    ``bound_ms_with_left_out`` (less AdamW's bytes), its traced peak
    against ``max_memory_allocated``.  The contour cell's check comes
    after the kernels line (:func:`roofline_contour`)."""
    t_phase = time.perf_counter()
    config = model.config
    meta_model = build_model(config, device="meta")
    meta_params = meta_model.params()
    meta_state = type(state)(meta_params,
                             init_opt_state(meta_params, TRAIN_OPT))
    train_row, cost, memory = priced_on_both(
        "train step", step, (state, batch),
        make_train_step(meta_model, TRAIN_OPT), (meta_state,
                                                 meta_twin(batch)))
    train_row.update(terms(
        cost, memory, "train", step_ms,
        predicted_compute_ms=bounds["bound_ms_with_left_out"]
        - bounds["adamw_bound_ms"]))
    # one decode step of the LM path's model against LM_PROMPTS[0]
    # positions (a cache of LM_MAX_LEN, its length set; the values are
    # the zeros init_cache makes)
    lm_config = get_arch(LM_ARCH).config
    lm = build_model(lm_config, device=DEVICE)
    params = lm.init(torch.Generator(device=DEVICE).manual_seed(LM_SEED))
    meta_lm = build_model(lm_config, device="meta")

    def at_prompt(cache):
        return lm_common.tree_map(
            lambda x: LM_PROMPTS[0] if type(x) is int else x, cache,
            lambda x: isinstance(x, (torch.Tensor, int)))

    cache = at_prompt(lm.init_cache(1, LM_MAX_LEN))
    token = torch.zeros((1, 1), dtype=torch.int64, device=DEVICE)
    with torch.inference_mode():
        _, decode_ms, _ = lm_events_ms(
            lambda: lm.decode_step(params, token, cache),
            ROOFLINE_DECODE_REPS)
        decode_row, cost, memory = priced_on_both(
            "decode step", lm.decode_step, (params, token, cache),
            meta_lm.decode_step, (meta_lm.params(), meta_twin(token),
                                  at_prompt(meta_lm.init_cache(
                                      1, LM_MAX_LEN))))
    decode_row.update(terms(cost, memory, "decode", decode_ms))
    del lm, params, cache
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    out = {"phase": "roofline_path", "nvidia_smi": card,
           "train": {"arch": TRAIN_ARCH, "batch": TRAIN_BATCH,
                     "seq": TRAIN_SEQ, "remat": config.remat, **train_row},
           "decode": {"arch": LM_ARCH, "cache_len": LM_PROMPTS[0],
                      "capacity": LM_MAX_LEN, **decode_row},
           "seconds": seconds, "budget_s": ROOFLINE_BUDGET_S,
           "within_budget": seconds <= ROOFLINE_BUDGET_S}
    emit(out)
    return out


def roofline_contour(kernels: dict) -> dict:
    """(c) The ``contour-cc`` cell priced on a 1-rank mesh at the main
    path's rmat n and m (``launch.dryrun.trace_contour``, one round):
    its bytes and operations must equal the sum of K1's, K7's and K6's
    entries of the kernels line; its memory term beside the three
    kernels' measured ms."""
    entries = [kernels[k] for k in ("fused_relax", "pointer_jump",
                                    "converged_early")]
    n, m = entries[0]["shape"]["n"], entries[0]["shape"]["m"]
    if entries[2]["shape"]["n"] != n or entries[2]["shape"]["m"] != m \
            or entries[1]["shape"]["n"] != n:
        raise AssertionError(f"the kernels line's K1/K7/K6 shapes differ: "
                             f"{[e['shape'] for e in entries]}")
    rank = AbstractMesh((1, 1), ("data", "model")).at(0)
    cost, memory, work = dryrun.trace_contour(rank, n, m, rounds=1)
    line = {"bytes": sum(e["bytes"] for e in entries),
            "ops": sum(e["ops"] for e in entries)}
    if (work["bytes"], work["ops"]) != (line["bytes"], line["ops"]) \
            or cost.bytes != line["bytes"] or cost.coll_counts:
        raise AssertionError(f"the contour round {work} is not the kernels "
                             f"line's {line}")
    return {"n": n, "m": m, "round": work, "kernels_line": line,
            **terms(cost, memory, "contour",
                    sum(e["ms"] for e in entries))}


def timed_ms(fn) -> tuple:
    """(CUDA-event ms of one call of ``fn``, its output)."""
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    sync()
    return start.elapsed_time(end), out


def state_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in
               lm_common.tree_leaves_with_path(tree, torch.is_tensor))


def block_bytes(model, dtype) -> int:
    """The bytes of the rank's blocks of ``model``'s parameters in
    ``dtype``, from ``shardings_for``."""
    specs = dict(lm_common.tree_leaves_with_path(model.param_specs(),
                                                 lm_common.is_spec))
    item = torch.empty((), dtype=dtype).element_size()
    return sum(int(np.prod(sh.shard_shape(specs[p].shape))) * item
               for p, sh in lm_common.tree_leaves_with_path(
                   model.shardings,
                   lambda x: isinstance(x, lm_common.Sharding)))


def lm_mesh_train_one(card: str, mesh, plain_ms: float) -> dict:
    """olmo-1b at full width and depth, one step on the 1-rank ``mesh``
    from the state of the mesh-less step (the same tensors: on one rank a
    block is the whole leaf), within ``TRAIN_CPU_TOL`` of it."""
    config = get_arch(TRAIN_ARCH).config
    model = build_model(config, device=DEVICE)
    state = init_train_state(
        model, torch.Generator(device=DEVICE).manual_seed(TRAIN_SEED),
        TRAIN_OPT)
    batch = build_batch_fn(config, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEED,
                           device=DEVICE)(0)
    plain = make_train_step(model, TRAIN_OPT)
    ms, (want, m_want) = timed_ms(lambda: plain(state, batch))
    mesh_model = build_model(config, mesh)
    expected = block_bytes(mesh_model, config.param_dtype)
    if expected != state_bytes(state.params):
        raise AssertionError(f"lm_mesh: {state_bytes(state.params)} "
                             f"parameter bytes, blocks of {expected}")
    step = make_train_step(mesh_model, TRAIN_OPT)
    reset_launch_counts()
    rt_mesh.reset_collective_stats()
    mesh_ms, (got, m_got) = timed_ms(lambda: step(state, batch))
    launches = launch_counts()
    out = {"phase": "lm_mesh_train", "nvidia_smi": card,
           "process_group": LM_MESH_BACKEND, "mesh": [1, 1],
           "arch": TRAIN_ARCH, "n_layers": config.n_layers,
           "d_model": config.d_model, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "step_ms": mesh_ms, "plain_step_ms": ms,
           "train_path_step_ms_mean": plain_ms,
           "loss_rel": rel(m_got["loss"], m_want["loss"]),
           "grad_norm_rel": rel(m_got["grad_norm"], m_want["grad_norm"]),
           **train_close(got, want, TRAIN_CPU_TOL),
           "bit_for_bit": all(torch.equal(x, y) for (_, x), (_, y) in zip(
               train_leaves(got), train_leaves(want))),
           "parameter_bytes": expected,
           "collectives": rt_mesh.collective_stats(), "launches": launches}
    emit(out)
    if out["loss_rel"] > TRAIN_CPU_TOL["loss_rtol"] or \
            out["grad_norm_rel"] > TRAIN_CPU_TOL["grad_norm_rtol"] or \
            out["excess"] > 0:
        raise AssertionError(f"lm_mesh: the 1-rank step against the "
                             f"mesh-less one: {out}")
    del model, mesh_model, state, want, got
    torch.cuda.empty_cache()
    return out


def greedy(model, params, tokens, new: int, max_len: int) -> tuple:
    """(the greedy continuation of ``tokens`` (B, T), the prefill's
    CUDA-event ms) with ``model``; its logits gathered whole."""
    vp = model.config.padded_vocab
    b = tokens.shape[0]
    with torch.inference_mode():
        ms, (logits, cache) = timed_ms(lambda: model.prefill(
            params, {"tokens": tokens}, max_len=max_len))
        out, logits_all = [], []
        for _ in range(new):
            logits = model.whole(logits, (b, 1, vp), "batch", None, "vocab")
            logits_all.append(logits.float())
            tok = logits[:, -1].argmax(-1, keepdim=True)
            out.append(tok)
            logits, cache = model.decode_step(params, tok, cache)
    return torch.cat(out, 1), ms, torch.cat(logits_all, 1)


def lm_mesh_serve_one(card: str, mesh) -> dict:
    """mistral-nemo-12b's serving config at full width and depth on the
    1-rank ``mesh`` and without one, the same bf16 weights: the greedy
    tokens after a prefill of ``LM_MESH_NEMO_PROMPT`` tokens must be
    equal."""
    config = get_arch(LM_ARCH).config.for_serving()
    model = build_model(config, device=DEVICE)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(LM_SEED))
    mesh_model = build_model(config, mesh)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, config.vocab_size, (1, LM_MESH_NEMO_PROMPT)), device=DEVICE)
    cap = LM_MESH_NEMO_PROMPT + LM_MESH_NEMO_NEW
    want, plain_ms, _ = greedy(model, params, tokens, LM_MESH_NEMO_NEW, cap)
    reset_launch_counts()
    got, mesh_ms, _ = greedy(mesh_model, params, tokens, LM_MESH_NEMO_NEW,
                             cap)
    out = {"phase": "lm_mesh_serve", "nvidia_smi": card,
           "process_group": LM_MESH_BACKEND, "mesh": [1, 1],
           "arch": LM_ARCH, "profile": config.sharding_profile,
           "n_layers": config.n_layers, "prompt": LM_MESH_NEMO_PROMPT,
           "new_tokens": LM_MESH_NEMO_NEW, "prefill_ms": mesh_ms,
           "plain_prefill_ms": plain_ms,
           "tokens_equal": bool(torch.equal(got, want)),
           "tokens": got[0].tolist(), "launches": launch_counts()}
    emit(out)
    if not out["tokens_equal"]:
        raise AssertionError(f"lm_mesh: nemo's greedy tokens on a 1-rank "
                             f"mesh {got.tolist()} != {want.tolist()}")
    del model, mesh_model, params
    torch.cuda.empty_cache()
    return out


def lm_mesh_config(arch: str, profile: str):
    config = get_arch(arch).config
    return config.replace(n_layers=LM_MESH_LAYERS, dtype=torch.float32,
                          param_dtype=torch.float32,
                          sharding_profile=profile)


# rank 0's mesh-less runs by (arch, steps): the same for every profile
_PLAIN_TRAIN: dict = {}


def plain_train(config, steps: int, device) -> tuple:
    """(each step's loss and grad norm, the parameters before the first
    step, the state after the last) of ``config`` without a mesh, from
    the draws the mesh's run makes."""
    key = (config.name, steps)
    if key not in _PLAIN_TRAIN:
        _PLAIN_TRAIN.clear()
        model = build_model(config, device=device)
        state = init_train_state(
            model, torch.Generator(device=device).manual_seed(TRAIN_SEED),
            LM_MESH_OPT)
        before = {p: t.clone() for p, t in lm_common.tree_leaves_with_path(
            state.params, torch.is_tensor)}
        step = make_train_step(model, LM_MESH_OPT)
        batch_at = build_batch_fn(config, LM_MESH_TRAIN_BATCH,
                                  LM_MESH_TRAIN_SEQ, TRAIN_SEED,
                                  device=device)
        metrics = []
        for k in range(steps):
            state, m = step(state, batch_at(k))
            metrics.append((m["loss"], m["grad_norm"]))
        _PLAIN_TRAIN[key] = (metrics, before, state)
    return _PLAIN_TRAIN[key]


def step_close(got: dict, want: dict, before: dict) -> dict:
    """Each leaf's change ``got - before`` against ``want - before``
    (path -> tensor): the worst ``max |d_got - d_want| / max |d_want|``
    over the leaves (inf where only one of them changed), and whether it
    is within ``LM_MESH_STEP_RTOL``."""
    worst = 0.0
    for path, w in want.items():
        d_want = (w - before[path]).float()
        d_got = (got[path] - before[path]).float()
        scale, miss = float(d_want.abs().max()), float(
            (d_got - d_want).abs().max())
        worst = max(worst, miss / scale if scale else
                    (0.0 if miss == 0 else float("inf")))
    return {"step_rel": worst, "step_ok": worst <= LM_MESH_STEP_RTOL}


def lm_mesh_train(mesh, config, rank: int, steps: int) -> dict:
    """``steps`` train steps on ``mesh`` and, on rank 0, without one
    (:func:`plain_train`), from the same draws, with ``LM_MESH_OPT``:
    each step's loss and grad norm, and the parameters after the last,
    within ``LM_MESH_TOL``; each leaf's change within
    ``LM_MESH_STEP_RTOL`` (:func:`step_close`)."""
    device = mesh.device
    model = build_model(config, mesh)
    state = init_train_state(
        model, torch.Generator(device=device).manual_seed(TRAIN_SEED),
        LM_MESH_OPT)
    held = {k: state_bytes(t) for k, t in (("params", state.params),
                                           ("m", state.opt["m"]),
                                           ("v", state.opt["v"]))}
    expected = block_bytes(model, config.param_dtype)
    batch_at = build_batch_fn(config, LM_MESH_TRAIN_BATCH,
                              LM_MESH_TRAIN_SEQ, TRAIN_SEED, device=device)
    step = make_train_step(model, LM_MESH_OPT)
    losses, norms, walls, stats = [], [], [], []
    for k in range(steps):
        rt_mesh.reset_collective_stats()
        t0 = time.perf_counter()
        state, metrics = step(state, batch_at(k))
        walls.append(time.perf_counter() - t0)
        stats.append(rt_mesh.collective_stats())
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    whole = {p: lm_common.relayout(t, mesh, sh.layout(t.dim()),
                                   ((),) * t.dim())
             for (p, t), (_, sh) in zip(
                 lm_common.tree_leaves_with_path(state.params,
                                                 torch.is_tensor),
                 lm_common.tree_leaves_with_path(
                     model.shardings,
                     lambda x: isinstance(x, lm_common.Sharding)))}
    out = {"kind": "train", "parameter_bytes": held["params"],
           "moment_bytes": held["m"] + held["v"],
           "expected_block_bytes": expected, "losses": losses,
           "grad_norms": norms, "step_wall_s": walls,
           "collectives_a_step": stats}
    if held["params"] != expected or held["m"] != expected \
            or held["v"] != expected:
        raise AssertionError(f"lm_mesh rank {rank}: held {held}, blocks "
                             f"of {expected} bytes")
    del state
    if rank == 0:
        metrics, before, pstate = plain_train(config, steps, device)
        out["loss_rel"] = [rel(a, m[0]) for a, m in zip(losses, metrics)]
        out["grad_norm_rel"] = [rel(a, m[1]) for a, m in zip(norms,
                                                             metrics)]
        mesh_state = type(pstate)(params=lm_common.tree_map_with_path(
            lambda p, _: whole[p], pstate.params, torch.is_tensor),
            opt=pstate.opt)
        out.update(train_close(mesh_state, pstate, LM_MESH_TOL))
        out.update(step_close(whole, dict(lm_common.tree_leaves_with_path(
            pstate.params, torch.is_tensor)), before))
        if max(out["loss_rel"]) > LM_MESH_TOL["loss_rtol"] or \
                max(out["grad_norm_rel"]) > LM_MESH_TOL["grad_norm_rtol"] \
                or out["excess"] > 0 or not out["step_ok"]:
            raise AssertionError(f"lm_mesh train against no mesh: {out}")
    return out


def lm_mesh_serve(mesh, config, rank: int) -> dict:
    """A prefill of ``LM_MESH_PROMPT`` tokens and ``LM_MESH_NEW`` greedy
    decode steps on ``mesh`` and, on rank 0, without one, from the same
    draws: the logits within ``LM_MESH_LOGITS_TOL``, the tokens equal."""
    device = mesh.device
    model = build_model(config, mesh)
    params = model.init(torch.Generator(device=device).manual_seed(LM_SEED))
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, config.vocab_size, (LM_MESH_SERVE_BATCH, LM_MESH_PROMPT)),
        device=device)
    cap = LM_MESH_PROMPT + LM_MESH_NEW
    rt_mesh.reset_collective_stats()
    t0 = time.perf_counter()
    got, _, got_logits = greedy(model, params, tokens, LM_MESH_NEW, cap)
    out = {"kind": "serve", "wall_s": time.perf_counter() - t0,
           "collectives": rt_mesh.collective_stats(),
           "parameter_bytes": state_bytes(params),
           "expected_block_bytes": block_bytes(model, config.param_dtype),
           "tokens": got.tolist()}
    if out["parameter_bytes"] != out["expected_block_bytes"]:
        raise AssertionError(f"lm_mesh rank {rank}: {out}")
    del params
    if rank == 0:
        plain = build_model(config, device=device)
        pparams = plain.init(torch.Generator(device=device).manual_seed(
            LM_SEED))
        want, _, want_logits = greedy(plain, pparams, tokens, LM_MESH_NEW,
                                      cap)
        diff = (got_logits - want_logits).abs()
        out.update(max_abs_diff=float(diff.max()),
                   excess=float((diff - LM_MESH_LOGITS_TOL * (
                       1 + want_logits.abs())).max()),
                   tokens_equal=bool(torch.equal(got, want)))
        if out["excess"] > 0 or not out["tokens_equal"]:
            raise AssertionError(f"lm_mesh serve against no mesh: {out}")
    return out


def lm_mesh_rank(rank: int, world: int, store: str, job: dict) -> None:
    """One of ``LM_MESH_RANKS`` gloo ranks sharing the card (a spawned
    process): every case of ``LM_MESH_CASES`` on ``make_host_mesh(
    LM_MESH_TP)``; writes ``lm_rank<r>.json`` into ``job["dir"]``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=MESH_COLLECTIVE_TIMEOUT_S))
    try:
        mesh = make_host_mesh(LM_MESH_TP, device=job["device"])
        out = {"rank": rank, "device": str(mesh.device), "cases": []}
        reset_launch_counts()
        for arch, profile, kinds, steps in LM_MESH_CASES:
            config = lm_mesh_config(arch, profile)
            for kind in kinds:
                if mesh.device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(mesh.device)
                t0 = time.perf_counter()
                run = (lm_mesh_train(mesh, config, rank, steps)
                       if kind == "train" else
                       lm_mesh_serve(mesh, config, rank))
                run.update(arch=arch, profile=profile,
                           seconds=time.perf_counter() - t0,
                           peak_bytes=torch.cuda.max_memory_allocated(
                               mesh.device)
                           if mesh.device.type == "cuda" else None)
                out["cases"].append(run)
                if mesh.device.type == "cuda":
                    torch.cuda.empty_cache()
        out["launches"] = launch_counts()
        with open(f"{job['dir']}/lm_rank{rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def phase_lm_mesh(card: str, plain_ms: float) -> list:
    """The LM on a mesh: the 1-rank mesh in this process, then the
    spawned gloo ranks, each case's rows printed with every rank's
    bytes and collectives (the ranks' results must agree).  Returns the
    runs whose launches (all 0) the kernels line sums."""
    t_phase = time.perf_counter()
    rows = []
    with tempfile.TemporaryDirectory(prefix="lm_mesh_") as directory:
        dist.init_process_group(LM_MESH_BACKEND,
                                init_method=f"file://{directory}/one",
                                rank=0, world_size=1)
        try:
            mesh = make_host_mesh(1, device=DEVICE)
            rows.append(lm_mesh_train_one(card, mesh, plain_ms))
            rows.append(lm_mesh_serve_one(card, mesh))
        finally:
            dist.destroy_process_group()
        t0 = time.perf_counter()
        ctx = mp.start_processes(
            lm_mesh_rank, args=(LM_MESH_RANKS, f"{directory}/gloo",
                                {"dir": directory, "device": DEVICE}),
            nprocs=LM_MESH_RANKS, join=False, start_method="spawn")
        deadline = time.monotonic() + MESH_SPAWN_TIMEOUT_S
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the {LM_MESH_RANKS} LM mesh ranks "
                                       f"still run after "
                                       f"{MESH_SPAWN_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        spawn_s = time.perf_counter() - t0
        outs = []
        for rank in range(LM_MESH_RANKS):
            with open(f"{directory}/lm_rank{rank}.json") as f:
                outs.append(json.load(f))
    for i, case in enumerate(outs[0]["cases"]):
        each = [out["cases"][i] for out in outs]
        agreed = "losses" if case["kind"] == "train" else "tokens"
        if len({json.dumps(c[agreed]) for c in each}) != 1:
            raise AssertionError(f"lm_mesh {case['arch']} {case['profile']}"
                                 f" {case['kind']}: the ranks' {agreed} "
                                 f"differ")
        row = {"phase": "lm_mesh_ranks", "nvidia_smi": card,
               "process_group": "gloo", "host_staged": True,
               "ranks": LM_MESH_RANKS, "mesh": [LM_MESH_RANKS // LM_MESH_TP,
                                                LM_MESH_TP],
               "devices": sorted({out["device"] for out in outs}),
               "layers": LM_MESH_LAYERS, "dtype": "float32",
               **{k: v for k, v in case.items()
                  if k not in ("parameter_bytes", "moment_bytes",
                               "expected_block_bytes", "peak_bytes",
                               "collectives_a_step", "collectives",
                               "seconds", "step_wall_s", "wall_s")},
               "per_rank": [{k: c.get(k) for k in (
                   "parameter_bytes", "moment_bytes", "expected_block_bytes",
                   "peak_bytes", "seconds", "step_wall_s", "wall_s",
                   "collectives_a_step", "collectives")} for c in each]}
        rows.append(row)
        emit(row)
    launches = summed_launches([{"launches": {
        name: out["launches"].get(name, 0) for name in KERNEL_NAMES}}
        for out in outs] + rows[:2])
    if any(launches.values()):
        raise AssertionError(f"the LM mesh phase launched kernels: "
                             f"{launches}")
    seconds = time.perf_counter() - t_phase
    run = {"phase": "lm_mesh_done", "nvidia_smi": card, "seconds": seconds,
           "spawn_s": spawn_s, "budget_s": LM_MESH_BUDGET_S,
           "within_budget": seconds <= LM_MESH_BUDGET_S,
           "launches": launches}
    emit(run)
    return [run]


def build_all() -> dict:
    """Build every kernel library, one ``nvcc`` each, all at once."""
    loaders = [module.load_library for _, module in LIBRARIES]
    with ThreadPoolExecutor(len(loaders)) as pool:
        list(pool.map(lambda load: load(), loaders))
    return {name: {"sources": [str(p.relative_to(ROOT))
                               for p in module.SOURCES],
                   "ptxas": [ln.strip() for ln in
                             _build.BUILD_LOGS.get(name, "").splitlines()
                             if "registers" in ln or "spill" in ln]}
            for name, module in LIBRARIES}


def host_graphs(specs: dict) -> dict:
    """The connectivity phases' large graphs, made with ``gen``'s numpy
    generators on the host (in a worker process, :class:`HostGraphs`):
    name -> (src, dst, n_vertices, seconds), the int32 edges of
    ``gen.rmat``/``gen.delaunay_like`` on the CPU."""
    out = {}
    for name, (kind, scale) in specs.items():
        t = time.perf_counter()
        g = (gen.rmat(scale, edge_factor=RMAT_EDGE_FACTOR, device="cpu")
             if kind == "rmat" else gen.delaunay_like(scale, device="cpu"))
        out[name] = (g.src.numpy(), g.dst.numpy(), g.n_vertices,
                     time.perf_counter() - t)
    return out


class HostGraphs:
    """:func:`host_graphs` of ``specs`` in one spawned worker process (it
    does not touch the card), started by :meth:`start` where the card
    runs phases that leave the host idle (training, the mesh), so that
    the host-bound serving phases before it are measured alone."""

    def __init__(self, specs: dict):
        self.specs, self.pool, self.future = specs, None, None

    def start(self) -> None:
        self.pool = ProcessPoolExecutor(1, mp_context=mp.get_context(
            "spawn"))
        self.future = self.pool.submit(host_graphs, self.specs)

    def result(self) -> dict:
        if self.future is None:
            self.start()
        return self.future.result()

    def stop(self) -> None:
        """End the worker, finished or not."""
        if self.pool is None:
            return
        for process in list(getattr(self.pool, "_processes", {}).values()):
            if process.is_alive():
                process.kill()
        self.pool.shutdown(wait=True, cancel_futures=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rmat-scale", type=int, default=22)
    ap.add_argument("--delaunay-scale", type=int, default=24)
    ap.add_argument("--star-scale", type=int, default=20)
    ap.add_argument("--async-rmat-scale", type=int, default=20)
    ap.add_argument("--async-delaunay-scale", type=int, default=21)
    ap.add_argument("--check-scale", type=int, default=16)
    ap.add_argument("--lp-delaunay-scale", type=int, default=18)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    # the large graphs are made on the host while the card trains
    # (rmat(22,16) alone takes 190-370 s of numpy work)
    rmat_name = f"rmat({args.rmat_scale},{RMAT_EDGE_FACTOR})"
    delaunay_name = f"delaunay_like({args.delaunay_scale})"
    async_rmat_name = f"rmat({args.async_rmat_scale},{RMAT_EDGE_FACTOR})"
    graphs = HostGraphs({rmat_name: ("rmat", args.rmat_scale),
                         delaunay_name: ("delaunay", args.delaunay_scale),
                         async_rmat_name: ("rmat", args.async_rmat_scale)})
    try:
        return run_phases(args, t_all, graphs, rmat_name, delaunay_name,
                          async_rmat_name)
    finally:
        graphs.stop()


def run_phases(args, t_all: float, graphs: HostGraphs, rmat_name: str,
               delaunay_name: str, async_rmat_name: str) -> int:
    """Every phase of :func:`main` in order; ``graphs`` are started when
    the training phase starts and taken when the connectivity phases
    start."""
    # 1. device
    t0 = time.perf_counter()
    card = device_line()
    emit({"phase": "device", "nvidia_smi": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "seconds": time.perf_counter() - t0})

    # 2. build every kernel of the paths from the checkout's sources
    t0 = time.perf_counter()
    libraries = build_all()
    emit({"phase": "build", "libraries": libraries,
          "seconds": time.perf_counter() - t0})

    # 2b. the float kernels against their plain versions, then their entry
    # points at mistral-nemo-12b's widths
    t0 = time.perf_counter()
    kernels = {}
    rms_checked = phase_rmsnorm_vs_plain()
    flash_checked = phase_flash_vs_plain()
    rms_run = phase_rmsnorm_path()
    flash_run = phase_flash_path()
    kernels["rmsnorm_rows"] = float_kernel_entry(
        "rmsnorm_rows", RMSNORM_SOURCE, rms_checked, rms_run)
    kernels["flash_mha"] = float_kernel_entry(
        "flash_mha", FLASH_SOURCE, flash_checked, flash_run)
    float_runs = [rms_run, flash_run]
    emit({"phase": "float_kernels_done",
          "seconds": time.perf_counter() - t0})

    # 2c. the LM serving path at mistral-nemo-12b's full width and depth
    # (its weights are freed before the graphs are made); its K4/K5
    # cross-checks' launches join the kernels line
    float_runs += phase_lm(card)
    # 2d. the other LM families at full width (arctic-480b at 2 layers),
    # one model at a time, each freed before the next
    float_runs += phase_lm_families(card)
    # 2e. the training path at olmo-1b's full width and depth, then its
    # checks at 2 layers and the smoke configs card against CPU; the
    # graphs are made on the host from here on
    graphs.start()
    train_runs = phase_train(card)
    float_runs += train_runs
    # 2f. the LM on a mesh: a 1-rank NCCL mesh, then gloo ranks sharing
    # the card
    float_runs += phase_lm_mesh(card, train_runs[0]["step_ms_mean"])

    # graphs: the sizes of the paper's soc-LiveJournal1 and delaunay_n24
    # for the main and frontier paths, smaller ones for the async path
    # (within the reference scalar kernel's own n <= 3,145,728) and for
    # the mm2 checks against its plain Python loop
    t0 = time.perf_counter()
    seconds = {}

    def make(name, fn):
        t = time.perf_counter()
        g = fn()
        seconds[name] = time.perf_counter() - t
        return g

    made = graphs.result()
    waited_s = time.perf_counter() - t0
    on_card = {name: Graph.from_numpy(src, dst, n, device=DEVICE)
               for name, (src, dst, n, _) in made.items()}
    host_seconds = {name: m[3] for name, m in made.items()}
    del made
    rmat, delaunay = on_card[rmat_name], on_card[delaunay_name]
    star = make("star", lambda: gen.star(1 << args.star_scale,
                                         device=DEVICE))
    async_graphs = {
        f"delaunay_like({args.async_delaunay_scale})": make(
            "async_delaunay", lambda: gen.delaunay_like(
                args.async_delaunay_scale, device=DEVICE)),
        async_rmat_name: on_card[async_rmat_name],
    }
    # no reference of its own to the graphs: the phases free them
    del on_card
    check_graphs = {
        f"delaunay_like({args.check_scale})": gen.delaunay_like(
            args.check_scale, device=DEVICE),
        f"rmat({args.check_scale},{RMAT_EDGE_FACTOR})": gen.rmat(
            args.check_scale, edge_factor=RMAT_EDGE_FACTOR, device=DEVICE),
        # each edge (i, i + 1) reads the label the edge before wrote; every
        # edge meets the hub
        "path_unshuffled(65536)": gen.path(1 << 16, shuffle_ids=False,
                                           device=DEVICE),
        "star(65536)": gen.star(1 << 16, device=DEVICE),
        # every edge meets vertex 0 (the sweep kernels' checks only)
        "one_hub(65536)": Graph.from_numpy(
            np.zeros((1 << 16) - 1, np.int64), np.arange(1, 1 << 16),
            1 << 16, device=DEVICE),
    }
    emit({"phase": "graphs", "seconds": time.perf_counter() - t0,
          "waited_for_the_host_s": waited_s,
          "host_seconds_each": host_seconds, "seconds_each": seconds,
          **{name: [g.n_vertices, g.n_edges] for name, g in
             [(rmat_name, rmat), (delaunay_name, delaunay),
              *async_graphs.items(), *check_graphs.items()]}})

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    kernels.update(phase_kernels(
        {rmat_name: rmat, delaunay_name: delaunay}, star, {
            name: check_graphs[name] for name in (
                f"delaunay_like({args.check_scale})",
                f"rmat({args.check_scale},{RMAT_EDGE_FACTOR})",
                "path_unshuffled(65536)", "star(65536)", "one_hub(65536)")}))
    del star
    kernels["mm2"] = phase_mm2(
        {name: g for name, g in check_graphs.items()
         if not name.startswith("one_hub")}, async_graphs)
    del check_graphs
    emit({"phase": "kernels_vs_plain_done",
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    ref_rmat = scipy_labels(rmat)
    ref_delaunay = scipy_labels(delaunay)
    ref_async = {name: scipy_labels(g) for name, g in async_graphs.items()}
    emit({"phase": "scipy_reference", "seconds": time.perf_counter() - t0})

    # 4. the main path at real size; 5. the second kernel on the main
    # entry point (C-11mm's order-1 warm-up sweeps)
    t0 = time.perf_counter()
    runs = [drive(delaunay, delaunay_name, "C-2", ref_delaunay),
            drive(rmat, rmat_name, "C-2", ref_rmat)]
    if not all(r["launches"]["fused_relax"] > 0 for r in runs):
        raise AssertionError("the main path did not launch fused_relax")
    if not all(r["launches"]["converged_early"] > 0
               and r["launches"]["pointer_jump"] > 0 for r in runs):
        raise AssertionError("the main path did not launch converged_early "
                             "and pointer_jump")
    c11 = drive(rmat, rmat_name, "C-11mm", ref_rmat)
    if c11["launches"]["scatter_min"] <= 0:
        raise AssertionError("C-11mm did not launch scatter_min")
    runs.append(c11)
    # the loop's kernels against their plain versions, at the main path's
    # label states and the solves' fixed points
    fixed = {rmat_name: (rmat, runs[1].pop("labels")),
             delaunay_name: (delaunay, runs[0].pop("labels"))}
    del c11["labels"]
    kernels.update(phase_converged(fixed))
    kernels["pointer_jump"] = phase_jump(fixed)
    del fixed
    emit({"phase": "main_path_done", "seconds": time.perf_counter() - t0})

    # 6. the async path: cuda_async on the in-order kernel; the first
    # graph's solve also runs on CPU tensors, through mm2_plain
    t0 = time.perf_counter()
    async_runs = [drive_async(g, name, ref_async[name], {}, on_cpu=i == 0)
                  for i, (name, g) in enumerate(async_graphs.items())]
    if not all(r["launches"]["mm2"] > 0 for r in async_runs):
        raise AssertionError("the async path did not launch mm2")
    runs += async_runs
    emit({"phase": "async_path_done", "seconds": time.perf_counter() - t0})

    # 7. the frontier path, staged at the paper's sizes, every strategy;
    # and cuda_async under the frontier
    t0 = time.perf_counter()
    frontier_runs = [drive_frontier(g, name, strategy, ref)
                     for strategy in SAMPLING_STRATEGIES
                     for name, g, ref in
                     ((delaunay_name, delaunay, ref_delaunay),
                      (rmat_name, rmat, ref_rmat))]
    if not all(r["launches"]["fused_relax"] > 0 for r in frontier_runs):
        raise AssertionError("the frontier path did not launch fused_relax")
    for name, g in ((delaunay_name, delaunay), (rmat_name, rmat)):
        emit({"phase": "frontier_parts", "graph": name,
              **frontier_parts(g)})
    name, g = next(iter(async_graphs.items()))
    async_frontier = drive_async(g, name, ref_async[name], FRONTIER,
                                 on_cpu=True)
    if async_frontier["launches"]["mm2"] <= 0:
        raise AssertionError("cuda_async under the frontier did not launch "
                             "mm2")
    runs += frontier_runs + [async_frontier] + float_runs
    emit({"phase": "frontier_path_done",
          "seconds": time.perf_counter() - t0})

    # 7b. fleets of small graphs through solve_batch, then algorithm="auto"
    # on the main path's graphs and the autotuner on the async rmat
    stream_name = f"rmat({args.async_rmat_scale},{RMAT_EDGE_FACTOR})"
    t0 = time.perf_counter()
    batch_runs, batch_kernels = phase_batch()
    kernels.update(batch_kernels)
    batch_s = time.perf_counter() - t0
    emit({"phase": "batch_path_done", "seconds": batch_s})
    t0 = time.perf_counter()
    auto_runs = [
        drive_auto(delaunay, delaunay_name, ref_delaunay,
                   runs[0]["loop_cost"]["solve_ms"]),
        drive_auto(rmat, rmat_name, ref_rmat,
                   runs[1]["loop_cost"]["solve_ms"]),
        # the async path's rmat(20,16)
        drive_autotune(async_graphs[stream_name], stream_name,
                       ref_async[stream_name])]
    auto_s = time.perf_counter() - t0
    runs += batch_runs + auto_runs
    emit({"phase": "auto_path_done", "seconds": auto_s,
          "batch_and_auto_s": batch_s + auto_s,
          "budget_s": BATCH_AUTO_BUDGET_S,
          "within_budget": batch_s + auto_s <= BATCH_AUTO_BUDGET_S})
    # the out-of-core and recovery paths take the async graphs' edges from
    # the host
    async_host = {name: g.to_numpy() for name, g in async_graphs.items()}
    del async_graphs, g

    # 8. the baseline families: FastSV on the main path's graphs, label
    # propagation on rmat and on a smaller mesh (its iterations grow with
    # the diameter), Rem (a host loop) only at the check scale, where every
    # family is also held against its solve on CPU tensors
    t0 = time.perf_counter()
    dense_ms = {delaunay_name: runs[0]["loop_cost"]["solve_ms"],
                rmat_name: runs[1]["loop_cost"]["solve_ms"]}
    lp_name = f"delaunay_like({args.lp_delaunay_scale})"
    lp_graph = gen.delaunay_like(args.lp_delaunay_scale, device=DEVICE)
    baseline_runs = [
        drive_baseline(delaunay, delaunay_name, "fastsv", ref_delaunay,
                       False, dense_ms[delaunay_name]),
        drive_baseline(rmat, rmat_name, "fastsv", ref_rmat, False,
                       dense_ms[rmat_name]),
        drive_baseline(rmat, rmat_name, "label_propagation", ref_rmat, False,
                       dense_ms[rmat_name]),
        drive_baseline(lp_graph, lp_name, "label_propagation",
                       scipy_labels(lp_graph), False)]
    del lp_graph
    for name, g in ((delaunay_name, delaunay), (rmat_name, rmat)):
        emit({"phase": "fastsv_freeze", "graph": name,
              **fastsv_freeze_cost(g)})
    for name, g in (
            (f"delaunay_like({args.check_scale})",
             gen.delaunay_like(args.check_scale, device=DEVICE)),
            (f"rmat({args.check_scale},{RMAT_EDGE_FACTOR})",
             gen.rmat(args.check_scale, edge_factor=RMAT_EDGE_FACTOR,
                      device=DEVICE))):
        ref = scipy_labels(g)
        baseline_runs += [drive_baseline(g, name, a, ref, True)
                          for a in ("fastsv", "label_propagation",
                                    "union_find")]
    runs += baseline_runs
    emit({"phase": "baseline_path_done",
          "seconds": time.perf_counter() - t0})

    # 9. the streaming path: the main path's graphs streamed in batches of
    # their own edges, then the card against CPU tensors at the check scale
    t0 = time.perf_counter()
    stream_runs = [drive_stream(delaunay, delaunay_name, ref_delaunay),
                   drive_stream(rmat, rmat_name, ref_rmat)]
    # the out-of-core path reads rmat's edges from the host, and the mesh
    # phase both graphs'
    rmat_host = rmat.to_numpy()
    delaunay_host = delaunay.to_numpy()
    del rmat, delaunay
    stream_runs += [stream_vs_cpu(g, name) for name, g in (
        (f"delaunay_like({args.check_scale})",
         gen.delaunay_like(args.check_scale, device=DEVICE)),
        (f"rmat({args.check_scale},{RMAT_EDGE_FACTOR})",
         gen.rmat(args.check_scale, edge_factor=RMAT_EDGE_FACTOR,
                  device=DEVICE)))]
    runs += stream_runs
    stream_s = time.perf_counter() - t0
    emit({"phase": "stream_path_done", "seconds": stream_s})

    # 10. the serving path: the engine under traffic on the card, and its
    # recovery from injected crashes
    t0 = time.perf_counter()
    runs += phase_serve()
    serve_s = time.perf_counter() - t0
    emit({"phase": "serve_path_done", "seconds": serve_s,
          "stream_and_serve_s": stream_s + serve_s,
          "budget_s": STREAM_SERVE_BUDGET_S,
          "within_budget": stream_s + serve_s <= STREAM_SERVE_BUDGET_S})

    # 11. the out-of-core path: the edges stream from the host, the card
    # holds the labels and one chunk; then the recovery loops
    t0 = time.perf_counter()
    _flush.clear()
    mesh_name = f"delaunay_like({args.async_delaunay_scale})"
    stream_name = f"rmat({args.async_rmat_scale},{RMAT_EDGE_FACTOR})"
    oocore_runs, mesh_out, mesh_rounds = phase_oocore(
        rmat_host, async_host[mesh_name], ref_rmat, rmat_name, mesh_name)
    oocore_s = time.perf_counter() - t0
    emit({"phase": "oocore_path_done", "seconds": oocore_s})
    t0 = time.perf_counter()
    runs += oocore_runs + phase_recovery(
        async_host[mesh_name], mesh_out, mesh_rounds,
        async_host[stream_name], mesh_name, stream_name)
    recovery_s = time.perf_counter() - t0
    emit({"phase": "recovery_path_done", "seconds": recovery_s,
          "oocore_and_recovery_s": oocore_s + recovery_s,
          "budget_s": OOCORE_BUDGET_S,
          "within_budget": oocore_s + recovery_s <= OOCORE_BUDGET_S})

    # 12. the mesh phase: a 1-rank NCCL mesh on the main path's graphs and
    # the stream's mesh path, then MESH_RANKS gloo ranks on the card over
    # the async path's graphs and the elastic shrink
    t0 = time.perf_counter()
    _flush.clear()
    runs += phase_mesh(
        {rmat_name: (rmat_host, ref_rmat),
         delaunay_name: (delaunay_host, ref_delaunay)},
        {name: (async_host[name], ref_async[name]) for name in async_host},
        rmat_name, mesh_name)
    del rmat_host, delaunay_host
    mesh_s = time.perf_counter() - t0
    emit({"phase": "mesh_done", "seconds": mesh_s,
          "budget_s": MESH_BUDGET_S, "within_budget": mesh_s <= MESH_BUDGET_S})

    # 13. the kernels line: launches summed over every path's runs
    line = []
    for name in KERNEL_NAMES:
        k = dict(kernels[name])
        k["launches"] = sum(r["launches"][name] for r in runs)
        if name in ROUTED:
            k["launches_by_route"] = {
                route: sum(r.get("routes", {}).get(name, {}).get(route, 0)
                           for r in runs) for route in ROUTES}
        k["max_abs_diff"] = k["max_abs_err"]
        k["kernel_ms"] = k["ms"]
        line.append(k)
    roofline = train_runs[0]["roofline_path"]
    emit({"roofline": {"nvidia_smi": card, "train": roofline["train"],
                       "decode": roofline["decode"],
                       "contour": roofline_contour(kernels)}})
    print(card, flush=True)
    emit({"kernels": line, "seconds_total": time.perf_counter() - t_all})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
