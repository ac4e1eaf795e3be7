#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, and drives the port's
paths through them:

  * the main path (`build_workload` -> `simulate` -> `request_stats`) on the
    paper's topology study at scale 16 (`studies.topology.workload`) and on
    two long traces (the fused
    serve-round kernel, once per round; its converged round held against
    the plain round and its time split by step);
  * the link-layer studies (`studies.link_layer`, `studies.link_reliability`)
    at the reference benchmarks' full sizes, their sweeps stacked
    (`simulate_stacked`: one fused serve-round launch per round for all
    members);
  * the paper-figure studies (`studies.validation`, `topology`, `routing`,
    `full_duplex`, `traces`: Fig. 7/8, 10-13, 16-20 and Table IV) at the
    reference benchmarks' full sizes, every schedule through the fused
    serve round (where the reference's `simulate_auto` would hand a
    schedule to the host oracle, the port's runs the fixpoint on, on the
    card, until it converges); each converged schedule is held against the
    oracle, one that ends unconverged at its default budget (the ring at
    scale 16, as in the reference) against the port's CPU run with that
    budget, and Fig. 10 at scale 16 against the main path's bandwidth;
  * `depart_times` (segmented depart kernel) on the converged rounds of the
    paper fabrics and of every expected-mode sweep member, against the
    fused serve round's departures;
  * the link explorer's flit-efficiency grid (`flit_sweep`, flit-pack
    kernel);
  * the model stack's serving path: recurrentgemma-2b at its published
    width (26 layers, d_model 2560, weights drawn from a seeded generator)
    behind the slot server (`runtime.server.Server`), whose prefills run the
    tensor-core flash-attention kernel (bf16) and the RG-LRU scan kernel;
  * device-handled coherence (`studies.snoop_filter`, `invblk`,
    `coherence_fabric`, `coherence_modes`: Fig. 14, Fig. 15 and the coupled
    studies) at the reference's full sizes, the snoop-filter protocol
    through the `sf_scan` kernel (held against its plain version bit for
    bit, Fig. 14/15 against the JAX package's integers), every coupled
    fabric pass through the fused serve round and against the oracle, and
    `simulate_coupled` itself against its CPU run;
  * the telemetry layer (`core.telemetry`): `fabric_metrics` on the main
    path's converged schedules (its retraining replay is one fused
    serve-round launch) against the same call on the CPU, the telemetry
    study (`studies.telemetry`) against the JAX package's rows, and the SF
    counters of Fig. 14's card events against the JAX package's;
  * the observability back end (`core.critical_path`, `core.trace_export`)
    on the main path's chain and markers schedules: the backpointer replay
    (`extract_backpointers(check=True)`, which holds the fused serve round's
    grants bit for bit), critical paths of a fixed sample of rows, blame,
    what-ifs and the Perfetto trace with its flows, each held against the
    same on the port's CPU run; the critical-path study
    (`studies.critical_path`) and the trace viewer
    (`studies.fabric_trace_viewer`, its SF scans through `sf_scan`) against
    the JAX package's rows and printout;
  * the streaming windowed engine (`core.streaming`): the streaming study
    (`studies.streaming`, 1.2 M requests through 65,536-row windows, each
    window's fixpoint through the fused serve round) against the JAX
    package's rows; phase 4b's markers tables in issue order streamed
    through 1,024-row windows (rows carried across window edges, the
    retraining replay once a window) and a Fig. 14-sized coherence stream
    (one `sf_scan` launch a chunk, from the carried SF state), each
    against its monolithic card schedule bit for bit; the verifier smoke
    (`analysis.verify_smoke`) on card lowerings against the JAX package's
    printout;
  * the TPU-fabric cost model (`core.fabric_model`, `core.autotune`,
    `runtime.straggler`): the fabric study (`studies.fabric`: collectives
    on the simulated 16 x 16 v5e torus and a 2-pod DCN ring, each one
    schedule through the fused serve round, held against the oracle)
    against the JAX package's rows; the autotune, coherence and
    link-reliability demos (`studies.fabric_autotune`,
    `coherence_fabric_demo`, `link_reliability_demo`) against the
    examples' printouts; `studies.serve_decode` on recurrentgemma-2b's
    smoke config (the flash-attention and RG-LRU scan kernels) against a
    manual decode loop;
  * mamba2-1.3b at its published width (48 SSD layers, d_model 2048,
    1.344 B parameters) behind the same server, prompts of 1 to 16,384
    tokens, whose prefills run the tensor-core SSD chunk kernel (bf16).
  * the model stack's remaining families at their published widths
    (phase 5h, after the earlier models are freed): qwen3-moe-30b-a3b
    (48 MoE layers, 128 experts top 8, 30.2 B parameters) behind the slot
    server, held token for token against a loop that reproduces the
    server's batch (a MoE tick routes its slots as one capacity group),
    with the kept share of (token, choice) pairs of every prefill and
    tick; whisper-base (6 encoder and 6 cross-attention decoder layers,
    1,500 seeded encoder frames) and phi-3-vision-4.2b (576 seeded patch
    embeddings) through prefill and decode, every step against forward;
    every attention, encoder and cross-attention layer through the
    tensor-core flash kernel, non-causal and with fewer queries than keys
    where whisper needs it.
  * training on the card (phase 5i, after phase 5h's models are freed):
    the flash-attention backward kernel and the RG-LRU scan's reverse mode
    against their plain versions (and timed against their bounds and
    SDPA's backward); one full-width recurrentgemma-2b period's loss and
    every gradient leaf on the card against the host CPU; recurrentgemma-2b
    at full width (26 layers, AdamW state, 4,096 tokens a step) through
    `Trainer.fit` for 10 steps held to a loss rule fixed from a probe, and
    the same at lr 0, which the rule must refuse; the 100m preset's
    checkpoint resume, bit for bit; `studies.quickstart` and the smoke
    `studies.train_small_lm` as a user runs them (their llama's head dim 8
    padded to 16 for both flash kernels), each with falling losses; the
    SSD backward kernel against its plain backward (and timed); mamba2-1.3b
    trained on the card: its smoke config, a full-width period against the
    host CPU and 10 full-width steps (finite, the loss rule recorded).
  * the production-mesh layer (phase 5j, after phase 5i): the GPipe schedule
    (`parallel.pipeline_par`) over recurrentgemma-2b's first 24 layers at
    its published width in four stages, four microbatches of 2,048 tokens
    (the flash-attention and RG-LRU scan kernels), bit for bit against each
    microbatch through the stages in order and within MODEL_TOL of the whole
    batch; the dry-run stand-in (`launch.dryrun`, its meta counts in a host
    subprocess that runs beside phase 5i) over the three hillclimb
    cells, the roofline CLI with its fabric cross-check through the fused
    serve round, held against the same on the CPU, and `launch.hillclimb
    --cell mamba2`.

Every study's rows are held against the JAX package's, recorded on the CPU
as constants below (`STUDY_REF`, `TRACES_REF`, `TELEMETRY_REF`,
`CRITICAL_PATH_REF`, `STREAMING_REF`, `FABRIC_REF`, Fig. 14/15's integers).

Before any of that it logs the host's numpy and C library and holds every
synthetic trace the studies replay (`core.traces.generate`) against the
JAX package's, by sha256.

flash_attention and ssd_chunk each have a tensor-core kernel (bf16) and a
CUDA-core one (float32); both are held against the plain versions and
timed, and the served models must launch the tensor-core ones only.  The
serve round has the fused kernel (the engine's path) and a map-only scan
sharing its device code; both are held against the plain versions and
timed.

Every converged schedule is checked against the port's event-driven
oracle, every served request against a manual prefill/decode loop, and the
script prints one JSON object per result line.  The last line is
``{"ok": true, "device": {...}}``; any failed check raises, so the script
exits non-zero and never prints it.  It imports
nothing of JAX and nothing of the ``repro`` package.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import io
import json
import math
import os
import platform
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM rate and the
# non-tensor-core 32-bit rate, the closest listed rate to the kernel's
# integer max/add work
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# map-only serve scan, per item: six int64 map components read, one int64
# written; applying one map to the state is 4 adds + 4 max + 2 saturations
SCAN_BYTES_PER_ITEM = 7 * 8
SCAN_OPS_PER_ITEM = 10
# fused serve round, per item: the operands' bytes (read once, counted from
# the tensors: 84 B for the engine's dtypes) and three int64 outputs; the
# lookups, the map (about 30 adds, compares and selects) and its application
ROUND_OUT_BYTES_PER_ITEM = 3 * 8
ROUND_OPS_PER_ITEM = 40
# segmented depart, per item: int64 channel, arrive and ser read, depart
# written (28 B with an int32 channel); a head test, an add and a max
DEPART_BYTES_PER_ITEM = 4 * 8
DEPART_BYTES_PER_ITEM_I32 = 4 + 3 * 8
DEPART_OPS_PER_ITEM = 3
# flit pack, per point: four int32 reads, an int32 and a float32 write;
# ceil division, multiply, select, three float multiply/adds, max, divide
FLIT_BYTES_PER_ITEM = 6 * 4
FLIT_OPS_PER_ITEM = 8

# bf16 dense tensor-core rate of the H100 SXM (NVIDIA data sheet): the rate
# attention's products could run at
TENSOR_BF16_FLOPS_PER_S = 989e12
# flash attention: a score and a PV product per unmasked (query, key) pair,
# 2 * D flops each
FLASH_FLOPS_PER_PAIR_PER_D = 4
# RG-LRU scan, per element: a and b read, h written (float32); a multiply
# and an add
RGLRU_BYTES_PER_ITEM = 3 * 4
RGLRU_OPS_PER_ITEM = 2
MODEL_ARCH = "recurrentgemma-2b"
SERVE_PROMPTS = (64, 300, 1024, 2047, 2048, 2049, 3000, 4096)
SERVE_NEW = 32
SERVE_SLOTS = 4
SERVE_MAX_LEN = 4608
# the tokens of the prefill-against-forward check of the served models
SERVE_FORWARD_TOKENS = 2304
# the bf16 tolerance the port's CPU tests hold the model to (against the
# JAX reference, and the card against the CPU)
MODEL_TOL = 5e-2
# phase 5h, the model families at full width
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_PROMPTS = (64, 300, 512, 1024, 1536, 2048, 3072, 4096)
MOE_FORWARD_TOKENS = 2048
WHISPER_ARCH = "whisper-base"
WHISPER_FRAMES = 1500
WHISPER_PROMPTS = (224, 448)
VLM_ARCH = "phi-3-vision-4.2b"
VLM_PROMPTS = (1024, 4096)
FAMILY_NEW = 32
# phi-3-vision's decode steps against forward: at its published width the
# bf16 noise of two forward passes alone exceeds MODEL_TOL's element bound,
# so its steps are held by their relative RMS error and greedy tokens.  On
# an H100 (700 W) sound runs read 0.019-0.020 and runs whose decode RoPE
# positions are one token on read 0.30-0.34 (two on 0.50, eight on 0.64);
# the limit sits between, with room of about 3.5 and 4.3 times
VLM_REL_RMS_LIMIT = 0.07
# what may be allocated on the card when phase 5h starts
FAMILY_START_BYTES = 4 << 30
# phase 5j, the production-mesh layer: `parallel.pipeline_par` over
# recurrentgemma-2b's first PIPE_STAGES * PIPE_PERIODS periods at its
# published width (the embedding, the two tail layers and the final norm
# stay outside), PIPE_MICROBATCHES rows of PIPE_TOKENS tokens, one a
# microbatch; then the dry-run stand-in over the hillclimb cells (its meta
# counts in a host subprocess started before phase 5i, CUDA hidden from it,
# joined here within DRYRUN_WAIT_S), the roofline with its fabric
# cross-check on the card, and `launch.hillclimb --cell HILLCLIMB_CELL`
PIPE_STAGES = 4
PIPE_PERIODS = 2
PIPE_MICROBATCHES = 4
PIPE_TOKENS = 2048
HILLCLIMB_CELL = "mamba2"
DRYRUN_WAIT_S = 600
# phase 5i, training: recurrentgemma-2b at full width, one period on
# PERIOD_TOKENS tokens on the card against the host CPU, then TRAIN_STEPS
# steps of one row of TRAIN_TOKENS tokens (train_4k's length; its global
# batch of 256 cut to 1 and its steps to 10) through `Trainer.fit`, once at
# TRAIN_LR and once, as the planted fault the loss rule must refuse, at lr
# 0; the 100m preset's resume on TRAIN_100M_BATCH x TRAIN_100M_SEQ
PERIOD_TOKENS = 512
TRAIN_TOKENS = 4096
TRAIN_STEPS = 10
TRAIN_LR = 1e-3
TRAIN_WARMUP = 2
TRAIN_100M_BATCH = 8
TRAIN_100M_SEQ = 256
# then the small training drivers on the card: `studies.quickstart` (its
# smoke llama, 30 steps of 8 x 32 tokens) and SMALL_TRAIN_STEPS steps of
# `studies.train_small_lm --preset smoke` (8 x 64): head dim 8, which the
# autograd op pads to 16 for the tensor-core kernels; each must finish with
# finite losses, the last below the first
SMALL_TRAIN_ARCH = "llama3-8b"
SMALL_TRAIN_BATCHES = ((8, 32), (8, 64))
SMALL_TRAIN_STEPS = 20
# the flash backward kernel against its plain version on the same inputs
# (q, k, v, dO, the forward kernel's bf16 output and LSE; float32):
# |got - want| <= FLASH_BWD_ULPS bf16 spacings of want plus FLASH_BWD_REL
# of the tensor's largest |want| (the bf16 rounding of the outputs, and the
# float32 sums taken in another order over up to 4,096 keys and 10 heads).
# Against autograd through the plain forward in float32 the same bound is
# widened by the plain backward's own distance from autograd: delta =
# rowsum(dO O) reads the stored bf16 output, as FlashAttention-2's does,
# where autograd differentiates the float32 softmax (measured on an NVIDIA
# H100 80GB HBM3 at 700 W: dq and dk at 2.4 and 2.6 times the unwidened
# bound; the plain backward with the bf16 output at 2.1, with a float32
# output at 0.22)
FLASH_BWD_ULPS = 2
FLASH_BWD_REL = 1e-3
# and an absolute floor for float32 cancellation: a row that sees one key
# has dS = P (dO . V - dO . O) = 0 in exact arithmetic, about 1e-7 of
# rounding in both versions (1.7e-7 measured on the same card)
FLASH_BWD_ATOL = 1e-5
# the forward's base-2 log-sum-exp against the plain version's (values up
# to about 20; ex2.approx and another order of the float32 row sums)
FLASH_LSE_ATOL = 1e-3
# the RG-LRU adjoint against the plain reverse walk: the chunk carries
# round otherwise, and the adjoint sums g over about 1 / (1 - a) steps
# (values to a few hundred), so the bound is relative to the largest
RGLRU_BWD_REL = 1e-5
# one full-width period on the card against the host CPU: the loss within
# MODEL_TOL, and each gradient leaf within PERIOD_GRAD_REL in relative L2
# norm (bf16 products summed in another order, the kernels' float32
# softmax and chunked scan, bf16 gradients)
PERIOD_GRAD_REL = 5e-2
# the 10-step run's loss rule, fixed from a probe run (NVIDIA H100 80GB
# HBM3, 700 W: at lr 1e-3 the loss went 12.93 -> 5.68, at lr 0 it stayed
# within 12.91-12.98): the last loss at least this far (nats) below the
# first
TRAIN_LOSS_DROP = 2.0
MAMBA_ARCH = "mamba2-1.3b"
MAMBA_PROMPTS = (1, 100, 128, 129, 1000, 2048, 4096, 16_384)
MAMBA_MAX_LEN = 16_448
# SSD chunk scan: x (B, S, H, P) and y in bf16, b and c (B, S, N) bf16, dt
# (B, S, H) and the final state (B, H, P, N) float32
SSD_SHAPE = (1, 4096, 64, 64, 128)
# the reference suite's kernel-vs-oracle tolerance (test_kernels.py:
# 119-120), on its own input family and on model-like inputs alike (tighter
# than its chunk-invariance bound, atol 2e-4 / rtol 2e-3): the kernel and
# the plain version take the chunk cumsum in one order
SSD_TOL = (3e-5, 3e-4)
# the SSD backward kernel against the plain backward in float64 on the same
# bf16 values: each gradient within this share of its norm (relative L2),
# fixed from the CPU emulation's distance before the kernel first ran
# (tests/test_torch_ssd_bwd.py states the same numbers): dx comes back in
# bf16, ddt and da_log carry float32 cancellation
SSD_BWD_TOL = {"dx": 4e-3, "ddt": 1e-4, "da_log": 1e-3, "db": 1e-5,
               "dc": 1e-5}
# the SSD backward's cases on the card: S (one step, ragged, one chunk,
# one chunk and a step, a segment boundary before a ragged tail, mamba2's
# training length) at B 2, the smoke config's (H, P, N) and full width's
SSD_BWD_S = (1, 100, 128, 129, 421, 4096)
SSD_BWD_DIMS = ((4, 16, 16), (4, 64, 128))
# mamba2-1.3b's smoke config trained on the card: steps of one batch
SSD_SMOKE_STEPS = 10
SSD_SMOKE_BATCH = (2, 64)

# Rounds the JAX reference needs where the computed `round_bound` falls
# short of them: the ring at scale 16 with 120 requests per pair takes 83
# against a bound of 71 (tests/test_torch_round_bound.py holds the port and
# the reference to it on the CPU).  With the default options such a run is
# unconverged at the bound and `simulate_auto` hands it to the oracle.
REF_ROUNDS = {"ring": 83}

# The snoop-filter scan (`sf_scan`): Fig. 14 and Fig. 15 at the reference's
# full size, n 32,000 requests over 4,096 lines, SF and caches of 819 lines.
# The JAX package's integers for them, per policy and per InvBlk length:
# (bandwidth_MBps, bisnp_events, invalidated_lines, total_time_ps, the sum
# of latency_ps), made on the CPU with
#   PYTHONPATH=src python3 -c 'import repro.core, numpy as np
#   from repro.core.snoop_filter import *
#   a = make_skewed_stream(32000, 4096, write_ratio=0.1, seed=3)
#   r = simulate_sf(*a, SFConfig(capacity=819, policy="fifo"),
#                   CacheConfig(capacity=819))
#   print(int(r.bandwidth_MBps), int(r.bisnp_events),
#         int(r.invalidated_lines), int(r.total_time_ps),
#         int(np.asarray(r.latency_ps).sum()))'
# for each policy, and for Fig. 15 with make_sequential_stream(32000, 4096,
# n_requesters=2, write_ratio=0.5, seed=5), SFConfig(capacity=819,
# policy="blp", invblk_max=L, bus_MBps=12_000, writeback_ps=30_000) and
# n_requesters=2 (the configurations of benchmarks/bench_snoop_filter.py
# and bench_invblk.py).
SF_N, SF_FOOT = 32_000, 4_096
FIG14_REF = {
    "fifo": (1453, 4586, 4586, 1408659000, 1408659000),
    "lru": (1453, 4586, 4586, 1408659000, 1408659000),
    "lfi": (1809, 3200, 3200, 1131981000, 1131981000),
    "lifo": (2070, 2485, 2485, 989031000, 989031000),
    "mru": (2070, 2485, 2485, 989031000, 989031000),
}
FIG15_REF = {
    1: (591, 22043, 22043, 3460622257, 6921225180),
    2: (646, 15679, 22044, 3168247590, 6336425847),
    3: (655, 13559, 22049, 3122257590, 6244446513),
    4: (652, 12496, 22048, 3137285589, 6274437845),
}
# The synthetic traces the port's studies replay, as the `traces.generate`
# arguments (name, n, footprint_lines, seed) of the traces study (Fig. 18/19,
# Fig. 20a, Fig. 20b) and of the coupled study's trace mode, each with the
# sha256 of its addresses (int64, little-endian) then its is_write flags
# (one byte each), made from the JAX package on the CPU with numpy 2.0.2 by
#   PYTHONPATH=src python3 -c 'import hashlib, numpy as np
#   from repro.core.traces import generate
#   t = generate(name, n, footprint_lines, seed)
#   print(hashlib.sha256(t["addr"].astype("<i8").tobytes()
#                        + t["is_write"].astype(np.uint8).tobytes())
#         .hexdigest())'
# for each key.  The redis trace's zipf ranks differ between numpy builds
# unless the port draws them with numpy 2.0.2's loop (`traces._zipf`).
TRACE_SHA256 = {
    ("xsbench", 3200, 16384, 1):
        "016c759230d51bb9e00d8ac70b0d0b391d0d9b8f9e44c17651170ad62cecaac0",
    ("btree", 3200, 16384, 1):
        "135474ec15f6c9507d5c3e0a3687d878712d481e03c5f811c0ae117097525736",
    ("liblinear", 3200, 16384, 1):
        "a613ee88b7c8af707bdca122dc132f9ac41e9a4acab47ea045fb9e39bd250988",
    ("redis", 3200, 16384, 1):
        "22161c03163c664bd147456c1621dc9937be38b917664b9f1c9f441c47ffbcf4",
    ("silo", 3200, 16384, 1):
        "812ede6eb35de7f89d781b85d2be6855edc6f8cec6feb47292cab02db606930e",
    ("xsbench", 6000, 16384, 2):
        "4461965f33ba585e163339ec939427dc7620a212b801c8d36ac4b107883357f1",
    ("btree", 6000, 16384, 2):
        "4ab95380d20d8693d1a6c5b9481bbc39b3d5d18f377b6c4459f863de0a60fe43",
    ("liblinear", 6000, 16384, 2):
        "546d3eb86d64284653805e6e6625fa84275f9dd9fc4473c4ed9a4c733abfe393",
    ("redis", 6000, 16384, 2):
        "86cd51b33e0b3f7a5b8ac9f942f4412cdefd8c85e80c90f9b982e4dd9ce26175",
    ("silo", 6000, 16384, 2):
        "c96befdc2f80d30f1e681c88efc29f9a54871efb8291359105047760bf4eceb5",
    ("silo", 6000, 16384, 4):
        "5ab377abe245653b01e094cde45d400111bd5a182818ab7aea22b8078d202025",
    ("xsbench", 800, 1024, 3):
        "b76b3f5ac93359280c43d827aef72e541d7162dddc184b58168436c1870d14f6",
    ("silo", 800, 1024, 3):
        "da8be97606cec7e0a6db6059d606c8584124a81b3ff3b8e19425a386de9dc479",
}
# The JAX package's `benchmarks.bench_traces.run(quick=False)` rows, name
# and derived, made on the CPU with numpy 2.0.2 (PYTHONPATH=src:. python3
# -c 'import benchmarks.bench_traces as B
# print([(r.name, r.derived) for r in B.run(quick=False)])').
TRACES_REF = (
    ("fig18_19/xsbench/chain",
     "thr_vs_chain=1.00;lat_vs_chain=1.00;paper_thr=1.00;paper_lat=1.00"),
    ("fig18_19/xsbench/tree",
     "thr_vs_chain=1.08;lat_vs_chain=1.07;paper_thr=1.00;paper_lat=1.00"),
    ("fig18_19/xsbench/ring",
     "thr_vs_chain=1.85;lat_vs_chain=0.58;paper_thr=1.72;paper_lat=0.57"),
    ("fig18_19/xsbench/spine_leaf",
     "thr_vs_chain=3.67;lat_vs_chain=0.27;paper_thr=2.27;paper_lat=0.44"),
    ("fig18_19/xsbench/fully_connected",
     "thr_vs_chain=6.20;lat_vs_chain=0.13;paper_thr=3.63;paper_lat=0.28"),
    ("fig18_19/btree/chain",
     "thr_vs_chain=1.00;lat_vs_chain=1.00;paper_thr=1.00;paper_lat=1.00"),
    ("fig18_19/btree/tree",
     "thr_vs_chain=1.08;lat_vs_chain=1.07;paper_thr=1.00;paper_lat=1.00"),
    ("fig18_19/btree/ring",
     "thr_vs_chain=1.85;lat_vs_chain=0.57;paper_thr=1.72;paper_lat=0.57"),
    ("fig18_19/btree/spine_leaf",
     "thr_vs_chain=3.67;lat_vs_chain=0.27;paper_thr=2.27;paper_lat=0.44"),
    ("fig18_19/btree/fully_connected",
     "thr_vs_chain=6.30;lat_vs_chain=0.14;paper_thr=3.63;paper_lat=0.28"),
    ("fig18_19/liblinear/chain",
     "thr_vs_chain=1.00;lat_vs_chain=1.00;paper_thr=1.00;paper_lat=1.00"),
    ("fig18_19/liblinear/tree",
     "thr_vs_chain=1.08;lat_vs_chain=1.07;paper_thr=1.00;paper_lat=1.00"),
    ("fig18_19/liblinear/ring",
     "thr_vs_chain=1.86;lat_vs_chain=0.57;paper_thr=1.72;paper_lat=0.57"),
    ("fig18_19/liblinear/spine_leaf",
     "thr_vs_chain=3.71;lat_vs_chain=0.27;paper_thr=2.27;paper_lat=0.44"),
    ("fig18_19/liblinear/fully_connected",
     "thr_vs_chain=6.50;lat_vs_chain=0.13;paper_thr=3.63;paper_lat=0.28"),
    ("fig18_19/redis/chain",
     "thr_vs_chain=1.00;lat_vs_chain=1.00;paper_thr=1.00;paper_lat=1.00"),
    ("fig18_19/redis/tree",
     "thr_vs_chain=1.08;lat_vs_chain=1.09;paper_thr=1.00;paper_lat=1.00"),
    ("fig18_19/redis/ring",
     "thr_vs_chain=1.72;lat_vs_chain=0.60;paper_thr=1.72;paper_lat=0.57"),
    ("fig18_19/redis/spine_leaf",
     "thr_vs_chain=3.21;lat_vs_chain=0.30;paper_thr=2.27;paper_lat=0.44"),
    ("fig18_19/redis/fully_connected",
     "thr_vs_chain=3.99;lat_vs_chain=0.16;paper_thr=3.63;paper_lat=0.28"),
    ("fig18_19/silo/chain",
     "thr_vs_chain=1.00;lat_vs_chain=1.00;paper_thr=1.00;paper_lat=1.00"),
    ("fig18_19/silo/tree",
     "thr_vs_chain=1.08;lat_vs_chain=1.06;paper_thr=1.00;paper_lat=1.00"),
    ("fig18_19/silo/ring",
     "thr_vs_chain=1.84;lat_vs_chain=0.58;paper_thr=1.72;paper_lat=0.57"),
    ("fig18_19/silo/spine_leaf",
     "thr_vs_chain=3.66;lat_vs_chain=0.27;paper_thr=2.27;paper_lat=0.44"),
    ("fig18_19/silo/fully_connected",
     "thr_vs_chain=6.06;lat_vs_chain=0.14;paper_thr=3.63;paper_lat=0.28"),
    ("fig20a/xsbench",
     "mix_degree=0.02;fullduplex_speedup=1.63"),
    ("fig20a/btree",
     "mix_degree=0.08;fullduplex_speedup=1.70"),
    ("fig20a/liblinear",
     "mix_degree=0.18;fullduplex_speedup=1.86"),
    ("fig20a/redis",
     "mix_degree=0.30;fullduplex_speedup=2.06"),
    ("fig20a/silo",
     "mix_degree=0.44;fullduplex_speedup=2.35"),
    ("fig20a/monotone_in_mix",
     "monotone=True"),
    ("fig20b/mix_bandwidth_slope",
     "rel_slope_per_0.1_mix=+0.126;paper=+0.09;n_windows=9"),
)
# The redis half-duplex bus of Fig. 20a (n 6,000) converges in this many
# rounds past its 23-round bound (the port's CPU run; the JAX package's
# `simulate_auto` answers it with its oracle).
REDIS_BUS_ROUNDS = 110
# The JAX package's `benchmarks.bench_telemetry.run(quick=False)` rows: name,
# derived and meta, made on the CPU (PYTHONPATH=src:. python3 -c 'import
# benchmarks.bench_telemetry as B
# print([(r.name, r.derived, r.meta) for r in B.run(quick=False)])').
TELEMETRY_REF = (
    ("telemetry/schedule_sweep",
     "bers=3;rows=600;hops=10028",
     {'engine_rounds': [7, 16, 22], 'engine_converged': True}),
    ("telemetry/attribution_ber1e-05",
     "p50=3310ns;p99=5046ns;p999=5076ns;retrain_stall=1964ns",
     {'quantiles_ps': [3309568, 5046272, 5076445],
      'retrain_stall_ps': 1963855,
      'queue_wait_ps': 1781955390,
      'peak_backlog': [580, 32, 4, 2, 3, 1, 4, 5, 2, 4, 3, 2, 4, 3]}),
    ("telemetry/attribution_ber0.0001",
     "p50=36176ns;p99=70255ns;p999=70311ns;retrain_stall=239175ns",
     {'quantiles_ps': [36175872, 70254592, 70310745],
      'retrain_stall_ps': 239174695,
      'queue_wait_ps': 22927879790,
      'peak_backlog': [595, 146, 10, 5, 9, 3, 10, 10, 11, 10, 2, 3, 4, 3]}),
    ("telemetry/attribution_ber0.0003",
     "p50=169869ns;p99=348127ns;p999=352539ns;retrain_stall=1150658ns",
     {'quantiles_ps': [169869312, 348127232, 352538600],
      'retrain_stall_ps': 1150657935,
      'queue_wait_ps': 100319609935,
      'peak_backlog': [599, 64, 6, 7, 5, 2, 4, 4, 5, 4, 2, 1, 1, 2]}),
    ("telemetry/metrics_per_sweep",
     "conservation=0ps;max_util=0.747;trace_events=9575;trace_valid=True;"
     "blame_residual=0ps",
     {'max_utilization': 0.7469352538790311,
      'blame': {'queue_ps': 100319609935, 'retrain_ps': 1150657935,
                'wire_ps': 178759000, 'row_extra_ps': 0, 'join_ps': 0,
                'fixed_ps': 115200000}}),
)
# The JAX package's `benchmarks.bench_critical_path.run(quick=False)` rows
# (`_gate_config` on `_coherence_config(False)`, with `leg_blame`, and on
# `_reliability_config(False)`; the streamed blame gate on 8,000 rows in
# 512-row windows): name, derived and meta without `host_phases`, made on
# the CPU (PYTHONPATH=src:. python3 -c 'import
# benchmarks.bench_critical_path as B
# print([(r.name, r.derived, {k: v for k, v in r.meta.items()
#         if k != "host_phases"}) for r in B.run(quick=False)])').
CRITICAL_PATH_REF = (
    ("critical_path/coherence_fabric",
     "rows=1452;total_ms=0.31;top=fixed@chNone:99%;conservation=exact",
     {'n_requests': 1452, 'total_ps': 307842600,
      'by_kind': {'issue': 0, 'join': 0, 'queue': 0, 'retrain': 0,
                  'wire': 3186600, 'row': 0, 'fixed': 304656000},
      'by_channel': [362000, 371000, 214000, 442000, 971000, 577000, 0, 0, 0,
                     0, 0, 0, 249600, 304656000],
      'top': [{'channel': None, 'kind': 'fixed', 'ps': 304656000,
               'share': 0.9896},
              {'channel': 4, 'kind': 'wire', 'ps': 971000, 'share': 0.0032},
              {'channel': 5, 'kind': 'wire', 'ps': 577000, 'share': 0.0019},
              {'channel': 3, 'kind': 'wire', 'ps': 442000, 'share': 0.0014},
              {'channel': 1, 'kind': 'wire', 'ps': 371000, 'share': 0.0012}],
      'flow_events': 1185, 'busiest_channel': 4,
      'speedup_if': {
          '1x': {'saved_ps': 0, 'mean_latency_ps': 212012,
                 'baseline_mean_latency_ps': 212012},
          '2x': {'saved_ps': 485500, 'mean_latency_ps': 211678,
                 'baseline_mean_latency_ps': 212012},
          '4x': {'saved_ps': 726304, 'mean_latency_ps': 211512,
                 'baseline_mean_latency_ps': 212012}},
      'by_switch': {'0': 2937000, '3': 1797600, '1': 733000, '2': 656000,
                    '4': 0, '5': 0, '6': 0},
      'leg_blame': {'demand_req': 105271000, 'service': 24249600,
                    'demand_rsp': 44416000, 'bisnp': 72136000,
                    'birsp': 61770000, 'writeback': 0, 'protocol': 0,
                    'background': 0}}),
    ("critical_path/reliability_bus",
     "rows=500;retrain_us=10840.0;queue_us=0.0;conservation=exact",
     {'n_requests': 500, 'total_ps': 13919305145,
      'by_kind': {'issue': 0, 'join': 0, 'queue': 0, 'retrain': 10840000000,
                  'wire': 3065141145, 'row': 0, 'fixed': 14164000},
      'by_channel': [108293000, 13796832000, 0, 0, 0, 0, 8000, 2000, 0, 0, 0,
                     0, 6145, 0, 14164000],
      'top': [{'channel': 1, 'kind': 'retrain', 'ps': 10840000000,
               'share': 0.7788},
              {'channel': 1, 'kind': 'wire', 'ps': 2956832000,
               'share': 0.2124},
              {'channel': 0, 'kind': 'wire', 'ps': 108293000,
               'share': 0.0078},
              {'channel': None, 'kind': 'fixed', 'ps': 14164000,
               'share': 0.001},
              {'channel': 6, 'kind': 'wire', 'ps': 8000, 'share': 0.0}],
      'flow_events': 1538, 'busiest_channel': 1,
      'speedup_if': {
          '1x': {'saved_ps': 0, 'mean_latency_ps': 27838610,
                 'baseline_mean_latency_ps': 27838610},
          '2x': {'saved_ps': 1150716755, 'mean_latency_ps': 25537176,
                 'baseline_mean_latency_ps': 27838610},
          '4x': {'saved_ps': 1480368570, 'mean_latency_ps': 24877873,
                 'baseline_mean_latency_ps': 27838610}},
      'by_switch': {'1': 13905135000, '0': 13905125000, '4': 16145, '2': 0,
                    '3': 0, '5': 0}}),
    ("critical_path/streaming_blame_gate", "windows=16;blame=bitexact",
     {'windows': 16,
      'blame': {'queue_ps': [900500, 897500, 785000, 776000, 749988000],
                'retrain_ps': [0, 0, 0, 0, 0],
                'wire_ps': [5200000, 5224000, 5194000, 5194000, 7994500],
                'row_extra_ps': [0, 0, 0, 0, 27840000], 'join_ps': 0,
                'fixed_ps': 48000000}}),
)
# The JAX package's `benchmarks.bench_streaming.run(quick=False)` rows: name,
# derived without `req_per_s` (a host rate) and meta without `host_phases`,
# made on the CPU (PYTHONPATH=src:. python3 -c 'import
# benchmarks.bench_streaming as B
# print([(r.name, ";".join(p for p in r.derived.split(";")
#                          if not p.startswith("req_per_s=")),
#         {k: v for k, v in r.meta.items() if k != "host_phases"})
#        for r in B.run(quick=False)])').
STREAMING_REF = (
    ("streaming/windowed_trace",
     "n=1200000;window=65536;p50=108ns;p99=215ns;p999=231ns",
     {'n_requests': 1200000, 'window_rows': 65536, 'windows': 19,
      'carried_peak': 0, 'oracle_windows': 0,
      'quantiles_ps': [107520, 215040, 231424],
      'max_utilization': 0.7461081371475746, 'span_ps': 7199894000,
      'rounds_sum': 209, 'rounds_max': 11, 'windows_converged': 19,
      'peak_backlog': [2, 2, 2, 2, 46],
      'blame': {'queue_ps': [138744500, 128077000, 119027000, 116795000,
                             112735190500],
                'retrain_ps': [0, 0, 0, 0, 0],
                'wire_ps': [779988000, 780018000, 779997000, 779994000,
                            1199995500],
                'row_extra_ps': [0, 0, 0, 0, 4171904000], 'join_ps': 0,
                'fixed_ps': 7200000000}}),
    ("streaming/equivalence_gate",
     "rows=2000;windows=8;bitexact=True;blame=bitexact;peak_backlog=bitexact",
     {'windows': 8, 'carried_peak': 0, 'rounds_sum': 64, 'rounds_max': 9,
      'windows_converged': 8}),
)
# The JAX package's rows of the eight studies below, each
# `benchmarks.bench_<study>.run(quick=False)`: name and derived, and for
# coherence_fabric also meta (the coupled sweeps' fixpoint iterations and
# engine rounds; no row of these studies carries a host time), made on the
# CPU with numpy 2.0.2 by
#   PYTHONPATH=src:. python3 -c 'import importlib, sys
#   B = importlib.import_module("benchmarks.bench_" + sys.argv[1])
#   print([(r.name, r.derived, r.meta) for r in B.run(quick=False)])' STUDY
# for each key.
STUDY_REF = {
    "validation": (
        ("fig7/idle_latency/local", "sim=108ns;hw=108ns;rel_err=0.002"),
        ("fig7/idle_latency/numa", "sim=191ns;hw=191ns;rel_err=0.001"),
        ("fig7/idle_latency/cxl", "sim=247ns;hw=256ns;rel_err=0.036"),
        ("fig7/peak_bw/local/rw1to0",
         "sim=112.5GBs;hw=118.0GBs;rel_err=0.046"),
        ("fig7/peak_bw/local/rw3to1",
         "sim=100.9GBs;hw=108.0GBs;rel_err=0.066"),
        ("fig7/peak_bw/local/rw2to1", "sim=98.8GBs;hw=104.0GBs;rel_err=0.050"),
        ("fig7/peak_bw/local/rw1to1", "sim=97.5GBs;hw=98.0GBs;rel_err=0.005"),
        ("fig7/peak_bw/numa/rw1to0", "sim=48.2GBs;hw=50.0GBs;rel_err=0.036"),
        ("fig7/peak_bw/numa/rw3to1", "sim=43.4GBs;hw=47.0GBs;rel_err=0.077"),
        ("fig7/peak_bw/numa/rw2to1", "sim=42.6GBs;hw=45.0GBs;rel_err=0.053"),
        ("fig7/peak_bw/numa/rw1to1", "sim=41.9GBs;hw=43.0GBs;rel_err=0.025"),
        ("fig7/peak_bw/cxl/rw1to0", "sim=25.4GBs;hw=26.0GBs;rel_err=0.024"),
        ("fig7/peak_bw/cxl/rw3to1", "sim=31.1GBs;hw=33.0GBs;rel_err=0.057"),
        ("fig7/peak_bw/cxl/rw2to1", "sim=33.6GBs;hw=36.0GBs;rel_err=0.067"),
        ("fig7/peak_bw/cxl/rw1to1", "sim=39.5GBs;hw=42.0GBs;rel_err=0.059"),
        ("fig8/loaded/cxl_read/iv60000", "bw=1.0GBs;lat=247ns"),
        ("fig8/loaded/cxl_read/iv24000", "bw=2.6GBs;lat=247ns"),
        ("fig8/loaded/cxl_read/iv12000", "bw=5.2GBs;lat=248ns"),
        ("fig8/loaded/cxl_read/iv6000", "bw=10.4GBs;lat=250ns"),
        ("fig8/loaded/cxl_read/iv4000", "bw=15.5GBs;lat=252ns"),
        ("fig8/loaded/cxl_read/iv3400", "bw=18.2GBs;lat=254ns"),
        ("fig8/loaded/cxl_read/iv3000", "bw=20.5GBs;lat=256ns"),
        ("fig8/loaded/cxl_read/iv2800", "bw=22.0GBs;lat=259ns"),
        ("fig8/loaded/cxl_read/iv2700", "bw=22.7GBs;lat=261ns"),
        ("fig8/loaded/cxl_read/iv2620", "bw=23.4GBs;lat=264ns"),
        ("fig8/loaded/cxl_read/iv2560", "bw=24.0GBs;lat=271ns"),
        ("fig8/loaded/cxl_read/iv2510", "bw=24.4GBs;lat=279ns"),
        ("fig8/loaded/error_summary",
         "avg_rel_err=0.165;max_rel_err=0.350;paper_band_avg=0.043;"
         "paper_band_max=0.12"),
        ("tab4/spec_overhead/gcc",
         "sim=0.170;hw=0.180;paper_esf=0.187;delta_vs_hw=0.010"),
        ("tab4/spec_overhead/mcf",
         "sim=0.227;hw=0.242;paper_esf=0.298;delta_vs_hw=0.015"),
    ),
    "topology": (
        ("fig10/chain/scale4", "norm_bw=0.96;target=1.00;converged=True"),
        ("fig10/chain/scale8", "norm_bw=0.92;target=1.00;converged=True"),
        ("fig10/chain/scale16", "norm_bw=0.96;target=1.00;converged=True"),
        ("fig10/chain/scale32", "norm_bw=0.98;target=1.00;converged=True"),
        ("fig10/tree/scale4", "norm_bw=1.00;target=1.00;converged=True"),
        ("fig10/tree/scale8", "norm_bw=1.00;target=1.00;converged=True"),
        ("fig10/tree/scale16", "norm_bw=1.00;target=1.00;converged=True"),
        ("fig10/tree/scale32", "norm_bw=1.00;target=1.00;converged=True"),
        ("fig10/ring/scale4", "norm_bw=1.67;target=2.00;converged=True"),
        ("fig10/ring/scale8", "norm_bw=1.91;target=2.00;converged=True"),
        ("fig10/ring/scale16", "norm_bw=1.88;target=2.00;converged=False"),
        ("fig10/ring/scale32", "norm_bw=1.92;target=2.00;converged=False"),
        ("fig10/spine_leaf/scale4", "norm_bw=1.83;target=1.00;converged=True"),
        ("fig10/spine_leaf/scale8", "norm_bw=2.00;target=2.00;converged=True"),
        ("fig10/spine_leaf/scale16",
         "norm_bw=3.98;target=4.00;converged=True"),
        ("fig10/spine_leaf/scale32",
         "norm_bw=7.95;target=8.00;converged=True"),
        ("fig10/fully_connected/scale4",
         "norm_bw=1.99;target=2.00;converged=True"),
        ("fig10/fully_connected/scale8",
         "norm_bw=3.91;target=4.00;converged=True"),
        ("fig10/fully_connected/scale16",
         "norm_bw=7.84;target=8.00;converged=True"),
        ("fig10/fully_connected/scale32",
         "norm_bw=15.77;target=16.00;converged=True"),
        ("fig11/chain/scale16",
         "h3:lat=969ns:wait=687ns;h4:lat=1478ns:wait=1101ns;"
         "h5:lat=1725ns:wait=1255ns;h6:lat=1897ns:wait=1333ns;"
         "h7:lat=1978ns:wait=1320ns;h8:lat=2115ns:wait=1363ns;"
         "h9:lat=2231ns:wait=1384ns;h10:lat=2355ns:wait=1415ns;"
         "h11:lat=2540ns:wait=1506ns;h12:lat=2635ns:wait=1507ns;"
         "h13:lat=2721ns:wait=1499ns;h14:lat=2857ns:wait=1541ns;"
         "h15:lat=2947ns:wait=1536ns;h16:lat=3043ns:wait=1538ns;"
         "h17:lat=3174ns:wait=1576ns"),
        ("fig11/tree/scale16", "h10:lat=2383ns:wait=1442ns"),
        ("fig11/ring/scale16",
         "h3:lat=283ns:wait=1ns;h4:lat=377ns:wait=1ns;h5:lat=471ns:wait=1ns;"
         "h6:lat=566ns:wait=1ns;h7:lat=660ns:wait=1ns;h8:lat=754ns:wait=1ns;"
         "h9:lat=848ns:wait=2ns;h10:lat=942ns:wait=2ns"),
        ("fig11/spine_leaf/scale16", "h4:lat=378ns:wait=1ns"),
        ("fig11/fully_connected/scale16", "h3:lat=283ns:wait=0ns"),
        ("fig12/chain/iso_bisection",
         "mean_lat=922ns;minhop=277ns;maxhop=1565ns;congestion_ratio=5.66"),
        ("fig12/tree/iso_bisection",
         "mean_lat=921ns;minhop=921ns;maxhop=921ns;congestion_ratio=1.00"),
        ("fig12/ring/iso_bisection",
         "mean_lat=678ns;minhop=277ns;maxhop=921ns;congestion_ratio=3.33"),
        ("fig12/spine_leaf/iso_bisection",
         "mean_lat=369ns;minhop=369ns;maxhop=369ns;congestion_ratio=1.00"),
        ("fig12/fully_connected/iso_bisection",
         "mean_lat=283ns;minhop=283ns;maxhop=283ns;congestion_ratio=1.00"),
    ),
    "routing": (
        ("fig13/oblivious",
         "host_norm_bw=0.319;vs_oblivious=1.00;host_lat=964ns"),
        ("fig13/ecmp", "host_norm_bw=0.527;vs_oblivious=1.65;host_lat=408ns"),
        ("fig13/adaptive",
         "host_norm_bw=0.532;vs_oblivious=1.67;host_lat=403ns"),
    ),
    "full_duplex": (
        ("fig16_17/full/h0/rw1to0",
         "bw_MBps=61164;vs_read_only=1.00;bus_utility=0.48;efficiency=0.50"),
        ("fig16_17/full/h0/rw3to1",
         "bw_MBps=79715;vs_read_only=1.30;bus_utility=0.62;efficiency=1.00"),
        ("fig16_17/full/h0/rw2to1",
         "bw_MBps=89185;vs_read_only=1.46;bus_utility=0.70;efficiency=1.00"),
        ("fig16_17/full/h0/rw1to1",
         "bw_MBps=116447;vs_read_only=1.90;bus_utility=0.91;efficiency=1.00"),
        ("fig16_17/full/h16/rw1to0",
         "bw_MBps=61157;vs_read_only=1.00;bus_utility=0.60;efficiency=0.50"),
        ("fig16_17/full/h16/rw3to1",
         "bw_MBps=74086;vs_read_only=1.21;bus_utility=0.72;efficiency=0.74"),
        ("fig16_17/full/h16/rw2to1",
         "bw_MBps=80008;vs_read_only=1.31;bus_utility=0.78;efficiency=0.78"),
        ("fig16_17/full/h16/rw1to1",
         "bw_MBps=94354;vs_read_only=1.54;bus_utility=0.92;efficiency=0.80"),
        ("fig16_17/full/h32/rw1to0",
         "bw_MBps=61150;vs_read_only=1.00;bus_utility=0.72;efficiency=0.50"),
        ("fig16_17/full/h32/rw3to1",
         "bw_MBps=69200;vs_read_only=1.13;bus_utility=0.81;efficiency=0.63"),
        ("fig16_17/full/h32/rw2to1",
         "bw_MBps=72543;vs_read_only=1.19;bus_utility=0.85;efficiency=0.65"),
        ("fig16_17/full/h32/rw1to1",
         "bw_MBps=79877;vs_read_only=1.31;bus_utility=0.94;efficiency=0.67"),
        ("fig16_17/full/h64/rw1to0",
         "bw_MBps=61135;vs_read_only=1.00;bus_utility=0.96;efficiency=0.50"),
        ("fig16_17/full/h64/rw3to1",
         "bw_MBps=61135;vs_read_only=1.00;bus_utility=0.96;efficiency=0.50"),
        ("fig16_17/full/h64/rw2to1",
         "bw_MBps=61135;vs_read_only=1.00;bus_utility=0.96;efficiency=0.50"),
        ("fig16_17/full/h64/rw1to1",
         "bw_MBps=61135;vs_read_only=1.00;bus_utility=0.96;efficiency=0.50"),
        ("fig16_17/half/h0/rw1to0",
         "bw_MBps=61164;vs_read_only=1.00;bus_utility=0.96;efficiency=1.00"),
        ("fig16_17/half/h0/rw3to1",
         "bw_MBps=41839;vs_read_only=0.68;bus_utility=0.65;efficiency=1.00"),
        ("fig16_17/half/h0/rw2to1",
         "bw_MBps=40170;vs_read_only=0.66;bus_utility=0.63;efficiency=1.00"),
        ("fig16_17/half/h0/rw1to1",
         "bw_MBps=36341;vs_read_only=0.59;bus_utility=0.57;efficiency=1.00"),
        ("fig16_17/half/h16/rw1to0",
         "bw_MBps=31651;vs_read_only=1.00;bus_utility=0.62;efficiency=0.80"),
        ("fig16_17/half/h16/rw3to1",
         "bw_MBps=31746;vs_read_only=1.00;bus_utility=0.62;efficiency=0.80"),
        ("fig16_17/half/h16/rw2to1",
         "bw_MBps=32064;vs_read_only=1.01;bus_utility=0.63;efficiency=0.80"),
        ("fig16_17/half/h16/rw1to1",
         "bw_MBps=32225;vs_read_only=1.02;bus_utility=0.63;efficiency=0.80"),
        ("fig16_17/half/h32/rw1to0",
         "bw_MBps=30977;vs_read_only=1.00;bus_utility=0.73;efficiency=0.67"),
        ("fig16_17/half/h32/rw3to1",
         "bw_MBps=30813;vs_read_only=0.99;bus_utility=0.72;efficiency=0.67"),
        ("fig16_17/half/h32/rw2to1",
         "bw_MBps=31098;vs_read_only=1.00;bus_utility=0.73;efficiency=0.67"),
        ("fig16_17/half/h32/rw1to1",
         "bw_MBps=31280;vs_read_only=1.01;bus_utility=0.73;efficiency=0.67"),
        ("fig16_17/half/h64/rw1to0",
         "bw_MBps=25457;vs_read_only=1.00;bus_utility=0.80;efficiency=0.50"),
        ("fig16_17/half/h64/rw3to1",
         "bw_MBps=25457;vs_read_only=1.00;bus_utility=0.80;efficiency=0.50"),
        ("fig16_17/half/h64/rw2to1",
         "bw_MBps=25457;vs_read_only=1.00;bus_utility=0.80;efficiency=0.50"),
        ("fig16_17/half/h64/rw1to1",
         "bw_MBps=25457;vs_read_only=1.00;bus_utility=0.80;efficiency=0.50"),
    ),
    "link_layer": (
        ("link_layer/gen/pcie5_bytes",
         "goodput_MBps=114568;vs_pcie5=1.00;latency_ns=10377"),
        ("link_layer/gen/pcie5_flit68",
         "goodput_MBps=106235;vs_pcie5=0.93;latency_ns=11194"),
        ("link_layer/gen/pcie6_flit256",
         "goodput_MBps=183225;vs_pcie5=1.60;latency_ns=6465"),
        ("link_layer/flit256_efficiency",
         "measured=0.9219;analytic=0.9219;rel_err=0.0000;pass=True"),
        ("link_layer/ber_sweep",
         "ber0=180149;ber1e-08=180113;ber1e-07=179588;ber3e-07=178461;"
         "ber1e-06=174583;ber3e-06=164367;ber1e-05=136202;monotone=True"),
    ),
    "link_reliability": (
        ("link_reliability/zero_ber_equivalence",
         "stochastic_matches_deterministic=True"),
        ("link_reliability/tail/ber0",
         "exp_p50=3988;exp_p99=7646;sto_p50=3988;sto_p99=7646"),
        ("link_reliability/tail/ber1e-06",
         "exp_p50=4115;exp_p99=7894;sto_p50=5147;sto_p99=8846"),
        ("link_reliability/tail/ber1e-05",
         "exp_p50=5268;exp_p99=10160;sto_p50=8316;sto_p99=13964"),
        ("link_reliability/tail/ber3e-05",
         "exp_p50=7907;exp_p99=15347;sto_p50=12577;sto_p99=28210"),
        ("link_reliability/tail/ber0.0001",
         "exp_p50=18044;exp_p99=35269;sto_p50=79386;sto_p99=140498"),
        ("link_reliability/tail_divergence",
         "p99_minus_p50_ber0=3658;p99_minus_p50_top=61112;"
         "expected_top=17226;diverges=True"),
        ("link_reliability/retrain_stall",
         "events=460;down_ns=494000;makespan_off=19860;makespan_on=87914;"
         "stalls=True"),
    ),
    "coherence_fabric": (
        ("coherence_fabric/load0",
         "iso_lat=215ns;cpl_lat=298ns;bisnp_meas=157ns;bisnp_model=64ns",
         {'fixpoint_iters': 6, 'fixpoint_converged': False,
          'engine_rounds': [15, 16, 16, 16, 16, 15],
          'engine_converged': True}),
        ("coherence_fabric/load0.3",
         "iso_lat=215ns;cpl_lat=304ns;bisnp_meas=159ns;bisnp_model=64ns",
         {'fixpoint_iters': 6, 'fixpoint_converged': False,
          'engine_rounds': [17, 16, 15, 16, 16, 17],
          'engine_converged': True}),
        ("coherence_fabric/load0.6",
         "iso_lat=215ns;cpl_lat=312ns;bisnp_meas=162ns;bisnp_model=64ns",
         {'fixpoint_iters': 6, 'fixpoint_converged': False,
          'engine_rounds': [17, 21, 17, 17, 16, 21],
          'engine_converged': True}),
        ("coherence_fabric/load0.9",
         "iso_lat=215ns;cpl_lat=322ns;bisnp_meas=167ns;bisnp_model=64ns",
         {'fixpoint_iters': 6, 'fixpoint_converged': False,
          'engine_rounds': [17, 17, 17, 21, 18, 15],
          'engine_converged': True}),
        ("coherence_fabric/policies_at_load",
         "fifo=322;lru=320;lfi=306;lifo=323;mru=328;blp=295",
         None),
        ("coherence_fabric/divergence_gate",
         "div_ns=84,89,97,107;grows=True;nonzero=True;gate=True",
         None),
        ("coherence_fabric/fanout_owners1",
         "chain=344ns;conc=344ns;div=0ns;snooped=1.00",
         {'engine_rounds': {'chain': 1, 'concurrent': 10},
          'engine_converged': True}),
        ("coherence_fabric/fanout_owners2",
         "chain=501ns;conc=344ns;div=157ns;snooped=2.00",
         {'engine_rounds': {'chain': 5, 'concurrent': 11},
          'engine_converged': True}),
        ("coherence_fabric/fanout_owners3",
         "chain=658ns;conc=344ns;div=313ns;snooped=3.00",
         {'engine_rounds': {'chain': 5, 'concurrent': 11},
          'engine_converged': True}),
        ("coherence_fabric/fanout_owners4",
         "chain=815ns;conc=345ns;div=470ns;snooped=4.00",
         {'engine_rounds': {'chain': 5, 'concurrent': 11},
          'engine_converged': True}),
        ("coherence_fabric/fanout_gate",
         "div_ns=0,157,313,470;grows=True;nonzero=True;gate=True",
         None),
        ("coherence_fabric/trace_xsbench",
         "iso_lat=207ns;cpl_lat=353ns;lifo_cpl=352ns",
         {'fixpoint_iters': 6, 'fixpoint_converged': False,
          'engine_rounds': [28, 20], 'engine_converged': True}),
        ("coherence_fabric/trace_silo",
         "iso_lat=217ns;cpl_lat=333ns;lifo_cpl=330ns",
         {'fixpoint_iters': 6, 'fixpoint_converged': False,
          'engine_rounds': [16, 17], 'engine_converged': True}),
    ),
    "coherence_modes": (
        ("coherence/scale2",
         "hdm_db_bw=123870;hdm_h_bw=39489;dmc_speedup=3.14;hdm_db_lat=385ns;"
         "hdm_h_lat=936ns"),
        ("coherence/scale4",
         "hdm_db_bw=128000;hdm_h_bw=48842;dmc_speedup=2.62;hdm_db_lat=562ns;"
         "hdm_h_lat=1330ns"),
        ("coherence/scale8",
         "hdm_db_bw=249587;hdm_h_bw=55346;dmc_speedup=4.51;hdm_db_lat=580ns;"
         "hdm_h_lat=2248ns"),
    ),
}
# The JAX package's `benchmarks.bench_fabric.run(quick=False)` rows, name
# and derived: collectives on the simulated 16 x 16 TPU v5e torus and the
# 2-pod DCN ring (PYTHONPATH=src:. python3 -c 'import
# benchmarks.bench_fabric as B
# print([(r.name, r.derived) for r in B.run(quick=False)])').
FABRIC_REF = (
    ("fabric/all_reduce/16MB", "sim_ms=0.315;alpha_beta_ms=0.315;ratio=1.000"),
    ("fabric/all_reduce/64MB", "sim_ms=1.258;alpha_beta_ms=1.258;ratio=1.000"),
    ("fabric/all_reduce/256MB",
     "sim_ms=5.033;alpha_beta_ms=5.033;ratio=1.000"),
    ("fabric/all_to_all/64MB",
     "sim_ms=3.020;contention_free_ms=0.629;contention_factor=4.80"),
    ("fabric/pod_all_reduce/64MB",
     "sim_ms=31.472;detail=DCN ring across pods"),
)
# What `examples/fabric_autotune.py`, `examples/coherence_fabric_demo.py`
# and `examples/link_reliability_demo.py` print (the JAX package on the CPU:
# PYTHONPATH=src python3 examples/NAME.py).
FABRIC_AUTOTUNE_REF = """\
== layout ranking: grok-1-314b train_4k (ESF-engine collective term) ==
  fsdp+tp+sp   step= 21.992 s bound=collective hbm=16.08 GiB  coll=11543.8 ms
  ddp          step= 22.286 s bound=collective hbm=601.78 GiB  coll=11838.0 ms
  tp-only      step= 22.398 s bound=collective hbm=50.53 GiB  coll=11949.7 ms
  fsdp+tp      step= 22.765 s bound=collective hbm=16.08 GiB  coll=12316.9 ms

== MoE all-to-all: contention the alpha-beta model misses ==
  ESF engine 6.04 ms vs contention-free 1.26 ms -> factor 4.80x

== straggler what-if: one chip's links at 0.25x bandwidth ==
  healthy step 0.947s, degraded 1.089s (slowdown 1.149x)
  200 steps left -> rebalance
  20000 steps left -> checkpoint_evict
"""
COHERENCE_DEMO_REF = """\
== isolated vs fabric-coupled mean miss latency (fifo DCOH) ==
   bg load  isolated   coupled  BISnp rtt  fixpoint
       0.0      209ns      298ns       157ns  5 iters
       0.3      209ns      302ns       160ns  10 iters (cap)
       0.6      209ns      310ns       161ns  10 iters (cap)
       0.9      209ns      316ns       164ns  10 iters (cap)
  (the isolated column cannot move: its miss path and BISnp RTT are
   constants; the coupled column feels the device link's queueing)

== trace-driven coherence (§V-E workloads, load 0.6) ==
  xsbench    isolated   209ns  coupled   358ns
  redis      isolated   224ns  coupled   332ns
  silo       isolated   216ns  coupled   341ns
"""
LINK_RELIABILITY_DEMO_REF = """\
== p50 / p99 request latency (ns): expected vs stochastic ==
       BER   exp p50   exp p99   sto p50   sto p99  sto p99/p50
     0e+00      3205      6127      3205      6127         1.91
     1e-06      3305      6325      3285      6431         1.96
     1e-05      4220      8129      4293      8559         1.99
     3e-05      6315     12271      6808     13360         1.96
     1e-04     14359     28150     15320     29803         1.95
  (expected mode scales every packet alike; the stochastic p99 pulls away
   from its p50 as replay bursts land on unlucky packets)

== retraining stalls (BER 1e-4, threshold 2, 1 us per event) ==
  sampled retraining events : 714
  makespan without retraining:    30323 ns
  makespan with retraining   :   144144 ns
  p99 without / with         : 29803 / 141838 ns
  (same seeded fault history; only the link-down intervals differ)
"""
# What `python -m repro.analysis.verify_smoke` prints (the JAX package on
# the CPU).
VERIFY_SMOKE_REF = """\
verify_smoke: static verification of every lowering path
  demand/tree                  ok  (200 rows x 48 channels)
  demand/single_bus            ok  (200 rows x 11 channels)
  reliability/stochastic       ok  (600 rows x 14 channels)
  coherence/chain              ok  (300 rows x 7 channels)
  coherence/concurrent         ok  (465 rows x 7 channels)
  streaming/windows            ok  (4 windows)
verify_smoke: clean
"""
# What `examples/fabric_trace_viewer.py` prints at full size (n 600), and
# the sha256 of the trace file it writes, made on the CPU in an empty
# directory (PYTHONPATH=src python3 examples/fabric_trace_viewer.py
# --out trace.json; sha256sum trace.json).
VIEWER_REF = """\
== where the latency went (all scheduled rows) ==
  join/fork wait             62.3 us  ( 12.7%)
  FCFS queueing              16.6 us  (  3.4%)
  retrain stall               0.0 us  (  0.0%)
  wire serialization         55.1 us  ( 11.2%)
  row-buffer extras           0.0 us  (  0.0%)
  fixed latency             356.7 us  ( 72.7%)
  latency p50/p99/p99.9: 223 / 373 / 412 ns
  hottest channel: sw0 -> mem3 at 21.2% (peak backlog 6)
  coupled fixpoint: 10 iters (cap), residuals [66357, 95045, 94361, 112175, \
81564, 62977, 59230, 61666, 67566] ps

wrote trace.json: 19268 events on 13 channel tracks - load it at \
https://ui.perfetto.dev
"""
VIEWER_TRACE_SHA256 = (
    "5c17659fd12b6e72ed667174578f567a8b6f588362b8dbc4112d79212d4e33cd")
# The JAX package's `telemetry.sf_telemetry` of Fig. 14's five scans, per
# policy: (fanout_hist, bisnp_legs, invblk_lines, wb_lines, hit_rate), made
# on the CPU with
#   PYTHONPATH=src python3 -c 'import repro.core
#   from repro.core.snoop_filter import *
#   from repro.core.telemetry import sf_telemetry
#   a = make_skewed_stream(32000, 4096, write_ratio=0.1, seed=3)
#   _, ev = simulate_sf(*a, SFConfig(capacity=819, policy="fifo"),
#                       CacheConfig(capacity=819), return_events=True)
#   print(sf_telemetry(ev, n_requesters=1))'
# for each policy.
FIG14_SF_REF = {
    "fifo": ([27414, 4586], 4586, 4586, 459, 0.83109375),
    "lru": ([27414, 4586], 4586, 4586, 459, 0.83109375),
    "lfi": ([28800, 3200], 3200, 3200, 309, 0.87440625),
    "lifo": ([29515, 2485], 2485, 2485, 217, 0.89675),
    "mru": ([29515, 2485], 2485, 2485, 217, 0.89675),
}
# requests per stream of the kernel-against-plain families (the plain step
# loop runs a few dozen small launches and a few host reads a request)
SF_CASE_N = 2_000
# requests of the `simulate_coupled` runs held against the CPU
COUPLED_N = 600
# the scan's bytes per request: addr, is_write, rid in (9 B); latency, hit,
# the two per-step counts out (25 B); plus the state in and out once.  Its
# operations are not counted: the kernel keeps its maps, counts and (fifo,
# lifo, lru, mru) order list up to date as entries change, so a step's
# work depends on its case (a few lookups on a hit; the list's end, or a
# warp search of the SF for lfi and blp, on a victim step), and its pace
# is set by the chain of dependent shared-memory accesses from step to
# step, reported beside the bound as µs per step, the step mix and the µs
# a step of each kind takes
SF_BYTES_PER_STEP = 9 + 25
SPIN_CYCLES = 200_000_000  # ~0.1 s of device spin at the H100's clocks


def emit(**obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(f"chip_smoke: {what}")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_cuda(torch, fn, iters):
    """(device ms, host ms) per call.  A spin kernel queued first keeps the
    card busy while the host enqueues every call, so the events time the
    calls' device work alone, not the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    h0 = time.perf_counter()
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    host_ms = (time.perf_counter() - h0) * 1e3 / iters
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters, host_ms


def bound_ms(k, bytes_per_item, ops_per_item):
    """(least time on the card in ms, what bounds it) for k items."""
    bytes_ms = bytes_per_item * k / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_per_item * k / SCALAR_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def scan_bound_ms(k):
    return bound_ms(k, SCAN_BYTES_PER_ITEM, SCAN_OPS_PER_ITEM)


def round_bound_ms(args):
    """(least time on the card in ms, what bounds it, bytes per item) of
    the fused round on these operands: each read once, three int64 outputs
    written."""
    k = int(args[0].shape[0])
    per_item = (sum(x.element_size() for x in args)
                + ROUND_OUT_BYTES_PER_ITEM)
    return bound_ms(k, per_item, ROUND_OPS_PER_ITEM) + (per_item,)


def round_breakdown(torch, K, wl, sched, repeats=5):
    """Device time of each step of one engine round, replayed from the
    resolved schedule (a fixed point, so every repeat does the same work),
    timed with CUDA events; also holds the fused round against the plain
    round on this round's real operands.  Returns the steps, the operands
    and the largest difference."""
    from repro_torch.core.engine import _round_inputs, _scatter_round
    from repro_torch.kernels.serve_round.ref import serve_round_ref

    names = ("sort_gather", "fused_round", "scatter_propagate",
             "residual_readback")
    total = dict.fromkeys(names, 0.0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    arrive = sched.arrive
    host = 0.0
    for _ in range(repeats):
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        ev[0].record()
        order, args = _round_inputs(wl.hops, wl.channels, arrive)
        ev[1].record()
        s_start, s_depart, s_stall = K.serve_round_fused(*args)
        ev[2].record()
        new_arrive = _scatter_round(wl.hops, wl.issue_ps, order, s_start,
                                    s_depart, None)[0]
        ev[3].record()
        resid = int((new_arrive - arrive).abs().max())
        ev[4].record()
        torch.cuda.synchronize()
        host += time.perf_counter() - h0
        check(resid == 0, "replayed round moved a converged schedule")
        for i, n in enumerate(names):
            total[n] += ev[i].elapsed_time(ev[i + 1])
    err = max(int((got - want).abs().max()) for got, want in zip(
        (s_start, s_depart, s_stall), serve_round_ref(*args)))
    check(err == 0, f"fused round != plain round on the main path's round "
                    f"(K={args[0].shape[0]}, max abs err {err})")
    out = {n: total[n] / repeats for n in names}
    out["round_host_ms"] = host / repeats * 1e3
    return out, args, err


def round_timing(torch, K, ref, name, args):
    """The fused round's device time on one converged round's operands,
    against the plain round, the unfused path it replaced (the plain
    pre-pass, the map-only scan kernel and the plain finish) and its
    bound."""
    k = int(args[0].shape[0])
    ms, host_ms = time_cuda(torch, lambda: K.serve_round_fused(*args), 50)
    plain_ms, _ = time_cuda(torch, lambda: ref.serve_round_ref(*args), 5)

    def unfused():
        maps, aux = ref.serve_maps(*args)
        return ref.finish_round(K.serve_scan(*maps), args[3], args[1],
                                args[11], aux)

    unfused_ms, _ = time_cuda(torch, unfused, 5)
    bound, by, per_item = round_bound_ms(args)
    timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                  library_ms=None)
    emit(phase="kernel_timing", kernel="serve_round", workload=name, K=k,
         host_ms_per_call=host_ms, unfused_prepass_scan_finish_ms=unfused_ms,
         bytes_per_item=per_item, **timing)
    return timing


def ptxas_summary(log):
    """Registers, stack, spills and static shared memory of each kernel in
    one source's ``nvcc -Xptxas -v`` output."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = dict(kernel=m.group(1))
            out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                cur.update(stack_bytes=int(m[1]), spill_store_bytes=int(m[2]),
                           spill_load_bytes=int(m[3]))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m[1])
            m = re.search(r"(\d+) bytes smem", line)
            if m:
                cur["static_smem_bytes"] = int(m[1])
    return out


def profile_device(torch, fn, ops=()):
    """Device busy share of one call of ``fn``: kernel time summed by
    `torch.profiler` over the wall time of the same call, plus the kernels
    that took the most device time, and the calls and device time of each
    PyTorch operator named in ``ops``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:10]

    def total_dev_us(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0))

    named = {op: dict(calls=0, device_ms=0.0) for op in ops}
    for e in prof.key_averages():
        if e.key in named and e.device_type != DeviceType.CUDA:
            named[e.key]["calls"] += e.count
            named[e.key]["device_ms"] += total_dev_us(e) / 1e3
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
                top_kernels=[dict(name=e.key[:100], ms=dev_us(e) / 1e3,
                                  calls=e.count) for e in top],
                **({"operators": named} if ops else {}))


def device_profile(torch, P, wl):
    """`profile_device` of one `simulate`, with its rounds and the
    ``torch.cummax`` calls left in it (one ``aten::_cummax_helper`` per
    call; the profiler nests two ``aten::cummax`` events in each)."""
    out = {}

    def run():
        out["rounds"] = P.simulate(wl.hops, wl.channels, wl.issue_ps).rounds

    prof = profile_device(torch, run, ops=("aten::_cummax_helper",))
    return dict(prof, rounds=out["rounds"])


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_kernel_vs_plain(torch, K, ref):
    """The map-only serve scan against its plain version on well-formed
    map streams (block edges, one segment over many blocks, a long
    pass-through prefix), then its device time at the main path's sizes."""
    blk = K.block_items()
    cases = [dict(k=k) for k in (1, 2, blk - 1, blk, blk + 1, 3 * blk + 5,
                                 (1 << 20) + 7)]
    cases += [dict(k=5 * blk + 3, one_segment=True),
              dict(k=4 * blk + 9, prefix=3 * blk + 17)]
    worst = 0
    for i, case in enumerate(cases):
        k = case.pop("k")
        maps = [torch.from_numpy(m).cuda()
                for m in ref.random_maps(k, 1000 + i, **case)]
        got = K.serve_scan(*maps)
        want = ref.serve_scan_plain(*maps)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        worst = max(worst, err)
        check(torch.equal(got, want), f"serve_scan != plain at K={k} {case}")
    emit(phase="kernel_vs_plain", kernel="serve_scan", block_items=blk,
         cases=len(cases), max_abs_err=worst)

    timings = {}
    for k in (268_800, 688_128):
        maps = [torch.from_numpy(m).cuda() for m in ref.random_maps(k, k)]
        ms, host_ms = time_cuda(torch, lambda: K.serve_scan(*maps), 50)
        plain_ms, _ = time_cuda(torch, lambda: ref.serve_scan_plain(*maps), 5)
        bound, by = scan_bound_ms(k)
        timings[k] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by=by)
        emit(phase="kernel_timing", kernel="serve_scan", K=k, ms=ms,
             host_ms_per_call=host_ms, plain_ms=plain_ms, bound_ms=bound,
             bound_by=by, library_ms=None)
    return worst, timings


def phase_round_vs_plain(torch, K, ref):
    """The fused round against the plain round on random sorted streams:
    block edges, segments over many blocks, serving items far apart,
    marker-only segments, a padded tail, warm seeds, times past 2**40 ps,
    more blocks than the one-block passes have threads, K to 2**20 + 7."""
    blk = K.round_block_items()
    families = [dict(), dict(n_chan=1), dict(n_chan=2, serve=0.02,
                                              marker=0.01),
                dict(markers_only=3), dict(tail=3000),
                dict(n_chan=600, warm=True, offset=7 << 40)]
    worst, n = 0, 0
    for f, kw in enumerate(families):
        for k in (1, 2, 3, blk - 1, blk, blk + 1, 3 * blk + 5,
                  300 * blk + 7, (1 << 20) + 7):
            args = [torch.from_numpy(x).cuda() for x in ref.random_round(
                k, 4000 + k + f, **dict(kw, tail=min(kw.get("tail", 0),
                                                     k)))]
            got = K.serve_round_fused(*args)
            want = ref.serve_round_ref(*args)
            torch.cuda.synchronize()
            err = max(int((g - w).abs().max()) for g, w in zip(got, want))
            worst = max(worst, err)
            n += 1
            check(err == 0, f"serve_round != plain at K={k} {kw}")
    emit(phase="kernel_vs_plain", kernel="serve_round", block_items=blk,
         cases=n, max_abs_err=worst)
    return worst


def timed(torch, fn):
    """(result, host ms, fused serve-round launches) of one main-path
    call."""
    from repro_torch.kernels.serve_round.kernel import LAUNCHES

    before = LAUNCHES["serve_round"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, (time.perf_counter() - t0) * 1e3,
            LAUNCHES["serve_round"] - before)


def run_path(np, torch, P, name, wl):
    """One main-path run on the card: `simulate_auto` with the default
    options (timed), then, where the bound falls short and the oracle
    answered, the fixpoint itself with the reference's round count; stats,
    and the fixpoint's schedule against the oracle.  Returns the fixpoint's
    schedule, its options and the result line."""
    (auto, used_oracle), ms, launches = timed(
        torch, lambda: P.simulate_auto(wl.hops, wl.channels, wl.issue_ps))
    check(launches == auto.rounds,
          f"{name}: {launches} kernel launches for {auto.rounds} rounds")
    check(used_oracle == (name in REF_ROUNDS),
          f"{name}: oracle fallback {used_oracle} after {auto.rounds} rounds")
    row = dict(used_oracle=used_oracle, simulate_ms=ms)
    opts, sched = None, auto
    if used_oracle:
        opts = P.SimOptions(max_rounds=REF_ROUNDS[name])
        sched, fix_ms, fix_launches = timed(
            torch, lambda: P.simulate(wl.hops, wl.channels, wl.issue_ps, opts))
        check(sched.rounds == REF_ROUNDS[name],
              f"{name}: fixpoint took {sched.rounds} rounds, the reference "
              f"{REF_ROUNDS[name]}")
        check(fix_launches == sched.rounds,
              f"{name}: {fix_launches} kernel launches for {sched.rounds} "
              f"rounds")
        launches += fix_launches
        row.update(default_rounds=auto.rounds, fixpoint_ms=fix_ms)
    n, h = wl.hops.channel.shape
    check(sched.converged, f"{name}: not converged in {sched.rounds} rounds")
    check(tuple(sched.arrive.shape) == (n, h + 1), f"{name}: arrive shape")
    check(bool((sched.complete >= wl.issue_ps).all()),
          f"{name}: completion before issue")
    stats = P.request_stats(wl.hops, sched, wl.issue_ps, wl.payload_bytes,
                            wl.measured)
    t0 = time.perf_counter()
    oracle = P.simulate_ref(wl.hops, wl.channels, wl.issue_ps)
    oracle_s = time.perf_counter() - t0
    for f in ("start", "depart", "arrive", "complete"):
        for s in (sched, auto):
            check(np.array_equal(getattr(s, f).cpu().numpy(), oracle[f]),
                  f"{name}: {f} differs from the oracle")
    span = int(sched.complete.max() - wl.issue_ps.min())
    return sched, opts, dict(rows=n, H=h, K=n * h, rounds=sched.rounds,
                             round_bound=P.round_bound(wl.hops),
                             launches=launches, oracle_s=oracle_s,
                             span_ps=span, steady_bandwidth_MBps=int(
                                 stats["steady_bandwidth_MBps"]), **row)


def phase_depart_vs_plain(torch, LK, LR):
    """The segmented depart kernel against its plain version (tile edges,
    one segment over many tiles, one-item segments, a leading channel -1
    run, int32 channels, K to 2**20 + 7 on many channels and on one
    segment, the longest look-back), on more tiles than the card holds at
    once, and over back-to-back calls on one stream (each call's workspace
    zeroed anew); then its time at the main path's sizes."""
    blk = LK.block_items()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    resident = LK.blocks_per_sm() * sms
    big = (2 * resident + 3) * blk + 5
    cases = [dict(k=k) for k in (1, 2, blk - 1, blk, blk + 1, 3 * blk + 5,
                                 (1 << 20) + 7)]
    cases += [dict(k=5 * blk + 3, one_segment=True),
              dict(k=4 * blk + 9, singletons=True),
              dict(k=3 * blk + 1, lead_minus_one=blk + 17),
              dict(k=2 * blk + 11, offset=7 << 40),
              dict(k=(1 << 20) + 7, one_segment=True),
              dict(k=big), dict(k=big, one_segment=True)]
    worst = 0

    def compare(got, want, what):
        nonlocal worst
        worst = max(worst, int((got - want).abs().max()))
        check(torch.equal(got, want), f"segmented_depart != plain for {what}")

    for i, case in enumerate(cases):
        kw = dict(case)
        cols = [torch.from_numpy(x).cuda()
                for x in LR.random_stream(kw.pop("k"), 2000 + i, **kw)]
        want = LR.segmented_depart_ref(*cols)
        for chan in (cols[0], cols[0].int()):
            got = LK.segmented_depart(chan, *cols[1:])
            torch.cuda.synchronize()
            compare(got, want, f"{case} ({chan.dtype})")
    # ten calls enqueued back to back, one segment and many channels in
    # turn, so each call's workspace may reuse the last one's memory
    streams = [[torch.from_numpy(x).cuda() for x in LR.random_stream(
        300_007, 3000 + i, one_segment=i % 2 == 0)] for i in range(10)]
    wants = [LR.segmented_depart_ref(*cols) for cols in streams]
    torch.cuda.synchronize()
    gots = [LK.segmented_depart(*cols) for cols in streams]
    torch.cuda.synchronize()
    for i, (got, want) in enumerate(zip(gots, wants)):
        compare(got, want, f"back-to-back call {i}")
    emit(phase="kernel_vs_plain", kernel="segmented_depart", block_items=blk,
         resident_blocks=resident, grid_past_resident=-(-big // blk),
         cases=2 * len(cases) + len(streams), max_abs_err=worst)

    timings = {}
    for k in (268_800, 688_128):
        for label, kw in (("n_chan=600", dict(n_chan=600)),
                          ("one_segment", dict(one_segment=True))):
            cols = [torch.from_numpy(x).cuda()
                    for x in LR.random_stream(k, k, **kw)]
            chan32 = cols[0].int()
            ms, host_ms = time_cuda(torch,
                                    lambda: LK.segmented_depart(*cols), 50)
            ms32, _ = time_cuda(torch, lambda: LK.segmented_depart(
                chan32, *cols[1:]), 50)
            plain_ms, _ = time_cuda(torch,
                                    lambda: LR.segmented_depart_ref(*cols), 5)
            bound, by = bound_ms(k, DEPART_BYTES_PER_ITEM,
                                 DEPART_OPS_PER_ITEM)
            bound32, by32 = bound_ms(k, DEPART_BYTES_PER_ITEM_I32,
                                     DEPART_OPS_PER_ITEM)
            # where a call's device time goes: the kernel and the memset
            # of its workspace, over 20 calls
            prof = profile_device(torch, lambda: [
                LK.segmented_depart(*cols) for _ in range(20)])
            if label == "n_chan=600":
                timings[k] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                  bound_by=by)
            emit(phase="kernel_timing", kernel="segmented_depart", K=k,
                 stream=label, ms=ms, host_ms_per_call=host_ms,
                 plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                 ms_int32_channel=ms32, bound_ms_int32_channel=bound32,
                 bound_by_int32_channel=by32, library_ms=None,
                 profile_20_calls=prof["top_kernels"])
    return worst, timings


def phase_flit_vs_plain(np, torch, FK, FR, max_payload, max_ppm):
    """The flit-pack kernel against its plain version (block edges, every
    flit mode, ppm over its whole range, payloads up to MAX_PAYLOAD_B),
    then its time on 2**20 and 2**24 points."""
    def points(k, seed):
        rng = np.random.default_rng(seed)
        pay = rng.integers(0, max_payload + 1, k)
        pay[: k // 2] = rng.integers(0, 1 << 16, k // 2)
        pay[:4] = (0, 1, 236, max_payload)[:k]
        # byte-exact, flit68 and flit256 points
        fsize = rng.choice([0, 68, 256], k)
        fpay = np.where(fsize == 68, 64, np.where(fsize == 256, 236, 0))
        ppm = rng.integers(0, max_ppm + 1, k)
        ppm[:2] = (0, max_ppm)[:k]
        return [torch.from_numpy(x.astype(np.int32)).cuda()
                for x in (pay, fsize, fpay, ppm)]

    worst = 0.0
    sizes = (1, 2, 255, 256, 257, 256 * 132 * 32 + 1, (1 << 20) + 3)
    for i, k in enumerate(sizes):
        cols = points(k, 3000 + i)
        wire, eff = FK.flit_pack_kernel(*cols)
        w_ref, e_ref = FR.flit_pack_ref(*cols)
        torch.cuda.synchronize()
        worst = max(worst, float((wire - w_ref).abs().max()),
                    float((eff - e_ref).abs().max()))
        check(torch.equal(wire, w_ref) and torch.equal(eff, e_ref),
              f"flit_pack != plain at K={k}")
    emit(phase="kernel_vs_plain", kernel="flit_pack", cases=len(sizes),
         max_abs_err=worst)

    timings = {}
    for k in (1 << 20, 1 << 24):
        cols = points(k, k)
        ms, host_ms = time_cuda(torch, lambda: FK.flit_pack_kernel(*cols),
                                50)
        plain_ms, _ = time_cuda(torch, lambda: FR.flit_pack_ref(*cols), 5)
        bound, by = bound_ms(k, FLIT_BYTES_PER_ITEM, FLIT_OPS_PER_ITEM)
        timings[k] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by=by)
        emit(phase="kernel_timing", kernel="flit_pack", K=k, ms=ms,
             host_ms_per_call=host_ms, plain_ms=plain_ms, bound_ms=bound,
             bound_by=by, library_ms=None)
    return worst, timings


def check_study_runs(np, P, name, log):
    """Every schedule a study resolved — each member of a stacked sweep —
    held bit for bit: a converged one against the port's oracle; an
    unconverged one (a plain `simulate` that ended at its default budget,
    as the reference's does: its row says ``converged=False``) against the
    port's CPU `simulate` of the same tables with the same budget, which
    must end at that budget too.  No schedule may come from the oracle
    itself: every one is the fused serve round's, launched once per round
    (a stacked sweep once per round for all its members, which must
    converge).  Returns how many schedules took each route, and how many
    converged past their round bound (`SimOptions` ``check="extend"``)."""
    routes = dict(oracle=0, cpu_at_budget=0, past_bound=0)
    for run in log.runs:
        rounds = run.schedule.rounds
        check(not run.used_oracle,
              f"{name}/{run.label}: the host oracle answered")
        if run.stacked:
            check(run.launches == max(rounds),
                  f"{name}/{run.label}: {run.launches} serve_round launches "
                  f"for {max(rounds)} stacked rounds")
            tables = [(P.member(run.hops, i), P.member(run.channels, i),
                       P.member(run.issue_ps, i), P.member(run.schedule, i))
                      for i in range(len(rounds))]
        else:
            check(run.launches == rounds,
                  f"{name}/{run.label}: {run.launches} serve_round launches "
                  f"for {rounds} rounds")
            tables = [(run.hops, run.channels, run.issue_ps, run.schedule)]
        for i, (hops, ch, issue, sched) in enumerate(tables):
            what = f"{name}/{run.label}[{i}]"
            budget = P.round_bound(hops)
            if sched.converged:
                want = P.simulate_ref(hops, ch, issue)
                routes["oracle"] += 1
                routes["past_bound"] += sched.rounds > budget
            else:
                check(not run.stacked, f"{what} not converged")
                cpu = P.simulate(P.hops_from_arrays(hops, device="cpu"),
                                 P.channels_from_arrays(ch, device="cpu"),
                                 P.issue_from_array(issue, device="cpu"),
                                 P.SimOptions(max_rounds=budget))
                check(sched.rounds == cpu.rounds == budget
                      and not cpu.converged
                      and sched.residual_ps == cpu.residual_ps,
                      f"{what}: unconverged after {sched.rounds} rounds "
                      f"(residual {sched.residual_ps}), the CPU run after "
                      f"{cpu.rounds} (residual {cpu.residual_ps}, converged "
                      f"{cpu.converged}), budget {budget}")
                want = {f: getattr(cpu, f).numpy()
                        for f in ("start", "depart", "arrive", "complete")}
                routes["cpu_at_budget"] += 1
            for f in ("start", "depart", "arrive", "complete"):
                check(np.array_equal(getattr(sched, f).cpu().numpy(),
                                     want[f]),
                      f"{what}: {f} differs from the "
                      f"{'oracle' if sched.converged else 'CPU run'}")
    return routes


def run_study(np, torch, P, K, module, name):
    """One study at the reference's full size on the card: rows, host time
    by phase, every schedule checked (`check_study_runs`)."""
    from repro_torch.studies.common import StudyLog

    log = StudyLog(sync=torch.cuda.synchronize,
                   launches=lambda: K.LAUNCHES["serve_round"])
    t0 = time.perf_counter()
    rows = module.run(quick=False, device="cuda", log=log)
    total_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    routes = check_study_runs(np, P, name, log)
    for row in rows:
        emit(phase="study_row", study=name, name=row.name,
             us_per_call=row.us_per_call, derived=row.derived)
    emit(phase="study", study=name, host_s=total_s,
         lower_s=log.seconds.get("lower", 0.0),
         verify_s=log.seconds.get("verify", 0.0),
         simulate_s=log.seconds.get("simulate", 0.0),
         route_s=log.seconds.get("route", 0.0),
         sf_scan_s=log.seconds.get("sf_scan", 0.0),
         sf_scans=len(log.scans),
         schedules=len(log.runs),
         launches=sum(r.launches for r in log.runs),
         rounds={r.label: r.schedule.rounds for r in log.runs},
         members_checked=routes["oracle"] + routes["cpu_at_budget"],
         checked_by=routes, check_s=time.perf_counter() - t0)
    return rows, log


def trace_sha256(trace):
    """sha256 of a trace's addresses (int64, little-endian) then its
    is_write flags (one byte each), as `TRACE_SHA256` records them."""
    import numpy as np

    return hashlib.sha256(
        np.ascontiguousarray(trace["addr"], "<i8").tobytes()
        + np.ascontiguousarray(trace["is_write"], np.uint8).tobytes()
    ).hexdigest()


def phase_traces_pinned(TR):
    """Every trace the studies replay against the JAX package's, by
    sha256 (`TRACE_SHA256`); a mismatch names the trace."""
    for (name, n, foot, seed), want in TRACE_SHA256.items():
        got = trace_sha256(TR.generate(name, n=n, footprint_lines=foot,
                                       seed=seed))
        check(got == want,
              f"trace {name} (n {n}, footprint {foot}, seed {seed}): "
              f"sha256 {got}, the JAX package's {want}")
    emit(phase="traces_pinned", traces=[list(k) for k in TRACE_SHA256],
         equal=True)


def rows_against_reference(study, rows, want, with_meta=False):
    """A study's rows against the JAX package's, name and derived (and
    meta) letter for letter."""
    got = [(r.name, r.derived) + ((r.meta,) if with_meta else ())
           for r in rows]
    check(len(got) == len(want),
          f"{study}: {len(got)} rows, the reference {len(want)}")
    for g, w in zip(got, want):
        check(g == tuple(w), f"{study}: {g} against the reference's {w}")
    emit(phase="rows_against_reference", study=study, rows=len(got),
         with_meta=with_meta, equal=True)


# ---------------------------------------------------------------------------
# telemetry: fabric_metrics on the main path's schedules, the SF counters
# ---------------------------------------------------------------------------

TELEMETRY_PATHS = ("chain", "long_span", "markers")


def metrics_diff(torch, got, want, what):
    """Every field of two `fabric_metrics` results held: integers equal,
    float64 equal bit for bit (compared as int64 words)."""
    def same(g, w, name):
        g = g.cpu()
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{name}: {g.dtype}{tuple(g.shape)} against "
              f"{w.dtype}{tuple(w.shape)}")
        if w.dtype == torch.float64:
            g, w = g.view(torch.int64), w.view(torch.int64)
        check(torch.equal(g, w), f"{name} differs from the CPU's")

    fields = 0
    for key, val in want.items():
        if isinstance(val, torch.Tensor):
            same(got[key], val, f"{what}.{key}")
            fields += 1
        elif isinstance(val, tuple):
            for f in val._fields:
                same(getattr(got[key], f), getattr(val, f),
                     f"{what}.{key}.{f}")
                fields += 1
        else:
            check(got[key] == val, f"{what}.{key}: {got[key]} against {val}")
    return fields


def telemetry_on_path(torch, P, TM, K, runs):
    """`fabric_metrics(check=True)` once on each converged main-path
    schedule of `TELEMETRY_PATHS` on the card, its serve-round launches
    counted (the retraining replay, one for the attribution and the blame
    together, where the tables carry retraining), held field for field
    against the same call on the CPU."""
    out = {}
    for name, wl, sched in runs:
        if name not in TELEMETRY_PATHS:
            continue
        before = K.LAUNCHES["serve_round"]
        got = TM.fabric_metrics(wl.hops, wl.channels, sched, wl.issue_ps,
                                check=True)
        torch.cuda.synchronize()
        launches = K.LAUNCHES["serve_round"] - before
        want_launches = 0 if wl.hops.retrain_after_ps is None else 1
        check(launches == want_launches,
              f"telemetry/{name}: {launches} serve_round launches, "
              f"expected {want_launches}")
        cpu_sched = sched._replace(**{f: getattr(sched, f).cpu() for f in (
            "arrive", "start", "depart", "complete")})
        t0 = time.perf_counter()
        want = TM.fabric_metrics(
            P.hops_from_arrays(wl.hops, device="cpu"),
            P.channels_from_arrays(wl.channels, device="cpu"), cpu_sched,
            P.issue_from_array(wl.issue_ps, device="cpu"), check=True)
        cpu_s = time.perf_counter() - t0
        fields = metrics_diff(torch, got, want, f"telemetry/{name}")
        att, blame = got["attribution"], got["blame"]
        out[name] = dict(
            K=int(wl.hops.channel.numel()), launches=launches,
            fields_equal_cpu=fields, cpu_s=cpu_s,
            conservation_residual_ps=int(
                TM.conservation_residual(att).abs().max()),
            blame_residual_ps=int(TM.blame_conservation_residual(blame)),
            latency_quantiles_ps=got["latency_quantiles_ps"].tolist(),
            blame_ps={f: int(getattr(blame, f).sum())
                      for f in blame._fields},
            peak_backlog_max=int(got["channels"].peak_backlog.max()),
            max_utilization=float(got["channels"].utilization.max()))
    return out


def time_fabric_metrics(torch, TM, wl, sched):
    """Host ms of `fabric_metrics(check=True)` (three calls after a warm
    one, each to a synchronize), and the device busy ms and idle share of
    one call under `torch.profiler`."""
    def call():
        TM.fabric_metrics(wl.hops, wl.channels, sched, wl.issue_ps,
                          check=True)

    call()
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    return dict(host_ms=host, **profile_device(torch, call))


def sf_telemetry_against_reference(TM, log):
    """`sf_telemetry` of each Fig. 14 scan's card events against the JAX
    package's (`FIG14_SF_REF`)."""
    for policy, want in FIG14_SF_REF.items():
        t = TM.sf_telemetry(log.events[f"fig14/{policy}"], n_requesters=1)
        got = (t.fanout_hist.tolist(), int(t.bisnp_legs),
               int(t.invblk_lines), int(t.wb_lines), float(t.hit_rate))
        check(got == want, f"sf_telemetry fig14/{policy}: {got} against "
                           f"the reference's {want}")
        emit(phase="sf_telemetry", policy=policy, fanout_hist=got[0],
             bisnp_legs=got[1], invblk_lines=got[2], wb_lines=got[3],
             hit_rate=got[4], equal_reference=True)


# ---------------------------------------------------------------------------
# the observability back end: critical paths, blame, what-ifs, the trace
# ---------------------------------------------------------------------------

CRITICAL_PATHS = ("chain", "markers")
# critical paths are asked for every PATH_STRIDE-th row and the row that
# completes last (120 + 1 rows on the chain): a path walks back through
# every FCFS predecessor to its own issue time, so under the main path's
# congestion a path has thousands of edges and all 7,680 would take minutes
PATH_STRIDE = 64
BP_ARRAYS = ("issue", "arrive", "start", "depart", "complete", "valid",
             "serving", "channel", "wire", "row_extra", "fixed", "bind",
             "qpred_row", "qpred_hop", "rsrc_row", "rsrc_hop", "gate_row")


def host_s(fn):
    """(result, host s) of one host-side call."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def in_temporary_directory():
    """Run the block in an empty working directory, removed afterwards, so
    what a study or the viewer writes leaves the checkout clean."""
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            yield
        finally:
            os.chdir(cwd)


def critical_path_on_path(np, torch, P, CP, TX, runs, cpu_scheds):
    """The observability back end on the main path's `CRITICAL_PATHS`
    schedules from the card: `extract_backpointers(check=True)` (its
    replay holds the fused serve round's start, depart, arrive and join
    gates bit for bit), the critical paths of a fixed sample of rows, each
    summing to complete - issue, their blame, `speedup_if` on the sample's
    busiest channel (0 ps saved at 1x, monotone after), the Perfetto trace
    with flows and blame and its schema gate; every backpointer array
    against the extraction on the port's CPU run of the same tables, whose
    schedule must equal the card's.  Returns one result dict a workload."""
    out = {}
    for name, wl, sched in runs:
        if name not in CRITICAL_PATHS:
            continue
        bp, extract_s = host_s(lambda: CP.extract_backpointers(
            wl.hops, wl.channels, sched, wl.issue_ps, check=True))
        binds = {k: int((bp.bind == getattr(CP, f"B_{k.upper()}")).sum())
                 for k in ("arrive", "queue", "retrain")}
        rows = list(range(0, bp.n, PATH_STRIDE))
        last = int(np.argmax(bp.complete))
        if last not in rows:
            rows.append(last)
        paths, paths_s = host_s(lambda: CP.critical_paths(bp, rows=rows))
        for r, path in zip(rows, paths):
            check(CP.path_total(path) == int(bp.complete[r] - bp.issue[r]),
                  f"critical_path/{name}: row {r}'s path does not sum to "
                  f"complete - issue")
        bl, blame_s = host_s(lambda: CP.blame(bp, rows=rows, paths=paths))
        check(bl.total_ps == int((bp.complete - bp.issue)[rows].sum())
              and bl.total_ps == int(bl.table.sum()),
              f"critical_path/{name}: blame does not conserve")
        busiest = int(bl.by_channel()[:-1].argmax())
        what_ifs, saved_prev = {}, -1
        for factor in (1.0, 2.0, 4.0):
            w, took = host_s(lambda: CP.speedup_if(bp, busiest, factor))
            saved = w["saved_ps"]
            check(saved >= saved_prev and (factor != 1.0 or saved == 0),
                  f"critical_path/{name}: speedup_if({factor:g}) saved "
                  f"{saved} ps after {saved_prev}")
            saved_prev = saved
            what_ifs[f"{factor:g}x"] = dict(saved_ps=saved, host_s=took)
        trace, trace_s = host_s(lambda: TX.schedule_trace(
            wl.hops, wl.channels, sched, flows=bp, blame=bl))
        errs, validate_s = host_s(lambda: TX.validate_trace(trace))
        check(errs == [], f"critical_path/{name}: trace violations "
                          f"{errs[:3]}")
        # the port's CPU run of the same tables: schedule, then every
        # backpointer array
        cpu = cpu_scheds.get(name)
        cpu_sim_s = 0.0
        cpu_tables = (P.hops_from_arrays(wl.hops, device="cpu"),
                      P.channels_from_arrays(wl.channels, device="cpu"),
                      P.issue_from_array(wl.issue_ps, device="cpu"))
        if cpu is None:
            cpu, cpu_sim_s = host_s(lambda: P.simulate(*cpu_tables))
        for f in ("start", "depart", "arrive", "complete"):
            check(torch.equal(getattr(cpu, f), getattr(sched, f).cpu()),
                  f"critical_path/{name}: the CPU schedule differs in {f}")
        cpu_bp, cpu_extract_s = host_s(lambda: CP.extract_backpointers(
            *cpu_tables[:2], cpu, cpu_tables[2], check=True))
        check((cpu_bp.n, cpu_bp.h, cpu_bp.c) == (bp.n, bp.h, bp.c),
              f"critical_path/{name}: CPU backpointer shape")
        for f in BP_ARRAYS:
            a, b = getattr(bp, f), getattr(cpu_bp, f)
            check(a.dtype == b.dtype and np.array_equal(a, b),
                  f"critical_path/{name}: backpointers.{f} differ from the "
                  f"CPU run's")
        edges = [len(p) for p in paths]
        out[name] = dict(
            rows=bp.n, K=bp.n * bp.h, binds=binds,
            join_gated_rows=int((bp.gate_row >= 0).sum()),
            extract_s=extract_s, path_rows=len(rows), last_row=last,
            edges_per_path_mean=sum(edges) / len(edges),
            edges_per_path_max=max(edges), paths_s=paths_s,
            blame_s=blame_s, blame_by_kind=bl.by_kind(),
            busiest_channel=busiest, speedup_if=what_ifs,
            trace_events=sum(1 for e in trace["traceEvents"]
                             if e["ph"] != "M"),
            trace_flows=sum(1 for e in trace["traceEvents"]
                            if e["ph"] == "s"),
            trace_s=trace_s, validate_s=validate_s, trace_violations=0,
            cpu_simulate_s=cpu_sim_s, cpu_extract_s=cpu_extract_s,
            backpointer_arrays_equal_cpu=len(BP_ARRAYS))
    return out


def critical_path_study(np, torch, P, K, module):
    """The critical-path study at full size, in a temporary working
    directory (it writes its artifact there): rows against
    `CRITICAL_PATH_REF` without their host phases (the third, the blame
    folded through the streaming engine), the artifact's three entries
    against the rows' meta."""
    with in_temporary_directory():
        rows, log = run_study(np, torch, P, K, module, "critical_path")
        with open(module.ARTIFACT) as f:
            artifact = json.load(f)
    stripped = [type(r)(r.name, r.us_per_call, r.derived,
                        {k: v for k, v in r.meta.items()
                         if k != "host_phases"}) for r in rows]
    rows_against_reference("critical_path", stripped, CRITICAL_PATH_REF,
                           with_meta=True)
    for key, row in zip(("coherence_fabric", "reliability_bus",
                         "streaming_smoke"), stripped, strict=True):
        check(json.loads(json.dumps(row.meta)) == artifact[key],
              f"critical_path: artifact {key} differs from its row")
    return log


def trace_viewer_on_card(TV, TX):
    """The trace viewer at full size (n 600) on the card, in a temporary
    directory: its printout against the example's (`VIEWER_REF`), its
    trace file against the example's by sha256 (so the dict equals the
    example's event for event), and the trace's schema gate."""
    printed = io.StringIO()
    with in_temporary_directory():
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            trace = TV.main(["--out", "trace.json", "--device", "cuda"])
        seconds = time.perf_counter() - t0
        with open("trace.json", "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
    check(printed.getvalue() == VIEWER_REF,
          f"trace viewer printed {printed.getvalue()!r}, the example "
          f"{VIEWER_REF!r}")
    check(digest == VIEWER_TRACE_SHA256,
          f"trace viewer's trace sha256 {digest}, the example's "
          f"{VIEWER_TRACE_SHA256}")
    check(TX.validate_trace(trace) == [], "trace viewer's trace invalid")
    return dict(host_s=seconds, printout=printed.getvalue().splitlines(),
                trace_sha256=digest, trace_events=sum(
                    1 for e in trace["traceEvents"] if e["ph"] != "M"))


# ---------------------------------------------------------------------------
# the streaming windowed engine
# ---------------------------------------------------------------------------

# phase 4b's markers tables, in issue order, stream through windows of this
# many rows: under its congestion most rows are still in flight at a window
# edge, so the carried suffixes, join seeds and down-until frontier all work
CARRY_WINDOW_ROWS = 1_024
# the coherence stream of tests/test_streaming.py's star fabric at Fig. 14's
# sizes: requests, footprint lines, SF and cache lines, requests a chunk
COH_STREAM = dict(n=32_000, footprint=4_096, capacity=819, chunk=4_000)


def stream_against_monolithic(SST, what, hops, ch, issue, mono, res):
    """`studies.streaming.stream_matches_monolithic` (every settled item,
    completion and gated arrival, the blame and the peak backlog against
    the monolithic schedule, bit for bit), and the run's figures."""
    SST.stream_matches_monolithic(hops, ch, issue, mono, res, what)
    valid = hops.valid
    return dict(rows=int(valid.shape[0]), items=int(valid.sum()),
                windows=res.windows, carried_peak=res.carried_peak,
                oracle_windows=res.oracle_windows, rounds_sum=res.rounds,
                rounds_max=res.state.rounds_max,
                monolithic_rounds=mono.rounds,
                retrain_ps=int(res.summary()["blame"]["retrain_ps"].sum()),
                host_s_by_step=dict(res.state.seconds))


def streaming_on_card(np, torch, P, K, module):
    """The streaming study at full size (`run_study`: the 2,000-row gate's
    monolithic schedule against the oracle), its rows against
    `STREAMING_REF` (derived without ``req_per_s``, meta without the host
    phases), host ms a window by step, and the device's busy share over
    one headline window."""
    from repro_torch.core import streaming as S

    rows, log = run_study(np, torch, P, K, module, "streaming")
    stripped = [type(r)(r.name, r.us_per_call,
                        ";".join(p for p in r.derived.split(";")
                                 if not p.startswith("req_per_s=")),
                        {k: v for k, v in r.meta.items()
                         if k != "host_phases"}) for r in rows]
    rows_against_reference("streaming", stripped, STREAMING_REF,
                           with_meta=True)
    head = rows[0]
    windows = head.meta["windows"]
    ch = module._channels("cuda")
    window = head.meta["window_rows"]
    prof = profile_device(torch, lambda: S.simulate_stream(
        module._trace(window, window, "cuda"), ch))
    return dict(
        req_per_s=float(re.search(r"req_per_s=(\d+)", head.derived)[1]),
        host_s=head.us_per_call / 1e6, windows=windows,
        rounds_per_window=head.meta["rounds_sum"] / windows,
        host_ms_per_window={step: log.seconds[f"stream.{step}"] * 1e3
                            / windows for step in S.STEPS},
        one_window=prof)


def carry_path_congested(torch, P, K, SST, wl):
    """Phase 4b's markers tables with the rows put in issue order (one
    stable argsort applied to every field) streamed through
    `CARRY_WINDOW_ROWS`-row windows on the card, against the card's
    monolithic schedule of the same ordered tables; the retraining replay
    runs once a window."""
    from repro_torch.core import streaming as S

    order = torch.argsort(wl.issue_ps, stable=True)
    hops = P.Hops(*(None if x is None else x[order] for x in wl.hops))
    issue = wl.issue_ps[order]
    mono = P.simulate(hops, wl.channels, issue)
    check(mono.converged, "carry path: the monolithic run did not converge")
    before = K.LAUNCHES["serve_round"]
    state = S.StreamState(wl.channels)
    state.sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    res = S.simulate_stream(S.stream_windows(hops, issue, CARRY_WINDOW_ROWS),
                            wl.channels, state, collect_schedule=True)
    host_s = time.perf_counter() - t0
    replays = K.LAUNCHES["serve_round"] - before - res.rounds
    out = stream_against_monolithic(SST, "carry path", hops, wl.channels,
                                    issue, mono, res)
    check(res.carried_peak > 0, "carry path: no row carried across a window")
    check(out["retrain_ps"] > 0, "carry path: no retraining stall folded")
    check(replays == res.windows,
          f"carry path: {replays} retraining replays in {res.windows} "
          f"windows")
    return dict(out, window_rows=CARRY_WINDOW_ROWS, host_s=host_s,
                stall_replay_launches=replays,
                serve_round_launches=res.rounds + replays)


def coherence_stream_on_card(np, P, PS, SFK, SST):
    """`COH_STREAM`: the star fabric's chain lowering streamed chunk by
    chunk (`CoherenceStream`: one `sf_scan` launch a chunk, resumed from
    the carried SF state) against the monolithic scan, lowering and
    schedule of the whole stream, bit for bit."""
    from repro_torch.core import coherence_traffic as CT
    from repro_torch.core import streaming as S

    kinds = [P.SWITCH, P.REQUESTER, P.REQUESTER, P.MEMORY]
    links = [P.LinkSpec(i, 0, 64_000, 26_000) for i in (1, 2, 3)]
    graph = P.Topology(np.asarray(kinds, np.int64), links,
                       name="star").build()
    spec = CT.CoherenceFabricSpec(dev_node=3, req_nodes=(1, 2))
    n, chunk = COH_STREAM["n"], COH_STREAM["chunk"]
    cfg = PS.SFConfig(capacity=COH_STREAM["capacity"],
                      footprint_lines=COH_STREAM["footprint"], policy="lru")
    cache = PS.CacheConfig(capacity=COH_STREAM["capacity"])
    addr, wr, rid = PS.make_skewed_stream(n, COH_STREAM["footprint"],
                                          write_ratio=0.1, n_requesters=2,
                                          seed=3, device="cuda")
    before = SFK.LAUNCHES["sf_scan"]
    t0 = time.perf_counter()
    _, ev = PS.simulate_sf(addr, wr, rid, cfg, cache, n_requesters=2,
                           return_events=True)
    low = CT.lower_coherence(graph, spec, cfg, addr, wr, rid, ev,
                             fanout="chain", device="cuda")
    issue = CT.coherence_issue(low, ev.fab_issue_ps)
    cs = CT.CoherenceStream(addr, wr, rid, cfg, cache, graph, spec,
                            chunk=chunk, n_requesters=2, fanout="chain",
                            device="cuda")
    ch = cs.channels()
    mono = P.simulate(low.hops, ch, issue)
    check(mono.converged, "coherence stream: the monolithic run did not "
                          "converge")
    mono_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = S.simulate_stream(cs, ch, collect_schedule=True)
    stream_s = time.perf_counter() - t0
    scans = SFK.LAUNCHES["sf_scan"] - before
    out = stream_against_monolithic(SST, "coherence stream", low.hops, ch,
                                    issue, mono, res)
    check(cs.n_done == n, f"coherence stream: {cs.n_done} of {n} requests")
    check(scans == -(-n // chunk) + 1,
          f"coherence stream: {scans} sf_scan launches for "
          f"{-(-n // chunk)} chunks and the monolithic scan")
    return dict(out, n=n, chunk=chunk, sf_scan_launches=scans,
                monolithic_s=mono_s, stream_s=stream_s)


def verify_smoke_on_card(VS):
    """`repro_torch.analysis.verify_smoke` with every lowering built on the
    card: it must succeed and print what the JAX package's prints."""
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = VS.main(device="cuda")
    seconds = time.perf_counter() - t0
    check(rc == 0 and printed.getvalue() == VERIFY_SMOKE_REF,
          f"verify_smoke returned {rc} and printed {printed.getvalue()!r}, "
          f"the reference {VERIFY_SMOKE_REF!r}")
    return dict(host_s=seconds, printout=printed.getvalue().splitlines())


# ---------------------------------------------------------------------------
# the TPU-fabric cost model and the examples whose modules are ported
# ---------------------------------------------------------------------------

def printout(fn, *args, **kw):
    """What ``fn`` prints, its result and its host seconds."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kw)
    return out.getvalue(), result, time.perf_counter() - t0


def fabric_study_on_card(np, torch, P, K, module):
    """The fabric study at full size (collectives on the simulated 16 x 16
    v5e torus, the 2-pod DCN ring) against `FABRIC_REF`; every schedule,
    the all-to-all's and the 2-pod one among them, converged and held to
    the oracle on its own tables (`run_study`).  Returns, per collective,
    its host seconds, table size, rounds, bound and launches."""
    rows, log = run_study(np, torch, P, K, module, "fabric")
    rows_against_reference("fabric", rows, FABRIC_REF)
    check(len(log.runs) == len(rows)
          and all(r.schedule.converged for r in log.runs),
          f"fabric: {len(log.runs)} schedules for {len(rows)} collectives, "
          f"converged {[r.schedule.converged for r in log.runs]}")
    return [dict(collective=row.name, host_s=row.us_per_call / 1e6,
                 N=int(run.hops.channel.shape[0]),
                 H=int(run.hops.channel.shape[1]),
                 rounds=run.schedule.rounds,
                 round_bound=P.round_bound(run.hops),
                 converged=run.schedule.converged, launches=run.launches)
            for row, run in zip(rows, log.runs)]


def examples_on_card(P, K, SFK, modules):
    """The fabric autotune, coherence and link-reliability demos at the
    examples' sizes on the card, each printout against the example's; the
    autotune demo's collectives recorded.  Returns each demo's host
    seconds and launches."""
    fabric_autotune, coherence_demo, reliability_demo = modules
    scheds = []

    def recorded(hops, channels, issue_ps):
        scheds.append((int(hops.channel.numel()),
                       P.simulate(hops, channels, issue_ps)))
        return scheds[-1][1]

    out = {}
    for name, fn, kw, want in (
            ("fabric_autotune", fabric_autotune.main,
             dict(simulate_fn=recorded), FABRIC_AUTOTUNE_REF),
            ("coherence_fabric_demo", coherence_demo.main, {},
             COHERENCE_DEMO_REF),
            ("link_reliability_demo", reliability_demo.main, {},
             LINK_RELIABILITY_DEMO_REF)):
        before = (K.LAUNCHES["serve_round"], SFK.LAUNCHES["sf_scan"])
        got, _, host_s = printout(fn, "cuda", **kw)
        check(got == want, f"{name} printed {got!r}, the example {want!r}")
        out[name] = dict(host_s=host_s, equal=True,
                         serve_round_launches=K.LAUNCHES["serve_round"]
                         - before[0],
                         sf_scan_launches=SFK.LAUNCHES["sf_scan"]
                         - before[1])
    check(all(s.converged for _, s in scheds),
          "an autotune collective did not converge")
    out["fabric_autotune"].update(
        collectives=len(scheds), items=[k for k, _ in scheds],
        rounds=[s.rounds for _, s in scheds])
    return out


def serve_decode_on_card(torch, FA, RK, module):
    """The serve_decode example's six greedy requests on recurrentgemma-2b's
    smoke config (seeded weights) behind the 3-slot server, its prefills
    through the tensor-core flash-attention kernel (D 16) and the RG-LRU
    scan; the counts set to 0 just before and read just after.  Every
    request finishes with 8 tokens, and its tokens equal a manual prefill +
    decode loop at the server's width.  Returns the launch counts."""
    from repro_torch.models import transformer as TF

    for counter in (FA.LAUNCHES, RK.LAUNCHES):
        for name in counter:
            counter[name] = 0
    printed, (reqs, stats, model), host_s = printout(module.main, "cuda")
    launches = {name: counter[name] for counter in (FA.LAUNCHES, RK.LAUNCHES)
                for name in counter}
    kinds = [key.split("_", 1)[1] for key, _ in model.keys]
    prefills = len(stats["prefill_ms"])
    check(prefills == len(reqs) == 6
          and all(r.done and len(r.out) == 8 for r in reqs)
          and stats["generated"] + len(reqs) == 6 * 8
          and all(0 <= t < model.cfg.vocab for r in reqs for t in r.out),
          f"serve_decode: {[(r.done, len(r.out)) for r in reqs]}, {stats}")
    want = {"flash_attention_tc": kinds.count("attn_local") * prefills,
            "flash_attention": 0,
            "rglru_scan": kinds.count("rglru") * prefills}
    check(launches == want,
          f"serve_decode launched {launches}, expected {want}")
    for r in reqs:
        toks, _ = manual_greedy(torch, TF, model, r.prompt, 8, 64, rows=3)
        check(toks == r.out, f"serve_decode request {r.rid}: server tokens "
                             f"{r.out} != manual loop {toks}")
    emit(phase="serve_decode", host_s=host_s, ticks=stats["ticks"],
         tokens=stats["generated"] + len(reqs),
         prefill_ms=stats["prefill_ms"], decode_ms=stats["decode_ms"],
         equal_to_manual_loop=True, printout=printed.splitlines(),
         **{f"{name}_launches": n for name, n in launches.items()})
    return launches


# ---------------------------------------------------------------------------
# coherence: the snoop-filter scan kernel and the coherence studies
# ---------------------------------------------------------------------------

def sf_cases(np, torch, PS):
    """(label, `simulate_sf` keyword arguments) of the kernel-against-plain
    families at n `SF_CASE_N` on the card: all six policies, 1, 2 and 4
    requesters, InvBlk 1-4 on a finite bus, a state too large for shared
    memory, fabric latencies, 4 requesters with writes at a small cache
    (write conflicts on hits), and the blp run that ends at line ``F - 1``
    (the reference's duplicate scatter into ``present``)."""
    def skewed(n_req, seed):
        return dict(zip(("addr", "is_write", "req_id"), PS.make_skewed_stream(
            SF_CASE_N, 1024, write_ratio=0.3, n_requesters=n_req, seed=seed,
            device="cuda")), n_requesters=n_req)

    def cfg(policy, **kw):
        return dict(sf_cfg=PS.SFConfig(capacity=102, policy=policy,
                                       footprint_lines=1024, **kw),
                    cache_cfg=PS.CacheConfig(capacity=102))

    cases = []
    for i, (pol, n_req) in enumerate(
            [(p, 2) for p in PS.POLICIES]
            + [("fifo", 1), ("blp", 1), ("lfi", 4), ("mru", 4)]):
        cases.append((f"{pol}/R{n_req}", dict(
            **skewed(n_req, i), **cfg(pol, invblk_max=2 if pol == "blp"
                                      else 1), return_events=True)))
    seq = dict(zip(("addr", "is_write", "req_id"), PS.make_sequential_stream(
        SF_CASE_N, 1024, n_requesters=2, write_ratio=0.5, seed=5,
        device="cuda")), n_requesters=2)
    for length in (1, 2, 3, 4):
        cases.append((f"blp/invblk{length}/bus", dict(
            **seq, **cfg("blp", invblk_max=length, bus_MBps=12_000,
                         writeback_ps=30_000), return_events=True)))
    # a footprint whose state does not fit in shared memory: the kernel
    # then works on the state in device memory, its maps in a workspace
    big = 65_536
    cases.append(("fifo/R2/device_memory_state", dict(
        zip(("addr", "is_write", "req_id"), PS.make_skewed_stream(
            SF_CASE_N, big, write_ratio=0.3, n_requesters=2, seed=9,
            device="cuda")), n_requesters=2,
        sf_cfg=PS.SFConfig(capacity=102, footprint_lines=big),
        cache_cfg=PS.CacheConfig(capacity=102), return_events=True)))
    rng = np.random.default_rng(3)
    for pol in ("fifo", "lfi", "blp"):
        fab = torch.from_numpy(rng.integers(40_000, 900_000, SF_CASE_N)).cuda()
        cases.append((f"{pol}/R2/fabric", dict(
            **skewed(2, 40), **cfg(pol, invblk_max=2 if pol == "blp" else 1),
            fabric_lat_ps=fab, return_events=True)))
    # 4 requesters, half writes, over a hot set a small cache shares
    cases.append(("fifo/R4/writes/small_cache", dict(
        zip(("addr", "is_write", "req_id"), PS.make_skewed_stream(
            SF_CASE_N, 256, write_ratio=0.5, n_requesters=4, seed=11,
            device="cuda")), n_requesters=4,
        sf_cfg=PS.SFConfig(capacity=24, footprint_lines=256),
        cache_cfg=PS.CacheConfig(capacity=24), return_events=True)))
    # lines 6 and 7 fill an SF of 2; line 0 evicts the run 6..7 with
    # InvBlk 4, whose clipped offsets repeat line 7 = F - 1, which keeps its
    # presence bit (tests/test_torch_snoop_filter.py's construction)
    cases.append(("blp/invblk4/last_line", dict(
        addr=torch.tensor([6, 7, 0, 6], dtype=torch.int32, device="cuda"),
        is_write=torch.zeros(4, dtype=torch.bool, device="cuda"),
        req_id=torch.zeros(4, dtype=torch.int32, device="cuda"),
        n_requesters=1, sf_cfg=PS.SFConfig(capacity=2, policy="blp",
                                           invblk_max=4, footprint_lines=8),
        cache_cfg=PS.CacheConfig(capacity=2), return_events=True)))
    return cases


def sf_diff(torch, got, want):
    """Largest difference between two scans' outputs and final states
    (every field; the dtypes and shapes must match)."""
    (g_out, g_state), (w_out, w_state) = got, want
    pairs = [(g_out[f], w_out[f]) for f in w_out] + list(zip(g_state,
                                                             w_state))
    check(set(g_out) == set(w_out), "sf_scan: output fields differ")
    worst = 0
    for x, y in pairs:
        check(x.dtype == y.dtype and x.shape == y.shape,
              f"sf_scan: {x.dtype}{tuple(x.shape)} against "
              f"{y.dtype}{tuple(y.shape)}")
        if x.numel():
            worst = max(worst, int((x.long() - y.long()).abs().max()))
    return worst


def phase_sf_vs_plain(np, torch, PS, SFK, SFR):
    """`sf_scan` against its plain version on the card, bit for bit, on the
    `sf_cases` families; two runs chunked in four, each chunk resumed from
    the carried state and held against the plain version from the same
    state, their concatenation against the monolithic run; two runs from
    edited carried states (the order list's tie rule, and the search where
    the list cannot keep its order); and the state check refusing a
    repeated tag.  Returns the largest difference."""
    worst, plain_s, steps = 0, 0.0, 0
    cases = sf_cases(np, torch, PS)
    for label, kw in cases:
        job = PS.scan_job(**kw)
        got = SFK.sf_scan_kernel([job])[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = SFR.sf_scan_ref([job])[0]
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t0
        steps += int(job.addr.shape[0])
        err = sf_diff(torch, got, want)
        check(err == 0, f"sf_scan {label}: differs from the plain version "
                        f"by {err}")
        worst = max(worst, err)
    # chunked in four from the carried state: lfi with 2 requesters, and
    # blp InvBlk 4 with 2 requesters on the finite bus
    named = dict(cases)
    chunked = []
    for label in ("lfi/R2", "blp/invblk4/bus"):
        kw = dict(named[label], return_state=True)
        mono = PS.simulate_sf(**kw)
        state, lat = None, []
        q = SF_CASE_N // 4
        for lo in range(0, SF_CASE_N, q):
            part = dict(kw, addr=kw["addr"][lo:lo + q],
                        is_write=kw["is_write"][lo:lo + q],
                        req_id=kw["req_id"][lo:lo + q], init_state=state)
            if state is not None:
                job = PS.scan_job(**part)
                err = sf_diff(torch, SFK.sf_scan_kernel([job])[0],
                              SFR.sf_scan_ref([job])[0])
                check(err == 0, f"sf_scan {label}: the chunk at {lo}, from "
                                f"the carried state, differs by {err}")
            res, _, state = PS.simulate_sf(**part)
            lat.append(res.latency_ps)
        check(torch.equal(torch.cat(lat), mono[0].latency_ps)
              and all(torch.equal(a, b) for a, b in zip(state, mono[2])),
              f"sf_scan {label}: the chunked run differs from the monolithic "
              f"one")
        chunked.append(f"{label}/chunked4")
    # fifo, lifo, lru and mru take their victim from the order list; from
    # carried states (the first half's, edited): three entries tied at the
    # victim's stamp (mru), and a `seq` not above every stamp (fifo), where
    # the steps search instead
    for label, edit in (("mru/R2", "tied"), ("fifo/R2", "seq")):
        kw = named[label]
        half = SF_CASE_N // 2
        part = {f: kw[f][:half] for f in ("addr", "is_write", "req_id")}
        state = [x.clone() for x in SFR.sf_scan_ref(
            [PS.scan_job(**dict(kw, **part))])[0][1]]
        stamp = state[6] if label.startswith("mru") else state[5]
        valid = (state[2] >= 0).nonzero().flatten()
        if edit == "tied":
            stamp[valid[-3:]] = stamp[valid].max()
        else:
            state[11] = stamp[valid].max().clone()
        job = PS.scan_job(**dict(
            kw, init_state=PS.SFState(*state),
            **{f: kw[f][half:] for f in ("addr", "is_write", "req_id")}))
        err = sf_diff(torch, SFK.sf_scan_kernel([job])[0],
                      SFR.sf_scan_ref([job])[0])
        check(err == 0, f"sf_scan {label}: from the carried state ({edit}) "
                        f"differs by {err}")
        chunked.append(f"{label}/carried_{edit}")
    # a starting state with a line held twice (two SF entries, or two slots
    # of one cache row) is refused before the launch
    refused = []
    base = PS.scan_job(**named["fifo/R2"])
    for what, field, fix in (
            ("sf_entries", 2, lambda t: t.__setitem__(slice(0, 2), 5)),
            ("cache_row", 0, lambda t: t[1].__setitem__(slice(0, 2), 7))):
        state = [x.clone() for x in base.state]
        fix(state[field])
        before = SFK.LAUNCHES["sf_scan"]
        try:
            SFK.sf_scan_kernel([base._replace(state=tuple(state))])
        except ValueError as exc:
            refused.append(f"{what}: {exc}")
        check(len(refused) and refused[-1].startswith(what)
              and SFK.LAUNCHES["sf_scan"] == before,
              f"sf_scan launched on a state with a repeated tag ({what})")
    emit(phase="kernel_vs_plain", kernel="sf_scan", n=SF_CASE_N,
         cases=[c[0] for c in cases] + chunked, refused=refused,
         max_abs_err=worst, plain_ms_per_step=plain_s * 1e3 / steps)
    return worst


def sf_bound_ms(SFK, n, cfg):
    """(least time on the card in ms, what bounds it) for one stream: its
    bytes, the stream in and the outputs out, the state in and out once
    (the kernel's shared memory less the maps, bitmaps and order links it
    builds there, which never leave the chip)."""
    state = SFK.smem_bytes(cfg) - 4 * SFK.work_words(cfg)
    nbytes = n * SF_BYTES_PER_STEP + 2 * state
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def sf_step_mix(outs):
    """A stream's steps by case, from its event outputs: cache hits,
    misses that need no victim, victim steps (an SF miss with the SF full),
    write conflicts (hits or misses)."""
    hit, nv = outs["cache_hit"], outs["need_victim"]
    return dict(hits=int(hit.sum()), misses_without_victim=int(
        (~hit & ~nv).sum()), victim_steps=int(nv.sum()),
        conflicts=int(outs["conflict"].sum()))


def sf_timing(np, torch, PS, SFK, SFR):
    """The kernel on a full-size Fig. 14 stream (fifo, n 32,000), alone and
    with the five policies in one launch, and on the full-size Fig. 15
    stream at InvBlk 4 (held to the JAX package's integers); each stream's
    step mix, and the µs a step of each kind takes alone; the plain version
    once on the fifo stream (host clock: it is host-bound), equal to the
    kernel's."""
    cap = int(0.2 * SF_FOOT)
    stream = PS.make_skewed_stream(SF_N, SF_FOOT, hot_frac=0.1,
                                   hot_ratio=0.9, write_ratio=0.1, seed=3,
                                   device="cuda")
    policies = ("fifo", "lru", "lfi", "lifo", "mru")
    jobs = [PS.scan_job(*stream, PS.SFConfig(capacity=cap, policy=p,
                                             footprint_lines=SF_FOOT),
                        PS.CacheConfig(capacity=cap))
            for p in policies]
    job = jobs[0]
    fig15 = dict(zip(("addr", "is_write", "req_id"), PS.make_sequential_stream(
        SF_N, SF_FOOT, n_requesters=2, write_ratio=0.5, seed=5,
        device="cuda")), n_requesters=2,
        sf_cfg=PS.SFConfig(capacity=cap, policy="blp", invblk_max=4,
                           footprint_lines=SF_FOOT, bus_MBps=12_000,
                           writeback_ps=30_000),
        cache_cfg=PS.CacheConfig(capacity=cap))
    job15 = PS.scan_job(**fig15)
    ms, host_ms = time_cuda(torch, lambda: SFK.sf_scan_kernel([job]), 3)
    ms5, _ = time_cuda(torch, lambda: SFK.sf_scan_kernel(jobs), 2)
    ms15, _ = time_cuda(torch, lambda: SFK.sf_scan_kernel([job15]), 3)
    res = PS.simulate_sf(**fig15)
    got15 = (int(res.bandwidth_MBps), int(res.bisnp_events),
             int(res.invalidated_lines), int(res.total_time_ps),
             int(res.latency_ps.sum()))
    check(got15 == FIG15_REF[4], f"sf_scan: the Fig. 15 InvBlk-4 stream "
                                 f"gives {got15}, the reference "
                                 f"{FIG15_REF[4]}")
    mixes = SFK.sf_scan_kernel([j._replace(events=True) for j in jobs]
                               + [job15._replace(events=True)])
    mix = {f"fig14/{p}": sf_step_mix(outs)
           for p, (outs, _) in zip(policies, mixes)}
    mix["fig15/invblk4"] = sf_step_mix(mixes[-1][0])
    got = SFK.sf_scan_kernel([job])[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = SFR.sf_scan_ref([job])[0]
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = sf_diff(torch, got, want)
    check(err == 0, f"sf_scan: the full-size stream differs from the plain "
                    f"version by {err}")
    # each kind of step alone: 32,000 requests of one requester over
    # Fig. 14's 4,096 lines, every step after the first 1,024 (hits) or 819
    # (the others) of that kind: hits (cache and SF of 2,048), victims from
    # fifo's order list and from lfi's search (SF and cache 819), misses to
    # a full cache row (SF of 4,096, cache 819)
    ar = torch.arange(SF_N, dtype=torch.int32, device="cuda")
    one = (torch.zeros(SF_N, dtype=torch.bool, device="cuda"),
           torch.zeros(SF_N, dtype=torch.int32, device="cuda"))
    kinds = {
        "hits": (ar % 1024, 2048, 2048, "fifo"),
        "victims_fifo_list": (ar % SF_FOOT, cap, cap, "fifo"),
        "victims_lfi_search": (ar % SF_FOOT, cap, cap, "lfi"),
        "misses_full_row": (ar % SF_FOOT, SF_FOOT, cap, "fifo")}
    us_per_step = {}
    for kind, (addr, cs, cc, pol) in kinds.items():
        kind_job = PS.scan_job(addr, *one, PS.SFConfig(
            capacity=cs, policy=pol, footprint_lines=SF_FOOT),
            PS.CacheConfig(capacity=cc))
        us_per_step[kind] = time_cuda(
            torch, lambda j=kind_job: SFK.sf_scan_kernel([j]),
            2)[0] * 1e3 / SF_N
    bound, by = sf_bound_ms(SFK, SF_N, job.cfg)
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
               library_ms=None)
    emit(phase="kernel_timing", kernel="sf_scan", n=SF_N,
         five_policies_one_launch_ms=ms5, fig15_invblk4_ms=ms15,
         us_per_step_by_kind=us_per_step,
         fig15_invblk4_bound_ms=sf_bound_ms(SFK, SF_N, job15.cfg)[0],
         us_per_step=ms * 1e3 / SF_N, host_ms_per_call=host_ms,
         smem_bytes=SFK.smem_bytes(job.cfg),
         fig15_smem_bytes=SFK.smem_bytes(job15.cfg), step_mix=mix,
         max_abs_err=err, **row)
    return err, row


def sf_rows_against_reference(name, log, want):
    """Each full-size scan of the Fig. 14 / Fig. 15 study against the JAX
    package's integers."""
    check(len(log.scans) == len(want), f"{name}: {len(log.scans)} scans")
    for (label, res), key in zip(log.scans, want):
        got = (int(res.bandwidth_MBps), int(res.bisnp_events),
               int(res.invalidated_lines), int(res.total_time_ps),
               int(res.latency_ps.sum()))
        check(got == want[key], f"{label}: {got} against the reference's "
                                f"{want[key]}")
        emit(phase="sf_against_reference", study=name, scan=label,
             bandwidth_MBps=got[0], bisnp_events=got[1],
             invalidated_lines=got[2], total_time_ps=got[3],
             latency_sum_ps=got[4])


def coupled_on_card(np, torch, P, PS):
    """`simulate_coupled` (one member of `coupled_fixpoint`, its passes
    through `fabric_pass`) on the card in both fan-outs, undamped and
    damped, with background demand at 0.6 of the device link, against the
    same run on the CPU: every field equal, no pass answered by the host
    oracle.  At this load the fixpoint does not settle within its
    iterations, so each run also takes the final pass."""
    from repro_torch.core.coherence_traffic import simulate_coupled
    from repro_torch.studies import coherence_fabric as CF

    graph, spec, bg_nodes = CF.build_coherence_fabric(2)
    cfg = PS.SFConfig(capacity=102, policy="lifo", footprint_lines=1024)
    cache = PS.CacheConfig(capacity=102)
    streams = {d: PS.make_skewed_stream(COUPLED_N, 1024, write_ratio=0.2,
                                        n_requesters=2, seed=7, device=d)
               for d in ("cuda", "cpu")}
    span = int(PS.simulate_sf(*streams["cpu"], cfg, cache,
                              n_requesters=2).total_time_ps)
    bgs = {d: CF._background(graph, bg_nodes, spec.dev_node, 0.6, span, d)
           for d in streams}
    for fanout in ("chain", "concurrent"):
        for damping in (False, True):
            what = f"{fanout}/{'damped' if damping else 'undamped'}"
            kw = dict(n_requesters=2, options=P.SimOptions(damping=damping),
                      max_iters=16 if damping else 8,
                      tol_ps=2_000 if damping else 0, fanout=fanout)
            t0 = time.perf_counter()
            got = simulate_coupled(*streams["cuda"], cfg, cache, graph, spec,
                                   background=bgs["cuda"], device="cuda",
                                   **kw)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            want = simulate_coupled(*streams["cpu"], cfg, cache, graph, spec,
                                    background=bgs["cpu"], device="cpu", **kw)
            check(not got.used_oracle and not want.used_oracle,
                  f"coupled/{what}: the host oracle answered")
            check((got.iters, got.converged, got.damped, got.rounds)
                  == (want.iters, want.converged, want.damped, want.rounds)
                  and np.array_equal(got.residual_ps, want.residual_ps),
                  f"coupled/{what}: the iterations differ from the CPU's")
            for name, a, b in (
                    ("fabric_lat_ps", got.fabric_lat_ps, want.fabric_lat_ps),
                    ("latency_ps", got.sf.latency_ps, want.sf.latency_ps),
                    ("bisnp_lat_ps", got.bisnp_lat_ps, want.bisnp_lat_ps),
                    ("fabric_issue_ps", got.fabric_issue_ps,
                     want.fabric_issue_ps),
                    *((f, getattr(got.schedule, f), getattr(want.schedule, f))
                      for f in ("arrive", "start", "depart"))):
                check(torch.equal(a.cpu(), b),
                      f"coupled/{what}: {name} differs from the CPU's")
            emit(phase="coupled_on_card", case=what, n=COUPLED_N,
                 iters=got.iters, converged=got.converged, damped=got.damped,
                 rounds=got.rounds, residual_ps=got.residual_ps.tolist(),
                 card_s=card_s)


def stacked_round_vs_plain(torch, K, ref, run):
    """The fused round against the plain round on one stacked sweep's
    converged round, all members in one sort.  Returns (K, largest
    difference)."""
    from repro_torch.core.engine import _flatten_members, _round_inputs

    fh, fc, _ = _flatten_members(run.hops, run.channels, run.issue_ps)
    arrive = run.schedule.arrive
    _, args = _round_inputs(fh, fc, arrive.reshape(-1, arrive.shape[-1]))
    err = max(int((g - w).abs().max()) for g, w in zip(
        K.serve_round_fused(*args), ref.serve_round_ref(*args)))
    check(err == 0, f"fused round != plain round on the stacked sweep "
                    f"{run.label} (max abs err {err})")
    return int(args[0].shape[0]), err


def stacked_vs_loop(torch, P, run):
    """Host ms of one stacked sweep against its members run one by one
    (each call ends in a host readback), three times in turns."""
    m = len(run.schedule.rounds)
    stacked, loop = [], []
    for _ in range(3):
        for out, fn in ((stacked, lambda: P.simulate_stacked(
                run.hops, run.channels, run.issue_ps)),
                (loop, lambda: [P.simulate(P.member(run.hops, i),
                                           P.member(run.channels, i),
                                           P.member(run.issue_ps, i))
                                for i in range(m)])):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
    return dict(members=m, rounds=list(run.schedule.rounds),
                stacked_ms=stacked, one_by_one_ms=loop)


def depart_on_round(torch, P, LO, name, hops, channels, sched):
    """`depart_times` over one replayed converged round's serving items
    against the fused serve round's departures for those items."""
    from repro_torch.core.engine import _round_inputs
    from repro_torch.kernels.serve_round.ops import serve_round

    check(int(channels.turnaround_ps.abs().max()) == 0
          and int(channels.row_hit_ps.abs().max()) == 0
          and int(channels.row_miss_ps.abs().max()) == 0,
          f"{name}: channels with turnaround or DRAM row timing")
    _, args = _round_inputs(hops, channels, sched.arrive)
    serving, marker = args[1], args[2]
    check(not bool(marker.any()), f"{name}: link-down markers in the round")
    _, depart, _ = serve_round(*args)
    got = LO.depart_times(args[0][serving], args[3][serving],
                          args[6][serving])
    want = depart[serving]
    torch.cuda.synchronize()
    err = int((got - want).abs().max()) if got.numel() else 0
    check(torch.equal(got, want),
          f"{name}: depart_times != serve-round depart (max abs err {err})")
    return int(serving.sum()), err


def bf16_within_ulps(torch, got, want, n):
    """|got - want| <= n bf16 spacings at the larger magnitude of the two,
    that magnitude taken as at least 2**-6 (spacing 2**-13, about the
    float32 tolerance of 1e-4): an output near zero is a difference of terms
    of order one, whose float32 sums in another order differ by about 1e-6
    of them.  Returns (ok, largest difference in spacings)."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -6)
    spacing = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    ulps = float(((g - w).abs() / spacing).max())
    return ulps <= n, ulps


def attn_pairs(s, window, causal=True, t=None):
    """Unmasked (query, key) pairs of one head: the work the masks leave
    (what this run's inputs need).  S queries against T = ``t`` keys (S by
    default); the causal mask sees keys 0 .. i from query i, as the kernel
    aligns it."""
    t = s if t is None else t
    q = list(range(s))
    if not causal:
        return s * t if window <= 0 else sum(
            t - max(0, i - window + 1) for i in q)
    return sum(min(i + 1, t) - (max(0, i - window + 1) if window > 0 else 0)
               for i in q)


def flops_per_s(elem_bytes):
    """The card's peak rate for products of this element size: bf16 on the
    tensor cores, float32 on the CUDA cores (TF32 is not float32)."""
    return TENSOR_BF16_FLOPS_PER_S if elem_bytes == 2 else SCALAR_OPS_PER_S


def flash_bound_ms(b, s, h, kvh, d, window, elem_bytes, causal=True,
                   t=None):
    """(least time on the card in ms, what bounds it) for one flash call:
    4 * D flops per unmasked pair at the peak rate of the inputs' type,
    against q, k, v read and the output written once at the HBM rate."""
    t = s if t is None else t
    flops = FLASH_FLOPS_PER_PAIR_PER_D * d * attn_pairs(
        s, window, causal, t) * b * h
    nbytes = elem_bytes * d * b * (2 * s * h + 2 * t * kvh)
    ops_ms = flops / flops_per_s(elem_bytes) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def sdpa_yardsticks(torch, sdpa, qt, kt, vt, s, g):
    """Which SDPA backend the masked call takes (its kernels: with a dense
    mask every pair is computed), and SDPA's flash backend on the causal
    mask without the window: more pairs than the window leaves, but dead
    tiles skipped, as the kernel skips them.  Yardsticks only; a backend
    that refuses the call is reported, not failed."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def causal():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)

    masked = profile_device(torch, sdpa)
    try:
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            causal_ms, _ = time_cuda(torch, causal, 20)
        refused = None
    except RuntimeError as e:
        causal_ms, refused = None, str(e).splitlines()[0][:200]
    emit(phase="sdpa_yardsticks", masked_call_kernels=[
             k["name"] for k in masked["top_kernels"]],
         masked_call_pairs=s * s * g, flash_causal_ms=causal_ms,
         flash_causal_refused=refused,
         flash_causal_pairs=attn_pairs(s, 0) * g)


def case_key(c):
    return tuple(sorted({**c, "t": c.get("t", c["s"])}.items()))


def flash_key(q, k, *, causal, window):
    """What a flash call's result depends on besides its values: q's and
    k's shapes, the mask and the dtype."""
    return (tuple(q.shape), tuple(k.shape), bool(causal), int(window),
            str(q.dtype))


def path_flash_cases():
    """One case for each flash call the script's model paths make, derived
    from the configurations and the lengths the phases run:
    recurrentgemma-2b's prefills and forward (phase 8); qwen3-moe-30b-a3b's
    prefills and forward; whisper-base's encoder over its frames, its
    decoder's causal self attention and its cross attention at each prompt
    and at each prompt plus FAMILY_NEW (the teacher-forced forward), and
    the cross attention of a decode step (one query); phi-3-vision-4.2b's
    prefills and forward (phase 5h); the training phase's
    recurrentgemma-2b period on PERIOD_TOKENS (its 4,096-token steps are
    among the prefills), the 100m preset's batch, and the smoke llama of
    `studies.quickstart` and `studies.train_small_lm` (D 8, padded to 16
    under autograd: ``pad``) (phase 5i); the pipeline's microbatches and
    its whole-batch yardstick (phase 5j).
    serve_decode's calls are listed in `phase_flash_vs_plain`;
    `flash_shapes` holds every launch to the set checked."""
    from repro_torch.configs import get_config, get_smoke_config

    def calls(arch, b, lengths, *, causal=True, t=None, window=0,
              smoke=False):
        cfg = (get_smoke_config if smoke else get_config)(arch)
        return [dict(b=b, kvh=cfg.n_kv, g=cfg.n_heads // cfg.n_kv,
                     d=cfg.head_dim, s=s, t=t or s, window=window,
                     causal=causal) for s in lengths]

    def forced(prompts):
        return (*prompts, *(n + FAMILY_NEW for n in prompts))

    return [*calls(MODEL_ARCH, 1, (*SERVE_PROMPTS, SERVE_FORWARD_TOKENS,
                                   PERIOD_TOKENS, PIPE_TOKENS),
                   window=get_config(MODEL_ARCH).window),
            *calls(MODEL_ARCH, PIPE_MICROBATCHES, (PIPE_TOKENS,),
                   window=get_config(MODEL_ARCH).window),
            dict(b=TRAIN_100M_BATCH, kvh=4, g=3, d=64, s=TRAIN_100M_SEQ,
                 t=TRAIN_100M_SEQ, window=0, causal=True),
            *calls(MOE_ARCH, 1, (*MOE_PROMPTS, MOE_FORWARD_TOKENS)),
            *calls(WHISPER_ARCH, SERVE_SLOTS, (WHISPER_FRAMES,),
                   causal=False),
            *calls(WHISPER_ARCH, SERVE_SLOTS, forced(WHISPER_PROMPTS)),
            *calls(WHISPER_ARCH, SERVE_SLOTS, (1, *forced(WHISPER_PROMPTS)),
                   causal=False, t=WHISPER_FRAMES),
            *calls(VLM_ARCH, 1, forced(VLM_PROMPTS)),
            *[dict(c, pad=True) for b, s in SMALL_TRAIN_BATCHES
              for c in calls(SMALL_TRAIN_ARCH, b, (s,), smoke=True)]]


@contextlib.contextmanager
def flash_shapes(OPS, seen, seen_bwd):
    """While open, every flash launch the model stack makes (through
    `ops.flash_attention`, which looks the kernels' wrappers up at each
    call) adds its `flash_key` to ``seen``, and every backward launch to
    ``seen_bwd``.  The comparisons of `phase_flash_vs_plain` and
    `flash_bwd_vs_plain` call the wrappers directly and are not seen."""
    kernel, bwd = OPS.flash_attention_kernel, OPS.flash_attention_bwd_kernel

    def spy(q, k, v, *, causal, window, **kw):
        seen.add(flash_key(q, k, causal=causal, window=window))
        return kernel(q, k, v, causal=causal, window=window, **kw)

    def spy_bwd(q, k, v, o, do, lse, *, causal, window, **kw):
        seen_bwd.add(flash_key(q, k, causal=causal, window=window))
        return bwd(q, k, v, o, do, lse, causal=causal, window=window, **kw)

    OPS.flash_attention_kernel = spy
    OPS.flash_attention_bwd_kernel = spy_bwd
    try:
        yield
    finally:
        OPS.flash_attention_kernel = kernel
        OPS.flash_attention_bwd_kernel = bwd


def phase_flash_vs_plain(torch, FA, FAR):
    """The flash-attention kernels against their plain version: G in {1, 4,
    10}, D in {64, 128, 256}, S = T across the 64- and 128-row tiles and the
    2048 window, causal with and without the window, one non-causal case,
    in float32 (the CUDA-core kernel, atol 1e-4) and bf16 (the tensor-core
    kernel, 2 ulps, and its base-2 LSE within FLASH_LSE_ATOL, the call that
    writes it bit-identical to the one that does not); plus D in {24, 200},
    which bf16 takes to the CUDA-core kernel (2 ulps); plus serve_decode's
    shapes (G 4, D 16, window 32, S 4 to 11 and 64); plus phi-3-vision's at
    its 576 patches, and every call of the model paths (`path_flash_cases`:
    non-causal with S = T and with S < T, H 32 over KV 4, H 8 over KV 8, H
    32 over KV 32 at D 96; the small training drivers' D 8, whose bf16
    calls take the autograd op's route: zero columns to 16 and the true D's
    divisor); plus D 8 and 12 through that route at S < T, GQA and a
    window.  Each call is counted on the kernel it should take, and the
    worst error is reported per kernel and dtype.  Then each kernel's time
    at one 4096-token prefill of recurrentgemma's attention layer in the
    dtype it serves, and the tensor-core kernel's at a layer of each of
    phase 5h's models (`family_timing`).  Returns the worst errors, the
    timings and the `flash_key`s held, so that `flash_shapes` can show that
    the paths launched no other shape."""
    from repro_torch.kernels.flash_attention import ops as FAO

    gen = torch.Generator(device="cuda").manual_seed(31)
    cases = [dict(b=1, kvh=1, g=g, d=d, s=s, window=w, causal=True)
             for g in (1, 4, 10) for d in (64, 128, 256)
             for s in (1, 63, 64, 65, 2047, 2048, 2049, 4096)
             for w in (0, 2048)]
    cases += [dict(b=2, kvh=2, g=3, d=128, s=1000, window=0, causal=False),
              dict(b=1, kvh=1, g=10, d=256, s=2049, window=2048,
                   causal=False)]
    cases += [dict(b=1, kvh=1, g=4, d=d, s=s, window=w, causal=True)
              for d in (24, 200) for s in (65, 2049) for w in (0, 2048)]
    # the serve_decode phase's prefills (the smoke model's attention layer:
    # H 4, KV 1, D 16 inside the D-64 tile, window 32, prompts of 4 to 11
    # tokens), and a 64-token one that the window cuts
    cases += [dict(b=1, kvh=1, g=4, d=16, s=s, window=32, causal=True)
              for s in (*range(4, 12), 64)]
    # phi-3-vision's layer at its patch count (H 32, KV 32, D 96 inside
    # the D-128 tile), then every call the model paths make
    cases += [dict(b=1, kvh=32, g=1, d=96, s=576, window=0, causal=True)]
    cases += path_flash_cases()
    # the padded route at the smoke configs' other head dim and its edges
    cases += [dict(b=2, kvh=4, g=1, d=12, s=70, t=131, window=0,
                   causal=False, pad=True),
              dict(b=1, kvh=1, g=3, d=12, s=100, window=17, causal=True,
                   pad=True),
              dict(b=1, kvh=2, g=4, d=8, s=1, t=65, window=0, causal=True,
                   pad=True)]
    keys = [case_key(c) for c in cases]
    cases = [c for i, c in enumerate(cases) if case_key(c) not in keys[:i]]
    worst = {"flash_attention": 0.0, "flash_attention_tc": 0.0}
    lse_worst = 0.0
    # the shapes held, as `flash_shapes` records a launch
    checked = set()
    # (kernel, dtype) -> [cases, max abs err, max bf16 ulps]
    variants = {}
    for c in cases:
        b, s, h, kvh, d = c["b"], c["s"], c["kvh"] * c["g"], c["kvh"], c["d"]
        t = c.get("t", s)
        q32, k32, v32 = (torch.randn(shape, generator=gen, device="cuda")
                         for shape in ((b, s, h, d), (b, t, kvh, d),
                                       (b, t, kvh, d)))
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (x.to(dtype) for x in (q32, k32, v32))
            kw = dict(causal=c["causal"], window=c["window"])
            args, extra = (q, k, v), {}
            if c.get("pad") and dtype == torch.bfloat16:
                dp = FAO.padded_head_dim(d)
                args = tuple(FAO.pad_head_dim(x, dp) for x in args)
                extra = dict(sqrt_d=FA._sqrt_d(d))
            name = ("flash_attention_tc"
                    if FA.uses_tensor_cores(dtype, args[0].shape[-1])
                    else "flash_attention")
            before = dict(FA.LAUNCHES)
            got = FA.flash_attention_kernel(*args, **kw, **extra)
            check({n: FA.LAUNCHES[n] - before[n] for n in before}
                  == {n: int(n == name) for n in before},
                  f"flash_attention {dtype} D={d} did not launch {name}")
            want, lse_ref = FAR.flash_attention_ref(q, k, v, return_lse=True,
                                                    **kw)
            if name == "flash_attention_tc":
                again, lse = FA.flash_attention_kernel(
                    *args, return_lse=True, **kw, **extra)
                lse_err = float((lse - lse_ref).abs().max())
                lse_worst = max(lse_worst, lse_err)
                check(torch.equal(again, got),
                      f"{name} with the LSE pointer differs for {c}")
                check(lse_err <= FLASH_LSE_ATOL,
                      f"{name} LSE != plain for {c}: {lse_err}")
                del again, lse
            got = got[..., :d]
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            worst[name] = max(worst[name], err)
            var = variants.setdefault((name, str(dtype).split(".")[1]),
                                      [0, 0.0, None])
            var[0] += 1
            var[1] = max(var[1], err)
            if dtype == torch.float32:
                check(torch.allclose(got, want, atol=1e-4, rtol=0),
                      f"{name} != plain (float32) for {c}: {err}")
            else:
                ok, ulps = bf16_within_ulps(torch, got, want, 2)
                var[2] = max(var[2] or 0.0, ulps)
                check(ok, f"{name} != plain (bf16) for {c}: {ulps} ulps")
            checked.add(flash_key(*args[:2], **kw))
    for (name, dtype), (n, err, ulps) in sorted(variants.items()):
        emit(phase="kernel_vs_plain", kernel=name, dtype=dtype, cases=n,
             max_abs_err=err, max_ulps_bf16=ulps,
             lse_max_abs_err=(lse_worst if name == "flash_attention_tc"
                              else None))

    # one prefill of a 4096-token prompt in an attention layer of the model,
    # in each kernel's dtype
    b, s, g, kvh, d, w = 1, 4096, 10, 1, 256, 2048
    pos = torch.arange(s, device="cuda")
    mask = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - w)
    timings = {}
    for name, dtype in (("flash_attention_tc", torch.bfloat16),
                        ("flash_attention", torch.float32)):
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for shape in ((b, s, g * kvh, d), (b, s, kvh, d),
                                 (b, s, kvh, d)))
        ms, host_ms = time_cuda(torch, lambda: FA.flash_attention_kernel(
            q, k, v, causal=True, window=w), 20)
        plain_ms, _ = time_cuda(torch, lambda: FAR.flash_attention_ref(
            q, k, v, causal=True, window=w), 3)
        # the one PyTorch call computing the same function: SDPA with the
        # same causal window mask (a yardstick only; the port never calls
        # it)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)

        lib_ms, _ = time_cuda(torch, sdpa, 20)
        lib_err = float((sdpa().transpose(1, 2).float()
                         - FA.flash_attention_kernel(
                             q, k, v, causal=True, window=w).float()
                         ).abs().max())
        bound, by = flash_bound_ms(b, s, g * kvh, kvh, d, w,
                                   torch.finfo(dtype).bits // 8)
        timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                             bound_by=by, library_ms=lib_ms)
        emit(phase="kernel_timing", kernel=name, B=b, S=s, H=g, KV=kvh, D=d,
             window=w, dtype=str(dtype).split(".")[1],
             host_ms_per_call=host_ms, unmasked_pairs=attn_pairs(s, w) * g,
             library="scaled_dot_product_attention (bool window mask, "
                     "enable_gqa)", library_max_abs_diff=lib_err,
             **timings[name])
        if dtype == torch.bfloat16:
            sdpa_yardsticks(torch, sdpa, qt, kt, vt, s, g)
    timings["flash_attention_tc"]["model_family_shapes"] = family_timing(
        torch, FA, FAR, gen)
    return worst, timings, checked


def family_timing(torch, FA, FAR, gen):
    """The tensor-core kernel at one layer of each of phase 5h's models, in
    bf16: qwen3-moe's 4,096-token prefill (H 32, KV 4, D 128, causal),
    whisper's 1,500-frame encoder over a batch of four (H 8, KV 8, D 64,
    non-causal), phi-3-vision's 4,096-token prefill (H 32, KV 32, D 96,
    causal), and whisper's cross attention over the batch of four at 448
    queries and at one (a decode step) against the 1,500 frames; each
    against its plain version's time, its bound and SDPA's time for the
    same function (``is_causal`` with ``enable_gqa`` for the causal rows, no
    mask for the others; a yardstick only, never called on the path), all
    timed with CUDA events (`time_cuda`)."""
    rows = []
    for model, b, s, t, h, kvh, d, causal in (
            (MOE_ARCH, 1, 4096, 4096, 32, 4, 128, True),
            (WHISPER_ARCH, 4, WHISPER_FRAMES, WHISPER_FRAMES, 8, 8, 64,
             False),
            (VLM_ARCH, 1, 4096, 4096, 32, 32, 96, True),
            (f"{WHISPER_ARCH} cross attention", 4, 448, WHISPER_FRAMES, 8, 8,
             64, False),
            (f"{WHISPER_ARCH} cross attention step", 4, 1, WHISPER_FRAMES,
             8, 8, 64, False)):
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16) for shape in ((b, s, h, d), (b, t, kvh, d),
                                          (b, t, kvh, d)))
        ms, host_ms = time_cuda(torch, lambda: FA.flash_attention_kernel(
            q, k, v, causal=causal), 20)
        plain_ms, _ = time_cuda(torch, lambda: FAR.flash_attention_ref(
            q, k, v, causal=causal), 3)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)

        lib_ms, _ = time_cuda(torch, sdpa, 20)
        lib_err = float((sdpa().transpose(1, 2).float()
                         - FA.flash_attention_kernel(
                             q, k, v, causal=causal).float()).abs().max())
        bound, by = flash_bound_ms(b, s, h, kvh, d, 0, 2, causal, t)
        row = dict(model=model, B=b, S=s, T=t, H=h, KV=kvh, D=d,
                   causal=causal, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                   bound_by=by, library_ms=lib_ms)
        emit(phase="kernel_timing", kernel="flash_attention_tc",
             dtype="bfloat16", window=0, host_ms_per_call=host_ms,
             unmasked_pairs=attn_pairs(s, 0, causal, t) * b * h,
             library="scaled_dot_product_attention ("
                     + ("is_causal, " if causal else "no mask, ")
                     + "enable_gqa)", library_max_abs_diff=lib_err, **row)
        rows.append(row)
    return rows


def rglru_gates(torch, gen, b, s, d):
    """(a, b) as the model draws them: a = exp(8 r log sigmoid(lam)) with
    lam over [2.2, 6.9], in (0, 1) and near 1; b = sqrt(1 - a^2) * i * x."""
    lam = torch.linspace(2.2, 6.9, d, device="cuda")
    r = torch.rand(b, s, d, generator=gen, device="cuda")
    a = torch.exp(8.0 * r * torch.nn.functional.logsigmoid(lam))
    x = torch.randn(b, s, d, generator=gen, device="cuda") * torch.rand(
        b, s, d, generator=gen, device="cuda")
    return a, torch.sqrt(torch.clamp_min(1 - a * a, 1e-8)) * x


def phase_rglru_vs_plain(torch, RK, RR):
    """The RG-LRU scan kernel against its plain version (B in {1, 4}, D in
    {1, 31, 2560}, S across the chunk and tile edges to 4096, and
    serve_decode's prefills: B 1, D 64, S 4 to 11; atol 1e-5, bit-equal
    while one chunk covers S) and bit-equal to the CPU emulation of its
    chunk carries (`rglru_scan_blocked`), then its time at one 4096-token
    prefill of the model's recurrent layer."""
    gen = torch.Generator(device="cuda").manual_seed(37)
    worst = 0.0
    n = 0
    ch, tile = RK.chunk(), RK.tile()
    shapes = [(b, s, d) for b in (1, 4) for d in (1, 31, 2560)
              for s in (1, ch - 1, ch, ch + 1, tile - 1, tile, tile + 1,
                        4096)]
    shapes += [(1, s, 64) for s in range(4, 12)]
    for b, s, d in shapes:
        a, bb = rglru_gates(torch, gen, b, s, d)
        got = RK.rglru_scan_kernel(a, bb)
        want = RR.rglru_scan_ref(a, bb)
        blocked = RR.rglru_scan_blocked(a, bb, ch)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        n += 1
        check(torch.allclose(got, want, atol=1e-5, rtol=0),
              f"rglru_scan != plain at {(b, s, d)}: {err}")
        check(s > ch or torch.equal(got, want),
              f"rglru_scan != plain bit for bit at {(b, s, d)}")
        check(torch.equal(got, blocked),
              f"rglru_scan != rglru_scan_blocked at {(b, s, d)}")
    emit(phase="kernel_vs_plain", kernel="rglru_scan", chunk=ch, tile=tile,
         cases=n, max_abs_err=worst, equal_to_blocked=True)

    b, s, d = 1, 4096, 2560
    a, bb = rglru_gates(torch, gen, b, s, d)
    ms, host_ms = time_cuda(torch, lambda: RK.rglru_scan_kernel(a, bb), 50)
    plain_ms, _ = time_cuda(torch, lambda: RR.rglru_scan_ref(a, bb), 3)
    bound, by = bound_ms(b * s * d, RGLRU_BYTES_PER_ITEM, RGLRU_OPS_PER_ITEM)
    timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                  library_ms=None)
    emit(phase="kernel_timing", kernel="rglru_scan", B=b, S=s, D=d,
         host_ms_per_call=host_ms, library="none: no PyTorch call computes "
         "a linear recurrence", **timing)
    return worst, timing


def ssd_inputs(torch, gen, b, s, h, p, n, model_like):
    """(x, dt, a_log, b, c) float32 on the card: the reference suite's input
    family (dt in [0.001, 0.1], A = exp(a_log) in [1, 8]) or the model's
    (dt = softplus of a normal draw, about 0.3 to 2, A = linspace(1, 16), so
    that the chunk cumsums reach -10^3)."""
    x = torch.randn(b, s, h, p, generator=gen, device="cuda")
    if model_like:
        dt = torch.nn.functional.softplus(
            torch.randn(b, s, h, generator=gen, device="cuda"))
        a_log = torch.log(torch.linspace(1.0, 16.0, h, device="cuda"))
    else:
        dt = 0.001 + 0.099 * torch.rand(b, s, h, generator=gen,
                                        device="cuda")
        a_log = torch.log(1 + 7 * torch.rand(h, generator=gen,
                                             device="cuda"))
    bm, cm = (torch.randn(b, s, n, generator=gen, device="cuda")
              for _ in range(2))
    return x, dt, a_log, bm, cm


def ssd_bound_ms(b, s, h, p, n, elem_bytes, chunk=128):
    """(least time on the card in ms, what bounds it, bytes, flops) for one
    SSD chunk scan: x read and y written in ``elem_bytes``, b and c read in
    ``elem_bytes``, dt read and the final state written in float32, at the
    HBM rate; against the products the chunked algorithm needs on these
    shapes (C B^T once per chunk and batch row, shared by the heads; y_diag
    and the chunk states on every step; y_off on every step past the first
    chunk) at the peak rate of the inputs' type."""
    nbytes = (2 * b * s * h * p * elem_bytes + 2 * b * s * n * elem_bytes
              + 4 * b * s * h + 4 * b * h * p * n + 4 * h)
    lens = [min(chunk, s - t) for t in range(0, s, chunk)]
    sq = sum(x * x for x in lens)
    flops = (2 * b * n * sq + 2 * b * h * p * sq + 2 * b * h * p * n * s
             + 2 * b * h * p * n * (s - lens[0]))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / flops_per_s(elem_bytes) * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations"), nbytes, flops


def phase_ssd_vs_plain(torch, SK, SR):
    """The SSD chunk kernels against their plain version, y and the final
    state: S in {1, 5, 127, 128, 129, 300, 421, 4096}, B in {1, 2}, and S
    16,384 (the server's longest prompt, 128 chunks) at B 1, the model's
    heads (H 64, P 64, N 128) plus the smoke config's (4, 16, 16) and
    ragged ones (3, 24, 40) and (3, 20, 40), float32 inputs (the CUDA-core
    kernel) and bf16 (the tensor-core kernel, or the CUDA-core one for P
    20), each call counted on the kernel it should take, both input
    families, all held to SSD_TOL (a bf16 y to one bf16 spacing more).  S
    421 at B 1 puts the tensor-core kernel's segment boundary (2 segments
    of 2 chunks) one chunk before the ragged tail; B 1,100 with
    60 heads puts 66,000 blocks in the tensor-core kernel's grid.  Each
    tensor-core call is made twice and must give the same bits in y and
    the state.  Every case is reported before any is checked.  Then each
    kernel's time at one 4,096-token prefill of a model layer in the dtype
    it serves (the tensor-core kernel's also at 1, 2 and 4 segments a head,
    and at 16,384 tokens), and the tensor-core kernel's launches in a
    profile: one kernel a call, and memsets."""
    gen = torch.Generator(device="cuda").manual_seed(41)
    shapes = [(b, s, 64, 64, 128)
              for s in (1, 5, 127, 128, 129, 300, 421, 4096) for b in (1, 2)]
    shapes += [(1, 16_384, 64, 64, 128)]
    shapes += [(2, s, 4, 16, 16) for s in (1, 128, 300)]
    shapes += [(2, s, 3, 24, 40) for s in (5, 129, 300)]
    # P not a multiple of 8: bf16 takes the CUDA-core kernel
    shapes += [(2, s, 3, 20, 40) for s in (129, 300)]
    atol, rtol = SSD_TOL
    worst = {}
    failed = []
    for b, s, h, p, n in shapes:
        for model_like in (False, True):
            args = ssd_inputs(torch, gen, b, s, h, p, n, model_like)
            for dtype in (torch.float32, torch.bfloat16):
                x, dt, a_log, bm, cm = (
                    t.to(dtype) if i in (0, 3, 4) else t
                    for i, t in enumerate(args))
                name = ("ssd_chunk_tc" if SK.uses_tensor_cores(dtype, p, n)
                        else "ssd_chunk")
                before = dict(SK.LAUNCHES)
                y, state = SK.ssd_chunk_kernel(x, dt, a_log, bm, cm)
                check({k: SK.LAUNCHES[k] - before[k] for k in before}
                      == {k: int(k == name) for k in before},
                      f"ssd_chunk {dtype} P={p} N={n} did not launch {name}")
                want = SR.ssd_chunk_ref(x, dt, a_log, bm, cm)
                want_state = SR.ssd_final_state(x, dt, a_log, bm)
                same = True
                if name == "ssd_chunk_tc":
                    y2, state2 = SK.ssd_chunk_kernel(x, dt, a_log, bm, cm)
                    same = bool(torch.equal(y2, y)
                                and torch.equal(state2, state))
                torch.cuda.synchronize()
                extra = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
                gy, wy = y.float(), want.float()
                err_y = float((gy - wy).abs().max())
                err_s = float((state - want_state).abs().max())
                # worst ratio of the difference to what the tolerance
                # allows (<= 1 passes)
                ratio_y = float(((gy - wy).abs() / (
                    atol + (rtol + extra) * wy.abs())).max())
                ratio_s = float(((state - want_state).abs() / (
                    atol + rtol * want_state.abs())).max())
                key = ("model" if model_like else "reference", name,
                       str(dtype).split(".")[1])
                w = worst.setdefault(key, [0.0, 0.0, 0.0])
                w[0] = max(w[0], err_y)
                w[1] = max(w[1], err_s)
                w[2] = max(w[2], ratio_y, ratio_s)
                if not (y.dtype == dtype and ratio_y <= 1 and ratio_s <= 1
                        and same and bool(torch.isfinite(gy).all())):
                    failed.append(dict(shape=(b, s, h, p, n), family=key[0],
                                       kernel=name, dtype=key[2],
                                       max_abs_err_y=err_y,
                                       max_abs_err_state=err_s,
                                       ratio_y=ratio_y, ratio_state=ratio_s,
                                       two_calls_bit_equal=same))
    # the tensor-core kernel's grid past 65,535 blocks (B * H = 66,000)
    x, dt, a_log, bm, cm = (t.to(torch.bfloat16) if i in (0, 3, 4) else t
                            for i, t in enumerate(ssd_inputs(
                                torch, gen, 1100, 1, 60, 8, 16, True)))
    y, state = SK.ssd_chunk_kernel(x, dt, a_log, bm, cm)
    want = SR.ssd_chunk_ref(x, dt, a_log, bm, cm).float()
    want_state = SR.ssd_final_state(x, dt, a_log, bm)
    big_y = float(((y.float() - want).abs() / (
        atol + (rtol + 2.0 ** -7) * want.abs())).max())
    big_s = float(((state - want_state).abs() / (
        atol + rtol * want_state.abs())).max())
    emit(phase="kernel_vs_plain", kernel="ssd_chunk_tc", family="model",
         dtype="bfloat16", shape=[1100, 1, 60, 8, 16],
         worst_ratio_to_tolerance=max(big_y, big_s))
    if not (big_y <= 1 and big_s <= 1):
        failed.append(dict(shape=(1100, 1, 60, 8, 16), kernel="ssd_chunk_tc",
                           ratio_y=big_y, ratio_state=big_s))
    for (family, name, dtype), (ey, es, r) in sorted(worst.items()):
        emit(phase="kernel_vs_plain", kernel=name, family=family,
             dtype=dtype, max_abs_err_y=ey, max_abs_err_state=es,
             worst_ratio_to_tolerance=r)
    for f in failed:
        emit(phase="kernel_vs_plain_failed", **f)
    check(not failed, f"ssd_chunk != plain in {len(failed)} of "
                      f"{4 * len(shapes)} cases")

    # one prefill of a 4096-token prompt in an SSD layer of the model, in
    # each kernel's dtype
    b, s, h, p, n = SSD_SHAPE
    timings = {}
    for name, dtype in (("ssd_chunk_tc", torch.bfloat16),
                        ("ssd_chunk", torch.float32)):
        x, dt, a_log, bm, cm = (t.to(dtype) if i in (0, 3, 4) else t
                                for i, t in enumerate(ssd_inputs(
                                    torch, gen, b, s, h, p, n, True)))
        ms, host_ms = time_cuda(torch, lambda: SK.ssd_chunk_kernel(
            x, dt, a_log, bm, cm), 20)
        plain_ms, _ = time_cuda(torch, lambda: (
            SR.ssd_chunk_ref(x, dt, a_log, bm, cm),
            SR.ssd_final_state(x, dt, a_log, bm)), 5)
        bound, by, nbytes, flops = ssd_bound_ms(
            b, s, h, p, n, torch.finfo(dtype).bits // 8)
        timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                             bound_by=by, library_ms=None)
        extra = {}
        if name == "ssd_chunk_tc":
            # what the segments buy (one segment a head: 64 blocks, half
            # the card; four: two waves), and the server's longest prompt
            # at the rule's segments
            extra["segments"] = SK.segment_count(b, h, s)
            extra["ms_by_segments"] = {
                seg: time_cuda(torch, lambda: SK.ssd_chunk_kernel(
                    x, dt, a_log, bm, cm, segments=seg), 20)[0]
                for seg in (1, 2, 4)}
            long = [t.to(dtype) if i in (0, 3, 4) else t
                    for i, t in enumerate(ssd_inputs(
                        torch, gen, b, 16_384, h, p, n, True))]
            extra["segments_s16384"] = SK.segment_count(b, h, 16_384)
            extra["ms_s16384"], _ = time_cuda(
                torch, lambda: SK.ssd_chunk_kernel(*long), 10)
            extra["bound_ms_s16384"] = ssd_bound_ms(
                b, 16_384, h, p, n, torch.finfo(dtype).bits // 8)[0]
            del long
        emit(phase="kernel_timing", kernel=name, B=b, S=s, H=h, P=p, N=n,
             dtype=f"{str(dtype).split('.')[1]} x, b, c; float32 dt, state",
             host_ms_per_call=host_ms, bytes=nbytes, flops=flops,
             library="none: no PyTorch call computes an SSD chunk scan",
             **timings[name], **extra)
        if name == "ssd_chunk_tc":
            # the kernel and its workspace memset over ten calls: one
            # kernel a call and nothing else but memsets
            prof = profile_device(torch, lambda: [SK.ssd_chunk_kernel(
                x, dt, a_log, bm, cm) for _ in range(10)])
            emit(phase="device_profile", workload="ssd_chunk_x10", **prof)
            check(sum(k["calls"] for k in prof["top_kernels"]
                      if "ssd_tc" in k["name"]) == 10
                  and all("ssd_tc" in k["name"]
                          or k["name"].startswith("Memset")
                          for k in prof["top_kernels"]),
                  "ssd_chunk_tc is not one kernel a call")
    return {name: max([w[0] for k, w in worst.items() if k[1] == name],
                      default=0.0) for name in SK.LAUNCHES}, timings


def manual_greedy(torch, TF, model, prompt, n_new, max_len, rows=1):
    """Greedy tokens of one request by a manual prefill + decode_step loop,
    with the logits of every step.  With ``rows`` > 1 the prompt's cache is
    copied into that many batch rows and all decode together (the tokens
    are row 0's): every matrix product then has the shape it has in a
    server of ``rows`` slots, and each row's result does not depend on the
    other rows."""
    logits, cache = TF.prefill(
        model, torch.as_tensor(prompt[None], device="cuda"), max_len)
    cache = [{name: {leaf: x.repeat_interleave(rows, dim=0)
                     for leaf, x in d.items()} for name, d in layer.items()}
             for layer in cache]
    out = [logits[0, -1].float()]
    toks = [int(torch.argmax(logits[0, -1]))]
    pos = len(prompt)
    for _ in range(n_new - 1):
        logits, cache = TF.decode_step(
            model, cache,
            torch.full((rows, 1), toks[-1], dtype=torch.int32, device="cuda"),
            torch.full((rows, 1), pos, dtype=torch.int32, device="cuda"))
        out.append(logits[0, -1].float())
        toks.append(int(torch.argmax(logits[0, -1])))
        pos += 1
    return toks, out


def manual_greedy_batch(torch, TF, model, prompts, n_new, max_len):
    """Greedy tokens of requests admitted together into as many slots, by a
    manual loop that reproduces the server's batch: each prompt prefilled
    alone, the caches stacked in slot order, all rows decoded together,
    each at its own position.  A MoE layer routes a tick's rows as one
    group, so a row's tokens depend on the others' and only this batch can
    reproduce them."""
    caches, toks = [], []
    for prompt in prompts:
        logits, cache = TF.prefill(
            model, torch.as_tensor(prompt[None], device="cuda"), max_len)
        caches.append(cache)
        toks.append([int(torch.argmax(logits[0, -1]))])
    cache = [{name: {leaf: torch.cat([c[i][name][leaf] for c in caches])
                     for leaf in d} for name, d in layer.items()}
             for i, layer in enumerate(caches[0])]
    pos = [len(p) for p in prompts]
    for _ in range(n_new - 1):
        logits, cache = TF.decode_step(
            model, cache,
            torch.tensor([[t[-1]] for t in toks], dtype=torch.int32,
                         device="cuda"),
            torch.tensor([[q] for q in pos], dtype=torch.int32,
                         device="cuda"))
        for row, t in enumerate(torch.argmax(logits[:, 0], dim=-1).tolist()):
            toks[row].append(t)
            pos[row] += 1
    return toks


def serve_model(np, torch, arch, prompts_len, max_len, kernels,
                manual_prompts, forward_tokens, seed, *, batch_manual=False,
                around_run=contextlib.nullcontext):
    """One model of the repo at its published width on the card, weights
    from a seeded generator, behind the slot server: one greedy request per
    prompt length, SERVE_NEW new tokens each, SERVE_SLOTS slots.
    ``kernels`` maps each kernel of the model's prefill to (its launch
    counter, the block kind that launches it once per prefill, or None for
    a kernel the run must not launch); the counts are set to 0 just before
    the run and read just after; ``around_run()`` is a context entered
    around the run alone.  Then the server against a manual prefill +
    decode loop (with ``batch_manual``, the first SERVE_SLOTS requests
    against `manual_greedy_batch` instead), prefill against forward, and a
    device profile of the longest prefill and of one tick.  Returns the
    launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TF
    from repro_torch.runtime.server import Request, Server

    class CheckedServer(Server):
        """The server, noting any NaN among the logits it samples from."""
        nan = False

        def _sample(self, logits):
            self.nan = self.nan or bool(torch.isnan(logits).any())
            return super()._sample(logits)

    cfg = get_config(arch)
    # the reference's float32 matrix products (RG-LRU gates) stay float32:
    # PyTorch keeps TF32 off for matrix products unless told otherwise
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "float32 matrix products would run in TF32")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = TF.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in model.parameters())
    kinds = [key.split("_", 1)[1] for key, _ in model.keys]
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in prompts_len]
    # warm up (not part of the run): the first prefills of a new length
    # load the libraries' GEMM kernels and grow the allocator's pool
    CheckedServer(model, slots=SERVE_SLOTS, max_len=max_len).run(
        [Request(rid=-1 - j, prompt=prompts[j], max_new=2)
         for j in (0, 2, len(prompts) - 1)])
    torch.cuda.synchronize()

    reqs = [Request(rid=i, prompt=p, max_new=SERVE_NEW)
            for i, p in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    srv = CheckedServer(model, slots=SERVE_SLOTS, max_len=max_len,
                        temperature=0.0)
    for counter, _ in kernels.values():
        for name in counter:
            counter[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with around_run():
        stats = srv.run(reqs)
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {name: counter[name] for name, (counter, _) in kernels.items()}
    peak = torch.cuda.max_memory_allocated()

    prefills = len(stats["prefill_ms"])
    check(prefills == len(reqs), f"{prefills} prefills for {len(reqs)} "
                                 f"requests")
    for r in reqs:
        check(r.done and len(r.out) == SERVE_NEW
              and all(0 <= t < cfg.vocab for t in r.out),
              f"request {r.rid} ({len(r.prompt)} tokens) did not finish "
              f"with {SERVE_NEW} tokens: {len(r.out)}")
    check(not srv.nan, f"{arch}: NaN among the served logits")
    for name, (_, kind) in kernels.items():
        check(launches[name] == kinds.count(kind) * prefills,
              f"{launches[name]} {name} launches for {prefills} prefills of "
              f"{kinds.count(kind)} {kind} layers")
    dec = sorted(stats["decode_ms"])
    tokens = stats["generated"] + len(reqs)
    emit(phase="model_serve", arch=cfg.name, layers=len(kinds),
         d_model=cfg.d_model, params=n_params, init_s=init_s,
         slots=SERVE_SLOTS, max_len=max_len,
         prompt_tokens=list(prompts_len), new_tokens=SERVE_NEW,
         prefill_ms=stats["prefill_ms"], ticks=stats["ticks"],
         decode_ms_per_tick_mean=sum(dec) / len(dec),
         decode_ms_per_tick_median=dec[len(dec) // 2],
         decode_ms_per_tick_min=dec[0], decode_ms_per_tick_max=dec[-1],
         run_s=run_s, generated_tokens=tokens,
         generated_tokens_per_s=tokens / run_s,
         max_memory_allocated_bytes=peak, init_peak_bytes=init_peak,
         weight_bytes=sum(p.numel() * p.element_size()
                          for p in model.parameters()),
         params_count=cfg.params_count(),
         **{f"{name}_launches": n for name, n in launches.items()})

    if batch_manual:
        # the first SERVE_SLOTS requests were admitted together and finish
        # on one tick: the server's batch, reproduced by hand
        toks = manual_greedy_batch(torch, TF, model, prompts[:SERVE_SLOTS],
                                   SERVE_NEW, max_len)
        for i, t in enumerate(toks):
            check(t == reqs[i].out,
                  f"{arch} prompt {prompts_len[i]}: server tokens "
                  f"{reqs[i].out} != the batch-reproducing loop's {t}")
        emit(phase="serve_vs_manual", arch=cfg.name, mode="server's batch",
             prompt_tokens=list(prompts_len[:SERVE_SLOTS]),
             equal_token_for_token=True)
    # the server's greedy tokens against a manual loop on the port: at the
    # server's batch width, token for token; with one row, equal up to a
    # near tie (a 1-row decode rounds through other matrix shapes)
    for n in manual_prompts:
        i = prompts_len.index(n)
        toks, _ = manual_greedy(torch, TF, model, prompts[i], SERVE_NEW,
                                max_len, rows=SERVE_SLOTS)
        check(toks == reqs[i].out,
              f"{arch} prompt {n}: server tokens {reqs[i].out} != manual "
              f"loop {toks} at the server's batch width")
        toks1, rows1 = manual_greedy(torch, TF, model, prompts[i],
                                     SERVE_NEW, max_len)
        diff = [j for j, (x, y) in enumerate(zip(toks1, reqs[i].out))
                if x != y]
        gap = None
        if diff:
            row = rows1[diff[0]]
            top = float(row.max())
            gap = top - float(row[reqs[i].out[diff[0]]])
            check(gap <= 2 * (MODEL_TOL + MODEL_TOL * abs(top)),
                  f"{arch} prompt {n}: server and 1-row loop differ at "
                  f"token {diff[0]} beyond a near tie (gap {gap})")
        emit(phase="serve_vs_manual", arch=cfg.name, prompt_tokens=n,
             equal_at_server_width=True, equal_one_row=not diff,
             one_row_first_difference=diff[0] if diff else None,
             one_row_logit_gap=gap)

    # prefill's last logits against forward's at that position
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, forward_tokens)),
                           device="cuda")
    pre, _ = TF.prefill(model, toks, max_len)
    full = TF.forward(model, toks)
    err = float((pre[0, 0].float() - full[0, -1].float()).abs().max())
    check(torch.allclose(pre[0, 0].float(), full[0, -1].float(),
                         atol=MODEL_TOL, rtol=MODEL_TOL)
          and not bool(torch.isnan(full).any()),
          f"{arch}: prefill vs forward at {forward_tokens} tokens: max abs "
          f"err {err}")
    emit(phase="prefill_vs_forward", arch=cfg.name, tokens=forward_tokens,
         max_abs_err=err)
    del full

    # where a prefill's and a tick's device time goes (after the counts
    # are read: these are timing runs)
    n_long = max(n for n in prompts_len if n <= 4096)
    long_prompt = torch.as_tensor(prompts[prompts_len.index(n_long)][None],
                                  device="cuda")
    emit(phase="device_profile", arch=cfg.name, workload=f"prefill_{n_long}",
         **profile_device(torch, lambda: TF.prefill(model, long_prompt,
                                                    max_len)))
    cache = TF.init_cache(cfg, SERVE_SLOTS, max_len, device="cuda")
    tok = torch.zeros((SERVE_SLOTS, 1), dtype=torch.int32, device="cuda")
    emit(phase="device_profile", arch=cfg.name,
         workload="decode_tick_4_slots",
         **profile_device(torch, lambda: TF.decode_step(model, cache, tok,
                                                        tok)))
    return launches


def phase_model_serve(np, torch, FA, RK):
    """recurrentgemma-2b at its published width: 8 requests of 64 to 4,096
    prompt tokens, every prefill through the tensor-core flash-attention
    kernel (bf16; the CUDA-core one never) and the RG-LRU scan kernel."""
    return serve_model(
        np, torch, MODEL_ARCH, SERVE_PROMPTS, SERVE_MAX_LEN,
        {"flash_attention_tc": (FA.LAUNCHES, "attn_local"),
         "flash_attention": (FA.LAUNCHES, None),
         "rglru_scan": (RK.LAUNCHES, "rglru")},
        manual_prompts=(2049, 4096), forward_tokens=SERVE_FORWARD_TOKENS,
        seed=13)


def phase_model_serve_mamba2(np, torch, SK):
    """mamba2-1.3b at its published width: 8 requests of 1 to 16,384 prompt
    tokens (one chunk, a ragged tail, many chunks, the long prompt that
    ``sub_quadratic`` is for), every prefill through the tensor-core SSD
    kernel (bf16; the CUDA-core one never)."""
    return serve_model(
        np, torch, MAMBA_ARCH, MAMBA_PROMPTS, MAMBA_MAX_LEN,
        {"ssd_chunk_tc": (SK.LAUNCHES, "ssd"),
         "ssd_chunk": (SK.LAUNCHES, None)},
        manual_prompts=(129, 4096), forward_tokens=SERVE_FORWARD_TOKENS,
        seed=17)


@contextlib.contextmanager
def counted_routes(MOE, calls):
    """While open, every MoE routing appends (tokens routed, kept (token,
    choice) pairs as a device tensor) to ``calls``: `moe.moe_mlp` looks
    `moe.route` up at each call."""
    route = MOE.route

    def spy(router, xt, **kw):
        r = route(router, xt, **kw)
        calls.append((xt.shape[0] * xt.shape[1], r.keep.sum()))
        return r

    MOE.route = spy
    try:
        yield
    finally:
        MOE.route = route


def kept_shares(torch, calls, layers, top_k):
    """The kept share of (token, choice) pairs of each model step (its
    ``layers`` routings in a row), [(tokens, share)]; of each layer over
    the prefills and over the ticks (steps of SERVE_SLOTS tokens); and of
    each layer in each prefill, by its token count."""
    kept = torch.stack([k for _, k in calls]).cpu().tolist()
    steps, prefills = [], {}
    by_layer = {"prefill": [[0, 0] for _ in range(layers)],
                "tick": [[0, 0] for _ in range(layers)]}
    for i in range(0, len(calls), layers):
        t = calls[i][0]
        steps.append((t, sum(kept[i:i + layers]) / (layers * t * top_k)))
        if t != SERVE_SLOTS:
            prefills[t] = [x / (t * top_k) for x in kept[i:i + layers]]
        side = by_layer["tick" if t == SERVE_SLOTS else "prefill"]
        for j in range(layers):
            side[j][0] += kept[i + j]
            side[j][1] += t * top_k
    return steps, {k: [a / b for a, b in v] for k, v in by_layer.items()}, \
        prefills


def serve_moe(np, torch, FA, MOE):
    """qwen3-moe-30b-a3b at its published width (48 ``attn_moe`` layers,
    128 experts, top 8; 30.2 B parameters, 60.4 GB of seeded random bf16
    weights) behind the slot server: 8 requests of 64 to 4,096 prompt
    tokens, each at most one 512-token group or whole groups, every prefill
    through the tensor-core flash kernel.  The server against a loop that
    reproduces its first batch, and the kept share of (token, choice)
    pairs of every prefill and tick (a 4-slot tick is one group with one
    slot an expert, so pairs are dropped there, as in the reference)."""
    from repro_torch.configs import get_config

    cfg = get_config(MOE_ARCH)
    calls = []
    launches = serve_model(
        np, torch, MOE_ARCH, MOE_PROMPTS, SERVE_MAX_LEN,
        {"flash_attention_tc": (FA.LAUNCHES, "attn_moe"),
         "flash_attention": (FA.LAUNCHES, None)},
        manual_prompts=(), forward_tokens=MOE_FORWARD_TOKENS, seed=19,
        batch_manual=True,
        around_run=lambda: counted_routes(MOE, calls))
    steps, by_layer, by_prefill = kept_shares(torch, calls, cfg.n_layers,
                                              cfg.moe.top_k)
    prefills = [share for t, share in steps if t != SERVE_SLOTS]
    ticks = [share for t, share in steps if t == SERVE_SLOTS]
    check(len(prefills) == len(MOE_PROMPTS) and all(
        0 < x <= 1 for x in prefills + ticks),
        f"{MOE_ARCH}: kept shares {steps}")
    emit(phase="moe_routing", arch=cfg.name, top_k=cfg.moe.top_k,
         experts=cfg.moe.n_experts, group=cfg.moe_group,
         prefill_tokens=list(MOE_PROMPTS), prefill_kept_share=prefills,
         ticks=len(ticks), tick_kept_share_mean=sum(ticks) / len(ticks),
         tick_kept_share_min=min(ticks), tick_kept_share_max=max(ticks),
         tick_kept_share=ticks,
         prefill_kept_share_by_layer=by_layer["prefill"],
         prefill_512_kept_share_by_layer=by_prefill[512],
         tick_kept_share_by_layer=by_layer["tick"])
    return launches


@contextlib.contextmanager
def attention_rounded_as_reference(A):
    """While open, the model stack's prefill and forward attention is the
    reference model's formulation (`attention.plain_attention`: softmax
    weights rounded to bf16, bf16 products) instead of the flash kernel."""
    flash = A.flash_attention
    A.flash_attention = lambda q, k, v, causal=True, window=0: \
        A.plain_attention(q, k, v, causal=causal, window=window or None)
    try:
        yield
    finally:
        A.flash_attention = flash


def teacher_forced_steps(torch, TF, model, prompt, fe, n_new, max_len,
                         launched, rel_rms_limit=None, shift=0):
    """Prefill (with frontend embeddings) and ``n_new`` greedy decode
    steps, every step's logits against `forward` teacher-forced on the
    same tokens; the host ms of the prefill and of each step, the launches
    (``launched()`` reads the count) of the prefill and of all the steps,
    and whether the model's rule, fixed before the run, holds them
    (``held``):

    * ``rel_rms_limit`` None: every element within ``MODEL_TOL`` absolute
      plus relative;
    * else: each step's relative RMS error at most ``rel_rms_limit``, and
      its greedy token forward's up to a near tie (within ``2 * (MODEL_TOL
      + MODEL_TOL * |top|)`` of forward's top logit).

    ``shift`` plants a fault: the decode steps are given RoPE positions
    that many tokens on (the cache slots stay right), a run the rule must
    refuse.  Reported beside it, and never used to judge: the bf16 noise
    floor, the spread of two forward passes of the same function
    (attention rounded as the reference's) that differ only in their
    matrix products' row counts (one token less)."""
    from repro_torch.models import attention as A

    b, n = prompt.shape
    c0 = launched()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = TF.prefill(model, prompt, max_len, frontend_embeds=fe)
    tok = torch.argmax(logits[:, -1], dim=-1)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    c1 = launched()
    rows, fed, step_ms = [logits[:, -1]], [], []
    for i in range(n_new):
        fed.append(tok)
        t0 = time.perf_counter()
        logits, cache = TF.decode_step(
            model, cache, tok[:, None].to(torch.int32),
            torch.full((b, 1), n + i + shift, dtype=torch.int32,
                       device=prompt.device))
        tok = torch.argmax(logits[:, 0], dim=-1)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        rows.append(logits[:, 0])
    c2 = launched()
    del cache
    seq = torch.cat([prompt, torch.stack(fed, dim=1).to(prompt.dtype)], 1)
    want = TF.forward(model, seq, frontend_embeds=fe).float()[:, n - 1:]
    got = torch.stack(rows, dim=1).float()

    def excess(x, y):
        return (x - y).abs() - (MODEL_TOL + MODEL_TOL * y.abs())

    over = excess(got, want)
    with attention_rounded_as_reference(A):
        full = TF.forward(model, seq, frontend_embeds=fe).float()
        short = TF.forward(model, seq[:, :-1], frontend_embeds=fe).float()
    floor = excess(short[:, n - 1:], full[:, n - 1:-1])
    del full, short
    rel = ((got - want).square().mean(dim=-1).sqrt()
           / want.square().mean(dim=-1).sqrt())
    top = want.amax(dim=-1)
    picked = got.argmax(dim=-1, keepdim=True)
    gap = top - want.gather(-1, picked)[..., 0]
    near = gap <= 2 * (MODEL_TOL + MODEL_TOL * top.abs())
    nan = bool(torch.isnan(got).any())
    if rel_rms_limit is None:
        held = not nan and float(over.max()) <= 0
    else:
        held = (not nan and float(rel.max()) <= rel_rms_limit
                and bool(near.all()))
    out = dict(prefill_ms=prefill_ms, step_ms=step_ms,
               prefill_launches=c1 - c0, decode_launches=c2 - c1,
               rule="element bound" if rel_rms_limit is None
               else "relative RMS and greedy tokens",
               rel_rms_limit=rel_rms_limit, rope_shift=shift, held=held,
               max_abs_err_vs_forward=float((got - want).abs().max()),
               max_abs_err_by_step=(got - want).abs().amax(
                   dim=(0, 2)).tolist(),
               worst_excess_over_bound=float(over.max()),
               elements_over_bound=int((over > 0).sum()),
               elements=over.numel(),
               noise_floor_worst_excess_over_bound=float(floor.max()),
               noise_floor_elements_over_bound=int((floor > 0).sum()),
               max_rel_rms_err=float(rel.max()),
               rel_rms_err_by_step=rel.amax(dim=0).tolist(),
               greedy_tokens_differing=int((gap > 0).sum()),
               greedy_tokens_beyond_a_near_tie=int((~near).sum()),
               largest_gap_of_a_differing_token=float(gap.max()),
               largest_logit=float(want.abs().max()))
    emit(phase="teacher_forced", arch=model.cfg.name, prompt_tokens=n,
         batch=b, **{k: v for k, v in out.items() if k != "step_ms"})
    return out


def decode_family(np, torch, FA, arch, prompts, batch, n_embeds, seed,
                  rel_rms_limit=None, profile_prompt=None):
    """One model at its published width on the card, driven through
    `prefill(..., frontend_embeds=)` and `decode_step` (whisper's slot
    server refuses it, as the reference's cannot serve it; phi-3-vision's
    server takes no patch embeddings): ``batch`` rows of each prompt
    length with seeded frontend embeddings of ``n_embeds`` rows (at the
    embedding table's scale), FAMILY_NEW greedy steps, every step's logits
    against forward by the model's rule (`teacher_forced_steps`), and the
    same rule refusing a run with a planted fault.  Returns the flash
    kernels' launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TF
    from repro_torch.runtime.server import Server

    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = TF.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if cfg.enc_layers:
        try:
            Server(model, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN)
            refused = False
        except ValueError:
            refused = True
        check(refused, f"{arch}: the slot server took an enc-dec model")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)
    max_len = max(prompts) + FAMILY_NEW + 1

    def inputs(n):
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, n)),
                                 device="cuda")
        fe = (torch.randn((batch, n_embeds, cfg.d_model), generator=gen,
                          device="cuda") * cfg.d_model ** -0.5).to(
            torch.bfloat16)
        return prompt, fe

    runs = [inputs(n) for n in prompts]
    # warm up (not part of the run): the first calls of each shape load the
    # libraries' GEMM kernels and grow the allocator's pool
    for prompt, fe in runs:
        _, cache = TF.prefill(model, prompt, max_len, frontend_embeds=fe)
        TF.decode_step(model, cache, prompt[:, :1].to(torch.int32),
                       torch.full((batch, 1), prompt.shape[1],
                                  dtype=torch.int32, device="cuda"))
    del cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in FA.LAUNCHES:
        FA.LAUNCHES[name] = 0
    results = [teacher_forced_steps(
        torch, TF, model, prompt, fe, FAMILY_NEW, max_len,
        lambda: FA.LAUNCHES["flash_attention_tc"], rel_rms_limit)
        for prompt, fe in runs]
    # the serving runs' launches (the forward passes that check them come
    # after each run's count is read)
    launches = {"flash_attention_tc": sum(
        r["prefill_launches"] + r["decode_launches"] for r in results),
        "flash_attention": FA.LAUNCHES["flash_attention"]}
    peak = torch.cuda.max_memory_allocated()
    per_prefill = cfg.n_layers + (cfg.n_layers + cfg.enc_layers
                                  if cfg.enc_layers else 0)
    per_step = cfg.n_layers if cfg.enc_layers else 0
    for n, r in zip(prompts, results):
        check(r["prefill_launches"] == per_prefill
              and r["decode_launches"] == per_step * FAMILY_NEW,
              f"{arch} prompt {n}: {r['prefill_launches']} launches in the "
              f"prefill ({per_prefill} expected), {r['decode_launches']} in "
              f"{FAMILY_NEW} steps ({per_step} a step expected)")
    check(launches["flash_attention"] == 0,
          f"{arch} launched the CUDA-core flash kernel")
    for n, r in zip(prompts, results):
        check(r["held"], f"{arch} prompt {n}: prefill and decode logits vs "
                         f"forward: {r}")
    # the control: the same rule refuses decode steps whose RoPE positions
    # are one token on (after the counts are read)
    planted = teacher_forced_steps(
        torch, TF, model, *runs[0], FAMILY_NEW, max_len,
        lambda: FA.LAUNCHES["flash_attention_tc"], rel_rms_limit, shift=1)
    check(not planted["held"], f"{arch}: the rule held decode steps with "
                               f"their RoPE positions one on: {planted}")
    steps = sorted(x for r in results for x in r["step_ms"])
    emit(phase="model_serve", arch=cfg.name,
         layers=cfg.n_layers, encoder_layers=cfg.enc_layers,
         d_model=cfg.d_model, params=sum(p.numel()
                                         for p in model.parameters()),
         params_count=cfg.params_count(), init_s=init_s, batch=batch,
         frontend_embeds=n_embeds, prompt_tokens=list(prompts),
         new_tokens=FAMILY_NEW,
         prefill_ms=[r["prefill_ms"] for r in results],
         decode_ms_per_step_mean=sum(steps) / len(steps),
         decode_ms_per_step_median=steps[len(steps) // 2],
         decode_ms_per_step_min=steps[0], decode_ms_per_step_max=steps[-1],
         max_abs_err_vs_forward=[r["max_abs_err_vs_forward"]
                                 for r in results],
         max_memory_allocated_bytes=peak,
         weight_bytes=sum(p.numel() * p.element_size()
                          for p in model.parameters()),
         flash_attention_tc_launches=launches["flash_attention_tc"],
         flash_attention_launches=launches["flash_attention"],
         launches_per_prefill=per_prefill, launches_per_step=per_step)
    if profile_prompt is not None:
        prompt, fe = runs[prompts.index(profile_prompt)]
        emit(phase="device_profile", arch=cfg.name,
             workload=f"prefill_{profile_prompt}",
             **profile_device(torch, lambda: TF.prefill(
                 model, prompt, max_len, frontend_embeds=fe)))
    return launches


def phase_model_families(np, torch, FA, MOE):
    """Phase 5h: the model stack's remaining families at their published
    widths, after the earlier models are freed: qwen3-moe-30b-a3b behind
    the slot server, whisper-base (four requests of 224 decoder tokens,
    then four of 448, each with 1,500 encoder frames) and phi-3-vision-4.2b
    (prompts of 1,024 and 4,096 tokens whose first 576 embeddings are
    patches) through prefill and decode.  Returns the flash kernels'
    launches over the three."""
    gc.collect()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_allocated()
    check(start < FAMILY_START_BYTES,
          f"{start} bytes still allocated when phase 5h starts")
    t0 = time.perf_counter()
    total = {name: 0 for name in FA.LAUNCHES}
    runs = ((serve_moe, (np, torch, FA, MOE)),
            (decode_family, (np, torch, FA, WHISPER_ARCH, WHISPER_PROMPTS,
                             SERVE_SLOTS, WHISPER_FRAMES, 23)),
            (decode_family, (np, torch, FA, VLM_ARCH, VLM_PROMPTS, 1,
                             576, 29, VLM_REL_RMS_LIMIT, 4096)))
    for fn, args in runs:
        for name, n in fn(*args).items():
            total[name] += n
        gc.collect()
        torch.cuda.empty_cache()
    emit(phase="model_families", host_s=time.perf_counter() - t0,
         allocated_at_start_bytes=start,
         **{f"{name}_launches": n for name, n in total.items()})
    return total


# ---------------------------------------------------------------------------
# phase 5i: training
# ---------------------------------------------------------------------------

# the flash backward: S, dP, dV, dK and dQ, 2 * D flops each per unmasked
# (query, key) pair
FLASH_BWD_FLOPS_PER_PAIR_PER_D = 10


def grad_allowance(torch, want, extra=0.0):
    """FLASH_BWD_ULPS bf16 spacings of |want| plus FLASH_BWD_REL of the
    tensor's largest |want| plus FLASH_BWD_ATOL (plus ``extra``)."""
    w = want.float()
    spacing = torch.exp2(torch.floor(torch.log2(
        w.abs().clamp_min(2.0 ** -100))) - 7)
    return (FLASH_BWD_ULPS * spacing + FLASH_BWD_REL * float(w.abs().max())
            + FLASH_BWD_ATOL + extra)


def grad_within(torch, got, want, extra=0.0):
    """(ok, the largest difference over its allowance) for ``got`` against
    ``want`` within `grad_allowance`."""
    ratio = float(((got.float() - want.float()).abs()
                   / grad_allowance(torch, want, extra)).max())
    return ratio <= 1.0, ratio


def flash_bwd_bound_ms(b, s, h, kvh, d, window, causal=True, t=None):
    """(least time on the card in ms, what bounds it) for one backward
    call: 10 * D flops per unmasked pair on the tensor cores, against q, o,
    dO and dQ (B, S, H, D), k, v, dK and dV (B, T, KV, D) in bf16 and the
    float32 lse moved once at the HBM rate."""
    t = s if t is None else t
    flops = FLASH_BWD_FLOPS_PER_PAIR_PER_D * d * attn_pairs(
        s, window, causal, t) * b * h
    nbytes = 2 * d * b * (4 * s * h + 4 * t * kvh) + 4 * b * h * s
    ops_ms = flops / TENSOR_BF16_FLOPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def train_bwd_cases():
    """The flash backward's cases: every shape phase 5i launches (the
    full-width period, the 4,096-token steps, the 100m preset's batch), a
    training layer of each model (timed: recurrentgemma-2b's, qwen3-moe's H
    32 over KV 4 at D 128, phi-3-vision's H 32 at D 96, whisper's encoder
    non-causal at 1,500 frames and its cross attention, 448 queries
    against 1,500 keys), the small training drivers' smoke llama (D 8,
    which the autograd op pads to 16), and edges (D 16, D 12 padded, S < T
    causal and not, one query, ragged tiles, D 256 with a window, GQA)."""
    from repro_torch.configs import get_config, get_smoke_config

    rg = get_config(MODEL_ARCH)
    small = get_smoke_config(SMALL_TRAIN_ARCH)
    rgk = dict(kvh=rg.n_kv, g=rg.n_heads // rg.n_kv, d=rg.head_dim,
               window=rg.window, causal=True)
    return [
        dict(b=1, s=PERIOD_TOKENS, **rgk),
        dict(b=1, s=TRAIN_TOKENS, model=MODEL_ARCH, **rgk),
        dict(b=TRAIN_100M_BATCH, s=TRAIN_100M_SEQ, kvh=4, g=3, d=64,
             window=0, causal=True),
        dict(b=1, s=4096, kvh=4, g=8, d=128, window=0, causal=True,
             model=MOE_ARCH),
        dict(b=1, s=4096, kvh=32, g=1, d=96, window=0, causal=True,
             model=VLM_ARCH),
        dict(b=1, s=WHISPER_FRAMES, kvh=8, g=1, d=64, window=0,
             causal=False, model=f"{WHISPER_ARCH} encoder"),
        dict(b=1, s=448, t=WHISPER_FRAMES, kvh=8, g=1, d=64, window=0,
             causal=False, model=f"{WHISPER_ARCH} cross attention"),
        dict(b=1, s=64, kvh=1, g=4, d=16, window=32, causal=True),
        dict(b=2, s=129, t=200, kvh=2, g=3, d=128, window=0, causal=True),
        dict(b=1, s=70, t=131, kvh=2, g=2, d=96, window=0, causal=False),
        dict(b=1, s=1, kvh=2, g=1, d=64, window=0, causal=True),
        dict(b=1, s=300, kvh=1, g=2, d=256, window=40, causal=True),
        dict(b=1, s=257, kvh=2, g=4, d=64, window=100, causal=True),
        *[dict(b=b, s=s, kvh=small.n_kv, g=small.n_heads // small.n_kv,
               d=small.head_dim, window=0, causal=True)
          for b, s in SMALL_TRAIN_BATCHES],
        dict(b=2, s=70, t=131, kvh=4, g=1, d=12, window=0, causal=False),
        dict(b=1, s=100, kvh=1, g=3, d=12, window=17, causal=True),
    ]


def plain_flash_grads(torch, FAR, q, k, v, do, **kw):
    """``torch.autograd.grad`` through the plain forward in float32."""
    leaves = [x.float().requires_grad_() for x in (q, k, v)]
    out = FAR.flash_attention_ref(*leaves, **kw)
    return torch.autograd.grad(out, leaves, do.float())


def sdpa_backward_ms(torch, q, k, v, do, *, causal, window):
    """SDPA's backward on the same function (``is_causal`` with
    ``enable_gqa`` where there is no window, the dense window mask
    otherwise), a yardstick only: (ms, None) or (None, why refused)."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    mask = None
    if window > 0:
        s, t = q.shape[1], k.shape[1]
        pos, kpos = torch.arange(s, device="cuda"), torch.arange(
            t, device="cuda")
        mask = (kpos[None] > pos[:, None] - window)
        if causal:
            mask &= kpos[None] <= pos[:, None]
    try:
        out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)
        dot = do.transpose(1, 2)
        ms, _ = time_cuda(torch, lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), 10)
        return ms, None
    except RuntimeError as e:
        return None, str(e).splitlines()[0][:200]


def flash_bwd_launch_ms(torch, FAB, args, kw, calls=5):
    """Device ms per call of each of the flash backward's four launches
    (delta, dkdv, sum, dq): CUDA events the kernel records before its first
    launch and after each (``marks``), over ``calls`` calls queued behind a
    device spin.  (``torch.profiler`` saw none of these launches at this
    point of the whole script, in two runs, though it did in a process of
    its own.)"""
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(5)]
             for _ in range(calls)]
    for row in marks:
        for e in row:
            e.record()  # an event exists from its first record
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    for row in marks:
        FAB.flash_attention_bwd_kernel(*args, marks=row, **kw)
    torch.cuda.synchronize()
    return {name: sum(row[i].elapsed_time(row[i + 1]) for row in marks)
            / calls for i, name in enumerate(("delta", "dkdv", "sum", "dq"))}


def flash_bwd_vs_plain(torch, FA, FAR):
    """The flash backward kernel at every case of `train_bwd_cases`, in
    bf16: the forward with the LSE pointer set bit-identical to the one
    without, its base-2 LSE against the plain version's within
    FLASH_LSE_ATOL, and dQ, dK and dV against the plain backward on the
    same inputs within FLASH_BWD_ULPS spacings plus FLASH_BWD_REL of the
    largest, and against autograd through the plain forward in float32
    within that bound widened by the plain backward's own distance from
    autograd (see FLASH_BWD_ULPS); a second call on the same inputs bit
    for bit equal to the first; each call counted on the backward.  A head
    dim that is not a multiple of 16 takes the autograd op's route (q, k,
    v, dO padded with zero columns to 16, both kernels given the true D's
    divisor, the results sliced back), held to the plain versions at the
    true D, and the op itself (`ops.flash_attention` under autograd) gives
    the same output and gradients bit for bit.  Then
    the timed cases' device ms against the plain backward's
    (`ref.flash_attention_bwd_plain`), the bound and SDPA's backward (and,
    where the layer has a window, SDPA's ``is_causal`` backward without
    it), with each of the four launches' device ms.
    Returns (worst abs err, the `flash_key`s held, the timings by model)."""
    from repro_torch.kernels.flash_attention import kernel_bwd as FAB
    from repro_torch.kernels.flash_attention import ops as FAO

    gen = torch.Generator(device="cuda").manual_seed(43)
    worst = ratio_worst = lse_worst = 0.0
    auto_err = auto_worst = auto_widened = 0.0
    checked, timings = set(), {}
    for c in train_bwd_cases():
        b, s, kvh, d = c["b"], c["s"], c["kvh"], c["d"]
        t, h = c.get("t", s), c["kvh"] * c["g"]
        kw = dict(causal=c["causal"], window=c["window"])
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16) for shape in ((b, s, h, d), (b, t, kvh, d),
                                          (b, t, kvh, d), (b, s, h, d)))
        dp = FAO.padded_head_dim(d)
        qp, kp, vp, dop = (FAO.pad_head_dim(x, dp) for x in (q, k, v, do))
        pkw = dict(kw, sqrt_d=FA._sqrt_d(d))
        plain_out = FA.flash_attention_kernel(qp, kp, vp, **pkw)
        out, lse = FA.flash_attention_kernel(qp, kp, vp, return_lse=True,
                                             **pkw)
        check(torch.equal(out, plain_out),
              f"flash forward with the LSE pointer differs for {c}")
        _, lse_ref = FAR.flash_attention_ref(q, k, v, return_lse=True, **kw)
        lse_err = float((lse - lse_ref).abs().max())
        lse_worst = max(lse_worst, lse_err)
        check(lse_err <= FLASH_LSE_ATOL, f"flash LSE != plain for {c}: "
                                         f"{lse_err}")
        before = FAB.BWD_LAUNCHES["flash_attention_bwd"]
        got = FAB.flash_attention_bwd_kernel(qp, kp, vp, out, dop, lse, **pkw)
        again = FAB.flash_attention_bwd_kernel(qp, kp, vp, out, dop, lse,
                                               **pkw)
        check(FAB.BWD_LAUNCHES["flash_attention_bwd"] == before + 2,
              "flash_attention_bwd did not count its launches")
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"flash_attention_bwd: two calls differ for {c}")
        del again
        out, got = out[..., :d], [x[..., :d] for x in got]
        if dp != d:
            # the autograd op takes the same route
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            op_out = FAO.flash_attention(*leaves, **kw)
            op_grads = torch.autograd.grad(op_out, leaves, do)
            check(torch.equal(op_out, out) and all(
                torch.equal(x, y) for x, y in zip(op_grads, got)),
                f"ops.flash_attention's padded route differs for {c}")
            del leaves, op_out, op_grads
        plain = FAR.flash_attention_bwd_plain(q, k, v, out, do, lse, **kw)
        auto = plain_flash_grads(torch, FAR, q, k, v, do, **kw)
        torch.cuda.synchronize()
        for name, g, w, a in zip(("dq", "dk", "dv"), got, plain, auto):
            err = float((g.float() - w).abs().max())
            ok, ratio = grad_within(torch, g, w)
            worst, ratio_worst = max(worst, err), max(ratio_worst, ratio)
            check(ok, f"flash_attention_bwd {name} != plain for {c}: "
                      f"{ratio} of the allowance, max abs err {err}")
            # against autograd: the allowance widened by the plain
            # backward's own distance from it
            _, auto_ratio = grad_within(torch, g, a)
            ok, widened = grad_within(torch, g, a, (w - a).abs())
            auto_worst = max(auto_worst, auto_ratio)
            auto_widened = max(auto_widened, widened)
            auto_err = max(auto_err, float((g.float() - a).abs().max()))
            check(ok, f"flash_attention_bwd {name} != autograd for {c}: "
                  f"{widened} of the widened allowance")
        checked.add(flash_key(qp, kp, **kw))
        del plain, auto, got, qp, kp, vp, dop
        if "model" in c:
            ms, host_ms = time_cuda(
                torch, lambda: FAB.flash_attention_bwd_kernel(
                    q, k, v, out, do, lse, **kw), 10)
            plain_ms, _ = time_cuda(
                torch, lambda: FAR.flash_attention_bwd_plain(
                    q, k, v, out, do, lse, **kw), 2)
            lib_ms, refused = sdpa_backward_ms(torch, q, k, v, do, **kw)
            yardstick = {}
            if c["window"] > 0:
                # per pair: SDPA's flash backward on the causal mask alone
                causal_ms, _ = sdpa_backward_ms(torch, q, k, v, do,
                                                causal=c["causal"], window=0)
                yardstick = dict(
                    library_is_causal_ms=causal_ms,
                    library_is_causal_pairs=attn_pairs(s, 0, c["causal"], t)
                    * b * h)
            bound, by = flash_bwd_bound_ms(b, s, h, kvh, d, c["window"],
                                           c["causal"], t)
            timings[c["model"]] = dict(ms=ms, plain_ms=plain_ms,
                                       bound_ms=bound, bound_by=by,
                                       library_ms=lib_ms)
            emit(phase="kernel_timing", kernel="flash_attention_bwd",
                 model=c["model"], B=b, S=s, T=t, H=h, KV=kvh, D=d,
                 window=c["window"], causal=c["causal"], dtype="bfloat16",
                 host_ms_per_call=host_ms,
                 launch_ms=flash_bwd_launch_ms(
                     torch, FAB, (q, k, v, out, do, lse), kw),
                 slices=FAB.slices(b, s, t, h, kvh, d, **kw),
                 unmasked_pairs=attn_pairs(s, c["window"], c["causal"], t)
                 * b * h, **yardstick,
                 library="scaled_dot_product_attention backward ("
                         + ("dense window mask" if c["window"] else
                            "is_causal" if c["causal"] else "no mask")
                         + ", enable_gqa)", library_refused=refused,
                 **timings[c["model"]])
        del q, k, v, do, out, lse, plain_out, lse_ref
        torch.cuda.empty_cache()
    emit(phase="kernel_vs_plain", kernel="flash_attention_bwd",
         cases=len(train_bwd_cases()), max_abs_err=worst,
         max_share_of_allowance=ratio_worst, lse_max_abs_err=lse_worst,
         tolerance=f"{FLASH_BWD_ULPS} bf16 spacings + {FLASH_BWD_REL} x "
                   f"max|grad| + {FLASH_BWD_ATOL}",
         two_calls_bit_equal=True,
         autograd_max_abs_err=auto_err,
         autograd_share_of_allowance=auto_worst,
         autograd_share_of_widened_allowance=auto_widened,
         forward_with_lse_bit_identical=True)
    return worst, checked, timings


def rglru_reverse_vs_plain(torch, RK, RR):
    """The RG-LRU scan's reverse mode: bit-equal to the CPU emulation of its
    chunk carries (`rglru_scan_blocked(..., reverse=True)`), and against
    the plain reverse walk and autograd of the plain forward (db = lam,
    da = lam h_{t-1}) within RGLRU_BWD_REL of the largest value; then its
    time at the training shape (1, 4096, 2560)."""
    gen = torch.Generator(device="cuda").manual_seed(47)
    ch, tile = RK.chunk(), RK.tile()
    worst = worst_abs = 0.0
    shapes = [(1, TRAIN_TOKENS, 2560), (1, PERIOD_TOKENS, 2560),
              (2, 1, 31), (1, ch - 1, 1), (1, ch + 1, 31),
              (4, tile + 1, 64), (2, 1000, 33)]
    for b, s, d in shapes:
        a, _ = rglru_gates(torch, gen, b, s, d)
        x = torch.randn(b, s, d, generator=gen, device="cuda")
        g = torch.randn(b, s, d, generator=gen, device="cuda")
        lam = RK.rglru_scan_kernel(a, g, reverse=True)
        blocked = RR.rglru_scan_blocked(a, g, ch, reverse=True)
        plain = RR.rglru_scan_bwd_plain(a, g)
        al, bl = a.clone().requires_grad_(), x.clone().requires_grad_()
        h = RR.rglru_scan_ref(al, bl)
        da, db = torch.autograd.grad(h, (al, bl), g)
        h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)
        torch.cuda.synchronize()
        check(torch.equal(lam, blocked),
              f"rglru_scan reverse != rglru_scan_blocked at {(b, s, d)}")
        for name, got, want in (("lam", lam, plain), ("db", lam, db),
                                ("da", lam * h_prev.detach(), da)):
            scale = max(1.0, float(want.abs().max()))
            err = float((got - want).abs().max())
            worst, worst_abs = max(worst, err / scale), max(worst_abs, err)
            check(err <= RGLRU_BWD_REL * scale,
                  f"rglru_scan reverse {name} at {(b, s, d)}: {err} of "
                  f"{scale}")
    emit(phase="kernel_vs_plain", kernel="rglru_scan_reverse", chunk=ch,
         tile=tile, cases=len(shapes), max_abs_err=worst_abs,
         max_err_over_largest=worst, equal_to_blocked=True)
    b, s, d = 1, TRAIN_TOKENS, 2560
    a, g = rglru_gates(torch, gen, b, s, d)
    ms, host_ms = time_cuda(torch, lambda: RK.rglru_scan_kernel(
        a, g, reverse=True), 50)
    plain_ms, _ = time_cuda(torch, lambda: RR.rglru_scan_bwd_plain(a, g), 3)
    bound, by = bound_ms(b * s * d, RGLRU_BYTES_PER_ITEM, RGLRU_OPS_PER_ITEM)
    timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                  library_ms=None)
    emit(phase="kernel_timing", kernel="rglru_scan_reverse", B=b, S=s, D=d,
         host_ms_per_call=host_ms, library="none: no PyTorch call computes "
         "a linear recurrence", **timing)
    return worst_abs, timing


def train_counts(FA, RK):
    from repro_torch.kernels.flash_attention import kernel_bwd as FAB
    from repro_torch.kernels.ssd_chunk import kernel as SK
    from repro_torch.kernels.ssd_chunk import kernel_bwd as SKB

    return {"flash_attention_tc": FA.LAUNCHES["flash_attention_tc"],
            "flash_attention": FA.LAUNCHES["flash_attention"],
            "flash_attention_bwd": FAB.BWD_LAUNCHES["flash_attention_bwd"],
            "rglru_scan": RK.LAUNCHES["rglru_scan"],
            "rglru_scan_reverse": RK.REVERSE_LAUNCHES["rglru_scan_reverse"],
            "ssd_chunk_tc": SK.LAUNCHES["ssd_chunk_tc"],
            "ssd_chunk": SK.LAUNCHES["ssd_chunk"],
            "ssd_chunk_bwd": SKB.BWD_LAUNCHES["ssd_chunk_bwd"]}


def zero_train_counts(FA, RK):
    from repro_torch.kernels.flash_attention import kernel_bwd as FAB
    from repro_torch.kernels.ssd_chunk import kernel as SK
    from repro_torch.kernels.ssd_chunk import kernel_bwd as SKB

    for counter in (FA.LAUNCHES, FAB.BWD_LAUNCHES, RK.LAUNCHES,
                    RK.REVERSE_LAUNCHES, SK.LAUNCHES, SKB.BWD_LAUNCHES):
        for name in counter:
            counter[name] = 0


def expected_train_counts(cfg, steps):
    """Launches of ``steps`` train steps: each layer runs forward twice
    (once more under the checkpoint's recompute) and backward once; an
    ``ssd`` layer through the tensor-core forward and the backward kernel,
    never the CUDA-core forward."""
    from repro_torch.models import transformer as TF

    kinds = [key.split("_", 1)[1] for key, _ in TF.layer_keys(cfg)]
    attn = sum(k in TF.ATTN_KINDS for k in kinds) * steps
    rec = kinds.count("rglru") * steps
    ssd = kinds.count("ssd") * steps
    return {"flash_attention_tc": 2 * attn, "flash_attention": 0,
            "flash_attention_bwd": attn, "rglru_scan": 2 * rec,
            "rglru_scan_reverse": rec, "ssd_chunk_tc": 2 * ssd,
            "ssd_chunk": 0, "ssd_chunk_bwd": ssd}


def period_card_vs_cpu(torch, FA, RK, arch=MODEL_ARCH):
    """One period of ``arch`` at full width (recurrentgemma-2b: rglru,
    rglru, attn_local at d 2560, the embedding and tied head at vocab
    256,000; mamba2-1.3b: one ssd layer at d 2048, 64 heads x 64, state 128,
    vocab 50,280), its loss and every gradient on PERIOD_TOKENS tokens, on
    the card (the kernels) and on the host CPU (the plain versions), from
    the same weights: the loss within MODEL_TOL, each leaf within
    PERIOD_GRAD_REL in relative L2 norm, and every card gradient finite and
    not all zero (a kernel autograd did not see would leave its inputs'
    gradients zero or missing).  Then the card's step once more under the
    profiler, its peak memory read around the first."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models import transformer as TF

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=len(full.pattern))
    cpu = TF.init_params(cfg, torch.Generator().manual_seed(41),
                         device="cpu")
    cpu.requires_grad_(True)
    card = copy.deepcopy(cpu).to("cuda")
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=PERIOD_TOKENS,
                                   global_batch=1, seed=5)).batch(0)

    def run(model, dev):
        t0 = time.perf_counter()
        loss, _ = TF.loss_fn(model, {k: v.to(dev) for k, v in batch.items()})
        loss.backward()
        value = float(loss.detach())
        return value, time.perf_counter() - t0

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_train_counts(FA, RK)
    card_loss, card_s = run(card, "cuda")
    launches = train_counts(FA, RK)
    peak = torch.cuda.max_memory_allocated()
    want = expected_train_counts(cfg, 1)
    check(launches == want,
          f"{arch}: one period's train step launched {launches}, expected "
          f"{want}")
    cpu_loss, cpu_s = run(cpu, "cpu")
    check(abs(card_loss - cpu_loss) <= MODEL_TOL,
          f"period loss on the card {card_loss} vs CPU {cpu_loss}")
    leaves, worst = 0, 0.0
    for (name, pc), (_, pg) in zip(card.named_parameters(),
                                   cpu.named_parameters()):
        check(pc.grad is not None, f"{name} has no gradient on the card")
        gcard, gcpu = pc.grad.float().cpu(), pg.grad.float()
        check(bool(torch.isfinite(gcard).all()) and bool(gcard.ne(0).any()),
              f"{name}: card gradient not finite or all zero")
        rel = float((gcard - gcpu).norm() / gcpu.norm().clamp_min(1e-30))
        worst = max(worst, rel)
        check(rel <= PERIOD_GRAD_REL,
              f"{name}: card gradient {rel} from the CPU's (relative L2)")
        leaves += 1
    card.zero_grad(set_to_none=True)
    before = train_counts(FA, RK)
    prof = profile_device(torch, lambda: run(card, "cuda"))
    launches = {n: c + train_counts(FA, RK)[n] - before[n]
                for n, c in launches.items()}
    emit(phase="train_period_card_vs_cpu", arch=arch, tokens=PERIOD_TOKENS,
         layers=[k for k, _ in card.keys], card_loss=card_loss,
         cpu_loss=cpu_loss, leaves=leaves, worst_leaf_rel_l2=worst,
         card_host_s=card_s, cpu_host_s=cpu_s, peak_bytes=peak,
         cpu_threads=torch.get_num_threads(), device_profile=prof, **{
             f"{n}_launches": c for n, c in launches.items()})
    del card, cpu
    return launches


def loss_rule(losses):
    """The 10-step run's rule, fixed before the run: every loss finite and
    the last at least TRAIN_LOSS_DROP below the first."""
    return all(l == l and abs(l) != float("inf") for l in losses) and \
        losses[-1] <= losses[0] - TRAIN_LOSS_DROP


def train_full_width(torch, FA, RK, lr, profile=True, arch=MODEL_ARCH,
                     smoke=False, batch=(1, TRAIN_TOKENS),
                     steps=TRAIN_STEPS):
    """``arch`` at full width (recurrentgemma-2b: 26 layers, vocab 256,000;
    mamba2-1.3b: 48 ssd layers, vocab 50,280), or its smoke config,
    `Trainer.fit` for ``steps`` steps of ``batch`` = (rows, tokens) from
    `SyntheticLM`, at peak lr ``lr``: per-step loss, grad_norm and host ms,
    memory after the state is made and at the peak, each kernel
    direction's launches against the layers times the steps (with the
    recompute), and the device profile of the step after the first."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.runtime.trainer import TrainConfig, Trainer

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = (get_smoke_config if smoke else get_config)(arch)
    trainer = Trainer(cfg, TrainConfig(
        steps=steps, peak_lr=lr, warmup_steps=TRAIN_WARMUP,
        log_every=steps, async_ckpt=False), device="cuda")
    src = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=batch[1],
                                 global_batch=batch[0]))
    t0 = time.perf_counter()
    model, opt = trainer.init_state(0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_bytes = torch.cuda.memory_allocated()
    step_fn, profiled = trainer.step_fn, {}

    def step(*args):
        if profile and len(profiled) == 1 and "profile" not in profiled:
            out = {}
            profiled["profile"] = profile_device(
                torch, lambda: out.update(r=step_fn(*args)))
            return out["r"]
        profiled.setdefault("first", True)
        return step_fn(*args)

    trainer.step_fn = step
    zero_train_counts(FA, RK)
    printed, _, host_s = printout(trainer.fit, src, model, opt)
    launches = train_counts(FA, RK)
    want = expected_train_counts(cfg, steps)
    check(launches == want,
          f"{cfg.name}: {steps} train steps launched {launches}, expected "
          f"{want}")
    log = trainer.metrics_log
    out = dict(config=cfg.name, batch_rows_tokens=list(batch), lr=lr,
               losses=[m["loss"] for m in log],
               grad_norms=[m["grad_norm"] for m in log],
               step_host_ms=[m["step_time_s"] * 1e3 for m in log],
               lrs=[m["lr"] for m in log], init_s=init_s, host_s=host_s,
               state_bytes=state_bytes,
               peak_bytes=torch.cuda.max_memory_allocated(),
               params=sum(p.numel() for p in model.parameters()),
               profiled_step=1 if profile else None,
               device_profile=profiled.get("profile"),
               printout=printed.splitlines(), launches=launches)
    del trainer, model, opt, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return out


def param_sha256(torch, model, opt):
    """sha256 over the parameters' and the AdamW master weights' bytes, in
    order."""
    h = hashlib.sha256()
    for x in (*model.parameters(), *opt.master.values()):
        h.update(x.detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


class StopAt(Exception):
    pass


class CutSource:
    """A data source that raises `StopAt` when asked for step ``cut``: the
    run it feeds stops there, as a killed job would."""

    def __init__(self, src, cut):
        self.src, self.cut = src, cut

    def batch(self, step):
        if step == self.cut:
            raise StopAt(step)
        return self.src.batch(step)


def resume_on_card(torch, FA):
    """The 100m preset on the card: 4 uninterrupted steps, against 2 steps
    stopped after the checkpoint at step 2 and 2 more in a fresh
    `Trainer` that resumes from it (in a temporary directory, removed
    afterwards): the losses and the parameters' and master weights'
    sha256 equal bit for bit."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.train import PRESET_100M
    from repro_torch.runtime.trainer import TrainConfig, Trainer

    src = SyntheticLM(DataConfig(vocab=PRESET_100M.vocab,
                                 seq_len=TRAIN_100M_SEQ,
                                 global_batch=TRAIN_100M_BATCH))

    def trainer(ckpt_dir):
        return Trainer(PRESET_100M, TrainConfig(
            steps=4, peak_lr=1e-3, warmup_steps=1, ckpt_dir=ckpt_dir,
            ckpt_every=2, async_ckpt=False, log_every=100), device="cuda")

    t0 = time.perf_counter()
    whole = trainer("")
    with contextlib.redirect_stdout(io.StringIO()):
        model, opt = whole.fit(src)
    want_losses = [m["loss"] for m in whole.metrics_log]
    want_sha = param_sha256(torch, model, opt)
    del model, opt
    with tempfile.TemporaryDirectory() as d:
        first = trainer(d)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                first.fit(CutSource(src, 2))
        except StopAt:
            pass
        check(ckpt.latest_step(d) == 2,
              f"no checkpoint at step 2: {ckpt.latest_step(d)}")
        second = trainer(d)
        with contextlib.redirect_stdout(io.StringIO()):
            model, opt = second.fit(src)
        got_losses = [m["loss"]
                      for m in first.metrics_log + second.metrics_log]
        got_sha = param_sha256(torch, model, opt)
    check(got_losses == want_losses and got_sha == want_sha,
          f"resumed run {got_losses} {got_sha} != whole run {want_losses} "
          f"{want_sha}")
    del model, opt
    emit(phase="train_resume", preset=PRESET_100M.name,
         batch=TRAIN_100M_BATCH, seq=TRAIN_100M_SEQ, losses=want_losses,
         resumed_at=2, params_sha256=want_sha, bit_equal=True,
         host_s=time.perf_counter() - t0)


def rel_l2(torch, got, want):
    """||got - want|| / ||want|| in float64 (the difference's norm where
    want is all zero)."""
    got, want = got.double(), want.double()
    norm = float(want.norm())
    diff = float((got - want).norm())
    return diff / norm if norm > 0 else diff


def ssd_bwd_bound_ms(b, s, h, p, n, chunk=128):
    """(least time on the card in ms, what bounds it, bytes, flops) for one
    SSD backward call: x, dy and dx (B, S, H, P) and b and c (B, S, N) in
    bf16, db and dc float32 (as the kernel returns them), dt and ddt float32
    and dstate (B, H, P, N) float32, each moved once at the HBM rate;
    against the products at one bf16 part each on the tensor cores: per
    head dM = dY x^T and M^T dY (2 Q^2 P each over whole chunks, as
    `ssd_bound_ms` counts the forward), and B R^T, x R, dY S, C S^T and the
    adjoint's update (2 Q P N each); per batch row and chunk G, dG^T C and
    dG B with dG summed over the heads first (2 Q^2 N each)."""
    nbytes = (3 * b * s * h * p * 2 + 2 * b * s * n * 2 + 2 * b * s * n * 4
              + 2 * b * s * h * 4 + 4 * b * h * p * n + 8 * h)
    lens = [min(chunk, s - t) for t in range(0, s, chunk)]
    sq = sum(x * x for x in lens)
    flops = 2 * b * h * (2 * p * sq + 5 * p * n * s) + 2 * b * 3 * n * sq
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / TENSOR_BF16_FLOPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations"), nbytes, flops


def ssd_bwd_launch_ms(torch, SKB, args, calls=5, **kw):
    """Device ms per call of each of the SSD backward's three launches
    (walk, grads, sum; the walk's status-word memset counts with the walk):
    CUDA events the wrapper records before its first launch and after each,
    over ``calls`` calls queued behind a device spin."""
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
             for _ in range(calls)]
    for row in marks:
        for e in row:
            e.record()  # an event exists from its first record
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    for row in marks:
        SKB.ssd_chunk_bwd_kernel(*args, marks=row, **kw)
    torch.cuda.synchronize()
    return {name: sum(row[i].elapsed_time(row[i + 1]) for row in marks)
            / calls for i, name in enumerate(("walk", "grads", "sum"))}


def ssd_bwd_inputs(torch, gen, b, s, h, p, n, model_like):
    """bf16 x, b, c and dy, float32 dt, a_log and dstate on the card
    (`ssd_inputs`' families)."""
    x, dt, a_log, bm, cm = (t.to(torch.bfloat16) if i in (0, 3, 4) else t
                            for i, t in enumerate(ssd_inputs(
                                torch, gen, b, s, h, p, n, model_like)))
    dy = torch.randn(b, s, h, p, generator=gen,
                     device="cuda").to(torch.bfloat16)
    dstate = torch.randn(b, h, p, n, generator=gen, device="cuda")
    return x, dt, a_log, bm, cm, dy, dstate


def ssd_bwd_vs_plain(torch, SK, SKB, SR):
    """The SSD backward kernel against the plain backward in float64 on the
    same bf16 values, each gradient within SSD_BWD_TOL in relative L2: S in
    SSD_BWD_S at B 2 with the smoke config's (H, P, N) and full width's
    (SSD_BWD_DIMS), and mamba2-1.3b's layer at B 2 and S 4,096; both input
    families; 1, 2 and 3 segments a head for the adjoint walk (at most one
    a chunk); the default group of heads for the gradient launch and, at S
    129 and 421, groups of 3 (the last of 4 heads ragged); a nonzero dstate
    (and none at S 421); every call twice, bit-equal, one count a call.
    The forward with its chunk states (the training path) gives y and the
    final state bit-equal to the served call.  Then the kernels' time at
    mamba2-1.3b's 4,096-token layer (B 1, H 64) by launch (walk, grads,
    sum), by the walk's segment count and by group size, and at 16,384
    tokens, against the bound and the plain backward's time, the forward's
    cost of writing the chunk states, and a profile of ten calls.  Returns
    (the worst max abs error, the timing, the worst shares)."""
    gen = torch.Generator(device="cuda").manual_seed(53)
    names = tuple(SSD_BWD_TOL)
    cases = [(2, s, h, p, n) for h, p, n in SSD_BWD_DIMS for s in SSD_BWD_S]
    cases.append((2, 4096, 64, 64, 128))
    worst, worst_abs, failed, calls = {}, 0.0, [], 0
    for b, s, h, p, n in cases:
        for model_like in (False, True):
            x, dt, a_log, bm, cm, dy, dstate = ssd_bwd_inputs(
                torch, gen, b, s, h, p, n, model_like)
            y, state, states = SK.ssd_chunk_kernel(x, dt, a_log, bm, cm,
                                                   return_states=True)
            y0, state0 = SK.ssd_chunk_kernel(x, dt, a_log, bm, cm)
            fwd_same = bool(torch.equal(y, y0) and torch.equal(state, state0))
            seeds = [dstate, None] if (s, p) == (421, 16) else [dstate]
            n_chunks = -(-s // SK.CHUNK)
            groups = [None, 3] if s in (129, 421) and h == 4 else [None]
            for seed in seeds:
                want = SR.ssd_chunk_bwd_plain(*(
                    t.double() for t in (x, dt, a_log, bm, cm, dy)),
                    None if seed is None else seed.double())
                for seg, grp in ((k, g) for k in sorted(
                        {min(k, n_chunks) for k in (1, 2, 3)})
                        for g in groups):
                    before = SKB.BWD_LAUNCHES["ssd_chunk_bwd"]
                    got = SKB.ssd_chunk_bwd_kernel(x, dt, a_log, bm, cm, dy,
                                                   seed, states, segments=seg,
                                                   group=grp)
                    again = SKB.ssd_chunk_bwd_kernel(
                        x, dt, a_log, bm, cm, dy, seed, states, segments=seg,
                        group=grp)
                    counted = SKB.BWD_LAUNCHES["ssd_chunk_bwd"] - before == 2
                    torch.cuda.synchronize()
                    calls += 2
                    same = all(torch.equal(u, v) for u, v in zip(got, again))
                    finite = all(bool(torch.isfinite(g).all()) for g in got)
                    share = {k: rel_l2(torch, g, w) / SSD_BWD_TOL[k]
                             for k, g, w in zip(names, got, want)}
                    err = max(float((g.double() - w).abs().max())
                              for g, w in zip(got, want))
                    worst_abs = max(worst_abs, err)
                    fam = worst.setdefault(
                        "model" if model_like else "reference",
                        dict.fromkeys(names, 0.0))
                    for k in names:
                        fam[k] = max(fam[k], share[k])
                    if not (max(share.values()) <= 1 and same and counted
                            and finite and fwd_same
                            and got[0].dtype == torch.bfloat16):
                        failed.append(dict(
                            shape=[b, s, h, p, n], model_like=model_like,
                            segments=seg, group=grp, dstate=seed is not None,
                            shares=share, two_calls_bit_equal=same,
                            counted=counted, finite=finite,
                            forward_with_states_bit_equal=fwd_same))
            del x, dy, states, want, got, again
    for fam, share in sorted(worst.items()):
        emit(phase="kernel_vs_plain", kernel="ssd_chunk_bwd", family=fam,
             share_of_tolerance=share)
    for f in failed:
        emit(phase="kernel_vs_plain_failed", kernel="ssd_chunk_bwd", **f)
    check(not failed, f"ssd_chunk_bwd != plain backward in {len(failed)} "
                      f"cases")
    share_worst = max(max(v.values()) for v in worst.values())
    emit(phase="kernel_vs_plain", kernel="ssd_chunk_bwd", cases=len(cases),
         calls=calls, max_abs_err=worst_abs,
         max_share_of_tolerance=share_worst,
         tolerance={k: f"{v} relative L2" for k, v in SSD_BWD_TOL.items()},
         two_calls_bit_equal=True, forward_with_states_bit_equal=True)

    b, s, h, p, n = SSD_SHAPE
    x, dt, a_log, bm, cm, dy, dstate = ssd_bwd_inputs(torch, gen, b, s, h, p,
                                                      n, True)
    _, _, states = SK.ssd_chunk_kernel(x, dt, a_log, bm, cm,
                                       return_states=True)

    def call(seg=None):
        return SKB.ssd_chunk_bwd_kernel(x, dt, a_log, bm, cm, dy, dstate,
                                        states, segments=seg)

    ms, host_ms = time_cuda(torch, call, 20)
    plain_ms, _ = time_cuda(torch, lambda: SR.ssd_chunk_bwd_plain(
        x, dt, a_log, bm, cm, dy, dstate), 3)
    bound, by, nbytes, flops = ssd_bwd_bound_ms(b, s, h, p, n)
    timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                  library_ms=None)
    extra = dict(
        segments=SKB.walk_segments(b, h, s), group=SKB.head_group(b, h, s),
        launch_ms=ssd_bwd_launch_ms(
            torch, SKB, (x, dt, a_log, bm, cm, dy, dstate, states)),
        ms_by_segments={seg: time_cuda(torch, lambda: call(seg), 20)[0]
                        for seg in (1, 2, 4)},
        ms_by_group={grp: time_cuda(torch, lambda: SKB.ssd_chunk_bwd_kernel(
            x, dt, a_log, bm, cm, dy, dstate, states, group=grp), 20)[0]
                     for grp in (2, 4, 8)},
        forward_with_states_ms=time_cuda(torch, lambda: SK.ssd_chunk_kernel(
            x, dt, a_log, bm, cm, return_states=True), 20)[0],
        forward_ms=time_cuda(torch, lambda: SK.ssd_chunk_kernel(
            x, dt, a_log, bm, cm), 20)[0])
    prof = profile_device(torch, lambda: [call() for _ in range(10)])
    del x, dy, states
    long = ssd_bwd_inputs(torch, gen, b, 16_384, h, p, n, True)
    _, _, states = SK.ssd_chunk_kernel(*long[:5], return_states=True)
    extra["segments_s16384"] = SKB.walk_segments(b, h, 16_384)
    extra["ms_s16384"], _ = time_cuda(torch, lambda: SKB.ssd_chunk_bwd_kernel(
        *long, states), 10)
    extra["launch_ms_s16384"] = ssd_bwd_launch_ms(torch, SKB,
                                                  (*long, states))
    extra["bound_ms_s16384"] = ssd_bwd_bound_ms(b, 16_384, h, p, n)[0]
    del long, states
    emit(phase="kernel_timing", kernel="ssd_chunk_bwd", B=b, S=s, H=h, P=p,
         N=n, dtype="bf16 x, b, c, dy, dx; float32 dt, a_log, dstate, ddt, "
         "da_log, db, dc", host_ms_per_call=host_ms, bytes=nbytes,
         flops=flops, library="none: no PyTorch call computes an SSD chunk "
         "scan's gradient", **timing, **extra)
    emit(phase="device_profile", workload="ssd_chunk_bwd_x10", **prof)
    # the profiler has recorded no device activity at this point of the
    # script in some runs (as for the flash backward, PR 30); where it
    # does, the call is its three kernels (walk, grads, sum) and a memset
    check(not prof["top_kernels"] or (
        sum(k["calls"] for k in prof["top_kernels"]
            if "ssd_bwd" in k["name"]) == 30
        and all("ssd_bwd" in k["name"] or k["name"].startswith("Memset")
                for k in prof["top_kernels"])),
          f"ssd_chunk_bwd is not three kernels a call: "
          f"{prof['top_kernels']}")
    return worst_abs, timing, worst


def ssd_training_on_card(torch, FA, RK):
    """mamba2-1.3b trains on the card: (a) its smoke config for
    SSD_SMOKE_STEPS steps of SSD_SMOKE_BATCH, the losses finite and the last
    below the first; (b) one full-width period (an ssd layer, the embedding
    and the head) on PERIOD_TOKENS tokens against the CPU; (c) TRAIN_STEPS
    full-width steps of one row of TRAIN_TOKENS tokens, every loss and
    gradient norm finite, the loss rule's verdict recorded.  Each run's counts are set to 0 before it and read after it
    (every ssd layer through the tensor-core forward twice a step and the
    backward kernel once, never the CUDA-core forward); each records its
    peak memory, host ms a step and the device profile of one step.
    Returns the launches of the three runs."""
    total = {}

    def add(launches):
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n

    smoke = train_full_width(torch, FA, RK, TRAIN_LR, arch=MAMBA_ARCH,
                             smoke=True, batch=SSD_SMOKE_BATCH,
                             steps=SSD_SMOKE_STEPS)
    add(smoke.pop("launches"))
    losses = smoke["losses"]
    emit(phase="train_smoke_ssd", arch=MAMBA_ARCH, **smoke)
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"mamba2's smoke config does not train on the card: {losses}")
    add(period_card_vs_cpu(torch, FA, RK, arch=MAMBA_ARCH))
    run = train_full_width(torch, FA, RK, TRAIN_LR, arch=MAMBA_ARCH)
    add(run.pop("launches"))
    finite = all(math.isfinite(x) for x in run["losses"] + run["grad_norms"])
    # recurrentgemma-2b's loss rule is recorded, not required: mamba2-1.3b
    # from seeded random weights does not learn that fast at this lr (the
    # port's CPU path at two full-width layers and 256 tokens: 11.34 ->
    # 11.14 in 10 steps, PERF.md); the step's correctness is the period's
    # gradients against the CPU
    emit(phase="train_full_width", arch=MAMBA_ARCH, tokens=TRAIN_TOKENS,
         steps=TRAIN_STEPS, loss_drop_min=TRAIN_LOSS_DROP,
         meets_loss_rule=loss_rule(run["losses"]), finite=finite, **run)
    check(finite, f"mamba2's {TRAIN_STEPS}-step run: a loss or gradient "
                  f"norm is not finite: {run['losses']} {run['grad_norms']}")
    return total


def small_training_on_card(torch, FA, RK):
    """The small training drivers on the card, as a user runs them:
    `studies.quickstart.main("cuda")` (its fabric question, 30 steps of the
    smoke llama, the autotuner) and `studies.train_small_lm` with ``--preset
    smoke`` for SMALL_TRAIN_STEPS steps into a fresh checkpoint directory.
    Their llama has head dim 8, which the autograd op pads to 16 for the
    tensor-core forward and backward kernels.  Each run's counts are set to
    0 before it and read after it: each must launch both flash kernels and
    not the CUDA-core one, and finish with finite losses, the last below
    the first (each driver returns its trainer).  Returns the launches of
    both runs."""
    from repro_torch.studies import quickstart, train_small_lm

    total = {}
    for name in ("quickstart", "train_small_lm"):
        zero_train_counts(FA, RK)
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                tempfile.TemporaryDirectory() as ckpt:
            if name == "quickstart":
                trainer = quickstart.main("cuda")
            else:
                trainer = train_small_lm.main([
                    "--preset", "smoke", "--steps", str(SMALL_TRAIN_STEPS),
                    "--ckpt-dir", ckpt, "--device", "cuda"])
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        launches = train_counts(FA, RK)
        losses = [m["loss"] for m in trainer.metrics_log]
        emit(phase="small_training", driver=name, arch=trainer.cfg.name,
             head_dim=trainer.cfg.head_dim, steps=len(losses),
             losses=losses, host_s=host_s, launches=launches,
             printed_lines=len(out.getvalue().splitlines()))
        check(len(losses) > 1 and all(math.isfinite(x) for x in losses)
              and losses[-1] < losses[0],
              f"{name}: the losses do not fall on the card: {losses}")
        check(launches["flash_attention_tc"] > 0
              and launches["flash_attention_bwd"] > 0
              and launches["flash_attention"] == 0,
              f"{name}: the flash launches {launches}")
        for n, c in launches.items():
            total[n] = total.get(n, 0) + c
    return total


def phase_training(torch, FA, FAR, RK, RR, SK, SKB, SR):
    """Phase 5i: training on the card, after phase 5h has freed its models.
    The flash backward, the RG-LRU scan's reverse mode and the SSD backward
    against their plain versions (and timed); one full-width
    recurrentgemma-2b period on the card against the CPU; TRAIN_STEPS
    full-width steps held to the loss rule, and the same at lr 0, which the
    rule must refuse; the 100m preset's checkpoint resume, bit for bit;
    `studies.quickstart` and the smoke `studies.train_small_lm` (head dim 8
    through the padded route); mamba2-1.3b's smoke config, full-width
    period and full-width steps (`ssd_training_on_card`).  Returns (the
    training paths' launches, worst errors, timings)."""
    gc.collect()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_allocated()
    emit(phase="training_start", allocated_bytes=start)
    check(start < FAMILY_START_BYTES,
          f"{start} bytes still allocated when phase 5i starts")
    t0 = time.perf_counter()
    bwd_err, bwd_checked, bwd_timings = flash_bwd_vs_plain(torch, FA, FAR)
    rev_err, rev_timing = rglru_reverse_vs_plain(torch, RK, RR)
    ssd_err, ssd_timing, ssd_shares = ssd_bwd_vs_plain(torch, SK, SKB, SR)
    kernels_s = time.perf_counter() - t0

    total = {}

    def add(launches):
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n

    add(period_card_vs_cpu(torch, FA, RK))
    run = train_full_width(torch, FA, RK, TRAIN_LR)
    add(run.pop("launches"))
    planted = train_full_width(torch, FA, RK, 0.0, profile=False)
    add(planted.pop("launches"))
    ok, refused = loss_rule(run["losses"]), not loss_rule(planted["losses"])
    emit(phase="train_full_width", arch=MODEL_ARCH, tokens=TRAIN_TOKENS,
         steps=TRAIN_STEPS, loss_drop_min=TRAIN_LOSS_DROP,
         meets_loss_rule=ok, **run)
    emit(phase="train_full_width_lr0", arch=MODEL_ARCH,
         refused_by_loss_rule=refused,
         **{k: v for k, v in planted.items() if k != "device_profile"})
    check(ok, f"the {TRAIN_STEPS}-step run misses the loss rule: "
              f"{run['losses']}")
    check(refused, f"the loss rule passed the lr-0 run: {planted['losses']}")
    zero_train_counts(FA, RK)
    resume_on_card(torch, FA)
    add(train_counts(FA, RK))
    add(small_training_on_card(torch, FA, RK))
    add(ssd_training_on_card(torch, FA, RK))
    emit(phase="training", host_s=time.perf_counter() - t0,
         kernel_checks_s=kernels_s, **{f"{n}_launches": c
                                       for n, c in total.items()})
    return (total, bwd_err, bwd_checked, bwd_timings, rev_err, rev_timing,
            ssd_err, ssd_timing, ssd_shares)


# ---------------------------------------------------------------------------
# phase 5j: the production-mesh layer
# ---------------------------------------------------------------------------

DRYRUN_HOST_SCRIPT = r"""
import json, sys, time
import torch
torch.set_num_threads(1)
from repro_torch.launch import dryrun, hillclimb

dry, log, cell = sys.argv[1:4]
for arch, shape, _ in hillclimb.CELLS.values():
    t0 = time.perf_counter()
    dryrun.main(["--arch", arch, "--shape", shape, "--out", dry])
    print("HOST_S", json.dumps({"step": f"dryrun {arch} {shape}",
                                "host_s": time.perf_counter() - t0}),
          flush=True)
t0 = time.perf_counter()
hillclimb.main(["--cell", cell, "--out", log])
print("HOST_S", json.dumps({"step": f"hillclimb --cell {cell}",
                            "host_s": time.perf_counter() - t0}), flush=True)
"""


def start_dryrun_host_work(tmp):
    """Start the dry-run stand-in's host work for phase 5j in a subprocess:
    the hillclimb cells' records (`launch.dryrun`, single pod) and
    `launch.hillclimb --cell HILLCLIMB_CELL`, into ``tmp``.  Its meta
    counts are CPU work only, so CUDA is hidden from it and it runs while
    phase 5i trains on the card; the process is killed when the script
    exits.
    Returns (the process, the records' path, the log's path)."""
    import atexit

    dry, log = os.path.join(tmp, "torch_dryrun.json"), \
        os.path.join(tmp, "torch_perf_log.json")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(
        [sys.executable, "-c", DRYRUN_HOST_SCRIPT, dry, log, HILLCLIMB_CELL],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=tmp)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, dry, log


def pipeline_on_card(np, torch, FA, RK):
    """Phase 5j (a): `parallel.pipeline_par.pipeline_forward` over
    recurrentgemma-2b at its published width (weights from the seeded
    generator, as phase 8 draws them): PIPE_STAGES stages of PIPE_PERIODS
    periods each, PIPE_MICROBATCHES microbatches of 1 x PIPE_TOKENS
    embedded tokens, in the forward's mode.  The launch counts are set to 0
    just before the pipeline and read just after; then the output is held
    bit for bit against each microbatch passed through the stages in order,
    and within MODEL_TOL of the layers applied to the whole batch.  Returns
    the pipeline's launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as TF
    from repro_torch.parallel.pipeline_par import pipeline_forward

    cfg = get_config(MODEL_ARCH)
    per = PIPE_PERIODS * len(cfg.pattern)
    model = TF.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    layers = list(model.layers)[:PIPE_STAGES * per]
    check(all(period is not None
              for _, period in model.keys[:PIPE_STAGES * per]),
          "the pipeline's layers are not all period layers")
    stages = [layers[i * per:(i + 1) * per] for i in range(PIPE_STAGES)]
    kinds = [key.split("_", 1)[1] for key, _ in model.keys[:len(layers)]]
    tokens = torch.as_tensor(np.random.default_rng(35).integers(
        0, cfg.vocab, (PIPE_MICROBATCHES, PIPE_TOKENS)), device="cuda")

    def stage_fn(blocks, h):
        pos = torch.arange(h.shape[1], device=h.device)[None].expand(
            h.shape[:2])
        for blk in blocks:
            h, _ = TF._apply_block(blk, h, pos, cfg, mode="forward")
        return h

    mesh = make_mesh((PIPE_STAGES,), ("stage",))
    with torch.no_grad():
        x = TF.embed(model.embed.tok, tokens)
        for counter in (FA.LAUNCHES, RK.LAUNCHES):
            for name in counter:
                counter[name] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipeline_forward(stage_fn, stages, x, mesh=mesh,
                               n_microbatches=PIPE_MICROBATCHES)
        torch.cuda.synchronize()
        pipe_s = time.perf_counter() - t0
        launches = {"flash_attention_tc": FA.LAUNCHES["flash_attention_tc"],
                    "flash_attention": FA.LAUNCHES["flash_attention"],
                    "rglru_scan": RK.LAUNCHES["rglru_scan"]}
        want = {"flash_attention_tc": kinds.count("attn_local")
                * PIPE_MICROBATCHES, "flash_attention": 0,
                "rglru_scan": kinds.count("rglru") * PIPE_MICROBATCHES}
        check(launches == want, f"the pipeline's launches {launches}, "
                                f"expected {want}")
        seq = []
        for i in range(PIPE_MICROBATCHES):
            h = x[i:i + 1]
            for blocks in stages:
                h = stage_fn(blocks, h)
            seq.append(h)
        seq = torch.cat(seq)
        check(torch.equal(out, seq), "the pipeline differs from each "
                                     "microbatch through the stages in order")
        whole = x
        for blocks in stages:
            whole = stage_fn(blocks, whole)
        err = float((out.float() - whole.float()).abs().max())
        check(tuple(out.shape) == tuple(x.shape)
              and bool(torch.isfinite(out.float()).all())
              and torch.allclose(out.float(), whole.float(), atol=MODEL_TOL,
                                 rtol=MODEL_TOL),
              f"the pipeline against the whole batch: max abs err {err}")
    emit(phase="pipeline", arch=cfg.name, stages=PIPE_STAGES,
         layers_per_stage=per, microbatches=PIPE_MICROBATCHES,
         tokens=PIPE_TOKENS, shape=list(out.shape), host_s=pipe_s,
         bit_equal_per_microbatch=True, max_abs_err_vs_whole_batch=err,
         max_abs_value=float(whole.float().abs().max()),
         **{f"{n}_launches": c for n, c in launches.items()})
    del model, layers, stages, x, out, seq, whole
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def dryrun_on_card(torch, K, host):
    """Phase 5j (b): join the dry-run's host subprocess
    (`start_dryrun_host_work`), print its steps' host seconds, then run the
    roofline CLI over its records with the fabric cross-check on the card
    (the serve_round count set to 0 just before and read just after), and
    hold the cross-check and the roofline rows against the same calls on
    the port's CPU path; check the hillclimb log.  Returns the cross-check's
    serve_round launches."""
    from repro_torch.configs import ARCH_IDS, SHAPES
    from repro_torch.launch import hillclimb, roofline

    proc, dry, log = host
    t0 = time.perf_counter()
    try:
        out, err = proc.communicate(timeout=DRYRUN_WAIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    wait_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"the dry-run subprocess failed "
                                f"({proc.returncode}): {err[-2000:]}")
    for line in out.splitlines():
        if line.startswith("HOST_S "):
            emit(phase="dryrun_host", **json.loads(line.split(" ", 1)[1]))
    with open(dry) as f:
        recs = json.load(f)
    cells = [(arch, shape) for arch, shape, _ in hillclimb.CELLS.values()]
    for arch, shape in cells:
        rec = recs[f"{arch}|{shape}|single"]
        check(rec["status"] == "ok" and rec["flops_once"] > 0
              and rec["bytes_once"] > 0
              and rec["memory"]["peak_per_device_gib"] > 0,
              f"dry-run {arch} {shape}: {rec}")
        emit(phase="dryrun_cell", arch=arch, shape=shape, mesh=rec["mesh"],
             host_s=rec["lower_s"], memory=rec["memory"],
             flops_once=rec["flops_once"], bytes_once=rec["bytes_once"],
             collectives_once=rec["collectives_once"])

    roof = os.path.join(os.path.dirname(dry), "torch_roofline.json")
    K.LAUNCHES["serve_round"] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        roofline.main(["--dryrun", dry, "--out", roof])
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = K.LAUNCHES["serve_round"]
    check(launches > 0, "the fabric cross-check never launched serve_round")
    with open(roof) as f:
        card = json.load(f)
    t0 = time.perf_counter()
    rows = [roofline.analyze_cell(f"{a}|{s}|single", recs[f"{a}|{s}|single"])
            for a in ARCH_IDS for s in SHAPES if f"{a}|{s}|single" in recs]
    rows = [r for r in rows if r]
    cpu = json.loads(json.dumps({
        "cells": rows,
        "fabric_crosscheck": roofline.fabric_crosscheck(rows, device="cpu")}))
    cpu_s = time.perf_counter() - t0
    check(card["cells"] == cpu["cells"], "roofline rows differ from the CPU "
                                         "run's")
    check(card["fabric_crosscheck"] == cpu["fabric_crosscheck"],
          f"the fabric cross-check on the card {card['fabric_crosscheck']} "
          f"differs from the CPU's {cpu['fabric_crosscheck']}")
    for row in card["cells"]:
        emit(phase="roofline_row", **{k: row[k] for k in (
            "arch", "shape", "compute_ms", "memory_ms", "collective_ms",
            "dominant", "useful_flops_ratio", "roofline_fraction",
            "memory_gib")})
    emit(phase="fabric_crosscheck", equal_to_cpu=True, host_s_card=card_s,
         host_s_cpu=cpu_s, serve_round_launches=launches,
         rows=card["fabric_crosscheck"])

    with open(log) as f:
        entry = json.load(f)[HILLCLIMB_CELL]
    its = entry["iterations"]
    check(len(its) == 3 and all(
        math.isfinite(v[k]) for v in (entry["baseline"], *its)
        for k in ("compute_ms", "memory_ms", "collective_ms")),
        f"the hillclimb log: {entry}")
    emit(phase="hillclimb", cell=HILLCLIMB_CELL, arch=entry["arch"],
         shape=entry["shape"], baseline=entry["baseline"],
         iterations=[{k: v[k] for k in (
             "tag", "compute_ms", "memory_ms", "collective_ms", "dominant",
             "dominant_term_delta")} for v in its],
         subprocess_wait_s=wait_s)
    return launches


def phase_mesh_layer(np, torch, FA, RK, K, host):
    """Phase 5j: the pipeline on the card, then the dry-run stand-in, the
    roofline and its fabric cross-check, and the hillclimb log.  Returns
    (the pipeline's launches, the cross-check's serve_round launches)."""
    gc.collect()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_allocated()
    check(start < FAMILY_START_BYTES,
          f"{start} bytes still allocated when phase 5j starts")
    t0 = time.perf_counter()
    pipe = pipeline_on_card(np, torch, FA, RK)
    pipe_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    xcheck = dryrun_on_card(torch, K, host)
    emit(phase="mesh_layer", pipeline_host_s=pipe_s,
         dryrun_host_s=time.perf_counter() - t0)
    return pipe, xcheck


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: the port's sources are missing ({src})",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    import numpy as np

    import repro_torch.core as P
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as FA, ref as FAR
    from repro_torch.kernels.flash_attention import kernel_bwd as FAB
    from repro_torch.kernels.flash_attention import ops as FAO
    from repro_torch.models import moe as MOE
    from repro_torch.kernels.rglru_scan import kernel as RK, ref as RR
    from repro_torch.kernels.flit_pack import kernel as FK, ref as FR
    from repro_torch.kernels.flit_pack.ops import MAX_PAYLOAD_B
    from repro_torch.kernels.link_contention import kernel as LK, ref as LR
    from repro_torch.kernels.link_contention import ops as LO
    from repro_torch.core import critical_path as CP
    from repro_torch.core import snoop_filter as PS
    from repro_torch.core import telemetry as TM
    from repro_torch.core import trace_export as TX
    from repro_torch.core import traces as TR
    from repro_torch.kernels.serve_round import kernel as K, ref
    from repro_torch.kernels.sf_scan import kernel as SFK, ref as SFR
    from repro_torch.kernels.ssd_chunk import kernel as SK, ref as SR
    from repro_torch.kernels.ssd_chunk import kernel_bwd as SKB
    from repro_torch.studies import (coherence_fabric, coherence_modes,
                                     full_duplex, invblk, link_explorer,
                                     link_layer, link_reliability, routing,
                                     topology, topology_explorer, traces,
                                     validation)
    from repro_torch.studies import critical_path as critical_path_study_mod
    from repro_torch.studies import fabric_trace_viewer
    from repro_torch.studies import snoop_filter as sf_study
    from repro_torch.studies import streaming as streaming_study
    from repro_torch.studies import telemetry as telemetry_study
    from repro_torch.analysis import verify_smoke as VS
    from repro_torch.studies import (coherence_fabric_demo, fabric_autotune,
                                     link_reliability_demo, serve_decode)
    from repro_torch.studies import fabric as fabric_study

    # phase 0: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit(phase="device", name=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    # whether this host's numpy draws the redis trace's zipf ranks as
    # numpy 2.0.2 does (the port never calls it: `traces._zipf`)
    seed = 1 + TR.zlib.crc32(b"redis") % 65536
    emit(phase="host", numpy=np.__version__, libc=list(platform.libc_ver()),
         python=platform.python_version(),
         numpy_zipf_equals_2_0_2=bool(np.array_equal(
             np.random.default_rng(seed).zipf(1.2, 3200),
             TR._zipf(np.random.default_rng(seed), 1.2, 3200))))
    # the synthetic traces the studies replay, against the JAX package's
    phase_traces_pinned(TR)

    # phase 1: build every kernel of the path from this checkout's sources
    # (one nvcc process per source, all started together)
    t0 = time.perf_counter()
    sources = [K._SOURCE, LK._SOURCE, FK._SOURCE, FA._SOURCE, FA._SOURCE_TC,
               FAB._SOURCE, RK._SOURCE, SK._SOURCE, SK._SOURCE_TC,
               SKB._SOURCE, SFK._SOURCE]
    _build.build_all(sources)
    for load in (K._lib, LK._lib, FK._lib, FA._lib, FA._lib_tc, FAB._lib_bwd,
                 RK._lib, SK._lib, SK._lib_tc, SKB._lib_bwd, SFK._lib):
        load()
    emit(phase="build", sources=[str(x.relative_to(ROOT)) for x in sources],
         seconds=time.perf_counter() - t0)
    # what ptxas made of the fused serve round, the segmented depart scan,
    # the RG-LRU scan and the tensor-core kernels, and the latter's dynamic
    # shared memory per block
    for src, smem in ((K._SOURCE, None), (LK._SOURCE, None),
                      (RK._SOURCE, None),
                      (FA._SOURCE_TC, {f"D{d}": FA._lib_tc(
                          ).flash_attention_tc_smem(d) for d in (64, 128,
                                                                 256)}),
                      (FAB._SOURCE, {f"D{d}": FAB._lib_bwd(
                          ).flash_attention_bwd_smem(d) for d in (64, 128,
                                                                  256)}),
                      (SK._SOURCE_TC, SK._lib_tc().ssd_chunk_tc_smem()),
                      (SKB._SOURCE, {
                          "walk": SKB._lib_bwd().ssd_chunk_bwd_walk_smem(),
                          "grads": SKB._lib_bwd().ssd_chunk_bwd_smem()}),
                      (SFK._SOURCE, {"opt_in_limit": SFK._lib(
                          ).sf_scan_max_smem(0)})):
        log = _build.LOGS.get(src)
        emit(phase="ptxas", source=str(src.relative_to(ROOT)),
             dynamic_smem_bytes=smem,
             kernels=ptxas_summary(log) if log else "built before this run",
             # ptxas's notes (C75xx), "wgmma.mma_async instructions are
             # serialized" among them
             notes=sorted(set(re.findall(r"\((C75\d\d)\)", log or ""))),
             wgmma_serialized="are serialized" in (log or ""))

    # phase 2: each kernel against its plain version, and its time
    worst_round = phase_round_vs_plain(torch, K, ref)
    worst, timings = phase_kernel_vs_plain(torch, K, ref)
    worst_depart, depart_timings = phase_depart_vs_plain(torch, LK, LR)
    worst_flit, flit_timings = phase_flit_vs_plain(
        np, torch, FK, FR, MAX_PAYLOAD_B, P.link_layer.MAX_REPLAY_PPM)
    worst_flash, flash_timings, flash_checked = phase_flash_vs_plain(
        torch, FA, FAR)
    worst_rglru, rglru_timing = phase_rglru_vs_plain(torch, RK, RR)
    worst_ssd, ssd_timings = phase_ssd_vs_plain(torch, SK, SR)
    worst_sf = phase_sf_vs_plain(np, torch, PS, SFK, SFR)
    err, sf_time = sf_timing(np, torch, PS, SFK, SFR)
    worst_sf = max(worst_sf, err)

    # warm up the CUDA libraries on a tiny workload (not part of the run)
    _, tiny = topology.workload(topology.build_topo("chain", 2), 2,
                                topology.FLOOD_IV_PS, device="cuda")
    P.simulate(tiny.hops, tiny.channels, tiny.issue_ps)
    torch.cuda.synchronize()

    # from here on, the shape of every flash launch of the paths
    flash_launched, flash_bwd_launched = set(), set()
    paths = contextlib.ExitStack()
    paths.enter_context(flash_shapes(FAO, flash_launched, flash_bwd_launched))

    # phases 3-4: the main path, with the launch counts read around it
    K.LAUNCHES["serve_round"] = 0
    K.LAUNCHES["serve_scan"] = 0
    runs = []
    cpu_scheds = {}
    fig10 = {}
    cpu_threads = torch.get_num_threads()
    for fabric in topology.FABRICS:
        _, wl = topology.workload(topology.build_topo(fabric, 8), 120,
                                  topology.FLOOD_IV_PS, device="cuda")
        sched, opts, row = run_path(np, torch, P, fabric, wl)
        # the same tables through the port's CPU path
        t0 = time.perf_counter()
        cpu = P.simulate(P.hops_from_arrays(wl.hops, device="cpu"),
                         P.channels_from_arrays(wl.channels, device="cpu"),
                         P.issue_from_array(wl.issue_ps, device="cpu"), opts)
        for f in ("start", "depart", "arrive", "complete"):
            check(torch.equal(getattr(cpu, f), getattr(sched, f).cpu()),
                  f"{fabric}: CPU run differs in {f}")
        check(cpu.rounds == sched.rounds, f"{fabric}: CPU rounds differ")
        if fabric in CRITICAL_PATHS:
            cpu_scheds[fabric] = cpu
        row.update(fabric=fabric, cpu_s=time.perf_counter() - t0,
                   cpu_threads=cpu_threads,
                   fig10_norm_bw=(row["steady_bandwidth_MBps"]
                                  / topology.PORT_MBPS))
        emit(phase="paper_path", **row)
        fig10[fabric] = row["fig10_norm_bw"]
        runs.append((fabric, wl, sched))

    # 4a: past the reference kernel's int32 span (2**29 ps per round)
    tree = topology.build_topo("tree", 8)
    _, wl = topology.workload(P.with_flit(tree, P.FlitConfig("flit256")),
                              512, 200_000, device="cuda")
    sched, _, row = run_path(np, torch, P, "long_span", wl)
    round_span = int(sched.arrive[:, :-1].max() - sched.arrive[:, :-1].min())
    check(round_span > (1 << 29) - 1, "long-span trace stays inside 2**29 ps")
    emit(phase="long_span", round_span_ps=round_span, **row)
    runs.append(("long_span", wl, sched))

    # 4b: stochastic reliability with link-down markers
    rel = P.FlitConfig("flit256", ber=1e-5, reliability="stochastic",
                       rel_seed=7, retrain_threshold=2,
                       retrain_ps=1_000_000)
    _, wl = topology.workload(P.with_flit(tree, rel), 128, 6_000,
                              device="cuda")
    markers = int(P.link_layer.retrain_marker_mask(
        wl.hops.channel.cpu().numpy(), wl.hops.nbytes.cpu().numpy(),
        wl.hops.valid.cpu().numpy(),
        wl.hops.retrain_after_ps.cpu().numpy()).sum())
    check(markers > 0, "the stochastic trace has no link-down markers")
    sched, _, row = run_path(np, torch, P, "markers", wl)
    emit(phase="markers", markers=markers, **row)
    runs.append(("markers", wl, sched))
    launches = K.LAUNCHES["serve_round"]
    scan_launches = K.LAUNCHES["serve_scan"]
    check(launches > 0, "the main path never launched serve_round")

    # where one round's time goes, per workload (after the counts are read)
    round_timings = {}
    for name, wl, sched in runs:
        steps, args, err = round_breakdown(torch, K, wl, sched)
        worst_round = max(worst_round, err)
        emit(phase="round_breakdown", workload=name, K=int(args[0].shape[0]),
             **steps)
        if name in ("chain", "long_span"):
            round_timings[name] = round_timing(torch, K, ref, name, args)
            emit(phase="device_profile", workload=name,
                 **device_profile(torch, P, wl))
        del args

    # phase 5: the link-layer studies at the reference's full sizes, with
    # the serve-round counts read around them
    K.LAUNCHES["serve_round"] = 0
    K.LAUNCHES["serve_scan"] = 0
    logs = {}
    for name, module in (("link_layer", link_layer),
                         ("link_reliability", link_reliability)):
        rows, logs[name] = run_study(np, torch, P, K, module, name)
        derived = ";".join(r.derived for r in rows)
        # link_reliability asserts its three gates itself
        check("pass=False" not in derived and "=False" not in derived,
              f"{name}: an acceptance gate failed: {derived}")
        rows_against_reference(name, rows, STUDY_REF[name])
    study_launches = K.LAUNCHES["serve_round"]
    check(study_launches > 0, "the studies never launched serve_round")
    launches += study_launches
    scan_launches += K.LAUNCHES["serve_scan"]
    # each stacked sweep's converged round through the fused kernel against
    # the plain round, and the sweep against its members run one by one
    # (after the count is read: these are checks and timing runs)
    for name, log in logs.items():
        for run in log.runs:
            if run.stacked:
                k, err = stacked_round_vs_plain(torch, K, ref, run)
                worst_round = max(worst_round, err)
                emit(phase="stacked_vs_loop", study=name, sweep=run.label,
                     round_K=k, fused_round_max_abs_err=err,
                     **stacked_vs_loop(torch, P, run))

    # phase 5b: the paper studies at the reference's full sizes (Fig. 7/8,
    # 10-13, 16-20, Table IV), with the serve-round count read around them
    K.LAUNCHES["serve_round"] = 0
    K.LAUNCHES["serve_scan"] = 0
    paper, paper_logs, unconverged = {}, {}, []
    for name, module in (("validation", validation), ("topology", topology),
                         ("routing", routing), ("full_duplex", full_duplex),
                         ("traces", traces)):
        paper[name], log = run_study(np, torch, P, K, module, name)
        paper_logs[name] = log
        unconverged += [f"{name}/{r.label}" for r in log.runs
                        if not r.stacked and not r.schedule.converged]
    paper_launches = K.LAUNCHES["serve_round"]
    check(paper_launches > 0, "the paper studies never launched serve_round")
    launches += paper_launches
    scan_launches += K.LAUNCHES["serve_scan"]
    # Fig. 10 at scale 16 is the main path's workload: the same specs and
    # ECMP seed, so each fabric's row carries paper_path's bandwidth
    norm = {r.name: re.search(r"norm_bw=([^;]+)", r.derived)[1]
            for r in paper["topology"] if r.name.startswith("fig10/")}
    for fabric in topology.FABRICS:
        got = norm[f"fig10/{fabric}/scale16"]
        check(got == f"{fig10[fabric]:.2f}",
              f"fig10/{fabric}/scale16: norm_bw={got}, paper_path "
              f"{fig10[fabric]:.2f}")
    # every paper study (Fig. 7/8, 10-13, 16-20, Table IV) against the JAX
    # package's rows, and the redis half-duplex bus's rounds
    for name in ("validation", "topology", "routing", "full_duplex"):
        rows_against_reference(name, paper[name], STUDY_REF[name])
    rows_against_reference("traces", paper["traces"], TRACES_REF)
    (redis_bus,) = [r for r in paper_logs["traces"].runs
                    if r.label == "redis/bus_half/n6000"]
    check(redis_bus.schedule.rounds == REDIS_BUS_ROUNDS,
          f"redis/bus_half: {redis_bus.schedule.rounds} rounds, expected "
          f"{REDIS_BUS_ROUNDS}")
    emit(phase="paper_studies", serve_round_launches=paper_launches,
         redis_bus_half_rounds=redis_bus.schedule.rounds,
         fig18_19_redis={r.name: r.derived for r in paper["traces"]
                         if r.name.startswith("fig18_19/redis/")},
         fig10_scale16={f: norm[f"fig10/{f}/scale16"]
                        for f in topology.FABRICS},
         unconverged_schedules=unconverged)

    # phase 5c: device-handled coherence at the reference's full sizes:
    # Fig. 14 and Fig. 15 (the snoop-filter scan) against the JAX package's
    # integers, the coupled studies (the scan and the fused serve round on
    # every fixpoint iteration) with every converged schedule against the
    # oracle; both counts read around them
    K.LAUNCHES["serve_round"] = 0
    K.LAUNCHES["serve_scan"] = 0
    SFK.LAUNCHES["sf_scan"] = 0
    coherence = {}
    for name, module in (("snoop_filter", sf_study), ("invblk", invblk),
                         ("coherence_fabric", coherence_fabric),
                         ("coherence_modes", coherence_modes)):
        coherence[name] = run_study(np, torch, P, K, module, name)
    # `simulate_coupled` itself, on the card against the CPU
    coupled_on_card(np, torch, P, PS)
    # the explorer's victim-policy sweep (`topology_explorer.main` runs it)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        topology_explorer.snoop_filter_sweep("cuda")
    sf_launches = SFK.LAUNCHES["sf_scan"]
    coherence_launches = K.LAUNCHES["serve_round"]
    check(sf_launches > 0, "the coherence studies never launched sf_scan")
    check(coherence_launches > 0,
          "the coherence studies never launched serve_round")
    launches += coherence_launches
    scan_launches += K.LAUNCHES["serve_scan"]
    sf_rows_against_reference("snoop_filter", coherence["snoop_filter"][1],
                              FIG14_REF)
    sf_rows_against_reference("invblk", coherence["invblk"][1], FIG15_REF)
    # the coupled studies' rows against the JAX package's, with the
    # fixpoints' iterations and engine rounds
    rows_against_reference("coherence_fabric",
                           coherence["coherence_fabric"][0],
                           STUDY_REF["coherence_fabric"], with_meta=True)
    rows_against_reference("coherence_modes", coherence["coherence_modes"][0],
                           STUDY_REF["coherence_modes"])
    sf_telemetry_against_reference(TM, coherence["snoop_filter"][1])
    derived = {r.name: r.derived for r in coherence["coherence_fabric"][0]}
    for gate in ("divergence_gate", "fanout_gate"):
        check("gate=True" in derived[f"coherence_fabric/{gate}"],
              f"coherence_fabric/{gate}: {derived}")
    emit(phase="coherence", explorer_sweep=printed.getvalue().splitlines(),
         sf_scan_launches=sf_launches,
         serve_round_launches=coherence_launches,
         fig14={r.name: r.derived for r in coherence["snoop_filter"][0]},
         fig15={r.name: r.derived for r in coherence["invblk"][0]})

    # phase 5d: the telemetry layer: fabric_metrics on the main path's
    # converged schedules (the retraining replay through the fused serve
    # round) against the CPU, and the telemetry study at the reference's
    # full size against the JAX package's rows; the serve-round count read
    # around them
    K.LAUNCHES["serve_round"] = 0
    K.LAUNCHES["serve_scan"] = 0
    on_path = telemetry_on_path(torch, P, TM, K, runs)
    telemetry_rows, _ = run_study(np, torch, P, K, telemetry_study,
                                  "telemetry")
    telemetry_launches = K.LAUNCHES["serve_round"]
    check(telemetry_launches > 0,
          "the telemetry phase never launched serve_round")
    launches += telemetry_launches
    scan_launches += K.LAUNCHES["serve_scan"]
    rows_against_reference("telemetry", telemetry_rows, TELEMETRY_REF,
                           with_meta=True)
    for name, wl, sched in runs:
        if name in on_path:
            emit(phase="telemetry", workload=name, **on_path[name],
                 **time_fabric_metrics(torch, TM, wl, sched))
    emit(phase="telemetry_launches", serve_round_launches=telemetry_launches,
         on_path={n: r["launches"] for n, r in on_path.items()})

    # phase 5e: the observability back end: critical paths, blame,
    # what-ifs and the trace export on the main path's chain and markers
    # schedules (host replays of the card's schedules, held against the CPU
    # run's), the critical-path study at full size against the JAX
    # package's rows, and the trace viewer against the example's printout;
    # the serve-round and sf_scan counts read around them
    K.LAUNCHES["serve_round"] = 0
    K.LAUNCHES["serve_scan"] = 0
    SFK.LAUNCHES["sf_scan"] = 0
    paths_on_path = critical_path_on_path(np, torch, P, CP, TX, runs,
                                          cpu_scheds)
    del cpu_scheds
    critical_path_study(np, torch, P, K, critical_path_study_mod)
    viewer = trace_viewer_on_card(fabric_trace_viewer, TX)
    cp_launches = K.LAUNCHES["serve_round"]
    cp_sf_launches = SFK.LAUNCHES["sf_scan"]
    check(cp_launches > 0,
          "the critical-path phase never launched serve_round")
    check(cp_sf_launches > 0, "the critical-path phase never launched sf_scan")
    launches += cp_launches
    scan_launches += K.LAUNCHES["serve_scan"]
    sf_launches += cp_sf_launches
    for name, result in paths_on_path.items():
        emit(phase="critical_path", workload=name, **result)
    emit(phase="trace_viewer", **viewer)
    emit(phase="critical_path_launches", serve_round_launches=cp_launches,
         sf_scan_launches=cp_sf_launches)

    # phase 5f: the streaming windowed engine: the streaming study at full
    # size (1.2 M requests through 65,536-row windows) against the JAX
    # package's rows, the congested carry path (phase 4b's markers tables
    # in issue order) and a Fig. 14-sized coherence stream each against its
    # monolithic card schedule, and the verifier smoke on card lowerings;
    # the serve-round and sf_scan counts read around them
    K.LAUNCHES["serve_round"] = 0
    K.LAUNCHES["serve_scan"] = 0
    SFK.LAUNCHES["sf_scan"] = 0
    t0 = time.perf_counter()
    stream = streaming_on_card(np, torch, P, K, streaming_study)
    (markers_wl,) = [wl for name, wl, _ in runs if name == "markers"]
    carry = carry_path_congested(torch, P, K, streaming_study, markers_wl)
    coh_stream = coherence_stream_on_card(np, P, PS, SFK, streaming_study)
    smoke = verify_smoke_on_card(VS)
    stream_launches = K.LAUNCHES["serve_round"]
    stream_sf_launches = SFK.LAUNCHES["sf_scan"]
    check(stream_launches > 0,
          "the streaming phase never launched serve_round")
    check(stream_sf_launches > 0, "the streaming phase never launched sf_scan")
    launches += stream_launches
    scan_launches += K.LAUNCHES["serve_scan"]
    sf_launches += stream_sf_launches
    emit(phase="streaming", **stream)
    emit(phase="stream_carry_path", **carry)
    emit(phase="coherence_stream", **coh_stream)
    emit(phase="verify_smoke", **smoke)
    emit(phase="streaming_launches", serve_round_launches=stream_launches,
         sf_scan_launches=stream_sf_launches,
         host_s=time.perf_counter() - t0)

    # phase 5g: the TPU-fabric cost model: the fabric study at full size
    # against the JAX package's rows (every collective's schedule against
    # the oracle), the autotune, coherence and link-reliability demos
    # against the examples' printouts, and the serve_decode example on the
    # smoke model; the serve-round, sf_scan, flash-attention and RG-LRU
    # counts read around them
    K.LAUNCHES["serve_round"] = 0
    K.LAUNCHES["serve_scan"] = 0
    SFK.LAUNCHES["sf_scan"] = 0
    t0 = time.perf_counter()
    collectives = fabric_study_on_card(np, torch, P, K, fabric_study)
    demos = examples_on_card(P, K, SFK, (fabric_autotune,
                                         coherence_fabric_demo,
                                         link_reliability_demo))
    fabric_launches = K.LAUNCHES["serve_round"]
    fabric_sf_launches = SFK.LAUNCHES["sf_scan"]
    decode_launches = serve_decode_on_card(torch, FA, RK, serve_decode)
    check(fabric_launches > 0, "the fabric phase never launched serve_round")
    check(fabric_sf_launches > 0, "the fabric phase never launched sf_scan")
    launches += fabric_launches
    scan_launches += K.LAUNCHES["serve_scan"]
    sf_launches += fabric_sf_launches
    for c in collectives:
        emit(phase="fabric_collective", **c)
    for name, d in demos.items():
        emit(phase="fabric_example", example=name, **d)
    emit(phase="fabric_launches", serve_round_launches=fabric_launches,
         sf_scan_launches=fabric_sf_launches, **{
             f"serve_decode_{n}": c for n, c in decode_launches.items()},
         host_s=time.perf_counter() - t0)

    # phase 6: depart_times on real converged rounds (its path), against
    # the serve-scan kernel's departures
    cases = [(n, wl.hops, wl.channels, sched) for n, wl, sched in runs
             if n != "markers"]
    for study, label in (("link_layer", "ber_sweep"),
                         ("link_reliability", "tail/expected")):
        (run,) = [r for r in logs[study].runs if r.label == label]
        cases += [(f"{label}[{i}]", P.member(run.hops, i),
                   P.member(run.channels, i), P.member(run.schedule, i))
                  for i in range(len(run.schedule.rounds))]
    LK.LAUNCHES["segmented_depart"] = 0
    for name, hops, channels, sched in cases:
        n_items, err = depart_on_round(torch, P, LO, name, hops, channels,
                                       sched)
        emit(phase="depart_on_round", workload=name, serving_items=n_items,
             max_abs_err=err)
    depart_launches = LK.LAUNCHES["segmented_depart"]
    check(depart_launches == len(cases),
          f"{depart_launches} segmented_depart launches for {len(cases)} "
          f"rounds")

    # phase 7: the link explorer's flit-efficiency grid (flit_pack's path)
    FK.LAUNCHES["flit_pack"] = 0
    grid = link_explorer.kernel_grid(device="cuda")
    flit_launches = FK.LAUNCHES["flit_pack"]
    check(flit_launches > 0, "the kernel grid never launched flit_pack")
    cpu_grid = link_explorer.kernel_grid(device="cpu")
    check(np.allclose(grid, cpu_grid, rtol=1e-6, atol=0)
          and bool((np.diff(grid, axis=1) <= 0).all()),
          f"flit grid: card {grid.tolist()} vs CPU {cpu_grid.tolist()}")
    emit(phase="link_explorer", grid=grid.tolist(),
         max_abs_diff_vs_cpu=float(np.abs(grid - cpu_grid).max()))

    # the simulator phases' tables and schedules are not read again: free
    # them for the models
    del runs, logs, paper, paper_logs, coherence, cases
    gc.collect()
    torch.cuda.empty_cache()
    emit(phase="memory_before_models",
         allocated_bytes=torch.cuda.memory_allocated())

    # phase 8: the model stack's serving path at full width (the flash
    # attention and RG-LRU scan kernels' path)
    rg_launches = phase_model_serve(np, torch, FA, RK)
    check(rg_launches["flash_attention_tc"] > 0
          and rg_launches["rglru_scan"] > 0,
          "the served model never launched its kernels")
    # free recurrentgemma-2b's weights and caches before the next model
    gc.collect()
    torch.cuda.empty_cache()

    # phase 9: mamba2-1.3b at full width (the SSD chunk kernel's path)
    ssd_launches = phase_model_serve_mamba2(np, torch, SK)
    check(ssd_launches["ssd_chunk_tc"] > 0,
          "the served model never launched ssd_chunk_tc")

    # phase 5h: the model families (MoE, encoder-decoder, VLM stub) at full
    # width, after mamba2-1.3b's weights and caches are freed; the flash
    # counts read around each model's run
    family_launches = phase_model_families(np, torch, FA, MOE)
    check(family_launches["flash_attention_tc"] > 0
          and family_launches["flash_attention"] == 0,
          f"the model families' flash launches: {family_launches}")

    # phase 5j's dry-run host work (meta counts, no card; about 75 s on the
    # card's host) runs from here on beside phase 5i, whose steps keep the
    # card busy
    dryrun_dir = tempfile.TemporaryDirectory()
    dryrun_host = start_dryrun_host_work(dryrun_dir.name)

    # phase 5i: training on the card (the flash backward kernel, the RG-LRU
    # scan's reverse mode, the SSD backward kernel), after phase 5h's models
    # are freed; the counts set to 0 around each training run
    (train_launches, worst_flash_bwd, flash_bwd_checked, flash_bwd_timings,
     worst_rglru_reverse, rglru_reverse_timing, worst_ssd_bwd,
     ssd_bwd_timing, ssd_bwd_shares) = phase_training(
        torch, FA, FAR, RK, RR, SK, SKB, SR)
    check(all(train_launches[n] > 0 for n in (
        "flash_attention_tc", "flash_attention_bwd", "rglru_scan",
        "rglru_scan_reverse", "ssd_chunk_tc", "ssd_chunk_bwd"))
          and train_launches["flash_attention"] == 0
          and train_launches["ssd_chunk"] == 0,
          f"the training phase's launches: {train_launches}")

    # phase 5j: the production-mesh layer (the pipeline schedule over
    # recurrentgemma-2b, the dry-run stand-in, the roofline's fabric
    # cross-check through the fused serve round, the hillclimb log)
    pipe_launches, xcheck_launches = phase_mesh_layer(
        np, torch, FA, RK, K, dryrun_host)
    check(pipe_launches["flash_attention_tc"] > 0
          and pipe_launches["rglru_scan"] > 0 and xcheck_launches > 0,
          f"phase 5j's launches: {pipe_launches}, serve_round "
          f"{xcheck_launches}")
    dryrun_dir.cleanup()
    paths.close()
    # every flash shape the paths launched, forward and backward, was held
    # to the plain version
    unchecked = sorted(flash_launched - flash_checked)
    check(not unchecked, f"flash shapes launched but never held to the "
                         f"plain version: {unchecked}")
    unchecked = sorted(flash_bwd_launched - flash_bwd_checked)
    check(not unchecked, f"flash backward shapes launched but never held "
                         f"to the plain version: {unchecked}")
    emit(phase="flash_shapes_on_path", launched=len(flash_launched),
         held_to_plain=len(flash_launched), checked=len(flash_checked),
         backward_launched=len(flash_bwd_launched),
         backward_checked=len(flash_bwd_checked))

    main_k = 268_800
    t = timings[main_k]
    td = depart_timings[main_k]
    tf = flit_timings[1 << 24]
    emit(kernels=[
        dict(name="serve_round", route="cuda",
             source="src/repro_torch/kernels/serve_round/csrc/serve_round.cu",
             replaces="src/repro/kernels/serve_round/kernel.py:104",
             launches=launches, max_abs_err=worst_round,
             **round_timings["chain"], K=main_k,
             shape="the chain's converged round"),
        dict(name="serve_scan", route="cuda",
             source="src/repro_torch/kernels/serve_round/csrc/serve_round.cu",
             replaces="src/repro/kernels/serve_round/kernel.py:104",
             launches=scan_launches, max_abs_err=worst, ms=t["ms"],
             plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
             bound_by=t["bound_by"], library_ms=None, K=main_k,
             shape="random well-formed maps (map-only entry)"),
        dict(name="segmented_depart", route="cuda",
             source="src/repro_torch/kernels/link_contention/csrc/"
                    "link_contention.cu",
             replaces="src/repro/kernels/link_contention/kernel.py:94",
             launches=depart_launches, max_abs_err=worst_depart,
             ms=td["ms"], plain_ms=td["plain_ms"], bound_ms=td["bound_ms"],
             bound_by=td["bound_by"], library_ms=None, K=main_k),
        dict(name="flit_pack", route="cuda",
             source="src/repro_torch/kernels/flit_pack/csrc/flit_pack.cu",
             replaces="src/repro/kernels/flit_pack/kernel.py:59",
             launches=flit_launches, max_abs_err=worst_flit, ms=tf["ms"],
             plain_ms=tf["plain_ms"], bound_ms=tf["bound_ms"],
             bound_by=tf["bound_by"], library_ms=None, K=1 << 24),
        *[dict(name=name, route="cuda",
               source=f"src/repro_torch/kernels/flash_attention/csrc/"
                      f"{name}.cu",
               replaces="src/repro/kernels/flash_attention/kernel.py:93",
               launches=rg_launches[name] + decode_launches[name]
               + family_launches[name] + train_launches[name]
               + pipe_launches[name],
               max_abs_err=worst_flash[name],
               **flash_timings[name],
               shape=f"B1 S4096 H10 KV1 D256 window 2048 {dtype}")
          for name, dtype in (("flash_attention_tc", "bf16"),
                              ("flash_attention", "float32"))],
        dict(name="flash_attention_bwd", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention_bwd.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:93",
             role="the gradient of that kernel (the TPU kernel has none)",
             launches=train_launches["flash_attention_bwd"],
             max_abs_err=worst_flash_bwd,
             **flash_bwd_timings[MODEL_ARCH],
             model_family_shapes={m: t for m, t in flash_bwd_timings.items()
                                  if m != MODEL_ARCH},
             shape="B1 S4096 H10 KV1 D256 window 2048 bf16"),
        dict(name="rglru_scan", route="cuda",
             source="src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
             replaces="src/repro/kernels/rglru_scan/kernel.py:62",
             launches=rg_launches["rglru_scan"]
             + decode_launches["rglru_scan"] + train_launches["rglru_scan"]
             + pipe_launches["rglru_scan"],
             max_abs_err=worst_rglru, **rglru_timing,
             shape="(1, 4096, 2560) float32"),
        dict(name="rglru_scan_reverse", route="cuda",
             source="src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
             replaces="src/repro/kernels/rglru_scan/kernel.py:62",
             role="the gradient of that kernel (the adjoint scan, reverse "
                  "mode)",
             launches=train_launches["rglru_scan_reverse"],
             max_abs_err=worst_rglru_reverse, **rglru_reverse_timing,
             shape="(1, 4096, 2560) float32"),
        dict(name="sf_scan", route="cuda",
             source="src/repro_torch/kernels/sf_scan/csrc/sf_scan.cu",
             replaces="src/repro/core/snoop_filter.py:210",
             launches=sf_launches, max_abs_err=worst_sf, **sf_time,
             shape=f"one Fig. 14 stream (fifo): n {SF_N}, SF and cache 819 "
                   f"lines, footprint {SF_FOOT}"),
        *[dict(name=name, route="cuda",
               source=f"src/repro_torch/kernels/ssd_chunk/csrc/{name}.cu",
               replaces="src/repro/kernels/ssd_chunk/kernel.py:82",
               launches=ssd_launches[name] + train_launches[name],
               max_abs_err=worst_ssd[name],
               **ssd_timings[name],
               shape=f"x (1, 4096, 64, 64) {dtype}, b and c (1, 4096, 128) "
                     f"{dtype}, dt (1, 4096, 64) float32")
          for name, dtype in (("ssd_chunk_tc", "bf16"),
                              ("ssd_chunk", "float32"))],
        dict(name="ssd_chunk_bwd", route="cuda",
             source="src/repro_torch/kernels/ssd_chunk/csrc/"
                    "ssd_chunk_bwd.cu",
             replaces="src/repro/kernels/ssd_chunk/kernel.py:82",
             role="the gradient of that kernel (the TPU kernel has none)",
             launches=train_launches["ssd_chunk_bwd"],
             max_abs_err=worst_ssd_bwd, share_of_tolerance=ssd_bwd_shares,
             **ssd_bwd_timing,
             shape="x and dy (1, 4096, 64, 64) bf16, b and c (1, 4096, 128) "
                   "bf16, dt (1, 4096, 64) float32")])

    leaked = sorted(m for m in sys.modules if m in ("jax", "repro")
                    or m.startswith(("jax.", "jaxlib", "repro.")))
    check(not leaked, f"imported JAX or the reference package: {leaked}")
    emit(ok=True, device=dict(platform="gpu", kind=kind,
                              count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
