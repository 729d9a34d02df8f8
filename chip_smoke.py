#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

1. device: the card's name and power limit.
2. build: every CUDA kernel from ``src/repro_torch/kernels/csrc`` with nvcc.
3. insert: ``paired_hash_histogram`` against its plain PyTorch version, bit
   for bit, at the main path's full shape, at ragged shapes (d in {1, 3, 4,
   5, 10, 13, 16, 17, 31, 32}, p from 1 to 8, n in {0, 31, 33} and n % 32
   != 0, partial masks), on the wide body (the projection tile: d in {33,
   40, 63, 64, 515, 4096}, p in {1, 4, 5, 8, 9, 30}, R in {1, 33, 257, 1000,
   2048}, whole tiles masked out, a view that is not 16-byte aligned), with
   integer-weighted masks (values 0-3 in some tiles only) and with
   int16/int8 outputs that saturate.
4. query: ``sketch_query`` against its plain version, bit for bit, on the
   full-size sketch for m in {17, 198, 4096, 1001, 0, 1, 272, 512}, then on
   random counters (negative ones too) at R in {1, 33, 2048}, p in {1, 4, 9,
   16} and m in {1, 17, 1001}, int32, int16 and int8, one call after
   another (each leaves the kernel's workspace zeroed for the next).
5. fit: ``regression.fit`` at the full configuration (n = 2^22 rows at the
   airfoil-matched widths d = 9, R = 2048, p = 4, 400 DFO steps + 1 refine)
   through the kernels, with the launch counts of that run; then the same fit
   through the plain versions (``engine="scan"``) on the same hash family and
   draws.
6. single-sided insert: ``hash_histogram`` against its plain version, bit
   for bit, at the classification path's full shape (n = 2^22 rows of
   d = 9 features, augmented to 11 columns, R = 1024, p = 2), at ragged
   shapes (d in {1, 3, 4, 5, 7, 11, 13, 15, 16, 17, 31, 32}, p from 1 to 8,
   n in {0, 31, 33} and n % 32 != 0, partial masks, one launch per
   non-empty stream), on the wide body (d in {33, 35, 40, 42, 63, 64, 70,
   515, 4096}, p in {1, 2, 4, 5, 8, 9, 30}, R down to 1, whole tiles masked
   out), with integer-weighted masks (values 0-3 in some tiles only), on
   rows that are not augmented (exact +0.0 and -0.0 entries, all-zero
   rows), on views that are not 16-byte aligned, and with int16/int8
   outputs that saturate.
7. banked inserts: ``sketch_dataset_many(engine="kernel")``, paired
   (R = 2048, p = 4) and single-sided (R = 1024, p = 2), over 16 tenants of
   2^18 rows (the last 1000 short), with the launch counts of that build;
   each slice against the lone kernel on that tenant and the whole bank
   against the plain banked version, bit for bit; then, paired and
   single-sided, a gateway-shaped bank (16 tenants x 4096 slots, about half
   masked, interleaved) and an integer-weighted one, the same way; then
   wide banks (paired d = 40, p = 9, d = 515, p = 4 and d = 63, p = 5;
   single-sided d = 66, p = 4, d = 63, p = 8 and d = 515, p = 1; the last
   three over 4095 slots, so that the tenants' rows are not 16-byte
   aligned).
8. banked query: ``sketch_query_banked`` against its plain version, bit for
   bit, on the 16-tenant bank for m in {272, 16, 32, 3168, 4096, 0, 1, 17,
   512}, on its int16 and int8 copies, and on random 3-table banks at R in
   {1, 33, 2048}, p in {1, 9, 16} and m in {17, 1001}.
9. classification: ``classification.fit`` on ``make_classification(2^22,
   9, margin 0.5)`` with R = 1024, p = 2 and 300 DFO steps, through the
   kernels (with its launch counts) and through the plain versions on the
   same draws (and through the kernels' plain versions, which must give the
   same fit bit for bit); then ``erm.fit_surrogate`` for ``logistic`` (accuracy) and
   ``kmeans`` (density gain over random directions) through the kernels.
10. banked fit: ``regression.fit_many`` over 16 tenants of 2^18 rows, each
    its own airfoil-matched draw, with the default configuration, through
    the kernels (with its launch counts), through the kernels' plain
    versions (which must give the same fit bit for bit) and through the
    scan engine, on the same draws.
11. timings (run last): device time per launch of each of the seven
    kernels (and of the queries' f32 variants: lone at m = 17, banked at
    the private gateway's 512 slots) and its plain version at the shapes
    above, beside the least time
    the card could take (the four inserts, kernels 1, 3, 4 and 5, over three
    profiler runs: min, median and max, and every kernel record); kernel 3
    at the kmeans shape (d = 11, p = 4) on its own line; both queries and
    their f32 variants at m in {17, 272, 512, 4096}, and both inserts on the wide body and
    kernel 7 on its tiled path (d = 515, n = 2^16, R = 2048, p = 4; the
    profiler beside CUDA events), each beside its bound and its no-FMA
    floor; where the
    time of the three fits goes; the gateway's ticks/s, points/s and rows/s,
    synchronous and pipelined, its tick latency (p50, p99) and, under the
    profiler, the device's busy share and the insert's and query's device
    time per tick.
12. srp_hash: ``ops.srp_hash`` (the entry point, one launch) at the
    regression family's hash (R = 2048, p = 4, 12 features) on 2^18 points
    and ``srp_hash`` at ragged shapes (d in {1, 11, 12, 13, 31, 32, 33, 515,
    4099}, R in {1, 33, 1000, 2048}, p in {1, 2, 4, 8, 9, 30}, n in {0, 1,
    63, 100 003}, and 2^20 + 1 points at R = 2048: codes past 2^31
    elements) through both of its paths, one launch per non-empty call,
    each against its plain version, bit for bit.
13. gateway: ``StormGateway`` over 16 tenants warm started from phase 7's
    bank, 4096 ingest and 32 query slots, 256 rounds of the launcher's
    ``synth_traffic`` (2048 rows and 17 points per tenant and round; rounds
    192-223 carry no queries, 224-255 no ingest) and a 50-step cohort fit
    over tenants 0-3 every 64 rounds, with ``tick_start`` under
    ``torch.cuda.set_sync_debug_mode("error")``. Every tenant's counters
    against the warm bank plus its lone insert, every served point against
    a standalone query of the tenant's sketch at that tick, every fit
    against the offline ``erm.fit_many``; one full tick makes one banked
    insert and one banked query; depth 2 and 3 against the synchronous loop;
    ``mode="ref"`` over the first 32 rounds and an int16 copy (saturating)
    over the first 64, bit for bit; a short single-sided run (R = 1024,
    p = 2) against the lone single-sided inserts.
14. tiered gateway: 64 tenants over 16 resident int16 slots under Zipf(1.1)
    tenant traffic; the final sketches against a flat 64-tenant int16
    gateway's, the pipelined loop against the synchronous one.
15. wide fit: ``regression.fit`` at d = 40 (2^20 rows, R = 4096, 400 DFO
    steps of k = 32 at sigma 0.15 and learning rate 0.25) through the wide
    insert and the queries' generic body, with the launch counts of that
    run, and through the kernels' plain versions (the same fit bit for bit);
    its train MSE and R^2 are printed, and its device time under the
    profiler (the insert's on the projection tile); then one of its DFO
    steps' queries (m = 65, d = 43) through kernel 2's generic body against
    the plain version, timed beside its bound, its no-FMA floor and the
    cuBLAS time of the projection alone.
16. privacy: the queries' f32 variants (``sketch_query_f32``,
    ``sketch_query_banked_f32``) against their plain versions on f32
    tables of both signs and magnitudes 1e-2 to 1e10 (R in {1, 33, 2048},
    p in {1, 4, 9}, m in {0, 1, 17, 272, 512, 4096}, lone and banked):
    two launches give the same bits, each point within 2^-22 mean|x| of
    the plain version, integer-valued tables bit for bit against the
    integer body; at the main path's shapes (the private gateway's 16
    lanes at its 512 slots, one lane at a fit's 17 points); a release of
    phase 5's sketch at eps = 1 (``privatize_counts``, ``query_private``,
    the f32 kernel) beside the exact query; the private ``StormGateway``
    at phase 13's configuration, 64 rounds under ReleasePolicy(48, 1)
    (rounds 32-39 without ingest; cohort fits over tenants 0-3 and over
    tenant 5 alone), once refusing and once stale on exhaustion: the
    ledger, statuses, lanes and fits against a host replay on a second
    view of the same seed, every served point against a standalone banked
    f32 query of its release, every fit against the offline
    ``erm.fit_many`` over its released sub-bank, one private tick = one
    banked insert and one banked f32 query, ``trace_count`` <= 4,
    ``tick_start`` under sync debug mode 'error', depth 2 and 3 against
    the synchronous loop, ``mode="ref"`` (statuses and spends equal,
    estimates within the bound); the tiered private gateway (phase 14's
    64 tenants over 16 int16 slots, stale): ledger keys are global
    tenants, depth 2 equals sync, ``trace_count`` <= 5; then private
    ticks/s, host time in ``tick_start`` and the device time of a private
    tick under the profiler.
17. wire: a ``StormWireServer`` on 127.0.0.1 over a 4-tenant card gateway
    at phase 13's widths; the port's client ingests 8 x 2048 rows per
    tenant, each followed by a 17-point query that must equal a
    standalone query of the tenant's lone sketch bit for bit, then a
    cohort fit (against the offline fit) and ``stats``; private servers:
    ``budget`` frames drain as the ledger does, a spent tenant's query is
    a terminal ``budget_exceeded`` (``BudgetExceeded``) or, on a stale
    server, a result marked ``"stale"``; ``budget`` is ``None`` without a
    policy.

18. distributed, on meshes of one card (``Mesh((cuda:0,))`` and
    ``Mesh((cuda:0,) * 4)``, the stand-in for four devices): ``sharded_sketch``
    of phase 5's 2^22-row stream against phase 5's lone build (one kernel 1
    launch per shard) and of phase 9's rows (single-sided, R = 1024, p = 2)
    against phase 9's (kernel 3); ``fleet_fit`` of 16 members from
    ``fleet.seed_fleet`` over the merged sketch at the default DFO
    configuration and ``fleet_fit_banked`` over phase 7's bank (16 tenants x
    2 restarts; 4 tenants a shard), each against its meshless run bit for
    bit, with kernel 2 and kernel 6 launches = shards x (steps + 2 per
    refine pass), and their wall times beside the meshless run's; the mesh
    gateway on phase 13's script (reports, fits, counters and ``n`` against
    phase 13's meshless run; kernels 4 and 6 = shards x the meshless
    ticks' launches; sync and depth 2; ``tick_start`` under sync debug mode
    'error') and its ticks/s, ``tick_start`` p50/p99 and busy share beside
    the meshless gateway's in turns; the tiered gateway on phase 14's cell
    over 4 shards against phase 14's run.

19. the LM, run after phase 11's timings: qwen2-7b at its published width
    (28 layers, d_model 3584, vocab 152064, bf16; 7.6e9 parameters drawn
    on the card from a seed), served by two fresh ``ServeEngine`` runs (4
    slots, cache 256, 8 greedy requests of 8-token prompts and 16 new
    tokens: equal streams), then by a tapped engine (cycles 13 and 27,
    entropy targets) feeding a ``TelemetryBridge`` over a 2-tenant paired
    gateway at d = 3587, R = 2048, p = 4 (the same streams: tap
    neutrality); the probe stream (2048 + 512 held-out random 16-token
    sequences through ``extract_tap_features``), each tap layer sketched
    by ``probes.sketch_features`` (kernel 1's wide body, bit for bit
    against its plain version) and fitted by ``fit_probe`` at a DFO step
    of 0.01 (the default, 2, diverges at d = 3585; kernel 2: the first
    steps bit for bit against the plain versions; the whole fit must leave
    the zero guard, its trace and held-out MSE within 2% of the scan
    engine's; held-out R^2 printed); the bridge's served counters against
    ``sketch_features(moments=frozen)`` on the captured rows and
    ``bridge.fit_probes`` (kernel 6) against the offline ``fit_probe_many``
    (heads, traces, selection losses), bit for bit, its first steps
    against the plain versions'; the main path's launches counted
    exactly; the drift scorers on card window deltas of the served
    counters, equal to their scores of host copies; kernel 4 at a bridge
    tick and kernels 2 and 6's generic body at d = 3587, m = 17 and 34,
    bit for bit against their plain versions;
    prefill then decode against the forward within 4 sqrt(2L + 1) 2^-8
    max|logit|, relative L2 error within sqrt(2L + 1) 2^-8; ``python -m
    repro_torch.launch.serve``; then its timings (decode step, tapped and
    untapped, and tokens/s; ``forward_taps``; the bridge's flushes; the
    fits; kernels 1 and 4 wide and kernels 2 and 6 at d = 3587, m = 17 and
    34, beside their bounds, no-FMA floors and, for the queries, the cuBLAS
    time of the projection alone; the engine loop's busy share under the
    profiler), each beside the card's name and power limit.

20. training, after phase 19 (whose model is freed first): gemma3-1b at
    its published width and depth (26 layers, d_model 1152, vocab 262144,
    bf16 params; 1.0e9 drawn on the card from a seed) with the reference's
    AdamW defaults (f32 master, mu and nu) but a 2-step warmup to lr 1e-3,
    on a fixed batch of 4 x 1024 random tokens (past the 512-token local
    window; two xent chunks), through ``trainer.train``: 4 steps with one
    save (keep 1) under ``.chip_scratch/``, then a second run that resumes
    from step 4 to 6 (``resumed_from`` 4, no restores: a CUDA error is
    sticky, so the restore branch must never hide one). The first loss in
    [0.3, 3] ln(vocab), every loss and gradient norm finite, the last loss
    below the first; the newest checkpoint restored into a fresh template
    bit for bit against the state in memory; the restored params served
    (4 slots, cache 256, greedy) with the same streams as the params in
    memory; one step's gradients under remat "nothing" against "none"
    within 2^-8 relative L2 a leaf, the remat peak the lower; ``python -m
    repro_torch.launch.train`` on the smoke config. It prints the steady
    step (host clock ending in a sync), tokens/s, model FLOP/s (6 N T / t)
    and its share of the bf16 peak, a step's busy share and device
    launches under the profiler, the peaks, and each save's and restore's
    seconds and bytes, beside the card's name and power limit. The
    training path launches none of the seven kernels.

21. the six non-dense LMs, after phase 20, each built on the card in bf16
    at its published widths from a seed and freed before the next:
    xlstm-1.3b (48 mLSTM blocks), zamba2-2.7b (45 Mamba2 blocks, 9 calls of
    one shared attention block), musicgen-medium (48 layers fed frame
    embeddings) and llama-3.2-vision-11b (32 attention and 8
    cross-attention layers onto 4096 frontend states) at full depth;
    mixtral-8x22b at 4 of 56 layers and phi3.5-moe at 8 of 32 (printed as
    ``reduced``: their full bf16 weights need 262 and 78 GiB). Each model:
    a prefill of 2 x 2048 tokens (two 1024-token chunks), timed; 8 decode
    steps after it against the forward over all 2056 tokens within 4
    sqrt(K) 2^-8 max|logit| (K rounded stages of the residual stream; the
    MoE pair at capacity factor = experts, a token routed apart by a bf16
    near tie counted and left out); decode steps at 4 lanes, timed; two
    fresh engines (4 slots, 8 requests, lanes re-admitted) with equal
    streams for the token-input models; decode-state bytes a lane at
    cache 256 and 4096; the peak. zamba2 is served with taps at cycles 4
    and 8 into a 2-tenant gateway at d = 2563 through the bridge: served
    counters equal their offline builds, ``fit_probe`` and ``fit_probes``
    (lr 0.01) equal the offline fits, kernels 1, 2, 4 and 6 bit for bit
    against their plain versions. xlstm-1.3b trains 3 steps of 2 x 2048
    tokens through ``trainer.train`` (no checkpoint): every gradient leaf
    finite, the loss falling; its step ms, tokens/s and model FLOP/s.

22. the LM's sharding (no kernel launches), its parts run where their
    models live: the rules (after phase 21): every config at full size,
    shape-only (``specs.eval_shape``), on the production meshes 16 x 16 and
    2 x 16 x 16 named on one card, the bytes a device holds of params and
    AdamW state by ``param_specs`` and ``opt_state_specs``; in phase 20,
    gemma3-1b's train state (equal to its newest checkpoint) placed on
    ``(data 2, model 2)`` of one card named 4 times, the bytes per device
    equal to the specs' count, gathered back bit for bit; the meshless
    checkpoint restored onto that mesh (``restore(shardings=)``) and
    gathered bit for bit; a decode state and the batch placed by
    ``decode_state_specs`` and ``batch_specs``; then (after phase 20's
    profiled step) the gradient of the batch's two halves (1.0e9
    coordinates) compressed as two pods on ``Mesh((cuda:0,) * 2, "pod")``
    at the default config: linearity within its f32 bound, the residual
    identity exact, the sketch, unsketch and all-reduce times, the ratio
    and the peak; in phase 19, qwen2-7b in a GPipe schedule of 4 stages of
    7 cycles on ``Mesh((cuda:0,) * 4, "pipe")`` over 8 microbatches of 1 x
    512 tokens, equal to the stages run one after another bit for bit, its
    logits within phase 19's bound of a whole-batch forward, its wall and
    bubble fraction; after the rules, xlstm-1.3b sequence-parallel on
    ``(data 1, model 4)``: in f32 (a witness) a prefill of 2 x 2048 against
    the meshless one (logits within 4 sqrt(K) 2^-16 max|logit|, each
    cycle's final state within 4 sqrt(c + 1) 2^-16 max|s_c|) and 8 decode
    steps from its state against the forward; in bf16 (the published
    config) the same printed beside the meshless prefill at the spans'
    chunking, with tokens/s; 2 train steps (finite gradient norms, the
    first loss within 2^-7 relative of the meshless loss).

23. the tooling (no new kernel): in phase 20, one more gemma3-1b train
    step (4 x 1024) under ``launch.op_analysis`` on the card, whose FLOPs
    (bf16 and f32), bytes, least bytes and ops must equal the dry run's
    count of the same cell on meta tensors (``launch.dryrun``, one card, one
    microbatch) and whose counted peak must lie within 0.8-1.25x of the
    allocator's peak over what was held; the same in phase 19 for
    qwen2-7b's 4-lane decode step at cache 256; each step's one-card
    roofline bound (``launch.roofline``: bf16 and f32 products at their
    peaks, the least bytes over HBM) over its measured time (host clock
    ending in a sync, and the profiler's device time) must stay at or below
    1.05, printed with the model FLOP/s share, the dominant term and
    hbm_bytes / min_bytes; after phase 22, the dry run of the ten configs at
    decode_32k on one card, rendered as the roofline table; then the seven
    examples of ``repro_torch.examples`` on the card, each held to its own
    checks (served counters equal to the standalone build; the refusal
    round and ledger of the private server; the quality bars of the
    example tests; every served request completed; ``train_lm --smoke``'s
    loss falling and its resume from step 10 giving the uninterrupted run's
    losses bit for bit), with their kernel launches.

The ``kernels`` line's launches are the main path's (phases 5, 7, 9, 10, 12,
13, 16, 19, 21, 23) plus phase 18's mesh runs (their meshless comparisons do
not count). The last two lines are the card (nvidia-smi's name and power limit)
and ``{"ok": true, "device": {...}}``. The run needs a CUDA card and the rest of
the repository beside this file; without either it exits non-zero.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from collections import deque
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# H100 SXM data sheet: fp32 outside the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# The main path's configuration: airfoil-matched widths, a day of 50 Hz
# telemetry from one device, and the default StormRegressorConfig.
N_ROWS = 1 << 22
D_FEATURES, NOISE, CONDITION = 9, 0.3, 30.0

# The single-sided path: the margin shapes of EXPERIMENTS.md's ERM table
# (R = 1024, p = 2 for the margins, p = 4 for kmeans) at the stream's size.
MARGIN = 0.5
CLS_ROWS, CLS_PLANES, KMEANS_PLANES = 1024, 2, 4

# The banked path: 16 tenants' streams of 2^18 rows (2^22 in all), the last
# one short, each its own airfoil-matched draw.
TENANTS, TENANT_ROWS, TENANT_SHORT = 16, 1 << 18, 1000

# A wide fit: 40 features (41 paired columns, past the narrow inserts' 32),
# a million rows. In 41 dimensions the default DFO steps (sigma 0.5,
# learning rate 2) overshoot, so smaller steps over more query points and
# rows. Even so the fit's quality depends on the draw, so the phase holds
# the kernel fit to the plain-version fit bit for bit and reports R^2.
WIDE_ROWS, WIDE_FEATURES, WIDE_NOISE = 1 << 20, 40, 0.2
WIDE_HASH_ROWS, WIDE_STEPS, WIDE_K = 4096, 400, 32
WIDE_SIGMA, WIDE_LR = 0.15, 0.25
# The wide inserts' timing shape (phase 11).
WIDE_TIME_ROWS, WIDE_TIME_D = 1 << 16, 515


# Kernel 7 (srp_hash) on its own entry point: the regression family's hash
# (R = 2048, p = 4 over the 12 augmented features) on a quarter-million
# query points (the codes of the full 2^22-row stream would be 32 GiB),
# then ragged shapes through both of the kernel's paths.
SRP_ROWS = 1 << 18
SRP_RAGGED = ((100_003, 11, 2048, 8), (100_003, 31, 33, 30),
              (100_003, 515, 33, 1))
# Both paths' new shapes (n, d, R, p): the register path's exact widths
# (d = 12, 11) and generic bodies, the projection tile's pass layouts and
# tails, and codes past 2^31 elements (64-bit offsets).
SRP_TILE = ((0, 12, 2048, 4), (1, 12, 2048, 4), (63, 13, 2048, 9),
            (100_003, 12, 2048, 4), (100_003, 11, 33, 2),
            (100_003, 12, 33, 8), (100_003, 32, 2048, 4),
            (100_003, 1, 1, 1), (100_003, 33, 1000, 8), (1, 4099, 33, 1),
            (63, 4099, 2048, 30), (8_191, 515, 2048, 4),
            (100_003, 515, 33, 9), ((1 << 20) + 1, 12, 2048, 4))

# The serving gateway at the regression family's width: 16 tenants warm
# started from phase 7's bank, 4096 ingest and 32 query slots each, and per
# tenant and round 2048 rows and 17 query points (one k = 8 DFO step).
# Rounds 192-223 carry no queries and 224-255 no ingest, so all three tick
# bodies run; a 50-step regression fit over tenants 0-3 every 64 rounds.
GW_INGEST_SLOTS, GW_QUERY_SLOTS = 4096, 32
GW_INGEST_RATE, GW_QUERY_RATE = 2048, 17
GW_ROUNDS, GW_INGEST_ONLY, GW_QUERY_ONLY = 256, range(192, 224), range(224, 256)
GW_FIT_EVERY, GW_FIT_COHORT, GW_FIT_STEPS = 64, (0, 1, 2, 3), 50
GW_REF_ROUNDS, GW_NARROW_ROUNDS, GW_SINGLE_ROUNDS = 32, 64, 16
GW_PROFILE_TICKS = 64
# The tiered gateway: 64 tenants over 16 resident int16 slots. Each round
# draws 16 tenants under Zipf(1.1), each sending a quarter of a gateway
# tenant's round (512 rows, 4 points), so that the most-drawn tenant stays
# within its slots and the tail keeps swapping.
TIERED_TENANTS, TIERED_HOT, TIERED_ROUNDS, TIERED_DRAWS = 64, 16, 128, 16
TIERED_ROWS, TIERED_POINTS = GW_INGEST_RATE // 4, 4
ZIPF_EXPONENT, TIERED_PROMOTE_PER_TICK = 1.1, 4
# The private gateway (phase 16) at the gateway's width: 64 rounds of
# synth_traffic under ReleasePolicy(epsilon_total=48, epsilon_release=1);
# rounds 32-39 carry no ingest, so their reads re-read open windows for
# free. A 50-step cohort fit over tenants 0-3 every 16 rounds and one over
# tenant 5 alone (the lone f32 query) every 16 rounds from round 8.
PRIV_ROUNDS, PRIV_NO_INGEST = 64, range(32, 40)
PRIV_EPS_TOTAL, PRIV_EPS_RELEASE, PRIV_FIT_EVERY = 48.0, 1.0, 16
PRIV_LONE_TENANT, PRIV_PROFILE_TICKS = 5, 16
# The wire (phase 17): 4 tenants at the gateway's widths, 8 requests of
# 2048 rows each, a 17-point query after each.
WIRE_TENANTS, WIRE_CHUNKS, WIRE_POINTS = 4, 8, 17
# Distributed (phase 18): meshes of 1 and 4 shards on one card; a fleet of
# 16 members against the merged sketch; phase 7's bank with 2 restarts per
# tenant.
MESH_SHARDS, MESH_MEMBERS, MESH_RESTARTS = (1, 4), 16, 2
# The LM path (phase 19): qwen2-7b at its published width, random init from
# a seed, served as the reference launcher serves it (4 slots, cache 256,
# 8 greedy requests of 8-token prompts and 16 new tokens), tapped at cycles
# 13 and 27 into a 2-tenant paired gateway whose hash family spans
# d_model + 3 = 3587 dimensions (R = 2048, p = 4), flushed every 64 rows;
# the probe stream is 2048 + 512 held-out random 16-token sequences.
LM_ARCH, LM_SLOTS, LM_CACHE = "qwen2-7b", 4, 256
LM_REQUESTS, LM_PROMPT, LM_NEW = 8, 8, 16
LM_TAPS, LM_TARGET = (13, 27), "entropy"
LM_TENANTS, LM_HASH_ROWS, LM_PLANES = 2, 2048, 4
LM_WINDOW, LM_INGEST_SLOTS = 64, 256
LM_PROBE_SEQS, LM_HELDOUT, LM_PROBE_LEN, LM_PROBE_BATCH = 2048, 512, 16, 256
LM_CHECK_LEN, LM_CHECK_DECODE = 32, 8
LM_PLAIN_STEPS, LM_QUERY_M, LM_PROFILE_STEPS = 8, (17, 34), 32
# The probe fits' DFO step at d = 3585, with the probe's default ridge: the
# default step (lr 2) diverges there and the zero guard wins; lr 0.01 leaves
# the guard and its traces follow the scan engine's (PERF.md §6, from
# scripts/lm_probe_sweep.py).
LM_PROBE_LR, LM_PROBE_L2 = 0.01, 3e-2
# The training path (phase 20): gemma3-1b at its published widths and depth
# (26 layers, d_model 1152, vocab 262144, bf16 parameters; 1.0e9 of them),
# random init from a seed, the reference's AdamW defaults (f32 master, mu
# and nu) but for a 2-step warmup to lr 1e-3, on one fixed batch of 4 x
# 1024 random tokens (past the 512-token local window; two 512-token xent
# chunks). The trainer runs 4 steps with one save (keep 1), resumes to 6;
# the checkpoints go under .chip_scratch/ (gitignored), removed at the end.
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ = "gemma3-1b", 4, 1024
TRAIN_LR, TRAIN_WARMUP, TRAIN_FIRST, TRAIN_RESUME = 1e-3, 2, 4, 6
TRAIN_SLOTS, TRAIN_CACHE, TRAIN_REQUESTS, TRAIN_NEW = 4, 256, 4, 8
# H100 SXM data sheet: dense bf16 on the tensor cores.
PEAK_BF16_FLOPS = 989e12
# The six non-dense LMs (phase 21), each at its published widths in bf16,
# random init from a seed: xlstm-1.3b (48 mLSTM blocks), zamba2-2.7b (45
# Mamba2 blocks and 9 calls of one shared attention block), musicgen-medium
# (48 layers over frame embeddings) and llama-3.2-vision-11b (32 attention
# and 8 cross-attention layers onto 4096 frontend states) at full depth;
# mixtral-8x22b at 4 of its 56 layers and phi3.5-moe at 8 of its 32: their
# full bf16 weights need 262 and 78 GiB. Each prefills 2 x 2048 tokens
# (two 1024-token chunks) and decodes 8 tokens against the forward over
# all 2056 (the MoE pair at capacity factor = experts, so that no token
# is dropped; the recurrent pair decodes 64, the first 8 held, and xlstm
# again in f32, all 64 held, as a witness that the drift is rounding);
# two fresh engines (4 slots, cache 256, 8 greedy requests of 8 + 8
# tokens) serve each token-input model. zamba2 is served with taps
# at cycles 4 and 8 into a 2-tenant gateway at d = 2560 + 3; xlstm trains
# 3 steps of 2 x 2048 tokens.
ND_ARCHS = ("xlstm-1.3b", "zamba2-2.7b", "mixtral-8x22b",
            "phi3.5-moe-42b-a6.6b", "musicgen-medium", "llama-3.2-vision-11b")
ND_LAYERS = {"mixtral-8x22b": 4, "phi3.5-moe-42b-a6.6b": 8}
ND_BATCH, ND_PREFILL, ND_DECODE = 2, 2048, 8
ND_DECODE_RECURRENT, ND_WITNESS_ARCH = 64, "xlstm-1.3b"
ND_SLOTS, ND_CACHE, ND_REQUESTS, ND_PROMPT, ND_NEW = 4, 256, 8, 8, 8
ND_TIMED_STEPS, ND_STATE_CACHES = 8, (256, 4096)
ND_TAP_ARCH, ND_TAPS = "zamba2-2.7b", (4, 8)
ND_TRAIN_ARCH, ND_TRAIN_STEPS, ND_TRAIN_LR = "xlstm-1.3b", 3, 1e-3
# The LM's sharding (phase 22). The rules of all ten configs at full size
# on the production meshes (16 x 16 and 2 x 16 x 16, named on one card,
# shape-only trees); phase 20's gemma3-1b train state placed on (data 2,
# model 2) of one card named 4 times, its checkpoint restored there; xlstm-1.3b
# (arXiv:2405.04517) sequence-parallel on (data 1, model 4): a prefill of
# 2 x 2048, 8 decode steps, 2 train steps; qwen2-7b (arXiv:2407.10671, phase
# 19's model) in a GPipe schedule of 4 stages of 7 cycles over 8
# microbatches of 1 x 512 tokens; gemma3-1b's (arXiv:2503.19786) gradient of
# two microbatch halves compressed as two pods at the default config.
SHARD_GRID, SP_ARCH, SP_MODEL, SP_TRAIN_STEPS = (2, 2), "xlstm-1.3b", 4, 2
PIPE_STAGES, PIPE_MICRO, PIPE_LEN = 4, 8, 512
PRESS_PODS = 2



@contextlib.contextmanager
def no_host_sync(torch):
    """Any device->host read or blocking copy inside raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def gateway_script(serve, gw_mod, seed, rounds, tenants, dim, fits=True,
                   augment=None):
    """Per-round request lists from the launcher's ``synth_traffic``
    (``augment`` maps single-sided rows to the augmented space)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rids = itertools.count()
    script = []
    for i in range(rounds):
        ingest = 0 if i in GW_QUERY_ONLY else GW_INGEST_RATE
        query = 0 if i in GW_INGEST_ONLY else GW_QUERY_RATE
        reqs = serve.synth_traffic(rng, rids, tenants, dim, ingest, query)
        if augment is not None:
            reqs = [dataclasses.replace(r, z=augment(r.z))
                    if isinstance(r, gw_mod.IngestRequest) else r
                    for r in reqs]
        if fits and (i + 1) % GW_FIT_EVERY == 0:
            reqs.append(gw_mod.FitRequest(
                rid=next(rids), tenants=list(GW_FIT_COHORT), seed=i,
                steps=GW_FIT_STEPS))
        script.append(reqs)
    return script


def zipf_script(gw_mod, seed, rounds, tenants, dim):
    """Per-round requests of ``TIERED_DRAWS`` tenants drawn Zipf(1.1),
    each draw ``Poisson(TIERED_ROWS)`` rows as ``synth_traffic`` makes them
    and ``Poisson(TIERED_POINTS)`` query points."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rids = itertools.count()
    prob = np.arange(1, tenants + 1, dtype=np.float64) ** -ZIPF_EXPONENT
    prob /= prob.sum()
    script = []
    for _ in range(rounds):
        reqs = []
        for t in rng.choice(tenants, size=TIERED_DRAWS, p=prob):
            z = rng.normal(size=(int(rng.poisson(TIERED_ROWS)), dim))
            z = (z * (0.4 / np.sqrt(dim))).astype(np.float32)
            reqs.append(gw_mod.IngestRequest(rid=next(rids), tenant=int(t),
                                             z=z))
            th = rng.normal(size=(int(rng.poisson(TIERED_POINTS)), dim))
            reqs.append(gw_mod.QueryRequest(rid=next(rids), tenant=int(t),
                                            thetas=th.astype(np.float32)))
        script.append(reqs)
    return script


def drive(gw, script, depth=1, on_start=None, guard=None, drain=True):
    """Submit each round and start a tick; finish ticks in order with up to
    ``depth`` in flight; then drain. Returns ``(reports, latencies,
    starts)``: a tick's latency is the host time from its start to its
    finish, ``starts`` the host time spent in ``tick_start``."""
    reports, latencies, starts, inflight = [], [], [], deque()

    def start():
        t0 = time.perf_counter()
        with guard() if guard is not None else contextlib.nullcontext():
            fl = gw.tick_start()
        starts.append(time.perf_counter() - t0)
        if on_start is not None:
            on_start(fl)
        inflight.append((fl, t0))

    def finish():
        fl, t0 = inflight.popleft()
        reports.append(gw.tick_finish(fl))
        latencies.append(time.perf_counter() - t0)

    for reqs in script:
        gw.submit_many(reqs)
        start()
        while len(inflight) >= depth:
            finish()
    while inflight or (drain and gw.pending):
        if drain and gw.pending and len(inflight) < depth:
            start()
        else:
            finish()
    return reports, latencies, starts


def streams_of(script, gw_mod, tenants):
    """Each tenant's ingested rows, in submission order."""
    import numpy as np

    rows = [[] for _ in range(tenants)]
    for reqs in script:
        for r in reqs:
            if isinstance(r, gw_mod.IngestRequest):
                rows[r.tenant].append(r.z)
    return [np.concatenate(z) if z else np.zeros((0, 1), np.float32)
            for z in rows]


class TickLog:
    """``on_start`` hook: each tick's placements and a copy of the bank
    right behind its body (the counters its queries and fits read)."""

    def __init__(self, gw):
        self.gw = gw
        self.placements = []  # (tick, rid, req_offset, tenant, count)
        self.snaps = {}       # tick -> (counts, n)

    def __call__(self, fl):
        for st, off, t, _, take in fl.placements:
            self.placements.append((fl.tick, st.req.rid, off, t, take))
        bank = self.gw.bank
        self.snaps[fl.tick] = (bank.counts.clone(), bank.n.clone())


def check_queries(log, reports, script, gw_mod, w, paired, ops, sketch_lib,
                  torch):
    """Every served point equals a standalone query of its tenant's lone
    sketch as it stood at the tick that served it. Returns the count."""
    thetas = {r.rid: r.thetas for reqs in script for r in reqs
              if isinstance(r, gw_mod.QueryRequest)}
    losses = {r.rid: r.losses for rep in reports for r in rep.results}
    if set(losses) != set(thetas):
        raise AssertionError("not every query request completed once")
    dev = w.device
    for tick, rid, off, t, take in log.placements:
        counts, n = log.snaps[tick]
        want = ops.query_theta_with_weights(
            sketch_lib.Sketch(counts=counts[t], n=n[t]), w,
            torch.from_numpy(thetas[rid][off:off + take]).to(dev),
            paired=paired)
        if not (want.cpu().numpy() == losses[rid][off:off + take]).all():
            raise AssertionError(f"query {rid} (tick {tick}, tenant {t}) "
                                 f"differs from the standalone query")
    return len(log.placements)

def privacy_script(serve, gw_mod, seed, rounds, tenants, dim, fits=True):
    """Per-round requests of the private gateway: ``synth_traffic`` with no
    ingest in ``PRIV_NO_INGEST``, and the cohort fits."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rids = itertools.count()
    script = []
    for i in range(rounds):
        ingest = 0 if i in PRIV_NO_INGEST else GW_INGEST_RATE
        reqs = serve.synth_traffic(rng, rids, tenants, dim, ingest,
                                   GW_QUERY_RATE)
        if fits and (i + 1) % PRIV_FIT_EVERY == 0:
            reqs.append(gw_mod.FitRequest(
                rid=next(rids), tenants=list(GW_FIT_COHORT), seed=i,
                steps=GW_FIT_STEPS))
        if fits and (i + 1) % PRIV_FIT_EVERY == PRIV_FIT_EVERY // 2:
            reqs.append(gw_mod.FitRequest(
                rid=next(rids), tenants=[PRIV_LONE_TENANT], seed=i,
                steps=GW_FIT_STEPS))
        script.append(reqs)
    return script


def replay_private(privacy_lib, policy, seed, log, reports):
    """The gateway's read planning replayed on the host with a second view
    of the same seed, from what the gateway was seen to do: per tick, the
    slots it read (placed points, or refused requests), the counter
    versions (the device n behind the tick's ingest) and the fits it
    gathered. Returns ``(view, plans, fit_plans)``: ``plans[tick]`` is
    ``{slot: plan}``, ``fit_plans[rid]`` the plans of a fit's members (the
    last one ``"refuse"`` for a refused fit)."""
    view = privacy_lib.PrivateBankView(policy, seed=seed)
    read = {}
    for tick, _, _, slot, _ in log.placements:
        read.setdefault(tick, set()).add(slot)
    for rep in reports:
        for r in rep.results:
            if r.status == "refused":
                read.setdefault(rep.tick, set()).add(r.tenant)
    fits_at = {}
    for rid, (tick, req, _, _) in log.fits.items():
        fits_at.setdefault(tick, []).append(req)
    plans, fit_plans = {}, {}
    for tick in sorted(log.snaps):
        versions = log.snaps[tick][1].tolist()
        shape = tuple(log.snaps[tick][0].shape[1:])
        plans[tick] = {slot: view.plan_read(slot, versions[slot], shape)
                       for slot in sorted(read.get(tick, ()))}
        for slot, plan in plans[tick].items():
            if plan.status == "fresh":
                view.mark_resident(slot)
        for req in fits_at.get(tick, ()):
            fit_plans[req.rid] = []
            for t in req.tenants:
                fit_plans[req.rid].append(view.plan_read(t, versions[t],
                                                         shape))
                if fit_plans[req.rid][-1].status == "refuse":
                    break
    return view, plans, fit_plans


class PrivateLog(TickLog):
    """``TickLog`` of a private gateway: also the lanes and release-time
    counts right behind each tick's body, and each fit's gathered sub-bank
    and status."""

    def __init__(self, gw):
        super().__init__(gw)
        self.lanes = {}  # tick -> (lanes, n_used)
        self.fits = {}   # rid -> (tick, request, sub-bank or None, status)

    def __call__(self, fl):
        super().__call__(fl)
        self.lanes[fl.tick] = (self.gw._release.clone(),
                               self.gw._n_used.clone())
        for req, sub, status in fl.fits:
            self.fits[req.rid] = (fl.tick, req, sub, status)


def _log(*args) -> None:
    print(*args, flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _median_ms(fn, reps: int, torch) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_events(prof):
    """``(name, µs)`` of every device activity a torch.profiler run recorded."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if getattr(e, "device_type", None) == DeviceType.CUDA]


def _kernel_named(symbol: str, name: str) -> bool:
    """Whether a profiler kernel name is the device function ``symbol``
    (demangled ``ns::symbol<...>`` or mangled ``<len>symbol``)."""
    return f"::{symbol}" in name or f"{len(symbol)}{symbol}" in name


def _device_ms(fn, calls: int, torch, symbol=None, records=None):
    """Device time per call of ``fn`` from torch.profiler; None if it saw no
    device work. With ``symbol`` (a kernel that ``fn`` launches once per
    call), the mean over the records of that kernel: the profiler has been
    seen to drop a record of a long kernel, and dividing by ``calls`` then
    undercounts. ``records``, a list, receives the µs of every matched
    record."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    matched = [us for name, us in _device_events(prof)
               if symbol is None or _kernel_named(symbol, name)]
    if records is not None:
        records.extend(matched)
    total = sum(matched)
    per = len(matched) if symbol is not None else calls
    return total / per / 1e3 if total > 0 else None


def _fit_profile(label, fit, torch, symbols):
    """Profile one fit and print its wall time, device busy share and the
    device time of each of ``symbols`` and of the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    by_name = {}
    for name, us in _device_events(prof):
        by_name[name] = by_name.get(name, 0.0) + us / 1e3
    busy = sum(by_name.values())
    if busy <= 0:
        _log(f"[{label}] the profiler saw no device work ({wall:.3f} s wall)")
        return
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    top = ", ".join(f"{n[:40]} {t:.2f} ms" for n, t in ranked[:5])
    own = ", ".join(
        f"{sym} {sum(t for n, t in ranked if _kernel_named(sym, n)):.2f} ms"
        for sym in symbols)
    _log(f"[{label}] under the profiler: {wall * 1e3:.1f} ms wall, device "
         f"busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}%); {own}; "
         f"top kernels: {top}")


def _pct(v) -> str:
    """p50 and p99 of host-clock seconds, in ms."""
    ms = [1e3 * x for x in v]
    return (f"p50 {statistics.median(ms):.4f} ms, p99 "
            f"{statistics.quantiles(ms, n=100)[98]:.4f} ms")


def _gateway_profile(torch, gw, script, label="gateway", shards=1):
    """Device busy share of ``GW_PROFILE_TICKS`` full pipelined ticks, and
    the device time per tick of the insert and the query kernels (one
    launch of each per shard and tick)."""
    from torch.profiler import ProfilerActivity, profile

    drive(gw, script[:4])  # warm-up
    rounds = script[4:4 + GW_PROFILE_TICKS]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        reps, *_ = drive(gw, rounds, depth=2, drain=False)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - start)
    events = _device_events(prof)
    busy = sum(us for _, us in events) / 1e3
    # A full tick launches each kernel once: per tick is the mean over the
    # kernel's records (the profiler may drop one).
    per_tick, seen = {}, {}
    for sym in ("paired_hist_kernel", "sketch_query_kernel"):
        mine = [us for n, us in events if _kernel_named(sym, n)]
        seen[sym] = len(mine)
        per_tick[sym] = shards * sum(mine) / 1e3 / max(len(mine), 1)
    _log(f"[time] {label} under the profiler: {len(reps)} full pipelined "
         f"ticks, {wall:.3f} ms wall, device busy {busy:.3f} ms "
         f"({100 * busy / wall:.2f}%); per tick: insert "
         f"{per_tick['paired_hist_kernel']:.4f} ms "
         f"({seen['paired_hist_kernel']} records), query "
         f"{per_tick['sketch_query_kernel']:.4f} ms "
         f"({seen['sketch_query_kernel']} records)")


def _private_profile(torch, gw, script):
    """Device time per full private tick of ``PRIV_PROFILE_TICKS``
    pipelined ticks under the profiler: the insert, the f32 query, the
    host->device transfer and the rest of the private body (the release's
    elementwise work and the estimates' masking)."""
    from torch.profiler import ProfilerActivity, profile

    drive(gw, script[:4])  # warm-up
    rounds = script[4:4 + PRIV_PROFILE_TICKS]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        reps, *_ = drive(gw, rounds, depth=2, drain=False)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - start)
    events = _device_events(prof)
    busy = sum(us for _, us in events) / 1e3
    parts = {"insert": 0.0, "query": 0.0, "copy": 0.0, "release": 0.0}
    for name, us in events:
        key = ("insert" if _kernel_named("paired_hist_kernel", name) else
               "query" if _kernel_named("sketch_query_kernel", name) else
               "copy" if "memcpy" in name.lower() else "release")
        parts[key] += us / 1e3
    n = max(len(reps), 1)
    _log(f"[time] private gateway under the profiler: {len(reps)} full "
         f"pipelined ticks, {wall:.3f} ms wall, device busy {busy:.3f} ms "
         f"({100 * busy / wall:.2f}%); per tick: device {busy / n:.4f} ms = "
         f"insert {parts['insert'] / n:.4f} + f32 query "
         f"{parts['query'] / n:.4f} + transfers {parts['copy'] / n:.4f} + "
         f"release and masking {parts['release'] / n:.4f} ms; the private "
         f"body {(parts['query'] + parts['release']) / n:.4f} ms")


def _sm_max_mhz() -> int:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return int(out.stdout.split()[0])


def _floor_ms(multiply_adds: float, torch) -> float:
    """The bit-exact contract's floor: a rounded multiply and a rounded add
    (no FMA) per multiply-add, at one fp32 instruction per lane per cycle
    on every SM at the card's top SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 2.0 * multiply_adds / (sms * 128 * _sm_max_mhz() * 1e6) * 1e3


def _bound(bytes_moved: float, flops: float):
    by_bytes = bytes_moved / PEAK_HBM_BYTES * 1e3
    by_ops = flops / PEAK_FP32_FLOPS * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations"))


def _generic_query_report(torch, label, fn, plain, q, w, banked, table_cells,
                          smi):
    """Time one query of the generic body (``fn``, already checked against
    its plain version) at its shape: CUDA events and the profiler per
    launch, beside its bound, its no-FMA floor and the cuBLAS time of the
    projection alone (``torch.matmul(q, w)`` in full fp32: w read once, no
    codes, no gather, another summation order)."""
    m = q.shape[0]
    p_, d_, r_ = w.shape
    ev_ms = _median_ms(fn, 20, torch)
    dev_ms = _device_ms(fn, 20, torch, "sketch_query_kernel")
    plain_ms = _median_ms(plain, 1, torch)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        blas_ms = _median_ms(lambda: torch.matmul(q, w), 20, torch)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    bound, by = _bound(
        bytes_moved=4 * (q.numel() + w.numel() + m + (m if banked else 0)
                         + min(m * r_, table_cells)),
        flops=2.0 * m * d_ * r_ * p_)
    floor = _floor_ms(float(m) * d_ * r_ * p_, torch)
    _log(f"[time] {label} generic body at d={d_} m={m} R={r_} p={p_} (equal "
         f"to its plain version): {1e3 * ev_ms:.2f} us per call by CUDA "
         f"events, device "
         f"{dev_ms if dev_ms is None else round(1e3 * dev_ms, 2)} us; bound "
         f"{1e3 * bound:.2f} us by {by}; no-FMA floor {1e3 * floor:.2f} us; "
         f"cuBLAS projection only {1e3 * blas_ms:.2f} us; plain version "
         f"{plain_ms:.2f} ms | {smi}")


@contextlib.contextmanager
def plain_versions():
    """Route every kernel wrapper to its plain PyTorch version (``ref``):
    a fit inside runs the kernels' arithmetic without the kernels, and
    counts no launch."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sketch_query as query_kernel
    from repro_torch.kernels import storm_sketch as insert_kernel

    names = {insert_kernel: ("paired_hash_histogram", "hash_histogram",
                             "paired_hash_histogram_banked",
                             "hash_histogram_banked"),
             query_kernel: ("sketch_query", "sketch_query_banked")}
    plain = {name: getattr(ref, name)
             for group in names.values() for name in group}
    # The banked query's wrapper also takes the caller's index_checked
    # flag, which the plain gather has no use for.
    plain["sketch_query_banked"] = (
        lambda q, w, counts, idx, index_checked=False:
        ref.sketch_query_banked(q, w, counts, idx))
    saved = [(mod, name, getattr(mod, name))
             for mod, group in names.items() for name in group]
    for mod, name, _ in saved:
        setattr(mod, name, plain[name])
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _held(torch, errs, key, got, want, what):
    """Hold a kernel's output against its plain version's bit for bit,
    recording the largest difference under ``key``."""
    gap = (got.to(torch.float64) - want.to(torch.float64)).abs().max()
    errs[key] = max(errs[key], float(gap))
    if not torch.equal(got, want):
        raise AssertionError(f"{what} differs from its plain version")


def _path_launches(counters, taps, steps, ticks, label):
    """The counts of a tapped serve into probes: one kernel 1 and ``steps
    + 1`` kernel 2 launches a tap layer (its sketch and ``fit_probe``),
    ``steps + 1`` kernel 6 launches (``fit_probes``) and one kernel 4
    launch a gateway tick, and nothing else."""
    launches = {name: c.launches for name, c in counters.items()}
    expected = dict(paired_hash_histogram=len(taps),
                    sketch_query=len(taps) * (steps + 1),
                    sketch_query_banked=steps + 1,
                    paired_hash_histogram_banked=ticks)
    if any(launches[name] != n for name, n in expected.items()) or sum(
            launches.values()) != sum(expected.values()):
        raise AssertionError(f"{label}'s main path made {launches}; "
                             f"expected {expected}")
    return launches


def _served_rows(torch, np, dev, seen):
    """The tap features ``(layers, n, d)`` and targets of the active lanes
    of every captured tap batch, on the card."""
    rows = [b.active() for b in seen]
    feats = torch.from_numpy(np.concatenate([f for f, _ in rows], axis=1))
    ys = torch.from_numpy(np.concatenate([y for _, y in rows]))
    return feats.to(dev), ys.to(dev)


def _served_against_offline(torch, np, dev, cfg, bridge, taps, seen,
                            hash_params, pconf, errs, label):
    """Each tap layer's served counters against ``sketch_features(moments=
    frozen)`` on the captured rows (kernel 1), bit for bit, and that build
    against kernel 1's plain version. Returns the offline states and the
    row count."""
    from repro_torch.core import probes
    from repro_torch.kernels import ops, ref

    feats, ys = _served_rows(torch, np, dev, seen)
    w = ops.from_lsh_params(hash_params)
    offline = []
    for j, layer in enumerate(taps):
        frozen = bridge.moments_of(cfg.name, layer)
        off = probes.sketch_features(None, feats[j], ys, pconf,
                                     moments=frozen, params=hash_params,
                                     device=dev)
        got = bridge.probe_state(cfg.name, layer)
        if not (torch.equal(got.sketch.counts, off.sketch.counts)
                and int(got.sketch.n) == int(off.sketch.n) == ys.numel()):
            raise AssertionError(f"{label}: the served counters of layer "
                                 f"{layer} differ from the offline build")
        zs, _ = probes.probe_rows(feats[j], ys, pconf, moments=frozen)
        plain = ref.paired_hash_histogram(
            zs.contiguous(), w, torch.ones(zs.shape[0], device=dev))
        _held(torch, errs, "paired_hash_histogram", off.sketch.counts,
              plain, f"{label}: kernel 1 at d = {w.shape[1]} (layer "
              f"{layer})")
        offline.append(off)
    return offline, ys.numel()


def _fit_probes_against_offline(torch, d, live, offline, dirs_many, fit_kw,
                                label):
    """``bridge.fit_probes``' result against the offline
    ``fit_probe_many`` bit for bit, and its first ``LM_PLAIN_STEPS`` steps
    (kernel 6) against the plain versions'."""
    from repro_torch.core import probes

    want = probes.fit_probe_many(None, offline, d, directions=dirs_many,
                                 **fit_kw)
    if not all(torch.equal(getattr(live, f), getattr(want, f))
               for f in ("theta", "intercept", "losses", "fleet_losses")):
        raise AssertionError(f"{label}: bridge.fit_probes differs from the "
                             f"offline fit_probe_many")
    short = dataclasses.replace(fit_kw["dfo_config"], steps=LM_PLAIN_STEPS)
    with plain_versions():
        plain_many = probes.fit_probe_many(
            None, offline, d, directions=dirs_many[:LM_PLAIN_STEPS],
            **dict(fit_kw, dfo_config=short))
    if not torch.equal(live.losses[:, :LM_PLAIN_STEPS], plain_many.losses):
        raise AssertionError(f"{label}: the served fit's first steps "
                             f"through kernel 6 differ from the plain "
                             f"versions'")


def lm_phase(torch, np, dev, smi, counters, errs):
    """Phase 19: qwen2-7b at full width, served with activation taps into
    STORM probes. Returns the launches of its main path (serving with taps
    into the gateway, the probe stream's sketches, the fits)."""
    from repro_torch.configs import registry
    from repro_torch.core import dfo, lsh, probes
    from repro_torch.device import generator
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sketch_query as query_kernel
    from repro_torch.kernels import storm_sketch as insert_kernel
    from repro_torch.models import layers, model
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.storm_gateway import StormGateway
    from repro_torch.telemetry import (TapConfig, TelemetryBridge,
                                       counter_distance, counter_kl,
                                       window_delta)
    from repro_torch.telemetry.taps import extract_tap_features

    t19 = time.perf_counter()
    cfg = registry.get_config(LM_ARCH)
    d = cfg.d_model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()

    # The model: every tensor drawn in f32 on the card and cast to bf16.
    start = time.perf_counter()
    params = model.init_params(generator(SEED + 19, dev), cfg, device=dev)
    torch.cuda.synchronize()
    n_params = model.param_count(params)
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, the config counts "
                             f"{cfg.param_count()}")
    _log(f"[lm] {cfg.name}: {cfg.num_layers} layers, d_model {d}, "
         f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
         f"{cfg.vocab_size}, {cfg.param_dtype}: {n_params} parameters "
         f"(cfg.param_count() {cfg.param_count()}), built in "
         f"{time.perf_counter() - start:.2f} s; max_memory_allocated "
         f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ("
         f"{before / 2**30:.2f} GiB held before the phase)")

    rng = np.random.default_rng(SEED + 19)
    prompts = [rng.integers(0, cfg.vocab_size, size=LM_PROMPT).astype(np.int32)
               for _ in range(LM_REQUESTS)]

    def requests():
        return [Request(rid=i, prompt=p, max_new_tokens=LM_NEW)
                for i, p in enumerate(prompts)]

    def serve(**kw):
        eng = ServeEngine(params, cfg, slots=LM_SLOTS, cache_len=LM_CACHE,
                          device=dev, **kw)
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = eng.run(requests())
        torch.cuda.synchronize()
        secs = time.perf_counter() - start
        return {c.rid: c.tokens for c in out}, eng, secs

    # Two fresh engines serve the same greedy requests: equal streams.
    first, _, first_s = serve()
    again, eng, again_s = serve()
    if first != again or sorted(first) != list(range(LM_REQUESTS)) or any(
            len(toks) != LM_NEW for toks in first.values()):
        raise AssertionError("two fresh engines served different streams")
    gen_tokens = LM_REQUESTS * LM_NEW

    # The main path: the tapped engine feeds a 2-tenant paired gateway
    # through the bridge; then the probe stream, its sketches and the fits.
    # The counts are read from here to the end of the fits.
    tap = TapConfig(cfg.name, layers=LM_TAPS, target=LM_TARGET)
    hash_params = lsh.init_srp(generator(SEED + 191, dev), LM_HASH_ROWS,
                               LM_PLANES, d + 3, device=dev)
    pconf = probes.ProbeConfig(rows=LM_HASH_ROWS, planes=LM_PLANES)
    gw = StormGateway(hash_params, tenants=LM_TENANTS,
                      ingest_slots=LM_INGEST_SLOTS, device=dev)
    bridge = TelemetryBridge(gw, pconf, window=LM_WINDOW)
    sink = bridge.register(tap, cfg)
    seen, flush_ms = [], []
    snaps = [gw.bank.counts.clone()]  # the bank at each window boundary

    def capture(batch):
        seen.append(batch)
        flushes = bridge.flushes
        start = time.perf_counter()
        sink(batch)
        if bridge.flushes > flushes:
            flush_ms.append(1e3 * (time.perf_counter() - start))
            snaps.append(gw.bank.counts.clone())

    for c in counters.values():
        c.launches = 0
    tapped, teng, tapped_s = serve(taps=tap, tap_sink=capture)
    start = time.perf_counter()
    bridge.flush()  # the tail window
    flush_ms.append(1e3 * (time.perf_counter() - start))
    snaps.append(gw.bank.counts.clone())
    if tapped != first:
        raise AssertionError("taps changed the served token streams")
    step_ms = {"untapped": 1e3 * again_s / eng.steps,
               "tapped": 1e3 * tapped_s / teng.steps}
    _log(f"[lm] serving: {LM_REQUESTS} greedy requests ({LM_PROMPT}-token "
         f"prompts, {LM_NEW} new tokens) over {LM_SLOTS} slots, cache "
         f"{LM_CACHE}: two fresh engines and the tapped engine (layers "
         f"{LM_TAPS}, target {LM_TARGET}) served the same streams; "
         f"{eng.steps} engine steps")

    # The probe stream: offline taps of random token sequences.
    n_seq = LM_PROBE_SEQS + LM_HELDOUT
    toks = torch.randint(0, cfg.vocab_size, (n_seq, LM_PROBE_LEN),
                         generator=generator(SEED + 192, dev), device=dev)
    feats, targets, batch_ms = [], [], []
    for lo in range(0, n_seq, LM_PROBE_BATCH):
        torch.cuda.synchronize()
        start = time.perf_counter()
        f_b, y_b = extract_tap_features(
            params, cfg, {"tokens": toks[lo:lo + LM_PROBE_BATCH]}, tap)
        torch.cuda.synchronize()
        batch_ms.append(1e3 * (time.perf_counter() - start))
        feats.append(f_b)
        targets.append(y_b)
    feats, targets = torch.cat(feats, dim=1), torch.cat(targets)
    if not (torch.isfinite(feats).all() and torch.isfinite(targets).all()
            and feats.shape == (len(LM_TAPS), n_seq, d)):
        raise AssertionError(f"probe stream {tuple(feats.shape)} not finite")
    train = slice(0, LM_PROBE_SEQS)
    held = slice(LM_PROBE_SEQS, n_seq)
    states = [probes.sketch_features(None, feats[j, train], targets[train],
                                     pconf, params=hash_params, device=dev)
              for j in range(len(LM_TAPS))]
    lm_dfo = dataclasses.replace(probes._PROBE_DFO, learning_rate=LM_PROBE_LR)
    fit_kw = dict(dfo_config=lm_dfo, l2=LM_PROBE_L2, device=dev)
    steps, k = lm_dfo.steps, lm_dfo.num_queries
    dirs = dfo.sphere_directions(generator(SEED + 193, dev), steps, 1, k,
                                 d + 1, dev)
    fits, fit_s = [], []
    for st in states:
        torch.cuda.synchronize()
        start = time.perf_counter()
        fits.append(probes.fit_probe(None, st, d, directions=dirs, **fit_kw))
        torch.cuda.synchronize()
        fit_s.append(time.perf_counter() - start)
    dirs_many = dfo.sphere_directions(generator(SEED + 194, dev), steps,
                                      len(LM_TAPS), k, d + 1, dev)
    live = bridge.fit_probes(None, directions=dirs_many, **fit_kw)
    torch.cuda.synchronize()
    lm_launches = _path_launches(counters, LM_TAPS, steps, gw.ticks,
                                 "phase 19")
    _log(f"[lm] main path launches: {lm_launches} ({gw.ticks} gateway "
         f"ticks)")

    # The bridge: served counters against the offline build of the same
    # rows under the frozen moments; fit_probes against fit_probe_many.
    offline, n_served = _served_against_offline(
        torch, np, dev, cfg, bridge, LM_TAPS, seen, hash_params, pconf, errs,
        cfg.name)
    _fit_probes_against_offline(torch, d, live, offline, dirs_many, fit_kw,
                                cfg.name)
    _log(f"[lm] bridge: {n_served} served rows per tap layer in "
         f"{bridge.flushes} flushes ({gw.ticks} ticks): each layer's counters "
         f"equal sketch_features(moments=frozen) on the captured rows, and "
         f"fit_probes equals the offline fit_probe_many (heads, traces, "
         f"selection losses), bit for bit; its first {LM_PLAIN_STEPS} steps "
         f"through kernel 6 equal the plain versions' (sketch loss "
         f"{[round(float(x), 6) for x in live.losses[:, 0]]} at step 0, "
         f"{[round(float(x), 6) for x in live.losses[:, -1]]} at the last, "
         f"|theta| {[round(float(x), 6) for x in live.theta.norm(dim=-1)]})")

    # The drift scorers on the card: each tap layer's first served window
    # against its last, window_delta of two card snapshots, against the
    # same scores of host copies.
    first = window_delta(snaps[0], snaps[1])
    last = window_delta(snaps[-2], snaps[-1])
    if not (first.is_cuda and last.is_cuda and len(snaps) > 2):
        raise AssertionError(f"{len(snaps) - 1} windows, deltas on "
                             f"{first.device}")
    drift = []
    for j, layer in enumerate(LM_TAPS):
        na, nb = int(first[j, 0].sum()) // 2, int(last[j, 0].sum()) // 2
        for score in (counter_distance, counter_kl):
            got = score(first[j], na, last[j], nb)
            if got != score(first[j].cpu().numpy(), na,
                            last[j].cpu().numpy(), nb):
                raise AssertionError(f"{score.__name__} of card deltas "
                                     f"differs from the host copies'")
            drift.append(f"layer {layer} {score.__name__} {got:.6f}")
    _log(f"[lm] drift scorers on card window deltas ({len(snaps) - 1} "
         f"windows; the first against the last, equal to the host copies' "
         f"scores): {', '.join(drift)}")

    # Kernel 1's wide body against its plain version.
    w = ops.from_lsh_params(hash_params)
    ones = torch.ones(LM_PROBE_SEQS, device=dev)
    for j, st in enumerate(states):
        zs, _ = probes.probe_rows(feats[j, train], targets[train], pconf)
        _held(torch, errs, "paired_hash_histogram", st.sketch.counts,
              ref.paired_hash_histogram(zs.contiguous(), w, ones),
              f"kernel 1 at d = {d + 3} (layer {LM_TAPS[j]})")

    # The fits: held-out quality; the first steps against the plain
    # versions bit for bit; the whole fit against the scan engine (the
    # plain versions' arithmetic in other kernels): both must leave the zero
    # guard, their traces agree within 2% and their held-out MSE within 2%.
    short = dataclasses.replace(lm_dfo, steps=LM_PLAIN_STEPS)
    short_kw = dict(fit_kw, dfo_config=short)
    got = probes.fit_probe(None, states[-1], d,
                           directions=dirs[:LM_PLAIN_STEPS], **short_kw)
    with plain_versions():
        plain_fit = probes.fit_probe(None, states[-1], d,
                                     directions=dirs[:LM_PLAIN_STEPS],
                                     **short_kw)
    if not (torch.equal(got.theta, plain_fit.theta)
            and torch.equal(got.losses, plain_fit.losses)):
        raise AssertionError("the kernel fit's first steps differ from the "
                             "plain versions'")
    scan = probes.fit_probe(None, states[-1], d, directions=dirs,
                            engine="scan", **fit_kw)
    for j, (layer, fit) in enumerate(zip(LM_TAPS, fits)):
        x_ho, y_ho = feats[j, held], targets[held]
        mse = float(fit.mse(x_ho, y_ho))
        mean_mse = float(((y_ho - targets[train].mean()) ** 2).mean())
        _log(f"[lm] fit_probe, layer {layer} (lr {LM_PROBE_LR}, l2 "
             f"{LM_PROBE_L2}): {fit_s[j]:.3f} s; held-out MSE {mse:.8g} "
             f"against the mean predictor's {mean_mse:.8g} (R^2 "
             f"{1 - mse / mean_mse:.6f}); train MSE "
             f"{float(fit.mse(feats[j, train], targets[train])):.8g}, var "
             f"{float(targets[train].var(correction=0)):.8g}; sketch loss "
             f"{float(fit.losses[0]):.6g} at step 0, final "
             f"{float(fit.fleet_losses[0]):.6g}; |theta| "
             f"{float(fit.theta.norm()):.6g}")
    kernel, kernel_mse = fits[-1], float(fits[-1].mse(feats[-1, held],
                                                      targets[held]))
    scan_mse = float(scan.mse(feats[-1, held], targets[held]))
    gap = float(((kernel.losses - scan.losses).abs()
                 / scan.losses.abs()).max())
    cos = float(kernel.theta @ scan.theta
                / (kernel.theta.norm() * scan.theta.norm()))
    _log(f"[lm] layer {LM_TAPS[-1]}: the first {LM_PLAIN_STEPS} DFO steps "
         f"through kernel 2 equal the plain versions' bit for bit; against "
         f"the scan engine's whole fit: trace apart by {gap:.6f} at most "
         f"(relative), held-out MSE {kernel_mse:.8g} and {scan_mse:.8g}, "
         f"cos(theta) {cos:.6f}")
    if not (kernel.theta.any() and scan.theta.any()):
        raise AssertionError("the zero guard won a probe fit: its head is "
                             "the mean predictor, whatever the queries")
    if not (gap <= 0.02 and abs(kernel_mse - scan_mse) <= 0.02 * scan_mse):
        raise AssertionError("the kernel fit and the scan fit differ by "
                             "more than 2% in trace or MSE")

    # Decode against forward, in bf16 (PERF.md §2, §6): per step, max|diff|
    # within 4 sqrt(2L + 1) u max|logit| and the relative L2 error of the
    # logits within sqrt(2L + 1) u, u = 2^-8 (2L + 1 rounded stages).
    check = torch.randint(0, cfg.vocab_size, (2, LM_CHECK_LEN),
                          generator=generator(SEED + 195, dev), device=dev)
    cdt = layers.dtype_of(cfg.compute_dtype)
    table = model.unembed_table(params, cfg)
    hidden, _ = model.forward(params, cfg, {"tokens": check})
    full = layers.unembed(table, hidden, cdt).to(torch.float32)
    prefix = LM_CHECK_LEN - LM_CHECK_DECODE
    state, logits = model.prefill(params, cfg, {"tokens": check[:, :prefix]},
                                  cache_len=LM_CHECK_LEN)
    diffs, rels = [], []

    def against(logits, pos):
        gap = logits.float() - full[:, pos]
        diffs.append(float(gap.abs().max()))
        rels.append(float((gap.norm(dim=-1) / full[:, pos].norm(dim=-1))
                          .max()))

    against(logits, prefix - 1)
    for pos in range(prefix, LM_CHECK_LEN):
        logits, state = model.decode_step(params, cfg, state,
                                          {"tokens": check[:, pos]}, pos)
        against(logits, pos)
    peak = float(full.abs().max())
    rel_limit = (2 * cfg.num_layers + 1) ** 0.5 * 2.0 ** -8
    limit = 4.0 * rel_limit * peak
    _log(f"[lm] decode against forward ({prefix}-token prefill, "
         f"{LM_CHECK_DECODE} decode steps, bf16): max|diff| "
         f"{max(diffs):.6f} per step {[round(x, 5) for x in diffs]}, "
         f"limit {limit:.6f} (max|logit| {peak:.4f}); relative L2 error "
         f"{max(rels):.6f} per step {[round(x, 5) for x in rels]}, limit "
         f"{rel_limit:.6f}")
    if not (max(diffs) <= limit and max(rels) <= rel_limit):
        raise AssertionError("decode drifted from the forward past its "
                             "bf16 limits")

    # The launcher, on the card.
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         check=True, timeout=600)
    _log(f"[lm] python -m repro_torch.launch.serve: "
         f"{out.stdout.strip().splitlines()[-1]}")

    # Timings, each beside the card.
    _log(f"[time] lm decode step: {step_ms['untapped']:.3f} ms untapped, "
         f"{step_ms['tapped']:.3f} ms tapped ({eng.steps} steps each, 4 "
         f"lanes); {gen_tokens / again_s:.1f} generated tokens/s untapped, "
         f"{gen_tokens / tapped_s:.1f} tapped ({first_s:.3f} s for the "
         f"first engine, warm-up included) | {smi}")
    per_batch = statistics.median(batch_ms)
    _log(f"[time] forward_taps + targets: median {per_batch:.3f} ms per "
         f"batch of {LM_PROBE_BATCH} x {LM_PROBE_LEN} tokens (min "
         f"{min(batch_ms):.3f}, max {max(batch_ms):.3f}, first "
         f"{batch_ms[0]:.3f}), "
         f"{LM_PROBE_BATCH * LM_PROBE_LEN / per_batch * 1e3:.0f} tokens/s "
         f"| {smi}")
    _log(f"[time] bridge flush (standardize, submit, drain): "
         f"{', '.join(f'{x:.3f}' for x in flush_ms)} ms | {smi}")
    _log(f"[time] fit_probe ({steps} DFO steps of k = {k}): "
         f"{', '.join(f'{s:.3f}' for s in fit_s)} s | {smi}")
    z0, _ = probes.probe_rows(feats[0, train], targets[train], pconf)
    z0 = z0.contiguous()
    n, dz = z0.shape
    p_, da, r_ = w.shape
    ins_ms = _median_ms(lambda: insert_kernel.paired_hash_histogram(
        z0, w, ones), 5, torch)
    ins_dev = _device_ms(lambda: insert_kernel.paired_hash_histogram(
        z0, w, ones), 5, torch, "projection_tile_kernel")
    ins_plain = _median_ms(lambda: ref.paired_hash_histogram(z0, w, ones), 1,
                           torch)
    macs = float(n) * da * r_ * p_
    ins_bound, ins_by = _bound(
        bytes_moved=4 * (z0.numel() + n + w.numel() + r_ * (1 << p_)),
        flops=2.0 * macs)
    _log(f"[time] kernel 1 wide (n={n} d={dz} p={p_} R={r_}): "
         f"{ins_ms:.4f} ms per call by CUDA events, device {ins_dev} ms; "
         f"plain version {ins_plain:.2f} ms; bound {ins_bound:.4f} ms by "
         f"{ins_by}; no-FMA floor {_floor_ms(macs, torch):.4f} ms | {smi}")
    # Kernel 4 at a bridge tick's shape: the 2 tap slots' ingest lanes,
    # LM_WINDOW rows valid in each.
    zb = torch.zeros((LM_TENANTS, LM_INGEST_SLOTS, dz), device=dev)
    zb[:, :LM_WINDOW] = z0[:LM_TENANTS * LM_WINDOW].reshape(
        LM_TENANTS, LM_WINDOW, dz)
    mb = torch.zeros((LM_TENANTS, LM_INGEST_SLOTS), device=dev)
    mb[:, :LM_WINDOW] = 1.0
    _held(torch, errs, "paired_hash_histogram_banked",
          insert_kernel.paired_hash_histogram_banked(zb, w, mb),
          ref.paired_hash_histogram_banked(zb, w, mb),
          f"kernel 4 at d = {da}")
    tick_ms = _median_ms(lambda: insert_kernel.paired_hash_histogram_banked(
        zb, w, mb), 20, torch)
    tick_plain = _median_ms(lambda: ref.paired_hash_histogram_banked(
        zb, w, mb), 1, torch)
    tick_macs = float(LM_TENANTS * LM_WINDOW) * da * r_ * p_
    tick_bound, tick_by = _bound(
        bytes_moved=4 * (zb.numel() + mb.numel() + w.numel()
                         + LM_TENANTS * r_ * (1 << p_)),
        flops=2.0 * tick_macs)
    _log(f"[time] kernel 4 wide at a bridge tick ({LM_TENANTS} x "
         f"{LM_INGEST_SLOTS} slots, {LM_WINDOW} valid each, d={dz}): "
         f"{tick_ms:.4f} ms per call by CUDA events; plain version "
         f"{tick_plain:.2f} ms; bound {tick_bound:.4f} ms by {tick_by}; "
         f"no-FMA floor {_floor_ms(tick_macs, torch):.4f} ms | {smi}")
    bank = gw.bank.counts
    for m in LM_QUERY_M:
        th = torch.randn(m, d + 1, generator=generator(SEED + m, dev),
                         device=dev)
        q = lsh.augment_query(lsh.normalize_query(th)).contiguous()
        idx = (torch.arange(m, device=dev, dtype=torch.int32)
               * LM_TENANTS // m)
        for name, fn, plain, table_cells in (
            ("kernel 2", lambda q=q: query_kernel.sketch_query(
                q, w, bank[0]), lambda q=q: ref.sketch_query(q, w, bank[0]),
             bank[0].numel()),
            ("kernel 6", lambda q=q, idx=idx: query_kernel.sketch_query_banked(
                q, w, bank, idx), lambda q=q, idx=idx:
             ref.sketch_query_banked(q, w, bank, idx), bank.numel()),
        ):
            key = ("sketch_query" if name == "kernel 2"
                   else "sketch_query_banked")
            _held(torch, errs, key, fn(), plain(),
                  f"{name}'s generic body at d = {da}, m = {m}")
            _generic_query_report(torch, name, fn, plain, q, w,
                                  name == "kernel 6", table_cells, smi)
    _engine_profile(torch, params, cfg, dev, prompts, smi)
    pipeline_phase(torch, dev, smi, params, cfg)
    # Phase 23 (a, b): the decode step's counts on the card against the
    # dry run's, and its bound against its times.
    tooling_decode(torch, dev, smi, params, cfg)
    _log(f"[lm] phase 19 took {time.perf_counter() - t19:.1f} s; its peak "
         f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
         f" GiB")
    return lm_launches


def _engine_profile(torch, params, cfg, dev, prompts, smi):
    """Device busy share of ``LM_PROFILE_STEPS`` engine steps, every lane
    generating, under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request, ServeEngine

    eng = ServeEngine(params, cfg, slots=LM_SLOTS, cache_len=LM_CACHE,
                      device=dev)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=2 * LM_PROFILE_STEPS)
            for i, p in enumerate(prompts[:LM_SLOTS])]
    eng.run(reqs, max_steps=LM_PROMPT + 2)  # prompts in, lanes generating
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        eng.run([], max_steps=eng.steps + LM_PROFILE_STEPS)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - start)
    busy = sum(us for _, us in _device_events(prof)) / 1e3
    _log(f"[time] engine loop under the profiler: {LM_PROFILE_STEPS} steps, "
         f"{wall:.3f} ms wall ({wall / LM_PROFILE_STEPS:.3f} ms a step), "
         f"device busy {busy:.3f} ms ({100 * busy / wall:.2f}%) | {smi}")


_TRAIN_KINDS = (
    ("f32 products (attention)", ("f32f32", "sgemm")),
    ("bf16 products", ("nvjet", "gemm", "xmma", "cutlass", "sm90_")),
    ("foreach (AdamW, norms)", ("multi_tensor", "foreach")),
    ("index and gather", ("index", "gather", "scatter", "embedding")),
    ("reductions", ("reduce", "softmax", "logsumexp", "norm")),
    ("copies and fills", ("memcpy", "memset", "copy", "fill")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def _train_kernel_kind(name: str) -> str:
    low = name.lower()
    for kind, keys in _TRAIN_KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def _tree_bytes(torch, tree) -> int:
    from repro_torch.train import tree as tree_lib

    return sum(t.numel() * t.element_size() for t in tree_lib.leaves(tree))


def train_phase(torch, np, dev, smi):
    """Phase 20: gemma3-1b trained at full width through the trainer, with
    resume, a restore bit for bit, remat's peak and the restored model
    served."""
    import gc
    import shutil

    from repro_torch.configs import registry
    from repro_torch.device import generator
    from repro_torch.models import model
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.train import checkpoint
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts
    from repro_torch.train import trainer
    from repro_torch.train import tree as tree_lib

    t20 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    scratch = ROOT / ".chip_scratch" / "train_phase"
    shutil.rmtree(scratch, ignore_errors=True)
    scratch.mkdir(parents=True)
    disk = shutil.disk_usage(scratch)
    cfg = registry.get_config(TRAIN_ARCH)
    tcfg = ts.TrainConfig(optimizer=opt_lib.AdamWConfig(
        learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP))
    n_params = cfg.param_count()
    _log(f"[train] {cfg.name}: {cfg.num_layers} layers, d_model "
         f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
         f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, local "
         f"window {cfg.local_window}, {cfg.param_dtype} params, remat "
         f"{cfg.remat_policy!r}: {n_params} parameters; AdamW lr "
         f"{TRAIN_LR}, warmup {TRAIN_WARMUP}, f32 master and moments; "
         f"batch {TRAIN_BATCH} x {TRAIN_SEQ}; {before / 2**30:.2f} GiB held "
         f"before the phase; disk under {scratch.parent.name}/: "
         f"{disk.free / 1e9:.1f} GB free of {disk.total / 1e9:.1f}")

    gen = torch.Generator().manual_seed(SEED + 20)
    toks = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                         generator=gen, dtype=torch.int64).to(torch.int32)
    batch = {"tokens": toks.to(dev), "labels": torch.roll(toks, -1,
                                                          dims=1).to(dev)}
    tokens = TRAIN_BATCH * TRAIN_SEQ

    # The trainer's step, recording what the loop does not report: each
    # step's metrics and its time on the host clock, ending in the sync of
    # reading the loss; and the state it leaves.
    record = {"ms": [], "grad_norm": [], "state": None}

    def step_fn(state, b):
        start = time.perf_counter()
        state, metrics = ts.train_step(state, b, cfg, tcfg)
        loss = float(metrics["loss"])
        record["ms"].append(1e3 * (time.perf_counter() - start))
        record["grad_norm"].append(float(metrics["grad_norm"]))
        record["state"] = state
        return state, {"loss": loss}

    saves, restores = [], []
    save, restore = checkpoint.save, checkpoint.restore

    def timed_save(directory, step, state, **kw):
        start = time.perf_counter()
        path = save(directory, step, state, **kw)
        saves.append((step, time.perf_counter() - start, sum(
            f.stat().st_size for f in Path(path).iterdir())))
        return path

    def timed_restore(directory, template):
        start = time.perf_counter()
        out = restore(directory, template)
        if out is not None:  # run 1 finds no checkpoint
            restores.append(time.perf_counter() - start)
        return out

    ckpt_dir = str(scratch / "ckpt")
    checkpoint.save, checkpoint.restore = timed_save, timed_restore
    try:
        r1 = trainer.train(
            generator(SEED + 20, dev), cfg, tcfg,
            trainer.LoopConfig(total_steps=TRAIN_FIRST, ckpt_every=100,
                               ckpt_dir=ckpt_dir, keep=1),
            lambda step: batch, step_fn=step_fn, device=dev)
        record["state"] = None  # run 1's state: run 2 starts from disk
        r2 = trainer.train(
            generator(SEED + 20, dev), cfg, tcfg,
            trainer.LoopConfig(total_steps=TRAIN_RESUME, ckpt_every=100,
                               ckpt_dir=ckpt_dir, keep=1),
            lambda step: batch, step_fn=step_fn, device=dev)
    finally:
        checkpoint.save, checkpoint.restore = save, restore
    state = record["state"]
    record["state"] = None
    losses = r1.losses + r2.losses
    band = (0.3 * np.log(cfg.vocab_size), 3 * np.log(cfg.vocab_size))
    _log(f"[train] trainer: run 1 {r1.steps_run} steps (resumed from "
         f"{r1.resumed_from}), run 2 {r2.steps_run} steps resumed from "
         f"{r2.resumed_from}, restores {r1.restores} + {r2.restores}; losses "
         f"{[round(x, 4) for x in losses]} (first in [{band[0]:.2f}, "
         f"{band[1]:.2f}]); grad norms "
         f"{[round(x, 4) for x in record['grad_norm']]}; step ms "
         f"{[round(x, 1) for x in record['ms']]} | {smi}")
    if not (r1.steps_run == TRAIN_FIRST and r1.resumed_from is None
            and r2.resumed_from == TRAIN_FIRST
            and r2.steps_run == TRAIN_RESUME - TRAIN_FIRST
            and r1.restores == 0 and r2.restores == 0):
        raise AssertionError("the trainer did not run, save and resume as "
                             "configured (or restored on a failure)")
    if [s for s, _, _ in saves] != [TRAIN_FIRST, TRAIN_RESUME] or \
            checkpoint.available_steps(ckpt_dir) != [TRAIN_RESUME]:
        raise AssertionError(f"saves at {[s for s, _, _ in saves]}, kept "
                             f"{checkpoint.available_steps(ckpt_dir)}")
    if not band[0] <= losses[0] <= band[1]:
        raise AssertionError(f"first loss {losses[0]} outside {band}")
    if not (all(np.isfinite(losses)) and all(np.isfinite(
            record["grad_norm"])) and losses[-1] < losses[0]):
        raise AssertionError("the loss did not fall or was not finite")
    if int(state.step) != TRAIN_RESUME or int(state.opt.step) != TRAIN_RESUME:
        raise AssertionError("the state's step counters are off")

    # The newest checkpoint into a fresh template: bit for bit the state
    # in memory.
    template = tree_lib.tree_map(
        lambda t: torch.empty_like(t).requires_grad_(t.requires_grad), state)
    start = time.perf_counter()
    step, restored, _ = checkpoint.restore(ckpt_dir, template)
    restores.append(time.perf_counter() - start)
    del template
    pairs = list(zip(tree_lib.leaf_paths(restored),
                     tree_lib.leaf_paths(state)))
    if step != TRAIN_RESUME or len(pairs) != len(tree_lib.leaves(state)):
        raise AssertionError(f"restored step {step}")
    for (name, a), (name_b, b) in pairs:
        if name != name_b or a.dtype != b.dtype or a.device != b.device \
                or not torch.equal(a.detach(), b.detach()):
            raise AssertionError(f"restored {name} differs from memory")
    n_tensors = len(pairs)
    del pairs
    state_bytes = _tree_bytes(torch, state)
    _log(f"[train] checkpoint: saves at steps "
         f"{[s for s, _, _ in saves]}, {[round(b / 1e9, 3) for _, _, b in saves]}"
         f" GB written in {[round(t, 2) for _, t, _ in saves]} s; restores "
         f"(resume, fresh template) in {[round(t, 2) for t in restores]} s; "
         f"the state ({state_bytes / 1e9:.3f} GB on the card: bf16 params, "
         f"f32 master, mu, nu) restored bit for bit (params, master, mu, nu, "
         f"steps: {n_tensors} tensors) | {smi}")

    # Serve the restored params and the params in memory: equal streams.
    rng = np.random.default_rng(SEED + 20)
    prompts = [rng.integers(0, cfg.vocab_size, size=8).astype(np.int32)
               for _ in range(TRAIN_REQUESTS)]

    def serve(params):
        eng = ServeEngine(params, cfg, slots=TRAIN_SLOTS,
                          cache_len=TRAIN_CACHE, device=dev)
        out = eng.run([Request(rid=i, prompt=p, max_new_tokens=TRAIN_NEW)
                       for i, p in enumerate(prompts)])
        return {c.rid: c.tokens for c in out}

    served = serve(restored.params)
    del restored
    if served != serve(state.params) or sorted(served) != list(
            range(TRAIN_REQUESTS)) or any(len(t) != TRAIN_NEW
                                          for t in served.values()):
        raise AssertionError("the restored params served other streams")
    _log(f"[train] served the restored params: {TRAIN_REQUESTS} greedy "
         f"requests over {TRAIN_SLOTS} slots, cache {TRAIN_CACHE}, "
         f"{TRAIN_NEW} new tokens each, the same streams as the params in "
         f"memory")

    # Remat: one step's gradients under "nothing" (the config's) and "none"
    # on the same state, with the peak each adds to what is held.
    grads, peaks = {}, {}
    for policy in ("nothing", "none"):
        c = dataclasses.replace(cfg, remat_policy=policy)
        gc.collect()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, g = ts.loss_and_grads(state.params, c, batch)
        torch.cuda.synchronize()
        peaks[policy] = (torch.cuda.max_memory_allocated(), held)
        grads[policy] = tree_lib.leaves(g)
        del g
        if not all(bool(torch.isfinite(x).all()) for x in grads[policy]):
            raise AssertionError(f"non-finite gradients under {policy!r}")
    # bf16 gradients: the embedding's backward adds with atomics on the
    # card, so each leaf is held within 2^-8 relative L2 (one bf16 rounding
    # of every element), and the leaves that came out bit for bit counted.
    rel = [float((a.float() - b.float()).norm() / b.float().norm().clamp(
        min=1e-30)) for a, b in zip(grads["nothing"], grads["none"])]
    same = sum(torch.equal(a, b) for a, b in zip(grads["nothing"],
                                                 grads["none"]))
    del grads
    adds = {k: (p - h) / 2**30 for k, (p, h) in peaks.items()}
    _log(f"[train] remat: gradients under 'nothing' against 'none': "
         f"{same} of {len(rel)} leaves bit for bit, max relative L2 "
         f"{max(rel):.3e} (limit 2^-8 = {2 ** -8:.3e}); peak "
         f"max_memory_allocated {peaks['nothing'][0] / 2**30:.2f} GiB "
         f"('nothing', {adds['nothing']:.2f} over the "
         f"{peaks['nothing'][1] / 2**30:.2f} held) against "
         f"{peaks['none'][0] / 2**30:.2f} GiB ('none', {adds['none']:.2f} "
         f"over {peaks['none'][1] / 2**30:.2f}) | {smi}")
    if max(rel) > 2 ** -8:
        raise AssertionError("remat changed the gradients")
    if not adds["nothing"] < adds["none"]:
        raise AssertionError("remat did not lower the peak")

    # Phase 22's placement and sharded restore, while the state in memory
    # is still the newest checkpoint's.
    shard_train_phase(torch, np, dev, smi, cfg, state, batch, ckpt_dir)

    # One more step under the profiler: the device's busy share and the
    # launches of a step.
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        state, metrics = ts.train_step(state, batch, cfg, tcfg)
        float(metrics["loss"])
        wall = 1e3 * (time.perf_counter() - start)
    events = _device_events(prof)
    busy = sum(us for _, us in events) / 1e3
    step_peak = torch.cuda.max_memory_allocated() / 2**30
    kinds, names = {}, {}
    for name, us in events:
        for key, table in ((_train_kernel_kind(name), kinds), (name, names)):
            ms, n = table.get(key, (0.0, 0))
            table[key] = (ms + us / 1e3, n + 1)
    by_time = lambda table: sorted(table.items(), key=lambda kv: -kv[1][0])
    _log("[train] a step's device time by kind: " + "; ".join(
        f"{k} {ms:.1f} ms ({100 * ms / busy:.1f}%, {n} launches)"
        for k, (ms, n) in by_time(kinds)) + f" | {smi}")
    _log("[train] a step's top kernels: " + "; ".join(
        f"{k[:100]} {ms:.1f} ms ({n})" for k, (ms, n) in by_time(names)[:10])
        + f" | {smi}")
    # Phase 23 (a, b): one more step counted on the card against the dry
    # run's count, and the bound against this phase's times.
    tooling_train(torch, smi, cfg, tcfg, state, batch,
                  statistics.median(record["ms"][1:]), busy)
    params = state.params
    del state  # phase 22's compression needs the parameters alone
    press_phase(torch, dev, smi, cfg, params, batch)
    del params
    steady = statistics.median(record["ms"][1:])
    flops = 6 * n_params * tokens / (steady / 1e3)
    _log(f"[time] train step (gemma3-1b, {TRAIN_BATCH} x {TRAIN_SEQ} "
         f"tokens, remat 'nothing', AdamW): steady {steady:.1f} ms (median "
         f"of steps 2-{len(record['ms'])} on the host clock, each ending "
         f"in a sync; first {record['ms'][0]:.1f} ms), "
         f"{tokens / steady * 1e3:.0f} tokens/s, model FLOP/s 6 N T / t = "
         f"{flops / 1e12:.1f} T ({100 * flops / PEAK_BF16_FLOPS:.1f}% of "
         f"the bf16 dense peak); under the profiler {wall:.1f} ms with "
         f"{busy:.1f} ms of device work (busy {100 * busy / wall:.2f}%), "
         f"{len(events)} device launches a step; peak max_memory_allocated "
         f"{step_peak:.2f} GiB a step | {smi}")
    _log(f"[time] checkpoint of {state_bytes / 1e9:.3f} GB: saves "
         f"{[round(t, 2) for _, t, _ in saves]} s "
         f"({[round(b / t / 1e9, 2) for _, t, b in saves]} GB/s), restores "
         f"{[round(t, 2) for t in restores]} s | {smi}")

    # The launcher, on the card (the smoke config, as phase 19's).
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         TRAIN_ARCH, "--smoke-config", "--steps", "4", "--ckpt-dir",
         str(scratch / "launcher")],
        cwd=ROOT, env=env, capture_output=True, text=True, check=True,
        timeout=600)
    line = out.stdout.strip().splitlines()[-1]
    if not line.startswith(f"arch={TRAIN_ARCH}-smoke steps=4 "):
        raise AssertionError(f"launcher: {line}")
    _log(f"[train] python -m repro_torch.launch.train: {line}")
    shutil.rmtree(scratch)
    _log(f"[train] phase 20 took {time.perf_counter() - t20:.1f} s")


def _rounded_stages(cfg) -> int:
    """The bf16 roundings of the residual stream between the embeddings and
    the logits: one per sublayer output (a recurrent mixer; an attention
    block and, where it has one, its FFN or MoE) and the final norm."""
    per_cycle = sum(1 if kind in ("mlstm", "mamba")
                    else 1 + bool(cfg.d_ff or cfg.is_moe)
                    for kind in cfg.cycle)
    return per_cycle * cfg.num_cycles + 1


@contextlib.contextmanager
def _routing_log(log):
    """Record each MoE layer's chosen experts, sorted over the choices,
    ``(k, groups, tokens)``, and its router logits ``(groups, tokens, E)``
    a call, in call order."""
    from repro_torch.models import moe

    dispatch = moe._top_k_dispatch

    def recorded(logits, k, capacity):
        routing, aux = dispatch(logits, k, capacity)
        log.append((routing.expert.sort(dim=0).values, logits.detach()))
        return routing, aux

    moe._top_k_dispatch = recorded
    try:
        yield
    finally:
        moe._top_k_dispatch = dispatch


def _near_ties(torch, fwd_log, other_log, k, limit_share):
    """The tokens whose top-k sets differ between the forward's routing
    and another path's over the same positions, each at the first MoE layer
    where they differ. Sets that differ swap some expert a in the one for
    some b in the other, so each path's gap between its k-th and (k+1)-th
    router logit is at most 2 max|delta|, delta the two paths' router
    logits' difference. The gap must lie within ``limit_share`` of the
    token's largest router logit (twice the bf16 size of delta), or the
    other path routed a token apart for another cause than a rounding.
    ``other_log`` is a list over layers of ``(experts (k, B, T), logits (B,
    T, E))``. Returns ``(apart (B, T) bool, [(b, t, layer, forward gap,
    other gap, max|delta|, limit)])``; raises on a gap past its limit."""
    differs = torch.stack([(f[0] != o[0]).any(dim=0)
                           for f, o in zip(fwd_log, other_log)])  # (L, B, T)
    apart = differs.any(dim=0)
    first = differs.to(torch.int8).argmax(dim=0)                 # (B, T)
    gaps = []
    for b, t in apart.nonzero().tolist():
        layer = int(first[b, t])
        lf, lo = (log[layer][1][b, t].float() for log in (fwd_log, other_log))
        gap_f, gap_o = (float(v[k - 1] - v[k])
                        for v in (lf.topk(k + 1).values,
                                  lo.topk(k + 1).values))
        delta = float((lf - lo).abs().max())
        limit = limit_share * float(lf.abs().max())
        gaps.append((b, t, layer, gap_f, gap_o, delta, limit))
        if max(gap_f, gap_o) > limit:
            raise AssertionError(
                f"a token (lane {b}, position {t}) routed apart at MoE "
                f"layer {layer} with router gaps {gap_f:.5f} (forward) and "
                f"{gap_o:.5f}, past {limit:.5f}: not a near tie")
    return apart, gaps


def _nd_inputs(torch, cfg, gen, dev, b, s):
    """A batch of ``s`` random tokens (frame embeddings for a model fed
    embeds) and, for cross-attention, ``cross_attn_tokens`` frontend
    states."""
    batch = {}
    if cfg.embeddings_provided:
        batch["embeds"] = 0.1 * torch.randn((b, s, cfg.d_model),
                                            generator=gen, device=dev)
    else:
        batch["tokens"] = torch.randint(0, cfg.vocab_size, (b, s),
                                        generator=gen, device=dev)
    if "cross_attn" in cfg.cycle:
        batch["cross_states"] = 0.1 * torch.randn(
            (b, cfg.cross_attn_tokens, cfg.d_model), generator=gen,
            device=dev)
    return batch


def _step_input(batch, pos):
    if "embeds" in batch:
        return {"embeds": batch["embeds"][:, pos:pos + 1]}
    return {"tokens": batch["tokens"][:, pos]}


def _decode_check(torch, cfg, params, batch, label, steps, held=None,
                  unit=2.0 ** -8, prefill_cfg=None, hold=True):
    """Prefill ``ND_PREFILL`` tokens, decode ``steps`` more, and hold the
    logits of the prefill's last token and the first ``held`` steps against
    the forward over all of them: max|diff| within 4 sqrt(K) u max|logit|,
    K = _rounded_stages(cfg) (four standard deviations of K independent
    roundings of unit u: 2^-8 in bf16), with the relative L2 error printed
    beside its one-deviation size sqrt(K) u. Steps past ``held`` are
    printed: a recurrent state carries each step's roundings into the
    next, which K independent roundings do not model. A MoE token whose
    routing in some layer differs between the two paths must be a near tie
    there (``_near_ties``: each path's router gap within twice the same
    4 sqrt(K) u of its largest router logit): a discontinuity of the model
    that a bf16 rounding crosses, not an error of decode. Its rows are
    counted and left out of the bound; more than a quarter of the rows left
    out fails. Returns the max|diff| and relative L2 as shares of their
    sizes, and the per-step max|diff|."""
    from repro_torch.models import layers, model

    held = ND_DECODE if held is None else held
    total = ND_PREFILL + steps
    fwd_log, pre_log, dec_logs = [], [], []
    with _routing_log(fwd_log):
        hidden, _ = model.forward(params, cfg, batch)
    cdt = layers.dtype_of(cfg.compute_dtype)
    full = layers.unembed(model.unembed_table(params, cfg),
                          hidden[:, ND_PREFILL - 1:], cdt).to(torch.float32)
    del hidden
    pre = {k: (v[:, :ND_PREFILL] if k in ("tokens", "embeds") else v)
           for k, v in batch.items()}
    with _routing_log(pre_log):
        state, logits = model.prefill(params, prefill_cfg or cfg, pre,
                                      cache_len=total)
    got = [logits.float()]
    for pos in range(ND_PREFILL, total):
        log = []
        with _routing_log(log):
            logits, state = model.decode_step(params, cfg, state,
                                              _step_input(batch, pos), pos)
        dec_logs.append(log)
        got.append(logits.float())
    del state
    stages = _rounded_stages(cfg)
    rel_limit = stages ** 0.5 * unit
    peak = float(full.abs().max())
    limit = 4.0 * rel_limit * peak
    b = full.shape[0]
    flipped = torch.zeros((b, len(got)), dtype=torch.bool,
                          device=full.device)
    moe_note = ""
    if fwd_log:
        # The prefill and decode routing over the forward's positions, per
        # layer; row j of the logits is position ND_PREFILL - 1 + j.
        other = [(torch.cat([pre_log[layer][0]]
                            + [log[layer][0] for log in dec_logs], dim=2),
                  torch.cat([pre_log[layer][1]]
                            + [log[layer][1] for log in dec_logs], dim=1))
                 for layer in range(len(fwd_log))]
        apart, gaps = _near_ties(torch, fwd_log, other,
                                 cfg.experts_per_token, 8.0 * rel_limit)
        shown = [tuple(round(x, 5) if isinstance(x, float) else x for x in g)
                 for g in gaps]
        flipped = apart[:, ND_PREFILL - 1:]
        moe_note = (f"; MoE tokens routed apart: {len(gaps)} of "
                    f"{apart.numel()}, each a near tie at its first such "
                    f"layer (lane, position, layer, router gap forward, "
                    f"decode, max|delta|, limit: "
                    f"{shown})")
    diffs, rels = [], []
    for j, logits in enumerate(got):
        gap = logits - full[:, j]
        diffs.append(gap.abs().amax(dim=-1))
        rels.append(gap.norm(dim=-1) / full[:, j].norm(dim=-1))
    diffs, rels = torch.stack(diffs, 1), torch.stack(rels, 1)
    kept = ~flipped
    kept[:, held + 1:] = False
    worst = float(diffs[kept].max()) if bool(kept.any()) else float("nan")
    worst_rel = float(rels[kept].max()) if bool(kept.any()) else float("nan")
    n_flipped = int(flipped.sum())
    per_step = diffs.where(~flipped, 0.0).amax(0).tolist()
    beyond = (f"; past step {held} (printed, not held): max|diff| "
              f"{max(per_step[held + 1:]):.6g}, relative L2 "
              f"{float(rels[:, held + 1:].max()):.6g}"
              if steps > held else "")
    _log(f"[nd] {label}: decode against forward ({ND_PREFILL}-token "
         f"prefill, {steps} decode steps, {cfg.compute_dtype}, K = {stages} "
         f"rounded stages, u = 2^{math.log2(unit):.0f}): to step {held} "
         f"max|diff| {worst:.6g}, limit {limit:.6g} (max|logit| "
         f"{peak:.4f}), relative L2 {worst_rel:.6g} (sqrt(K) u = "
         f"{rel_limit:.6g}){beyond}; per step max|diff| "
         f"{[float(f'{x:.5g}') for x in per_step]}"
         + (f"; {n_flipped} of {flipped.numel()} rows left out (max|diff| "
            f"there {float(diffs[flipped].max()) if n_flipped else 0.0:.5f})"
            + moe_note if fwd_log else ""))
    if hold and 4 * n_flipped > flipped.numel():
        raise AssertionError(f"{label}: {n_flipped} rows routed apart")
    if hold and not worst <= limit:
        raise AssertionError(f"{label}: decode drifted from the forward "
                             f"past its limit")
    return worst / limit, worst_rel / rel_limit, per_step


def _nd_probes(torch, np, dev, smi, cfg, params, counters, errs, prompts):
    """zamba2 served with taps into a 2-tenant gateway through the bridge
    (kernel 4), the served counters against the offline builds (kernel 1),
    a probe fit each (kernel 2) and ``fit_probes`` (kernel 6) against
    ``fit_probe_many``: phase 19's checks, through its helpers. Each kernel
    is held bit for bit against its plain version. Returns the launches of
    that path."""
    from repro_torch.core import dfo, lsh, probes
    from repro_torch.device import generator
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sketch_query as query_kernel
    from repro_torch.kernels import storm_sketch as insert_kernel
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.storm_gateway import StormGateway
    from repro_torch.telemetry import TapConfig, TelemetryBridge

    d = cfg.d_model
    tap = TapConfig(cfg.name, layers=ND_TAPS, target=LM_TARGET)
    hash_params = lsh.init_srp(generator(SEED + 211, dev), LM_HASH_ROWS,
                               LM_PLANES, d + 3, device=dev)
    pconf = probes.ProbeConfig(rows=LM_HASH_ROWS, planes=LM_PLANES)
    gw = StormGateway(hash_params, tenants=LM_TENANTS,
                      ingest_slots=LM_INGEST_SLOTS, device=dev)
    bridge = TelemetryBridge(gw, pconf, window=LM_WINDOW)
    sink = bridge.register(tap, cfg)
    seen = []

    def capture(batch):
        seen.append(batch)
        sink(batch)

    for c in counters.values():
        c.launches = 0
    eng = ServeEngine(params, cfg, slots=ND_SLOTS, cache_len=ND_CACHE,
                      taps=tap, tap_sink=capture, device=dev)
    served = eng.run([Request(rid=i, prompt=p, max_new_tokens=ND_NEW)
                      for i, p in enumerate(prompts)])
    bridge.flush()
    offline, n_served = _served_against_offline(
        torch, np, dev, cfg, bridge, ND_TAPS, seen, hash_params, pconf, errs,
        cfg.name)
    lm_dfo = dataclasses.replace(probes._PROBE_DFO, learning_rate=LM_PROBE_LR)
    fit_kw = dict(dfo_config=lm_dfo, l2=LM_PROBE_L2, device=dev)
    steps, k = lm_dfo.steps, lm_dfo.num_queries
    dirs = dfo.sphere_directions(generator(SEED + 212, dev), steps, 1, k,
                                 d + 1, dev)
    fits = [probes.fit_probe(None, st, d, directions=dirs, **fit_kw)
            for st in offline]
    dirs_many = dfo.sphere_directions(generator(SEED + 213, dev), steps,
                                      len(ND_TAPS), k, d + 1, dev)
    live = bridge.fit_probes(None, directions=dirs_many, **fit_kw)
    torch.cuda.synchronize()
    launches = _path_launches(counters, ND_TAPS, steps, gw.ticks, cfg.name)
    _fit_probes_against_offline(torch, d, live, offline, dirs_many, fit_kw,
                                cfg.name)
    # Kernel 2 on a fit's first steps, kernel 4 on a tick's shape and
    # kernels 2 and 6 on the served bank, each against its plain version.
    short_kw = dict(fit_kw, dfo_config=dataclasses.replace(
        lm_dfo, steps=LM_PLAIN_STEPS))
    one = probes.fit_probe(None, offline[-1], d,
                           directions=dirs[:LM_PLAIN_STEPS], **short_kw)
    with plain_versions():
        plain_one = probes.fit_probe(None, offline[-1], d,
                                     directions=dirs[:LM_PLAIN_STEPS],
                                     **short_kw)
    if not (torch.equal(one.theta, plain_one.theta)
            and torch.equal(one.losses, plain_one.losses)):
        raise AssertionError(f"{cfg.name}: the fit's first steps through "
                             f"kernel 2 differ from the plain versions'")
    w = ops.from_lsh_params(hash_params)
    feats, ys = _served_rows(torch, np, dev, seen)
    zs, _ = probes.probe_rows(feats[-1], ys, pconf,
                              moments=bridge.moments_of(cfg.name,
                                                        ND_TAPS[-1]))
    zb = torch.zeros((LM_TENANTS, LM_INGEST_SLOTS, zs.shape[1]), device=dev)
    mb = torch.zeros((LM_TENANTS, LM_INGEST_SLOTS), device=dev)
    take = min(LM_WINDOW, zs.shape[0] // LM_TENANTS)
    zb[:, :take] = zs[:LM_TENANTS * take].reshape(LM_TENANTS, take, -1)
    mb[:, :take] = 1.0
    _held(torch, errs, "paired_hash_histogram_banked",
          insert_kernel.paired_hash_histogram_banked(zb, w, mb),
          ref.paired_hash_histogram_banked(zb, w, mb),
          f"kernel 4 at d = {d + 3}")
    bank = gw.bank.counts
    th = torch.randn(LM_QUERY_M[1], d + 1,
                     generator=generator(SEED + 214, dev), device=dev)
    q = lsh.augment_query(lsh.normalize_query(th)).contiguous()
    idx = (torch.arange(q.shape[0], device=dev, dtype=torch.int32)
           * LM_TENANTS // q.shape[0])
    _held(torch, errs, "sketch_query",
          query_kernel.sketch_query(q, w, bank[0]),
          ref.sketch_query(q, w, bank[0]), f"kernel 2 at d = {d + 3}")
    _held(torch, errs, "sketch_query_banked",
          query_kernel.sketch_query_banked(q, w, bank, idx),
          ref.sketch_query_banked(q, w, bank, idx),
          f"kernel 6 at d = {d + 3}")
    _log(f"[nd] {cfg.name} served with taps (cycles {ND_TAPS}, target "
         f"{LM_TARGET}) into a {LM_TENANTS}-tenant gateway at d = {d + 3}: "
         f"{len(served)} requests, {n_served} tapped lane-steps, "
         f"{bridge.flushes} flushes, {gw.ticks} ticks; the served counters "
         f"equal sketch_features(moments=frozen) bit for bit; fit_probe "
         f"(lr {LM_PROBE_LR}) sketch loss "
         f"{[round(float(f.losses[0]), 6) for f in fits]} at step 0, "
         f"{[round(float(f.fleet_losses[0]), 6) for f in fits]} at the end, "
         f"|theta| {[round(float(f.theta.norm()), 6) for f in fits]}; "
         f"fit_probes equals fit_probe_many; kernels 1, 2, 4, 6 bit for bit "
         f"against their plain versions; launches {launches} | {smi}")
    if not all(bool(f.theta.any()) for f in fits):
        raise AssertionError(f"{cfg.name}: the zero guard won a probe fit")
    return launches


def _nd_train(torch, np, dev, smi, cfg):
    """xlstm-1.3b through ``trainer.train`` with the port's own
    ``train_step``: ``ND_TRAIN_STEPS`` steps of 2 x 2048 random tokens, no
    checkpoint; the global gradient norm finite at every step (so every
    gradient leaf is) and the loss falling. Prints the steady step and
    model FLOP/s."""
    from repro_torch.device import generator
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts
    from repro_torch.train import trainer

    tcfg = ts.TrainConfig(optimizer=opt_lib.AdamWConfig(
        learning_rate=ND_TRAIN_LR, warmup_steps=1))
    gen = torch.Generator().manual_seed(SEED + 215)
    toks = torch.randint(0, cfg.vocab_size, (ND_BATCH, ND_PREFILL),
                         generator=gen, dtype=torch.int64).to(torch.int32)
    batch = {"tokens": toks.to(dev),
             "labels": torch.roll(toks, -1, dims=1).to(dev)}
    record = {"ms": [], "grad_norm": []}

    # Phase 20's wrapper: the trainer's step, timed on the host clock to
    # the sync of reading the loss.
    def step_fn(state, b):
        start = time.perf_counter()
        state, metrics = ts.train_step(state, b, cfg, tcfg)
        loss = float(metrics["loss"])
        record["ms"].append(1e3 * (time.perf_counter() - start))
        record["grad_norm"].append(float(metrics["grad_norm"]))
        return state, {"loss": loss}

    torch.cuda.reset_peak_memory_stats()
    report = trainer.train(
        generator(SEED + 215, dev), cfg, tcfg,
        trainer.LoopConfig(total_steps=ND_TRAIN_STEPS, ckpt_dir=None),
        lambda step: batch, step_fn=step_fn, device=dev)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = report.losses
    tokens = ND_BATCH * ND_PREFILL
    steady = statistics.median(record["ms"][1:])
    flops = 6 * cfg.param_count() * tokens / (steady / 1e3)
    _log(f"[nd] {cfg.name} trained {report.steps_run} steps of "
         f"{ND_BATCH} x {ND_PREFILL} tokens through train_step (AdamW lr "
         f"{ND_TRAIN_LR}, warmup 1, microbatches {tcfg.microbatches}, "
         f"grad_dtype {tcfg.optimizer.grad_dtype}, no checkpoint): losses "
         f"{[round(x, 4) for x in losses]}; global gradient norm "
         f"{[round(x, 4) for x in record['grad_norm']]}; step ms "
         f"{[round(x, 1) for x in record['ms']]} | {smi}")
    _log(f"[time] nd train step ({cfg.name}, {ND_BATCH} x {ND_PREFILL} "
         f"tokens, remat {cfg.remat_policy!r}, AdamW): steady {steady:.1f} "
         f"ms (median of steps 2-{len(record['ms'])}, host clock ending in "
         f"the loss read), {tokens / steady * 1e3:.0f} tokens/s, model "
         f"FLOP/s 6 N T / t = {flops / 1e12:.1f} T "
         f"({100 * flops / PEAK_BF16_FLOPS:.2f}% of the bf16 peak); peak "
         f"max_memory_allocated {peak:.2f} GiB | {smi}")
    if not (report.steps_run == ND_TRAIN_STEPS
            and all(np.isfinite(record["grad_norm"]))
            and all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{cfg.name}: the loss did not fall or a "
                             f"gradient was not finite")


def _nd_prefill_profile(torch, arch, prefill, smi):
    """One more prefill under the profiler: its wall, device busy time and
    device time by kind of kernel (phase 20's kinds)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - start)
    events = _device_events(prof)
    busy = sum(us for _, us in events) / 1e3
    kinds = {}
    for name, us in events:
        kind = _train_kernel_kind(name)
        ms, n = kinds.get(kind, (0.0, 0))
        kinds[kind] = (ms + us / 1e3, n + 1)
    _log(f"[time] nd {arch} prefill under the profiler: {wall:.1f} ms wall, "
         f"{busy:.1f} ms device ({100 * busy / wall:.1f}% busy, "
         f"{len(events)} launches): " + "; ".join(
             f"{k} {ms:.1f} ms ({n})" for k, (ms, n) in sorted(
                 kinds.items(), key=lambda kv: -kv[1][0])) + f" | {smi}")


def _f32_witness(torch, dev, cfg, bf16_steps):
    """The decode check on an f32 copy of ``cfg`` at full width (the bf16
    model's weights before their rounding, its inputs), all
    ``ND_DECODE_RECURRENT`` steps held at u = 2^-16: 2^-8 of the bf16
    limit. A decode fault would show at the bf16 size here too. Prints
    both runs' max|diff| per ``ND_DECODE`` steps and the log2 of their
    ratio."""
    import gc

    from repro_torch.device import generator
    from repro_torch.models import model

    f32 = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    params = model.init_params(generator(SEED + 21, dev), f32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    batch = _nd_inputs(torch, f32, gen, dev, ND_BATCH,
                       ND_PREFILL + ND_DECODE_RECURRENT)
    shares = _decode_check(torch, f32, params, batch, f"{cfg.name} in f32",
                           ND_DECODE_RECURRENT, held=ND_DECODE_RECURRENT,
                           unit=2.0 ** -16)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    block = ND_DECODE
    blocks = lambda xs: [max(xs[i:i + block])
                         for i in range(1, len(xs), block)]
    b16, b32 = blocks(bf16_steps), blocks(shares[2])
    ratio = [round(math.log2(a / b), 2) if a and b else None
             for a, b in zip(b16, b32)]
    _log(f"[nd] {cfg.name} decode drift, max|diff| per {block} steps: bf16 "
         f"{[float(f'{x:.4g}') for x in b16]}, f32 "
         f"{[float(f'{x:.4g}') for x in b32]}, log2 of their ratio "
         f"{ratio}; the f32 run at {shares[0]:.4f} of its limit (2^-8 of "
         f"bf16's) over all {len(shares[2]) - 1} steps")


def nondense_phase(torch, np, dev, smi, counters, errs):
    """Phase 21: the six non-dense LMs at their published widths in bf16.
    Returns the launches of its main path (zamba2's taps into probes)."""
    import gc

    from repro_torch.configs import registry
    from repro_torch.device import generator
    from repro_torch.models import model
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.train import tree as tree_lib

    t21 = time.perf_counter()
    launches = {}
    rng = np.random.default_rng(SEED + 21)
    summary = []
    for arch in ND_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**30
        t_model = time.perf_counter()
        full = registry.get_config(arch)
        cfg = (dataclasses.replace(full, num_layers=ND_LAYERS[arch])
               if arch in ND_LAYERS else full)
        start = time.perf_counter()
        params = model.init_params(generator(SEED + 21, dev), cfg,
                                   device=dev)
        torch.cuda.synchronize()
        built_s = time.perf_counter() - start
        n_params = model.param_count(params)
        if n_params != cfg.param_count():
            raise AssertionError(f"{arch}: {n_params} parameters, the config "
                                 f"counts {cfg.param_count()}")
        reduced = (f"; reduced: {cfg.num_layers} of {full.num_layers} "
                   f"layers (full depth: {full.param_count()} parameters, "
                   f"{2 * full.param_count() / 2**30:.1f} GiB of bf16 "
                   f"weights)" if cfg is not full else "")
        _log(f"[nd] {arch}: {cfg.num_layers} layers of {cfg.cycle}, d_model "
             f"{cfg.d_model}, vocab {cfg.vocab_size}, {cfg.param_dtype}: "
             f"{n_params} parameters ({2 * n_params / 2**30:.2f} GiB), built "
             f"in {built_s:.2f} s{reduced}")
        gen = torch.Generator(device=dev).manual_seed(SEED + 21)
        steps = (ND_DECODE_RECURRENT if {"mlstm", "mamba"} & set(cfg.cycle)
                 else ND_DECODE)
        batch = _nd_inputs(torch, cfg, gen, dev, ND_BATCH,
                           ND_PREFILL + steps)
        pre = {k: (v[:, :ND_PREFILL] if k in ("tokens", "embeds") else v)
               for k, v in batch.items()}

        # Prefill at the published configuration: a warm-up, then timed.
        model.prefill(params, cfg, pre, cache_len=ND_PREFILL)
        torch.cuda.synchronize()
        start = time.perf_counter()
        _, last = model.prefill(params, cfg, pre, cache_len=ND_PREFILL)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - start
        if not bool(torch.isfinite(last).all()):
            raise AssertionError(f"{arch}: prefill logits not finite")
        del last
        _nd_prefill_profile(torch, arch, lambda: model.prefill(
            params, cfg, pre, cache_len=ND_PREFILL), smi)

        # Decode against the forward (the MoE pair without drops).
        check = (dataclasses.replace(
            cfg, moe_capacity_factor=float(cfg.num_experts))
            if cfg.is_moe else cfg)
        shares = _decode_check(torch, check, params, batch, arch, steps)
        del batch, pre

        # Decode steps at 4 lanes from zeroed states, timed.
        state = model.init_decode_state(cfg, ND_SLOTS, ND_CACHE, dev)
        step_in = _nd_inputs(torch, cfg, gen, dev, ND_SLOTS,
                             2 + ND_TIMED_STEPS)
        for pos in range(2):
            _, state = model.decode_step(params, cfg, state,
                                         _step_input(step_in, pos), pos)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for pos in range(2, 2 + ND_TIMED_STEPS):
            logits, state = model.decode_step(params, cfg, state,
                                              _step_input(step_in, pos), pos)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - start) / ND_TIMED_STEPS
        del state, step_in, logits

        # Two fresh engines, token inputs: equal streams; the 8 requests
        # over 4 slots re-admit every lane.
        prompts = [rng.integers(0, cfg.vocab_size, size=ND_PROMPT).astype(
            np.int32) for _ in range(ND_REQUESTS)]
        engine_note = "not served by the engine (fed embeds)"
        if not cfg.embeddings_provided:
            streams = []
            for _ in range(2):
                eng = ServeEngine(params, cfg, slots=ND_SLOTS,
                                  cache_len=ND_CACHE, device=dev)
                out = eng.run([Request(rid=i, prompt=p,
                                       max_new_tokens=ND_NEW)
                               for i, p in enumerate(prompts)])
                streams.append({c.rid: c.tokens for c in out})
            if streams[0] != streams[1] or sorted(streams[0]) != list(
                    range(ND_REQUESTS)) or eng.resets != ND_REQUESTS:
                raise AssertionError(f"{arch}: two fresh engines served "
                                     f"different streams")
            engine_note = (f"two fresh engines served equal streams "
                           f"({eng.steps} steps, {eng.resets} lane resets)")
            del eng, out  # the engine holds the parameters

        # Decode state bytes a lane.
        state_bytes = []
        for cache in ND_STATE_CACHES:
            st = model.init_decode_state(cfg, 1, cache, dev)
            state_bytes.append(sum(t.numel() * t.element_size()
                                   for t in tree_lib.leaves(st)))
            del st
        peak = torch.cuda.max_memory_allocated() / 2**30
        tokens = ND_BATCH * ND_PREFILL
        _log(f"[time] nd {arch}: {n_params} parameters; prefill "
             f"{ND_BATCH} x {ND_PREFILL} in {1e3 * prefill_s:.1f} ms "
             f"({tokens / prefill_s:.0f} tokens/s); decode step at "
             f"{ND_SLOTS} lanes {step_ms:.3f} ms; decode state a lane "
             f"{state_bytes[0]} B at cache {ND_STATE_CACHES[0]}, "
             f"{state_bytes[1]} B at {ND_STATE_CACHES[1]}; peak "
             f"max_memory_allocated {peak:.2f} GiB ({held:.2f} GiB held "
             f"before the model); decode max|diff| at "
             f"{shares[0]:.3f} of its limit, relative L2 at {shares[1]:.3f} "
             f"of sqrt(K) 2^-8; "
             f"{engine_note}{reduced} | {smi}")
        summary.append((arch, n_params, tokens / prefill_s, step_ms,
                        state_bytes, peak))
        if arch == ND_TAP_ARCH:
            launches = _nd_probes(torch, np, dev, smi, cfg, params,
                                  counters, errs, prompts)
        del params
        if arch == ND_WITNESS_ARCH:
            _f32_witness(torch, dev, cfg, shares[2])
        if arch == ND_TRAIN_ARCH:
            gc.collect()
            torch.cuda.empty_cache()
            _nd_train(torch, np, dev, smi, cfg)
        _log(f"[nd] {arch} took {time.perf_counter() - t_model:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    _log(f"[nd] phase 21 took {time.perf_counter() - t21:.1f} s")
    return launches


def _same_tree(torch, tree_lib, got, want, what):
    """Every leaf of ``got`` equals ``want``'s bit for bit (path, dtype and
    values; a host counter compared on the host). Returns the count."""
    pairs = list(zip(tree_lib.leaf_paths(got), tree_lib.leaf_paths(want)))
    if len(pairs) != len(tree_lib.leaves(want)):
        raise AssertionError(f"{what}: {len(pairs)} leaves")
    for (path, a), (path_b, b) in pairs:
        b = b.detach()
        if path != path_b or a.dtype != b.dtype or not torch.equal(
                a.to(b.device), b):
            raise AssertionError(f"{what}: {path} differs")
    return len(pairs)


def shard_rules_phase(dev, smi):
    """Phase 22 (a), the rules: every config's parameters and AdamW state at
    full size (shape-only: ``specs.eval_shape``, nothing allocated) on the
    two production meshes named on one card; the bytes one device would
    hold by the specs."""
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import model
    from repro_torch.sharding import specs
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import tree as tree_lib

    start = time.perf_counter()
    meshes = [make_production_mesh(pod, devices=[dev] * (512 if pod else 256))
              for pod in (False, True)]
    for arch in registry.ARCH_IDS:
        cfg = registry.get_config(arch)
        params = specs.eval_shape(model.init_params, None, cfg, "cpu")
        opt = opt_lib.init(opt_lib.AdamWConfig(), params)
        if any(t.device.type != "meta" for t in tree_lib.leaves(params)):
            raise AssertionError(f"{arch}: the shape-only tree allocated")
        weights = sum(t.numel() * t.element_size()
                      for t in tree_lib.leaves(params))
        cells = []
        for mesh in meshes:
            ps = specs.param_specs(params, cfg, mesh)
            pb = specs.spec_bytes(params, ps, mesh)
            ob = specs.spec_bytes(opt, specs.opt_state_specs(opt, ps), mesh)
            cells.append(f"{'x'.join(map(str, mesh.grid))} params {pb} B, "
                         f"AdamW state {ob} B")
        _log(f"[shard] {arch}: {model.param_count(params)} parameters, "
             f"{weights} B of {cfg.param_dtype} weights; one device holds "
             f"{'; '.join(cells)}")
    _log(f"[shard] the rules of {len(registry.ARCH_IDS)} configs on 2 "
         f"production meshes in {time.perf_counter() - start:.1f} s")


def shard_train_phase(torch, np, dev, smi, cfg, state, batch, ckpt_dir):
    """Phase 22 (a) and (d) on phase 20's gemma3-1b: its train state (equal
    to its newest checkpoint) placed on ``(data 2, model 2)`` of one card
    named 4 times by ``param_specs`` and ``opt_state_specs``, the bytes per
    device against the specs' count, gathered back bit for bit; the
    meshless checkpoint restored onto that mesh and gathered bit for bit; a
    decode state and the batch placed by their specs."""
    import gc

    from repro_torch.models import model
    from repro_torch.sharding import specs
    from repro_torch.sharding.mesh import Mesh
    from repro_torch.train import checkpoint
    from repro_torch.train import train_step as ts
    from repro_torch.train import tree as tree_lib

    t22 = time.perf_counter()
    mesh = Mesh([dev] * 4, ("data", "model"), SHARD_GRID)
    pspecs = specs.param_specs(state.params, cfg, mesh)
    sspecs = ts.TrainStateT(params=pspecs, opt=specs.opt_state_specs(
        state.opt, pspecs), step=specs.P())
    shardings = specs.named(mesh, sspecs)
    want = specs.spec_bytes(state, sspecs, mesh)
    whole = sum(t.numel() * t.element_size() for t in tree_lib.leaves(state))
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    start = time.perf_counter()
    placed = specs.device_put(state, shardings)
    torch.cuda.synchronize()
    put_s = time.perf_counter() - start
    added = torch.cuda.memory_allocated() - held
    per = specs.shard_bytes(placed)
    start = time.perf_counter()
    n_leaves = _same_tree(torch, tree_lib, specs.gather_tree(placed), state,
                          "the gathered train state")
    gather_s = time.perf_counter() - start
    named_axes = sorted({a for x in tree_lib.leaves(placed)
                         for d in range(len(x.sharding.spec))
                         for a in x.sharding.spec.axes(d)})
    del placed
    _log(f"[shard] {cfg.name}'s train state ({whole} B: bf16 params, f32 "
         f"master, mu, nu) on {mesh}: bytes per device {per} (from the "
         f"specs: {want}); {added} B allocated on the card ({added / whole:.3f}"
         f" of the state: the placed copy, replicated leaves 4 times); axes "
         f"used {named_axes}; placed in {put_s:.2f} s, gathered back bit for "
         f"bit ({n_leaves} leaves) in {gather_s:.2f} s | {smi}")
    if per != [want] * mesh.size:
        raise AssertionError("the bytes per device are not the specs' count")

    start = time.perf_counter()
    step, restored, _ = checkpoint.restore(ckpt_dir, state,
                                           shardings=shardings)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - start
    if step != TRAIN_RESUME or specs.shard_bytes(restored) != [want] * 4:
        raise AssertionError(f"sharded restore: step {step}")
    _same_tree(torch, tree_lib, specs.gather_tree(restored), state,
               "the sharded restore")
    del restored
    _log(f"[shard] the meshless checkpoint (step {step}) restored onto the "
         f"mesh by its specs in {restore_s:.2f} s, gathered back bit for "
         f"bit | {smi}")

    with torch.no_grad():
        dstate, _ = model.prefill(state.params, cfg, {
            "tokens": batch["tokens"][:, :256]}, cache_len=TRAIN_SEQ)
    for what, tree, tree_specs in (
        ("decode state", dstate, specs.decode_state_specs(
            dstate, cfg, mesh, TRAIN_BATCH)),
        ("batch", batch, specs.batch_specs(batch, mesh)),
    ):
        placed = specs.device_put(tree, specs.named(mesh, tree_specs))
        per = specs.shard_bytes(placed)
        if per != [specs.spec_bytes(tree, tree_specs, mesh)] * mesh.size:
            raise AssertionError(f"{what}: bytes per device {per}")
        _same_tree(torch, tree_lib, specs.gather_tree(placed), tree,
                   f"the gathered {what}")
        _log(f"[shard] {cfg.name}'s {what} placed by its specs "
             f"({sorted({str(x.sharding.spec) for x in tree_lib.leaves(placed)})}"
             f"): {per[0]} B a device, gathered back bit for bit")
        del placed
    del dstate

    _log(f"[shard] phase 22's train-state part took "
         f"{time.perf_counter() - t22:.1f} s")


def press_phase(torch, dev, smi, cfg, params, batch):
    """Phase 22 (d): phase 20's gemma3-1b gradient of the batch's two
    halves (1.0e9 coordinates, in f32) compressed as two pods on
    ``Mesh((dev,) * 2, "pod")`` at the default config: the sketch's
    linearity within its f32 bound, the residual identity exactly as
    computed, the pods' estimates equal; sketch, unsketch and all-reduce
    times, the ratio and the peak."""
    import gc

    from repro_torch.sharding.mesh import Mesh
    from repro_torch.train import compression as comp
    from repro_torch.train import train_step as ts
    from repro_torch.train import tree as tree_lib

    t22 = time.perf_counter()
    pcfg = comp.SketchCompressorConfig()
    halves = [{k: v[i * TRAIN_BATCH // 2:(i + 1) * TRAIN_BATCH // 2]
               for k, v in batch.items()} for i in range(PRESS_PODS)]
    grads = []
    for half in halves:
        _, g = ts.loss_and_grads(params, cfg, half)
        grads.append(tree_lib.tree_map(lambda t: t.detach().float(), g))
        del g
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    flats = [torch.cat([t.reshape(-1) for t in tree_lib.leaves(g)])
             for g in grads]
    n = flats[0].numel()
    torch.cuda.synchronize()
    start = time.perf_counter()
    sk_a = comp.sketch_vector(pcfg, flats[0])
    torch.cuda.synchronize()
    sketch_ms = 1e3 * (time.perf_counter() - start)
    sk_b = comp.sketch_vector(pcfg, flats[1])
    sk_ab = comp.sketch_vector(pcfg, flats[0] + flats[1])
    # The bound: per bucket, each sketch's f32 sum within (m + 1) 2^-24 of
    # its entries' magnitudes, m the bucket's count (so twice that over
    # |a| + |b|, the terms of a + b rounded once each), and the final add.
    mag = torch.zeros_like(sk_a)
    cnt = torch.zeros_like(sk_a)
    for lo, hi, buckets, _ in comp._chunks(pcfg, n, dev, None):
        both = (flats[0][lo:hi].abs() + flats[1][lo:hi].abs())
        mag.scatter_add_(1, buckets, both.expand(pcfg.rows, -1).contiguous())
        cnt.scatter_add_(1, buckets, torch.ones_like(buckets,
                                                     dtype=torch.float32))
    u = 2.0 ** -24
    bound = 2 * (cnt + 1) * u * mag + u * (sk_a + sk_b).abs()
    gap = (sk_a + sk_b - sk_ab).abs()
    share = float((gap / bound.clamp(min=1e-30)).max())
    torch.cuda.synchronize()
    start = time.perf_counter()
    comp.unsketch_vector(pcfg, sk_a + sk_b, n)
    torch.cuda.synchronize()
    unsketch_ms = 1e3 * (time.perf_counter() - start)
    del flats, sk_a, sk_b, sk_ab, mag, cnt, bound, gap
    _log(f"[press] linearity at n = {n} (gemma3-1b's gradient, "
         f"{PRESS_PODS} microbatch halves): |sketch(a) + sketch(b) - "
         f"sketch(a + b)| at {share:.4f} of its f32 bound at most "
         f"(rows {pcfg.rows}, cols {pcfg.cols}, buckets of "
         f"{n / pcfg.cols:.0f} entries on average) | {smi}")
    if not share <= 1.0:
        raise AssertionError("the sketch is not linear within its bound")

    pods = Mesh([dev] * PRESS_PODS, "pod")
    states = [comp.init_state(g) for g in grads]
    torch.cuda.synchronize()
    start = time.perf_counter()
    ests, new = comp.compress_allreduce(pcfg, grads, states, pods)
    torch.cuda.synchronize()
    press_ms = 1e3 * (time.perf_counter() - start)
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    kept = sum(int((t != 0).sum()) for t in tree_lib.leaves(ests[0]))
    for g, e, st in zip(grads, ests, new):
        for gl, el, rl in zip(tree_lib.leaves(g), tree_lib.leaves(e),
                              tree_lib.leaves(st.residual)):
            if not torch.equal(rl, (gl + 0.0) - el * float(PRESS_PODS)):
                raise AssertionError("the residual identity does not hold")
    if not all(torch.equal(a, b) for a, b in zip(
            tree_lib.leaves(ests[0]), tree_lib.leaves(ests[1]))):
        raise AssertionError("the pods' estimates differ")
    if not kept >= max(1, int(n * pcfg.top_k_fraction)):
        raise AssertionError(f"{kept} coordinates kept")
    del grads, states, ests, new
    _log(f"[time] compression (gemma3-1b's gradient, n = {n}, {PRESS_PODS} "
         f"pods on {pods}): sketch {sketch_ms:.1f} ms a pod, unsketch "
         f"{unsketch_ms:.1f} ms, compress_allreduce {press_ms:.1f} ms; "
         f"ratio {comp.compression_ratio(pcfg, n):.1f} ({n} coordinates "
         f"for {pcfg.rows} x {pcfg.cols} floats); {kept} kept (top "
         f"{pcfg.top_k_fraction}); residual identity exact on both pods; "
         f"peak {peak:.2f} GiB over the {held / 2**30:.2f} held | {smi}")
    _log(f"[press] phase 22's compression part took "
         f"{time.perf_counter() - t22:.1f} s")


def pipeline_phase(torch, dev, smi, params, cfg):
    """Phase 22 (c): phase 19's qwen2-7b in a GPipe schedule: ``PIPE_STAGES``
    stages of its cycles on ``Mesh((dev,) * PIPE_STAGES, "pipe")``,
    ``PIPE_MICRO`` microbatches of 1 x ``PIPE_LEN`` tokens, the embedding,
    final norm and unembedding outside. The output equals the same
    microbatches run stage after stage bit for bit; the logits are within
    phase 19's bound of a whole-batch ``forward``."""
    from repro_torch.models import layers, model
    from repro_torch.sharding.mesh import Mesh
    from repro_torch.sharding.pipeline import bubble_fraction, pipeline_forward

    per = cfg.num_cycles // PIPE_STAGES
    stages = [params["blocks"][s * per:(s + 1) * per]
              for s in range(PIPE_STAGES)]
    mesh = Mesh([dev] * PIPE_STAGES, "pipe")
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    toks = torch.randint(0, cfg.vocab_size, (PIPE_MICRO, 1, PIPE_LEN),
                         generator=gen, device=dev)
    cdt = layers.dtype_of(cfg.compute_dtype)
    fn = lambda cycles, h: model.apply_cycles(cycles, cfg, h)
    with torch.no_grad():
        x = layers.embed(params["embed"], toks, cdt)
        pipeline_forward(fn, stages, x[:1], mesh)   # warm-up
        torch.cuda.synchronize()
        start = time.perf_counter()
        got = pipeline_forward(fn, stages, x, mesh)
        torch.cuda.synchronize()
        pipe_s = time.perf_counter() - start
        start = time.perf_counter()
        seq = []
        for i in range(PIPE_MICRO):
            h = x[i]
            for cycles in stages:
                h = fn(cycles, h)
            seq.append(h)
        seq = torch.stack(seq)
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - start
        if not torch.equal(got, seq):
            raise AssertionError("the pipeline differs from its sequential "
                                 "run")
        del seq
        hidden = layers.rms_norm(got.reshape(PIPE_MICRO, PIPE_LEN, -1),
                                 params["final_norm"], cfg.norm_eps)
        table = model.unembed_table(params, cfg)
        logits = layers.unembed(table, hidden, cdt).float()
        whole, _ = model.forward(params, cfg, {"tokens": toks.reshape(
            PIPE_MICRO, PIPE_LEN)})
        want = layers.unembed(table, whole, cdt).float()
        del hidden, whole
    peak = float(want.abs().max())
    rel_limit = (2 * cfg.num_layers + 1) ** 0.5 * 2.0 ** -8
    limit = 4.0 * rel_limit * peak
    diff = float((logits - want).abs().max())
    del logits, want
    _log(f"[pipe] {cfg.name}: {PIPE_STAGES} stages of {per} cycles on "
         f"{mesh}, {PIPE_MICRO} microbatches of 1 x {PIPE_LEN} tokens: the "
         f"output equals the sequential run bit for bit; logits against a "
         f"whole-batch forward max|diff| {diff:.6f}, limit {limit:.6f} "
         f"(max|logit| {peak:.4f}, 4 sqrt(2L + 1) 2^-8) | {smi}")
    if not diff <= limit:
        raise AssertionError("the pipeline's logits left phase 19's bound")
    _log(f"[time] pipeline ({cfg.name}, {PIPE_STAGES} stages, "
         f"{PIPE_MICRO} microbatches of {PIPE_LEN} tokens): {pipe_s:.3f} s "
         f"wall ({PIPE_MICRO * PIPE_LEN / pipe_s:.0f} tokens/s; the same "
         f"microbatches stage after stage {seq_s:.3f} s); bubble fraction "
         f"(S - 1) / (M + S - 1) = {bubble_fraction(PIPE_STAGES, PIPE_MICRO):.4f}"
         f" (one card: the stages run in turn, so the schedule saves no "
         f"time here) | {smi}")


def _seqpar_prefills(torch, params, configs, pre, mesh):
    """Each config's prefill of ``pre`` (a warm-up, then timed) under the
    mesh: ``{label: (seconds, states, logits in f32)}``."""
    from repro_torch.models import model
    from repro_torch.sharding.mesh import set_mesh

    out = {}
    with torch.no_grad(), set_mesh(mesh):
        for label, c in configs.items():
            cache = ND_PREFILL + ND_DECODE
            model.prefill(params, c, pre, cache_len=cache)
            torch.cuda.synchronize()
            start = time.perf_counter()
            st, lg = model.prefill(params, c, pre, cache_len=cache)
            torch.cuda.synchronize()
            out[label] = (time.perf_counter() - start, st, lg.float())
    return out


def _seqpar_against(torch, runs, label, flat_cfg, unit):
    """``label``'s prefill against the meshless one (``"meshless"``): the
    logits' max|diff| as a share of 4 sqrt(K) u max|logit|, each cycle's
    final state's (s and n) as a share of 4 sqrt(c + 1) u max|s_c|.
    Returns ``(logit share, state shares per cycle)``."""
    _, st0, lg0 = runs["meshless"]
    _, st1, lg1 = runs[label]
    limit = 4.0 * _rounded_stages(flat_cfg) ** 0.5 * unit * float(
        lg0.abs().max())
    shares = []
    for c, (a, b) in enumerate(zip(st1, st0)):
        shares.append(max(
            float((x - y).abs().max()) / (4.0 * (c + 1) ** 0.5 * unit * float(
                y.abs().max())) for x, y in zip(a["pos0"], b["pos0"])))
    return float((lg1 - lg0).abs().max()) / limit, shares


def seqpar_phase(torch, np, dev, smi):
    """Phase 22 (b): xlstm-1.3b at its published widths with
    ``sequence_parallel=True`` on ``(data 1, model 4)`` of one card.

    f32 (the witness; weights drawn from the bf16 model's seed, before
    their rounding): a prefill of 2 x 2048 against the meshless one,
    logits within 4 sqrt(K) 2^-16 max|logit| (K = 49), each cycle's final
    state within 4 sqrt(c + 1) 2^-16 max|s_c|, and 8 decode steps from the
    sequence-parallel state against the meshless forward held as phase 21
    holds its f32 witness. bf16 (the published config): the same
    comparisons printed, each beside the meshless prefill at the spans'
    chunking (c = 512) against the meshless one: at this depth a random
    init amplifies any change of the f32 sums' order past the bf16 K-stage
    bound, the meshless algorithm's own re-chunking included (PERF.md
    §6); the prefill's tokens/s beside the meshless one's; 2
    ``train_step``s: finite gradient norms, the first loss within 2^-7
    relative of the meshless loss."""
    import gc

    from repro_torch.configs import registry
    from repro_torch.device import generator
    from repro_torch.models import model
    from repro_torch.sharding.mesh import Mesh, set_mesh
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as ts

    t22 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    published = registry.get_config(SP_ARCH)
    mesh = Mesh([dev] * SP_MODEL, ("data", "model"), (1, SP_MODEL))
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    batch = _nd_inputs(torch, published, gen, dev, ND_BATCH,
                       ND_PREFILL + ND_DECODE)
    pre = {"tokens": batch["tokens"][:, :ND_PREFILL]}
    tokens = ND_BATCH * ND_PREFILL
    span = ND_PREFILL // SP_MODEL

    for dtype, unit in (("float32", 2.0 ** -16), ("bfloat16", 2.0 ** -8)):
        flat = dataclasses.replace(published, param_dtype=dtype,
                                   compute_dtype=dtype)
        cfg = dataclasses.replace(flat, sequence_parallel=True)
        rechunked = dataclasses.replace(flat, attn_chunk=min(
            flat.attn_chunk, span))
        if dtype == "float32":
            params = model.init_params(generator(SEED + 22, dev), flat, dev)
        else:
            tcfg = ts.TrainConfig(optimizer=opt_lib.AdamWConfig(
                learning_rate=ND_TRAIN_LR, warmup_steps=1))
            state = ts.init_state(generator(SEED + 22, dev), cfg, tcfg, dev)
            params = state.params
        runs = _seqpar_prefills(torch, params, {
            "meshless": flat, "sequence-parallel": cfg,
            "meshless re-chunked": rechunked}, pre, mesh)
        sp_logits, sp_states = _seqpar_against(
            torch, runs, "sequence-parallel", flat, unit)
        re_logits, re_states = _seqpar_against(
            torch, runs, "meshless re-chunked", flat, unit)
        flat_s, sp_s = runs["meshless"][0], runs["sequence-parallel"][0]
        del runs
        held = dtype == "float32"
        with torch.no_grad(), set_mesh(mesh):
            shares = _decode_check(
                torch, flat, params, batch, f"{SP_ARCH} in {dtype} from "
                f"the sequence-parallel prefill", ND_DECODE, unit=unit,
                prefill_cfg=cfg, hold=held)
        _log(f"[seqpar] {SP_ARCH} ({flat.num_layers} mLSTM blocks, {dtype}"
             f") prefill of {ND_BATCH} x {ND_PREFILL}, sequence-parallel on "
             f"{mesh} (spans of {span}, chunk {min(flat.attn_chunk, span)}), "
             f"against the meshless prefill (chunk {flat.attn_chunk}): "
             f"logits at {sp_logits:.4f} of 4 sqrt(K) u max|logit| (u = "
             f"2^{math.log2(unit):.0f}, K = {_rounded_stages(flat)}), final "
             f"states at most {max(sp_states):.4f} of 4 sqrt(c + 1) u "
             f"max|s_c| (cycle 0 {sp_states[0]:.2e}, cycle "
             f"{len(sp_states) - 1} {sp_states[-1]:.4f}), decode steps 1-"
             f"{ND_DECODE} at {shares[0]:.4f} of phase 21's limit; the "
             f"meshless prefill at chunk {min(flat.attn_chunk, span)} "
             f"against it: logits {re_logits:.4f}, states "
             f"{max(re_states):.4f}; "
             + ("held" if held else "printed, not held (bf16: a rounding "
                "at any order moves it past the bound)") + f" | {smi}")
        if held and not (sp_logits <= 1.0 and max(sp_states) <= 1.0):
            raise AssertionError(f"the sequence-parallel prefill in {dtype}"
                                 f" left its bounds")
        if dtype == "float32":
            del params
            gc.collect()
            torch.cuda.empty_cache()
    _log(f"[time] seqpar prefill ({SP_ARCH}, bf16, {ND_BATCH} x "
         f"{ND_PREFILL}): sequence-parallel over {SP_MODEL} names of one "
         f"card {1e3 * sp_s:.1f} ms ({tokens / sp_s:.0f} tokens/s), "
         f"meshless {1e3 * flat_s:.1f} ms ({tokens / flat_s:.0f} tokens/s) "
         f"| {smi}")

    train = {"tokens": pre["tokens"],
             "labels": torch.roll(pre["tokens"], -1, dims=1)}
    with torch.no_grad():
        flat_loss = float(model.train_loss(params, flat, train))
    losses, norms, step_ms = [], [], []
    with set_mesh(mesh):
        for _ in range(SP_TRAIN_STEPS):
            start = time.perf_counter()
            state, metrics = ts.train_step(state, train, cfg, tcfg)
            losses.append(float(metrics["loss"]))
            step_ms.append(1e3 * (time.perf_counter() - start))
            norms.append(float(metrics["grad_norm"]))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    del state, params, batch, pre, train
    gc.collect()
    torch.cuda.empty_cache()
    rel = abs(losses[0] - flat_loss) / abs(flat_loss)
    _log(f"[seqpar] {SP_ARCH} trained {SP_TRAIN_STEPS} steps of {ND_BATCH} "
         f"x {ND_PREFILL} with sequence_parallel on {mesh}: losses "
         f"{[round(x, 4) for x in losses]} (meshless loss {flat_loss:.4f}, "
         f"the first at {rel:.2e} relative of it, limit 2^-7); gradient "
         f"norms {[round(x, 4) for x in norms]}; step ms "
         f"{[round(x, 1) for x in step_ms]}; peak {peak_gib:.2f} GiB | {smi}")
    if not (all(np.isfinite(norms)) and all(np.isfinite(losses))
            and rel <= 2.0 ** -7):
        raise AssertionError("the sequence-parallel train step")
    _log(f"[seqpar] phase 22's sequence-parallel part took "
         f"{time.perf_counter() - t22:.1f} s")


# -- phase 23: the tooling ----------------------------------------------------

TOOL_COUNT_KEYS = ("flops", "flops:bf16", "flops:f32", "hbm_bytes",
                   "min_bytes", "launches")
TOOL_PEAK_BAND = (0.8, 1.25)   # op_analysis peak over the allocator's
TOOL_SHARE_MAX = 1.05          # a bound over a measured time above: a bad count
TOOL_DECODE_STEPS, TOOL_PROFILE_STEPS = 10, 3
TOOL_TRAIN_LR = "1e-2"         # train_lm --smoke: the preset's lr moves too little


def _counted_step(torch, fn, *args):
    """``fn(*args)`` once under ``op_analysis`` on the card, and the
    allocator's peak over what was allocated before it."""
    import gc

    from repro_torch.launch import op_analysis

    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    counts = op_analysis.analyze(fn, *args)
    torch.cuda.synchronize()
    return counts, torch.cuda.max_memory_allocated() - held


def _counts_against_dry_run(label, real, alloc_peak, cell, smi):
    """Phase 23 (a): the card's counts equal the dry run's on meta tensors,
    and the counted peak lies within ``TOOL_PEAK_BAND`` of the
    allocator's."""
    if not cell.ok:
        raise AssertionError(f"{label}: the dry run failed: {cell.error}")
    fake = cell.cost
    differ = {k: (real[k], fake[k]) for k in TOOL_COUNT_KEYS
              if real[k] != fake[k]}
    ratio = real["peak_bytes"] / max(alloc_peak, 1)
    _log(f"[tool] {label} counted on the card: " + ", ".join(
        f"{k} {real[k]:.6g}" for k in TOOL_COUNT_KEYS) + f"; the dry run's "
        f"meta count {'equal in every key' if not differ else differ}; "
        f"peak_bytes {real['peak_bytes'] / 2**30:.3f} GiB against the "
        f"allocator's {alloc_peak / 2**30:.3f} GiB over what was held "
        f"({ratio:.3f}, band {TOOL_PEAK_BAND}) | {smi}")
    if differ:
        raise AssertionError(f"{label}: card and dry-run counts differ: "
                             f"{differ}")
    if not TOOL_PEAK_BAND[0] <= ratio <= TOOL_PEAK_BAND[1]:
        raise AssertionError(f"{label}: counted peak {ratio:.3f} of the "
                             f"allocator's")


def _bound_against_times(label, counts, host_ms, device_ms, model_flops,
                         smi):
    """Phase 23 (b): the one-card roofline bound over the measured step."""
    from repro_torch.launch import roofline

    compute_ms = 1e3 * roofline.compute_seconds(counts)
    memory_ms = 1e3 * counts["min_bytes"] / roofline.HBM_BW
    bound_ms = max(compute_ms, memory_ms)
    shares = {"host": bound_ms / host_ms, "device": bound_ms / device_ms}
    mfu = model_flops / (host_ms / 1e3) / roofline.PEAK_BF16_FLOPS
    _log(f"[tool] {label}: bound {bound_ms:.3f} ms (compute {compute_ms:.3f}"
         f" ms = {counts['flops:bf16']:.4g} bf16 + {counts['flops:f32']:.4g}"
         f" f32 FLOPs, memory {memory_ms:.3f} ms = {counts['min_bytes']:.4g}"
         f" B; dominant {'compute' if compute_ms >= memory_ms else 'memory'}"
         f"); measured {host_ms:.3f} ms host clock, {device_ms:.3f} ms of "
         f"device work; bound / time {shares['host']:.4f} (host), "
         f"{shares['device']:.4f} (device), limit {TOOL_SHARE_MAX}; model "
         f"FLOP/s share {mfu:.4f} of the bf16 peak; hbm_bytes / min_bytes "
         f"{counts['hbm_bytes'] / counts['min_bytes']:.2f}; "
         f"{counts['launches']:.0f} ops | {smi}")
    if max(shares.values()) > TOOL_SHARE_MAX:
        raise AssertionError(f"{label}: the bound exceeds the measured time "
                             f"({shares}): the count is wrong")
    return shares


def tooling_train(torch, smi, cfg, tcfg, state, batch, step_ms, device_ms):
    """Phase 23 (a, b) on phase 20's state and batch: one more gemma3-1b
    train step counted on the card against the dry run's count of the same
    cell, then its bound against phase 20's times."""
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.train import train_step as ts

    real, alloc = _counted_step(torch, ts.train_step, state, batch, cfg, tcfg)
    shape = registry.ShapeSpec(f"train_{TRAIN_BATCH}x{TRAIN_SEQ}", TRAIN_SEQ,
                               TRAIN_BATCH, "train")
    cell = dryrun.run_cell(TRAIN_ARCH, shape.name, "1",
                           {"remat_group": cfg.remat_group}, shape=shape,
                           microbatches=tcfg.microbatches,
                           optimizer=tcfg.optimizer)
    label = f"{TRAIN_ARCH} train step ({TRAIN_BATCH} x {TRAIN_SEQ})"
    _counts_against_dry_run(label, real, alloc, cell, smi)
    _bound_against_times(label, real, step_ms, device_ms,
                         6.0 * cfg.param_count() * TRAIN_BATCH * TRAIN_SEQ,
                         smi)


def tooling_decode(torch, dev, smi, params, cfg):
    """Phase 23 (a, b) on phase 19's model: one 4-lane decode step at cache
    ``LM_CACHE`` counted on the card against the dry run's count, then its
    bound against the step's host-clock and device times."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.models import model

    state = model.init_decode_state(cfg, LM_SLOTS, LM_CACHE, dev)
    inputs = {"tokens": torch.arange(LM_SLOTS, dtype=torch.int32,
                                     device=dev)}
    pos = torch.tensor(LM_CACHE // 2, dtype=torch.int32, device=dev)
    step = lambda: model.decode_step(params, cfg, state, inputs, pos)
    real, alloc = _counted_step(torch, model.decode_step, params, cfg, state,
                                inputs, pos)
    shape = registry.ShapeSpec(f"decode_{LM_SLOTS}x{LM_CACHE}", LM_CACHE,
                               LM_SLOTS, "decode")
    cell = dryrun.run_cell(LM_ARCH, shape.name, "1", shape=shape)
    label = f"{LM_ARCH} decode step ({LM_SLOTS} lanes, cache {LM_CACHE})"
    _counts_against_dry_run(label, real, alloc, cell, smi)
    ms = []
    for _ in range(TOOL_DECODE_STEPS):
        torch.cuda.synchronize()
        start = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - start))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(TOOL_PROFILE_STEPS):
            step()
        torch.cuda.synchronize()
    device_ms = sum(us for _, us in _device_events(prof)) / 1e3 \
        / TOOL_PROFILE_STEPS
    _bound_against_times(label, real, statistics.median(ms[1:]), device_ms,
                         2.0 * cfg.param_count() * LM_SLOTS, smi)


def _example(module, argv):
    """An example's ``main(argv)`` on the card; what it printed goes to one
    log line."""
    import contextlib
    import io

    buf = io.StringIO()
    start = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = module.main(list(argv))
    secs = time.perf_counter() - start
    return out, secs, buf.getvalue().strip().splitlines()


def tooling_phase(torch, dev, smi, counters):
    """Phase 23 (c, d): the dry-run table of the ten configs at decode_32k
    on one card, then the seven examples on the card with their checks.
    Returns the examples' kernel launches."""
    import dataclasses
    import shutil

    from repro_torch.configs import registry
    from repro_torch.examples import (edge_regression, logistic_edge,
                                      private_serving, quickstart, serve_lm,
                                      serve_storm, train_lm)
    from repro_torch.kernels import srp_hash as hash_kernel
    from repro_torch.launch import dryrun, roofline

    t23 = time.perf_counter()
    results = {}
    for arch in registry.ARCH_IDS:
        res = dryrun.run_cell(arch, "decode_32k", "1")
        if not res.ok:
            raise AssertionError(f"dry run {arch} decode_32k: {res.error}")
        results[f"{arch}|decode_32k|1"] = dataclasses.asdict(res)
    for line in roofline.render(results, "1").splitlines():
        if line.startswith(("|", "Counted")):
            _log(f"[tool] dry run: {line}")
    _log(f"[tool] dry run of the ten configs at decode_32k on one card in "
         f"{time.perf_counter() - t23:.1f} s (shape-only, counted) | {smi}")

    wrappers = dict(counters, srp_hash=hash_kernel.srp_hash)
    scratch = ROOT / ".chip_scratch" / "tooling"
    shutil.rmtree(scratch, ignore_errors=True)
    card = ["--device", str(dev)]
    total = {name: 0 for name in wrappers}
    runs = (
        ("quickstart", quickstart, card),
        ("serve_storm", serve_storm, card),
        ("logistic_edge", logistic_edge, card),
        ("private_serving", private_serving, card),
        ("edge_regression", edge_regression, card),
        ("serve_lm", serve_lm, card),
        ("train_lm whole", train_lm, card + [
            "--smoke", "--lr", TOOL_TRAIN_LR, "--ckpt-dir",
            str(scratch / "whole")]),
        ("train_lm cut", train_lm, card + [
            "--smoke", "--lr", TOOL_TRAIN_LR, "--stop-after", "10",
            "--ckpt-dir", str(scratch / "cut")]),
        ("train_lm resumed", train_lm, card + [
            "--smoke", "--lr", TOOL_TRAIN_LR, "--ckpt-dir",
            str(scratch / "cut")]),
    )
    outs = {}
    for label, module, argv in runs:
        for w in wrappers.values():
            w.launches = 0
        out, secs, printed = _example(module, argv)
        used = {n: w.launches for n, w in wrappers.items() if w.launches}
        for n, c in used.items():
            total[n] += c
        outs[label] = out
        _log(f"[tool] example {label}: {secs:.2f} s, kernel launches {used}; "
             f"it printed: {' / '.join(printed)[:900]}")

    q = outs["quickstart"]
    s = outs["serve_storm"]
    lg = outs["logistic_edge"]
    pv = outs["private_serving"]
    ed = outs["edge_regression"]
    sl = outs["serve_lm"]
    whole, cut, resumed = (outs["train_lm whole"], outs["train_lm cut"],
                           outs["train_lm resumed"])
    losses = whole["losses"]
    resume_diff = max(abs(a - b) for a, b in
                      zip(cut["losses"] + resumed["losses"], losses))
    checks = {
        "quickstart: STORM MSE < 0.6 var(y), registry path < 0.6 var(ys), "
        "cos to OLS > 0.5": (q["storm_mse"] < 0.6 * q["var_y"]
                            and q["generic_mse"] < 0.6 * q["var_ys"]
                            and q["cos"] > 0.5
                            and q["sketch_bytes"] == 131072),
        "serve_storm: served counters == the standalone build, 4 ticks, "
        "4096 rows, 4 points, 2 traced bodies, MSE < 0.8 var(y)": (
            s["same_counters"]
            and (s["ticks"], s["rows_ingested"], s["points_served"],
                 s["trace_count"]) == (4, 4096, 4, 2)
            and all(m < 0.8 * v for m, v in zip(s["mse"], s["var_y"]))),
        "logistic_edge: accuracies > 0.8, 1 traced body": (
            min(lg["local_accuracy"] + lg["gateway_accuracy"]) > 0.8
            and lg["trace_count"] == 1),
        "private_serving: refused at round 5, not retryable, spent 1-4, "
        "ledger {'0': 4.0}, 4 releases": (
            pv["refused_at"] == 5 and pv["retryable"] is False
            and [r["spent"] for r in pv["rounds"]] == [1, 2, 3, 4]
            and pv["spent"] == {"0": 4.0} and pv["exhausted"] == [0]
            and pv["releases"] == 4),
        "edge_regression: 8 shards, n 4096, MSE < 0.6 var(ys), private "
        "query within 0.1": (
            (ed["devices"], ed["n"]) == (8, 4096)
            and ed["mse"] < 0.6 * ed["var_ys"]
            and abs(ed["private"] - ed["exact"]) < 0.1),
        "serve_lm: every request completes with its 16 tokens": (
            sl["completed"] == list(range(8))
            and all(len(t) == 16 for t in sl["tokens"].values())),
        "train_lm --smoke: the loss falls (final below the first five's "
        "mean, the last five's mean below the first five's), resumes from "
        "step 10 with the uninterrupted run's losses bit for bit": (
            whole["steps_run"] == 20 and whole["final_loss"] < whole["first5"]
            and sum(losses[-5:]) < sum(losses[:5])
            and cut["steps_run"] == 10
            and (resumed["resumed_from"], resumed["steps_run"]) == (10, 10)
            and resumed["restores"] == 0
            and cut["losses"] + resumed["losses"] == losses),
    }
    _log(f"[tool] examples: quickstart MSE {q['storm_mse']:.4f} (var y "
         f"{q['var_y']:.4f}), registry {q['generic_mse']:.4f}, cos "
         f"{q['cos']:.3f}; serve_storm MSE/var "
         f"{[round(m / v, 3) for m, v in zip(s['mse'], s['var_y'])]}; "
         f"logistic accuracies {lg['local_accuracy']} / "
         f"{lg['gateway_accuracy']}; edge MSE {ed['mse']:.4f}, private "
         f"{ed['private']:.4f} against {ed['exact']:.4f}; train_lm losses "
         f"{[round(x, 4) for x in losses]}, resumed run "
         f"{[round(x, 4) for x in resumed['losses']]}; the cut and resumed "
         f"runs against the whole run: largest difference {resume_diff:.3g}")
    failed = [name for name, ok in checks.items() if not ok]
    _log(f"[tool] example checks: {len(checks) - len(failed)} of "
         f"{len(checks)} hold" + (f"; FAILED: {failed}" if failed else ""))
    if failed:
        raise AssertionError(f"example checks failed: {failed}")
    for name in ("paired_hash_histogram", "sketch_query",
                 "paired_hash_histogram_banked", "sketch_query_banked",
                 "hash_histogram", "hash_histogram_banked"):
        if not total[name]:
            raise AssertionError(f"the examples launched no {name}")
    if not total["sketch_query_f32"] + total["sketch_query_banked_f32"]:
        raise AssertionError("the private server's fits launched no f32 "
                             "query")
    shutil.rmtree(scratch, ignore_errors=True)
    _log(f"[tool] the examples' kernel launches: {total}; phase 23's "
         f"examples and table took {time.perf_counter() - t23:.1f} s")
    return total


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke: run it from the repository (src/repro_torch is "
              "missing beside it)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.core import (baselines, classification, dfo, distributed,
                                  erm, fleet, losses, lsh, regression)
    from repro_torch.core import sketch as sketch_lib
    from repro_torch.data import datasets
    from repro_torch.device import generator, resolve_device
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import sketch_query as query_kernel
    from repro_torch.kernels import srp_hash as hash_kernel
    from repro_torch.kernels import storm_sketch as insert_kernel
    from repro_torch.launch import storm_serve
    from repro_torch.serve import storm_gateway
    from repro_torch.serve import tiered_gateway as tiered_mod
    from repro_torch.serve.storm_gateway import report_key
    from repro_torch.sharding.mesh import Mesh

    # -- 1. device --------------------------------------------------------------
    dev = resolve_device("cuda")  # also switches TF32 off for the plain versions
    smi = _nvidia_smi()
    _log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda}"
         f" | {torch.cuda.get_device_name(0)}")

    # -- 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    _log(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")
    for path in libs.values():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                _log(f"[build] {path.stem}: {line.strip()}")

    gen = generator(SEED, dev)
    # A second stream for the wide-body, p > 8 and query-shape cases and the
    # wide fit, so that adding cases leaves every other phase's draws as
    # they were: the fits' quality checks hold chaotic DFO fits to fixed
    # draws.
    extra = generator(SEED + 1, dev)
    # A third stream for the cases of the projection tile (the inserts' wide
    # body and kernel 7's tiled path), for the same reason.
    more = generator(SEED + 2, dev)
    cfg = regression.StormRegressorConfig()
    x, y, _ = datasets.make_regression(gen, N_ROWS, D_FEATURES, NOISE,
                                       CONDITION)
    dim = D_FEATURES + 3
    params = lsh.init_srp(gen, cfg.rows, cfg.planes, dim, device=dev)
    w = ops.from_lsh_params(params)  # (p, d + 2, R)
    xs, ys, *_ = regression._standardize(x, y, True)
    z, _ = lsh.scale_to_unit_ball(torch.cat([xs, ys[:, None]], dim=1),
                                  cfg.norm_slack)
    z = z.contiguous()
    ones = torch.ones(N_ROWS, device=dev)
    counters = {
        "paired_hash_histogram": insert_kernel.paired_hash_histogram,
        "sketch_query": query_kernel.sketch_query,
        "hash_histogram": insert_kernel.hash_histogram,
        "paired_hash_histogram_banked":
            insert_kernel.paired_hash_histogram_banked,
        "hash_histogram_banked": insert_kernel.hash_histogram_banked,
        "sketch_query_banked": query_kernel.sketch_query_banked,
        "sketch_query_f32": query_kernel.sketch_query_f32,
        "sketch_query_banked_f32": query_kernel.sketch_query_banked_f32,
    }
    errs = {name: 0.0 for name in counters}

    # -- 3. insert kernel against its plain version ----------------------------
    def check_insert(label, zi, wi, mi, out_dtype):
        got = insert_kernel.paired_hash_histogram(zi, wi, mi, out_dtype)
        want = ref.paired_hash_histogram(zi, wi, mi, out_dtype)
        torch.cuda.synchronize()
        err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        errs["paired_hash_histogram"] = max(errs["paired_hash_histogram"], err)
        mass = got.to(torch.int64).sum(1)
        _log(f"[insert] {label}: n={zi.shape[0]} d+2={wi.shape[1]} "
             f"p={wi.shape[0]} R={wi.shape[2]} {out_dtype} max|err|={err:g} "
             f"row mass {int(mass.min())}..{int(mass.max())} "
             f"(2*sum(int(mask)) = {2 * int(mi.to(torch.int64).sum())})")
        if not torch.equal(got, want):
            raise AssertionError(f"insert kernel differs from its plain "
                                 f"version at {label}")
        return got

    def weighted_mask(lead, keep, g=gen):
        """A 0/1 mask (``keep`` valid, interleaved) whose every third
        256-slot tile carries integer weights 0-3: weighted and binary tiles
        meet in one launch."""
        mi = (torch.rand(lead, generator=g, device=dev) < keep).float()
        for start in range(256, lead[-1], 768):
            mi[..., start:start + 256] = torch.randint(
                0, 4, mi[..., start:start + 256].shape, generator=g,
                device=dev).float()
        return mi

    def unaligned(xi, offset):
        """A contiguous copy of ``xi`` that starts ``offset`` floats into
        its buffer, so that it is not 16-byte aligned."""
        buf = torch.empty(xi.numel() + offset, device=dev)
        view = buf[offset:].view(xi.shape)
        view.copy_(xi)
        return view

    def empty_tiles(mi):
        """``mi`` with its first 10 000 slots and every other 1024-slot
        block from there masked out: whole tiles of 0 meet live ones."""
        mi[..., :10_000] = 0
        for start in range(10_000, mi.shape[-1], 2048):
            mi[..., start:start + 1024] = 0
        return mi

    full_counts = check_insert("full", z, w, ones, torch.int32)
    for label, n, d, p, r, keep, out_dtype in (
        ("ragged", 100_003, 10, 4, 2000, 0.9, torch.int32),
        ("ragged", 77_777, 5, 1, 130, 0.7, torch.int32),
        ("ragged", 12_345, 13, 8, 77, 0.5, torch.int32),
        ("ragged", 5_001, 31, 5, 333, 1.0, torch.int32),
        ("ragged d", 100_003, 1, 4, 2048, 0.6, torch.int32),
        ("ragged d", 50_001, 16, 3, 1000, 0.5, torch.int32),
        ("ragged d", 50_001, 17, 6, 513, 0.5, torch.int32),
        ("ragged d", 33_333, 32, 7, 300, 0.8, torch.int32),
        ("ragged d", 40_000, 10, 2, 2048, 0.5, torch.int32),
        ("ragged d", 40_000, 10, 5, 2048, 0.5, torch.int32),
        ("ragged n", 31, 10, 4, 2048, 1.0, torch.int32),
        ("ragged n", 33, 10, 4, 2048, 0.7, torch.int32),
        ("ragged n", 0, 10, 4, 2048, 1.0, torch.int32),
        ("weighted", 100_003, 10, 4, 2048, 0.5, torch.int32),
        ("weighted", 100_003, 16, 4, 333, 0.5, torch.int32),
        ("weighted", 50_001, 17, 8, 100, 0.5, torch.int32),
        ("weighted", 50_001, 10, 1, 100, 0.5, torch.int32),
        ("int16 saturating", 200_001, 4, 1, 50, 1.0, torch.int16),
        ("int16", 30_000, 10, 4, 2048, 0.8, torch.int16),
        ("int8 saturating", 50_001, 3, 2, 64, 1.0, torch.int8),
        ("int16 saturating weighted", 100_003, 10, 1, 64, 0.5, torch.int16),
        ("int8 saturating weighted", 50_001, 10, 4, 64, 0.5, torch.int8),
        ("int8 saturating weighted", 50_001, 17, 8, 64, 0.5, torch.int8),
        ("wide", 100_003, 33, 4, 2048, 0.9, torch.int32),
        ("wide", 50_001, 64, 8, 300, 0.5, torch.int32),
        ("wide", 20_001, 515, 9, 257, 0.7, torch.int32),
        ("wide", 3_001, 4096, 4, 100, 0.8, torch.int32),
        ("p=9", 50_001, 10, 9, 513, 0.7, torch.int32),
        ("wide weighted", 50_001, 40, 9, 64, 0.5, torch.int32),
        ("wide int16 saturating", 100_003, 33, 1, 50, 1.0, torch.int16),
        ("wide int8 saturating weighted", 100_003, 64, 1, 64, 0.5,
         torch.int8),
        # The projection tile's shapes: every p pass layout (1, 4, 5, 8; 9
        # and 30 in passes), tails of d, R and n, the timing shape.
        ("tile", 65_536, 515, 4, 2048, 1.0, torch.int32),
        ("tile", 50_001, 63, 5, 1000, 0.5, torch.int32),
        ("tile", 30_001, 33, 8, 2048, 0.8, torch.int32),
        ("tile", 20_001, 40, 1, 1, 0.9, torch.int32),
        ("tile", 20_001, 63, 9, 1000, 0.7, torch.int32),
        ("tile p=30", 2_001, 40, 30, 1, 0.9, torch.int32),
        ("tile empty tiles weighted", 100_003, 40, 4, 33, 0.5, torch.int32),
        ("tile unaligned", 50_001, 40, 4, 1000, 0.9, torch.int32),
        ("tile int16 saturating", 100_003, 515, 1, 33, 1.0, torch.int16),
    ):
        g = (more if "tile" in label else
             extra if "wide" in label or p > 8 else gen)
        zi = torch.randn(n, d, generator=g, device=dev)
        if n:
            zi, _ = lsh.scale_to_unit_ball(zi)
        zi = zi.contiguous()
        if "unaligned" in label:
            zi = unaligned(zi, 1)
            assert zi.is_contiguous() and zi.data_ptr() % 16
        wi = torch.randn(p, d + 2, r, generator=g, device=dev)
        mi = (weighted_mask((n,), keep, g) if "weighted" in label else
              (torch.rand(n, generator=g, device=dev) < keep).float())
        if "empty tiles" in label:
            mi = empty_tiles(mi)
        got = check_insert(label, zi, wi, mi, out_dtype)
        if "saturating" in label and int(got.max()) != torch.iinfo(out_dtype).max:
            raise AssertionError(f"{label} did not saturate")

    # -- 4. query kernel against its plain version ------------------------------
    def check_query(label, got, want):
        torch.cuda.synchronize()
        err = float((got - want).abs().max()) if got.numel() else 0.0
        name = "sketch_query_banked" if "banked" in label else "sketch_query"
        errs[name] = max(errs[name], err)
        _log(f"[query] {label}: max|err|={err:g}")
        if not (got.shape == want.shape and torch.equal(got, want)):
            raise AssertionError(f"query kernel differs from its plain "
                                 f"version at {label}")

    def random_counts(lead, rows_q, p_q, dtype):
        hi = min(torch.iinfo(dtype).max, 1 << 20)
        return torch.randint(-hi, hi, lead + (rows_q, 1 << p_q),
                             generator=extra, device=dev,
                             dtype=torch.int32).to(dtype)

    dtypes = (torch.int32, torch.int16, torch.int8)
    for m, g in ((17, gen), (198, gen), (4096, gen), (1001, gen), (0, extra),
                 (1, extra), (272, extra), (512, extra)):
        th = torch.randn(m, dim - 2, generator=g, device=dev)
        q = lsh.augment_query(lsh.normalize_query(th)).contiguous()
        check_query(f"m={m}", query_kernel.sketch_query(q, w, full_counts),
                    ref.sketch_query(q, w, full_counts))
    # Row slices (R = 1, 33, 2048), the staged body (p <= 8) and the generic
    # one (p > 8), narrow and negative counters, calls of different m in a
    # row.
    for i, (rows_q, p_q, m) in enumerate(itertools.product(
            (1, 33, 2048), (1, 4, 9, 16), (1, 17, 1001))):
        dtype = dtypes[i % 3]
        wq = torch.randn(p_q, dim, rows_q, generator=extra, device=dev)
        cq = random_counts((), rows_q, p_q, dtype)
        q = torch.randn(m, dim, generator=extra, device=dev)
        check_query(f"m={m} R={rows_q} p={p_q} {dtype}",
                    query_kernel.sketch_query(q, wq, cq),
                    ref.sketch_query(q, wq, cq))

    # -- 5. end-to-end fit ------------------------------------------------------
    k, steps = cfg.dfo.num_queries, cfg.dfo.steps
    directions = dfo.sphere_directions(gen, steps, 1, k, dim - 2, dev)
    refine = torch.randn(cfg.refine_steps, 1,
                         dfo.refine_sample_count(dim - 2), dim - 2,
                         generator=gen, device=dev)
    draws = dict(params=params, directions=directions, refine_samples=refine)

    def run_fit(engine):
        c = regression.StormRegressorConfig(engine=engine)
        torch.cuda.synchronize()
        start = time.perf_counter()
        fit = regression.fit(gen, x, y, c, device=dev, **draws)
        torch.cuda.synchronize()
        return fit, time.perf_counter() - start

    fit_kernel, _ = run_fit("auto")  # warm-up: libraries loaded, caches hot
    for c in counters.values():
        c.launches = 0
    fit_kernel, fit_s = run_fit("auto")
    fit_launches = {name: c.launches for name, c in counters.items()}
    launches = {name: fit_launches[name]
                for name in ("paired_hash_histogram", "sketch_query")}
    fit_plain, plain_s = run_fit("scan")

    var_y = float(y.var(correction=0))
    ols = baselines.ols(x, y)
    results = {}
    for name, fit, secs in (("kernel", fit_kernel, fit_s),
                            ("plain", fit_plain, plain_s)):
        mse = float(fit.mse(x, y))
        cos = float(torch.dot(fit.theta, ols.theta)
                    / (fit.theta.norm() * ols.theta.norm()))
        results[name] = mse
        _log(f"[fit] {name}: {secs:.3f} s, train MSE {mse:.6f} "
             f"(var(y) {var_y:.6f}, OLS MSE {float(ols.mse(x, y)):.6f}), "
             f"R^2 {1 - mse / var_y:.6f}, cos to OLS {cos:.6f}, "
             f"final sketch loss {float(fit.fleet_losses[0]):.6f}")
        if not (torch.isfinite(fit.theta).all() and fit.theta.shape
                == (D_FEATURES,)):
            raise AssertionError(f"{name} fit gave {fit.theta}")
    _log(f"[fit] launches in the kernel fit: {fit_launches}")
    if launches["paired_hash_histogram"] < 1:
        raise AssertionError("the fit did not run the insert kernel")
    expected_queries = steps + 2 * cfg.refine_steps + 1
    if (launches["sketch_query"] != expected_queries
            or sum(fit_launches.values()) != 1 + expected_queries):
        raise AssertionError(f"expected {expected_queries} query launches, "
                             f"got {fit_launches}")
    if not results["kernel"] < var_y:
        raise AssertionError("the kernel fit does not beat the mean predictor")
    if abs(results["kernel"] - results["plain"]) > 0.02 * results["plain"]:
        raise AssertionError("kernel and plain fits differ by more than 2%")

    # -- 6. single-sided insert against its plain version ------------------------
    def check_single(label, xi, wi, mi, out_dtype):
        got = insert_kernel.hash_histogram(xi, wi, mi, out_dtype)
        want = ref.hash_histogram(xi, wi, mi, out_dtype)
        torch.cuda.synchronize()
        err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        errs["hash_histogram"] = max(errs["hash_histogram"], err)
        mass = got.to(torch.int64).sum(1)
        _log(f"[single] {label}: n={xi.shape[0]} d={wi.shape[1]} "
             f"p={wi.shape[0]} R={wi.shape[2]} {out_dtype} max|err|={err:g} "
             f"row mass {int(mass.min())}..{int(mass.max())} "
             f"(sum(mask) = {int(mi.sum())})")
        if not torch.equal(got, want):
            raise AssertionError(f"single-sided insert kernel differs from "
                                 f"its plain version at {label}")
        return got

    def margin_rows(xc, yc):
        """The classification path's insert input: aug(unit-ball(-y x))."""
        zc, _ = lsh.scale_to_unit_ball(-yc[:, None] * xc, 1.05)
        return lsh.augment_data(zc).contiguous()

    xc, yc, _ = datasets.make_classification(gen, N_ROWS, D_FEATURES,
                                             MARGIN)
    xa = margin_rows(xc, yc)  # (n, d + 2)
    ccfg = classification.StormClassifierConfig(rows=CLS_ROWS,
                                                planes=CLS_PLANES)
    cparams = lsh.init_srp(gen, CLS_ROWS, CLS_PLANES, D_FEATURES + 2,
                           device=dev)
    wc = ops.from_lsh_params(cparams)  # (p, d + 2, R)
    check_single("full", xa, wc, ones, torch.int32)

    def generic_rows(n, d, g=gen):
        """Rows that are not augmented: about a tenth of the entries +0.0
        and a tenth -0.0, every 97th row all zeros (+0.0 or -0.0), so that a
        kernel which skipped a column or assumed the augmented layout would
        differ."""
        xi = torch.randn(n, d, generator=g, device=dev)
        u = torch.rand(n, d, generator=g, device=dev)
        xi = torch.where(u < 0.1, torch.zeros_like(xi), xi)
        xi = torch.where((u >= 0.1) & (u < 0.2), -torch.zeros_like(xi), xi)
        xi[::97] = 0.0
        xi[48::194] = -0.0
        return xi

    for label, n, d, p, r, keep, out_dtype in (
        ("ragged", 100_003, 11, 1, 1000, 0.9, torch.int32),
        ("ragged", 77_777, 7, 2, 130, 0.7, torch.int32),
        ("ragged", 12_345, 15, 4, 77, 0.5, torch.int32),
        ("ragged", 5_001, 32, 8, 333, 1.0, torch.int32),
        ("ragged d", 100_003, 11, 4, 1024, 0.6, torch.int32),
        ("ragged d", 50_001, 11, 5, 1024, 0.5, torch.int32),
        ("ragged d", 50_001, 16, 3, 1000, 0.5, torch.int32),
        ("ragged d", 50_001, 17, 6, 513, 0.5, torch.int32),
        ("ragged d", 33_333, 1, 2, 300, 0.8, torch.int32),
        ("ragged n", 31, 11, 2, 1024, 1.0, torch.int32),
        ("ragged n", 33, 11, 2, 1024, 0.7, torch.int32),
        ("ragged n", 0, 11, 2, 1024, 1.0, torch.int32),
        ("weighted", 100_003, 11, 2, 1024, 0.5, torch.int32),
        ("weighted", 100_003, 11, 4, 1024, 0.5, torch.int32),
        ("weighted", 50_001, 16, 4, 333, 0.5, torch.int32),
        ("weighted", 50_001, 17, 8, 100, 0.5, torch.int32),
        ("generic", 100_003, 11, 2, 1024, 0.9, torch.int32),
        ("generic", 100_003, 11, 4, 1024, 0.9, torch.int32),
        ("generic", 50_001, 5, 8, 200, 0.9, torch.int32),
        ("generic weighted", 50_001, 31, 3, 300, 0.5, torch.int32),
        ("unaligned", 100_003, 11, 2, 1024, 0.9, torch.int32),
        ("unaligned generic", 50_001, 13, 4, 500, 0.9, torch.int32),
        ("int16 saturating", 200_001, 4, 1, 50, 1.0, torch.int16),
        ("int16", 30_000, 11, 2, 1024, 0.8, torch.int16),
        ("int8 saturating", 50_001, 3, 2, 64, 1.0, torch.int8),
        ("int8 saturating weighted", 50_001, 11, 2, 64, 0.5, torch.int8),
        ("wide", 100_003, 35, 4, 1024, 0.9, torch.int32),
        ("wide", 50_001, 64, 2, 300, 0.5, torch.int32),
        ("wide", 20_001, 515, 9, 257, 0.7, torch.int32),
        ("wide", 3_001, 4096, 4, 100, 0.8, torch.int32),
        ("p=9", 50_001, 11, 9, 513, 0.7, torch.int32),
        ("wide weighted", 50_001, 42, 9, 64, 0.5, torch.int32),
        ("wide generic", 20_001, 70, 4, 300, 0.9, torch.int32),
        ("wide int8 saturating", 50_001, 64, 2, 64, 1.0, torch.int8),
        # The projection tile's shapes, as in phase 3.
        ("tile", 8_191, 515, 4, 2048, 1.0, torch.int32),
        ("tile", 50_001, 63, 5, 1000, 0.5, torch.int32),
        ("tile", 30_001, 33, 8, 2048, 0.8, torch.int32),
        ("tile", 20_001, 40, 1, 1, 0.9, torch.int32),
        ("tile p=30", 2_001, 41, 30, 1, 0.9, torch.int32),
        ("tile empty tiles weighted", 100_003, 40, 4, 33, 0.5, torch.int32),
        ("tile unaligned generic", 50_001, 63, 4, 1000, 0.9, torch.int32),
        ("tile int16 saturating weighted", 100_003, 515, 1, 33, 0.5,
         torch.int16),
    ):
        g = (more if "tile" in label else
             extra if "wide" in label or p > 8 else gen)
        if "generic" in label or d < 3:
            xi = generic_rows(n, d, g)
        else:
            zi = torch.randn(n, d - 2, generator=g, device=dev)
            if n:
                zi = lsh.scale_to_unit_ball(zi)[0]
            xi = lsh.augment_data(zi).contiguous()
        if "unaligned" in label:
            xi = unaligned(xi, 1)
            assert xi.is_contiguous() and xi.data_ptr() % 16
        wi = torch.randn(p, d, r, generator=g, device=dev)
        mi = (weighted_mask((n,), keep, g) if "weighted" in label else
              (torch.rand(n, generator=g, device=dev) < keep).float())
        if "empty tiles" in label:
            mi = empty_tiles(mi)
        before = insert_kernel.hash_histogram.launches
        got = check_single(label, xi, wi, mi, out_dtype)
        if insert_kernel.hash_histogram.launches != before + (n > 0):
            raise AssertionError(f"{label}: expected {int(n > 0)} launch")
        if "saturating" in label and int(got.max()) != torch.iinfo(out_dtype).max:
            raise AssertionError(f"{label} did not saturate")

    # -- 7. banked inserts: the bank build, then each slice ----------------------
    sizes = [TENANT_ROWS] * (TENANTS - 1) + [TENANT_ROWS - TENANT_SHORT]
    reg_tenants = [datasets.make_regression(gen, nt, D_FEATURES, NOISE,
                                            CONDITION)[:2] for nt in sizes]
    cls_tenants = [datasets.make_classification(gen, nt, D_FEATURES, MARGIN)
                   [:2] for nt in sizes]
    z_tenants = []
    for xt, yt in reg_tenants:
        xs_t, ys_t, *_ = regression._standardize(xt, yt, True)
        zt, _ = lsh.scale_to_unit_ball(torch.cat([xs_t, ys_t[:, None]], 1),
                                       cfg.norm_slack)
        z_tenants.append(zt.contiguous())
    x_tenants = [margin_rows(xt, yt) for xt, yt in cls_tenants]
    bank_params = {True: params, False: cparams}
    stacks = {True: z_tenants, False: x_tenants}
    for c in counters.values():
        c.launches = 0
    banks = {paired: sketch_lib.sketch_dataset_many(
        bank_params[paired], stacks[paired], paired=paired, engine="kernel",
        device=dev) for paired in (True, False)}
    torch.cuda.synchronize()
    build_launches = {name: c.launches for name, c in counters.items()}
    _log(f"[bank] launches in the bank build: {build_launches}")
    if (build_launches["paired_hash_histogram_banked"] != 1
            or build_launches["hash_histogram_banked"] != 1
            or build_launches["paired_hash_histogram"]
            or build_launches["hash_histogram"]):
        raise AssertionError("the bank build did not run one banked insert "
                             "per bank")
    launches["paired_hash_histogram_banked"] = build_launches[
        "paired_hash_histogram_banked"]
    launches["hash_histogram_banked"] = build_launches["hash_histogram_banked"]
    for paired, name, lone, plain in (
        (True, "paired_hash_histogram_banked",
         insert_kernel.paired_hash_histogram, ref.paired_hash_histogram_banked),
        (False, "hash_histogram_banked", insert_kernel.hash_histogram,
         ref.hash_histogram_banked),
    ):
        bank = banks[paired]
        wb = ops.from_lsh_params(bank_params[paired])
        stacked, mask = sketch_lib.stack_ragged(stacks[paired])
        want = plain(stacked, wb, mask)
        torch.cuda.synchronize()
        err = float((bank.counts.to(torch.int64) - want.to(torch.int64))
                    .abs().max())
        errs[name] = max(errs[name], err)
        slices_equal = all(
            torch.equal(bank.counts[i], lone(
                zt, wb, torch.ones(zt.shape[0], device=dev)))
            for i, zt in enumerate(stacks[paired]))
        per_point = 2 if paired else 1
        mass_ok = torch.equal(
            bank.counts.to(torch.int64).sum(2),
            per_point * bank.n.to(torch.int64)[:, None].expand(
                TENANTS, bank.rows))
        _log(f"[bank] {name}: S={TENANTS} n={sizes[0]}..{sizes[-1]} "
             f"R={bank.rows} B={bank.buckets}; max|err| vs plain={err:g}; "
             f"slices equal the lone kernel: {slices_equal}; row masses "
             f"{per_point}n: {mass_ok}; n={bank.n.tolist()}")
        if not (torch.equal(bank.counts, want) and slices_equal and mass_ok
                and bank.n.tolist() == sizes):
            raise AssertionError(f"{name}: the bank differs from its plain "
                                 f"version or from the lone kernel")

    # A gateway-shaped bank (ingest slots about half masked, interleaved),
    # then one whose masks carry integer weights in some tiles only; paired
    # (the regression family's rows and hash) and single-sided (augmented
    # margin-shaped rows under the classification hash).
    for paired, label in itertools.product((True, False),
                                           ("interleaved", "weighted")):
        if paired:
            name, wg = "paired_hash_histogram_banked", w
            banked = insert_kernel.paired_hash_histogram_banked
            lone = insert_kernel.paired_hash_histogram
            plain = ref.paired_hash_histogram_banked
            width = D_FEATURES + 1
        else:
            name, wg = "hash_histogram_banked", wc
            banked = insert_kernel.hash_histogram_banked
            lone = insert_kernel.hash_histogram
            plain = ref.hash_histogram_banked
            width = D_FEATURES
        zg = torch.stack([lsh.scale_to_unit_ball(torch.randn(
            GW_INGEST_SLOTS, width, generator=gen, device=dev))[0]
            for _ in range(TENANTS)])
        zg = (zg if paired else lsh.augment_data(zg)).contiguous()
        mg = (weighted_mask((TENANTS, GW_INGEST_SLOTS), 0.5)
              if label == "weighted" else
              (torch.rand(TENANTS, GW_INGEST_SLOTS, generator=gen,
                          device=dev) < 0.5).float())
        got = banked(zg, wg, mg)
        want = plain(zg, wg, mg)
        torch.cuda.synchronize()
        err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        errs[name] = max(errs[name], err)
        slices_equal = all(torch.equal(got[i], lone(zg[i], wg, mg[i]))
                           for i in range(TENANTS))
        kind = "paired" if paired else "single-sided"
        _log(f"[bank] {label} {kind} bank: S={TENANTS} slots="
             f"{GW_INGEST_SLOTS} valid={int((mg != 0).sum())} "
             f"sum(int(mask))={int(mg.to(torch.int64).sum())}; max|err| vs "
             f"plain={err:g}; slices equal the lone kernel: {slices_equal}")
        if not (torch.equal(got, want) and slices_equal):
            raise AssertionError(f"the {label} {kind} bank differs from its "
                                 f"plain version or from the lone kernel")

    # Wide banks: the wide body's banked launch, paired and single-sided;
    # 4095 slots put the tenants' rows off 16-byte alignment.
    for paired, width, p_w, r_w, slots in (
            (True, 40, 9, 512, GW_INGEST_SLOTS),
            (True, 515, 4, 300, GW_INGEST_SLOTS),
            (False, 66, 4, 512, GW_INGEST_SLOTS),
            (True, 63, 5, 1000, GW_INGEST_SLOTS - 1),
            (False, 63, 8, 2048, GW_INGEST_SLOTS - 1),
            (False, 515, 1, 33, GW_INGEST_SLOTS - 1)):
        g = extra if slots == GW_INGEST_SLOTS else more
        if paired:
            name = "paired_hash_histogram_banked"
            banked = insert_kernel.paired_hash_histogram_banked
            lone = insert_kernel.paired_hash_histogram
            plain = ref.paired_hash_histogram_banked
            zg = torch.stack([lsh.scale_to_unit_ball(torch.randn(
                slots, width, generator=g, device=dev))[0]
                for _ in range(4)]).contiguous()
            wg = torch.randn(p_w, width + 2, r_w, generator=g,
                             device=dev)
        else:
            name = "hash_histogram_banked"
            banked = insert_kernel.hash_histogram_banked
            lone = insert_kernel.hash_histogram
            plain = ref.hash_histogram_banked
            zg = lsh.augment_data(torch.stack([lsh.scale_to_unit_ball(
                torch.randn(slots, width - 2, generator=g,
                            device=dev))[0] for _ in range(4)])).contiguous()
            wg = torch.randn(p_w, width, r_w, generator=g, device=dev)
        mg = weighted_mask((4, slots), 0.5, g)
        got = banked(zg, wg, mg)
        want = plain(zg, wg, mg)
        torch.cuda.synchronize()
        err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        errs[name] = max(errs[name], err)
        slices_equal = all(torch.equal(got[i], lone(zg[i], wg, mg[i]))
                           for i in range(4))
        _log(f"[bank] wide {'paired' if paired else 'single-sided'} bank: "
             f"S=4 slots={slots} d={width} p={p_w} R={r_w}, "
             f"weighted; max|err| vs plain={err:g}; slices equal the lone "
             f"kernel: {slices_equal}")
        if not (torch.equal(got, want) and slices_equal):
            raise AssertionError(f"the wide bank (d={width}, p={p_w}) differs "
                                 f"from its plain version or the lone kernel")

    # -- 8. banked query against its plain version -------------------------------
    bank = banks[True]
    member_major = torch.repeat_interleave(
        torch.arange(TENANTS, dtype=torch.int32, device=dev), 2 * k + 1)
    for m_q, dtype in ((TENANTS * (2 * k + 1), torch.int32),
                       (TENANTS, torch.int32), (2 * TENANTS, torch.int32),
                       (TENANTS * dfo.refine_sample_count(dim - 2),
                        torch.int32), (4096, torch.int32),
                       (TENANTS * (2 * k + 1), torch.int16),
                       (4096, torch.int8)):
        th = torch.randn(m_q, dim - 2, generator=gen, device=dev)
        q = lsh.augment_query(lsh.normalize_query(th)).contiguous()
        idx = (member_major if m_q == member_major.numel() else
               torch.randint(0, TENANTS, (m_q,), generator=gen, device=dev,
                             dtype=torch.int32))
        cnt = sketch_lib.saturating_cast(bank.counts, dtype)
        check_query(f"banked m={m_q} {dtype}",
                    query_kernel.sketch_query_banked(q, w, cnt, idx),
                    ref.sketch_query_banked(q, w, cnt, idx))
    for m_q, dtype in ((0, torch.int32), (1, torch.int32), (17, torch.int16),
                       (TENANTS * GW_QUERY_SLOTS, torch.int32)):
        th = torch.randn(m_q, dim - 2, generator=extra, device=dev)
        q = lsh.augment_query(lsh.normalize_query(th)).contiguous()
        idx = torch.randint(0, TENANTS, (m_q,), generator=extra, device=dev,
                            dtype=torch.int32)
        cnt = sketch_lib.saturating_cast(bank.counts, dtype)
        check_query(f"banked m={m_q} {dtype}",
                    query_kernel.sketch_query_banked(q, w, cnt, idx),
                    ref.sketch_query_banked(q, w, cnt, idx))
    for i, (rows_q, p_q, m_q) in enumerate(itertools.product(
            (1, 33, 2048), (1, 9, 16), (17, 1001))):
        dtype = dtypes[i % 3]
        wq = torch.randn(p_q, dim, rows_q, generator=extra, device=dev)
        cq = random_counts((3,), rows_q, p_q, dtype)
        q = torch.randn(m_q, dim, generator=extra, device=dev)
        idx = torch.randint(0, 3, (m_q,), generator=extra, device=dev)
        check_query(f"banked m={m_q} R={rows_q} p={p_q} {dtype}",
                    query_kernel.sketch_query_banked(q, wq, cq, idx),
                    ref.sketch_query_banked(q, wq, cq, idx))

    # -- 9. classification fit, then logistic and kmeans -------------------------
    csteps = ccfg.dfo.steps
    cdraws = dict(
        params=cparams,
        directions=dfo.sphere_directions(gen, csteps, 1, k, D_FEATURES, dev),
        theta0_noise=torch.randn(D_FEATURES, generator=gen, device=dev))

    def run_cls(engine):
        c = dataclasses.replace(ccfg, engine=engine)
        torch.cuda.synchronize()
        start = time.perf_counter()
        fit = classification.fit(gen, xc, yc, c, device=dev, **cdraws)
        torch.cuda.synchronize()
        return fit, time.perf_counter() - start

    run_cls("auto")  # warm-up
    for c in counters.values():
        c.launches = 0
    cls_kernel, cls_s = run_cls("auto")
    cls_launches = {name: c.launches for name, c in counters.items()}
    with plain_versions():
        cls_ref, _ = run_cls("auto")
    if not torch.equal(cls_ref.theta, cls_kernel.theta):
        raise AssertionError("the kernel classification fit differs from the "
                             "same fit through the kernels' plain versions")
    cls_plain, cls_plain_s = run_cls("scan")
    accs = {}
    for name, fit, secs in (("kernel", cls_kernel, cls_s),
                            ("plain", cls_plain, cls_plain_s)):
        accs[name] = float(fit.accuracy(xc, yc))
        _log(f"[cls] {name}: {secs:.3f} s, accuracy {accs[name]:.6f}, final "
             f"sketch loss {float(fit.fleet_losses[0]):.6f}")
        if not (torch.isfinite(fit.theta).all()
                and fit.theta.shape == (D_FEATURES,)):
            raise AssertionError(f"{name} classification fit gave {fit.theta}")
    _log(f"[cls] launches in the kernel fit: {cls_launches}")
    expected = csteps + 2 * ccfg.refine_steps + 1
    if (cls_launches["hash_histogram"] != 1
            or cls_launches["sketch_query"] != expected
            or sum(cls_launches.values()) != 1 + expected):
        raise AssertionError(f"expected 1 hash_histogram and {expected} "
                             f"sketch_query launches, got {cls_launches}")
    launches["hash_histogram"] = cls_launches["hash_histogram"]
    if abs(accs["kernel"] - accs["plain"]) > 0.005:
        raise AssertionError("kernel and plain classification accuracies "
                             "differ by more than 0.5 points")

    scfg = erm.ERMConfig(rows=CLS_ROWS, planes=CLS_PLANES)
    for c in counters.values():
        c.launches = 0
    logi = erm.fit_surrogate("logistic", gen, xc, yc, scfg, device=dev)
    torch.cuda.synchronize()
    logi_acc = float(torch.mean((torch.sign(xc @ logi.theta) == yc)
                                .to(torch.float32)))
    _log(f"[logistic] accuracy {logi_acc:.6f}; launches "
         f"{ {n: c.launches for n, c in counters.items()} }")
    centers = torch.randn(2, D_FEATURES, generator=gen, device=dev)
    centers = centers / torch.linalg.vector_norm(centers, dim=-1,
                                                 keepdim=True)
    pts = torch.cat([centers[i] + 0.15 * torch.randn(
        N_ROWS // 2, D_FEATURES, generator=gen, device=dev)
        for i in range(2)])
    kcfg = erm.ERMConfig(rows=CLS_ROWS, planes=KMEANS_PLANES)
    for c in counters.values():
        c.launches = 0
    km = erm.fit_surrogate("kmeans", gen, pts, None, kcfg, device=dev)
    torch.cuda.synchronize()
    zk, _ = lsh.scale_to_unit_ball(pts, 1.05)
    rand_dirs = torch.randn(32, D_FEATURES, generator=gen, device=dev)
    dens_fit = -float(km.objective(zk))
    dens_rand = statistics.mean(
        -float(losses.KMEANS.objective(v, zk, KMEANS_PLANES))
        for v in rand_dirs)
    gain = dens_fit / max(dens_rand, 1e-12)
    _log(f"[kmeans] density gain over 32 random directions {gain:.6f}; "
         f"launches { {n: c.launches for n, c in counters.items()} }")
    for name, fit in (("logistic", logi), ("kmeans", km)):
        if not torch.isfinite(fit.theta).all():
            raise AssertionError(f"{name} fit gave {fit.theta}")

    # -- 10. banked regression fit -------------------------------------------
    fleet_size = TENANTS * cfg.restarts
    mdraws = dict(
        params=params,
        directions=dfo.sphere_directions(gen, steps, fleet_size, k, dim - 2,
                                         dev),
        refine_samples=torch.randn(
            cfg.refine_steps, fleet_size, dfo.refine_sample_count(dim - 2),
            dim - 2, generator=gen, device=dev))
    xs_m = [xt for xt, _ in reg_tenants]
    ys_m = [yt for _, yt in reg_tenants]

    def run_many(engine):
        c = regression.StormRegressorConfig(engine=engine)
        torch.cuda.synchronize()
        start = time.perf_counter()
        fit = regression.fit_many(gen, xs_m, ys_m, c, device=dev, **mdraws)
        torch.cuda.synchronize()
        return fit, time.perf_counter() - start

    run_many("auto")  # warm-up
    for c in counters.values():
        c.launches = 0
    many_kernel, many_s = run_many("auto")
    many_launches = {name: c.launches for name, c in counters.items()}
    with plain_versions():
        many_plain, many_plain_s = run_many("auto")
    many_scan, many_scan_s = run_many("scan")
    _log(f"[many] kernel {many_s:.3f} s, plain versions {many_plain_s:.3f} s, "
         f"scan engine {many_scan_s:.3f} s; launches in the kernel fit: "
         f"{many_launches}")
    expected = steps + 2 * cfg.refine_steps + 1
    if (many_launches["paired_hash_histogram"] != TENANTS
            or many_launches["sketch_query_banked"] != expected
            or many_launches["sketch_query"] != 0
            or sum(many_launches.values()) != TENANTS + expected):
        raise AssertionError(f"expected {TENANTS} paired inserts and "
                             f"{expected} banked queries, got {many_launches}")
    launches["sketch_query_banked"] = many_launches["sketch_query_banked"]
    faults = []
    for i, (xt, yt) in enumerate(reg_tenants):
        var_t = float(yt.var(correction=0))
        mse_k, mse_p, mse_s = (float(f.select(i).mse(xt, yt)) for f in
                               (many_kernel, many_plain, many_scan))
        _log(f"[many] tenant {i}: n={xt.shape[0]} MSE kernel {mse_k:.6f}, "
             f"plain versions {mse_p:.6f} ({100 * (mse_k / mse_p - 1):+.3f}%), "
             f"scan engine {mse_s:.6f} ({100 * (mse_k / mse_s - 1):+.3f}%); "
             f"var(y) {var_t:.6f}, R^2 {1 - mse_k / var_t:.6f}")
        if not torch.isfinite(many_kernel.theta[i]).all():
            faults.append(f"tenant {i} fit gave {many_kernel.theta[i]}")
        if not (mse_k < var_t and mse_s < var_t):
            faults.append(f"tenant {i} does not beat its mean predictor")
        if abs(mse_k - mse_p) > 0.02 * mse_p:
            faults.append(f"tenant {i}: kernel and plain-version fits differ "
                          f"by more than 2%")
    if not (torch.equal(many_kernel.theta, many_plain.theta)
            and torch.equal(many_kernel.bank.counts, many_plain.bank.counts)):
        faults.append("the kernel fit differs from the same fit through the "
                      "kernels' plain versions")
    if faults:
        raise AssertionError("; ".join(faults))

    # -- 12. kernel 7: srp_hash on its own entry point -------------------------
    counters["srp_hash"] = hash_kernel.srp_hash
    errs["srp_hash"] = 0.0

    def check_srp(label, xi, wi, got):
        # The plain version by row chunks of at most 2^28 codes, so that a
        # large output needs no second copy.
        step = max(1, (1 << 28) // wi.shape[2])
        err, equal = 0.0, got.shape == (xi.shape[0], wi.shape[2])
        for a in range(0, xi.shape[0], step):
            want = ref.srp_hash(xi[a:a + step], wi)
            part = got[a:a + step]
            err = max(err, float((part.to(torch.int64)
                                  - want.to(torch.int64)).abs().max()))
            equal = equal and torch.equal(part, want)
        torch.cuda.synchronize()
        errs["srp_hash"] = max(errs["srp_hash"], err)
        _log(f"[srp] {label}: n={xi.shape[0]} d={wi.shape[1]} p={wi.shape[0]}"
             f" R={wi.shape[2]} max|err|={err:g}")
        if not equal:
            raise AssertionError(f"srp_hash kernel differs from its plain "
                                 f"version at {label}")

    th_h = torch.randn(SRP_ROWS, dim - 2, generator=gen, device=dev)
    xh = lsh.augment_query(lsh.normalize_query(th_h)).contiguous()
    for c in counters.values():
        c.launches = 0
    codes = ops.srp_hash(xh, w)  # the entry point, as a user calls it
    torch.cuda.synchronize()
    srp_launches = {name: c.launches for name, c in counters.items()}
    if srp_launches["srp_hash"] != 1 or sum(srp_launches.values()) != 1:
        raise AssertionError(f"ops.srp_hash made {srp_launches}")
    launches["srp_hash"] = srp_launches["srp_hash"]
    check_srp("full", xh, w, codes)
    del codes
    for n_h, d_h, r_h, p_h in SRP_RAGGED:
        xi = torch.randn(n_h, d_h, generator=gen, device=dev)
        wi = torch.randn(p_h, d_h, r_h, generator=gen, device=dev)
        check_srp("ragged", xi, wi, hash_kernel.srp_hash(xi, wi))
    for n_h, d_h, r_h, p_h in SRP_TILE:
        xi = torch.randn(n_h, d_h, generator=more, device=dev)
        wi = torch.randn(p_h, d_h, r_h, generator=more, device=dev)
        before = hash_kernel.srp_hash.launches
        got = hash_kernel.srp_hash(xi, wi)
        if hash_kernel.srp_hash.launches != before + (n_h > 0):
            raise AssertionError(f"srp_hash at n={n_h}: expected "
                                 f"{int(n_h > 0)} launch")
        check_srp("tile" if d_h > 32 or p_h > 8 else "register", xi, wi, got)
        del got

    # -- 13. the serving gateway at full width ----------------------------------
    gw_mod = storm_gateway
    warm = banks[True]  # phase 7's 16 x 2^18 paired bank, int32
    gw_dim = dim - 2    # sketch-space rows: 9 features and y

    def flat_gateway(bank=None, mode="auto", count_dtype=torch.int32,
                     gparams=params, paired=True, tenants=TENANTS):
        return gw_mod.StormGateway(
            gparams, tenants, paired=paired, query_slots=GW_QUERY_SLOTS,
            ingest_slots=GW_INGEST_SLOTS, mode=mode, count_dtype=count_dtype,
            bank=bank, device=dev)

    script = gateway_script(storm_serve, gw_mod, SEED + 13, GW_ROUNDS,
                            TENANTS, gw_dim)
    guard = lambda: no_host_sync(torch)  # noqa: E731
    gw = flat_gateway(bank=warm)
    log = TickLog(gw)
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    sync_reports, *_ = drive(gw, script, on_start=log, guard=guard)
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    gw_launches = {name: c.launches for name, c in counters.items()}
    _log(f"[gateway] sync run (tick_start under sync debug mode 'error'): "
         f"{gw.ticks} ticks, {gw.rows_ingested} rows, {gw.points_served} "
         f"points, {gw.fits_run} fits in {check_s:.3f} s; trace_count "
         f"{gw.trace_count}; staging waits {gw.staging_waits}; launches "
         f"{gw_launches}")
    if (gw_launches["paired_hash_histogram_banked"] < 1
            or gw_launches["sketch_query_banked"] < 1
            or gw_launches["paired_hash_histogram"]
            or gw_launches["sketch_query"]):
        raise AssertionError("the gateway did not serve through the banked "
                             "kernels alone")
    if gw.trace_count > 3 or len({sig[0] for sig in gw._signatures}) != 3:
        raise AssertionError(f"tick bodies: {gw._signatures}")

    # Counters: the warm bank plus each tenant's lone paired insert.
    streams = streams_of(script, gw_mod, TENANTS)
    for t, zt in enumerate(streams):
        zt = torch.from_numpy(zt).to(dev)
        lone = insert_kernel.paired_hash_histogram(
            zt, w, torch.ones(zt.shape[0], device=dev))
        if not (torch.equal(gw.bank.counts[t], warm.counts[t] + lone)
                and int(gw.bank.n[t]) == int(warm.n[t]) + zt.shape[0]):
            raise AssertionError(f"tenant {t}'s served counters differ from "
                                 f"the warm bank plus its lone insert")
    served = check_queries(log, sync_reports, script, gw_mod, w, True, ops,
                           sketch_lib, torch)
    # Each cohort fit against the offline erm.fit_many on the same counters.
    fit_reports = [(rep.tick, f) for rep in sync_reports for f in rep.fits]
    for tick, f in fit_reports:
        counts_k, n_k = log.snaps[tick]
        sub = sketch_lib.SketchBank(
            counts=counts_k[list(f.tenants)].to(torch.int32),
            n=n_k[list(f.tenants)])
        req = next(r for reqs in script for r in reqs if r.rid == f.rid)
        want = erm.fit_many(
            req.surrogate, sub, params,
            dfo.DFOConfig(steps=req.steps, num_queries=req.num_queries,
                          sigma=req.sigma, learning_rate=req.learning_rate,
                          decay=req.decay),
            restarts=req.restarts, l2=req.l2, refine_steps=req.refine_steps,
            generator=generator(req.seed, dev), device=dev)
        if not (np.array_equal(f.theta, want.theta.cpu().numpy())
                and np.array_equal(f.fleet_losses,
                                   want.fleet_losses.cpu().numpy())):
            raise AssertionError(f"the gateway fit at tick {tick} differs "
                                 f"from the offline fit_many")
    if len(fit_reports) != GW_ROUNDS // GW_FIT_EVERY:
        raise AssertionError(f"{len(fit_reports)} fits ran")
    _log(f"[gateway] counters equal warm + lone inserts for {TENANTS} "
         f"tenants; {served} placements equal standalone queries; "
         f"{len(fit_reports)} fits equal the offline fit_many")

    # One full tick: one banked insert, one banked query, nothing else.
    gw.submit_many(storm_serve.synth_traffic(
        np.random.default_rng(SEED), itertools.count(10 ** 6), TENANTS,
        gw_dim, GW_INGEST_RATE, GW_QUERY_RATE))
    for c in counters.values():
        c.launches = 0
    gw.tick()
    tick_launches = {name: c.launches for name, c in counters.items()}
    if (tick_launches["paired_hash_histogram_banked"] != 1
            or tick_launches["sketch_query_banked"] != 1
            or sum(tick_launches.values()) != 2):
        raise AssertionError(f"a full tick made {tick_launches}")
    _log(f"[gateway] one full tick: {tick_launches}")

    # Pipelined at depth 2 and 3 against the synchronous loop.
    sync_keys = [report_key(r) for r in sync_reports]
    final, final_n = log.snaps[max(log.snaps)]
    for depth in (2, 3):
        gp = flat_gateway(bank=warm)
        reps, *_ = drive(gp, script, depth=depth, guard=guard)
        if not ([report_key(r) for r in reps] == sync_keys
                and torch.equal(gp.bank.counts, final)):
            raise AssertionError(f"depth {depth} differs from the sync loop")
        _log(f"[gateway] depth {depth}: {len(reps)} reports, counters and "
             f"order equal the sync loop")
    # The plain versions (mode="ref") over the first rounds.
    gr = flat_gateway(bank=warm, mode="ref")
    reps, *_ = drive(gr, script[:GW_REF_ROUNDS], drain=False)
    if not ([report_key(r) for r in reps] == sync_keys[:GW_REF_ROUNDS]
            and torch.equal(gr.bank.counts, log.snaps[GW_REF_ROUNDS][0])):
        raise AssertionError("the gateway through the plain versions differs")
    _log(f"[gateway] mode='ref': {GW_REF_ROUNDS} ticks equal bit for bit")
    # An int16 copy saturates where the int32 run's saturating cast says.
    g16 = flat_gateway(bank=sketch_lib.SketchBank(
        counts=sketch_lib.saturating_cast(warm.counts, torch.int16),
        n=warm.n), count_dtype=torch.int16)
    drive(g16, script[:GW_NARROW_ROUNDS], drain=False)
    want16 = sketch_lib.saturating_cast(log.snaps[GW_NARROW_ROUNDS][0],
                                        torch.int16)
    saturated = int((log.snaps[GW_NARROW_ROUNDS][0] > 32767).sum())
    if not (torch.equal(g16.bank.counts, want16) and saturated
            and int(g16.bank.counts.max()) == 32767):
        raise AssertionError("the int16 gateway differs from the saturated "
                             "int32 counters")
    _log(f"[gateway] int16 copy: {GW_NARROW_ROUNDS} ticks equal the "
         f"saturating cast of the int32 counters ({saturated} cells "
         f"saturated)")
    del log, g16, gr

    # A short single-sided run: kernel 5 on the path.
    def augment(z):
        zt = torch.from_numpy(z)
        zt = zt / torch.clamp(torch.linalg.vector_norm(zt, dim=1,
                                                       keepdim=True), min=1.0)
        return lsh.augment_data(zt).numpy()

    s_script = gateway_script(storm_serve, gw_mod, SEED + 14,
                              GW_SINGLE_ROUNDS, TENANTS, D_FEATURES,
                              fits=False, augment=augment)
    gs = flat_gateway(gparams=cparams, paired=False)
    slog = TickLog(gs)
    for c in counters.values():
        c.launches = 0
    s_reports, *_ = drive(gs, s_script, on_start=slog, guard=guard)
    torch.cuda.synchronize()
    single_launches = {name: c.launches for name, c in counters.items()}
    if (single_launches["hash_histogram_banked"] < 1
            or single_launches["sketch_query_banked"] < 1
            or single_launches["paired_hash_histogram_banked"]):
        raise AssertionError(f"the single-sided gateway made "
                             f"{single_launches}")
    for t, xt in enumerate(streams_of(s_script, gw_mod, TENANTS)):
        xt = torch.from_numpy(xt).to(dev)
        lone = insert_kernel.hash_histogram(
            xt, wc, torch.ones(xt.shape[0], device=dev))
        if not torch.equal(gs.bank.counts[t], lone):
            raise AssertionError(f"single-sided tenant {t} differs from its "
                                 f"lone insert")
    s_served = check_queries(slog, s_reports, s_script, gw_mod, wc, False,
                             ops, sketch_lib, torch)
    _log(f"[gateway] single-sided (R={CLS_ROWS}, p={CLS_PLANES}): counters "
         f"equal the lone inserts, {s_served} placements equal standalone "
         f"queries; launches {single_launches}")
    del slog, gs

    # -- 14. the tiered gateway -------------------------------------------------
    z_script = zipf_script(gw_mod, SEED + 15, TIERED_ROUNDS, TIERED_TENANTS,
                           gw_dim)

    def tiered_gateway():
        return tiered_mod.TieredStormGateway(
            params, TIERED_TENANTS, TIERED_HOT, query_slots=GW_QUERY_SLOTS,
            ingest_slots=GW_INGEST_SLOTS, count_dtype=torch.int16,
            promote_per_tick=TIERED_PROMOTE_PER_TICK, device=dev)

    gt = tiered_gateway()
    swaps = [0]  # swap_count after each tick_start

    def count_swaps(fl):
        swaps.append(gt.tiers.swap_count)

    t_reports, *_ = drive(gt, z_script, on_start=count_swaps, guard=guard)
    flat64 = flat_gateway(count_dtype=torch.int16, tenants=TIERED_TENANTS)
    drive(flat64, z_script)
    for t in range(TIERED_TENANTS):
        sk = gt.sketch_of(t)
        if not (torch.equal(sk.counts, flat64.bank.counts[t])
                and int(sk.n) == int(flat64.bank.n[t])):
            raise AssertionError(f"tiered tenant {t} differs from the flat "
                                 f"64-tenant gateway")
    gtp = tiered_gateway()
    tp_reports, *_ = drive(gtp, z_script, depth=2, guard=guard)
    if [report_key(r) for r in tp_reports] != [report_key(r)
                                               for r in t_reports]:
        raise AssertionError("the pipelined tiered gateway differs from the "
                             "sync loop")
    for t in range(TIERED_TENANTS):
        if not torch.equal(gtp.sketch_of(t).counts, gt.sketch_of(t).counts):
            raise AssertionError(f"pipelined tiered tenant {t} differs")
    if gt.trace_count > 4 or gtp.trace_count > 4:
        raise AssertionError(f"tiered trace_count {gt.trace_count}")
    tier = gt.queue_stats()["tier"]
    _log(f"[tiered] T={TIERED_TENANTS} H={TIERED_HOT} int16, Zipf "
         f"{ZIPF_EXPONENT}: {gt.ticks} ticks, "
         f"{sum(b > a for a, b in zip(swaps, swaps[1:]))} of them swapped "
         f"({tier['swap_count']} swaps, {gt.promotions} promotions, "
         f"{gt.deferred_promotions} deferred); final sketches equal the flat "
         f"64-tenant int16 gateway's; depth 2 equals sync; trace_count "
         f"{gt.trace_count}; tick_start ran under sync debug mode 'error'")
    tiered_final = [gt.sketch_of(t) for t in range(TIERED_TENANTS)]
    del gt, gtp, flat64

    # -- 15. a wide regression fit: d = 40 through the wide insert -------------
    xw, yw, _ = datasets.make_regression(extra, WIDE_ROWS, WIDE_FEATURES,
                                         WIDE_NOISE)
    wide_dim = WIDE_FEATURES + 3  # [x, y] augmented
    wcfg = regression.StormRegressorConfig(
        rows=WIDE_HASH_ROWS,
        dfo=dfo.DFOConfig(steps=WIDE_STEPS, num_queries=WIDE_K,
                          sigma=WIDE_SIGMA, sigma_decay=0.995,
                          learning_rate=WIDE_LR, decay=0.995,
                          average_tail=0.5))
    wide_draws = dict(
        params=lsh.init_srp(extra, WIDE_HASH_ROWS, wcfg.planes, wide_dim,
                            device=dev),
        directions=dfo.sphere_directions(extra, WIDE_STEPS, 1, WIDE_K,
                                         WIDE_FEATURES + 1, dev),
        refine_samples=torch.randn(
            wcfg.refine_steps, 1, dfo.refine_sample_count(WIDE_FEATURES + 1),
            WIDE_FEATURES + 1, generator=extra, device=dev))

    def run_wide():
        torch.cuda.synchronize()
        start = time.perf_counter()
        fit = regression.fit(extra, xw, yw, wcfg, device=dev, **wide_draws)
        torch.cuda.synchronize()
        return fit, time.perf_counter() - start

    run_wide()  # warm-up
    for c in counters.values():
        c.launches = 0
    wide_kernel, wide_s = run_wide()
    wide_launches = {name: c.launches for name, c in counters.items()}
    with plain_versions():
        wide_plain, wide_plain_s = run_wide()
    var_w = float(yw.var(correction=0))
    mse_w = float(wide_kernel.mse(xw, yw))
    wide_expected = WIDE_STEPS + 2 * wcfg.refine_steps + 1
    _log(f"[wide] regression.fit n={WIDE_ROWS} d={WIDE_FEATURES} "
         f"R={WIDE_HASH_ROWS}: kernel {wide_s:.3f} s, plain versions "
         f"{wide_plain_s:.3f} s; train MSE {mse_w:.6f} (var(y) {var_w:.6f}, "
         f"R^2 {1 - mse_w / var_w:.6f}); launches {wide_launches}")
    if (wide_launches["paired_hash_histogram"] != 1
            or wide_launches["sketch_query"] != wide_expected
            or sum(wide_launches.values()) != 1 + wide_expected):
        raise AssertionError(f"the wide fit made {wide_launches}")
    if not torch.equal(wide_kernel.theta, wide_plain.theta):
        raise AssertionError("the wide kernel fit differs from the same fit "
                             "through the kernels' plain versions")
    if not (torch.isfinite(wide_kernel.theta).all()
            and wide_kernel.theta.shape == (WIDE_FEATURES,)):
        raise AssertionError(f"the wide fit gave {wide_kernel.theta}")
    # Where the wide fit's time goes: its one insert on the projection tile
    # and 403 queries through the queries' generic body (d = 43).
    _fit_profile("wide", run_wide, torch,
                 ("projection_tile_kernel", "sketch_query_kernel"))
    ww = ops.from_lsh_params(wide_draws["params"])
    wide_counts = wide_kernel.sketch.counts
    thw = torch.randn(2 * WIDE_K + 1, WIDE_FEATURES + 1,
                      generator=generator(SEED + 15, dev), device=dev)
    qw = lsh.augment_query(lsh.normalize_query(thw)).contiguous()
    got = query_kernel.sketch_query(qw, ww, wide_counts)
    want = ref.sketch_query(qw, ww, wide_counts)
    errs["sketch_query"] = max(errs["sketch_query"],
                               float((got - want).abs().max()))
    if not torch.equal(got, want):
        raise AssertionError(f"kernel 2's generic body at d = {wide_dim} "
                             f"differs from its plain version")
    _generic_query_report(
        torch, "kernel 2 (a DFO step of the wide fit)",
        lambda: query_kernel.sketch_query(qw, ww, wide_counts),
        lambda: ref.sketch_query(qw, ww, wide_counts), qw, ww, False,
        wide_counts.numel(), smi)
    del xw, yw

    # -- 16. privacy: the f32 queries, a release, the private gateways ---------
    from repro_torch.core import privacy as privacy_lib

    pgen = generator(SEED + 3, dev)  # a fourth stream: earlier draws stay

    def f32_tables(lead, rows_q, p_q):
        """Non-integer f32 tables of both signs, magnitudes 1e-2 to 1e10."""
        shape = lead + (rows_q, 1 << p_q)
        mag = 10.0 ** (torch.rand(shape, generator=pgen, device=dev) * 12 - 2)
        sign = torch.where(torch.rand(shape, generator=pgen, device=dev)
                           < 0.3, -1.0, 1.0)
        return (mag * sign).to(torch.float32)

    def f32_gap(got, want, scale):
        """max |got - want| / (2^-22 * mean|x|): at most 1 within the bound
        (``scale``: the plain query over |x|)."""
        if not got.numel():
            return 0.0
        gap = (got.double() - want.double()).abs() / (
            2.0 ** -22 * scale.double())
        gap = torch.where(got.double() == want.double(), 0.0, gap)
        return float(gap.max())

    worst = 0.0
    for rows_q, p_q, m, banked in itertools.product(
            (1, 33, 2048), (1, 4, 9), (0, 1, 17, 272, 512, 4096),
            (False, True)):
        wq = torch.randn(p_q, dim, rows_q, generator=pgen, device=dev)
        tq = f32_tables((3,), rows_q, p_q)
        q = torch.randn(m, dim, generator=pgen, device=dev)
        ci = torch.randint(-(1 << 20), 1 << 20, tq.shape, generator=pgen,
                           device=dev, dtype=torch.int32)
        if banked:
            idx = torch.randint(0, 3, (m,), generator=pgen, device=dev)
            kern = query_kernel.sketch_query_banked_f32
            call = lambda c: query_kernel.sketch_query_banked(q, wq, c, idx)
            plain = lambda c: ref.sketch_query_banked(q, wq, c, idx)
        else:
            kern = query_kernel.sketch_query_f32
            call = lambda c: query_kernel.sketch_query(q, wq, c[1])
            plain = lambda c: ref.sketch_query(q, wq, c[1])
        before = kern.launches
        got, again = call(tq), call(tq)
        gap = f32_gap(got, plain(tq), plain(tq.abs()))
        same_int = torch.equal(call(ci.float()), call(ci))
        torch.cuda.synchronize()
        if not (torch.equal(got, again) and gap <= 1.0 and same_int
                and kern.launches == before + 3 * (m > 0)):
            raise AssertionError(
                f"f32 query (banked={banked}) at R={rows_q} p={p_q} m={m}: "
                f"repeat equal {torch.equal(got, again)}, gap {gap}, "
                f"integer-valued equal {same_int}")
        worst = max(worst, gap)
    _log(f"[privacy] f32 queries, lone and banked, R in {{1, 33, 2048}}, p "
         f"in {{1, 4, 9}}, m in {{0, 1, 17, 272, 512, 4096}} on tables of "
         f"magnitudes 1e-2..1e10: two launches give the same bits; max "
         f"|kernel - plain| / (2^-22 mean|x|) = {worst:.4f} (bound 1); "
         f"integer-valued tables equal the integer body bit for bit")

    # The main path's shapes: the private gateway's lanes (16 tenants'
    # releases at eps = 1 over phase 7's bank) at its 512 slots, and one
    # lane at a lone fit's 17 points.
    f32_lanes = warm.counts.to(torch.float32) + privacy_lib.count_noise(
        pgen, warm.counts.shape, PRIV_EPS_RELEASE, cfg.rows, device=dev)
    m_gw = TENANTS * GW_QUERY_SLOTS
    q_gw = lsh.augment_query(lsh.normalize_query(torch.randn(
        m_gw, dim - 2, generator=pgen, device=dev))).contiguous()
    idx_gw = torch.repeat_interleave(torch.arange(
        TENANTS, dtype=torch.int32, device=dev), GW_QUERY_SLOTS)
    q_fit = q_gw[:2 * cfg.dfo.num_queries + 1].contiguous()
    for name, got, want, scale in (
        ("sketch_query_banked_f32",
         query_kernel.sketch_query_banked(q_gw, w, f32_lanes, idx_gw),
         ref.sketch_query_banked(q_gw, w, f32_lanes, idx_gw),
         ref.sketch_query_banked(q_gw, w, f32_lanes.abs(), idx_gw)),
        ("sketch_query_f32", query_kernel.sketch_query(q_fit, w, f32_lanes[0]),
         ref.sketch_query(q_fit, w, f32_lanes[0]),
         ref.sketch_query(q_fit, w, f32_lanes[0].abs())),
    ):
        gap = f32_gap(got, want, scale)
        err = float((got - want).abs().max())
        errs[name] = max(errs[name], err)
        _log(f"[privacy] {name} at m={got.numel()} on released tables: "
             f"max|err| {err:g} against the plain version ({gap:.4f} of "
             f"the bound 2^-22 mean|x|)")
        if gap > 1.0:
            raise AssertionError(f"{name} at the main path's shape")

    # A standalone release of phase 5's 2^22-row sketch at eps = 1, read at
    # the zero model (theta = 0, the label's -1) beside the exact query.
    big = fit_kernel.sketch
    release = privacy_lib.privatize_counts(pgen, big, 1.0)
    theta0 = torch.zeros(dim - 2, device=dev)
    theta0[-1] = -1.0
    codes0 = lsh.query_codes(params, theta0[None])
    exact0 = float(sketch_lib.query(big, codes0, paired=True)[0])
    private0 = float(privacy_lib.query_private(release, codes0)[0])
    before = query_kernel.sketch_query_f32.launches
    kernel0 = ops.query_theta_with_weights(release, w, theta0[None])
    scale0 = ref.sketch_query(lsh.augment_query(lsh.normalize_query(
        theta0[None])), w, release.counts.abs()) / sketch_lib.denominator(
        release.n, True)
    gap0 = f32_gap(kernel0, torch.tensor([private0], device=dev), scale0)
    errs["sketch_query_f32"] = max(errs["sketch_query_f32"], abs(
        float(kernel0[0]) - private0))
    _log(f"[privacy] release of the {N_ROWS}-row sketch at eps=1 (Laplace "
         f"scale {2 * cfg.rows}): query at theta=0: exact {exact0:.8f}, "
         f"query_private {private0:.8f}, f32 kernel {float(kernel0[0]):.8f}"
         f" ({query_kernel.sketch_query_f32.launches - before} launch; "
         f"gap {gap0:.4f} of the bound)")
    # Laplace(b) noise has variance 2 b^2; the mean over R cells, divided
    # by 2n, has standard deviation sqrt(2) b / sqrt(R) / (2n).
    sd0 = (2 ** 0.5 * 2 * cfg.rows / cfg.rows ** 0.5
           / (2 * max(int(big.n), 1)))
    _log(f"[privacy] |query_private - exact| = {abs(private0 - exact0):.3g}"
         f" ({abs(private0 - exact0) / sd0:.3f} standard deviations of the "
         f"noise)")
    if not (gap0 <= 1.0 and abs(private0 - exact0) <= 6 * sd0
            and query_kernel.sketch_query_f32.launches == before + 1):
        raise AssertionError("the standalone release's query")
    del release

    # The flat private gateway at phase 13's configuration, twice.
    p_script = privacy_script(storm_serve, gw_mod, SEED + 16, PRIV_ROUNDS,
                              TENANTS, gw_dim)
    gw_shape = (cfg.rows, 1 << cfg.planes)
    f32_names = ("sketch_query_f32", "sketch_query_banked_f32")

    def private_gateway(on_exhaust, mode="auto", total=PRIV_EPS_TOTAL):
        pol = privacy_lib.ReleasePolicy(epsilon_total=total,
                                        epsilon_release=PRIV_EPS_RELEASE,
                                        on_exhaust=on_exhaust)
        gwp = gw_mod.StormGateway(
            params, TENANTS, query_slots=GW_QUERY_SLOTS,
            ingest_slots=GW_INGEST_SLOTS, mode=mode, bank=warm, privacy=pol,
            privacy_seed=SEED + 16, device=dev)
        return gwp, pol

    tick_deltas = []

    @contextlib.contextmanager
    def counted_sync_free():
        """``tick_start`` under sync debug mode 'error', with the launches
        it makes."""
        before = {name: c.launches for name, c in counters.items()}
        with no_host_sync(torch):
            yield
        tick_deltas.append({name: c.launches - before[name]
                            for name, c in counters.items()})

    private_runs = {}
    for on_exhaust in ("refuse", "stale"):
        gwp, pol = private_gateway(on_exhaust)
        plog = PrivateLog(gwp)
        tick_deltas.clear()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        p_reports, p_lat, p_starts = drive(gwp, p_script, on_start=plog,
                                           guard=counted_sync_free)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        run_launches = {name: c.launches for name, c in counters.items()}
        if on_exhaust == "refuse":
            for name in f32_names:
                launches[name] = run_launches[name]
                if not run_launches[name]:
                    raise AssertionError(f"the private gateway never "
                                         f"launched {name}")
        view2, plans, fit_plans = replay_private(
            privacy_lib, pol, SEED + 16, plog, p_reports)
        # The ledger and the views: the same spends, releases and windows.
        if gwp.private_view.summary() != view2.summary():
            raise AssertionError(f"{on_exhaust}: the ledger differs from "
                                 f"the host replay")
        status_of = {"fresh": "ok", "stale": "stale", "refuse": "refused"}
        qreq = {r.rid: (k, r) for k, reqs in enumerate(p_script, start=1)
                for r in reqs if isinstance(r, gw_mod.QueryRequest)}
        results = {r.rid: r for rep in p_reports for r in rep.results}
        if results.keys() != qreq.keys():
            raise AssertionError(f"{on_exhaust}: not every query completed "
                                 f"once")
        want_status = {rep_r.rid: "refused" for rep in p_reports
                       for rep_r in rep.results
                       if plans[rep.tick].get(rep_r.tenant) is not None
                       and plans[rep.tick][rep_r.tenant].status == "refuse"}
        for tick, rid, _, t, _ in plog.placements:
            got = status_of[plans[tick][t].status]
            if want_status.get(rid, "ok") != "stale":
                want_status[rid] = got
        counts_by_status = {}
        for rid in qreq:
            want = want_status[rid]
            counts_by_status[want] = counts_by_status.get(want, 0) + 1
            if results[rid].status != want:
                raise AssertionError(f"{on_exhaust}: query {rid} is "
                                     f"{results[rid].status}, not {want}")
        # The releases: each tick's lanes against the replay's expected
        # release, and every served point against a standalone banked f32
        # query of that release.
        lane = torch.zeros((TENANTS,) + gw_shape, device=dev)
        expect = {}
        for tick in sorted(plog.snaps):
            counts_k = plog.snaps[tick][0]
            n_used = torch.zeros(TENANTS, dtype=torch.int32, device=dev)
            for slot, plan in plans[tick].items():
                n_used[slot] = plan.n
                if plan.status == "fresh":
                    lane[slot] = counts_k[slot].to(torch.float32) + \
                        torch.from_numpy(plan.noise).to(dev)
            got_lanes, got_n = plog.lanes[tick]
            read = [slot for slot, plan in plans[tick].items()
                    if plan.status != "refuse"]
            if read and not (torch.equal(got_lanes, lane)
                             and torch.equal(got_n[read], n_used[read])):
                raise AssertionError(f"{on_exhaust}: tick {tick}'s lanes "
                                     f"differ from the replay's releases")
            expect[tick] = (lane.clone(), n_used)
        served = 0
        for tick, rid, off, t, take in plog.placements:
            lanes_k, n_used = expect[tick]
            th = torch.from_numpy(qreq[rid][1].thetas[off:off + take]).to(dev)
            want = ops.query_theta_with_weights(
                sketch_lib.SketchBank(counts=lanes_k, n=n_used), w, th,
                sketch_idx=torch.full((take,), t, dtype=torch.int32,
                                      device=dev))
            if not (want.cpu().numpy()
                    == results[rid].losses[off:off + take]).all():
                raise AssertionError(f"{on_exhaust}: query {rid} (tick "
                                     f"{tick}) differs from the standalone "
                                     f"query of its release")
            served += take
        # The fits: status and sub-bank against the replay, then the
        # offline fit_many over that sub-bank.
        fits = {f.rid: f for rep in p_reports for f in rep.fits}
        if fit_plans.keys() != fits.keys():
            raise AssertionError(f"{on_exhaust}: fits {sorted(fits)} ran, "
                                 f"{sorted(fit_plans)} were gathered")
        for rid, member_plans in fit_plans.items():
            tick, req, sub, status = plog.fits[rid]
            statuses = [pl.status for pl in member_plans]
            want_status = ("refused" if "refuse" in statuses else
                           "stale" if "stale" in statuses else "ok")
            if not (status == fits[rid].status == want_status):
                raise AssertionError(f"{on_exhaust}: fit {rid} is "
                                     f"{fits[rid].status}, not {want_status}")
            if status == "refused":
                if fits[rid].theta.any():
                    raise AssertionError("a refused fit carries a theta")
                continue
            counts_k = plog.snaps[tick][0]
            lanes_k = plog.lanes[tick][0]
            want_sub = torch.stack([
                counts_k[t].to(torch.float32) + torch.from_numpy(
                    pl.noise).to(dev) if pl.status == "fresh" else lanes_k[t]
                for t, pl in zip(req.tenants, member_plans)])
            offline = erm.fit_many(
                req.surrogate, sub, params,
                dfo.DFOConfig(steps=req.steps, num_queries=req.num_queries,
                              sigma=req.sigma, learning_rate=req.learning_rate,
                              decay=req.decay),
                restarts=req.restarts, l2=req.l2,
                refine_steps=req.refine_steps,
                generator=generator(req.seed, dev), device=dev)
            if not (torch.equal(sub.counts, want_sub)
                    and sub.n.tolist() == [pl.n for pl in member_plans]
                    and np.array_equal(fits[rid].theta,
                                       offline.theta.cpu().numpy())
                    and np.array_equal(fits[rid].fleet_losses,
                                       offline.fleet_losses.cpu().numpy())):
                raise AssertionError(f"{on_exhaust}: fit {rid} differs from "
                                     f"the offline fit_many over its release")
        # One private tick with rows and points: one banked insert and one
        # banked f32 query, nothing else launched in tick_start.
        full_ticks = [d for d, rep in zip(tick_deltas, p_reports)
                      if rep.rows_ingested and rep.points_served]
        want_delta = dict.fromkeys(counters, 0)
        want_delta.update(paired_hash_histogram_banked=1,
                          sketch_query_banked_f32=1)
        if not full_ticks or any(d != want_delta for d in full_ticks):
            raise AssertionError(f"{on_exhaust}: a private tick launched "
                                 f"{full_ticks[:1]}")
        if gwp.trace_count > 4 or {sig[0] for sig in gwp._signatures} != {
                "ingest", "private"}:
            raise AssertionError(f"private bodies: {gwp._signatures}")
        priv = gwp.queue_stats()["privacy"]
        _log(f"[privacy] {on_exhaust}: {gwp.ticks} ticks in {run_s:.3f} s "
             f"(tick_start under sync debug mode 'error'), {served} points; "
             f"statuses {counts_by_status}; {priv['releases']} releases, "
             f"{len(priv['exhausted'])} tenants exhausted, "
             f"{priv['queries_refused']} queries and {priv['fits_refused']} "
             f"fits refused; ledger, statuses, lanes and "
             f"{len(fit_plans)} fits equal the host replay; served points "
             f"equal standalone banked f32 queries of their release; fits "
             f"equal the offline fit_many; one private tick: {want_delta}; "
             f"trace_count {gwp.trace_count}; launches {run_launches}")
        if on_exhaust == "refuse" and not (counts_by_status.get("refused")
                                           and priv["fits_refused"]):
            raise AssertionError("the refuse run refused nothing")
        if on_exhaust == "stale" and not counts_by_status.get("stale"):
            raise AssertionError("the stale run served nothing stale")
        private_runs[on_exhaust] = (p_reports, plog, gwp, p_lat, p_starts)

    # Pipelined at depth 2 and 3 against the synchronous loop (stale).
    s_reports, slog, sgw = private_runs["stale"][:3]
    s_keys = [report_key(r) for r in s_reports]
    for depth in (2, 3):
        gpp, _ = private_gateway("stale")
        reps, *_ = drive(gpp, p_script, depth=depth,
                         guard=lambda: no_host_sync(torch))
        if not ([report_key(r) for r in reps] == s_keys
                and torch.equal(gpp.bank.counts, sgw.bank.counts)
                and torch.equal(gpp._release, sgw._release)
                and gpp.private_view.summary() == sgw.private_view.summary()):
            raise AssertionError(f"private depth {depth} differs from sync")
        _log(f"[privacy] depth {depth}: {len(reps)} reports, counters, "
             f"lanes and ledger equal the sync loop")
    del gpp
    # The plain versions (mode="ref"): statuses and spends equal; estimates
    # within 2^-22 mean|x| / denom + 2^-23 |est| (both sum in float64, in
    # other orders).
    gref, _ = private_gateway("stale", mode="ref")
    r_reports, *_ = drive(gref, p_script)
    r_results = {r.rid: r for rep in r_reports for r in rep.results}
    s_results = {r.rid: r for rep in s_reports for r in rep.results}
    worst = 0.0
    for tick, rid, off, t, take in slog.placements:
        lanes_k, n_used = slog.lanes[tick]
        th = torch.from_numpy(qreq[rid][1].thetas[off:off + take]).to(dev)
        qa = lsh.augment_query(lsh.normalize_query(th))
        scale = ref.sketch_query(qa, w, lanes_k[t].abs()).double() / \
            sketch_lib.denominator(n_used[t], True).double()
        a = torch.from_numpy(s_results[rid].losses[off:off + take]).to(
            dev).double()
        b = torch.from_numpy(r_results[rid].losses[off:off + take]).to(
            dev).double()
        gap = torch.where(a == b, 0.0, (a - b).abs() / (
            2.0 ** -22 * scale + 2.0 ** -23 * a.abs()))
        worst = max(worst, float(gap.max()))
    if not ([(r.rid, r.status) for rep in r_reports for r in rep.results]
            == [(r.rid, r.status) for rep in s_reports for r in rep.results]
            and [(f.rid, f.status) for rep in r_reports for f in rep.fits]
            == [(f.rid, f.status) for rep in s_reports for f in rep.fits]
            and gref.private_view.summary() == sgw.private_view.summary()
            and torch.equal(gref.bank.counts, sgw.bank.counts)
            and worst <= 1.0):
        raise AssertionError(f"the private gateway through the plain "
                             f"versions differs (gap {worst})")
    _log(f"[privacy] mode='ref': statuses, spends and counters equal; "
         f"estimates within {worst:.4f} of the bound")
    del gref, r_reports

    # The tiered private gateway: phase 14's 64 tenants over 16 int16 slots
    # under Zipf(1.1), stale on exhaustion.
    def tiered_private():
        return tiered_mod.TieredStormGateway(
            params, TIERED_TENANTS, TIERED_HOT, query_slots=GW_QUERY_SLOTS,
            ingest_slots=GW_INGEST_SLOTS, count_dtype=torch.int16,
            promote_per_tick=TIERED_PROMOTE_PER_TICK,
            privacy=privacy_lib.ReleasePolicy(
                epsilon_total=PRIV_EPS_TOTAL,
                epsilon_release=PRIV_EPS_RELEASE, on_exhaust="stale"),
            privacy_seed=SEED + 17, device=dev)

    tz_script = zipf_script(gw_mod, SEED + 17, TIERED_ROUNDS, TIERED_TENANTS,
                            gw_dim)
    gtz = tiered_private()
    tz_reports, *_ = drive(gtz, tz_script, guard=lambda: no_host_sync(torch))
    gtzp = tiered_private()
    tzp_reports, *_ = drive(gtzp, tz_script, depth=2,
                            guard=lambda: no_host_sync(torch))
    queried = {r.tenant for reqs in tz_script for r in reqs
               if isinstance(r, gw_mod.QueryRequest) and len(r.thetas)}
    tz_priv = gtz.queue_stats()["privacy"]
    if not ([report_key(r) for r in tzp_reports]
            == [report_key(r) for r in tz_reports]
            and gtzp.private_view.summary() == gtz.private_view.summary()
            and set(gtz.private_view.ledger.keys()) == queried
            and gtz.trace_count <= 5 and gtzp.trace_count <= 5
            and gtz.promotions > 0):
        raise AssertionError(f"the tiered private gateway: keys "
                             f"{gtz.private_view.ledger.keys()[:8]}..., "
                             f"trace_count {gtz.trace_count}")
    tz_status = {}
    for rep in tz_reports:
        for r in rep.results:
            tz_status[r.status] = tz_status.get(r.status, 0) + 1
    _log(f"[privacy] tiered T={TIERED_TENANTS} H={TIERED_HOT} int16, stale: "
         f"{gtz.ticks} ticks, {gtz.promotions} promotions; ledger keys are "
         f"the {len(queried)} queried global tenants; statuses {tz_status}; "
         f"{tz_priv['releases']} releases; depth 2 equals sync; trace_count "
         f"{gtz.trace_count}")
    del gtz, gtzp, tz_reports, tzp_reports

    # Private ticks/s and host time in tick_start (fit-free, budget that
    # lasts: every query tick is a full private tick), then the device time
    # of a tick under the profiler.
    pt_script = privacy_script(storm_serve, gw_mod, SEED + 16, PRIV_ROUNDS,
                               TENANTS, gw_dim, fits=False)
    drive(private_gateway("refuse", total=1e9)[0], pt_script[:8])  # warm-up
    priv_times = {}
    for label, depth in (("sync", 1), ("pipelined", 2)):
        gtm, _ = private_gateway("refuse", total=1e9)
        torch.cuda.synchronize()
        start = time.perf_counter()
        reps, lat, starts = drive(gtm, pt_script, depth=depth)
        torch.cuda.synchronize()
        secs = time.perf_counter() - start
        ms = sorted(1e3 * x for x in starts)
        priv_times[label] = len(reps) / secs
        _log(f"[time] private gateway {label}: {len(reps)} ticks in "
             f"{secs:.4f} s: {len(reps) / secs:.1f} ticks/s, "
             f"{gtm.points_served / secs:.0f} points/s, "
             f"{gtm.rows_ingested / secs:.0f} rows/s; host time in "
             f"tick_start p50 {statistics.median(ms):.4f} ms, p99 "
             f"{statistics.quantiles(ms, n=100)[98]:.4f} ms; "
             f"{gtm.private_view.releases} releases; staging waits "
             f"{gtm.staging_waits}")
    _private_profile(torch, private_gateway("refuse", total=1e9)[0],
                     pt_script)
    del private_runs, plog, slog, sgw, expect

    # -- 17. the wire: a loopback server over a card gateway --------------------
    from repro_torch.serve import wire

    wgw = gw_mod.StormGateway(params, WIRE_TENANTS,
                              query_slots=GW_QUERY_SLOTS,
                              ingest_slots=GW_INGEST_SLOTS, device=dev)
    server = wire.StormWireServer(wgw, "127.0.0.1", 0).start()
    waddr = server.address
    wrng = np.random.default_rng(SEED + 18)
    try:
        client = wire.StormWireClient(*server.address)
        if client.budget() is not None:
            raise AssertionError("budget without a policy is not None")
        rows_of = [[] for _ in range(WIRE_TENANTS)]
        rid = itertools.count()
        checked = 0
        for chunk in range(WIRE_CHUNKS):
            for t in range(WIRE_TENANTS):
                zt = (wrng.normal(size=(GW_INGEST_RATE, gw_dim)) * (
                    0.4 / np.sqrt(gw_dim))).astype(np.float32)
                rows_of[t].append(zt)
                client.ingest(next(rid), t, zt)
                header, _ = client.recv()
                if header["type"] != "ingest_ok" or header["rows"] != len(zt):
                    raise AssertionError(f"wire ingest: {header}")
                th = wrng.normal(size=(WIRE_POINTS, gw_dim)).astype(
                    np.float32)
                got = client.query_sync(next(rid), t, th)
                zall = torch.from_numpy(np.concatenate(rows_of[t])).to(dev)
                lone = sketch_lib.Sketch(
                    counts=insert_kernel.paired_hash_histogram(
                        zall, w, torch.ones(zall.shape[0], device=dev)),
                    n=torch.tensor(zall.shape[0], dtype=torch.int32,
                                   device=dev))
                want = ops.query_theta_with_weights(
                    lone, w, torch.from_numpy(th).to(dev)).cpu().numpy()
                if not np.array_equal(got, want):
                    raise AssertionError(f"wire query of tenant {t} after "
                                         f"chunk {chunk} differs from the "
                                         f"standalone query")
                checked += 1
        theta_w, losses_w = client.fit_sync(next(rid), list(range(
            WIRE_TENANTS)), steps=GW_FIT_STEPS, seed=3)
        subs = [insert_kernel.paired_hash_histogram(
            torch.from_numpy(np.concatenate(z)).to(dev), w,
            torch.ones(sum(len(c) for c in z), device=dev)) for z in rows_of]
        offline = erm.fit_many(
            "prp_regression", sketch_lib.SketchBank(
                counts=torch.stack(subs),
                n=torch.tensor([sum(len(c) for c in z) for z in rows_of],
                               dtype=torch.int32, device=dev)),
            params, dfo.DFOConfig(steps=GW_FIT_STEPS, num_queries=8,
                                  sigma=0.5, learning_rate=1.0, decay=0.995),
            generator=generator(3, dev), device=dev)
        if not (np.array_equal(theta_w, offline.theta.cpu().numpy())
                and np.array_equal(losses_w,
                                   offline.fleet_losses.cpu().numpy())):
            raise AssertionError("the wire fit differs from the offline fit")
        wstats = client.stats()
        client.close()
    finally:
        server.stop()
    if not (wstats["rows_ingested"] == WIRE_TENANTS * WIRE_CHUNKS
            * GW_INGEST_RATE and wstats["fits_run"] == 1
            and wstats["trace_count"] <= 3):
        raise AssertionError(f"wire stats: {wstats}")
    _log(f"[wire] {waddr[0]}:{waddr[1]}: {checked} "
         f"queries after {WIRE_TENANTS} x {WIRE_CHUNKS} ingests of "
         f"{GW_INGEST_RATE} rows equal standalone queries of the lone "
         f"sketches; the cohort fit equals the offline fit_many; stats: "
         f"{wstats['ticks']} ticks, {wstats['rows_ingested']} rows, "
         f"trace_count {wstats['trace_count']}")
    # A private server: budget frames drain as the ledger does; a spent
    # tenant's query is a terminal budget_exceeded; a stale server flags.
    for on_exhaust in ("refuse", "stale"):
        pgw = gw_mod.StormGateway(
            params, WIRE_TENANTS, query_slots=GW_QUERY_SLOTS,
            ingest_slots=GW_INGEST_SLOTS, privacy=privacy_lib.ReleasePolicy(
                epsilon_total=2.0, epsilon_release=1.0,
                on_exhaust=on_exhaust), privacy_seed=SEED + 19, device=dev)
        server = wire.StormWireServer(pgw, "127.0.0.1", 0).start()
        try:
            client = wire.StormWireClient(*server.address)
            spent, first = [], None
            for chunk in range(3):
                client.ingest(next(rid), 1, (wrng.normal(
                    size=(GW_INGEST_RATE, gw_dim)) * (0.4 / np.sqrt(gw_dim))
                ).astype(np.float32))
                if client.recv()[0]["type"] != "ingest_ok":
                    raise AssertionError("private wire ingest")
                th = wrng.normal(size=(WIRE_POINTS, gw_dim)).astype(
                    np.float32)
                if chunk < 2:
                    out = client.query_sync(next(rid), 1, th)
                    first = out if first is None else first
                    spent.append(client.budget()["spent"]["1"])
                elif on_exhaust == "refuse":
                    try:
                        client.query_sync(next(rid), 1, th)
                    except wire.BudgetExceeded as exc:
                        if exc.header["retryable"] is not False:
                            raise AssertionError("budget_exceeded retryable")
                    else:
                        raise AssertionError("a spent tenant was served")
                else:
                    client.query(next(rid), 1, th)
                    header, out = client.recv()
                    if not (header["type"] == "result"
                            and header.get("stale") is True):
                        raise AssertionError(f"stale wire result: {header}")
            budget = client.budget()
            client.close()
        finally:
            server.stop()
        if not (spent == [1.0, 2.0] and budget["exhausted"] == [1]
                and budget["remaining"] == {"1": 0.0}):
            raise AssertionError(f"wire budget: {spent}, {budget}")
        _log(f"[wire] private ({on_exhaust}): budget frames {spent} then "
             f"{budget['spent']}, exhausted {budget['exhausted']}; the third "
             f"read " + ("raised BudgetExceeded (terminal)"
                         if on_exhaust == "refuse" else "came back stale"))
    del wgw, pgw

    # -- 18. distributed: the sharded sketch, the fleet fits, the mesh gateways
    # Every mesh is one card named 1 or 4 times: each shard's blocks, bodies
    # and launches are real, one after another on the card's stream.
    t18 = time.perf_counter()
    def meshes(axis):
        return {s: Mesh([dev] * s, axis) for s in MESH_SHARDS}

    mesh_launches = {name: 0 for name in counters}

    def counted(fn, path=True):
        """``fn()`` with every count set to 0 before and read after; a
        mesh path's counts add to the ``kernels`` line."""
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {name: c.launches for name, c in counters.items()}
        if path:
            for name, n in got.items():
                mesh_launches[name] += n
        return out, got

    def only(got, **want):
        """The launch counts are exactly ``want`` (all others 0)."""
        return all(got[name] == want.get(name, 0) for name in got)

    # The sharded sketch: phase 5's stream, then phase 9's rows.
    for shards, mesh in meshes("data").items():
        sk, got = counted(lambda: distributed.sharded_sketch(params, z, mesh))
        if not (torch.equal(sk.counts, fit_kernel.sketch.counts)
                and int(sk.n) == int(fit_kernel.sketch.n) == N_ROWS
                and sk.counts.device == mesh.first):
            raise AssertionError(f"the {shards}-shard sketch differs from "
                                 f"phase 5's lone build")
        if not only(got, paired_hash_histogram=shards):
            raise AssertionError(f"the {shards}-shard sketch made {got}")
        _log(f"[mesh] sharded_sketch over {shards} shard(s) of "
             f"{N_ROWS // shards} rows: equals phase 5's lone build (n = "
             f"{int(sk.n)}); launches {got['paired_hash_histogram']} of "
             f"kernel 1")
    merged = sk  # the 4-shard merge
    csk, got = counted(lambda: distributed.sharded_sketch(
        cparams, xa, meshes("data")[4], paired=False))
    if not (torch.equal(csk.counts, cls_kernel.sketch.counts)
            and int(csk.n) == int(cls_kernel.sketch.n)):
        raise AssertionError("the single-sided 4-shard sketch differs from "
                             "phase 9's lone build")
    if not only(got, hash_histogram=4):
        raise AssertionError(f"the single-sided sharded sketch made {got}")
    _log(f"[mesh] single-sided sharded_sketch (R={CLS_ROWS}, p={CLS_PLANES}) "
         f"over 4 shards: equals phase 9's lone build; launches "
         f"{got['hash_histogram']} of kernel 3")
    del csk

    # fleet_fit: 16 members over the merged sketch, default DFO config.
    per_shard = steps + 2 * cfg.refine_steps
    f_theta0, f_sig, f_lr = fleet.seed_fleet(
        MESH_MEMBERS, dim - 2, cfg.dfo, generator=generator(SEED + 18, dev),
        device=dev)

    def run_fleet_fit(mesh):
        torch.cuda.synchronize()
        start = time.perf_counter()
        res = distributed.fleet_fit(
            merged, params, f_theta0, cfg.dfo, mesh=mesh, sigma=f_sig,
            learning_rate=f_lr, refine_steps=cfg.refine_steps,
            generator=generator(SEED + 19, dev))
        torch.cuda.synchronize()
        return res, time.perf_counter() - start

    run_fleet_fit(None)  # warm-up
    (f_want, f_secs), got = counted(lambda: run_fleet_fit(None), path=False)
    if not only(got, sketch_query=per_shard):
        raise AssertionError(f"the meshless fleet fit made {got}")
    walls = {"meshless": f_secs}
    for shards, mesh in meshes("fleet").items():
        (res, secs), got = counted(lambda: run_fleet_fit(mesh))
        walls[shards] = secs
        if not (torch.equal(res.theta, f_want.theta)
                and torch.equal(res.losses, f_want.losses)):
            raise AssertionError(f"fleet_fit over {shards} shard(s) differs "
                                 f"from the meshless fit")
        if not only(got, sketch_query=shards * per_shard):
            raise AssertionError(f"fleet_fit over {shards} shard(s) made "
                                 f"{got}")
    if not torch.isfinite(f_want.theta).all():
        raise AssertionError(f"the fleet fit gave {f_want.theta}")
    # The fleet's final losses on the merged sketch: one query launch.
    rq, got = counted(lambda: distributed.replicated_query(
        merged, params, f_want.theta))
    if not (only(got, sketch_query=1) and torch.equal(rq, ops.query_theta(
            fit_kernel.sketch, params, f_want.theta))):
        raise AssertionError(f"replicated_query made {got} or differs from "
                             f"the lone sketch's query")
    _log(f"[mesh] fleet_fit ({MESH_MEMBERS} members, {steps} steps of k={k}, "
         f"{cfg.refine_steps} refine pass): 1 and 4 shards equal the "
         f"meshless fit bit for bit; kernel 2 launches 1 x {per_shard}, "
         f"4 x {per_shard}; wall {walls['meshless']:.4f} s meshless, "
         f"{walls[1]:.4f} s on 1 shard, {walls[4]:.4f} s on 4 (shards run "
         f"one after another in one thread); replicated_query of the 16 "
         f"final iterates (1 launch) equals the lone sketch's: min "
         f"{float(rq.min()):.6f}")

    # fleet_fit_banked over phase 7's bank: 16 tenants x 2 restarts.
    b_theta0, b_sig, b_lr = fleet.seed_fleet_many(
        TENANTS, MESH_RESTARTS, dim - 2, cfg.dfo,
        generator=generator(SEED + 20, dev), device=dev)

    def run_banked_fit(mesh):
        torch.cuda.synchronize()
        start = time.perf_counter()
        res = distributed.fleet_fit_banked(
            banks[True], params, b_theta0, cfg.dfo, MESH_RESTARTS, mesh=mesh,
            sigma=b_sig, learning_rate=b_lr, refine_steps=cfg.refine_steps,
            generator=generator(SEED + 21, dev))
        torch.cuda.synchronize()
        return res, time.perf_counter() - start

    run_banked_fit(None)  # warm-up
    (b_want, b_secs), got = counted(lambda: run_banked_fit(None), path=False)
    if not only(got, sketch_query_banked=per_shard):
        raise AssertionError(f"the meshless banked fit made {got}")
    walls = {"meshless": b_secs}
    for shards, mesh in meshes("bank").items():
        (res, secs), got = counted(lambda: run_banked_fit(mesh))
        walls[shards] = secs
        if not (torch.equal(res.theta, b_want.theta)
                and torch.equal(res.losses, b_want.losses)):
            raise AssertionError(f"fleet_fit_banked over {shards} shard(s) "
                                 f"differs from the meshless fit")
        if not only(got, sketch_query_banked=shards * per_shard):
            raise AssertionError(f"fleet_fit_banked over {shards} shard(s) "
                                 f"made {got}")
    _log(f"[mesh] fleet_fit_banked ({TENANTS} tenants x {MESH_RESTARTS} "
         f"restarts, {TENANTS // 4} tenants a shard on 4): 1 and 4 shards "
         f"equal the meshless fit bit for bit; kernel 6 launches "
         f"1 x {per_shard}, 4 x {per_shard}; wall {walls['meshless']:.4f} s "
         f"meshless, {walls[1]:.4f} s on 1 shard, {walls[4]:.4f} s on 4")
    del merged, f_want, b_want, res, rq

    # The mesh gateway on phase 13's script, against phase 13's run.
    def mesh_gateway(mesh):
        return gw_mod.StormGateway(
            params, TENANTS, query_slots=GW_QUERY_SLOTS,
            ingest_slots=GW_INGEST_SLOTS, bank=warm, mesh=mesh)

    ingest_ticks = sum(rep.rows_ingested > 0 for rep in sync_reports)
    query_ticks = sum(rep.points_served > 0 for rep in sync_reports)
    fit_queries = gw_launches["sketch_query_banked"] - query_ticks
    for shards, mesh in meshes("bank").items():
        gm = mesh_gateway(mesh)
        (reps, *_), got = counted(lambda: drive(gm, script, guard=guard))
        if not ([report_key(r) for r in reps] == sync_keys
                and torch.equal(gm.bank.counts, final)
                and torch.equal(gm.bank.n, final_n)):
            raise AssertionError(f"the {shards}-shard gateway differs from "
                                 f"phase 13's meshless run")
        if not only(got, paired_hash_histogram_banked=shards * ingest_ticks,
                    sketch_query_banked=shards * query_ticks + fit_queries):
            raise AssertionError(f"the {shards}-shard gateway made {got} "
                                 f"({ingest_ticks} ingest ticks, "
                                 f"{query_ticks} query ticks)")
        if gm.trace_count > 3:
            raise AssertionError(f"mesh tick bodies: {gm._signatures}")
        gp = mesh_gateway(mesh)
        reps2, *_ = drive(gp, script, depth=2, guard=guard)
        if not ([report_key(r) for r in reps2] == sync_keys
                and torch.equal(gp.bank.counts, final)):
            raise AssertionError(f"the {shards}-shard gateway at depth 2 "
                                 f"differs from the sync loop")
        _log(f"[mesh] gateway over {shards} shard(s) ({TENANTS // shards} "
             f"tenants each): {len(reps)} reports, {gm.fits_run} fits, "
             f"counters and n equal phase 13's meshless run, sync and depth "
             f"2 (tick_start under sync debug mode 'error'); launches "
             f"{got['paired_hash_histogram_banked']} of kernel 4 = {shards} x "
             f"{ingest_ticks}, {got['sketch_query_banked']} of kernel 6 = "
             f"{shards} x {query_ticks} + {fit_queries} in fits; trace_count "
             f"{gm.trace_count}")
    del gm, gp

    # The tiered gateway on phase 14's cell over 4 shards.
    gtm = tiered_mod.TieredStormGateway(
        params, TIERED_TENANTS, TIERED_HOT, query_slots=GW_QUERY_SLOTS,
        ingest_slots=GW_INGEST_SLOTS, count_dtype=torch.int16,
        promote_per_tick=TIERED_PROMOTE_PER_TICK, mesh=meshes("bank")[4])
    (reps, *_), got = counted(lambda: drive(gtm, z_script, guard=guard))
    tiered_ingest = sum(rep.rows_ingested > 0 for rep in t_reports)
    tiered_query = sum(rep.points_served > 0 for rep in t_reports)
    if [report_key(r) for r in reps] != [report_key(r) for r in t_reports]:
        raise AssertionError("the 4-shard tiered gateway differs from phase "
                             "14's meshless run")
    for t, want in enumerate(tiered_final):
        sk = gtm.sketch_of(t)
        if not (torch.equal(sk.counts, want.counts)
                and int(sk.n) == int(want.n)):
            raise AssertionError(f"4-shard tiered tenant {t} differs")
    if not only(got, paired_hash_histogram_banked=4 * tiered_ingest,
                sketch_query_banked=4 * tiered_query):
        raise AssertionError(f"the 4-shard tiered gateway made {got}")
    _log(f"[mesh] tiered gateway over 4 shards (T={TIERED_TENANTS}, "
         f"H={TIERED_HOT}, int16, Zipf {ZIPF_EXPONENT}): reports and final "
         f"sketches equal phase 14's meshless run; {gtm.promotions} "
         f"promotions, {gtm.tiers.swap_count} swaps; trace_count "
         f"{gtm.trace_count}")
    del gtm, tiered_final

    # The mesh gateway's speed beside the meshless one's, in turns, on
    # fit-free traffic.
    t_script = gateway_script(storm_serve, gw_mod, SEED + 13, GW_ROUNDS,
                              TENANTS, gw_dim, fits=False)
    drive(mesh_gateway(meshes("bank")[4]), t_script[:16])  # warm-up
    for depth in (1, 2):
        for shards in (0, 1, 4, 4, 1, 0):
            g = (flat_gateway(bank=warm) if not shards
                 else mesh_gateway(meshes("bank")[shards]))
            torch.cuda.synchronize()
            start = time.perf_counter()
            reps, lat, starts = drive(g, t_script, depth=depth)
            torch.cuda.synchronize()
            secs = time.perf_counter() - start
            name = f"{shards} shard(s)" if shards else "meshless"
            _log(f"[time] mesh gateway, {name}, depth {depth}: {len(reps)} "
                 f"ticks in {secs:.4f} s: {len(reps) / secs:.1f} ticks/s; "
                 f"tick latency {_pct(lat)}; host time in tick_start "
                 f"{_pct(starts)}")
    for shards in MESH_SHARDS:
        _gateway_profile(torch, mesh_gateway(meshes("bank")[shards]),
                         t_script, label=f"mesh gateway, {shards} shard(s)",
                         shards=shards)
    for name, n in mesh_launches.items():
        if name in launches:
            launches[name] += n
    _log(f"[mesh] launches on the mesh paths: {mesh_launches}; phase 18 "
         f"took {time.perf_counter() - t18:.1f} s")

    # -- 11. timings ------------------------------------------------------------
    # "ms" is device time per launch from torch.profiler (CUPTI); where the
    # profiler records no device activity it is the CUDA-event time per call,
    # which also counts the host's gaps between launches.
    p, d_aug, rows = w.shape
    m = 2 * k + 1  # one DFO step of a one-member fleet
    th = torch.randn(m, dim - 2, generator=gen, device=dev)
    q = lsh.augment_query(lsh.normalize_query(th)).contiguous()
    counts = fit_kernel.sketch.counts
    zb, mb = sketch_lib.stack_ragged(z_tenants)
    xb, mxb = sketch_lib.stack_ragged(x_tenants)
    n_valid = float(mb.sum())  # the masked rows need no projection
    pc, dc, rc = wc.shape
    mq = TENANTS * (2 * k + 1)  # one DFO step of the 16-tenant fleet
    thb = torch.randn(mq, dim - 2, generator=gen, device=dev)
    qb = lsh.augment_query(lsh.normalize_query(thb)).contiguous()
    bcounts = banks[True].counts
    cases = {
        "paired_hash_histogram": (
            lambda: insert_kernel.paired_hash_histogram(z, w, ones),
            lambda: ref.paired_hash_histogram(z, w, ones), 3, 1,
            "paired_hist_kernel",
            _bound(bytes_moved=4 * (z.numel() + ones.numel() + w.numel()
                                    + rows * (1 << p)),
                   flops=2.0 * N_ROWS * d_aug * rows * p)),
        "sketch_query": (
            lambda: query_kernel.sketch_query(q, w, counts),
            lambda: ref.sketch_query(q, w, counts), 200, 20,
            "sketch_query_kernel",
            # The gather reads at most m * R cells, and no cell more than once.
            _bound(bytes_moved=4 * (q.numel() + w.numel() + m
                                    + min(m * rows, counts.numel())),
                   flops=2.0 * m * d_aug * rows * p)),
        "hash_histogram": (
            lambda: insert_kernel.hash_histogram(xa, wc, ones),
            lambda: ref.hash_histogram(xa, wc, ones), 5, 1, "hist_kernel",
            _bound(bytes_moved=4 * (xa.numel() + ones.numel() + wc.numel()
                                    + rc * (1 << pc)),
                   flops=2.0 * N_ROWS * dc * rc * pc)),
        "paired_hash_histogram_banked": (
            lambda: insert_kernel.paired_hash_histogram_banked(zb, w, mb),
            lambda: ref.paired_hash_histogram_banked(zb, w, mb), 3, 1,
            "paired_hist_kernel",
            _bound(bytes_moved=4 * (zb.numel() + mb.numel() + w.numel()
                                    + TENANTS * rows * (1 << p)),
                   flops=2.0 * n_valid * d_aug * rows * p)),
        "hash_histogram_banked": (
            lambda: insert_kernel.hash_histogram_banked(xb, wc, mxb),
            lambda: ref.hash_histogram_banked(xb, wc, mxb), 5, 1,
            "hist_kernel",
            _bound(bytes_moved=4 * (xb.numel() + mxb.numel() + wc.numel()
                                    + TENANTS * rc * (1 << pc)),
                   flops=2.0 * float(mxb.sum()) * dc * rc * pc)),
        "sketch_query_banked": (
            lambda: query_kernel.sketch_query_banked(qb, w, bcounts,
                                                     member_major),
            lambda: ref.sketch_query_banked(qb, w, bcounts, member_major),
            200, 20, "sketch_query_kernel",
            # Each point reads at most R cells of its own table, no cell
            # more than once; the index is read once.
            _bound(bytes_moved=4 * (qb.numel() + w.numel() + 2 * mq
                                    + min(mq * rows, bcounts.numel())),
                   flops=2.0 * mq * d_aug * rows * p)),
        "sketch_query_f32": (
            lambda: query_kernel.sketch_query(q_fit, w, f32_lanes[0]),
            lambda: ref.sketch_query(q_fit, w, f32_lanes[0]), 200, 20,
            "sketch_query_kernel",
            # 4-byte table reads, as for int32 tables.
            _bound(bytes_moved=4 * (q_fit.numel() + w.numel() + m
                                    + min(m * rows, f32_lanes[0].numel())),
                   flops=2.0 * m * d_aug * rows * p)),
        "sketch_query_banked_f32": (
            lambda: query_kernel.sketch_query_banked(q_gw, w, f32_lanes,
                                                     idx_gw, True),
            lambda: ref.sketch_query_banked(q_gw, w, f32_lanes, idx_gw),
            200, 20, "sketch_query_kernel",
            _bound(bytes_moved=4 * (q_gw.numel() + w.numel() + 2 * m_gw
                                    + min(m_gw * rows, f32_lanes.numel())),
                   flops=2.0 * m_gw * d_aug * rows * p)),
        "srp_hash": (
            lambda: hash_kernel.srp_hash(xh, w),
            lambda: ref.srp_hash(xh, w), 20, 1, "srp_hash_reg_kernel",
            _bound(bytes_moved=4 * (xh.numel() + w.numel() + SRP_ROWS * rows),
                   flops=2.0 * SRP_ROWS * d_aug * rows * p)),
    }
    times = {}
    spread = ("paired_hash_histogram", "paired_hash_histogram_banked",
              "hash_histogram", "hash_histogram_banked")

    def spread_ms(name, kern, reps, symbol):
        """The inserts: three profiler runs, so that an outlier shows as
        spread; their median is the kernel's time. Every record is printed,
        so that a dropped one shows as well."""
        records = []
        runs = [_device_ms(kern, reps, torch, symbol, records)
                for _ in range(3)]
        if None in runs:
            return None
        dev_ms = statistics.median(runs)
        _log(f"[time] {name}: device ms per launch over {len(runs)} "
             f"profiler runs of {reps}: min {min(runs):.4f}, median "
             f"{dev_ms:.4f}, max {max(runs):.4f}; {len(records)} kernel "
             f"records (ms): "
             f"{', '.join(f'{us / 1e3:.3f}' for us in records)}")
        return dev_ms

    for name, (kern, plain, reps, plain_reps, symbol, bound) in cases.items():
        wall = _median_ms(kern, reps, torch)
        plain_wall = _median_ms(plain, plain_reps, torch)
        dev_ms = (spread_ms(name, kern, reps, symbol) if name in spread
                  else _device_ms(kern, reps, torch, symbol))
        plain_dev_ms = _device_ms(plain, plain_reps, torch)
        times[name] = (dev_ms if dev_ms is not None else wall,
                       plain_dev_ms if plain_dev_ms is not None else plain_wall,
                       bound)
        _log(f"[time] {name}: device {dev_ms} ms per launch, {wall:.4f} ms "
             f"per call by CUDA events; plain version: device "
             f"{plain_dev_ms} ms, {plain_wall:.4f} ms per call")

    # Kernel 3 at the kmeans shape (d = 11, p = 4, R = 1024) on its own line;
    # it stays out of the kernel list, which has one entry per kernel.
    xk = lsh.augment_data(zk).contiguous()
    wk = torch.randn(KMEANS_PLANES, D_FEATURES + 2, CLS_ROWS, generator=gen,
                     device=dev)

    def kmeans_insert():
        return insert_kernel.hash_histogram(xk, wk, ones)

    kmeans_wall = _median_ms(kmeans_insert, 5, torch)
    kmeans_ms = spread_ms("hash_histogram at the kmeans shape",
                          kmeans_insert, 5, "hist_kernel")
    kmeans_bound, kmeans_by = _bound(
        bytes_moved=4 * (xk.numel() + ones.numel() + wk.numel()
                         + CLS_ROWS * (1 << KMEANS_PLANES)),
        flops=2.0 * N_ROWS * xk.shape[1] * CLS_ROWS * KMEANS_PLANES)
    _log(f"[time] hash_histogram at the kmeans shape (n={N_ROWS} d="
         f"{xk.shape[1]} p={KMEANS_PLANES} R={CLS_ROWS}): device "
         f"{kmeans_ms} ms per launch, {kmeans_wall:.4f} ms per call by "
         f"CUDA events; bound {kmeans_bound:.4f} ms by "
         f"{kmeans_by}")

    # Both queries at m in {17, 272, 512, 4096} (one DFO step, a 16-tenant
    # fleet's step, the gateway's 512 slots, a large batch), each beside its
    # bound; the banked query reads the 16-tenant bank, slot-major at 272
    # and 512 as the fleet and the gateway send it.
    for m_t in (17, 272, 512, 4096):
        th_t = torch.randn(m_t, dim - 2, generator=extra, device=dev)
        q_t = lsh.augment_query(lsh.normalize_query(th_t)).contiguous()
        per = m_t // TENANTS
        idx_t = (torch.repeat_interleave(torch.arange(
            TENANTS, dtype=torch.int32, device=dev), per)
            if per * TENANTS == m_t else torch.randint(
                0, TENANTS, (m_t,), generator=extra, device=dev,
                dtype=torch.int32))
        for name, fn, table in (
            ("sketch_query", lambda q_t=q_t: query_kernel.sketch_query(
                q_t, w, counts), counts),
            ("sketch_query_banked",
             lambda q_t=q_t, idx_t=idx_t: query_kernel.sketch_query_banked(
                 q_t, w, bcounts, idx_t), bcounts),
            ("sketch_query_f32", lambda q_t=q_t: query_kernel.sketch_query(
                q_t, w, f32_lanes[0]), f32_lanes[0]),
            ("sketch_query_banked_f32",
             lambda q_t=q_t, idx_t=idx_t: query_kernel.sketch_query_banked(
                 q_t, w, f32_lanes, idx_t), f32_lanes),
        ):
            q_ms = _device_ms(fn, 200, torch, "sketch_query_kernel")
            q_bound, q_by = _bound(
                bytes_moved=4 * (q_t.numel() + w.numel() + m_t
                                 + (m_t if table.ndim == 3 else 0)
                                 + min(m_t * rows, table.numel())),
                flops=2.0 * m_t * d_aug * rows * p)
            _log(f"[time] {name} at m={m_t}: device {q_ms} ms per launch; "
                 f"bound {q_bound:.6f} ms by {q_by}")

    # Both inserts on the wide body and kernel 7 on its tiled path: d = 515
    # (paired: 517 columns of w), n = 2^16, R = 2048, p = 4, beside their
    # bounds, no-FMA floors and plain versions.
    wide_z = lsh.scale_to_unit_ball(torch.randn(
        WIDE_TIME_ROWS, WIDE_TIME_D, generator=extra, device=dev))[0]
    wide_x = lsh.augment_data(wide_z[:, :WIDE_TIME_D - 2]).contiguous()
    wide_ones = torch.ones(WIDE_TIME_ROWS, device=dev)
    wide_w = torch.randn(p, WIDE_TIME_D + 2, rows, generator=extra,
                         device=dev)
    wide_ws = wide_w[:, :WIDE_TIME_D].contiguous()
    for name, kern, plain, wi, xi, out_cells in (
        ("paired_hash_histogram", insert_kernel.paired_hash_histogram,
         ref.paired_hash_histogram, wide_w, wide_z, rows << p),
        ("hash_histogram", insert_kernel.hash_histogram, ref.hash_histogram,
         wide_ws, wide_x, rows << p),
        ("srp_hash", hash_kernel.srp_hash, ref.srp_hash, wide_ws, wide_z,
         WIDE_TIME_ROWS * rows),
    ):
        args = (xi, wi) if name == "srp_hash" else (xi, wi, wide_ones)

        def wide_call(kern=kern, args=args):
            return kern(*args)

        # The profiler drops records of these long kernels (a whole run's,
        # once), so the CUDA-event time of the call (allocation and launch
        # included) stands beside it.
        where = ("its tiled path" if name == "srp_hash" else
                 "the wide body")
        wide_event = _median_ms(wide_call, 3, torch)
        wide_ms = spread_ms(f"{name} on {where}", wide_call, 3,
                            "projection_tile_kernel")
        wide_plain_ms = _device_ms(lambda plain=plain, args=args: plain(
            *args), 1, torch)
        # As for the main path's kernels: every column of w (the paired
        # insert's zero column included) is a multiply-add.
        multiply_adds = float(WIDE_TIME_ROWS) * wi.shape[1] * rows * p
        wide_bound, wide_by = _bound(
            bytes_moved=4 * (xi.numel() + wi.numel() + out_cells
                             + (0 if name == "srp_hash" else WIDE_TIME_ROWS)),
            flops=2.0 * multiply_adds)
        _log(f"[time] {name} on {where} (n={WIDE_TIME_ROWS} "
             f"d={xi.shape[1]} p={p} R={rows}): device {wide_ms} ms per "
             f"launch, {wide_event:.4f} ms per call by CUDA events; plain "
             f"version {wide_plain_ms} ms; bound {wide_bound:.4f} ms by "
             f"{wide_by}; no-FMA floor {_floor_ms(multiply_adds, torch):.4f}"
             f" ms")
    del wide_z, wide_x, wide_w, wide_ws

    # Where each fit's time goes: device busy time under the profiler.
    _fit_profile("fit", lambda: run_fit("auto"), torch,
                 ("paired_hist_kernel", "sketch_query_kernel"))
    _fit_profile("cls", lambda: run_cls("auto"), torch,
                 ("hist_kernel", "sketch_query_kernel"))
    _fit_profile("many", lambda: run_many("auto"), torch,
                 ("paired_hist_kernel", "sketch_query_kernel"))

    # The gateway on fit-free traffic: throughput and tick latency (host
    # clock from a tick's start to its finish), synchronous and pipelined;
    # then the device's busy share over full ticks under the profiler.
    t_script = gateway_script(storm_serve, gw_mod, SEED + 13, GW_ROUNDS,
                              TENANTS, gw_dim, fits=False)
    drive(flat_gateway(bank=warm), t_script[:16])  # warm-up
    for label, depth in (("sync", 1), ("pipelined", 2)):
        gtm = flat_gateway(bank=warm)
        torch.cuda.synchronize()
        start = time.perf_counter()
        reps, lat, starts = drive(gtm, t_script, depth=depth)
        torch.cuda.synchronize()
        secs = time.perf_counter() - start

        _log(f"[time] gateway {label}: {len(reps)} ticks in {secs:.4f} s: "
             f"{len(reps) / secs:.1f} ticks/s, {gtm.points_served / secs:.0f}"
             f" points/s, {gtm.rows_ingested / secs:.0f} rows/s; tick "
             f"latency {_pct(lat)}; host time in tick_start {_pct(starts)}; "
             f"staging waits {gtm.staging_waits}")
    _gateway_profile(torch, flat_gateway(bank=warm), t_script)

    # -- 19. the LM: qwen2-7b served with taps into STORM probes -------------
    for name, n in lm_phase(torch, np, dev, smi, counters, errs).items():
        if name in launches:
            launches[name] += n

    # -- 20. training: gemma3-1b through the trainer, resumed and served ---
    train_phase(torch, np, dev, smi)

    # -- 21. the six non-dense LMs; zamba2 tapped into probes ---------------
    for name, n in nondense_phase(torch, np, dev, smi, counters,
                                  errs).items():
        if name in launches:
            launches[name] += n

    # -- 22. the LM's sharding: rules, sequence-parallel xlstm (its placed
    # train state, restore, pipeline and compression ran in phases 19-20,
    # where their models live) ---------------------------------------------
    shard_rules_phase(dev, smi)
    seqpar_phase(torch, np, dev, smi)

    # -- 23. tooling: the dry-run table on one card, the seven examples -----
    for name, n in tooling_phase(torch, dev, smi, counters).items():
        launches[name] += n

    kernels = []
    csrc = "src/repro_torch/kernels/csrc/"
    for name, src, replaces in (
        ("paired_hash_histogram", csrc + "paired_hash_histogram.cu",
         "src/repro/kernels/storm_sketch.py:219"),
        ("sketch_query", csrc + "sketch_query.cu",
         "src/repro/kernels/sketch_query.py:80"),
        ("hash_histogram", csrc + "hash_histogram.cu",
         "src/repro/kernels/storm_sketch.py:112"),
        ("paired_hash_histogram_banked", csrc + "paired_hash_histogram.cu",
         "src/repro/kernels/storm_sketch.py:450"),
        ("hash_histogram_banked", csrc + "hash_histogram.cu",
         "src/repro/kernels/storm_sketch.py:339"),
        ("sketch_query_banked", csrc + "sketch_query.cu",
         "src/repro/kernels/sketch_query.py:175"),
        ("srp_hash", csrc + "srp_hash.cu",
         "src/repro/kernels/srp_hash.py:53"),
        ("sketch_query_f32", csrc + "sketch_query.cu",
         "src/repro/kernels/sketch_query.py:80"),
        ("sketch_query_banked_f32", csrc + "sketch_query.cu",
         "src/repro/kernels/sketch_query.py:175"),
    ):
        ms, plain_ms, (bound_ms, bound_by) = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
        _log(f"[time] {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
             f"{bound_ms:.4f} ms by {bound_by}, {launches[name]} launches)")
    _log(json.dumps({"kernels": kernels}))
    _log(smi)
    _log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
