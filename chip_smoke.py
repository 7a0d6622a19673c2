#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels and drive its main paths on one GPU.

    python3 chip_smoke.py

Thirteen paths, each driven with the launch counts set to 0 just before it
and read just after:

* **TSQR** (the paper's workload): a tall-skinny matrix row-distributed over
  P = 8 ranks, factored by fault-tolerant TSQR whose local QR is CholeskyQR2
  on the hand-written kernels ``gram`` and ``fused_apply_gram``
  (``local_r="cqr2_pallas"``); ``apply_right`` forms the explicit Q of the
  kernel layer's ``ops.cholesky_qr2``.
* **Blocked QR** of a general matrix (``QRConfig(panel_width=128,
  use_pallas=True)``) at 8 × 2^17 × 512 and 8 × 2^17 × 480: the prime
  (``panel_cross``, or ``pad_cross`` when the pipeline pads the width) and
  one ``trailing_update`` sweep per later panel, with Q's polish Gram on
  ``gram``.
* **combine_gram**: the Gram-butterfly's combine G = R₁ᵀR₁ + R₂ᵀR₂ through
  its entry point ``ops.combine_gram(use_pallas=True)``, at 8 × n × n.
* **Replay**: the cached programs captured as CUDA graphs and replayed.
* **Coded TSQR** (``QRConfig(redundancy="coded", parity=3)``) at 8 × 2^19 ×
  128 and 8 × 2^17 × 32, fault-free and with deaths, stragglers, silent
  corruption (``observed=``) and an over-budget loss, on ``gram`` and
  ``fused_apply_gram``.
* **Coded blocked QR** (``parity=2``, ``use_pallas=True``) at 8 × 2^17 ×
  512: the eager driver's ``panel_cross``, ``trailing_update`` and polish
  ``gram``.
* **QR serving** (``repro_torch.serve.QRServer``): shape-bucketed
  continuous batching, each drain one replay of the batched blocked
  pipeline (``panel_cross`` or ``pad_cross``, ``trailing_update``, ``gram``)
  and each request of a faulted drain re-served through the eager driver.
* **Optimizers, checkpoints, data** at olmo-1b's widths: PowerSGD
  (``compress_mean_grad`` over 8 replicas of the 8192 x 2048 MLP gradient,
  ``compress_grad`` with error feedback), ``ft_cqr2_q``, an AdamW, a
  low-rank and an OrthoSGD step on one layer's weights, an async checkpoint
  round trip and a buddy store on the card, and ``SyntheticCorpus`` at
  vocab 50 304 and a 2048-token context.  This path runs no port kernel
  (the reference's runs no ``pallas_call``); its launch counts must stay 0.
* **Model serving** (``repro_torch.models``): qwen3-0.6b at its published
  config through ``launch/serve.py``'s ``--mode model --full`` path (batch
  4, prompt 512, 64 greedy steps), and olmo-1b, minitron-4b, gemma2-9b,
  qwen2-moe-a2.7b, mixtral-8x22b (4 of 56 layers), qwen2-vl-72b (8 of
  80), mamba2-2.7b, zamba2-7b and whisper-medium at full widths in bf16.
  The models' attention and Mamba2's SSD scan are plain tensor code (the
  reference's reach no ``pallas_call``); the launch counts stay 0.
* **Training** (``repro_torch.runtime``): olmo-1b at its published config
  and mamba2-2.7b at its published widths (its depth cut to fit the card)
  through ``launch/train.py``'s path, 4 replicas under BLANK with the
  gradient combine on ``ft_allreduce``; the three stock trainer fault
  scenarios (REBUILD from disk and from the buddy store, SHRINK then
  rejoin) and PowerSGD, OrthoSGD and the low-rank optimizer at its widths
  cut to 2 layers, and one whisper-medium step in bf16 on f32 frames.  The
  reference's trainer reaches no ``pallas_call``; the launch counts stay 0.
* **The bench harness** (``repro_torch.bench``): the full tier of all
  sixteen cases through its ``main``, one case a call with the launches
  read around each (``general_qr``, ``dispatch``, ``overlap`` and
  ``serving`` run the blocked QR on the kernels), the blocked QR's
  factorization latency at general_full through the ``dispatch`` case's
  ``run``, and the retrace guard.
* **The butterfly across processes** (``mesh=``, ``DistComm``): P = 8 rank
  processes on the one card, joined over gloo with each wire payload staged
  through pinned host memory, each factoring its own rows: ``ft_allreduce``
  and ``ft_allreduce_jit(mesh=)``, TSQR on ``gram`` and
  ``fused_apply_gram``, the Gram-butterfly TSQR, the blocked QR on
  ``panel_cross``, ``pad_cross``, ``trailing_update`` and ``gram``, and
  the kernel layer's explicit-Q CholeskyQR2 of each rank's block on
  ``apply_right``; every rank reads its own launch counts.
* **PowerSGD across processes** (``repro_torch.launch.powersgd_dp``, the
  counterpart of the reference's ``examples/powersgd_dp.py``): the same 8
  ranks as a 2 × 4 data × model mesh, the example trained at its widths
  for 80 steps with a model rank lost at step 40, and ``compress_grad`` at
  an olmo-1b MLP projection's gradient, over the axis collectives
  (``dist.psum``, ``pmean``, ``all_gather``) and ``ShardMapComm(4,
  "model")``.  Its local QR is ``torch.linalg`` (the reference's ``"jnp"``
  route) and ``form_q`` runs without ``use_pallas``: no port kernel; the
  launch counts stay 0.

Elsewhere all P ranks live on the one card with a leading (P,) axis, so
each sweep is one kernel launch for every rank.

Phases (each raises on failure; the script then exits non-zero):

1. build the kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a, one
   process per source, in parallel);
2. print the card's name and power limit;
3. hold each kernel against its plain PyTorch version on the card (f32 and
   bf16, ragged rows, a P = 8 batch, strided views, row strides and offsets
   that take each of the staging copy widths), check the bitwise
   contracts (fused ≡ gram(apply_right), want_q=False ≡ True, the
   lookahead S ≡ panel_cross of the stored A_new, pad_cross's real columns
   ≡ panel_cross, the same real columns under extra zero columns), that two
   runs give the same bits, and each f32 kernel against a float64 product;
   ``trailing_update`` over a batch against its per-slice calls (A_new bit
   for bit; S bit for bit where the row split is the same), at ROADMAP
   C.8's case and at general_full's first update;
4. drive TSQR ``factorize`` at 2^20 x 32 (all four variants, fault-free and
   with rank 5 dying at exchange 1; ``compute_q`` on the kernel route and,
   for the plain polish Gram, with ``local_r="cqr2"``), at 2^22 x 128
   (redundant, selfhealing), and the explicit-Q CholeskyQR2 of the kernel
   layer (timed end to end at 2^22 x 128); check validity against the
   plan, every survivor's R against a float64 Householder R of the same
   matrix, the orthogonality of Q, and one launch of each CholeskyQR2
   kernel per factorization;
5. drive the blocked ``factorize`` (redundant and selfhealing; the
   fixed-shape pipeline, the eager driver, the split schedule, panel-phase
   and update-phase deaths, ``recover="off"``, ``compute_q``); check
   validity against the plans, every survivor's R against a float64
   Householder R, ‖QᵀQ − I‖, pipeline ≡ eager ≡ split schedule bit for bit,
   and 1 prime + K − 1 trailing sweeps per factorization;
6. hold ``combine_gram`` against its plain version (f32 and bf16), against
   a float64 product, for exact symmetry and for the same bits on a rerun;
7. drive the cached programs (``repro_torch.replay``): the blocked
   pipeline at general_full and general_ragged, the batched TSQR at 4 × 8 ×
   2^17 × 32, ``ft_allreduce_jit`` and ``coded_allreduce_jit``, each cold
   (one CUDA-graph capture), warm (one replay, no capture) and eagerly
   issued; check the capture and dispatch counts, the replay's kernel
   launches, replay ≡ eager bit for bit, and time replay against eager;
   then drive coded TSQR and the coded blocked QR: fault-free R equal to
   the butterfly's bit for bit, the wire observed through
   ``InstrumentedComm`` equal to the plan, validity and ``detected`` as the
   plans and the reference give them, decoded R within
   ``reconstruction_tol``, the launch counts; then the stock collective
   and blocked fault scenarios on the card;
8. serve two request streams through ``QRServer``: the reference
   launcher's (P = 4, buckets 256 × 32 and 512 × 64, 24 requests) and one
   at the sizes users would call real (P = 8, buckets 2^16 × 64, 2^17 ×
   128 and 2^18 × 256, 48 requests, planned on fixed H100 constants,
   printed beside the copy bandwidth and f32 product rate measured in the
   run), each with a death every third drain; check zero new traces,
   evictions and recaptures over the warm stream, one pipeline dispatch a
   drain, the kernel launches, every R against numpy's and every
   re-served R against a fault-free eager re-run bit for bit; then for
   each bucket's first drain, the replay's R against the eagerly issued
   program's (bit for bit) and the plain route's, every kernel call of
   the drain on its own operands against its plain version and float64,
   and where nothing reads the prime's S, the graph's prime buffers
   poisoned before a replay and S checked after it; print the planner's
   decisions, throughput, latencies, drain times and the device's busy
   share;
8b. drive the optimizers, the checkpoint layer and the data pipeline at
   olmo-1b's widths: PowerSGD's ĝ (ft, ft with a death, dense) within 2e-4
   of each other and of a rank-8 mean, validity against the plans, the
   byte counts, error feedback reducing the residual; ``ft_cqr2_q``'s
   orthogonality and Q against float64; each optimizer step against the
   port's CPU run or its defining property; the checkpoint restored bit
   for bit; the data's batches equal to the host's; each step timed;
10. (run before 9) serve the model zoo: qwen3-0.6b through the
   launcher's path and the nine other architectures (prefill 4 × 512,
   decode 16 steps; mamba2, zamba2 and whisper at full depth), each timed
   cold and warm with its peak memory, ids in range and logits finite;
   then at full widths in float32, one unit each, prefill-then-decode
   against forward (3e-3 relative to max|logit|, 5e-3 over 8 more steps), a
   forward rerun bit for bit, the ring buffer decoded past its window,
   mamba2's chunked SSD against its step-by-step recurrence at a ragged 300
   tokens, whisper's logits moved by its frames, and qwen3-0.6b,
   qwen2-moe-a2.7b, mamba2-2.7b and whisper-medium against the port's CPU
   run (logits within 1e-4, MoE expert ids and slots equal); the SSM,
   hybrid and enc-dec parts each read 0 port-kernel launches;
11. (run before 9) train: olmo-1b at its published config (16 layers,
   bf16, remat) through the launcher's ``run`` with ``TRAIN_LAUNCH`` (4
   replicas x 2 x 2048 tokens, BLANK, replica 1 down for steps 2-3): losses
   finite, the ``ft_allreduce`` line, 1 failure, 1 recovery, 2 masked
   steps, one ``train_step`` trace and 6 dispatches, the warm step time,
   tokens/s and peak allocation (under 70 GB); mamba2-2.7b the same way at
   its published widths, its depth cut to ``MAMBA_TRAIN_LAYERS`` (logged),
   0 port-kernel launches; the three stock trainer
   scenarios at full widths cut to 2 layers, 2048-token rows (their fault
   stats, final width, last step, traces and dispatches 1/12, 1/9, 2/8),
   one warm step of that size profiled; PowerSGD, OrthoSGD and low-rank 2
   steps each under BLANK, losses finite; one layer in f32 trained 3 steps
   on the card and on the CPU from the same weights (losses within 1e-6
   relative, the parameters within 1e-3 of max|param|); one whisper-medium
   step in bf16 at its published widths, one encoder and one decoder layer,
   on the f32 frames the data pipeline builds (ROADMAP C.11), loss finite;
9. profile one call of each main path, time each kernel (CUDA events,
   median over repeats) beside its plain version, one PyTorch library call
   computing the same function where there is one, and its bound (``gram``
   also at the blocked QR's polish shape 8 × 2^17 × 128 and at n = 512),
   with the SM clock and power draw under the redesigned kernels and two
   library calls, and time ``factorize`` end to end (coded against the
   butterfly as well).
12. tune the kernels' row splits (``repro_torch.kernels.autotune``) at
   the main path's shapes, 8 × 2^19 × 128 (TSQR) and 8 × 2^17 × 512 (the
   blocked QR), persist the table under ``build/autotune/``, reload it and
   check every winner legal and re-picked from its persisted times, the
   ``ops`` wrappers' bytes and dispatches equal to the predicted and no
   warm trace; with the table installed, fused ≡ unfused, S ≡
   ``panel_cross(A_new)`` and pipeline ≡ eager bit for bit, R within 4e-6
   (TSQR) and 2e-6 (blocked) of float64, ``QRConfig(block_rows=...)``
   reaching the kernels' split and ``CostModel.tuned()`` taking the
   table's constants; after ``clear()``, R equal to the untuned run's bit
   for bit; then ``python -m repro_torch.bench run --tier smoke`` in
   process, every case ``ok``.  Each winner is printed beside the untuned
   split with both times.  Then the full tier of all sixteen cases, one
   ``--only`` call each through the same ``main``, every case ``ok``, a
   ``[bench]`` line a case with its status, metric count, time and the port
   kernels' launches read around it (``general_qr``, ``dispatch``,
   ``overlap`` and ``serving`` must launch ``trailing_update``,
   ``panel_cross`` or ``pad_cross``, and ``gram``); the ``dispatch``
   case's ``run`` at general_full (8 × 2^17 × 512, panels of 128, batch 2)
   held to the case's gates and to pipeline ≡ eager bit for bit, its
   ``time_pipeline_p50_us`` and ``time_eager_p50_us`` printed beside
   PERF.md §5's profile of one call; the retrace guard with 0 failures;
   the phase's time, and the whole script's.
13. (run after 2, while this process holds nothing on the card) the
   butterfly across processes: spawn 8 rank
   processes on the card (``repro_torch.collective.dist.run_ranks``, gloo,
   host staging) after the kernels are built, each drawing the same stacks from
   the same seeds and keeping its own rows: ``ft_allreduce`` for sum, mean,
   max and gram_sum over the four variants at 8 × 128 × 128, fault-free
   and with ranks 5 and 2 dying, every rank's value equal to SimComm's bit
   for bit and the fast path to the general executor;
   ``ft_allreduce_jit(mesh=)`` with no trace on a warm repeat; TSQR with
   ``local_r="cqr2_pallas"`` at 8 × 2^17 × 32 (four variants, rank 5 dead
   at exchange 1, ``compute_q``) and 8 × 2^19 × 128; the Gram butterfly at
   8 × 2^19 × 128; the blocked QR at 8 × 2^17 × 512 (pipeline,
   ``compute_q``, the general driver with a panel- and an update-phase
   death under ``replace``) and 8 × 2^17 × 480; each rank's R against
   SimComm's on the same stack (1e-5 of max|R|) and float64, validity
   against the plans and reports, ‖QᵀQ − I‖, each rank's launches per
   call and all six kernels launched from every rank; the wall time of
   each route beside SimComm's, the seconds staged through the host, the
   peak memory per rank, and the retrace guard inside the world with its
   ``ShardMapComm`` line; then drop the programs its SimComm comparisons
   cached (``replay.clear()``), so the later phases start cold as before.
13b. (in phase 13's world, after its cases) PowerSGD across processes:
   each of the 8 ranks runs the entry point's own rank body
   (``powersgd_dp.rank_main``: the 2 × 4 data × model mesh of
   ``launch/mesh.py::make_smoke_mesh``, and the example's training at
   DIN 64, DH 128, DOUT 32, rank 8, 80 steps, LR 0.3,
   ``selfhealing``, error feedback, model rank 1 lost at exchange 1 of
   step 40); print the example's lines through ``powersgd_dp.report`` and
   check its own rule (final loss under a quarter of the first), every
   rank valid at the fault step, the byte counts against 4·r·(m·M + n)
   and 4·m·M·n, ĝ and w1 the same bits on each data line and w2 and S̄ on
   all eight; ``compress_grad`` at ``tests/test_spmd.py:121``'s sizes
   within 2e-3 of the dense data-mean; ``compress_grad`` on each rank's
   rows of a 2048 × 8192 olmo-1b MLP gradient (model = 4, distinct per
   data replica) at ranks 8 and 32, timed beside SimComm(4) on the same
   block size, with the wire's exchange and host-staging milliseconds and
   the peak allocation per rank; no port kernel launched on any rank.

The inputs are drawn on the card from fixed seeds.  float32 products run in
full float32 (TF32 off).  The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

DEVICE = "cuda"
P = 8
MAIN_SHAPES = {"paper_fig": (P, (1 << 20) // P, 32), "powersgd_panel": (P, (1 << 22) // P, 128)}
HEADLINE = "powersgd_panel"
# The blocked QR: the reference's acceptance shape (general_qr "full",
# 4096 x 512 at panel width 128) with the rows scaled to the card; the
# ragged width makes the pipeline's prime pad_cross.
BLOCKED_SHAPES = {"general_full": (P, 1 << 17, 512), "general_ragged": (P, 1 << 17, 480)}
PANEL = 128
BLOCKED_VARIANTS = ("redundant", "selfhealing")
VARIANTS = ("tree", "redundant", "replace", "selfhealing")
# tests/test_kernels.py's tolerances; for the kernels held against their
# plain versions they bound max|got - want| / max|want| (sums of up to 2^19
# terms run in another order than cuBLAS's).
TOL = {"float32": 5e-4, "bfloat16": 3e-2}
R_TOL = 5e-4     # survivors' R vs float64 truth, relative to max|R| (tests/test_tsqr.py)
# The suite's R_TOL sits three decades above what full-f32 kernels give
# (1.4e-7 to 3.4e-7 on an H100), and CholeskyQR2's second pass repairs a
# coarse first Gram, so R_TOL alone would pass a reduced-precision (TF32)
# sweep.  Two tighter limits, about ten times the sound readings, catch it:
# on the main path's R, and on each f32 kernel against a float64 product.
R_TIGHT = 4e-6
F64_TOL = 1e-5
ORTHO_TOL = 2e-5
# The blocked QR's limits: the reference's blocked test bounds ‖QᵀQ − I‖ by
# 5e-5; the R limit beside R_TOL is about ten times the sound readings
# (1.5e-7 to 2.2e-7 on an H100).
R_TIGHT_BLOCKED = 2e-6
ORTHO_BLOCKED = 5e-5
# H100 SXM data-sheet peaks: HBM3 bytes/s and
# f32 FLOP/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
REPLACES = {
    "gram": "src/repro/kernels/gram.py:107",
    "fused_apply_gram": "src/repro/kernels/fused_apply_gram.py:116",
    "apply_right": "src/repro/kernels/apply_right.py:62",
    "trailing_update": "src/repro/kernels/trailing_update.py:129",
    "panel_cross": "src/repro/kernels/trailing_update.py:177",
    "pad_cross": "src/repro/kernels/trailing_update.py:241",
    "combine_gram": "src/repro/kernels/combine_gram.py:48",
}
# The path whose run gives each kernel's ``launches``: factorize (the TSQR
# main path) runs CholeskyQR2 R-only; Q's sweep 3 is only in the kernel
# layer's explicit-Q ``ops.cholesky_qr2``; the blocked QR runs the trailing
# sweeps.  Each path's counts start at 0.
KERNEL_PATH = {"gram": "factorize", "fused_apply_gram": "factorize",
               "apply_right": "cholesky_qr2", "trailing_update": "blocked",
               "panel_cross": "blocked", "pad_cross": "blocked",
               "combine_gram": "combine_gram"}
# The shape each kernel's time and error in the ``kernels`` line are taken at.
KERNEL_SHAPE = {"gram": HEADLINE, "fused_apply_gram": HEADLINE, "apply_right": HEADLINE,
                "trailing_update": "general_full", "panel_cross": "general_full",
                "pad_cross": "general_ragged", "combine_gram": "8x512"}
# Empty spin kernels that profile() launches in each window before the
# call: once a process has profiled for a while, the profiler drops the
# first few device records of each window (eager launches and graph
# replays alike), so these take the loss.
PROFILE_SPIN = 64
# The port's kernel functions as the profiler names them, labelled by the
# wrapper that launches them (panel_cross's sweep also runs inside
# trailing_update, for its lookahead).
PROFILE_NAMES = {"gram_partial_kernel": "gram", "fused_kernel": "fused_apply_gram",
                 "fused_partial_kernel": "fused_apply_gram", "apply_kernel": "apply_right",
                 "update_kernel": "trailing_update", "cross_partial_kernel": "panel_cross sweep",
                 "pad_cross_kernel": "pad_cross", "combine_gram_kernel": "combine_gram",
                 "fold_partials": "Gram fold", "fold_rect": "cross fold"}
# Each kernel's f32 main-path instantiation, as its mangled name spells it
# (float, the tile its main-path width takes, 16-byte copies where the
# kernel stages with cp.async), whose ptxas -v report the build phase
# prints; tests/test_torch_kernel_names.py holds these names and
# PROFILE_NAMES to the sources.
MAIN_ENTRY = {"gram": "19gram_partial_kernelIfLi128ELi4E", "fused_apply_gram":
              "12fused_kernelIfLi128ELi4E", "apply_right": "12apply_kernelIfLi128ELi4E",
              "trailing_update": "13update_kernelIfLi128ELi4E",
              "panel_cross": "20cross_partial_kernelIfLi128ELi4E",
              "pad_cross": "16pad_cross_kernelIfLi128ELi4E",
              "combine_gram": "19combine_gram_kernelIfLi64ELi4E"}
# combine_gram's widths (8 matrices each; n <= 512 in every TSQR use) and the
# coded scheme's parity counts.
COMBINE_WIDTHS = (32, 128, 512)
# phase 12: the tuned shapes (TSQR's and the blocked QR's) and where the
# table and the smoke-tier bench document go (both under build/, ignored)
AUTOTUNE_SHAPES = {HEADLINE: MAIN_SHAPES[HEADLINE], "general_full": BLOCKED_SHAPES["general_full"]}
AUTOTUNE_DIR = Path("build") / "autotune"
AUTOTUNE_REPS = 5
BENCH_OUT = Path("build") / "bench_torch" / "smoke.json"
BENCH_FULL_DIR = Path("build") / "bench_torch" / "full"
# the cases whose blocked QR runs on the kernels (use_pallas=True): each must
# launch trailing_update, panel_cross or pad_cross, and gram (each panel's
# Q polish)
BENCH_BLOCKED = ("general_qr", "dispatch", "overlap", "serving")
# the factorization latency at general_full through the dispatch case's run
# (batch 2: the batched input stays at 4 GiB); PERF.md §5's profile of one
# call read 103.4 ms (pipeline) and 95.9 ms (eager)
LATENCY_RUN = dict(p=P, m_local=1 << 17, n=512, panel_width=PANEL, batch=2)
LATENCY_PROFILED_MS = {"pipeline": 103.4, "eager": 95.9}
TUNED_SPLIT = 2048     # an explicit QRConfig(block_rows=...) the blocked QR must reach
# the replay phase's shapes beside general_full and general_ragged: the
# batched TSQR of B = 4 and B = 1 paper_fig-sized stacks (paper_fig's call
# is host-bound), and general_full with its rows cut 32-fold
REPLAY_TSQR = {"4 x paper_fig": (4, P, 1 << 17, 32), "paper_fig": (1, P, 1 << 17, 32)}
REPLAY_BLOCKED = {"general_full": BLOCKED_SHAPES["general_full"],
                  "general_ragged": BLOCKED_SHAPES["general_ragged"],
                  "general_full / 32": (P, 1 << 12, 512)}
CODED_PARITY = 3
BLOCKED_PARITY = 2
# The serving streams: the reference launcher's (src/repro/launch/serve.py)
# and one at the data sizes a user would serve from an H100, padded payload
# 2^28 bytes a drain.  The card stream is planned on fixed constants, the
# copy bandwidth and f32 product rate that machine_constants() read on an
# H100 80GB HBM3 at 700 W, so every run drives the same drains: at the rates
# a run measures, the 2^18 x 256 bucket's width-32 and width-64 scores lie
# within 1% and the plan would flip between runs.  Each request of either
# stream is held to numpy's R by the serving bench's measure
# (src/repro/bench/cases/serving.py) and limit; each bucket's first drain is
# held to the plain route's R at about ten times the f32 gap that drains
# show (a TF32 sweep would pass SERVING_R_TOL).
CARD_MODEL = dict(mem_bw_bytes_per_s=2.9712e12, flops_per_s=5.1820e13)
SERVING_STREAMS = {
    "reference": dict(p=4, buckets=((256, 32), (512, 64)), requests=24,
                      model=dict(max_batch_cap=6)),
    "card": dict(p=P, buckets=((1 << 16, 64), (1 << 17, 128), (1 << 18, 256)), requests=48,
                 model=CARD_MODEL),
}
SERVING_FAULT_PERIOD = 3
SERVING_R_TOL = 5e-4
SERVING_PLAIN_TOL = 1e-5
# The optimizer, checkpoint and data phase at olmo-1b's widths, read from the
# port's registry (repro_torch.configs.get_config("olmo-1b"): d_model 2048,
# d_ff 8192, vocab 50 304) and a 2048-token context: PowerSGD over R = 8
# replica gradients of the MLP's d_ff x d_model weight at rank 8 (512 MiB in
# f32); the optimizer steps on one layer's seven weights (4 x 2048^2
# attention, 2 x 2048 x 8192 gate/up, 8192 x 2048 down); a global batch of 64
# sequences in 8 data shards.
OLMO_ARCH = "olmo-1b"
OLMO_SEQ_LEN = 2048
# Phase 10, model serving (repro_torch.models): qwen3-0.6b at its published
# config through launch/serve.py's --mode model path; the nine other
# architectures at full widths in bf16, at full depth where the bf16 weights
# fit in 40 GB and cut where they do not (the cut is logged), each
# prefilling 4 x 512 tokens and decoding 16 greedy steps (whisper encodes
# its 1500 frames first).  The SSM, hybrid and enc-dec families
# (FAMILY_ARCHS) fit at full depth: mamba2-2.7b 64 layers, zamba2-7b 81
# (13 units of 6 and a tail of 3), whisper-medium 24 + 24.
MODEL_LAUNCH = ["--arch", "qwen3-0.6b", "--full", "--batch", "4", "--prompt-len", "512",
                "--gen", "64"]
MODEL_ZOO = {"olmo-1b": None, "minitron-4b": None, "gemma2-9b": None,
             "qwen2-moe-a2.7b": None, "mixtral-8x22b": 4, "qwen2-vl-72b": 8,
             "mamba2-2.7b": None, "zamba2-7b": None, "whisper-medium": None}
FAMILY_ARCHS = ("mamba2-2.7b", "zamba2-7b", "whisper-medium")
MODEL_BATCH, MODEL_PROMPT, MODEL_GEN = 4, 512, 16
# Correctness at full widths in float32, one unit of each architecture (two
# layers for gemma2, one Mamba layer for mamba2, one unit of 6 Mamba layers
# and the shared block for zamba2, one encoder and one decoder layer for
# whisper): prefill(t[:s-1]) then decode_step(t[s-1]) against forward(t) at
# s = 64, then 8 more decode steps, within the reference's own tolerances
# (tests/test_serving.py: 3e-3, and 5e-3 over several steps), here relative
# to max|logit|; the ring buffer at mixtral's widths with a 64-slot window,
# prefilled past it (80 tokens) and decoded to 104; mamba2's chunked SSD
# against its step-by-step recurrence over a ragged 300 tokens (chunks of
# 150 at chunk 256): a prefill of the conv window's 3 tokens, then a decode
# step for each later token, each step's logits against forward's and the
# final recurrent state against the chunked prefill's of all 300.
MODEL_CHECK_S, MODEL_CHECK_STEPS = 64, 8
SERVE_TOL, MULTI_TOL = 3e-3, 5e-3
RING_WINDOW, RING_PREFILL, RING_END = 64, 80, 104
SSM_RAGGED = 300
# The card against the port's CPU run on the same weights and tokens, both in
# float32 with TF32 off: the two differ only in summation order, ~1e-6 of
# max|logit| through one unit; a TF32 product (10-bit mantissa, ~5e-4 per
# product) or a bf16 one lands past this bound.
CARD_CPU_ARCHS = ("qwen3-0.6b", "qwen2-moe-a2.7b", "mamba2-2.7b", "whisper-medium")
CARD_CPU_TOL = 1e-4
# Phase 11, training (repro_torch.runtime.trainer): olmo-1b at its published
# config (16 layers, d_model 2048, d_ff 8192, vocab 50 304, bf16, remat)
# through launch/train.py's path, 4 replicas simulated on the card, 2
# sequences of 2048 tokens each, BLANK with replica 1 failed over steps 2-3
# (the gradient combine on ft_allreduce over the 4 replicas).  The step's
# peak allocation must stay under TRAIN_PEAK_LIMIT: the peak is in the fast
# butterfly, which holds its input, the running sum, the received operand,
# both ordered operands and the new sum of the 4 stacked bf16 gradient
# trees (9.4 GB each at 16 layers) beside the weights and f32 moments.
TRAIN_LAUNCH = ["--arch", "olmo-1b", "--full", "--mesh", "4x1", "--seq-len", "2048",
                "--global-batch", "8", "--on-failure", "blank", "--fail", "2:1",
                "--recover", "4:1", "--steps", "6"]
TRAIN_PEAK_LIMIT = 70e9
# mamba2-2.7b the same way (its published widths: d_model 2560, 80 heads of
# 64, state 128, chunk 256, vocab 50 280 untied, bf16, remat), its depth cut
# from 64 layers to MAMBA_TRAIN_LAYERS so the step's peak stays under
# TRAIN_PEAK_LIMIT: ~40.2 M parameters a layer and 257 M in the two
# embeddings; the peak read 33.60, 61.63 and 70.93 GB at 8, 20 and 24
# layers on an H100 (2.33 GB a layer: the butterfly's six copies of 4
# stacked bf16 gradient trees, the weights, the f32 moments), so 23 layers
# peak near 68.6 GB, the deepest under the limit.  The cut is logged.
MAMBA_TRAIN = ["--arch", "mamba2-2.7b", "--full", "--mesh", "4x1", "--seq-len", "2048",
               "--global-batch", "8", "--on-failure", "blank", "--fail", "2:1",
               "--recover", "4:1", "--steps", "6"]
MAMBA_TRAIN_LAYERS = 23
# whisper-medium in bf16 on the f32 frames SyntheticCorpus builds (ROADMAP
# C.11): one step through the launcher at its published widths (d_model
# 1024, 16 heads of 64, d_ff 4096, 1500 frames, vocab 51 865), its depth cut
# to WHISPER_TRAIN_LAYERS encoder and decoder layers, one replica.  The
# corpus draws a row's frames from its first enc_frames token positions, so
# the rows are 1500 tokens long.
WHISPER_TRAIN = ["--arch", "whisper-medium", "--full", "--seq-len", "1500",
                 "--global-batch", "2", "--steps", "1", "--ckpt-every", "0"]
WHISPER_TRAIN_LAYERS = 1
# The stock trainer scenarios, the other optimizers and the step profile at
# olmo-1b's widths cut to 2 layers (2.37 GB of bf16 weights and f32 moments
# a disk checkpoint), 2048-token rows; the expected train_step counts.
TRAIN_CUT_LAYERS = 2
TRAIN_SEQ_LEN = 2048
TRAIN_COUNTS = {"fail_during_rebuild": (1, 12), "buddy_pair_wipe": (1, 9),
                "shrink_then_rebuild": (2, 8)}
# The card against the port's CPU run: one olmo-1b layer at full widths in
# float32 (TF32 off), 4 replicas, 8 rows of 64 tokens, AdamW, 3 steps under
# BLANK with replica 1 failed at step 1, from the same weights.  Limits: the
# losses relative (ten times the 9.0e-8 read on an H100); the parameters'
# largest difference relative to max|param|, about four times the 2.3e-4
# read on an H100 (2.7e-5 absolute, 0.09·lr).  That reading is past the
# reference's optimizer tolerance (2e-4, tests/test_optim.py): AdamW steps
# each weight by lr·m̂/(√v̂ + eps), a ratio of order 1 whatever the
# gradient's size, so a gradient the two summation orders round apart moves
# its weight apart by that part of lr.  The elements furthest apart are not
# near eps (1e-8): √v̂ there reads 1.3e-7 to 2.4e-4, and the last step's
# ratio agrees there within 0.03, so they parted in the earlier steps.
TRAIN_CPU_SEQ = 64
TRAIN_CPU_LOSS_TOL = 1e-6
TRAIN_CPU_PARAM_TOL = 1e-3
OPTIM_REPLICAS = 8
PSGD_RANK = 8
DATA_BATCH = 64
# The reference's own PowerSGD / CholeskyQR2 tolerance (tests/test_optim.py:
# rtol = atol = 2e-4), here relative to max|want|: the ft and dense routes,
# a death, the rank-8 mean, the card against the port's CPU run.
PSGD_TOL = 2e-4
# CholeskyQR2 of a square Gaussian momentum (condition 1e3-1e4) left
# ||Q^T Q - I|| at 5e-6 and 2.2e-5 at 2048^2 on the CPU; the tall ones 1.5e-6.
ORTHO_SGD_TOL = 1e-3
# An update read back as new_p - p in float64 carries the float32 rounding
# of new_p (half an ulp of a 0.02-sized weight, ~4e-5 of a 3e-4-sized step).
STEP_TOL = 1e-3


# Phase 13: the butterfly across processes.  P ranks, one process each, all
# on the one card, joined over gloo with each wire payload staged through
# pinned host memory (repro_torch.collective.dist).
MESH_RANKS = P
MESH_ALLREDUCE = (P, 128, 128)
MESH_OPS = ("sum", "mean", "max", "gram_sum")
MESH_DEATHS = {5: 1, 2: 2}
MESH_TSQR = {"paper_fig": MAIN_SHAPES["paper_fig"], HEADLINE: MAIN_SHAPES[HEADLINE]}
MESH_TSQR_RUNS = ([("paper_fig", v, f, False) for v in VARIANTS for f in (None, {5: 1})]
                  + [("paper_fig", "redundant", None, True)]
                  + [(HEADLINE, v, f, False) for v in ("redundant", "selfhealing")
                     for f in (None, {5: 1})])
MESH_SCHEDULE = dict(panel={1: {2: 1}}, update={2: {5: 1}})
# (label, shape name, config fields, fault schedule)
MESH_BLOCKED_RUNS = (
    ("pipeline", "general_full", {}, None),
    ("pipeline compute_q", "general_full", {"compute_q": True}, None),
    ("general driver replace", "general_full", {"variant": "replace"}, MESH_SCHEDULE),
    ("pipeline ragged", "general_ragged", {}, None),
)
MESH_SEEDS = {"allreduce": 13000, "paper_fig": 13001, HEADLINE: 13002, "general_full": 13003,
              "general_ragged": 13004}
MESH_SIM_TOL = 1e-5     # a rank's R against SimComm's on the same stack, of max|R|
MESH_REPEATS = 3        # host-clock samples per route (median)
MESH_TIMEOUT = 600
MESH_KERNELS = ("gram", "fused_apply_gram", "apply_right", "trailing_update", "panel_cross",
                "pad_cross")

# Phase 13b: PowerSGD across processes, the same 8 ranks viewed as a 2 x 4
# data x model mesh (repro_torch.launch.powersgd_dp, the counterpart of
# examples/powersgd_dp.py).
PSGD_MESH_SPMD = (2, 4, 8, 12, 3)     # D, M, m_loc, n, r of tests/test_spmd.py:121
PSGD_MESH_SPMD_TOL = 2e-3             # that test's rtol = atol
PSGD_MESH_RANKS = (8, 32)             # compress_grad's rank at olmo-1b's MLP projection
PSGD_MESH_SEEDS = {"spmd": 13100, "olmo": 13101, "basis": 13102}


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*args) -> None:
    print(*args, flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {src}/repro_torch not found; run from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_script = time.perf_counter()
    smoke = Smoke(torch)
    smoke.build()
    card = smoke.card()
    smoke.mesh_path()
    smoke.psgd_mesh_path()
    smoke.kernel_checks()
    smoke.blocked_kernel_checks()
    smoke.combine_gram_path()
    smoke.replay_path()
    smoke.main_path()
    smoke.blocked_path()
    smoke.coded_tsqr_path()
    smoke.coded_blocked_path()
    smoke.scenarios()
    smoke.serving_path()
    smoke.optim_path()
    smoke.model_path()
    smoke.train_path()
    smoke.timings()
    smoke.blocked_timings()
    smoke.combine_gram_timing()
    smoke.autotune_path()
    log(f"[smoke] the whole script took {time.perf_counter() - t_script:.1f} s")
    log(json.dumps({"kernels": smoke.kernel_rows()}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def mesh_rank(mesh, spec: dict) -> dict:
    """Phase 13's body in one rank of the world (every rank runs it).

    Each rank draws the same stacks as the parent from the same seeds on
    the card and keeps its own (m_local, n) block; it drives
    ``ft_allreduce``, ``ft_allreduce_jit(mesh=)``, TSQR, the Gram-butterfly
    TSQR and the blocked QR through the mesh routes, the kernel layer's
    explicit-Q CholeskyQR2 on its block, and the retrace guard, and returns
    what the parent checks: results as numpy, launch counts, times, the
    wire's counters and its peak memory."""
    import contextlib
    import io
    import warnings

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.bench.cases import dispatch as guard_case
    from repro_torch.collective import (
        DistComm,
        FaultSpec,
        execute_plan,
        ft_allreduce,
        ft_allreduce_jit,
        make_plan,
    )
    from repro_torch.collective import dist as rank_world
    from repro_torch.kernels import dispatch, ops
    from repro_torch.qr import PanelFaultSchedule, QRConfig, factorize

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r, dev = mesh.rank, mesh.device
    on_card = dev.type == "cuda"
    gen = torch.Generator(device=dev)
    counts = dispatch.launches
    panel = spec["panel"]

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def mine(name):
        gen.manual_seed(MESH_SEEDS[name])
        stack = torch.randn(spec["shapes"][name], generator=gen, device=dev)
        return stack[r].clone()         # a view would keep the whole stack alive

    def host(t):
        return t.detach().cpu().numpy()

    def gram64(q):
        q = q.double()
        return host(q.mT @ q)

    def wall(fn) -> float:
        return _rank_wall_ms(fn, dev)

    peaks: dict[str, float] = {}

    @contextlib.contextmanager
    def peak(label):
        """The route's peak allocation (GB), counted from its own start."""
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        yield
        sync()
        peaks[label] = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else 0.0

    def delta_since(before):
        sync()
        return {k: v - before[k] for k, v in counts.as_dict().items() if v != before[k]}

    t_rank = time.perf_counter()
    data = {name: mine(name) for name in MESH_SEEDS}
    x = data["allreduce"]
    sym = x + x.mT                      # elementwise: the parent's has the same bits
    sync()
    if on_card:
        torch.cuda.empty_cache()
    rank_world.wire.reset()
    comm = DistComm(MESH_RANKS, "rows")
    out: dict = {"rank": r, "times": {}, "tsqr": {}, "blocked": {}, "allreduce": {}}
    dist.barrier()
    counts.reset()
    t_cases = time.perf_counter()

    # -- ft_allreduce: every combiner and variant, fault-free and faulted ---
    same_fast = []
    with peak("ft_allreduce"):
        for deaths in (None, MESH_DEATHS):
            for op in MESH_OPS:
                payload = sym if op == "gram_sum" else x
                for variant in VARIANTS:
                    plan = make_plan(variant, MESH_RANKS,
                                     FaultSpec.of(deaths) if deaths else None)
                    v, ok = ft_allreduce(payload, comm, op=op, plan=plan)
                    out["allreduce"][(op, variant, bool(deaths))] = (host(v), bool(ok))
                    if plan.is_fault_free:
                        va, oa = execute_plan(payload, comm, plan, op)
                        vg, og = execute_plan(payload, comm, plan, op, fast=False)
                        same_fast.append(bool(torch.equal(va.view(torch.int32),
                                                          vg.view(torch.int32))
                                              and torch.equal(oa, og)))
        out["fast_equals_general"] = same_fast
        mine_row = x[None]
        vj, okj = ft_allreduce_jit(mine_row, comm, op="sum", mesh=mesh)
        before = dispatch.trace_count("ft_allreduce")
        vj2, _ = ft_allreduce_jit(mine_row, comm, op="sum", mesh=mesh)
        plain, _ = ft_allreduce(x, comm, op="sum")
        out["jit"] = (dispatch.trace_count("ft_allreduce") - before,
                      bool(torch.equal(vj[0], plain) and torch.equal(vj2, vj)), bool(okj[0]))
        out["times"]["ft_allreduce_jit sum"] = wall(
            lambda: ft_allreduce_jit(mine_row, comm, op="sum", mesh=mesh))

    # -- TSQR on the kernels (local_r="cqr2_pallas") ------------------------
    for name, variant, deaths, want_q in MESH_TSQR_RUNS:
        cfg = QRConfig(variant=variant, local_r="cqr2_pallas", compute_q=want_q)
        faults = FaultSpec.of(deaths) if deaths else None
        with peak(f"tsqr {name}{' compute_q' if want_q else ''}"):
            before = counts.as_dict()
            res = factorize(data[name], cfg, faults=faults, mesh=mesh)
            launched = delta_since(before)
            out["tsqr"][(name, variant, bool(deaths), want_q)] = (
                host(res.r[0]), bool(res.valid[0]), res.plan.final_valid,
                gram64(res.q) if want_q else None, launched)
            del res
            if deaths is None and not want_q and variant == "redundant":
                out["times"][f"tsqr {name} redundant"] = wall(
                    lambda cfg=cfg, name=name: factorize(data[name], cfg, mesh=mesh))
    # the Gram-butterfly TSQR at powersgd_panel's width
    with peak(f"gram butterfly {HEADLINE}"):
        res = factorize(data[HEADLINE], QRConfig(gram=True), mesh=mesh)
        out["gram"] = (host(res.r[0]), bool(res.valid[0]), gram64(res.q))
        del res
        out["times"][f"gram butterfly {HEADLINE}"] = wall(
            lambda: factorize(data[HEADLINE], QRConfig(gram=True), mesh=mesh))
    # the kernel layer's explicit-Q CholeskyQR2 of this rank's block
    with peak(f"ops.cholesky_qr2 {HEADLINE}"):
        before = counts.as_dict()
        q, r_full = ops.cholesky_qr2(data[HEADLINE], use_pallas=True)
        r_only = ops.cholesky_qr2_r(data[HEADLINE], use_pallas=True)
        launched = delta_since(before)
        eye = np.eye(q.shape[-1])
        out["cholesky_qr2"] = (bool(torch.equal(r_full, r_only)),
                               float(np.abs(gram64(q) - eye).max()), launched)
        del q

    # -- the blocked QR on the kernels ---------------------------------------
    for label, name, fields, sched in MESH_BLOCKED_RUNS:
        cfg = QRConfig(panel_width=panel, use_pallas=True, **fields)
        faults = PanelFaultSchedule.of(**sched) if sched else None
        with peak(f"blocked {label} {name}"):
            before = counts.as_dict()
            res = factorize(data[name], cfg, faults=faults, mesh=mesh)
            launched = delta_since(before)
            reports = [(rep.plan_r.final_valid, None if rep.plan_w is None else
                        rep.plan_w.final_valid, rep.fused, bool(rep.recovered_r))
                       for rep in res.reports]
            out["blocked"][label] = (host(res.r[0]), bool(res.valid[0]), reports,
                                     gram64(res.q) if res.q is not None else None, launched)
            del res
            if not fields.get("compute_q"):
                out["times"][f"blocked {label} {name}"] = wall(
                    lambda cfg=cfg, faults=faults, name=name: factorize(
                        data[name], cfg, faults=faults, mesh=mesh))
    sync()
    out["launches"] = counts.as_dict()
    out["cases_s"] = time.perf_counter() - t_cases
    out["wire"] = rank_world.wire.as_dict()
    out["peaks"] = peaks
    out["data_gb"] = sum(t.numel() * t.element_size() for t in data.values()) / 1e9

    # -- the retrace guard inside the world (its ShardMapComm line) ----------
    t_guard = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        failures = guard_case.guard()
    out["guard"] = (failures, buf.getvalue(), time.perf_counter() - t_guard)
    out["rank_s"] = time.perf_counter() - t_rank
    del data, x, sym

    # -- phase 13b in the same world: PowerSGD on a data x model mesh --------
    out["psgd"] = psgd_mesh_rank(mesh, spec["psgd"])
    return out


def _rank_wall_ms(fn, dev) -> float:
    """Median host-clock ms of ``MESH_REPEATS`` warm calls of ``fn`` in a
    rank, each ending in a synchronize and a barrier of the world."""
    import torch
    import torch.distributed as dist

    samples = []
    for _ in range(MESH_REPEATS):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def psgd_mesh_rank(mesh, spec: dict) -> dict:
    """Phase 13b's body in one rank of phase 13's world (:func:`mesh_rank`
    calls it on every rank after phase 13's cases).

    The rank runs the entry point's own rank body
    (``powersgd_dp.rank_main``: the 2 x 4 data x model mesh of
    ``launch/mesh.py::make_smoke_mesh``, the example's widths, 80 steps, the
    fault at step 40); then, on a 2 x 4 mesh of its own, it runs
    ``compress_grad`` at ``tests/test_spmd.py:121``'s sizes against the
    dense data-mean, and times ``compress_grad`` on its rows of an olmo-1b
    MLP projection's gradient (distinct per data replica) at each rank of
    ``PSGD_MESH_RANKS``, with the wire's exchange and staging seconds and
    the peak allocation of those calls."""
    import torch

    from repro_torch.collective import ShardMapComm
    from repro_torch.collective import dist as rank_world
    from repro_torch.kernels import dispatch
    from repro_torch.launch import powersgd_dp
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.optim import powersgd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    on_card = dev.type == "cuda"
    gen = torch.Generator(device=dev)
    counts = dispatch.launches
    t_rank = time.perf_counter()

    def psum_data(v):
        return rank_world.psum(v, "data", grid)

    def psum_model(v):
        return rank_world.psum(v, "model", grid)

    def randn(shape, seed):
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    counts.reset()
    rank_world.wire.reset()
    out: dict = {}
    t0 = time.perf_counter()
    out["example"] = powersgd_dp.rank_main(mesh)
    out["example_s"] = time.perf_counter() - t0
    out["example_wire"] = rank_world.wire.as_dict()

    grid = make_smoke_mesh(powersgd_dp.D, powersgd_dp.M)
    D, M = grid.shape["data"], grid.shape["model"]
    d, m = grid.index("data"), grid.index("model")
    comm = ShardMapComm(M, "model")
    out.update({"rank": grid.rank, "coords": (d, m)})

    # -- tests/test_spmd.py:121: a rank-r gradient per data replica ---------
    _, _, m_loc, n, r = spec["spmd"]
    u = randn((D, M * m_loc, r), PSGD_MESH_SEEDS["spmd"])
    v = randn((n, r), PSGD_MESH_SEEDS["spmd"] + 1)
    q0 = randn((n, r), PSGD_MESH_SEEDS["spmd"] + 2)
    g = torch.einsum("dmr,nr->dmn", u, v)
    rows = slice(m * m_loc, (m + 1) * m_loc)
    ghat, _, stats = powersgd.compress_grad(
        g[d, rows].clone(), {"q": q0, "e": None}, comm,
        cfg=powersgd.PowerSGDConfig(rank=r, error_feedback=False),
        psum_data=psum_data, psum_model=psum_model, n_data=D)
    mean = g.mean(0)[rows]
    out["spmd"] = (float((ghat - mean).abs().max()),
                   bool(((ghat - mean).abs() <= PSGD_MESH_SPMD_TOL
                         + PSGD_MESH_SPMD_TOL * mean.abs()).all()),
                   bool(stats["valid"]), ghat.cpu().numpy())
    del u, g, mean

    # -- compress_grad on this rank's rows of an olmo-1b MLP projection ------
    n_rows, n_cols = spec["olmo"]
    m_loc = n_rows // M
    blk = randn((n_rows, n_cols), PSGD_MESH_SEEDS["olmo"] + d)[m * m_loc:(m + 1) * m_loc].clone()
    sync()
    if on_card:
        torch.cuda.empty_cache()
    timed = {}
    for rank in spec["ranks"]:
        cfg = powersgd.PowerSGDConfig(rank=rank)
        state = {"q": randn((n_cols, rank), PSGD_MESH_SEEDS["basis"]),
                 "e": torch.zeros_like(blk)}

        def call(cfg=cfg, state=state):
            return powersgd.compress_grad(blk, state, comm, cfg=cfg, psum_data=psum_data,
                                          psum_model=psum_model, n_data=D)

        ghat, new, stats = call()
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        rank_world.wire.reset()
        ms = _rank_wall_ms(call, dev)
        wire = rank_world.wire.as_dict()
        timed[rank] = {
            "ms": ms, "exchange_ms": wire["exchange_seconds"] * 1e3 / MESH_REPEATS,
            "staging_ms": wire["staging_seconds"] * 1e3 / MESH_REPEATS,
            "bytes_sent": wire["bytes_sent"] // MESH_REPEATS,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else 0.0,
            "valid": bool(stats["valid"]), "finite": bool(ghat.isfinite().all()),
            "bytes": (stats["data_bytes_compressed"], stats["data_bytes_dense"]),
            "ghat_sha": _sha(ghat), "q_sha": _sha(new["q"]),
        }
        del ghat, new, state
    out["olmo"] = timed
    sync()
    out["launches"] = counts.as_dict()
    out["rank_s"] = time.perf_counter() - t_rank
    return out


def _sha(t) -> str:
    import hashlib

    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()


class Smoke:
    def __init__(self, torch):
        from repro_torch import configs
        from repro_torch.kernels import _build, dispatch, ops, ref
        from repro_torch.kernels.apply_right import apply_right
        from repro_torch.kernels.combine_gram import combine_gram
        from repro_torch.kernels.fused_apply_gram import fused_apply_gram
        from repro_torch.kernels.gram import gram
        from repro_torch.kernels.trailing_update import pad_cross, panel_cross, trailing_update

        self.torch = torch
        self.build_mod, self.dispatch, self.ops, self.ref = _build, dispatch, ops, ref
        self.kernels = {"gram": gram, "fused_apply_gram": fused_apply_gram,
                        "apply_right": apply_right, "trailing_update": trailing_update,
                        "panel_cross": panel_cross, "pad_cross": pad_cross,
                        "combine_gram": combine_gram}
        self.gen = torch.Generator(device=DEVICE)
        self.errors: dict[str, float] = {}
        self.launches: dict[str, dict[str, int]] = {}  # path -> kernel -> count
        self.times: dict[tuple[str, str], dict] = {}
        self.e2e: dict[tuple[str, str], float] = {}
        self.blocked_full = None      # general_full's input and float64 R
        self.replay_ms: dict[str, tuple[float, float]] = {}  # label -> (replay, eager)
        self.ptxas: dict[str, str] = {}  # kernel -> ptxas -v of its main-path instantiation
        self.card_name = ""
        self.configs = configs
        olmo = configs.get_config(OLMO_ARCH)
        self.olmo = {"d_model": olmo.d_model, "d_ff": olmo.d_ff, "vocab": olmo.vocab,
                     "seq_len": OLMO_SEQ_LEN}

    # -- helpers --------------------------------------------------------------

    def randn(self, shape, seed, dtype=None):
        torch = self.torch
        self.gen.manual_seed(seed)
        x = torch.randn(shape, generator=self.gen, device=DEVICE)
        return x if dtype is None else x.to(dtype)

    def time_ms(self, fn, repeats: int = 7, inner: int = 5) -> float:
        """Median over ``repeats`` of CUDA-event times of ``inner`` calls."""
        torch = self.torch
        for _ in range(2):
            fn()
        samples = []
        for _ in range(repeats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / inner)
        return statistics.median(samples)

    def same_bits(self, got, want) -> bool:
        """Equal dtype, shape and bytes (NaN payloads included)."""
        torch = self.torch
        if got.dtype != want.dtype or got.shape != want.shape:
            return False
        if got.is_floating_point():
            as_int = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[got.dtype]
            got, want = got.view(as_int), want.view(as_int)
        return torch.equal(got, want)

    def rel_err(self, got, want) -> float:
        if want.dtype != self.torch.float64:
            got, want = got.float(), want.float()
        return ((got - want).abs().max() / want.abs().max()).item()

    # -- phase 1: build -------------------------------------------------------

    def build(self) -> None:
        t0 = time.perf_counter()
        self.build_mod.build_all()
        log(f"[build] {len(self.build_mod.KERNELS)} kernel libraries in "
            f"{time.perf_counter() - t0:.1f} s ({self.build_mod.build_dir()})")
        for name in self.build_mod.KERNELS:
            entries = self.build_mod.ptxas_entries(name).values()
            regs = [e.split("Used ")[1].split(",")[0] for e in entries if "Used " in e]
            spills = [k for k, e in self.build_mod.ptxas_entries(name).items()
                      if ", 0 bytes spill stores" not in e]
            log(f"[build] {name}: {', '.join(regs)}; spilling variants: {len(spills)} "
                f"{spills}")
        for name, entry in MAIN_ENTRY.items():
            found = [v for k, v in self.build_mod.ptxas_entries(name).items() if entry in k]
            self.ptxas[name] = found[0] if found else "not in the build log"
            log(f"[build] {name} main-path instantiation ({entry}): {self.ptxas[name]}")

    # -- phase 2: card --------------------------------------------------------

    def card(self) -> str:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()
        log(f"[card] {out[0]}")
        self.card_name = out[0]
        return out[0]

    # -- phase 3: kernels against their plain versions ------------------------

    def kernel_checks(self) -> None:
        torch = self.torch
        gram, fused, apply = (self.kernels[k] for k in ("gram", "fused_apply_gram",
                                                       "apply_right"))
        cases = [  # (batch, m, n, k): ragged m, P = 8 batches, k != n
            (1, 1000, 32, 32), (P, 777, 128, 128), (2, 513, 256, 256),
            (3, 100, 7, 5), (2, 300, 64, 40), (1, 257, 512, 512),
            # rows of 120 bytes (f32) and 60 bytes (bf16): apply_right's
            # 4-byte copies; odd bf16 rows (n = 7 above) take its one-element
            # copies; k != n at the main path's n, one and two column tiles
            (2, 333, 30, 30), (P, 1001, 128, 96), (P, 1001, 128, 200),
            *[(b, m, n, n) for b, m, n in MAIN_SHAPES.values()],
        ]
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            for seed, (b, m, n, k) in enumerate(cases):
                a = self.randn((b, m, n), seed, dtype)
                w = (self.randn((b, n, k), 100 + seed) / n ** 0.5).to(dtype)
                g = gram(a)
                q = apply(a, w)
                qf, gf = fused(a, w)
                g_only = fused(a, w, want_q=False)
                g_unfused = gram(q)
                torch.cuda.synchronize()
                errs = {
                    "gram": self.rel_err(g, self.ref.gram(a)),
                    "apply_right": self.rel_err(q, self.ref.apply_right(a, w)),
                    "fused_apply_gram": max(
                        self.rel_err(gf, self.ref.fused_apply_gram(a, w)[1]),
                        self.rel_err(qf, self.ref.apply_right(a, w)),
                    ),
                }
                bitwise = {
                    "fused Q == apply_right": torch.equal(qf, q),
                    "fused G == gram(apply_right)": torch.equal(gf, g_unfused),
                    "want_q=False == want_q=True": torch.equal(g_only, gf),
                    "gram rerun": torch.equal(gram(a), g),
                    "fused rerun": torch.equal(fused(a, w, want_q=False), g_only),
                    "apply_right rerun": torch.equal(apply(a, w), q),
                }
                torch.cuda.synchronize()
                log(f"[kernels] {dname} {(b, m, n, k)} rel err "
                    + " ".join(f"{k_}={v:.2e}" for k_, v in errs.items())
                    + f" bitwise {all(bitwise.values())}")
                for name, err in errs.items():
                    check(err <= TOL[dname], f"{name} {dname} {(b, m, n, k)}: rel err {err:.3e}"
                          f" > {TOL[dname]}")
                for what, ok in bitwise.items():
                    check(ok, f"{what} fails at {dname} {(b, m, n, k)}")
                if dtype == torch.float32 and (b, m, n, k) in {
                        (*shape, shape[-1]) for shape in MAIN_SHAPES.values()}:
                    self.float64_errors(a, w, g, q, gf)
                if dtype == torch.float32 and (b, m, n) == MAIN_SHAPES[HEADLINE]:
                    self.errors.update({name: self._abs_err(name, a, w) for name in errs})

    def float64_errors(self, a, w, g, q, gf) -> None:
        """Kernel and plain version, each against a float64 product: which
        of the two f32 summation orders is nearer the exact value.  The
        kernel must stay within ``F64_TOL`` (full f32, no TF32)."""
        a64, w64, q64 = a.double(), w.double(), q.double()
        want = {"gram": a64.mT @ a64, "apply_right": a64 @ w64,
                "fused_apply_gram": q64.mT @ q64}
        got = {"gram": (g, self.ref.gram(a)), "apply_right": (q, self.ref.apply_right(a, w)),
               "fused_apply_gram": (gf, self.ref.gram(q))}
        errs = {name: [self.rel_err(x.double(), want[name]) for x in pair]
                for name, pair in got.items()}
        log(f"[kernels] vs float64 at {tuple(a.shape)}: " + "; ".join(
            f"{name} kernel {k:.2e} plain {p:.2e}" for name, (k, p) in errs.items()))
        for name, (err, _) in errs.items():
            check(err <= F64_TOL, f"{name} at {tuple(a.shape)}: {err:.3e} from float64 "
                  f"> {F64_TOL}")

    def _abs_err(self, name: str, a, w) -> float:
        """max |kernel − plain| on the headline main-path inputs."""
        kern, ref = self.kernels[name], self.ref
        if name == "gram":
            return (kern(a) - ref.gram(a)).abs().max().item()
        if name == "apply_right":
            return (kern(a, w) - ref.apply_right(a, w)).abs().max().item()
        return (kern(a, w, want_q=False) - ref.fused_apply_gram(a, w)[1]).abs().max().item()

    # -- phase 3b: the blocked QR's kernels against their plain versions ------

    def blocked_kernel_checks(self) -> None:
        """trailing_update, panel_cross and pad_cross on strided views of a
        wider matrix: against their plain versions, the bitwise contracts
        between them, width invariance, reruns, and the ``out=`` buffer."""
        torch, ref = self.torch, self.ref
        tu, pc, pad = (self.kernels[k] for k in ("trailing_update", "panel_cross", "pad_cross"))
        extra = 40
        # (m, b, n_t): A = wide[..., b:b + n_t] of b + n_t + 40 columns, so
        # panel_cross stages the first four with 16-byte copies and the last
        # three, at the offset b = 7 or a row stride that is not a multiple
        # of 4 elements, with 4-byte copies (bf16 at b = 7: one element a
        # copy); m % 32 != 0 in all
        cases = [(4099, 32, 96), (777, 32, 384), (4099, 128, 96), (777, 128, 384),
                 (100, 7, 17), (1001, 32, 98), (333, 128, 130)]
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).removeprefix("torch.")
            for seed, (m, b, nt) in enumerate(cases):
                wide = self.randn((P, m, b + nt + extra), 200 + seed, dtype)
                wide[..., b + nt:] = 0
                a, a_ext = wide[..., b:b + nt], wide[..., b:]        # strided rows
                q = self.randn((P, m, b), 300 + seed, dtype)
                w = (self.randn((P, b, nt), 400 + seed) / b ** 0.5).to(dtype)
                w_ext = torch.cat([w, w.new_zeros(w.shape[:-1] + (extra,))], dim=-1)
                split = min(b, nt)
                s1 = pc(a, split=split)
                a_pad, s_pad = pad(a, split=split, out_width=nt + extra)
                want_pad = ref.pad_cross(a, split=split, out_width=nt + extra)
                errs = {"panel_cross": self.rel_err(s1, ref.panel_cross(a, split=split)),
                        "pad_cross": max(self.rel_err(a_pad, want_pad[0]),
                                         self.rel_err(s_pad, want_pad[1]))}
                bitwise = {
                    "pad_cross S real columns == panel_cross": torch.equal(s_pad[..., :nt], s1),
                    "pad_cross pad columns zero": not s_pad[..., nt:].any()
                    and not a_pad[..., nt:].any(),
                    "pad_cross copy exact": torch.equal(a_pad[..., :nt], a),
                    "panel_cross width-invariant": torch.equal(pc(a_ext, split=split)[..., :nt],
                                                               s1),
                    "panel_cross rerun": torch.equal(pc(a, split=split), s1),
                    "pad_cross rerun": torch.equal(pad(a, split=split, out_width=nt + extra)[1],
                                                   s_pad),
                }
                for nw in (0, split):
                    got = tu(a, q, w, next_width=nw)
                    want = ref.trailing_update(a, q, w, next_width=nw)
                    wide_got = tu(a_ext, q, w_ext, next_width=nw)
                    buf = torch.zeros((P, m, nt + 8), dtype=dtype, device=DEVICE)
                    into = tu(a, q, w, next_width=nw, out=buf[..., :nt])
                    if nw:
                        a_new, s_new = got
                        errs[f"trailing_update nw={nw}"] = max(self.rel_err(a_new, want[0]),
                                                              self.rel_err(s_new, want[1]))
                        bitwise["S == panel_cross(stored A_new)"] = torch.equal(
                            s_new, pc(a_new, split=nw))
                        bitwise["S width-invariant"] = torch.equal(wide_got[1][..., :nt], s_new)
                        bitwise["out= S"] = torch.equal(into[1], s_new)
                        wide_got, got = wide_got[0], a_new
                    else:
                        errs["trailing_update nw=0"] = self.rel_err(got, want)
                    bitwise[f"A_new width-invariant nw={nw}"] = torch.equal(
                        wide_got[..., :nt], got) and not wide_got[..., nt:].any()
                    bitwise[f"out= A_new nw={nw}"] = torch.equal(buf[..., :nt], got) \
                        and not buf[..., nt:].any()
                    rerun = tu(a, q, w, next_width=nw)
                    bitwise[f"trailing_update rerun nw={nw}"] = torch.equal(
                        rerun[0] if nw else rerun, got)
                torch.cuda.synchronize()
                tag = f"{dname} (P={P}, m={m}, b={b}, n_t={nt})"
                log(f"[blocked kernels] {tag} rel err "
                    + " ".join(f"{k_}={v:.2e}" for k_, v in errs.items())
                    + f" bitwise {all(bitwise.values())}")
                for name, err in errs.items():
                    check(err <= TOL[dname], f"{name} {tag}: rel err {err:.3e} > {TOL[dname]}")
                for what, ok in bitwise.items():
                    check(ok, f"{what} fails at {tag}")
        self.blocked_float64()

    def blocked_float64(self) -> None:
        """At the main path's shapes (f32): each kernel and its plain version
        against a float64 product, and max |kernel − plain| for the
        ``kernels`` line."""
        torch, ref = self.torch, self.ref
        tu, pc, pad = (self.kernels[k] for k in ("trailing_update", "panel_cross", "pad_cross"))
        b = PANEL
        full = self.randn(BLOCKED_SHAPES["general_full"], 500)
        ragged = self.randn(BLOCKED_SHAPES["general_ragged"], 501)
        a = full[..., b:]
        q = self.randn(full.shape[:-1] + (b,), 502) / full.shape[-2] ** 0.5
        w = self.randn((P, b, a.shape[-1]), 503) / b ** 0.5
        a_new, s_new = tu(a, q, w, next_width=b)
        p_new, p_s = ref.trailing_update(a, q, w, next_width=b)
        s1, s1_plain = pc(full, split=b), ref.panel_cross(full, split=b)
        _, s2 = pad(ragged, split=b, out_width=full.shape[-1])
        s2_plain = ref.pad_cross(ragged, split=b, out_width=full.shape[-1])[1]
        self.errors.update({
            "trailing_update": max((a_new - p_new).abs().max().item(),
                                   (s_new - p_s).abs().max().item()),
            "panel_cross": (s1 - s1_plain).abs().max().item(),
            "pad_cross": (s2 - s2_plain).abs().max().item(),
        })
        nr = ragged.shape[-1]
        f64 = {"trailing_update A_new": (a.double() - q.double() @ w.double(), a_new, p_new)}
        an64 = a_new.double()
        f64["trailing_update S"] = (an64[..., :b].mT @ an64, s_new, ref.panel_cross(a_new, split=b))
        del an64
        f64["panel_cross"] = (full.double()[..., :b].mT @ full.double(), s1, s1_plain)
        r64 = ragged.double()
        f64["pad_cross"] = (r64[..., :b].mT @ r64, s2[..., :nr], s2_plain[..., :nr])
        del r64
        errs = {k: (self.rel_err(g.double(), t), self.rel_err(pl.double(), t))
                for k, (t, g, pl) in f64.items()}
        log("[blocked kernels] vs float64 at the main path's shapes: " + "; ".join(
            f"{k} kernel {e:.2e} plain {pe:.2e}" for k, (e, pe) in errs.items()))
        log(f"[blocked kernels] max |kernel − plain| on those inputs: "
            + json.dumps({k: self.errors[k] for k in ("trailing_update", "panel_cross",
                                                      "pad_cross")}))
        for k, (e, _) in errs.items():
            check(e <= F64_TOL, f"{k}: {e:.3e} from float64 > {F64_TOL}")
        self.batch_vs_slices()

    def batch_vs_slices(self) -> None:
        """trailing_update over a batch against its per-slice calls: A_new
        bit for bit (no row reduction feeds it); S bit for bit where
        ``cross_split(batch, m)`` gives the rows of ``cross_split(1, m)``,
        else within F64_TOL (the split is a function of (batch, m), so the
        sums run over other row blocks).  At ROADMAP C.8's case, where the
        reference's vmapped call is not bitwise, and at general_full's
        first trailing update."""
        import numpy as np

        torch = self.torch
        from repro_torch.kernels import _launch

        tu = self.kernels["trailing_update"]
        c8 = [torch.from_numpy(np.random.default_rng(i).standard_normal(shape)
                               .astype(np.float32)).to(DEVICE)
              for i, shape in enumerate([(2, 5, 3), (2, 5, 1), (2, 1, 3)])]
        m, b = BLOCKED_SHAPES["general_full"][1], PANEL
        nt = BLOCKED_SHAPES["general_full"][2] - b
        main = [self.randn((P, m, nt), 510), self.randn((P, m, b), 511) / m ** 0.5,
                self.randn((P, b, nt), 512) / b ** 0.5]
        for label, (a, q, w), nw in (("C.8", c8, 3), ("general_full", main, b)):
            batch, rows = a.shape[0], a.shape[1]
            same_split = _launch.cross_split(batch, rows) == _launch.cross_split(1, rows)
            a_new, s = tu(a, q, w, next_width=nw)
            a_bits, s_bits, s_err = True, True, 0.0
            for i in range(batch):
                ai, si = tu(a[i], q[i], w[i], next_width=nw)
                a_bits &= self.same_bits(a_new[i], ai)
                s_bits &= self.same_bits(s[i], si)
                s_err = max(s_err, self.rel_err(s[i].double(), si.double()))
            tag = (f"{label} {tuple(a.shape)} b={q.shape[-1]} next_width={nw}: split "
                   f"{_launch.cross_split(batch, rows)} batched, {_launch.cross_split(1, rows)} "
                   f"per slice")
            log(f"[blocked kernels] batch vs per-slice calls at {tag}: A_new bitwise {a_bits}, "
                f"S bitwise {s_bits}, S rel err {s_err:.2e}")
            check(a_bits, f"A_new of the batched call differs from its per-slice calls at {tag}")
            if same_split:
                check(s_bits, f"S of the batched call differs from its per-slice calls at {tag}")
            check(s_err <= F64_TOL, f"S batched vs per slice {s_err:.3e} > {F64_TOL} at {tag}")

    # -- phase 4: the main path -----------------------------------------------

    def main_path(self) -> None:
        torch = self.torch
        from repro_torch.collective import FaultSpec
        from repro_torch.qr import QRConfig, factorize

        counts = self.dispatch.launches
        fault = FaultSpec.of({5: 1})
        kern = "cqr2_pallas"
        runs = [(name, v, f, False, kern) for name in ("paper_fig",) for v in VARIANTS
                for f in (None, fault)]
        runs += [(HEADLINE, v, f, False, kern) for v in ("redundant", "selfhealing")
                 for f in (None, fault)]
        # compute_q on the kernel route, and on the plain route, whose polish
        # Gram is the chunked product of qr/panel.py (ROADMAP C4)
        runs += [("paper_fig", "redundant", None, True, kern),
                 ("paper_fig", "redundant", None, True, "cqr2")]
        data = {name: self.randn(shape, 1000 + i) for i, (name, shape) in
                enumerate(MAIN_SHAPES.items())}
        truth = {}
        for name, a in data.items():
            r64 = torch.linalg.qr(a.reshape(-1, a.shape[-1]).double(), mode="r")[1]
            truth[name] = r64 * torch.where(r64.diagonal() < 0, -1.0, 1.0).double()[:, None]
        torch.cuda.synchronize()

        counts.reset()
        for name, variant, faults, want_q, local_r in runs:
            before = counts.as_dict()
            res = factorize(data[name], QRConfig(variant=variant, local_r=local_r,
                                                 compute_q=want_q), faults=faults)
            torch.cuda.synchronize()
            delta = {k: v - before[k] for k, v in counts.as_dict().items()}
            deaths = faults.deaths if faults else ()
            tag = f"{name} {tuple(data[name].shape)} {variant} {local_r} faults={deaths}"
            # one launch of each for all P ranks; with compute_q the
            # reorthogonalization pass adds one gram launch; the plain
            # route launches nothing
            want = dict.fromkeys(counts.as_dict(), 0)
            if local_r == kern:
                want.update(gram=1 + want_q, fused_apply_gram=1)
            check(delta == want, f"{tag}: launches {delta}, want {want}")
            valid = res.valid.cpu().numpy()
            check((valid == res.plan.final_valid).all(),
                  f"{tag}: validity {valid} != plan {res.plan.final_valid}")
            t = truth[name]
            err = max(((res.r[i].double() - t).abs().max() / t.abs().max()).item()
                      for i in valid.nonzero()[0].tolist())
            check(err <= R_TIGHT, f"{tag}: survivor R rel err {err:.3e} > {R_TIGHT} "
                  f"(suite limit {R_TOL})")
            line = f"[main] {tag} valid={valid.astype(int).tolist()} R rel err {err:.2e}"
            if want_q:
                q = res.q.double()
                ortho = (torch.einsum("pmi,pmj->ij", q, q)
                         - torch.eye(q.shape[-1], dtype=torch.float64, device=DEVICE)
                         ).abs().max().item()
                check(ortho <= ORTHO_TOL, f"{tag}: ||QᵀQ − I|| {ortho:.3e} > {ORTHO_TOL}")
                line += f" ||QᵀQ−I||={ortho:.2e}"
            log(line + f" launches {delta}")

        self.launches["factorize"] = counts.as_dict()
        log(f"[main] launches over {len(runs)} factorizations: {self.launches['factorize']}")

        # the kernel layer's explicit-Q CholeskyQR2 (sweep 3 is apply_right),
        # held against the R-only path as the reference's kernels bench case
        # does; its launches are counted on their own
        counts.reset()
        for name, a in data.items():
            before = counts.as_dict()
            q, r = self.ops.cholesky_qr2(a, use_pallas=True)
            r_only = self.ops.cholesky_qr2_r(a, use_pallas=True)
            torch.cuda.synchronize()
            delta = {k: v - before[k] for k, v in counts.as_dict().items() if v - before[k]}
            check(delta == {"gram": 2, "fused_apply_gram": 2, "apply_right": 1},
                  f"cholesky_qr2 {name}: launches {delta}")
            check(torch.equal(r, r_only), f"cholesky_qr2 {name}: R-only != full-Q R")
            q64 = q.double()
            ortho = (q64.mT @ q64 - torch.eye(q.shape[-1], dtype=torch.float64,
                                              device=DEVICE)).abs().max().item()
            check(ortho <= 3e-5, f"cholesky_qr2 {name}: per-rank ||QᵀQ − I|| {ortho:.3e}")
            log(f"[main] cholesky_qr2 {name} {tuple(a.shape)} R-only == full-Q R, "
                f"per-rank ||QᵀQ−I||={ortho:.2e} launches {delta}")
        self.launches["cholesky_qr2"] = counts.as_dict()
        log(f"[main] launches over {len(data)} explicit-Q cholesky_qr2 calls: "
            f"{self.launches['cholesky_qr2']}")
        med, lo, hi = self._median_ms(lambda: self.ops.cholesky_qr2(data[HEADLINE],
                                                                    use_pallas=True))
        log(f"[e2e] ops.cholesky_qr2 {HEADLINE} {tuple(data[HEADLINE].shape)} use_pallas: "
            f"median {med:.3f} ms (min {lo:.3f}, max {hi:.3f}, 5 runs)")
        cfg = QRConfig(variant="redundant", local_r=kern)
        for name, a in data.items():
            self.profile(f"TSQR {name} {tuple(a.shape)}", lambda a=a: factorize(a, cfg))

        # end-to-end factorize times
        for name, variant, faults, want_q, local_r in runs:
            cfg = QRConfig(variant=variant, local_r=local_r, compute_q=want_q)
            samples = []
            for i in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                factorize(data[name], cfg, faults=faults)
                torch.cuda.synchronize()
                if i:
                    samples.append((time.perf_counter() - t0) * 1e3)
            log(f"[e2e] factorize {name} {tuple(data[name].shape)} {variant} "
                f"{local_r} faults={faults.deaths if faults else ()} compute_q={want_q}: "
                f"median {statistics.median(samples):.3f} ms "
                f"(min {min(samples):.3f}, max {max(samples):.3f}, 5 runs)")

    # -- phase 5: the blocked QR ----------------------------------------------

    def truth_r(self, a):
        """Sign-normalized float64 Householder R of the global matrix."""
        torch = self.torch
        r64 = torch.linalg.qr(a.reshape(-1, a.shape[-1]).double(), mode="r")[1]
        return r64 * torch.where(r64.diagonal() < 0, -1.0, 1.0).double()[:, None]

    def blocked_path(self) -> None:
        import numpy as np

        torch = self.torch
        from repro_torch.qr import PanelFaultSchedule, QRConfig, factorize

        counts = self.dispatch.launches
        data = {name: self.randn(shape, 3000 + i)
                for i, (name, shape) in enumerate(BLOCKED_SHAPES.items())}
        truth = {name: self.truth_r(a) for name, a in data.items()}
        self.blocked_full = (data["general_full"], truth["general_full"])
        death = {"panel {1: {5: 1}}": PanelFaultSchedule.of(panel={1: {5: 1}}),
                 "update {0: {3: 0}}": PanelFaultSchedule.of(update={0: {3: 0}}),
                 "update {0: {5: 1}}": PanelFaultSchedule.of(update={0: {5: 1}})}
        runs = []     # (shape, variant, config fields, fault name, equal to run)
        for v in BLOCKED_VARIANTS:
            runs += [("general_full", v, {}, None, None),
                     ("general_full", v, {"pipeline": "off"}, None, ("general_full", v)),
                     ("general_full", v, {"fuse": "off"}, None, ("general_full", v)),
                     ("general_ragged", v, {}, None, None),
                     ("general_ragged", v, {"pipeline": "off"}, None, ("general_ragged", v))]
            runs += [("general_full", v, {"fuse": fuse}, f, None)
                     for f in death for fuse in ("auto", "off")]
        runs += [("general_full", "redundant", {"recover": "off"}, "panel {1: {5: 1}}", None),
                 ("general_full", "redundant", {"compute_q": True}, None, None)]
        torch.cuda.synchronize()

        base = {}
        counts.reset()
        for name, variant, fields, fault, same_as in runs:
            a = data[name]
            faults = death[fault] if fault else None
            before = counts.as_dict()
            res = factorize(a, QRConfig(panel_width=PANEL, use_pallas=True, variant=variant,
                                        **fields), faults=faults)
            torch.cuda.synchronize()
            delta = {k: v - before[k] for k, v in counts.as_dict().items()}
            tag = f"{name} {tuple(a.shape)} {variant} {fields} faults={fault}"
            k_panels = res.n_panels
            eager = faults is not None or fields.get("pipeline") == "off"
            prime = "pad_cross" if not eager and a.shape[-1] < k_panels * PANEL else "panel_cross"
            want = dict.fromkeys(counts.as_dict(), 0)
            want.update({prime: 1, "trailing_update": k_panels - 1, "gram": sum(
                1 for rep in res.reports if rep.plan_r.final_valid.all() or rep.recovered_r)})
            check(delta == want, f"{tag}: launches {delta}, want {want}")
            expect = np.ones(P, bool)
            for rep in res.reports:
                expect &= rep.plan_r.final_valid
                if not rep.fused and rep.plan_w is not None:
                    expect &= rep.plan_w.final_valid
            valid = res.valid.cpu().numpy()
            check((valid == expect).all(), f"{tag}: validity {valid} != plans {expect}")
            # recover="off" leaves the faulted panel exact on survivors and
            # rots the later ones
            rows = 2 * PANEL if fields.get("recover") == "off" else a.shape[-1]
            t = truth[name][:rows]
            errs = [((res.r[i, :rows].double() - t).abs().max() / t.abs().max()).item()
                    for i in valid.nonzero()[0].tolist()]
            line = f"[blocked] {tag} valid={valid.astype(int).tolist()}"
            if errs:
                err = max(errs)
                check(err <= R_TIGHT_BLOCKED, f"{tag}: survivor R rel err "
                      f"{err:.3e} > {R_TIGHT_BLOCKED} (suite limit {R_TOL})")
                line += f" R rel err {err:.2e}"
            else:
                check(bool(torch.isnan(res.r).flatten(1).any(1).all()),
                      f"{tag}: no survivor, yet some rank's R is not poisoned")
                line += " no survivor, every R NaN-poisoned"
            if rows < a.shape[-1]:
                check(bool(torch.isnan(res.r[:, rows:]).any()), f"{tag}: later panels not poisoned")
                line += f", rows >= {rows} poisoned"
            if fields.get("compute_q"):
                q = res.q.double()
                ortho = (torch.einsum("pmi,pmj->ij", q, q)
                         - torch.eye(q.shape[-1], dtype=torch.float64, device=DEVICE)
                         ).abs().max().item()
                del q
                check(ortho <= ORTHO_BLOCKED,
                      f"{tag}: ||QᵀQ − I|| {ortho:.3e} > {ORTHO_BLOCKED}")
                line += f" ||QᵀQ−I||={ortho:.2e}"
            if same_as is not None:
                other = base[same_as]
                check(torch.equal(res.r, other.r) and torch.equal(res.valid, other.valid),
                      f"{tag}: R differs from {same_as}'s pipeline run")
                line += f" == {same_as[0]} pipeline run bit for bit"
            elif not fields and faults is None:
                base[(name, variant)] = res
            log(line + f" launches {({k: v for k, v in delta.items() if v})}")
        self.launches["blocked"] = counts.as_dict()
        log(f"[blocked] launches over {len(runs)} factorizations: {self.launches['blocked']}")
        for kernel, path in KERNEL_PATH.items():
            check(self.launches[path][kernel] > 0, f"{kernel} was never launched on its "
                  f"path ({path})")

        for name, a in data.items():
            for pipeline in ("auto", "off"):
                cfg = QRConfig(panel_width=PANEL, use_pallas=True, pipeline=pipeline)
                self.profile(f"blocked {name} {tuple(a.shape)} pipeline={pipeline}",
                             lambda a=a, cfg=cfg: factorize(a, cfg))
        for name, a in data.items():
            for pipeline in ("auto", "off"):
                cfg = QRConfig(panel_width=PANEL, use_pallas=True, pipeline=pipeline)
                samples = []
                for i in range(6):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    factorize(a, cfg)
                    torch.cuda.synchronize()
                    if i:
                        samples.append((time.perf_counter() - t0) * 1e3)
                self.e2e[(name, pipeline)] = statistics.median(samples)
                log(f"[e2e] blocked factorize {name} {tuple(a.shape)} redundant "
                    f"pipeline={pipeline}: median {statistics.median(samples):.3f} ms "
                    f"(min {min(samples):.3f}, max {max(samples):.3f}, 5 runs)")

    # -- phase 12: the autotuner and the bench harness -----------------------

    def autotune_path(self) -> None:
        torch = self.torch
        from repro_torch import replay
        from repro_torch.bench.__main__ import main as bench_main
        from repro_torch.bench.cases import autotune as tune_case
        from repro_torch.kernels import _launch
        from repro_torch.kernels import autotune as at
        from repro_torch.qr import QRConfig, factorize
        from repro_torch.serve.planner import CostModel

        t_phase = time.perf_counter()
        at.clear()
        tsqr = self.randn(MAIN_SHAPES[HEADLINE], 1001)
        blk = self.randn(BLOCKED_SHAPES["general_full"], 3000)
        cfgs = {"tsqr": (tsqr, QRConfig(variant="redundant", local_r="cqr2_pallas"), R_TIGHT),
                "blocked": (blk, QRConfig(panel_width=PANEL, use_pallas=True), R_TIGHT_BLOCKED)}
        truth = {k: self.truth_r(a) for k, (a, _, _) in cfgs.items()}
        untuned = {k: factorize(a, cfg).r.clone() for k, (a, cfg, _) in cfgs.items()}
        torch.cuda.synchronize()

        shapes = [(m, n) for _, m, n in AUTOTUNE_SHAPES.values()]
        t0 = time.perf_counter()
        doc = at.tune(shapes, at.DEFAULT_KERNELS, batch=P, reps=AUTOTUNE_REPS,
                      out_dir=str(AUTOTUNE_DIR))
        tune_s = time.perf_counter() - t0
        table = at.load_table(str(AUTOTUNE_DIR / f"{doc['backend']}.json"))
        check(table == json.loads(json.dumps(doc)), "autotune: the reloaded table differs")
        mc = table["machine"]
        log(f"[autotune] {len(table['entries'])} entries tuned in {tune_s:.1f} s at batch {P} "
            f"on {self.card_name}; probes: copy {mc['mem_bw_bytes_per_s']:.4e} B/s, f32 "
            f"product {mc['flops_per_s']:.4e} flop/s")
        for key, e in sorted(table["entries"].items()):
            check(at.entry_legal(e), f"autotune {key}: illegal winner {e['block_rows']}")
            check(at.select_winner(e) == e["block_rows"],
                  f"autotune {key}: the persisted times re-pick {at.select_winner(e)}, "
                  f"not {e['block_rows']}")
            default = at.default_block_rows(e["kernel"], e["m"], e["n"], batch=e["batch"])
            times = {c["block_rows"]: c["measured_s"] for c in e["candidates"]}
            measured = ", ".join(f"{br}: {t * 1e3:.4f}" for br, t in sorted(times.items())
                                 if t is not None)
            t_def = times.get(default)
            log(f"[autotune] {key}: winner {e['block_rows']} rows a split "
                f"({times[e['block_rows']] * 1e3:.4f} ms) against the untuned {default} ("
                + (f"{t_def * 1e3:.4f} ms" if t_def is not None else "not measured")
                + f"); measured ms {{{measured}}}; predicted {e['predicted_s'] * 1e3:.4f} ms, "
                f"fused={e['fuse_want_q']}")
        for m, n in shapes:
            acc = tune_case.accounting(table["entries"], m, n, batch=P)
            tune_case.check_accounting(acc)
            log(f"[autotune] {P} x {m} x {n}: predicted bytes and dispatches equal the "
                f"observed, 0 warm traces: " + ", ".join(
                    f"{k} {r['observed_read_bytes']}+{r['observed_write_bytes']} B"
                    for k, r in acc.items()))

        # the bitwise contracts with the table installed
        ops = self.ops
        a = self.randn(MAIN_SHAPES[HEADLINE], 4101)
        n_ = a.shape[-1]
        w = self.randn((P, n_, n_), 4102) / n_
        q1, g_fused = ops.fused_apply_gram(a, w, use_pallas=True)
        g_unfused = ops.gram(ops.apply_right(a, w, use_pallas=True), use_pallas=True)
        check(self.same_bits(g_fused, g_unfused), "tuned: fused G' != gram(apply_right)")
        _, r_fused = ops.cholesky_qr2(a, use_pallas=True)
        _, r_split = ops.cholesky_qr2(a, use_pallas=True, fused=False)
        check(self.same_bits(r_fused, r_split), "tuned: fused CholeskyQR2 R != unfused")
        del a, w, q1
        p_, m_, n_ = BLOCKED_SHAPES["general_full"]
        b = at.trailing_panel_width(n_)
        at_, qt = self.randn((p_, m_, n_), 4103), self.randn((p_, m_, b), 4104)
        wt = self.randn((p_, b, n_), 4105) / n_
        a_new, s = ops.trailing_update(at_, qt, wt, next_width=b, use_pallas=True)
        check(self.same_bits(s, ops.panel_cross(a_new, split=b, use_pallas=True)),
              "tuned: trailing_update's S != panel_cross(A_new)")
        del at_, qt, wt, a_new, s
        tuned = {}
        for k, (x, cfg, limit) in cfgs.items():
            tuned[k] = factorize(x, cfg).r
            t = truth[k]
            err = max(((tuned[k][i].double() - t).abs().max() / t.abs().max()).item()
                      for i in range(P))
            check(err <= limit, f"tuned {k}: R rel err {err:.3e} > {limit}")
            log(f"[autotune] tuned {k} {tuple(x.shape)}: R rel err {err:.3e} (limit {limit}); "
                f"R {'==' if self.same_bits(tuned[k], untuned[k]) else '!='} the untuned R")
        eager = factorize(blk, dataclasses.replace(cfgs["blocked"][1], pipeline="off")).r
        check(self.same_bits(eager, tuned["blocked"]), "tuned: blocked pipeline != eager")
        log("[autotune] tuned: fused ≡ unfused (G' and R), S ≡ panel_cross(A_new), "
            "pipeline ≡ eager, bit for bit")

        # an explicit split reaches the kernels; the planner takes the constants
        seen = []
        real = _launch.cross_split

        def spy(batch, m, rows_per_split=None):
            out = real(batch, m, rows_per_split)
            seen.append(out[0])
            return out

        _launch.cross_split = spy
        try:
            # issued eagerly: when the tuner's winner for this geometry is
            # TUNED_SPLIT, the tuned run above captured the same program,
            # whose replay calls no kernel wrapper for the spy to see
            with replay.eager():
                explicit = factorize(blk, dataclasses.replace(cfgs["blocked"][1],
                                                              block_rows=TUNED_SPLIT)).r
            torch.cuda.synchronize()
        finally:
            _launch.cross_split = real
        untuned_rows = real(P, BLOCKED_SHAPES["general_full"][1])[0]
        check(seen and set(seen) == {TUNED_SPLIT} != {untuned_rows},
              f"QRConfig(block_rows={TUNED_SPLIT}): the kernels took splits {set(seen)}")
        t = truth["blocked"]
        err = max(((explicit[i].double() - t).abs().max() / t.abs().max()).item()
                  for i in range(P))
        check(err <= R_TIGHT_BLOCKED, f"block_rows={TUNED_SPLIT}: R rel err {err:.3e}")
        model = CostModel.tuned()
        check((model.mem_bw_bytes_per_s, model.flops_per_s)
              == (mc["mem_bw_bytes_per_s"], mc["flops_per_s"]),
              "CostModel.tuned() did not take the table's constants")
        log(f"[autotune] QRConfig(block_rows={TUNED_SPLIT}): {len(seen)} cross launches at "
            f"{TUNED_SPLIT} rows a split (untuned {untuned_rows}), R rel err {err:.3e}; "
            f"CostModel.tuned() takes the table's bandwidth and rate")

        at.clear()
        check(CostModel.tuned() == CostModel(), "CostModel.tuned() != CostModel() after clear")
        for k, (x, cfg, _) in cfgs.items():
            check(self.same_bits(factorize(x, cfg).r, untuned[k]),
                  f"after clear(): {k} R differs from the untuned run's")
        log("[autotune] after clear(): TSQR and blocked R equal the untuned runs' bit for bit")
        del tsqr, blk, untuned, tuned, eager, explicit, truth
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        rc = bench_main(["run", "--tier", "smoke", "--out", str(BENCH_OUT)])
        bench = json.loads(BENCH_OUT.read_text())
        for name, c in sorted(bench["cases"].items()):
            t_ms = c.get("metrics", {}).get("time_mean_us", {}).get("value", float("nan")) / 1e3
            log(f"[bench] smoke {name}: {c['status']} ({len(c.get('metrics', {}))} metrics, "
                f"{t_ms:.1f} ms) {c.get('error', '')}")
        bad = {n: c["status"] for n, c in bench["cases"].items() if c["status"] != "ok"}
        check(rc == 0 and not bad, f"bench smoke tier: rc {rc}, not ok: {bad}")
        check(not at.installed(), "the bench's autotune case left a table installed")
        log(f"[bench] smoke tier: {len(bench['cases'])} cases ok in "
            f"{time.perf_counter() - t0:.1f} s on {bench['card']}")
        self.bench_full()
        self.latency()
        self.retrace_guard()
        log(f"[bench] phase 12 took {time.perf_counter() - t_phase:.1f} s")

    def bench_full(self) -> None:
        """The full tier of every registered case through ``python -m
        repro_torch.bench run --tier full`` (its ``main``), one case a call
        so that the port kernels' launches are read around each; the cases
        whose blocked QR runs on the kernels must launch them."""
        from repro_torch.bench.__main__ import main as bench_main
        from repro_torch.bench.registry import REGISTRY

        counts = self.dispatch.launches
        t0 = time.perf_counter()
        names = sorted(REGISTRY)
        check(len(names) == 16, f"the bench registry holds {len(names)} cases, not 16")
        card = None
        for name in names:
            out = BENCH_FULL_DIR / f"{name}.json"
            self.torch.cuda.synchronize()
            counts.reset()
            t_case = time.perf_counter()
            rc = bench_main(["run", "--tier", "full", "--only", name, "--out", str(out)])
            self.torch.cuda.synchronize()
            case_s = time.perf_counter() - t_case
            made = {k: v for k, v in counts.as_dict().items() if v}
            doc = json.loads(out.read_text())
            card, c = doc["card"], doc["cases"][name]
            log(f"[bench] full {name}: {c['status']}, {len(c.get('metrics', {}))} metrics, "
                f"{case_s:.1f} s; port-kernel launches {made} {c.get('error', '')}")
            check(rc == 0 and c["status"] == "ok", f"bench full tier {name}: rc {rc}, {c}")
            if name in BENCH_BLOCKED:
                check(made.get("trailing_update") and made.get("gram")
                      and (made.get("panel_cross") or made.get("pad_cross")),
                      f"bench {name}: the blocked QR did not launch trailing_update, "
                      f"panel_cross or pad_cross, and gram: {made}")
            self.torch.cuda.empty_cache()
        log(f"[bench] full tier: {len(names)} cases ok in {time.perf_counter() - t0:.1f} s "
            f"on {card}")

    def latency(self) -> None:
        """The blocked QR's factorization latency at general_full through
        the dispatch case's ``run``, held to the case's gates and to
        pipeline ≡ eager bit for bit."""
        from repro_torch.bench.cases import dispatch as case

        counts = self.dispatch.launches
        counts.reset()
        t0 = time.perf_counter()
        rows = case.run(**LATENCY_RUN)
        self.torch.cuda.synchronize()
        case.check(rows)
        shape = f"{LATENCY_RUN['p']} x {LATENCY_RUN['m_local']} x {LATENCY_RUN['n']}"
        log(f"[latency] dispatch.run at {shape}, panels of {LATENCY_RUN['panel_width']} "
            f"(K = {rows['n_panels']}), batch {rows['batch']} on {self.card_name}: "
            f"time_pipeline_p50_us {rows['time_pipeline_p50_us']:.1f} (PERF.md §5's profile "
            f"of one call: {LATENCY_PROFILED_MS['pipeline']} ms), time_eager_p50_us "
            f"{rows['time_eager_p50_us']:.1f} (PERF.md §5: {LATENCY_PROFILED_MS['eager']} ms); "
            f"traces {rows['traces_first']} then {rows['traces_second']}, dispatches a call "
            f"{rows['dispatches_cold']} (K = {rows['n_panels_half_width']}: "
            f"{rows['dispatches_half_width']}), batched {rows['dispatches_batched']}, eager "
            f"kernel dispatches {rows['eager_kernel_dispatches']}; eager_rel_err "
            f"{rows['eager_rel_err']:.3e}, batch_rel_err {rows['batch_rel_err']:.3e} (limit "
            f"{case.BATCH_TOL}), bit_identical_eager {rows['bit_identical_eager']}; "
            f"launches {counts.as_dict()}; {time.perf_counter() - t0:.1f} s")
        check(rows["bit_identical_eager"], "general_full: pipeline != eager bit for bit")
        check(rows["dispatches_batched"] == 1 and rows["allreduce_retrace"] == 0,
              f"general_full: batched dispatches {rows['dispatches_batched']}, allreduce "
              f"retraces {rows['allreduce_retrace']}")
        self.torch.cuda.empty_cache()

    def retrace_guard(self) -> None:
        """``python -m repro_torch.bench.cases.dispatch --guard``'s body on
        the card: no guarded entry point builds a program on its second
        call."""
        from repro_torch.bench.cases import dispatch as case

        t0 = time.perf_counter()
        failures = case.guard()
        self.torch.cuda.synchronize()
        log(f"[retrace-guard] {failures} entry point(s) re-traced on {self.card_name} "
            f"({time.perf_counter() - t0:.1f} s)")
        check(failures == 0, f"the retrace guard counted {failures} re-traced entry points")

    # -- phase 6: combine_gram ----------------------------------------------

    def combine_gram_path(self) -> None:
        """Drive the kernel's entry point, ``ops.combine_gram(use_pallas=
        True)``, at 8 × n × n in f32 and bf16 with the counts set to 0 just
        before and read just after; then hold every output against the plain
        version, and at n = 512 (f32) against a float64 product, for exact
        symmetry and for the same bits on a rerun."""
        torch, ref = self.torch, self.ref
        counts = self.dispatch.launches
        inputs = {}
        for dtype in (torch.float32, torch.bfloat16):
            for n in COMBINE_WIDTHS:
                inputs[(dtype, n)] = tuple(self.randn((P, n, n), 600 + n + i, dtype)
                                           for i in (0, 1))
        torch.cuda.synchronize()
        counts.reset()
        outs = {key: self.ops.combine_gram(r1, r2, use_pallas=True)
                for key, (r1, r2) in inputs.items()}
        torch.cuda.synchronize()
        self.launches["combine_gram"] = counts.as_dict()
        check(counts.combine_gram == len(inputs), f"combine_gram launches {counts.as_dict()}, "
              f"want {len(inputs)}")
        for (dtype, n), g in outs.items():
            dname = str(dtype).removeprefix("torch.")
            r1, r2 = inputs[(dtype, n)]
            err = self.rel_err(g, ref.combine_gram(r1, r2))
            sym = torch.equal(g, g.mT)
            rerun = torch.equal(self.kernels["combine_gram"](r1, r2), g)
            line = f"[combine_gram] {dname} (8, {n}, {n}) rel err {err:.2e} symmetric {sym} " \
                   f"rerun {rerun}"
            check(err <= TOL[dname], f"combine_gram {dname} n={n}: rel err {err:.3e} "
                  f"> {TOL[dname]}")
            check(sym, f"combine_gram {dname} n={n}: G is not exactly symmetric")
            check(rerun, f"combine_gram {dname} n={n}: a rerun gives other bits")
            if dtype == torch.float32 and n == max(COMBINE_WIDTHS):
                a64, b64 = r1.double(), r2.double()
                want = a64.mT @ a64 + b64.mT @ b64
                e64 = self.rel_err(g.double(), want)
                p64 = self.rel_err(ref.combine_gram(r1, r2).double(), want)
                line += f"; vs float64 kernel {e64:.2e} plain {p64:.2e}"
                check(e64 <= F64_TOL, f"combine_gram n={n}: {e64:.3e} from float64 > {F64_TOL}")
                self.errors["combine_gram"] = (g - ref.combine_gram(r1, r2)).abs().max().item()
            log(line)
        log(f"[combine_gram] launches over {len(inputs)} ops.combine_gram calls: "
            f"{self.launches['combine_gram']}")

    def combine_gram_timing(self) -> None:
        """combine_gram at 8 × 512 × 512 (at 8 × 128 its bound is launch
        overhead).  Operations: two symmetric Grams, n²(n + 1) each, plus n²
        adds a matrix; bytes: both inputs read and G written once.  No one
        PyTorch call computes the function; the yardstick is two:
        ``torch.baddbmm(r2.mT @ r2, r1.mT, r1)``."""
        torch, ref = self.torch, self.ref
        n = max(COMBINE_WIDTHS)
        r1, r2 = (self.randn((P, n, n), 700 + i) for i in (0, 1))
        two = lambda: torch.baddbmm(r2.mT @ r2, r1.mT, r1)  # noqa: E731
        two_err = self.rel_err(two(), ref.combine_gram(r1, r2))
        check(two_err <= TOL["float32"], f"baddbmm yardstick: {two_err:.3e}")
        row = self.time_row((P, n, n), 4 * P * 3 * n * n, P * (2 * n * n * (n + 1) + n * n),
                            lambda: self.kernels["combine_gram"](r1, r2),
                            lambda: ref.combine_gram(r1, r2), None)
        row["two_calls_ms"] = self.time_ms(two)
        row["library_note"] = "none: no one call; torch.baddbmm(r2.mT @ r2, r1.mT, r1) is two"
        row["ptxas"] = self.ptxas["combine_gram"]
        self.times[("combine_gram", "8x512")] = row
        log(f"[time] combine_gram 8x512 {json.dumps(row)}")

    # -- phase 8: the cached programs (CUDA-graph replay) ---------------------

    def replay_path(self) -> None:
        """The cached programs of ``repro_torch.replay``: the blocked
        pipeline at general_full and general_ragged, the batched TSQR at
        REPLAY_TSQR and ``ft_allreduce_jit`` / ``coded_allreduce_jit``.  For
        each: one capture (trace) on the cold call and none on a warm
        repeat, one dispatch a call, the replay equal bit for bit to the same
        program issued eagerly (``replay.eager()``), the replay's kernel
        launches; then replay and eager times, the cache's bytes and the
        peak of allocated memory."""
        torch = self.torch
        from repro_torch import replay
        from repro_torch.collective import (
            FaultSpec,
            SimComm,
            coded_allreduce,
            coded_allreduce_jit,
            ft_allreduce,
            ft_allreduce_jit,
            make_coded_plan,
        )
        from repro_torch.qr import QRConfig, factorize
        from repro_torch.qr.blocked import PIPELINE_NAME

        d, counts = self.dispatch, self.dispatch.launches
        replay.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts.reset()

        def cold_warm(label, name, fn, want_launches):
            """fn() cold (capture), warm (replay) and inside replay.eager();
            the counts of each, the three results."""
            with d.track_dispatch() as t_cold:
                cold = fn()
            torch.cuda.synchronize()
            before = counts.as_dict()
            with d.track_dispatch() as t_warm:
                warm = fn()
            torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in counts.as_dict().items() if v - before[k]}
            with replay.eager():
                eager = fn()
            torch.cuda.synchronize()
            check(t_cold.traces[name] == 1 and all(
                k == name or k.startswith("kernel:") for k in t_cold.traces),
                f"{label}: cold traces {dict(t_cold.traces)}")
            check(not t_warm.traces, f"{label}: a warm repeat traced {dict(t_warm.traces)}")
            check(t_cold.dispatches[name] == 1 and t_warm.dispatches == {name: 1},
                  f"{label}: dispatches cold {dict(t_cold.dispatches)} warm "
                  f"{dict(t_warm.dispatches)}")
            check(launched == want_launches, f"{label}: replay launched {launched}, want "
                  f"{want_launches}")
            log(f"[replay] {label}: cold {t_cold.as_dict()}; warm {t_warm.as_dict()}; "
                f"replay launches {launched}")
            return cold, warm, eager

        for seed, (name, shape) in enumerate(REPLAY_BLOCKED.items(), 5000):
            a = self.randn(shape, seed)
            cfg = QRConfig(panel_width=PANEL, use_pallas=True)
            k_panels = -(-a.shape[-1] // PANEL)
            prime = "pad_cross" if a.shape[-1] < k_panels * PANEL else "panel_cross"
            label = f"blocked pipeline {name} {tuple(a.shape)}"
            cold, warm, eager = cold_warm(label, PIPELINE_NAME, lambda a=a: factorize(a, cfg), {
                prime: 1, "trailing_update": k_panels - 1, "gram": k_panels})
            for what, res in (("replay", warm), ("capture call", cold)):
                check(torch.equal(res.r, eager.r) and torch.equal(res.valid, eager.valid),
                      f"{label}: {what} != eager-issued pipeline")
            log(f"[replay] {label}: replay == capture call == eager-issued pipeline bit for bit")
            self.profile(f"{label} replay", lambda a=a: factorize(a, cfg))
            with replay.eager():
                self.profile(f"{label} eager", lambda a=a: factorize(a, cfg))
            self.replay_times(label, lambda a=a: factorize(a, cfg))
            del a, cold, warm, eager

        cfg = QRConfig(local_r="cqr2_pallas")
        for seed, (name, shape) in enumerate(REPLAY_TSQR.items(), 5010):
            a = self.randn(shape, seed)
            label = f"batched TSQR {name} {tuple(a.shape)}"
            cold, warm, eager = cold_warm(label, "tsqr_batched", lambda a=a: factorize(a, cfg),
                                          {"gram": 1, "fused_apply_gram": 1})
            for what, res in (("replay", warm), ("capture call", cold)):
                check(torch.equal(res.r, eager.r), f"{label}: {what} != eager")
            log(f"[replay] {label}: replay == capture call == eager bit for bit")
            self.profile(f"{label} replay", lambda a=a: factorize(a, cfg))
            with replay.eager():
                self.profile(f"{label} eager", lambda a=a: factorize(a, cfg))
            self.replay_times(label, lambda a=a: factorize(a, cfg))
            del a

        x = self.randn((P, 128, 128), 5003)
        comm = SimComm(P, x.device)
        for op in ("sum", "gram_sum"):
            label = f"ft_allreduce_jit {op} {tuple(x.shape)}"
            cold, warm, eager = cold_warm(label, "ft_allreduce",
                                          lambda op=op: ft_allreduce_jit(x, comm, op=op), {})
            plain = ft_allreduce(x, comm, op=op)
            for what, res in (("replay", warm), ("capture call", cold), ("eager", eager)):
                check(all(self.same_bits(g, w) for g, w in zip(res, plain)),
                      f"{label}: {what} != ft_allreduce")
            log(f"[replay] {label}: replay == ft_allreduce bit for bit")
        world = SimComm(P + BLOCKED_PARITY, x.device)
        xw = self.randn((P + BLOCKED_PARITY, 128, 128), 5004)
        for faults in (None, {1: 0, 6: 1}):
            plan = make_coded_plan(P, BLOCKED_PARITY, FaultSpec.of(faults) if faults else None)
            label = f"coded_allreduce_jit sum c={BLOCKED_PARITY} deaths={faults or {}}"
            cold, warm, eager = cold_warm(label, "coded_allreduce", lambda plan=plan:
                                          coded_allreduce_jit(xw, world, plan=plan), {})
            plain = coded_allreduce(xw, world, plan=plan)
            for what, res in (("replay", warm), ("capture call", cold), ("eager", eager)):
                check(all(self.same_bits(g, w) for g, w in zip(res, plain)),
                      f"{label}: {what} != coded_allreduce")
            log(f"[replay] {label}: replay == coded_allreduce bit for bit")
        self.launches["replay"] = counts.as_dict()
        log(f"[replay] cached programs hold {replay.cache_bytes()} bytes; peak allocated "
            f"{torch.cuda.max_memory_allocated()} bytes; cache {replay.stats()} (evictions past "
            f"an entry point's count bound, graphs dropped past the memory bound, recaptures)")

    def replay_times(self, label: str, fn) -> None:
        """Host-clock medians of the replay and of the eager-issued program."""
        from repro_torch import replay

        med, lo, hi = self._median_ms(fn)
        with replay.eager():
            fn()
            e_med, e_lo, e_hi = self._median_ms(fn)
        self.replay_ms[label] = (med, e_med)
        log(f"[e2e] {label}: replay median {med:.3f} ms (min {lo:.3f}, max {hi:.3f}); eager "
            f"median {e_med:.3f} ms (min {e_lo:.3f}, max {e_hi:.3f}), 5 runs each")

    # -- phase 8b: the coded scheme ------------------------------------------

    def _ortho(self, q) -> float:
        torch = self.torch
        q = q.double()
        return (torch.einsum("pmi,pmj->ij", q, q)
                - torch.eye(q.shape[-1], dtype=torch.float64, device=DEVICE)).abs().max().item()

    def _median_ms(self, fn) -> tuple[float, float, float]:
        """Median, min and max of 5 warm host-clock runs ending in a
        synchronize."""
        torch = self.torch
        samples = []
        for i in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i:
                samples.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(samples), min(samples), max(samples)

    def coded_tsqr_path(self) -> None:
        """Coded TSQR (``local_r="cqr2_pallas"``, c = 3) at powersgd_panel:
        fault-free R equal to the redundant butterfly's bit for bit, the
        wire of the collective equal to the plan's, deaths (the gather root
        among them), stragglers, silent corruption through ``observed=``,
        an over-budget loss, ``compute_q``; at paper_fig, c = 1..3
        fault-free equal to the butterfly.  Launches counted from 0."""
        torch = self.torch
        from repro_torch.collective import (
            FaultSpec,
            InstrumentedComm,
            SimComm,
            execute_coded,
            execute_plan,
            make_coded_plan,
            make_plan,
            reconstruction_tol,
        )
        from repro_torch.qr import QRConfig, factorize
        from repro_torch.qr import tsqr as tsqr_mod

        counts = self.dispatch.launches
        kern = "cqr2_pallas"
        coded = QRConfig(local_r=kern, redundancy="coded", parity=CODED_PARITY)
        fly = QRConfig(local_r=kern)
        tol = reconstruction_tol(torch.float32)
        a = self.randn(MAIN_SHAPES[HEADLINE], 1001)
        small = self.randn(MAIN_SHAPES["paper_fig"], 1000)
        torch.cuda.synchronize()

        counts.reset()
        base = factorize(a, fly)
        res = factorize(a, coded)
        torch.cuda.synchronize()
        tag = f"coded {HEADLINE} {tuple(a.shape)} c={CODED_PARITY}"
        check(torch.equal(res.r, base.r), f"{tag}: fault-free coded R != butterfly R")
        check(bool(res.valid.all()) and not bool(res.detected.any()),
              f"{tag}: fault-free valid={res.valid.tolist()} detected={res.detected.tolist()}")
        log(f"[coded] {tag} fault-free: R == redundant butterfly R bit for bit, all valid, "
            f"nothing detected")
        scale = base.r[0].abs().max().item()

        def faulted(label, want_launches, **kw):
            before = counts.as_dict()
            out = tsqr_mod._factorize_sim(a, coded, **kw)
            torch.cuda.synchronize()
            delta = {k: v - before[k] for k, v in counts.as_dict().items() if v - before[k]}
            check(delta == want_launches, f"{tag} {label}: launches {delta}, want "
                  f"{want_launches}")
            check((out.valid.cpu().numpy() == out.plan.final_valid[:P]).all(),
                  f"{tag} {label}: validity {out.valid.tolist()} != plan")
            return out, delta

        one = {"gram": 1, "fused_apply_gram": 1}
        for label, spec in (("deaths {0, 2, 4} at step 0", FaultSpec.of({0: 0, 2: 0, 4: 0})),
                            ("stragglers {2, 5}", FaultSpec.of({}, slow=(2, 5)))):
            out, delta = faulted(label, one, fault_spec=spec)
            err = max(((out.r[i] - base.r[0]).abs().max() / scale).item() for i in range(P))
            check(bool(out.valid.all()), f"{tag} {label}: a data rank is invalid")
            check(err <= tol, f"{tag} {label}: R {err:.3e} from fault-free > {tol:.3e}")
            check(not bool(out.detected.any()), f"{tag} {label}: detected {out.detected}")
            log(f"[coded] {tag} {label}: all valid, R rel err vs fault-free {err:.2e} "
                f"(limit {tol:.2e}) launches {delta}")
        observed = a.clone()
        observed[6] *= 3.0
        out, delta = faulted("SDC on rank 6", {"gram": 2, "fused_apply_gram": 2},
                             fault_spec=FaultSpec.of({}, corrupt=(6,)), observed=observed)
        del observed
        flagged = out.detected.nonzero().flatten().tolist()
        err = ((out.r[0] - base.r[0]).abs().max() / scale).item()
        check(flagged == [6], f"{tag} SDC: detected ranks {flagged}, want [6]")
        check(err <= tol, f"{tag} SDC: R {err:.3e} from fault-free > {tol:.3e}")
        log(f"[coded] {tag} SDC on rank 6 (observed x3): detected {flagged}, R rel err vs "
            f"fault-free {err:.2e} launches {delta}")
        out, delta = faulted("four deaths", one,
                             fault_spec=FaultSpec.of({0: 0, 1: 0, 3: 0, 5: 0}))
        check(not bool(out.valid.any()) and bool(torch.isnan(out.r).all()),
              f"{tag} four deaths: some rank valid or R not NaN")
        log(f"[coded] {tag} four deaths (budget {CODED_PARITY}): no valid rank, R all NaN "
            f"launches {delta}")
        before = counts.as_dict()
        out = factorize(a, dataclasses.replace(coded, compute_q=True))
        torch.cuda.synchronize()
        ortho = self._ortho(out.q)
        check(ortho <= ORTHO_TOL, f"{tag} compute_q: ||QᵀQ − I|| {ortho:.3e} > {ORTHO_TOL}")
        delta = {k: v - before[k] for k, v in counts.as_dict().items() if v - before[k]}
        check(delta == {"gram": 2, "fused_apply_gram": 1}, f"{tag} compute_q: launches {delta}")
        log(f"[coded] {tag} compute_q: ||QᵀQ−I||={ortho:.2e} launches {delta}")
        del out
        for c in (1, 2, 3):
            got = factorize(small, QRConfig(local_r=kern, redundancy="coded", parity=c))
            want = factorize(small, fly)
            check(torch.equal(got.r, want.r), f"coded paper_fig c={c}: R != butterfly R")
        log(f"[coded] paper_fig {tuple(small.shape)} c=1..3 fault-free: R == redundant "
            f"butterfly R bit for bit")
        self.launches["coded"] = counts.as_dict()
        log(f"[coded] launches over the coded TSQR runs: {self.launches['coded']}")

        # the collective's wire, observed against each plan
        pf = coded.factorizer()
        plan = make_coded_plan(P, CODED_PARITY)
        comm = InstrumentedComm(SimComm(plan.n_ranks, a.device))
        execute_coded(a, comm, plan, pf.combiner())
        fly_comm = InstrumentedComm(SimComm(P, a.device))
        execute_plan(a, fly_comm, make_plan("redundant", P), pf.combiner())
        unit = a.shape[-1] ** 2 * 4
        units = comm.stats.payload_bytes // unit
        check((comm.stats.messages, units) == (plan.message_count(), plan.payload_units()),
              f"coded wire: {comm.stats.messages} messages, {units} units; plan "
              f"{plan.message_count()}, {plan.payload_units()}")
        check(comm.stats.payload_bytes == plan.bytes_on_wire(a.shape[-1]), "coded wire bytes")
        log(f"[coded] wire at c={CODED_PARITY}: {comm.stats.messages} messages, {units} payload "
            f"units, {comm.stats.payload_bytes} B (plan {plan.message_count()}, "
            f"{plan.payload_units()}); redundant butterfly {fly_comm.stats.messages} messages, "
            f"{fly_comm.stats.payload_bytes} B")

        self.profile(f"coded TSQR {HEADLINE} {tuple(a.shape)} c={CODED_PARITY}",
                     lambda: factorize(a, coded))
        for name, x in ((HEADLINE, a), ("paper_fig", small)):
            for label, cfg, faults in (
                    ("redundant butterfly", fly, None),
                    ("redundant butterfly, rank 5 dead at exchange 1", fly,
                     FaultSpec.of({5: 1})),
                    (f"coded c={CODED_PARITY}", coded, None),
                    (f"coded c={CODED_PARITY}, ranks 0, 2, 4 dead", coded,
                     FaultSpec.of({0: 0, 2: 0, 4: 0}))):
                med, lo, hi = self._median_ms(lambda: factorize(x, cfg, faults=faults))
                log(f"[e2e] coded-vs-butterfly TSQR {name} {tuple(x.shape)} {label}: median "
                    f"{med:.3f} ms (min {lo:.3f}, max {hi:.3f}, 5 runs)")

    def coded_blocked_path(self) -> None:
        """The coded blocked QR at general_full (c = 2, ``use_pallas``):
        fault-free R equal to the eager butterfly driver's bit for bit (as
        in the reference), a panel-phase death of two ranks, an
        update-phase death, a declared-corrupt rank; validity as the plans
        give it, R against the float64 Householder R, ``detected`` all
        False (nothing is perturbed), the eager driver's launches."""
        import numpy as np

        torch = self.torch
        from repro_torch.collective import FaultSpec
        from repro_torch.qr import PanelFaultSchedule, QRConfig, factorize

        counts = self.dispatch.launches
        a, truth = self.blocked_full
        cfg = QRConfig(panel_width=PANEL, use_pallas=True, redundancy="coded",
                       parity=BLOCKED_PARITY)
        eager = QRConfig(panel_width=PANEL, use_pallas=True, pipeline="off")
        schedules = {
            None: None,
            "panel {1: ranks 3, 6 dead}": PanelFaultSchedule.of(panel={1: {3: 0, 6: 0}}),
            "update {0: rank 5 dead at 1}": PanelFaultSchedule.of(update={0: {5: 1}}),
            "panel {0: rank 2 declared corrupt}": PanelFaultSchedule.of(
                panel={0: FaultSpec.of({}, corrupt=(2,))}),
        }
        base = factorize(a, eager)
        torch.cuda.synchronize()
        counts.reset()
        for label, sched in schedules.items():
            before = counts.as_dict()
            res = factorize(a, cfg, faults=sched)
            torch.cuda.synchronize()
            delta = {k: v - before[k] for k, v in counts.as_dict().items()}
            tag = f"coded blocked general_full {tuple(a.shape)} c={BLOCKED_PARITY} " \
                  f"faults={label}"
            k_panels = res.n_panels
            want = dict.fromkeys(delta, 0)
            want.update(panel_cross=1, trailing_update=k_panels - 1, gram=k_panels)
            check(delta == want, f"{tag}: launches {delta}, want {want}")
            expect = np.ones(P, bool)
            for rep in res.reports:
                for plan in (rep.plan_r, rep.plan_w):
                    if plan is not None:
                        expect &= plan.final_valid[:P]
            valid = res.valid.cpu().numpy()
            check((valid == expect).all() and expect.all(),
                  f"{tag}: validity {valid} != plans {expect}")
            check(not bool(res.detected.any()), f"{tag}: detected {res.detected.tolist()}")
            err = max(((res.r[i].double() - truth).abs().max() / truth.abs().max()).item()
                      for i in range(P))
            check(err <= R_TOL, f"{tag}: R rel err {err:.3e} > {R_TOL}")
            line = f"[coded blocked] {tag} all valid, nothing detected, R rel err {err:.2e}"
            if sched is None:
                check(torch.equal(res.r, base.r), f"{tag}: R != eager butterfly R")
                line += ", == eager butterfly bit for bit"
            log(line + f" launches {({k: v for k, v in delta.items() if v})}")
        self.launches["coded_blocked"] = counts.as_dict()
        log(f"[coded blocked] launches over {len(schedules)} factorizations: "
            f"{self.launches['coded_blocked']}")
        self.profile(f"coded blocked general_full {tuple(a.shape)} c={BLOCKED_PARITY}",
                     lambda: factorize(a, cfg))
        for label, c, faults in (
                ("butterfly, eager", eager, None),
                ("butterfly, pipeline", QRConfig(panel_width=PANEL, use_pallas=True), None),
                ("butterfly, eager, panel {1: rank 5 dead at 1}", eager,
                 PanelFaultSchedule.of(panel={1: {5: 1}})),
                (f"coded c={BLOCKED_PARITY}", cfg, None),
                (f"coded c={BLOCKED_PARITY}, panel {{1: ranks 3, 6 dead}}", cfg,
                 schedules["panel {1: ranks 3, 6 dead}"])):
            med, lo, hi = self._median_ms(lambda: factorize(a, c, faults=faults))
            log(f"[e2e] coded-vs-butterfly blocked general_full {tuple(a.shape)} {label}: "
                f"median {med:.3f} ms (min {lo:.3f}, max {hi:.3f}, 5 runs)")

    def scenarios(self) -> None:
        """The stock collective and blocked fault scenarios on the card,
        with their guarantee fields checked."""
        from repro_torch.bench.scenarios import get_scenarios, run_scenario

        guarantees = ("values_match", "survived", "corruption_detected",
                      "honest_degradation", "wire_matches_plan", "survivors_match_plan")
        for sc in get_scenarios():
            if sc.kind == "trainer":          # phase 11 runs them at olmo-1b's widths
                continue
            metrics = run_scenario(sc, seed=0, device=DEVICE)
            for key in guarantees:
                if key in metrics:
                    check(metrics[key].value is True, f"scenario {sc.name}: {key} is "
                          f"{metrics[key].value}")
            log(f"[scenario] {sc.name} ({sc.kind}): " + json.dumps(
                {k: m.value for k, m in metrics.items()}))

    # -- phase 7: QR serving ----------------------------------------------------

    def machine_constants(self) -> tuple[float, float]:
        """The card's copy bandwidth (bytes read and written a second, over a
        1 GiB device-to-device copy) and f32 product rate (an 8192³ product,
        TF32 off), each the median of CUDA-event times."""
        torch = self.torch
        src = torch.empty(1 << 28, device=DEVICE)
        dst = torch.empty_like(src)
        copy_ms = self.time_ms(lambda: dst.copy_(src))
        bandwidth = 2 * src.numel() * 4 / (copy_ms * 1e-3)
        del src, dst
        n = 8192
        a, b = self.randn((n, n), 6000), self.randn((n, n), 6001)
        mm_ms = self.time_ms(lambda: a @ b, repeats=5, inner=3)
        flops = 2 * n ** 3 / (mm_ms * 1e-3)
        del a, b
        return bandwidth, flops

    def card_stream(self, buckets, n_requests: int, seed: int) -> list:
        """The reference launcher's request shapes (the requests cycle the
        buckets, each (m, n) drawn with its jitter from ``seed``), each
        matrix drawn on the card from its own seed and copied to the host."""
        import numpy as np

        rng = np.random.default_rng(seed)
        mats = []
        for i in range(n_requests):
            spec = buckets[i % len(buckets)]
            n = int(rng.integers(max(2, spec.n_pad // 2), spec.n_pad + 1))
            m = int(rng.integers(n, spec.m_pad - (spec.n_pad - n) + 1))
            mats.append(self.randn((m, n), 7000 + i).cpu().numpy())
        return mats

    @contextlib.contextmanager
    def tapped_primes(self):
        """For every prime (``panel_cross`` or ``pad_cross``) launched while
        a graph is captured in the block: hold its S, so that nothing later
        in the graph reuses S's memory, and note the address of its
        partials.  Yields a list of (op, part address, part shape, S)."""
        from repro_torch.kernels import _launch, ops

        torch = self.torch
        taps, parts = [], []
        launch = _launch.launch
        kernels = {"panel_cross": ops._panel_cross_kernel, "pad_cross": ops._pad_cross_kernel}

        def tapped(name, device, *args):
            if name in kernels and torch.cuda.is_current_stream_capturing():
                if name == "panel_cross":
                    _, part, _, _, batch, _, n, split, _, _, _, splits = args
                else:
                    _, _, part, _, _, batch, _, _, split, n, _, _, _, splits = args
                parts.append((part, (batch, splits, split, n)))
            return launch(name, device, *args)

        def holding(name):
            def call(*args, **kw):
                out = kernels[name](*args, **kw)
                if torch.cuda.is_current_stream_capturing():
                    taps.append((name, *parts.pop(), out if name == "panel_cross" else out[1]))
                return out
            return call

        _launch.launch = tapped
        ops._panel_cross_kernel, ops._pad_cross_kernel = holding("panel_cross"), holding(
            "pad_cross")
        try:
            yield taps
        finally:
            _launch.launch = launch
            ops._panel_cross_kernel, ops._pad_cross_kernel = kernels.values()

    def at_address(self, address: int, shape: tuple):
        """A float32 tensor over device memory at ``address`` (a graph's
        buffer, which its pool keeps while the graph lives)."""
        class View:
            __cuda_array_interface__ = {"shape": shape, "typestr": "<f4", "data": (address, False),
                                        "version": 3, "strides": None}
        return self.torch.as_tensor(View(), device=DEVICE)

    @contextlib.contextmanager
    def held_kernels(self):
        """Hold every call of the blocked QR's kernels (``panel_cross``,
        ``pad_cross``, ``trailing_update``, and ``gram`` for Q's polish) in
        the block on its own operands as it is made: against its plain
        version and a float64 product.  Yields a map (kernel, operand
        shapes, statics) -> [calls, max error against the plain version,
        max error against float64]; the kernel's result is returned as
        made, so the run is the one it checks."""
        from repro_torch.kernels import ops
        from repro_torch.qr import panel

        torch, ref = self.torch, self.ref
        found: dict[tuple, list] = {}

        def note(name, operands, statics, plain_err, f64_err):
            key = (name, tuple(tuple(t.shape) for t in operands), statics)
            row = found.setdefault(key, [0, 0.0, 0.0])
            row[0] += 1
            row[1], row[2] = max(row[1], plain_err), max(row[2], f64_err)

        def cross64(x, split):
            x64 = x.double()
            return x64[..., :split].mT @ x64

        def gram(kernel):
            def call(a, **kw):
                g = kernel(a, **kw)
                note("gram", (a,), (), self.rel_err(g, ref.gram(a)),
                     self.rel_err(g.double(), cross64(a, a.shape[-1])))
                return g
            return call

        def panel_cross(kernel):
            def call(a, *, split, **kw):
                s = kernel(a, split=split, **kw)
                note("panel_cross", (a,), (split,),
                     self.rel_err(s, ref.panel_cross(a, split=split)),
                     self.rel_err(s.double(), cross64(a, split)))
                return s
            return call

        def pad_cross(kernel):
            def call(a, *, split, out_width, **kw):
                a_pad, s = kernel(a, split=split, out_width=out_width, **kw)
                want = ref.pad_cross(a, split=split, out_width=out_width)
                note("pad_cross", (a,), (split, out_width),
                     max(self.rel_err(a_pad, want[0]), self.rel_err(s, want[1])),
                     self.rel_err(s[..., :a.shape[-1]].double(), cross64(a, split)))
                return a_pad, s
            return call

        def trailing_update(kernel):
            def call(a, q, w, *, next_width=0, out=None, **kw):
                got = kernel(a, q, w, next_width=next_width, out=out, **kw)
                want = ref.trailing_update(a, q, w, next_width=next_width)
                a_new, s = (got if next_width else (got, None))
                exact = a.double() - q.double() @ w.double()
                if next_width:
                    plain = max(self.rel_err(a_new, want[0]), self.rel_err(s, want[1]))
                    f64 = max(self.rel_err(a_new.double(), exact),
                              self.rel_err(s.double(), cross64(a_new, next_width)))
                else:
                    plain, f64 = self.rel_err(a_new, want), self.rel_err(a_new.double(), exact)
                note("trailing_update", (a, q, w), (next_width,), plain, f64)
                return got
            return call

        patches = [(panel, "gram", gram),
                   (ops, "_panel_cross_kernel", panel_cross),
                   (ops, "_pad_cross_kernel", pad_cross),
                   (ops, "_trailing_kernel", trailing_update)]
        saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
        for mod, attr, wrap in patches:
            setattr(mod, attr, wrap(getattr(mod, attr)))
        try:
            yield found
        finally:
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)

    def serving_path(self) -> None:
        """``QRServer`` on the card (``use_pallas=True``: each drain one CUDA-
        graph replay of the batched pipeline on the kernels).  For each
        stream: ``prewarm()``; the stream with a death every third drain;
        zero new traces, evictions and recaptures over it; one pipeline
        dispatch a drain; the prime and trailing launches of every drain and
        re-serve; each R against numpy's; each re-served R against a
        fault-free eager re-run bit for bit.  Then, for each bucket, its
        first drain's batch: the replay's R against the same program
        issued eagerly (bit for bit) and on the plain route
        (``use_pallas=False``, ``SERVING_PLAIN_TOL``); every kernel call of
        the eagerly issued drain on its own operands against its plain
        version and float64; the drain's host-to-card copy and replay
        timed, and on the card stream the replay profiled."""
        torch = self.torch
        import numpy as np

        from repro_torch import replay
        from repro_torch.launch.serve import synthetic_stream
        from repro_torch.qr import Pipeline, factorize
        from repro_torch.qr.blocked import PIPELINE_NAME
        from repro_torch.serve import BucketSpec, CostModel, PeriodicFaultInjector, QRServer
        from repro_torch.serve.buckets import block_rows, extract_r, pad_request

        d, counts = self.dispatch, self.dispatch.launches
        phase_t0 = time.perf_counter()
        bandwidth, flops = self.machine_constants()
        log(f"[serve] measured on {self.card_name}: copy bandwidth {bandwidth:.4e} B/s, f32 "
            f"product rate {flops:.4e} FLOP/s (TF32 off); the card stream is planned on "
            f"{CARD_MODEL['mem_bw_bytes_per_s']:.4e} B/s and {CARD_MODEL['flops_per_s']:.4e} "
            f"FLOP/s")
        replay.clear()
        for label, cfg in SERVING_STREAMS.items():
            p = cfg["p"]
            buckets = tuple(BucketSpec(*b) for b in cfg["buckets"])
            injector = PeriodicFaultInjector.sampled(SERVING_FAULT_PERIOD, variant="redundant",
                                                     p=p, seed=0)
            server = QRServer(buckets, p=p, model=CostModel(**cfg["model"]),
                              fault_injector=injector, device=DEVICE)
            check(all(c.use_pallas for c in server.configs.values()),
                  f"serve {label}: a config on the card without use_pallas")
            for plan in server.planner_decisions():
                log(f"[serve] {label}: bucket {plan['bucket']}: panel_width="
                    f"{plan['panel_width']} local_r={plan['local_r']} max_batch="
                    f"{plan['max_batch']} predicted drain {plan['predicted_drain_s']:.4e} s")
            t0 = time.perf_counter()
            with self.tapped_primes() as taps:
                traces = server.prewarm()
            log(f"[serve] {label}: prewarm {sum(traces.values())} trace(s) in "
                f"{time.perf_counter() - t0:.2f} s {traces}")
            check(len(taps) == len(server.buckets),
                  f"serve {label}: {len(taps)} primes captured for {len(server.buckets)} buckets")
            t0 = time.perf_counter()
            mats = (self.card_stream(buckets, cfg["requests"], 0) if label == "card"
                    else synthetic_stream(buckets, cfg["requests"], 0))
            log(f"[serve] {label}: {len(mats)} requests drawn in "
                f"{time.perf_counter() - t0:.2f} s")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            stats0, traced0 = replay.stats(), d.trace_count()
            counts.reset()
            t0 = time.perf_counter()
            responses = server.serve(mats)
            wall = time.perf_counter() - t0
            launched = counts.as_dict()
            self.launches[f"serving {label}"] = launched
            warm = d.trace_count() - traced0
            stats = {k: v - stats0[k] for k, v in replay.stats().items()}
            s = server.stats
            check(warm == 0, f"serve {label}: the warm stream traced {warm}")
            check(stats["evictions"] == 0 and stats["recaptures"] == 0,
                  f"serve {label}: the warm stream's cache {stats}")
            check(s.dispatches_per_drain == [1] * s.drains,
                  f"serve {label}: {PIPELINE_NAME} dispatches a drain {s.dispatches_per_drain}")
            check(len(responses) == len(mats) == s.served, f"serve {label}: served {s.served}")
            # the prime and K - 1 trailing sweeps of every drain and re-serve
            drains = {r.drain_index: r.bucket for r in responses}
            runs = list(drains.values()) + [r.bucket for r in responses
                                            if r.served_via == "reserved"]
            want_prime = len(runs)
            want_trailing = sum(-(-spec.n_pad // server.plans[spec].panel_width) - 1
                                for spec in runs)
            check(len(drains) == s.drains and
                  launched["panel_cross"] + launched["pad_cross"] == want_prime and
                  launched["trailing_update"] == want_trailing,
                  f"serve {label}: launches {launched}, want prime {want_prime} trailing "
                  f"{want_trailing}")
            t0 = time.perf_counter()
            err = 0.0
            for resp, a in zip(responses, mats):
                r_np = np.linalg.qr(a, mode="r")
                sign = np.sign(np.diag(r_np))
                sign[sign == 0] = 1.0
                r_ref = (r_np.T * sign).T
                err = max(err, float(np.abs(resp.r - r_ref).max()
                                     / max(1.0, np.abs(r_ref).max())))
            check(err <= SERVING_R_TOL, f"serve {label}: max R error {err:.3e}")
            numpy_s = time.perf_counter() - t0
            reserved = [r for r in responses if r.served_via == "reserved"]
            for resp in reserved:
                a = mats[resp.rid]
                cfg_off = dataclasses.replace(server.configs[resp.bucket], pipeline=Pipeline.OFF)
                rerun = factorize(block_rows(pad_request(a, resp.bucket), p), cfg_off,
                                  device=DEVICE)
                r_rerun = extract_r(rerun.r[0].cpu().numpy(), a.shape[1])
                check(np.array_equal(resp.r.view(np.int32), r_rerun.view(np.int32)),
                      f"serve {label}: re-served request {resp.rid} != its fault-free re-run")
            lat_ms = np.array([r.latency_s for r in responses]) * 1e3
            log(f"[serve] {label}: served {s.served} requests in {wall:.3f} s "
                f"({s.served / wall:.1f} req/s), {s.drains} drains ({s.faulted_drains} "
                f"faulted, {s.reserved} re-served, {s.filler_slots} filler slots); "
                f"dispatches/drain {sorted(set(s.dispatches_per_drain))}; latency p50 "
                f"{np.percentile(lat_ms, 50):.3f} ms p99 {np.percentile(lat_ms, 99):.3f} ms")
            log(f"[serve] {label}: warm-stream traces {warm}, cache {stats}; launches "
                f"{launched} (prime {want_prime}, trailing {want_trailing} wanted); max R error "
                f"{err:.3e} (limit {SERVING_R_TOL}; numpy's QRs {numpy_s:.2f} s); "
                f"{len(reserved)} re-served R equal to their fault-free eager re-runs bit for bit")
            log(f"[serve] {label}: cached programs hold {replay.cache_bytes()} bytes; peak "
                f"allocated over the stream {torch.cuda.max_memory_allocated()} bytes")
            for spec, tap in zip(server.buckets, taps):
                self.serving_drain(label, server, spec, [
                    a for a in mats if server.bucket_of(*a.shape) == spec], tap)
            del server, responses, mats, taps
            torch.cuda.empty_cache()
        log(f"[serve] phase took {time.perf_counter() - phase_t0:.1f} s")

    def serving_drain(self, label: str, server, spec, mats: list, tap: tuple) -> None:
        """One bucket's first drain batch (its first ``max_batch`` requests
        of the stream, padded, topped up with fillers), on the card: the
        warm replay's R equal to the same program issued eagerly bit for
        bit and within ``SERVING_PLAIN_TOL`` of the plain route's; every
        kernel call of the eager drain held on its own operands
        (:meth:`held_kernels`); where nothing reads the prime's S (one
        panel, no Cholesky local R), so R cannot vouch for it, the graph's
        prime buffers (``tap``) poisoned before a replay and its S held to
        the kernel's S of the same operand after it; the host-to-card copy
        and the replay timed; on the card stream the replay profiled."""
        torch = self.torch
        import numpy as np

        from repro_torch import replay
        from repro_torch.qr import factorize
        from repro_torch.serve.buckets import block_rows, filler_matrix, pad_request

        counts = self.dispatch.launches
        p, plan, config = server.p, server.plans[spec], server.configs[spec]
        padded = [pad_request(a, spec) for a in mats[:plan.max_batch]]
        padded += [filler_matrix(spec)] * (plan.max_batch - len(padded))
        batch = np.stack([block_rows(m, p) for m in padded])
        dev = torch.from_numpy(batch).to(DEVICE)
        tag = f"{label}: drain {spec.m_pad} x {spec.n_pad} x {plan.max_batch} " \
              f"(width {plan.panel_width})"
        traced0 = self.dispatch.trace_count()
        r_replay = factorize(dev, config, device=DEVICE).r
        check(self.dispatch.trace_count() == traced0, f"serve {tag}: the warm replay traced")
        before = counts.as_dict()
        with self.held_kernels() as held, replay.eager():
            r_eager = factorize(dev, config, device=DEVICE).r
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in counts.as_dict().items() if v != before[k]}
        held_calls = collections.Counter()
        for (name, _, _), (calls, _, _) in held.items():
            held_calls[name] += calls
        check(launched == dict(held_calls), f"serve {tag}: launched {launched}, held {held_calls}")
        check(self.same_bits(r_eager, r_replay), f"serve {tag}: replay R != eager-issued R")
        with replay.eager():
            r_plain = factorize(dev, dataclasses.replace(config, use_pallas=False),
                                device=DEVICE).r
        plain_err = self.rel_err(r_replay, r_plain)
        log(f"[serve] {tag}: replay R == eager-issued R bit for bit; vs the plain route "
            f"{plain_err:.3e} (limit {SERVING_PLAIN_TOL}); kernel calls {launched}")
        check(plain_err <= SERVING_PLAIN_TOL,
              f"serve {tag}: R {plain_err:.3e} from the plain route > {SERVING_PLAIN_TOL}")
        for (name, shapes, statics), (calls, perr, ferr) in held.items():
            log(f"[serve] {tag}: {name} {shapes} {statics} x{calls}: vs plain {perr:.2e}, "
                f"vs float64 {ferr:.2e}")
            check(perr <= TOL["float32"], f"serve {tag}: {name} {shapes}: {perr:.3e} from "
                  f"its plain version > {TOL['float32']}")
            check(ferr <= F64_TOL, f"serve {tag}: {name} {shapes}: {ferr:.3e} from float64 "
                  f"> {F64_TOL}")
        del r_eager, r_plain, held
        if -(-spec.n_pad // plan.panel_width) == 1 and plan.local_r != "chol":
            op, part_at, part_shape, s = tap
            part = self.at_address(part_at, part_shape)
            part.fill_(float("nan"))
            s.fill_(float("nan"))
            factorize(dev, config, device=DEVICE)
            x = dev.transpose(0, 1).contiguous()
            b = plan.panel_width
            want = (self.kernels[op](x, split=b) if op == "panel_cross" else
                    self.kernels[op](x, split=b, out_width=spec.n_pad)[1])
            torch.cuda.synchronize()
            check(self.same_bits(s, want),
                  f"serve {tag}: the graph's {op} node left S != {op} of its operand")
            log(f"[serve] {tag}: nothing reads the prime's S; the graph's {op} buffers "
                f"(partials {part_shape}, S {tuple(s.shape)}, held through the capture) "
                f"poisoned with NaN before a replay: S == {op} of the graph's operand bit for "
                f"bit after it")
            del part, x, want
        times = [self._median_ms(fn) for fn in (
            lambda: torch.from_numpy(batch).to(DEVICE),
            lambda: factorize(dev, config, device=DEVICE))]
        log(f"[serve] {tag} (host clock, median, min, max of 5): "
            + "; ".join(f"{what} {med:.3f} ms ({lo:.3f}, {hi:.3f})" for what, (med, lo, hi)
                        in zip(("host-to-card copy", "replay"), times)))
        if label == "card":
            self.profile(f"serving drain replay {spec.m_pad} x {spec.n_pad} x {plan.max_batch}",
                         lambda: factorize(dev, config, device=DEVICE))

    # -- phase 8b: optimizers, checkpoints, data --------------------------------

    def optim_path(self) -> None:
        """The FT optimizers, the checkpoint layer and the data pipeline at
        olmo-1b's widths (``self.olmo``), with the launch counts read around the
        phase: no port kernel runs on this path.  Each check fails the run
        past its limit; each step is timed on the card."""
        torch = self.torch
        counts = self.dispatch.launches
        phase_t0 = time.perf_counter()
        counts.reset()
        self.psgd_checks()
        params, grads = self.optimizer_steps()
        self.checkpoint_checks(params, grads)
        self.data_checks()
        torch.cuda.synchronize()
        self.launches["optim"] = counts.as_dict()
        log(f"[optim] launches in this phase: {self.launches['optim']}")
        check(not any(self.launches["optim"].values()),
              f"the optimizer path launched a port kernel: {self.launches['optim']}")
        log(f"[optim] phase took {time.perf_counter() - phase_t0:.1f} s")

    def step_time(self, label: str, fn, note: str = "") -> None:
        med, lo, hi = self._median_ms(fn)
        log(f"[optim] time {label} on {self.card_name}: median {med:.3f} ms (min {lo:.3f}, "
            f"max {hi:.3f}, 5 warm runs){note}")

    def psgd_checks(self) -> None:
        """PowerSGD's ``compress_mean_grad`` over R replicas (ft fault-free,
        ft with slot 5 dead at exchange 1, dense; exact on a rank-r mean;
        the card against the port's CPU run on a small input),
        ``compress_grad`` with error feedback on SimComm(P), and
        ``ft_cqr2_q`` on a d_ff x 128 block over 8 shards."""
        torch = self.torch
        from repro_torch.collective import FaultSpec, SimComm, make_plan
        from repro_torch.optim import lowrank, powersgd
        from repro_torch.optim.ftqr import ft_cqr2_q

        R, r, m, n = OPTIM_REPLICAS, PSGD_RANK, self.olmo["d_ff"], self.olmo["d_model"]
        cfg = powersgd.PowerSGDConfig(rank=r)
        death = make_plan("redundant", R, FaultSpec.of({5: 1}))
        tag = f"{R} x {m} x {n}, rank {r}"
        q0 = self.randn((n, r), 701)
        g_rep = self.randn((R, m, n), 700)
        g_ft, q_ft = powersgd.compress_mean_grad(g_rep, q0, cfg=cfg)
        g_dead, _ = powersgd.compress_mean_grad(g_rep, q0, cfg=cfg, plan=death)
        g_dense, q_dense = powersgd.compress_mean_grad(g_rep, q0, cfg=cfg, ft=False)
        torch.cuda.synchronize()
        check(g_ft.shape == (m, n) and q_ft.shape == (n, r) and bool(g_ft.isfinite().all()),
              f"compress_mean_grad {tag}: shape {tuple(g_ft.shape)} or non-finite values")
        errs = {"ft vs dense": self.rel_err(g_ft, g_dense),
                "new q ft vs dense": self.rel_err(q_ft, q_dense),
                "slot 5 dead vs fault-free": self.rel_err(g_dead, g_ft)}
        log(f"[optim] compress_mean_grad {tag}, full-rank replica gradients: "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + f" (limit {PSGD_TOL}); the death's plan final_valid "
            f"{death.final_valid.astype(int).tolist()}, its ĝ bit for bit the fault-free one: "
            f"{self.same_bits(g_dead, g_ft)}")
        for k, v in errs.items():
            check(v <= PSGD_TOL, f"compress_mean_grad {tag}: {k} {v:.3e} > {PSGD_TOL}")
        self.step_time(f"compress_mean_grad ft {tag}",
                       lambda: powersgd.compress_mean_grad(g_rep, q0, cfg=cfg))
        self.step_time(f"compress_mean_grad ft, slot 5 dead, {tag}",
                       lambda: powersgd.compress_mean_grad(g_rep, q0, cfg=cfg, plan=death))
        self.step_time(f"compress_mean_grad dense {tag}",
                       lambda: powersgd.compress_mean_grad(g_rep, q0, cfg=cfg, ft=False))
        log(f"[optim] compress_mean_grad reads {g_rep.numel() * 4} bytes of replica gradients "
            f"and sends {4 * r * (m + n)} bytes a replica compressed against {4 * m * n} dense "
            f"(the {R} replicas' gradients take no less than "
            f"{g_rep.numel() * 4 / PEAK_BYTES * 1e3:.3f} ms to read at {PEAK_BYTES:.3g} B/s)")
        del g_rep, g_dead, g_dense

        u, v = self.randn((m, r), 702), self.randn((R, n, r), 703)
        g_low = torch.einsum("mr,Rnr->Rmn", u, v)                # the mean has rank <= r
        mean64 = g_low.double().mean(0)
        exact = {label: self.rel_err(powersgd.compress_mean_grad(g_low, q0, cfg=cfg, **kw)[0]
                                     .double(), mean64)
                 for label, kw in (("ft", {}), ("ft, slot 5 dead", {"plan": death}),
                                   ("dense", {"ft": False}))}
        log(f"[optim] compress_mean_grad {tag} on a rank-{r} mean: ĝ against the float64 mean "
            + ", ".join(f"{k} {e:.3e}" for k, e in exact.items()) + f" (limit {PSGD_TOL})")
        for k, e in exact.items():
            check(e <= PSGD_TOL, f"compress_mean_grad {k} not exact on a rank-{r} mean: {e:.3e}")
        del g_low, mean64

        small = self.randn((R, 256, 128), 709)
        small_q = self.randn((128, r), 710)
        on_card, _ = powersgd.compress_mean_grad(small, small_q, cfg=cfg)
        on_cpu, _ = powersgd.compress_mean_grad(small.cpu(), small_q.cpu(), cfg=cfg)
        err = self.rel_err(on_card.cpu(), on_cpu)
        log(f"[optim] compress_mean_grad {R} x 256 x 128: the card against the port's CPU run "
            f"{err:.3e} (limit {PSGD_TOL})")
        check(err <= PSGD_TOL, f"compress_mean_grad card vs CPU {err:.3e} > {PSGD_TOL}")

        # compress_grad with error feedback: the d_ff x d_model gradient
        # row-distributed over P model ranks, a decaying spectrum (32 modes
        # at 0.8^k) plus noise, fed 8 rounds
        ml = m // P
        comm = SimComm(P, DEVICE)

        def psum_model(x):
            return x.sum(0, keepdim=True).expand(x.shape)

        def psum_data(x):
            return x

        modes = 0.8 ** torch.arange(32, device=DEVICE, dtype=torch.float32)
        g = ((self.randn((m, 32), 704) * modes) @ self.randn((n, 32), 705).T
             + 0.01 * self.randn((m, n), 706)).reshape(P, ml, n)
        gen = torch.Generator(device=DEVICE).manual_seed(707)
        state0 = powersgd.init_state(gen, (ml, n), cfg, leading=(P,), device=DEVICE)
        state, acc, resid = state0, torch.zeros_like(g), []
        g_norm = torch.linalg.norm(g).item()
        for i in range(8):
            g_hat, state, stats = powersgd.compress_grad(g, state, comm, cfg=cfg,
                                                         psum_data=psum_data,
                                                         psum_model=psum_model, n_data=1)
            acc += g_hat
            resid.append(torch.linalg.norm(g - acc / (i + 1)).item() / g_norm)
        want_bytes = (4 * r * (ml * P + n), 4 * ml * P * n)
        got_bytes = (stats["data_bytes_compressed"], stats["data_bytes_dense"])
        log(f"[optim] compress_grad with error feedback on SimComm({P}) at {P} x {ml} x {n}, "
            f"rank {r}: ‖g − mean ĝ‖/‖g‖ over 8 rounds "
            + ", ".join(f"{x:.4f}" for x in resid)
            + f"; data bytes a round {got_bytes[0]} compressed, {got_bytes[1]} dense")
        check(resid[-1] < 0.9 and resid[-1] < resid[0],
              f"error feedback did not reduce the residual: {resid}")
        check(got_bytes == want_bytes, f"compress_grad byte counts {got_bytes} != {want_bytes}")
        check(bool(stats["valid"].all()), f"compress_grad fault-free validity {stats['valid']}")
        spec = FaultSpec.of({5: 1})
        base, _, _ = powersgd.compress_grad(g, state0, comm, cfg=cfg, psum_data=psum_data,
                                            psum_model=psum_model, n_data=1)
        for variant in ("redundant", "selfhealing"):
            vcfg = powersgd.PowerSGDConfig(rank=r, variant=variant)
            got, _, st = powersgd.compress_grad(g, state0, comm, cfg=vcfg, psum_data=psum_data,
                                                psum_model=psum_model, n_data=1, fault_spec=spec)
            plan = make_plan(variant, P, spec)
            valid = st["valid"].cpu().numpy()
            line = (f"[optim] compress_grad {variant}, rank 5 dead at exchange 1: valid "
                    f"{valid.astype(int).tolist()} (the plan's {plan.final_valid.astype(int).tolist()})")
            check((valid == plan.final_valid).all(), line)
            if valid.all():
                err = self.rel_err(got, base)
                line += f", ĝ against the fault-free round {err:.3e} (limit {PSGD_TOL})"
                check(err <= PSGD_TOL, line)
            else:
                line += (f", NaN in {int(got.isnan().sum())} of {got.numel()} entries (an invalid "
                         "rank's R reaches every rank through form_q's Gram all-reduce, as in the "
                         "reference)")
            log(line)
        self.step_time(f"compress_grad round {P} x {ml} x {n}",
                       lambda: powersgd.compress_grad(g, state0, comm, cfg=cfg,
                                                      psum_data=psum_data,
                                                      psum_model=psum_model, n_data=1))
        del g, acc, state, state0, base

        a = self.randn((m, 128), 708)
        qh, rh = torch.linalg.qr(a.double())
        q64 = qh * torch.where(rh.diagonal() < 0, -1.0, 1.0).double()
        eye = torch.eye(128, dtype=torch.float64, device=DEVICE)
        runs = {"ft_cqr2_q (8 shards)": lambda: ft_cqr2_q(a, 8),
                "ft_cqr2_q (8 shards, shard 5 dead at exchange 1)":
                    lambda: ft_cqr2_q(a, 8, plan=death),
                "gram_cqr2_q": lambda: lowrank.gram_cqr2_q(a)}
        for label, fn in runs.items():
            q = fn().double()
            ortho = (q.mT @ q - eye).abs().max().item()
            err = self.rel_err(q, q64)
            log(f"[optim] {label} at {m} x 128: ‖QᵀQ − I‖max {ortho:.3e} (limit {ORTHO_TOL}), "
                f"Q against float64 {err:.3e} (limit {F64_TOL})")
            check(ortho <= ORTHO_TOL and err <= F64_TOL, f"{label}: {ortho:.3e}, {err:.3e}")
            self.step_time(f"{label} {m} x 128", fn)

    def optimizer_steps(self):
        """An AdamW, a low-rank (a refresh step, then a plain one) and an
        OrthoSGD step on one layer's weights; AdamW and the low-rank state
        against the port's CPU run of the same step, the low-rank basis
        orthonormal with the update in its span, the OrthoSGD direction
        orthonormal.  Returns the AdamW step's parameters and gradients."""
        torch = self.torch
        from repro_torch.optim import adamw, lowrank, orthosgd

        d, ff = self.olmo["d_model"], self.olmo["d_ff"]
        shapes = {"attn_q": (d, d), "attn_k": (d, d), "attn_v": (d, d), "attn_o": (d, d),
                  "mlp_gate": (d, ff), "mlp_up": (d, ff), "mlp_down": (ff, d)}
        params = {k: self.randn(s, 720 + i) * 0.02 for i, (k, s) in enumerate(shapes.items())}
        grads = {k: self.randn(s, 740 + i) for i, (k, s) in enumerate(shapes.items())}
        cpu_p = {k: v.cpu() for k, v in params.items()}
        cpu_g = {k: v.cpu() for k, v in grads.items()}
        n_params = sum(p.numel() for p in params.values())
        log(f"[optim] one olmo-1b layer: {n_params} parameters ({n_params * 4} bytes in f32)")

        def delta(new, old):
            return new.double() - old.double()

        a_cfg = adamw.AdamWConfig(warmup=0)
        new_p, a_state, metrics = adamw.update(a_cfg, params, grads, adamw.init(params))
        want_p, want_state, _ = adamw.update(a_cfg, cpu_p, cpu_g, adamw.init(cpu_p))
        errs = {}
        for k in shapes:
            errs[k] = max(self.rel_err(delta(new_p[k], params[k]).cpu(),
                                       delta(want_p[k], cpu_p[k])),
                          self.rel_err(a_state["m"][k].cpu(), want_state["m"][k]),
                          self.rel_err(a_state["v"][k].cpu(), want_state["v"][k]))
        log(f"[optim] adamw step (lr {float(metrics['lr']):.4e}, grad norm "
            f"{float(metrics['grad_norm']):.1f}): the card's update and moments against the "
            f"port's CPU run, worst leaf {max(errs.values()):.3e} (limit {STEP_TOL})")
        check(max(errs.values()) <= STEP_TOL, f"adamw step card vs CPU {errs}")
        self.step_time("adamw step, one layer",
                       lambda: adamw.update(a_cfg, params, grads, adamw.init(params)))

        # The low-rank update does not read the weights, so it steps zero
        # weights here: the new weights are then the update, unrounded.
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}
        l_cfg = lowrank.LowRankConfig()
        l0 = lowrank.init(zeros, l_cfg)
        p1, l1 = lowrank.update(l_cfg, zeros, grads, l0)
        want1 = lowrank.update(l_cfg, cpu_p, cpu_g, lowrank.init(cpu_p, l_cfg))[1]
        worst = {}
        for k in shapes:
            st, want = l1["per_param"][k], want1["per_param"][k]
            b = st["basis"].double()
            step = p1[k].double()
            span = (step - step @ b @ b.mT).abs().max().item() / step.abs().max().item()
            ortho = (b.mT @ b - torch.eye(b.shape[-1], dtype=torch.float64, device=DEVICE)
                     ).abs().max().item()
            state_err = max(self.rel_err(st[x].cpu(), want[x]) for x in ("basis", "m", "v"))
            worst[k] = (ortho, span, state_err, tuple(st["m"].shape))
            check(ortho <= ORTHO_TOL and span <= STEP_TOL and state_err <= PSGD_TOL,
                  f"lowrank refresh step on {k}: ‖BᵀB − I‖ {ortho:.3e}, update outside the "
                  f"basis {span:.3e}, state vs CPU {state_err:.3e}")
        log("[optim] lowrank refresh step, by leaf (‖BᵀB − I‖max, update outside span(B), "
            "basis/moments against the port's CPU run, moment shape): "
            + json.dumps({k: [f"{a:.2e}", f"{b:.2e}", f"{c:.2e}", list(s)]
                          for k, (a, b, c, s) in worst.items()})
            + f" (limits {ORTHO_TOL}, {STEP_TOL}, {PSGD_TOL})")
        p2, l2 = lowrank.update(l_cfg, p1, grads, l1)
        check(all(torch.equal(l2["per_param"][k]["basis"], l1["per_param"][k]["basis"])
                  for k in shapes), "the low-rank basis changed on a step without a refresh")
        check(all(bool(p2[k].isfinite().all()) for k in shapes), "lowrank step 2: non-finite")
        self.step_time("lowrank step with the basis refresh, one layer",
                       lambda: lowrank.update(l_cfg, zeros, grads, l0))
        self.step_time("lowrank step, one layer", lambda: lowrank.update(l_cfg, p1, grads, l1))
        del p1, p2, l1, l2, l0, zeros

        o_cfg = orthosgd.OrthoSGDConfig()
        o_state = orthosgd.init(params)
        po, _ = orthosgd.update(o_cfg, params, grads, o_state)
        orth = {}
        for k in shapes:
            eff = grads[k] + o_cfg.momentum * grads[k]           # nesterov, first step
            q = orthosgd._orth_update(eff).double()
            mm, nn = q.shape
            q = q / (max(mm, nn) / nn) ** 0.5
            gram = q.mT @ q if mm >= nn else q @ q.mT
            ortho = (gram - torch.eye(gram.shape[0], dtype=torch.float64, device=DEVICE)
                     ).abs().max().item()
            took = (delta(po[k], params[k]) + o_cfg.lr * orthosgd._orth_update(eff).double())
            off = took.abs().max().item() / (o_cfg.lr * q.abs().max().item())
            orth[k] = (ortho, off)
            check(ortho <= ORTHO_SGD_TOL and off <= STEP_TOL,
                  f"orthosgd step on {k}: ‖QᵀQ − I‖ {ortho:.3e}, step off its direction {off:.3e}")
        log("[optim] orthosgd step, by leaf (‖QᵀQ − I‖max of the direction, the step off "
            "−lr·Q): " + json.dumps({k: [f"{a:.2e}", f"{b:.2e}"] for k, (a, b) in orth.items()})
            + f" (limits {ORTHO_SGD_TOL}, {STEP_TOL})")
        self.step_time("orthosgd step, one layer",
                       lambda: orthosgd.update(o_cfg, params, grads, o_state))
        self.step_time("orthosgd step with ft_shards=8, one layer",
                       lambda: orthosgd.update(orthosgd.OrthoSGDConfig(ft_shards=8), params,
                                               grads, o_state))
        return {"params": new_p, "adamw": a_state}, grads

    def checkpoint_checks(self, state, grads) -> None:
        """The AdamW step's parameters and state saved asynchronously and
        blocking, restored on the card bit for bit, keep-k GC; a BuddyStore
        of the gradients' rows on the card, recovered bit for bit after
        2^2 - 1 deaths."""
        import shutil

        torch = self.torch
        from repro_torch.checkpoint import BuddyStore, CheckpointManager
        from repro_torch.optim._tree import leaves

        root = Path(__file__).resolve().parent / "build" / "smoke_checkpoints"
        shutil.rmtree(root, ignore_errors=True)
        mgr = CheckpointManager(str(root), keep=2)
        nbytes = sum(t.numel() * t.element_size() for t in leaves(state))
        try:
            t0 = time.perf_counter()
            mgr.save(1, state)
            block_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            mgr.save(2, state, {"save": "async"}, block=False)
            returned = time.perf_counter() - t0
            mgr.wait()
            async_s = time.perf_counter() - t0
            check(mgr.steps() == [1, 2], f"checkpoints on disk: {mgr.steps()}")
            mgr.save(3, state, block=False)
            mgr.wait()
            check(mgr.steps() == [2, 3], f"keep=2 left steps {mgr.steps()}")
            t0 = time.perf_counter()
            restored, meta = mgr.restore(state, step=2)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            check(meta == {"save": "async", "step": 2, "n_arrays": len(leaves(state))},
                  f"manifest {meta}")
            for got in (restored, mgr.restore(state)[0]):
                same = all(a.device == b.device and (self.same_bits(a, b) if a.is_floating_point()
                                                     else torch.equal(a, b))
                           for a, b in zip(leaves(got), leaves(state)))
                check(same, "the restored checkpoint differs from the saved state")
        finally:
            mgr.wait()
            shutil.rmtree(root, ignore_errors=True)
        log(f"[optim] checkpoint of {nbytes} bytes (one layer's AdamW step: parameters, m, v): "
            f"the async-saved steps 2 and 3 restored on the card bit for bit; keep=2 kept [2, 3]")
        log(f"[optim] checkpoint on {self.card_name}: async save returned in "
            f"{returned * 1e3:.1f} ms and was on disk in {async_s:.3f} s "
            f"({nbytes / async_s / 1e6:.1f} MB/s); blocking save {block_s:.3f} s "
            f"({nbytes / block_s / 1e6:.1f} MB/s); restore to the card {restore_s:.3f} s "
            f"({nbytes / restore_s / 1e6:.1f} MB/s)")

        rows = grads["mlp_down"].reshape(P, -1, grads["mlp_down"].shape[-1])
        store = BuddyStore(P)
        store.checkpoint(1, {r: rows[r] for r in range(P)}, levels=2)
        for dead in (0, 3, 5):
            store.fail(dead)
        back = [store.recover(r) for r in range(P)]
        check(all(s == 1 and self.same_bits(x, rows[r]) for r, (s, x) in enumerate(back)),
              "BuddyStore lost a shard within 2^2 - 1 deaths")
        log(f"[optim] BuddyStore({P}) on the card, 2 levels: ranks 0, 3, 5 dead, every shard "
            f"recovered bit for bit, copies left {[store.copies(r) for r in range(P)]}")

    def data_checks(self) -> None:
        """SyntheticCorpus at olmo-1b's vocab and a 2048-token context: the
        card's batch equal to the host's, shards composing into the global
        batch, tokens in range, labels shifted; the prefetcher's batches and
        its thread gone after close."""
        torch = self.torch
        from repro_torch.data import DataConfig, Prefetcher, SyntheticCorpus

        cfg = DataConfig(vocab=self.olmo["vocab"], seq_len=self.olmo["seq_len"], global_batch=DATA_BATCH)
        corpus = SyntheticCorpus(cfg, device=DEVICE)
        for step in range(2):
            full = corpus.batch(step)
            host = corpus.host_batch(step)
            shards = [corpus.batch(step, shard=s, n_shards=P)["tokens"] for s in range(P)]
            tok = full["tokens"]
            check(tok.device.type == torch.device(DEVICE).type
                  and tok.shape == (DATA_BATCH, self.olmo["seq_len"])
                  and tok.dtype == torch.int32, f"batch {tok.device} {tuple(tok.shape)}")
            check(torch.equal(tok.cpu(), torch.from_numpy(host["tokens"].copy()))
                  and torch.equal(full["labels"].cpu(), torch.from_numpy(host["labels"].copy())),
                  "the card's batch differs from the host's")
            check(torch.equal(torch.cat(shards), tok), "the shards do not compose the batch")
            check(torch.equal(tok[:, 1:], full["labels"][:, :-1]), "labels are not shifted")
            check(0 <= int(tok.min()) and int(tok.max()) < self.olmo["vocab"], "token out of range")
        pf = Prefetcher(corpus, start_step=0, depth=2)
        try:
            got = [pf.next() for _ in range(4)]
        finally:
            pf.close()
        check(not pf._thread.is_alive(), "the prefetcher's thread outlived close()")
        check([s for s, _ in got] == [0, 1, 2, 3]
              and all(torch.equal(b["tokens"], corpus.batch(s)["tokens"]) for s, b in got),
              "the prefetcher's batches differ from the corpus's")
        log(f"[optim] data at vocab {self.olmo['vocab']}, seq_len {self.olmo['seq_len']}, global batch "
            f"{DATA_BATCH} in {P} shards: the card's batches equal the host's, the shards "
            f"compose, the prefetcher delivered steps 0-3 and its thread is gone after close()")
        tokens = DATA_BATCH * self.olmo["seq_len"]
        self.step_time(f"data batch (host build + handover, {tokens} tokens)",
                       lambda: corpus.batch(5))
        self.step_time(f"data shard (1 of {P})", lambda: corpus.batch(5, shard=3, n_shards=P))

    # -- phase 10: model serving -------------------------------------------------

    def model_path(self) -> None:
        """The model zoo served on the card (``repro_torch.models`` through
        the launcher's ``--mode model`` path: the transformers, Mamba2,
        Zamba2 and Whisper), with the launch
        counts read around the phase: no port kernel runs on this path.
        bf16 products accumulate in f32 here, as the reference's do."""
        torch = self.torch
        counts = self.dispatch.launches
        phase_t0 = time.perf_counter()
        matmul = torch.backends.cuda.matmul
        reduced = matmul.allow_bf16_reduced_precision_reduction
        matmul.allow_bf16_reduced_precision_reduction = False
        counts.reset()
        try:
            self.model_launcher()
            self.model_zoo()
            self.model_checks()
        finally:
            matmul.allow_bf16_reduced_precision_reduction = reduced
        torch.cuda.synchronize()
        self.launches["model"] = counts.as_dict()
        log(f"[model] launches in this phase: {self.launches['model']}")
        check(not any(self.launches["model"].values()),
              f"the model path launched a port kernel: {self.launches['model']}")
        log(f"[model] phase took {time.perf_counter() - phase_t0:.1f} s")

    def log_run(self, run, b: int, s: int, gen: int, label: str, vocab: int,
                base: int) -> None:
        """The serving run's times, rates and peak memory (above ``base``,
        what the process held before the model's weights); its ids in range
        and its last logits finite."""
        torch = self.torch
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        log(f"[model] {run.arch} {label} on {self.card_name}: prefill({b}x{s}) "
            f"{run.t_prefill * 1e3:.3f} ms ({b * s / run.t_prefill:.0f} tokens/s), decode {gen} "
            f"steps {run.t_decode * 1e3:.3f} ms ({run.t_decode / gen * 1e3:.3f} ms/token, "
            f"{b * gen / run.t_decode:.1f} tokens/s), peak memory {peak:.2f} GB")
        check(tuple(run.ids.shape) == (b, gen) and 0 <= int(run.ids.min())
              and int(run.ids.max()) < vocab, f"{run.arch}: generated ids {tuple(run.ids.shape)}")
        check(run.logits.dtype == torch.float32 and bool(run.logits.isfinite().all()),
              f"{run.arch}: non-finite logits")

    def model_launcher(self) -> None:
        """qwen3-0.6b at its published config through ``run_model``, the
        body of ``python -m repro_torch.launch.serve --mode model --full``:
        a cold run (first calls of each shape), then a warm one."""
        torch = self.torch
        from repro_torch.launch import serve

        args = serve.parse_args(MODEL_LAUNCH + ["--device", DEVICE])
        for label in ("cold", "warm"):
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            run = serve.run_model(args)
            self.log_run(run, args.batch, args.prompt_len, args.gen,
                         f"{label}, {' '.join(MODEL_LAUNCH)}",
                         self.configs.get_config(args.arch).vocab, base)
        log(f"[model] arch={run.arch} prefill({args.batch}x{args.prompt_len})="
            f"{run.t_prefill*1e3:.1f}ms decode {args.gen} steps={run.t_decode*1e3:.1f}ms "
            f"({run.t_decode/args.gen*1e3:.2f} ms/tok)")
        log(f"[model] generated ids[0]: {run.ids[0].tolist()}")
        # where a warm prefill and one decode step spend device time (the
        # launcher's parameters and batch, drawn again from seed 0)
        from repro_torch.models import api

        cfg = self.configs.get_config(args.arch)
        params = api.init(0, cfg, DEVICE)
        batch = api.synth_batch(0, cfg, "prefill", args.batch, args.prompt_len, DEVICE)
        s_max = args.prompt_len + args.gen
        with torch.inference_mode():
            logits, cache = api.prefill(params, batch, cfg, s_max=s_max)
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            self.profile(f"{args.arch} prefill {args.batch} x {args.prompt_len}",
                         lambda: api.prefill(params, batch, cfg, s_max=s_max))
            self.profile(f"{args.arch} decode step at position {args.prompt_len}",
                         lambda: api.decode_step(params, cache, tok, cfg))
        del params, batch, cache

    def model_zoo(self) -> None:
        """The other architectures at full widths in bf16, each freed
        before the next; the SSM, hybrid and enc-dec ones each read their
        own port-kernel launches."""
        for arch, depth in MODEL_ZOO.items():
            with (self.no_launches("model", f"{arch} bf16 serving") if arch in FAMILY_ARCHS
                  else contextlib.nullcontext()):
                self.zoo_arch(arch, depth)

    def zoo_arch(self, arch: str, depth) -> None:
        """One architecture of ``MODEL_ZOO`` drawn on the card, served cold
        and warm, and freed."""
        torch = self.torch
        from repro_torch.launch.serve import generate
        from repro_torch.models import api
        from repro_torch.optim._tree import leaves

        cfg = self.configs.get_config(arch)
        if depth:
            log(f"[model] {arch}: depth cut from {cfg.n_layers} to {depth} layers "
                f"(its bf16 weights exceed 40 GB at full depth)")
            cfg = dataclasses.replace(cfg, n_layers=depth)
        t0 = time.perf_counter()
        base = torch.cuda.memory_allocated()
        params = api.init(11, cfg, DEVICE)
        batch = api.synth_batch(12, cfg, "prefill", MODEL_BATCH, MODEL_PROMPT, DEVICE)
        torch.cuda.synchronize()
        n = sum(t.numel() for t in leaves(params))
        depth_note = (f"{cfg.n_enc_layers} encoder + " if cfg.family == "encdec" else "")
        log(f"[model] {arch}: {depth_note}{cfg.n_layers} layers, {n / 1e9:.3f} B parameters "
            f"({sum(t.numel() * t.element_size() for t in leaves(params)) / 1e9:.2f} GB "
            f"in {cfg.dtype}), drawn in {time.perf_counter() - t0:.1f} s")
        for label in ("cold", "warm"):
            torch.cuda.reset_peak_memory_stats()
            run = generate(params, batch, cfg, MODEL_GEN, s_max=MODEL_PROMPT + MODEL_GEN)
            self.log_run(run, MODEL_BATCH, MODEL_PROMPT, MODEL_GEN, label, cfg.vocab, base)
        log(f"[model] {arch} generated ids[0]: {run.ids[0].tolist()}")
        if arch in FAMILY_ARCHS:
            # where a warm prefill and one decode step spend device time
            s_max = MODEL_PROMPT + MODEL_GEN
            with torch.inference_mode():
                logits, cache = api.prefill(params, batch, cfg, s_max=s_max)
                tok = logits.argmax(-1)[:, None].to(torch.int32)
                self.profile(f"{arch} prefill {MODEL_BATCH} x {MODEL_PROMPT}",
                             lambda: api.prefill(params, batch, cfg, s_max=s_max))
                self.profile(f"{arch} decode step at position {MODEL_PROMPT}",
                             lambda: api.decode_step(params, cache, tok, cfg))
            del cache
        del params, batch, run
        torch.cuda.empty_cache()

    @contextlib.contextmanager
    def no_launches(self, tag: str, label: str):
        """The port-kernel launches made inside the block, logged and
        required to be none (the SSM, hybrid and enc-dec parts of phases
        10 and 11)."""
        counts = self.dispatch.launches
        before = counts.as_dict()
        yield
        self.torch.cuda.synchronize()
        made = {k: v - before[k] for k, v in counts.as_dict().items()}
        log(f"[{tag}] {label}: port-kernel launches {made}")
        check(not any(made.values()), f"{label} launched a port kernel: {made}")

    @contextlib.contextmanager
    def recorded_routes(self):
        """The MoE routes (expert ids) and dispatch slots that the calls
        inside the block compute, in order."""
        from repro_torch.models import moe

        seen = []
        route, slots = moe._route, moe._dispatch_slots

        def record_route(p, x, cfg):
            w, ids = route(p, x, cfg)
            seen.append(ids)
            return w, ids

        def record_slots(ids, n_experts, cap):
            out = slots(ids, n_experts, cap)
            seen.append(out)
            return out

        moe._route, moe._dispatch_slots = record_route, record_slots
        try:
            yield seen
        finally:
            moe._route, moe._dispatch_slots = route, slots

    def model_checks(self) -> None:
        """Each architecture at full widths in float32, one unit: a forward
        rerun bit for bit; for ``CARD_CPU_ARCHS`` the card against the
        port's CPU run (the MoE at its published capacity, drops included);
        serving ≡ forward; then the ring buffer past its window, mamba2's
        chunked SSD against its recurrence, whisper's frames read.

        A MoE forward at the published capacity factor drops assignments,
        and decode's per-token gather drops none, so the two agree only
        where nothing is dropped (the reference's own test runs at
        ``smoke()``'s capacity factor 4.0).  Serving ≡ forward is checked at
        ``capacity_factor = n_experts / top_k``: each expert's capacity is
        then the whole sequence."""
        for arch in ["qwen3-0.6b", *MODEL_ZOO]:
            with (self.no_launches("model", f"{arch} f32 checks") if arch in FAMILY_ARCHS
                  else contextlib.nullcontext()):
                self.check_arch(arch)

    def one_unit(self, arch: str):
        """The architecture at its published widths in float32, cut to one
        unit: the transformer's repeating pattern, one Mamba layer, one
        zamba2 unit (``attn_every`` Mamba layers and the shared block), one
        whisper encoder and one decoder layer."""
        from repro_torch.models.transformer import unit_pattern

        cfg = dataclasses.replace(self.configs.get_config(arch), dtype="float32")
        if cfg.family == "ssm":
            return dataclasses.replace(cfg, n_layers=1)
        if cfg.family == "hybrid":
            return dataclasses.replace(cfg, n_layers=cfg.attn_every)
        if cfg.family == "encdec":
            return dataclasses.replace(cfg, n_layers=1, n_enc_layers=1)
        return dataclasses.replace(cfg, n_layers=len(unit_pattern(cfg)))

    def check_arch(self, arch: str) -> None:
        """:meth:`model_checks` for one architecture."""
        torch = self.torch
        from repro_torch.models import api, moe
        from repro_torch.optim._tree import map_params

        n = MODEL_CHECK_S + MODEL_CHECK_STEPS
        cfg = self.one_unit(arch)
        params = api.init(21, cfg, DEVICE)
        batch = api.synth_batch(22, cfg, "train", 2, n, DEVICE)
        del batch["labels"]
        with torch.inference_mode(), self.recorded_routes() as routes:
            full = api.forward(params, batch, cfg)
            again = api.forward(params, batch, cfg)
        check(self.same_bits(again, full), f"{arch}: a rerun of forward changed bits")
        routes = routes[:len(routes) // 2]                 # the first forward's
        serve_cfg = cfg
        if cfg.n_experts:
            cap = moe.capacity(cfg, n)
            drops = sum(int((t == cfg.n_experts * cap).sum()) for t in routes[1::2])
            log(f"[model] {arch}: at the published capacity factor {cfg.capacity_factor} "
                f"(capacity {cap} for {n} tokens) forward dropped {drops} of "
                f"{2 * n * cfg.top_k} assignments")
            serve_cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        if arch in CARD_CPU_ARCHS:
            cpu_params = map_params(lambda t: t.cpu(), params)
            cpu_batch = {k: v.cpu() for k, v in batch.items()}
            with torch.inference_mode(), self.recorded_routes() as cpu_routes:
                on_cpu = api.forward(cpu_params, cpu_batch, cfg)
            err = self.rel_err(full.cpu(), on_cpu)
            same = len(routes) == len(cpu_routes) and all(
                torch.equal(a.cpu(), b) for a, b in zip(routes, cpu_routes))
            log(f"[model] {arch} card vs the port's CPU run, same weights and tokens: "
                f"logits {err:.3e} (limit {CARD_CPU_TOL}); MoE expert ids and slots "
                f"(kept and dropped) equal: {same} ({len(cpu_routes)} tensors)")
            check(err <= CARD_CPU_TOL, f"{arch}: card vs CPU {err:.3e}")
            check(same, f"{arch}: the card's MoE routes differ from the CPU's")
            del cpu_params
        if serve_cfg is not cfg:
            with torch.inference_mode():
                full = api.forward(params, batch, serve_cfg)
        errs = self.serve_errors(serve_cfg, params, batch, full, MODEL_CHECK_S - 1)
        s = MODEL_CHECK_S
        depth = (f"{cfg.n_enc_layers} encoder + {cfg.n_layers} decoder layers"
                 if cfg.family == "encdec" else f"{cfg.n_layers} layers")
        log(f"[model] {arch} one unit ({depth}) f32 at full widths, batch 2"
            + (f", capacity factor {serve_cfg.capacity_factor:g}" if cfg.n_experts else "")
            + f": prefill(t[:{s - 1}]) vs forward {errs[0]:.3e}, decode(t[{s - 1}]) "
            f"{errs[1]:.3e} (limit {SERVE_TOL}), {MODEL_CHECK_STEPS} more steps max "
            f"{max(errs[2:]):.3e} (limit {MULTI_TOL}), relative to max|logit|; "
            f"forward rerun bit for bit")
        check(max(errs[:2]) <= SERVE_TOL and max(errs[2:]) <= MULTI_TOL,
              f"{arch}: serving vs forward {errs}")
        if arch == "mixtral-8x22b":
            self.ring_check(dataclasses.replace(serve_cfg, sliding_window=RING_WINDOW),
                            params)
        if cfg.family == "ssm":
            self.ssm_recurrence_check(cfg, params)
        if cfg.family == "encdec":
            self.frames_check(cfg, params, batch, full)
        del params, full, again
        torch.cuda.empty_cache()

    def ssm_recurrence_check(self, cfg, params) -> None:
        """mamba2's chunked SSD against its step-by-step recurrence at a
        ragged length: a prefill of the conv window (``ssm_conv - 1``
        tokens), then one decode step a token; each step's logits against
        forward's, and the recurrent state after the last step against the
        chunked prefill's of the whole sequence."""
        torch = self.torch
        from repro_torch.models import api, ssm

        start, n = cfg.ssm_conv - 1, SSM_RAGGED
        chunk = ssm._chunk_len(n, cfg.ssm_chunk)
        toks = api.synth_batch(24, cfg, "prefill", 2, n, DEVICE)["tokens"]
        with torch.inference_mode():
            full = api.forward(params, {"tokens": toks}, cfg)
            _, chunked = api.prefill(params, {"tokens": toks}, cfg)
            lp, cache = api.prefill(params, {"tokens": toks[:, :start]}, cfg)
            errs = [self.rel_err(lp, full[:, start - 1])]
            for t in range(start, n):
                ld, cache = api.decode_step(params, cache, toks[:, t:t + 1], cfg)
                errs.append(self.rel_err(ld, full[:, t]))
        state_errs = {k: self.rel_err(cache["state"][k], chunked["state"][k])
                      for k in ("ssm", "conv_x", "conv_bc")}
        log(f"[model] mamba2-2.7b chunked SSD vs the step-by-step recurrence, one layer f32 at "
            f"full widths, batch 2 x {n} tokens (chunks of {chunk} at ssm_chunk "
            f"{cfg.ssm_chunk}): prefill of {start} tokens then {n - start} decode steps, "
            f"logits max {max(errs):.3e} (limit {MULTI_TOL}) against forward; final states "
            f"against the chunked prefill's: "
            + ", ".join(f"{k} {v:.3e}" for k, v in state_errs.items())
            + f" (limit {MULTI_TOL}), relative to each one's max")
        check(chunk < cfg.ssm_chunk and n % chunk == 0 and n // chunk > 1,
              f"{n} tokens are not ragged at chunk {cfg.ssm_chunk}")
        check(max(errs) <= MULTI_TOL and max(state_errs.values()) <= MULTI_TOL,
              f"mamba2 chunked vs stepwise: logits {max(errs):.3e}, states {state_errs}")

    def frames_check(self, cfg, params, batch, full) -> None:
        """whisper's logits change when its audio frames change (the
        reference's test_whisper_decode_uses_encoder, at full widths), with
        frames drawn anew: the reference test's frames + 1 shifts every
        frame by a constant, which the encoder's first LayerNorm takes out,
        so it moves the logits by rounding only."""
        torch = self.torch
        from repro_torch.models import api

        other = api.synth_batch(25, cfg, "prefill", *batch["frames"].shape[:1], 1, DEVICE)
        with torch.inference_mode():
            moved = api.forward(params, dict(batch, frames=other["frames"]), cfg)
        diff = self.rel_err(moved, full)
        log(f"[model] whisper-medium: other frames move the logits by {diff:.3e} of "
            f"max|logit| (the decoder reads the encoder through cross-attention)")
        check(diff > 1e-2, f"whisper logits do not follow the frames: {diff:.3e}")

    def serve_errors(self, cfg, params, batch, full, start: int) -> list[float]:
        """Prefill the first ``start`` tokens, then decode each later one:
        the prefill's and every step's logits against ``full`` (forward of
        the whole batch), relative to max|logit|."""
        torch = self.torch
        from repro_torch.models import api

        n = batch["tokens"].shape[1]
        pre = {k: (v[..., :start] if k in ("tokens", "positions") else v)
               for k, v in batch.items()}
        with torch.inference_mode():
            lp, cache = api.prefill(params, pre, cfg, s_max=n)
            errs = [self.rel_err(lp, full[:, start - 1])]
            for t in range(start, n):
                ld, cache = api.decode_step(params, cache, batch["tokens"][:, t:t + 1], cfg)
                errs.append(self.rel_err(ld, full[:, t]))
        return errs

    def ring_check(self, cfg, params) -> None:
        """mixtral's widths with a ``RING_WINDOW``-slot ring: prefill past the
        window (the ring rolled into place), decode on past it again."""
        torch = self.torch
        from repro_torch.models import api

        batch = api.synth_batch(23, cfg, "prefill", 2, RING_END, DEVICE)
        with torch.inference_mode():
            full = api.forward(params, batch, cfg)
        errs = self.serve_errors(cfg, params, batch, full, RING_PREFILL)
        log(f"[model] ring buffer, mixtral-8x22b widths, window {RING_WINDOW}: prefill "
            f"{RING_PREFILL} tokens, decode to {RING_END}: prefill {errs[0]:.3e}, decode max "
            f"{max(errs[1:]):.3e} (limit {MULTI_TOL}) against forward")
        check(max(errs) <= MULTI_TOL, f"ring buffer vs forward {max(errs):.3e}")

    # -- phase 11: training ---------------------------------------------------

    def train_path(self) -> None:
        """The fault-tolerant trainer on the card (``repro_torch.runtime``
        through ``launch/train.py``'s path), with the launch counts read
        around the phase: no port kernel runs on this path.  bf16 products
        accumulate in f32 here, as the reference's do."""
        import shutil

        torch = self.torch
        counts = self.dispatch.launches
        phase_t0 = time.perf_counter()
        matmul = torch.backends.cuda.matmul
        reduced = matmul.allow_bf16_reduced_precision_reduction
        matmul.allow_bf16_reduced_precision_reduction = False
        root = Path(__file__).resolve().parent / "build" / "smoke_train"
        shutil.rmtree(root, ignore_errors=True)
        # the full-depth step needs most of the card: drop the cached
        # programs of the earlier phases (the timings capture theirs again)
        from repro_torch import replay

        replay.clear()
        free, total = torch.cuda.mem_get_info()
        log(f"[train] at the phase's start: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
            f"allocated by earlier phases, {free / 1e9:.2f} of {total / 1e9:.2f} GB free")
        counts.reset()
        try:
            self.train_launcher(root / "launch")
            with self.no_launches("train", "mamba2-2.7b launcher run"):
                self.train_launcher(root / "mamba2", MAMBA_TRAIN, cut=MAMBA_TRAIN_LAYERS)
            with self.no_launches("train", "whisper-medium bf16 step"):
                self.train_whisper_bf16(root / "whisper")
            self.train_scenarios(root)
            self.train_optimizers(root)
            self.train_card_vs_cpu(root / "cpu")
        finally:
            matmul.allow_bf16_reduced_precision_reduction = reduced
            shutil.rmtree(root, ignore_errors=True)
        torch.cuda.synchronize()
        self.launches["train"] = counts.as_dict()
        log(f"[train] launches in this phase: {self.launches['train']}")
        check(not any(self.launches["train"].values()),
              f"the training path launched a port kernel: {self.launches['train']}")
        log(f"[train] phase took {time.perf_counter() - phase_t0:.1f} s")

    def train_counts(self, label: str, stats, traces: int, dispatches: int) -> None:
        got = (dict(stats.traces), dict(stats.dispatches))
        want = ({"train_step": traces}, {"train_step": dispatches})
        log(f"[train] {label}: traces {got[0]}, dispatches {got[1]}")
        check(got == want, f"{label}: traces and dispatches {got}, expected {want}")

    def train_cut(self, n_layers: int):
        cfg = self.configs.get_config(OLMO_ARCH)
        return dataclasses.replace(cfg, n_layers=n_layers)

    def train_launcher(self, ckpt_dir: Path, argv=TRAIN_LAUNCH, cut=None) -> None:
        """An architecture at its published config (its depth cut to
        ``cut`` layers where given) through ``run``, the body of ``python
        -m repro_torch.launch.train`` with ``argv``: BLANK over 4
        replicas, the failed replica masked for two steps.  The cut goes in
        through the registry the launcher reads, for this run only."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.launch import train
        from repro_torch.models import api
        from repro_torch.optim._tree import leaves

        import numpy as np

        args = train.parse_args(argv + ["--device", DEVICE, "--ckpt-dir", str(ckpt_dir)])
        arch, published = args.arch, configs.get_config
        if cut is not None:
            log(f"[train] {arch}: depth cut from {published(arch).n_layers} to {cut} layers "
                f"(the step's peak allocation must stay under {TRAIN_PEAK_LIMIT / 1e9:.0f} GB)")
            configs.get_config = lambda name: (dataclasses.replace(published(name), n_layers=cut)
                                               if name == arch else published(name))
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            with self.dispatch.track_dispatch() as stats:
                tr = train.run(args)
        finally:
            configs.get_config = published
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        cfg = tr.model_cfg
        losses = [m["loss"] for m in tr.metrics_log]
        walls = [m["wall"] for m in tr.metrics_log]
        warm = statistics.median(walls[1:])
        tokens = args.global_batch * args.seq_len
        n_params = sum(t.numel() for t in leaves(api.param_specs(cfg)))
        widths = (f"d_model {cfg.d_model}, {cfg.n_ssm_heads} heads of {cfg.ssm_head_dim}, state "
                  f"{cfg.ssm_state}, chunk {cfg.ssm_chunk}" if cfg.family == "ssm"
                  else f"d_model {cfg.d_model}, d_ff {cfg.d_ff}")
        log(f"[train] {arch} ({cfg.n_layers} layers, {widths}, vocab {cfg.vocab}, {cfg.dtype}, "
            f"remat {cfg.remat}; {n_params / 1e9:.3f} B parameters), {' '.join(argv)}")
        log(f"[train] {arch} launcher run on {self.card_name}: {len(walls)} steps in "
            f"{run_s:.3f} s (weights drawn on the card included); step walls "
            f"{[round(w, 4) for w in walls]} s; warm step (median of steps 1-{len(walls) - 1}) "
            f"{warm * 1e3:.3f} ms, {tokens / warm:.0f} tokens/s ({tokens} tokens a step over "
            f"{tr.n_replicas} replicas); peak allocation {peak / 1e9:.2f} GB above the "
            f"process's other allocations (limit {TRAIN_PEAK_LIMIT / 1e9:.0f} GB)")
        log(f"[train] {arch} losses {losses}; fault stats {tr.fault_stats}")
        check(all(np.isfinite(losses)) and len(losses) == 6, f"{arch} losses {losses}")
        check("gradient all-reduce: ft_allreduce over 4 replicas" in tr.events_log,
              f"{arch}: no ft_allreduce line in {tr.events_log}")
        fs = tr.fault_stats
        check((fs["failures"], fs["recoveries"], fs["masked_steps"]) == (1, 1, 2),
              f"{arch} fault stats {fs}")
        check(peak < TRAIN_PEAK_LIMIT, f"{arch} peak allocation {peak / 1e9:.2f} GB")
        self.train_counts(f"{arch} launcher run", stats, 1, 6)
        del tr
        torch.cuda.empty_cache()

    def train_whisper_bf16(self, ckpt_dir: Path) -> None:
        """ROADMAP C.11: whisper-medium in bf16 trained on the f32 frames
        ``SyntheticCorpus`` builds, through the launcher's ``run``: its
        products promote the f32 encoder and residual against the bf16
        weights, as the reference's ``jnp`` does.  Published widths, the
        depth cut to ``WHISPER_TRAIN_LAYERS`` encoder and decoder layers
        through the registry the launcher reads, for this run only."""
        torch = self.torch
        from repro_torch import configs
        from repro_torch.data.pipeline import SyntheticCorpus
        from repro_torch.launch import train

        import numpy as np

        args = train.parse_args(WHISPER_TRAIN + ["--device", DEVICE, "--ckpt-dir",
                                                 str(ckpt_dir)])
        arch, published = args.arch, configs.get_config
        cut = WHISPER_TRAIN_LAYERS
        configs.get_config = lambda name: (
            dataclasses.replace(published(name), n_layers=cut, n_enc_layers=cut)
            if name == arch else published(name))
        t0 = time.perf_counter()
        try:
            tr = train.run(args)
        finally:
            configs.get_config = published
        torch.cuda.synchronize()
        cfg = tr.model_cfg
        frames = SyntheticCorpus(tr.data_cfg, "cpu").host_batch(0)["frames"]
        losses = [m["loss"] for m in tr.metrics_log]
        log(f"[train] {arch} in {cfg.dtype} ({cfg.n_enc_layers} encoder + {cfg.n_layers} "
            f"decoder layers of {published(arch).n_enc_layers} + {published(arch).n_layers}, "
            f"d_model {cfg.d_model}, d_ff {cfg.d_ff}, {cfg.enc_frames} frames of "
            f"{frames.dtype}), {' '.join(WHISPER_TRAIN)} on {self.card_name}: loss {losses} "
            f"in {time.perf_counter() - t0:.3f} s (weights drawn on the card included)")
        check(cfg.dtype == "bfloat16" and frames.dtype == np.float32,
              f"{arch}: dtype {cfg.dtype}, frames {frames.dtype}")
        check(len(losses) == 1 and np.isfinite(losses[0]), f"{arch} bf16 losses {losses}")
        del tr
        torch.cuda.empty_cache()

    def train_scenarios(self, root: Path) -> None:
        """The three stock trainer scenarios at olmo-1b's widths cut to
        ``TRAIN_CUT_LAYERS`` layers, through ``trainer_scenario_run`` (disk
        checkpoints under ``root``): the expected fault stats, final width,
        last step and train_step counts; then one warm step of a BLANK
        trainer at that size profiled."""
        torch = self.torch
        from repro_torch.bench import scenarios

        cfg = self.train_cut(TRAIN_CUT_LAYERS)
        for sc in scenarios.get_scenarios():
            if sc.kind != "trainer":
                continue
            t0 = time.perf_counter()
            with self.dispatch.track_dispatch() as stats:
                tr = scenarios.trainer_scenario_run(sc, str(root / sc.name), device=DEVICE,
                                                    cfg=cfg, seq_len=TRAIN_SEQ_LEN)
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
            metrics = {k: m.value for k, m in scenarios.trainer_scenario_metrics(sc, tr).items()}
            walls = [m["wall"] for m in tr.metrics_log]
            log(f"[train] scenario {sc.name} ({cfg.n_layers} layers at full widths, "
                f"{sc.data_width} replicas, {2 * sc.data_width} x {TRAIN_SEQ_LEN} tokens) on "
                f"{self.card_name}: {took:.3f} s, {len(walls)} steps, median step "
                f"{statistics.median(walls) * 1e3:.3f} ms; metrics {metrics}")
            log(f"[train] scenario {sc.name} events: {tr.events_log}")
            check(metrics["loss_finite"] and metrics["completed_final_step"] == sc.steps - 1
                  and metrics["final_replicas"] == sc.data_width,
                  f"scenario {sc.name}: {metrics}")
            self.train_counts(f"scenario {sc.name}", stats, *TRAIN_COUNTS[sc.name])
            del tr
        self.train_profile(cfg, root / "profile")

    def train_profile(self, cfg, ckpt_dir: Path) -> None:
        """One warm AdamW step under BLANK (4 replicas, the gradient combine
        on the butterfly) at the scenarios' size, under the profiler."""
        torch = self.torch
        from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
        from repro_torch.runtime.elastic import ReplicaMesh
        from repro_torch.runtime.trainer import Trainer, TrainerConfig

        tr = Trainer(cfg, TrainerConfig(steps=4, ckpt_every=0, ckpt_dir=str(ckpt_dir)),
                     ReplicaMesh.of((4, 1)),
                     DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ_LEN, global_batch=8),
                     device=DEVICE)
        p, o = tr.init_state()
        batch = tr._device_batch(SyntheticCorpus(tr.data_cfg, DEVICE).host_batch(0))
        self.profile(f"olmo-1b train step ({cfg.n_layers} layers at full widths, 4 replicas, "
                     f"8 x {TRAIN_SEQ_LEN} tokens, BLANK, AdamW)",
                     lambda: tr.step_fn(p, o, batch))
        del tr, p, o, batch
        torch.cuda.empty_cache()

    def train_optimizers(self, root: Path) -> None:
        """PowerSGD, OrthoSGD and the low-rank optimizer, 2 steps each over
        4 replicas under BLANK with replica 2 failed at step 1, at the
        scenarios' size."""
        torch = self.torch
        from repro_torch.bench import scenarios
        from repro_torch.runtime.trainer import FaultEvent

        cfg = self.train_cut(TRAIN_CUT_LAYERS)
        for opt in ("powersgd", "orthosgd", "lowrank"):
            sc = scenarios.TrainerScenario(
                name=f"blank_{opt}", on_failure="blank", optimizer=opt, steps=2, ckpt_every=0,
                events=(FaultEvent(step=1, kind="fail", replica=2),),
                expect={"failures": 1, "masked_steps": 1})
            t0 = time.perf_counter()
            with self.dispatch.track_dispatch() as stats:
                tr = scenarios.trainer_scenario_run(sc, str(root / sc.name), device=DEVICE,
                                                    cfg=cfg, seq_len=TRAIN_SEQ_LEN)
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
            metrics = {k: m.value for k, m in scenarios.trainer_scenario_metrics(sc, tr).items()}
            losses = [m["loss"] for m in tr.metrics_log]
            log(f"[train] {opt} ({cfg.n_layers} layers at full widths, 4 replicas, BLANK) on "
                f"{self.card_name}: {took:.3f} s for 2 steps, step walls "
                f"{[round(m['wall'], 4) for m in tr.metrics_log]} s, losses {losses}")
            check(metrics["loss_finite"] and "gradient all-reduce: ft_allreduce over 4 replicas"
                  in tr.events_log, f"{opt}: {metrics}, {tr.events_log}")
            self.train_counts(opt, stats, 1, 2)
            del tr
        torch.cuda.empty_cache()

    def train_card_vs_cpu(self, ckpt_dir: Path) -> None:
        """One olmo-1b layer at full widths in float32, trained 3 steps
        under BLANK on the card and on the CPU from the same weights: the
        losses and the final parameters within the limits."""
        torch = self.torch
        from repro_torch.data.pipeline import DataConfig
        from repro_torch.models import api
        from repro_torch.optim import adamw
        from repro_torch.optim._tree import leaves, map_params
        from repro_torch.runtime.elastic import ReplicaMesh
        from repro_torch.runtime.trainer import FaultEvent, Trainer, TrainerConfig

        cfg = dataclasses.replace(self.train_cut(1), dtype="float32")
        weights = api.init(31, cfg, "cpu")
        runs = {}
        for device in (DEVICE, "cpu"):
            tr = Trainer(cfg, TrainerConfig(steps=3, ckpt_every=0, log_every=10**9,
                                            ckpt_dir=str(ckpt_dir / device)),
                         ReplicaMesh.of((4, 1)),
                         DataConfig(vocab=cfg.vocab, seq_len=TRAIN_CPU_SEQ, global_batch=8),
                         device=device)
            p = map_params(lambda t: t.to(tr.device, copy=True), weights)
            t0 = time.perf_counter()
            p, o = tr.run(p, adamw.init(p), fault_schedule=(FaultEvent(1, "fail", 1),))
            took = time.perf_counter() - t0
            runs[device] = ([m["loss"] for m in tr.metrics_log], [t.cpu() for t in leaves(p)],
                            [t.cpu() for t in leaves(o["m"])], [t.cpu() for t in leaves(o["v"])],
                            tr.fault_stats["masked_steps"], took, tr.opt_cfg)
        (gl, gp, gmom, gv, gm, gt, _), (wl, wp, wmom, wv, wm, wt, ocfg) = runs[DEVICE], runs["cpu"]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(gl, wl))
        param_err = max(self.rel_err(a, b) for a, b in zip(gp, wp))
        diff = torch.cat([(a - b).abs().flatten() for a, b in zip(gp, wp)])
        # AdamW's direction m̂/(√v̂ + eps) after the 3 steps, and its √v̂, at
        # the elements the two runs moved furthest apart
        def adam(ms, vs):
            m = torch.cat([t.flatten() for t in ms]) / (1 - ocfg.b1 ** 3)
            root_v = (torch.cat([t.flatten() for t in vs]) / (1 - ocfg.b2 ** 3)).sqrt()
            return m / (root_v + ocfg.eps), root_v

        (ratio, root_v), (ratio_card, root_v_card) = adam(wmom, wv), adam(gmom, gv)
        top = diff.topk(8).indices
        log(f"[train] card vs the port's CPU run, one olmo-1b layer at full widths in f32, 4 "
            f"replicas, 8 x {TRAIN_CPU_SEQ} tokens, AdamW, BLANK with replica 1 failed at step 1: "
            f"losses {gl} (card) {wl} (CPU), max relative difference {loss_err:.3e} (limit "
            f"{TRAIN_CPU_LOSS_TOL}); final parameters: max |difference| {float(diff.max()):.3e}, "
            f"{param_err:.3e} of max|param| (limit {TRAIN_CPU_PARAM_TOL}), "
            f"{int((diff > 1e-6).sum())} of {diff.numel()} elements apart by more than 1e-6; "
            f"masked steps {gm}, {wm}; {gt:.3f} s on the card, {wt:.3f} s on the CPU")
        log(f"[train] card vs CPU: the 8 elements furthest apart: differences "
            f"{[f'{float(d):.3e}' for d in diff[top]]}; AdamW's m̂/(√v̂ + eps) there (CPU) "
            f"{[f'{float(r):.4f}' for r in ratio[top]]}, (card) "
            f"{[f'{float(r):.4f}' for r in ratio_card[top]]}; √v̂ there (CPU) "
            f"{[f'{float(r):.3e}' for r in root_v[top]]}, (card) "
            f"{[f'{float(r):.3e}' for r in root_v_card[top]]}, eps {ocfg.eps}; elements with "
            f"√v̂ < 10·eps (CPU): {int((root_v < 10 * ocfg.eps).sum())}, of those apart by more "
            f"than 1e-6: {int(((root_v < 10 * ocfg.eps) & (diff > 1e-6)).sum())}")
        check(gm == wm == 2, f"masked steps {gm}, {wm}")
        check(loss_err <= TRAIN_CPU_LOSS_TOL, f"card vs CPU losses {loss_err:.3e}")
        check(param_err <= TRAIN_CPU_PARAM_TOL, f"card vs CPU parameters {param_err:.3e} of "
              f"max|param| (limit {TRAIN_CPU_PARAM_TOL})")

    def profile(self, label: str, fn) -> None:
        """Where one warm call spends device time: ``torch.profiler`` over
        the call, the device-time sums by kernel (each port kernel named by
        its wrapper), and the device's busy share of the call (kernel time
        summed, over the span between CUDA events recorded around the call
        and over the host wall; the call runs alone on the card, so kernels
        do not overlap).  The window opens 20 ms before the call, so no
        launch of the call sits at its opening, and every launch of a port
        kernel in the call must have its record: a missing one would leave
        the busy share short.  Later in a process the profiler drops the
        first few device records of each window, so ``PROFILE_SPIN`` empty
        spin kernels run first, outside the call's span and sums; at least
        one of their records must be kept, which shows the drop ended
        before the call."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        counts = self.dispatch.launches
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        before = counts.as_dict()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(0.02)
            for _ in range(PROFILE_SPIN):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        launched = {k: v - before[k] for k, v in counts.as_dict().items() if v - before[k]}
        span_us = start.elapsed_time(end) * 1e3
        # device activities only (kernels, copies, fills): a host event's
        # device time repeats the time of the kernels it launched, and
        # CUPTI's host-side records (a launch blocked on a full command
        # buffer) are no device work
        cuda = torch.autograd.DeviceType.CUDA
        rows, host, spun = [], [], 0
        for e in prof.key_averages():
            if "spin_kernel" in e.key:
                spun += e.count
            elif e.self_device_time_total > 0 and e.device_type == cuda:
                rows.append((e.key, e.self_device_time_total, e.count))
            elif e.self_device_time_total > 0 and not e.key.startswith("aten::"):
                host.append((e.key, e.self_device_time_total, e.count))
        check(bool(rows), f"profile {label}: the profiler recorded no device time")
        check(spun > 0, f"profile {label}: the profiler dropped all {PROFILE_SPIN} spin records "
              f"before the call, so it may have dropped the call's first records")
        records = collections.Counter()
        for key, _, count in rows:
            records[self._port_kernel(key)] += count
        want = {("panel_cross sweep" if k == "panel_cross" else k): n for k, n in launched.items()}
        missing = {k: (records[k], n) for k, n in want.items()
                   if records[k] < n or (records[k] != n and k != "panel_cross sweep")}
        busy_us = sum(t for _, t, _ in rows)
        log(f"[profile] {label}: wall {wall_us:.0f} us, device span {span_us:.0f} us "
            f"(CUDA events), device busy {busy_us:.0f} us ({100 * busy_us / span_us:.1f}% of "
            f"the span, {100 * busy_us / wall_us:.1f}% of the wall); port kernels launched "
            f"{launched}")
        for key, t, count in sorted(rows, key=lambda r: -r[1])[:10]:
            log(f"[profile]   {t:10.0f} us  x{count:<4d} {self._port_kernel(key):18s} {key[:80]}")
        if host:
            log("[profile]   not device work, not counted: " + ", ".join(
                f"{key[:40]} {t:.0f} us x{count}" for key, t, count in host))
        check(not missing, f"profile {label}: kernel records (got, launched) {missing}")
        log(f"[profile] {label}: every launch of a port kernel has its record; the profiler "
            f"kept {spun} of the {PROFILE_SPIN} spin records before the call")

    @staticmethod
    def _port_kernel(key: str) -> str:
        """The port's name for a kernel the profiler recorded, or
        "library"."""
        for fn_name, name in PROFILE_NAMES.items():
            if f"::{fn_name}<" in key or f"::{fn_name}(" in key:
                return name
        return "library"

    # -- phase 9: kernel times ------------------------------------------------

    def timings(self) -> None:
        torch = self.torch
        ref = self.ref
        for shape_name, (b, m, n) in MAIN_SHAPES.items():
            a = self.randn((b, m, n), 2000)
            w = self.randn((b, n, n), 2001) / n ** 0.5
            f32 = 4
            # Operations the function needs: a Gram is symmetric, so its
            # n(n+1)/2 distinct entries of 2m operations each; the fused
            # sweep is the product (2mnk) and the Gram of its (m, k) result.
            gram_ops = b * m * n * (n + 1)
            product_ops = 2 * b * m * n * n
            work = {
                "gram": (f32 * b * (m * n + n * n), gram_ops,
                         lambda: self.kernels["gram"](a), lambda: ref.gram(a),
                         lambda: torch.matmul(a.mT, a)),
                "fused_apply_gram": (f32 * b * (m * n + 2 * n * n), product_ops + gram_ops,
                                     lambda: self.kernels["fused_apply_gram"](a, w,
                                                                              want_q=False),
                                     lambda: ref.fused_apply_gram(a, w)[1],
                                     lambda: torch.einsum("bmi,bij,bmk,bkl->bjl", a, w, a, w)),
                "apply_right": (f32 * b * (2 * m * n + n * n), product_ops,
                                lambda: self.kernels["apply_right"](a, w),
                                lambda: ref.apply_right(a, w), lambda: torch.matmul(a, w)),
            }
            # one library call for the fused sweep: an einsum of (A, W, A, W)
            # gives Wᵀ(AᵀA)W = (AW)ᵀ(AW), equal in f32 to G' of the cast Q
            lib_err = self.rel_err(work["fused_apply_gram"][4](), ref.fused_apply_gram(a, w)[1])
            check(lib_err <= TOL["float32"], f"einsum yardstick {shape_name}: {lib_err:.3e}")
            for name, (nbytes, flops, kern, plain, lib) in work.items():
                bytes_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
                row = {
                    "shape": [b, m, n, n],
                    "ms": self.time_ms(kern),
                    "plain_ms": self.time_ms(plain),
                    "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                    "library_ms": self.time_ms(lib) if lib else None,
                }
                self.times[(name, shape_name)] = row
                log(f"[time] {name} {shape_name} {json.dumps(row)}")
            if shape_name == HEADLINE:
                self.clock("gram kernel", work["gram"][2])
                self.clock("apply_right kernel", work["apply_right"][2])
                self.clock("apply_right library a @ w", work["apply_right"][4])
                self.clock("fused_apply_gram kernel", work["fused_apply_gram"][2])
        # gram beside the headline row (and paper_fig's n = 32 above): the
        # blocked QR's polish Gram of each 128-column panel of Q, and the
        # widest Gram, whose ten tile pairs take the off-diagonal CTAs
        gram = self.kernels["gram"]
        for label, shape, seed in (("polish", (P, 1 << 17, PANEL), 2002),
                                   ("n512", (P, 1 << 17, 512), 2003)):
            b, m, n = shape
            a = self.randn(shape, seed)
            row = self.time_row(shape, 4 * b * (m * n + n * n), b * m * n * (n + 1),
                                lambda a=a: gram(a), lambda a=a: ref.gram(a),
                                lambda a=a: torch.matmul(a.mT, a))
            self.times[("gram", label)] = row
            log(f"[time] gram {label} {json.dumps(row)}")

    def clock(self, label: str, fn, launches: int = 400) -> None:
        """The SM clock and power draw while ``fn`` runs back to back: the
        card may cap its clock at its power limit, which a time alone does
        not show."""
        for _ in range(launches):
            fn()
        time.sleep(0.5)
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
        self.torch.cuda.synchronize()
        log(f"[clock] {label}: {out}")

    def time_row(self, shape, nbytes: int, flops: int, kern, plain, lib) -> dict:
        """Kernel, plain version and library call times beside the bound:
        the larger of the bytes over the memory rate and the operations over
        the f32 rate."""
        bytes_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
        return {
            "shape": list(shape),
            "ms": self.time_ms(kern),
            "plain_ms": self.time_ms(plain),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": self.time_ms(lib) if lib else None,
        }

    def blocked_timings(self) -> None:
        """The blocked QR's kernels at the main path's shapes.  Operations:
        m·s(s+1) for the symmetric s × s block of a cross product S of split
        s, 2ms(n − s) for the rest of S, 2mb·n_t for the update."""
        torch, ref = self.torch, self.ref
        tu, pc, pad = (self.kernels[k] for k in ("trailing_update", "panel_cross", "pad_cross"))
        b, f32 = PANEL, 4
        full = self.randn(BLOCKED_SHAPES["general_full"], 4000)
        ragged = self.randn(BLOCKED_SHAPES["general_ragged"], 4001)
        bsz, m, n = full.shape
        q = self.randn((bsz, m, b), 4002) / m ** 0.5

        def cross_ops(split, width):
            return bsz * (m * split * (split + 1) + 2 * m * split * (width - split))

        # the trailing widths of general_full's sweeps (384, 256, 128), and
        # the first without the lookahead
        widths = [n - k * b for k in range(1, n // b)]
        for nt, nw in [(nt, b) for nt in widths] + [(widths[0], 0)]:
            a = full[..., n - nt:]                           # the strided trailing block
            w = self.randn((bsz, b, nt), 4003 + nt) / b ** 0.5
            lib = None
            if not nw:
                # one library call for the update alone: A − Q W
                lib = lambda a=a, w=w: torch.baddbmm(a, q, w, alpha=-1)  # noqa: E731
                lib_err = self.rel_err(lib(), ref.trailing_update(a, q, w))
                check(lib_err <= TOL["float32"], f"baddbmm yardstick: {lib_err:.3e}")
            key = f"general_full n_t={nt}" + ("" if nw else " next_width=0")
            self.times[("trailing_update", key)] = self.time_row(
                (bsz, m, b, nt, nw),
                f32 * bsz * (2 * m * nt + m * b + b * nt + nw * nt),
                bsz * 2 * m * b * nt + (cross_ops(nw, nt) if nw else 0),
                lambda a=a, w=w, nw=nw: tu(a, q, w, next_width=nw),
                lambda a=a, w=w, nw=nw: ref.trailing_update(a, q, w, next_width=nw), lib)
        self.times[("trailing_update", "general_full")] = self.times[
            ("trailing_update", f"general_full n_t={widths[0]}")]
        trail = full[..., n - widths[0]:]
        w0 = self.randn((bsz, b, widths[0]), 4003 + widths[0]) / b ** 0.5
        self.clock("trailing_update kernel", lambda: tu(trail, q, w0, next_width=b))
        self.times[("panel_cross", "general_full")] = self.time_row(
            (bsz, m, n, b), f32 * bsz * (m * n + b * n), cross_ops(b, n),
            lambda: pc(full, split=b), lambda: ref.panel_cross(full, split=b),
            lambda: full[..., :b].mT @ full)
        self.clock("panel_cross kernel", lambda: pc(full, split=b))
        self.clock("panel_cross library a[..., :b].mT @ a", lambda: full[..., :b].mT @ full)
        nr = ragged.shape[-1]
        # no single library call widens A and forms S in one sweep
        self.times[("pad_cross", "general_ragged")] = self.time_row(
            (bsz, m, nr, b, n), f32 * bsz * (m * nr + m * n + b * n), cross_ops(b, nr),
            lambda: pad(ragged, split=b, out_width=n),
            lambda: ref.pad_cross(ragged, split=b, out_width=n), None)
        self.clock("pad_cross kernel", lambda: pad(ragged, split=b, out_width=n))
        for (name, shape), row in self.times.items():
            if name in ("trailing_update", "panel_cross", "pad_cross"):
                log(f"[time] {name} {shape} {json.dumps(row)}")
        bound = {key: sum(self.times[("trailing_update", f"general_full n_t={nt}")]["bound_ms"]
                          for nt in nts)
                 for key, nts in (("pipeline", [widths[0]] * len(widths)), ("eager", widths))}
        log(f"[time] trailing sweeps' bound per general_full factorization: pipeline (n_t = "
            f"{widths[0]} every panel) {bound['pipeline']:.3f} ms, eager ({widths}) "
            f"{bound['eager']:.3f} ms")

    # -- phase 13: the butterfly across processes -----------------------------

    def mesh_path(self) -> None:
        """Spawn ``MESH_RANKS`` rank processes on the one card
        (:func:`repro_torch.collective.dist.run_ranks`, gloo, host-staged),
        run :func:`mesh_rank` in each, and hold what they return against
        SimComm's results on the same stacks, computed here on the card
        afterwards, and against float64."""
        import numpy as np

        torch = self.torch
        from repro_torch import replay
        from repro_torch.collective import FaultSpec, SimComm, ft_allreduce, ft_allreduce_jit
        from repro_torch.collective import dist as rank_world
        from repro_torch.collective import make_plan
        from repro_torch.qr import PanelFaultSchedule, QRConfig, factorize
        from repro_torch.qr.tsqr import gram_tsqr

        t_phase = time.perf_counter()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"[dist] gloo, host-staged, {MESH_RANKS} ranks on {self.card_name}")
        shapes = {"allreduce": MESH_ALLREDUCE, **MESH_TSQR, **BLOCKED_SHAPES}
        psgd = {"spmd": PSGD_MESH_SPMD, "olmo": (self.olmo["d_model"], self.olmo["d_ff"]),
                "ranks": PSGD_MESH_RANKS}
        ranks = rank_world.run_ranks(mesh_rank, MESH_RANKS, device=DEVICE,
                                     args=({"shapes": shapes, "panel": PANEL, "psgd": psgd},),
                                     timeout=MESH_TIMEOUT)
        t_world = time.perf_counter() - t_phase
        self.psgd_ranks = [out.pop("psgd") for out in ranks]    # phase 13b checks them
        check([out["rank"] for out in ranks] == list(range(MESH_RANKS)), "ranks out of order")

        def rel(a, b) -> float:
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            return float(np.abs(a - b).max() / np.abs(b).max())

        def bits(a, b) -> bool:
            return a.dtype == b.dtype and np.array_equal(a.view(np.int32), b.view(np.int32))

        sim_ms = {}

        def sim_wall(label, fn):
            samples = []
            fn()
            for _ in range(MESH_REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                samples.append((time.perf_counter() - t0) * 1e3)
            sim_ms[label] = statistics.median(samples)

        # -- ft_allreduce ------------------------------------------------------
        x = self.randn(MESH_ALLREDUCE, MESH_SEEDS["allreduce"])
        sym = x + x.mT
        sim = SimComm(MESH_RANKS, DEVICE)
        n_cases = 0
        for deaths in (None, MESH_DEATHS):
            for op in MESH_OPS:
                payload = sym if op == "gram_sum" else x
                for variant in VARIANTS:
                    plan = make_plan(variant, MESH_RANKS, FaultSpec.of(deaths) if deaths else None)
                    v, ok = ft_allreduce(payload, sim, op=op, plan=plan)
                    v, ok = v.cpu().numpy(), ok.cpu().numpy()
                    tag = f"ft_allreduce {op} {variant} faults={deaths}"
                    got_ok = np.array([out["allreduce"][(op, variant, bool(deaths))][1]
                                       for out in ranks])
                    check((got_ok == plan.final_valid).all() and (got_ok == ok).all(),
                          f"{tag}: validity {got_ok} != plan {plan.final_valid}")
                    for i, out in enumerate(ranks):
                        check(bits(out["allreduce"][(op, variant, bool(deaths))][0], v[i]),
                              f"{tag}: rank {i}'s value differs from SimComm's bits")
                    n_cases += 1
        fast = [flag for out in ranks for flag in out["fast_equals_general"]]
        check(all(fast), "a rank's fast path differs from its general executor")
        log(f"[dist] ft_allreduce at {MESH_ALLREDUCE}: {n_cases} cases (sum, mean, max, "
            f"gram_sum x 4 variants x fault-free and {MESH_DEATHS}), validity == plan and "
            f"every rank's value == SimComm's bit for bit; fast == general executor bit for "
            f"bit in {len(fast)} rank-cases")
        for i, out in enumerate(ranks):
            traced, same, ok = out["jit"]
            check(traced == 0 and same and ok, f"rank {i}: ft_allreduce_jit(mesh=) warm repeat "
                  f"traced {traced}, equal to ft_allreduce {same}, valid {ok}")
        sim_wall("ft_allreduce_jit sum", lambda: ft_allreduce_jit(x, sim, op="sum"))
        log("[dist] ft_allreduce_jit(mesh=): equal to ft_allreduce bit for bit, no trace on "
            "a warm repeat, on every rank")
        del x, sym

        # -- TSQR and the Gram butterfly --------------------------------------
        for name in MESH_TSQR:
            a = self.randn(MESH_TSQR[name], MESH_SEEDS[name])
            truth = self.truth_r(a)
            t_max = truth.abs().max().item()
            for name_, variant, deaths, want_q in MESH_TSQR_RUNS:
                if name_ != name:
                    continue
                cfg = QRConfig(variant=variant, local_r="cqr2_pallas", compute_q=want_q)
                faults = FaultSpec.of(deaths) if deaths else None
                res = factorize(a, cfg, faults=faults)
                sim_r = res.r.cpu().numpy()
                tag = f"tsqr {name} {tuple(a.shape)} {variant} faults={deaths} q={want_q}"
                rows = [out["tsqr"][(name, variant, bool(deaths), want_q)] for out in ranks]
                valid = np.array([row[1] for row in rows])
                check((valid == rows[0][2]).all() and (valid == res.valid.cpu().numpy()).all(),
                      f"{tag}: validity {valid} != plan {rows[0][2]}")
                sim_err = max(rel(rows[i][0], sim_r[i]) for i in np.flatnonzero(valid))
                f64_err = max(float((torch.from_numpy(rows[i][0]).to(DEVICE).double()
                                     - truth).abs().max().item() / t_max)
                              for i in np.flatnonzero(valid))
                check(sim_err <= MESH_SIM_TOL, f"{tag}: R vs SimComm {sim_err:.3e}")
                check(f64_err <= R_TIGHT, f"{tag}: R vs float64 {f64_err:.3e} > {R_TIGHT}")
                want = {"gram": 1 + want_q, "fused_apply_gram": 1}
                for i, row in enumerate(rows):
                    check(row[4] == want, f"{tag}: rank {i} launched {row[4]}, want {want}")
                line = (f"[dist] {tag} valid={valid.astype(int).tolist()} R vs SimComm "
                        f"{sim_err:.2e} vs float64 {f64_err:.2e}")
                if want_q:
                    ortho = float(np.abs(sum(row[3] for row in rows)
                                         - np.eye(a.shape[-1])).max())
                    check(ortho <= ORTHO_TOL, f"{tag}: ||QᵀQ − I|| {ortho:.3e}")
                    line += f" ||QᵀQ−I||={ortho:.2e}"
                log(line + f" launches a rank {rows[0][4]}")
                if deaths is None and not want_q and variant == "redundant":
                    sim_wall(f"tsqr {name} redundant", lambda a=a, cfg=cfg: factorize(a, cfg))
            if name == HEADLINE:
                rg, qg = gram_tsqr(a, SimComm(MESH_RANKS, DEVICE))
                rg = rg.cpu().numpy()
                del qg
                sim_err = max(rel(out["gram"][0], rg[i]) for i, out in enumerate(ranks))
                f64_err = max(float((torch.from_numpy(out["gram"][0]).to(DEVICE).double()
                                     - truth).abs().max().item() / t_max) for out in ranks)
                ortho = float(np.abs(sum(out["gram"][2] for out in ranks)
                                     - np.eye(a.shape[-1])).max())
                check(all(out["gram"][1] for out in ranks), "gram butterfly: a rank invalid")
                check(sim_err <= MESH_SIM_TOL, f"gram butterfly: R vs SimComm {sim_err:.3e}")
                check(f64_err <= R_TIGHT, f"gram butterfly: R vs float64 {f64_err:.3e}")
                check(ortho <= ORTHO_TOL, f"gram butterfly: ||QᵀQ − I|| {ortho:.3e}")
                log(f"[dist] gram butterfly {name} {tuple(a.shape)}: R vs SimComm "
                    f"{sim_err:.2e} vs float64 {f64_err:.2e} ||QᵀQ−I||={ortho:.2e}")
                sim_wall(f"gram butterfly {name}",
                         lambda a=a: gram_tsqr(a, SimComm(MESH_RANKS, DEVICE)))
            del a, truth
        for i, out in enumerate(ranks):
            same, ortho, launched = out["cholesky_qr2"]
            check(same and ortho <= 3e-5 and launched == {"gram": 2, "fused_apply_gram": 2,
                                                          "apply_right": 1},
                  f"rank {i}: cholesky_qr2 R-only == full-Q {same}, ||QᵀQ − I|| {ortho:.3e}, "
                  f"launches {launched}")
        log(f"[dist] ops.cholesky_qr2 of each rank's {MESH_TSQR[HEADLINE][1:]} block: "
            f"R-only == full-Q R, per-rank ||QᵀQ−I|| <= "
            f"{max(out['cholesky_qr2'][1] for out in ranks):.2e}")

        # -- the blocked QR --------------------------------------------------
        for name in BLOCKED_SHAPES:
            a = self.randn(BLOCKED_SHAPES[name], MESH_SEEDS[name])
            truth = self.truth_r(a)
            t_max = truth.abs().max().item()
            for label, name_, fields, sched in MESH_BLOCKED_RUNS:
                if name_ != name:
                    continue
                cfg = QRConfig(panel_width=PANEL, use_pallas=True, **fields)
                faults = PanelFaultSchedule.of(**sched) if sched else None
                res = factorize(a, cfg, faults=faults)
                sim_r = res.r.cpu().numpy()
                tag = f"blocked {label} {name} {tuple(a.shape)}"
                rows = [out["blocked"][label] for out in ranks]
                expect = np.ones(MESH_RANKS, bool)
                for plan_r, plan_w, fused, _ in rows[0][2]:
                    expect &= plan_r
                    if not fused and plan_w is not None:
                        expect &= plan_w
                valid = np.array([row[1] for row in rows])
                check((valid == expect).all() and (valid == res.valid.cpu().numpy()).all(),
                      f"{tag}: validity {valid} != reports {expect}")
                # replica fetch restores every rank, valid or not
                sim_err = max(rel(row[0], sim_r[i]) for i, row in enumerate(rows))
                f64_err = max(float((torch.from_numpy(row[0]).to(DEVICE).double() - truth)
                                    .abs().max().item() / t_max) for row in rows)
                check(sim_err <= MESH_SIM_TOL, f"{tag}: R vs SimComm {sim_err:.3e}")
                check(f64_err <= R_TIGHT_BLOCKED,
                      f"{tag}: R vs float64 {f64_err:.3e} > {R_TIGHT_BLOCKED}")
                k_panels = len(rows[0][2])
                eager = faults is not None
                prime = ("pad_cross" if not eager and a.shape[-1] < k_panels * PANEL
                         else "panel_cross")
                want = {prime: 1, "trailing_update": k_panels - 1,
                        "gram": sum(1 for pr, _, _, rec in rows[0][2] if pr.all() or rec)}
                for i, row in enumerate(rows):
                    check(row[4] == want, f"{tag}: rank {i} launched {row[4]}, want {want}")
                line = (f"[dist] {tag} valid={valid.astype(int).tolist()} every rank's R vs "
                        f"SimComm {sim_err:.2e} vs float64 {f64_err:.2e}")
                if fields.get("compute_q"):
                    ortho = float(np.abs(sum(row[3] for row in rows)
                                         - np.eye(a.shape[-1])).max())
                    check(ortho <= ORTHO_BLOCKED, f"{tag}: ||QᵀQ − I|| {ortho:.3e}")
                    line += f" ||QᵀQ−I||={ortho:.2e}"
                log(line + f" launches a rank {rows[0][4]}")
                del res
                if not fields.get("compute_q"):
                    sim_wall(f"blocked {label} {name}",
                             lambda a=a, cfg=cfg, faults=faults: factorize(a, cfg, faults=faults))
            del a, truth

        # -- launches, times, the wire, memory, the guard ----------------------
        total = dict.fromkeys(ranks[0]["launches"], 0)
        for i, out in enumerate(ranks):
            missing = [k for k in MESH_KERNELS if not out["launches"][k]]
            check(not missing, f"rank {i} never launched {missing}: {out['launches']}")
            check(out["launches"]["combine_gram"] == 0, f"rank {i} launched combine_gram")
            for k, v in out["launches"].items():
                total[k] += v
        self.launches["mesh"] = total
        log(f"[dist] launches a rank: {[out['launches'] for out in ranks]}")
        log(f"[dist] launches over the {MESH_RANKS} ranks: {total}")
        for label in ranks[0]["times"]:
            ms = [out["times"][label] for out in ranks]
            log(f"[dist] {label}: {MESH_RANKS} ranks {max(ms):.3f} ms (median of "
                f"{MESH_REPEATS}, host clock to a synchronize and a barrier; slowest rank) "
                f"vs SimComm {sim_ms[label]:.3f} ms on {self.card_name}")
        wire = [out["wire"] for out in ranks]
        log(f"[dist] the wire: {sum(w['messages'] for w in wire)} messages, "
            f"{sum(w['bytes_sent'] for w in wire)} bytes sent, "
            f"{sum(w['staged_bytes'] for w in wire)} bytes staged through pinned host memory; "
            f"staging {sum(w['staging_seconds'] for w in wire):.3f} s over the ranks "
            f"(max {max(w['staging_seconds'] for w in wire):.3f} s a rank), exchanges "
            f"{max(w['exchange_seconds'] for w in wire):.3f} s a rank at most")
        peak_gb = [max(out["peaks"].values()) for out in ranks]
        log(f"[dist] torch.cuda.max_memory_allocated a rank (GB): "
            f"{[round(gb, 3) for gb in peak_gb]}, with the rank's {ranks[0]['data_gb']:.3f} GB "
            f"of input blocks held throughout; by route on rank 0: "
            + ", ".join(f"{k} {v:.3f}" for k, v in ranks[0]["peaks"].items()))
        failures = [out["guard"][0] for out in ranks]
        lines = [ln for ln in ranks[0]["guard"][1].splitlines()
                 if ln.startswith("[retrace-guard]")]
        check(failures == [0] * MESH_RANKS and len(lines) == 19 and
              all(ln.endswith(": ok") for ln in lines),
              f"the retrace guard in the world: failures {failures}, lines {lines}")
        check(sum(ln == "[retrace-guard] ft_allreduce: ok" for ln in lines) == 2,
              "the guard in the world printed no ShardMapComm ft_allreduce line")
        for ln in lines:
            log(ln)
        log(f"[dist] the retrace guard in the {MESH_RANKS}-rank world: 19 lines ok "
            f"({max(out['guard'][2] for out in ranks):.1f} s a rank)")
        replay.clear()       # the later phases capture their programs cold
        log(f"[dist] ranks took {max(out['cases_s'] for out in ranks):.1f} s for the cases, "
            f"{max(out['rank_s'] for out in ranks):.1f} s in all before phase 13b's body; the "
            f"world {t_world:.1f} s from spawn to the last result, phase 13b's body included; "
            f"phase 13 took "
            f"{time.perf_counter() - t_phase:.1f} s")

    def psgd_mesh_path(self) -> None:
        """Phase 13b: check what :func:`psgd_mesh_rank` returned in each of
        phase 13's ranks, on a 2 x 4 data x model mesh of that world: the
        entry point's example through its own report and loss
        check, the validity bits of the fault step, the byte counts against
        the reference's formulas, ĝ and the weights the same bits on each
        line where the reference makes them so, ``compress_grad`` at
        ``tests/test_spmd.py:121``'s sizes within that test's tolerance of
        the dense data-mean, no port kernel launched; then time
        ``compress_grad`` on SimComm(M) on the same block size."""
        import io

        import numpy as np

        torch = self.torch
        from repro_torch.collective import SimComm
        from repro_torch.launch import powersgd_dp
        from repro_torch.optim import powersgd

        t_phase = time.perf_counter()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        D, M = powersgd_dp.D, powersgd_dp.M
        olmo = (self.olmo["d_model"], self.olmo["d_ff"])
        log(f"[psgd dist] phase 13's {MESH_RANKS} ranks as a {D} x {M} data x model mesh on "
            f"{self.card_name}, gloo, host-staged")
        ranks = self.psgd_ranks
        check([out["rank"] for out in ranks] == list(range(MESH_RANKS)), "ranks out of order")
        check([out["coords"] for out in ranks] == [divmod(i, M) for i in range(MESH_RANKS)],
              f"mesh coordinates {[out['coords'] for out in ranks]}")

        def bits(a, b) -> bool:
            return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
                a.view(np.int32), b.view(np.int32))

        # -- the entry point's example at its widths ---------------------------
        ex = [out["example"] for out in ranks]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ok = powersgd_dp.report(ex)
        for line in filter(None, buf.getvalue().splitlines()):
            log(f"[psgd dist] {line}")
        check(ok, f"the example's loss check: final {ex[0]['losses'][-1]:.5f} against the first "
              f"{ex[0]['losses'][0]:.5f}")
        check(all(np.isfinite(e["losses"]).all() for e in ex), "a non-finite loss")
        valid = [e["valid_at_fault"] for e in ex]
        check(valid == [True] * MESH_RANKS, f"validity at the fault step {valid}")
        m_rows = powersgd_dp.DIN // M
        want = (4 * powersgd_dp.RANK * (m_rows * M + powersgd_dp.DH),
                4 * m_rows * M * powersgd_dp.DH)
        check(all(e["bytes"] == want for e in ex), f"byte counts {ex[0]['bytes']} != {want}")
        for mi in range(M):
            line = [i for i in range(MESH_RANKS) if i % M == mi]
            for key in ("g1_hat", "w1"):     # e is each data replica's own
                check(all(bits(ex[i][key], ex[line[0]][key]) for i in line),
                      f"model index {mi}: {key} differs across the data line {line}")
        for key in ("w2", "q"):
            check(all(bits(e[key], ex[0][key]) for e in ex), f"{key} differs across the ranks")
        check(all(e["losses"] == ex[0]["losses"] for e in ex), "the ranks' losses differ")
        step_ms = [statistics.median(e["step_s"]) * 1e3 for e in ex]
        wire = [out["example_wire"] for out in ranks]
        log(f"[psgd dist] example ({powersgd_dp.STEPS} steps, fault at "
            f"{powersgd_dp.STEPS // 2}): every rank valid at the fault step, bytes {want} == "
            f"4·r·(m·M + n), 4·m·M·n; ĝ and w1 the same bits on each data line, w2 and S̄ on "
            f"all {MESH_RANKS}; a step {max(step_ms):.3f} ms (median, slowest rank, host clock "
            f"to the loss's float()); {max(out['example_s'] for out in ranks):.1f} s a rank; "
            f"wire {sum(w['messages'] for w in wire)} messages, "
            f"{sum(w['bytes_sent'] for w in wire)} bytes sent, staging "
            f"{max(w['staging_seconds'] for w in wire):.3f} s and exchanges "
            f"{max(w['exchange_seconds'] for w in wire):.3f} s a rank at most")

        # -- compress_grad at tests/test_spmd.py:121's sizes -------------------
        errs = [out["spmd"][0] for out in ranks]
        check(all(out["spmd"][1] and out["spmd"][2] for out in ranks),
              f"compress_grad at {PSGD_MESH_SPMD}: ĝ vs the dense data-mean {max(errs):.3e} "
              f"past {PSGD_MESH_SPMD_TOL} (+ rel), or a rank invalid")
        for mi in range(M):
            check(bits(ranks[mi]["spmd"][3], ranks[M + mi]["spmd"][3]),
                  f"compress_grad at {PSGD_MESH_SPMD}: ĝ differs across data line {mi}")
        log(f"[psgd dist] compress_grad (D, M, m_loc, n, r) = {PSGD_MESH_SPMD}: ĝ against the "
            f"dense data-mean {max(errs):.3e} max abs (limit {PSGD_MESH_SPMD_TOL} + "
            f"{PSGD_MESH_SPMD_TOL}·|mean|), every rank valid, the same bits on each data line")

        # -- compress_grad at olmo-1b's MLP projection, against SimComm --------
        n_rows, n_cols = olmo
        m_loc = n_rows // M
        sim = SimComm(M, DEVICE)
        stack = self.randn((n_rows, n_cols), PSGD_MESH_SEEDS["olmo"]).reshape(M, m_loc, n_cols)
        for rank in PSGD_MESH_RANKS:
            rows = [out["olmo"][rank] for out in ranks]
            want = (4 * rank * (m_loc * M + n_cols), 4 * m_loc * M * n_cols)
            check(all(t["valid"] and t["finite"] and t["bytes"] == want for t in rows),
                  f"compress_grad {n_rows} x {n_cols} rank {rank}: valid, finite, bytes {want}: "
                  f"{[(t['valid'], t['finite'], t['bytes']) for t in rows]}")
            for mi in range(M):
                check(rows[mi]["ghat_sha"] == rows[M + mi]["ghat_sha"],
                      f"compress_grad rank {rank}: ĝ differs across data line {mi}")
            check(len({t["q_sha"] for t in rows}) == 1, f"compress_grad rank {rank}: S̄ differs")
            cfg = powersgd.PowerSGDConfig(rank=rank)
            state = {"q": self.randn((n_cols, rank), PSGD_MESH_SEEDS["basis"]),
                     "e": torch.zeros_like(stack)}

            def sim_call(cfg=cfg, state=state):
                return powersgd.compress_grad(
                    stack, state, sim, cfg=cfg,
                    psum_data=lambda v: v, n_data=1,
                    psum_model=lambda v: v.sum(0, keepdim=True).expand(v.shape))

            sim_ms, lo, hi = self._median_ms(sim_call)
            slow = max(rows, key=lambda t: t["ms"])
            log(f"[psgd dist] compress_grad {n_rows} x {n_cols} (olmo-1b's MLP projection), rows "
                f"over model = {M}, data = {D}, rank {rank}: {slow['ms']:.3f} ms a call (median of "
                f"{MESH_REPEATS}, slowest rank, host clock to a synchronize and a barrier), of it "
                f"exchanges {slow['exchange_ms']:.3f} ms and host staging "
                f"{slow['staging_ms']:.3f} ms; {slow['bytes_sent']} bytes sent a rank a call; "
                f"peak allocation a rank (GB) {[round(t['peak_gb'], 3) for t in rows]} | "
                f"SimComm({M}) on data replica 0's {M} x {m_loc} x {n_cols} stack, one process, "
                f"no data-axis sum: {sim_ms:.3f} ms (min {lo:.3f}, max {hi:.3f}, 5 warm runs) "
                f"on {self.card_name}")
            del state
        del stack
        total = dict.fromkeys(ranks[0]["launches"], 0)
        for i, out in enumerate(ranks):
            check(not any(out["launches"].values()),
                  f"rank {i} launched a port kernel on the PowerSGD path: {out['launches']}")
            for k, v in out["launches"].items():
                total[k] += v
        self.launches["psgd_mesh"] = total
        log(f"[psgd dist] no port kernel launched on any rank (form_q without use_pallas, the "
            f"local QR on torch.linalg, as the reference's 'jnp' route); its body took "
            f"{max(out['rank_s'] for out in ranks):.1f} s a rank inside phase 13's world; its "
            f"checks and SimComm's times here {time.perf_counter() - t_phase:.2f} s")

    def kernel_rows(self) -> list[dict]:
        rows = []
        for name in self.kernels:
            t = self.times[(name, KERNEL_SHAPE[name])]
            rows.append({
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{name}.cu",
                "replaces": REPLACES[name],
                "launches": self.launches[KERNEL_PATH[name]][name],
                "path": KERNEL_PATH[name],
                "launches_by_path": {path: counts[name]
                                     for path, counts in self.launches.items()},
                "max_abs_err": self.errors[name],
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "shape": t["shape"], "ptxas": self.ptxas.get(name),
                **{k: t[k] for k in ("two_calls_ms", "library_note") if k in t},
            })
        return rows


if __name__ == "__main__":
    sys.exit(main())
