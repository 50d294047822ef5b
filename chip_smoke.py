#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one NVIDIA H100.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failed check exits non-zero; no phase is skipped):
  1. build every CUDA kernel from src/repro_torch/csrc (one nvcc each,
     all in parallel);
  2. hold each kernel against its plain PyTorch version on the card, at
     the shapes of the main path (N = 463,715 YearPredictionMSD-sized
     rows, d = 91, L = 100, K = 5; probes at B in {1, 16}, J in {1, 3}),
     and time kernel, plain version and the PyTorch library call; each
     probe row carries its kernel's registers and spill bytes from the
     build log, and the B 1 multi row a J 1 launch with the masks'
     2,116-byte parameter block against the same kernel built with a
     64-byte one (-DPROBE_MASK_SLOTS=16), timed in turns.  The simhash
     row carries its launch plan, its instantiation's registers, spills
     and shared memory (no simhash instantiation may spill), ``x @ w``
     through torch.matmul timed as a yardstick, and two checks: a second
     call gives the same bits, and 16 rows of x probed as queries find
     their own codes in the index sorted from simhash's, bitwise;
  3. a small-input reference check: the same index build and 20 LGD
     steps, with the same draws, on the card and on the CPU's plain path;
  4. the main path: ``init`` + 300 ``lgd_step`` + 300 ``sgd_step`` at
     N = 463,715 for the quadratic, srp and mips families x multiprobe
     {0, 2}, with the kernels' launch counts set to 0 just before and
     read just after: every kernel must have run, ``draw_assemble`` once
     a step (300 a run);
  5. a torch.profiler trace of 50 steady LGD steps per family: device
     time per step, the device's idle share and the top kernels.

The LM serving slice adds, each after the phase it extends:
  2b. the flash-attention and flash-decode kernels against their plain
      versions at the phi4-mini serve shapes (B = 4, Hkv = 8, G = 3,
      D = 128; prompt S = 2,048, cache S = 2,560 with kv_len
      [1, 777, 2048, 2560]), in f32 and bf16, timed beside the plain
      version and torch's scaled_dot_product_attention, with each row's
      TFLOP/s and share of its bound.  Decode is timed cold: kernel,
      plain version and SDPA each cycle through L2_SETS distinct
      (q, K, V) sets larger together than the L2, as the serve path's
      32 layers' caches are; the same-tensor (L2-warm) times stand
      beside them, with the split-KV plan (chunk, splits, blocks).  Then
      the registers, spills and shared memory of the bf16 prefill
      (tensor cores) and of the bf16 decode at D = 128 from the build
      log, which must show no spill;
  3b. a small-input check: phi4-mini SMOKE (f32) with the same weights on
      the card (kernels) and the CPU (plain versions), prefill of 2 x 256
      tokens and 8 teacher-forced decode steps;
  4b. the serve path at full width: phi4-mini FULL in bf16 (32 layers,
      random weights), B = 4, prompt 2,048, 512 greedy decode steps,
      through the functions ``python -m repro_torch.serve --size full``
      calls, with the launch counts set to 0 just before and read just
      after (32 flash_attention, 16,384 flash_decode); then the prompt
      and the first 32 decode steps again, teacher-forced, on the kernel
      path (bitwise the timed call), with attn_impl="ref" in bf16 and in
      f32 on the card (``serve_arch_full_width``, shared with 4g);
  5b. a torch.profiler trace of 20 steady decode steps at full width,
      with flash_decode's device ms per step.

The LM training slice adds:
  2c. the gather_weight kernel against its plain version, bitwise (rows
      and weights), at the train path's shape (N = 2,048, S+1 = 513,
      m = 8) and a large one (N = 463,715, m = 512), with duplicate ids
      and probabilities below p_floor; timed beside the plain version
      and ``index_select``;
  2d. the draw_assemble kernel (Algorithm 1 after the probe, and the
      gather and weight, in one launch) against the sampler's plain
      composition on the card with the same draws: at the LGD shapes
      (srp and quadratic laws, B in {1, 16}, J in {1, 3}, m 16, P 200)
      and at the train shape with its store (d 3,072, K 7, L 10,
      N 2,048, m 8, S+1 513); ids, walk results and rows bitwise, p and
      weights within DRAW_RTOL (the worst case printed with its cosine),
      two calls bitwise equal, ptxas's registers and spills (no spill
      allowed); timed beside the plain composition and, at the train
      shape, ``index_select`` of the rows (the gather alone);
  3c. a small-input check: phi4-mini SMOKE (f32) with the same weights
      on the card (kernels) and the CPU (plain versions): the LGD index
      build, then 5 ``next_batch`` + trainer steps with the same injected
      draws and queries;
  4c. the train path at full width: phi4-mini FULL in bf16, batch 8 x
      512 tokens from a 2,048-example corpus, Adam, 20 LGD steps with an
      async refresh (launched at step 9, swapped in at step 10; a step
      hook then stops the schedule, so none is launched at step 19 to be
      joined at teardown), through the functions
      ``python -m repro_torch.launch.train --arch phi4_mini_3_8b --full
      --lgd`` calls, with the launch counts set to 0 just before and
      read just after (draw_assemble 20, bucket_probe >= 20, simhash 2;
      the standalone gather_weight, held in 2c, is off the path); every
      refresh returned True with no health transition; the refreshes'
      device ms and host wait, the boundary steps beside the steady p50;
      then the probe and simhash kernels against their plain versions at
      the train path's shapes (d 3,072, K 7, L 10, N 2,048), timed, the
      simhash row with phase 2's plan, ptxas, yardstick and checks;
  5c. a torch.profiler trace of 2 steady training steps.
4c and 5c run last, after the serve model of 4b/5b is freed: the train
state (bf16 weights and grads, f32 Adam moments) takes ~53 GB.

The streaming slice adds:
  2c. simhash at the delta refresh's shapes (N in {64, 256}, d 3,072,
      L·K 70) against its plain version, with the train-shape row's
      checks, plan, registers and spills;
  2d. draw_assemble on a streaming index at the train shape (capacity
      2,048, 1/2 and 1/8 of the slots evicted, queries far from every
      live row, so most walks fall back to the live prefix, n_live by
      value): ids, walk results and rows bitwise, p and weights within
      DRAW_RTOL, the fallback share and the time;
  3d. a small-input check of the streaming pipeline, card against CPU
      (``streaming_card_vs_cpu``);
  4d. the streaming path at full width, after 5c on the same model:
      phi4-mini FULL in bf16, batch 8 x 512, Adam, corpus 2,048 with
      window 2,048, delta refresh every 5 steps, async, 20 steps; 128
      rows appended at steps 4, 8, 12 and 16 (the window evicts the
      oldest), 64 evicted at step 10; launch counts (draw_assemble 20,
      bucket_probe >= 20, simhash >= 1 per build, append and delta
      refresh), every refresh returned True with no health transition,
      losses finite, batch-mean weights 1 +- 1e-5, every drawn id live
      at its step, and the final index: order[t, :n_live] the live
      slots, the sentinel tail, sorted_codes bitwise a fresh stable sort
      of hash(features) masked by the live mask with the same ids per
      code; the delta refreshes' rows and device ms, the append ms per
      row, the steady step p50 and the peak memory.

The banded slice (the mips_banded family and the LSH decode head) adds:
  2e. draw_assemble's band mode against the plain composition on the
      card with the same draws: the LGD shape with mips_banded
      (N 463,715, K 5, L 100, nb 8, B in {1, 16}, J in {1, 3}, m 16,
      P 200), the head shape (N 200,064, aug d 3,074, K 12, L 8, J 3,
      B 4, m 32, P 16) and a streaming row with band 3 evicted empty;
      ids, walk results and bands bitwise, p within DRAW_RTOL, two calls
      bitwise equal, registers and spills, timed beside the plain
      composition, and the flat 2d main row beside PERF.md's time;
  3e. a small-input check, card against CPU: phi4-mini SMOKE (f32) with
      the same weights and projections: the head index's sorted codes
      and order bitwise (hashing the CPU's x_aug), the shortlist ids and
      valid bitwise, 8 lsh_decode_step tokens equal; and (in phase 3's
      loop) a mips_banded LGD index build and 20 steps with the same
      draws;
  4e. the serve path with ``--head lsh`` at full width, on 4b's model:
      phi4-mini FULL in bf16, B 4, prompt 2,048, 512 greedy steps through
      the functions ``python -m repro_torch.serve --size full --head
      lsh`` calls, counts set to 0 just before the index build and read
      after the run (flash_attention 32, flash_decode 16,384,
      bucket_probe_codes one per emitted token, simhash 1); every token
      in the vocabulary and equal to the masked argmax recomputed in f32
      over its own candidates; the index build time, decode p10/p50
      beside 4b's, the head's device ms beside the full lm_logits, a
      profile of 20 steady steps, the first tokens' agreement with the
      full head, recall@1 on 256 planted queries, peak memory; then
      mips_banded x mp {0, 2} through phase 4's LGD path (300 steps,
      draw_assemble 300, bucket_probe_codes >= 300, losses finite; the
      loss trend reported, not gated: on a pareto-noise corpus the
      reference's own banded loss rises where plain mips falls, and the
      port follows it, as tests/test_torch_banded.py shows), and 300
      banded steps on the card, each from the CPU's state, held against
      the CPU's plain step on the same data, index and draws.

The training-stack slice (checkpoints, Adam8bit, gradient compression,
the step hook) adds:
  3f. a small-input check, card against CPU (``training_stack_card_vs_
      cpu``): phi4-mini SMOKE (f32), the same weights and injected draws
      as 3c; 5 LGD trainer steps with Adam8bit and grad_compress, each
      from the CPU's state (losses within SMOKE_TRAIN_RTOL; compressed
      gradients and int8 moments equal but for values one apart at a
      rounding edge, counted; params within rtol 1e-4, atol 1e-6 outside
      the blocks whose compressed gradient differs); the card trainer's
      checkpoint passing the CPU's verify and restoring bitwise on the
      CPU; 4 steps of the LSH head's sampled loss through
      TrainerConfig(step_hook=head.step_hook) with a refresh every 2
      (refreshes at the same steps, losses within SMOKE_TRAIN_RTOL);
  4f. the slice at full width after 4d (``training_stack_full_width``):
      phi4-mini at full width and 8 of its 32 layers in bf16, from
      seed-0 weights, batch 8 x 512, corpus 2,048, 4c's LGD sampler
      recipe with its refresh schedule off (none in these 10 steps),
      Adam8bit.  Run A trains 5
      steps and checkpoints asynchronously at step 5 (keep 1); runs B
      and C, fresh trainers with resume=True on the same model and
      sampler, restore step 5 through latest_valid_step, restore_at(5)
      and train steps 6-10.  Checked: every manifest CRC32 on the
      restored tensors, B's and C's ids bitwise at every step, their
      losses (step 6 bitwise, then within RESUME_RTOL), every loss
      finite, draw_assemble 5 a run, simhash >= 1 a restore; then a
      flipped manifest byte fails verify, latest_valid_step is None and
      a fourth trainer starts at step 0.  A disk too small for the
      checkpoint fails the run.  Printed: the checkpoint's bytes against
      the free disk, snapshot / serialisation / verify / restore /
      restore_at seconds, the step p50, the peak memory; then the
      script's total seconds.

The other-mixers slice (Mamba-2, mLSTM, sLSTM, MoE, cross-attention,
shared attention, the embed_stub frontend) adds:
  2g. 2b's rows at the other archs' head shapes (NEW_HEADS: Hkv 32, G 1,
      D 64 for zamba2 and musicgen; Hkv 4, G 16, D 64 for qwen3; Hkv 8,
      G 5 and G 8, D 128 for llama4 and llama-3.2-vision), B 4, prompt
      2,048, cache 2,080 with kv_len [1, 777, 2048, 2080], f32 and bf16,
      2b's limits, timed beside the plain version and SDPA (decode with
      a cold L2); then the registers, spills and shared memory of every
      D 64 instantiation from the build log, none of which may spill;
  3g. a small-input check per arch (``other_arch_card_vs_cpu``): its
      SMOKE config (f32) on the card and on the CPU with the same
      weights, prefill of 2 x 64 tokens or embeddings (8 image patches
      for the vision arch), 8 teacher-forced decode steps, logits within
      3b's limits, the flash kernels once a self-attention layer a call;
  4g. each arch served at full width through the functions ``python -m
      repro_torch.serve --size full [--layers N]`` calls
      (``serve_arch_full_width``): zamba2, xlstm and musicgen whole,
      qwen3 at 4 of 94 layers, llama4 at 1 of 48, llama-3.2-vision at 5
      of 100 with 1,024 image patches; B 4, prompt 2,048, 32 greedy
      steps; counts set to 0 just before and read just after
      (flash_attention 2 / 0 / 48 / 4 / 1 / 5, flash_decode 32 times
      that); every logit finite; the agreement of 4b against an f32 run,
      and against the plain bf16 path within KERNEL_VS_REF_LIMIT (zamba2
      besides it, llama4 instead of it); prefill s, decode p10 / p50,
      peak memory, layers run of the config's.  Each arch is freed
      before the next is built.

The sharded slice (shard-by-example LGD on one card) and training the
other archs add:
  3h. a small-input check of ``ShardedLSHPipeline`` at S = 4 on
      ``train_lm``'s demo preset (``sharded_card_vs_cpu``): the card's
      pipeline on the CPU's projections and indexes, 5 batches with the
      same draws and query: ids, tokens, targets and shard_ids bitwise,
      weights within rtol 1e-5, 4 probes and 4 draw_assembles a step;
      on the card, owners [0, 1] + [2, 3] composing bitwise into full
      ownership, adopt_shards([2, 3], 5) drawing what full ownership
      draws, two rebuild_sharded_pipeline calls onto S 2 alike;
  3i. every arch ``launch.train`` takes (musicgen, embed_stub, it
      refuses), SMOKE (f32), 3 steps card vs CPU from the same weights
      on the same uniform batches (``train_archs_card_vs_cpu``): losses
      within SMOKE_TRAIN_RTOL, every parameter within 1e-4 (relative L2);
  4i. the other archs trained at full width on LGD batches (srp, K 7, L
      10, 8 x 512 tokens, async refresh; a corpus of 512 rows), 6 steps
      with one refresh at step 3 (``train_arch_full_width``): zamba2 and
      xlstm whole with Adam, qwen3 at 2 of 94 layers and
      llama-3.2-vision at 5 of 100 with Adafactor (the reference
      dryrun's choice for its giant archs); llama4's one layer is held
      against the card's memory first and, needing 94.5 GB, not run: its
      arithmetic is printed.  Checked: launches (draw_assemble and
      bucket_probe 6, simhash 2), the refresh swapped in healthy,
      losses finite, batch-mean weights 1 +- 1e-5.  Reported: build s,
      step p10 / p50, the refresh's device span, peak memory, a profiled
      step by kind, and the backward of the chunked core and of the MoE
      FFN traced alone (``mixer_backwards``);
  4h. 4c's recipe through a ``ShardedLSHPipeline`` of 4 shards, after 4f,
      on phi4-mini at full width and 8 of its 32 layers, from seed-0
      weights (``sharded_full_width``): 12 steps, a refresh at step 10,
      exactly 4 probes and 4 draw_assembles a step and 4 simhash a build
      and a refresh; each shard's build and refresh device span, step
      p10 / p50, peak memory, the batch-mean weight and fallback share
      per shard and composed; a checkpoint of the weights at step 10,
      restored, and one rebuild_sharded_pipeline onto S 2 timed with its
      rescale_plan(4, 2, 8).

The multi-process slice (``repro_torch.dist.multihost`` and its worker)
adds:
  3j. the worker as two processes on the card (``python -c`` children
      running ``mh_worker_main``), over a TCPStore on a free local port
      and a gloo group, on the reference worker's tiny stack
      (``multihost_card``): (a) no fault, 10 steps, a sync every 5: both
      ranks healthy in generation 0, each rank's first batch bitwise its
      shard's rows of a one-process ShardedLSHPipeline(n_shards=2)'s
      first batch built here from the same weights; (b) the host-loss
      drill of tests/test_multihost.py:720-731 (rank 1 killed at step 12
      of 20, a sync every 5, a checkpoint every 10, 4 degraded and 6
      post-reform steps): rank 1 exits 17, rank 0 exits 0 having walked
      [missing-host-degraded, reformed] with dead [1], shard 1 adopted
      once, one reform shard and the writer fence held, restore step <=
      incident + 4, finite positive degraded weight means, and
      ``replay_post_reform`` here gives its post-reform digest and
      losses bitwise.  Each process's launches at its exit: one
      bucket_probe and one draw_assemble a draw for each owned shard,
      simhash >= 1;
  4j. after 4i, the same at full width (``multihost_full_width``): two
      processes share the card, each on zamba2 whole (bf16, Adam, 256
      corpus rows and 8 x 512 tokens a process, the worker's sync refresh
      every 10 steps).  A fault-free run (5 steps, the sync and an 11 GB
      checkpoint at step 5) must show no incident; its longest barrier
      wait and longest gap between a rank's beats set the drill's barrier
      and heartbeat timeouts, printed beside them; then 3j(b)'s drill
      and checks.  Reported: each process's build s, step p10 / p50 with
      two processes on the card beside 4i's one-process zamba2 p50, each
      sync's ms with the gloo all-reduce inside it, kill to
      HostLossDetected, the adoption build, reform to first step, the
      checkpoint's bytes, each process's peak memory.
Each phase prints the second it starts at.

Imports torch, numpy and repro_torch only.  Without a CUDA device, or
without the repository around it, it exits non-zero and prints no
result.  The last line is the JSON result; the lines before it carry
every measurement (probe rows, paths, profiles, the kernels table).
"""

from __future__ import annotations

import functools
import gc
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_TRAIN = 463_715          # public YearPredictionMSD train split
STEPS = 300
FAMILIES = ("quadratic", "srp", "mips")
# the banded slice: the LM head's vocabulary at phi4-mini FULL, and the
# planted queries of 4e's recall (tests/test_sampled_softmax.py:219)
HEAD_ROWS, RECALL_QUERIES = 200_064, 256


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# The H100 SXM's peaks (NVIDIA data sheet, dense), which every bound
# assumes: fp32 FLOP/s outside the tensor cores, and HBM bytes/s.
CARD = "NVIDIA H100 80GB HBM3"
FP32_PEAK = 67e12
BF16_PEAK = 989e12      # dense bf16 tensor-core FLOP/s
HBM_RATE = 3.35e12
# the probe kernel built with 16 mask slots by value, a 64-byte block in
# place of the default 2,116 (phase 2's J 1 parameter-block comparison)
COMPACT_MASKS = ("-DPROBE_MASK_SLOTS=16",)
LGD_KERNELS = ("simhash", "bucket_probe", "bucket_probe_multi",
               "bucket_probe_codes", "draw_assemble")
# phase 2d: p and the weights of draw_assemble against the plain
# composition.  The kernel sums x.q, x.x and q.q in another order than
# torch and calls acosf and powf, so p parts in its last bits, and
# (1 - cp^K)^(l-1) multiplies that by up to l - 1 < 200
DRAW_RTOL = 1e-4

# the LM train path (phases 2c, 3c, 4c, 5c): the reference launcher's
# defaults with 512-token rows
TRAIN_BATCH, TRAIN_SEQ, TRAIN_CORPUS, TRAIN_STEPS = 8, 512, 2048, 20
TRAIN_REFRESH = 10
# 3c: losses of the f32 SMOKE model, card vs CPU, on bitwise-equal
# tokens and weights within 1e-6: sums in another order, compounded
# over 5 Adam steps
SMOKE_TRAIN_RTOL = 1e-4
# 4f: losses of two trainers resumed from one checkpoint, steps 7-10 (step
# 6, a forward from bitwise-equal state, must be bitwise equal)
RESUME_RTOL = 1e-3

# the LM serve path (phases 2b, 4b, 5b): phi4-mini's attention shapes
SERVE_ARCH = "phi4_mini_3_8b"
SERVE_B, SERVE_PROMPT, SERVE_NEW = 4, 2048, 512
HKV, GROUP, D_HEAD = 8, 3, 128
CACHE_LENS = [1, 777, 2048, 2560]
# Phase 2b's limits, (rtol, atol) of kernel against plain version.  f32:
# the same arithmetic in another order.  bf16: kernel and plain version
# each round an f32 result once, so they may part by one bf16 ulp, at
# most 2^-7 |want|; the limit is two ulps (rtol 2^-6), plus an atol of
# 1e-4 for outputs near zero, 100x the f32 sums' own error (the f32
# rows' max |err| is ~1e-6).  A bf16 kernel must also be as close to the
# f32 result (the plain version on the upcast inputs) as the plain bf16
# version is: its max |err| from it at most BF16_GOLD_FACTOR times that.
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -6, 1e-4)}
BF16_GOLD_FACTOR = 1.5
# phase 2b times decode over this many distinct (q, K, V) sets, cycled,
# so that each call finds its cache in HBM and not in the 50 MB L2
L2_SETS = 4
# full width: the kernel path's distance from an f32 run may be at most
# this multiple of the plain bf16 path's distance from it
FULL_WIDTH_FACTOR = 1.25

# the other archs (phases 2g, 3g, 4g).  2g: the (Hkv, G, D) each runs the
# flash kernels at, B 4, prompt 2,048, a cache of 2,080 rows
NEW_HEADS = {"zamba2/musicgen": (32, 1, 64), "qwen3": (4, 16, 64),
             "llama4": (8, 5, 128), "llama-3.2-vision": (8, 8, 128)}
NEW_CACHE_LENS = [1, 777, 2048, 2080]
# 4g: each arch at full width, the layers run (a whole number of its
# block pattern; None: all), B 4, prompt 2,048, NEW_STEPS greedy steps
NEW_ARCHS = {"zamba2_1_2b": None, "xlstm_350m": None, "musicgen_large": None,
             "qwen3_moe_235b_a22b": 4, "llama4_maverick_400b_a17b": 1,
             "llama_3_2_vision_90b": 5}
NEW_STEPS = 32
# 4g: the relative L2 distance of the kernel path from the plain bf16
# path, gated for these archs besides (or, for llama4, instead of) the
# comparison with an f32 run.
KERNEL_VS_REF_LIMIT = {
    # one layer; its f32 copy, ~73 GB, does not fit beside the bf16 one.
    # The two paths part where an f32 attention output rounds to another
    # bf16 neighbour (one ulp, 2^-8 relative at most, on a share of the
    # elements), which the residual and one MoE FFN carry on at about
    # that size; the limit is 2^-6, four ulps.  A wrong mask or a dropped
    # tile moves a row by O(1), and so would a token routed to another
    # expert (reported, if it happens, by the argmax agreement).
    "llama4_maverick_400b_a17b": 2 ** -6,
    # 36 Mamba-2 layers carry a bf16 rounding into an O(1) change of their
    # state, so both bf16 paths sit ~0.64 from the f32 run (this phase on
    # an H100 SXM at 700 W) and FULL_WIDTH_FACTOR alone would pass the
    # kernel path up to ~0.8.  The two bf16 paths stay 0.019-0.020 apart
    # at the gated views (the same runs; the same seed reads the same to
    # four digits); the limit, 2^-5, is 1.6x that, so an error of the
    # D 64 kernels at the shared block's shape above ~1% of the hidden
    # state fails the run.
    "zamba2_1_2b": 2 ** -5,
}

# the sharded slice (phases 3h, 4h): S per-shard indexes in one process.
# 4h: 4c's recipe with S 4 (2 rows and 512 corpus rows a shard), 12 steps
# and a refresh at step 10, a checkpoint of the weights at step 10, then
# one rebuild onto RESHARD shards
SHARDS, SHARD_STEPS, SHARD_REFRESH, RESHARD = 4, 12, 10, 2
# 4f and 4h run phi4-mini at full width but CUT_LAYERS of its 32 layers:
# their index builds, refreshes, rebuilds and checkpoint I/O scale with
# depth (at 32 layers 4f took 235 s of the script and 4h 148 s)
CUT_LAYERS = 8
# training the other archs (phases 3i, 4i).  3i: SMOKE, 3 steps card vs
# CPU; 4i: full width, LGD batches (srp, K 7, L 10, 8 x 512 tokens, async
# refresh), ARCH_STEPS steps with one refresh at step ARCH_REFRESH, from a
# corpus of ARCH_CORPUS rows (the launcher's 2,048 cut to bound the index
# build); the layers each trains (a whole number of its block pattern;
# None: all)
ARCH_STEPS, ARCH_REFRESH, ARCH_CORPUS = 6, 3, 512
TRAIN_ARCHS = {"zamba2_1_2b": None, "xlstm_350m": None,
               "qwen3_moe_235b_a22b": 2, "llama_3_2_vision_90b": 5,
               "llama4_maverick_400b_a17b": 1}
# src/repro/launch/dryrun.py:56-64 (GIANT_ARCHS, pick_optimizer): the
# archs whose optimiser state must be factored to fit train with
# Adafactor(lr=1e-2); the others with the launcher's Adam
GIANT_ARCHS = {"qwen3_moe_235b_a22b", "llama4_maverick_400b_a17b",
               "llama_3_2_vision_90b"}


# the multi-process slice (phases 3j, 4j): two processes of
# repro_torch.dist.multihost_worker share the card, over a TCPStore on a
# free local port and a gloo group.  The drill is the reference test's
# (tests/test_multihost.py:720-731): rank 1 killed at step 12 of 20, a
# sync every 5, a checkpoint every 10, 4 degraded and 6 post-reform steps
MH_DRILL = ["--steps", "20", "--sync-every", "5", "--ckpt-every", "10",
            "--degraded-steps", "4", "--post-steps", "6"]
MH_KILL_AT = 12
MH_INTACT = ["--steps", "10", "--sync-every", "5", "--ckpt-every", "10"]
# 4j's fault-free run: its one sync meets the checkpoint (rank 0 snapshots
# 11 GB while rank 1 waits at the barrier), the longest legitimate wait
# the drill's step 10 holds too
MH_INTACT_FULL = ["--steps", "5", "--sync-every", "5", "--ckpt-every", "5"]
# 4j: the arch 4i trains whole (23.7 GB peak with Adam); a corpus of 512
# rows, 256 a process, and a global batch of 16 (8 x 512 tokens a process,
# 4i's batch); the worker's sync refresh every 10 steps
MH_ARCH, MH_CORPUS, MH_BATCH, MH_REFRESH = "zamba2_1_2b", 512, 16, 10
# 4j's fault-free run: windows wide enough that no legitimate wait ends
# it; the drill's timeouts come from the waits it measures
MH_WIDE_TIMEOUTS = ["--barrier-timeout", "600", "--heartbeat-timeout",
                    "1200"]
MH_PAIR_TIMEOUT_S = 600
# a worker process: python -c MH_CHILD <repo> <repo>/src <stack> <args>
MH_CHILD = ("import sys; sys.path[:0] = sys.argv[1:3]; import chip_smoke; "
            "chip_smoke.mh_worker_main(sys.argv[3:])")


# device-time classes of a trace, by substrings of the kernel's name
KERNEL_KINDS = (
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
    ("hand-written", ("simhash_kernel", "probe", "flash_", "gather_weight",
                      "draw_assemble")),
    ("copy", ("Memcpy", "Memset", "copy_kernel")),
    ("reduce", ("reduce_kernel", "logsumexp", "softmax", "norm_kernel")),
    ("index", ("index", "gather", "scatter", "embedding")),
    ("elementwise", ("elementwise", "where", "fill")),
)


def time_ms(torch, fn, reps: int, warmup: int = 3) -> dict:
    """Time ``reps`` calls of ``fn`` two ways.

    ``ms``: device time per call — the summed duration of every device
    activity (kernels, copies) the calls make, from a torch.profiler
    trace; the number the kernel table reports.  ``loop_ms``: CUDA
    events around back-to-back calls, which for a kernel of a few
    microseconds measures the host's dispatch instead.  Where the
    profiler sees no device activity, ``ms`` is the loop time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    loop_ms = start.elapsed_time(end) / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    device_us = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"ms": device_us / 1e3 / reps if device_us else loop_ms,
            "loop_ms": loop_ms, "timed_by": "profiler" if device_us
            else "events"}


def bound(nbytes: float, flops: float, peak: float = FP32_PEAK):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``nbytes`` and do ``flops`` at ``peak`` operations per second."""
    t_bytes, t_ops = nbytes / HBM_RATE, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# the simhash kernel's sum modes, the CUDA source's enum Mode in order
SIMHASH_MODES = ("one", "reg_parts", "split_parts")


def simhash_label(inst: dict) -> str:
    """"<rows> rows, <mode>[, 16-byte x][, narrow]": a simhash kernel
    instantiation (``simhash_instance``'s fields)."""
    return (f"{inst['rows']} rows, {inst['mode']}"
            + (", 16-byte x" if inst["x16"] else "")
            + (", narrow" if inst["narrow"] else ""))


def simhash_usage(build) -> dict:
    """ptxas's registers, spill bytes and static shared memory (its shared
    memory is dynamic: ``simhash_instance``) of each simhash kernel
    instantiation in the build log, by ``simhash_label`` (the mangled
    name where it has no template)."""
    out = {}
    for name, u in build.ptxas_usage(build.build_log("simhash")).items():
        if "simhash_kernel" not in name:
            continue
        m = re.search(
            r"simhash_kernelILi(\d+)E.*?ModeE(\d)ELb([01])ELb([01])E", name)
        label = simhash_label(dict(
            rows=(32 if m[4] == "1" else 16) * int(m[1]),
            mode=SIMHASH_MODES[int(m[2])], x16=m[3] == "1",
            narrow=m[4] == "1")) if m else name
        out[label] = dict(regs=u["registers"],
                          spill=u["spill_stores"] + u["spill_loads"],
                          smem=u["smem"])
    return out


def time_param_blocks(torch, bp_kernel, call, pairs: int = 6) -> dict:
    """A J 1 multi-probe launch, ``call``, with the masks' 2,116-byte
    parameter block against the same kernel built with a 64-byte one
    (COMPACT_MASKS), timed in turns compact, wide, wide, compact, ...:
    device and loop ms per call, the means and each turn's device ms."""
    def through(defines):
        def run():
            orig = bp_kernel._fn
            bp_kernel._fn = functools.partial(orig, defines=defines)
            try:
                return call()
            finally:
                bp_kernel._fn = orig
        return run

    fns = {"compact": through(COMPACT_MASKS), "wide": through(())}
    outs = {tag: fn() for tag, fn in fns.items()}
    if not all(torch.equal(a, c) for a, c in zip(outs["compact"],
                                                  outs["wide"])):
        fail("the probe built with the compact parameter block disagrees")
    seen = {"compact": [], "wide": []}
    for i in range(pairs):
        for tag in ("compact", "wide")[::1 if i % 2 == 0 else -1]:
            seen[tag].append(time_ms(torch, fns[tag], 100))
    out = {}
    for tag, ts in seen.items():
        out[f"{tag}_ms"] = sum(t["ms"] for t in ts) / len(ts)
        out[f"{tag}_loop_ms"] = sum(t["loop_ms"] for t in ts) / len(ts)
        out[f"{tag}_ms_turns"] = [t["ms"] for t in ts]
    out.update(compact_bytes=4 * 16, wide_bytes=4 * bp_kernel.MAX_MASKS)
    return out


def rotate(fns):
    """One callable that calls ``fns`` in turn."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def trace_steps(torch, step, steps: int) -> dict:
    """Trace ``steps`` calls of ``step`` with torch.profiler: wall ms per
    step, device kernel ms per step, the device's idle share and the
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels, spans = [], []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((e.name, e.time_range.elapsed_us()))
            spans.append((e.time_range.start, e.time_range.end))
    # busy time: the union of the activities' intervals, since the sum of
    # their durations can exceed the wall time where activities overlap
    device_us, last = 0.0, float("-inf")
    for start, end in sorted(spans):
        device_us += max(0.0, end - max(start, last))
        last = max(last, end)
    by_name: dict = {}
    by_kind: dict = {}
    for name, us in kernels:
        by_name[name] = by_name.get(name, 0.0) + us
        kind = next((kk for kk, marks in KERNEL_KINDS
                     if any(mk in name for mk in marks)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    if device_us == 0:
        return {"wall_ms_per_step": wall_ms, "device": "not measured"}
    return {
        "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_us / 1e3 / steps,
        "device_idle_share": 1.0 - device_us / 1e3 / steps / wall_ms,
        "device_ops_per_step": len(kernels) / steps,
        "device_summed_ms_per_step": sum(by_kind.values()) / 1e3 / steps,
        "device_summed_ms_per_step_by_kind": {kk: us / 1e3 / steps
                                              for kk, us in by_kind.items()},
        "top_device_us_per_step": [[name[:90], us / steps]
                                   for name, us in top],
    }


def profile_steps(torch, family, ds, make_problem, init, lgd_step,
                  steps: int = 50) -> dict:
    """Trace ``steps`` steady LGD steps (multiprobe 0)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    problem, opt = make_problem(family, 0, "sgd")
    state, xt, yt, xa = init(g, problem, ds.x_train, ds.y_train, opt)
    for _ in range(10):
        state, _ = lgd_step(g, state, xt, yt, xa, problem, opt)

    def step():
        nonlocal state
        state, _ = lgd_step(g, state, xt, yt, xa, problem, opt)

    return trace_steps(torch, step, steps)


# the streaming slice (phases 3d and 4d)
STREAM_STEPS, STREAM_REFRESH, STREAM_APPEND, STREAM_EVICT = 20, 5, 128, 64
STREAM_APPEND_AT, STREAM_EVICT_AT = (4, 8, 12, 16), 10


def refresh_health(sampler, tag: str, swaps: int) -> list:
    """The refreshes' records; fails unless ``swaps`` of them reached their
    swap boundary and every one returned True, with no health transition
    and no failed refresh attempt (a refresh catches any exception and
    degrades to the stale index, so a kernel fault would hide there)."""
    recs = sampler.refresh_records()
    done = [r for r in recs if r["ok"] is not None]
    hs = sampler.health_summary()
    if len(done) != swaps or not all(r["ok"] for r in done) or \
            hs["transitions"] or hs["refresh_failures"]:
        fail(f"{tag}: refreshes {recs}, health {hs} (expected {swaps} "
             f"successful swaps, no transition, no failure)")
    return recs


def streaming_card_vs_cpu(torch, np, dev, cfg_t, seq: int = 64) -> dict:
    """Phase 3d: phi4-mini SMOKE (f32) with the same weights on the card
    and the CPU, a streaming pipeline on each (window 256, delta refresh
    every 4 steps, async with lead 1, drift 0.25) fed the same injected
    draws and drift masks, 10 draws and trainer steps: an append past the
    window (auto-evict 16) at step 2, an explicit evict of 8 during the
    refresh in flight at step 4, an append at step 7, delta refreshes
    swapped in at steps 4 and 8.  The index after each mutation and
    refresh bitwise the CPU's (codes may part only where a projection is
    within 1e-4 of zero, and then the card takes the CPU's index, as in
    3c), drawn ids bitwise, weights within rtol 1e-5, and a second
    restore_at(t) bitwise the first."""
    from repro_torch import kernels
    from repro_torch.core import LSHIndex, draw_samples, \
        hash_points
    from repro_torch.data import (
        LSHPipelineConfig, LSHSampledPipeline, lm_head_query_fn,
        make_token_corpus, mean_pool_feature_fn)
    from repro_torch.models import LM
    from repro_torch.optim import Adam, schedules
    from repro_torch.train import Trainer

    lm_c = LM.init(cfg_t, seed=0, device="cpu")
    lm_g = LM(cfg_t, device=dev)
    lm_g.load_state_dict(lm_c.state_dict())
    toks = make_token_corpus(0, 256, seq, cfg_t.vocab).tokens
    extra = make_token_corpus(1, 32, seq, cfg_t.vocab).tokens

    def drift(r, cap):
        return torch.from_numpy(np.random.default_rng(100 + r).random(cap)
                                < 0.25)

    pcfg = dict(minibatch=TRAIN_BATCH, window=256, refresh_mode="delta",
                refresh_async=True, refresh_lead=1, refresh_every=4,
                drift_frac=0.25)
    pipes = {"cpu": LSHSampledPipeline(
        2, toks, mean_pool_feature_fn(cfg_t), lm_head_query_fn(),
        LSHPipelineConfig(**pcfg), params=lm_c, device="cpu", drift=drift)}
    kernels.reset_launch_counts()
    pipes["cuda"] = LSHSampledPipeline(
        2, toks, mean_pool_feature_fn(cfg_t), lm_head_query_fn(),
        LSHPipelineConfig(**pcfg), params=lm_g, device=dev, drift=drift,
        projections=pipes["cpu"].index.projections.to(dev))
    cpu, gpu = pipes["cpu"], pipes["cuda"]
    trainers = {where: Trainer(
        cfg_t, lm, Adam(lr=schedules.warmup_cosine(1e-3, 2, 10)),
        sampler=pipes[where]) for where, lm in (("cpu", lm_c),
                                                ("cuda", lm_g))}
    out = {"flips": 0, "checked": [], "feature_max_abs_diff": 0.0,
           "weight_max_rel_diff": 0.0}

    def compare(stage):
        if not np.array_equal(cpu._live_np, gpu._live_np):
            fail(f"3d {stage}: membership on the card differs")
        proj, lsh = cpu.index.projections, cpu.lsh
        fc, fg = cpu.features, gpu.features.cpu()
        live = torch.from_numpy(cpu._live_np)
        out["feature_max_abs_diff"] = max(out["feature_max_abs_diff"], float(
            (fg - fc)[live].abs().max()))
        near = ((fc @ proj).abs() < 1e-4).reshape(-1, lsh.l, lsh.k).any(-1).T
        diff = (hash_points(fc, proj, lsh) != hash_points(
            gpu.features, proj.to(dev), lsh).cpu()) & live[None]
        if bool((diff & ~near).any()):
            fail(f"3d {stage}: codes on the card differ away from zero")
        flips = int(diff.sum())
        out["flips"] += flips
        if flips == 0:
            if not (torch.equal(gpu.index.sorted_codes.cpu(),
                                cpu.index.sorted_codes)
                    and torch.equal(gpu.index.order.cpu(), cpu.index.order)):
                fail(f"3d {stage}: the index on the card differs from the "
                     f"CPU's")
        else:   # from here the card samples the CPU's index, as in 3c
            gpu.features = fc.to(dev)
            gpu.index = LSHIndex(*(x.to(dev) for x in cpu.index))
        out["checked"].append(stage)

    compare("build")
    gd = torch.Generator().manual_seed(4)
    for step in range(10):
        if step == 2:
            for p in (cpu, gpu):
                p.append_rows(extra[:16])
            compare("append 16 (window auto-evict 16)")
        if step == 4:
            gone = np.flatnonzero(cpu._live_np)[::31][:8]
            for p in (cpu, gpu):
                p.evict_rows(gone)
            compare("evict 8 (refresh in flight)")
        if step == 7:
            for p in (cpu, gpu):
                p.append_rows(extra[16:])
            compare("append 16 (window auto-evict 8)")
        dr = draw_samples(gd, (TRAIN_BATCH,), max(2 * cpu.lsh.l, 8),
                          cpu.lsh.l, cpu.n_live, "cpu")
        q = cpu.family.augment_query(lm_c.lm_head_query().detach())
        bt = {"cpu": cpu.next_batch(query=q, draws=dr),
              "cuda": gpu.next_batch(query=q.to(dev), draws=dr.to(dev))}
        if step in (4, 8):
            compare(f"delta refresh swapped in at step {step}")
        for kk in ("tokens", "example_ids"):
            if not torch.equal(bt["cuda"][kk].cpu(), bt["cpu"][kk]):
                fail(f"3d step {step}: batch {kk} differ from the CPU's")
        if not bool(torch.from_numpy(cpu._live_np)[
                bt["cpu"]["example_ids"]].all()):
            fail(f"3d step {step}: a drawn id is not live")
        wc, wg = bt["cpu"]["loss_weights"], bt["cuda"]["loss_weights"].cpu()
        out["weight_max_rel_diff"] = max(out["weight_max_rel_diff"], float(
            ((wg - wc).abs() / wc).max()))
        if not torch.allclose(wg, wc, rtol=1e-5, atol=0):
            fail(f"3d step {step}: weights differ from the CPU's")
        for where in ("cpu", "cuda"):
            trainers[where].train_step(bt[where])
    for where in ("cpu", "cuda"):
        trainers[where].finalize()
        refresh_health(pipes[where], f"3d {where}", 2)
    out["launches"] = {kk: kernels.launches[kk] for kk in (
        "simhash", "bucket_probe", "draw_assemble")}
    # the build, 2 appends and 2 delta refreshes each hash once on the card
    if out["launches"]["draw_assemble"] != 10 or \
            out["launches"]["simhash"] < 5:
        fail(f"3d: the card path's launches {out['launches']}")
    step = gpu._step
    runs = []
    for _ in range(2):
        gpu.restore_at(step)
        runs.append((gpu.index.sorted_codes.clone(), gpu.index.order.clone(),
                     [gpu.next_batch() for _ in range(3)]))
    (sc_a, od_a, ba), (sc_b, od_b, bb) = runs
    if not (torch.equal(sc_a, sc_b) and torch.equal(od_a, od_b) and all(
            torch.equal(x[kk], y[kk]) for x, y in zip(ba, bb) for kk in x)):
        fail("3d: two restore_at at the same step differ")
    out.update(restored_at=step, n_live=gpu.n_live, capacity=gpu.capacity,
               refresh_rows=[r["rows"] for r in gpu.refresh_records()])
    return out


def streaming_full_width(torch, np, dev, cfg_f, model, feature_batch) -> dict:
    """Phase 4d: the streaming path at full width (module docstring)."""
    from repro_torch import kernels
    from repro_torch.core import EMPTY_CODE, hash_points
    from repro_torch.data import (
        LSHPipelineConfig, LSHSampledPipeline, lm_head_query_fn,
        make_token_corpus, mean_pool_feature_fn)
    from repro_torch.launch import train as launch_train

    data = make_token_corpus(0, TRAIN_CORPUS, TRAIN_SEQ, cfg_f.vocab)
    new = make_token_corpus(5, STREAM_APPEND * len(STREAM_APPEND_AT),
                            TRAIN_SEQ, cfg_f.vocab).tokens
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    start_mem_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sampler = LSHSampledPipeline(
        2, data.tokens, mean_pool_feature_fn(cfg_f), lm_head_query_fn(),
        LSHPipelineConfig(minibatch=TRAIN_BATCH, window=TRAIN_CORPUS,
                          refresh_mode="delta", refresh_async=True,
                          refresh_every=STREAM_REFRESH),
        feature_batch=feature_batch, params=model, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tr = launch_train.make_trainer(cfg_f, model, steps=STREAM_STEPS,
                                   lr=1e-3, sampler=sampler)
    drawn, append_s, dts, losses = [], [], [], []
    next_batch = sampler.next_batch

    def kept_batch(*a, **kw):
        b = next_batch(*a, **kw)
        drawn.append((b["example_ids"], b["loss_weights"].mean(),
                      torch.from_numpy(sampler._live_np.copy()).to(dev)))
        return b

    sampler.next_batch = kept_batch
    tr.batches = iter(sampler.next_batch, None)
    for step in range(STREAM_STEPS):
        if step in STREAM_APPEND_AT:
            i = STREAM_APPEND_AT.index(step)
            torch.cuda.synchronize()
            t = time.perf_counter()
            sampler.append_rows(new[i * STREAM_APPEND:(i + 1) * STREAM_APPEND])
            torch.cuda.synchronize()
            append_s.append(time.perf_counter() - t)
        if step == STREAM_EVICT_AT:
            sampler.evict_rows(np.flatnonzero(sampler._live_np)[
                ::TRAIN_CORPUS // STREAM_EVICT][:STREAM_EVICT])
        t = time.perf_counter()
        losses += tr.run(1)["losses"]
        torch.cuda.synchronize()
        dts.append((time.perf_counter() - t) * 1e3)
    tr.finalize()
    torch.cuda.synchronize()
    launched = {kk: kernels.launches[kk] for kk in (
        "simhash", "bucket_probe", "draw_assemble")}
    sampler.next_batch = next_batch
    swaps = len(range(STREAM_REFRESH, STREAM_STEPS, STREAM_REFRESH))
    recs = refresh_health(sampler, "4d", swaps)
    # simhash: the build, every append, every delta refresh (the one
    # launched at the last step joins at teardown)
    want_hash = 1 + len(STREAM_APPEND_AT) + swaps
    if launched["draw_assemble"] != STREAM_STEPS or \
            launched["bucket_probe"] < STREAM_STEPS or \
            launched["simhash"] < want_hash:
        fail(f"4d launches {launched}: expected draw_assemble "
             f"{STREAM_STEPS}, bucket_probe >= {STREAM_STEPS}, simhash >= "
             f"{want_hash}")
    if len(losses) != STREAM_STEPS or not all(map(math.isfinite, losses)):
        fail(f"4d losses {losses}")
    w_means = torch.stack([m for _, m, _ in drawn]).cpu()
    if not torch.allclose(w_means, torch.ones_like(w_means), rtol=0,
                          atol=1e-5):
        fail(f"4d weights' batch means are not 1: {w_means}")
    if not all(bool(live[ids].all()) for ids, _, live in drawn):
        fail("4d: a drawn id was not live at its step")
    # the index: the live prefix, the sentinel tail, and a fresh stable
    # sort of hash(features) masked by the live mask
    sc, od = sampler.index.sorted_codes, sampler.index.order
    nl, cap = sampler.n_live, sampler.capacity
    live = sampler._live_dev
    live_ids = torch.nonzero(live).flatten()
    if not (torch.equal(od[:, :nl].sort(dim=1).values,
                        live_ids.expand(sc.shape[0], -1))
            and bool((sc[:, nl:] == EMPTY_CODE).all())
            and bool((sc[:, :nl] != EMPTY_CODE).all())):
        fail("4d: order[t, :n_live] is not the live slots, or the tail is "
             "not the sentinel")
    codes = torch.where(live[None], hash_points(
        sampler.features, sampler.index.projections, sampler.lsh),
        torch.full_like(sc, EMPTY_CODE))
    fresh_sc, fresh_od = torch.sort(codes, dim=1, stable=True)
    if not torch.equal(fresh_sc, sc):
        fail("4d: sorted_codes differ from a fresh sort of the live codes")
    if not torch.equal((sc * cap + od).sort(dim=1).values,
                       (fresh_sc * cap + fresh_od).sort(dim=1).values):
        fail("4d: the ids of some bucket differ from a fresh sort's")
    boundary = {s for s in range(STREAM_STEPS)
                if (s + 1) % STREAM_REFRESH == 0 or
                (s % STREAM_REFRESH == 0 and s > 0)}
    steady = [d for s, d in enumerate(dts)
              if s not in boundary and s not in STREAM_APPEND_AT
              and s != STREAM_EVICT_AT]
    return dict(
        arch=cfg_f.name, corpus=TRAIN_CORPUS, window=TRAIN_CORPUS,
        steps=STREAM_STEPS, refresh_every=STREAM_REFRESH,
        index_build_s=build_s, append_rows=STREAM_APPEND,
        append_s=append_s, append_ms_per_row=[
            a * 1e3 / STREAM_APPEND for a in append_s],
        refreshes=recs, step_ms_all=dts,
        step_ms_p50=float(np.percentile(steady, 50)),
        steady_steps=len(steady), n_live=nl, capacity=cap,
        start_mem_gb=start_mem_gb,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        losses=losses, weight_mean_max_dev=float((w_means - 1).abs().max()),
        fallback_rate=sampler.sampler_stats()["fallback_rate"],
        launches=launched)


def serve_lsh_full_width(torch, np, dev, cfg_f, lm_f, prompts, full_first,
                         full) -> dict:
    """Phase 4e: ``--head lsh`` through ``serve.build_head`` and
    ``serve.generate`` on 4b's model (module docstring)."""
    from repro_torch import kernels, serve
    from repro_torch.models import lsh_decode_step
    from repro_torch.models import sampled_softmax as ssm

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    head, build_s = serve.build_head(lm_f)
    # every emitted token's hidden state and token, kept on the card
    seen, orig = [], ssm.lsh_head_tokens

    def recorded(lm, h, head):
        tok = orig(lm, h, head)
        seen.append((h, tok))
        return tok

    ssm.lsh_head_tokens = serve.lsh_head_tokens = recorded
    try:
        t0 = time.perf_counter()
        out = serve.generate(lm_f, prompts, SERVE_NEW, head)
        wall_s = time.perf_counter() - t0
    finally:
        ssm.lsh_head_tokens = serve.lsh_head_tokens = orig
    served = dict(kernels.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emitted = SERVE_NEW + 1
    want = {"flash_attention": cfg_f.n_layers,
            "flash_decode": cfg_f.n_layers * SERVE_NEW,
            "bucket_probe_codes": emitted, "simhash": 1}
    got = {kk: served[kk] for kk in want}
    if got != want or served["draw_assemble"] or served["bucket_probe"]:
        fail(f"4e launches {served}: expected {want}")
    toks = out["tokens"]
    if toks.shape != (SERVE_B, emitted) or len(seen) != emitted:
        fail(f"4e: {tuple(toks.shape)} tokens, {len(seen)} head calls")
    if not bool(((toks >= 0) & (toks < cfg_f.vocab)).all()):
        fail("4e: a token outside the vocabulary")
    # each token against the masked argmax recomputed in f32 over its own
    # candidates from the (d, V) head's columns; a different id counts only
    # where its logit is below the best by more than f32 rounding
    lm_head, worse, exact = lm_f.embed_group.lm_head, 0, 0
    with torch.inference_mode():
        for h, tok in seen:
            q = lm_f.embed_group.final_norm(h)[:, 0].float()
            ids, valid = ssm.shortlist_candidates(
                head.index, head._fam.augment_query(q), head.lsh, head.scfg)
            w = lm_head.index_select(1, ids.reshape(-1)).float().reshape(
                q.shape[1], *ids.shape)
            lg = torch.where(valid, torch.einsum("bd,dbk->bk", q, w),
                             float("-inf"))
            best = lg.max(-1).values
            mine = torch.where(ids == tok, lg, float("-inf")).max(-1).values
            exact += int((torch.gather(ids, 1, lg.argmax(-1)[:, None])
                          == tok).sum())
            worse += int((best - mine > 1e-5 * best.abs().clamp_min(
                1.0)).sum())
    if worse:
        fail(f"4e: {worse} tokens are not their candidates' argmax")
    p10, p50 = serve.percentiles(out["step_ms"])
    # the head alone against the full head on the last hidden states
    h_last = seen[-1][0]
    with torch.inference_mode():
        head_ms = time_ms(torch, lambda: ssm.lsh_head_tokens(
            lm_f, h_last, head), 50)
        full_ms = time_ms(torch, lambda: lm_f.embed_group.lm_logits(
            h_last).argmax(-1), 50)
        # 20 steady steps under the profiler, as 5b
        cache = lm_f.init_cache(SERVE_B, SERVE_PROMPT + 30)
        h, cache = lm_f.prefill({"tokens": prompts}, cache)
        tok = ssm.lsh_head_tokens(lm_f, h[:, -1:], head)
        pos = [SERVE_PROMPT]

        def decode():
            nonlocal tok
            step = {"tokens": tok, "positions": torch.full(
                (SERVE_B, 1), pos[0], dtype=torch.int32, device=dev)}
            tok, _ = lsh_decode_step(lm_f, step, cache, head)
            pos[0] += 1

        for _ in range(5):
            decode()
        prof = trace_steps(torch, decode, 20)
        del cache, h
        # recall@1 on planted queries: head rows plus 0.1 sigma noise
        g = torch.Generator(device=dev).manual_seed(30)
        rows = head.rows.float()
        sigma = float(rows.std())
        winners = torch.randint(0, cfg_f.vocab, (RECALL_QUERIES,),
                                generator=g, device=dev)
        q = rows[winners] + 0.1 * sigma * torch.randn(
            (RECALL_QUERIES, rows.shape[1]), generator=g, device=dev)
        del rows
        hits, head_f = 0, lm_head.float()
        for i in range(0, RECALL_QUERIES, 16):
            qc = q[i:i + 16]
            true = (qc @ head_f).argmax(-1)
            ids, valid = ssm.shortlist_candidates(
                head.index, head._fam.augment_query(qc), head.lsh, head.scfg)
            lg = ssm.shortlist_logits(head.rows, qc, ids, valid)
            hits += int((torch.gather(ids, 1, lg.argmax(-1)[:, None])[:, 0]
                         == true).sum())
        del head_f
    return dict(
        arch=cfg_f.name, batch=SERVE_B, prompt=SERVE_PROMPT,
        new_tokens=SERVE_NEW, rows=head.index.n_points,
        tables=head.index.n_tables, k=head.lsh.k,
        code_width=head._fam.code_width(head.lsh.k),
        candidates_per_token=serve.shortlist_size(head.scfg),
        index_build_s=build_s, prefill_s=out["prefill_s"],
        decode_ms_p10=p10, decode_ms_p50=p50,
        full_decode_ms_p10=full["decode_ms_p10"],
        full_decode_ms_p50=full["decode_ms_p50"],
        first_step_ms=out["step_ms"][0], wall_s=wall_s,
        head_ms=head_ms["ms"], head_loop_ms=head_ms["loop_ms"],
        full_head_ms=full_ms["ms"], full_head_loop_ms=full_ms["loop_ms"],
        profile=prof, tokens_argmax_exact=exact,
        tokens_checked=emitted * SERVE_B,
        agree_with_full_first_token=float(
            (toks[:, 0] == full_first[:, 0]).float().mean()),
        agree_with_full_first_decode_step=float(
            (toks[:, 1] == full_first[:, 1]).float().mean()),
        recall_at_1=hits / RECALL_QUERIES, recall_queries=RECALL_QUERIES,
        peak_mem_gb=peak_gb, launches=got,
        sample_row=toks[0, :12].tolist())


def _same_state(torch, src, dst):
    """Copy trainer ``src``'s parameters, optimiser state and
    error-feedback residual into trainer ``dst`` (another device)."""
    from repro_torch.train import checkpoint as ckpt
    with torch.no_grad():
        for (_, a), (_, b) in zip(ckpt.flatten(src._state_tree()),
                                  ckpt.flatten(dst._state_tree())):
            b.copy_(a)
        for k, r in (src._ef_residual or {}).items():
            dst._ef_residual[k].copy_(r)


def _max(t) -> float:
    """The largest element of ``t``, 0 for an empty one."""
    return float(t.max()) if t.numel() else 0.0


def _blocks(t, block: int):
    """``t`` flattened and zero-padded into rows of ``block`` values."""
    import torch
    flat = t.detach().reshape(-1)
    pad = (-flat.numel()) % block
    return torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)


def training_stack_card_vs_cpu(torch, np, dev, cfg_t) -> dict:
    """3f: the training stack at phi4-mini SMOKE (f32), card against CPU,
    with the same weights and the same injected draws, as in 3c.

    (a) 5 LGD trainer steps with Adam8bit (peak lr 1e-6, below) and
    ``grad_compress``, each from the CPU's state (params, int8 moments, residual copied to the
    card first), on bitwise-equal batches.  A compressed gradient's int8
    value may differ by one where the two devices' f32 gradients
    straddle a rounding edge (the backward sums in another order); its
    256-value block (the same partition for the moments) then carries a
    one-quantum gradient difference into the moments and the update, and
    is exempt below (counted).  Elsewhere the int8 moments may differ by
    one (a rounding edge) and their scales by rtol 1e-5, the params by
    rtol 1e-4, atol 1e-6; the losses by SMOKE_TRAIN_RTOL.  (b) 4 steps of
    the LSH head's sampled loss through ``TrainerConfig(step_hook=
    head.step_hook)``, refresh every 2: the refreshes at the same steps
    on both (the card then takes the CPU's refreshed index, as 3e does,
    so both sample the same negatives with the same draws), the losses
    within SMOKE_TRAIN_RTOL.  (c) the card trainer's checkpoint passes
    ``verify`` and restores on the CPU bitwise."""
    import shutil
    import tempfile
    from repro_torch import kernels
    from repro_torch.core import LSHIndex
    from repro_torch.core.sampler import draw_samples
    from repro_torch.data import (
        LSHPipelineConfig, LSHSampledPipeline, lm_head_query_fn,
        make_token_corpus, mean_pool_feature_fn)
    from repro_torch.models import (
        LM, LMHeadIndex, SampledSoftmaxConfig, make_sampled_loss)
    from repro_torch.optim import Adam, Adam8bit, compression, schedules
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train import checkpoint as ckpt

    out = {}
    lm_c = LM.init(cfg_t, seed=0, device="cpu")
    lm_g = LM(cfg_t, device=dev)
    lm_g.load_state_dict(lm_c.state_dict())
    toks = make_token_corpus(0, 256, 64, cfg_t.vocab).tokens
    pcfg = LSHPipelineConfig(minibatch=TRAIN_BATCH)
    pipes = {"cpu": LSHSampledPipeline(
        2, toks, mean_pool_feature_fn(cfg_t), lm_head_query_fn(), pcfg,
        params=lm_c, device="cpu")}
    pipes["cuda"] = LSHSampledPipeline(
        2, toks, mean_pool_feature_fn(cfg_t), lm_head_query_fn(), pcfg,
        params=lm_g, device=dev,
        projections=pipes["cpu"].index.projections.to(dev))
    # both sample the CPU's index (3c holds the card's own build)
    pipes["cuda"].features = pipes["cpu"].features.to(dev)
    pipes["cuda"].index = LSHIndex(*(x.to(dev) for x in pipes["cpu"].index))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_3f_")
    # 3c's schedule at a 1e-6 peak: at 3c's 1e-3, Adam8bit's jumps where a
    # compressed gradient rounds to 0 over a stored v of 0 (ROADMAP queue
    # 3; tests/test_torch_optim_stack.py::test_adam8bit_zero_gradient_
    # jump) drive the SMOKE loss up by orders of magnitude within these 5
    # steps, and there the softmax turns the two devices' last-bit logit
    # differences into 1e-3-relative differences of the largest gradients:
    # a measure of that blow-up, not of the port
    opt = Adam8bit(lr=schedules.warmup_cosine(1e-6, 2, 5))
    trainers = {
        "cpu": Trainer(cfg_t, lm_c, opt, tcfg=TrainerConfig(
            grad_compress=True, log_every=100), sampler=pipes["cpu"]),
        "cuda": Trainer(cfg_t, lm_g, opt, tcfg=TrainerConfig(
            grad_compress=True, log_every=100, ckpt_dir=tmp,
            ckpt_every=10 ** 9), resume=False, sampler=pipes["cuda"])}
    captured = []                 # each train_step's compressed gradients
    compress = compression.compress_with_feedback

    def capture(grads, residual, block=compression.BLOCK):
        q, r = compress(grads, residual, block)
        captured.append(q)
        return q, r

    lsh_t = pipes["cpu"].lsh
    gd = torch.Generator().manual_seed(4)
    stats = dict(losses_cpu=[], losses_cuda=[], grad_q_diff=0,
                 grad_q_values=0, grad_q_max_diff=0,
                 grad_scale_max_rel_diff=0.0, exempt_blocks=0,
                 moment_q_diff=0, moment_q_values=0, moment_q_max_diff=0,
                 moment_scale_max_rel_diff=0.0, param_max_abs_diff=0.0,
                 param_worst_of_tol=0.0, exempt_param_max_abs_diff=0.0)
    bad = []                      # every violation, reported together

    def worst(key, value, limit, what):
        stats[key] = max(stats[key], value)
        if value > limit:
            bad.append(f"{what}: {value:.4g} > {limit:.4g}")

    kernels.reset_launch_counts()
    compression.compress_with_feedback = capture
    try:
        for step in range(5):
            _same_state(torch, trainers["cpu"], trainers["cuda"])
            dr = draw_samples(gd, (TRAIN_BATCH,), max(2 * lsh_t.l, 8),
                              lsh_t.l, toks.shape[0], "cpu")
            q = pipes["cpu"].family.augment_query(
                lm_c.lm_head_query().detach())
            bt = {"cpu": pipes["cpu"].next_batch(query=q, draws=dr),
                  "cuda": pipes["cuda"].next_batch(query=q.to(dev),
                                                   draws=dr.to(dev))}
            if not torch.equal(bt["cuda"]["tokens"].cpu(),
                               bt["cpu"]["tokens"]):
                fail("3f: the LGD batch on the card differs from the CPU's")
            captured.clear()
            for where in ("cpu", "cuda"):
                loss, _, ok = trainers[where].train_step(bt[where])
                if ok is False or not math.isfinite(float(loss)):
                    fail(f"3f: a non-finite step on {where}")
                stats[f"losses_{where}"].append(float(loss))
            flips = {}
            for k, qc in captured[0].items():
                qg = captured[1][k]
                d = (qg.q.cpu().int() - qc.q.int()).abs()
                rel = (qg.scale.cpu() - qc.scale).abs() / qc.scale
                worst("grad_q_max_diff", int(d.max()), 1,
                      f"step {step} {k} compressed-gradient int8 diff")
                worst("grad_scale_max_rel_diff", float(rel.max()),
                      SMOKE_TRAIN_RTOL, f"step {step} {k} gradient scale")
                flips[k] = (d > 0).any(dim=1)
                stats["grad_q_diff"] += int((d > 0).sum())
                stats["grad_q_values"] += d.numel()
                stats["exempt_blocks"] += int(flips[k].sum())
            st = {w: trainers[w].opt_state for w in trainers}
            for field in ("m", "v"):
                for k, qc in getattr(st["cpu"], field).items():
                    qg, keep = getattr(st["cuda"], field)[k], ~flips[k]
                    d = (qg.q.cpu().int() - qc.q.int()).abs()
                    rel = (qg.scale.cpu() - qc.scale).abs() / qc.scale
                    stats["moment_q_diff"] += int((d > 0).sum())
                    stats["moment_q_values"] += d.numel()
                    worst("moment_q_max_diff", int(_max(d[keep])), 1,
                          f"step {step} {k} int8 {field} diff")
                    worst("moment_scale_max_rel_diff", _max(rel[keep]),
                          SMOKE_TRAIN_RTOL, f"step {step} {k} {field} scale")
            for k, pc in trainers["cpu"].named_params.items():
                pg = trainers["cuda"].named_params[k]
                a, b = _blocks(pg.cpu(), 256), _blocks(pc, 256)
                keep = ~flips[k]
                err = (a - b).abs()
                stats["param_max_abs_diff"] = max(
                    stats["param_max_abs_diff"], _max(err[keep]))
                stats["exempt_param_max_abs_diff"] = max(
                    stats["exempt_param_max_abs_diff"], _max(err[~keep]))
                # |a - b| <= atol + rtol |b| as a share of its bound
                worst("param_worst_of_tol", _max(
                    (err / (1e-6 + 1e-4 * b.abs()))[keep]), 1.0,
                    f"step {step} params {k}")
    finally:
        compression.compress_with_feedback = compress
    lc, lg = stats["losses_cpu"], stats["losses_cuda"]
    stats["loss_max_rel_diff"] = max(abs(a - b) / abs(b)
                                     for a, b in zip(lg, lc))
    if stats["loss_max_rel_diff"] > SMOKE_TRAIN_RTOL:
        bad.append(f"losses {lc} vs {lg}")
    print("small-input check train-stack adam8bit " + json.dumps(stats),
          flush=True)
    if bad:
        fail("3f: Adam8bit + grad_compress, card against CPU: "
             + "; ".join(bad[:8]))
    stats["launches"] = {k: kernels.launches[k] for k in ("draw_assemble",)}
    if stats["launches"]["draw_assemble"] != 5:
        fail(f"3f: the LGD steps on the card did not draw through the "
             f"kernel: {stats['launches']}")
    out["adam8bit_compress"] = stats

    # (c) the card's checkpoint on the CPU
    tg = trainers["cuda"]
    tg.step = 5
    tg.save()
    tg.finalize()
    ok, reason = ckpt.verify(tmp, 5)
    if not ok:
        fail(f"3f: the card's checkpoint fails the CPU's verify: {reason}")
    tree, extra = ckpt.restore(tmp, 5, trainers["cpu"]._state_tree())
    n_leaves = 0
    for (path, a), (_, b) in zip(ckpt.flatten(tree),
                                 ckpt.flatten(tg._state_tree())):
        n_leaves += 1
        if a.device.type != "cpu" or not torch.equal(a, b.detach().cpu()):
            fail(f"3f: leaf {path} restored on the CPU is not the card's")
    out["checkpoint"] = dict(verify=reason, leaves=n_leaves,
                             step=extra.get("step"))
    shutil.rmtree(tmp)
    del trainers, pipes, lm_c, lm_g, tree

    # (b) the LSH head through the step hook
    lm_c = LM.init(cfg_t, seed=1, device="cpu")
    lm_g = LM(cfg_t, device=dev)
    lm_g.load_state_dict(lm_c.state_dict())
    scfg = SampledSoftmaxConfig(k=3, l=4, n_samples=16, multiprobe=1,
                                refresh_every=2, refresh_mode="delta")
    heads = {"cpu": LMHeadIndex(lm_c, scfg)}
    heads["cuda"] = LMHeadIndex(lm_g, scfg, projections=heads[
        "cpu"].index.projections.to(dev))

    def take_cpu_index():
        heads["cuda"].index = LSHIndex(*(x.to(dev)
                                         for x in heads["cpu"].index))
        heads["cuda"].x_aug = heads["cpu"].x_aug.to(dev)

    take_cpu_index()
    rng = np.random.default_rng(60)
    gh = torch.Generator().manual_seed(61)
    rows = [torch.from_numpy(rng.integers(0, cfg_t.vocab, (2, 17)))
            for _ in range(4)]
    draws = [draw_samples(gh, (2 * 16, scfg.n_samples), max(2 * scfg.l, 8),
                          scfg.l, cfg_t.vocab, "cpu") for _ in range(4)]

    def stream(where):
        to = "cpu" if where == "cpu" else dev
        plain = ({"tokens": r[:, :-1].to(to), "targets": r[:, 1:].to(to)}
                 for r in rows)
        for i, b in enumerate(heads[where].wrap_batches(plain)):
            b["head_draws"] = draws[i].to(to)
            yield b

    trainers = {w: Trainer(cfg_t, lm, Adam(lr=1e-3), stream(w), TrainerConfig(
            log_every=100, step_hook=heads[w].step_hook),
        loss_fn=make_sampled_loss(cfg_t, scfg))
        for w, lm in (("cpu", lm_c), ("cuda", lm_g))}
    hl = {"cpu": [], "cuda": []}
    refreshed = {"cpu": [], "cuda": []}
    kernels.reset_launch_counts()
    for _ in range(4):
        for w in ("cpu", "cuda"):
            before = heads[w].refreshes
            hl[w] += trainers[w].run(1)["losses"]
            if heads[w].refreshes != before:
                refreshed[w].append(trainers[w].step)
        take_cpu_index()
    head = dict(losses_cpu=hl["cpu"], losses_cuda=hl["cuda"],
                refresh_steps=refreshed,
                launches={k: kernels.launches[k]
                          for k in ("draw_assemble", "simhash")})
    head["loss_max_rel_diff"] = max(abs(a - b) / abs(b)
                                    for a, b in zip(hl["cuda"], hl["cpu"]))
    if refreshed["cpu"] != [2, 4] or refreshed["cuda"] != refreshed["cpu"]:
        fail(f"3f: the head's refresh steps differ: {refreshed}")
    if not all(map(math.isfinite, hl["cpu"] + hl["cuda"])) or \
            head["loss_max_rel_diff"] > SMOKE_TRAIN_RTOL:
        fail(f"3f: sampled-head losses on the card differ from the CPU's: "
             f"{hl}")
    if head["launches"] != {"draw_assemble": 4, "simhash": 2}:
        fail(f"3f: the head's draws and refreshes on the card did not run "
             f"the kernels: {head['launches']}")
    out["lsh_head"] = head
    return out


def training_stack_full_width(torch, np, dev, cfg_f, model,
                              sampler) -> dict:
    """4f: checkpoint, resume and corruption at full width on ``model``
    (phi4-mini, bf16, CUT_LAYERS layers), with 4c's LGD sampler recipe
    (its refresh schedule off, so no refresh falls in these 10 steps) and
    Adam8bit.

    Run A trains 5 steps and checkpoints asynchronously at step 5; runs B
    and C are fresh trainers with ``resume=True`` on the same model and
    sampler objects (the restore overwrites them in place), each
    restoring step 5 through ``latest_valid_step`` and ``restore_at(5)``
    and training steps 6-10.  Then the manifest is corrupted and a fourth
    trainer must start at step 0."""
    import shutil
    import tempfile
    import zlib
    from repro_torch import kernels
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import Adam8bit, schedules
    from repro_torch.testing import flip_manifest_byte
    from repro_torch.train import TrainerConfig
    from repro_torch.train import checkpoint as ckpt

    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if sampler.cfg.refresh_every:
        fail("4f: the sampler refreshes")
    out = {}
    drawn = []
    next_batch = sampler.next_batch

    def kept_batch(*a, **kw):
        b = next_batch(*a, **kw)
        drawn.append(b["example_ids"].clone())
        return b

    sampler.next_batch = kept_batch
    opt = Adam8bit(lr=schedules.warmup_cosine(1e-3, 10, 10))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_4f_")

    def trainer(resume: bool, every: int):
        return launch_train.make_trainer(
            cfg_f, model, steps=10, lr=1e-3, sampler=sampler, optimizer=opt,
            tcfg=TrainerConfig(ckpt_dir=tmp, ckpt_every=every, keep_ckpts=1,
                               log_every=10), resume=resume)

    def run(tr, tag):
        starts, step = [], tr.train_step

        def timed_step(batch):
            starts.append(time.perf_counter())
            return step(batch)

        tr.train_step = timed_step
        kernels.reset_launch_counts()
        losses = tr.run(5)["losses"]
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
        del tr.train_step
        used = kernels.launches["draw_assemble"]
        if used != 5:
            fail(f"4f {tag}: draw_assemble launched {used} times, not 5")
        if len(losses) != 5 or not all(map(math.isfinite, losses)):
            fail(f"4f {tag}: losses {losses}")
        return losses, [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]

    timers: dict = {}

    def timing(fn, name):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                timers.setdefault(name, []).append(time.perf_counter() - t1)
        return wrapper

    verify, restore = ckpt.verify, ckpt.restore
    try:
        # -- run A: 5 steps, the async checkpoint at step 5
        state_bytes = sum(p.numel() * p.element_size()
                          for p in model.parameters())
        blocks = sum(-(-p.numel() // opt.block) for p in model.parameters())
        need = state_bytes + 2 * blocks * (opt.block + 4) + 4
        free = shutil.disk_usage(tmp).free
        out.update(checkpoint_bytes_predicted=need, disk_free_bytes=free)
        if free < need * 1.05:
            fail(f"4f: the disk under {tmp} has {free / 1e9:.2f} GB free, "
                 f"too small for the {need / 1e9:.2f} GB checkpoint")
        ta = trainer(False, 5)
        la, dts_a = run(ta, "A")
        ta.finalize()                 # waits for the write
        if ckpt.latest_step(tmp) != 5:
            fail("4f A: no checkpoint at step 5")
        d5 = os.path.join(tmp, "step_00000005")
        out.update(
            checkpoint_bytes=sum(os.path.getsize(os.path.join(d5, f))
                                 for f in os.listdir(d5)),
            snapshot_s=ta._ckpt.snapshot_s, write_s=ta._ckpt.write_s)
        del ta
        gc.collect()

        # -- runs B and C: resume, restore_at(5), steps 6-10
        ckpt.verify = timing(verify, "verify")
        ckpt.restore = timing(restore, "restore")
        sampler.restore_at = timing(sampler.restore_at, "restore_at")
        res = {}
        for tag in ("B", "C"):
            kernels.reset_launch_counts()
            tr = trainer(True, 10 ** 9)
            hashed = kernels.launches["simhash"]
            if tr.step != 5 or hashed < 1:
                fail(f"4f {tag}: resumed at step {tr.step} with {hashed} "
                     f"simhash launches")
            if tag == "B":
                # every manifest CRC32 on the restored tensors
                with open(os.path.join(d5, "manifest.json")) as f:
                    crcs = {leaf["path"]: leaf["crc32"]
                            for leaf in json.load(f)["leaves"]}
                host = ckpt.snapshot(tr._state_tree())
                flat = ckpt.flatten(host)
                bad = [p for p, a in flat if zlib.crc32(np.ascontiguousarray(
                    a).reshape(-1).view(np.uint8)) != crcs.pop(p, None)]
                if bad or crcs:
                    fail(f"4f: restored leaves fail their manifest CRC32: "
                         f"{bad[:3]}, missing {list(crcs)[:3]}")
                out["crc_leaves_checked"] = len(flat)
                del host, flat
            first = len(drawn)
            losses, dts = run(tr, tag)
            res[tag] = dict(losses=losses, dts=dts, simhash=hashed,
                            ids=drawn[first:])
            tr.finalize()
            del tr
            gc.collect()
    finally:
        ckpt.verify, ckpt.restore = verify, restore
        sampler.__dict__.pop("restore_at", None)
        sampler.__dict__.pop("next_batch", None)
    for s_, (a, b) in enumerate(zip(res["B"]["ids"], res["C"]["ids"])):
        if not torch.equal(a, b):
            fail(f"4f: B and C drew different ids at step {6 + s_}")
    lb, lc = res["B"]["losses"], res["C"]["losses"]
    bitwise = lb == lc
    # step 6 is a forward from bitwise-equal restored state; steps 7-10
    # follow a backward
    rel = max(abs(a - b) / abs(b) for a, b in zip(lb, lc))
    if lb[0] != lc[0] or rel > RESUME_RTOL:
        fail(f"4f: B's and C's losses differ: {lb} vs {lc}")

    # -- corruption: the newest (only) checkpoint's manifest bit-rots
    flip_manifest_byte(tmp, 5)
    ok, reason = verify(tmp, 5)
    if ok or "manifest" not in reason:
        fail(f"4f: a flipped manifest byte passed verify ({reason})")
    if ckpt.latest_valid_step(tmp) is not None:
        fail("4f: latest_valid_step found a valid step after the flip")
    td = trainer(True, 10 ** 9)
    if td.step != 0:
        fail(f"4f: the trainer after the flip starts at step {td.step}")
    del td
    sampler.finalize()
    shutil.rmtree(tmp)
    steady = dts_a[:-1] + res["B"]["dts"] + res["C"]["dts"]
    out.update(
        arch=cfg_f.name, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        corpus=TRAIN_CORPUS, optimizer="adam8bit",
        verify_s=timers["verify"], restore_s=timers["restore"],
        restore_at_s=timers["restore_at"], corrupt_verify=reason,
        losses_a=la, losses_b=lb, losses_c=lc, losses_bitwise=bitwise,
        loss_max_rel_diff=rel,
        simhash_per_restore=[res["B"]["simhash"], res["C"]["simhash"]],
        step_ms_all=dts_a + res["B"]["dts"] + res["C"]["dts"],
        step_ms_p50=float(np.percentile(steady, 50)),
        layers=cfg_f.n_layers,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return out


def banded_card_vs_cpu(torch, dev, ds, mp: int) -> dict:
    """Phase 4e: the mips_banded LGD step at N_TRAIN on the card against
    the CPU's plain path, STEPS times, each step from the CPU's state with
    the same data, projections, index and draws (the card takes the CPU's
    index, as phase 3 does when a near-zero projection flips a code).  At
    every step: the draw's integers (ids, probes, bucket sizes, probe
    codes, fallbacks) equal; each p within DRAW_RTOL times its float32
    condition number 1 + K(l-1)Q/(1-Q) (Q the per-table hit probability:
    1 - Q cancels when Q is near 1, on both sides); and the card's theta
    within phase 3's rtol 1e-4, atol 1e-6 of the CPU's step taken with
    the card's p.  Free-running paths are not compared: the query is made
    from theta, so such a p difference moves every later draw's p."""
    from repro_torch.core import LGDState, draw_samples, init, lgd_step, \
        probe_masks, sample
    from repro_torch.core import estimator as est
    from repro_torch.core.sampler import popcounts
    from repro_torch.quickstart import make_problem

    problem, opt = make_problem("mips_banded", mp, "sgd")
    lsh, fam, n = problem.lsh, problem.family, ds.x_train.shape[0]
    gcpu = torch.Generator().manual_seed(7)
    proj = fam.mask_projections(torch.randn((lsh.dim, lsh.l * lsh.k),
                                            generator=gcpu))
    st_c, xt_c, yt_c, xa_c = init(None, problem, ds.x_train.cpu(),
                                  ds.y_train.cpu(), opt, projections=proj)

    def to_dev(t):
        return None if t is None else t.to(dev)

    index_g = type(st_c.index)(*map(to_dev, st_c.index))
    xt_g, yt_g, xa_g = xt_c.to(dev), yt_c.to(dev), xa_c.to(dev)
    rs = popcounts(probe_masks(lsh.k, 1 + mp), "cpu")
    worst_p = worst_theta = max_kappa = 0.0
    for step in range(STEPS):
        dr = draw_samples(gcpu, (problem.minibatch,), max(2 * lsh.l, 8),
                          lsh.l, n, "cpu", bands=True)
        th = st_c.theta
        q = problem.query_fn()(th)
        r_c = sample(None, st_c.index, xa_c, q, lsh, m=problem.minibatch,
                     multiprobe=mp, draws=dr)
        # the card's own query, as its lgd_step below makes it
        r_g = type(r_c)(*(f.cpu() for f in sample(
            None, index_g, xa_g, problem.query_fn()(th.to(dev)), lsh,
            m=problem.minibatch, multiprobe=mp, draws=dr.to(dev))))
        for field in ("indices", "n_probes", "bucket_sizes", "probe_code",
                      "fallback"):
            if not torch.equal(getattr(r_g, field), getattr(r_c, field)):
                fail(f"mips_banded/mp{mp} step {step}: the card's draw "
                     f"{field} differs from the CPU's")
        cp = fam.collision_prob(xa_c[r_c.indices], q[None])
        hit = fam.probe_class_probs(cp[..., None], lsh.k, rs).sum(-1)
        kappa = torch.where(r_c.fallback, 1.0, 1.0 + lsh.k * (
            r_c.n_probes - 1) * hit / torch.clamp(1.0 - hit, min=1e-30))
        max_kappa = max(max_kappa, float(kappa.max()))
        p_err = float(((r_g.probs - r_c.probs).abs()
                       / (DRAW_RTOL * kappa * r_c.probs)).max())
        worst_p = max(worst_p, p_err)
        # the CPU's step with the card's p, and the card's whole step
        grad = est.lgd_gradient(problem.grad_fn(), th, xt_c[r_c.indices],
                                yt_c[r_c.indices], r_g, n, problem.p_floor)
        upd, _ = opt.update(grad, st_c.opt_state, th)
        st_g, _ = lgd_step(None, LGDState(
            to_dev(th), type(st_c.opt_state)(*map(to_dev, st_c.opt_state)),
            index_g, to_dev(st_c.step)), xt_g, yt_g, xa_g, problem, opt,
            draws=dr.to(dev))
        want = th + upd
        worst_theta = max(worst_theta, float(
            ((st_g.theta.cpu() - want).abs()
             / (1e-6 + 1e-4 * want.abs())).max()))
        st_c, _ = lgd_step(None, st_c, xt_c, yt_c, xa_c, problem, opt,
                           draws=dr)
    out = dict(steps=STEPS, p_diff_over_tol=worst_p, max_condition=max_kappa,
               theta_diff_over_tol=worst_theta)
    if worst_p > 1.0 or worst_theta > 1.0:
        fail(f"mips_banded/mp{mp}: LGD steps on the card differ from the "
             f"CPU's: {out}")
    return out


def _new_inputs(full: dict, lo: int, hi: int) -> dict:
    """Positions [lo, hi) of a ``serve.make_inputs`` batch; image
    embeddings whole."""
    return {k: v if k == "image_embeds" else v[:, lo:hi]
            for k, v in full.items()}


def _attn_layers(lm) -> int:
    """Self-attention layers: each runs flash_attention once a prefill
    and flash_decode once a decode step (a cross_attn layer's memory
    attention takes the plain path)."""
    return sum(k in ("attn", "cross_attn", "shared_attn") for k in lm.kinds)


def other_arch_card_vs_cpu(torch, dev, kernels, configs, serve, LM,
                           arch: str) -> dict:
    """Phase 3g for one arch: its SMOKE config (f32) with the same weights
    on the card (the flash kernels) and on the CPU (the plain versions):
    prefill of 2 x 64 tokens (or embeddings; llama-3.2-vision with 8
    image patches), then 8 teacher-forced decode steps; logits within
    3b's rtol = atol = 1e-4, and the kernels launched once a
    self-attention layer a call."""
    cfg = configs.get_smoke(arch).with_(attn_impl="pallas")
    lm_c = LM.init(cfg, seed=0, device="cpu")
    lm_g = LM(cfg, device=dev)
    lm_g.load_state_dict(lm_c.state_dict())
    full = serve.make_inputs(cfg, 2, 72, "cpu", seed=3)
    out = {}
    before = dict(kernels.launches)
    with torch.inference_mode():
        for where, lm in (("cpu", lm_c), ("cuda", lm_g)):
            batch = {k: v.to(lm.device) for k, v in full.items()}
            cache = lm.init_cache(2, 72)
            h, cache = lm.prefill(_new_inputs(batch, 0, 64), cache)
            got = [lm.embed_group.lm_logits(h[:, -1:])[:, 0]]
            for i in range(64, 72):
                step = _new_inputs(batch, i, i + 1)
                step["positions"] = torch.full((2, 1), i, device=lm.device)
                lg, cache = lm.decode_step(step, cache)
                got.append(lg[:, 0])
            out[where] = torch.stack(got).cpu()
    n_attn = _attn_layers(lm_g)
    ran = {kk: kernels.launches[kk] - before[kk]
           for kk in ("flash_attention", "flash_decode")}
    if ran != {"flash_attention": n_attn, "flash_decode": 8 * n_attn}:
        fail(f"{cfg.name} on the card did not run the kernels once a "
             f"self-attention layer ({n_attn}): {ran}")
    err = float((out["cuda"] - out["cpu"]).abs().max())
    if not (bool(torch.isfinite(out["cuda"]).all()) and torch.allclose(
            out["cuda"], out["cpu"], rtol=1e-4, atol=1e-4)):
        fail(f"{cfg.name} logits on the card differ from the CPU's: max "
             f"|diff| {err:.3g}")
    res = {"arch": cfg.name, "max_abs_diff": err, "launches": ran}
    print(f"small-input check {cfg.name}: prefill 2x64 + 8 decode steps, "
          f"logits max |diff| card vs CPU {err:.3g}, launches {ran}",
          flush=True)
    return res


def serve_arch_full_width(torch, dev, kernels, serve, LM, arch: str,
                          layers, steps: int = NEW_STEPS, keep: bool = False):
    """Phases 4b and 4g for one arch: ``arch`` at full width (its first
    ``layers`` layers, or all), bf16, B 4, a prompt of 2,048 tokens or
    embeddings (llama-3.2-vision with its 1,024 image patches), ``steps``
    greedy steps through ``serve.generate``, the counts set to 0 just
    before and read just after: flash_attention once a self-attention
    layer, flash_decode that times ``steps``.  Every logit finite.

    Then the agreement, on the same card and the same weights: the prompt
    and the first min(steps, NEW_STEPS) decode steps, teacher-forced with
    the kernel path's greedy tokens (an ``embed_stub`` arch: generate's
    own decode embeddings), run again on the kernel path, on the plain
    path (attn_impl="ref") in bf16, and in f32 (the bf16 weights upcast
    exactly).  The kernel rerun must equal the timed call bitwise at the
    prompt's last hidden state and the first step's logits, so the
    figures describe the timed run.  In bf16 the two paths part wherever
    an f32 attention output sits near a bf16 rounding boundary, and deep
    random residual stacks amplify that (phi4-mini's 32 layers: 3.5%
    relative L2 between them), so no fixed kernel-vs-ref tolerance holds
    for every arch.  The kernel path must instead be about as accurate as
    the plain path: its relative L2 distance from the f32 run at most
    FULL_WIDTH_FACTOR times the plain path's, at the prompt's last
    position and the first step (an MoE arch: at every position and
    step).  Where that comparison cannot carry the check alone (llama4,
    no room for f32; zamba2, whose bf16 paths both sit far from f32),
    the kernel path is also held against the plain bf16 path within
    KERNEL_VS_REF_LIMIT.  A wrong mask or a dropped tile moves the hidden
    state by O(1).

    Returns (the report, None), or with ``keep`` (the report, a dict of
    the config, the model, the inputs and generate's tokens) for the
    phases that go on with the model."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, lm = serve.load_model(arch, "full", device=dev, seed=0,
                               layers=layers)
    inputs = serve.make_inputs(cfg, SERVE_B, SERVE_PROMPT, dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_attn = _attn_layers(lm)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    gen_out = serve.generate(lm, inputs, steps)
    wall_s = time.perf_counter() - t0
    served = {kk: kernels.launches[kk]
              for kk in ("flash_attention", "flash_decode")}
    want = {"flash_attention": n_attn, "flash_decode": n_attn * steps}
    if served != want:
        fail(f"{cfg.name}: the serve path launched {served}, expected {want}")
    if not gen_out["finite"]:
        fail(f"{cfg.name}: non-finite logits")
    p10, p50 = serve.percentiles(gen_out["step_ms"])
    decode_s = sum(gen_out["step_ms"]) / 1e3
    full_layers = serve.configs.get(arch).n_layers
    res = dict(arch=cfg.name, layers=cfg.n_layers, of_layers=full_layers,
               params=sum(p.numel() for p in lm.parameters()),
               batch=SERVE_B, prompt=SERVE_PROMPT, new_tokens=steps,
               patches=(inputs["image_embeds"].shape[1]
                        if "image_embeds" in inputs else 0),
               init_s=init_s, prefill_s=gen_out["prefill_s"],
               decode_ms_p10=p10, decode_ms_p50=p50,
               first_step_ms=gen_out["step_ms"][0], decode_s=decode_s,
               tokens_per_s=SERVE_B * steps / decode_s, wall_s=wall_s,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=served,
               sample_row=gen_out["tokens"][0, :12].tolist())

    forced = min(steps, NEW_STEPS)
    gen = torch.Generator(device=dev).manual_seed(serve.DECODE_EMBED_SEED)
    fed = []
    for t in range(forced):
        st = {"positions": torch.full((SERVE_B, 1), SERVE_PROMPT + t,
                                      dtype=torch.int32, device=dev)}
        if cfg.frontend == "embed_stub":
            st["embeds"] = (torch.zeros((SERVE_B, 1, cfg.d_model),
                                        device=dev) if t == 0 else
                            torch.randn((SERVE_B, 1, cfg.d_model),
                                        generator=gen, device=dev))
        else:
            st["tokens"] = gen_out["tokens"][:, t:t + 1]
        if "image_embeds" in inputs:
            st["image_embeds"] = inputs["image_embeds"]
        fed.append(st)

    @torch.inference_mode()
    def teacher_forced(model):
        """(every prompt position's final hidden state, every fed step's
        logits), f32; the cache as long as generate's."""
        cache = model.init_cache(SERVE_B, SERVE_PROMPT + steps)
        h_p, cache = model.prefill(inputs, cache)
        lgs = []
        for st in fed:
            lg, cache = model.decode_step(st, cache)
            lgs.append(lg[:, 0].float())
        return {"hidden": h_p.float(), "logits": torch.stack(lgs, dim=1)}

    runs = {"kernel": teacher_forced(lm)}
    as_generate = {
        "last_hidden": torch.equal(runs["kernel"]["hidden"][:, -1],
                                   gen_out["last_hidden"].float()),
        "first_logits": torch.equal(runs["kernel"]["logits"][:, 0],
                                    gen_out["first_logits"].float())}
    if not all(as_generate.values()):
        fail(f"{cfg.name}: the teacher-forced rerun is not the timed "
             f"generate call (bitwise equal: {as_generate})")
    res["rerun_as_generate"] = as_generate
    kept = (dict(cfg=cfg, lm=lm, inputs=inputs, tokens=gen_out["tokens"])
            if keep else None)
    sd = lm.state_dict()           # bf16 weights, f32 norms and constants
    del lm, gen_out

    def plain_run(dtype):
        lm_p = LM(cfg.with_(attn_impl="ref", dtype=dtype), device="meta")
        lm_p.load_state_dict(sd, assign=True)
        return teacher_forced(lm_p)

    def rel(a_, b_):
        return float((a_ - b_).norm() / b_.norm())

    runs["ref"] = plain_run(cfg.dtype)
    if arch != "llama4_maverick_400b_a17b":
        for kk in list(sd):            # bf16 -> f32 a leaf at a time
            sd[kk] = sd[kk].float()
        torch.cuda.empty_cache()
        runs["gold"] = plain_run("float32")
    del sd
    # An MoE arch routes each token to its top-k experts, and where two
    # experts' router logits lie within a bf16 rounding of each other
    # the kernel path, the plain path and the f32 run may pick different
    # ones (on an H100: 2 of 4 first-step argmaxes apart at
    # qwen3), so four rows are a draw of such flips.  There the gate is
    # over every prompt position (8,192 rows) and every fed step.
    wide = cfg.is_moe and "gold" in runs
    views = {"last_hidden": lambda r: r["hidden"][:, -1],
             "first_logits": lambda r: r["logits"][:, 0],
             "all_hidden": lambda r: r["hidden"],
             "all_logits": lambda r: r["logits"]}
    gated = ("all_hidden", "all_logits") if wide else ("last_hidden",
                                                       "first_logits")
    ref_limit = KERNEL_VS_REF_LIMIT.get(arch)
    check = {}
    for key, view in views.items():
        got_t, ref_t = view(runs["kernel"]), view(runs["ref"])
        c = check[key] = dict(
            kernel_vs_ref=rel(got_t, ref_t), gated=key in gated,
            max_abs_kernel_vs_ref=float((got_t - ref_t).abs().max()),
            ref_max_abs=float(ref_t.abs().max()),
            argmax_agree=float((got_t.argmax(-1) == ref_t.argmax(-1))
                               .float().mean()))
        if "gold" in runs:
            gold_t = view(runs["gold"])
            c.update(kernel_vs_gold=rel(got_t, gold_t),
                     ref_vs_gold=rel(ref_t, gold_t))
        if key not in gated:
            continue
        if "gold" in runs and not (c["kernel_vs_gold"]
                                   <= FULL_WIDTH_FACTOR * c["ref_vs_gold"]):
            fail(f"{cfg.name}: {key} of the kernel path is "
                 f"{c['kernel_vs_gold']:.3g} from the f32 run, more than "
                 f"{FULL_WIDTH_FACTOR} x the plain path's "
                 f"{c['ref_vs_gold']:.3g}")
        if ref_limit is not None and not c["kernel_vs_ref"] <= ref_limit:
            fail(f"{cfg.name}: {key} of the kernel path is "
                 f"{c['kernel_vs_ref']:.3g} from the plain bf16 path, more "
                 f"than {ref_limit:.3g}")
    res["check"] = check
    res["peak_mem_gb_with_check"] = torch.cuda.max_memory_allocated() / 1e9
    return res, kept


def pick_optimizer(arch: str):
    """The optimiser of ``arch``'s training run: Adafactor(lr=1e-2) for
    the giant archs (``src/repro/launch/dryrun.py:56-64``), else None:
    the launcher's Adam under warmup_cosine."""
    from repro_torch.optim import Adafactor
    return Adafactor(lr=1e-2) if arch in GIANT_ARCHS else None


def sharded_card_vs_cpu(torch, np, dev) -> dict:
    """Phase 3h: shard-by-example LGD at S = SHARDS on ``train_lm``'s
    smallest preset (demo, f32), the same weights on the card and the CPU.

    (a) The card's pipeline on the CPU's projections, each shard's index
    bitwise the CPU's (or, where a code flips at a near-zero projection,
    the CPU's index, as 3c), 5 batches with the same injected draws and
    the CPU model's query: tokens, targets, ids and shard_ids bitwise,
    weights within rtol 1e-5 (3d's); SHARDS probes and SHARDS
    draw_assembles a step on the card.  On the card alone, raw weights:
    (b) owners of shards [0, 1] and [2, 3] compose bitwise into full
    ownership over 5 steps; (c) adopt_shards([2, 3], 5) on the [0, 1]
    owner draws bitwise what full ownership draws for 5 more; (d) two
    rebuild_sharded_pipeline calls onto RESHARD shards at step 5 draw
    bitwise alike for 5 steps."""
    from repro_torch import kernels, train_lm
    from repro_torch.core import LSHIndex, draw_samples, hash_points
    from repro_torch.data import (
        LSHPipelineConfig, ShardedLSHPipeline, lm_head_query_fn,
        make_token_corpus, mean_pool_feature_fn)
    from repro_torch.models import LM
    from repro_torch.train.elastic import rebuild_sharded_pipeline

    preset = train_lm.PRESETS["demo"]
    cfg = train_lm.preset_config("demo")
    lm_c = LM.init(cfg, seed=0, device="cpu")
    lm_g = LM(cfg, device=dev)
    lm_g.load_state_dict(lm_c.state_dict())
    toks = make_token_corpus(1, preset["corpus"], preset["seq"], cfg.vocab,
                             hard_frac=0.1).tokens
    m = preset["batch"]
    pcfg = dict(k=cfg.lgd_k, l=cfg.lgd_l, minibatch=m,
                refresh_every=cfg.lgd_refresh_every, refresh_async=True)

    def pipe(params, device, **kw):
        c = dict(pcfg, **{k: kw.pop(k) for k in list(kw)
                          if k in ("normalize_weights",)})
        return ShardedLSHPipeline(
            2, toks, mean_pool_feature_fn(cfg), lm_head_query_fn(),
            LSHPipelineConfig(**c), n_shards=SHARDS, params=params,
            device=device, **kw)

    out = {"flips": 0, "weight_max_rel_diff": 0.0}
    cpu = pipe(lm_c, "cpu")
    kernels.reset_launch_counts()
    gpu = pipe(lm_g, dev, projections=[
        p.index.projections.to(dev) for p in cpu.shards])
    if kernels.launches["simhash"] != SHARDS:
        fail(f"3h: {kernels.launches['simhash']} simhash launches for "
             f"{SHARDS} shard builds")
    for s, (pc, pg) in enumerate(zip(cpu.shards, gpu.shards)):
        fc, proj, lsh = pc.features, pc.index.projections, pc.lsh
        out["feature_max_abs_diff"] = max(out.get(
            "feature_max_abs_diff", 0.0), float((pg.features.cpu() - fc)
                                                .abs().max()))
        near = ((fc @ proj).abs() < 1e-4).reshape(-1, lsh.l, lsh.k).any(-1).T
        diff = hash_points(fc, proj, lsh) != hash_points(
            pg.features, proj.to(dev), lsh).cpu()
        if bool((diff & ~near).any()):
            fail(f"3h shard {s}: codes on the card differ away from zero")
        flips = int(diff.sum())
        out["flips"] += flips
        if flips == 0:
            if not (torch.equal(pg.index.sorted_codes.cpu(),
                                pc.index.sorted_codes)
                    and torch.equal(pg.index.order.cpu(), pc.index.order)):
                fail(f"3h shard {s}: the index on the card differs")
        else:
            pg.features = fc.to(dev)
            pg.index = LSHIndex(*(x.to(dev) for x in pc.index))
    gd = torch.Generator().manual_seed(4)
    kernels.reset_launch_counts()
    for step in range(5):
        drs = [draw_samples(gd, (m // SHARDS,), max(2 * p.lsh.l, 8),
                            p.lsh.l, p.n, "cpu") for p in cpu.shards]
        q = cpu.shards[0]._query()
        bc = cpu.next_batch(query=q, draws=drs)
        bg = gpu.next_batch(query=q.to(dev), draws=[d.to(dev) for d in drs])
        for kk in ("tokens", "targets", "example_ids", "shard_ids"):
            if not torch.equal(bg[kk].cpu(), bc[kk]):
                fail(f"3h step {step}: batch {kk} on the card differ")
        wc, wg = bc["loss_weights"], bg["loss_weights"].cpu()
        out["weight_max_rel_diff"] = max(out["weight_max_rel_diff"], float(
            ((wg - wc).abs() / wc).max()))
        if not torch.allclose(wg, wc, rtol=1e-5, atol=0):
            fail(f"3h step {step}: weights on the card differ: "
                 f"{out['weight_max_rel_diff']:.3g} relative")
    ran = {kk: kernels.launches[kk] for kk in ("bucket_probe",
                                               "draw_assemble")}
    if ran != {"bucket_probe": 5 * SHARDS, "draw_assemble": 5 * SHARDS}:
        fail(f"3h: the card's launches {ran}, expected {5 * SHARDS} each")
    out["launches"] = ran
    del cpu, gpu

    def same(a, b, what):
        for kk in ("tokens", "targets", "example_ids", "shard_ids",
                   "loss_weights"):
            if not torch.equal(a[kk], b[kk]):
                fail(f"3h {what}: {kk} differ")

    def cat(parts):
        return {kk: torch.cat([p[kk] for p in parts]) for kk in parts[0]}

    full = pipe(lm_g, dev, normalize_weights=False)
    lo = pipe(lm_g, dev, normalize_weights=False, owned_shards=[0, 1])
    hi = pipe(lm_g, dev, normalize_weights=False, owned_shards=[2, 3])
    for step in range(5):
        same(full.next_batch(), cat([lo.next_batch(), hi.next_batch()]),
             f"owners [0, 1] + [2, 3] vs full ownership, step {step}")
    lo.adopt_shards([2, 3], step=5)
    for step in range(5, 10):
        same(full.next_batch(), lo.next_batch(),
             f"adopt_shards([2, 3], 5) vs full ownership, step {step}")
    del full, lo, hi
    runs = []
    for _ in range(2):
        re_ = rebuild_sharded_pipeline(
            2, toks, mean_pool_feature_fn(cfg), lm_head_query_fn(),
            LSHPipelineConfig(**pcfg), step=5, n_shards=RESHARD,
            params=lm_g, device=dev)
        runs.append([re_.next_batch() for _ in range(5)])
    for step, (a, b) in enumerate(zip(*runs)):
        same(a, b, f"two rebuilds onto S {RESHARD}, step {5 + step}")
    out.update(preset="demo", shards=SHARDS, rows=toks.shape[0],
               checked=["card vs CPU, 5 steps", "owners [0, 1] + [2, 3] = "
                        "full, 5 steps", "adopt_shards([2, 3], 5) = full, 5 "
                        "steps", f"two rebuilds onto S {RESHARD}, 5 steps"])
    return out


def train_archs_card_vs_cpu(torch, dev, configs, launch_train, LM) -> dict:
    """Phase 3i: every arch ``launch.train`` trains (an embed_stub arch
    it refuses) at its SMOKE config (f32), the same weights on the card
    and the CPU, 3 trainer steps on the same uniform batches (4 x 32
    tokens) with the optimiser of 4i (Adam; Adafactor for the giant
    archs): losses within SMOKE_TRAIN_RTOL, and every updated parameter
    within 1e-4 of the CPU's in relative L2 distance."""
    from repro_torch.data import make_token_corpus, uniform_batches
    from repro_torch.train import TrainerConfig

    out = {}
    for arch in configs.all_archs():
        cfg = configs.get_smoke(arch)
        if cfg.frontend == "embed_stub":
            continue
        lm_c = LM.init(cfg, seed=0, device="cpu")
        lm_g = LM(cfg, device=dev)
        lm_g.load_state_dict(lm_c.state_dict())
        data = make_token_corpus(0, 64, 32, cfg.vocab)
        losses = {}
        for where, lm in (("cpu", lm_c), ("cuda", lm_g)):
            tr = launch_train.make_trainer(
                cfg, lm, steps=3, lr=1e-3, optimizer=pick_optimizer(arch),
                batches=uniform_batches(data, 4, seed=1, device=lm.device),
                tcfg=TrainerConfig(log_every=10 ** 9))
            losses[where] = tr.run(3)["losses"]
        l_err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                          losses["cpu"]))
        sd_c = lm_c.state_dict()
        p_err, p_abs = 0.0, 0.0
        for name, g in lm_g.state_dict().items():
            c, g = sd_c[name].double(), g.cpu().double()
            p_err = max(p_err, float((g - c).norm() / max(float(c.norm()),
                                                          1e-30)))
            p_abs = max(p_abs, float((g - c).abs().max()))
        if not all(map(math.isfinite, losses["cuda"])) or \
                l_err > SMOKE_TRAIN_RTOL or p_err > 1e-4:
            fail(f"3i {cfg.name}: 3 steps on the card differ from the CPU's: "
                 f"losses {losses}, params {p_err:.3g} relative")
        out[arch] = dict(optimizer=("adafactor" if arch in GIANT_ARCHS
                                    else "adam"),
                         losses_cpu=losses["cpu"], losses_cuda=losses["cuda"],
                         loss_max_rel_diff=l_err, param_max_rel_l2=p_err,
                         param_max_abs_diff=p_abs)
        print(f"small-input check train {cfg.name} " + json.dumps(out[arch]),
              flush=True)
    return out


def train_memory_gb(LM, cfg, giant: bool) -> dict:
    """The least memory a training step of ``cfg`` holds, from its
    parameter shapes (a model on the meta device): weights, gradients,
    the optimiser's slots (Adam: two f32 moments; Adafactor: f32 row and
    column factors) and the clip's f32 copy of the largest gradient leaf.
    Activations come on top."""
    params = list(LM(cfg, device="meta").parameters())
    w = sum(p.numel() * p.element_size() for p in params)
    if giant:
        opt = sum(4 * ((math.prod(p.shape[:-1])
                        + math.prod(p.shape[:-2]) * p.shape[-1])
                       if p.dim() >= 2 else p.numel()) for p in params)
    else:
        opt = sum(8 * p.numel() for p in params)
    clip = 4 * max(p.numel() for p in params)
    return dict(weights_gb=w / 1e9, grads_gb=w / 1e9, optimizer_gb=opt / 1e9,
                clip_copy_gb=clip / 1e9, total_gb=(2 * w + opt + clip) / 1e9)


def backward_trace(torch, fn, inputs, module=None, reps: int = 3) -> dict:
    """The device time of the backward of ``fn(*inputs)`` alone: the
    forward runs outside the trace on leaf copies of ``inputs``, then
    ``reps`` backwards of one random cotangent through the retained
    graph are traced.  ``module``'s parameter gradients are dropped
    after."""
    leaves = [x.detach().clone().requires_grad_(x.is_floating_point())
              for x in inputs]
    y = fn(*leaves)
    gy = torch.randn_like(y)
    res = trace_steps(torch, lambda: torch.autograd.backward(
        y, gy, retain_graph=True), reps)
    if module is not None:
        for p in module.parameters():
            p.grad = None
    del y, gy, leaves
    return {"shape": [list(x.shape) for x in inputs],
            "device_ms": res.get("device_ms_per_step"),
            "by_kind_ms": res.get("device_summed_ms_per_step_by_kind"),
            "ops": res.get("device_ops_per_step")}


def mixer_backwards(torch, cfg, model) -> dict:
    """4i: the backward of the chunked core (``models/ssm.py``:
    ``gla_chunked``, and the sLSTM's ``slstm_scan``) and of the MoE FFN
    with its dispatch (``models/moe.py``), each traced alone at the
    training step's shapes (B 8, S 512) on the first layer that runs it,
    with the calls a step makes."""
    from repro_torch.models import ssm

    out = {}
    g = torch.Generator(device=model.device).manual_seed(11)
    x = (torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), generator=g,
                     device=model.device) * 0.5).to(model.dtype)
    kinds = model.kinds
    for kind, attr in (("mamba2", "mamba"), ("mlstm", "mlstm")):
        if kind in kinds:
            mixer = getattr(model._layer(kinds.index(kind)), attr)
            with torch.no_grad():
                q, k, v, log_a = mixer._project(x)[:4]
            row = backward_trace(
                torch, lambda q_, k_, v_, la_: ssm.gla_chunked(
                    q_, k_, v_, la_, cfg.chunk)[0], (q, k, v, log_a))
            out[f"ssm.gla_chunked backward ({kind})"] = dict(
                row, calls_per_step=kinds.count(kind))
    if "slstm" in kinds:
        mixer = model._layer(kinds.index("slstm")).slstm
        with torch.no_grad():
            z, i, f, o = torch.chunk((mixer.norm(x) @ mixer.in_proj).float(),
                                     4, dim=-1)
        state = ssm.init_slstm_state(cfg, TRAIN_BATCH, model.device)
        row = backward_trace(torch, lambda *a: ssm.slstm_scan(
            *a, state)[0], (z, i, f, o))
        out["ssm.slstm_scan backward"] = dict(
            row, calls_per_step=kinds.count("slstm"))
    if cfg.is_moe:
        moe = model._layer(0).ffn
        row = backward_trace(torch, moe, (x,), module=moe)
        out["moe.MoE backward (dispatch, experts, combine)"] = dict(
            row, calls_per_step=sum(model._layer(i).ffn is not None
                                    for i in range(len(kinds))))
    return out


def train_arch_full_width(torch, np, dev, kernels, configs, launch_train, LM,
                          arch: str, layers) -> dict:
    """Phase 4i for one arch: ``arch`` at full width (its first ``layers``
    layers, or all), bf16, trained on LGD batches as the launcher builds
    them (srp, K 7, L 10, batch 8 x 512 tokens, async refresh) from a
    corpus of ARCH_CORPUS rows, ARCH_STEPS steps, one refresh at step
    ARCH_REFRESH (the schedule is switched off after it), with Adam or,
    for a giant arch, Adafactor.  Before the model is built, the least
    memory of a step (``train_memory_gb``) is held against the card's:
    an arch that cannot fit is not run and its arithmetic is reported.
    Checked: launches (draw_assemble and bucket_probe once a step,
    simhash at the build and the refresh), the refresh swapped in with no
    health transition, every loss finite, every batch-mean weight 1 +-
    1e-5.  Reported: build s, step p10 / p50, the refresh's device span,
    peak memory, one profiled step by kind, and ``mixer_backwards``."""
    from repro_torch.train import TrainerConfig

    torch.cuda.synchronize()
    gc.collect()                   # the previous arch's state, cycles too
    torch.cuda.empty_cache()
    cfg = configs.get(arch)
    if layers is not None:
        cfg = cfg.with_(n_layers=layers)
    giant = arch in GIANT_ARCHS
    mem = train_memory_gb(LM, cfg, giant)
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    res = dict(arch=cfg.name, layers=cfg.n_layers,
               of_layers=configs.get(arch).n_layers,
               optimizer="adafactor" if giant else "adam", memory=mem,
               card_gb=card_gb)
    if mem["total_gb"] >= card_gb:
        res["run"] = False
        print(f"train-4i {cfg.name}: not run: a step holds at least "
              f"{mem['weights_gb']:.2f} GB of bf16 weights + "
              f"{mem['grads_gb']:.2f} GB of gradients + "
              f"{mem['optimizer_gb']:.2f} GB of optimiser slots + "
              f"{mem['clip_copy_gb']:.2f} GB (the clip's f32 copy of the "
              f"largest gradient leaf) = {mem['total_gb']:.2f} GB, beyond "
              f"the card's {card_gb:.2f} GB before any activation",
              flush=True)
        return res
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    model = LM.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sampler, _ = launch_train.make_batches(
        cfg, model, lgd=True, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        corpus=ARCH_CORPUS, device=dev, refresh_every=ARCH_REFRESH)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    w_means, next_batch = [], sampler.next_batch

    def kept_batch(*a, **kw):
        b = next_batch(*a, **kw)
        w_means.append(b["loss_weights"].mean())
        return b

    def one_refresh(tr):
        if tr.step == ARCH_REFRESH + 1:     # after the refresh's swap
            for c in (sampler.cfg, sampler.shards[0].cfg):
                c.refresh_every = 0

    sampler.next_batch = kept_batch
    tr = launch_train.make_trainer(
        cfg, model, steps=ARCH_STEPS, lr=1e-3, sampler=sampler,
        optimizer=pick_optimizer(arch),
        tcfg=TrainerConfig(log_every=10, step_hook=one_refresh))
    starts, train_step = [], tr.train_step

    def timed_step(batch):
        starts.append(time.perf_counter())
        return train_step(batch)

    tr.train_step = timed_step
    losses = tr.run(ARCH_STEPS)["losses"]
    torch.cuda.synchronize()
    starts.append(time.perf_counter())
    del tr.train_step
    used = {kk: kernels.launches[kk] for kk in (
        "simhash", "bucket_probe", "draw_assemble", "flash_attention")}
    if used["draw_assemble"] != ARCH_STEPS or \
            used["bucket_probe"] != ARCH_STEPS or used["simhash"] != 2:
        fail(f"4i {cfg.name}: launches {used}: expected draw_assemble and "
             f"bucket_probe {ARCH_STEPS}, simhash 2 (the build, the refresh)")
    recs = refresh_health(sampler, f"4i {cfg.name}", 1)
    if len(losses) != ARCH_STEPS or not all(map(math.isfinite, losses)):
        fail(f"4i {cfg.name}: losses {losses}")
    w_mean = torch.stack(w_means).float().cpu()
    if not torch.allclose(w_mean, torch.ones_like(w_mean), rtol=0,
                          atol=1e-5):
        fail(f"4i {cfg.name}: batch-mean weights are not 1: {w_mean}")
    dts = [(b_ - a_) * 1e3 for a_, b_ in zip(starts, starts[1:])]
    # iteration k trains step k and draws batch k + 1: the refresh
    # launches in iteration ARCH_REFRESH - 2 and is swapped in the next
    boundary = (ARCH_REFRESH - 2, ARCH_REFRESH - 1)
    steady = [d_ for i_, d_ in enumerate(dts) if i_ not in boundary]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sampler.next_batch = next_batch
    tr.batches = iter(sampler.next_batch, None)
    res.update(
        run=True, params=sum(p.numel() for p in model.parameters()),
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, corpus=ARCH_CORPUS,
        steps=ARCH_STEPS, feature_batch=sampler.feature_batch,
        init_s=init_s, build_s=build_s,
        build_device_s=sampler.build_device_ms()[0] / 1e3,
        refresh_device_s=[r["device_ms"] / 1e3 for r in recs
                          if "device_ms" in r],
        refresh_wait_s=[r["wait_s"] for r in recs],
        boundary_step_ms={i_: dts[i_] for i_ in boundary},
        step_ms_p10=float(np.percentile(steady, 10)),
        step_ms_p50=float(np.percentile(steady, 50)), step_ms_all=dts,
        peak_mem_gb=peak_gb, losses=losses,
        weight_mean_max_dev=float((w_mean - 1).abs().max()),
        fallback_rate=sampler.sampler_stats()["fallback_rate"],
        launches=used)
    res["profile_step"] = trace_steps(torch, lambda: tr.run(1), 1)
    res["backward"] = mixer_backwards(torch, cfg, model)
    tr.finalize()
    # every reference to the model goes: the next arch needs the memory
    del tr, train_step, timed_step, kept_batch, one_refresh, next_batch
    del sampler, model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def sharded_full_width(torch, np, dev, kernels, cfg_f, model,
                       launch_train) -> dict:
    """Phase 4h: 4c's recipe (phi4-mini at full width and CUT_LAYERS
    layers, bf16, batch 8 x 512, corpus 2,048, Adam, K 7, L 10, srp,
    async refresh) through a
    ``ShardedLSHPipeline`` of SHARDS shards, built by the launcher's
    ``make_batches``: SHARD_STEPS steps with a refresh at step
    SHARD_REFRESH, the counts set to 0 just before the build and read
    after the run (bucket_probe and draw_assemble SHARDS a step, simhash
    SHARDS a build and a refresh); every shard's refresh swapped in with
    no health transition; losses finite; composed batch-mean weights 1
    +- 1e-5 and shard_ids in shard order.  A step hook checkpoints the
    weights at step SHARD_REFRESH; after the run the checkpoint is
    restored into the model (``restore_latest_valid_on_mesh``) and one
    ``rebuild_sharded_pipeline`` onto RESHARD shards is timed, with
    ``rescale_plan(SHARDS, RESHARD, batch)``; the rebuilt pipeline (its
    refresh schedule off) draws one batch with mean weight 1."""
    import shutil
    import tempfile
    from repro_torch.data import (
        LSHPipelineConfig, lm_head_query_fn, make_token_corpus,
        mean_pool_feature_fn)
    from repro_torch.train import TrainerConfig
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.elastic import (
        rebuild_sharded_pipeline, rescale_plan, restore_latest_valid_on_mesh)

    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sampler, _ = launch_train.make_batches(
        cfg_f, model, lgd=True, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        corpus=TRAIN_CORPUS, device=dev, refresh_every=SHARD_REFRESH,
        n_shards=SHARDS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    m_s = TRAIN_BATCH // SHARDS
    want_ids = torch.arange(SHARDS, dtype=torch.int32,
                            device=dev).repeat_interleave(m_s)
    w_means, w_shard, shard_ids = [], [], []
    next_batch = sampler.next_batch

    def kept_batch(*a, **kw):         # device tensors only: no host sync
        b = next_batch(*a, **kw)
        w_means.append(b["loss_weights"].mean())
        w_shard.append(b["loss_weights"].view(SHARDS, m_s).mean(1))
        shard_ids.append(b["shard_ids"])
        return b

    sampler.next_batch = kept_batch
    tmp = tempfile.mkdtemp(prefix="chip_smoke_4h_")
    need = sum(p.numel() * p.element_size() for p in model.parameters())
    free = shutil.disk_usage(tmp).free
    if free < need * 1.05:
        fail(f"4h: the disk under {tmp} has {free / 1e9:.2f} GB free, too "
             f"small for the {need / 1e9:.2f} GB checkpoint of the weights")
    saved = {}

    def checkpoint(tr):
        if tr.step == SHARD_REFRESH:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ckpt.save(tmp, tr.step, {"params": tr.named_params},
                      extra={"step": tr.step, "n_shards": SHARDS})
            saved["save_s"] = time.perf_counter() - t1

    tr = launch_train.make_trainer(
        cfg_f, model, steps=SHARD_STEPS, lr=1e-3, sampler=sampler,
        tcfg=TrainerConfig(log_every=10, step_hook=checkpoint))
    starts, train_step = [], tr.train_step

    def timed_step(batch):
        starts.append(time.perf_counter())
        return train_step(batch)

    tr.train_step = timed_step
    out = tr.run(SHARD_STEPS)
    starts.append(time.perf_counter())
    del tr.train_step
    tr.finalize()
    torch.cuda.synchronize()
    used = {kk: kernels.launches[kk] for kk in (
        "simhash", "bucket_probe", "draw_assemble")}
    want = {"simhash": 2 * SHARDS, "bucket_probe": SHARDS * SHARD_STEPS,
            "draw_assemble": SHARDS * SHARD_STEPS}
    if used != want:
        fail(f"4h: launches {used}, expected {want} (a probe and a "
             f"draw_assemble a shard a step; a simhash a shard a build and "
             f"a refresh)")
    recs = refresh_health(sampler, "4h", SHARDS)
    losses = out["losses"]
    if len(losses) != SHARD_STEPS or not all(map(math.isfinite, losses)):
        fail(f"4h: losses {losses}")
    w_mean = torch.stack(w_means).float().cpu()
    ids_ok = all(torch.equal(x, want_ids) for x in shard_ids)
    if not torch.allclose(w_mean, torch.ones_like(w_mean), rtol=0,
                          atol=1e-5) or not ids_ok:
        fail(f"4h: composed batch-mean weights {w_mean} (must be 1), "
             f"shard_ids in shard order: {ids_ok}")
    w_shard = torch.stack(w_shard).float().cpu()
    dts = [(b_ - a_) * 1e3 for a_, b_ in zip(starts, starts[1:])]
    # the refresh launches in iteration SHARD_REFRESH - 2 and is swapped
    # (and the weights checkpointed) in the next
    boundary = (SHARD_REFRESH - 2, SHARD_REFRESH - 1)
    steady = [d_ for i_, d_ in enumerate(dts) if i_ not in boundary]
    res = dict(
        arch=cfg_f.name, shards=SHARDS, batch=TRAIN_BATCH,
        rows_per_shard=m_s, corpus=TRAIN_CORPUS,
        corpus_per_shard=[p.n for p in sampler.shards], steps=SHARD_STEPS,
        build_s=build_s,
        shard_build_device_s=[ms / 1e3 for ms in sampler.build_device_ms()],
        shard_refresh_device_s={r["shard"]: r["device_ms"] / 1e3
                                for r in recs if "device_ms" in r},
        refresh_wait_s=sum(r["wait_s"] for r in recs),
        boundary_step_ms={i_: dts[i_] for i_ in boundary},
        step_ms_p10=float(np.percentile(steady, 10)),
        step_ms_p50=float(np.percentile(steady, 50)),
        layers=cfg_f.n_layers, step_ms_all=dts,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        weight_mean_composed_max_dev=float((w_mean - 1).abs().max()),
        weight_mean_per_shard=w_shard.mean(0).tolist(),
        weight_mean_per_shard_range=[float(w_shard.min()),
                                     float(w_shard.max())],
        fallback_rate_per_shard=[p.sampler_stats()["fallback_rate"]
                                 for p in sampler.shards],
        fallback_rate_composed=sampler.sampler_stats()["fallback_rate"],
        losses=losses, launches=used, checkpoint_save_s=saved.get("save_s"))
    names = tr.named_params
    feature_batch = sampler.feature_batch
    sampler.next_batch = next_batch
    del tr, train_step, timed_step, kept_batch, sampler
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step, _, extra = restore_latest_valid_on_mesh(tmp, {"params": names},
                                                  in_place=True)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if step != SHARD_REFRESH or extra.get("n_shards") != SHARDS:
        fail(f"4h: restored step {step}, extra {extra}")
    plan = rescale_plan(SHARDS, RESHARD, TRAIN_BATCH)
    print("4h rescale_plan " + json.dumps(plan), flush=True)
    tokens = make_token_corpus(0, TRAIN_CORPUS, TRAIN_SEQ, cfg_f.vocab).tokens
    # the launcher's config with the refresh schedule off: the rebuilt
    # pipeline draws one batch, at step 10, a refresh boundary
    pcfg = LSHPipelineConfig(minibatch=TRAIN_BATCH, refresh_every=0,
                             refresh_async=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    re_ = rebuild_sharded_pipeline(
        2, tokens, mean_pool_feature_fn(cfg_f), lm_head_query_fn(), pcfg,
        step=step, n_shards=RESHARD, params=model,
        feature_batch=feature_batch, device=dev)
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    b = re_.next_batch()
    wm = float(b["loss_weights"].mean())
    if [p._step for p in re_.shards] != [step + 1] * RESHARD or \
            abs(wm - 1.0) > 1e-5 or b["shard_ids"].tolist() != sorted(
                b["shard_ids"].tolist()):
        fail(f"4h: the rebuilt pipeline at step {step}: mean weight {wm}, "
             f"shard_ids {b['shard_ids'].tolist()}")
    res.update(restore_s=restore_s, rescale_plan=plan, rebuild_s=rebuild_s,
               rebuild_shard_build_device_s=[
                   ms / 1e3 for ms in re_.build_device_ms()],
               rebuild_corpus_per_shard=[p.n for p in re_.shards],
               rebuild_weight_mean=wm)
    del re_, b
    shutil.rmtree(tmp)
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def mh_stack(name: str):
    """A worker's ``Stack``: "tiny" (the reference worker's model, corpus
    and pipeline) or "full" (4j: MH_ARCH whole in bf16 on 4i's LGD recipe,
    srp, K 7, L 10, 512-token rows from MH_CORPUS rows split over the two
    processes, a global batch of MH_BATCH, with the worker's sync refresh
    every MH_REFRESH steps and raw weights, Adam)."""
    from repro_torch.dist import multihost_worker as mw
    if name == "tiny":
        return mw.Stack()
    from repro_torch import configs
    from repro_torch.data import LSHPipelineConfig
    from repro_torch.launch.train import feature_batch_for
    cfg = configs.get(MH_ARCH)
    return mw.Stack(
        model=cfg,
        pipe=LSHPipelineConfig(minibatch=MH_BATCH, refresh_every=MH_REFRESH,
                               refresh_async=False, refresh_backoff=0.0,
                               normalize_weights=False),
        corpus=dict(seed=0, n_examples=MH_CORPUS, seq_len=TRAIN_SEQ,
                    hard_frac=0.1),
        lr=1e-3, feature_batch=feature_batch_for(cfg, TRAIN_SEQ))


def mh_worker_main(argv):
    """One worker process of 3j / 4j (``MH_CHILD``): ``argv`` is the
    stack's name, then the worker's own command line."""
    from repro_torch.dist import multihost_worker as mw
    mw.run_worker(mw.build_arg_parser().parse_args(argv[1:]),
                  stack=mh_stack(argv[0]))


def mh_pair(tmp: str, tag: str, stack: str, args: list,
            kill_at=None) -> dict:
    """Two worker processes on the card (ranks 0 and 1 of one run, over a
    store on a free local port), each polled until it exits; past
    MH_PAIR_TIMEOUT_S both are killed and the run fails.  Returns the exit
    codes, each exit's wall time, the results each rank wrote and the
    tails of their logs."""
    d = os.path.join(tmp, tag)
    os.makedirs(d)
    coord = f"127.0.0.1:{_free_port()}"
    procs, logs = [], []
    t0 = time.perf_counter()
    for r in (0, 1):
        cmd = [sys.executable, "-c", MH_CHILD, HERE,
               os.path.join(HERE, "src"), stack, "--rank", str(r),
               "--nprocs", "2", "--coordinator", coord,
               "--ckpt-dir", os.path.join(d, "ckpt"),
               "--result", os.path.join(d, f"r{r}.json"),
               "--device", "cuda"] + args
        if r == 1 and kill_at is not None:
            cmd += ["--kill-at", str(kill_at)]
        logs.append(open(os.path.join(d, f"log{r}.txt"), "w"))
        procs.append(subprocess.Popen(cmd, stdout=logs[-1],
                                      stderr=subprocess.STDOUT, cwd=HERE))
    exit_t = [None, None]
    deadline = time.monotonic() + MH_PAIR_TIMEOUT_S
    while None in exit_t and time.monotonic() < deadline:
        for r, p in enumerate(procs):
            if exit_t[r] is None and p.poll() is not None:
                exit_t[r] = time.time()
        time.sleep(0.02)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    for f in logs:
        f.close()
    tails = []
    for r in (0, 1):
        with open(os.path.join(d, f"log{r}.txt")) as f:
            tails.append(f.read()[-3000:])
    if None in exit_t:
        fail(f"{tag}: the worker pair did not finish within "
             f"{MH_PAIR_TIMEOUT_S} s; logs: {tails}")
    results = []
    for r in (0, 1):
        path = os.path.join(d, f"r{r}.json")
        if os.path.exists(path):
            with open(path) as f:
                results.append(json.load(f))
        else:
            results.append(None)
    return dict(dir=d, rcs=[p.returncode for p in procs], exit_t=exit_t,
                results=results, tails=tails,
                wall_s=time.perf_counter() - t0)


def mh_check_launches(tag: str, res: dict, shard_draws: int) -> dict:
    """A worker's kernel launches at its exit: one bucket_probe and one
    draw_assemble a draw for each owned shard (``shard_draws``), and at
    least one simhash (the index build)."""
    got = {k: res["launches"][k] for k in ("simhash", "bucket_probe",
                                           "draw_assemble")}
    if got["simhash"] < 1 or got["bucket_probe"] != shard_draws or \
            got["draw_assemble"] != shard_draws:
        fail(f"{tag}: launches {got}, expected bucket_probe and "
             f"draw_assemble {shard_draws} (one a draw a shard) and "
             f"simhash >= 1")
    return got


def mh_check_intact(tag: str, run: dict, batch0=None) -> list:
    """The fault-free pair: both ranks exit 0, healthy in generation 0,
    every loss finite, their launches; with ``batch0`` (the first batch
    of a one-process pipeline over both shards, built in this process)
    rank r's first batch must be shard r's rows of it, bitwise (ids,
    tokens, weights).  Returns each rank's launches."""
    import hashlib

    if run["rcs"] != [0, 0] or None in run["results"]:
        fail(f"{tag}: exit codes {run['rcs']}; logs: {run['tails']}")
    launched = []
    for r, res in enumerate(run["results"]):
        c = res["cluster"]
        if res["incident"] is not None or c["state"] != "healthy" or \
                c["generation"] != 0 or c["transitions"]:
            fail(f"{tag} rank {r}: an incident in a fault-free run: {c}")
        if not all(map(math.isfinite, res["losses_pre"])):
            fail(f"{tag} rank {r}: losses {res['losses_pre']}")
        launched.append(mh_check_launches(f"{tag} rank {r}", res,
                                          len(res["weight_means"])))
        if batch0 is None:
            continue
        m_s = batch0["example_ids"].shape[0] // 2
        rows = slice(r * m_s, (r + 1) * m_s)
        fb = res["first_batch"]
        want = (batch0["example_ids"][rows].tolist(), hashlib.sha256(
            batch0["tokens"][rows].cpu().numpy().tobytes()).hexdigest(),
            batch0["loss_weights"][rows].cpu().numpy().tobytes().hex())
        if (fb["example_ids"], fb["tokens_sha256"],
                fb["loss_weights_hex"]) != want:
            fail(f"{tag} rank {r}: the first batch is not shard {r}'s rows "
                 f"of the one-process batch: {fb} vs {want}")
    return launched


def mh_check_drill(tag: str, run: dict, stack, dev) -> dict:
    """The host-loss drill (rank 1 killed at MH_KILL_AT): rank 1 exits 17
    and rank 0 exits 0; the incident names [1] dead; the transitions are
    [missing-host-degraded, reformed]; "shard 1 adopted by rank 0" once;
    one reform shard and the writer fence held; restore step <= incident
    + 4; the degraded weight means finite and positive; every loss
    finite; the survivor's launches; then ``replay_post_reform`` in this
    process gives the survivor's post-reform digest and losses bitwise."""
    from repro_torch.dist import multihost_worker as mw

    r0 = run["results"][0]
    if run["rcs"] != [0, 17] or r0 is None:
        fail(f"{tag}: exit codes {run['rcs']} (want [0, 17]); logs: "
             f"{run['tails']}")
    c = r0["cluster"]
    states = [t[2] for t in c["transitions"]]
    adopted = [e[2] for e in c["events"]].count("shard 1 adopted by rank 0")
    dm = r0["degraded_weight_means"]
    losses = r0["losses_degraded"] + r0["losses_post"]
    if (r0["incident"] is None or r0["incident"]["dead"] != [1]
            or states != ["missing-host-degraded", "reformed"]
            or adopted != 1 or r0["reform_shards"] != 1
            or r0["reform_writer"] is not True
            or r0["restore_step"] > r0["incident"]["step"] + 4
            or len(dm) != 4 or not all(math.isfinite(v) and v > 0
                                       for v in dm)
            or not all(map(math.isfinite, losses))):
        fail(f"{tag}: the survivor did not walk the ladder: "
             f"{json.dumps({k: v for k, v in r0.items() if k != 'timings'})}")
    launched = mh_check_launches(
        f"{tag} survivor", r0, r0["pre_draws"] + 2 * len(dm)
        + r0["post_draws"])
    t0 = time.perf_counter()
    rep = mw.replay_post_reform(
        os.path.join(run["dir"], "ckpt"), r0["restore_step"],
        len(r0["losses_post"]), n_shards=1, stack=stack, device=dev)
    replay_s = time.perf_counter() - t0
    if rep["digest"] != r0["post_digest"] or \
            rep["losses"] != r0["losses_post"]:
        fail(f"{tag}: the replay is not the survivor's stream: digest "
             f"{rep['digest']} vs {r0['post_digest']}, losses "
             f"{rep['losses']} vs {r0['losses_post']}")
    tm = r0["timings"]
    return dict(
        incident=r0["incident"], transitions=c["transitions"],
        events=c["events"], restore_step=r0["restore_step"],
        reform_shards=1, reform_writer=True, degraded_weight_means=dm,
        losses_degraded=r0["losses_degraded"],
        losses_post=r0["losses_post"], replay_bitwise=True,
        replay_s=replay_s, launches=launched,
        kill_to_detect_s=tm["incident_wall_t"] - run["exit_t"][1],
        adopt_s=tm["adopt_s"],
        reform_to_first_step_s=tm["reform_to_first_step_s"],
        build_s=tm["build_s"], peak_gb=r0["max_memory_allocated"] / 1e9,
        wall_s=run["wall_s"])


def multihost_card(torch, dev) -> dict:
    """Phase 3j: the worker (``repro_torch.dist.multihost_worker``) as two
    processes on the card, on the reference worker's tiny stack.  (a) No
    fault: 10 steps, a sync every 5; both ranks healthy in generation 0,
    and each rank's first batch bitwise shard r's rows of a one-process
    ``ShardedLSHPipeline(n_shards=2)``'s first batch built here on the
    card from the same weights.  (b) The host-loss drill with the
    reference test's flags (tests/test_multihost.py:720-731), rank 1
    killed at step 12 (``mh_check_drill``).  Each process's launches are
    held (``mh_check_launches``)."""
    import shutil
    import tempfile

    from repro_torch.dist import multihost_worker as mw
    from repro_torch.models import LM

    tmp = tempfile.mkdtemp(prefix="chip_smoke_3j_")
    stack = mh_stack("tiny")
    run = mh_pair(tmp, "3j-intact", "tiny", MH_INTACT)
    model = LM.init(stack.model, seed=mw.PARAM_KEY_SEED, device=dev)
    batch0 = mw.build_pipeline(model, 2, stack=stack,
                               device=dev).next_batch()
    launched = mh_check_intact("3j", run, batch0)
    res = dict(intact_launches=launched, intact_wall_s=run["wall_s"],
               composition_bitwise=True)
    del model, batch0
    drill = mh_pair(tmp, "3j-drill", "tiny", MH_DRILL, kill_at=MH_KILL_AT)
    res["drill"] = mh_check_drill("3j", drill, stack, dev)
    shutil.rmtree(tmp)
    return res


def _steady_ms(stamps: list, skip: set) -> list:
    """Each step's ms from the per-step stamps (step k's stamp is taken
    after its hook), without the steps in ``skip``."""
    return [(b - a) * 1e3 for k, (a, b) in enumerate(
        zip(stamps, stamps[1:]), start=2) if k not in skip]


def multihost_full_width(torch, np, dev, single_p50: float) -> dict:
    """Phase 4j: two worker processes share the card, each running the
    worker's code on ``mh_stack("full")`` (MH_ARCH whole, bf16, Adam).
    First a fault-free run (MH_INTACT_FULL, barrier and heartbeat
    windows of MH_WIDE_TIMEOUTS): no incident, the launches, the longest
    barrier wait and the longest gap between a rank's beats; the drill's
    barrier and heartbeat timeouts are set above them and printed beside
    them.  Then 3j(b)'s drill at full width with those timeouts
    (``mh_check_drill``, the replay in this process).  Reported: each
    process's build s, the steady step p10 / p50 with two processes on
    the card (the fault-free run's steps 2-4 and the survivor's steps
    2-12 but the syncs at 5 and 10) beside 4i's one-process p50, each
    sync's ms and the gloo all-reduce inside it, the kill to
    ``HostLossDetected``, the adoption build, reform to first step, the
    checkpoint's bytes, each process's peak memory."""
    import shutil
    import tempfile

    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_4j_")
    stack = mh_stack("full")
    run = mh_pair(tmp, "4j-intact", "full",
                  MH_INTACT_FULL + MH_WIDE_TIMEOUTS)
    launched = mh_check_intact("4j", run)
    syncs = [s for res in run["results"] for s in res["timings"]["syncs"]]
    wait_max = max(s["barrier_s"] for s in syncs)
    gap_max = max(b - a for res in run["results"] for a, b in zip(
        res["timings"]["hook_stamps"], res["timings"]["hook_stamps"][1:]))
    # twice the gap: the drill's step 10 also holds a refresh, which the
    # fault-free run's one sync does not
    hb_s = max(3.0, math.ceil(2 * gap_max))
    # two missed windows outlast a heartbeat timeout: a killed rank is
    # named by its stale beats, not by the alive-but-stuck fallback
    barrier_s = max(2.0, math.ceil(2 * wait_max) + 1, math.ceil(hb_s / 2) + 1)
    print(f"4j timeouts: barrier {barrier_s} s (the fault-free run's "
          f"longest barrier wait {wait_max:.3f} s), heartbeat {hb_s} s (its "
          f"longest gap between a rank's beats {gap_max:.3f} s)", flush=True)
    ckpt_dir = os.path.join(run["dir"], "ckpt")
    ckpt_bytes = sum(os.path.getsize(os.path.join(dp, f))
                     for dp, _, fs in os.walk(ckpt_dir) for f in fs)
    res = dict(
        arch=MH_ARCH, batch_per_process=MH_BATCH // 2,
        seq=TRAIN_SEQ, corpus=MH_CORPUS, intact_launches=launched,
        build_s=[r["timings"]["build_s"] for r in run["results"]],
        one_process_p50_4i=single_p50,
        syncs=[dict(rank=r, **s) for r, res_ in enumerate(run["results"])
               for s in res_["timings"]["syncs"]],
        longest_barrier_wait_s=wait_max, longest_beat_gap_s=gap_max,
        barrier_timeout_s=barrier_s, heartbeat_timeout_s=hb_s,
        ckpt_bytes=ckpt_bytes,
        peak_gb=[r["max_memory_allocated"] / 1e9 for r in run["results"]],
        losses=[r["losses_pre"] for r in run["results"]],
        intact_wall_s=run["wall_s"])
    shutil.rmtree(run["dir"])          # the checkpoint's disk, for the drill
    drill = mh_pair(tmp, "4j-drill", "full", MH_DRILL + [
        "--barrier-timeout", str(barrier_s),
        "--heartbeat-timeout", str(hb_s)], kill_at=MH_KILL_AT)
    res["drill"] = mh_check_drill("4j", drill, stack, dev)
    # both processes stepping: the fault-free run's steps 2-4 and the
    # survivor's 2-12 (rank 1 dies in step 12's hook), no sync step
    steady = [ms for r in run["results"] for ms in _steady_ms(
        r["timings"]["step_stamps"], {5})] + _steady_ms(
        drill["results"][0]["timings"]["step_stamps"][:12], {5, 10})
    res.update(step_ms_p10=float(np.percentile(steady, 10)),
               step_ms_p50=float(np.percentile(steady, 50)),
               steady_steps=len(steady))
    shutil.rmtree(tmp)
    gc.collect()
    torch.cuda.empty_cache()
    return res


def main() -> int:
    t_script = time.perf_counter()

    def stamp(phase: str):
        print(f"phase {phase} starts at "
              f"{time.perf_counter() - t_script:.1f} s", flush=True)
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a card")
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        import numpy as np
        from repro_torch import kernels
        from repro_torch.core import (
            IndexMutation, LGDState, compute_codes, evict_rows, full_loss,
            hash_points, init, lgd_step, mutate_index, probe_masks,
            regression_query, sgd_step)
        from repro_torch.core.simhash import quadratic_forms
        from repro_torch.core.sampler import (
            _probe_bounds, draw_assemble, draw_assemble_plain, draw_samples)
        from repro_torch.data import make_regression
        from repro_torch.kernels import build
        from repro_torch.kernels.bucket_probe import (
            bucket_probe_codes_cuda, bucket_probe_codes_ref,
            bucket_probe_cuda, bucket_probe_multi_cuda,
            bucket_probe_multi_ref, bucket_probe_ref)
        from repro_torch.kernels.bucket_probe import kernel as bp_kernel
        from repro_torch.kernels.simhash import (
            simhash_codes_cuda, simhash_codes_ref)
        from repro_torch.kernels.simhash import kernel as sh_kernel
        from repro_torch.quickstart import make_problem
        from repro_torch import configs, serve
        from repro_torch.kernels.flash_attention import (
            attention_ref, decode_ref, flash_attention_cuda,
            flash_decode_cuda)
        from repro_torch.kernels.flash_attention.kernel import (
            decode_chunk, decode_smem_bytes, prefill_bf16_smem_bytes,
            sm_count)
        from repro_torch.models import LM
        from repro_torch.core import LSHIndex, LSHParams
        from repro_torch.data import (
            LSHPipelineConfig, LSHSampledPipeline, lm_head_query_fn,
            make_token_corpus, mean_pool_feature_fn)
        from repro_torch.kernels.gather_weight import (
            gather_weight_cuda, gather_weight_ref)
        from repro_torch.launch import train as launch_train
        from repro_torch.optim import Adam, schedules
        from repro_torch.train import Trainer, TrainerConfig
    except ImportError as e:
        fail(f"the repro_torch package is not beside this script: {e}")

    dev = torch.device("cuda")
    kernels.require_full_fp32()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}",
          flush=True)
    if kind != CARD:
        fail(f"the bounds assume the H100 SXM ({CARD}), not {kind}")
    report = {"card": card, "kernels": {}, "probe_rows": [], "paths": {},
              "profile": {}}

    # -- 1. build ---------------------------------------------------------
    stamp("1")
    t0 = time.perf_counter()
    build.build_all()
    report["build_s"] = time.perf_counter() - t0
    print(f"kernel build: {report['build_s']:.2f} s "
          f"({len(build.SOURCES)} sources, one nvcc each)", flush=True)
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    def timings(kernel, plain, library, reps):
        """ms / plain_ms / library_ms (device time) plus the loop times."""
        out = {}
        for key, fn in (("ms", kernel), ("plain_ms", plain),
                        ("library_ms", library)):
            if fn is None:
                continue
            tm = time_ms(torch, fn, reps)
            out[key] = tm["ms"]
            out[key.replace("ms", "loop_ms")] = tm["loop_ms"]
            out["timed_by"] = tm["timed_by"]
        return out

    sh_use = simhash_usage(build)
    print("simhash ptxas " + json.dumps(sh_use), flush=True)
    if not sh_use or any(u["spill"] or u["regs"] > 255
                         for u in sh_use.values()):
        fail(f"simhash kernel: no ptxas line, a spill or > 255 registers: "
             f"{sh_use}")

    def simhash_extras(x, w_, codes, l_, k_, reps):
        """The simhash row's plan, its instantiation's registers, spills
        and shared memory, ``x @ w`` through torch.matmul timed as a
        yardstick (not the same function: no sign, no pack), and two
        checks: a second call gives the same bits, and 16 rows of x probed
        as queries against the index sorted from ``codes`` each find
        their own code, bitwise (the probe sums in simhash's order)."""
        if not torch.equal(simhash_codes_cuda(x, w_, k=k_, l=l_), codes):
            fail("two simhash calls on the same inputs differ")
        sc_ = torch.sort(codes, dim=1).values
        g_ = torch.Generator(device=dev).manual_seed(17)
        rows = torch.randperm(x.shape[0], generator=g_, device=dev)[:16]
        lo, hi = bucket_probe_cuda(x[rows].contiguous(), w_, sc_, k=k_,
                                   l=l_)
        if not (bool((hi > lo).all()) and torch.equal(
                torch.gather(sc_, 1, lo.T.long()), codes[:, rows])):
            fail(f"the probe does not find simhash's codes of its points "
                 f"(d {x.shape[1]})")
        plan = sh_kernel.simhash_plan(*x.shape, l_, k_, sm_count(0))
        inst = sh_kernel.simhash_instance(x, plan, l_, k_)
        return dict(plan=plan._asdict(), instance=simhash_label(inst),
                    **sh_use[simhash_label(inst)], dynamic_smem=inst["smem"],
                    projection_matmul_ms=time_ms(torch, lambda: x @ w_,
                                                 reps)["ms"],
                    repeat_bitwise=True, probe_identity_rows=16)

    # -- 2. kernels against their plain versions, slice shapes --------------
    stamp("2")
    gen = torch.Generator(device=dev).manual_seed(0)
    ds = make_regression(gen, "yearmsd-like", n_train=N_TRAIN, d=90,
                         noise="pareto", device=dev)
    prob_srp, _ = make_problem("srp", 0, "sgd")
    _, _, x_aug = prob_srp.preprocess(ds.x_train, ds.y_train)   # (N, 91)
    p_lin = prob_srp.lsh
    n, d = x_aug.shape
    l, k = p_lin.l, p_lin.k
    lk = l * k
    idx_lin = mutate_index(None, IndexMutation("build", generator=gen,
                                               x_aug=x_aug), p_lin)
    w = idx_lin.projections
    sc = idx_lin.sorted_codes

    got = simhash_codes_cuda(x_aug, w, k=k, l=l)                # (L, N)
    ref = simhash_codes_ref(x_aug, w, k=k, l=l).T
    near = ((x_aug @ w).abs() < 1e-4).reshape(n, l, k).any(-1).T
    diff = (got - ref).abs()
    err = int(diff[~near].max())
    flips = int((diff > 0).sum())
    print(f"simhash (N={n}, d={d}, L={l}, K={k}): max |err| outside "
          f"near-zero = {err}, codes differing = {flips}, near-zero "
          f"(|proj| < 1e-4) = {int(near.sum())}", flush=True)
    if err != 0:
        fail("simhash kernel disagrees with its plain version")
    nb, fl = bound(n * d * 4 + d * lk * 4 + n * l * 8, 2.0 * n * d * lk)
    report["kernels"]["simhash"] = dict(
        name="simhash", route="cuda", source="src/repro_torch/csrc/simhash.cu",
        replaces="src/repro/kernels/simhash/kernel.py:76",
        max_abs_err=err, bound_ms=nb, bound_by=fl, library_ms=None,
        **simhash_extras(x_aug, w, got, l, k, 10),
        **timings(lambda: simhash_codes_cuda(x_aug, w, k=k, l=l),
                  lambda: simhash_codes_ref(x_aug, w, k=k, l=l), None, 10))
    print("simhash " + json.dumps(report["kernels"]["simhash"]), flush=True)
    del got, ref, near, diff

    prob_q, _ = make_problem("quadratic", 0, "sgd")
    idx_q = mutate_index(None, IndexMutation("build", generator=gen,
                                             x_aug=x_aug), prob_q.lsh)
    levels = math.floor(math.log2(n))   # fewest loads of one search of N codes

    def probe_bound(rows: int, hashed_b: int):
        """rows = B*J*L searches; hashed_b queries hashed in the kernel."""
        nbytes = rows * (2 * levels * 8 + 2 * 4)
        flops = 0.0
        if hashed_b:
            nbytes += hashed_b * d * 4 + d * lk * 4
            flops = 2.0 * hashed_b * d * lk
        return bound(nbytes, flops)

    def two_searches(qc_lb, sorted_codes):
        return (torch.searchsorted(sorted_codes, qc_lb, side="left",
                                   out_int32=True),
                torch.searchsorted(sorted_codes, qc_lb, side="right",
                                   out_int32=True))

    def check_hashed(name, b, j, got, want, q):
        # exempt (b, t) whose query projection is near zero: summation
        # order may flip its sign, and with it the bucket
        near = ((q @ w).abs() < 1e-4).reshape(b, 1, l, k).any(-1)
        near = near.expand(b, j, l)
        e = max(int((got[0] - want[0]).abs()[~near].max()),
                int((got[1] - want[1]).abs()[~near].max()))
        if e != 0:
            fail(f"{name} kernel disagrees with its plain version (B={b})")
        return e

    masks3 = probe_masks(k, 3)
    for b in (1, 16):
        theta = 0.1 * torch.randn((b, d - 1), generator=gen, device=dev)
        q = regression_query(theta).contiguous()
        qcodes = compute_codes(q, w, k=k, l=l)
        # fused (J = 1)
        got = bucket_probe_cuda(q, w, sc, k=k, l=l)
        want = bucket_probe_ref(q, w, sc, k=k, l=l)
        e = check_hashed("bucket_probe", b, 1, (got[0][:, None], got[1][:, None]),
                         (want[0][:, None], want[1][:, None]), q)
        nb, fl = probe_bound(b * l, b)
        qt = qcodes.T.contiguous()
        row = dict(name="bucket_probe", B=b, J=1, max_abs_err=e,
                   bound_ms=nb, bound_by=fl, **timings(
                       lambda: bucket_probe_cuda(q, w, sc, k=k, l=l),
                       lambda: bucket_probe_ref(q, w, sc, k=k, l=l),
                       lambda: two_searches(qt, sc), 100))
        report["probe_rows"].append(row)
        # multi (J = 3)
        got = bucket_probe_multi_cuda(q, w, sc, masks3, k=k, l=l)
        want = bucket_probe_multi_ref(q, w, sc, masks3, k=k, l=l)
        e = check_hashed("bucket_probe_multi", b, 3, got, want, q)
        marr = torch.tensor(masks3, dtype=torch.int64, device=dev)
        pt = (qcodes[:, None, :] ^ marr[None, :, None]).reshape(
            b * 3, l).T.contiguous()
        nb, fl = probe_bound(b * 3 * l, b)
        row = dict(name="bucket_probe_multi", B=b, J=3, max_abs_err=e,
                   bound_ms=nb, bound_by=fl, **timings(
                       lambda: bucket_probe_multi_cuda(q, w, sc, masks3,
                                                       k=k, l=l),
                       lambda: bucket_probe_multi_ref(q, w, sc, masks3,
                                                      k=k, l=l),
                       lambda: two_searches(pt, sc), 100))
        report["probe_rows"].append(row)
        # codes (quadratic family), J in {1, 3}
        qq = compute_codes(q, idx_q.projections, k=k, l=l, quadratic=True)
        for j in (1, 3):
            pc = (qq[:, None, :] ^ marr[None, :j, None]).reshape(b * j, l)
            pc = pc.contiguous()
            got = bucket_probe_codes_cuda(pc, idx_q.sorted_codes)
            want = bucket_probe_codes_ref(pc, idx_q.sorted_codes)
            e = max(int((got[0] - want[0]).abs().max()),
                    int((got[1] - want[1]).abs().max()))
            if e != 0:
                fail(f"bucket_probe_codes kernel disagrees (B={b}, J={j})")
            pct = pc.T.contiguous()
            nb, fl = probe_bound(b * j * l, 0)
            row = dict(name="bucket_probe_codes", B=b, J=j, max_abs_err=e,
                       bound_ms=nb, bound_by=fl, **timings(
                           lambda: bucket_probe_codes_cuda(
                               pc, idx_q.sorted_codes),
                           lambda: bucket_probe_codes_ref(
                               pc, idx_q.sorted_codes),
                           lambda: two_searches(pct, idx_q.sorted_codes),
                           100))
            report["probe_rows"].append(row)
    # what ptxas gave the two probe kernels
    probe_use = {}
    for fn_name, u in build.ptxas_usage(build.build_log("bucket_probe")).items():
        for kname in ("probe_hashed_kernel", "probe_codes_kernel"):
            if kname in fn_name:
                probe_use[kname] = u
    if len(probe_use) != 2:
        fail(f"the build log has no ptxas line of a probe kernel: {probe_use}")

    def probe_regs(name):
        u = probe_use["probe_codes_kernel" if name == "bucket_probe_codes"
                      else "probe_hashed_kernel"]
        return dict(regs=u["registers"],
                    spill=u["spill_stores"] + u["spill_loads"])

    b1 = next(r for r in report["probe_rows"]
              if (r["name"], r["B"]) == ("bucket_probe_multi", 1))
    q1 = regression_query(0.1 * torch.randn(
        (1, d - 1), generator=gen, device=dev)).contiguous()
    b1["j1_params"] = time_param_blocks(
        torch, bp_kernel, lambda: bucket_probe_multi_cuda(
            q1, w, sc, (0,), k=k, l=l))
    for row in report["probe_rows"]:
        row.update(probe_regs(row["name"]))
        print("probe " + json.dumps(row), flush=True)
    # the main path probes ONE query per step: B = 1 rows go in the table
    main_shape = {"bucket_probe": (1, 1), "bucket_probe_multi": (1, 3),
                  "bucket_probe_codes": (1, 1)}
    for row in report["probe_rows"]:
        if (row["B"], row["J"]) == main_shape[row["name"]]:
            report["kernels"][row["name"]] = dict(
                name=row["name"], route="cuda",
                source="src/repro_torch/csrc/bucket_probe.cu",
                replaces={
                    "bucket_probe":
                        "src/repro/kernels/bucket_probe/kernel.py:164",
                    "bucket_probe_multi":
                        "src/repro/kernels/bucket_probe/kernel.py:200",
                    "bucket_probe_codes":
                        "src/repro/kernels/bucket_probe/kernel.py:246",
                }[row["name"]],
                max_abs_err=row["max_abs_err"], ms=row["ms"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=row["library_ms"])
    del idx_lin, idx_q, sc, w

    # -- 2b. flash kernels against their plain versions, serve shapes -------
    stamp("2b")
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    ga = torch.Generator(device=dev).manual_seed(5)

    def hold(name, tname, got, want, gold):
        """Readings of ``got`` against its plain version ``want`` and, in
        bf16, the f32 result ``gold``; fails past the limits above."""
        rtol, atol = TOL[tname]
        got, want = got.float(), want.float()
        out = {"max_abs_err": float((got - want).abs().max()),
               "max_rel_err": float(((got - want).abs()
                                     / want.abs().clamp_min(atol)).max()),
               "rtol": rtol, "atol": atol}
        if not torch.allclose(got, want, rtol=rtol, atol=atol):
            fail(f"{name} ({tname}) disagrees with its plain version: max "
                 f"|err| {out['max_abs_err']:.3g} at rtol {rtol}, atol {atol}")
        if gold is not None:
            out["err_vs_f32"] = float((got - gold).abs().max())
            out["plain_err_vs_f32"] = float((want - gold).abs().max())
            if not (out["err_vs_f32"]
                    <= BF16_GOLD_FACTOR * out["plain_err_vs_f32"]):
                fail(f"{name} ({tname}) is {out['err_vs_f32']:.3g} from the "
                     f"f32 result, more than {BF16_GOLD_FACTOR} x the plain "
                     f"version's {out['plain_err_vs_f32']:.3g}")
        return out

    def flash_rows(hkv, group, d_head, cache_lens):
        """Phase 2b's rows at one head shape (Hkv, G, D): the prefill and
        the decode, f32 and bf16, B 4, prompt 2,048, a cache of
        cache_lens[-1] rows valid up to cache_lens."""
        b_, hq, s_cache = SERVE_B, hkv * group, cache_lens[-1]
        lens = torch.tensor(cache_lens, dtype=torch.int32, device=dev)
        valid = torch.arange(s_cache, device=dev)[None, :] < lens[:, None]
        rows = []
        # decode's split-KV plan at these shapes, from the wrapper's rule
        dec_chunk = decode_chunk(s_cache, b_ * hkv, sm_count(dev.index or 0))
        dec_split = -(-s_cache // dec_chunk)
        l2_bytes = torch.cuda.get_device_properties(dev).L2_cache_size
        for dtype in (torch.float32, torch.bfloat16):
            tname = str(dtype).split(".")[1]
            bf16 = dtype == torch.bfloat16
            esize = torch.finfo(dtype).bits // 8
            peak = BF16_PEAK if bf16 else FP32_PEAK

            def randn(*shape):
                return torch.randn(shape, generator=ga, device=dev).to(dtype)

            fq = randn(b_, hkv, group, SERVE_PROMPT, d_head)
            fk = randn(b_, hkv, SERVE_PROMPT, d_head)
            fv = randn(b_, hkv, SERVE_PROMPT, d_head)
            got = flash_attention_cuda(fq, fk, fv, causal=True)
            want = attention_ref(fq, fk, fv, causal=True)
            gold = (attention_ref(fq.float(), fk.float(), fv.float(),
                                  causal=True) if bf16 else None)
            readings = hold("flash_attention", tname, got, want, gold)
            # the causal half
            flops = 4.0 * b_ * hq * SERVE_PROMPT ** 2 * d_head / 2
            nbytes = (2 * fq.numel() + fk.numel() + fv.numel()) * esize
            nb, fl = bound(nbytes, flops, peak)
            qh = fq.reshape(b_, hq, SERVE_PROMPT, d_head)
            row = dict(name="flash_attention", dtype=tname, **readings,
                       bound_ms=nb, bound_by=fl, flops=flops, **timings(
                           lambda: flash_attention_cuda(fq, fk, fv,
                                                        causal=True),
                           lambda: attention_ref(fq, fk, fv, causal=True),
                           lambda: sdpa(qh, fk, fv, is_causal=True,
                                        enable_gqa=True), 5))
            if bf16:
                # the tensor cores' work: every visited 64 x 64 tile (the
                # diagonal ones whole), Q.K^T once and P.V twice (hi + lo)
                nt = SERVE_PROMPT // 64
                row["mma_flops"] = (b_ * hq * nt * (nt + 1) / 2
                                    * 3 * 2 * 64 * 64 * d_head)
                row["mma_tflops"] = row["mma_flops"] / row["ms"] / 1e9
            rows.append(row)
            del fq, fk, fv, qh, got, want, gold

            # decode: set 0 is checked; the kernel, the plain version and
            # SDPA are timed cycling through L2_SETS sets larger together
            # than the L2, as the serve path's 32 layers' caches are (cold),
            # and on set 0 alone (L2-warm, as earlier calls timed it)
            set_bytes = (b_ * hkv * (group + 2 * s_cache) * d_head) * esize
            # at least L2_SETS sets, and together twice the L2
            n_sets = max(L2_SETS, -(-2 * l2_bytes // set_bytes))
            sets = [(randn(b_, hkv, group, d_head),
                     randn(b_, hkv, s_cache, d_head),
                     randn(b_, hkv, s_cache, d_head)) for _ in range(n_sets)]
            if n_sets * set_bytes <= l2_bytes:
                fail(f"decode timing sets ({n_sets} x {set_bytes} bytes) fit "
                     f"in the {l2_bytes}-byte L2")
            fq, fk, fv = sets[0]
            got = flash_decode_cuda(fq, fk, fv, lens)
            want = decode_ref(fq, fk, fv, lens)
            gold = (decode_ref(fq.float(), fk.float(), fv.float(), lens)
                    if bf16 else None)
            readings = hold("flash_decode", tname, got, want, gold)
            keys = sum(cache_lens)             # the cache rows the data need
            flops = 4.0 * hq * d_head * keys
            nbytes = (2 * keys * hkv * d_head + 2 * fq.numel()) * esize
            nb, fl = bound(nbytes, flops, peak)
            mask = valid[:, None, None, :]
            fns = {"kernel": lambda qq, kk, vv: flash_decode_cuda(
                       qq, kk, vv, lens),
                   "plain": lambda qq, kk, vv: decode_ref(qq, kk, vv, lens),
                   "library": lambda qq, kk, vv: sdpa(
                       qq.reshape(b_, hq, 1, d_head), kk, vv, attn_mask=mask,
                       enable_gqa=True)}
            cold = timings(*(rotate([functools.partial(fn, *st)
                                     for st in sets])
                             for fn in fns.values()), 12 * n_sets)
            warm = timings(*(functools.partial(fn, *sets[0])
                             for fn in fns.values()), 48)
            row = dict(name="flash_decode", dtype=tname, **readings,
                       bound_ms=nb, bound_by=fl, flops=flops, **cold,
                       ms_l2_warm=warm["ms"],
                       plain_ms_l2_warm=warm["plain_ms"],
                       library_ms_l2_warm=warm["library_ms"], l2_sets=n_sets,
                       l2_set_bytes=set_bytes, l2_bytes=l2_bytes,
                       chunk=dec_chunk, splits=dec_split,
                       blocks=b_ * hkv * dec_split,
                       blocks_with_keys=hkv * sum(
                           -(-min(n, s_cache) // dec_chunk) if n > 0
                           else dec_split for n in cache_lens))
            row["bound_share_l2_warm"] = nb / row["ms_l2_warm"]
            rows.append(row)
            del fq, fk, fv, sets, got, want, gold
        return rows

    report["flash_rows"] = flash_rows(HKV, GROUP, D_HEAD, CACHE_LENS)
    for row in report["flash_rows"]:
        row["tflops"] = row["flops"] / row["ms"] / 1e9
        row["bound_share"] = row["bound_ms"] / row["ms"]
        print("flash " + json.dumps(row), flush=True)
        if row["dtype"] == "bfloat16":          # the serve path's type
            report["kernels"][row["name"]] = dict(
                row, route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces={"flash_attention":
                          "src/repro/kernels/flash_attention/kernel.py:92",
                          "flash_decode":
                          "src/repro/kernels/flash_attention/kernel.py:184",
                          }[row["name"]])

    # what ptxas gave the bf16 prefill at the serve head dim: it must not
    # spill (dynamic shared memory is set at launch, so it comes from
    # the source's own formula)
    usage = [u for fn, u in build.ptxas_usage(
        build.build_log("flash_attention")).items()
        if f"flash_prefill_mma_kernelILi{D_HEAD}E" in fn]
    if len(usage) != 1:
        fail("the build log has no ptxas line of the bf16 prefill kernel")
    report["prefill_ptxas"] = dict(
        usage[0], kernel=f"flash_prefill_mma_kernel<{D_HEAD}>",
        dynamic_smem=prefill_bf16_smem_bytes(D_HEAD))
    print("flash_attention bf16 ptxas " + json.dumps(report["prefill_ptxas"]),
          flush=True)
    if usage[0]["spill_stores"] or usage[0]["spill_loads"]:
        fail(f"the bf16 prefill kernel spills: {usage[0]}")
    # and the bf16 (tensor-core) decode at D = 128: its one instance
    # (G <= 16 heads in one 16-row mma tile) must not spill either
    dec = [u for fn, u in build.ptxas_usage(
        build.build_log("flash_attention")).items()
        if f"flash_decode_mma_kernelILi{D_HEAD}ELi1E" in fn]
    if len(dec) != 1:
        fail("the build log has no ptxas line of the bf16 decode kernel")
    report["decode_ptxas"] = dict(
        dec[0], kernel=f"flash_decode_mma_kernel<{D_HEAD}, 1>",
        dynamic_smem=decode_smem_bytes(GROUP, D_HEAD, True))
    print("flash_decode bf16 ptxas " + json.dumps(report["decode_ptxas"]),
          flush=True)
    if dec[0]["spill_stores"] or dec[0]["spill_loads"]:
        fail(f"the bf16 decode kernel spills: {dec[0]}")

    # -- 2g. the flash kernels at the other archs' head shapes -------------
    stamp("2g")
    report["flash_rows_2g"] = {}
    for label, (hkv, group, d_head) in NEW_HEADS.items():
        rows = flash_rows(hkv, group, d_head, NEW_CACHE_LENS)
        for row in rows:
            row.update(heads=label, hkv=hkv, group=group, d_head=d_head,
                       tflops=row["flops"] / row["ms"] / 1e9,
                       bound_share=row["bound_ms"] / row["ms"])
            print("flash-2g " + json.dumps(row), flush=True)
        report["flash_rows_2g"][label] = rows
    # every D 64 instantiation (zamba2's, musicgen's and qwen3's head dim):
    # registers, spills and shared memory from the build log; none may
    # spill
    d64 = {fn: u for fn, u in build.ptxas_usage(
        build.build_log("flash_attention")).items() if "Li64E" in fn}
    if not any("flash_prefill_mma" in fn for fn in d64) or not any(
            "flash_decode" in fn for fn in d64):
        fail(f"the build log lacks the D 64 flash kernels: {sorted(d64)}")
    report["d64_ptxas"] = dict(
        d64, prefill_bf16_dynamic_smem=prefill_bf16_smem_bytes(64),
        decode_dynamic_smem={f"G{g}_{'bf16' if bf else 'f32'}":
                             decode_smem_bytes(g, 64, bf)
                             for g in (1, 16) for bf in (True, False)})
    print("flash D64 ptxas " + json.dumps(report["d64_ptxas"]), flush=True)
    spilled = {fn: u for fn, u in d64.items()
               if u["spill_stores"] or u["spill_loads"]}
    if spilled:
        fail(f"D 64 flash instantiations spill: {spilled}")

    # -- 2c. gather_weight against its plain version, train shapes ---------
    stamp("2c")
    report["gather_rows"] = []
    gg = torch.Generator(device=dev).manual_seed(7)
    for n_rows, m in ((TRAIN_CORPUS, TRAIN_BATCH), (N_TRAIN, 512)):
        width = TRAIN_SEQ + 1
        store = torch.randint(0, 200_064, (n_rows, width), generator=gg,
                              device=dev, dtype=torch.int32)
        gidx = torch.randint(0, n_rows, (m,), generator=gg, device=dev)
        gidx[: m // 4] = gidx[0]                        # duplicate ids
        gp = torch.rand((m,), generator=gg, device=dev) * 0.01
        gp[-2:] = torch.tensor([0.0, 1e-9])             # below p_floor
        rows, gw = gather_weight_cuda(store, gidx, gp, p_floor=1e-8)
        want_rows, want_w = gather_weight_ref(store, gidx, gp, p_floor=1e-8)
        if not (torch.equal(rows, want_rows) and torch.equal(
                gw.view(torch.int32), want_w.view(torch.int32))):
            fail(f"gather_weight (N={n_rows}, m={m}) is not bitwise equal to "
                 f"its plain version")
        uniq = int(torch.unique(gidx).numel())
        nb, fl = bound(uniq * width * 4 + m * width * 4 + m * (8 + 4 + 4),
                       2.0 * m)
        row = dict(name="gather_weight", N=n_rows, W=width, m=m,
                   unique_ids=uniq, max_abs_err=0, bound_ms=nb, bound_by=fl,
                   **timings(
                       lambda: gather_weight_cuda(store, gidx, gp,
                                                  p_floor=1e-8),
                       lambda: gather_weight_ref(store, gidx, gp,
                                                 p_floor=1e-8),
                       lambda: store.index_select(0, gidx), 100))
        report["gather_rows"].append(row)
        print("gather " + json.dumps(row), flush=True)
        del store, rows, want_rows
    main_gather = report["gather_rows"][0]
    report["kernels"]["gather_weight"] = dict(
        name="gather_weight", route="cuda",
        source="src/repro_torch/csrc/gather_weight.cu",
        replaces="src/repro/kernels/gather_weight/kernel.py:56",
        **{kk: main_gather[kk] for kk in (
            "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")})

    # the delta refresh's re-hash: simhash at its dirty buckets (N 64 and
    # 256) at the train path's d 3,072 and L·K 70, against its plain
    # version with the train-shape row's checks
    report["delta_simhash_rows"] = []
    gs = torch.Generator(device=dev).manual_seed(13)
    shift_s = torch.linspace(0, 2, 3072, device=dev)
    w_s = torch.randn((3072, 70), generator=gs, device=dev)
    for n_s in (64, 256):
        x_s = torch.randn((n_s, 3072), generator=gs, device=dev) + shift_s
        got = simhash_codes_cuda(x_s, w_s, k=7, l=10)
        want = simhash_codes_ref(x_s, w_s, k=7, l=10).T
        near_s = ((x_s @ w_s).abs() < 1e-4).reshape(n_s, 10, 7).any(-1).T
        e_s = int((got - want).abs()[~near_s].max())
        if e_s != 0:
            fail(f"simhash disagrees with its plain version at N {n_s}")
        nb, fl = bound(n_s * 3072 * 4 + 3072 * 70 * 4 + n_s * 10 * 8,
                       2.0 * n_s * 3072 * 70)
        row = dict(name="simhash", shape=f"N {n_s}, d 3,072, K 7, L 10",
                   max_abs_err=e_s, bound_ms=nb, bound_by=fl,
                   **simhash_extras(x_s, w_s, got, 10, 7, 100),
                   **timings(lambda: simhash_codes_cuda(x_s, w_s, k=7, l=10),
                             lambda: simhash_codes_ref(x_s, w_s, k=7, l=10),
                             None, 100))
        report["delta_simhash_rows"].append(row)
        print("simhash-delta " + json.dumps(row), flush=True)

    # -- 2d. draw_assemble against the plain composition -------------------
    stamp("2d")
    report["draw_rows"] = []
    gd = torch.Generator(device=dev).manual_seed(9)
    draw_use = {fn: u for fn, u in build.ptxas_usage(
        build.build_log("gather_weight")).items()
        if "draw_assemble_kernel" in fn}
    # four instantiations: 4- and 16-byte row copies, flat and band mode
    if len(draw_use) != 4 or any(u["spill_stores"] or u["spill_loads"]
                                 for u in draw_use.values()):
        fail(f"draw_assemble: not four ptxas lines, or a spill: {draw_use}")
    draw_regs = {("int4" if "int4" in fn else "int32")
                 + (" band" if "Lb1E" in fn else ""): u["registers"]
                 for fn, u in draw_use.items()}
    print("draw_assemble ptxas " + json.dumps(draw_use), flush=True)

    def draw_row(tag, args, x_, q_, law, d_law=None):
        """Hold draw_assemble against the plain composition on ``args``,
        check that two calls give the same bits, time both; the bound
        counts what this draw's walks and rows touch.  ``d_law``: the
        leading coordinates the law reads (a banded row's band id is
        not geometry)."""
        got = draw_assemble(*args)
        again = draw_assemble(*args)
        want = draw_assemble_plain(*args)
        res, res_w = got[0], want[0]
        for key in ("indices", "n_probes", "bucket_sizes", "fallback",
                    "probe_code"):
            if not torch.equal(getattr(res, key), getattr(res_w, key)):
                fail(f"draw_assemble {tag}: {key} differs from the plain "
                     f"composition")
        if got[1] is not None and not torch.equal(got[1], want[1]):
            fail(f"draw_assemble {tag}: gathered rows differ")
        flat = [t for t in list(got[0]) + list(got[1:]) if t is not None]
        flat2 = [t for t in list(again[0]) + list(again[1:])
                 if t is not None]
        if not all(torch.equal(a.view(torch.int32) if a.dtype ==
                               torch.float32 else a,
                               b.view(torch.int32) if b.dtype ==
                               torch.float32 else b)
                   for a, b in zip(flat, flat2)):
            fail(f"draw_assemble {tag}: two calls differ")
        err = (res.probs - res_w.probs).abs().reshape(-1)
        rel = err / res_w.probs.abs().reshape(-1).clamp_min(1e-38)
        worst = int(rel.argmax())
        ids = res.indices.reshape(-1)
        qb = q_[torch.arange(ids.numel(), device=dev) // res.indices.shape[1]]
        xd, qd = x_[ids, :d_law].double(), qb[:, :d_law].double()
        cos = (xd * qd).sum(-1) / (xd.norm(dim=-1) * qd.norm(dim=-1))
        if law == "quadratic":
            cos = cos * cos
        out = dict(shape=tag, max_abs_err=float(err.max()),
                   max_rel_err_p=float(rel[worst]),
                   worst_cos=float(cos[worst]),
                   worst_p=float(res_w.probs.reshape(-1)[worst]),
                   fallback_frac=float(res.fallback.float().mean()),
                   n_probes_max=int(res.n_probes.max()))
        if not torch.allclose(res.probs, res_w.probs, rtol=DRAW_RTOL,
                              atol=0):
            fail(f"draw_assemble {tag}: p differs by {out['max_rel_err_p']:.3g}"
                 f" (rtol {DRAW_RTOL}) at cos {out['worst_cos']:.6g}")
        if got[2] is not None:
            out["max_abs_err_w"] = float((got[2] - want[2]).abs().max())
            out["max_rel_err_w"] = float(((got[2] - want[2]).abs()
                                          / want[2].abs()).max())
            if not torch.allclose(got[2], want[2], rtol=DRAW_RTOL, atol=0):
                fail(f"draw_assemble {tag}: weights differ by "
                     f"{out['max_rel_err_w']:.3g}")
        # the bytes the draw needs: each block's walked table draws and
        # bounds, its order entry, slot_u, on a miss its fallback draw,
        # its x row once per distinct id, the queries, the results; with
        # a store its row read once per distinct id and written once a
        # block
        jj = len(args[8])
        found = ~res.fallback
        walked = torch.where(found, (res.n_probes - 1) * jj
                             + res.probe_code + 1,
                             res.n_probes * jj).sum()
        draws_read = res.n_probes.sum()
        uniq = int(torch.unique(ids).numel())
        blocks = ids.numel()
        misses = blocks - int(found.sum())
        d_ = x_.shape[1]
        nbytes = (int(draws_read) * 8 + int(walked) * 8
                  + int(found.sum()) * 8 + blocks * (4 + 25)
                  + uniq * d_ * 4 + q_.numel() * 4)
        if len(args) > 12 and args[12] is not None:   # band mode: starts,
            # band_u; on a miss fallback_u and order[0, slot]
            nbytes += blocks * (args[12].numel() * 4 + 4) + misses * 12
        else:                           # on a miss the fallback id
            nbytes += misses * 8
        if got[1] is not None:
            nbytes += (uniq + blocks) * got[1].shape[1] * 4 + blocks * 4
        nb, fl = bound(nbytes, 6.0 * d_ * blocks)
        out.update(bound_ms=nb, bound_by=fl, blocks=blocks,
                   **timings(lambda: draw_assemble(*args),
                             lambda: draw_assemble_plain(*args),
                             (lambda: args[9].index_select(0, ids))
                             if got[1] is not None else None, 100))
        out.pop("library_loop_ms", None)
        if "library_ms" in out:
            out["index_select_ms"] = out.pop("library_ms")
        return out

    for family, prob_f in (("srp", prob_srp), ("quadratic", prob_q)):
        index_d = mutate_index(None, IndexMutation(
            "build", generator=gd, x_aug=x_aug), prob_f.lsh)
        for b in (1, 16):
            theta = 0.1 * torch.randn((b, d - 1), generator=gd, device=dev)
            q = regression_query(theta).contiguous()
            for j in (1, 3):
                masks = probe_masks(k, j)
                lo, hi = _probe_bounds(index_d, q, prob_f.lsh, masks)
                dr = draw_samples(gd, (b, 16), 2 * l, l, n, dev)
                row = draw_row(f"{family}, B {b}, J {j}",
                               (dr, lo, hi, index_d.order, x_aug, q,
                                prob_f.lsh, 2 * l, masks), x_aug, q,
                               "quadratic" if family == "quadratic"
                               else "angle")
                row.update(name="draw_assemble", family=family, B=b, J=j,
                           m=16, regs=draw_regs["int32"], spill=0)
                report["draw_rows"].append(row)
                print("draw " + json.dumps(row), flush=True)
        del index_d
    # the train path's draw: seeded features, projections, store and
    # query at its shape
    n_t, d_t, k_t, l_t = TRAIN_CORPUS, 3072, 7, 10
    shift = torch.linspace(0, 2, d_t, device=dev)
    x_t = torch.randn((n_t, d_t), generator=gd, device=dev) + shift
    p_t = LSHParams(k=k_t, l=l_t, dim=d_t, family="srp")
    index_t = mutate_index(None, IndexMutation(
        "build", projections=torch.randn((d_t, l_t * k_t), generator=gd,
                                         device=dev), x_aug=x_t), p_t)
    store_t = torch.randint(0, 200_064, (n_t, TRAIN_SEQ + 1), generator=gd,
                            device=dev, dtype=torch.int32)
    q_t = (torch.randn((1, d_t), generator=gd, device=dev)
           + shift).contiguous()
    lo, hi = _probe_bounds(index_t, q_t, p_t, (0,))
    dr = draw_samples(gd, (1, TRAIN_BATCH), 2 * l_t, l_t, n_t, dev)
    row = draw_row(f"train: d {d_t}, K {k_t}, L {l_t}, N {n_t}, "
                   f"S+1 {TRAIN_SEQ + 1}",
                   (dr, lo, hi, index_t.order, x_t, q_t, p_t, 2 * l_t, (0,),
                    store_t, 1e-8), x_t, q_t, "angle")
    row.update(name="draw_assemble", family="srp", B=1, J=1, m=TRAIN_BATCH,
               regs=draw_regs["int32"], spill=0)
    report["draw_rows"].append(row)
    print("draw " + json.dumps(row), flush=True)
    # a streaming index at the train shape: 1/2 and 1/8 of the slots
    # evicted (the EMPTY_CODE tail), queries far from the live rows, so
    # most walks miss and fall back to the live prefix, n_live by value
    for frac in (2, 8):
        gone = torch.randperm(n_t, generator=gd, device=dev)[:n_t // frac]
        index_s = evict_rows(index_t, gone)
        n_live_s = n_t - n_t // frac
        # opposite the rows' common direction (the shift): few live rows
        # share their buckets
        q_s = (-(x_t[gone[:4]] + 2 * shift)).contiguous()
        lo, hi = _probe_bounds(index_s, q_s, p_t, (0,))
        dr = draw_samples(gd, (4, TRAIN_BATCH), 2 * l_t, l_t, n_live_s, dev)
        args_s = (dr, lo, hi, index_s.order, x_t, q_s, p_t, 2 * l_t, (0,),
                  store_t, 1e-8, n_live_s)
        row = draw_row(f"streaming: 1/{frac} evicted, n_live {n_live_s}",
                       args_s, x_t, q_s, "angle")
        res_s = draw_assemble(*args_s)[0]
        live_s = torch.ones(n_t, dtype=torch.bool, device=dev)
        live_s[gone] = False
        if not bool(live_s[res_s.indices].all()):
            fail(f"draw_assemble drew an evicted slot (1/{frac} evicted)")
        row.update(name="draw_assemble", family="srp", B=4, J=1,
                   m=TRAIN_BATCH, n_live=n_live_s,
                   fallbacks=int(res_s.fallback.sum()),
                   regs=draw_regs["int32"], spill=0)
        report["draw_rows"].append(row)
        print("draw " + json.dumps(row), flush=True)
    del x_t, index_t, store_t, index_s
    main_draw = report["draw_rows"][0]             # srp, B 1, J 1
    report["kernels"]["draw_assemble"] = dict(
        name="draw_assemble", route="cuda",
        source="src/repro_torch/csrc/gather_weight.cu",
        replaces="src/repro/kernels/gather_weight/kernel.py:56",
        **{kk: main_draw[kk] for kk in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
        library_ms=None)

    # -- 2e. draw_assemble's band mode against the plain composition -------
    stamp("2e")
    from repro_torch.core import band_starts, bucket_bounds_banded, \
        query_codes
    from repro_torch.core.families import get_family
    from repro_torch.core.tables import _band_probe_bits
    report["band_rows"] = []

    def band_row(tag, index_b, xa_b, q_b, lsh_b, m, p_max, j, live=None,
                 reps=100):
        """A banded draw on ``index_b``: the probe of every band, the
        starts, the band mode held against the plain composition; the
        bands drawn (from the plain version's ids) compared too."""
        masks = probe_masks(lsh_b.k, j)
        lo, hi = bucket_bounds_banded(index_b, q_b, lsh_b, masks)
        starts = band_starts(index_b, lsh_b)
        dr = draw_samples(gd, (q_b.shape[0], m), p_max, lsh_b.l,
                          index_b.n_points, dev, bands=True)
        args = (dr, lo, hi, index_b.order, xa_b, q_b, lsh_b, p_max, masks,
                None, 1e-8, None, starts)
        row = draw_row(tag, args, xa_b, q_b, "angle",
                       d_law=xa_b.shape[1] - 1)
        res = draw_assemble(*args)[0]
        want = draw_assemble_plain(*args)[0]
        bands = [xa_b[r.indices.reshape(-1), -1].round().long()
                 for r in (res, want)]
        if not torch.equal(*bands):
            fail(f"draw_assemble band mode {tag}: the bands drawn differ")
        if live is not None and not bool(live[res.indices].all()):
            fail(f"draw_assemble band mode {tag}: drew an evicted row")
        row.update(name="draw_assemble", mode="band", family="mips_banded",
                   B=q_b.shape[0], J=j, m=m, P=p_max,
                   nb=starts.numel() - 1,
                   bands_drawn=torch.bincount(
                       bands[0], minlength=starts.numel() - 1).tolist(),
                   regs=draw_regs["int32 band"], spill=0)
        report["band_rows"].append(row)
        print("draw-band " + json.dumps(row), flush=True)
        # the probe of this draw alone: every band's probe codes, one
        # bucket_probe_codes launch, against its plain version
        marr, tags = _band_probe_bits(tuple(masks), starts.numel() - 1,
                                      lsh_b.k, dev)
        qc = query_codes(index_b, q_b, lsh_b)
        pc = ((qc[:, None, None, :] ^ marr[None, None, :, None])
              | tags[None, :, None, None]).reshape(-1, lsh_b.l).contiguous()
        sc_b = index_b.sorted_codes
        got_p = bucket_probe_codes_cuda(pc, sc_b)
        want_p = bucket_probe_codes_ref(pc, sc_b)
        if not all(torch.equal(a_, b_) for a_, b_ in zip(got_p, want_p)):
            fail(f"bucket_probe_codes disagrees on the banded codes ({tag})")
        lv = math.floor(math.log2(index_b.n_points))
        nb_p, fl_p = bound(pc.numel() * (2 * lv * 8 + 2 * 4), 0.0)
        pct = pc.T.contiguous()
        prow = dict(name="bucket_probe_codes", shape=tag, codes=pc.numel(),
                    max_abs_err=0, bound_ms=nb_p, bound_by=fl_p,
                    **probe_regs("bucket_probe_codes"), **timings(
                        lambda: bucket_probe_codes_cuda(pc, sc_b),
                        lambda: bucket_probe_codes_ref(pc, sc_b),
                        lambda: two_searches(pct, sc_b), 100))
        report["band_rows"].append(prow)
        print("probe-band " + json.dumps(prow), flush=True)

    prob_b, _ = make_problem("mips_banded", 0, "sgd")
    _, _, xa_b = prob_b.preprocess(ds.x_train, ds.y_train)      # (N, 93)
    idx_b = mutate_index(None, IndexMutation(
        "build", generator=gd, x_aug=xa_b,
        live_mask=torch.ones(n, dtype=torch.bool, device=dev)), prob_b.lsh)
    for b in (1, 16):
        theta = 0.1 * torch.randn((b, d - 1), generator=gd, device=dev)
        q_b = prob_b.query_fn()(theta).contiguous()
        for j in (1, 3):
            band_row(f"mips_banded, B {b}, J {j}", idx_b, xa_b, q_b,
                     prob_b.lsh, 16, 2 * l, j)
    # the streaming row: every row of band 3 evicted, its region empty
    fam_b = get_family("mips_banded")
    gone = torch.nonzero(xa_b[:, -1] == 3).flatten()
    idx_e = evict_rows(idx_b, gone)
    st_e = band_starts(idx_e, prob_b.lsh)
    if int(st_e[4] - st_e[3]) != 0 or int(st_e[-1]) != n - gone.numel():
        fail(f"band 3 not empty after its evict: starts {st_e.tolist()}")
    live_e = torch.ones(n, dtype=torch.bool, device=dev)
    live_e[gone] = False
    q_b = prob_b.query_fn()(0.1 * torch.randn(
        (4, d - 1), generator=gd, device=dev)).contiguous()
    band_row(f"streaming: band 3 evicted ({gone.numel()} rows)", idx_e,
             xa_b, q_b, prob_b.lsh, 16, 2 * l, 1, live=live_e)
    del idx_b, idx_e, xa_b, live_e
    # the head shape: a (V, d) head of phi4-mini's width from a seeded
    # generator, drawn as the sampled-softmax loss would (K 12, L 8, J 3)
    d_head_rows = 3072
    rows_h = torch.randn((HEAD_ROWS, d_head_rows), generator=gd,
                         device=dev) * d_head_rows ** -0.5
    xa_h = fam_b.augment_data(rows_h, scale=fam_b.data_scale(rows_h))
    lsh_h = LSHParams(k=12, l=8, dim=d_head_rows + 2, family="mips_banded")
    idx_h = mutate_index(None, IndexMutation("build", generator=gd,
                                             x_aug=xa_h), lsh_h)
    q_h = fam_b.augment_query(torch.randn((4, d_head_rows), generator=gd,
                                          device=dev)).contiguous()
    band_row(f"head: N {HEAD_ROWS}, d {d_head_rows + 2}, K 12, L 8",
             idx_h, xa_h, q_h, lsh_h, 32, 16, 3)
    del rows_h, xa_h, idx_h
    # the flat rows of 2d beside PERF.md's (call 19.2) time of the main row
    report["draw_flat_vs_perf_md"] = dict(
        ms=main_draw["ms"], perf_md_ms=0.003067,
        ratio=main_draw["ms"] / 0.003067)
    print("draw-flat " + json.dumps(report["draw_flat_vs_perf_md"]),
          flush=True)

    # -- 3. small input: the card against the CPU's plain path --------------
    stamp("3")
    gcpu = torch.Generator().manual_seed(1)
    small = make_regression(gcpu, n_train=2000, n_test=10, d=90,
                            device="cpu")
    # ("mips_banded", 2): phase 3e's LGD index build and 20 steps
    for family, mp in (("quadratic", 0), ("srp", 2), ("mips", 0),
                       ("mips_banded", 2)):
        banded = family == "mips_banded"
        problem, opt = make_problem(family, mp, "sgd")
        proj = (torch.randn((problem.lsh.l * k, problem.lsh.dim,
                             problem.lsh.dim), generator=gcpu)
                if family == "quadratic" else
                problem.family.mask_projections(torch.randn(
                    (problem.lsh.dim, problem.lsh.l * k), generator=gcpu)))
        # both devices start from the CPU's preprocessed data: the
        # Simple-LSH tail sqrt(1 - |x/M|^2) magnifies last-bit
        # differences of the two devices' own preprocessing
        st_c, xt_c, yt_c, xa_c = init(None, problem, small.x_train,
                                      small.y_train, opt, projections=proj)
        idx_g = mutate_index(None, IndexMutation(
            "build", projections=proj.to(dev), x_aug=xa_c.to(dev)),
            problem.lsh)
        # codes may differ only where a projection is near zero (the sums
        # run in another order); with no such flip the sorted index must
        # be bitwise equal
        pr = (quadratic_forms(xa_c, proj) if family == "quadratic"
              else xa_c @ proj)
        near = (pr.abs() < 1e-4).reshape(-1, problem.lsh.l, k).any(-1).T
        codes = [hash_points(xa_c, proj, problem.lsh),
                 hash_points(xa_c.to(dev), proj.to(dev), problem.lsh).cpu()]
        if not torch.equal(codes[0][~near], codes[1][~near]):
            fail(f"{family}: codes hashed on the card differ from the CPU's")
        flips = int((codes[0] != codes[1]).sum())
        if flips == 0 and not (
                torch.equal(idx_g.sorted_codes.cpu(),
                            st_c.index.sorted_codes)
                and torch.equal(idx_g.order.cpu(), st_c.index.order)):
            fail(f"{family}: index built on the card differs from the CPU's")
        def to_dev(t):
            return None if t is None else t.to(dev)

        st_g = LGDState(to_dev(st_c.theta),
                        type(st_c.opt_state)(*map(to_dev, st_c.opt_state)),
                        type(st_c.index)(*map(to_dev, st_c.index)),
                        to_dev(st_c.step))
        runs = {"cpu": [st_c, xt_c, yt_c, xa_c],
                "cuda": [st_g, xt_c.to(dev), yt_c.to(dev), xa_c.to(dev)]}
        for _ in range(20):
            dr = draw_samples(gcpu, (problem.minibatch,),
                              max(2 * problem.lsh.l, 8), problem.lsh.l, 2000,
                              "cpu", bands=banded)
            for where in ("cpu", "cuda"):
                st, xt, yt, xa = runs[where]
                st, _ = lgd_step(None, st, xt, yt, xa, problem, opt,
                                 draws=dr.to(where))
                runs[where][0] = st
        th_c, th_g = runs["cpu"][0].theta, runs["cuda"][0].theta.cpu()
        if not torch.allclose(th_g, th_c, rtol=1e-4, atol=1e-6):
            fail(f"{family}: 20 LGD steps on the card differ from the CPU's "
                 f"(max |d theta| {float((th_g - th_c).abs().max()):.3g})")
        print(f"small-input check {family} mp{mp}: {flips} near-zero code "
              f"flips, theta after 20 steps max |diff| "
              f"{float((th_g - th_c).abs().max()):.3g}", flush=True)

    # -- 3b. small input: the serve model on the card against the CPU ------
    stamp("3b")
    # f32 logits of a 2-layer model whose attention, matmuls and softmax
    # sum in another order on the card: rtol = atol = 1e-4
    cfg_s = configs.get_smoke(SERVE_ARCH).with_(attn_impl="pallas")
    lm_c = LM.init(cfg_s, seed=0, device="cpu")
    lm_g = LM(cfg_s, device=dev)
    lm_g.load_state_dict(lm_c.state_dict())
    toks = torch.randint(0, cfg_s.vocab, (2, 264),
                         generator=torch.Generator().manual_seed(3))
    small = {}
    before = dict(kernels.launches)
    with torch.inference_mode():
        for where, lm in (("cpu", lm_c), ("cuda", lm_g)):
            cache = lm.init_cache(2, 264)
            h, cache = lm.prefill({"tokens": toks[:, :256].to(lm.device)},
                                  cache)
            out = [lm.embed_group.lm_logits(h[:, -1:])[:, 0]]
            for i in range(8):
                lg, cache = lm.decode_step(
                    {"tokens": toks[:, 256 + i:257 + i].to(lm.device),
                     "positions": torch.full((2, 1), 256 + i,
                                             device=lm.device)}, cache)
                out.append(lg[:, 0])
            small[where] = torch.stack(out).cpu()
    ran = {kk: kernels.launches[kk] - before[kk]
           for kk in ("flash_attention", "flash_decode")}
    if ran != {"flash_attention": 2, "flash_decode": 16}:
        fail(f"the SMOKE model on the card did not run the kernels: {ran}")
    err = float((small["cuda"] - small["cpu"]).abs().max())
    if not torch.allclose(small["cuda"], small["cpu"], rtol=1e-4, atol=1e-4):
        fail(f"phi4-mini SMOKE logits on the card differ from the CPU's: "
             f"max |diff| {err:.3g}")
    print(f"small-input check {cfg_s.name}: prefill 2x256 + 8 decode "
          f"steps, logits max |diff| card vs CPU {err:.3g}", flush=True)

    # -- 3g. small input: the other archs on the card against the CPU ------
    stamp("3g")
    report["small_3g"] = {
        arch: other_arch_card_vs_cpu(torch, dev, kernels, configs, serve, LM,
                                     arch) for arch in NEW_ARCHS}

    # -- 3e. small input: the LSH head on the card against the CPU ---------
    stamp("3e")
    from repro_torch.models import LMHeadIndex, lsh_decode_step
    from repro_torch.models.sampled_softmax import (
        lsh_head_tokens, shortlist_candidates, shortlist_logits)

    scfg_s = serve.lsh_head_config(cfg_s)
    head_c = LMHeadIndex(lm_c, scfg_s)
    before = kernels.launches["simhash"]
    head_g = LMHeadIndex(lm_g, scfg_s,
                         projections=head_c.index.projections.to(dev))
    if kernels.launches["simhash"] != before + 1:
        fail("3e: the head index on the card was not hashed by simhash")
    lsh_s, fam_s = head_c.lsh, head_c._fam
    xa_err = float((head_g.x_aug.cpu() - head_c.x_aug)[:, :-2].abs().max())
    if xa_err > 1e-5:
        fail(f"3e: the head's x_aug on the card is {xa_err:.3g} from the "
             f"CPU's")
    # the card hashes the CPU's x_aug (the Simple-LSH tail magnifies the
    # two devices' last-bit differences, ROADMAP queue 3's note)
    proj_s = head_c.index.projections
    idx_sg = mutate_index(None, IndexMutation(
        "build", projections=proj_s.to(dev), x_aug=head_c.x_aug.to(dev)),
        lsh_s)
    near = ((head_c.x_aug @ proj_s).abs() < 1e-4).reshape(
        -1, lsh_s.l, lsh_s.k).any(-1).T
    codes = [hash_points(head_c.x_aug, proj_s, lsh_s),
             hash_points(head_c.x_aug.to(dev), proj_s.to(dev), lsh_s).cpu()]
    if not torch.equal(codes[0][~near], codes[1][~near]):
        fail("3e: head codes hashed on the card differ from the CPU's")
    head_flips = int((codes[0] != codes[1]).sum())
    if head_flips == 0 and not (
            torch.equal(idx_sg.sorted_codes.cpu(), head_c.index.sorted_codes)
            and torch.equal(idx_sg.order.cpu(), head_c.index.order)):
        fail("3e: the head index built on the card differs from the CPU's")
    # from here both hold the CPU's index
    head_g.index = LSHIndex(*(x.to(dev) for x in head_c.index))
    head_g.x_aug = head_c.x_aug.to(dev)
    qs = torch.randn((4, cfg_s.d_model),
                     generator=torch.Generator().manual_seed(8))
    sl = [shortlist_candidates(hd.index, fam_s.augment_query(qs.to(where)),
                               lsh_s, scfg_s)
          for hd, where in ((head_c, "cpu"), (head_g, dev))]
    if not (torch.equal(sl[0][0], sl[1][0].cpu())
            and torch.equal(sl[0][1], sl[1][1].cpu())):
        fail("3e: the shortlist on the card differs from the CPU's")
    lg_s = [shortlist_logits(hd.rows, qs.to(hd.rows.device), *ids_v)
            for hd, ids_v in ((head_c, sl[0]), (head_g, sl[1]))]
    lg_err = float((lg_s[1].cpu() - lg_s[0])[sl[0][1]].abs().max())
    # 8 tokens: each side's LSH head on its own hidden state, both fed
    # the CPU's token
    lsh_toks, caches = {"cpu": [], "cuda": []}, {}
    before = dict(kernels.launches)
    with torch.inference_mode():
        for where, lm, hd in (("cpu", lm_c, head_c), ("cuda", lm_g, head_g)):
            caches[where] = lm.init_cache(2, 264)
            h, _ = lm.prefill({"tokens": toks[:, :256].to(lm.device)},
                              caches[where])
            lsh_toks[where].append(lsh_head_tokens(lm, h[:, -1:], hd)
                                   .cpu())
        tok = lsh_toks["cpu"][0]
        for i in range(7):
            for where, lm, hd in (("cpu", lm_c, head_c),
                                  ("cuda", lm_g, head_g)):
                step = {"tokens": tok.to(lm.device),
                        "positions": torch.full((2, 1), 256 + i,
                                                device=lm.device)}
                out, _ = lsh_decode_step(lm, step, caches[where], hd)
                lsh_toks[where].append(out.cpu())
            tok = lsh_toks["cpu"][-1]
    ran = {kk: kernels.launches[kk] - before[kk]
           for kk in ("bucket_probe_codes", "flash_attention",
                      "flash_decode")}
    if ran != {"bucket_probe_codes": 8, "flash_attention": cfg_s.n_layers,
               "flash_decode": 7 * cfg_s.n_layers}:
        fail(f"3e: the LSH head on the card did not run the kernels: {ran}")
    tc, tg = torch.cat(lsh_toks["cpu"], 1), torch.cat(lsh_toks["cuda"], 1)
    if not torch.equal(tc, tg):
        fail(f"3e: LSH-head tokens on the card differ from the CPU's: "
             f"{tg.tolist()} vs {tc.tolist()}")
    report["smoke_lsh_head"] = dict(
        x_aug_max_abs_diff_body=xa_err, code_flips=head_flips,
        shortlist_logit_max_abs_diff=lg_err, tokens=tc.tolist(),
        launches=ran)
    print("small-input check lsh-head " + json.dumps(
        report["smoke_lsh_head"]), flush=True)
    del lm_c, lm_g, head_c, head_g

    # -- 3c. small input: LGD training on the card against the CPU ---------
    stamp("3c")
    cfg_t = configs.get_smoke(SERVE_ARCH)                 # f32
    lm_c = LM.init(cfg_t, seed=0, device="cpu")
    lm_g = LM(cfg_t, device=dev)
    lm_g.load_state_dict(lm_c.state_dict())
    toks = make_token_corpus(0, 256, 64, cfg_t.vocab).tokens
    pcfg = LSHPipelineConfig(minibatch=TRAIN_BATCH)
    kernels.reset_launch_counts()
    pipes = {"cpu": LSHSampledPipeline(
        2, toks, mean_pool_feature_fn(cfg_t), lm_head_query_fn(), pcfg,
        params=lm_c, device="cpu")}
    pipes["cuda"] = LSHSampledPipeline(
        2, toks, mean_pool_feature_fn(cfg_t), lm_head_query_fn(), pcfg,
        params=lm_g, device=dev,
        projections=pipes["cpu"].index.projections.to(dev))
    if kernels.launches["simhash"] != 1:
        fail("the SMOKE LGD index on the card was not hashed by the kernel")
    fc, fg = pipes["cpu"].features, pipes["cuda"].features.cpu()
    feat_err = float((fg - fc).abs().max())
    if not torch.allclose(fg, fc, rtol=1e-4, atol=1e-6):
        fail(f"SMOKE LGD features on the card differ from the CPU's: max "
             f"|diff| {feat_err:.3g}")
    proj_t = pipes["cpu"].index.projections
    lsh_t = pipes["cpu"].lsh
    near = ((fc @ proj_t).abs() < 1e-4).reshape(-1, lsh_t.l, lsh_t.k).any(-1).T
    codes = [hash_points(fc, proj_t, lsh_t),
             hash_points(pipes["cuda"].features, proj_t.to(dev), lsh_t).cpu()]
    if not torch.equal(codes[0][~near], codes[1][~near]):
        fail("SMOKE LGD codes hashed on the card differ from the CPU's")
    flips = int((codes[0] != codes[1]).sum())
    ic, ig = pipes["cpu"].index, pipes["cuda"].index
    if flips == 0 and not (torch.equal(ig.sorted_codes.cpu(), ic.sorted_codes)
                           and torch.equal(ig.order.cpu(), ic.order)):
        fail("SMOKE LGD index built on the card differs from the CPU's")
    # from here both sample the CPU's index with the same draws and the
    # CPU model's query, so tokens must agree bitwise; the probabilities
    # (and so the weights) are computed on each device, in another order
    pipes["cuda"].features = fc.to(dev)
    pipes["cuda"].index = LSHIndex(*(x.to(dev) for x in ic))
    trainers = {where: Trainer(
        cfg_t, lm, Adam(lr=schedules.warmup_cosine(1e-3, 2, 5)),
        sampler=pipes[where]) for where, lm in (("cpu", lm_c),
                                                ("cuda", lm_g))}
    gd = torch.Generator().manual_seed(4)
    lsm = {"cpu": [], "cuda": []}
    kernels.reset_launch_counts()
    w_err = 0.0
    for _ in range(5):
        dr = draw_samples(gd, (TRAIN_BATCH,), max(2 * lsh_t.l, 8), lsh_t.l,
                          toks.shape[0], "cpu")
        q = pipes["cpu"].family.augment_query(lm_c.lm_head_query().detach())
        bt = {"cpu": pipes["cpu"].next_batch(query=q, draws=dr),
              "cuda": pipes["cuda"].next_batch(
                  query=q.to(dev), draws=dr.to(dev))}
        for kk in ("tokens", "targets", "example_ids"):
            if not torch.equal(bt["cuda"][kk].cpu(), bt["cpu"][kk]):
                fail(f"SMOKE LGD batch {kk} on the card differ from the CPU's")
        wc, wg = bt["cpu"]["loss_weights"], bt["cuda"]["loss_weights"].cpu()
        w_err = max(w_err, float(((wg - wc).abs() / wc).max()))
        if not torch.allclose(wg, wc, rtol=1e-5, atol=0):
            fail(f"SMOKE LGD weights on the card differ from the CPU's: "
                 f"{w_err:.3g} relative")
        for where in ("cpu", "cuda"):
            lsm[where].append(float(trainers[where].train_step(bt[where])[0]))
    ran = {kk: kernels.launches[kk] for kk in ("bucket_probe",
                                               "draw_assemble")}
    if ran != {"bucket_probe": 5, "draw_assemble": 5}:
        fail(f"the SMOKE LGD path on the card did not run the kernels: {ran}")
    l_err = max(abs(a - b) / abs(b) for a, b in zip(lsm["cuda"], lsm["cpu"]))
    if l_err > SMOKE_TRAIN_RTOL:
        fail(f"SMOKE LGD losses on the card differ from the CPU's: {lsm}")
    report["smoke_train"] = dict(
        feature_max_abs_diff=feat_err, code_flips=flips,
        weight_max_rel_diff=w_err, loss_max_rel_diff=l_err,
        losses_cpu=lsm["cpu"], losses_cuda=lsm["cuda"], launches=ran)
    print("small-input check train " + json.dumps(report["smoke_train"]),
          flush=True)
    del lm_c, lm_g, pipes, trainers

    # -- 3d. small input: the streaming pipeline on the card against the CPU
    stamp("3d")
    report["smoke_stream"] = streaming_card_vs_cpu(torch, np, dev, cfg_t)
    print("small-input check stream " + json.dumps(report["smoke_stream"]),
          flush=True)

    # -- 3f. small input: the training stack on the card against the CPU --
    stamp("3f")
    report["smoke_train_stack"] = training_stack_card_vs_cpu(
        torch, np, dev, cfg_t)
    print("small-input check train-stack " + json.dumps(
        report["smoke_train_stack"]), flush=True)

    # -- 3h. small input: the sharded pipeline on the card against the CPU
    stamp("3h")
    report["smoke_sharded"] = sharded_card_vs_cpu(torch, np, dev)
    print("small-input check sharded " + json.dumps(report["smoke_sharded"]),
          flush=True)

    # -- 3i. small input: training every arch on the card against the CPU
    stamp("3i")
    report["smoke_train_archs"] = train_archs_card_vs_cpu(
        torch, dev, configs, launch_train, LM)

    # -- 3j. small input: the multi-process protocol, two processes -------
    stamp("3j")
    report["smoke_multihost"] = multihost_card(torch, dev)
    print("small-input check multihost " + json.dumps(
        report["smoke_multihost"]), flush=True)

    # -- 4. the main path ---------------------------------------------------
    stamp("4")
    expect = {0: ("simhash", "bucket_probe"), 2: ("simhash",
                                                  "bucket_probe_multi")}

    def lgd_path(family, mp):
        """init + STEPS lgd_step + STEPS sgd_step at N_TRAIN for one
        family and multiprobe: its report entry (with whether the LGD
        loss fell), its checks and launches.  Returns the report key."""
        before = dict(kernels.launches)
        g = torch.Generator(device=dev).manual_seed(2)
        problem, opt = make_problem(family, mp, "sgd")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, xt, yt, xa = init(g, problem, ds.x_train, ds.y_train, opt)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        s_lgd = s_sgd = state
        losses = {"lgd": [], "sgd": []}
        t_lgd, t_sgd = [], []
        for step in range(STEPS + 1):
            if step in (0, STEPS // 2, STEPS):
                losses["lgd"].append(float(full_loss(s_lgd.theta, xt, yt,
                                                     problem)))
                losses["sgd"].append(float(full_loss(s_sgd.theta, xt, yt,
                                                     problem)))
            if step == STEPS:
                break
            t0 = time.perf_counter()
            s_lgd, m = lgd_step(g, s_lgd, xt, yt, xa, problem, opt)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            s_sgd, _ = sgd_step(g, s_sgd, xt, yt, problem, opt)
            torch.cuda.synchronize()
            t_lgd.append((t1 - t0) * 1e3)
            t_sgd.append((time.perf_counter() - t1) * 1e3)
        used = {kname: kernels.launches[kname] - before[kname]
                for kname in kernels.launches}
        key = f"{family}/mp{mp}"
        report["paths"][key] = dict(
            build_s=build_s, lgd_loss=losses["lgd"],
            sgd_loss=losses["sgd"],
            lgd_step_ms_p50=float(np.median(t_lgd)),
            sgd_step_ms_p50=float(np.median(t_sgd)),
            fallback_frac_last=float(m["fallback_frac"]),
            bucket_size_mean_last=float(m["bucket_size_mean"]),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches=used)
        print(f"path {key} " + json.dumps(report["paths"][key]), flush=True)
        if not all(math.isfinite(v) for v in losses["lgd"] + losses["sgd"]):
            fail(f"{key}: non-finite loss {losses}")
        report["paths"][key]["lgd_loss_fell"] = (
            losses["lgd"][-1] < losses["lgd"][0])
        want = (("bucket_probe_codes",)
                if family in ("quadratic", "mips_banded") else expect[mp])
        for kname in want:
            if used[kname] < (STEPS if family == "mips_banded" else 1):
                fail(f"{key}: kernel {kname} launched {used[kname]} times")
        if used["draw_assemble"] != STEPS:
            fail(f"{key}: draw_assemble launched "
                 f"{used['draw_assemble']} times, expected {STEPS}")
        return key

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for family in FAMILIES:
        for mp in (0, 2):
            key = lgd_path(family, mp)
            if not report["paths"][key]["lgd_loss_fell"]:
                fail(f"{key}: LGD loss did not fall "
                     f"{report['paths'][key]['lgd_loss']}")
    counts = dict(kernels.launches)
    for kname in LGD_KERNELS:
        if counts[kname] <= 0:
            fail(f"kernel {kname} was not launched on the main path")
        report["kernels"][kname]["launches"] = counts[kname]

    # -- 4b. the serve path at full width -----------------------------------
    stamp("4b")
    report["serve"], kept = serve_arch_full_width(
        torch, dev, kernels, serve, LM, SERVE_ARCH, None, steps=SERVE_NEW,
        keep=True)
    for kname, n_launch in report["serve"]["launches"].items():
        report["kernels"][kname]["launches"] = n_launch
    report["serve_check"] = report["serve"].pop("check")
    print("serve " + json.dumps(report["serve"]), flush=True)
    print("serve-check " + json.dumps(report["serve_check"]), flush=True)
    cfg_f, lm_f = kept["cfg"], kept["lm"]
    prompts = kept["inputs"]["tokens"]
    full_first = kept["tokens"][:, :2].clone()   # 4e compares with it
    del kept

    # -- 5. where an LGD step's time goes (after the counts are read) -------
    stamp("5")
    for family in FAMILIES:
        report["profile"][family] = profile_steps(
            torch, family, ds, make_problem, init, lgd_step)
        print(f"profile {family}/mp0 " + json.dumps(report["profile"][family]),
              flush=True)

    # -- 5b. where a full-width decode step's time goes ---------------------
    stamp("5b")
    with torch.inference_mode():
        cache = lm_f.init_cache(SERVE_B, SERVE_PROMPT + 30)
        h, cache = lm_f.prefill({"tokens": prompts}, cache)
        tok = lm_f.embed_group.lm_logits(h[:, -1:]).argmax(-1)
        pos = [SERVE_PROMPT]

        def decode():
            nonlocal tok
            step = {"tokens": tok, "positions": torch.full(
                (SERVE_B, 1), pos[0], dtype=torch.int32, device=dev)}
            logits, _ = lm_f.decode_step(step, cache)
            tok = logits[:, -1:].argmax(-1)
            pos[0] += 1

        for _ in range(5):
            decode()
        prof = trace_steps(torch, decode, 20)
        prof["flash_decode_ms_per_step"] = sum(
            us for name, us in prof.get("top_device_us_per_step", [])
            if "flash_decode" in name) / 1e3
        report["profile"]["serve_decode"] = prof
    print("profile serve/decode " + json.dumps(
        report["profile"]["serve_decode"]), flush=True)
    del cache, h

    # -- 4e. the serve path with --head lsh at full width (4b's model) ------
    stamp("4e")
    report["serve_lsh"] = serve_lsh_full_width(
        torch, np, dev, cfg_f, lm_f, prompts, full_first, report["serve"])
    print("serve-lsh " + json.dumps(report["serve_lsh"]), flush=True)
    del lm_f, prompts
    # mips_banded through phase 4's LGD path, its counts read on their own.
    # Its loss trend is reported, not gated: on a pareto corpus the
    # reference's own banded loss rises at both multiprobe settings where
    # plain mips falls, and the port follows it step for step
    # (tests/test_torch_banded.py::TestBandedDraws::
    # test_quickstart_loss_trend_on_a_pareto_corpus).  Each of 300 card
    # steps is held against the CPU's plain step from the same state
    for mp in (0, 2):
        lgd_path("mips_banded", mp)
        report["paths"][f"mips_banded/mp{mp}"]["card_vs_cpu"] = \
            banded_card_vs_cpu(torch, dev, ds, mp)
        print(f"path mips_banded/mp{mp} card-vs-cpu " + json.dumps(
            report["paths"][f"mips_banded/mp{mp}"]["card_vs_cpu"]),
            flush=True)

    # -- 4g. the other archs served at full width, one at a time -----------
    stamp("4g")
    report["serve_4g"] = {}
    for arch, layers in NEW_ARCHS.items():
        report["serve_4g"][arch], _ = serve_arch_full_width(
            torch, dev, kernels, serve, LM, arch, layers)
        print("serve-4g " + json.dumps(report["serve_4g"][arch]), flush=True)
        gc.collect()
        torch.cuda.empty_cache()

    # -- 4c. the train path at full width -----------------------------------
    stamp("4c")
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    cfg_f, model = launch_train.load_model(SERVE_ARCH, True, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sampler, _ = launch_train.make_batches(
        cfg_f, model, lgd=True, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        corpus=TRAIN_CORPUS, device=dev, refresh_every=TRAIN_REFRESH)
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    # instrument: each batch's mean weight kept on the device (the async
    # refreshes are timed by the pipeline's own CUDA events)
    w_means = []
    next_batch = sampler.next_batch

    def kept_batch(*a, **kw):
        b = next_batch(*a, **kw)
        w_means.append(b["loss_weights"].mean())
        return b

    sampler.next_batch = kept_batch
    # the launcher's log cadence (10): a log also feeds the ladder's
    # fallback-rate check, and logged every step a run whose query drifts
    # into empty buckets for 3 steps degrades to uniform batches; the
    # loop's iterations are timed from their train_step calls instead
    def one_refresh(tr_):
        if tr_.step == TRAIN_REFRESH + 1:     # after the swap at step 10
            for c in (sampler.cfg, sampler.shards[0].cfg):
                c.refresh_every = 0

    tr = launch_train.make_trainer(
        cfg_f, model, steps=TRAIN_STEPS, lr=1e-3, sampler=sampler,
        tcfg=TrainerConfig(log_every=10, step_hook=one_refresh))
    starts, train_step = [], tr.train_step

    def timed_step(batch):
        starts.append(time.perf_counter())
        return train_step(batch)

    tr.train_step = timed_step
    t0 = time.perf_counter()
    out = tr.run(TRAIN_STEPS)
    starts.append(time.perf_counter())
    del tr.train_step              # no trainer -> wrapper -> trainer cycle
    tr.finalize()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    trained = dict(kernels.launches)
    if trained["draw_assemble"] != TRAIN_STEPS or \
            trained["bucket_probe"] < TRAIN_STEPS or trained["simhash"] != 2:
        fail(f"train path launches {trained}: expected draw_assemble "
             f"{TRAIN_STEPS}, bucket_probe >= {TRAIN_STEPS}, simhash 2 (the "
             f"build and the refresh)")
    recs = refresh_health(sampler, "4c", 1)
    # the standalone gather_weight is off every path (draw_assemble
    # gathers): its count, 0, stands in the table beside phase 2c's row
    report["kernels"]["gather_weight"]["launches"] = trained["gather_weight"]
    losses = out["losses"]
    if len(losses) != TRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"train path losses {losses}")
    w_means = torch.stack(w_means).cpu()
    if not torch.allclose(w_means, torch.ones_like(w_means), rtol=0,
                          atol=1e-5):
        fail(f"train path weights' batch means are not 1: {w_means}")
    dts = [(b_ - a_) * 1e3 for a_, b_ in zip(starts, starts[1:])]
    # loop iteration k trains step k and draws batch k + 1: the refresh
    # launches in iteration 8, iteration 9 waits for its reads before the
    # update and swaps
    boundary = (TRAIN_REFRESH - 2, TRAIN_REFRESH - 1)
    steady = [d_ for i_, d_ in enumerate(dts) if i_ not in boundary]
    report["train"] = dict(
        arch=cfg_f.name, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        corpus=TRAIN_CORPUS, steps=TRAIN_STEPS,
        params=sum(p.numel() for p in model.parameters()),
        feature_batch=sampler.feature_batch, init_s=init_s,
        index_build_s=index_s, refreshes=recs,
        refresh_device_s=[r["device_ms"] / 1e3 for r in recs
                          if "device_ms" in r],
        boundary_step_ms={i_: dts[i_] for i_ in boundary},
        run_s=run_s,
        step_ms_p10=float(np.percentile(steady, 10)),
        step_ms_p50=float(np.percentile(steady, 50)),
        step_ms_all=dts, sampler_overhead=tr.sampler_overhead,
        data_s=tr.data_seconds,
        fallback_rate=sampler.sampler_stats()["fallback_rate"],
        weight_mean_max_dev=float((w_means - 1).abs().max()),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        first_loss=losses[0], last_loss=losses[-1], losses=losses,
        skipped_steps=tr.skipped_steps, launches=trained)
    print("train " + json.dumps(report["train"]), flush=True)

    # the train path's own shapes of its LGD kernels (d 3,072, K 7, L 10,
    # N 2,048): the query probe of every step, the hash of every build
    # and refresh; held against the plain versions and timed (after the
    # counts were read)
    shard = sampler.shards[0]      # the launcher's one shard on one card
    w_t, sc_t, x_t = (shard.index.projections, shard.index.sorted_codes,
                      shard.features)
    k_t, l_t = shard.lsh.k, shard.lsh.l
    (n_t, d_t), lk_t = x_t.shape, shard.lsh.k * shard.lsh.l
    q_t = shard.family.augment_query(
        model.lm_head_query().detach())[None].contiguous()
    near_q = ((q_t @ w_t).abs() < 1e-4).reshape(1, l_t, k_t).any(-1)
    got = bucket_probe_cuda(q_t, w_t, sc_t, k=k_t, l=l_t)
    want = bucket_probe_ref(q_t, w_t, sc_t, k=k_t, l=l_t)
    e_probe = max(int((a - b).abs()[~near_q].max())
                  for a, b in zip(got, want))
    near_x = ((x_t @ w_t).abs() < 1e-4).reshape(n_t, l_t, k_t).any(-1).T
    got = simhash_codes_cuda(x_t, w_t, k=k_t, l=l_t)
    want = simhash_codes_ref(x_t, w_t, k=k_t, l=l_t).T
    e_hash = int((got - want).abs()[~near_x].max())
    if e_probe or e_hash:
        fail("a kernel disagrees with its plain version at the train shapes")
    hash_extras = simhash_extras(x_t, w_t, got, l_t, k_t, 100)
    qc_t = compute_codes(q_t, w_t, k=k_t, l=l_t).T.contiguous()
    levels_t = math.floor(math.log2(n_t))
    shape = f"d {d_t}, K {k_t}, L {l_t}, N {n_t}"
    nb, fl = bound(l_t * (2 * levels_t * 8 + 2 * 4) + d_t * 4
                   + d_t * lk_t * 4, 2.0 * d_t * lk_t)
    report["train_kernels"] = [dict(
        name="bucket_probe", shape="B 1, " + shape, max_abs_err=e_probe,
        bound_ms=nb, bound_by=fl, **probe_regs("bucket_probe"), **timings(
            lambda: bucket_probe_cuda(q_t, w_t, sc_t, k=k_t, l=l_t),
            lambda: bucket_probe_ref(q_t, w_t, sc_t, k=k_t, l=l_t),
            lambda: two_searches(qc_t, sc_t), 100))]
    nb, fl = bound(n_t * d_t * 4 + d_t * lk_t * 4 + n_t * l_t * 8,
                   2.0 * n_t * d_t * lk_t)
    report["train_kernels"].append(dict(
        name="simhash", shape=shape, max_abs_err=e_hash, bound_ms=nb,
        bound_by=fl, **hash_extras, **timings(
            lambda: simhash_codes_cuda(x_t, w_t, k=k_t, l=l_t),
            lambda: simhash_codes_ref(x_t, w_t, k=k_t, l=l_t), None, 100)))
    for row in report["train_kernels"]:
        print("train-kernel " + json.dumps(row), flush=True)
    del got, want, near_x, shard

    # -- 5c. where a full-width training step's time goes -------------------
    stamp("5c")
    sampler.next_batch = next_batch
    for c in (sampler.cfg, sampler.shards[0].cfg):   # steady: no refresh
        c.refresh_every = 0
    tr.batches = iter(sampler.next_batch, None)
    report["profile"]["train_step"] = trace_steps(torch, lambda: tr.run(1), 2)
    print("profile train/step " + json.dumps(
        report["profile"]["train_step"]), flush=True)
    feature_batch = sampler.feature_batch
    sampler.__dict__.pop("next_batch", None)
    # every reference to the trainer (its Adam moments: ~36 GB) goes
    del tr, train_step, timed_step, next_batch, kept_batch
    gc.collect()

    # -- 4d. the streaming path at full width (the same model) --------------
    stamp("4d")
    report["stream"] = streaming_full_width(torch, np, dev, cfg_f, model,
                                            feature_batch)
    print("stream " + json.dumps(report["stream"]), flush=True)

    # -- 4f. the training stack at full width, CUT_LAYERS deep -------------
    stamp("4f")
    del model, sampler
    gc.collect()
    torch.cuda.empty_cache()
    cfg_f = configs.get(SERVE_ARCH).with_(n_layers=CUT_LAYERS)
    model = LM.init(cfg_f, seed=0, device=dev)
    sampler, _ = launch_train.make_batches(
        cfg_f, model, lgd=True, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        corpus=TRAIN_CORPUS, device=dev, refresh_every=0)
    report["train_stack"] = training_stack_full_width(
        torch, np, dev, cfg_f, model, sampler)
    print("train-stack " + json.dumps(report["train_stack"]), flush=True)
    del model, sampler

    # -- 4h. shard-by-example LGD at full width, CUT_LAYERS deep -----------
    stamp("4h")
    gc.collect()
    torch.cuda.empty_cache()
    cfg_f = configs.get(SERVE_ARCH).with_(n_layers=CUT_LAYERS)
    model = LM.init(cfg_f, seed=0, device=dev)
    report["sharded"] = sharded_full_width(
        torch, np, dev, kernels, cfg_f, model, launch_train)
    print("sharded " + json.dumps(report["sharded"]), flush=True)
    for kname, n_launch in report["sharded"]["launches"].items():
        report["kernels"][kname]["launches"] += n_launch
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # -- 4i. the other archs trained at full width, one at a time ----------
    stamp("4i")
    report["train_4i"] = {}
    for arch, layers in TRAIN_ARCHS.items():
        report["train_4i"][arch] = row = train_arch_full_width(
            torch, np, dev, kernels, configs, launch_train, LM, arch, layers)
        print("train-4i " + json.dumps(row), flush=True)
        for kname, n_launch in row.get("launches", {}).items():
            report["kernels"][kname]["launches"] += n_launch

    # -- 4j. the multi-process protocol at full width, two processes -------
    stamp("4j")
    report["multihost"] = multihost_full_width(
        torch, np, dev, report["train_4i"][MH_ARCH]["step_ms_p50"])
    print("multihost-4j " + json.dumps(report["multihost"]), flush=True)
    # the workers' launches: both ranks of each fault-free run and each
    # drill's survivor
    for part in (report["smoke_multihost"], report["multihost"]):
        for used in part["intact_launches"] + [part["drill"]["launches"]]:
            for kname, n_launch in used.items():
                report["kernels"][kname]["launches"] += n_launch
    print(f"chip_smoke total: {time.perf_counter() - t_script:.1f} s",
          flush=True)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {kk: report["kernels"][kname][kk] for kk in keys}
        for kname in LGD_KERNELS + ("flash_attention", "flash_decode",
                                    "gather_weight")]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
