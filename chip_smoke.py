#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (paddle_tpu_torch) on one card.

    python3 chip_smoke.py [--seed 0]

Runs on one NVIDIA GPU (built for Hopper, sm_90a) and fails without one.
Each phase prints one JSON line:

1. device: the card's name and power limit (as nvidia-smi prints them, on
   a line of their own too), torch and CUDA versions, and the build time
   of the hand-written kernels, compiled here from the sources in
   paddle_tpu_torch/csrc by nvcc, one process per source.
2. kernels: K1 (flash-attention forward), K2 (its backward: the dq and
   the dk/dv kernels), K4 (the single-pass backward) and K3 (decode
   attention) held against their plain PyTorch versions on the card at
   the training shape (B 16, T 1024, 16 heads of 64, causal, both
   layouts), the serving shapes and edge cases (ragged T, head dim 128,
   KV lengths 0, 77, 200; T 129 and T 1 at both head dims, causal or
   not, in both layouts, and lengths 0, 1, 129; K3's slot lengths 0, 1,
   its split size - 1, split, + 1, S - 1, S and S + 1 at both head dims,
   and two calls on the same inputs bitwise equal), each with its max abs
   error against a stated tolerance (the "K1 worst" and "K3 worst" lines:
   over all of a kernel's cases) and, at the main shapes (K3: the slice's
   last-step lengths, every slot full and every slot empty), its device
   time (REPS calls captured in one CUDA graph, the replay timed by CUDA
   events), beside the plain version's time, the bound, and the time of
   torch's scaled_dot_product_attention on the same inputs (forward; for
   the backward, forward + backward minus forward), a yardstick only:
   the port never calls it. The bound of an attention
   kernel counts its fp32-accurate products at the tensor cores' 3xTF32
   rate, the least time the card could take for them (K1, K2 and K4 run
   them that way); the CUDA-core fp32 bound rides beside it as
   fp32_bound_ms. K1's, K2's and K4's entries also carry, from cuobjdump
   of the built libraries, each kernel's TF32 HMMA/HGMMA count (the run
   fails if one is 0), registers and local memory (the "SASS" line);
   K1's its numbers at the serving prefill shape too (serving_*), and
   K3's its numbers with every slot full (full_*) and its time with every
   slot empty (empty_ms) and its device time and launches in the
   profiled generate call.
   Then the bf16 twins, K1-bf16, K2-bf16 (dq, dk/dv) and K4-bf16, at the
   training shape and at Dh 128 (B 8, T 1024, H 8; both timed), in BHTD,
   at the fp32 kernels' edge cases and at the bf16 kernels' tile edges
   (BF16_EDGE_T at both head dims, both layouts, causal or not; Tq apart
   from Tk across those edges; KV lengths one key either side of a 64-
   and a 128-key edge; one batch or one head, BF16_EDGE_BH): each, and
   its plain bf16 version, against fp32 attention on the same
   bf16-valued inputs (the kernel's error within BF16_ERR_RATIO of the
   plain version's and BF16_ULPS bf16 ulps), and K1-bf16, K2-bf16 and
   K4-bf16's dk and dv called twice on the same inputs bitwise equal
   ("K1-bf16 worst" and "K2/K4-bf16 worst" lines); timed on q pre-scaled
   as the op pre-scales it (device time, and the wrapper's host time per
   call: host_us with its tensor maps cached, host_us_new_maps with every
   map encoded anew, fp32_host_us of the fp32 K1 or K2 in the same
   rounds, and from the first two map_encode_us, the host time of one
   map), beside the bound at the bf16 tensor-core rate (989 TFLOP/s) and
   bf16 bytes, and scaled_dot_product_attention in bf16; K4-bf16's
   beside the bytes of fp32 adds one call makes into dq, as the kernel
   counts them (fused_dq_reduce_mb, on the kernels line too) and as its
   tile walk computes them (fused_dq_reduce_mb_walk; the run fails if
   they differ), and the time of its wrapper's zero fill and bf16 cast of
   that buffer. The "SASS" line counts their bf16 tensor-core
   instructions, HGMMA (wgmma) and HMMA (mma.sync) apart, and each
   kernel's local-memory loads and stores (LDL, STL: spills; cuobjdump's
   LOCAL does not count a spill to the stack): the run fails if one has
   no tensor-core instruction, and if K1-bf16, K2-bf16 or K4-bf16 (the
   wgmma kernels) has no HGMMA or any LOCAL memory.
3. train: the flagship training config (bench.py's LM phase: vocab
   32768, 12 layers, d_model 1024, 16 heads, d_inner 4096, seq 1024,
   batch 16, Adam 1e-4), fp32, random weights from the port's own startup
   program. Startup, 2 warm steps, then 5 steps in each of four turns
   through Executor.run: graph, eager, eager, graph (graph: each step one
   replay of the step's captured CUDA graph; eager: the same step op by
   op, eager_steps()): step ms, tokens/s and peak memory by mode, the
   losses, the host's kernel launches per step by mode (0 in a replay).
   The main path's run: one more graph step under torch.profiler, host
   counts zeroed just before it (they must stay 0; the device's launch
   counters, csrc/launch_count.cuh, count K1, K2-dq and K2-dkv 12 times
   each inside the replay); a profiled
   eager step beside it (the idle share of each, busy time by kind, top
   kernels and host ops; tables in build/chip_smoke/train_step_ops.txt
   and train_step_eager_ops.txt). Then, from the state after the first
   turn (saved as copies: the executor updates the scope's tensors in
   place): the kernel step through its graph and op by op (graph_vs_eager:
   bitwise, or within compare_steps), op by op with the plain attention
   forward and backward and with K1's forward and the plain backward,
   and through graphs with PADDLE_TPU_FLASH_FUSED_BWD=1 (K4 12 times, K2
   never, in a replay) and in the BHTD layout (PADDLE_TPU_ATTN_BTHD=0):
   the loss, every @GRAD and every updated parameter against the kernel
   step, within stated tolerances.
4. train_amp: the same config as bench.py runs it, in bf16 AMP O2 (built,
   minimized, then enable_mixed_precision(level="O2")), timed and
   profiled as train is (12 K1-bf16, K2-dq-bf16 and K2-dkv-bf16 in the
   main path's replay, no fp32 kernel). Then, from one saved state: (a)
   the kernel step through its graph and op by op (graph_vs_eager), (b)
   the plain bf16 attention forward and backward, op by op, (c)
   PADDLE_TPU_FLASH_FUSED_BWD=1 (K4-bf16 12 times, K2-bf16 never), (d)
   the O1 program, (e) the fp32 program; (a) and (c) against (b)
   relative to (b)'s distance from (e) (compare_amp: ratios printed,
   gates at the top of this file); (c) replayed once more under the
   profiler (profile_fused_bwd, train_amp_fused_bwd_step_ops.txt).
   train_loop: the same bf16 O2 program stepped by Executor.run_loop
   and timed as bench.py times it (one run_loop(3), then the slope of
   run_loop(12) and run_loop(24)): ms per step, tokens/s, peak memory;
   one profiled run_loop(12) (the main path's run: 12 graph launches,
   144 of each bf16 kernel inside them, none from the host); run_loop(12)
   from a saved state against 12 run calls from it (bitwise, or the
   loss and parameters within LOSS_RTOL and lr/10); then the reader
   window: the program over py_reader -> double_buffer -> read_file, fed
   2 windows of 12 batches from --seed and then EOF, trained window by
   window with the prefetch on and off (ms per step, the host's pull
   ms), the first window against run_loop over the same batches as
   per_step_feeds, and EOFException on the third call.
   train_files: that program fed from recordio files (open_files, and a
   DataLoader), each window against per_step_feeds; input_pipeline: the
   host's batches/s of a loader, no card.
   nmt: first K1, K2, K4 and their bf16 twins at its attention shapes
   (B 32, T 256, 8 heads of 64, BTHD, non-causal over the source lengths
   and causal over the target lengths; the "nmt attention shapes" line,
   each kernel's nmt_max_abs_err on the kernels line); then
   get_model's encoder-decoder Transformer at Transformer-base
   width (NMT_CONFIG: 6 + 6 layers, d_model 512, 8 heads of 64, d_inner
   2048, vocabularies of 10,000), batch 32 at source and target length
   256 with lengths from --seed in 64..256, Adam, in fp32 and in bf16 O2,
   each at dropout 0 and 0.1: one line each (run_nmt). Timed and
   profiled as train is (step ms, target tokens/s, peak memory, the
   graph's pool GB, idle share; the main path's step one graph launch:
   at dropout 0, 18 K1, K2-dq and K2-dkv (or their bf16 twins) counted on
   the device inside it, 6 encoder, 6 decoder and 6 cross-attentions; at
   dropout 0.1 none, by the reference's dispatch of attention dropout);
   the graph step against the same step op by op from one state and one
   step of the random stream (bitwise, or compare_steps / compare_amp);
   at dropout 0 the kernel step against the plain attention step (fp32:
   with every ReLU pinned to the kernel step's signs, the flipped units
   counted; relu_flips) and the
   step with PADDLE_TPU_FLASH_FUSED_BWD=1 (18 K4); at
   dropout 0.1 every dropout op's mask in two successive steps (they
   differ, each keeps 0.9 within KEEP_SIGMAS) and the device ms of the
   draws beside torch's Philox draw. lm_variants: TRAIN_CONFIG in bf16
   O2 with fused_qkv=True (made from the separate projections' weights)
   and with fused_head=False, against the separate-projection,
   fused-head step from one state (gates at the top of this file), the
   fused q/k/v step timed beside the separate one in turns, 12 of each
   bf16 kernel in their replays.
   moe: TRAIN_CONFIG with MOE_EXPERTS experts (layers.moe_ffn's defaults:
   top-2, capacity factor 2.0), 924,518,400 parameters, bf16 O2, Adam,
   timed and profiled as train_amp is (busy ms with the indexing
   kernels apart as "routing"; the graph's pool GB; 12 of each bf16
   kernel and one graph launch in the main path's step), each layer's
   kept share of (token, choice) pairs after one step op by op; then at
   MOE_COMPARE_LAYERS layers, full width, from one saved state: the graph
   step against the same step op by op (bitwise), and against the plain
   attention's step with every layer's routing pinned to the kernel
   step's (compare_amp, relative to the fp32 step pinned the same way;
   the flipped choices counted, run_moe). nmt_noam: the nmt phase's bf16
   Transformer-base under noam_decay(512, NOAM_WARMUP) and Adam(β2 0.98,
   ε 1e-9): each step's fetched lr against d^-0.5 min(s^-0.5, s
   w^-1.5) at NOAM_LR_RTOL, 18 of each bf16 kernel and one graph launch
   a step, run_loop(NOAM_LOOP) against as many runs (bitwise, the step
   counter included), its step ms beside the fixed-lr nmt step's.
   optimizers: TRAIN_CONFIG at OPT_LAYERS layers, bf16 O2, trained by
   each of OPT_RECIPES (every optimizer, Nesterov, L2 decay, global-norm
   clipping, LARS, ModelAverage): step ms beside Adam's, one graph launch
   and 2 of each bf16 kernel a step, graph = eager bitwise,
   ModelAverage's apply and restore in place and the replay after them
   against the eager step; every optimizer op against its float64
   evaluation at OPT_OP_RTOL.
5. slice: the flagship serving config at full width (vocab 32768, 12
   layers, d_model 1024, 8 heads, d_inner 4096, max_len 2048), random
   weights from --seed. The export is written with save_decode_model,
   loaded with DecodePredictor and asked for 8 prompts x 64 new tokens;
   every step runs through the Engine's graph steps (serving/engine.py).
   The generated tokens are checked teacher-forced: they are fed through
   the same steps again, once replaying the kernels' graphs and once
   through the steps' eager functions with the plain attention, and the
   logits of every step must agree within a stated tolerance. The main
   path's run is a steady-state generate through the graph steps (built
   and captured by earlier ones) under torch.profiler
   (build/chip_smoke/generate_graph_ops.txt), with the kernel counts
   zeroed just before it: its replays launch K1 (prefill) and K3 (decode)
   inside the graphs, where the host counts nothing and the device's
   counters count 12 K1 per prefill and 12 K3 per decode step (the
   profiler's counts are printed beside them: now and then it loses a
   kernel's record in a long trace of replays). The run fails
   unless the host counts are 0 (nothing ran eagerly), the device's
   are those, no step was built or captured, and its tokens are the
   generated ones. K3's device time in that run rides on the slice line
   as k3_device_ms. The profile's "attention" is every kernel that the
   port's csrc/ sources declare.
6. engine: the slice's generate through the steps' eager functions
   (eager_steps(): the interpreter op by op, as before the Engine) and
   through their CUDA graphs, in turns (eager, graph, graph, eager) in
   one call: prefill ms, decode ms per token (mean, p50), tokens/s, peak
   memory; per mode a profiled generate (device busy ms and idle share,
   generate_eager_ops.txt and generate_graph_ops.txt: the graph one is
   the main path's run) and the launch calls of one decode step (kernel
   and graph launches); the builds and captures (traces: a later
   generate adds none), the graphs' pools, and the tokens of every run
   equal. Then the memory of generates over three buckets (the slice's
   and two smaller ones, eager and graph tokens equal at each): the
   bytes the step cache holds (slabs, buffers, graph pools) and the
   device memory reserved after each; then the cache bounded to the
   slice's bucket: the evictions and the memory after.
7. predictor: inference.Predictor on the slice's prefill program
   exported at the slice's prefill bucket (8 x 1024, K1 at the serving
   shape), through its graph and its eager function in turns: ms per
   call, the largest output difference, and its logits against the
   DecodePredictor prefill's on the same prompts.
8. sampling: generate with top-k (k 40) and top-p (p 0.9) on the slice's
   prompts: through the graph steps twice with one seed and through the
   eager functions with it (all equal: the draw is a function of the
   step's seed feed, computed on the card), with another seed (tokens
   differing, printed); a predictor with sample_k=1 gives the greedy
   tokens.
9. server: DecodeServer (continuous batching; K1 in each admission
   prefill, K3 in every decode step, inside the steps' graphs) over the
   serving config, fresh random weights from --seed. From tools/
   bench_decode.py's batch-mode A/B (bench_batch_modes): 24 requests,
   budgets 8 and 64 alternating, all sent as one burst (no arrival
   process), a warm round per mode and the modes in turns. Widened to
   the serving config: prompts of 64..1000 tokens drawn from --seed
   (bench_decode's are 16), 8 slots over the full 2048-row slab (its
   are 4 over prompt + budget), the burst split over 4 client threads
   (its is one). A continuous and a static (gang) server on one
   predictor. Every admission prefill bucket is captured first; a warm
   round per mode; an untimed round with a generate at the server's
   bucket beside it (equal to one with no server); then 3 timed rounds
   per mode in turns: generated tokens/s, mean active slots, latency and
   time to first token (p50, p99), decode step ms p50, prefill
   executions, no build or capture; the owned slab's and the step
   cache's GB. The server's main path: one more continuous round under
   torch.profiler, K1/K3 host counts zeroed just before it (0 from the
   host; the device's counters 12 K1 per admission prefill, 12 K3 per
   decode step in the replays; device idle share and busy ms by kind;
   build/chip_smoke/server_round_ops.txt). Gates: every greedy token
   within LOGITS_TOL of its row's maximum (teacher-forced, the warm
   continuous round), every later round's tokens (the one beside a
   generate, the timed ones, the profiled one, the one stop() drains)
   equal to the warm round of its mode, stop() during a burst completes
   every future, a topk server round completes; tokens against generate
   of each prompt alone are printed.
10. predictor_server: PredictorServer(max_batch=8) over the LM's prefill
   exported with a batch axis that buckets (bucketed_prefill_export, seq
   1024): 32 single-row requests from 4 threads, a warm round and a
   timed one: rows/s, latency p50 and p99, bucket fill, one build and
   one capture per bucket at prewarm and none in traffic; every row
   against Predictor.run's, and Predictor.run's rows against the
   DecodePredictor prefill's last-position logits on the same rows and
   weights (the export is the LM's prefill), each within LOGITS_TOL.

11-15. The rest of decode serving, on the serving config with the
   slice's weights (and one export more), each phase a line
   (run_decode_features):
   speculative: generate(speculative=True, spec_k=SPEC_K) with a
   DRAFT_LAYERS-deep draft against plain greedy, in turns, on the
   slice's prompts and budget, on the random export and on the
   acceptance-favourable one (tools/bench_decode.py's: layers past the
   draft have their out and fc2 projections zeroed): tokens/s,
   acceptance rate, draft and verify ms p50 (device, by CUDA events),
   the device's launches in one call (12 K1; DRAFT_LAYERS K3 a draft
   step, none in a verify step: its window attention is plain torch),
   every token within LOGITS_TOL of its row's teacher-forced maximum, the
   tokens differing from greedy printed, the favourable export's
   acceptance at least SPEC_FAVOURABLE_ACCEPTANCE, and the draft and
   verify steps on the decode step's own slabs (data_ptr).
   server_spec: DecodeServer(speculative=True) and a plain server under
   the server phase's traffic, warm rounds and then timed rounds in
   turns: tokens/s, latency and TTFT, round ms, acceptance; the same
   token gate, every round equal to the warm one, one more round's
   device launches (12 K1 a prefill, DRAFT_LAYERS K3 a draft step).
   prefix: a prefix-sharing server (PREFIX_HEADERS headers of
   PREFIX_HEADER_LEN tokens; full hits and partial hits extended through
   the verify window) and a private one in turns: tokens/s, TTFT,
   prefill executions (each equal to the unique misses), the store's hits
   and bytes, the token gate, and the device's launches over the shared
   server's fill and warm burst (12 K1 a prefill, i.e. a store miss; 12
   K3 a decode step; none in the verify windows). int8: DecodeServer(kv_dtype="int8") under
   the server traffic: tokens/s, step ms, slab GB against fp32's, 12 K3
   a step; one step replayed against the same step op by op with the
   plain attention on the same int8 slabs (LOGITS_TOL); the share of
   tokens equal to the fp32 server's printed. beam: generate_beam with
   BEAM_SIZE beams on BEAM_PROMPTS prompts, BEAM_NEW tokens: step ms,
   beam_size=1 = greedy, scores in order, the best beam's score = its
   teacher-forced log-probability sum (LOGITS_TOL), 12 K3 a step.
   Then one decode_features line with their seconds.

Then one line with K1's BHTD and K2's (and K2-bf16's) pair numbers, one
line
{"kernels": [...]} (every kernel, with its launches on each main path,
the server's profiled round among them, error, times and bound), the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure exits non-zero before that.
Scratch files go to build/chip_smoke/; the export is removed.

``--k4-ablations`` runs none of that. It times K4-bf16's kernel at the
two timed shapes with parts of its dq share left out (K4_ABLATIONS, one
library each, built together), in turns over ``--rounds``, beside the
whole kernel and K2-dkv-bf16, and prints one line per shape. The
variants give a wrong dq: they are timed, not checked.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import functools
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): fp32 on CUDA cores, dense
# TF32 on the tensor cores, and HBM3 bandwidth. An fp32-accurate product
# on the tensor cores is three TF32 products (3xTF32, as K1, K2, K4 and
# the library's fp32 attention compute it), so fp32 products reach a third of
# the TF32 rate there, 2.5x the CUDA cores'. The bound of a call is the
# larger of its operations over that rate and its bytes over HBM's.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

# kernel vs plain version at unit-scale inputs: fp32 sums taken in another
# order (tiles, online softmax, split-KV combine) differ by ~1e-6, the
# 3xTF32 tensor-core products of K1, K2 and K4 by up to ~2e-5 of the
# largest gradient (an H100); 1e-4 leaves room for the largest outputs
KERNEL_TOL = 1e-4
# teacher-forced logits, kernel path vs plain path, after 12 layers of
# fp32 arithmetic: logits are O(1); reordered sums drift ~1e-5
LOGITS_TOL = 1e-3
# one training step against another from one saved state. The loss comes
# out of 12 layers of fp32 sums taken in another order: 1e-4 relative.
# Each gradient is held to GRAD_RTOL of its own largest element when both
# steps share K1's forward (the backward kernels against the plain
# backward on the same saved out and lse; K4 against K2; BHTD against
# BTHD). Against the all-plain step the forward's saved out and lse differ
# in their last bits (K1 sums its softmax tile by tile), and at this init
# attention is near uniform over keys that share a large common part, so
# dq and dk are sums whose terms nearly cancel (sum_j dS_ij = 0): they,
# and through the residual stream every layer below, move by ~1e-4 of
# their size (median 1.4e-4, worst 3.3e-3 on an H100 at the training
# config): PATH_GRAD_RTOL. The NMT step is held to the all-plain step at
# GRAD_RTOL with every ReLU pinned to the kernel step's signs
# (relu_pinned): unpinned, a unit whose input lies within those last bits
# of 0 passes the gradient in one step only. A key projection's bias
# has a gradient that is zero up to rounding (softmax does not see a
# per-query constant): held to 1e-5 of the largest gradient instead.
# Parameters after the Adam update: Adam divides each gradient by its
# running RMS, so an element with a near-zero gradient moves by a
# different fraction of lr: lr/10.
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
PATH_GRAD_RTOL = 1e-2
ZERO_GRAD_TOL = 1e-5
# The bf16 kernels (K1-bf16, K2-bf16, K4-bf16) round where the reference
# rounds (q pre-scaled, P and dS, the outputs), so they are held, with
# their plain bf16 versions, against fp32 attention on the same
# bf16-valued inputs: the kernel's max abs error at most BF16_ERR_RATIO
# times the plain version's (sums in another order flip a rounding here
# and there), and at most BF16_ULPS bf16 ulps of the output's (each
# gradient's) largest element, 2^(floor(log2 max|x|) - 7); an error
# within KERNEL_TOL of the largest element (at least 1) passes either
# way: there both are fp32 sums in another order (T 1, where a gradient
# is zero up to rounding). The lse is fp32 in both: within KERNEL_TOL of
# the plain version's.
BF16_ERR_RATIO = 2.0
BF16_ULPS = 8
# the bf16 edge cases: T around the 64- and 128-row tiles of K1-bf16 and
# K2-bf16 (and T 1); Tq apart from Tk across those edges; KV lengths one
# key before and one after a 64- and a 128-key edge
BF16_EDGE_T = (1, 63, 64, 65, 127, 128, 129, 191, 193)
BF16_EDGE_TQ_TK = ((65, 193, False), (193, 63, True), (129, 191, True),
                   (127, 65, False))
BF16_EDGE_LENGTHS = [63, 65, 127, 129]
# (B, H) with one batch or one head: a tensor map's axis of size 1
BF16_EDGE_BH = ((1, 3), (3, 1))
# K4-bf16 with a part of its dq share left out: the value of the
# K4_BF16_OMIT macro (csrc/flash_bwd_kv_bf16.cuh) for each, 0 the whole
# kernel (--k4-ablations)
K4_ABLATIONS = {"kernel": 0, "no_reductions": 1, "half_reductions": 2,
                "no_stage": 3, "no_dq_product": 4}
# the kernels that run on wgmma (the SASS line's HGMMA count)
WGMMA_KERNELS = ("flash_fwd_bf16", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16",
                 "flash_bwd_fused_bf16")
# The bf16 O2 training step with the kernels, (a), against the same step
# with the plain bf16 attention, (b), relative to (b)'s distance from the
# fp32 step, (e). Both are bf16 runs of one algorithm whose sums go in
# another order (the kernel rounds P against a running max, tile by
# tile): a bf16 rounding that flips in an attention output moves later
# roundings, so (a) and (b) part by a good fraction of the distance that
# bf16 keeps from fp32 (0.65 of it, the median over the gradients, at 2
# layers on an H100). Gates: the loss within AMP_LOSS_RHO of (b)'s
# distance; all gradients together (the global norm of the differences)
# and all updated parameters within AMP_RHO, each one within
# AMP_RHO_EACH; and (a) no farther from (e) than AMP_FAR times (b): the
# kernels add no error beyond the bf16 algorithm's. A key projection's
# bias has a gradient that is zero up to rounding: held to
# AMP_ZERO_GRAD_TOL of the largest gradient, its value after the step to
# 2 lr (Adam's step is about lr at most).
AMP_LOSS_RHO = 0.5
AMP_RHO = 1.0
AMP_RHO_EACH = 1.5
AMP_FAR = 1.25
AMP_ZERO_GRAD_TOL = 1e-2
# calls per timed measurement
REPS = 30

# the flagship serving config (tools/bench_quant.py's decode config)
FULL_CONFIG = dict(vocab_size=32768, n_layer=12, n_head=8, d_model=1024,
                   d_inner=4096, max_len=2048)
N_PROMPTS, MAX_NEW = 8, 64
# the sampling line's parameters (DecodePredictor's defaults) and seed
SAMPLE_K, SAMPLE_P, SAMPLE_SEED = 40, 0.9, 1234
# the server phase. From tools/bench_decode.py's batch-mode A/B
# (bench_batch_modes, bench_decode.py:346-400): its CONT_REQUESTS
# requests, budgets alternating its default mix at 128 steps (max(4,
# 128 // 16), 128 // 2), every request sent at once (one burst, no
# arrival process), one untimed warm round per mode, then the modes in
# turns (it alternates which goes first). Not from it, widened to the
# serving config: prompts of SERVER_PROMPT_LENS tokens drawn from --seed
# (its DECODE_PROMPT is 16), SERVER_SLOTS slots over the full SERVER_SEQ
# slab (its CONT_SLOTS is 4, over prompt + budget), and the burst split
# over SERVER_CLIENTS threads (it submits from one)
SERVER_SLOTS, SERVER_SEQ, SERVER_CLIENTS = 8, 2048, 4
SERVER_REQUESTS, SERVER_BUDGETS = 24, (8, 64)
SERVER_PROMPT_LENS = (64, 1000)
SERVER_TIMED = ("continuous", "static", "static", "continuous",
                "continuous", "static")
# phases 11-15. speculative: tools/bench_decode.py's draft depth and window
# (DECODE_DRAFT_LAYERS 1, SPEC_K 4), the slice's prompts and budget; the
# acceptance the favourable export must reach. prefix: PREFIX_HEADERS
# system headers of PREFIX_HEADER_LEN tokens, a full prompt per header
# (header + PREFIX_QUESTION_LEN tokens), and the server traffic's count
# and budgets, half exact repeats of the full prompts, half a header and a
# fresh suffix of PREFIX_SUFFIX_LENS tokens. beam: BEAM_SIZE beams over the
# slice's first BEAM_PROMPTS prompts (a beam batch of 8), BEAM_NEW tokens
SPEC_K, DRAFT_LAYERS, SPEC_FAVOURABLE_ACCEPTANCE = 4, 1, 0.9
PREFIX_HEADERS, PREFIX_HEADER_LEN, PREFIX_QUESTION_LEN = 4, 512, 32
PREFIX_SUFFIX_LENS = (8, 64)
BEAM_SIZE, BEAM_PROMPTS, BEAM_NEW = 4, 2, 32
# the predictor_server phase: PredictorServer(max_batch=8) over the LM's
# prefill exported with a batch axis that buckets (1, 2, 4, 8), fed
# single-row requests of full-length prompts from SERVER_CLIENTS threads
PSERVER_MAX_BATCH, PSERVER_SEQ, PSERVER_REQUESTS = 8, 1024, 32

# the flagship training config: bench.py's LM phase (bench.py:80-92,
# bench_lm), full width and depth, 16 heads of 64; the train phase runs
# it in fp32, train_amp in bf16 AMP O2 as bench.py runs it
TRAIN_CONFIG = dict(vocab_size=32768, n_layer=12, n_head=16, d_model=1024,
                    d_inner=4096, max_len=1024)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 16, 1024, 1e-4
WARM_STEPS, TIMED_STEPS = 2, 5
# bench.py's run_loop timing (bench.py:_timed_loop, with its WARMUP and
# STEPS): one run_loop(3) call, then run_loop(12) and run_loop(24)
LOOP_WARMUP, LOOP_STEPS = 3, 12
# train_files: the DataLoader's worker processes (tools/bench_dataloader.py's
# quick_metric count), and the depth of the window checked without
# double_buffer (enough to hold a window of batches; no third full-size
# capture)
FILES_LOADER_WORKERS, FILES_WINDOW_LAYERS = 2, 2
# the nmt phase: get_model's encoder-decoder Transformer at Transformer-base
# width (Vaswani et al. 2017, Table 3 "base": 6 + 6 layers, d_model 512, 8
# heads of 64, d_inner 2048, dropout 0.1) and get_model's vocabularies of
# 10,000; batch 32 at source and target length 256, each row's lengths
# drawn from --seed in NMT_MIN_LEN..256 (row 0 full); Adam; run at
# dropout 0 and NMT_DROPOUT, in fp32 and in bf16 O2
NMT_CONFIG = dict(src_vocab_size=10000, tgt_vocab_size=10000, n_layer=6,
                  n_head=8, d_model=512, d_inner=2048)
NMT_BATCH, NMT_SEQ, NMT_MIN_LEN = 32, 256, 64
NMT_LR, NMT_DROPOUT, NMT_WARM, NMT_STEPS = 1e-4, 0.1, 2, 3
# a dropout mask of n elements keeps n (1 - p) of them give or take
# KEEP_SIGMAS binomial standard deviations, sqrt(n p (1 - p))
KEEP_SIGMAS = 6
# the training surface: the MoE LM (TRAIN_CONFIG with 8 experts, top-2,
# capacity factor 2.0: Mixtral 8x7B's routing), its comparisons at
# MOE_COMPARE_LAYERS layers; the noam recipe (Vaswani et al. 2017 §5.3)
# on NMT_CONFIG; every optimizer on TRAIN_CONFIG cut to OPT_LAYERS layers
MOE_EXPERTS, MOE_COMPARE_LAYERS, MOE_STEPS = 8, 2, 3
NOAM_WARMUP, NOAM_STEPS, NOAM_LOOP = 4000, 5, 3
NOAM_ADAM = dict(beta1=0.9, beta2=0.98, epsilon=1e-9)
NOAM_LR_RTOL = 1e-6
OPT_LAYERS, OPT_WARM, OPT_STEPS = 2, 2, 3
OPT_OP_RTOL = 1e-6
OPT_OP_TYPES = ("sgd", "momentum", "adam", "adamax", "adagrad",
                "decayed_adagrad", "adadelta", "rmsprop", "ftrl",
                "proximal_gd", "proximal_adagrad", "average_accumulates")


def fail(msg):
    raise RuntimeError("chip_smoke: " + msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def time_ms(fn, warmup=3):
    """Mean device time of one call of ``fn``: REPS calls captured in one
    CUDA graph, whose replay CUDA events time. The host's work (the
    wrapper's checks and allocations, the ctypes call) stays out of it, so
    the figure does not move with the host's speed. The warm-up runs on
    the stream that is then captured (K3 keeps its counters per stream)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def host_us_each(fns, calls=50, rounds=21):
    """Host time of one call of each function of the dict ``fns`` in
    microseconds: the median over ``rounds`` rounds, each of which times
    ``calls`` calls of every function in turn, back to back on the host
    clock, the device left to catch up after each (its queue does not
    fill in that many). What a wrapper costs the host: checks,
    allocations, tensor maps, the ctypes call and the launch. The host is
    shared and one round alone swings by 2x, so the functions that are
    compared share every round."""
    import torch

    for fn in fns.values():
        for _ in range(3):
            fn()
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times[name].append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return {name: sorted(t)[rounds // 2] for name, t in times.items()}


def host_us(fn):
    """host_us_each of the one function ``fn``."""
    return host_us_each({"fn": fn})["fn"]


def fresh_addresses(torch, tensors, calls=50, rounds=21):
    """For each of the contiguous ``tensors``, one view of its values for
    every call that host_us_each makes of a function (3 + calls x
    rounds), each at its own address 16 bytes past the one before: a
    tensor map cached by address never serves one of them, so a wrapper
    called on them encodes every map anew."""
    n = 3 + calls * rounds
    views = []
    for x in tensors:
        assert x.is_contiguous()
        step = 16 // x.element_size()
        flat = x.reshape(-1)
        buf = torch.cat([flat] * (1 + -(-step * n // flat.numel())))
        views.append([buf.as_strided(x.shape, x.stride(), step * i)
                      for i in range(n)])
    return list(zip(*views))


def bound(flops, nbytes, peak_flops=PEAK_3XTF32_FLOPS):
    """(bound_ms, bound_by): the least time the card could take, with the
    products at ``peak_flops`` (by default fp32-accurate on the tensor
    cores; PEAK_FP32_FLOPS gives the CUDA-core bound)."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sass_report(lib_path, kernels, kind="TF32"):
    """Per instantiation of each kernel in ``kernels`` (function names) in
    the built library: its tensor-core instructions of type ``kind``
    (.TF32 or .BF16) from ``cuobjdump -sass``, in all and apart as HGMMA
    (wgmma) and HMMA (mma.sync), its local-memory loads and stores (LDL,
    STL: spills), and its registers, stack and local memory from
    ``cuobjdump -res-usage``."""
    from paddle_tpu_torch.kernels import cuda_tool

    def dump(flag):
        r = subprocess.run([cuda_tool("cuobjdump"), flag, lib_path],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            fail("cuobjdump %s failed: %s" % (flag, r.stderr.strip()))
        return r.stdout

    return parse_sass(dump("-sass"), dump("-res-usage"), kernels, kind)


def parse_sass(sass, res_usage, kernels, kind="TF32"):
    """See sass_report: {"<kernel><D>": {"tc_instructions", "hgmma",
    "hmma", "ldl", "stl", "regs", "stack", "local"}} for the template
    instantiations (on the head dim) of the named kernels."""
    import re

    def key(mangled):
        for name in kernels:
            m = re.search(r"%s_kernelILi(\d+)E" % name, mangled)
            if m:
                return "%s<%s>" % (name, m.group(1))
        return None

    out, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = key(m.group(1))
            if cur:
                out[cur] = {"tc_instructions": 0, "hgmma": 0, "hmma": 0,
                            "ldl": 0, "stl": 0}
        elif cur:
            m = re.search(r"\b(HMMA|HGMMA)\.\S*%s" % kind, line)
            if m:
                out[cur]["tc_instructions"] += 1
                out[cur][m.group(1).lower()] += 1
            m = re.search(r"\b(LDL|STL)\b", line)
            if m:
                out[cur][m.group(1).lower()] += 1
    cur = None
    for line in res_usage.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            cur = key(m.group(1))
            continue
        m = re.search(r"REG:(\d+) STACK:(\d+) .*LOCAL:(\d+)", line)
        if cur and m and cur in out:
            out[cur].update(regs=int(m.group(1)), stack=int(m.group(2)),
                            local=int(m.group(3)))
    return out


def flash_work(b, h, t, tk, d, causal, lengths=None, itemsize=4):
    """FLOPs and bytes one exact-attention forward needs on these inputs:
    2*d FLOPs per (query, valid key) pair for QK^T and again for PV; each
    of q, k, v, out (``itemsize`` bytes a value) read or written once,
    plus the fp32 lse row."""
    kv = np.full(b, tk) if lengths is None else np.minimum(lengths, tk)
    rows = np.arange(t)
    pairs = sum(int(np.minimum(rows + 1, n).sum()) if causal else t * int(n)
                for n in kv)
    flops = 4.0 * d * h * pairs
    nbytes = (itemsize * (2 * b * t * h * d + 2 * b * tk * h * d)
              + 4.0 * b * h * t)
    return flops, nbytes


def flash_bwd_work(b, h, t, tk, d, causal, lengths=None, products=5,
                   itemsize=4):
    """FLOPs and bytes the attention backward needs on these inputs: five
    products of 2*d FLOPs per (query, valid key) pair (recompute S, dP,
    dV, dK, dQ); q, k, v, dO (``itemsize`` bytes a value) and the fp32 lse
    and delta read once, dq, dk, dv written once. ``products`` 3 is dq
    alone (S, dP, dQ; writes dq), 4 is dk/dv alone (S, dP, dV, dK; writes
    dk, dv)."""
    fwd_flops, _ = flash_work(b, h, t, tk, d, causal, lengths)
    flops = fwd_flops / 2 * products
    rows, keys = b * t * h * d, b * tk * h * d
    out = {5: rows + 2 * keys, 3: rows, 4: 2 * keys}[products]
    nbytes = itemsize * (2 * rows + 2 * keys + out) + 4.0 * 2 * b * h * t
    return flops, nbytes


def fused_dq_reduce_bytes(b, h, t, tk, d, causal, lengths=None):
    """Bytes of fp32 adds that K4-bf16 makes into dq on these inputs, as
    its walk makes them: each 128-key tile that some query sees adds, for
    every q tile (64 rows at Dh 64, 32 at Dh 128) from the first that
    sees its keys, Dh fp32 values for each of the tile's rows before
    Tq."""
    bq = 64 if d == 64 else 32
    kv = [tk] * b if lengths is None else [max(0, min(int(n), tk))
                                           for n in lengths]
    rows = 0
    for n in kv:
        for r0 in range(0, tk, 128):
            if r0 < n and (not causal or r0 < t):
                rows += t - (r0 // bq * bq if causal else 0)
    return 4.0 * d * h * rows


def decode_work(b, h, d, lengths):
    """FLOPs and bytes one decode-attention call needs: each live K and V
    row read once (the kernel stops at the length), q and out once."""
    live = int(np.clip(lengths, 0, None).sum())
    flops = 4.0 * d * h * live
    nbytes = 4.0 * (2 * live * h * d + 2 * b * h * d) + 4.0 * b
    return flops, nbytes


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_flash(torch, gen, dev, b, t, h, d, causal, layout, lengths=None,
                time_it=False):
    from paddle_tpu_torch.ops.attention import (flash_attention_fwd,
                                                flash_attention_plain)

    shape = (b, t, h, d) if layout == "bthd" else (b, h, t, d)
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               for _ in range(3))
    lens = None
    if lengths is not None:
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    out, lse = flash_attention_fwd(q, k, v, causal=causal, lengths=lens,
                                   layout=layout)
    ref, ref_lse = flash_attention_plain(q, k, v, causal=causal,
                                         lengths=lens, layout=layout)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    finite = torch.isfinite(ref_lse)
    lse_err = float((lse[finite] - ref_lse[finite]).abs().max())
    if not (torch.isfinite(out).all() and err <= KERNEL_TOL
            and lse_err <= KERNEL_TOL
            and bool((torch.isfinite(lse) == finite).all())):
        fail("K1 disagrees with its plain version at %s causal=%s %s: "
             "out err %.3g, lse err %.3g (tolerance %g)"
             % (shape, causal, layout, err, lse_err, KERNEL_TOL))
    res = {"case": "K1", "shape": list(shape), "layout": layout,
           "causal": causal, "lengths": lengths, "max_abs_err": err,
           "lse_max_abs_err": lse_err, "tol": KERNEL_TOL}
    if time_it:
        tf = torch.nn.functional
        qt, kt, vt = ((x.transpose(1, 2) if layout == "bthd" else x)
                      for x in (q, k, v))
        res["ms"] = time_ms(lambda: flash_attention_fwd(
            q, k, v, causal=causal, lengths=lens, layout=layout))
        res["host_us"] = host_us(lambda: flash_attention_fwd(
            q, k, v, causal=causal, lengths=lens, layout=layout))
        res["plain_ms"] = time_ms(lambda: flash_attention_plain(
            q, k, v, causal=causal, lengths=lens, layout=layout))
        res["library_ms"] = time_ms(lambda: tf.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        flops, nbytes = flash_work(b, h, t, t, d, causal, lengths)
        res["bound_ms"], res["bound_by"] = bound(flops, nbytes)
        res["fp32_bound_ms"] = bound(flops, nbytes, PEAK_FP32_FLOPS)[0]
        res["gflop"], res["mbytes"] = flops / 1e9, nbytes / 1e6
    emit(res)
    return res


def sdpa_backend(torch, fn):
    """The attention kernels that one call of ``fn`` ran, by name (which
    of scaled_dot_product_attention's backends took fp32 inputs)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA]
    hits = [n for n in names if any(w in n.lower() for w in (
        "fmha", "attention", "flash", "efficient", "cudnn", "softmax"))]
    return sorted(hits or names)[:4]


def check_flash_bwd(torch, gen, dev, b, t, h, d, causal, layout,
                    lengths=None, time_it=False):
    """K2 (dq, then dk/dv) and K4 against flash_attention_bwd_plain on the
    same inputs: q, k, v, dO ~ N(0, 1), out and lse from K1. Each gradient
    is held to KERNEL_TOL of its own largest element (at least 1; the
    *_rel_err keys are the error over that); K4's dq sums with atomics, in
    an order that changes from run to run."""
    from paddle_tpu_torch.ops import attention as A

    shape = (b, t, h, d) if layout == "bthd" else (b, h, t, d)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                   for _ in range(4))
    lens = None
    if lengths is not None:
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    out, lse = A.flash_attention_fwd(q, k, v, causal, None, lens, layout)
    delta = A.attention_delta(out, do, layout)
    args = (q, k, v, lse, delta, do, causal, None, lens, layout)
    split = (A.flash_attention_bwd_dq(*args),) + A.flash_attention_bwd_dkv(*args)
    fused = A.flash_attention_bwd_fused(*args)
    ref = A.flash_attention_bwd_plain(q, k, v, out, lse, do, causal, None,
                                      lens, layout)
    torch.cuda.synchronize()
    res = {"case": "K2/K4", "shape": list(shape), "layout": layout,
           "causal": causal, "lengths": lengths, "tol": KERNEL_TOL}
    worst = {"K2": 0.0, "K4": 0.0}
    for key, got in (("K2", split), ("K4", fused)):
        for name, g, r in zip(("dq", "dk", "dv"), got, ref):
            err = float((g - r).abs().max())
            scale = max(1.0, float(r.abs().max()))
            res["%s_%s_err" % (key, name)] = err
            res["%s_%s_rel_err" % (key, name)] = err / scale
            worst[key] = max(worst[key], err)
            if not bool(torch.isfinite(g).all()) or err > KERNEL_TOL * scale:
                fail("%s %s disagrees with the plain backward at %s causal=%s "
                     "%s lengths %s: err %.3g (tolerance %g x %.3g), finite: "
                     "%s" % (key, name, shape, causal, layout, lengths, err,
                             KERNEL_TOL, scale, bool(torch.isfinite(g).all())))
        if lengths is not None:
            for i, n in enumerate(lengths):
                if n == 0 and not all(bool((g[i] == 0).all()) for g in got):
                    fail("%s: a length-0 row has nonzero gradients" % key)
    res["K2_max_abs_err"], res["K4_max_abs_err"] = worst["K2"], worst["K4"]
    if time_it:
        tf = torch.nn.functional
        res["dq_ms"] = time_ms(lambda: A.flash_attention_bwd_dq(*args))
        res["dkv_ms"] = time_ms(lambda: A.flash_attention_bwd_dkv(*args))
        res["pair_ms"] = time_ms(lambda: (A.flash_attention_bwd_dq(*args),
                                          A.flash_attention_bwd_dkv(*args)))
        res["pair_host_us"] = host_us(lambda: (
            A.flash_attention_bwd_dq(*args), A.flash_attention_bwd_dkv(*args)))
        res["fused_ms"] = time_ms(lambda: A.flash_attention_bwd_fused(*args))
        res["plain_ms"] = time_ms(lambda: A.flash_attention_bwd_plain(
            q, k, v, out, lse, do, causal, None, lens, layout))
        # the library yardstick: scaled_dot_product_attention's backward,
        # (forward + backward) - forward, on the same fp32 inputs
        qt, kt, vt = (x.transpose(1, 2) if layout == "bthd" else x
                      for x in (q, k, v))
        qt, kt, vt = (x.detach().requires_grad_() for x in (qt, kt, vt))
        dot = do.transpose(1, 2) if layout == "bthd" else do

        def sdpa_fwd():
            return tf.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=causal)

        def sdpa_fwd_bwd():
            return torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), dot)

        res["library_fwd_bwd_ms"] = time_ms(sdpa_fwd_bwd)
        res["library_fwd_ms"] = time_ms(sdpa_fwd)
        res["library_ms"] = res["library_fwd_bwd_ms"] - res["library_fwd_ms"]
        res["library_kernels"] = sdpa_backend(torch, sdpa_fwd_bwd)
        for key, products in (("pair", 5), ("dq", 3), ("dkv", 4)):
            flops, nbytes = flash_bwd_work(b, h, t, t, d, causal, lengths,
                                           products)
            res["%s_bound_ms" % key], res["%s_bound_by" % key] = \
                bound(flops, nbytes)
            res["%s_fp32_bound_ms" % key] = bound(flops, nbytes,
                                                  PEAK_FP32_FLOPS)[0]
        res["gflop"] = flash_bwd_work(b, h, t, t, d, causal, lengths)[0] / 1e9
    emit(res)
    return res


def bf16_ulp(x):
    """One bf16 ulp at the largest magnitude of ``x``."""
    return 2.0 ** (math.floor(math.log2(max(float(x.abs().max()),
                                             1e-30))) - 7)


def bf16_gate(name, got, plain, ref, where):
    """K*-bf16's output ``got`` and its plain version's ``plain`` against
    the fp32 ``ref``: the kernel's max abs error within BF16_ERR_RATIO of
    the plain version's and BF16_ULPS ulps of ref's largest element.
    Returns the errors; fails the run otherwise."""
    import torch

    err = float((got.float() - ref).abs().max())
    plain_err = float((plain.float() - ref).abs().max())
    # below the fp32 kernels' own tolerance both errors are fp32 sums in
    # another order (a gradient that is zero up to rounding, one key)
    floor = KERNEL_TOL * max(1.0, float(ref.abs().max()))
    limit = max(BF16_ULPS * bf16_ulp(ref), floor)
    ok = (bool(torch.isfinite(got).all()) and err <= limit
          and err <= max(BF16_ERR_RATIO * plain_err, floor))
    if not ok:
        fail("%s disagrees at %s: err %.4g, plain version's %.4g (ratio "
             "limit %g), limit %.4g (%d bf16 ulps)"
             % (name, where, err, plain_err, BF16_ERR_RATIO, limit,
                BF16_ULPS))
    return {"err": err, "plain_err": plain_err, "limit": limit,
            "ratio": err / max(plain_err, 1e-30)}


def _bf16_inputs(torch, gen, dev, shape, n):
    return [torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(n)]


def _shapes(b, t, h, d, layout, tk):
    """q's shape and k's (Tk keys, Tq if None) in the layout."""
    tk = t if tk is None else tk
    if layout == "bthd":
        return (b, t, h, d), (b, tk, h, d)
    return (b, h, t, d), (b, h, tk, d)


def check_flash_bf16(torch, gen, dev, b, t, h, d, causal, layout,
                     lengths=None, time_it=False, tk=None):
    """K1-bf16 (through flash_attention_fwd, which pre-scales q in bf16)
    and its plain bf16 version against fp32 attention on the same
    bf16-valued inputs (bf16_gate); the lse against the plain version's
    within KERNEL_TOL; a second call on the same inputs bitwise the first.
    ``tk`` keys (Tq if None). With time_it, the kernel on the pre-scaled
    q (device and host time), the plain version on it, and
    scaled_dot_product_attention on the bf16 inputs, beside the bound at
    the bf16 tensor-core rate."""
    from paddle_tpu_torch.ops import attention as A

    shape, kshape = _shapes(b, t, h, d, layout, tk)
    q, = _bf16_inputs(torch, gen, dev, shape, 1)
    k, v = _bf16_inputs(torch, gen, dev, kshape, 2)
    lens = None
    if lengths is not None:
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    out, lse = A.flash_attention_fwd(q, k, v, causal, None, lens, layout)
    again = A.flash_attention_fwd(q, k, v, causal, None, lens, layout)
    plain, plain_lse = A.flash_attention_plain(q, k, v, causal, None, lens,
                                               layout)
    ref, _ = A.flash_attention_plain(q.float(), k.float(), v.float(),
                                     causal, None, lens, layout)
    torch.cuda.synchronize()
    where = "%s keys %s causal=%s %s lengths %s" % (shape, kshape, causal,
                                                    layout, lengths)
    gate = bf16_gate("K1-bf16", out, plain, ref, where)
    bitwise = bool(torch.equal(out, again[0])) and bool(
        torch.equal(lse, again[1]))
    if not bitwise:
        fail("K1-bf16: two calls on the same inputs differ at %s" % where)
    finite = torch.isfinite(plain_lse)
    lse_err = float((lse[finite] - plain_lse[finite]).abs().max())
    if lse_err > KERNEL_TOL or not bool(
            (torch.isfinite(lse) == finite).all()):
        fail("K1-bf16's lse disagrees at %s: err %.3g" % (where, lse_err))
    for i, n in enumerate(lengths or []):
        if n == 0 and not bool((out[i] == 0).all()):
            fail("K1-bf16: a length-0 row is not zero at %s" % where)
    res = {"case": "K1-bf16", "shape": list(shape), "keys": kshape[
        1 if layout == "bthd" else 2], "layout": layout, "causal": causal,
           "lengths": lengths, "max_abs_err": gate["err"],
           "plain_err": gate["plain_err"], "err_ratio": gate["ratio"],
           "limit": gate["limit"], "lse_max_abs_err": lse_err,
           "bitwise_repeat": bitwise}
    if time_it:
        tf = torch.nn.functional
        qs = A.prescale_q(q, 1.0 / math.sqrt(d))
        qt, kt, vt = ((x.transpose(1, 2) if layout == "bthd" else x)
                      for x in (q, k, v))
        res["ms"] = time_ms(lambda: A.flash_attention_fwd_bf16(
            qs, k, v, causal, lens, layout))
        # the wrapper's host time with its tensor maps cached (the same
        # tensors every call), with every map encoded anew (new addresses
        # every call) and the fp32 K1's, in the same rounds
        fresh = iter(fresh_addresses(torch, (qs, k, v)))
        f32 = [x.float() for x in (q, k, v)]
        hu = host_us_each({
            "cached": lambda: A.flash_attention_fwd_bf16(
                qs, k, v, causal, lens, layout),
            "new_maps": lambda: A.flash_attention_fwd_bf16(
                *next(fresh), causal, lens, layout),
            "fp32": lambda: A.flash_attention_fwd(
                *f32, causal, None, lens, layout)})
        res["host_us"], res["host_us_new_maps"] = hu["cached"], hu["new_maps"]
        res["fp32_host_us"] = hu["fp32"]
        res["map_encode_us"] = (hu["new_maps"] - hu["cached"]) / 3
        res["plain_ms"] = time_ms(lambda: A.flash_attention_plain_bf16(
            qs, k, v, causal, lens, layout))
        res["library_ms"] = time_ms(lambda: tf.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        flops, nbytes = flash_work(b, h, t, t, d, causal, lengths, 2)
        res["bound_ms"], res["bound_by"] = bound(flops, nbytes,
                                                 PEAK_BF16_FLOPS)
        res["gflop"], res["mbytes"] = flops / 1e9, nbytes / 1e6
    emit(res)
    return res


def check_flash_bwd_bf16(torch, gen, dev, b, t, h, d, causal, layout,
                         lengths=None, time_it=False, tk=None):
    """K2-bf16 (dq, then dk/dv) and K4-bf16, through the wrappers that
    pre-scale q and scale dq back, and the plain bf16 backward, on the
    same bf16 q, k, v, dO and K1-bf16's out and lse, each gradient against
    the fp32 backward of fp32 attention on the same bf16-valued inputs
    (bf16_gate); K2-bf16 called twice on the same inputs gives the same
    bits, and so do K4-bf16's dk and dv (register sums per block); its dq
    is added across blocks in an order that changes from run to run.
    ``tk`` keys (Tq if None)."""
    from paddle_tpu_torch.ops import attention as A

    shape, kshape = _shapes(b, t, h, d, layout, tk)
    q, do = _bf16_inputs(torch, gen, dev, shape, 2)
    k, v = _bf16_inputs(torch, gen, dev, kshape, 2)
    lens = None
    if lengths is not None:
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    out, lse = A.flash_attention_fwd(q, k, v, causal, None, lens, layout)
    delta = A.attention_delta(out, do, layout)
    args = (q, k, v, lse, delta, do, causal, None, lens, layout)
    split = (A.flash_attention_bwd_dq(*args),) + A.flash_attention_bwd_dkv(
        *args)
    again = (A.flash_attention_bwd_dq(*args),) + A.flash_attention_bwd_dkv(
        *args)
    fused = A.flash_attention_bwd_fused(*args)
    fused_again = A.flash_attention_bwd_fused(*args)
    plain = A.flash_attention_bwd_plain(q, k, v, out, lse, do, causal, None,
                                        lens, layout)
    f32 = [x.float() for x in (q, k, v, do)]
    out32, lse32 = A.flash_attention_plain(*f32[:3], causal, None, lens,
                                           layout)
    ref = A.flash_attention_bwd_plain(*f32[:3], out32, lse32, f32[3],
                                      causal, None, lens, layout)
    torch.cuda.synchronize()
    where = "%s keys %s causal=%s %s lengths %s" % (shape, kshape, causal,
                                                    layout, lengths)
    bitwise = all(bool(torch.equal(x, y)) for x, y in zip(split, again))
    if not bitwise:
        fail("K2-bf16: two calls on the same inputs differ at %s" % where)
    bitwise_dkv = all(bool(torch.equal(x, y))
                      for x, y in zip(fused[1:], fused_again[1:]))
    if not bitwise_dkv:
        fail("K4-bf16: dk or dv differs between two calls on the same "
             "inputs at %s" % where)
    res = {"case": "K2/K4-bf16", "shape": list(shape), "keys": kshape[
        1 if layout == "bthd" else 2], "layout": layout, "causal": causal,
           "lengths": lengths, "bitwise_repeat": bitwise,
           "K4_dkv_bitwise_repeat": bitwise_dkv}
    worst = {"K2": 0.0, "K4": 0.0}
    for key, got in (("K2", split), ("K4", fused)):
        for name, g, p, r in zip(("dq", "dk", "dv"), got, plain, ref):
            gate = bf16_gate("%s-bf16 %s" % (key, name), g, p, r, where)
            res["%s_%s_err" % (key, name)] = gate["err"]
            res["%s_%s_err_ratio" % (key, name)] = gate["ratio"]
            res["%s_%s_limit" % (key, name)] = gate["limit"]
            worst[key] = max(worst[key], gate["err"])
        if lengths is not None:
            for i, n in enumerate(lengths):
                if n == 0 and not all(bool((g[i] == 0).all()) for g in got):
                    fail("%s-bf16: a length-0 row has nonzero gradients"
                         % key)
    res["K2_max_abs_err"], res["K4_max_abs_err"] = worst["K2"], worst["K4"]
    if time_it:
        tf = torch.nn.functional
        qs = A.prescale_q(q, 1.0 / math.sqrt(d))
        sargs = (qs, k, v, lse, delta, do, causal, lens, layout)
        res["dq_ms"] = time_ms(lambda: A.flash_attention_bwd_dq_bf16(*sargs))
        res["dkv_ms"] = time_ms(
            lambda: A.flash_attention_bwd_dkv_bf16(*sargs))
        res["pair_ms"] = time_ms(lambda: (
            A.flash_attention_bwd_dq_bf16(*sargs),
            A.flash_attention_bwd_dkv_bf16(*sargs)))
        # host time as for K1-bf16: maps cached, maps new (ten a pair: dq
        # four, dk/dv six), and the fp32 K2 pair's
        fresh = iter(fresh_addresses(torch, (qs, k, v, lse, delta, do)))
        f32 = [x.float() for x in (q, k, v)]
        out32, lse32 = A.flash_attention_fwd(*f32, causal, None, lens,
                                             layout)
        do32 = do.float()
        args32 = (*f32, lse32, A.attention_delta(out32, do32, layout), do32,
                  causal, None, lens, layout)

        def pair_new_maps():
            a = next(fresh)
            return (A.flash_attention_bwd_dq_bf16(*a, causal, lens, layout),
                    A.flash_attention_bwd_dkv_bf16(*a, causal, lens, layout))

        hu = host_us_each({
            "cached": lambda: (A.flash_attention_bwd_dq_bf16(*sargs),
                               A.flash_attention_bwd_dkv_bf16(*sargs)),
            "new_maps": pair_new_maps,
            "fp32": lambda: (A.flash_attention_bwd_dq(*args32),
                             A.flash_attention_bwd_dkv(*args32))})
        res["pair_host_us"] = hu["cached"]
        res["pair_host_us_new_maps"] = hu["new_maps"]
        res["fp32_pair_host_us"] = hu["fp32"]
        res["map_encode_us"] = (hu["new_maps"] - hu["cached"]) / 10
        res["fused_ms"] = time_ms(
            lambda: A.flash_attention_bwd_fused_bf16(*sargs))
        # what K4-bf16's wrapper does besides the kernel: the zero fill of
        # the fp32 dq that the kernel adds into, and its cast to bf16
        res["fused_zero_cast_ms"] = time_ms(lambda: torch.zeros(
            qs.shape, dtype=torch.float32, device=dev).to(torch.bfloat16))
        # the bytes of fp32 adds one call makes into dq: as the kernel
        # counts them, and as its tile walk computes them
        A.take_fused_bf16_dq_bytes(dev)
        A.flash_attention_bwd_fused_bf16(*sargs)
        res["fused_dq_reduce_mb"] = A.take_fused_bf16_dq_bytes(dev) / 1e6
        res["fused_dq_reduce_mb_walk"] = fused_dq_reduce_bytes(
            b, h, t, kshape[1 if layout == "bthd" else 2], d, causal,
            lengths) / 1e6
        if res["fused_dq_reduce_mb"] != res["fused_dq_reduce_mb_walk"]:
            fail("K4-bf16 added %r MB into dq at %s; its tile walk adds %r"
                 % (res["fused_dq_reduce_mb"], where,
                    res["fused_dq_reduce_mb_walk"]))
        res["plain_ms"] = time_ms(
            lambda: A.flash_attention_bwd_plain_bf16(*sargs))
        qt, kt, vt = (x.transpose(1, 2) if layout == "bthd" else x
                      for x in (q, k, v))
        qt, kt, vt = (x.detach().requires_grad_() for x in (qt, kt, vt))
        dot = do.transpose(1, 2) if layout == "bthd" else do

        def sdpa_fwd():
            return tf.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=causal)

        def sdpa_fwd_bwd():
            return torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), dot)

        res["library_fwd_bwd_ms"] = time_ms(sdpa_fwd_bwd)
        res["library_fwd_ms"] = time_ms(sdpa_fwd)
        res["library_ms"] = res["library_fwd_bwd_ms"] - res["library_fwd_ms"]
        res["library_kernels"] = sdpa_backend(torch, sdpa_fwd_bwd)
        for key, products in (("pair", 5), ("dq", 3), ("dkv", 4)):
            flops, nbytes = flash_bwd_work(b, h, t, t, d, causal, lengths,
                                           products, 2)
            res["%s_bound_ms" % key], res["%s_bound_by" % key] = \
                bound(flops, nbytes, PEAK_BF16_FLOPS)
        res["gflop"] = flash_bwd_work(b, h, t, t, d, causal, lengths)[0] / 1e9
    emit(res)
    return res


def check_decode(torch, gen, dev, b, s, h, d, lengths, time_it=False,
                 yardsticks=True):
    """K3 against its plain version (a length past S reads S rows, a length
    of 0 gives exact zeros) and against itself: a second call on the same
    inputs must be bitwise the first, whichever block merges. With
    time_it, K3's time and bound, and with yardsticks the plain version's
    and the library's times too (each timing of the plain version leaves
    a cuBLAS workspace allocated for its side stream, which the training
    phase's peak memory then counts)."""
    from paddle_tpu_torch.ops.kv_cache import (decode_attention,
                                               decode_attention_plain)

    q = torch.randn((b, 1, h, d), generator=gen, device=dev)
    kc = torch.randn((b, s, h, d), generator=gen, device=dev)
    vc = torch.randn((b, s, h, d), generator=gen, device=dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    out = decode_attention(q, kc, vc, lens)
    again = decode_attention(q, kc, vc, lens)
    ref = decode_attention_plain(q, kc, vc, lens)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    zero_ok = all(bool((out[i] == 0).all())
                  for i, n in enumerate(lengths) if n == 0)
    bitwise = bool(torch.equal(out, again))
    if not (torch.isfinite(out).all() and err <= KERNEL_TOL and zero_ok
            and bitwise):
        fail("K3 disagrees with its plain version at B=%d S=%d H=%d D=%d "
             "lengths %s: err %.3g (tolerance %g), length-0 rows zero: %s, "
             "two calls bitwise equal: %s"
             % (b, s, h, d, lengths, err, KERNEL_TOL, zero_ok, bitwise))
    res = {"case": "K3", "shape": [b, s, h, d], "lengths": list(lengths),
           "max_abs_err": err, "tol": KERNEL_TOL, "bitwise_repeat": bitwise}
    if time_it:
        tf = torch.nn.functional
        mask = (torch.arange(s, device=dev)[None, :]
                < lens[:, None])[:, None, None, :]
        # three slab pairs taken in turn (each captured call binds the
        # next): the live rows of one pair would stay in the 50 MB L2
        # across back-to-back calls, where each layer of a decode step
        # reads a pair of its own from HBM
        slabs = itertools.cycle([(kc, vc)] + [
            tuple(torch.randn((b, s, h, d), generator=gen, device=dev)
                  for _ in range(2)) for _ in range(2)])

        def turn(fn):
            return lambda: fn(*next(slabs))

        res["ms"] = time_ms(turn(
            lambda kk, vv: decode_attention(q, kk, vv, lens)))
        if yardsticks:
            res["plain_ms"] = time_ms(turn(
                lambda kk, vv: decode_attention_plain(q, kk, vv, lens)))
            res["library_ms"] = time_ms(turn(
                lambda kk, vv: tf.scaled_dot_product_attention(
                    q.transpose(1, 2), kk.transpose(1, 2),
                    vv.transpose(1, 2), attn_mask=mask)))
        flops, nbytes = decode_work(b, h, d, np.asarray(lengths))
        res["bound_ms"], res["bound_by"] = bound(flops, nbytes)
        res["gflop"], res["mbytes"] = flops / 1e9, nbytes / 1e6
    emit(res)
    return res


# ---------------------------------------------------------------------------
# phase 3: the slice at full width
# ---------------------------------------------------------------------------


def init_params(config, seed):
    """Parameters of the serving graph, made with numpy from ``seed`` by
    the model's own startup initializers (N(0, 0.02) weights, layer-norm
    scales 1, biases 0)."""
    from paddle_tpu_torch import Program, program_guard, unique_name
    from paddle_tpu_torch.serving.decode import _prefill_graph

    prog, startup = Program(), Program()
    with program_guard(prog, startup):
        with unique_name.guard():
            _prefill_graph(config, 1, 16)
    rng = np.random.default_rng(seed)
    params = {}
    for op in startup.global_block().ops:
        name, shape = op.output("Out")[0], tuple(op.attr("shape"))
        if op.type == "gaussian_random":
            params[name] = (rng.standard_normal(shape, dtype=np.float32)
                            * np.float32(op.attr("std"))
                            + np.float32(op.attr("mean")))
        elif op.type == "fill_constant":
            params[name] = np.full(shape, op.attr("value"), np.float32)
        else:
            fail("unexpected initializer %r for %s" % (op.type, name))
    return params


@contextlib.contextmanager
def plain_attention(forward_kernel=False):
    """Run the kernel-backed ops through their plain PyTorch versions (the
    reference path): fused_attention through flash_attention_plain (or,
    with ``forward_kernel``, through K1) and, when a gradient is asked
    for, flash_attention_bwd_plain; decode_attention, and
    decode_attention_quant on its dequantized slabs, through
    decode_attention_plain."""
    import torch
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.ops.attention import (flash_attention_bwd_plain,
                                                flash_attention_fwd,
                                                flash_attention_plain)
    from paddle_tpu_torch.ops.kv_cache import decode_attention_plain
    from paddle_tpu_torch.ops.quant import dequantize_slab

    fwd = flash_attention_fwd if forward_kernel else flash_attention_plain

    class PlainAttention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, lengths, causal, scale, layout):
            out, lse = fwd(q, k, v, causal, scale, lengths, layout)
            ctx.save_for_backward(q, k, v, out, lse, lengths)
            ctx.args = (causal, scale, layout)
            return out

        @staticmethod
        def backward(ctx, do):
            q, k, v, out, lse, lengths = ctx.saved_tensors
            causal, scale, layout = ctx.args
            return flash_attention_bwd_plain(
                q, k, v, out, lse, do, causal, scale, lengths, layout) + \
                (None,) * 4

    def fused(ctx):
        return {"Out": PlainAttention.apply(
            ctx.input("Q"), ctx.input("K"), ctx.input("V"),
            ctx.input("Lengths"), bool(ctx.attr("causal", False)),
            ctx.attr("scale", None), str(ctx.attr("layout", "bhtd")).lower())}

    def decode(ctx):
        return {"Out": decode_attention_plain(
            ctx.input("Q"), ctx.input("KCache"), ctx.input("VCache"),
            ctx.input("Lengths"), scale=ctx.attr("scale", None))}

    def decode_quant(ctx):
        q = ctx.input("Q")
        return {"Out": decode_attention_plain(
            q, dequantize_slab(ctx.input("KCache"), ctx.input("KScales"),
                               q.dtype),
            dequantize_slab(ctx.input("VCache"), ctx.input("VScales"),
                            q.dtype),
            ctx.input("Lengths"), scale=ctx.attr("scale", None))}

    saved = dict(registry.KERNELS)
    registry.KERNELS.update({"fused_attention": fused,
                             "decode_attention": decode,
                             "decode_attention_quant": decode_quant})
    try:
        yield
    finally:
        registry.KERNELS.clear()
        registry.KERNELS.update(saved)


@contextlib.contextmanager
def env_set(name, value):
    """Set one environment variable for the duration of a block."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name)
        else:
            os.environ[name] = old


@contextlib.contextmanager
def eager_steps():
    """Run every GraphStep through its eager function (``run_eager``: the
    program op by op from Python) instead of its CUDA graph: the engine
    line's eager side, and the plain-attention pass, which must not
    replay a graph of the kernels."""
    from paddle_tpu_torch.serving.engine import GraphStep

    saved = GraphStep.__call__
    GraphStep.__call__ = GraphStep.run_eager
    try:
        yield
    finally:
        GraphStep.__call__ = saved


def _decode_feeds(pred, slabs, cur, lens, seed):
    """One decode step's feeds: ``cur`` (B,) tokens at ``lens`` (B,)."""
    bb = cur.shape[0]
    feeds = {"tokens": cur.reshape(bb, 1).astype(np.int64),
             "positions": lens.reshape(bb, 1).astype(np.int64),
             "lengths": lens.astype(np.int32),
             "seed": np.array([seed], np.int64)}
    for i in range(pred.config.n_layer):
        feeds["kcache_%d" % i] = slabs[2 * i]
        feeds["vcache_%d" % i] = slabs[2 * i + 1]
    return feeds


def teacher_forced_logits(pred, prompts, generated, max_new):
    """Logits of every step when the prompts and then ``generated`` (B,
    max_new) are fed through the predictor's prefill and decode steps
    (their graphs on the card; under eager_steps(), their eager
    functions): entry t is what produced generated[:, t]."""
    import torch

    tokens, lens, b, s = pred._bucketed(prompts, max_new)
    bb = tokens.shape[0]
    dexe, _fetch_names = pred.acquire("decode", bb, s)
    slabs = pred._slabs(dexe)
    logits = [pred._prefill(tokens, lens, s, slabs)[:b].float()]
    lens = lens.copy()
    cur = np.zeros((bb,), np.int64)
    for t in range(1, max_new):
        cur[:b] = generated[:, t - 1]
        logits.append(dexe(  # fetches [next_ids, logits, slabs...]
            _decode_feeds(pred, slabs, cur, lens, t),
            read=lambda outs: outs[1][:b].float().clone()))
        lens = lens + 1
    return torch.stack(logits, dim=1)                   # (B, max_new, V)


def _k1_k3_counts(reset=False):
    from paddle_tpu_torch.ops.attention import flash_attention_fwd
    from paddle_tpu_torch.ops.kv_cache import decode_attention

    if reset:
        flash_attention_fwd.launches = decode_attention.launches = 0
    return {"K1": flash_attention_fwd.launches,
            "K3": decode_attention.launches}


def run_slice(config, prompt_lens, max_new, seed, place, workdir):
    """Export, load and serve ``config`` with random weights. Returns the
    slice line: the timed runs, the teacher-forced comparison and the main
    path's run (a steady-state generate through the graph steps, kernel
    counts zeroed just before it; on the card under torch.profiler, with
    the device's K1 and K3 counts as ``device_launches`` and the
    profiler's as ``profiler_launches``); with the engine line
    (eager against graph steps, memory over buckets, ``res["engine"]``)
    and the predictor line (``res["predictor"]``) inside. Runs on any
    place (the CPU tests rehearse it at a tiny size); the caller checks
    the kernel launch counts."""
    import torch
    from paddle_tpu_torch import Scope
    from paddle_tpu_torch.serving.decode import (DecodeConfig,
                                                 DecodePredictor,
                                                 _pow2_bucket,
                                                 save_decode_model)
    from paddle_tpu_torch.serving.engine import GraphStep

    cfg = DecodeConfig(**config)
    t0 = time.perf_counter()
    scope = Scope()
    for name, val in init_params(cfg, seed).items():
        scope.set_var(name, val)
    n_params = sum(int(np.prod(v.shape)) for v in scope.vars.values())
    model_dir = os.path.join(workdir, "model")
    save_decode_model(model_dir, cfg, None, scope=scope)
    # the predictor line serves the prefill program at the slice's
    # prefill bucket (K1 at the serving shape)
    pbatch = _pow2_bucket(len(prompt_lens))
    pseq = _pow2_bucket(int(max(prompt_lens)), floor=16)
    predictor_dir = os.path.join(workdir, "predictor_model")
    save_decode_model(predictor_dir, cfg, None, scope=scope,
                      export_batch=pbatch, export_seq=pseq)
    del scope
    pred = DecodePredictor(model_dir, place=place)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int64)
               for n in prompt_lens]
    cuda = pred.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def generate(eager, batch=None):
        batch = prompts if batch is None else batch
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with eager_steps() if eager else contextlib.nullcontext():
            out = pred.generate(batch, max_new_tokens=max_new)
        sync()
        wall = time.perf_counter() - t0
        steps = list(pred.timings["step"])
        return np.stack(out), {
            "prefill_ms": pred.timings["prefill"][0],
            "decode_ms_per_token": float(np.mean(steps)),
            "decode_ms_p50": float(np.median(steps)),
            "generate_s": wall, "tokens_per_s": len(batch) * max_new / wall,
            "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                            if cuda else None),
            "peak_reserved_gb": (torch.cuda.max_memory_reserved() / 1e9
                                 if cuda else None),
            "prefill_calls": len(pred.timings["prefill"]),
            "decode_steps": len(steps)}

    def reserved_gb():
        """Device memory the allocator holds beyond its free cache: the
        graphs' private pools stay in it."""
        if not cuda:
            return 0.0
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved() / 1e9

    # eager first: it builds the kernels and the steps, and no graph
    # exists yet, so its peak memory holds no graph pool
    generate(eager=True)
    out, run = generate(eager=True)
    runs = {"eager": [run], "graph": []}
    tokens = [out]
    traces = {"after_eager": pred.traces}
    reserved_before = reserved_gb()
    # the first generate through the graph steps captures them (each
    # step's warm-up runs and its capture launch its kernels from the
    # host); the later ones replay
    out, cold = generate(eager=False)
    tokens.append(out)
    traces["after_first_graph_generate"] = pred.traces
    reserved_after = reserved_gb()
    for mode in ("graph", "graph", "eager"):
        out, run = generate(eager=mode == "eager")
        tokens.append(out)
        runs[mode].append(run)
    traces["after_timed"] = pred.traces
    generated = tokens[0]
    if generated.shape != (len(prompts), max_new) or \
            generated.min() < 0 or generated.max() >= cfg.vocab_size:
        fail("generate returned tokens of shape %s in [%d, %d]"
             % (generated.shape, generated.min(), generated.max()))
    tokens_equal = all(np.array_equal(t, generated) for t in tokens)
    if not tokens_equal:
        fail("eager and graph generate gave different tokens")
    if traces["after_timed"] != traces["after_first_graph_generate"]:
        fail("a generate at the same buckets built or captured again: %s"
             % traces)

    kernel_logits = teacher_forced_logits(pred, prompts, generated, max_new)
    with plain_attention(), eager_steps():
        plain_logits = teacher_forced_logits(pred, prompts, generated,
                                             max_new)
    replay_match = bool((kernel_logits.argmax(-1).cpu().numpy()
                         == generated).all())
    plain_agree = float((plain_logits.argmax(-1).cpu().numpy()
                         == generated).mean())
    err = float((kernel_logits - plain_logits).abs().max())
    engine = {"phase": "engine", "tokens_equal": tokens_equal,
              "traces": traces, "graph_warmup_runs": GraphStep.WARMUP,
              "first_graph_generate": cold,
              "graph_pools_gb": reserved_after - reserved_before,
              "reserved_gb": reserved_after}
    if cuda:
        with eager_steps():
            engine["eager"] = {
                "profile": profile_generate(pred, prompts, max_new, workdir,
                                            "generate_eager_ops.txt"),
                "launches_per_decode_step": launches_per_decode_step(
                    pred, prompts, max_new)}

    # the main path: a steady-state generate through the graph steps,
    # kernel counts zeroed just before it; on the card the device's
    # counters count the kernels the replays launch, under the profiler
    got = {}

    def main_path():
        got["tokens"] = np.stack(pred.generate(prompts,
                                               max_new_tokens=max_new))

    _k1_k3_counts(reset=True)
    if cuda:
        _device_counts((), reset=True)
        profile = profile_call(main_path, os.path.join(
            workdir, "generate_graph_ops.txt"))
        device_launches = _device_counts(("K1", "K3"))
    else:
        main_path()
    launches = _k1_k3_counts()
    traces["after_main_path"] = pred.traces
    main = {"tokens_equal": bool(np.array_equal(got["tokens"], generated)),
            "captures_or_builds": (traces["after_main_path"]
                                   - traces["after_timed"]),
            "prefill_calls": len(pred.timings["prefill"]),
            "decode_steps": len(pred.timings["step"])}
    if not main["tokens_equal"] or main["captures_or_builds"]:
        fail("the main path's generate: %s" % main)
    graph = runs["graph"][0]
    res = {
        "phase": "slice", "config": config, "params": n_params,
        "prompts": [int(n) for n in prompt_lens], "max_new_tokens": max_new,
        "prefill_calls": main["prefill_calls"],
        "decode_steps": main["decode_steps"], "launches": launches,
        "main_path": main,
        "prefill_ms": graph["prefill_ms"],
        "decode_ms_per_token": graph["decode_ms_per_token"],
        "decode_ms_p50": graph["decode_ms_p50"],
        "generate_s": graph["generate_s"],
        "tokens_per_s": graph["tokens_per_s"],
        "first_generate_s": cold["generate_s"],
        "setup_s": setup_s,
        "peak_mem_gb": graph["peak_mem_gb"],
        "logits_max_abs_err": err, "logits_tol": LOGITS_TOL,
        "logits_finite": bool(torch.isfinite(kernel_logits).all()),
        "replay_matches_generate": replay_match,
        "plain_argmax_agreement": plain_agree,
    }
    if not (res["logits_finite"] and err <= LOGITS_TOL and replay_match):
        fail("teacher-forced check failed: %s" % json.dumps(res))
    for mode, got_runs in runs.items():
        engine.setdefault(mode, {}).update(
            {key: [r[key] for r in got_runs] for key in (
                "prefill_ms", "decode_ms_per_token", "decode_ms_p50",
                "generate_s", "tokens_per_s", "peak_mem_gb",
                "peak_reserved_gb")})
    if cuda:
        res["profile"] = engine["graph"]["profile"] = profile
        engine["graph"]["launches_per_decode_step"] = \
            launches_per_decode_step(pred, prompts, max_new)
        res["k3_device_ms"] = profile["port_kernels"].get(
            "decode_attn", {"device_ms": 0.0})["device_ms"]
        res["device_launches"] = device_launches
        res["profiler_launches"] = {
            name: profile["port_kernels"].get(src, {"launches": 0})[
                "launches"]
            for name, src in (("K1", "flash_fwd"), ("K3", "decode_attn"))}
        engine["decode_speedup"] = (
            float(np.mean(engine["eager"]["decode_ms_per_token"]))
            / float(np.mean(engine["graph"]["decode_ms_per_token"])))
    engine["memory"] = bucket_memory(pred, prompts, generate, reserved_gb)
    res["engine"] = engine
    res["predictor"] = run_predictor(predictor_dir, pred, prompts, max_new,
                                     place)
    t0 = time.perf_counter()
    res["sampling"] = run_sampling(pred, model_dir, prompts, max_new, place)
    res["sampling"]["seconds"] = time.perf_counter() - t0
    shutil.rmtree(model_dir, ignore_errors=True)
    shutil.rmtree(predictor_dir, ignore_errors=True)
    return res


def bucket_memory(pred, prompts, generate, reserved_gb):
    """Memory of generates over buckets: the slice's (steps already
    cached), then two smaller ones (half the prompts cut to a quarter of
    their length, a quarter of them cut to half), each through the eager
    functions and the graphs with the same tokens: after each, the steps
    cached, the bytes they hold (``StepCache.nbytes``: slabs, buffers,
    graph pools) and the device memory reserved. Then the cache bounded
    to the slice's steps' bytes plus half of the other buckets' (which
    evicts the least recently used: the slice's steps), a generate at the
    last bucket (a hit) and one at the slice's (built and captured again,
    evicting the oldest of the others): evictions, memory and the same
    tokens after each."""
    cache = pred._steps

    def state(label, batch):
        return {"bucket": label, "prompts": len(batch),
                "prompt_max": int(max(len(p) for p in batch)),
                "steps": len(cache), "step_cache_gb": cache.nbytes / 1e9,
                "reserved_gb": reserved_gb(), "evictions": cache.evictions,
                "traces": pred.traces}

    n = len(prompts)
    batches = [("slice", prompts),
               ("half_quarter", [p[:max(1, len(p) // 4)]
                                 for p in prompts[:max(1, n // 2)]]),
               ("quarter_half", [p[:max(1, len(p) // 2)]
                                 for p in prompts[:max(1, n // 4)]])]
    slice_bytes = cache.nbytes
    out = {"unbounded": [], "slice_step_gb": slice_bytes / 1e9}
    want = {}
    for label, batch in batches:
        eager, _ = generate(True, batch)
        want[label], run = generate(False, batch)
        if not np.array_equal(eager, want[label]):
            fail("eager and graph generate differ at bucket %s" % label)
        out["unbounded"].append(dict(state(label, batch),
                                     peak_mem_gb=run["peak_mem_gb"]))
    bound = slice_bytes + (cache.nbytes - slice_bytes) // 2
    out["bound_gb"] = bound / 1e9
    saved, cache.max_bytes = cache.max_bytes, bound
    try:
        out["bounded"] = [state("bound set", prompts)]
        for label, batch in (batches[-1], batches[0]):
            got, run = generate(False, batch)
            if not np.array_equal(got, want[label]):
                fail("the bounded cache's generate at bucket %s gave other "
                     "tokens" % label)
            out["bounded"].append(dict(state(label, batch),
                                       peak_mem_gb=run["peak_mem_gb"]))
        if cache.nbytes > bound or not cache.evictions:
            fail("the bounded step cache holds %d bytes past %d with %d "
                 "evictions" % (cache.nbytes, bound, cache.evictions))
    finally:
        cache.max_bytes = saved
    return out


def launches_per_decode_step(pred, prompts, max_new):
    """Host launch calls of one call of the slice's decode step, from
    torch.profiler (the CUDA API calls it records): kernel launches
    and graph launches, and the device kernels the call ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tokens, lens, b, s = pred._bucketed(prompts, max_new)
    dexe, _ = pred.acquire("decode", tokens.shape[0], s)
    cur = tokens[:, 0].copy()
    feeds = _decode_feeds(pred, pred._slabs(dexe), cur, lens, 1)
    dexe(feeds, read=lambda outs: outs[0].cpu())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dexe(feeds, read=lambda outs: outs[0].cpu())
        torch.cuda.synchronize()
    got = {"kernel_launches": 0, "graph_launches": 0, "device_kernels": 0}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            if "memcpy" not in e.key.lower() and \
                    "memset" not in e.key.lower():
                got["device_kernels"] += e.count
        elif e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            got["kernel_launches"] += e.count
        elif e.key.startswith("cudaGraphLaunch"):
            got["graph_launches"] += e.count
    return got


def run_predictor(model_dir, pred, prompts, max_new, place, calls=5):
    """The predictor line: ``inference.Predictor`` on the slice's prefill
    export, through its graph step against its eager function in turns
    (eager, graph, graph, eager; ``calls`` calls each): ms per call, the
    largest difference of their outputs, and their logits against the
    DecodePredictor prefill's on the same prompts."""
    import torch
    from paddle_tpu_torch.inference import Predictor

    p = Predictor(model_dir, place=place)
    tokens, lens, b, s = pred._bucketed(prompts, max_new)
    sp = p._feed_plan[0][1].shape[1]
    feed = {"tokens": tokens[:, :sp], "lengths": lens}
    want = pred._prefill(tokens, lens, s).cpu().numpy()
    times = {"eager": [], "graph": []}
    outs = {}
    for mode in ("eager", "graph", "graph", "eager"):
        with eager_steps() if mode == "eager" else contextlib.nullcontext():
            outs[mode] = p.run(feed)[0]          # warm-up (and capture)
            t0 = time.perf_counter()
            for _ in range(calls):
                p.run(feed)
            times[mode].append((time.perf_counter() - t0) / calls * 1e3)
    diff = float(np.abs(outs["graph"] - outs["eager"]).max())
    vs_decode = float(np.abs(outs["graph"] - want).max())
    res = {"phase": "predictor", "export": [int(n) for n in
                                            tokens[:, :sp].shape],
           "fetches": p.fetch_names, "ms_per_call": times,
           "graph_vs_eager_max_abs": diff,
           "vs_decode_prefill_max_abs": vs_decode,
           "vs_decode_prefill_equal": bool(vs_decode == 0.0),
           "traces": p.traces, "tol": LOGITS_TOL}
    if not (np.isfinite(outs["graph"]).all() and diff <= LOGITS_TOL
            and vs_decode <= LOGITS_TOL):
        fail("predictor check failed: %s" % json.dumps(res))
    del p
    if place.torch_device().type == "cuda":
        torch.cuda.empty_cache()
    return res


def run_sampling(pred, model_dir, prompts, max_new, place):
    """The sampling line: ``generate`` with top-k (k SAMPLE_K) and top-p
    (p SAMPLE_P) on the slice's prompts. For each: through the graph
    steps twice with one seed (equal tokens), through the eager functions
    with that seed (equal to the graph's: the draw is a function of the
    seed feed, computed on the device), with another seed (how many
    tokens differ); then a predictor with sample_k=1, whose topk tokens
    must be the greedy ones."""
    from paddle_tpu_torch.serving.decode import DecodePredictor

    greedy = np.stack(pred.generate(prompts, max_new_tokens=max_new))
    res = {"phase": "sampling", "k": SAMPLE_K, "p": SAMPLE_P,
           "seed": SAMPLE_SEED}
    for strategy in ("topk", "topp"):
        def gen(seed, eager=False):
            with eager_steps() if eager else contextlib.nullcontext():
                return np.stack(pred.generate(
                    prompts, max_new_tokens=max_new, strategy=strategy,
                    seed=seed))

        graph = gen(SAMPLE_SEED)
        t0 = time.perf_counter()
        again = gen(SAMPLE_SEED)
        wall = time.perf_counter() - t0
        eager = gen(SAMPLE_SEED, eager=True)
        other = gen(SAMPLE_SEED + 1)
        res[strategy] = {
            "graph_equals_eager": bool(np.array_equal(graph, eager)),
            "same_seed_equal": bool(np.array_equal(graph, again)),
            "other_seed_tokens_differing": int((graph != other).sum()),
            "tokens_differing_from_greedy": int((graph != greedy).sum()),
            "in_range": bool(graph.min() >= 0
                             and graph.max() < pred.config.vocab_size),
            "decode_ms_p50": float(np.median(pred.timings["step"])),
            "generate_s": wall}
    k1 = DecodePredictor(model_dir, place=place, sample_k=1)
    res["k1_equals_greedy"] = bool(np.array_equal(
        np.stack(k1.generate(prompts, max_new_tokens=max_new,
                             strategy="topk", seed=SAMPLE_SEED)), greedy))
    del k1
    ok = res["k1_equals_greedy"] and all(
        res[s]["graph_equals_eager"] and res[s]["same_seed_equal"]
        and res[s]["in_range"] and res[s]["other_seed_tokens_differing"]
        for s in ("topk", "topp"))
    if not ok:
        fail("sampling check failed: %s" % json.dumps(res))
    return res


def _percentiles(xs):
    xs = np.asarray(xs, np.float64)
    return {"p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99))}


def serve_round(srv, requests, clients):
    """Send ``requests`` ((sample, ...) tuples) to ``srv`` from
    ``clients`` threads, request i from thread i % clients, each thread
    submitting its share and then waiting for it. Returns (outputs, wall
    s, per-request latency ms, time to first token ms or None)."""
    import threading

    n = len(requests)
    futs, done = [None] * n, [0.0] * n

    def client(c):
        mine = range(c, n, clients)
        for i in mine:
            futs[i] = srv.submit(requests[i])
            futs[i].add_done_callback(
                lambda f, i=i: done.__setitem__(i, time.perf_counter()))
        for i in mine:
            futs[i].result(timeout=600)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    outs = [f.result(timeout=0)[0] for f in futs]
    lat = [(d - f._t0) * 1e3 for d, f in zip(done, futs)]
    ttft = [(f._t_first - f._t0) * 1e3 for f in futs
            if f._t_first is not None]
    return outs, wall, lat, ttft or None


def _same_tokens(outs, want):
    """Whether two rounds gave every request the same tokens."""
    return len(outs) == len(want) and all(
        np.array_equal(o, w) for o, w in zip(outs, want))


def greedy_gate(pred, prompts, outs, budgets):
    """Each server output checked teacher-forced, as the slice checks
    generate: fed back through the predictor's prefill and decode steps
    (groups of equal budget, at most SERVER_SLOTS prompts), every
    generated token's logit must be within LOGITS_TOL of its row's
    maximum. Returns the worst gap."""
    import torch

    worst = 0.0
    for mn in sorted(set(budgets)):
        idx = [i for i, b in enumerate(budgets) if b == mn]
        for c in range(0, len(idx), SERVER_SLOTS):
            chunk = idx[c:c + SERVER_SLOTS]
            gen = np.stack([outs[i] for i in chunk])
            logits = teacher_forced_logits(pred, [prompts[i] for i in chunk],
                                           gen, mn)
            picked = logits.gather(
                2, torch.from_numpy(gen).to(logits.device)[..., None])[..., 0]
            worst = max(worst, float((logits.max(-1).values
                                      - picked).max()))
    return worst


def run_server(config, seed, place, workdir,
               prompt_range=SERVER_PROMPT_LENS, budget_mix=SERVER_BUDGETS):
    """The server line: DecodeServer over the serving config (random
    weights from ``seed``), the traffic described above SERVER_SLOTS,
    sent as one burst by SERVER_CLIENTS threads to a continuous and a static
    (gang) server on one predictor. Every prefill bucket the traffic can
    hit is captured first, then one untimed warm round per mode and one
    untimed continuous round with a generate at the server's bucket
    running beside it (its tokens must equal those of one with no server
    running); then the timed rounds in turns (SERVER_TIMED), each:
    generated tokens/s, mean active slots, request latency and time to
    first token (p50, p99), decode step ms p50, prefill executions, and
    no build or capture. Then one continuous round under torch.profiler
    (on the card) with the K1/K3 host and device counts zeroed just
    before it (the main path's run for the server: the device counts 12
    K1 per admission prefill and 12 K3 per decode step), the greedy gate (teacher-forced, on
    the warm continuous round), every later round's tokens equal to the
    warm round of its mode (greedy decoding is deterministic, whatever
    the grouping of admissions), tokens against generate of each prompt
    alone (printed), a stop() during a burst (every future completes),
    and a topk server round."""
    import threading

    import torch
    from paddle_tpu_torch import Scope
    from paddle_tpu_torch.serving.decode import (DecodeConfig,
                                                 DecodePredictor,
                                                 DecodeServer,
                                                 save_decode_model)

    cuda = torch.device(place.torch_device()).type == "cuda"
    cfg = DecodeConfig(**config)
    t0 = time.perf_counter()
    scope = Scope()
    for name, val in init_params(cfg, seed).items():
        scope.set_var(name, val)
    model_dir = os.path.join(workdir, "server_model")
    save_decode_model(model_dir, cfg, None, scope=scope)
    del scope
    pred = DecodePredictor(model_dir, place=place)
    setup_s = time.perf_counter() - t0
    prompts, budgets = _server_requests(cfg, seed, prompt_range, budget_mix)
    requests = [(p, np.array([b], np.int64))
                for p, b in zip(prompts, budgets)]
    max_new = max(budgets)
    # point a's reference: a generate at the server's bucket, no server
    gen_prompts = prompts[:SERVER_SLOTS]
    gen_want = np.stack(pred.generate(gen_prompts, max_new_tokens=max_new))
    servers = {mode: DecodeServer(pred, slots=SERVER_SLOTS,
                                  max_seq=SERVER_SEQ, max_new_tokens=max_new,
                                  continuous=mode == "continuous")
               for mode in ("continuous", "static")}
    t0 = time.perf_counter()
    for srv in servers.values():
        srv.start()
    buckets = _capture_prefills(pred, [len(p) for p in prompts],
                                SERVER_SEQ)
    warm_s = time.perf_counter() - t0
    warm = {}
    for mode, srv in servers.items():
        warm[mode] = serve_round(srv, requests, SERVER_CLIENTS)[0]
    # point a, untimed: a generate at the server's bucket while it serves
    got_gen = {}
    gen_thread = threading.Thread(target=lambda: got_gen.update(
        tokens=np.stack(pred.generate(gen_prompts, max_new_tokens=max_new))))
    gen_thread.start()
    beside = serve_round(servers["continuous"], requests, SERVER_CLIENTS)[0]
    gen_thread.join()
    # each later round's greedy tokens against the warm round of its mode
    equal_warm = {"beside_generate": _same_tokens(beside,
                                                  warm["continuous"]),
                  "timed": {mode: [] for mode in servers}}
    traces = pred.traces
    stats = {mode: {"tokens_per_s": [], "mean_active_slots": [],
                    "latency_ms": [], "ttft_ms": [], "decode_step_ms_p50": [],
                    "prefill_executions": [], "decode_steps": []}
             for mode in servers}
    for mode in SERVER_TIMED:
        srv = servers[mode]
        srv.step_active_counts.clear()
        srv.step_ms.clear()
        pf0 = srv.prefill_executions
        outs, wall, lat, ttft = serve_round(srv, requests, SERVER_CLIENTS)
        equal_warm["timed"][mode].append(_same_tokens(outs, warm[mode]))
        st = stats[mode]
        st["tokens_per_s"].append(sum(len(o) for o in outs) / wall)
        st["mean_active_slots"].append(float(np.mean(
            srv.step_active_counts)))
        st["latency_ms"].append(_percentiles(lat))
        st["ttft_ms"].append(_percentiles(ttft))
        st["decode_step_ms_p50"].append(float(np.median(srv.step_ms)))
        st["prefill_executions"].append(srv.prefill_executions - pf0)
        st["decode_steps"].append(len(srv.step_active_counts))
    timed_traces = pred.traces - traces
    gen_equal = bool(np.array_equal(got_gen.get("tokens"), gen_want))
    owned_gb = sum(s.numel() * s.element_size()
                   for s in servers["continuous"]._slabs) / 1e9
    # the server's main path: one continuous round, host counts zeroed
    srv = servers["continuous"]
    srv.step_active_counts.clear()
    pf0 = srv.prefill_executions
    _k1_k3_counts(reset=True)
    profiled = {}

    def main_path():
        profiled["outs"] = serve_round(srv, requests, SERVER_CLIENTS)[0]

    if cuda:
        _device_counts((), reset=True)
        profile = profile_call(main_path, os.path.join(
            workdir, "server_round_ops.txt"))
        device_launches = _device_counts(("K1", "K3"))
    else:
        profile = None
        main_path()
    host = _k1_k3_counts()
    equal_warm["main_path"] = _same_tokens(profiled["outs"],
                                           warm["continuous"])
    prefills = srv.prefill_executions - pf0
    steps = len(srv.step_active_counts)
    res = {"phase": "server", "config": config, "slots": SERVER_SLOTS,
           "seq": srv.seq, "requests": SERVER_REQUESTS,
           "clients": SERVER_CLIENTS, "budgets": list(budget_mix),
           "prompt_lens": [len(p) for p in prompts],
           "tokens_per_round": int(sum(budgets)), "timed_order":
           list(SERVER_TIMED), "setup_s": setup_s, "warm_s": warm_s,
           "prefill_buckets": buckets,
           **{mode: st for mode, st in stats.items()},
           "timed_builds_and_captures": timed_traces,
           "owned_slab_gb": owned_gb,
           "step_cache_gb": pred._steps.nbytes / 1e9,
           "generate_during_round_equal": gen_equal,
           "main_path": {"host_launches": host, "prefill_executions":
                         prefills, "decode_steps": steps}}
    n_layer = cfg.n_layer
    if profile is not None:
        res["main_path"]["device_launches"] = device_launches
        res["main_path"]["profiler_launches"] = {
            name: profile["port_kernels"].get(src, {"launches": 0})[
                "launches"]
            for name, src in (("K1", "flash_fwd"), ("K3", "decode_attn"))}
        res["main_path"]["expected"] = {"K1": n_layer * prefills,
                                        "K3": n_layer * steps}
        res["profile"] = {key: profile[key] for key in (
            "profiled_wall_ms", "device_busy_ms", "device_idle_share",
            "device_ms_by_kind", "port_kernels", "host_launch_calls")}
    # the gates on the greedy outputs (the warm continuous round's)
    res["greedy_worst_logit_gap"] = greedy_gate(
        pred, prompts, warm["continuous"], budgets)
    alone = [pred.generate([p], max_new_tokens=b)[0]
             for p, b in zip(prompts, budgets)]
    res["tokens_differing_from_generate_alone"] = int(sum(
        int((a != o).sum()) for a, o in zip(alone, warm["continuous"])))
    res["static_vs_continuous_tokens_differing"] = int(sum(
        int((a != o).sum()) for a, o in zip(warm["static"],
                                            warm["continuous"])))
    # stop() during a burst: every future completes
    futs = [srv.submit(r) for r in requests]
    stopper = threading.Thread(target=srv.stop)
    stopper.start()
    stopped = [f.result(timeout=600)[0] for f in futs]
    stopper.join()
    res["stop_during_burst_completed"] = int(sum(
        len(o) == b for o, b in zip(stopped, budgets)))
    equal_warm["stop_burst"] = _same_tokens(stopped, warm["continuous"])
    res["rounds_equal_to_warm"] = equal_warm
    servers["static"].stop()
    topk = DecodeServer(pred, slots=SERVER_SLOTS, max_seq=SERVER_SEQ,
                        max_new_tokens=max_new, strategy="topk")
    topk.start()
    touts = serve_round(topk, [(p, np.array([b, 100 + i], np.int64))
                               for i, (p, b) in enumerate(
                                   zip(prompts[:SERVER_SLOTS], budgets))],
                        SERVER_CLIENTS)[0]
    topk.stop()
    res["topk_round_completed"] = int(sum(
        len(o) == b and o.min() >= 0 and o.max() < cfg.vocab_size
        for o, b in zip(touts, budgets)))
    res["step_cache_gb_after_stop"] = pred._steps.nbytes / 1e9
    bad = []
    if timed_traces:
        bad.append("the timed rounds built or captured %d" % timed_traces)
    if not gen_equal:
        bad.append("a generate during a round gave other tokens")
    if any(host.values()):
        bad.append("the host launched %s in the main path's round" % host)
    if profile is not None and res["main_path"]["device_launches"] != \
            res["main_path"]["expected"]:
        bad.append("the profiled round launched %s"
                   % res["main_path"]["device_launches"])
    if res["greedy_worst_logit_gap"] > LOGITS_TOL:
        bad.append("a greedy token is %.3g below its row's maximum"
                   % res["greedy_worst_logit_gap"])
    if not all([equal_warm["beside_generate"], equal_warm["main_path"],
                equal_warm["stop_burst"]]
               + [ok for oks in equal_warm["timed"].values() for ok in oks]):
        bad.append("a round's greedy tokens differ from the warm round's")
    if res["stop_during_burst_completed"] != SERVER_REQUESTS:
        bad.append("stop() during a burst completed %d of %d"
                   % (res["stop_during_burst_completed"], SERVER_REQUESTS))
    if res["topk_round_completed"] != SERVER_SLOTS:
        bad.append("the topk round completed %d of %d"
                   % (res["topk_round_completed"], SERVER_SLOTS))
    if bad:
        fail("server: %s: %s" % ("; ".join(bad), json.dumps(res)))
    del pred
    shutil.rmtree(model_dir, ignore_errors=True)
    if cuda:
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phases 11-15: the rest of decode serving (speculative decoding, the
# speculative server, shared-prefix admission, int8 slabs, beam search)
# ---------------------------------------------------------------------------


def _export(workdir, name, cfg, params):
    """``params`` written as a decode export under ``workdir``/``name``."""
    from paddle_tpu_torch import Scope
    from paddle_tpu_torch.serving.decode import save_decode_model

    scope = Scope()
    for key, val in params.items():
        scope.set_var(key, val)
    model_dir = os.path.join(workdir, name)
    save_decode_model(model_dir, cfg, None, scope=scope)
    return model_dir


def favourable_params(params, draft_layers):
    """tools/bench_decode.py's acceptance-favourable export
    (bench_decode.py:118-133): every layer at or past the draft's depth
    has its attention ``out`` and FFN ``fc2`` projections (weights and
    biases) zeroed, so those layers are identities on the residual stream
    and the draft's argmax is the target's. The zeroed products still
    run: the cost of a step is unchanged."""
    out = dict(params)
    for name, val in params.items():
        if re.match(r"lm\.l(\d+)\.(self\.out|ffn\.fc2)\.[wb]$", name) and \
                int(name.split(".")[1][1:]) >= draft_layers:
            out[name] = np.zeros_like(val)
    return out


def _tokens_differing(outs, want):
    return int(sum(int((np.asarray(a) != np.asarray(b)).sum())
                   + abs(len(a) - len(b)) for a, b in zip(outs, want)))


def _spec_counts():
    from paddle_tpu_torch import observability as obs

    return (obs.DECODE_SPEC_PROPOSED.value(),
            obs.DECODE_SPEC_ACCEPTED.value())


def _shares_slabs(step, lender):
    """Whether every slab feed of ``step`` is ``lender``'s own tensor."""
    names = [n for n in step.static
             if n.startswith(("kcache_", "vcache_"))]
    return bool(names) and all(
        step.static[n].data_ptr() == lender.static[n].data_ptr()
        for n in names)


def run_speculative(preds, prompts, max_new, spec_k, cuda):
    """The speculative line: generate(speculative=True, spec_k) against
    plain greedy on each export of ``preds`` ({name: predictor}), in
    turns (plain, speculative, speculative, plain) after a warm call of
    each: tokens/s, acceptance rate, draft and verify ms p50 (device,
    by events), and on the card the device's K1/K3 launches of one
    speculative generate and of one draft and one verify step alone
    (the verify window's attention is plain torch: 0 K3). Gates: every
    emitted token within LOGITS_TOL of its row's teacher-forced maximum,
    the launch counts, the draft and verify steps on the decode step's
    own slabs; the count of tokens that differ from plain greedy is
    printed."""
    out = {}
    for name, pred in preds.items():
        n_layer, dn = pred.config.n_layer, pred.draft_n_layer
        tokens, lens, b, s = pred._bucketed(prompts, max_new)
        plain = pred.generate(prompts, max_new)
        spec = pred.generate(prompts, max_new, speculative=True,
                             spec_k=spec_k)
        res = {"tokens_per_s": {"plain": [], "speculative": []},
               "draft_ms_p50": [], "verify_ms_p50": [], "rounds": [],
               "tail_steps": [], "equal_to_first": True}
        p0, a0 = _spec_counts()
        for mode in ("plain", "speculative", "speculative", "plain"):
            t0 = time.perf_counter()
            got = pred.generate(prompts, max_new,
                                speculative=mode == "speculative",
                                spec_k=spec_k)
            wall = time.perf_counter() - t0
            res["tokens_per_s"][mode].append(sum(len(g) for g in got)
                                             / wall)
            first = spec if mode == "speculative" else plain
            res["equal_to_first"] &= _same_tokens(got, first)
            if mode == "speculative":
                res["draft_ms_p50"].append(float(np.median(
                    pred.timings["draft"])))
                res["verify_ms_p50"].append(float(np.median(
                    pred.timings["verify"])))
                res["rounds"].append(len(pred.timings["verify"]))
                res["tail_steps"].append(len(pred.timings["step"]))
        proposed, accepted = (x - y for x, y in zip(_spec_counts(),
                                                    (p0, a0)))
        res["acceptance_rate"] = accepted / max(proposed, 1)
        res["tokens_differing_from_greedy"] = _tokens_differing(spec, plain)
        res["greedy_worst_logit_gap"] = greedy_gate(
            pred, prompts, spec, [max_new] * len(prompts))
        dexe = pred.acquire("decode", tokens.shape[0], s, "greedy")[0]
        drexe = pred.acquire("draft", tokens.shape[0], s, lender=dexe)[0]
        vexe = pred.acquire("verify", tokens.shape[0], s,
                            window=spec_k + 1, lender=dexe)[0]
        res["draft_verify_share_decode_slabs"] = (
            _shares_slabs(drexe, dexe) and _shares_slabs(vexe, dexe))
        if cuda:
            _device_counts((), reset=True)
            pred.generate(prompts, max_new, speculative=True, spec_k=spec_k)
            got = _device_counts(("K1", "K3"), reset=True)
            rounds, tail = (len(pred.timings["verify"]),
                            len(pred.timings["step"]))
            res["device_launches"] = got
            res["expected"] = {"K1": n_layer,
                               "K3": dn * spec_k * rounds + n_layer * tail}
            drexe(dict(drexe.static))
            res["draft_step_launches"] = _device_counts(("K1", "K3"),
                                                        reset=True)
            vexe(dict(vexe.static))
            res["verify_step_launches"] = _device_counts(("K1", "K3"),
                                                         reset=True)
            res["device_launches_per_round"] = {
                "K3": dn * spec_k, "K1": 0, "verify_K3": 0}
        out[name] = res
    return out


def _server_requests(cfg, seed, prompt_range, budget_mix):
    """run_server's traffic (its prompts and budgets from ``seed``)."""
    rng = np.random.default_rng(seed + 2)
    lo, hi = prompt_range
    plens = rng.integers(lo, hi + 1, SERVER_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int64)
               for n in plens]
    budgets = [budget_mix[i % len(budget_mix)]
               for i in range(SERVER_REQUESTS)]
    return prompts, budgets


def _capture_prefills(pred, plens, seq):
    """Capture every admission prefill bucket that prompts of ``plens``
    tokens can hit in a server of SERVER_SLOTS slots over ``seq`` rows;
    returns the [batch, seq] buckets."""
    from paddle_tpu_torch.serving.decode import _pow2_bucket

    sps = sorted({min(_pow2_bucket(int(n), floor=16), seq) for n in plens})
    bbs = sorted({_pow2_bucket(b) for b in range(1, SERVER_SLOTS + 1)})
    buckets = [[bb, sp] for bb in bbs for sp in sps]
    for bb, sp in buckets:
        pred.acquire("prefill", bb, sp)[0].capture()
    return buckets


def _round_stats(srv, outs, wall, lat, ttft):
    return {"tokens_per_s": sum(len(o) for o in outs) / wall,
            "latency_ms": _percentiles(lat),
            "ttft_ms": _percentiles(ttft),
            "step_ms_p50": float(np.median(srv.step_ms)),
            "steps": len(srv.step_ms)}


def _timed_rounds(servers, order, requests, warm):
    """Rounds of ``requests`` to ``servers`` ({mode: server}) in ``order``:
    per mode a list of _round_stats, and whether each round's tokens equal
    the warm round's of its mode."""
    stats = {mode: [] for mode in servers}
    equal = {mode: [] for mode in servers}
    for mode in order:
        srv = servers[mode]
        srv.step_ms.clear()
        pf0 = srv.prefill_executions
        outs, wall, lat, ttft = serve_round(srv, requests, SERVER_CLIENTS)
        st = _round_stats(srv, outs, wall, lat, ttft)
        st["prefill_executions"] = srv.prefill_executions - pf0
        stats[mode].append(st)
        equal[mode].append(_same_tokens(outs, warm[mode]))
    return stats, equal


def run_server_spec(pred, cfg, seed, cuda, prompt_range, budget_mix,
                    spec_k):
    """The server_spec line: DecodeServer(speculative=True) and a plain
    server on one predictor under the server phase's traffic; every
    prefill bucket captured first, a warm round each, then timed rounds
    in turns (plain, speculative, speculative, plain). Gates: the
    speculative warm round's tokens within LOGITS_TOL of their rows'
    teacher-forced maxima, every timed round equal to the warm round of
    its mode, the draft and verify steps on the server's own slabs, and
    on the card one more speculative round's device launches: K1 12 a
    prefill, K3 draft_n_layer a draft step, none in a verify step. Tokens
    differing from the plain server's are printed. Returns (line, the
    plain server's warm outputs, the traffic)."""
    from paddle_tpu_torch.serving.decode import DecodeServer

    prompts, budgets = _server_requests(cfg, seed, prompt_range, budget_mix)
    requests = [(p, np.array([b], np.int64))
                for p, b in zip(prompts, budgets)]
    _capture_prefills(pred, [len(p) for p in prompts], SERVER_SEQ)
    servers = {"plain": DecodeServer(pred, slots=SERVER_SLOTS,
                                     max_seq=SERVER_SEQ,
                                     max_new_tokens=max(budgets)),
               "speculative": DecodeServer(pred, slots=SERVER_SLOTS,
                                           max_seq=SERVER_SEQ,
                                           max_new_tokens=max(budgets),
                                           speculative=True,
                                           spec_k=spec_k)}
    for srv in servers.values():
        srv.start()
    spec = servers["speculative"]
    shares = (_shares_slabs(spec._draft, spec._step)
              and _shares_slabs(spec._verify, spec._step))
    warm = {mode: serve_round(srv, requests, SERVER_CLIENTS)[0]
            for mode, srv in servers.items()}
    p0, a0 = _spec_counts()
    stats, equal = _timed_rounds(
        servers, ("plain", "speculative", "speculative", "plain"),
        requests, warm)
    proposed, accepted = (x - y for x, y in zip(_spec_counts(), (p0, a0)))
    res = {"phase": "server_spec", "spec_k": spec_k,
           "draft_n_layer": pred.draft_n_layer, "slots": SERVER_SLOTS,
           "seq": spec.seq, "requests": SERVER_REQUESTS,
           "budgets": list(budget_mix), **stats,
           "acceptance_rate": accepted / max(proposed, 1),
           "rounds_equal_to_warm": equal,
           "draft_verify_share_server_slabs": shares,
           "tokens_differing_from_plain_server": _tokens_differing(
               warm["speculative"], warm["plain"])}
    if cuda:
        spec.step_ms.clear()
        pf0 = spec.prefill_executions
        _device_counts((), reset=True)
        outs = serve_round(spec, requests, SERVER_CLIENTS)[0]
        got = _device_counts(("K1", "K3"), reset=True)
        rounds = len(spec.step_ms)
        res["main_path"] = {
            "device_launches": got, "rounds": rounds,
            "prefill_executions": spec.prefill_executions - pf0,
            "expected": {"K1": cfg.n_layer * (spec.prefill_executions - pf0),
                         "K3": pred.draft_n_layer * spec_k * rounds},
            "equal_to_warm": _same_tokens(outs, warm["speculative"])}
    res["greedy_worst_logit_gap"] = greedy_gate(pred, prompts,
                                                warm["speculative"], budgets)
    for srv in servers.values():
        srv.stop()
    return res, warm["plain"], (prompts, budgets, requests)


def _prefix_traffic(cfg, seed, header_len, question_len, suffix_range):
    """PREFIX_HEADERS system headers of ``header_len`` tokens; one full
    prompt per header (header + a question of ``question_len``); then
    SERVER_REQUESTS requests, every other one an exact repeat of a full
    prompt (full hits) and the rest a header plus a fresh suffix of
    ``suffix_range`` tokens (partial hits, extended through the verify
    window)."""
    rng = np.random.default_rng(seed + 3)
    headers = [rng.integers(0, cfg.vocab_size, header_len)
               for _ in range(PREFIX_HEADERS)]
    full = [np.concatenate([h, rng.integers(0, cfg.vocab_size,
                                            question_len)]).astype(np.int64)
            for h in headers]
    prompts = []
    for i in range(SERVER_REQUESTS):
        h = (i // 2) % PREFIX_HEADERS
        if i % 2 == 0:
            prompts.append(full[h])
        else:
            n = int(rng.integers(suffix_range[0], suffix_range[1] + 1))
            prompts.append(np.concatenate([
                headers[h], rng.integers(0, cfg.vocab_size, n)]).astype(
                    np.int64))
    return full, prompts


def run_prefix(pred, cfg, seed, cuda, budget_mix, header_len, question_len,
               suffix_range, spec_k):
    """The prefix line: a prefix-sharing DecodeServer and a private one
    on one predictor. The shared server first takes the PREFIX_HEADERS
    full prompts one at a time (each a miss: one prefill, one store
    entry), then its warm round of _prefix_traffic's burst of
    SERVER_REQUESTS: that fill and burst is the shared server's main
    path, and on the card the device's K1/K3 launches are zeroed just
    before it and read just after (K1 12 a prefill, K3 12 a decode step,
    none in the verify windows that extend partial hits). Then the
    private server's warm round and timed rounds in turns (shared,
    private, private, shared): tokens/s, TTFT p50/p99, prefill
    executions, the store's hits, entries and bytes. Gates: the shared
    server's prefill executions equal its unique misses in every round
    (queries minus hits), every round equal to the warm round of its
    mode, the shared warm round's tokens within LOGITS_TOL of their rows'
    teacher-forced maxima, and the launches; tokens differing from the
    private server's are printed."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.serving.decode import DecodeServer

    full, prompts = _prefix_traffic(cfg, seed, header_len, question_len,
                                    suffix_range)
    budgets = [budget_mix[i % len(budget_mix)]
               for i in range(len(prompts))]
    requests = [(p, np.array([b], np.int64))
                for p, b in zip(prompts, budgets)]
    _capture_prefills(pred, [len(p) for p in prompts + full], SERVER_SEQ)
    servers = {"shared": DecodeServer(pred, slots=SERVER_SLOTS,
                                      max_seq=SERVER_SEQ,
                                      max_new_tokens=max(budgets),
                                      spec_k=spec_k, prefix_cache=True),
               "private": DecodeServer(pred, slots=SERVER_SLOTS,
                                       max_seq=SERVER_SEQ,
                                       max_new_tokens=max(budgets))}
    for srv in servers.values():
        srv.start()
    shared = servers["shared"]
    store = shared._prefix

    def counts():
        return (obs.DECODE_PREFIX_QUERIES.value(),
                {k: obs.DECODE_PREFIX_HITS.value(kind=k)
                 for k in ("full", "partial", "batch")})

    def misses(before):
        q0, h0 = before
        q1, h1 = counts()
        hits = {k: h1[k] - h0[k] for k in h1}
        return int(q1 - q0 - sum(hits.values())), hits

    # the shared server's main path: the fill, then its warm burst
    shared.step_ms.clear()
    pf_start = shared.prefill_executions
    ext0 = obs.DECODE_STEP_MS.stats(stage="extend")["count"]
    if cuda:
        _device_counts((), reset=True)
    c0, pf0 = counts(), shared.prefill_executions
    for p in full:
        shared.submit((p, np.array([budget_mix[0]], np.int64))).result(
            timeout=600)
    fill_misses, _hits = misses(c0)
    fill_line = {"prompts": len(full),
                 "prefill_executions": shared.prefill_executions - pf0,
                 "unique_misses": fill_misses, "entries": len(store),
                 "store_bytes": store.bytes}
    c0, pf0 = counts(), shared.prefill_executions
    warm = {"shared": serve_round(shared, requests, SERVER_CLIENTS)[0]}
    warm_misses, warm_hits = misses(c0)
    warm_line = {"prefill_executions": shared.prefill_executions - pf0,
                 "unique_misses": warm_misses, "hits": warm_hits}
    prefills = shared.prefill_executions - pf_start
    main_path = {"prefill_executions": prefills,
                 "decode_steps": len(shared.step_ms),
                 "verify_window_calls": obs.DECODE_STEP_MS.stats(
                     stage="extend")["count"] - ext0}
    if cuda:
        main_path["device_launches"] = _device_counts(("K1", "K3"),
                                                      reset=True)
        main_path["expected"] = {
            "K1": cfg.n_layer * prefills,
            "K3": cfg.n_layer * main_path["decode_steps"]}
    warm["private"] = serve_round(servers["private"], requests,
                                  SERVER_CLIENTS)[0]
    c0 = counts()
    stats, equal = _timed_rounds(
        servers, ("shared", "private", "private", "shared"), requests, warm)
    timed_misses, timed_hits = misses(c0)
    res = {"phase": "prefix", "headers": PREFIX_HEADERS,
           "header_len": header_len, "question_len": question_len,
           "suffix_lens": list(suffix_range), "requests": len(prompts),
           "budgets": list(budget_mix), "fill": fill_line,
           "warm_shared": warm_line, "main_path": main_path,
           **stats, "timed_shared_hits": timed_hits,
           "timed_shared_unique_misses": timed_misses,
           "store": {"entries": len(store), "bytes": store.bytes,
                     "max_bytes": store.max_bytes},
           "rounds_equal_to_warm": equal,
           "tokens_differing_from_private": _tokens_differing(
               warm["shared"], warm["private"])}
    res["greedy_worst_logit_gap"] = greedy_gate(pred, prompts,
                                                warm["shared"], budgets)
    for srv in servers.values():
        srv.stop()
    return res


def run_int8(pred, cfg, cuda, traffic, fp32_warm):
    """The int8 line: DecodeServer(kv_dtype="int8") under the server
    phase's traffic: a warm round, two timed rounds (tokens/s, step ms
    p50), its slab GB against the fp32 server's; on the card one round's
    device launches (12 K3 a decode step, K1 12 a prefill). Gate: one
    decode step of the server's own step, replayed, against the same
    step run op by op with the plain attention on the same int8 slabs,
    logits within LOGITS_TOL. The share of tokens equal to the fp32
    server's is printed."""
    import torch
    from paddle_tpu_torch.serving.decode import DecodeServer

    prompts, budgets, requests = traffic
    srv = DecodeServer(pred, slots=SERVER_SLOTS, max_seq=SERVER_SEQ,
                       max_new_tokens=max(budgets), kv_dtype="int8")
    srv.start()
    slab_gb = sum(t.numel() * t.element_size() for t in srv._slabs) / 1e9
    fp32_gb = sum(t.numel() * 4 for t in srv._slabs
                  if t.dtype == torch.int8) / 1e9
    warm = serve_round(srv, requests, SERVER_CLIENTS)[0]
    stats, equal = _timed_rounds({"int8": srv}, ("int8", "int8"), requests,
                                 {"int8": warm})
    res = {"phase": "int8", "slots": SERVER_SLOTS, "seq": srv.seq,
           "requests": SERVER_REQUESTS, **stats,
           "rounds_equal_to_warm": equal["int8"],
           "slab_gb": slab_gb, "fp32_slab_gb": fp32_gb,
           "share_of_tokens_equal_to_fp32_server": float(np.mean(
               [t == u for a, b in zip(warm, fp32_warm)
                for t, u in zip(a, b)]))}
    if cuda:
        srv.step_ms.clear()
        pf0 = srv.prefill_executions
        _device_counts((), reset=True)
        serve_round(srv, requests, SERVER_CLIENTS)
        got = _device_counts(("K1", "K3"), reset=True)
        steps = len(srv.step_ms)
        res["main_path"] = {
            "device_launches": got, "decode_steps": steps,
            "expected": {"K1": cfg.n_layer * (srv.prefill_executions - pf0),
                         "K3": cfg.n_layer * steps}}
    # one decode step on the slabs as the rounds left them, replayed and
    # then op by op with the plain attention: appending the same row
    # twice writes the same int8 row and scale
    step = srv._step
    rng = np.random.default_rng(0)
    lens = rng.integers(1, srv.seq - 1, SERVER_SLOTS).astype(np.int32)
    feeds = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (SERVER_SLOTS, 1)).astype(np.int64),
             "positions": lens.reshape(-1, 1).astype(np.int64),
             "lengths": lens, "seed": np.zeros((1,), np.int64)}
    feeds.update(zip(srv._cache_feed_names, srv._slabs))
    fetch = (lambda outs: outs[1].float().clone())
    graph = step(feeds, read=fetch)
    with plain_attention():
        plain = step.run_eager(feeds, read=fetch)
    res["step_vs_plain_max_abs"] = float((graph - plain).abs().max())
    srv.stop()
    return res


def run_beam(pred, prompts, max_new, beam_size, cuda):
    """The beam line: generate_beam(beam_size) on ``prompts`` (beam batch
    pow2(len * beam_size)): ms per step p50 (the decode step, the beam
    step and the slabs' reorder), and on the card the device's launches
    of one call (12 K3 a step, 12 K1). Gates: beam_size=1 equals greedy,
    each prompt's beam scores in order, the best beam's score equal to
    its teacher-forced log-probability sum within LOGITS_TOL, the
    launches."""
    import torch

    ids, lens, scores = pred.generate_beam(prompts, max_new,
                                           beam_size=beam_size,
                                           return_all=True)
    steps = list(pred.timings["step"])
    best = ids[:, 0, :]
    logits = teacher_forced_logits(pred, prompts, best, max_new)
    lp = torch.log_softmax(logits, dim=-1).gather(
        2, torch.from_numpy(best.astype(np.int64)).to(logits.device)[
            ..., None])[..., 0]
    tf_sum = lp.sum(dim=1).cpu().numpy()
    one = pred.generate(prompts, max_new, strategy="beam", beam_size=1)
    greedy = pred.generate(prompts, max_new)
    from paddle_tpu_torch.serving.decode import _pow2_bucket

    bk = _pow2_bucket(len(prompts) * beam_size)
    slab_gb = sum(t.numel() * t.element_size() for t in pred._slabs(
        pred.acquire("decode", bk, pred._bucketed(prompts, max_new)[3],
                     "logits")[0])) / 1e9
    res = {"phase": "beam", "prompts": [len(p) for p in prompts],
           "beam_size": beam_size, "max_new": max_new,
           "step_ms_p50": float(np.median(steps)), "steps": len(steps),
           "reorder_gb_per_step": 2 * slab_gb,
           "scores": scores.tolist(), "lengths": lens.tolist(),
           "scores_ordered": bool(np.all(np.diff(scores, axis=1) <= 0)),
           "best_vs_teacher_forced_max_abs": float(np.abs(
               tf_sum - scores[:, 0]).max()),
           "beam1_equals_greedy": _same_tokens(one, greedy)}
    if cuda:
        _device_counts((), reset=True)
        pred.generate_beam(prompts, max_new, beam_size=beam_size)
        res["device_launches"] = _device_counts(("K1", "K3"), reset=True)
        res["expected"] = {"K1": pred.config.n_layer,
                           "K3": pred.config.n_layer * (max_new - 1)}
    return res


def run_decode_features(config, prompt_lens, max_new, seed, place, workdir,
                        server_prompts=SERVER_PROMPT_LENS,
                        budget_mix=SERVER_BUDGETS,
                        prefix_sizes=(PREFIX_HEADER_LEN, PREFIX_QUESTION_LEN,
                                      PREFIX_SUFFIX_LENS),
                        beam_new=BEAM_NEW):
    """Phases 11-15 on the serving config, random weights from ``seed``
    (the slice's, and its prompts): the speculative, server_spec,
    prefix, int8 and beam lines, each with its seconds; every gate
    checked here (launch counts on the card). Runs on any place (the
    CPU tests rehearse it at a tiny size)."""
    import torch
    from paddle_tpu_torch.serving.decode import DecodeConfig, DecodePredictor

    cuda = torch.device(place.torch_device()).type == "cuda"
    cfg = DecodeConfig(**config)
    params = init_params(cfg, seed)
    t0 = time.perf_counter()
    dirs = {"random": _export(workdir, "features_model", cfg, params),
            "favourable": _export(workdir, "favourable_model", cfg,
                                  favourable_params(params, DRAFT_LAYERS))}
    del params
    preds = {name: DecodePredictor(d, place=place,
                                   draft_n_layer=DRAFT_LAYERS)
             for name, d in dirs.items()}
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int64)
               for n in prompt_lens]
    lines = {}
    t1 = time.perf_counter()
    sp = run_speculative(preds, prompts, max_new, SPEC_K, cuda)
    lines["speculative"] = {"phase": "speculative", "spec_k": SPEC_K,
                            "draft_n_layer": DRAFT_LAYERS,
                            "prompts": len(prompts), "max_new": max_new,
                            "setup_s": t1 - t0, **sp}
    fav = preds.pop("favourable")
    del fav
    pred = preds["random"]
    if cuda:
        torch.cuda.empty_cache()
    lines["speculative"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lines["server_spec"], fp32_warm, traffic = run_server_spec(
        pred, cfg, seed, cuda, server_prompts, budget_mix, SPEC_K)
    lines["server_spec"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lines["prefix"] = run_prefix(pred, cfg, seed, cuda, budget_mix,
                                 *prefix_sizes, SPEC_K)
    lines["prefix"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lines["int8"] = run_int8(pred, cfg, cuda, traffic, fp32_warm)
    lines["int8"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lines["beam"] = run_beam(pred, prompts[:BEAM_PROMPTS], beam_new,
                             BEAM_SIZE, cuda)
    lines["beam"]["seconds"] = time.perf_counter() - t0
    del pred, preds
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    if cuda:
        torch.cuda.empty_cache()
    bad = []
    for name, res in lines["speculative"].items():
        if not isinstance(res, dict):
            continue
        if res["greedy_worst_logit_gap"] > LOGITS_TOL:
            bad.append("speculative (%s): a token is %.3g below its row's "
                       "maximum" % (name, res["greedy_worst_logit_gap"]))
        if not res["equal_to_first"] or \
                not res["draft_verify_share_decode_slabs"]:
            bad.append("speculative (%s): a timed call changed its tokens "
                       "or a step copies the slabs" % name)
        if cuda and (res["device_launches"] != res["expected"]
                     or res["verify_step_launches"] != {"K1": 0, "K3": 0}
                     or res["draft_step_launches"] != {
                         "K1": 0, "K3": DRAFT_LAYERS}):
            bad.append("speculative (%s): launches %s, draft %s, verify %s;"
                       " expected %s" % (name, res["device_launches"],
                                         res["draft_step_launches"],
                                         res["verify_step_launches"],
                                         res["expected"]))
    fav_rate = lines["speculative"]["favourable"]["acceptance_rate"]
    if fav_rate < SPEC_FAVOURABLE_ACCEPTANCE:
        bad.append("speculative: acceptance %.3f on the favourable export"
                   % fav_rate)
    ss = lines["server_spec"]
    if ss["greedy_worst_logit_gap"] > LOGITS_TOL:
        bad.append("server_spec: a token is %.3g below its row's maximum"
                   % ss["greedy_worst_logit_gap"])
    if not all(ok for oks in ss["rounds_equal_to_warm"].values()
               for ok in oks) or not ss["draft_verify_share_server_slabs"]:
        bad.append("server_spec: a round differs from the warm one, or a "
                   "step copies the slabs")
    if cuda and (ss["main_path"]["device_launches"]
                 != ss["main_path"]["expected"]
                 or not ss["main_path"]["equal_to_warm"]):
        bad.append("server_spec: the round launched %s, expected %s"
                   % (ss["main_path"]["device_launches"],
                      ss["main_path"]["expected"]))
    px = lines["prefix"]
    if px["greedy_worst_logit_gap"] > LOGITS_TOL:
        bad.append("prefix: a token is %.3g below its row's maximum"
                   % px["greedy_worst_logit_gap"])
    if px["fill"]["prefill_executions"] != px["fill"]["unique_misses"] or \
            px["warm_shared"]["prefill_executions"] != \
            px["warm_shared"]["unique_misses"] or \
            px["timed_shared_unique_misses"] != sum(
                st["prefill_executions"] for st in px["shared"]):
        bad.append("prefix: prefill executions differ from unique misses")
    if not all(ok for oks in px["rounds_equal_to_warm"].values()
               for ok in oks):
        bad.append("prefix: a round differs from the warm one")
    pm = px["main_path"]
    if pm["verify_window_calls"] < 1 or pm["prefill_executions"] != \
            px["fill"]["unique_misses"] + px["warm_shared"]["unique_misses"]:
        bad.append("prefix: the main path made %d verify window calls and "
                   "%d prefills for %d unique misses" % (
                       pm["verify_window_calls"], pm["prefill_executions"],
                       px["fill"]["unique_misses"]
                       + px["warm_shared"]["unique_misses"]))
    if cuda and pm["device_launches"] != pm["expected"]:
        bad.append("prefix: the main path launched %s, expected %s"
                   % (pm["device_launches"], pm["expected"]))
    q8 = lines["int8"]
    if q8["step_vs_plain_max_abs"] > LOGITS_TOL or \
            not all(q8["rounds_equal_to_warm"]):
        bad.append("int8: step vs plain %.3g, or a round differs from the "
                   "warm one" % q8["step_vs_plain_max_abs"])
    if cuda and q8["main_path"]["device_launches"] != \
            q8["main_path"]["expected"]:
        bad.append("int8: the round launched %s, expected %s"
                   % (q8["main_path"]["device_launches"],
                      q8["main_path"]["expected"]))
    bm = lines["beam"]
    if not (bm["beam1_equals_greedy"] and bm["scores_ordered"]) or \
            bm["best_vs_teacher_forced_max_abs"] > LOGITS_TOL:
        bad.append("beam: beam 1 = greedy %s, ordered %s, best vs "
                   "teacher-forced %.3g" % (
                       bm["beam1_equals_greedy"], bm["scores_ordered"],
                       bm["best_vs_teacher_forced_max_abs"]))
    if cuda and bm["device_launches"] != bm["expected"]:
        bad.append("beam: launched %s, expected %s"
                   % (bm["device_launches"], bm["expected"]))
    if bad:
        fail("decode features: %s: %s" % ("; ".join(bad), json.dumps(
            lines, default=str)))
    return lines


def bucketed_prefill_export(model_dir, cfg, params, seq):
    """The LM's prefill as an inference export whose batch axis buckets:
    tokens (-1, seq), every row a full-length prompt, out the logits of
    its last position (the serving graph's layers and parameter names;
    the last row taken by a transpose and a gather, which keep rows apart,
    where transformer_lm_prefill gathers with per-row offsets that fix
    the batch). Stamped for bucketize (``program._bucketize``: batches
    pad to pow2 buckets), as the optimizing transpiler stamps a row-wise
    export; the stamp is set by hand, the transpiler is not ported."""
    from paddle_tpu_torch import (Program, Scope, io, layers, program_guard,
                                  unique_name)
    from paddle_tpu_torch.models import transformer as T

    prog, startup = Program(), Program()
    with program_guard(prog, startup):
        with unique_name.guard():
            tokens = layers.data(name="tokens", shape=[-1, seq],
                                 dtype="int64", append_batch_size=False)
            x = T._embed(tokens, cfg.vocab_size, cfg.d_model, cfg.max_len,
                         "lm")
            for i in range(cfg.n_layer):
                attn, _k, _v = T._cached_self_attention(
                    T._pre_norm(x), cfg.n_head, cfg.d_model,
                    "lm.l%d.self" % i)
                x = layers.elementwise_add(x, attn)
                x = layers.elementwise_add(x, T.positionwise_ffn(
                    T._pre_norm(x), cfg.d_inner, cfg.d_model, 0.0,
                    name="lm.l%d.ffn" % i))
            x = T._pre_norm(x)
            last = layers.gather(layers.transpose(x, perm=[1, 0, 2]),
                                 layers.assign(np.array([seq - 1],
                                                        np.int64)))
            logits = T._lm_head_logits(
                layers.reshape(last, shape=[-1, cfg.d_model]),
                cfg.vocab_size, False, "lm")
    prog._bucketize = {"feeds": ["tokens"], "fetches": [logits.name]}
    scope = Scope()
    for name, val in params.items():
        scope.set_var(name, val)
    io.save_inference_model(model_dir, ["tokens"], [logits], None,
                            main_program=prog, scope=scope)


def run_predictor_server(config, seed, place, workdir, seq=PSERVER_SEQ):
    """The predictor_server line: PredictorServer(max_batch=
    PSERVER_MAX_BATCH) over the LM's prefill exported with a bucketing
    batch axis (bucketed_prefill_export, random weights from ``seed``),
    PSERVER_REQUESTS single-row requests from SERVER_CLIENTS threads, one
    warm round, then a timed one: rows/s, request latency (p50, p99),
    bucket fill, builds and captures at prewarm (one build and one
    capture per bucket) and in traffic (none), and every row against
    Predictor.run's on the same rows (batches of PSERVER_MAX_BATCH),
    within LOGITS_TOL. The export is held to the LM: Predictor.run's rows
    against the last-position logits of the DecodePredictor prefill
    (the serving graph) on the same rows and weights, within
    LOGITS_TOL."""
    import torch
    from paddle_tpu_torch import Scope
    from paddle_tpu_torch.inference import Predictor, PredictorServer
    from paddle_tpu_torch.serving.decode import (DecodeConfig,
                                                 DecodePredictor,
                                                 save_decode_model)

    cfg = DecodeConfig(**config)
    t0 = time.perf_counter()
    model_dir = os.path.join(workdir, "pserver_model")
    params = init_params(cfg, seed)
    bucketed_prefill_export(model_dir, cfg, params, seq)
    p = Predictor(model_dir, place=place)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 3)
    rows = rng.integers(0, cfg.vocab_size,
                        (PSERVER_REQUESTS, seq)).astype(np.int64)
    traces0 = p.traces
    srv = PredictorServer(p, max_batch=PSERVER_MAX_BATCH)
    t0 = time.perf_counter()
    srv.start()
    prewarm_s = time.perf_counter() - t0
    prewarm_traces = p.traces - traces0
    requests = [(r,) for r in rows]
    serve_round(srv, requests, SERVER_CLIENTS)
    srv.batch_size_counts.clear()
    traces1 = p.traces
    outs, wall, lat, _ = serve_round(srv, requests, SERVER_CLIENTS)
    srv.stop()
    want = np.concatenate([p.run([rows[i:i + PSERVER_MAX_BATCH]])[0]
                           for i in range(0, len(rows),
                                          PSERVER_MAX_BATCH)])
    # the export against the LM's own prefill: same rows, same weights
    decode_dir = os.path.join(workdir, "pserver_decode_model")
    scope = Scope()
    for name, val in params.items():
        scope.set_var(name, val)
    save_decode_model(decode_dir, cfg, None, scope=scope)
    del scope, params
    dec = DecodePredictor(decode_dir, place=place)
    lm = []
    for i in range(0, len(rows), PSERVER_MAX_BATCH):
        chunk = rows[i:i + PSERVER_MAX_BATCH]
        lm.append(dec._prefill(chunk, np.full(len(chunk), seq, np.int32),
                               seq).cpu().numpy())
    vs_lm = float(np.abs(want - np.concatenate(lm)).max())
    del dec, lm
    shutil.rmtree(decode_dir, ignore_errors=True)
    counts = dict(srv.batch_size_counts)
    real = sum(n * c for n, c in counts.items())
    padded = sum(srv._bucket_for(n) * c for n, c in counts.items())
    err = float(np.abs(np.stack(outs) - want).max())
    res = {"phase": "predictor_server", "config": config,
           "export": [-1, seq], "buckets": srv.buckets,
           "requests": PSERVER_REQUESTS, "clients": SERVER_CLIENTS,
           "setup_s": setup_s, "prewarm_s": prewarm_s,
           "rows_per_s": PSERVER_REQUESTS / wall,
           "latency_ms": _percentiles(lat),
           "batch_size_counts": {str(k): v for k, v in sorted(
               counts.items())},
           "bucket_fill": real / padded,
           "prewarm_builds_and_captures": prewarm_traces,
           "traffic_builds_and_captures": p.traces - traces1,
           "vs_predictor_run_max_abs": err,
           "predictor_run_vs_decode_prefill_max_abs": vs_lm,
           "tol": LOGITS_TOL,
           "finite": bool(np.isfinite(np.stack(outs)).all())}
    cuda = p.device.type == "cuda"
    want_prewarm = len(srv.buckets) * (2 if cuda else 1)
    if not (res["finite"] and err <= LOGITS_TOL and vs_lm <= LOGITS_TOL
            and prewarm_traces == want_prewarm
            and res["traffic_builds_and_captures"] == 0):
        fail("predictor_server check failed: %s" % json.dumps(res))
    del p, srv
    shutil.rmtree(model_dir, ignore_errors=True)
    if cuda:
        torch.cuda.empty_cache()
    return res


def profile_generate(pred, prompts, max_new, out_dir,
                     table="generate_ops.txt"):
    """One more generate call under torch.profiler (see profile_call);
    the op tables land in ``out_dir``/``table``."""
    return profile_call(
        lambda: pred.generate(prompts, max_new_tokens=max_new),
        os.path.join(out_dir, table))


@functools.lru_cache(maxsize=None)
def port_kernels():
    """{source: (kernel names)}: every __global__ function that the port's
    CUDA sources (paddle_tpu_torch/csrc/*.cu) declare, by source name."""
    csrc = os.path.join(_ROOT, "paddle_tpu_torch", "csrc")
    decl = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*"
                      r"\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")
    found = {}
    for fname in sorted(os.listdir(csrc)):
        if fname.endswith(".cu"):
            with open(os.path.join(csrc, fname)) as f:
                found[fname[:-3]] = tuple(decl.findall(f.read()))
    return found


def _port_source(name):
    """The port's source whose kernel the profiler's ``name`` is (its
    demangled name carries the declared one), or None."""
    for src, kernels in port_kernels().items():
        if any(re.search(r"\b%s\b" % k, name) for k in kernels):
            return src
    return None


# the kernels that move tokens by index: the MoE routing, dispatch and
# combine (argmax, cumsum, gather, index_put, index_select and their
# backward), and with them every other indexing kernel of the step
# (embedding lookups and their backward)
ROUTING_WORDS = ("index", "scatter", "gather", "scan", "argmax", "cumsum")


def _kernel_kind(name, routing=False):
    """products (cuBLAS/CUTLASS matrix products), attention (the port's
    hand-written kernels: every kernel its csrc/ sources declare), with
    ``routing`` the indexing kernels (ROUTING_WORDS), or other
    (elementwise, reductions, copies)."""
    if _port_source(name) is not None:
        return "attention"
    low = name.lower()
    if any(w in low for w in ("gemm", "xmma", "cutlass", "cublas",
                              "nvjet")):
        return "products"
    if routing and any(w in low for w in ROUTING_WORDS):
        return "routing"
    return "other"


def profile_call(fn, table_path, routing=False):
    """One call of ``fn`` under torch.profiler: the device's busy time (the
    sum of its kernels and copies), the call's wall time, the idle share
    they give (both from this one call; the profiler slows the host, so
    an unprofiled call idles less), busy time by kind of kernel, and the
    kernels and host ops that take the most. Writes both op tables to
    ``table_path``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    by_kind = {"products": 0.0, "attention": 0.0, "other": 0.0}
    if routing:
        by_kind["routing"] = 0.0
    by_source, by_kernel = {}, {}
    for e in dev:
        ms = e.self_device_time_total / 1e3
        by_kind[_kernel_kind(e.key, routing)] += ms
        src = _port_source(e.key)
        if src is not None:
            got = by_source.setdefault(src, {"device_ms": 0.0,
                                             "launches": 0})
            got["device_ms"] += ms
            got["launches"] += e.count
            for sym in port_kernels()[src]:
                if re.search(r"\b%s\b" % sym, e.key):
                    by_kernel[sym] = by_kernel.get(sym, 0) + e.count
    host_calls = {"kernel_launches": 0, "graph_launches": 0}
    for e in host:
        if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            host_calls["kernel_launches"] += e.count
        elif e.key.startswith("cudaGraphLaunch"):
            host_calls["graph_launches"] += e.count
    with open(table_path, "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=40))
        f.write("\n")
        f.write(events.table(sort_by="self_cpu_time_total", row_limit=40))
    return {
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_ms_by_kind": by_kind,
        "port_kernels": by_source,
        "kernel_launches": by_kernel,
        "host_launch_calls": host_calls,
        "device_top": [[e.key[:80], e.count, e.self_device_time_total / 1e3]
                       for e in dev[:15]],
        "host_top": [[e.key[:80], e.count, e.self_cpu_time_total / 1e3]
                     for e in host[:15]],
    }


# ---------------------------------------------------------------------------
# phase 4: the training slice at full width
# ---------------------------------------------------------------------------


def build_train(config, batch, seq, lr, seed, amp_level=None):
    """transformer_lm + Adam(lr).minimize, built as a user would, then,
    with ``amp_level``, set to bf16 AMP as bench.py sets it (minimize
    first, then enable_mixed_precision): returns (main, startup, loss)."""
    from paddle_tpu_torch import (Program, layers, optimizer, program_guard,
                                  unique_name)
    from paddle_tpu_torch.models import transformer

    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = seed
    with program_guard(main, startup), unique_name.guard():
        ids = layers.data(name="ids", shape=[batch, seq], dtype="int64",
                          append_batch_size=False)
        labels = layers.data(name="labels", shape=[batch, seq],
                             dtype="int64", append_batch_size=False)
        loss, _ = transformer.transformer_lm(ids, labels, **config)
        optimizer.Adam(learning_rate=lr).minimize(loss)
        if amp_level:
            main.enable_mixed_precision(level=amp_level)
    return main, startup, loss


FP32_KERNELS = ("K1", "K2-dq", "K2-dkv", "K4")
BF16_KERNELS = ("K1-bf16", "K2-dq-bf16", "K2-dkv-bf16", "K4-bf16")
# each kernel's __global__ name in the port's sources (port_kernels()),
# which the profiler's kernel names carry
KERNEL_SYMBOLS = {"K1": "flash_fwd_kernel", "K2-dq": "flash_bwd_dq_kernel",
                  "K2-dkv": "flash_bwd_dkv_kernel",
                  "K4": "flash_bwd_fused_kernel",
                  "K1-bf16": "flash_fwd_bf16_kernel",
                  "K2-dq-bf16": "flash_bwd_dq_bf16_kernel",
                  "K2-dkv-bf16": "flash_bwd_dkv_bf16_kernel",
                  "K4-bf16": "flash_bwd_fused_bf16_kernel",
                  "K3": "decode_attn_kernel"}
# each kernel's launch counter on the device (csrc/launch_count.cuh): its
# library and its place in the order its source declares the kernels
KERNEL_COUNTERS = {"K1": ("flash_fwd", 0), "K2-dq": ("flash_bwd", 0),
                   "K2-dkv": ("flash_bwd", 1), "K4": ("flash_bwd_fused", 0),
                   "K1-bf16": ("flash_fwd_bf16", 0),
                   "K2-dq-bf16": ("flash_bwd_bf16", 0),
                   "K2-dkv-bf16": ("flash_bwd_bf16", 1),
                   "K4-bf16": ("flash_bwd_fused_bf16", 0),
                   "K3": ("decode_attn", 0)}


def _device_counts(keys, reset=False):
    """The launches of the kernels ``keys`` since the counters were last
    zeroed, as the device counts them: inside a graph's replay too, where
    the wrappers' host counts see nothing, and exactly, where a profiler
    now and then loses a kernel's record. ``reset`` zeroes every kernel's
    counter after the read. Synchronizes the device first."""
    import torch
    from paddle_tpu_torch.kernels import launch_counts

    torch.cuda.synchronize()
    got = {src: launch_counts(src, reset=reset)
           for src in sorted({src for src, _ in KERNEL_COUNTERS.values()})}
    return {k: got[KERNEL_COUNTERS[k][0]][KERNEL_COUNTERS[k][1]]
            for k in keys}


def _launch_counts(reset=False, keys=FP32_KERNELS):
    from paddle_tpu_torch.ops import attention as A

    wrappers = {"K1": A.flash_attention_fwd, "K2-dq": A.flash_attention_bwd_dq,
                "K2-dkv": A.flash_attention_bwd_dkv,
                "K4": A.flash_attention_bwd_fused,
                "K1-bf16": A.flash_attention_fwd_bf16,
                "K2-dq-bf16": A.flash_attention_bwd_dq_bf16,
                "K2-dkv-bf16": A.flash_attention_bwd_dkv_bf16,
                "K4-bf16": A.flash_attention_bwd_fused_bf16}
    if reset:
        for w in wrappers.values():
            w.launches = 0
    return {k: wrappers[k].launches for k in keys}


def compare_steps(got, ref, lr, grad_rtol=GRAD_RTOL):
    """One training step against another from the same state: the loss,
    every @GRAD and every updated parameter, with the tolerances stated at
    the top of this file. Returns the measured errors and ``ok``."""
    import torch

    (lg, gg, pg), (lr_, gr, pr) = got, ref
    big = max(float(g.abs().max()) for g in gr.values())
    res = {"loss": float(lg), "ref_loss": float(lr_),
           "loss_rel_err": abs(float(lg) - float(lr_)) / abs(float(lr_))}
    worst, bad, errs, zero = (0.0, None), [], [], 0.0
    for name in gr:
        a, b = gg[name], gr[name]
        finite = bool(torch.isfinite(a).all())
        if name.endswith(".k.b@GRAD"):
            err = max(float(a.abs().max()), float(b.abs().max())) / big
            tol = ZERO_GRAD_TOL
            zero = max(zero, err / tol)
        else:
            err = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                   1e-30)
            tol = grad_rtol
            errs.append(err)
        if err / tol > worst[0]:
            worst = (err / tol, name)
        if not finite or err > tol:
            bad.append((name, err, tol, finite))
    res["grad_rtol"] = grad_rtol
    res["grad_rel_err_median"] = float(np.median(errs))
    res["grad_worst_share_of_tol"], res["grad_worst"] = worst
    res["grad_rel_err_max"] = float(max(errs))
    res["zero_grad_worst_share_of_tol"] = zero
    res["param_max_abs_err"] = max(float((pg[n] - pr[n]).abs().max())
                                   for n in pr)
    res["param_tol"] = lr / 10
    res["grads_over_tol"] = bad[:5]
    res["ok"] = (not bad and res["loss_rel_err"] <= LOSS_RTOL
                 and res["param_max_abs_err"] <= lr / 10
                 and all(bool(torch.isfinite(p).all()) for p in pg.values()))
    return res


def _dist(a, b):
    return float((a.double() - b.double()).norm())


def _global_rel(got, ref):
    """sqrt(sum |got - ref|^2) / sqrt(sum |ref|^2) over the dicts' tensors."""
    num = sum(_dist(got[n], ref[n]) ** 2 for n in ref)
    den = sum(float(ref[n].double().norm()) ** 2 for n in ref)
    return (num / den) ** 0.5


def compare_amp(got, ref, far, lr):
    """bf16 AMP step ``got`` against step ``ref`` relative to ``ref``'s
    distance from step ``far`` (the fp32 step), with the gates stated at
    the top of this file. Returns the ratios and ``ok``."""
    import torch

    (lg, gg, pg), (lr_, gr, pr), (lf, gf, pf) = got, ref, far
    big = max(float(g.abs().max()) for g in gr.values())
    res = {"loss": float(lg), "ref_loss": float(lr_), "fp32_loss": float(lf),
           "loss_ratio": abs(float(lg) - float(lr_))
           / max(abs(float(lr_) - float(lf)), 1e-30),
           "rho": {"loss": AMP_LOSS_RHO, "global": AMP_RHO,
                   "each": AMP_RHO_EACH, "far": AMP_FAR}}
    bad, zero, zero_p = [], 0.0, 0.0
    if not res["loss_ratio"] <= AMP_LOSS_RHO:
        bad.append(("loss", res["loss_ratio"]))
    for key, a_, b_, e_ in (("grad", gg, gr, gf), ("param", pg, pr, pf)):
        each, num, den, far_num = {}, 0.0, 0.0, 0.0
        for name in b_:
            a, b, e = a_[name], b_[name], e_[name]
            if not bool(torch.isfinite(a).all()):
                bad.append((name, "not finite"))
            if name.endswith(".k.b@GRAD"):
                zero = max(zero, float(a.abs().max()) / big)
                continue
            if name.endswith(".k.b"):
                zero_p = max(zero_p, float((a - b).abs().max()))
                continue
            ab, be = _dist(a, b), _dist(b, e)
            each[name] = ab / max(be, 1e-30)
            num, den = num + ab ** 2, den + be ** 2
            far_num += _dist(a, e) ** 2
            if each[name] > AMP_RHO_EACH:
                bad.append((name, each[name]))
        worst = max(each, key=each.get)
        res["%s_ratio_global" % key] = (num / den) ** 0.5
        res["%s_far_ratio" % key] = (far_num / den) ** 0.5
        res["%s_ratio_median" % key] = float(np.median(list(each.values())))
        res["%s_ratio_max" % key], res["%s_worst" % key] = each[worst], worst
        if res["%s_ratio_global" % key] > AMP_RHO:
            bad.append((key + " global", res["%s_ratio_global" % key]))
        if res["%s_far_ratio" % key] > AMP_FAR:
            bad.append((key + " far", res["%s_far_ratio" % key]))
    res["zero_grad_share_of_largest"] = zero
    res["zero_grad_tol"] = AMP_ZERO_GRAD_TOL
    res["k_bias_param_max_abs_diff"] = zero_p
    if zero > AMP_ZERO_GRAD_TOL:
        bad.append(("k.b@GRAD", zero))
    if zero_p > 2 * lr:
        bad.append(("k.b", zero_p))
    res["failed"] = bad[:5]
    res["ok"] = not bad
    return res


def run_train(config, batch, seq, lr, warm, steps, seed, place, workdir):
    """Train ``config`` as a user would (build, startup, Executor.run step
    after step on one seeded batch, as bench.py does): each step one
    replay of its CUDA graph, timed in turns against the same step run
    op by op (eager_steps()), with a profiled step of each; the main
    path's run is the profiled graph step. Then, from one saved state:
    the kernel step through its graph and op by op (held against each
    other: graph_vs_eager), op by op with the plain attention forward and
    backward and with K1's forward and the plain backward, and through
    graphs with PADDLE_TPU_FLASH_FUSED_BWD=1 and in the BHTD layout
    (PADDLE_TPU_ATTN_BTHD=0), each compared with the kernel step. Runs on
    any place (the CPU tests rehearse it at a tiny size); the caller
    checks the kernel launch counts."""
    from paddle_tpu_torch import Executor, Scope

    t0 = time.perf_counter()
    main, startup, loss = build_train(config, batch, seq, lr, seed)
    exe, scope = Executor(place), Scope()
    exe.run(startup, scope=scope)
    t = _Trainer(exe, scope, main, loss, config, batch, seq, seed,
                 FP32_KERNELS, workdir)
    res = {"phase": "train", "config": config, "batch": batch, "seq": seq,
           "lr": lr, "params": t.n_params}
    res.update(t.timed_turns(warm, steps, "train_step", t0))
    saved = t.saved
    nothing = contextlib.nullcontext
    kernel, _ = t.one_step(main, saved, nothing())
    eager, res["kernel_eager_launches"] = t.one_step(main, saved, nothing(),
                                                     eager=True)
    res["graph_vs_eager"] = graph_vs_eager(kernel, eager, compare_steps(
        kernel, eager, lr))
    del eager
    plain, res["plain_launches"] = t.one_step(main, saved,
                                              plain_attention(), eager=True)
    res["kernels_vs_plain"] = compare_steps(kernel, plain, lr,
                                            PATH_GRAD_RTOL)
    del plain
    plain_bwd, res["plain_bwd_launches"] = t.one_step(
        main, saved, plain_attention(forward_kernel=True), eager=True)
    res["bwd_kernels_vs_plain_bwd"] = compare_steps(kernel, plain_bwd, lr)
    del plain_bwd
    fused_env = functools.partial(env_set, "PADDLE_TPU_FLASH_FUSED_BWD", "1")
    fused, _ = t.one_step(main, saved, fused_env())
    res["fused_bwd_vs_kernels"] = compare_steps(fused, kernel, lr)
    res["fused_bwd_launches"] = t.replay_launches(main, fused_env())
    del fused
    with env_set("PADDLE_TPU_ATTN_BTHD", "0"):
        main_bhtd, _, _ = build_train(config, batch, seq, lr, seed)
    bhtd, _ = t.one_step(main_bhtd, saved, nothing())
    res["bhtd_vs_bthd"] = compare_steps(bhtd, kernel, lr)
    res["bhtd_launches"] = t.replay_launches(main_bhtd, nothing())
    del bhtd, kernel
    res["step_cache"] = t.cache_line()
    for key in ("graph_vs_eager", "kernels_vs_plain",
                "bwd_kernels_vs_plain_bwd", "fused_bwd_vs_kernels",
                "bhtd_vs_bthd"):
        if not res[key]["ok"]:
            fail("training step %s failed: %s" % (key, json.dumps(res[key])))
    exe.close()
    return res


def run_train_amp(config, batch, seq, lr, warm, steps, seed, place,
                  workdir):
    """Train ``config`` as bench.py trains it: built and minimized, then
    set to bf16 AMP O2, stepped by Executor.run on one seeded batch, each
    step a replay of its CUDA graph, timed in turns against the same step
    op by op, with a profiled step of each (the main path's run: the
    graph step). Then, from one saved state: (a) the kernel step through
    its graph, and op by op (graph_vs_eager); (b) the same program with
    the plain bf16 attention forward and backward, op by op; (c) the
    kernel step with PADDLE_TPU_FLASH_FUSED_BWD=1; (d) the O1 program;
    (e) the fp32 program ((c), (d), (e) through graphs). (a) and (c) are
    held against (b) relative to (b)'s distance from (e) (compare_amp);
    (c) replayed once more under the profiler (profile_fused_bwd). Runs
    on any place (the CPU tests rehearse it at a tiny size); the caller
    checks the kernel launch counts."""
    import torch
    from paddle_tpu_torch import Executor, Scope

    keys = FP32_KERNELS + BF16_KERNELS
    t0 = time.perf_counter()
    main, startup, loss = build_train(config, batch, seq, lr, seed, "O2")
    exe, scope = Executor(place), Scope()
    exe.run(startup, scope=scope)
    t = _Trainer(exe, scope, main, loss, config, batch, seq, seed, keys,
                 workdir)
    res = {"phase": "train_amp", "amp_level": "O2", "config": config,
           "batch": batch, "seq": seq, "lr": lr}
    res.update(t.timed_turns(warm, steps, "train_amp_step", t0))
    for var in main.list_vars():
        val = scope.find_var(var.name) if var.persistable else None
        if val is not None and val.is_floating_point() and \
                val.dtype != torch.float32:
            fail("AMP state %s is %s, not fp32" % (var.name, val.dtype))

    saved = t.saved
    nothing = contextlib.nullcontext
    kernel, _ = t.one_step(main, saved, nothing())
    eager, res["kernel_eager_launches"] = t.one_step(main, saved, nothing(),
                                                     eager=True)
    plain, res["plain_launches"] = t.one_step(main, saved,
                                              plain_attention(), eager=True)
    fused_env = functools.partial(env_set, "PADDLE_TPU_FLASH_FUSED_BWD", "1")
    fused, _ = t.one_step(main, saved, fused_env())
    res["fused_bwd_launches"] = t.replay_launches(main, fused_env())
    main_o1 = build_train(config, batch, seq, lr, seed, "O1")[0]
    o1, _ = t.one_step(main_o1, saved, nothing())
    res["o1_launches"] = t.replay_launches(main_o1, nothing())
    del main_o1
    fp32, _ = t.one_step(build_train(config, batch, seq, lr, seed)[0],
                         saved, nothing())
    for name, (step_loss, step_grads, _) in (("kernel", kernel),
                                             ("o1", o1)):
        if any(g.dtype != torch.float32 for g in step_grads.values()):
            fail("the %s step's gradients are not all fp32" % name)
    res.update({
        "graph_vs_eager": graph_vs_eager(kernel, eager, compare_amp(
            kernel, eager, fp32, lr)),
        "kernels_vs_plain": compare_amp(kernel, plain, fp32, lr),
        "fused_bwd_vs_plain": compare_amp(fused, plain, fp32, lr),
        "o1_loss": float(o1[0]), "fp32_loss": float(fp32[0]),
        # the global norm of each AMP step's gradients' distance from the
        # fp32 step's, over the fp32 step's own
        "o1_vs_fp32_grad_rel": _global_rel(o1[1], fp32[1]),
        "o2_vs_fp32_grad_rel": _global_rel(kernel[1], fp32[1]),
    })
    del kernel, eager, plain, fused, o1, fp32
    if not np.isfinite(res["o1_loss"]):
        fail("the O1 step's loss is not finite")
    for key in ("graph_vs_eager", "kernels_vs_plain", "fused_bwd_vs_plain"):
        if not res[key]["ok"]:
            fail("bf16 AMP training step %s failed: %s"
                 % (key, json.dumps(res[key])))
    if t.cuda:
        # step (c), the single-pass backward, profiled the same way (a
        # replay: the step without the gradient fetches is captured first)
        t.restore(saved)
        with fused_env():
            t.step()
            res["profile_fused_bwd"] = profile_call(
                t.step, os.path.join(workdir,
                                     "train_amp_fused_bwd_step_ops.txt"))
    res["step_cache"] = t.cache_line()
    exe.close()
    return res


def graph_vs_eager(graph, eager, gate):
    """The graph step against the same step op by op from one state: the
    largest differences of the loss, the gradients and the updated
    parameters, whether all are 0 (bitwise), and ``gate`` (compare_steps
    or compare_amp of the two), which must hold when they are not."""
    (lg, gg, pg), (le, ge, pe) = graph, eager
    diffs = {"loss_abs_diff": abs(float(lg) - float(le)),
             "grad_max_abs_diff": max(float((gg[n] - ge[n]).abs().max())
                                      for n in ge),
             "param_max_abs_diff": max(float((pg[n] - pe[n]).abs().max())
                                       for n in pe)}
    bitwise = not any(diffs.values())
    return {"bitwise": bitwise, **diffs, "gate": gate,
            "ok": bitwise or gate["ok"]}


class _Trainer:
    """What the training phases share: one program's executor, scope and
    seeded batch; steps through the graph or op by op (eager_steps()),
    timed in turns; one step from a saved state; kernel launches counted
    by the host and, inside replays, by the device's counters."""

    def __init__(self, exe, scope, main, loss, config, batch, seq, seed,
                 keys, workdir, feed=None, tokens=None):
        import torch

        self.torch = torch
        self.exe, self.scope, self.main, self.loss = exe, scope, main, loss
        self.keys, self.workdir = keys, workdir
        self.cuda = exe.device.type == "cuda"
        self.batch, self.seq = batch, seq
        # the tokens a step trains on (tokens_per_s)
        self.tokens = batch * seq if tokens is None else tokens
        self.params = [p.name for p in main.all_parameters()]
        self.grads = [n + "@GRAD" for n in self.params]
        self.n_params = sum(scope.find_var(n).numel() for n in self.params)
        if feed is None:
            rng = np.random.default_rng(seed + 2)
            feed = {k: torch.from_numpy(rng.integers(
                0, config["vocab_size"], (batch, seq))).to(exe.device)
                for k in ("ids", "labels")}
        self.feed = feed

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def step(self, program=None):
        return self.exe.run(program or self.main, self.feed, [self.loss],
                            scope=self.scope, return_numpy=False)

    def timed_turns(self, warm, steps, table, t0, save=True, routing=False):
        """Warm graph steps (the first builds the kernels and captures),
        then ``steps`` steps per turn, graph, eager, eager, graph: ms,
        tokens/s and peak memory by mode, the host's kernel launches per
        step by mode (0 in a replay), the losses of the warm steps and
        the first turn (with ``save``, ``self.saved``: a copy of the state
        after them, where the comparisons of one step start); then a
        profiled step of each mode, the graph one the main path's run
        (host counts zeroed just before it: they must stay 0, the device's
        counters count the kernels inside the replay), busy time by kind
        (with ``routing``, the indexing kernels apart)."""
        torch = self.torch
        self.sync()
        setup_s = time.perf_counter() - t0
        losses = [float(self.step()[0]) for _ in range(warm)]
        self.sync()
        modes = {m: {"step_ms": [], "peak_mem_gb": [], "peak_reserved_gb": [],
                     "host_launches": [], "losses": []}
                 for m in ("graph", "eager")}
        turns = ("graph", "eager", "eager", "graph")
        for turn, mode in enumerate(turns):
            got = modes[mode]
            if self.cuda:
                torch.cuda.reset_peak_memory_stats()
            _launch_counts(reset=True)
            with eager_steps() if mode == "eager" else \
                    contextlib.nullcontext():
                for _ in range(steps):
                    t1 = time.perf_counter()
                    got["losses"].append(float(self.step()[0]))
                    got["step_ms"].append((time.perf_counter() - t1) * 1e3)
            if turn == 0:
                losses += got["losses"]
                if save:
                    self.saved = self.save()
            got["host_launches"].append(
                {k: n / steps for k, n in _launch_counts(
                    keys=self.keys).items()})
            # allocated: a replay allocates nothing, and the graph's pool
            # is not counted as allocated; reserved holds the pool
            got["peak_mem_gb"].append(torch.cuda.max_memory_allocated() / 1e9
                                      if self.cuda else None)
            got["peak_reserved_gb"].append(
                torch.cuda.max_memory_reserved() / 1e9 if self.cuda
                else None)
        if not all(np.isfinite(losses + modes["graph"]["losses"]
                          + modes["eager"]["losses"])):
            fail("training losses are not finite: %s" % modes)
        for got in modes.values():
            got["step_ms_mean"] = float(np.mean(got["step_ms"]))
            got["tokens_per_s"] = (self.tokens
                                   / (got["step_ms_mean"] / 1e3))
        graph, eager = modes["graph"], modes["eager"]
        res = {"setup_s": setup_s, "warm_steps": warm, "steps": steps,
               "turns": list(turns),
               "losses": losses, "graph": graph, "eager": eager,
               "step_ms_mean": graph["step_ms_mean"],
               "tokens_per_s": graph["tokens_per_s"],
               "peak_mem_gb": max(graph["peak_mem_gb"]) if self.cuda
               else None,
               "peak_reserved_gb": max(graph["peak_reserved_gb"])
               if self.cuda else None,
               "graph_speedup": eager["step_ms_mean"] / graph["step_ms_mean"],
               "eager_launches_per_step": eager["host_launches"][0],
               "host_launches_per_graph_step": graph["host_launches"][-1]}
        for got in modes.values():
            del got["losses"]
        # the main path's run: one graph step, counts zeroed just before
        _launch_counts(reset=True)
        if self.cuda:
            _device_counts((), reset=True)
            graph["profile"] = profile_call(self.step, os.path.join(
                self.workdir, table + "_ops.txt"), routing)
            res["launches_per_step"] = _device_counts(self.keys)
            res["profiler_launches_per_step"] = {
                k: graph["profile"]["kernel_launches"].get(KERNEL_SYMBOLS[k],
                                                           0)
                for k in self.keys}
        else:
            self.step()
            res["launches_per_step"] = dict.fromkeys(self.keys, 0)
        res["main_path_host_launches"] = _launch_counts(keys=self.keys)
        if self.cuda:
            with eager_steps():
                eager["profile"] = profile_call(self.step, os.path.join(
                    self.workdir, table + "_eager_ops.txt"), routing)
            res["profile"] = graph["profile"]
        return res

    def save(self):
        """Copies of every persistable: the executor updates the scope's
        tensors in place, so a saved state must not be one of them."""
        return {v.name: self.scope.find_var(v.name).clone()
                for v in self.main.list_vars() if v.persistable}

    def restore(self, saved):
        """Copies of ``saved`` into the scope: a tensor in the scope when a
        step runs may become its state buffer, updated in place."""
        for name, val in saved.items():
            self.scope.set_var(name, val.clone())

    def one_step(self, program, saved, ctx, eager=False, step=None):
        """One step of ``program`` from ``saved`` under ``ctx``, through
        its graph or (``eager``) op by op, as the program's step ``step``
        when given (its random stream's position): ((loss, {@GRAD},
        {param}), host launch counts), every tensor a copy."""
        self.restore(saved)
        if step is not None:
            self.exe.set_program_steps(program, step)
        _launch_counts(reset=True)
        with ctx, eager_steps() if eager else contextlib.nullcontext():
            outs = self.exe.run(program, self.feed, [self.loss] + self.grads,
                                scope=self.scope, return_numpy=False)
        self.sync()
        return ((outs[0], dict(zip(self.grads, outs[1:])),
                 {n: self.scope.find_var(n).clone() for n in self.params}),
                _launch_counts(keys=self.keys))

    def replay_launches(self, program, ctx):
        """The kernels that one more step of ``program`` (a replay of the
        graph that one_step captured) launches, as the device's counters
        count them; zeros on the CPU."""
        if not self.cuda:
            return dict.fromkeys(self.keys, 0)
        _device_counts((), reset=True)
        with ctx:
            self.exe.run(program, self.feed, [self.loss] + self.grads,
                         scope=self.scope, return_numpy=False)
        return _device_counts(self.keys)

    def cache_line(self):
        """The executor's step cache: steps held, their bytes, captures."""
        cache = self.exe.step_cache
        return {"steps": len(cache), "gb": cache.nbytes / 1e9,
                "traces": cache.traces, "evictions": cache.evictions,
                "bound_gb": (cache.max_bytes / 1e9 if cache.max_bytes
                             else None)}


def timed_loop(run_loop, warmup, steps):
    """bench.py's device-loop timing (_timed_loop, bench.py:176-213): one
    run_loop(warmup) call to build and warm, then run_loop(steps) and
    run_loop(2 * steps), each ended by reading its loss on the host; the
    time of a step is the slope (t2 - t1) / steps, so a call's fixed
    costs cancel. Returns (ms per step, last loss, t1 s, t2 s)."""
    out = run_loop(max(1, warmup))
    float(out[0])
    t0 = time.perf_counter()
    out = run_loop(steps)
    float(out[0])
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = run_loop(2 * steps)
    loss = float(out[0])
    t2 = time.perf_counter() - t0
    dt = (t2 - t1) / steps
    if dt <= 0:
        dt = t2 / (2 * steps)
    return dt * 1e3, loss, t1, t2


def build_train_reader(config, batch, seq, lr, seed, amp_level="O2",
                       make_reader=None):
    """build_train's program fed by a reader instead of a feed dict:
    py_reader (double-buffered), or the reader variable ``make_reader()``
    builds, -> read_file -> transformer_lm; the same parameter names.
    Returns (main, startup, loss, reader)."""
    from paddle_tpu_torch import (Program, layers, optimizer, program_guard,
                                  unique_name)
    from paddle_tpu_torch.models import transformer

    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = seed
    with program_guard(main, startup), unique_name.guard():
        if make_reader is None:
            reader = layers.py_reader(capacity=4, shapes=[(batch, seq)] * 2,
                                      dtypes=["int64", "int64"],
                                      name="train_reader")
        else:
            reader = make_reader()
        ids, labels = layers.read_file(reader)
        loss, _ = transformer.transformer_lm(ids, labels, **config)
        optimizer.Adam(learning_rate=lr).minimize(loss)
        if amp_level:
            main.enable_mixed_precision(level=amp_level)
    return main, startup, loss, reader


def _same_steps(a, b, lr):
    """Two runs of the same steps from one state: (loss, {param}) each.
    Bitwise, or the loss within LOSS_RTOL and every parameter within
    lr/10 (compare_steps' gates)."""
    (la, pa), (lb, pb) = a, b
    loss_diff = abs(float(la) - float(lb))
    param_diff = max(float((pa[n] - pb[n]).abs().max()) for n in pb)
    bitwise = loss_diff == 0.0 and param_diff == 0.0
    return {"bitwise": bitwise, "loss_abs_diff": loss_diff,
            "param_max_abs_diff": param_diff,
            "ok": bitwise or (loss_diff <= LOSS_RTOL * abs(float(lb))
                              and param_diff <= lr / 10)}


def run_train_loop(config, batch, seq, lr, warmup, steps, seed, place,
                   workdir):
    """bench.py's LM phase as bench.py runs it: bf16 AMP O2, stepped by
    Executor.run_loop(k) and timed by its slope method (timed_loop), then
    one run_loop(steps) call profiled (the main path's run: host kernel
    counts zeroed before it stay 0, one graph launch a step, the device's
    counters count the kernels inside the replays). Gates: run_loop(steps) from a
    saved state equals ``steps`` run calls from it. Then the reader
    window: the same program over py_reader -> double_buffer ->
    read_file, fed 2 windows of ``steps`` batches drawn from ``seed``
    and then EOF, trained window by window with the prefetch on and off
    (ms per step, the host's pull ms); its first window equals a
    run_loop with the same batches as stacked per_step_feeds, and the
    third call must raise EOFException. Runs on any place (the CPU tests
    rehearse it at a tiny size)."""
    import torch
    from paddle_tpu_torch import EOFException, Executor, Scope

    keys = FP32_KERNELS + BF16_KERNELS
    t0 = time.perf_counter()
    main, startup, loss = build_train(config, batch, seq, lr, seed, "O2")
    exe, scope = Executor(place), Scope()
    exe.run(startup, scope=scope)
    t = _Trainer(exe, scope, main, loss, config, batch, seq, seed, keys,
                 workdir)
    t.sync()
    setup_s = time.perf_counter() - t0

    def run_loop(k, program=main, **kw):
        kw.setdefault("feed", t.feed)
        return exe.run_loop(program, fetch_list=[loss], steps=k,
                            scope=scope, return_numpy=False, **kw)

    if t.cuda:
        torch.cuda.reset_peak_memory_stats()
    ms, last_loss, t1, t2 = timed_loop(run_loop, warmup, steps)
    res = {"phase": "train_loop", "amp_level": "O2", "config": config,
           "batch": batch, "seq": seq, "lr": lr, "setup_s": setup_s,
           "warmup": warmup, "steps": steps, "step_ms": ms,
           "tokens_per_s": batch * seq / (ms / 1e3),
           "call_s": {"steps": t1, "2_steps": t2}, "last_loss": last_loss,
           "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                           if t.cuda else None),
           "peak_reserved_gb": (torch.cuda.max_memory_reserved() / 1e9
                                if t.cuda else None)}
    if not np.isfinite(last_loss):
        fail("run_loop's loss is not finite: %s" % last_loss)
    # the main path's run: one run_loop(steps) call
    _launch_counts(reset=True)
    if t.cuda:
        _device_counts((), reset=True)
        prof = profile_call(lambda: float(run_loop(steps)[0]),
                            os.path.join(workdir, "train_loop_ops.txt"))
        res["profile"] = prof
        res["launches"] = _device_counts(keys)
        res["profiler_launches"] = {k: prof["kernel_launches"].get(
            KERNEL_SYMBOLS[k], 0) for k in keys}
        res["graph_launches"] = prof["host_launch_calls"]["graph_launches"]
    else:
        run_loop(steps)
        res["launches"] = dict.fromkeys(keys, 0)
        res["graph_launches"] = 0
    res["host_launches"] = _launch_counts(keys=keys)

    # run_loop(steps) against steps run calls, from one saved state
    saved = t.save()

    def state():
        return {n: scope.find_var(n).clone() for n in t.params}

    t.restore(saved)
    loop = (run_loop(steps)[0], state())
    t.restore(saved)
    for _ in range(steps):
        out = t.step()
    runs = (out[0], state())
    res["loop_vs_runs"] = _same_steps(loop, runs, lr)
    del loop, runs

    # the reader window: 2 windows of `steps` batches, then EOF
    rmain, _, rloss, reader = build_train_reader(config, batch, seq, lr,
                                                 seed)
    rng = np.random.default_rng(seed + 3)
    data = rng.integers(0, config["vocab_size"], (2 * steps, 2, batch, seq))
    reader.decorate_tensor_provider(lambda: iter([(d[0], d[1])
                                                  for d in data]))

    def epoch(prefetch):
        """One epoch of reader windows from the saved state: the window
        losses, ms per call, the state after the first window, and the
        host's pull ms; the third call must raise EOFException."""
        t.restore(saved)
        got = {"ms": [], "losses": []}
        pull0 = exe.reader_pull_ms
        with env_set("PADDLE_TPU_READER_PREFETCH", "1" if prefetch else "0"):
            reader.reset()
            reader.start()
            for w in range(2):
                t1 = time.perf_counter()
                out = exe.run_loop(rmain, fetch_list=[rloss], steps=steps,
                                   scope=scope, return_numpy=False)
                got["losses"].append(float(out[0]))
                got["ms"].append((time.perf_counter() - t1) * 1e3)
                if w == 0:
                    got["first_state"] = state()
                    got["first_loss"] = out[0]
            try:
                exe.run_loop(rmain, fetch_list=[rloss], steps=steps,
                             scope=scope, return_numpy=False)
                got["eof"] = False
            except EOFException:
                got["eof"] = True
        got["pull_ms"] = exe.reader_pull_ms - pull0
        got["ms_per_step"] = sum(got["ms"]) / (2 * steps)
        return got

    epoch(True)                      # builds and captures the reader step
    on, off = epoch(True), epoch(False)
    t.restore(saved)
    stacked = {"ids": torch.from_numpy(data[:steps, 0]),
               "labels": torch.from_numpy(data[:steps, 1])}
    per_step = run_loop(steps, feed=stacked, per_step_feeds=["ids",
                                                             "labels"])
    want = (per_step[0], state())
    window = {
        "windows": 2, "eof_on_third_call": on["eof"] and off["eof"],
        "prefetch_on": {k: on[k] for k in ("ms", "ms_per_step", "pull_ms",
                                           "losses")},
        "prefetch_off": {k: off[k] for k in ("ms", "ms_per_step", "pull_ms",
                                             "losses")},
        "on_equals_off": on["losses"] == off["losses"],
        "first_window_vs_per_step_feeds": _same_steps(
            (on["first_loss"], on["first_state"]), want, lr)}
    res["reader_window"] = window
    res["step_cache"] = t.cache_line()
    exe.close()
    if not res["loop_vs_runs"]["ok"]:
        fail("run_loop(%d) differs from %d run calls: %s"
             % (steps, steps, json.dumps(res["loop_vs_runs"])))
    if not window["eof_on_third_call"]:
        fail("the reader's third window did not raise EOFException")
    if not (window["first_window_vs_per_step_feeds"]["ok"]
            and window["on_equals_off"]):
        fail("the reader window check failed: %s" % json.dumps(window))
    return res


# ---------------------------------------------------------------------------
# train_files: the LM trained from recordio files and from the DataLoader
# ---------------------------------------------------------------------------


class FileSamples:
    """The samples of recordio files, one pickled (ids, labels) tuple a
    record, file after file: the DataLoader's source (module-level, so its
    worker processes can unpickle it; cheap to iterate, as a source
    should be)."""

    def __init__(self, paths):
        self.paths = list(paths)

    def __call__(self):
        from paddle_tpu_torch import recordio_sample_reader

        for path in self.paths:
            yield from recordio_sample_reader(path, prefetch=False)()


def _reader_epoch(exe, scope, program, loss, reader, steps, saved, restore,
                  state, prefetch):
    """One epoch of ``reader`` from ``saved``: 2 run_loop(steps) windows,
    then a third call that must raise EOFException. Returns ms per
    window, ms per step, the host's pull ms, and each window's (loss,
    state())."""
    from paddle_tpu_torch import EOFException

    restore(saved)
    got = {"ms": [], "windows": []}
    pull0 = exe.reader_pull_ms
    with env_set("PADDLE_TPU_READER_PREFETCH", "1" if prefetch else "0"):
        reader.reset()
        reader.start()
        for _ in range(2):
            t1 = time.perf_counter()
            out = exe.run_loop(program, fetch_list=[loss], steps=steps,
                               scope=scope, return_numpy=False)
            float(out[0])
            got["ms"].append((time.perf_counter() - t1) * 1e3)
            got["windows"].append((out[0], state()))
        try:
            exe.run_loop(program, fetch_list=[loss], steps=steps,
                         scope=scope, return_numpy=False)
            got["eof"] = False
        except EOFException:
            got["eof"] = True
    got["pull_ms"] = exe.reader_pull_ms - pull0
    got["ms_per_step"] = sum(got["ms"]) / (2 * steps)
    got["losses"] = [float(w[0]) for w in got["windows"]]
    return got


def run_train_files(config, batch, seq, lr, steps, seed, place, workdir):
    """The LM (bench.py's LM phase, bf16 O2) trained by run_loop(steps)
    from files on disk. 2 windows x ``steps`` batches x ``batch`` samples
    of (ids[seq], labels[seq]) int64 from ``seed`` are written with
    recordio_convert into two recordio files; the program then reads them
    through open_files -> batch -> double_buffer -> read_file, windows
    trained with the prefetch on and off (ms per step, the host's pull
    ms), and through a data_loader (FILES_LOADER_WORKERS processes, ordered,
    double-buffered, decorate_sample_reader over the files; its stats()).
    Gates: each window's loss and parameters equal a run_loop(steps) over
    the same batches as per_step_feeds from one saved state
    (_same_steps), and the third call raises EOFException, on both
    paths. The main path's run: one files window under torch.profiler,
    the host counts zeroed just before it (they must stay 0; the device's
    counters count the bf16 kernels inside the replays). Then a window of
    open_files -> batch -> read_file (no double buffer, so the window
    holds ``steps`` batches that BatchReader handed out) at
    FILES_WINDOW_LAYERS layers against per_step_feeds. Runs on any place
    (the CPU tests rehearse it at a tiny size)."""
    import torch
    from paddle_tpu_torch import Executor, Scope, layers, recordio_convert
    from paddle_tpu_torch.runtime import build as rt_build
    from paddle_tpu_torch.runtime.recordio import native_available

    if not native_available():
        fail("the runtime library (runtime.cc) did not build: %s"
             % rt_build.build_error())
    keys = BF16_KERNELS
    rng = np.random.default_rng(seed + 5)
    data = rng.integers(0, config["vocab_size"], (2 * steps * batch, 2, seq))
    paths = [os.path.join(workdir, "train_%d.recordio" % i) for i in (0, 1)]
    t0 = time.perf_counter()
    half = steps * batch
    for path, part in zip(paths, (data[:half], data[half:])):
        recordio_convert(lambda part=part: ((s[0], s[1]) for s in part),
                         path)
    res = {"phase": "train_files", "amp_level": "O2", "config": config,
           "batch": batch, "seq": seq, "lr": lr, "steps": steps,
           "native_runtime": native_available(),
           "files_mb": sum(os.path.getsize(p) for p in paths) / 1e6,
           "write_ms": (time.perf_counter() - t0) * 1e3}
    # the true batches: (window, step, batch, 2, seq)
    windows = data.reshape(2, steps, batch, 2, seq)

    main, startup, loss = build_train(config, batch, seq, lr, seed, "O2")
    exe, scope = Executor(place), Scope()
    exe.run(startup, scope=scope)
    t = _Trainer(exe, scope, main, loss, config, batch, seq, seed, keys,
                 workdir)
    saved = t.save()

    def state():
        return {n: scope.find_var(n).clone() for n in t.params}

    def per_step(program, lossvar, win, on_scope):
        """run_loop(steps) over window ``win``'s true batches as
        per_step_feeds: the loss."""
        stacked = {"ids": torch.from_numpy(np.ascontiguousarray(
                       windows[win, :, :, 0])),
                   "labels": torch.from_numpy(np.ascontiguousarray(
                       windows[win, :, :, 1]))}
        return exe.run_loop(program, feed=stacked, fetch_list=[lossvar],
                            steps=steps, scope=on_scope, return_numpy=False,
                            per_step_feeds=["ids", "labels"])[0]

    t.restore(saved)
    want = [(per_step(main, loss, w, scope), state()) for w in range(2)]

    def gates(epoch):
        return [_same_steps(got, ref, lr)
                for got, ref in zip(epoch["windows"], want)]

    # open_files -> batch -> double_buffer -> read_file
    fmain, _, floss, freader = build_train_reader(
        config, batch, seq, lr, seed, make_reader=lambda: layers.double_buffer(
            layers.batch(layers.open_files(paths, [(seq,), (seq,)],
                                           ["int64", "int64"]), batch)))
    epoch_args = (exe, scope, fmain, floss, freader, steps, saved, t.restore,
                  state)
    _reader_epoch(*epoch_args, prefetch=True)   # builds and captures
    on = _reader_epoch(*epoch_args, prefetch=True)
    off = _reader_epoch(*epoch_args, prefetch=False)
    files = {"prefetch_on": {k: on[k] for k in ("ms", "ms_per_step",
                                                 "pull_ms", "losses")},
             "prefetch_off": {k: off[k] for k in ("ms", "ms_per_step",
                                                   "pull_ms", "losses")},
             "eof_on_third_call": on["eof"] and off["eof"],
             "on_equals_off": on["losses"] == off["losses"],
             "windows_vs_per_step_feeds": gates(on)}
    del on, off
    # the main path's run: one files window, counts zeroed just before
    t.restore(saved)
    freader.reset()
    freader.start()
    _launch_counts(reset=True)
    if t.cuda:
        _device_counts((), reset=True)
        prof = profile_call(lambda: float(exe.run_loop(
            fmain, fetch_list=[floss], steps=steps, scope=scope,
            return_numpy=False)[0]), os.path.join(workdir,
                                                  "train_files_ops.txt"))
        res["profile"] = prof
        res["launches"] = _device_counts(keys)
        res["profiler_launches"] = {k: prof["kernel_launches"].get(
            KERNEL_SYMBOLS[k], 0) for k in keys}
        res["graph_launches"] = prof["host_launch_calls"]["graph_launches"]
    else:
        exe.run_loop(fmain, fetch_list=[floss], steps=steps, scope=scope)
        res["launches"] = dict.fromkeys(keys, 0)
        res["graph_launches"] = 0
    res["host_launches"] = _launch_counts(keys=keys)
    res["files"] = files

    # a data_loader over the same files
    lmain, _, lloss, loader = build_train_reader(
        config, batch, seq, lr, seed, make_reader=lambda: layers.data_loader(
            capacity=8, shapes=[(-1, seq), (-1, seq)],
            dtypes=["int64", "int64"], num_workers=FILES_LOADER_WORKERS,
            use_double_buffer=True, name="train_loader"))
    loader.decorate_sample_reader(FileSamples(paths), batch_size=batch)
    holder = loader._reader_holder.inner
    try:
        epoch_args = (exe, scope, lmain, lloss, loader, steps, saved,
                      t.restore, state)
        _reader_epoch(*epoch_args, prefetch=True)   # builds and captures
        st0 = holder.stats()
        got = _reader_epoch(*epoch_args, prefetch=True)
        st = holder.stats()
    finally:
        loader.close()
    wall = st["wall_s"] - st0["wall_s"]
    res["loader"] = {
        "workers": FILES_LOADER_WORKERS, "capacity": holder.capacity,
        "ms": got["ms"], "ms_per_step": got["ms_per_step"],
        "pull_ms": got["pull_ms"], "losses": got["losses"],
        "eof_on_third_call": got["eof"],
        "windows_vs_per_step_feeds": gates(got),
        "batches": st["batches"] - st0["batches"],
        "shm_batches": st["shm_batches"] - st0["shm_batches"],
        "pickle_batches": st["pickle_batches"] - st0["pickle_batches"],
        "blocked_share": (st["blocked_s"] - st0["blocked_s"]) / wall,
        "worker_utilization": (st["worker_busy_s"] - st0["worker_busy_s"])
        / (FILES_LOADER_WORKERS * wall)}
    del got, want

    # a window of batches BatchReader handed out, held by the executor
    # until stacked: open_files -> batch -> read_file, at FILES_WINDOW_LAYERS
    small = dict(config, n_layer=FILES_WINDOW_LAYERS)
    smain, sstart, sloss = build_train(small, batch, seq, lr, seed, "O2")
    wmain, _, wloss, wreader = build_train_reader(
        small, batch, seq, lr, seed, make_reader=lambda: layers.batch(
            layers.open_files(paths, [(seq,), (seq,)], ["int64", "int64"]),
            batch))
    sscope = Scope()
    exe.run(sstart, scope=sscope)
    names = [p.name for p in smain.all_parameters()]
    ssaved = {v.name: sscope.find_var(v.name).clone()
              for v in smain.list_vars() if v.persistable}

    def small_state():
        return {n: sscope.find_var(n).clone() for n in names}

    wreader.start()
    out = exe.run_loop(wmain, fetch_list=[wloss], steps=steps, scope=sscope,
                       return_numpy=False)
    held = (out[0], small_state())
    for name, val in ssaved.items():
        sscope.set_var(name, val.clone())
    ref = (per_step(smain, sloss, 0, sscope), small_state())
    res["window_without_double_buffer"] = {
        "n_layer": FILES_WINDOW_LAYERS,
        "vs_per_step_feeds": _same_steps(held, ref, lr)}
    res["step_cache"] = t.cache_line()
    exe.close()
    for path in paths:
        os.remove(path)
    if not (files["eof_on_third_call"] and res["loader"]["eof_on_third_call"]):
        fail("train_files: the third window did not raise EOFException")
    checks = (files["windows_vs_per_step_feeds"]
              + res["loader"]["windows_vs_per_step_feeds"]
              + [res["window_without_double_buffer"]["vs_per_step_feeds"]])
    if not (all(c["ok"] for c in checks) and files["on_equals_off"]):
        fail("train_files: a window differs from per_step_feeds: %s"
             % json.dumps({k: res[k] for k in ("files", "loader",
                                                "window_without_double_buffer")}))
    return res


class RawSource:
    """tools/bench_dataloader.py's source: (raw_bytes, label) samples,
    cheap to iterate (4 distinct blobs, cycled)."""

    def __init__(self, n, nbytes, seed=0):
        r = np.random.RandomState(seed)
        self.blobs = [r.randint(0, 256, nbytes).astype(np.uint8).tobytes()
                      for _ in range(4)]
        self.n = n

    def __call__(self):
        for i in range(self.n):
            yield (self.blobs[i % len(self.blobs)], i)


class HeavyDecode:
    """tools/bench_dataloader.py's GIL-holding per-sample decode: a Python
    loop over every 17th byte, then the float conversion."""

    def __init__(self, stride=17):
        self.stride = stride

    def __call__(self, sample):
        raw, label = sample
        a = np.frombuffer(raw, np.uint8).astype(np.float32)
        acc = 0.0
        for v in a[::self.stride]:
            acc = acc * 0.9999 + float(v)
        img = a * (1.0 / 127.5) - 1.0
        img[0] = acc * 1e-9
        return (img, np.int64(label))


def _pipeline_threads(n_batches, batch, nbytes, workers):
    """xmap_readers threads + batch + stacking on the consumer: batches/s
    from the first delivered batch on."""
    from paddle_tpu_torch import reader as rd

    mapped = rd.xmap_readers(HeavyDecode(), RawSource(n_batches * batch,
                                                      nbytes),
                             workers, max(2 * workers, 4), order=True)
    n, t0 = 0, None
    for minibatch in rd.batch(mapped, batch, drop_last=True)():
        np.stack([s[0] for s in minibatch])
        np.stack([s[1] for s in minibatch])
        if t0 is None:
            t0 = time.perf_counter()
            continue
        n += 1
    if n != n_batches - 1:
        fail("the threaded pipeline gave %d batches, not %d"
             % (n + 1, n_batches))
    return n / (time.perf_counter() - t0)


def _pipeline_process(n_batches, batch, nbytes, workers, stats_out=None):
    """The port's DataLoader: worker processes, shared-memory transport,
    batches arrive stacked; batches/s from the first delivered batch."""
    from paddle_tpu_torch.io.dataloader import DataLoader

    dl = DataLoader(["img", "label"], None, None, num_workers=workers,
                    capacity=max(8, 2 * workers),
                    slot_bytes=max(4 << 20, 8 * batch * nbytes))
    dl.decorate_sample_reader(RawSource(n_batches * batch, nbytes),
                              batch_size=batch, drop_last=True,
                              mapper=HeavyDecode())
    try:
        dl.start()
        n, t0 = 0, None
        for _feed in dl:
            if t0 is None:
                t0 = time.perf_counter()
                continue
            n += 1
        dt = time.perf_counter() - t0
        if n != n_batches - 1:
            fail("the DataLoader gave %d batches, not %d" % (n + 1,
                                                              n_batches))
        if stats_out is not None:
            stats_out.update(dl.stats())
        return n / dt
    finally:
        dl.close()


def input_pipeline(workers=2, sample_kb=16, batch=16, n_batches=48,
                   rounds=3):
    """The host input pipeline on tools/bench_dataloader.py:180's
    quick_metric workload (2 workers, 16 KB samples, batch 16, 48
    batches, 3 rounds, medians): the port's DataLoader against the
    threaded path (xmap_readers), in turns, after one warm DataLoader
    epoch (the fork server's start)."""
    nbytes = int(sample_kb * 1024)
    _pipeline_process(max(2, n_batches // 8), batch, nbytes, workers)
    stats, t_rates, p_rates = {}, [], []
    for _ in range(rounds):
        t_rates.append(_pipeline_threads(n_batches, batch, nbytes, workers))
        p_rates.append(_pipeline_process(n_batches, batch, nbytes, workers,
                                         stats_out=stats))
    t_rate, p_rate = float(np.median(t_rates)), float(np.median(p_rates))
    wall = max(stats.get("wall_s", 0.0), 1e-9)
    return {"phase": "input_pipeline", "workers": workers,
            "sample_kb": sample_kb, "batch": batch, "batches": n_batches,
            "rounds": rounds, "batches_per_s": p_rate,
            "samples_per_s": p_rate * batch,
            "threads_batches_per_s": t_rate,
            "speedup_vs_threads": p_rate / max(t_rate, 1e-9),
            "process_rounds": p_rates, "threads_rounds": t_rates,
            "transport": {"shm": stats.get("shm_batches"),
                          "pickle": stats.get("pickle_batches")},
            "consumer_blocked_share": stats.get("blocked_s", 0.0) / wall,
            "worker_utilization": stats.get("worker_busy_s", 0.0)
            / (workers * wall)}


# ---------------------------------------------------------------------------
# the nmt and lm_variants phases: the dense Transformer's other paths
# ---------------------------------------------------------------------------


def build_nmt(config, batch, seq, lr, seed, dropout, amp_level=None):
    """get_model's encoder-decoder transformer_nmt + Adam(lr).minimize,
    built as a user would, then, with ``amp_level``, set to bf16 AMP as
    bench.py sets its LM: returns (main, startup, loss)."""
    from paddle_tpu_torch import (Program, optimizer, program_guard,
                                  unique_name)
    from paddle_tpu_torch.models import transformer

    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = seed
    with program_guard(main, startup), unique_name.guard():
        loss, _, _ = transformer.get_model(
            batch_size=batch, seq_len=seq, dropout_rate=dropout, **config)
        optimizer.Adam(learning_rate=lr).minimize(loss)
        if amp_level:
            main.enable_mixed_precision(level=amp_level)
    return main, startup, loss


def nmt_feed(config, batch, seq, min_len, seed, device):
    """The NMT step's feeds from ``seed``: token ids in the vocabularies,
    source and target lengths drawn in min_len..seq, row 0 at seq."""
    import torch

    rng = np.random.default_rng(seed + 3)
    feed = {}
    for side in ("src", "tgt"):
        feed[side + "_ids"] = rng.integers(
            0, config[side + "_vocab_size"], (batch, seq))
        lens = rng.integers(min_len, seq + 1, batch)
        lens[0] = seq
        feed[side + "_len"] = lens.astype(np.int32)
    feed["lbl_ids"] = rng.integers(0, config["tgt_vocab_size"], (batch, seq))
    return {k: torch.from_numpy(v).to(device) for k, v in feed.items()}


def keep_share(mask, p):
    """The kept share of a dropout mask and its distance from 1 - p in
    binomial standard deviations."""
    n = mask.numel()
    kept = float(mask.double().sum())
    return kept / n, (kept - n * (1 - p)) / (n * p * (1 - p)) ** 0.5


def dropout_draws(config, batch, seq, p, amp_level, seed, device):
    """The device ms of one draw of each dropout of the NMT step (REPS
    draws in a graph, CUDA events), on the counter-based hash
    (ops/rng.py): the FFN's mask and its dropout on a (batch, seq,
    d_inner) activation, one attention block's mask (batch, heads, seq,
    seq); beside them torch's Philox draw of the FFN's mask (torch.rand,
    the generator a capture registers), a yardstick the port does not
    call. Also the kept share of an attention block's mask, and on the
    card 2**20 of the hash's values against the CPU's (equal)."""
    import torch
    from paddle_tpu_torch.ops import rng as prng

    dtype = torch.bfloat16 if amp_level else torch.float32
    x = torch.randn((batch, seq, config["d_inner"]), device=device,
                    dtype=dtype)
    zero = torch.zeros((), dtype=dtype, device=device)
    key = prng.counter_key(torch.tensor([seed, 1], device=device))
    att = (batch, config["n_head"], seq, seq)
    share, sigmas = keep_share(prng.keep_mask(prng.fold(key, 0), att, p), p)
    if sigmas > KEEP_SIGMAS or sigmas < -KEEP_SIGMAS:
        fail("attention dropout keeps %.6f of a block (%.1f sigmas from "
             "%.2f)" % (share, sigmas, 1 - p))
    res = {"attention_block_kept_share": share,
           "attention_block_sigmas": sigmas}
    if device.type != "cuda":
        return res
    # the card draws the CPU's bits (int32 products wrap alike)
    res["bits_equal_cpu"] = bool(torch.equal(
        prng.uniform24(key, (1 << 20,)).cpu(),
        prng.uniform24(key.cpu(), (1 << 20,))))
    if not res["bits_equal_cpu"]:
        fail("the card's dropout bits differ from the CPU's")
    n_layer = config["n_layer"]
    res.update({
        "ffn_shape": list(x.shape), "attention_block_shape": list(att),
        "ffn_mask_ms": time_ms(lambda: prng.keep_mask(key, x.shape, p)),
        "ffn_dropout_ms": time_ms(lambda: torch.where(
            prng.keep_mask(key, x.shape, p), x, zero)),
        "attention_block_mask_ms": time_ms(
            lambda: prng.keep_mask(key, att, p)),
        "philox_ffn_mask_ms": time_ms(
            lambda: torch.rand(x.shape, device=device) >= p),
        "draws_per_step": {"ffn": 2 * n_layer, "attention": 3 * n_layer}})
    res["step_draw_ms"] = (2 * n_layer * res["ffn_dropout_ms"]
                           + 3 * n_layer * res["attention_block_mask_ms"])
    return res


def check_nmt_attention(torch, dev, seed):
    """K1, K2 and K4 and their bf16 twins at the nmt phase's attention
    shapes, BTHD (NMT_BATCH x NMT_SEQ queries and keys, NMT_CONFIG's
    heads) with nmt_feed's lengths: non-causal over the source lengths
    (the encoder's self-attention and the cross-attention) and causal
    over the target lengths (the decoder's self-attention); fp32 at
    KERNEL_TOL, bf16 by bf16_gate. Returns the worst error of each."""
    cfg = NMT_CONFIG
    h = cfg["n_head"]
    d = cfg["d_model"] // h
    feed = nmt_feed(cfg, NMT_BATCH, NMT_SEQ, NMT_MIN_LEN, seed, "cpu")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 5)
    shape = (torch, gen, dev, NMT_BATCH, NMT_SEQ, h, d)
    worst = dict.fromkeys(("K1", "K2", "K4", "K1-bf16", "K2-bf16",
                           "K4-bf16"), 0.0)
    for causal, side in ((False, "src_len"), (True, "tgt_len")):
        lengths = feed[side].tolist()
        fwd = check_flash(*shape, causal, "bthd", lengths=lengths)
        bwd = check_flash_bwd(*shape, causal, "bthd", lengths=lengths)
        fwd16 = check_flash_bf16(*shape, causal, "bthd", lengths=lengths)
        bwd16 = check_flash_bwd_bf16(*shape, causal, "bthd",
                                     lengths=lengths)
        for key, err in (("K1", fwd["max_abs_err"]),
                         ("K2", bwd["K2_max_abs_err"]),
                         ("K4", bwd["K4_max_abs_err"]),
                         ("K1-bf16", fwd16["max_abs_err"]),
                         ("K2-bf16", bwd16["K2_max_abs_err"]),
                         ("K4-bf16", bwd16["K4_max_abs_err"])):
            worst[key] = max(worst[key], err)
    emit({"case": "nmt attention shapes", "shape": [NMT_BATCH, NMT_SEQ, h,
                                                    d],
          "layout": "bthd", "tol": KERNEL_TOL, "max_abs_err": worst})
    return worst


@contextlib.contextmanager
def relu_pinned(signs, flips=None):
    """Every relu op records in signs[name] (name: its input's) where its
    input z is positive; or, with ``flips``, passes z where signs[name]
    (another step's) says, not where its own z is positive, and records
    in flips[name] its units and those whose own sign differs."""
    from paddle_tpu_torch.ops import registry

    inner = registry.KERNELS["relu"]

    def relu(ctx):
        name, z = ctx.op.input("X")[0], ctx.input("X")
        if flips is None:
            signs[name] = z.detach() > 0
            return inner(ctx)
        keep = signs[name]
        flips[name] = (z.numel(), int(((z.detach() > 0) != keep).sum()))
        return {"Out": z * keep.to(z.dtype)}

    registry.KERNELS["relu"] = relu
    try:
        yield
    finally:
        registry.KERNELS["relu"] = inner


def run_nmt(config, batch, seq, min_len, lr, warm, steps, dropout, seed,
            place, workdir, amp_level=None):
    """Train get_model's encoder-decoder Transformer at ``config`` as a
    user would: build, startup, Executor.run steps on one seeded batch
    (nmt_feed), each one replay of the step's CUDA graph, timed in turns
    against the same step op by op, a profiled step of each (the main
    path's run: the graph step, device counters zeroed before it). Then,
    from one saved state and the same step of the random stream: the
    step through its graph and op by op (graph_vs_eager; under AMP
    relative to the fp32 program's step); at dropout 0 the steps with the
    plain attention, op by op (kernels_vs_plain: bf16 compare_amp; fp32
    compare_steps with the ReLUs pinned to the kernel step's signs
    (relu_pinned), and bwd_kernels_vs_plain_bwd on K1's forward), and
    the step with
    PADDLE_TPU_FLASH_FUSED_BWD=1 (its device launches and its state
    against the split backward's); with dropout, every dropout op's mask
    in two successive steps (they differ; each keeps 1 - p of its
    elements within KEEP_SIGMAS) and the draws' device ms
    (dropout_draws). Runs on any place (the CPU tests rehearse it at a
    tiny size); the gates on launch counts hold on the card."""
    from paddle_tpu_torch import Executor, Scope

    keys = FP32_KERNELS + BF16_KERNELS
    t0 = time.perf_counter()
    main, startup, loss = build_nmt(config, batch, seq, lr, seed, dropout,
                                    amp_level)
    exe, scope = Executor(place), Scope()
    exe.run(startup, scope=scope)
    feed = nmt_feed(config, batch, seq, min_len, seed, exe.device)
    tokens = int(feed["tgt_len"].sum())
    t = _Trainer(exe, scope, main, loss, None, batch, seq, seed, keys,
                 workdir, feed=feed, tokens=tokens)
    tag = "nmt_%s%s" % (amp_level or "fp32", "_dropout" if dropout else "")
    res = {"phase": "nmt", "amp_level": amp_level, "dropout": dropout,
           "config": config, "batch": batch, "seq": seq, "lr": lr,
           "params": t.n_params, "target_tokens": tokens,
           "source_tokens": int(feed["src_len"].sum())}
    res.update(t.timed_turns(warm, steps, tag + "_step", t0))
    # the main path's step: its graph's pool (autograd's saved tensors,
    # dropout masks among them, live at once) and its buffers
    (main_step,) = exe.step_cache.steps()
    res["graph_pool_gb"] = main_step.pool_bytes / 1e9
    res["step_gb"] = main_step.nbytes / 1e9
    res["graph_launches_per_step"] = (
        res["profile"]["host_launch_calls"]["graph_launches"] if t.cuda
        else None)
    saved, s0 = t.saved, exe.program_steps(main)
    nothing = contextlib.nullcontext
    graph, _ = t.one_step(main, saved, nothing(), step=s0)
    eager, res["kernel_eager_launches"] = t.one_step(
        main, saved, nothing(), eager=True, step=s0)
    far = None
    if amp_level:
        # the fp32 program draws the same masks: the same ops, the same
        # seed, the same step
        far, _ = t.one_step(build_nmt(config, batch, seq, lr, seed,
                                      dropout)[0], saved, nothing(),
                            eager=True, step=s0)

    def gate(a, b):
        return compare_amp(a, b, far, lr) if amp_level else \
            compare_steps(a, b, lr)

    res["graph_vs_eager"] = graph_vs_eager(graph, eager, gate(graph, eager))
    del eager
    checks = ["graph_vs_eager"]
    if not dropout:
        # the kernels (with lengths, non-causal and cross) against the
        # plain attention, op by op: in bf16 forward and backward
        # (compare_amp); in fp32 the whole step (compare_steps, GRAD_RTOL)
        # with every ReLU passing where the kernel step's did
        # (relu_pinned: the two forwards differ in their last bits, and an
        # FFN unit whose input lies that close to 0 passes the gradient in
        # one step and not in the other, a whole token's term of its
        # weight's gradient; those units are counted, and the unpinned
        # step's comparison at PATH_GRAD_RTOL printed), and the backward
        # kernels against the plain backward on K1's own forward
        plain, res["plain_launches"] = t.one_step(
            main, saved, plain_attention(), eager=True, step=s0)
        if amp_level:
            res["kernels_vs_plain"] = compare_amp(graph, plain, far, lr)
        else:
            res["kernels_vs_plain_unpinned"] = compare_steps(
                graph, plain, lr, PATH_GRAD_RTOL)
            del plain
            signs, flips = {}, {}
            with relu_pinned(signs):
                t.one_step(main, saved, nothing(), eager=True, step=s0)
            with relu_pinned(signs, flips):
                plain, _ = t.one_step(main, saved, plain_attention(),
                                      eager=True, step=s0)
            del signs
            res["kernels_vs_plain"] = compare_steps(graph, plain, lr)
            res["relu_flips"] = {
                "relus": len(flips), "units": sum(u for u, _ in
                                                  flips.values()),
                "flips": sum(f for _, f in flips.values()),
                "flip_share_max": max(f / u for u, f in flips.values()),
                "flips_by_relu": [f for _, f in flips.values()]}
            plain_bwd, res["plain_bwd_launches"] = t.one_step(
                main, saved, plain_attention(forward_kernel=True),
                eager=True, step=s0)
            res["bwd_kernels_vs_plain_bwd"] = compare_steps(graph,
                                                            plain_bwd, lr)
            checks.append("bwd_kernels_vs_plain_bwd")
            del plain_bwd
        checks.append("kernels_vs_plain")
        del plain
        fused_env = functools.partial(env_set, "PADDLE_TPU_FLASH_FUSED_BWD",
                                      "1")
        fused, _ = t.one_step(main, saved, fused_env(), step=s0)
        res["fused_bwd_vs_split"] = gate(fused, graph)
        res["fused_bwd_launches"] = t.replay_launches(main, fused_env())
        checks.append("fused_bwd_vs_split")
        del fused
    else:
        names = [op.output("Mask")[0] for op in main.global_block().ops
                 if op.type == "dropout"]
        t.restore(saved)
        exe.set_program_steps(main, s0)
        first = exe.run(main, feed, names, scope=scope, return_numpy=False)
        second = exe.run(main, feed, names, scope=scope, return_numpy=False)
        shares = [keep_share(m, dropout) for m in first]
        res["masks"] = {
            "ops": len(names), "dtype": str(first[0].dtype),
            "kept_share_min": min(s for s, _ in shares),
            "kept_share_max": max(s for s, _ in shares),
            "sigmas_max": max(abs(z) for _, z in shares),
            "sigmas_tol": KEEP_SIGMAS,
            "steps_differ": all(not bool((a == b).all())
                                for a, b in zip(first, second))}
        del first, second
        res["draws"] = dropout_draws(config, batch, seq, dropout, amp_level,
                                     seed, exe.device)
        if not res["masks"]["steps_differ"] or \
                res["masks"]["sigmas_max"] > KEEP_SIGMAS:
            fail("nmt dropout masks: %s" % json.dumps(res["masks"]))
    del graph, far
    res["step_cache"] = t.cache_line()
    for key in checks:
        if not res[key]["ok"]:
            fail("nmt step %s (%s, dropout %s) failed: %s"
                 % (key, amp_level or "fp32", dropout, json.dumps(res[key])))
    if t.cuda:
        none = dict.fromkeys(keys, 0)
        want = dict(none)
        n_att = 3 * config["n_layer"]
        names = BF16_KERNELS if amp_level else FP32_KERNELS
        if not dropout:
            want.update(dict.fromkeys(names[:3], n_att))
        expect = {"launches_per_step": want,
                  "main_path_host_launches": none,
                  "host_launches_per_graph_step": none,
                  "eager_launches_per_step": want,
                  "kernel_eager_launches": want}
        if not dropout:
            expect["fused_bwd_launches"] = {
                **none, names[0]: n_att, names[3]: n_att}
            expect["plain_launches"] = none
            if not amp_level:
                expect["plain_bwd_launches"] = {**none, names[0]: n_att}
        for key, counts in expect.items():
            if res[key] != counts:
                fail("nmt (%s, dropout %s): %s %s, expected %s"
                     % (amp_level or "fp32", dropout, key, res[key], counts))
        if res["graph_launches_per_step"] != 1:
            fail("nmt (%s, dropout %s): %s graph launches in the main "
                 "path's step, expected 1" % (amp_level or "fp32", dropout,
                                              res["graph_launches_per_step"]))
    exe.close()
    return res


def _qkv_split(tensors, n_head):
    """{name: tensor} with every fused ``.qkv.w``/``.qkv.b`` (and its
    @GRAD) split into the separate projections' ``.q``, ``.k``, ``.v``
    (columns grouped per head: [h0: q,k,v | h1: q,k,v | ...])."""
    out = {}
    for name, x in tensors.items():
        if ".qkv." not in name:
            out[name] = x
            continue
        lead, d3 = tuple(x.shape[:-1]), x.shape[-1]
        parts = x.reshape(lead + (n_head, 3, d3 // 3 // n_head))
        for i, which in enumerate("qkv"):
            out[name.replace(".qkv.", ".%s." % which)] = \
                parts[..., i, :].reshape(lead + (d3 // 3,))
    return out


def _qkv_fuse(get, name, n_head):
    """The fused ``name`` (a .qkv.w or .qkv.b) from the separate
    projections' tensors, ``get(name)`` each."""
    import torch

    parts = [get(name.replace(".qkv.", ".%s." % w)) for w in "qkv"]
    lead, d = tuple(parts[0].shape[:-1]), parts[0].shape[-1]
    return torch.stack([x.reshape(lead + (n_head, d // n_head))
                        for x in parts], dim=-2).reshape(lead + (3 * d,))


def run_lm_variants(config, batch, seq, lr, steps, seed, place, workdir,
                    amp_gates=True):
    """The flagship LM's other builds in bf16 O2, as bench.py builds them
    (minimize, then O2), against the separate-projection, fused-head
    program of the train_amp phase from one state: fused_qkv=True (the
    fused projections made from the separate ones, per head [q|k|v]) and
    fused_head=False (the same lm.head.w/.b through the logits and
    softmax_with_cross_entropy). Timed graph steps of the separate and
    the fused-q/k/v program in turns (ms each), a profiled fused-q/k/v
    step (one graph launch); then one step of each variant from the
    state (graph replays, their device launches), each held against the
    separate-projection step relative to the fp32 program's distance
    (compare_amp; the fused q/k/v's loss, gradients and parameters split
    back into .q/.k/.v), and the fp32 steps likewise (compare_steps).
    Runs on any place: the CPU tests rehearse it at a size where one
    Adam step's bf16 rounding is no measure of the card's, with
    ``amp_gates`` off (the bf16 comparisons are then returned, not
    gated)."""
    import torch
    from paddle_tpu_torch import Executor, Scope

    keys = FP32_KERNELS + BF16_KERNELS
    n_head = config["n_head"]
    exe, nothing = Executor(place), contextlib.nullcontext
    sep, sep_start, sep_loss = build_train(config, batch, seq, lr, seed,
                                           "O2")
    qkv, qkv_start, qkv_loss = build_train(dict(config, fused_qkv=True),
                                           batch, seq, lr, seed, "O2")
    unf, _, unf_loss = build_train(dict(config, fused_head=False), batch,
                                   seq, lr, seed, "O2")
    s_scope, q_scope = Scope(), Scope()
    exe.run(sep_start, scope=s_scope)
    exe.run(qkv_start, scope=q_scope)
    for v in qkv.list_vars():
        if v.persistable and v.name.endswith((".qkv.w", ".qkv.b")):
            q_scope.set_var(v.name, _qkv_fuse(s_scope.find_var, v.name,
                                              n_head).clone())
        elif v.persistable and s_scope.find_var(v.name) is not None:
            q_scope.set_var(v.name, s_scope.find_var(v.name).clone())
    ts = _Trainer(exe, s_scope, sep, sep_loss, config, batch, seq, seed,
                  keys, workdir)
    tq = _Trainer(exe, q_scope, qkv, qkv_loss, config, batch, seq, seed,
                  keys, workdir)
    tu = _Trainer(exe, s_scope, unf, unf_loss, config, batch, seq, seed,
                  keys, workdir)
    if set(tu.params) != set(ts.params):
        fail("the unfused head's parameters %s are not the fused head's"
             % sorted(set(tu.params) ^ set(ts.params)))
    saved_s, saved_q = ts.save(), tq.save()
    res = {"phase": "lm_variants", "amp_level": "O2", "config": config,
           "batch": batch, "seq": seq, "lr": lr}
    # timed graph steps in turns
    ms = {"separate": [], "fused_qkv": []}
    for name in ("separate", "fused_qkv", "fused_qkv", "separate"):
        tr = ts if name == "separate" else tq
        tr.step()
        tr.sync()
        for _ in range(steps):
            t1 = time.perf_counter()
            float(tr.step()[0])
            ms[name].append((time.perf_counter() - t1) * 1e3)
    res["step_ms"] = ms
    res["step_ms_mean"] = {k: float(np.mean(v)) for k, v in ms.items()}
    if tq.cuda:
        _device_counts((), reset=True)
        prof = profile_call(tq.step, os.path.join(
            workdir, "lm_fused_qkv_step_ops.txt"))
        res["fused_qkv_launches_per_step"] = _device_counts(keys)
        res["fused_qkv_graph_launches_per_step"] = \
            prof["host_launch_calls"]["graph_launches"]
        res["fused_qkv_profile"] = {k: prof[k] for k in (
            "device_busy_ms", "device_idle_share", "device_ms_by_kind")}
    # one step of each from the state, bf16 through graphs, fp32 op by op
    sep16, _ = ts.one_step(sep, saved_s, nothing())
    qkv16, _ = tq.one_step(qkv, saved_q, nothing())
    res["fused_qkv_replay_launches"] = tq.replay_launches(qkv, nothing())
    unf16, _ = tu.one_step(unf, saved_s, nothing())
    res["unfused_head_replay_launches"] = tu.replay_launches(unf, nothing())
    fp32 = {}
    for name, tr, saved, extra in (("sep", ts, saved_s, {}),
                                   ("qkv", tq, saved_q, {"fused_qkv": True}),
                                   ("unf", tu, saved_s,
                                    {"fused_head": False})):
        fp32[name], _ = tr.one_step(build_train(
            dict(config, **extra), batch, seq, lr, seed)[0], saved,
            nothing(), eager=True)

    def split(step):
        return (step[0], _qkv_split(step[1], n_head),
                _qkv_split(step[2], n_head))

    res.update({
        "fused_qkv_vs_separate": compare_amp(split(qkv16), sep16,
                                             fp32["sep"], lr),
        "fused_qkv_vs_separate_fp32": compare_steps(
            split(fp32["qkv"]), fp32["sep"], lr, PATH_GRAD_RTOL),
        "unfused_vs_fused_head": compare_amp(unf16, sep16, fp32["sep"],
                                             lr),
        "unfused_vs_fused_head_fp32": compare_steps(
            fp32["unf"], fp32["sep"], lr, PATH_GRAD_RTOL)})
    del sep16, qkv16, unf16, fp32
    res["step_cache"] = ts.cache_line()
    exe.close()
    gates = {key: res[key]["ok"] for key in (
        "fused_qkv_vs_separate_fp32", "unfused_vs_fused_head_fp32")}
    if amp_gates:
        gates.update({key: res[key]["ok"] for key in (
            "fused_qkv_vs_separate", "unfused_vs_fused_head")})
    res["gates_held"] = gates
    for key, ok in gates.items():
        if not ok:
            fail("lm_variants %s failed: %s" % (key, json.dumps(res[key])))
    if tq.cuda:
        none = dict.fromkeys(keys, 0)
        want = {**none, **dict.fromkeys(BF16_KERNELS[:3],
                                        config["n_layer"])}
        for key in ("fused_qkv_launches_per_step",
                    "fused_qkv_replay_launches",
                    "unfused_head_replay_launches"):
            if res[key] != want:
                fail("lm_variants: %s %s, expected %s"
                     % (key, res[key], want))
        if res["fused_qkv_graph_launches_per_step"] != 1:
            fail("lm_variants: %s graph launches in a fused q/k/v step, "
                 "expected 1" % res["fused_qkv_graph_launches_per_step"])
    return res


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------
# the training surface: the MoE LM, the noam recipe, every optimizer
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def moe_routing(record=None, pinned=None, flips=None, kept=None):
    """Every moe_ffn call's routing observed or pinned (parallel/moe.py):
    with ``record`` (a list) each round's expert choices are appended to
    it; with ``pinned`` (such a list, from another step) each round takes
    the recorded choices instead of its own, and appends to ``flips`` how
    many of its own choices differ; with ``kept`` each call's share of
    (token, choice) pairs kept under the capacity is appended. For steps
    op by op: a replayed graph calls none of this."""
    from paddle_tpu_torch.parallel import moe

    first_max, slots = moe.first_max, moe.dispatch_slots
    it = iter(pinned) if pinned is not None else None

    def pick(remaining):
        own = first_max(remaining)
        if it is not None:
            want = next(it)
            flips.append(int((own != want).sum()))
            own = want
        if record is not None:
            record.append(own.detach().clone())
        return own

    def dispatch(choices, num_experts, capacity):
        rows, keep = slots(choices, num_experts, capacity)
        if kept is not None:
            kept.append(keep.float().mean())
        return rows, keep

    moe.first_max, moe.dispatch_slots = pick, dispatch
    try:
        yield
    finally:
        moe.first_max, moe.dispatch_slots = first_max, slots


def _free(*objs):
    """Drop an earlier phase's executor (its cached steps and graph
    pools) and return the allocator's cache to the card."""
    import gc

    import torch

    for obj in objs:
        obj.close()
    if torch.cuda.is_available():
        gc.collect()
        torch.cuda.empty_cache()


def run_moe(config, batch, seq, lr, warm, steps, seed, place, workdir,
            compare_layers=MOE_COMPARE_LAYERS):
    """Train the MoE LM (``config`` with ``moe_experts``; the layer's
    defaults k 2, capacity factor 2.0) in bf16 O2 as bench.py trains its
    LM: timed in turns, graph and op by op, the main path's graph step
    profiled (busy ms by kind, the indexing kernels as "routing"), then
    one step op by op reading each layer's kept share of (token, choice)
    pairs. Then at ``compare_layers`` layers, full width, from one saved
    state: the step through its graph against the same step op by op
    (graph_vs_eager, bitwise), and against the plain attention's step
    with every MoE layer's routing pinned to the kernel step's choices
    (moe_routing; the flips counted), relative to the fp32 program's step
    (pinned the same way) by compare_amp. Runs on any place (the CPU
    tests rehearse it at a tiny size); the caller checks the launches."""
    from paddle_tpu_torch import Executor, Scope
    from paddle_tpu_torch.parallel.moe import moe_capacity

    keys = FP32_KERNELS + BF16_KERNELS
    t0 = time.perf_counter()
    main, startup, loss = build_train(config, batch, seq, lr, seed, "O2")
    exe, scope = Executor(place), Scope()
    exe.run(startup, scope=scope)
    t = _Trainer(exe, scope, main, loss, config, batch, seq, seed, keys,
                 workdir)
    experts = config["moe_experts"]
    res = {"phase": "moe", "amp_level": "O2", "config": config,
           "batch": batch, "seq": seq, "lr": lr, "params": t.n_params,
           "experts": experts, "k": 2, "capacity_factor": 2.0,
           "capacity": moe_capacity(batch * seq, experts, 2.0)}
    res.update(t.timed_turns(warm, steps, "moe_step", t0, save=False,
                             routing=True))
    (main_step,) = exe.step_cache.steps()
    res["graph_pool_gb"] = main_step.pool_bytes / 1e9
    res["step_gb"] = main_step.nbytes / 1e9
    res["graph_launches_per_step"] = (
        res["profile"]["host_launch_calls"]["graph_launches"] if t.cuda
        else None)
    kept = []
    with moe_routing(kept=kept), eager_steps():
        t.step()
    res["kept_share_by_layer"] = [float(v) for v in kept]
    res["step_cache"] = t.cache_line()
    del t, main_step, scope
    _free(exe)

    cfg = dict(config, n_layer=compare_layers)
    main, startup, loss = build_train(cfg, batch, seq, lr, seed, "O2")
    exe, scope = Executor(place), Scope()
    exe.run(startup, scope=scope)
    t = _Trainer(exe, scope, main, loss, cfg, batch, seq, seed, keys,
                 workdir)
    for _ in range(warm):
        t.step()
    saved, nothing = t.save(), contextlib.nullcontext
    graph, _ = t.one_step(main, saved, nothing())
    choices, flips, flips_far = [], [], []
    with moe_routing(record=choices):
        eager, _ = t.one_step(main, saved, nothing(), eager=True)
    with moe_routing(pinned=choices, flips=flips):
        plain, res["plain_launches"] = t.one_step(
            main, saved, plain_attention(), eager=True)
    with moe_routing(pinned=choices, flips=flips_far):
        far, _ = t.one_step(build_train(cfg, batch, seq, lr, seed)[0],
                            saved, nothing(), eager=True)
    res["compare_layers"] = compare_layers
    res["graph_vs_eager"] = graph_vs_eager(graph, eager, compare_amp(
        graph, eager, far, lr))
    res["kernels_vs_plain"] = compare_amp(graph, plain, far, lr)
    res["routing_flips"] = {
        "choices": len(choices) * batch * seq, "plain": sum(flips),
        "fp32": sum(flips_far), "plain_by_round": flips,
        "fp32_by_round": flips_far}
    del graph, eager, plain, far, saved, t, scope
    _free(exe)
    if not res["graph_vs_eager"]["bitwise"]:
        fail("moe: the graph step is not the eager step bitwise: %s"
             % json.dumps(res["graph_vs_eager"]))
    if not res["kernels_vs_plain"]["ok"]:
        fail("moe: the kernel step against the plain attention's (routing "
             "pinned) failed: %s" % json.dumps(res["kernels_vs_plain"]))
    if not all(0 < s <= 1 for s in res["kept_share_by_layer"]):
        fail("moe: kept shares %s" % res["kept_share_by_layer"])
    return res


def build_nmt_noam(config, batch, seq, seed):
    """get_model's Transformer under the paper's recipe (Vaswani et al.
    2017 §5.3): noam_decay(d_model, NOAM_WARMUP) as the learning rate of
    Adam(NOAM_ADAM), dropout 0, bf16 O2: (main, startup, loss, lr)."""
    from paddle_tpu_torch import (Program, layers, optimizer, program_guard,
                                  unique_name)
    from paddle_tpu_torch.models import transformer

    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = seed
    with program_guard(main, startup), unique_name.guard():
        loss, _, _ = transformer.get_model(
            batch_size=batch, seq_len=seq, dropout_rate=0.0, **config)
        lr = layers.noam_decay(config["d_model"], NOAM_WARMUP)
        optimizer.Adam(learning_rate=lr, **NOAM_ADAM).minimize(loss)
        main.enable_mixed_precision(level="O2")
    return main, startup, loss, lr


def noam_lr(d_model, warmup, s):
    """d_model^-0.5 min(s^-0.5, s warmup^-1.5), in float64."""
    s = np.asarray(s, np.float64)
    return d_model ** -0.5 * np.minimum(s ** -0.5, s * warmup ** -1.5)


def run_nmt_noam(config, batch, seq, min_len, seed, place, workdir, steps,
                 loop_k):
    """The nmt phase's bf16 O2 Transformer under noam_decay and Adam(β2
    0.98, ε 1e-9): ``steps`` graph steps through Executor.run fetching the
    loss and the lr (timed after the first two), then the main path's
    step profiled (device counters zeroed before it); the lr of every
    step against the formula at s = 1, 2, ...; then run_loop(loop_k)
    from a saved state against loop_k run calls from it (every
    persistable bitwise, the step counter among them, and the last lr)."""
    import torch
    from paddle_tpu_torch import Executor, Scope

    keys = FP32_KERNELS + BF16_KERNELS
    main, startup, loss, lr = build_nmt_noam(config, batch, seq, seed)
    exe, scope = Executor(place), Scope()
    exe.run(startup, scope=scope)
    feed = nmt_feed(config, batch, seq, min_len, seed, exe.device)
    tokens = int(feed["tgt_len"].sum())
    t = _Trainer(exe, scope, main, loss, None, batch, seq, seed, keys,
                 workdir, feed=feed, tokens=tokens)
    lrs, ms, losses = [], [], []

    def step():
        out = exe.run(main, feed, [loss, lr], scope=scope,
                      return_numpy=False)
        losses.append(float(out[0]))
        lrs.append(float(out[1].reshape(())))

    for _ in range(steps):
        t.sync()
        t1 = time.perf_counter()
        step()
        ms.append((time.perf_counter() - t1) * 1e3)
    res = {"phase": "nmt_noam", "amp_level": "O2", "config": config,
           "batch": batch, "seq": seq, "warmup": NOAM_WARMUP,
           "adam": NOAM_ADAM, "target_tokens": tokens, "step_ms": ms,
           "step_ms_mean": float(np.mean(ms[2:]))}
    res["tokens_per_s"] = tokens / (res["step_ms_mean"] / 1e3)
    _launch_counts(reset=True)
    if t.cuda:
        _device_counts((), reset=True)
        res["profile"] = profile_call(step, os.path.join(
            workdir, "nmt_noam_step_ops.txt"))
        res["launches_per_step"] = _device_counts(keys)
        res["graph_launches_per_step"] = res["profile"][
            "host_launch_calls"]["graph_launches"]
    else:
        step()
        res["launches_per_step"] = dict.fromkeys(keys, 0)
        res["graph_launches_per_step"] = None
    res["main_path_host_launches"] = _launch_counts(keys=keys)
    want = noam_lr(config["d_model"], NOAM_WARMUP,
                   np.arange(1, len(lrs) + 1))
    res["lrs"] = lrs
    res["lr_rel_err_max"] = float(np.max(np.abs(np.asarray(lrs) - want)
                                         / want))
    res["losses"] = losses
    saved = t.save()
    counter = "@STEP_COUNTER@"
    loop = exe.run_loop(main, feed, [loss, lr], steps=loop_k, scope=scope,
                        return_numpy=False)
    after_loop = t.save()
    t.restore(saved)
    for _ in range(loop_k):
        runs = exe.run(main, feed, [loss, lr], scope=scope,
                       return_numpy=False)
    after_runs = t.save()
    res["loop_vs_runs"] = {
        "steps": loop_k, "counter_before": int(saved[counter][0]),
        "counter_after": int(after_loop[counter][0]),
        "lr": float(loop[1].reshape(())),
        "bitwise": (all(torch.equal(after_loop[n], after_runs[n])
                        for n in saved)
                    and torch.equal(loop[0], runs[0])
                    and torch.equal(loop[1], runs[1]))}
    res["step_cache"] = t.cache_line()
    del t, saved, after_loop, after_runs, scope
    _free(exe)
    if not res["lr_rel_err_max"] <= NOAM_LR_RTOL or \
            not np.all(np.isfinite(losses)):
        fail("nmt_noam: lr %s against %s (rel err %s), losses %s"
             % (lrs, want.tolist(), res["lr_rel_err_max"], losses))
    lvr = res["loop_vs_runs"]
    if not lvr["bitwise"] or \
            lvr["counter_after"] != lvr["counter_before"] + loop_k:
        fail("nmt_noam: run_loop(%d) against %d runs: %s"
             % (loop_k, loop_k, json.dumps(lvr)))
    return res


# each optimizer the phase trains, as a user would set it up
OPT_RECIPES = ("Adam", "SGD", "Momentum", "Momentum_nesterov", "Adagrad",
               "Adamax", "DecayedAdagrad", "Adadelta", "RMSProp", "Ftrl",
               "Adam_L2Decay", "Adam_ClipByGlobalNorm", "Momentum_LARS",
               "Adam_ModelAverage")


def minimize_recipe(name, loss, main):
    """Minimize ``loss`` by recipe ``name`` (OPT_RECIPES); returns the
    ModelAverage of that recipe, else None."""
    from paddle_tpu_torch import clip, layers, optimizer, regularizer

    if name == "Momentum_LARS":
        lr = layers.exponential_decay(1e-3, 1000, 0.9)
        opt = optimizer.Momentum(lr, momentum=0.9)
        params_grads = opt.backward(loss)
        layers.append_LARS(params_grads, lr, 1e-4)
        opt.apply_gradients(params_grads)
        return None
    if name == "Adam_ClipByGlobalNorm":
        clip.set_gradient_clip(clip.GradientClipByGlobalNorm(1.0),
                               program=main)
    {"Adam": lambda: optimizer.Adam(1e-4),
     "SGD": lambda: optimizer.SGD(1e-2),
     "Momentum": lambda: optimizer.Momentum(1e-3, momentum=0.9),
     "Momentum_nesterov": lambda: optimizer.Momentum(
         1e-3, momentum=0.9, use_nesterov=True),
     "Adagrad": lambda: optimizer.Adagrad(1e-3),
     "Adamax": lambda: optimizer.Adamax(1e-4),
     "DecayedAdagrad": lambda: optimizer.DecayedAdagrad(1e-3),
     "Adadelta": lambda: optimizer.Adadelta(1.0),
     "RMSProp": lambda: optimizer.RMSProp(1e-4),
     "Ftrl": lambda: optimizer.Ftrl(1e-3, l1=1e-5, l2=1e-5),
     "Adam_L2Decay": lambda: optimizer.Adam(
         1e-4, regularization=regularizer.L2Decay(1e-4)),
     "Adam_ClipByGlobalNorm": lambda: optimizer.Adam(1e-4),
     "Adam_ModelAverage": lambda: optimizer.Adam(1e-4)}[name]().minimize(
        loss)
    if name == "Adam_ModelAverage":
        return optimizer.ModelAverage(0.15, min_average_window=2,
                                      max_average_window=10)
    return None


def build_recipe(config, batch, seq, seed, name):
    """transformer_lm minimized by recipe ``name``, then bf16 O2:
    (main, startup, loss, its ModelAverage or None)."""
    from paddle_tpu_torch import (Program, layers, program_guard,
                                  unique_name)
    from paddle_tpu_torch.models import transformer

    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = seed
    with program_guard(main, startup), unique_name.guard():
        ids = layers.data(name="ids", shape=[batch, seq], dtype="int64",
                          append_batch_size=False)
        labels = layers.data(name="labels", shape=[batch, seq],
                             dtype="int64", append_batch_size=False)
        loss, _ = transformer.transformer_lm(ids, labels, **config)
        avg = minimize_recipe(name, loss, main)
        main.enable_mixed_precision(level="O2")
    return main, startup, loss, avg


class _OpCtx:
    """The smallest op context an optimizer kernel reads."""

    def __init__(self, inputs, attrs):
        self._inputs, self._attrs = inputs, attrs

    def input(self, slot, default=None):
        return self._inputs.get(slot, default)

    def attr(self, name, default=None):
        return self._attrs.get(name, default)


def check_optimizer_ops(p, g):
    """Every optimizer op of ops/optim.py on the card, in fp32, on a real
    parameter ``p`` and its gradient ``g`` (accumulators made from them),
    against the same formula in float64 on the same (fp32-valued) inputs:
    each output's largest difference over its largest magnitude."""
    import torch
    from paddle_tpu_torch.ops import registry

    dev = p.device

    def one(v):
        return torch.tensor([v], dtype=torch.float32, device=dev)

    pos = g * g * 0.5 + 1e-8
    base = {"Param": p, "Grad": g, "LearningRate": one(1e-3)}
    cases = {
        "sgd": ({}, {}),
        "momentum": ({"Velocity": 0.1 * g}, {"mu": 0.9,
                                             "use_nesterov": True}),
        "adam": ({"Moment1": 0.1 * g, "Moment2": pos,
                  "Beta1Pow": one(0.9 ** 3), "Beta2Pow": one(0.999 ** 3)},
                 {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
        "adamax": ({"Moment": 0.1 * g, "InfNorm": 0.5 * g.abs(),
                    "Beta1Pow": one(0.9 ** 3)}, {}),
        "adagrad": ({"Moment": pos}, {}),
        "decayed_adagrad": ({"Moment": pos}, {}),
        "adadelta": ({"AvgSquaredGrad": pos,
                      "AvgSquaredUpdate": 1e-2 * pos}, {}),
        "rmsprop": ({"MeanSquare": pos, "Moment": 0.1 * g},
                    {"momentum": 0.5}),
        "ftrl": ({"SquaredAccumulator": pos, "LinearAccumulator": 0.1 * g},
                 {"l1": 1e-5, "l2": 1e-5}),
        "proximal_gd": ({}, {"l1": 1e-5, "l2": 1e-4}),
        "proximal_adagrad": ({"Moment": pos}, {"l1": 1e-5, "l2": 1e-4}),
    }
    counts = {n: torch.tensor([v], dtype=torch.int64, device=dev)
              for n, v in (("in_num_accumulates", 4),
                           ("in_old_num_accumulates", 2),
                           ("in_num_updates", 16383))}
    cases["average_accumulates"] = (
        dict(param=p, in_sum_1=0.5 * p, in_sum_2=0.25 * p, in_sum_3=p,
             **counts),
        {"average_window": 0.5, "max_average_window": 5,
         "min_average_window": 5})
    out = {}
    for op, (extra, attrs) in cases.items():
        inputs = extra if op == "average_accumulates" else {**base, **extra}
        got = registry.get_kernel(op)(_OpCtx(inputs, attrs))
        ref = registry.get_kernel(op)(_OpCtx(
            {k: v.double() if v.is_floating_point() else v
             for k, v in inputs.items()}, attrs))
        out[op] = max(
            float((got[k].double() - ref[k]).abs().max())
            / max(float(ref[k].double().abs().max()), 1e-30) for k in ref)
    return out


def run_optimizers(config, batch, seq, seed, place, workdir, warm, steps):
    """bench.py's LM at ``config`` (full width, cut in depth), bf16 O2,
    trained by each of OPT_RECIPES: ``warm`` + ``steps`` graph steps
    through Executor.run (ms of the last ``steps``, losses finite), the
    main path's step profiled (one graph launch; device counters zeroed
    before it), then from a saved state the step through its graph
    against the same step op by op (bitwise). ModelAverage: apply, then
    restore (the parameters back bitwise), then a replay straight after
    against the same step op by op from that state. Then every optimizer
    op on the card against float64 (check_optimizer_ops) on the Adam
    recipe's first FFN weight and its gradient."""
    import torch
    from paddle_tpu_torch import Executor, Scope, scope_guard

    keys = FP32_KERNELS + BF16_KERNELS
    nothing = contextlib.nullcontext
    res = {"phase": "optimizers", "amp_level": "O2", "config": config,
           "batch": batch, "seq": seq, "warm": warm, "steps": steps,
           "recipes": {}}
    op_inputs = None
    for name in OPT_RECIPES:
        t0 = time.perf_counter()
        main, startup, loss, avg = build_recipe(config, batch, seq, seed,
                                                name)
        exe, scope = Executor(place), Scope()
        exe.run(startup, scope=scope)
        t = _Trainer(exe, scope, main, loss, config, batch, seq, seed, keys,
                     workdir)

        def step():
            return exe.run(main, t.feed, [loss] + t.grads, scope=scope,
                           return_numpy=False)

        ms, losses = [], []
        for i in range(warm + steps):
            t.sync()
            t1 = time.perf_counter()
            losses.append(float(step()[0]))
            if i >= warm:
                ms.append((time.perf_counter() - t1) * 1e3)
        got = {"step_ms": ms, "step_ms_mean": float(np.mean(ms)),
               "losses": losses,
               "ops": sorted({op.type for op in main.global_block().ops
                              if op.type in OPT_OP_TYPES})}
        if t.cuda:
            _device_counts((), reset=True)
            prof = profile_call(step, os.path.join(
                workdir, "optimizers_%s_step_ops.txt" % name))
            got["launches_per_step"] = _device_counts(keys)
            got["graph_launches_per_step"] = prof["host_launch_calls"][
                "graph_launches"]
        saved = t.save()
        graph, _ = t.one_step(main, saved, nothing())
        eager, _ = t.one_step(main, saved, nothing(), eager=True)
        got["graph_vs_eager"] = graph_vs_eager(graph, eager, {"ok": False})
        if name == "Adam":
            p = "lm.l0.ffn.fc1.w"
            op_inputs = (saved[p], graph[1][p + "@GRAD"].clone())
        del graph, eager
        if avg is not None:
            # one step from the saved state first, so that the scope holds
            # the step's own state buffers, which apply and restore write
            t.restore(saved)
            step()
            before = {n: scope.find_var(n).clone() for n in t.params}
            held = {n: scope.find_var(n) for n in t.params}
            with scope_guard(scope):
                avg.apply(exe)
                moved = any(not torch.equal(scope.find_var(n), before[n])
                            for n in t.params)
                avg.restore(exe)
            back = all(torch.equal(scope.find_var(n), before[n])
                       and scope.find_var(n) is held[n] for n in t.params)
            state = t.save()
            outs = step()   # a replay over the restored tensors, in place
            t.sync()
            replay = (outs[0], dict(zip(t.grads, outs[1:])),
                      {n: scope.find_var(n).clone() for n in t.params})
            ref, _ = t.one_step(main, state, nothing(), eager=True)
            got["model_average"] = {
                "apply_moved_params": moved, "restore_bitwise": back,
                "replay_vs_eager": graph_vs_eager(replay, ref,
                                                  {"ok": False})}
            del replay, ref, state, before, held
        got["seconds"] = time.perf_counter() - t0
        res["recipes"][name] = got
        del t, saved, scope
        _free(exe)
    adam_ms = res["recipes"]["Adam"]["step_ms_mean"]
    for got in res["recipes"].values():
        got["vs_adam"] = got["step_ms_mean"] / adam_ms
    res["op_rel_err"] = check_optimizer_ops(*op_inputs)
    res["op_rtol"] = OPT_OP_RTOL
    del op_inputs
    bad = []
    for name, got in res["recipes"].items():
        if not np.all(np.isfinite(got["losses"])):
            bad.append((name, "losses", got["losses"]))
        if not got["graph_vs_eager"]["bitwise"]:
            bad.append((name, "graph_vs_eager", got["graph_vs_eager"]))
        ma = got.get("model_average")
        if ma is not None and not (ma["apply_moved_params"]
                                   and ma["restore_bitwise"]
                                   and ma["replay_vs_eager"]["bitwise"]):
            bad.append((name, "model_average", ma))
    bad += [(op, "rel_err", e) for op, e in res["op_rel_err"].items()
            if not e <= OPT_OP_RTOL]
    if bad:
        fail("optimizers: %s" % json.dumps(bad))
    return res


# ---------------------------------------------------------------------------


def check_launches(phase, res, want, paths):
    """A training line's kernel launches: the main path's graph step (the
    device's counts in the replay) as ``want``, with none launched from
    the host there or in the timed graph steps; each timed eager step and
    the eager kernel step launch ``want`` from the host; the plain
    attention pass launches no attention kernel; ``paths``: line key ->
    expected counts (the knob and program paths, as the device counts a
    replay; the plain-backward pass, from the host)."""
    none = dict.fromkeys(want, 0)
    expect = {"launches_per_step": want, "main_path_host_launches": none,
              "host_launches_per_graph_step": none,
              "eager_launches_per_step": want,
              "kernel_eager_launches": want, "plain_launches": none,
              **paths}
    for key, counts in expect.items():
        if res[key] != counts:
            fail("%s: %s %s, expected %s" % (phase, key, res[key], counts))


def _smi_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail("nvidia-smi failed: %s" % r.stderr.strip())
    return r.stdout.strip().splitlines()[0]


def run_k4_ablations(torch, dev, seed, rounds):
    """--k4-ablations: K4-bf16's kernel (its launch alone, into one fp32
    dq buffer) with each part of K4_ABLATIONS left out, and K2-dkv-bf16,
    timed in turns at the two timed shapes (causal, BTHD); one line per
    shape, every round's time of each."""
    from concurrent.futures import ThreadPoolExecutor

    from paddle_tpu_torch.kernels import build_all
    from paddle_tpu_torch.ops import attention as A

    variants = {name: ("K4_BF16_OMIT=%d" % n,) if n else ()
                for name, n in K4_ABLATIONS.items()}
    with ThreadPoolExecutor(len(variants)) as pool:
        list(pool.map(lambda defs: build_all(["flash_bwd_fused_bf16"], defs),
                      variants.values()))
    gen = torch.Generator(device=dev).manual_seed(seed)
    times = {}
    for b, t, h, d in ((TRAIN_BATCH, TRAIN_SEQ, 16, 64), (8, 1024, 8, 128)):
        q, k, v, do = _bf16_inputs(torch, gen, dev, (b, t, h, d), 4)
        out, lse = A.flash_attention_fwd(q, k, v, True, None, None, "bthd")
        delta = A.attention_delta(out, do, "bthd")
        qs = A.prescale_q(q, 1.0 / math.sqrt(d))
        sargs = (qs, k, v, lse, delta, do, True, None, "bthd")
        grads = (torch.zeros(qs.shape, dtype=torch.float32, device=dev),
                 torch.empty_like(k), torch.empty_like(v))
        fns = {name: functools.partial(
            A._launch_bwd, "fused", qs, k, v, lse, delta, do, grads, True,
            None, None, "bthd", defs) for name, defs in variants.items()}
        fns["k2_dkv"] = functools.partial(A.flash_attention_bwd_dkv_bf16,
                                          *sargs)
        times[b, t, h, d] = {name: [] for name in fns}
        for _ in range(rounds):
            for name, fn in fns.items():
                times[b, t, h, d][name].append(time_ms(fn))
    for shape in times:
        emit({"case": "K4-bf16 ablations", "shape": list(shape),
              "layout": "bthd", "causal": True, "ms": times[shape]})
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--k4-ablations", action="store_true",
                    help="time K4-bf16 with parts left out, and nothing else")
    ap.add_argument("--rounds", type=int, default=3,
                    help="--k4-ablations: turns over the variants")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card "
              "only", file=sys.stderr)
        return 2
    sys.path.insert(0, _ROOT)
    import paddle_tpu_torch  # noqa: F401  (fails outside the repo)
    from paddle_tpu_torch.kernels import build_all

    from paddle_tpu_torch.framework.scope import fp32_sums

    fp32_sums()
    dev = torch.device("cuda", 0)
    smi = _smi_line()
    print(smi, flush=True)
    if args.k4_ablations:
        return run_k4_ablations(torch, dev, args.seed, args.rounds)
    t0 = time.perf_counter()
    built = build_all()
    build_wall_s = time.perf_counter() - t0
    # the host runtime (recordio, prefetch, channels): g++, on first use
    from paddle_tpu_torch.runtime import build as rt_build
    from paddle_tpu_torch.runtime.recordio import native_available

    if not native_available():
        fail("the runtime library (runtime.cc) did not build: %s"
             % rt_build.build_error())
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "build_s": built, "build_wall_s": build_wall_s,
          "runtime_build_s": rt_build.build_seconds,
          "runtime_library": os.path.relpath(rt_build.lib_path(), _ROOT)})

    # prompt lengths of the slice, drawn first: K3 is timed at the
    # lengths of the slice's last decode step
    rng = np.random.default_rng(args.seed)
    prompt_lens = rng.integers(256, 1001, N_PROMPTS)
    prompt_lens[0] = 1000  # pins the prefill bucket at T=1024
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    tc = TRAIN_CONFIG
    tb, tt, th = TRAIN_BATCH, TRAIN_SEQ, tc["n_head"]
    td = tc["d_model"] // th
    # K1 at the training shape in both layouts and at the serving shape
    k1 = check_flash(torch, gen, dev, tb, tt, th, td, True, "bthd",
                     time_it=True)
    k1_bhtd = check_flash(torch, gen, dev, tb, tt, th, td, True, "bhtd",
                          time_it=True)
    k1_serve = check_flash(torch, gen, dev, 8, 1024, 8, 128, True, "bthd",
                           time_it=True)
    k1_cases = [k1, k1_bhtd, k1_serve]
    k1_cases.append(check_flash(torch, gen, dev, 8, 200, 8, 128, False,
                                "bthd"))
    k1_cases.append(check_flash(torch, gen, dev, 3, 200, 4, 64, True, "bhtd",
                                lengths=[0, 77, 200]))
    # one row past a 128-row tile, and a single row; lengths 0, 1 and T
    for t, d, causal, layout in itertools.product(
            (129, 1), (64, 128), (True, False), ("bthd", "bhtd")):
        k1_cases.append(check_flash(torch, gen, dev, 2, t, 2, d, causal,
                                    layout))
    for causal, layout in ((True, "bthd"), (False, "bhtd")):
        k1_cases.append(check_flash(torch, gen, dev, 3, 129, 2, 128, causal,
                                    layout, lengths=[0, 1, 129]))
    emit({"case": "K1 worst", "cases": len(k1_cases), "tol": KERNEL_TOL,
          "max_abs_err": max(r["max_abs_err"] for r in k1_cases),
          "lse_max_abs_err": max(r["lse_max_abs_err"] for r in k1_cases)})
    # K2 and K4 at the training shape in both layouts, and edge cases
    bwd = check_flash_bwd(torch, gen, dev, tb, tt, th, td, True, "bthd",
                          time_it=True)
    check_flash_bwd(torch, gen, dev, tb, tt, th, td, True, "bhtd",
                    time_it=True)
    check_flash_bwd(torch, gen, dev, 2, 200, 4, 64, False, "bthd")
    check_flash_bwd(torch, gen, dev, 2, 200, 2, 128, True, "bthd")
    check_flash_bwd(torch, gen, dev, 3, 200, 4, 64, True, "bhtd",
                    lengths=[0, 77, 200])
    check_flash_bwd(torch, gen, dev, 3, 200, 2, 128, False, "bthd",
                    lengths=[0, 77, 200])
    # one row past a 128-row tile, and a single row
    for t, d, causal, layout in itertools.product(
            (129, 1), (64, 128), (True, False), ("bthd", "bhtd")):
        check_flash_bwd(torch, gen, dev, 2, t, 2, d, causal, layout)
    check_flash_bwd(torch, gen, dev, 3, 129, 2, 64, True, "bthd",
                    lengths=[0, 1, 129])
    check_flash_bwd(torch, gen, dev, 3, 129, 2, 128, False, "bhtd",
                    lengths=[0, 1, 129])
    # the bf16 twins at the training shape (timed), at Dh 128 (B 8, T 1024,
    # H 8, timed), in BHTD, and at the fp32 kernels' edge cases
    k1b = check_flash_bf16(torch, gen, dev, tb, tt, th, td, True, "bthd",
                           time_it=True)
    k1b_128 = check_flash_bf16(torch, gen, dev, 8, 1024, 8, 128, True,
                               "bthd", time_it=True)
    k1b_cases = [k1b, k1b_128, check_flash_bf16(
        torch, gen, dev, tb, tt, th, td, True, "bhtd")]
    k1b_cases.append(check_flash_bf16(torch, gen, dev, 3, 200, 4, 64, True,
                                      "bhtd", lengths=[0, 77, 200]))
    for t, d, causal, layout in itertools.product(
            BF16_EDGE_T, (64, 128), (True, False), ("bthd", "bhtd")):
        k1b_cases.append(check_flash_bf16(torch, gen, dev, 2, t, 2, d,
                                          causal, layout))
    for (t, tk, causal), d in itertools.product(BF16_EDGE_TQ_TK, (64, 128)):
        k1b_cases.append(check_flash_bf16(
            torch, gen, dev, 2, t, 2, d, causal,
            "bthd" if d == 64 else "bhtd", tk=tk))
    for causal, layout in ((True, "bthd"), (False, "bhtd")):
        k1b_cases.append(check_flash_bf16(torch, gen, dev, 3, 129, 2, 128,
                                          causal, layout,
                                          lengths=[0, 1, 129]))
    for d, causal, layout in itertools.product(
            (64, 128), (True, False), ("bthd", "bhtd")):
        k1b_cases.append(check_flash_bf16(torch, gen, dev, 4, 193, 2, d,
                                          causal, layout,
                                          lengths=BF16_EDGE_LENGTHS))
    for (b1, h1), d, causal, layout in itertools.product(
            BF16_EDGE_BH, (64, 128), (True, False), ("bthd", "bhtd")):
        k1b_cases.append(check_flash_bf16(torch, gen, dev, b1, 129, h1, d,
                                          causal, layout))
    k1b_cases.append(check_flash_bf16(torch, gen, dev, 1, 193, 2, 64, True,
                                      "bthd", lengths=[65]))
    emit({"case": "K1-bf16 worst", "cases": len(k1b_cases),
          "err_ratio_max": max(r["err_ratio"] for r in k1b_cases),
          "max_abs_err": max(r["max_abs_err"] for r in k1b_cases),
          "lse_max_abs_err": max(r["lse_max_abs_err"] for r in k1b_cases),
          "bitwise_repeat": all(r["bitwise_repeat"] for r in k1b_cases)})
    bwdb = check_flash_bwd_bf16(torch, gen, dev, tb, tt, th, td, True,
                                "bthd", time_it=True)
    bwdb_128 = check_flash_bwd_bf16(torch, gen, dev, 8, 1024, 8, 128, True,
                                    "bthd", time_it=True)
    bwdb_cases = [bwdb, bwdb_128, check_flash_bwd_bf16(
        torch, gen, dev, tb, tt, th, td, True, "bhtd")]
    bwdb_cases.append(check_flash_bwd_bf16(torch, gen, dev, 3, 200, 4, 64,
                                           True, "bhtd",
                                           lengths=[0, 77, 200]))
    for t, d, causal, layout in itertools.product(
            BF16_EDGE_T, (64, 128), (True, False), ("bthd", "bhtd")):
        bwdb_cases.append(check_flash_bwd_bf16(torch, gen, dev, 2, t, 2, d,
                                               causal, layout))
    for (t, tk, causal), d in itertools.product(BF16_EDGE_TQ_TK, (64, 128)):
        bwdb_cases.append(check_flash_bwd_bf16(
            torch, gen, dev, 2, t, 2, d, causal,
            "bthd" if d == 64 else "bhtd", tk=tk))
    bwdb_cases.append(check_flash_bwd_bf16(torch, gen, dev, 3, 129, 2, 64,
                                           True, "bthd", lengths=[0, 1, 129]))
    bwdb_cases.append(check_flash_bwd_bf16(torch, gen, dev, 3, 129, 2, 128,
                                           False, "bhtd",
                                           lengths=[0, 1, 129]))
    for d, causal, layout in itertools.product(
            (64, 128), (True, False), ("bthd", "bhtd")):
        bwdb_cases.append(check_flash_bwd_bf16(torch, gen, dev, 4, 193, 2, d,
                                               causal, layout,
                                               lengths=BF16_EDGE_LENGTHS))
    for (b1, h1), d, causal, layout in itertools.product(
            BF16_EDGE_BH, (64, 128), (True, False), ("bthd", "bhtd")):
        bwdb_cases.append(check_flash_bwd_bf16(torch, gen, dev, b1, 129, h1,
                                               d, causal, layout))
    bwdb_cases.append(check_flash_bwd_bf16(torch, gen, dev, 1, 193, 2, 128,
                                           False, "bhtd", lengths=[65]))
    emit({"case": "K2/K4-bf16 worst", "cases": len(bwdb_cases),
          "err_ratio_max": max(v for r in bwdb_cases for key, v in r.items()
                               if key.endswith("_err_ratio")),
          "K2_max_abs_err": max(r["K2_max_abs_err"] for r in bwdb_cases),
          "K4_max_abs_err": max(r["K4_max_abs_err"] for r in bwdb_cases),
          "K2_bitwise_repeat": all(r["bitwise_repeat"] for r in bwdb_cases),
          "K4_dkv_bitwise_repeat": all(r["K4_dkv_bitwise_repeat"]
                                       for r in bwdb_cases)})
    # K1, K2 and K4 on the tensor cores, in TF32, and their twins in bf16:
    # a fact about the binaries
    from paddle_tpu_torch.kernels import library_path

    sass = {}
    for lib, names, kind in (
            ("flash_fwd", ("flash_fwd",), "TF32"),
            ("flash_bwd", ("flash_bwd_dq", "flash_bwd_dkv"), "TF32"),
            ("flash_bwd_fused", ("flash_bwd_fused",), "TF32"),
            ("flash_fwd_bf16", ("flash_fwd_bf16",), "BF16"),
            ("flash_bwd_bf16", ("flash_bwd_dq_bf16", "flash_bwd_dkv_bf16"),
             "BF16"),
            ("flash_bwd_fused_bf16", ("flash_bwd_fused_bf16",), "BF16")):
        sass.update(sass_report(library_path(lib), names, kind))
    emit({"case": "SASS", "kernels": sass})
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "flash_bwd_fused", "flash_fwd_bf16", "flash_bwd_dq_bf16",
                 "flash_bwd_dkv_bf16", "flash_bwd_fused_bf16"):
        for d in (64, 128):
            got = sass.get("%s<%d>" % (name, d), {})
            if not got.get("tc_instructions"):
                fail("%s<%d> has no %s tensor-core instruction in its "
                     "SASS: %s" % (name, d, "BF16" if "bf16" in name
                                   else "TF32", got))
            # K1-bf16, K2-bf16 and K4-bf16 run on wgmma, with nothing in
            # local memory
            if name in WGMMA_KERNELS and (not got["hgmma"] or got["local"]):
                fail("%s<%d> must issue wgmma (HGMMA) and keep nothing in "
                     "local memory: %s" % (name, d, got))
    # K3 at the slice's last-step lengths, with every slot full and with
    # every slot empty (all timed: the two first give its rate and what a
    # call costs beside the bytes, the last the cost of its grid alone),
    # then edge lengths around its split and the slab's end (one past S,
    # which reads S rows) at both head dims
    from paddle_tpu_torch.ops.kv_cache import decode_kernel_split

    S, split = 2048, decode_kernel_split()
    k3 = check_decode(torch, gen, dev, 8, S, 8, 128,
                      [int(n) + MAX_NEW - 1 for n in prompt_lens],
                      time_it=True)
    k3_full = check_decode(torch, gen, dev, 8, S, 8, 128, [S] * 8,
                           time_it=True, yardsticks=False)
    k3_empty = check_decode(torch, gen, dev, 8, S, 8, 128, [0] * 8,
                            time_it=True, yardsticks=False)
    k3_cases = [k3, k3_full, k3_empty]
    for d in (128, 64):
        k3_cases.append(check_decode(
            torch, gen, dev, 8, S, 8, d,
            [0, 1, split - 1, split, split + 1, S - 1, S, S + 1]))
    k3_cases.append(check_decode(torch, gen, dev, 8, S, 8, 128,
                                 [0, 1, 1000, S, 511, 512, 513, 7]))
    k3_cases.append(check_decode(torch, gen, dev, 4, 300, 2, 64,
                                 [0, 1, 257, 300]))
    emit({"case": "K3 worst", "cases": len(k3_cases), "tol": KERNEL_TOL,
          "split": split,
          "max_abs_err": max(r["max_abs_err"] for r in k3_cases),
          "bitwise_repeat": all(r["bitwise_repeat"] for r in k3_cases)})

    workdir = os.path.join(_ROOT, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    from paddle_tpu_torch import CUDAPlace

    tr = run_train(TRAIN_CONFIG, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR,
                   WARM_STEPS, TIMED_STEPS, args.seed, CUDAPlace(0), workdir)
    tr["gpu"] = smi
    emit(tr)
    n_layer = TRAIN_CONFIG["n_layer"]
    want = {"K1": n_layer, "K2-dq": n_layer, "K2-dkv": n_layer, "K4": 0}
    check_launches("train", tr, want, {
        "fused_bwd_launches": {**want, "K2-dq": 0, "K2-dkv": 0,
                               "K4": n_layer},
        "bhtd_launches": want,
        "plain_bwd_launches": {**dict.fromkeys(want, 0), "K1": n_layer}})
    torch.cuda.empty_cache()

    ta = run_train_amp(TRAIN_CONFIG, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR,
                       WARM_STEPS, TIMED_STEPS, args.seed, CUDAPlace(0),
                       workdir)
    ta["gpu"] = smi
    emit(ta)
    none = dict.fromkeys(FP32_KERNELS + BF16_KERNELS, 0)
    want = {**none, "K1-bf16": n_layer, "K2-dq-bf16": n_layer,
            "K2-dkv-bf16": n_layer}
    check_launches("train_amp", ta, want, {
        "fused_bwd_launches": {**want, "K2-dq-bf16": 0, "K2-dkv-bf16": 0,
                               "K4-bf16": n_layer},
        "o1_launches": want})
    torch.cuda.empty_cache()

    tl = run_train_loop(TRAIN_CONFIG, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR,
                        LOOP_WARMUP, LOOP_STEPS, args.seed, CUDAPlace(0),
                        workdir)
    tl["gpu"] = smi
    emit(tl)
    want_loop = {k: v * LOOP_STEPS for k, v in want.items()}
    if tl["launches"] != want_loop or any(tl["host_launches"].values()) \
            or tl["graph_launches"] != LOOP_STEPS:
        fail("run_loop(%d) launched %s (device), %s from the host and %d "
             "graphs; expected %s, none and %d"
             % (LOOP_STEPS, tl["launches"], tl["host_launches"],
                tl["graph_launches"], want_loop, LOOP_STEPS))
    torch.cuda.empty_cache()

    tf = run_train_files(TRAIN_CONFIG, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR,
                         LOOP_STEPS, args.seed, CUDAPlace(0), workdir)
    tf["gpu"] = smi
    emit(tf)
    want_files = {k: want_loop[k] for k in BF16_KERNELS}
    if tf["launches"] != want_files or any(tf["host_launches"].values()) \
            or tf["graph_launches"] != LOOP_STEPS:
        fail("the files window launched %s (device), %s from the host and "
             "%d graphs; expected %s, none and %d"
             % (tf["launches"], tf["host_launches"], tf["graph_launches"],
                want_files, LOOP_STEPS))
    torch.cuda.empty_cache()
    ip = input_pipeline()
    ip["gpu"] = smi
    emit(ip)

    # the attention kernels at the nmt step's shapes and lengths, then the
    # step
    nmt_att = check_nmt_attention(torch, dev, args.seed)
    nmt = {}
    for amp_level in (None, "O2"):
        for rate in (0.0, NMT_DROPOUT):
            got = run_nmt(NMT_CONFIG, NMT_BATCH, NMT_SEQ, NMT_MIN_LEN,
                          NMT_LR, NMT_WARM, NMT_STEPS, rate, args.seed,
                          CUDAPlace(0), workdir, amp_level)
            got["gpu"] = smi
            emit(got)
            nmt[amp_level, rate] = got
            torch.cuda.empty_cache()
    lv = run_lm_variants(TRAIN_CONFIG, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR,
                         NMT_STEPS, args.seed, CUDAPlace(0), workdir)
    lv["gpu"] = smi
    emit(lv)
    torch.cuda.empty_cache()

    # the training surface: the MoE LM, the noam recipe, every optimizer
    n_layer = TRAIN_CONFIG["n_layer"]
    none = dict.fromkeys(FP32_KERNELS + BF16_KERNELS, 0)
    t0 = time.perf_counter()
    moe = run_moe(dict(TRAIN_CONFIG, moe_experts=MOE_EXPERTS), TRAIN_BATCH,
                  TRAIN_SEQ, TRAIN_LR, WARM_STEPS, MOE_STEPS, args.seed,
                  CUDAPlace(0), workdir)
    moe["seconds"], moe["gpu"] = time.perf_counter() - t0, smi
    emit(moe)
    want = {**none, "K1-bf16": n_layer, "K2-dq-bf16": n_layer,
            "K2-dkv-bf16": n_layer}
    for key, counts in (("launches_per_step", want),
                        ("main_path_host_launches", none),
                        ("host_launches_per_graph_step", none),
                        ("eager_launches_per_step", want),
                        ("plain_launches", none)):
        if moe[key] != counts:
            fail("moe: %s %s, expected %s" % (key, moe[key], counts))
    if moe["graph_launches_per_step"] != 1:
        fail("moe: %s graph launches in the main path's step, expected 1"
             % moe["graph_launches_per_step"])
    t0 = time.perf_counter()
    noam = run_nmt_noam(NMT_CONFIG, NMT_BATCH, NMT_SEQ, NMT_MIN_LEN,
                        args.seed, CUDAPlace(0), workdir, NOAM_STEPS,
                        NOAM_LOOP)
    noam["seconds"], noam["gpu"] = time.perf_counter() - t0, smi
    noam["fixed_lr_step_ms_mean"] = nmt["O2", 0.0]["step_ms_mean"]
    emit(noam)
    n_att = 3 * NMT_CONFIG["n_layer"]
    want_noam = {**none, "K1-bf16": n_att, "K2-dq-bf16": n_att,
                 "K2-dkv-bf16": n_att}
    if noam["launches_per_step"] != want_noam or \
            noam["main_path_host_launches"] != none or \
            noam["graph_launches_per_step"] != 1:
        fail("nmt_noam: launches %s (device), %s from the host, %s graph "
             "launches; expected %s, none and 1"
             % (noam["launches_per_step"], noam["main_path_host_launches"],
                noam["graph_launches_per_step"], want_noam))
    t0 = time.perf_counter()
    opts = run_optimizers(dict(TRAIN_CONFIG, n_layer=OPT_LAYERS),
                          TRAIN_BATCH, TRAIN_SEQ, args.seed, CUDAPlace(0),
                          workdir, OPT_WARM, OPT_STEPS)
    opts["seconds"], opts["gpu"] = time.perf_counter() - t0, smi
    emit(opts)
    want_opt = {**none, "K1-bf16": OPT_LAYERS, "K2-dq-bf16": OPT_LAYERS,
                "K2-dkv-bf16": OPT_LAYERS}
    for name, got in opts["recipes"].items():
        if got["launches_per_step"] != want_opt or \
                got["graph_launches_per_step"] != 1:
            fail("optimizers (%s): launches %s, %s graph launches; "
                 "expected %s and 1" % (name, got["launches_per_step"],
                                        got["graph_launches_per_step"],
                                        want_opt))
    torch.cuda.empty_cache()
    nmt32, nmt16 = nmt[None, 0.0], nmt["O2", 0.0]

    sl = run_slice(FULL_CONFIG, prompt_lens, MAX_NEW, args.seed,
                   CUDAPlace(0), workdir)
    engine, predictor = sl.pop("engine"), sl.pop("predictor")
    sampling = sl.pop("sampling")
    sl["gpu"] = engine["gpu"] = predictor["gpu"] = sampling["gpu"] = smi
    n_layer = FULL_CONFIG["n_layer"]
    # the main path's run replays the graphs: the host launches nothing,
    # the device's counters count the kernels inside the replays
    want_each = {"K1": n_layer * sl["prefill_calls"],
                 "K3": n_layer * sl["decode_steps"]}
    emit(sl)
    emit(engine)
    emit(predictor)
    emit(sampling)
    if sl["launches"] != {"K1": 0, "K3": 0}:
        fail("the main path's generate launched kernels from the host %s: "
             "a step ran eagerly" % sl["launches"])
    if sl["device_launches"] != want_each:
        fail("kernel launches in the main path's generate %s (device), "
             "expected %s" % (sl["device_launches"], want_each))
    torch.cuda.empty_cache()
    # the request servers: DecodeServer's continuous batching (K1 in each
    # admission prefill, K3 in every decode step, inside the replays; its
    # main path's run checked in run_server) and PredictorServer
    t0 = time.perf_counter()
    sv = run_server(FULL_CONFIG, args.seed, CUDAPlace(0), workdir)
    sv["seconds"], sv["gpu"] = time.perf_counter() - t0, smi
    emit(sv)
    t0 = time.perf_counter()
    ps = run_predictor_server(FULL_CONFIG, args.seed, CUDAPlace(0), workdir)
    ps["seconds"], ps["gpu"] = time.perf_counter() - t0, smi
    emit(ps)
    server_launches = sv["main_path"]["device_launches"]
    # the rest of decode serving on the serving config: speculative
    # decoding (generate and server), shared-prefix admission, int8 slabs
    # and beam search (gates and launch counts checked inside)
    t0 = time.perf_counter()
    features = run_decode_features(FULL_CONFIG, prompt_lens, MAX_NEW,
                                   args.seed, CUDAPlace(0), workdir)
    features_s = time.perf_counter() - t0
    for name in ("speculative", "server_spec", "prefix", "int8", "beam"):
        features[name]["gpu"] = smi
        emit(features[name])
    emit({"phase": "decode_features", "seconds": features_s, "gpu": smi})
    spec_random = features["speculative"]["random"]

    # each kernel: its launches on each main path (one training step, a
    # replay of its graph, as the device counts them; the fused-backward
    # step and the BHTD step; one run_loop call; one generate call), its
    # error and times at the training shape (K3: the serving shape)
    def entry(name, src, replaces, by_path, err, ms, plain_ms, bnd,
              library_ms, **extra):
        by_path = {k: v for k, v in by_path.items() if v}
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library_ms, **extra}

    def sass_of(name):
        return {"Dh%d" % d: sass["%s<%d>" % (name, d)] for d in (64, 128)}

    csrc = "paddle_tpu_torch/csrc/"
    per_step, fused_step = tr["launches_per_step"], tr["fused_bwd_launches"]
    kernels = [
        entry("flash_fwd", csrc + "flash_fwd.cu",
              "paddle_tpu/ops/attention.py:172",
              {"train_step": per_step["K1"],
               "train_step_bhtd": tr["bhtd_launches"]["K1"],
               "nmt_step": nmt32["launches_per_step"]["K1"],
               "nmt_step_fused_bwd": nmt32["fused_bwd_launches"]["K1"],
               "generate": sl["device_launches"]["K1"],
               "server_round": server_launches["K1"],
               "speculative_generate": spec_random["device_launches"]["K1"],
               "server_spec_round": features["server_spec"]["main_path"][
                   "device_launches"]["K1"],
               "prefix_round": features["prefix"]["main_path"][
                   "device_launches"]["K1"],
               "int8_server_round": features["int8"]["main_path"][
                   "device_launches"]["K1"],
               "beam_generate": features["beam"]["device_launches"]["K1"]},
              k1["max_abs_err"], k1["ms"], k1["plain_ms"],
              (k1["bound_ms"], k1["bound_by"]), k1["library_ms"],
              generate_host_launches=sl["launches"]["K1"],
              fp32_bound_ms=k1["fp32_bound_ms"], host_us=k1["host_us"],
              nmt_max_abs_err=nmt_att["K1"],
              sass=sass_of("flash_fwd"),
              **{"serving_" + key: k1_serve[key] for key in (
                  "shape", "ms", "plain_ms", "library_ms", "bound_ms",
                  "bound_by", "fp32_bound_ms")}),
        entry("flash_bwd_dq", csrc + "flash_bwd.cu",
              "paddle_tpu/ops/attention.py:216",
              {"train_step": per_step["K2-dq"],
               "train_step_bhtd": tr["bhtd_launches"]["K2-dq"],
               "nmt_step": nmt32["launches_per_step"]["K2-dq"]},
              bwd["K2_max_abs_err"], bwd["dq_ms"], bwd["plain_ms"],
              (bwd["dq_bound_ms"], bwd["dq_bound_by"]), None,
              fp32_bound_ms=bwd["dq_fp32_bound_ms"],
              nmt_max_abs_err=nmt_att["K2"],
              sass=sass_of("flash_bwd_dq")),
        entry("flash_bwd_dkv", csrc + "flash_bwd.cu",
              "paddle_tpu/ops/attention.py:246",
              {"train_step": per_step["K2-dkv"],
               "train_step_bhtd": tr["bhtd_launches"]["K2-dkv"],
               "nmt_step": nmt32["launches_per_step"]["K2-dkv"]},
              bwd["K2_max_abs_err"], bwd["dkv_ms"], bwd["plain_ms"],
              (bwd["dkv_bound_ms"], bwd["dkv_bound_by"]), None,
              fp32_bound_ms=bwd["dkv_fp32_bound_ms"],
              nmt_max_abs_err=nmt_att["K2"],
              sass=sass_of("flash_bwd_dkv")),
        entry("decode_attn", csrc + "decode_attn.cu",
              "paddle_tpu/ops/kv_cache.py:88",
              {"generate": sl["device_launches"]["K3"],
               "server_round": server_launches["K3"],
               "speculative_generate": spec_random["device_launches"]["K3"],
               "server_spec_round": features["server_spec"]["main_path"][
                   "device_launches"]["K3"],
               "prefix_round": features["prefix"]["main_path"][
                   "device_launches"]["K3"],
               "int8_server_round": features["int8"]["main_path"][
                   "device_launches"]["K3"],
               "beam_generate": features["beam"]["device_launches"]["K3"]},
              k3["max_abs_err"], k3["ms"], k3["plain_ms"],
              (k3["bound_ms"], k3["bound_by"]),
              k3["library_ms"], generate_host_launches=sl["launches"]["K3"],
              k3_device_ms=sl["k3_device_ms"],
              **{"full_" + key: k3_full[key] for key in (
                  "lengths", "ms", "bound_ms", "bound_by")},
              empty_ms=k3_empty["ms"]),
        entry("flash_bwd_fused", csrc + "flash_bwd_fused.cu",
              "paddle_tpu/ops/attention.py:282",
              {"train_step_fused_bwd": fused_step["K4"],
               "nmt_step_fused_bwd": nmt32["fused_bwd_launches"]["K4"]},
              bwd["K4_max_abs_err"], bwd["fused_ms"], bwd["plain_ms"],
              (bwd["pair_bound_ms"], bwd["pair_bound_by"]),
              bwd["library_ms"], fp32_bound_ms=bwd["pair_fp32_bound_ms"],
              nmt_max_abs_err=nmt_att["K4"],
              sass=sass_of("flash_bwd_fused")),
    ]
    amp_step, amp_o1 = ta["launches_per_step"], ta["o1_launches"]
    loop = tl["launches"]

    def dh128(res, keys):
        return {"dh128_" + key: res[key] for key in keys}

    kernels += [
        entry("flash_fwd_bf16", csrc + "flash_fwd_bf16.cu",
              "paddle_tpu/ops/attention.py:172",
              {"train_amp_step": amp_step["K1-bf16"],
               "train_amp_o1_step": amp_o1["K1-bf16"],
               "train_loop": loop["K1-bf16"],
               "train_files": tf["launches"]["K1-bf16"],
               "nmt_amp_step": nmt16["launches_per_step"]["K1-bf16"],
               "lm_fused_qkv_step": lv["fused_qkv_launches_per_step"][
                   "K1-bf16"],
               "lm_unfused_head_step": lv["unfused_head_replay_launches"][
                   "K1-bf16"],
               "moe_step": moe["launches_per_step"]["K1-bf16"],
               "nmt_noam_step": noam["launches_per_step"]["K1-bf16"],
               "optimizers_adam_step": opts["recipes"]["Adam"][
                   "launches_per_step"]["K1-bf16"]},
              k1b["max_abs_err"], k1b["ms"], k1b["plain_ms"],
              (k1b["bound_ms"], k1b["bound_by"]), k1b["library_ms"],
              plain_err=k1b["plain_err"], err_ratio=k1b["err_ratio"],
              host_us=k1b["host_us"],
              host_us_new_maps=k1b["host_us_new_maps"],
              fp32_host_us=k1b["fp32_host_us"],
              map_encode_us=k1b["map_encode_us"],
              nmt_max_abs_err=nmt_att["K1-bf16"],
              sass=sass_of("flash_fwd_bf16"),
              **dh128(k1b_128, ("shape", "ms", "plain_ms", "library_ms",
                                "bound_ms", "bound_by"))),
        entry("flash_bwd_dq_bf16", csrc + "flash_bwd_bf16.cu",
              "paddle_tpu/ops/attention.py:216",
              {"train_amp_step": amp_step["K2-dq-bf16"],
               "train_amp_o1_step": amp_o1["K2-dq-bf16"],
               "train_loop": loop["K2-dq-bf16"],
               "train_files": tf["launches"]["K2-dq-bf16"],
               "nmt_amp_step": nmt16["launches_per_step"]["K2-dq-bf16"],
               "lm_fused_qkv_step": lv["fused_qkv_launches_per_step"][
                   "K2-dq-bf16"],
               "lm_unfused_head_step": lv["unfused_head_replay_launches"][
                   "K2-dq-bf16"],
               "moe_step": moe["launches_per_step"]["K2-dq-bf16"],
               "nmt_noam_step": noam["launches_per_step"]["K2-dq-bf16"],
               "optimizers_adam_step": opts["recipes"]["Adam"][
                   "launches_per_step"]["K2-dq-bf16"]},
              bwdb["K2_dq_err"], bwdb["dq_ms"], bwdb["plain_ms"],
              (bwdb["dq_bound_ms"], bwdb["dq_bound_by"]), None,
              err_ratio=bwdb["K2_dq_err_ratio"],
              nmt_max_abs_err=nmt_att["K2-bf16"],
              sass=sass_of("flash_bwd_dq_bf16"),
              **dh128(bwdb_128, ("dq_ms", "dq_bound_ms"))),
        entry("flash_bwd_dkv_bf16", csrc + "flash_bwd_bf16.cu",
              "paddle_tpu/ops/attention.py:246",
              {"train_amp_step": amp_step["K2-dkv-bf16"],
               "train_amp_o1_step": amp_o1["K2-dkv-bf16"],
               "train_loop": loop["K2-dkv-bf16"],
               "train_files": tf["launches"]["K2-dkv-bf16"],
               "nmt_amp_step": nmt16["launches_per_step"]["K2-dkv-bf16"],
               "lm_fused_qkv_step": lv["fused_qkv_launches_per_step"][
                   "K2-dkv-bf16"],
               "lm_unfused_head_step": lv["unfused_head_replay_launches"][
                   "K2-dkv-bf16"],
               "moe_step": moe["launches_per_step"]["K2-dkv-bf16"],
               "nmt_noam_step": noam["launches_per_step"]["K2-dkv-bf16"],
               "optimizers_adam_step": opts["recipes"]["Adam"][
                   "launches_per_step"]["K2-dkv-bf16"]},
              max(bwdb["K2_dk_err"], bwdb["K2_dv_err"]), bwdb["dkv_ms"],
              bwdb["plain_ms"], (bwdb["dkv_bound_ms"], bwdb["dkv_bound_by"]),
              None, err_ratio=max(bwdb["K2_dk_err_ratio"],
                                  bwdb["K2_dv_err_ratio"]),
              nmt_max_abs_err=nmt_att["K2-bf16"],
              sass=sass_of("flash_bwd_dkv_bf16"),
              **dh128(bwdb_128, ("dkv_ms", "dkv_bound_ms"))),
        entry("flash_bwd_fused_bf16", csrc + "flash_bwd_fused_bf16.cu",
              "paddle_tpu/ops/attention.py:282",
              {"train_amp_step_fused_bwd": ta["fused_bwd_launches"][
                  "K4-bf16"],
               "nmt_amp_step_fused_bwd": nmt16["fused_bwd_launches"][
                   "K4-bf16"]},
              bwdb["K4_max_abs_err"], bwdb["fused_ms"], bwdb["plain_ms"],
              (bwdb["pair_bound_ms"], bwdb["pair_bound_by"]),
              bwdb["library_ms"],
              err_ratio=max(bwdb["K4_%s_err_ratio" % n]
                            for n in ("dq", "dk", "dv")),
              nmt_max_abs_err=nmt_att["K4-bf16"],
              sass=sass_of("flash_bwd_fused_bf16"),
              zero_cast_ms=bwdb["fused_zero_cast_ms"],
              dq_reduce_mb=bwdb["fused_dq_reduce_mb"],
              **dh128(bwdb_128, ("fused_ms", "pair_bound_ms", "plain_ms",
                                 "library_ms", "fused_zero_cast_ms",
                                 "fused_dq_reduce_mb"))),
    ]
    for k in kernels:
        if not k["launches"]:
            fail("kernel %s was launched no time on the main path"
                 % k["name"])
    emit({"k1_bhtd": {key: k1_bhtd[key] for key in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
        "fp32_bound_ms")},
        "k2_pair": {"ms": bwd["pair_ms"], "host_us": bwd["pair_host_us"],
                    "plain_ms": bwd["plain_ms"],
                    "library_ms": bwd["library_ms"],
                    "bound_ms": bwd["pair_bound_ms"],
                    "bound_by": bwd["pair_bound_by"],
                    "fp32_bound_ms": bwd["pair_fp32_bound_ms"]},
        "k2_bf16_pair": {key: res[key] for res, key in (
            (bwdb, "pair_ms"), (bwdb, "pair_host_us"),
            (bwdb, "pair_host_us_new_maps"), (bwdb, "fp32_pair_host_us"),
            (bwdb, "map_encode_us"), (bwdb, "plain_ms"), (bwdb, "library_ms"),
            (bwdb, "pair_bound_ms"), (bwdb, "pair_bound_by"))},
        "k2_bf16_pair_dh128": {key: bwdb_128[key] for key in (
            "pair_ms", "plain_ms", "library_ms", "pair_bound_ms")}})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
