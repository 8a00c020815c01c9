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
   program. Startup, 2 warm steps, 5 timed steps through Executor.run:
   step ms, tokens/s, the loss of every step, peak device memory, and
   the launches per step (K1, K2-dq and K2-dkv once per layer, K4 never).
   Then, from one saved state, one step with the kernels, one with the
   plain attention forward and backward, one with K1's forward and the
   plain backward, one with PADDLE_TPU_FLASH_FUSED_BWD=1 (K4 once per
   layer, K2 never) and one in the BHTD layout (PADDLE_TPU_ATTN_BTHD=0):
   the loss, every @GRAD and every updated parameter against the kernel
   step, within stated tolerances. Last, one more step under torch.profiler: the device's
   busy time against the step's wall time (the idle share), busy time by
   kind (products, attention, other), the top kernels and host ops (the
   full tables land in build/chip_smoke/train_step_ops.txt).
4. train_amp: the same config as bench.py runs it, in bf16 AMP O2 (built,
   minimized, then enable_mixed_precision(level="O2")): startup, 2 warm
   and 5 timed steps (step ms, tokens/s, losses, peak memory, launches
   per step: K1-bf16, K2-dq-bf16 and K2-dkv-bf16 once per layer, no fp32
   kernel). Then, from one saved state: (a) the kernel step, (b) the plain
   bf16 attention forward and backward, (c) PADDLE_TPU_FLASH_FUSED_BWD=1
   (K4-bf16 once per layer, K2-bf16 never), (d) the O1 program, (e) the
   fp32 program; (a) and (c) against (b) relative to (b)'s distance from
   (e) (compare_amp: ratios printed, gates at the top of this file); one
   profiled step (build/chip_smoke/train_amp_step_ops.txt), and one with
   PADDLE_TPU_FLASH_FUSED_BWD=1 (profile_fused_bwd,
   train_amp_fused_bwd_step_ops.txt).
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
   inside the graphs, where the host counts nothing and the profiler
   counts 12 K1 per prefill and 12 K3 per decode step. The run fails
   unless the host counts are 0 (nothing ran eagerly), the profiler's
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

Then one line with K1's BHTD and K2's (and K2-bf16's) pair numbers, one
line
{"kernels": [...]} (every kernel, with its launches on each main path,
error, times and bound), the nvidia-smi line, and last
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
# config): PATH_GRAD_RTOL. A key projection's bias
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

# the flagship training config: bench.py's LM phase (bench.py:80-92,
# bench_lm), full width and depth, 16 heads of 64; the train phase runs
# it in fp32, train_amp in bf16 AMP O2 as bench.py runs it
TRAIN_CONFIG = dict(vocab_size=32768, n_layer=12, n_head=16, d_model=1024,
                    d_inner=4096, max_len=1024)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 16, 1024, 1e-4
WARM_STEPS, TIMED_STEPS = 2, 5


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
    for, flash_attention_bwd_plain; decode_attention through
    decode_attention_plain."""
    import torch
    from paddle_tpu_torch.ops import registry
    from paddle_tpu_torch.ops.attention import (flash_attention_bwd_plain,
                                                flash_attention_fwd,
                                                flash_attention_plain)
    from paddle_tpu_torch.ops.kv_cache import decode_attention_plain

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

    saved = dict(registry.KERNELS)
    registry.KERNELS.update({"fused_attention": fused,
                             "decode_attention": decode})
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
    counts zeroed just before it; on the card under torch.profiler, whose
    K1 and K3 counts ride as ``device_launches``); with the engine line
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
    # kernel counts zeroed just before it; on the card under the
    # profiler, which counts the kernels the replays launch
    got = {}

    def main_path():
        got["tokens"] = np.stack(pred.generate(prompts,
                                               max_new_tokens=max_new))

    _k1_k3_counts(reset=True)
    if cuda:
        profile = profile_call(main_path, os.path.join(
            workdir, "generate_graph_ops.txt"))
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
        res["device_launches"] = {
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


def _kernel_kind(name):
    """products (cuBLAS/CUTLASS matrix products), attention (the port's
    hand-written kernels: every kernel its csrc/ sources declare), or
    other (elementwise, reductions, copies)."""
    if _port_source(name) is not None:
        return "attention"
    low = name.lower()
    if any(w in low for w in ("gemm", "xmma", "cutlass", "cublas",
                              "nvjet")):
        return "products"
    return "other"


def profile_call(fn, table_path):
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
    by_source = {}
    for e in dev:
        ms = e.self_device_time_total / 1e3
        by_kind[_kernel_kind(e.key)] += ms
        src = _port_source(e.key)
        if src is not None:
            got = by_source.setdefault(src, {"device_ms": 0.0,
                                             "launches": 0})
            got["device_ms"] += ms
            got["launches"] += e.count
    with open(table_path, "w") as f:
        f.write(events.table(sort_by="self_cuda_time_total", row_limit=40))
        f.write("\n")
        f.write(events.table(sort_by="self_cpu_time_total", row_limit=40))
    return {
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_ms_by_kind": by_kind,
        "port_kernels": by_source,
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
    after step on one seeded batch, as bench.py does), then: one step with
    the kernels, one with the plain attention forward and backward, one
    with K1's forward and the plain backward, one with
    PADDLE_TPU_FLASH_FUSED_BWD=1 and one in the BHTD layout
    (PADDLE_TPU_ATTN_BTHD=0), each from the same saved state and compared
    with the kernel step; on the card, one more step under torch.profiler.
    Runs on any place (the CPU tests rehearse it at a tiny size); the
    caller checks the kernel launch counts."""
    import torch
    from paddle_tpu_torch import Executor, Scope

    t0 = time.perf_counter()
    main, startup, loss = build_train(config, batch, seq, lr, seed)
    exe, scope = Executor(place), Scope()
    exe.run(startup, scope=scope)
    cuda = exe.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    params = [p.name for p in main.all_parameters()]
    grads = [n + "@GRAD" for n in params]
    n_params = sum(scope.find_var(n).numel() for n in params)
    rng = np.random.default_rng(seed + 2)
    feed = {k: torch.from_numpy(rng.integers(
        0, config["vocab_size"], (batch, seq))).to(exe.device)
        for k in ("ids", "labels")}
    sync()
    setup_s = time.perf_counter() - t0

    losses = [float(exe.run(main, feed, [loss], scope=scope)[0])
              for _ in range(warm)]
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _launch_counts(reset=True)
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(exe.run(main, feed, [loss], scope=scope)[0]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: n // steps if n % steps == 0 else n / steps
                for k, n in _launch_counts().items()}
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    if not all(np.isfinite(losses)):
        fail("training losses are not finite: %s" % losses)

    # the same step from one saved state, by four paths (nothing in the
    # scope is updated in place, so the saved tensors stay as they are)
    saved = {v.name: scope.find_var(v.name) for v in main.list_vars()
             if v.persistable}

    def one_step(program, ctx):
        for name, val in saved.items():
            scope.set_var(name, val)
        _launch_counts(reset=True)
        with ctx:
            outs = exe.run(program, feed, [loss] + grads, scope=scope,
                           return_numpy=False)
        sync()
        return ((outs[0], dict(zip(grads, outs[1:])),
                 {n: scope.find_var(n) for n in params}), _launch_counts())

    kernel, kernel_launches = one_step(main, contextlib.nullcontext())
    plain, _ = one_step(main, plain_attention())
    plain_bwd, _ = one_step(main, plain_attention(forward_kernel=True))
    fused, fused_launches = one_step(
        main, env_set("PADDLE_TPU_FLASH_FUSED_BWD", "1"))
    with env_set("PADDLE_TPU_ATTN_BTHD", "0"):
        main_bhtd, _, _ = build_train(config, batch, seq, lr, seed)
    bhtd, bhtd_launches = one_step(main_bhtd, contextlib.nullcontext())
    res = {
        "phase": "train", "config": config, "batch": batch, "seq": seq,
        "lr": lr, "params": n_params, "setup_s": setup_s,
        "warm_steps": warm, "steps": steps, "step_ms": step_ms,
        "step_ms_mean": float(np.mean(step_ms)),
        "tokens_per_s": batch * seq / (float(np.mean(step_ms)) / 1e3),
        "losses": losses, "peak_mem_gb": peak,
        "launches_per_step": launches,
        "kernel_step_launches": kernel_launches,
        "kernels_vs_plain": compare_steps(kernel, plain, lr,
                                          PATH_GRAD_RTOL),
        "bwd_kernels_vs_plain_bwd": compare_steps(kernel, plain_bwd, lr),
        "fused_bwd_launches": fused_launches,
        "fused_bwd_vs_kernels": compare_steps(fused, kernel, lr),
        "bhtd_launches": bhtd_launches,
        "bhtd_vs_bthd": compare_steps(bhtd, kernel, lr),
    }
    del kernel, plain, plain_bwd, fused, bhtd
    for key in ("kernels_vs_plain", "bwd_kernels_vs_plain_bwd",
                "fused_bwd_vs_kernels", "bhtd_vs_bthd"):
        if not res[key]["ok"]:
            fail("training step %s failed: %s" % (key, json.dumps(res[key])))
    if cuda:
        for name, val in saved.items():
            scope.set_var(name, val)
        res["profile"] = profile_call(
            lambda: exe.run(main, feed, [loss], scope=scope),
            os.path.join(workdir, "train_step_ops.txt"))
    return res


def run_train_amp(config, batch, seq, lr, warm, steps, seed, place,
                  workdir):
    """Train ``config`` as bench.py trains it: built and minimized, then
    set to bf16 AMP O2, stepped by Executor.run on one seeded batch. Then,
    from one saved state: (a) the kernel step; (b) the same program with
    the plain bf16 attention forward and backward; (c) the kernel step
    with PADDLE_TPU_FLASH_FUSED_BWD=1; (d) the O1 program; (e) the fp32
    program. (a) and (c) are held against (b) relative to (b)'s distance
    from (e) (compare_amp); on the card, one more step under
    torch.profiler. Runs on any place (the CPU tests rehearse it at a tiny
    size); the caller checks the kernel launch counts."""
    import torch
    from paddle_tpu_torch import Executor, Scope

    keys = FP32_KERNELS + BF16_KERNELS
    t0 = time.perf_counter()
    main, startup, loss = build_train(config, batch, seq, lr, seed, "O2")
    exe, scope = Executor(place), Scope()
    exe.run(startup, scope=scope)
    cuda = exe.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    params = [p.name for p in main.all_parameters()]
    grads = [n + "@GRAD" for n in params]
    rng = np.random.default_rng(seed + 2)
    feed = {k: torch.from_numpy(rng.integers(
        0, config["vocab_size"], (batch, seq))).to(exe.device)
        for k in ("ids", "labels")}
    sync()
    setup_s = time.perf_counter() - t0

    losses = [float(exe.run(main, feed, [loss], scope=scope)[0])
              for _ in range(warm)]
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    _launch_counts(reset=True)
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(exe.run(main, feed, [loss], scope=scope)[0]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k: n // steps if n % steps == 0 else n / steps
                for k, n in _launch_counts(keys=keys).items()}
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
    if not all(np.isfinite(losses)):
        fail("bf16 AMP training losses are not finite: %s" % losses)
    for var in main.list_vars():
        val = scope.find_var(var.name) if var.persistable else None
        if val is not None and val.is_floating_point() and \
                val.dtype != torch.float32:
            fail("AMP state %s is %s, not fp32" % (var.name, val.dtype))

    saved = {v.name: scope.find_var(v.name) for v in main.list_vars()
             if v.persistable}

    def one_step(program, ctx):
        for name, val in saved.items():
            scope.set_var(name, val)
        _launch_counts(reset=True)
        with ctx:
            outs = exe.run(program, feed, [loss] + grads, scope=scope,
                           return_numpy=False)
        sync()
        return ((outs[0], dict(zip(grads, outs[1:])),
                 {n: scope.find_var(n) for n in params}),
                _launch_counts(keys=keys))

    nothing = contextlib.nullcontext
    kernel, kernel_launches = one_step(main, nothing())
    plain, _ = one_step(main, plain_attention())
    fused, fused_launches = one_step(
        main, env_set("PADDLE_TPU_FLASH_FUSED_BWD", "1"))
    o1, o1_launches = one_step(
        build_train(config, batch, seq, lr, seed, "O1")[0], nothing())
    fp32, _ = one_step(build_train(config, batch, seq, lr, seed)[0],
                       nothing())
    for name, (step_loss, step_grads, _) in (("kernel", kernel),
                                             ("o1", o1)):
        if any(g.dtype != torch.float32 for g in step_grads.values()):
            fail("the %s step's gradients are not all fp32" % name)
    res = {
        "phase": "train_amp", "amp_level": "O2", "config": config,
        "batch": batch, "seq": seq, "lr": lr, "setup_s": setup_s,
        "warm_steps": warm, "steps": steps, "step_ms": step_ms,
        "step_ms_mean": float(np.mean(step_ms)),
        "tokens_per_s": batch * seq / (float(np.mean(step_ms)) / 1e3),
        "losses": losses, "peak_mem_gb": peak,
        "launches_per_step": launches,
        "kernel_step_launches": kernel_launches,
        "kernels_vs_plain": compare_amp(kernel, plain, fp32, lr),
        "fused_bwd_launches": fused_launches,
        "fused_bwd_vs_plain": compare_amp(fused, plain, fp32, lr),
        "o1_launches": o1_launches,
        "o1_loss": float(o1[0]), "fp32_loss": float(fp32[0]),
        # the global norm of each AMP step's gradients' distance from the
        # fp32 step's, over the fp32 step's own
        "o1_vs_fp32_grad_rel": _global_rel(o1[1], fp32[1]),
        "o2_vs_fp32_grad_rel": _global_rel(kernel[1], fp32[1]),
    }
    del kernel, plain, fused, o1, fp32
    if not np.isfinite(res["o1_loss"]):
        fail("the O1 step's loss is not finite")
    for key in ("kernels_vs_plain", "fused_bwd_vs_plain"):
        if not res[key]["ok"]:
            fail("bf16 AMP training step %s failed: %s"
                 % (key, json.dumps(res[key])))
    if cuda:
        for name, val in saved.items():
            scope.set_var(name, val)
        res["profile"] = profile_call(
            lambda: exe.run(main, feed, [loss], scope=scope),
            os.path.join(workdir, "train_amp_step_ops.txt"))
        # step (c), the single-pass backward, profiled the same way
        for name, val in saved.items():
            scope.set_var(name, val)
        with env_set("PADDLE_TPU_FLASH_FUSED_BWD", "1"):
            res["profile_fused_bwd"] = profile_call(
                lambda: exe.run(main, feed, [loss], scope=scope),
                os.path.join(workdir, "train_amp_fused_bwd_step_ops.txt"))
    return res


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


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
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "build_s": built, "build_wall_s": time.perf_counter() - t0})

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
    if tr["launches_per_step"] != want or tr["kernel_step_launches"] != want:
        fail("kernel launches per training step %s, expected %s"
             % (tr["launches_per_step"], want))
    want_fused = {"K1": n_layer, "K2-dq": 0, "K2-dkv": 0, "K4": n_layer}
    if tr["fused_bwd_launches"] != want_fused:
        fail("launches with the fused backward %s, expected %s"
             % (tr["fused_bwd_launches"], want_fused))
    if tr["bhtd_launches"] != want:
        fail("launches in the BHTD layout %s, expected %s"
             % (tr["bhtd_launches"], want))
    torch.cuda.empty_cache()

    ta = run_train_amp(TRAIN_CONFIG, TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR,
                       WARM_STEPS, TIMED_STEPS, args.seed, CUDAPlace(0),
                       workdir)
    ta["gpu"] = smi
    emit(ta)
    none = dict.fromkeys(FP32_KERNELS, 0)
    want = {**none, "K1-bf16": n_layer, "K2-dq-bf16": n_layer,
            "K2-dkv-bf16": n_layer, "K4-bf16": 0}
    for key in ("launches_per_step", "kernel_step_launches", "o1_launches"):
        if ta[key] != want:
            fail("bf16 AMP %s %s, expected %s" % (key, ta[key], want))
    want_fused = {**want, "K2-dq-bf16": 0, "K2-dkv-bf16": 0,
                  "K4-bf16": n_layer}
    if ta["fused_bwd_launches"] != want_fused:
        fail("bf16 AMP launches with the fused backward %s, expected %s"
             % (ta["fused_bwd_launches"], want_fused))
    torch.cuda.empty_cache()

    sl = run_slice(FULL_CONFIG, prompt_lens, MAX_NEW, args.seed,
                   CUDAPlace(0), workdir)
    engine, predictor = sl.pop("engine"), sl.pop("predictor")
    sl["gpu"] = engine["gpu"] = predictor["gpu"] = smi
    n_layer = FULL_CONFIG["n_layer"]
    # the main path's run replays the graphs: the host launches nothing,
    # the profiler counts the kernels inside the replays
    want_each = {"K1": n_layer * sl["prefill_calls"],
                 "K3": n_layer * sl["decode_steps"]}
    emit(sl)
    emit(engine)
    emit(predictor)
    if sl["launches"] != {"K1": 0, "K3": 0}:
        fail("the main path's generate launched kernels from the host %s: "
             "a step ran eagerly" % sl["launches"])
    if sl["device_launches"] != want_each:
        fail("kernel launches in the main path's generate %s (profiler), "
             "expected %s" % (sl["device_launches"], want_each))

    # each kernel: its launches on each main path (one training step; the
    # fused-backward step and the BHTD step; one generate call), its error
    # and times at the training shape (K3: the serving shape)
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
               "generate": sl["device_launches"]["K1"]},
              k1["max_abs_err"], k1["ms"], k1["plain_ms"],
              (k1["bound_ms"], k1["bound_by"]), k1["library_ms"],
              generate_host_launches=sl["launches"]["K1"],
              fp32_bound_ms=k1["fp32_bound_ms"], host_us=k1["host_us"],
              sass=sass_of("flash_fwd"),
              **{"serving_" + key: k1_serve[key] for key in (
                  "shape", "ms", "plain_ms", "library_ms", "bound_ms",
                  "bound_by", "fp32_bound_ms")}),
        entry("flash_bwd_dq", csrc + "flash_bwd.cu",
              "paddle_tpu/ops/attention.py:216",
              {"train_step": per_step["K2-dq"],
               "train_step_bhtd": tr["bhtd_launches"]["K2-dq"]},
              bwd["K2_max_abs_err"], bwd["dq_ms"], bwd["plain_ms"],
              (bwd["dq_bound_ms"], bwd["dq_bound_by"]), None,
              fp32_bound_ms=bwd["dq_fp32_bound_ms"],
              sass=sass_of("flash_bwd_dq")),
        entry("flash_bwd_dkv", csrc + "flash_bwd.cu",
              "paddle_tpu/ops/attention.py:246",
              {"train_step": per_step["K2-dkv"],
               "train_step_bhtd": tr["bhtd_launches"]["K2-dkv"]},
              bwd["K2_max_abs_err"], bwd["dkv_ms"], bwd["plain_ms"],
              (bwd["dkv_bound_ms"], bwd["dkv_bound_by"]), None,
              fp32_bound_ms=bwd["dkv_fp32_bound_ms"],
              sass=sass_of("flash_bwd_dkv")),
        entry("decode_attn", csrc + "decode_attn.cu",
              "paddle_tpu/ops/kv_cache.py:88",
              {"generate": sl["device_launches"]["K3"]},
              k3["max_abs_err"], k3["ms"], k3["plain_ms"],
              (k3["bound_ms"], k3["bound_by"]),
              k3["library_ms"], generate_host_launches=sl["launches"]["K3"],
              k3_device_ms=sl["k3_device_ms"],
              **{"full_" + key: k3_full[key] for key in (
                  "lengths", "ms", "bound_ms", "bound_by")},
              empty_ms=k3_empty["ms"]),
        entry("flash_bwd_fused", csrc + "flash_bwd_fused.cu",
              "paddle_tpu/ops/attention.py:282",
              {"train_step_fused_bwd": fused_step["K4"]},
              bwd["K4_max_abs_err"], bwd["fused_ms"], bwd["plain_ms"],
              (bwd["pair_bound_ms"], bwd["pair_bound_by"]),
              bwd["library_ms"], fp32_bound_ms=bwd["pair_fp32_bound_ms"],
              sass=sass_of("flash_bwd_fused")),
    ]
    amp_step, amp_o1 = ta["launches_per_step"], ta["o1_launches"]

    def dh128(res, keys):
        return {"dh128_" + key: res[key] for key in keys}

    kernels += [
        entry("flash_fwd_bf16", csrc + "flash_fwd_bf16.cu",
              "paddle_tpu/ops/attention.py:172",
              {"train_amp_step": amp_step["K1-bf16"],
               "train_amp_o1_step": amp_o1["K1-bf16"]},
              k1b["max_abs_err"], k1b["ms"], k1b["plain_ms"],
              (k1b["bound_ms"], k1b["bound_by"]), k1b["library_ms"],
              plain_err=k1b["plain_err"], err_ratio=k1b["err_ratio"],
              host_us=k1b["host_us"],
              host_us_new_maps=k1b["host_us_new_maps"],
              fp32_host_us=k1b["fp32_host_us"],
              map_encode_us=k1b["map_encode_us"],
              sass=sass_of("flash_fwd_bf16"),
              **dh128(k1b_128, ("shape", "ms", "plain_ms", "library_ms",
                                "bound_ms", "bound_by"))),
        entry("flash_bwd_dq_bf16", csrc + "flash_bwd_bf16.cu",
              "paddle_tpu/ops/attention.py:216",
              {"train_amp_step": amp_step["K2-dq-bf16"],
               "train_amp_o1_step": amp_o1["K2-dq-bf16"]},
              bwdb["K2_dq_err"], bwdb["dq_ms"], bwdb["plain_ms"],
              (bwdb["dq_bound_ms"], bwdb["dq_bound_by"]), None,
              err_ratio=bwdb["K2_dq_err_ratio"],
              sass=sass_of("flash_bwd_dq_bf16"),
              **dh128(bwdb_128, ("dq_ms", "dq_bound_ms"))),
        entry("flash_bwd_dkv_bf16", csrc + "flash_bwd_bf16.cu",
              "paddle_tpu/ops/attention.py:246",
              {"train_amp_step": amp_step["K2-dkv-bf16"],
               "train_amp_o1_step": amp_o1["K2-dkv-bf16"]},
              max(bwdb["K2_dk_err"], bwdb["K2_dv_err"]), bwdb["dkv_ms"],
              bwdb["plain_ms"], (bwdb["dkv_bound_ms"], bwdb["dkv_bound_by"]),
              None, err_ratio=max(bwdb["K2_dk_err_ratio"],
                                  bwdb["K2_dv_err_ratio"]),
              sass=sass_of("flash_bwd_dkv_bf16"),
              **dh128(bwdb_128, ("dkv_ms", "dkv_bound_ms"))),
        entry("flash_bwd_fused_bf16", csrc + "flash_bwd_fused_bf16.cu",
              "paddle_tpu/ops/attention.py:282",
              {"train_amp_step_fused_bwd": ta["fused_bwd_launches"][
                  "K4-bf16"]},
              bwdb["K4_max_abs_err"], bwdb["fused_ms"], bwdb["plain_ms"],
              (bwdb["pair_bound_ms"], bwdb["pair_bound_by"]),
              bwdb["library_ms"],
              err_ratio=max(bwdb["K4_%s_err_ratio" % n]
                            for n in ("dq", "dk", "dv")),
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
