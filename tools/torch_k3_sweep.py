#!/usr/bin/env python3
"""Time design variants of K3, the port's decode attention, on one card.

    python3 tools/torch_k3_sweep.py [--variants 64x4,32x4,...]

K3 (paddle_tpu_torch/csrc/decode_attn.cu) splits the slab into blocks of
SPLIT keys, WARPS warps a block. This script builds the committed source
once for each SPLITxWARPS variant (the macros DECODE_ATTN_SPLIT and
DECODE_ATTN_WARPS set through the port's own build), launches each through
the wrapper's own binding, holds each against the plain PyTorch version,
and times each the way chip_smoke.py times K3 (a CUDA graph of 30 calls,
three slab pairs taken in turn) at chip_smoke's timed case (B 8, S 2048,
H 8, Dh 128, the lengths of the serving slice's last decode step at seed
0) and with every slot full. One JSON line per variant, each with the
card's name and power limit. Needs one CUDA card and nvcc; imports no JAX.
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

DEFAULT = "64x4,64x8,32x4,128x4,128x8"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=DEFAULT, help=(
        "SPLITxWARPS, comma separated (WARPS >= 4, SPLIT / WARPS even)"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_k3_sweep: needs a CUDA card", file=sys.stderr)
        return 2
    from paddle_tpu_torch.kernels import load
    from paddle_tpu_torch.ops import kv_cache

    smi = chip_smoke._smi_line()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    b, s, h, d = 8, 2048, 8, 128
    rng = np.random.default_rng(0)
    prompt_lens = rng.integers(256, 1001, chip_smoke.N_PROMPTS)
    prompt_lens[0] = 1000
    cases = {"slice": [int(n) + chip_smoke.MAX_NEW - 1 for n in prompt_lens],
             "full": [s] * b}
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((b, 1, h, d), generator=gen, device=dev)
    slabs = [tuple(torch.randn((b, s, h, d), generator=gen, device=dev)
                   for _ in range(2)) for _ in range(3)]
    scale = 1.0 / math.sqrt(d)
    for variant in args.variants.split(","):
        split, warps = (int(x) for x in variant.split("x"))
        lib = load("decode_attn", ("DECODE_ATTN_SPLIT=%d" % split,
                                   "DECODE_ATTN_WARPS=%d" % warps))
        if (lib.decode_attn_split(), lib.decode_attn_warps()) != (split,
                                                                  warps):
            raise RuntimeError("variant %s built as %dx%d" % (
                variant, lib.decode_attn_split(), lib.decode_attn_warps()))
        fns = kv_cache._bind(lib)
        out = torch.empty_like(q)
        part = torch.empty((fns[1](b, h, s, d),), device=dev)
        counters = torch.zeros(b * h, dtype=torch.int32, device=dev)
        res = {"variant": {"SPLIT": split, "WARPS": warps}, "gpu": smi}
        for case, lengths in cases.items():
            lens = torch.tensor(lengths, dtype=torch.int32, device=dev)

            def call(kk, vv):
                kv_cache._launch(fns, q, kk, vv, lens, out, part, counters,
                                 scale)

            call(*slabs[0])
            ref = kv_cache.decode_attention_plain(q, *slabs[0], lens)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            if err > chip_smoke.KERNEL_TOL or int(counters.abs().sum()):
                raise RuntimeError("variant %s: err %g, counters %s"
                                   % (variant, err, counters.tolist()))
            turn = itertools.cycle(slabs)
            # time_ms warms up and captures on one side stream; the
            # variant's counters are this call's own, used on one stream
            # at a time
            ms = chip_smoke.time_ms(lambda: call(*next(turn)))
            flops, nbytes = chip_smoke.decode_work(b, h, d,
                                                   np.asarray(lengths))
            bound_ms, _by = chip_smoke.bound(flops, nbytes)
            res[case] = {"lengths": lengths, "max_abs_err": err, "ms": ms,
                         "bound_ms": bound_ms,
                         "share_of_bound": bound_ms / ms}
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
