"""Fused (flash) attention: the ``fused_attention`` op and kernels K1, K2
and K4.

Counterpart of paddle_tpu/ops/attention.py. On the card the op's forward
runs K1, the hand-written CUDA flash-attention forward (csrc/flash_fwd.cu),
which replaces the Pallas TPU kernel ``_mha_fwd_kernel``; its backward runs
K2, the dq and dk/dv kernels (csrc/flash_bwd.cu, replacing
``_mha_dq_kernel`` and ``_mha_dkv_kernel``), or, with
``PADDLE_TPU_FLASH_FUSED_BWD=1`` as in the reference, K4, the single-pass
backward (csrc/flash_bwd_fused.cu, replacing ``_mha_bwd_fused_kernel``).
``FlashAttention`` ties them into one ``torch.autograd.Function`` that
saves q, k, v, out and the per-row logsumexp, never the scores.

Beside the kernels stand their plain PyTorch versions,
``flash_attention_plain`` and ``flash_attention_bwd_plain``: the CPU path
and the reference the kernels are held against on the card.

The wrappers (``flash_attention_fwd``, ``flash_attention_bwd`` and the
per-kernel ``flash_attention_bwd_dq``, ``flash_attention_bwd_dkv``,
``flash_attention_bwd_fused``) run the plain version for CPU tensors; for
CUDA tensors they launch their kernel or raise, never fall back. Each
kernel's launch count is the ``launches`` attribute of its wrapper.
"""
from __future__ import annotations

import ctypes
import math
import os
from typing import Optional, Tuple

import torch

from .registry import register_op

_HEAD_DIMS = (64, 128)
_FN = None
_BWD_FNS = {}


def _kernel():
    """K1's C entry point, built and bound on first use."""
    global _FN
    if _FN is None:
        from ..kernels import load

        lib = load("flash_fwd")
        fn = lib.flash_fwd_f32
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_fwd_error_string.restype = ctypes.c_char_p
        lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
        _FN = (fn, lib.flash_fwd_error_string)
    return _FN


def _to_bhtd(x, layout):
    return x.transpose(1, 2) if layout == "bthd" else x


def flash_attention_plain(q, k, v, causal=False, scale=None, lengths=None,
                          layout="bthd") -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1, same contract as the wrapper:
    q (B, Tq, H, Dh), k/v (B, Tk, H, Dh) for layout "bthd", or
    (B, H, T, Dh) for "bhtd"; ``lengths`` (B,) masks KV positions at or
    past it; causal keeps key j <= query i. Returns (out in q's layout,
    lse (B*H, 1, Tq) fp32). A row with no valid key gives zeros and
    lse -inf. Materializes the (B, H, Tq, Tk) scores: a reference, not a
    fast path."""
    qh, kh, vh = (_to_bhtd(x, layout).float() for x in (q, k, v))
    b, h, t, d = qh.shape
    tk = kh.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = torch.matmul(qh * scale, kh.transpose(-1, -2))        # (B,H,T,Tk)
    col = torch.arange(tk, device=q.device)
    mask = torch.ones((1, 1, t, tk), dtype=torch.bool, device=q.device)
    if lengths is not None:
        mask = mask & (col[None, None, None, :]
                       < lengths.reshape(-1, 1, 1, 1).to(q.device))
    if causal:
        row = torch.arange(t, device=q.device)
        mask = mask & (col[None, :] <= row[:, None])
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    live = l > 0
    out = torch.matmul(p, vh) / torch.where(live, l, torch.ones_like(l))
    lse = torch.where(live, m + torch.log(l), torch.full_like(l, float("-inf")))
    out = out.to(q.dtype)
    return (out.transpose(1, 2) if layout == "bthd" else out), \
        lse.reshape(b * h, 1, t)


def _bth_strides(x, layout):
    """Element strides of the logical (batch, time, head) axes."""
    sb, s1, s2, _ = x.stride()
    return (sb, s1, s2) if layout == "bthd" else (sb, s2, s1)


def _check_kernel_input(name, x, layout):
    """What K1 takes: fp32, 4-D, a contiguous head dim, and rows that start
    on 16-byte boundaries (its loads are float4)."""
    if x.dtype != torch.float32:
        raise TypeError("flash attention kernel takes float32, got %s %s"
                        % (name, x.dtype))
    if x.ndim != 4:
        raise ValueError("flash attention: %s must be 4-D, got %s"
                         % (name, tuple(x.shape)))
    if x.stride(-1) != 1 or any(st % 4 for st in _bth_strides(x, layout)):
        raise ValueError("flash attention: %s needs a contiguous head dim "
                         "and strides that are multiples of 4 (got %s)"
                         % (name, tuple(x.stride())))
    if x.data_ptr() % 16:
        raise ValueError("flash attention: %s is not 16-byte aligned" % name)


def flash_attention_fwd(q, k, v, causal=False, scale=None, lengths=None,
                        layout="bthd") -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact attention forward -> (out, lse); see flash_attention_plain
    for the contract. CPU tensors run the plain version. CUDA tensors
    launch K1 (fp32, Dh 64 or 128, any T; strides taken as given, head dim
    contiguous) or raise."""
    if layout not in ("bthd", "bhtd"):
        raise ValueError("layout must be 'bthd' or 'bhtd', got %r" % (layout,))
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale, lengths, layout)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_kernel_input(name, x, layout)
    qb, kb, vb = (_to_bhtd(x, layout).shape for x in (q, k, v))
    b, h, t, d = qb
    tk = kb[2]
    if kb != vb or kb[0] != b or kb[1] != h or kb[3] != d:
        raise ValueError("flash attention: q %s, k %s, v %s do not agree"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if d not in _HEAD_DIMS:
        raise ValueError("flash attention kernel takes head dim %s, got %d"
                         % (_HEAD_DIMS, d))
    if lengths is not None and lengths.numel() != b:
        raise ValueError("flash attention: lengths has %d entries for "
                         "batch %d" % (lengths.numel(), b))
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError("flash attention: %s is on %s, q on %s"
                             % (name, x.device, q.device))
    if lengths is not None:
        lengths = lengths.reshape(b).to(device=q.device,
                                        dtype=torch.int32).contiguous()
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, 1, t), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *_bth_strides(q, layout), *_bth_strides(k, layout),
        *_bth_strides(v, layout), *_bth_strides(out, layout))
    fn, err_str = _kernel()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), lengths.data_ptr() if lengths is not None else None,
             b, h, t, tk, d, strides, float(scale), int(bool(causal)),
             q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention_fwd.launches += 1
    if err:
        raise RuntimeError("flash attention kernel launch failed: %s"
                           % err_str(err).decode())
    return out, lse


flash_attention_fwd.launches = 0


def _bwd_kernel(name):
    """A backward kernel's C entry point (``flash_bwd_dq_f32``,
    ``flash_bwd_dkv_f32`` or ``flash_bwd_fused_f32``) and its library's
    error-string function, built and bound on first use."""
    if name not in _BWD_FNS:
        from ..kernels import load

        lib_name = "flash_bwd_fused" if name == "fused" else "flash_bwd"
        lib = load(lib_name)
        fn = getattr(lib, "flash_bwd_%s_f32" % name)
        n_out = {"dq": 1, "dkv": 2, "fused": 3}[name]
        fn.argtypes = ([ctypes.c_void_p] * (6 + n_out + 1)
                       + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        err_str = getattr(lib, "%s_error_string" % lib_name)
        err_str.restype = ctypes.c_char_p
        err_str.argtypes = [ctypes.c_int]
        _BWD_FNS[name] = (fn, err_str)
    return _BWD_FNS[name]


def _fused_bwd_enabled() -> bool:
    """The reference's switch for the single-pass backward (K4)."""
    return os.environ.get("PADDLE_TPU_FLASH_FUSED_BWD", "0") == "1"


def attention_delta(out, do, layout="bthd") -> torch.Tensor:
    """delta = rowsum(dO * out) per (batch, head, query), fp32, laid out
    (B*H, Tq) like the forward's lse rows."""
    d = (do.float() * out.float()).sum(-1)
    if layout == "bthd":
        d = d.transpose(1, 2)
    return d.reshape(-1, d.shape[-1]).contiguous()


def _bwd_plain(q, k, v, lse, delta, do, causal, scale, lengths, layout):
    """The backward from the saved lse and delta; see
    flash_attention_bwd_plain."""
    qh, kh, vh, doh = (_to_bhtd(x, layout).float() for x in (q, k, v, do))
    b, h, t, d = qh.shape
    tk = kh.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = torch.matmul(qh * scale, kh.transpose(-1, -2))        # (B,H,T,Tk)
    lse4 = lse.reshape(b, h, t, 1)
    col = torch.arange(tk, device=q.device)
    mask = torch.isfinite(lse4)
    if lengths is not None:
        mask = mask & (col[None, None, None, :]
                       < lengths.reshape(-1, 1, 1, 1).to(q.device))
    if causal:
        row = torch.arange(t, device=q.device)
        mask = mask & (col[None, :] <= row[:, None])
    # a masked score or a row with lse -inf (no valid key) has P = 0
    p = torch.where(mask, torch.exp(s - torch.where(mask, lse4, 0.0)), 0.0)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    ds = p * (dp - delta.reshape(b, h, t, 1))
    dq = torch.matmul(ds, kh) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qh) * scale
    dv = torch.matmul(p.transpose(-1, -2), doh)
    back = (lambda x: x.transpose(1, 2)) if layout == "bthd" else \
        (lambda x: x)
    return (back(dq).to(q.dtype), back(dk).to(k.dtype),
            back(dv).to(v.dtype))


def flash_attention_bwd_plain(q, k, v, out, lse, do, causal=False,
                              scale=None, lengths=None, layout="bthd"
                              ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch backward of exact attention -> (dq, dk, dv) in the
    inputs' layout, from the forward's out and lse and the output
    gradient ``do``. It recomputes P = exp(scale q k^T - lse) at the full
    (B, H, Tq, Tk) size, one call at a time: a reference, not a fast path.
    A row with lse -inf (no valid key) and keys at or past ``lengths``
    get zero gradients."""
    return _bwd_plain(q, k, v, lse, attention_delta(out, do, layout), do,
                      causal, scale, lengths, layout)


def _check_bwd_inputs(q, k, v, lse, delta, do, lengths, layout):
    """What K2 and K4 take: K1's rules for q, k, v and dO (fp32, a
    contiguous head dim, 16-byte aligned rows, head dim 64 or 128, one
    CUDA device), lse (B*H, 1, Tq) and delta (B*H, Tq) fp32 contiguous.
    Returns (B, H, Tq, Tk, Dh)."""
    if layout not in ("bthd", "bhtd"):
        raise ValueError("layout must be 'bthd' or 'bhtd', got %r" % (layout,))
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do)):
        _check_kernel_input(name, x, layout)
    qb, kb, vb = (_to_bhtd(x, layout).shape for x in (q, k, v))
    b, h, t, d = qb
    tk = kb[2]
    if kb != vb or kb[0] != b or kb[1] != h or kb[3] != d or \
            do.shape != q.shape:
        raise ValueError("flash attention backward: q %s, k %s, v %s, do %s "
                         "do not agree" % (tuple(q.shape), tuple(k.shape),
                                           tuple(v.shape), tuple(do.shape)))
    if d not in _HEAD_DIMS:
        raise ValueError("flash attention kernel takes head dim %s, got %d"
                         % (_HEAD_DIMS, d))
    for name, x in (("k", k), ("v", v), ("do", do), ("lse", lse),
                    ("delta", delta)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError("flash attention: %s is on %s, q on %s"
                             % (name, x.device, q.device))
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b * h, 1, t) \
            or not lse.is_contiguous():
        raise ValueError("flash attention backward: lse must be contiguous "
                         "fp32 (%d, 1, %d), got %s %s"
                         % (b * h, t, lse.dtype, tuple(lse.shape)))
    if delta.dtype != torch.float32 or tuple(delta.shape) != (b * h, t) \
            or not delta.is_contiguous():
        raise ValueError("flash attention backward: delta must be contiguous "
                         "fp32 (%d, %d), got %s %s"
                         % (b * h, t, delta.dtype, tuple(delta.shape)))
    if lengths is not None and lengths.numel() != b:
        raise ValueError("flash attention: lengths has %d entries for "
                         "batch %d" % (lengths.numel(), b))
    return b, h, t, tk, d


def _launch_bwd(name, q, k, v, lse, delta, do, outs, causal, scale,
                lengths, layout):
    """Validate, then launch one backward kernel into ``outs`` (dq; dk, dv;
    or dq, dk, dv)."""
    b, h, t, tk, d = _check_bwd_inputs(q, k, v, lse, delta, do, lengths,
                                       layout)
    if lengths is not None:
        lengths = lengths.reshape(b).to(device=q.device,
                                        dtype=torch.int32).contiguous()
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    # the strides of the gradients a kernel does not write are unused
    grads = ((outs[0], k, v) if name == "dq" else
             (q,) + tuple(outs) if name == "dkv" else tuple(outs))
    strides = (ctypes.c_longlong * 21)(
        *(st for x in (q, k, v, do) + grads for st in _bth_strides(x, layout)))
    fn, err_str = _bwd_kernel(name)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(),
             *(x.data_ptr() for x in outs),
             lengths.data_ptr() if lengths is not None else None,
             b, h, t, tk, d, strides, float(scale), int(bool(causal)),
             q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("flash attention backward kernel %s launch "
                           "failed: %s" % (name, err_str(err).decode()))


def flash_attention_bwd_dq(q, k, v, lse, delta, do, causal=False,
                           scale=None, lengths=None, layout="bthd"
                           ) -> torch.Tensor:
    """dq of exact attention from lse and delta (attention_delta). CPU
    tensors run the plain version; CUDA tensors launch K2's dq kernel or
    raise."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, lse, delta, do, causal, scale, lengths,
                          layout)[0]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("dq", q, k, v, lse, delta, do, (dq,), causal, scale,
                lengths, layout)
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal=False,
                            scale=None, lengths=None, layout="bthd"
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of exact attention from lse and delta. CPU tensors run the
    plain version; CUDA tensors launch K2's dk/dv kernel or raise."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, lse, delta, do, causal, scale, lengths,
                          layout)[1:]
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd("dkv", q, k, v, lse, delta, do, (dk, dv), causal, scale,
                lengths, layout)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_fused(q, k, v, lse, delta, do, causal=False,
                              scale=None, lengths=None, layout="bthd"
                              ) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) in one pass. CPU tensors run the plain version; CUDA
    tensors launch K4 or raise. K4 adds dq into a zeroed fp32 buffer with
    atomics, so dq is not bitwise reproducible from run to run."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, lse, delta, do, causal, scale, lengths,
                          layout)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd("fused", q, k, v, lse, delta, do, (dq, dk, dv), causal,
                scale, lengths, layout)
    flash_attention_bwd_fused.launches += 1
    return dq.to(q.dtype), dk, dv


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_fused.launches = 0


def flash_attention_bwd(q, k, v, out, lse, do, causal=False, scale=None,
                        lengths=None, layout="bthd"
                        ) -> Tuple[torch.Tensor, ...]:
    """Exact attention backward -> (dq, dk, dv); see
    flash_attention_bwd_plain for the contract. CPU tensors run the plain
    version. CUDA tensors launch K2 (the dq and the dk/dv kernels) or,
    with PADDLE_TPU_FLASH_FUSED_BWD=1, K4, or raise."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do, causal,
                                         scale, lengths, layout)
    if layout not in ("bthd", "bhtd"):
        raise ValueError("layout must be 'bthd' or 'bhtd', got %r" % (layout,))
    for name, x in (("out", out), ("do", do)):
        _check_kernel_input(name, x, layout)
    delta = attention_delta(out, do, layout)
    args = (q, k, v, lse, delta, do, causal, scale, lengths, layout)
    if _fused_bwd_enabled():
        return flash_attention_bwd_fused(*args)
    return (flash_attention_bwd_dq(*args),) + flash_attention_bwd_dkv(*args)


class FlashAttention(torch.autograd.Function):
    """Differentiable exact attention: K1 forward, K2 (or K4) backward on
    the card, their plain versions on the CPU. Saves q, k, v, out and the
    (B*H, 1, Tq) lse; no (Tq, Tk) tensor outlives the forward."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, causal, scale, layout):
        out, lse = flash_attention_fwd(q, k, v, causal, scale, lengths,
                                       layout)
        ctx.save_for_backward(q, k, v, out, lse, lengths)
        ctx.causal, ctx.scale, ctx.layout = causal, scale, layout
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, lengths = ctx.saved_tensors
        # dO is autograd's own tensor and may be any view of the output's
        # gradient; the kernels take its strides but need a contiguous
        # head dim, so it is made contiguous here (a no-op when it is)
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, do.contiguous(), ctx.causal, ctx.scale,
            lengths, ctx.layout)
        return dq, dk, dv, None, None, None, None


@register_op("fused_attention")
def _fused_attention(ctx):
    """Inputs Q,K,V: (B, H, T, Dh) — or (B, T, H, Dh) with attr
    layout="bthd" (+ optional Lengths for KV padding). Attrs: causal,
    scale, dropout_rate, layout (block_k rides the desc; the kernels pick
    their own tiles). Differentiable through FlashAttention. Attention
    dropout is a later slice."""
    q, k, v = ctx.input("Q"), ctx.input("K"), ctx.input("V")
    dropout_rate = float(ctx.attr("dropout_rate", 0.0) or 0.0)
    if ctx.is_test:
        dropout_rate = 0.0
    if dropout_rate:
        raise NotImplementedError(
            "attention dropout is a later slice of the port")
    layout = str(ctx.attr("layout", "bhtd") or "bhtd").lower()
    if layout not in ("bthd", "bhtd"):
        raise ValueError("layout must be 'bthd' or 'bhtd', got %r" % (layout,))
    return {"Out": FlashAttention.apply(
        q, k, v, ctx.input("Lengths"), bool(ctx.attr("causal", False)),
        ctx.attr("scale", None), layout)}
