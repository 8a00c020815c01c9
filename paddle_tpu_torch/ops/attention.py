"""Fused (flash) attention: the ``fused_attention`` op and kernels K1, K2
and K4, each in fp32 and in bf16.

Counterpart of paddle_tpu/ops/attention.py. On the card the op's forward
runs K1, the hand-written CUDA flash-attention forward (csrc/flash_fwd.cu),
which replaces the Pallas TPU kernel ``_mha_fwd_kernel``; its backward runs
K2, the dq and dk/dv kernels (csrc/flash_bwd.cu, replacing
``_mha_dq_kernel`` and ``_mha_dkv_kernel``), or, with
``PADDLE_TPU_FLASH_FUSED_BWD=1`` as in the reference, K4, the single-pass
backward (csrc/flash_bwd_fused.cu, replacing ``_mha_bwd_fused_kernel``).
``FlashAttention`` ties them into one ``torch.autograd.Function`` that
saves q, k, v, out and the per-row logsumexp, never the scores.

The wrappers dispatch by dtype: fp32 tensors go to those kernels, bf16
tensors (the op under bf16 AMP) to their bf16 twins, K1-bf16, K2-bf16 and
K4-bf16 (csrc/flash_fwd_bf16.cu and csrc/flash_bwd_bf16.cu on wgmma and
TMA, csrc/flash_bwd_fused_bf16.cu on mma.sync), which compute
what the same Pallas bodies compute on bf16 operands: the reference
pre-scales q in bf16 (``q * jnp.asarray(scale, q.dtype)``) before its
kernels, which take no scale, and the chain rule through that product
scales dq in bf16 on the way out. Here ``prescale_q`` does both roundings
around the bf16 kernels' wrappers (``flash_attention_fwd_bf16``,
``flash_attention_bwd_dq_bf16``, ``..._dkv_bf16``, ``..._fused_bf16``),
which take the pre-scaled q. Any other dtype raises.

Beside the kernels stand their plain PyTorch versions,
``flash_attention_plain`` and ``flash_attention_bwd_plain`` (for bf16,
``flash_attention_plain_bf16`` and ``flash_attention_bwd_plain_bf16`` on
the pre-scaled q, with the reference's bf16 rounding points): the CPU
path and the reference the kernels are held against on the card.

The wrappers run the plain version for CPU tensors; for CUDA tensors they
launch their kernel or raise, never fall back. Each kernel's launch count
is the ``launches`` attribute of its wrapper.
"""
from __future__ import annotations

import ctypes
import math
import os
from typing import Tuple

import torch

from .registry import register_op

_HEAD_DIMS = (64, 128)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_BF16 = torch.bfloat16
_FN = {}
_BWD_FNS = {}


def _bind_error(lib, name):
    err_str = getattr(lib, "%s_error_string" % name)
    err_str.restype = ctypes.c_char_p
    err_str.argtypes = [ctypes.c_int]
    return err_str


def _kernel(bf16=False):
    """K1's (or K1-bf16's) C entry point, built and bound on first use."""
    if bf16 not in _FN:
        from ..kernels import load

        name = "flash_fwd_bf16" if bf16 else "flash_fwd"
        lib = load(name)
        fn = getattr(lib, name if bf16 else "flash_fwd_f32")
        # bf16 takes no scale: its q arrives pre-scaled
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p]
                       + ([] if bf16 else [ctypes.c_float])
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN[bf16] = (fn, _bind_error(lib, name))
    return _FN[bf16]


def _to_bhtd(x, layout):
    return x.transpose(1, 2) if layout == "bthd" else x


def _scale_of(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def _bf16_scale(scale) -> float:
    """The softmax scale rounded to bf16, as ``jnp.asarray(scale,
    bf16)`` rounds it: a Python float that bf16 represents exactly."""
    return float(torch.tensor(float(scale), dtype=_BF16))


def prescale_q(q, scale):
    """bf16 q times the bf16 scale, rounded to bf16: the q the reference's
    bf16 kernels take. The product of two bf16 values is exact in fp32, so
    multiplying by the exact Python float rounds once, as bf16 x bf16
    does."""
    return q * _bf16_scale(scale)


def _masks(t, tk, causal, lengths, device):
    """(1 or B, 1, Tq, Tk) mask of valid (query, key) pairs."""
    col = torch.arange(tk, device=device)
    mask = torch.ones((1, 1, t, tk), dtype=torch.bool, device=device)
    if lengths is not None:
        mask = mask & (col[None, None, None, :]
                       < lengths.reshape(-1, 1, 1, 1).to(device))
    if causal:
        row = torch.arange(t, device=device)
        mask = mask & (col[None, :] <= row[:, None])
    return mask


def _softmax_stats(s, mask):
    """Row max m (0 for a row with no valid key), p = exp(s - m) with
    masked entries 0, row sum l, all fp32."""
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    return m, p, p.sum(dim=-1, keepdim=True)


def _finish_fwd(pv, m, l, dtype, layout, b, h, t):
    live = l > 0
    out = pv / torch.where(live, l, torch.ones_like(l))
    lse = torch.where(live, m + torch.log(l), torch.full_like(l, float("-inf")))
    out = out.to(dtype)
    return (out.transpose(1, 2) if layout == "bthd" else out), \
        lse.reshape(b * h, 1, t)


def flash_attention_plain(q, k, v, causal=False, scale=None, lengths=None,
                          layout="bthd") -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1, same contract as the wrapper:
    q (B, Tq, H, Dh), k/v (B, Tk, H, Dh) for layout "bthd", or
    (B, H, T, Dh) for "bhtd"; ``lengths`` (B,) masks KV positions at or
    past it; causal keeps key j <= query i. Returns (out in q's layout and
    dtype, lse (B*H, 1, Tq) fp32). A row with no valid key gives zeros and
    lse -inf. bf16 inputs take K1-bf16's algorithm
    (flash_attention_plain_bf16 on prescale_q(q)). Materializes the
    (B, H, Tq, Tk) scores: a reference, not a fast path."""
    if q.dtype == _BF16:
        return flash_attention_plain_bf16(
            prescale_q(q, _scale_of(q, scale)), k, v, causal, lengths, layout)
    qh, kh, vh = (_to_bhtd(x, layout).float() for x in (q, k, v))
    b, h, t, d = qh.shape
    scale = _scale_of(q, scale)
    s = torch.matmul(qh * scale, kh.transpose(-1, -2))        # (B,H,T,Tk)
    m, p, l = _softmax_stats(s, _masks(t, kh.shape[2], causal, lengths,
                                       q.device))
    return _finish_fwd(torch.matmul(p, vh), m, l, q.dtype, layout, b, h, t)


def flash_attention_plain_bf16(qs, k, v, causal=False, lengths=None,
                               layout="bthd"
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1-bf16 on the pre-scaled bf16 ``qs``: the
    scores qs k^T and the softmax statistics in fp32, P = exp(s - m)
    rounded to bf16 before P v (fp32 sums), out = P v / l rounded to bf16,
    lse fp32. The products of bf16 values are exact in fp32, so each
    matmul here is the reference's bf16 x bf16 -> fp32 product."""
    qh, kh, vh = (_to_bhtd(x, layout).float() for x in (qs, k, v))
    b, h, t, _ = qh.shape
    s = torch.matmul(qh, kh.transpose(-1, -2))                 # (B,H,T,Tk)
    m, p, l = _softmax_stats(s, _masks(t, kh.shape[2], causal, lengths,
                                       qs.device))
    pv = torch.matmul(p.to(_BF16).float(), vh)
    return _finish_fwd(pv, m, l, _BF16, layout, b, h, t)


def _bth_strides(x, layout):
    """Element strides of the logical (batch, time, head) axes."""
    sb, s1, s2, _ = x.stride()
    return (sb, s1, s2) if layout == "bthd" else (sb, s2, s1)


def _check_kernel_input(name, x, layout, dtype):
    """What the kernels take: fp32 (K1, K2, K4) or bf16 (their twins), one
    dtype for all inputs, 4-D, a contiguous head dim, and rows that start
    on 16-byte boundaries (16-byte loads): strides that are multiples of
    4 fp32 or 8 bf16 values."""
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError("flash attention kernels take float32 or bfloat16, "
                        "got %s %s" % (name, x.dtype))
    if x.dtype != dtype:
        raise TypeError("flash attention: %s is %s where q is %s"
                        % (name, x.dtype, dtype))
    if x.ndim != 4:
        raise ValueError("flash attention: %s must be 4-D, got %s"
                         % (name, tuple(x.shape)))
    per16 = 16 // x.element_size()
    if x.stride(-1) != 1 or any(st % per16 for st in _bth_strides(x, layout)):
        raise ValueError("flash attention: %s needs a contiguous head dim "
                         "and strides that are multiples of %d (got %s)"
                         % (name, per16, tuple(x.stride())))
    if x.data_ptr() % 16:
        raise ValueError("flash attention: %s is not 16-byte aligned" % name)


def _fwd_dims(q, k, v, lengths, layout):
    """Validate the forward's inputs for a kernel; returns (B, H, Tq, Tk,
    Dh, lengths as contiguous int32 on q's device or None)."""
    if layout not in ("bthd", "bhtd"):
        raise ValueError("layout must be 'bthd' or 'bhtd', got %r" % (layout,))
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_kernel_input(name, x, layout, q.dtype)
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
    return b, h, t, tk, d, lengths


def _launch_fwd(q, k, v, causal, scale, lengths, layout):
    """Validate, then launch K1 (fp32; ``scale`` applied in the kernel) or
    K1-bf16 (bf16 q pre-scaled; ``scale`` None) -> (out, lse)."""
    b, h, t, tk, d, lengths = _fwd_dims(q, k, v, lengths, layout)
    bf16 = q.dtype == _BF16
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, 1, t), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *_bth_strides(q, layout), *_bth_strides(k, layout),
        *_bth_strides(v, layout), *_bth_strides(out, layout))
    fn, err_str = _kernel(bf16)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), lengths.data_ptr() if lengths is not None else None,
             b, h, t, tk, d, strides,
             *(() if bf16 else (float(_scale_of(q, scale)),)),
             int(bool(causal)), q.device.index,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("flash attention kernel launch failed: %s"
                           % err_str(err).decode())
    return out, lse


def flash_attention_fwd(q, k, v, causal=False, scale=None, lengths=None,
                        layout="bthd") -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact attention forward -> (out, lse); see flash_attention_plain
    for the contract. CPU tensors run the plain version. CUDA tensors
    launch K1 (fp32) or, for bf16, pre-scale q and launch K1-bf16
    (flash_attention_fwd_bf16), or raise: Dh 64 or 128, any T; strides
    taken as given, head dim contiguous."""
    if layout not in ("bthd", "bhtd"):
        raise ValueError("layout must be 'bthd' or 'bhtd', got %r" % (layout,))
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale, lengths, layout)
    if q.dtype == _BF16:
        return flash_attention_fwd_bf16(prescale_q(q, _scale_of(q, scale)),
                                        k, v, causal, lengths, layout)
    out, lse = _launch_fwd(q, k, v, causal, scale, lengths, layout)
    flash_attention_fwd.launches += 1
    return out, lse


def _bf16_only(qs, name):
    if qs.dtype != _BF16:
        raise TypeError("%s takes bfloat16, got %s" % (name, qs.dtype))


def flash_attention_fwd_bf16(qs, k, v, causal=False, lengths=None,
                             layout="bthd"
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1-bf16 on the pre-scaled bf16 ``qs`` (prescale_q) -> (out bf16,
    lse fp32). CPU tensors run flash_attention_plain_bf16; CUDA tensors
    launch K1-bf16 or raise."""
    if qs.device.type == "cpu":
        return flash_attention_plain_bf16(qs, k, v, causal, lengths, layout)
    _bf16_only(qs, "flash_attention_fwd_bf16")
    out, lse = _launch_fwd(qs, k, v, causal, None, lengths, layout)
    flash_attention_fwd_bf16.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd_bf16.launches = 0


def _bwd_kernel(name, bf16=False):
    """A backward kernel's C entry point (``flash_bwd_dq_f32``,
    ``flash_bwd_dkv_f32``, ``flash_bwd_fused_f32`` or their ``_bf16``
    twins) and its library's error-string function, built and bound on
    first use."""
    if (name, bf16) not in _BWD_FNS:
        from ..kernels import load

        lib_name = (("flash_bwd_fused" if name == "fused" else "flash_bwd")
                    + ("_bf16" if bf16 else ""))
        lib = load(lib_name)
        fn = getattr(lib, "flash_bwd_%s_%s" % (name, "bf16" if bf16
                                               else "f32"))
        n_out = {"dq": 1, "dkv": 2, "fused": 3}[name]
        fn.argtypes = ([ctypes.c_void_p] * (6 + n_out + 1)
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                       + ([] if bf16 else [ctypes.c_float])
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _BWD_FNS[name, bf16] = (fn, _bind_error(lib, lib_name))
    return _BWD_FNS[name, bf16]


def _fused_bwd_enabled() -> bool:
    """The reference's switch for the single-pass backward (K4)."""
    return os.environ.get("PADDLE_TPU_FLASH_FUSED_BWD", "0") == "1"


def attention_delta(out, do, layout="bthd") -> torch.Tensor:
    """delta = rowsum(dO * out) per (batch, head, query), fp32 (from fp32
    copies of bf16 inputs, as the reference computes it), laid out
    (B*H, Tq) like the forward's lse rows."""
    d = (do.float() * out.float()).sum(-1)
    if layout == "bthd":
        d = d.transpose(1, 2)
    return d.reshape(-1, d.shape[-1]).contiguous()


def _bwd_p(qh, kh, lse, causal, lengths, device):
    """P = exp(s - lse) from fp32 (B, H, T, Dh) qh (scale applied) and kh,
    0 where masked or where the row's lse is -inf (no valid key)."""
    b, h, t, _ = qh.shape
    s = torch.matmul(qh, kh.transpose(-1, -2))                 # (B,H,T,Tk)
    lse4 = lse.reshape(b, h, t, 1)
    mask = torch.isfinite(lse4) & _masks(t, kh.shape[2], causal, lengths,
                                         device)
    return torch.where(mask, torch.exp(s - torch.where(mask, lse4, 0.0)), 0.0)


def _back(layout):
    return (lambda x: x.transpose(1, 2)) if layout == "bthd" else \
        (lambda x: x)


def _bwd_plain(q, k, v, lse, delta, do, causal, scale, lengths, layout):
    """The backward from the saved lse and delta; see
    flash_attention_bwd_plain."""
    scale = _scale_of(q, scale)
    if q.dtype == _BF16:
        dqs, dk, dv = flash_attention_bwd_plain_bf16(
            prescale_q(q, scale), k, v, lse, delta, do, causal, lengths,
            layout)
        return prescale_q(dqs, scale), dk, dv
    qh, kh, vh, doh = (_to_bhtd(x, layout).float() for x in (q, k, v, do))
    b, h, t, d = qh.shape
    p = _bwd_p(qh * scale, kh, lse, causal, lengths, q.device)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    ds = p * (dp - delta.reshape(b, h, t, 1))
    dq = torch.matmul(ds, kh) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qh) * scale
    dv = torch.matmul(p.transpose(-1, -2), doh)
    back = _back(layout)
    return (back(dq).to(q.dtype), back(dk).to(k.dtype),
            back(dv).to(v.dtype))


def flash_attention_bwd_plain_bf16(qs, k, v, lse, delta, do, causal=False,
                                   lengths=None, layout="bthd"
                                   ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K2-bf16 and K4-bf16 on the pre-scaled bf16
    ``qs``: P = exp(qs k^T - lse) and dS = P * (dO v^T - delta) in fp32,
    then dv = bf16(P)^T dO, dqs = bf16(dS) k and dk = bf16(dS)^T qs with
    fp32 sums, each rounded to bf16 once -> (dqs, dk, dv), dqs the
    gradient of qs (prescale_q(dqs, scale) is dq)."""
    qh, kh, vh, doh = (_to_bhtd(x, layout).float() for x in (qs, k, v, do))
    b, h, t, _ = qh.shape
    p = _bwd_p(qh, kh, lse, causal, lengths, qs.device)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    ds = (p * (dp - delta.reshape(b, h, t, 1))).to(_BF16).float()
    dqs = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    dv = torch.matmul(p.to(_BF16).float().transpose(-1, -2), doh)
    back = _back(layout)
    return tuple(back(x).to(_BF16) for x in (dqs, dk, dv))


def flash_attention_bwd_plain(q, k, v, out, lse, do, causal=False,
                              scale=None, lengths=None, layout="bthd"
                              ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch backward of exact attention -> (dq, dk, dv) in the
    inputs' layout and dtype, from the forward's out and lse and the
    output gradient ``do``. It recomputes P = exp(scale q k^T - lse) at
    the full (B, H, Tq, Tk) size, one call at a time: a reference, not a
    fast path. A row with lse -inf (no valid key) and keys at or past
    ``lengths`` get zero gradients. bf16 inputs take K2-bf16's algorithm
    (flash_attention_bwd_plain_bf16 on prescale_q(q), dq scaled back in
    bf16)."""
    return _bwd_plain(q, k, v, lse, attention_delta(out, do, layout), do,
                      causal, scale, lengths, layout)


def _check_bwd_inputs(q, k, v, lse, delta, do, lengths, layout):
    """What K2 and K4 (and their bf16 twins) take: K1's rules for q, k, v
    and dO (one dtype, fp32 or bf16, a contiguous head dim, 16-byte
    aligned rows, head dim 64 or 128, one CUDA device), lse (B*H, 1, Tq)
    and delta (B*H, Tq) fp32 contiguous. Returns (B, H, Tq, Tk, Dh)."""
    if layout not in ("bthd", "bhtd"):
        raise ValueError("layout must be 'bthd' or 'bhtd', got %r" % (layout,))
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do)):
        _check_kernel_input(name, x, layout, q.dtype)
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
    or dq, dk, dv): fp32 with ``scale``, or its bf16 twin on the
    pre-scaled q (``scale`` unused)."""
    b, h, t, tk, d = _check_bwd_inputs(q, k, v, lse, delta, do, lengths,
                                       layout)
    bf16 = q.dtype == _BF16
    if lengths is not None:
        lengths = lengths.reshape(b).to(device=q.device,
                                        dtype=torch.int32).contiguous()
    # the strides of the gradients a kernel does not write are unused
    grads = ((outs[0], k, v) if name == "dq" else
             (q,) + tuple(outs) if name == "dkv" else tuple(outs))
    strides = (ctypes.c_longlong * 21)(
        *(st for x in (q, k, v, do) + grads for st in _bth_strides(x, layout)))
    fn, err_str = _bwd_kernel(name, bf16)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(),
             *(x.data_ptr() for x in outs),
             lengths.data_ptr() if lengths is not None else None,
             b, h, t, tk, d, strides,
             *(() if bf16 else (float(_scale_of(q, scale)),)),
             int(bool(causal)), q.device.index,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("flash attention backward kernel %s launch "
                           "failed: %s" % (name, err_str(err).decode()))


def flash_attention_bwd_dq(q, k, v, lse, delta, do, causal=False,
                           scale=None, lengths=None, layout="bthd"
                           ) -> torch.Tensor:
    """dq of exact attention from lse and delta (attention_delta). CPU
    tensors run the plain version; CUDA tensors launch K2's dq kernel (or,
    for bf16, K2-dq-bf16 through flash_attention_bwd_dq_bf16) or raise."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, lse, delta, do, causal, scale, lengths,
                          layout)[0]
    if q.dtype == _BF16:
        scale = _scale_of(q, scale)
        return prescale_q(flash_attention_bwd_dq_bf16(
            prescale_q(q, scale), k, v, lse, delta, do, causal, lengths,
            layout), scale)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("dq", q, k, v, lse, delta, do, (dq,), causal, scale,
                lengths, layout)
    flash_attention_bwd_dq.launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal=False,
                            scale=None, lengths=None, layout="bthd"
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of exact attention from lse and delta. CPU tensors run the
    plain version; CUDA tensors launch K2's dk/dv kernel (or K2-dkv-bf16)
    or raise."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, lse, delta, do, causal, scale, lengths,
                          layout)[1:]
    if q.dtype == _BF16:
        return flash_attention_bwd_dkv_bf16(
            prescale_q(q, _scale_of(q, scale)), k, v, lse, delta, do, causal,
            lengths, layout)
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
    tensors launch K4 (or K4-bf16) or raise. K4 adds dq into a zeroed fp32
    buffer with atomics, so dq is not bitwise reproducible from run to
    run."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, lse, delta, do, causal, scale, lengths,
                          layout)
    if q.dtype == _BF16:
        scale = _scale_of(q, scale)
        dqs, dk, dv = flash_attention_bwd_fused_bf16(
            prescale_q(q, scale), k, v, lse, delta, do, causal, lengths,
            layout)
        return prescale_q(dqs, scale), dk, dv
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd("fused", q, k, v, lse, delta, do, (dq, dk, dv), causal,
                scale, lengths, layout)
    flash_attention_bwd_fused.launches += 1
    return dq.to(q.dtype), dk, dv


def flash_attention_bwd_dq_bf16(qs, k, v, lse, delta, do, causal=False,
                                lengths=None, layout="bthd") -> torch.Tensor:
    """dqs, the gradient of the pre-scaled bf16 ``qs``, from lse and delta.
    CPU tensors run flash_attention_bwd_plain_bf16; CUDA tensors launch
    K2-dq-bf16 or raise."""
    if qs.device.type == "cpu":
        return flash_attention_bwd_plain_bf16(qs, k, v, lse, delta, do,
                                              causal, lengths, layout)[0]
    _bf16_only(qs, "flash_attention_bwd_dq_bf16")
    dq = torch.empty(qs.shape, dtype=_BF16, device=qs.device)
    _launch_bwd("dq", qs, k, v, lse, delta, do, (dq,), causal, None,
                lengths, layout)
    flash_attention_bwd_dq_bf16.launches += 1
    return dq


def flash_attention_bwd_dkv_bf16(qs, k, v, lse, delta, do, causal=False,
                                 lengths=None, layout="bthd"
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) from the pre-scaled bf16 ``qs``, lse and delta. CPU
    tensors run the plain version; CUDA tensors launch K2-dkv-bf16 or
    raise."""
    if qs.device.type == "cpu":
        return flash_attention_bwd_plain_bf16(qs, k, v, lse, delta, do,
                                              causal, lengths, layout)[1:]
    _bf16_only(qs, "flash_attention_bwd_dkv_bf16")
    dk = torch.empty(k.shape, dtype=_BF16, device=k.device)
    dv = torch.empty(v.shape, dtype=_BF16, device=v.device)
    _launch_bwd("dkv", qs, k, v, lse, delta, do, (dk, dv), causal, None,
                lengths, layout)
    flash_attention_bwd_dkv_bf16.launches += 1
    return dk, dv


def flash_attention_bwd_fused_bf16(qs, k, v, lse, delta, do, causal=False,
                                   lengths=None, layout="bthd"
                                   ) -> Tuple[torch.Tensor, ...]:
    """(dqs, dk, dv) in one pass from the pre-scaled bf16 ``qs``. CPU
    tensors run the plain version; CUDA tensors launch K4-bf16 or raise.
    dqs is summed in a zeroed fp32 buffer with atomics (not bitwise
    reproducible) and rounded to bf16 once."""
    if qs.device.type == "cpu":
        return flash_attention_bwd_plain_bf16(qs, k, v, lse, delta, do,
                                              causal, lengths, layout)
    _bf16_only(qs, "flash_attention_bwd_fused_bf16")
    dq = torch.zeros(qs.shape, dtype=torch.float32, device=qs.device)
    dk = torch.empty(k.shape, dtype=_BF16, device=k.device)
    dv = torch.empty(v.shape, dtype=_BF16, device=v.device)
    _launch_bwd("fused", qs, k, v, lse, delta, do, (dq, dk, dv), causal,
                None, lengths, layout)
    flash_attention_bwd_fused_bf16.launches += 1
    return dq.to(_BF16), dk, dv


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_fused.launches = 0
flash_attention_bwd_dq_bf16.launches = 0
flash_attention_bwd_dkv_bf16.launches = 0
flash_attention_bwd_fused_bf16.launches = 0


def flash_attention_bwd(q, k, v, out, lse, do, causal=False, scale=None,
                        lengths=None, layout="bthd"
                        ) -> Tuple[torch.Tensor, ...]:
    """Exact attention backward -> (dq, dk, dv); see
    flash_attention_bwd_plain for the contract. CPU tensors run the plain
    version. CUDA tensors launch K2 (the dq and the dk/dv kernels) or,
    with PADDLE_TPU_FLASH_FUSED_BWD=1, K4 — their bf16 twins for bf16
    tensors, on q pre-scaled once — or raise."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do, causal,
                                         scale, lengths, layout)
    if layout not in ("bthd", "bhtd"):
        raise ValueError("layout must be 'bthd' or 'bhtd', got %r" % (layout,))
    for name, x in (("out", out), ("do", do)):
        _check_kernel_input(name, x, layout, q.dtype)
    delta = attention_delta(out, do, layout)
    if q.dtype == _BF16:
        scale = _scale_of(q, scale)
        args = (prescale_q(q, scale), k, v, lse, delta, do, causal, lengths,
                layout)
        if _fused_bwd_enabled():
            dqs, dk, dv = flash_attention_bwd_fused_bf16(*args)
        else:
            dqs = flash_attention_bwd_dq_bf16(*args)
            dk, dv = flash_attention_bwd_dkv_bf16(*args)
        return prescale_q(dqs, scale), dk, dv
    args = (q, k, v, lse, delta, do, causal, scale, lengths, layout)
    if _fused_bwd_enabled():
        return flash_attention_bwd_fused(*args)
    return (flash_attention_bwd_dq(*args),) + flash_attention_bwd_dkv(*args)


class FlashAttention(torch.autograd.Function):
    """Differentiable exact attention: K1 forward, K2 (or K4) backward on
    the card — or their bf16 twins for bf16 inputs — their plain versions
    on the CPU. Saves q, k, v, out and the (B*H, 1, Tq) lse; no (Tq, Tk)
    tensor outlives the forward."""

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
    their own tiles). Differentiable through FlashAttention; under bf16
    AMP the interpreter hands it bf16 q, k, v. Attention dropout is a
    later slice."""
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
