"""Fused LM-head softmax-cross-entropy: the vocabulary projection and the
loss without ever holding the (N, V) logits (counterpart of
paddle_tpu/ops/fused_loss.py).

The vocab axis is taken in chunks of ``block_v`` with an online
logsumexp: the forward saves only x, w, b, the labels and the per-row
logsumexp; the backward recomputes each chunk's logits, forms
(softmax - onehot) per chunk and accumulates dx, dw and db, so no more
than one (N, block_v) logits chunk is live at a time. Chunks are read from
w in place (a column block of a (D, V) weight, or a row block of the
(V, D) tied embedding table with ``transpose_w``). A last chunk that
``block_v`` does not fill is padded with zero weights and a bias of -1e30,
as the reference's ``_pad_wb`` pads, so its padded logits vanish from the
logsumexp. The products are plain ``torch.matmul`` (the reference leaves
them to XLA; there is no Pallas kernel here).
"""
from __future__ import annotations

import torch

from .registry import register_op

_NEG = -1e30


def _chunk(w, b, j, block_v, transpose_w):
    """Chunk j of the vocab axis: (wb, bb, lo, hi), wb (D, block_v) — or
    (block_v, D) with transpose_w — and bb (block_v,), padded past the
    vocab with zero weights and bias -1e30."""
    v = w.shape[0 if transpose_w else 1]
    lo, hi = j * block_v, min(v, (j + 1) * block_v)
    wb = w[lo:hi] if transpose_w else w[:, lo:hi]
    bb = b[lo:hi]
    pad = block_v - (hi - lo)
    if pad:
        wb = torch.nn.functional.pad(wb, (0, 0, 0, pad) if transpose_w
                                     else (0, pad))
        bb = torch.nn.functional.pad(bb, (0, pad), value=_NEG)
    return wb, bb, lo, hi


def _logits(x, wb, bb, transpose_w):
    return torch.matmul(x, wb.t() if transpose_w else wb) + bb


class LMHeadLoss(torch.autograd.Function):
    """x (N, D), w (D, V) — or (V, D) with transpose_w — b (V,), labels (N,)
    int -> loss (N, 1) fp32: logsumexp_v(x w + b) - (x w + b)[label]."""

    @staticmethod
    def forward(ctx, x, w, b, labels, block_v, transpose_w):
        n = x.shape[0]
        v = w.shape[0 if transpose_w else 1]
        labels = labels.reshape(n).long()
        m = torch.full((n,), _NEG, dtype=torch.float32, device=x.device)
        s = torch.zeros((n,), dtype=torch.float32, device=x.device)
        picked = torch.zeros((n,), dtype=torch.float32, device=x.device)
        for j in range(-(-v // block_v)):
            wb, bb, lo, _ = _chunk(w, b, j, block_v, transpose_w)
            logits = _logits(x, wb.to(x.dtype), bb, transpose_w).float()
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=-1)
            m = m_new
            col = labels - lo
            hit = (col >= 0) & (col < block_v)
            picked = picked + torch.where(
                hit, logits.gather(1, col.clamp(0, block_v - 1)[:, None])[:, 0],
                0.0)
        lse = m + torch.log(s)
        ctx.save_for_backward(x, w, b, labels, lse)
        ctx.block_v, ctx.transpose_w = block_v, transpose_w
        return (lse - picked)[:, None]

    @staticmethod
    def backward(ctx, g):
        x, w, b, labels, lse = ctx.saved_tensors
        block_v, transpose_w = ctx.block_v, ctx.transpose_w
        v = w.shape[0 if transpose_w else 1]
        gl = g.reshape(-1, 1).float()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        db = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
        rows = torch.arange(x.shape[0], device=x.device)
        for j in range(-(-v // block_v)):
            wb, bb, lo, hi = _chunk(w, b, j, block_v, transpose_w)
            wbx = wb.to(x.dtype)
            p = torch.exp(_logits(x, wbx, bb, transpose_w).float()
                          - lse[:, None])  # padded columns: exp(-1e30) = 0
            col = labels - lo
            hit = (col >= 0) & (col < block_v)
            p[rows[hit], col[hit]] -= 1.0
            gch = (p * gl).to(x.dtype)                          # (N, block_v)
            k = hi - lo
            if transpose_w:
                dx += torch.matmul(gch, wbx)
                dw[lo:hi] = torch.matmul(gch.t(), x)[:k]
            else:
                dx += torch.matmul(gch, wbx.t())
                dw[:, lo:hi] = torch.matmul(x.t(), gch)[:, :k]
            db[lo:hi] = gch.float().sum(dim=0)[:k]
        return (dx.to(x.dtype), dw.to(w.dtype), db.to(b.dtype), None, None,
                None)


def lm_head_loss(block_v, x, w, b, labels, transpose_w=False):
    """x: (N, D); w: (D, V) — or (V, D) with ``transpose_w=True``, the
    tied-embedding layout where w is the token-embedding table used in
    place; b: (V,); labels: (N,) int -> loss (N, 1) fp32."""
    return LMHeadLoss.apply(x, w, b, labels, int(block_v), bool(transpose_w))


@register_op("fused_lm_head_loss")
def _fused_lm_head_loss(ctx):
    """Inputs X: (..., D), W: (D, V), Bias: (V,) optional, Label: (..., 1)
    or (...,) int. Output Loss: (N, 1) fp32 per-token loss, N = prod of
    X's leading dims. Attr block_v: vocab chunk size. Attr transpose_w: W
    is (V, D), the tied-embedding layout, read in place."""
    x = ctx.input("X")
    w = ctx.input("W")
    transpose_w = bool(ctx.attr("transpose_w", False))
    block_v = int(ctx.attr("block_v", 4096))
    b = ctx.input("Bias")
    if b is None:
        b = torch.zeros((w.shape[0 if transpose_w else 1],),
                        dtype=torch.float32, device=w.device)
    loss = lm_head_loss(block_v, x.reshape(-1, x.shape[-1]), w, b.float(),
                        ctx.input("Label").reshape(-1),
                        transpose_w=transpose_w)
    return {"Loss": loss}
