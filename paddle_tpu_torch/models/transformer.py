"""The Transformer's graphs (counterpart of
paddle_tpu/models/transformer.py): the encoder-decoder training graph
``transformer_nmt`` (``get_model``, the reference's machine-translation
benchmark model) with its ``transformer_encoder``, ``encoder_layer``,
``decoder_layer`` (self-attention, cross-attention over the encoder's
output, a dense FFN) and ``multi_head_attention``; the decoder LM's
training graph ``transformer_lm``; and its serving graphs
``transformer_lm_prefill``, ``transformer_lm_decode`` (fp32 or int8
slabs, at any depth up to the model's: the speculative draft is the same
builder at ``draft_n_layer`` layers) and ``transformer_lm_verify`` (the
speculative verify window, also the prefix store's suffix extension).

Every builder emits the JAX package's program op for op and names the
same parameters (tests pin the JSON equality): fused attention in the
BTHD layout, or BHTD under ``PADDLE_TPU_ATTN_BTHD=0``; fused q/k/v
projections; the unfused attention (scale, matmul, additive mask,
softmax, dropout, matmul); the fused LM head or the unfused one through
``softmax_with_cross_entropy``, tied or not; dropout in the FFN and in
attention. The serving builders re-create ``transformer_lm``'s parameter
set NAME-FOR-NAME (explicitly named projections AND the auto-named
layer_norm_N scale/bias pairs), so a scope trained through either
package's ``transformer_lm`` loads into them directly. That only holds
when the layer-creation ORDER matches exactly: build under
``unique_name.guard()`` and keep the layer_norm call sequence identical
(2 per layer + 1 final).

``moe_experts > 0`` swaps a decoder layer's dense FFN for a
mixture-of-experts block (``layers.moe_ffn``, routed by index on one
device), with the dense path's dropout after it. Not ported yet, raising
NotImplementedError: ring attention (queue 1 item 7, multi-device).
"""
from __future__ import annotations

import os

import numpy as np

from .. import layers
from ..framework import default_main_program
from ..initializer import NormalInitializer
from ..param_attr import ParamAttr


def _linear(x, size, name=None, num_flatten_dims=2, act=None):
    return layers.fc(
        input=x,
        size=size,
        num_flatten_dims=num_flatten_dims,
        act=act,
        param_attr=ParamAttr(name=name + ".w" if name else None,
                             initializer=NormalInitializer(0.0, 0.02)),
        bias_attr=ParamAttr(name=name + ".b" if name else None),
    )


def _ring_unported():
    raise NotImplementedError(
        "ring attention is a later slice of the port (queue 1 item 7, "
        "multi-device)")


def positionwise_ffn(x, d_inner, d_model, dropout_rate=0.0, name=None):
    h = _linear(x, d_inner, name and name + ".fc1", act="relu")
    if dropout_rate:
        h = layers.dropout(h, dropout_prob=dropout_rate)
    return _linear(h, d_model, name and name + ".fc2")


def _pre_norm(x, name=None):
    return layers.layer_norm(x, begin_norm_axis=len(x.shape) - 1)


def _embed(ids, vocab_size, d_model, max_len, name):
    B, T = ids.shape
    tok = layers.embedding(
        input=ids, size=[vocab_size, d_model],
        param_attr=ParamAttr(name=name + ".tok_emb",
                             initializer=NormalInitializer(0.0, 0.02)),
    )
    pos_ids = layers.assign(np.arange(max_len, dtype=np.int64)[:T].reshape(1, T))
    pos = layers.embedding(
        input=pos_ids, size=[max_len, d_model],
        param_attr=ParamAttr(name=name + ".pos_emb",
                             initializer=NormalInitializer(0.0, 0.02)),
    )
    return layers.elementwise_add(tok, pos)


def multi_head_attention(
    q_in, kv_in, n_head, d_model, dropout_rate=0.0, causal=False,
    kv_lengths=None, name=None, use_fused=True, use_ring=False,
    sp_axis="sp", fused_qkv=False,
):
    """(B, Tq, D) x (B, Tk, D) -> (B, Tq, D).

    use_fused=True goes through the fused_attention op: K1 forward, K2 or
    K4 backward on the card (KV lengths mask keys there), or, with
    dropout, the reference's XLA flash attention in plain PyTorch. The
    heads go to the op in the BTHD layout, the projection's own shape, or
    transposed to BHTD under PADDLE_TPU_ATTN_BTHD=0. use_fused=False
    builds the unfused path: q scaled, q k^T, the additive mask of
    ``_attn_mask``, softmax, dropout, weights v, in BHTD.

    fused_qkv=True (self-attention only) computes q/k/v in ONE (D, 3D)
    projection ``.qkv`` whose columns are grouped per head [h0: q,k,v |
    h1: q,k,v | ...], reshaped to (B, T, H, 3, Dh), transposed to put
    q/k/v first and unstacked."""
    if use_ring:
        _ring_unported()
    B, Tq, _ = q_in.shape
    Tk = kv_in.shape[1]
    d_head = d_model // n_head
    bthd = use_fused and os.environ.get("PADDLE_TPU_ATTN_BTHD", "1") == "1"

    def split_heads(x, T):
        x = layers.reshape(x, shape=[B, T, n_head, d_head])
        if bthd:
            return x  # (B, T, H, Dh), consumed as it is
        return layers.transpose(x, perm=[0, 2, 1, 3])  # (B, H, T, Dh)

    if fused_qkv and q_in is not kv_in:
        raise ValueError(
            "fused_qkv packs q/k/v of SELF-attention into one matmul; "
            "pass the same Variable as q_in and kv_in (cross-attention "
            "must use separate projections)")
    if fused_qkv:
        qkv = _linear(q_in, 3 * d_model, name and name + ".qkv")
        # (B, T, H, 3, Dh): dim 3 separates q/k/v within each head group
        qkv = layers.reshape(qkv, shape=[B, Tq, n_head, 3, d_head])
        if bthd:
            qkv = layers.transpose(qkv, perm=[3, 0, 1, 2, 4])  # (3,B,T,H,Dh)
        else:
            qkv = layers.transpose(qkv, perm=[3, 0, 2, 1, 4])  # (3,B,H,T,Dh)
        q, k, v = layers.unstack(qkv, axis=0)
    else:
        q = _linear(q_in, d_model, name and name + ".q")
        k = _linear(kv_in, d_model, name and name + ".k")
        v = _linear(kv_in, d_model, name and name + ".v")
        q = split_heads(q, Tq)
        k = split_heads(k, Tk)
        v = split_heads(v, Tk)

    if use_fused:
        ctx = layers.fused_attention(
            q, k, v, causal=causal, sequence_length=kv_lengths,
            dropout_rate=dropout_rate, layout="bthd" if bthd else "bhtd")
        if bthd:
            # already (B, Tq, H, Dh): fold heads without a transpose
            return _linear(layers.reshape(ctx, shape=[B, Tq, d_model]),
                           d_model, name and name + ".out")
    else:
        q = layers.scale(q, scale=float(d_head) ** -0.5)
        logits = layers.matmul(q, k, transpose_y=True)  # (B, H, Tq, Tk)
        mask = _attn_mask(B, Tq, Tk, causal=causal, kv_lengths=kv_lengths)
        if mask is not None:
            logits = layers.elementwise_add(logits, mask)
        weights = layers.softmax(logits)
        if dropout_rate:
            weights = layers.dropout(weights, dropout_prob=dropout_rate)
        ctx = layers.matmul(weights, v)  # (B, H, Tq, Dh)
    ctx = layers.transpose(ctx, perm=[0, 2, 1, 3])
    ctx = layers.reshape(ctx, shape=[B, Tq, d_model])
    return _linear(ctx, d_model, name and name + ".out")


def _attn_mask(B, Tq, Tk, causal=False, kv_lengths=None):
    """Additive mask (B or 1, 1, Tq, Tk): 0 keep, -1e9 drop."""
    parts = []
    if causal:
        causal_np = np.triu(np.full((Tq, Tk), -1e9, np.float32), k=1)
        parts.append(layers.assign(causal_np.reshape(1, 1, Tq, Tk)))
    if kv_lengths is not None:
        # (B, Tk) padding mask from lengths
        mask = layers.sequence_mask(kv_lengths, maxlen=Tk, dtype="float32")
        # 0 where valid, -1e9 where padded
        neg = layers.scale(mask, scale=1e9, bias=-1e9)
        parts.append(layers.reshape(neg, shape=[B, 1, 1, Tk]))
    if not parts:
        return None
    out = parts[0]
    for p in parts[1:]:
        out = layers.elementwise_add(out, p)
    return out


def encoder_layer(x, n_head, d_model, d_inner, dropout_rate, lengths, name):
    """Pre-norm encoder block: self-attention over ``lengths`` valid keys
    (not causal) and a dense FFN, each with a residual."""
    h = _pre_norm(x)
    attn = multi_head_attention(
        h, h, n_head, d_model, dropout_rate,
        kv_lengths=lengths, name=name + ".attn",
    )
    x = layers.elementwise_add(x, attn)
    ffn = positionwise_ffn(_pre_norm(x), d_inner, d_model, dropout_rate,
                           name=name + ".ffn")
    return layers.elementwise_add(x, ffn)


def decoder_layer(x, enc, n_head, d_model, d_inner, dropout_rate,
                  src_lengths, tgt_lengths, name, use_ring=False,
                  sp_axis="sp", moe_experts=0, fused_qkv=False):
    """Pre-norm decoder block: causal self-attention over ``tgt_lengths``,
    cross-attention over ``enc`` (already normalized, the
    transformer_encoder's output) and its ``src_lengths`` when given, and
    a dense FFN, each with a residual; ``moe_experts > 0`` swaps the
    dense FFN for a mixture-of-experts block (layers.moe_ffn)."""
    h = _pre_norm(x)
    self_attn = multi_head_attention(
        h, h, n_head, d_model, dropout_rate,
        causal=True, kv_lengths=tgt_lengths, name=name + ".self",
        use_ring=use_ring, sp_axis=sp_axis, fused_qkv=fused_qkv,
    )
    x = layers.elementwise_add(x, self_attn)
    if enc is not None:
        cross = multi_head_attention(
            _pre_norm(x), enc, n_head, d_model, dropout_rate,
            kv_lengths=src_lengths, name=name + ".cross",
        )
        x = layers.elementwise_add(x, cross)
    if moe_experts:
        ffn = layers.moe_ffn(_pre_norm(x), num_experts=moe_experts,
                             d_ff=d_inner, name=name + ".moe")
        if dropout_rate:
            # the dense path drops inside positionwise_ffn
            ffn = layers.dropout(ffn, dropout_prob=dropout_rate)
    else:
        ffn = positionwise_ffn(_pre_norm(x), d_inner, d_model, dropout_rate,
                               name=name + ".ffn")
    return layers.elementwise_add(x, ffn)


def transformer_encoder(src_ids, src_lengths, vocab_size, n_layer, n_head,
                        d_model, d_inner, dropout_rate=0.1, max_len=512):
    x = _embed(src_ids, vocab_size, d_model, max_len, "enc")
    for i in range(n_layer):
        x = encoder_layer(x, n_head, d_model, d_inner, dropout_rate,
                          src_lengths, "enc.l%d" % i)
    return _pre_norm(x)


def transformer_nmt(
    src_ids, src_lengths, tgt_ids, tgt_lengths, label_ids,
    src_vocab_size, tgt_vocab_size,
    n_layer=2, n_head=8, d_model=512, d_inner=2048,
    dropout_rate=0.1, max_len=512,
):
    """Encoder-decoder training graph (Vaswani et al. 2017, pre-norm);
    returns (avg_cost, logits): the token loss averaged over the target
    positions below ``tgt_lengths``."""
    enc = transformer_encoder(src_ids, src_lengths, src_vocab_size, n_layer,
                              n_head, d_model, d_inner, dropout_rate, max_len)
    x = _embed(tgt_ids, tgt_vocab_size, d_model, max_len, "dec")
    for i in range(n_layer):
        x = decoder_layer(x, enc, n_head, d_model, d_inner, dropout_rate,
                          src_lengths, tgt_lengths, "dec.l%d" % i)
    x = _pre_norm(x)
    logits = _linear(x, tgt_vocab_size, "dec.head")
    B, T = tgt_ids.shape
    loss = layers.softmax_with_cross_entropy(
        layers.reshape(logits, shape=[B * T, tgt_vocab_size]),
        layers.reshape(label_ids, shape=[B * T, 1]),
    )
    # mask padding positions out of the loss
    mask = layers.sequence_mask(tgt_lengths, maxlen=T, dtype="float32")
    mask = layers.reshape(mask, shape=[B * T, 1])
    loss = layers.elementwise_mul(loss, mask)
    avg_cost = layers.elementwise_div(
        layers.reduce_sum(loss), layers.reduce_sum(mask)
    )
    return avg_cost, logits


def transformer_lm(
    ids, labels, vocab_size, n_layer=4, n_head=8, d_model=512, d_inner=2048,
    dropout_rate=0.0, max_len=2048, fused_head=True,
    use_ring_attention=False, sp_axis="sp", moe_experts=0,
    fused_qkv=False, tie_embeddings=False,
):
    """Decoder-only causal LM (the flagship). Returns (avg_cost, logits).
    fused_head=True computes the vocab projection and loss through
    ``layers.fused_lm_head_loss`` (the (B*T, vocab) logits are never held)
    and returns logits None; fused_head=False builds the logits and
    ``softmax_with_cross_entropy``. tie_embeddings=True projects through
    the token-embedding table itself."""
    x = _embed(ids, vocab_size, d_model, max_len, "lm")
    for i in range(n_layer):
        x = decoder_layer(x, None, n_head, d_model, d_inner, dropout_rate,
                          None, None, "lm.l%d" % i,
                          use_ring=use_ring_attention, sp_axis=sp_axis,
                          moe_experts=moe_experts, fused_qkv=fused_qkv)
    x = _pre_norm(x)
    B, T = ids.shape
    if fused_head:
        if tie_embeddings:
            # the head reads the EXISTING "lm.tok_emb" (V, D) table in place
            default_main_program().global_block().var("lm.tok_emb")
            head_attr = ParamAttr(name="lm.tok_emb")
        else:
            head_attr = ParamAttr(name="lm.head.w",
                                  initializer=NormalInitializer(0.0, 0.02))
        loss = layers.fused_lm_head_loss(
            x, labels, vocab_size,
            param_attr=head_attr,
            bias_attr=ParamAttr(name="lm.head.b"),
            transpose_w=tie_embeddings,
        )
        return layers.mean(loss), None
    if tie_embeddings:
        emb = default_main_program().global_block().var("lm.tok_emb")
        logits = layers.matmul(x, emb, transpose_y=True)
        bias = layers.create_parameter(
            shape=[vocab_size], dtype=logits.dtype, name="lm.head.b",
            is_bias=True)
        logits = layers.elementwise_add(logits, bias)
    else:
        logits = _linear(x, vocab_size, "lm.head")
    loss = layers.softmax_with_cross_entropy(
        layers.reshape(logits, shape=[B * T, vocab_size]),
        layers.reshape(labels, shape=[B * T, 1]),
    )
    return layers.mean(loss), logits


def _cached_self_attention(h, n_head, d_model, name, k_cache=None,
                           v_cache=None, lengths=None, kv_lengths=None,
                           k_scale=None, v_scale=None, window=False):
    """transformer_lm's self-attention with its K/V exposed (dense mode).

    Prefill mode (no caches): full causal flash attention over (B, S);
    returns (out, k, v) with k/v in the (B, S, H, Dh) slab layout. Decode
    mode (caches given): h is (B, 1, D); the step's k/v rows append into
    the slabs at ``lengths`` and a single-query decode_attention runs
    against the updated slabs up to ``kv_lengths`` valid rows; returns
    (out, new_k_cache, new_v_cache). With ``k_scale``/``v_scale`` (B, S)
    the slabs are int8: appends quantize each fresh row against its own
    scale and attention dequantizes on read; returns (out, new_k, new_v,
    new_k_scale, new_v_scale). ``window=True`` (decode mode, h (B, T, D)):
    the verify / suffix-extension step: T rows append per slot
    (cache_append_window), THEN T queries attend with the staircase mask
    (decode_attention_window). Every append writes the slab in place and
    comes before the attention that reads it: a speculative draft's rows
    in the same slab are overwritten by the window before they are read.
    Parameter names and creation order match the JAX package's builder
    verbatim."""
    B, T, _ = h.shape
    d_head = d_model // n_head
    q = _linear(h, d_model, name + ".q")
    k = _linear(h, d_model, name + ".k")
    v = _linear(h, d_model, name + ".v")
    q = layers.reshape(q, shape=[B, T, n_head, d_head])
    k = layers.reshape(k, shape=[B, T, n_head, d_head])
    v = layers.reshape(v, shape=[B, T, n_head, d_head])
    if k_cache is None:
        ctx = layers.fused_attention(q, k, v, causal=True, layout="bthd")
        out = _linear(layers.reshape(ctx, shape=[B, T, d_model]),
                      d_model, name + ".out")
        return out, k, v
    if window:
        new_k = layers.cache_append_window(k_cache, k, lengths)
        new_v = layers.cache_append_window(v_cache, v, lengths)
        ctx = layers.decode_attention_window(q, new_k, new_v, lengths)
        out = _linear(layers.reshape(ctx, shape=[B, T, d_model]),
                      d_model, name + ".out")
        return out, new_k, new_v
    if k_scale is not None:
        new_k, new_ks = layers.cache_append_quant(k_cache, k_scale, k,
                                                  lengths)
        new_v, new_vs = layers.cache_append_quant(v_cache, v_scale, v,
                                                  lengths)
        ctx = layers.decode_attention_quant(q, new_k, new_ks, new_v,
                                            new_vs, kv_lengths)
        out = _linear(layers.reshape(ctx, shape=[B, T, d_model]),
                      d_model, name + ".out")
        return out, new_k, new_v, new_ks, new_vs
    new_k = layers.cache_append(k_cache, k, lengths)
    new_v = layers.cache_append(v_cache, v, lengths)
    ctx = layers.decode_attention(q, new_k, new_v, kv_lengths)
    out = _linear(layers.reshape(ctx, shape=[B, T, d_model]),
                  d_model, name + ".out")
    return out, new_k, new_v


def _lm_head_logits(x, vocab_size, tie_embeddings, prefix):
    """Vocab projection on a (B, D) last-hidden row; same parameters as
    transformer_lm(fused_head=False)."""
    if tie_embeddings:
        emb = default_main_program().global_block().var(prefix + ".tok_emb")
        logits = layers.matmul(x, emb, transpose_y=True)
        bias = layers.create_parameter(
            shape=[vocab_size], dtype=logits.dtype, name=prefix + ".head.b",
            is_bias=True)
        return layers.elementwise_add(logits, bias)
    return layers.fc(
        x, vocab_size, num_flatten_dims=1,
        param_attr=ParamAttr(name=prefix + ".head.w",
                             initializer=NormalInitializer(0.0, 0.02)),
        bias_attr=ParamAttr(name=prefix + ".head.b"))


def transformer_lm_prefill(
    tokens, lengths, vocab_size, n_layer=4, n_head=8, d_model=512,
    d_inner=2048, max_len=2048, tie_embeddings=False, prefix="lm",
    use_ring_attention=False,
):
    """Prefill graph: the full causal forward over padded prompts
    ``tokens`` (B, S) with ``lengths`` (B,) valid tokens, POPULATING the
    KV slabs as a side product.

    Returns (last_logits, caches): last_logits (B, V) is the vocab
    projection of each row's final valid position (the hidden state is
    gathered BEFORE the head), caches is [(k_0, v_0), ...] per layer in
    the (B, S, H, Dh) slab layout. Positions past a row's length hold
    garbage K/V — decode_attention masks them by length. Ring prefill
    needs the ring_attention op and an sp mesh: queue 1 item 7
    (multi-device)."""
    if use_ring_attention:
        raise NotImplementedError(
            "ring prefill is a later slice of the port (queue 1 item 7, "
            "multi-device: the ring_attention op and an sp mesh)")
    x = _embed(tokens, vocab_size, d_model, max_len, prefix)
    B, S = tokens.shape
    caches = []
    for i in range(n_layer):
        h = _pre_norm(x)
        attn, k, v = _cached_self_attention(
            h, n_head, d_model, "%s.l%d.self" % (prefix, i))
        caches.append((k, v))
        x = layers.elementwise_add(x, attn)
        ffn = positionwise_ffn(_pre_norm(x), d_inner, d_model, 0.0,
                               name="%s.l%d.ffn" % (prefix, i))
        x = layers.elementwise_add(x, ffn)
    x = _pre_norm(x)
    # gather each row's LAST VALID hidden state: flat row index
    # b*S + (lengths[b] - 1)
    flat = layers.reshape(x, shape=[B * S, d_model])
    base = layers.assign(
        (np.arange(B, dtype=np.int32) * S - 1).reshape(B))
    idx = layers.elementwise_add(layers.cast(lengths, "int32"), base)
    last = layers.gather(flat, idx)  # (B, D)
    return _lm_head_logits(last, vocab_size, tie_embeddings, prefix), caches


def transformer_lm_decode(
    tokens, positions, lengths, k_caches, v_caches, vocab_size,
    n_layer=4, n_head=8, d_model=512, d_inner=2048, max_len=2048,
    tie_embeddings=False, prefix="lm", strategy="greedy", seed=None,
    sample_k=40, sample_p=0.9, temperature=1.0,
    k_scales=None, v_scales=None,
):
    """One incremental decode step: ``tokens`` (B, 1) int64 (the
    previously sampled token per slot), ``positions`` (B, 1) int64 (its
    sequence position = the slot's pre-append length), ``lengths`` (B,)
    int32 valid cache rows BEFORE this step, and per-layer K/V slabs
    (B, S, H, Dh).

    Each layer appends its fresh K/V row at ``lengths`` and runs
    single-query decode_attention over lengths+1 valid rows. Returns
    (next_ids, logits, new_caches): next_ids (B,) int64 per ``strategy``
    ("greedy" | "topk" | "topp" | "logits", the last skips sampling);
    the top-k and top-p draws are functions of the ``seed`` feed's value
    (ops/sampling.py). With ``k_scales``/``v_scales`` (per-layer (B, S)
    tensors) the slabs are int8 and each ``new_caches`` entry is the
    4-tuple (k, v, k_scales, v_scales). ``n_layer`` below the model's
    depth builds the speculative draft over the first layers' slabs."""
    B = tokens.shape[0]
    # embedding squeezes the trailing ids dim of 1 (LoD convention):
    # (B, 1) ids -> (B, D); restore the singleton time axis explicitly
    tok = layers.embedding(
        input=tokens, size=[vocab_size, d_model],
        param_attr=ParamAttr(name=prefix + ".tok_emb",
                             initializer=NormalInitializer(0.0, 0.02)))
    pos = layers.embedding(
        input=positions, size=[max_len, d_model],
        param_attr=ParamAttr(name=prefix + ".pos_emb",
                             initializer=NormalInitializer(0.0, 0.02)))
    x = layers.reshape(layers.elementwise_add(tok, pos),
                       shape=[B, 1, d_model])
    kv_lengths = layers.elementwise_add(
        layers.cast(lengths, "int32"),
        layers.fill_constant(shape=[B], dtype="int32", value=1))
    new_caches = []
    for i in range(n_layer):
        h = _pre_norm(x)
        if k_scales is not None:
            attn, nk, nv, nks, nvs = _cached_self_attention(
                h, n_head, d_model, "%s.l%d.self" % (prefix, i),
                k_cache=k_caches[i], v_cache=v_caches[i], lengths=lengths,
                kv_lengths=kv_lengths, k_scale=k_scales[i],
                v_scale=v_scales[i])
            new_caches.append((nk, nv, nks, nvs))
        else:
            attn, nk, nv = _cached_self_attention(
                h, n_head, d_model, "%s.l%d.self" % (prefix, i),
                k_cache=k_caches[i], v_cache=v_caches[i], lengths=lengths,
                kv_lengths=kv_lengths)
            new_caches.append((nk, nv))
        x = layers.elementwise_add(x, attn)
        ffn = positionwise_ffn(_pre_norm(x), d_inner, d_model, 0.0,
                               name="%s.l%d.ffn" % (prefix, i))
        x = layers.elementwise_add(x, ffn)
    x = _pre_norm(x)
    last = layers.reshape(x, shape=[B, d_model])
    logits = _lm_head_logits(last, vocab_size, tie_embeddings, prefix)
    if strategy == "greedy":
        next_ids = layers.greedy_sample(logits)
    elif strategy == "topk":
        next_ids = layers.top_k_sample(logits, seed=seed, k=sample_k,
                                       temperature=temperature)
    elif strategy == "topp":
        next_ids = layers.top_p_sample(logits, seed=seed, p=sample_p,
                                       temperature=temperature)
    elif strategy == "logits":
        next_ids = None
    else:
        raise ValueError("unknown decode strategy %r (greedy | topk | "
                         "topp | logits)" % (strategy,))
    return next_ids, logits, new_caches


def transformer_lm_verify(
    tokens, positions, lengths, last_idx, k_caches, v_caches, vocab_size,
    n_layer=4, n_head=8, d_model=512, d_inner=2048, max_len=2048,
    tie_embeddings=False, prefix="lm",
):
    """One speculative VERIFY window (also the prefix store's suffix
    extension step): ``tokens`` (B, T) int64 (window slot 0 each
    sequence's committed token, slots 1..T-1 the draft's proposals) at
    ``positions`` (B, T), ``lengths`` (B,) valid cache rows BEFORE the
    window, per-layer K/V slabs (B, S, H, Dh).

    Every layer appends its T rows at lengths..lengths+T-1 in place,
    then runs T-query staircase attention: one step, not T decode steps.
    Returns (next_ids (B, T) int64, the target's argmax after each
    window position; accept (B,) int32, the accepted proposals per slot;
    last_logits (B, V), the logits at window position ``last_idx[b]``;
    new_caches). Parameter names match the other decode builders, so
    one loaded state drives every step kind."""
    B, T = tokens.shape
    if T < 2:
        raise ValueError(
            "verify windows need T >= 2 (one committed token + at least "
            "one proposal); got T=%d" % T)
    tok = layers.embedding(
        input=tokens, size=[vocab_size, d_model],
        param_attr=ParamAttr(name=prefix + ".tok_emb",
                             initializer=NormalInitializer(0.0, 0.02)))
    pos = layers.embedding(
        input=positions, size=[max_len, d_model],
        param_attr=ParamAttr(name=prefix + ".pos_emb",
                             initializer=NormalInitializer(0.0, 0.02)))
    x = layers.elementwise_add(tok, pos)                   # (B, T, D)
    new_caches = []
    for i in range(n_layer):
        h = _pre_norm(x)
        attn, nk, nv = _cached_self_attention(
            h, n_head, d_model, "%s.l%d.self" % (prefix, i),
            k_cache=k_caches[i], v_cache=v_caches[i], lengths=lengths,
            window=True)
        new_caches.append((nk, nv))
        x = layers.elementwise_add(x, attn)
        ffn = positionwise_ffn(_pre_norm(x), d_inner, d_model, 0.0,
                               name="%s.l%d.ffn" % (prefix, i))
        x = layers.elementwise_add(x, ffn)
    x = _pre_norm(x)
    flat = layers.reshape(x, shape=[B * T, d_model])
    logits = _lm_head_logits(flat, vocab_size, tie_embeddings, prefix)
    logits3 = layers.reshape(logits, shape=[B, T, vocab_size])
    next_ids, accept = layers.spec_accept(tokens, logits3)
    base = layers.assign((np.arange(B, dtype=np.int32) * T).reshape(B))
    idx = layers.elementwise_add(layers.cast(last_idx, "int32"), base)
    last_logits = layers.gather(logits, idx)               # (B, V)
    return next_ids, accept, last_logits, new_caches


def get_model(
    batch_size=16, seq_len=64, src_vocab_size=10000, tgt_vocab_size=10000,
    n_layer=2, n_head=8, d_model=512, d_inner=2048, dropout_rate=0.1,
):
    """The machine-translation benchmark model: its five feeds (src_ids,
    src_len, tgt_ids, tgt_len, lbl_ids) and transformer_nmt over them.
    Returns (avg_cost, None, feeds)."""
    src = layers.data(name="src_ids", shape=[batch_size, seq_len],
                      dtype="int64", append_batch_size=False)
    src_len = layers.data(name="src_len", shape=[batch_size], dtype="int32",
                          append_batch_size=False)
    tgt = layers.data(name="tgt_ids", shape=[batch_size, seq_len],
                      dtype="int64", append_batch_size=False)
    tgt_len = layers.data(name="tgt_len", shape=[batch_size], dtype="int32",
                          append_batch_size=False)
    lbl = layers.data(name="lbl_ids", shape=[batch_size, seq_len],
                      dtype="int64", append_batch_size=False)
    avg_cost, _logits = transformer_nmt(
        src, src_len, tgt, tgt_len, lbl, src_vocab_size, tgt_vocab_size,
        n_layer, n_head, d_model, d_inner, dropout_rate,
    )
    return avg_cost, None, [src, src_len, tgt, tgt_len, lbl]
