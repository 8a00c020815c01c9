"""The flagship decoder LM's graphs (counterpart of
paddle_tpu/models/transformer.py): the training graph ``transformer_lm``
with its ``multi_head_attention`` and ``decoder_layer``, and the serving
graphs ``transformer_lm_prefill``, ``transformer_lm_decode`` (fp32 or
int8 slabs, at any depth up to the model's: the speculative draft is the
same builder at ``draft_n_layer`` layers) and ``transformer_lm_verify``
(the speculative verify window, also the prefix store's suffix
extension).

``transformer_lm`` builds the JAX package's program op for op (fused
attention in the BTHD layout, or BHTD under ``PADDLE_TPU_ATTN_BTHD=0``;
the fused LM head, tied or not), so both packages serialize the same
program and name the same parameters (a test pins it). The serving
builders re-create ``transformer_lm``'s parameter set NAME-FOR-NAME
(explicitly named projections AND the auto-named layer_norm_N scale/bias
pairs), so a scope trained through either package's ``transformer_lm``
loads into them directly. That only holds when the layer-creation ORDER
matches exactly: build under ``unique_name.guard()`` and keep the
layer_norm call sequence identical (2 per layer + 1 final).

Not ported yet: ring attention (queue 1 item 7, multi-device), fused
q/k/v projections, the unfused
attention and LM-head paths, cross-attention (the encoder-decoder model),
mixture-of-experts FFNs and dropout; each raises NotImplementedError.
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


def positionwise_ffn(x, d_inner, d_model, dropout_rate=0.0, name=None):
    if dropout_rate:
        raise NotImplementedError("dropout is a later slice of the port")
    h = _linear(x, d_inner, name and name + ".fc1", act="relu")
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


def multi_head_attention(
    q_in, kv_in, n_head, d_model, dropout_rate=0.0, causal=False,
    kv_lengths=None, name=None, use_fused=True, use_ring=False,
    sp_axis="sp", fused_qkv=False,
):
    """(B, Tq, D) x (B, Tk, D) -> (B, Tq, D) through the fused_attention
    op (flash attention: K1 forward, K2 or K4 backward on the card). The
    heads go to the op in the BTHD layout, the projection's own shape, or
    transposed to BHTD under PADDLE_TPU_ATTN_BTHD=0, as in the JAX
    package."""
    if use_ring or fused_qkv or not use_fused:
        raise NotImplementedError(
            "ring attention, fused q/k/v projections and the unfused "
            "attention path are a later slice of the port")
    B, Tq, _ = q_in.shape
    Tk = kv_in.shape[1]
    d_head = d_model // n_head
    bthd = os.environ.get("PADDLE_TPU_ATTN_BTHD", "1") == "1"

    def split_heads(x, T):
        x = layers.reshape(x, shape=[B, T, n_head, d_head])
        if bthd:
            return x  # (B, T, H, Dh), consumed as it is
        return layers.transpose(x, perm=[0, 2, 1, 3])  # (B, H, T, Dh)

    q = _linear(q_in, d_model, name and name + ".q")
    k = _linear(kv_in, d_model, name and name + ".k")
    v = _linear(kv_in, d_model, name and name + ".v")
    q = split_heads(q, Tq)
    k = split_heads(k, Tk)
    v = split_heads(v, Tk)
    ctx = layers.fused_attention(
        q, k, v, causal=causal, sequence_length=kv_lengths,
        dropout_rate=dropout_rate, layout="bthd" if bthd else "bhtd")
    if not bthd:
        ctx = layers.transpose(ctx, perm=[0, 2, 1, 3])
    ctx = layers.reshape(ctx, shape=[B, Tq, d_model])
    return _linear(ctx, d_model, name and name + ".out")


def decoder_layer(x, enc, n_head, d_model, d_inner, dropout_rate,
                  src_lengths, tgt_lengths, name, use_ring=False,
                  sp_axis="sp", moe_experts=0, fused_qkv=False):
    """Pre-norm decoder block: causal self-attention and a dense FFN, each
    with a residual. Cross-attention (``enc``) and MoE FFNs are a later
    slice."""
    if enc is not None or moe_experts:
        raise NotImplementedError(
            "cross-attention and mixture-of-experts FFNs are a later slice "
            "of the port")
    h = _pre_norm(x)
    self_attn = multi_head_attention(
        h, h, n_head, d_model, dropout_rate,
        causal=True, kv_lengths=tgt_lengths, name=name + ".self",
        use_ring=use_ring, sp_axis=sp_axis, fused_qkv=fused_qkv,
    )
    x = layers.elementwise_add(x, self_attn)
    ffn = positionwise_ffn(_pre_norm(x), d_inner, d_model, dropout_rate,
                           name=name + ".ffn")
    return layers.elementwise_add(x, ffn)


def transformer_lm(
    ids, labels, vocab_size, n_layer=4, n_head=8, d_model=512, d_inner=2048,
    dropout_rate=0.0, max_len=2048, fused_head=True,
    use_ring_attention=False, sp_axis="sp", moe_experts=0,
    fused_qkv=False, tie_embeddings=False,
):
    """Decoder-only causal LM (the flagship). Returns (avg_cost, None): the
    vocab projection and loss go through ``layers.fused_lm_head_loss``, so
    the (B*T, vocab) logits are never held. tie_embeddings=True projects
    through the token-embedding table itself (transpose_w). The unfused
    head (fused_head=False) is a later slice."""
    if not fused_head:
        raise NotImplementedError(
            "transformer_lm(fused_head=False) needs softmax_with_cross_"
            "entropy, a later slice of the port")
    x = _embed(ids, vocab_size, d_model, max_len, "lm")
    for i in range(n_layer):
        x = decoder_layer(x, None, n_head, d_model, d_inner, dropout_rate,
                          None, None, "lm.l%d" % i,
                          use_ring=use_ring_attention, sp_axis=sp_axis,
                          moe_experts=moe_experts, fused_qkv=fused_qkv)
    x = _pre_norm(x)
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
