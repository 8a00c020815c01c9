"""layers.nn (reference: python/paddle/fluid/layers/nn.py).

The builders the decoder LM's programs use, with the JAX package's
signatures and the same emitted op descs (so both packages serialize a
built program identically). Kernels live in paddle_tpu_torch/ops/*.
"""
from __future__ import annotations

from ..framework.dtypes import convert_dtype
from ..layer_helper import LayerHelper
from .ops import elementwise_add  # re-export for parity

__all__ = [
    "fc",
    "embedding",
    "layer_norm",
    "matmul",
    "transpose",
    "reshape",
    "gather",
    "elementwise_add",
    "fused_attention",
    "decode_attention",
    "cache_append",
    "cache_append_quant",
    "decode_attention_quant",
    "cache_gather",
    "cache_append_window",
    "decode_attention_window",
    "spec_accept",
    "beam_search",
    "beam_search_decode",
    "greedy_sample",
    "top_k_sample",
    "top_p_sample",
    "mean",
    "fused_lm_head_loss",
    "dropout",
    "softmax",
    "softmax_with_cross_entropy",
    "reduce_sum",
    "unstack",
    "sequence_mask",
    "sum",
    "autoincreased_step_counter",
    "moe_ffn",
]

# the JAX package's default ``block_k`` attr: it rides the op desc (so
# programs serialize identically); the CUDA kernels pick their own tiles
_DEFAULT_ATTN_BLOCK_K = 512


def _prod(xs):
    out = 1
    for x in xs:
        out *= int(x)
    return out


def fc(
    input,
    size,
    num_flatten_dims=1,
    param_attr=None,
    bias_attr=None,
    act=None,
    is_test=False,
    name=None,
):
    """Fully connected (reference nn.py:fc): one `mul` per input + sum +
    bias + act."""
    helper = LayerHelper("fc", **locals())
    dtype = helper.input_dtype()
    inputs = helper.multiple_input()
    param_attrs = param_attr if isinstance(param_attr, (list, tuple)) else [param_attr] * len(inputs)

    mul_results = []
    for inp, attr in zip(inputs, param_attrs):
        input_shape = inp.shape
        in_features = _prod(input_shape[num_flatten_dims:])
        w = helper.create_parameter(
            attr=attr, shape=[in_features, size], dtype=dtype, is_bias=False
        )
        out_shape = tuple(input_shape[:num_flatten_dims]) + (size,)
        tmp = helper.create_variable_for_type_inference(dtype, shape=out_shape)
        helper.append_op(
            type="mul",
            inputs={"X": [inp], "Y": [w]},
            outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
        )
        mul_results.append(tmp)

    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype, shape=mul_results[0].shape)
        helper.append_op(type="sum", inputs={"X": mul_results}, outputs={"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(
    input,
    size,
    is_sparse=False,
    is_distributed=False,
    padding_idx=None,
    param_attr=None,
    dtype="float32",
):
    """reference nn.py:embedding / lookup_table_op.cc."""
    helper = LayerHelper("embedding", **locals())
    w = helper.create_parameter(attr=helper.param_attr, shape=size, dtype=dtype, is_bias=False)
    in_shape = input.shape
    if in_shape and in_shape[-1] == 1:
        out_shape = tuple(in_shape[:-1]) + (size[1],)
    else:
        out_shape = tuple(in_shape) + (size[1],)
    tmp = helper.create_variable_for_type_inference(dtype, shape=out_shape)
    padding_idx = (
        -1 if padding_idx is None else padding_idx if padding_idx >= 0 else size[0] + padding_idx
    )
    helper.append_op(
        type="lookup_table",
        inputs={"Ids": [input], "W": [w]},
        outputs={"Out": [tmp]},
        attrs={"is_sparse": is_sparse, "padding_idx": padding_idx},
    )
    return tmp


def layer_norm(
    input,
    scale=True,
    shift=True,
    begin_norm_axis=1,
    epsilon=1e-05,
    param_attr=None,
    bias_attr=None,
    act=None,
    name=None,
):
    helper = LayerHelper("layer_norm", **locals())
    dtype = input.dtype
    param_shape = [_prod(input.shape[begin_norm_axis:])]
    inputs = {"X": [input]}
    if scale:
        from ..initializer import ConstantInitializer

        s = helper.create_parameter(
            attr=helper.param_attr,
            shape=param_shape,
            dtype=dtype,
            default_initializer=ConstantInitializer(1.0),
        )
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(
            attr=helper.bias_attr, shape=param_shape, dtype=dtype, is_bias=True
        )
        inputs["Bias"] = [b]
    mean_out = helper.create_variable_for_type_inference(
        dtype, shape=input.shape[:begin_norm_axis], stop_gradient=True
    )
    var_out = helper.create_variable_for_type_inference(
        dtype, shape=input.shape[:begin_norm_axis], stop_gradient=True
    )
    out = helper.create_variable_for_type_inference(dtype, shape=input.shape)
    helper.append_op(
        type="layer_norm",
        inputs=inputs,
        outputs={"Y": [out], "Mean": [mean_out], "Variance": [var_out]},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis},
    )
    return helper.append_activation(out)


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    xs = list(x.shape)
    ys = list(y.shape)
    if transpose_x and len(xs) > 1:
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if transpose_y and len(ys) > 1:
        ys[-1], ys[-2] = ys[-2], ys[-1]
    batch = xs[:-2] if len(xs) > 2 else (ys[:-2] if len(ys) > 2 else [])
    out_shape = tuple(batch) + ((xs[-2],) if len(xs) > 1 else ()) + ((ys[-1],) if len(ys) > 1 else ())
    out = helper.create_variable_for_type_inference(x.dtype, shape=out_shape)
    helper.append_op(
        type="matmul",
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y, "alpha": float(alpha)},
    )
    return out


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", name=name)
    out_shape = tuple(x.shape[p] for p in perm)
    out = helper.create_variable_for_type_inference(x.dtype, shape=out_shape)
    helper.append_op(
        type="transpose", inputs={"X": [x]}, outputs={"Out": [out]}, attrs={"axis": list(perm)}
    )
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=True, name=None):
    helper = LayerHelper("reshape", name=name, act=act)
    out_shape = list(shape)
    in_count = _prod([s for s in x.shape if s >= 0])
    for i, s in enumerate(out_shape):
        if s == 0:
            out_shape[i] = x.shape[i]
    if -1 in out_shape and all(s >= 0 for s in x.shape):
        known = _prod([s for s in out_shape if s > 0])
        out_shape[out_shape.index(-1)] = in_count // known
    out = helper.create_variable_for_type_inference(x.dtype, shape=tuple(out_shape))
    helper.append_op(
        type="reshape", inputs={"X": [x]}, outputs={"Out": [out]}, attrs={"shape": list(shape)}
    )
    return helper.append_activation(out)


def gather(input, index):
    helper = LayerHelper("gather")
    out_shape = (index.shape[0],) + tuple(input.shape[1:])
    out = helper.create_variable_for_type_inference(input.dtype, shape=out_shape)
    helper.append_op(
        type="gather", inputs={"X": [input], "Index": [index]}, outputs={"Out": [out]}
    )
    return out


def fused_attention(q, k, v, causal=False, scale=None, sequence_length=None,
                    dropout_rate=0.0, block_k=None, layout="bhtd",
                    name=None):
    """Flash attention over (B, H, T, Dh) tensors, or (B, T, H, Dh) with
    layout="bthd" (kernel: ops/attention.py — the K1 CUDA kernel on the
    card). `sequence_length` masks padded KV positions."""
    helper = LayerHelper("fused_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype, shape=q.shape)
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if sequence_length is not None:
        inputs["Lengths"] = [sequence_length]
    helper.append_op(
        type="fused_attention",
        inputs=inputs,
        outputs={"Out": [out]},
        attrs={"causal": causal, "scale": scale,
               "dropout_rate": dropout_rate,
               "block_k": block_k or _DEFAULT_ATTN_BLOCK_K,
               "layout": layout},
    )
    return out


def decode_attention(q, k_cache, v_cache, lengths, scale=None, block_s=None,
                     name=None):
    """Single-query attention against a preallocated KV slab (kernel:
    ops/kv_cache.py — the K3 CUDA kernel on the card): q (B, 1, H, Dh)
    attends k/v slabs (B, S, H, Dh) up to ``lengths`` (B,) valid rows."""
    helper = LayerHelper("decode_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype, shape=q.shape)
    helper.append_op(
        type="decode_attention",
        inputs={"Q": [q], "KCache": [k_cache], "VCache": [v_cache],
                "Lengths": [lengths]},
        outputs={"Out": [out]},
        attrs={"scale": scale, "block_s": block_s or _DEFAULT_ATTN_BLOCK_K},
    )
    return out


def cache_append(cache, new, pos, name=None):
    """Append one row per sequence into a KV slab: ``new`` (B, 1, ...)
    lands at row ``pos[b]`` of ``cache`` (B, S, ...). The port's kernel
    writes the row into the slab in place (ops/kv_cache.py)."""
    helper = LayerHelper("cache_append", name=name)
    out = helper.create_variable_for_type_inference(
        cache.dtype, shape=cache.shape)
    helper.append_op(
        type="cache_append",
        inputs={"Cache": [cache], "New": [new], "Pos": [pos]},
        outputs={"Out": [out]},
        attrs={},
    )
    return out


def cache_append_quant(cache, scales, new, pos, name=None):
    """Quantized slab append: the float row ``new`` (B, 1, ...) lands in
    the int8 slab ``cache`` (B, S, ...) at row ``pos[b]``, quantized
    against a fresh per-row scale stored in ``scales`` (B, S) at the
    same position, both in place. Returns (new_cache, new_scales);
    kernel: ops/quant.py."""
    helper = LayerHelper("cache_append_quant", name=name)
    out = helper.create_variable_for_type_inference(
        cache.dtype, shape=cache.shape)
    out_scales = helper.create_variable_for_type_inference(
        scales.dtype, shape=scales.shape)
    helper.append_op(
        type="cache_append_quant",
        inputs={"Cache": [cache], "Scales": [scales], "New": [new],
                "Pos": [pos]},
        outputs={"Out": [out], "OutScales": [out_scales]},
        attrs={},
    )
    return out, out_scales


def decode_attention_quant(q, k_cache, k_scales, v_cache, v_scales,
                           lengths, scale=None, block_s=None, name=None):
    """``decode_attention`` over int8 K/V slabs with per-(slot,
    position) scales: the slabs dequantize, then the decode dispatch runs
    (K3 on the card; kernel: ops/quant.py)."""
    helper = LayerHelper("decode_attention_quant", name=name)
    out = helper.create_variable_for_type_inference(q.dtype, shape=q.shape)
    helper.append_op(
        type="decode_attention_quant",
        inputs={"Q": [q], "KCache": [k_cache], "KScales": [k_scales],
                "VCache": [v_cache], "VScales": [v_scales],
                "Lengths": [lengths]},
        outputs={"Out": [out]},
        attrs={"scale": scale, "block_s": block_s or _DEFAULT_ATTN_BLOCK_K},
    )
    return out


def cache_gather(cache, index, name=None):
    """Reorder KV-slab slot rows: out[i] = cache[index[i]] (beam-search
    parent reordering; kernel: ops/kv_cache.py). The output's row count
    is the product of Index's dims (the kernel flattens it)."""
    helper = LayerHelper("cache_gather", name=name)
    n = None
    if index.shape is not None and all(d is not None and d >= 0
                                       for d in index.shape):
        n = _prod(index.shape)
    out = helper.create_variable_for_type_inference(
        cache.dtype, shape=(n,) + tuple(cache.shape)[1:])
    helper.append_op(
        type="cache_gather",
        inputs={"Cache": [cache], "Index": [index]},
        outputs={"Out": [out]},
        attrs={},
    )
    return out


def cache_append_window(cache, new, pos, name=None):
    """Append T rows per sequence into a KV slab: ``new`` (B, T, ...)
    lands at rows ``pos[b]..pos[b]+T-1`` of ``cache`` (B, S, ...), in
    place; rows past S-1 are dropped (kernel: ops/speculative.py)."""
    helper = LayerHelper("cache_append_window", name=name)
    out = helper.create_variable_for_type_inference(
        cache.dtype, shape=cache.shape)
    helper.append_op(
        type="cache_append_window",
        inputs={"Cache": [cache], "New": [new], "Pos": [pos]},
        outputs={"Out": [out]},
        attrs={},
    )
    return out


def decode_attention_window(q, k_cache, v_cache, lengths, scale=None,
                            name=None):
    """T-query decode attention with the staircase window mask: window
    query i attends ``lengths[b] + i + 1`` slab rows, what T sequential
    ``decode_attention`` steps would see, in one op (kernel:
    ops/speculative.py)."""
    helper = LayerHelper("decode_attention_window", name=name)
    out = helper.create_variable_for_type_inference(q.dtype, shape=q.shape)
    helper.append_op(
        type="decode_attention_window",
        inputs={"Q": [q], "KCache": [k_cache], "VCache": [v_cache],
                "Lengths": [lengths]},
        outputs={"Out": [out]},
        attrs={"scale": scale},
    )
    return out


def spec_accept(proposed, logits, name=None):
    """In-graph speculative accept/reject: window tokens ``proposed``
    (B, T) vs target ``logits`` (B, T, V) -> (next_ids (B, T) int64,
    accept (B,) int32 longest-matching-prefix count) (kernel:
    ops/speculative.py)."""
    helper = LayerHelper("spec_accept", name=name)
    b = proposed.shape[0] if proposed.shape else None
    t = proposed.shape[1] if proposed.shape and len(proposed.shape) > 1 \
        else None
    next_ids = helper.create_variable_for_type_inference(
        "int64", shape=(b, t))
    accept = helper.create_variable_for_type_inference(
        "int32", shape=(b,))
    helper.append_op(
        type="spec_accept",
        inputs={"Proposed": [proposed], "Logits": [logits]},
        outputs={"NextIds": [next_ids], "Accept": [accept]},
        attrs={},
    )
    return next_ids, accept


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id, level=0,
                name=None):
    """One decode step over dense (B, K) beams. ``scores`` are
    ACCUMULATED log-probs (B, K, V); finished beams (pre_id == end_id)
    only propose end_id with their score unchanged. Returns
    (selected_ids, selected_scores, parent_idx), each (B, beam_size).
    ``level`` is accepted for source compatibility (kernel:
    ops/decode.py)."""
    helper = LayerHelper("beam_search", name=name)
    b = pre_ids.shape[0]
    sel_ids = helper.create_variable_for_type_inference(
        "int32", shape=(b, beam_size))
    sel_scores = helper.create_variable_for_type_inference(
        scores.dtype, shape=(b, beam_size))
    parent_idx = helper.create_variable_for_type_inference(
        "int32", shape=(b, beam_size))
    inputs = {"pre_ids": [pre_ids], "pre_scores": [pre_scores],
              "scores": [scores]}
    if ids is not None:
        inputs["ids"] = [ids]
    helper.append_op(
        type="beam_search",
        inputs=inputs,
        outputs={"selected_ids": [sel_ids], "selected_scores": [sel_scores],
                 "parent_idx": [parent_idx]},
        attrs={"beam_size": beam_size, "end_id": end_id},
    )
    return sel_ids, sel_scores, parent_idx


def beam_search_decode(ids, scores, beam_size=None, end_id=0, parent_idx=None,
                       name=None):
    """Backtrack the stacked per-step beam selections: ``ids``/``scores``
    are (steps, B, K) stacks of beam_search outputs and ``parent_idx``
    the matching parent pointers. Returns (sentence_ids (B, K, steps),
    sentence_scores (B, K)); with scores=None (sentence_ids,
    sentence_lengths (B, K) int32) (kernel: ops/decode.py)."""
    if parent_idx is None:
        raise ValueError(
            "beam_search_decode needs the stacked parent_idx produced by "
            "beam_search (dense backtracking replaces LoD lineage)")
    helper = LayerHelper("beam_search_decode", name=name)
    s, b, k = ids.shape
    sent_ids = helper.create_variable_for_type_inference(
        "int32", shape=(b, k, s))
    sent_lens = helper.create_variable_for_type_inference(
        "int32", shape=(b, k))
    outputs = {"SentenceIds": [sent_ids], "SentenceLengths": [sent_lens]}
    inputs = {"Ids": [ids], "ParentIdx": [parent_idx]}
    if scores is not None:
        sent_scores = helper.create_variable_for_type_inference(
            scores.dtype, shape=(b, k))
        inputs["Scores"] = [scores]
        outputs["SentenceScores"] = [sent_scores]
    helper.append_op(
        type="beam_search_decode", inputs=inputs, outputs=outputs,
        attrs={"end_id": end_id},
    )
    if scores is not None:
        return sent_ids, sent_scores
    return sent_ids, sent_lens


def greedy_sample(logits, name=None):
    """argmax token per row: (B, V) or (B, 1, V) -> (B,) int64 (kernel:
    ops/sampling.py)."""
    helper = LayerHelper("greedy_sample", name=name)
    out = helper.create_variable_for_type_inference(
        "int64", shape=(logits.shape[0],))
    helper.append_op(type="greedy_sample", inputs={"Logits": [logits]},
                     outputs={"Out": [out]}, attrs={})
    return out


def top_k_sample(logits, seed=None, k=40, temperature=1.0, name=None):
    """Sample from the renormalized top-k logits slice -> (B,) int64.
    ``seed`` (an int tensor; first element used) is a per-step feed in a
    decode loop: the draw is a function of its value, so a replayed step
    draws anew only when the seed changes (kernel: ops/sampling.py)."""
    helper = LayerHelper("top_k_sample", name=name)
    out = helper.create_variable_for_type_inference(
        "int64", shape=(logits.shape[0],))
    inputs = {"Logits": [logits]}
    if seed is not None:
        inputs["Seed"] = [seed]
    helper.append_op(type="top_k_sample", inputs=inputs,
                     outputs={"Out": [out]},
                     attrs={"k": k, "temperature": temperature})
    return out


def top_p_sample(logits, seed=None, p=0.9, temperature=1.0, name=None):
    """Nucleus sampling over the smallest probability mass >= p -> (B,)
    int64; same Seed contract as ``top_k_sample`` (kernel:
    ops/sampling.py)."""
    helper = LayerHelper("top_p_sample", name=name)
    out = helper.create_variable_for_type_inference(
        "int64", shape=(logits.shape[0],))
    inputs = {"Logits": [logits]}
    if seed is not None:
        inputs["Seed"] = [seed]
    helper.append_op(type="top_p_sample", inputs=inputs,
                     outputs={"Out": [out]},
                     attrs={"p": p, "temperature": temperature})
    return out


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=())
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def fused_lm_head_loss(input, label, size, param_attr=None, bias_attr=None,
                       block_v=4096, transpose_w=False, name=None):
    """Fused vocabulary projection + softmax-cross-entropy: the per-token
    loss of `fc(input, size)` against `label` without the (N, vocab)
    logits (kernel: ops/fused_loss.py, chunked online logsumexp with its
    own backward). input: (..., D); label: (...,) or (..., 1) int ids;
    returns (N, 1) fp32 loss, N = prod of input's leading dims.
    transpose_w=True declares the weight as (size, D), the tied-embedding
    layout: a param_attr naming the token-embedding table makes the head
    project through that same parameter."""
    helper = LayerHelper("fused_lm_head_loss", **locals())
    dtype = helper.input_dtype()
    d = input.shape[-1]
    w_shape = [size, d] if transpose_w else [d, size]
    w = helper.create_parameter(
        attr=helper.param_attr, shape=w_shape, dtype=dtype, is_bias=False)
    if list(w.shape) != w_shape:
        # create_parameter reuses an existing param by name whatever the
        # requested shape (the tied path relies on it): a wrong transpose_w
        # for the named table shows here
        raise ValueError(
            "fused_lm_head_loss: reused parameter %r has shape %s but "
            "transpose_w=%s requires %s" %
            (w.name, list(w.shape), bool(transpose_w), w_shape))
    inputs = {"X": [input], "W": [w], "Label": [label]}
    bias_attr = helper.bias_attr
    if bias_attr is not False:
        b = helper.create_parameter(
            attr=bias_attr, shape=[size], dtype=dtype, is_bias=True)
        inputs["Bias"] = [b]
    lead = input.shape[:-1]
    n = -1 if any(s < 0 for s in lead) else _prod(lead)
    loss = helper.create_variable_for_type_inference("float32", shape=(n, 1))
    helper.append_op(
        type="fused_lm_head_loss",
        inputs=inputs,
        outputs={"Loss": [loss]},
        attrs={"block_v": block_v, "transpose_w": bool(transpose_w)},
    )
    return loss


def softmax(input, use_cudnn=True, name=None):
    helper = LayerHelper("softmax", **locals())
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    shape=input.shape)
    helper.append_op(type="softmax", inputs={"X": [input]},
                     outputs={"Out": [out]})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100):
    """Per-row loss (..., 1) of softmax + cross entropy (kernel:
    ops/math.py); the op's Softmax output rides beside it."""
    helper = LayerHelper("softmax_with_cross_entropy")
    loss_shape = tuple(logits.shape[:-1]) + (1,)
    softmax_out = helper.create_variable_for_type_inference(
        logits.dtype, shape=logits.shape)
    loss = helper.create_variable_for_type_inference(logits.dtype,
                                                     shape=loss_shape)
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Softmax": [softmax_out], "Loss": [loss]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index},
    )
    return loss


def _reduce_layer(op_type, input, dim, keep_dim, name):
    helper = LayerHelper(op_type, name=name)
    if dim is None:
        out_shape = ()
        attrs = {"reduce_all": True, "keep_dim": keep_dim}
    else:
        dims = dim if isinstance(dim, (list, tuple)) else [dim]
        nd = len(input.shape)
        axes = sorted(d % nd for d in dims)
        shape = list(input.shape)
        if keep_dim:
            for a in axes:
                shape[a] = 1
        else:
            for a in reversed(axes):
                del shape[a]
        out_shape = tuple(shape)
        attrs = {"dim": list(dims), "keep_dim": keep_dim,
                 "reduce_all": False}
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    shape=out_shape)
    helper.append_op(type=op_type, inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_sum", input, dim, keep_dim, name)


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    nd = len(x.shape)
    ax = axis % nd
    if num is None:
        num = x.shape[ax]
    shape = [s for i, s in enumerate(x.shape) if i != ax]
    outs = [helper.create_variable_for_type_inference(x.dtype,
                                                      shape=tuple(shape))
            for _ in range(num)]
    helper.append_op(type="unstack", inputs={"X": [x]}, outputs={"Y": outs},
                     attrs={"axis": axis})
    return outs


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    """Dropout (kernel: ops/nn.py; its mask a counter-based hash, so a
    training step keeps its CUDA graph). A ``seed`` fixes the op's mask:
    the same mask every step."""
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    mask = helper.create_variable_for_type_inference(
        x.dtype, shape=x.shape, stop_gradient=True)
    helper.append_op(
        type="dropout",
        inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={
            "dropout_prob": dropout_prob,
            "is_test": is_test,
            "seed": seed if seed is not None else 0,
            "dropout_implementation": dropout_implementation,
        },
    )
    return out


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """(B,) lengths -> (B, maxlen) mask (kernel: ops/sequence.py); maxlen
    must be given."""
    helper = LayerHelper("sequence_mask", name=name)
    if maxlen is None:
        raise ValueError("sequence_mask requires a static maxlen")
    out = helper.create_variable_for_type_inference(
        convert_dtype(dtype), shape=(x.shape[0] if x.shape else -1, maxlen))
    helper.append_op(
        type="sequence_mask",
        inputs={"X": [x]},
        outputs={"Y": [out]},
        attrs={"maxlen": maxlen, "out_dtype": convert_dtype(dtype)},
    )
    return out


def sum(x):
    """The sum of a list of variables (the ``sum`` op; layers.sums)."""
    from .tensor import sums

    return sums(x if isinstance(x, (list, tuple)) else [x])


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """Persistable int64 step counter incremented once per run (reference
    nn.py:autoincreased_step_counter): state of the step, so a step with
    a learning-rate schedule stays one graph replay and ``run_loop(k)``
    advances it k times."""
    helper = LayerHelper("global_step_counter")
    name = counter_name or "@STEP_COUNTER@"
    counter = helper.create_global_variable(
        name=name, dtype="int64", shape=(1,), persistable=True
    )
    from ..initializer import ConstantInitializer

    helper.set_variable_initializer(counter, ConstantInitializer(begin - 1))
    helper.append_op(
        type="increment",
        inputs={"X": [counter]},
        outputs={"Out": [counter]},
        attrs={"step": float(step)},
    )
    counter.stop_gradient = True
    return counter


def moe_ffn(x, num_experts, d_ff, capacity_factor=2.0, k=2, ep_axis="ep",
            param_attr=None, name=None):
    """Mixture-of-experts FFN block (kernel: ops/attention.py moe_ffn; math:
    parallel/moe.py, top-k routing with per-expert capacity, by index).
    The same op desc and parameters (``<name>.gate_w/w1/b1/w2/b2``) as the
    JAX package's; ``ep_axis`` rides the desc, and the port runs the
    single-device path (its expert-parallel form waits for multi-device)."""
    helper = LayerHelper("moe_ffn", name=name)
    d = x.shape[-1]
    base = name or helper.name

    def mk(shape, suffix, is_bias=False):
        import copy

        from ..param_attr import ParamAttr

        if param_attr:
            # clone per parameter: a shared attr object would get its name
            # fixed on first use and alias all five params to one variable
            attr = copy.deepcopy(ParamAttr._to_attr(param_attr))
            attr.name = "%s.%s" % (attr.name or base, suffix)
        else:
            attr = ParamAttr(name="%s.%s" % (base, suffix))
        return helper.create_parameter(attr=attr, shape=shape,
                                       dtype=x.dtype, is_bias=is_bias)

    gate_w = mk((d, num_experts), "gate_w")
    w1 = mk((num_experts, d, d_ff), "w1")
    b1 = mk((num_experts, d_ff), "b1", is_bias=True)
    w2 = mk((num_experts, d_ff, d), "w2")
    b2 = mk((num_experts, d), "b2", is_bias=True)
    out = helper.create_variable_for_type_inference(x.dtype, shape=x.shape)
    helper.append_op(
        type="moe_ffn",
        inputs={"X": [x], "GateW": [gate_w], "W1": [w1], "B1": [b1],
                "W2": [w2], "B2": [b2]},
        outputs={"Out": [out]},
        attrs={"capacity_factor": float(capacity_factor), "k": int(k),
               "ep_axis": ep_axis},
    )
    return out
