"""Transformer NMT, its training graph and its beam-search decode, built with
the port's DSL (the port's copy of ``paddle_tpu/models/transformer.py``).

The same layers, op types, parameter names and attrs as the JAX package's,
so a Program and its weights carry across either way: the projections and
embeddings are named by ``ParamAttr``, the fc biases and layer norms by
``unique_name``, which gives both packages the same names when both build
under ``unique_name.guard()`` in the same order. Variable-length sequences
are padded [B, S] with a 1/0 mask. Attention is composed of ``matmul``,
``softmax`` and ``dropout`` ops, as in the JAX model (no ``fused_attention``).

``beam_decode`` is one program: a ``Scan`` over ``max_len`` steps carrying
dense [B, K] beams; each step reruns the causal decoder over the whole
(static-length) prefix buffer and takes one top-k over [B, K*V]
(``ops/beam_ops.py``), as the JAX function does, with no KV cache. On the
card ``Executor.run`` captures the whole decode as one CUDA graph.
"""
from __future__ import annotations

import math

import numpy as np

from .. import layers
from ..framework import default_main_program
from ..initializer import Normal
from ..layer_helper import LayerHelper, ParamAttr


class TransformerConfig:
    def __init__(self, src_vocab=30000, trg_vocab=30000, hidden=512, n_layers=6,
                 n_heads=8, ffn_hidden=2048, max_len=256, dropout=0.1):
        self.src_vocab, self.trg_vocab = src_vocab, trg_vocab
        self.hidden, self.n_layers, self.n_heads = hidden, n_layers, n_heads
        self.ffn_hidden, self.max_len, self.dropout = ffn_hidden, max_len, dropout


def _fc(x, size, name, act=None, nfd=2):
    return layers.fc(x, size, num_flatten_dims=nfd, act=act,
                     param_attr=ParamAttr(name=name + "_w", initializer=Normal(0.0, 0.02)))


def _mha(q_in, kv_in, cfg, bias, name):
    H = cfg.hidden
    d = H // cfg.n_heads
    q = _fc(q_in, H, name + "_q")
    k = _fc(kv_in, H, name + "_k")
    v = _fc(kv_in, H, name + "_v")

    def heads(t):
        t = layers.reshape(t, [0, -1, cfg.n_heads, d])
        return layers.transpose(t, [0, 2, 1, 3])

    q, k, v = heads(q), heads(k), heads(v)
    scores = layers.matmul(q, k, transpose_y=True, alpha=1.0 / math.sqrt(d))
    if bias is not None:
        scores = layers.elementwise_add(scores, bias)
    probs = layers.softmax(scores)
    if cfg.dropout:
        probs = layers.dropout(probs, cfg.dropout, dropout_implementation="upscale_in_train")
    ctx = layers.matmul(probs, v)
    ctx = layers.reshape(layers.transpose(ctx, [0, 2, 1, 3]), [0, -1, H])
    return _fc(ctx, H, name + "_o")


def _ffn(x, cfg, name):
    h = _fc(x, cfg.ffn_hidden, name + "_ffn1", act="relu")
    return _fc(h, cfg.hidden, name + "_ffn2")


def _resid_norm(x, sub, cfg):
    if cfg.dropout:
        sub = layers.dropout(sub, cfg.dropout, dropout_implementation="upscale_in_train")
    return layers.layer_norm(layers.elementwise_add(x, sub), begin_norm_axis=2)


def _embed(ids, pos_ids, vocab, cfg, name):
    emb = layers.embedding(ids, [vocab, cfg.hidden],
                           param_attr=ParamAttr(name=name + "_emb",
                                                initializer=Normal(0.0, 0.02)))
    emb = layers.scale(emb, scale=math.sqrt(cfg.hidden))
    pos = layers.embedding(pos_ids, [cfg.max_len, cfg.hidden],
                           param_attr=ParamAttr(name=name + "_pos",
                                                initializer=Normal(0.0, 0.02)))
    x = layers.elementwise_add(emb, pos)
    if cfg.dropout:
        x = layers.dropout(x, cfg.dropout, dropout_implementation="upscale_in_train")
    return x


def _pad_bias(mask):
    """[B, S] 1/0 -> additive [B, 1, 1, S]."""
    b = layers.scale(mask, scale=1e4, bias=-1e4)
    return layers.unsqueeze(layers.unsqueeze(b, [1]), [1])


def _causal_bias(mask, S):
    """The padding mask and the causal mask as one additive [B, 1, S, S]."""
    pad = _pad_bias(mask)                                  # [B, 1, 1, S]
    tri = np.triu(np.full((S, S), -1e4, dtype="float32"), k=1)
    causal = layers.assign(tri.reshape(1, 1, S, S))
    return layers.elementwise_add(pad, causal)


def encode(src_ids, src_pos, src_mask, cfg: TransformerConfig):
    enc = _embed(src_ids, src_pos, cfg.src_vocab, cfg, "src")
    bias = _pad_bias(src_mask)
    for i in range(cfg.n_layers):
        enc = _resid_norm(enc, _mha(enc, enc, cfg, bias, f"enc{i}_attn"), cfg)
        enc = _resid_norm(enc, _ffn(enc, cfg, f"enc{i}"), cfg)
    return enc


def decode(trg_ids, trg_pos, trg_mask, enc_out, src_mask, cfg: TransformerConfig):
    S = trg_ids.shape[1]
    dec = _embed(trg_ids, trg_pos, cfg.trg_vocab, cfg, "trg")
    self_bias = _causal_bias(trg_mask, S)
    cross_bias = _pad_bias(src_mask)
    for i in range(cfg.n_layers):
        dec = _resid_norm(dec, _mha(dec, dec, cfg, self_bias, f"dec{i}_self"), cfg)
        dec = _resid_norm(dec, _mha(dec, enc_out, cfg, cross_bias, f"dec{i}_cross"), cfg)
        dec = _resid_norm(dec, _ffn(dec, cfg, f"dec{i}"), cfg)
    return _fc(dec, cfg.trg_vocab, "proj")    # [B, S, V]


def beam_decode(src_ids, src_pos, src_mask, cfg: TransformerConfig,
                beam_size=4, max_len=16, bos_id=0, eos_id=1):
    """Beam-search decode: a ``Scan`` over ``max_len`` steps carrying [B, K]
    beams, each step the causal decoder over the prefix buffer and one top-k
    over [B, K*V]. Build with ``cfg.dropout = 0``.

    Returns (sentence ids [B, K, max_len], sentence scores [B, K]), sorted
    best-first per batch row; bos is not among the tokens."""
    K, T = beam_size, max_len + 1       # the buffer holds bos and max_len tokens
    S, H = src_ids.shape[1], cfg.hidden

    enc_out = encode(src_ids, src_pos, src_mask, cfg)          # [B, S, H]

    # each batch row repeated K times (a row-major repeat, not a tile)
    def tile_beams(x, tail_shape):
        e = layers.unsqueeze(x, [1])
        e = layers.expand(e, [1, K] + [1] * len(tail_shape))
        return layers.reshape(e, [-1] + list(tail_shape))

    enc_tiled = tile_beams(enc_out, [S, H])
    src_mask_tiled = tile_beams(src_mask, [S])

    helper = LayerHelper("beam_init")
    blk = default_main_program().current_block()
    scores0 = blk.create_var(helper.name + "_scores0", (-1, K), "float32")
    fin0 = blk.create_var(helper.name + "_fin0", (-1, K), "bool")
    buf0 = blk.create_var(helper.name + "_buf0", (-1, K, T), "int64")
    helper.append_op("beam_init", inputs={"BatchRef": [src_ids]},
                     outputs={"ScoresInit": [scores0], "FinishedInit": [fin0],
                              "IdsBufInit": [buf0]},
                     attrs={"beam_size": K, "buf_len": T, "bos_id": bos_id})
    scores0, fin0, buf0 = blk.var(scores0.name), blk.var(fin0.name), blk.var(buf0.name)
    for v in (scores0, fin0, buf0):
        v.stop_gradient = True

    # the step t, scanned over axis 1 of a [1, max_len] row of indices
    t_seq = layers.assign(np.arange(max_len, dtype="int32").reshape(1, -1))
    pos_row = layers.assign(np.arange(T, dtype="int64").reshape(1, T))
    one_i32 = layers.assign(np.ones(1, dtype="int32"))

    scan = layers.Scan()
    with scan.step():
        t = scan.step_input(t_seq)                      # [1] int32
        scores = scan.memory(scores0)                   # [B, K]
        fin = scan.memory(fin0)                         # [B, K] bool
        buf = scan.memory(buf0)                         # [B, K, T]

        prefix = layers.reshape(buf, [-1, T])           # [B*K, T]
        zeros64 = layers.elementwise_mul(prefix, layers.fill_constant([1], "int64", 0))
        trg_pos = layers.elementwise_add(zeros64, pos_row)
        # the positions <= t are visible
        t64 = layers.cast(t, "int64")
        vis = layers.less_than(trg_pos, layers.elementwise_add(
            t64, layers.fill_constant([1], "int64", 1)))
        trg_mask = layers.cast(vis, "float32")          # [B*K, T]

        logits = decode(prefix, trg_pos, trg_mask, enc_tiled, src_mask_tiled, cfg)
        step_logits = layers.gather(logits, t, axis=1)  # [B*K, 1, V]
        step_logits = layers.squeeze(step_logits, [1])  # [B*K, V]
        # flat; beam_search unflattens it against PreScores' beam shape
        log_probs = layers.log_softmax(step_logits)

        sel_ids, sel_scores, parent, fin_new = layers.beam_search(
            scores, scores, log_probs, fin, K, eos_id)
        t_next = layers.elementwise_add(t, one_i32)
        buf_new = layers.beam_append(buf, parent, sel_ids, t_next)

        scan.update_memory(scores, sel_scores)
        scan.update_memory(fin, fin_new)
        scan.update_memory(buf, buf_new)
        scan.step_output(sel_ids)
        scan.step_output(parent)
    ids_steps, parent_steps = scan()                    # [B, max_len, K]
    final_scores = scan.finals[0]                       # [B, K]

    return layers.beam_search_decode(ids_steps, parent_steps, final_scores,
                                     beam_size=K, end_id=eos_id)


def greedy_decode(src_ids, src_pos, src_mask, cfg: TransformerConfig,
                  max_len=16, bos_id=0, eos_id=1):
    """Greedy decode: beam decode with beam_size 1."""
    return beam_decode(src_ids, src_pos, src_mask, cfg, beam_size=1, max_len=max_len,
                       bos_id=bos_id, eos_id=eos_id)


def transformer(src_ids, src_pos, src_mask, trg_ids, trg_pos, trg_mask,
                label_ids, cfg: TransformerConfig, label_smooth_eps=0.1):
    """The training graph; ``label_ids`` is the target shifted left. Returns
    (loss, logits): the cross-entropy against the label-smoothed one-hot
    targets, summed over the target mask and divided by its sum."""
    enc_out = encode(src_ids, src_pos, src_mask, cfg)
    logits = decode(trg_ids, trg_pos, trg_mask, enc_out, src_mask, cfg)
    if label_smooth_eps:
        labels = layers.label_smooth(
            layers.one_hot(layers.reshape(label_ids, [-1, 1]), cfg.trg_vocab),
            epsilon=label_smooth_eps)
        flat = layers.reshape(logits, [-1, cfg.trg_vocab])
        ce = layers.softmax_with_cross_entropy(flat, labels, soft_label=True)
        ce = layers.reshape(ce, [0, 1])
    else:
        flat = layers.reshape(logits, [-1, cfg.trg_vocab])
        ce = layers.softmax_with_cross_entropy(flat, layers.reshape(label_ids, [-1, 1]))
    # padded target positions carry no loss
    w = layers.reshape(trg_mask, [-1, 1])
    loss = layers.elementwise_div(layers.reduce_sum(layers.elementwise_mul(ce, w)),
                                  layers.reduce_sum(w))
    return loss, logits
