"""BERT encoder and pretraining graph, built with the port's DSL (the
port's copy of ``paddle_tpu/models/bert.py``).

The same layers, op types, parameter names and attrs as the JAX package's
``encoder`` and ``pretrain``, so a Program and its weights (and, under
``unique_name.guard()``, its optimizer state) carry across either way.
Attention is one ``fused_attention`` op (the CUDA flash-attention kernels on
the card, forward and backward), or with ``attn_impl="composed"`` the plain
matmul/softmax/dropout graph. ``pp_stages`` wraps each group of
``n_layers / pp_stages`` layers in ``device_guard("stage:i")``, which
``PipelineOptimizer`` lowers to the ``temporal_pipeline`` op.
"""
from __future__ import annotations

import math

from .. import layers
from ..framework import default_main_program
from ..initializer import Constant, Normal
from ..layer_helper import ParamAttr


class BertConfig:
    def __init__(self, vocab_size=30522, hidden=768, n_layers=12, n_heads=12,
                 ffn_hidden=None, max_seq_len=512, type_vocab=2, dropout=0.1,
                 dtype="float32", attn_impl="auto", tie_mlm_weight=True,
                 pp_stages=None, gelu_approximate=True):
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.ffn_hidden = ffn_hidden or hidden * 4
        self.max_seq_len = max_seq_len
        self.type_vocab = type_vocab
        self.dropout = dropout
        self.dtype = dtype
        # "auto" | "pallas" (both: the CUDA kernels) | "composed" (plain graph)
        self.attn_impl = attn_impl
        self.tie_mlm_weight = tie_mlm_weight
        self.pp_stages = pp_stages
        # tanh-approximate GELU, the form google-research BERT computes
        self.gelu_approximate = gelu_approximate
        if pp_stages and n_layers % pp_stages:
            raise ValueError(f"n_layers={n_layers} must be divisible by "
                             f"pp_stages={pp_stages}")


def base_config(**kw):
    return BertConfig(n_layers=kw.pop("n_layers", 12), **kw)


def _dense(x, size, name, num_flatten_dims=2, act=None, cfg=None):
    out = layers.fc(x, size, num_flatten_dims=num_flatten_dims,
                    act=None if act == "gelu" else act,
                    param_attr=ParamAttr(name=name + "_w",
                                         initializer=Normal(0.0, 0.02)),
                    bias_attr=ParamAttr(name=name + "_b",
                                        initializer=Constant(0.0)))
    if act == "gelu":
        out = layers.gelu(out, approximate=bool(
            cfg is None or getattr(cfg, "gelu_approximate", True)))
    return out


def attention(x, cfg: BertConfig, mask_bias, name):
    """Multi-head self-attention. x: [B,S,H]; mask_bias: [B,1,1,S] additive."""
    B_H = cfg.hidden
    qkv = _dense(x, 3 * B_H, name + "_qkv")                    # [B,S,3H]
    q, k, v = layers.split(qkv, 3, dim=2)
    d_head = B_H // cfg.n_heads

    def to_heads(t):  # [B,S,H] -> [B,heads,S,d]
        t = layers.reshape(t, [0, -1, cfg.n_heads, d_head])    # 0 copies B; -1=S
        return layers.transpose(t, [0, 2, 1, 3])

    q, k, v = to_heads(q), to_heads(k), to_heads(v)
    if cfg.attn_impl == "composed":
        scores = layers.matmul(q, k, transpose_y=True,
                               alpha=1.0 / math.sqrt(d_head))  # [B,h,S,S]
        if mask_bias is not None:
            scores = layers.elementwise_add(scores, mask_bias)
        probs = layers.softmax(scores)
        if cfg.dropout:
            probs = layers.dropout(probs, cfg.dropout,
                                   dropout_implementation="upscale_in_train")
        ctx = layers.matmul(probs, v)                          # [B,h,S,d]
    else:
        ctx = layers.fused_attention(q, k, v, bias=mask_bias,
                                     scale=1.0 / math.sqrt(d_head),
                                     dropout_prob=cfg.dropout,
                                     impl=cfg.attn_impl)
    ctx = layers.transpose(ctx, [0, 2, 1, 3])
    ctx = layers.reshape(ctx, [0, -1, B_H])
    return _dense(ctx, B_H, name + "_out")


def encoder_layer(x, cfg: BertConfig, mask_bias, name):
    attn = attention(x, cfg, mask_bias, name + "_attn")
    if cfg.dropout:
        attn = layers.dropout(attn, cfg.dropout,
                              dropout_implementation="upscale_in_train")
    x = layers.layer_norm(layers.elementwise_add(x, attn), begin_norm_axis=2)
    ffn = _dense(x, cfg.ffn_hidden, name + "_ffn1", act="gelu", cfg=cfg)
    ffn = _dense(ffn, cfg.hidden, name + "_ffn2")
    if cfg.dropout:
        ffn = layers.dropout(ffn, cfg.dropout,
                             dropout_implementation="upscale_in_train")
    return layers.layer_norm(layers.elementwise_add(x, ffn), begin_norm_axis=2)


def encoder(src_ids, pos_ids, sent_ids, input_mask, cfg: BertConfig):
    """Embeddings + transformer stack. input_mask: [B,S] 1/0 float.

    Embedding tables are always float32 (the master-weight convention);
    activations are cast to ``cfg.dtype`` right after the embedding sum.
    layer_norm and softmax compute in f32 inside their ops regardless."""
    emb = layers.embedding(src_ids, [cfg.vocab_size, cfg.hidden],
                           dtype="float32",
                           param_attr=ParamAttr(name="word_emb",
                                                initializer=Normal(0.0, 0.02)))
    pos = layers.embedding(pos_ids, [cfg.max_seq_len, cfg.hidden],
                           dtype="float32",
                           param_attr=ParamAttr(name="pos_emb",
                                                initializer=Normal(0.0, 0.02)))
    sent = layers.embedding(sent_ids, [cfg.type_vocab, cfg.hidden],
                            dtype="float32",
                            param_attr=ParamAttr(name="sent_emb",
                                                 initializer=Normal(0.0, 0.02)))
    x = layers.elementwise_add(layers.elementwise_add(emb, pos), sent)
    if cfg.dtype != "float32":
        x = layers.cast(x, cfg.dtype)
    x = layers.layer_norm(x, begin_norm_axis=2)
    if cfg.dropout:
        x = layers.dropout(x, cfg.dropout,
                           dropout_implementation="upscale_in_train")
    # additive attention bias: (mask-1) * 1e4 -> -1e4 where padded
    bias = layers.scale(input_mask, scale=1e4, bias=-1e4)      # [B,S]
    bias = layers.unsqueeze(layers.unsqueeze(bias, [1]), [1])  # [B,1,1,S]
    if cfg.dtype == "bfloat16":
        bias = layers.cast(bias, "bfloat16")
    if cfg.pp_stages:
        from ..framework import device_guard
        per_stage = cfg.n_layers // cfg.pp_stages
        for i in range(cfg.n_layers):
            with device_guard(f"stage:{i // per_stage}"):
                x = encoder_layer(x, cfg, bias, f"layer{i}")
    else:
        for i in range(cfg.n_layers):
            x = encoder_layer(x, cfg, bias, f"layer{i}")
    return x


def pretrain(src_ids, pos_ids, sent_ids, input_mask, mask_pos, mask_label,
             nsp_label, cfg: BertConfig):
    """BERT pretraining loss = masked-LM + next-sentence.

    mask_pos: [M,1] int -- flat indices into [B*S] of masked tokens;
    mask_label: [M,1] int64; nsp_label: [B,1] int64.
    Returns (total_loss, mlm_loss, nsp_acc). The MLM tail stays in
    cfg.dtype; only the logits are cast up to f32 for the softmax.
    """
    enc = encoder(src_ids, pos_ids, sent_ids, input_mask, cfg)   # [B,S,H]
    flat = layers.reshape(enc, [-1, cfg.hidden])                 # [B*S,H]
    masked = layers.gather(flat, mask_pos)
    masked = layers.reshape(masked, [-1, cfg.hidden])
    mlm_h = layers.fc(masked, cfg.hidden,
                      param_attr=ParamAttr(name="mlm_trans_w",
                                           initializer=Normal(0.0, 0.02)))
    mlm_h = layers.gelu(mlm_h, approximate=bool(getattr(cfg, "gelu_approximate", True)))
    mlm_h = layers.layer_norm(mlm_h, begin_norm_axis=1)
    if cfg.tie_mlm_weight:
        # decode through word_emb^T; the f32 table is cast down so the
        # [M,H]x[H,V] decode runs in cfg.dtype, and the f32 param keeps the
        # optimizer state
        word_emb = default_main_program().global_block().var("word_emb")
        wdec = word_emb if cfg.dtype == "float32" else layers.cast(word_emb, cfg.dtype)
        mlm_logits = layers.matmul(mlm_h, wdec, transpose_y=True)
        if cfg.dtype == "bfloat16":
            mlm_logits = layers.cast(mlm_logits, "float32")
        mlm_bias = layers.create_parameter([cfg.vocab_size], "float32",
                                           name="mlm_out_bias",
                                           default_initializer=Constant(0.0))
        mlm_logits = layers.elementwise_add(mlm_logits, mlm_bias)
    else:
        mlm_logits = layers.fc(mlm_h, cfg.vocab_size,
                               param_attr=ParamAttr(name="mlm_out_w",
                                                    initializer=Normal(0.0, 0.02)))
        if cfg.dtype == "bfloat16":
            mlm_logits = layers.cast(mlm_logits, "float32")
    mlm_loss = layers.mean(layers.softmax_with_cross_entropy(mlm_logits, mask_label))

    pooled = layers.fc(layers.slice(enc, [1], [0], [1]), cfg.hidden, act="tanh",
                       num_flatten_dims=1,
                       param_attr=ParamAttr(name="pooler_w",
                                            initializer=Normal(0.0, 0.02)))
    nsp_logits = layers.fc(pooled, 2,
                           param_attr=ParamAttr(name="nsp_w",
                                                initializer=Normal(0.0, 0.02)))
    if cfg.dtype == "bfloat16":
        nsp_logits = layers.cast(nsp_logits, "float32")
    nsp_loss = layers.mean(layers.softmax_with_cross_entropy(nsp_logits, nsp_label))
    nsp_acc = layers.accuracy(nsp_logits, nsp_label)
    total = layers.elementwise_add(mlm_loss, nsp_loss)
    return total, mlm_loss, nsp_acc
