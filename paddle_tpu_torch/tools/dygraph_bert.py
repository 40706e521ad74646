"""BERT's encoder composed from dygraph layers, for ``chip_smoke.py``'s
phase 29 and the tests (not a public layer).

The same computation as ``models/bert.py``'s ``encoder`` (``attention``,
``encoder_layer``), op for op: ``Embedding`` (``lookup_table_v2``) for the
word, position and sentence ids, their sum, ``LayerNorm``, ``Dropout``, the
additive mask bias (``scale``, two ``unsqueeze2``), and in each layer a
``Linear`` to Q/K/V, ``split``, ``reshape2`` and ``transpose2`` to heads,
``fused_attention`` (the CUDA flash-attention kernels on the card),
``transpose2`` and ``reshape2`` back, the output ``Linear``, ``Dropout``, the
residual and ``LayerNorm``, then the FFN (``Linear``, ``gelu``, ``Linear``,
``Dropout``, residual, ``LayerNorm``). Float32 only.

``build_encoder(cfg, dg)`` takes the dygraph module to build with: the
port's when None; the tests pass the JAX package's ``paddle_tpu.dygraph``.
``static_names(model)`` maps each parameter of the dygraph encoder to the
name of the same parameter in ``models.bert.encoder``'s Program, built under
``unique_name.guard()``: ``word_emb``, ``pos_emb``, ``sent_emb``; the
embedding's layer norm ``layer_norm_0.w_0`` / ``.b_0``; in layer ``i``
``layer{i}_attn_qkv_w`` / ``_b``, ``layer{i}_attn_out_w`` / ``_b``,
``layer_norm_{2i+1}``, ``layer{i}_ffn1_w`` / ``_b``, ``layer{i}_ffn2_w`` /
``_b`` and ``layer_norm_{2i+2}``. ``load_static_state(model, arrays)`` sets
the dygraph parameters from those names.
"""
from __future__ import annotations

import math

#: the feeds of ``encoder`` and the dygraph encoder's ``forward``, in order
FEEDS = (("src_ids", "int64"), ("pos_ids", "int64"), ("sent_ids", "int64"),
         ("input_mask", "float32"))


def _op(dg, type, ins, attrs, slot="Out"):
    return dg.trace_op(type, ins, attrs, [slot])[slot]


def build_encoder(cfg, dg=None):
    """The dygraph encoder of ``cfg`` (``models.bert.BertConfig``), built
    with the dygraph module ``dg``. ``forward(src_ids, pos_ids, sent_ids,
    input_mask)`` returns the encoder's output [B, S, hidden]."""
    if dg is None:
        from .. import dygraph as dg
    if cfg.dtype != "float32":
        raise ValueError(f"the dygraph encoder is float32 only, got {cfg.dtype}")
    H, heads = cfg.hidden, cfg.n_heads
    d_head = H // heads

    class Layer(dg.Layer):
        def __init__(self, i):
            super().__init__()
            self.qkv = dg.Linear(H, 3 * H)
            self.out = dg.Linear(H, H)
            self.drop1 = dg.Dropout(cfg.dropout)
            self.norm1 = dg.LayerNorm(H)
            self.ffn1 = dg.Linear(H, cfg.ffn_hidden)
            self.ffn2 = dg.Linear(cfg.ffn_hidden, H)
            self.drop2 = dg.Dropout(cfg.dropout)
            self.norm2 = dg.LayerNorm(H)
            self.names = {self.qkv: f"layer{i}_attn_qkv", self.out: f"layer{i}_attn_out",
                          self.ffn1: f"layer{i}_ffn1", self.ffn2: f"layer{i}_ffn2",
                          self.norm1: f"layer_norm_{2 * i + 1}",
                          self.norm2: f"layer_norm_{2 * i + 2}"}

        def attention(self, x, bias):
            q, k, v = _op(dg, "split", {"X": [self.qkv(x)]},
                          {"num": 3, "sections": [], "axis": 2})
            heads_ = []
            for t in (q, k, v):
                t = _op(dg, "reshape2", {"X": [t]}, {"shape": [0, -1, heads, d_head]})[0]
                heads_.append(_op(dg, "transpose2", {"X": [t]}, {"axis": [0, 2, 1, 3]})[0])
            q, k, v = heads_
            ctx = _op(dg, "fused_attention", {"Q": [q], "K": [k], "V": [v], "Bias": [bias]},
                      {"scale": 1.0 / math.sqrt(d_head), "dropout_prob": float(cfg.dropout),
                       "causal": False, "is_test": not self.training,
                       "impl": cfg.attn_impl})[0]
            ctx = _op(dg, "transpose2", {"X": [ctx]}, {"axis": [0, 2, 1, 3]})[0]
            ctx = _op(dg, "reshape2", {"X": [ctx]}, {"shape": [0, -1, H]})[0]
            return self.out(ctx)

        def forward(self, x, bias):
            attn = self.attention(x, bias)
            if cfg.dropout:
                attn = self.drop1(attn)
            x = self.norm1(x + attn)
            ffn = _op(dg, "gelu", {"X": [self.ffn1(x)]},
                      {"approximate": bool(cfg.gelu_approximate)})[0]
            ffn = self.ffn2(ffn)
            if cfg.dropout:
                ffn = self.drop2(ffn)
            return self.norm2(x + ffn)

    class Encoder(dg.Layer):
        def __init__(self):
            super().__init__()
            self.word = dg.Embedding([cfg.vocab_size, H])
            self.pos = dg.Embedding([cfg.max_seq_len, H])
            self.sent = dg.Embedding([cfg.type_vocab, H])
            self.norm = dg.LayerNorm(H)
            self.drop = dg.Dropout(cfg.dropout)
            self.layers = [Layer(i) for i in range(cfg.n_layers)]
            for i, layer in enumerate(self.layers):
                setattr(self, f"layer{i}", layer)

        def forward(self, src_ids, pos_ids, sent_ids, input_mask):
            x = self.word(src_ids) + self.pos(pos_ids) + self.sent(sent_ids)
            x = self.norm(x)
            if cfg.dropout:
                x = self.drop(x)
            bias = _op(dg, "scale", {"X": [input_mask]},
                       {"scale": 1e4, "bias": -1e4, "bias_after_scale": True})[0]
            for _ in range(2):
                bias = _op(dg, "unsqueeze2", {"X": [bias]}, {"axes": [1]})[0]
            for layer in self.layers:
                x = layer(x, bias)
            return x

    return Encoder()


def loss(dg, out):
    """mean(square(out)), the phase's training loss."""
    return _op(dg, "mean", {"X": [_op(dg, "square", {"X": [out]}, {})[0]]}, {})[0]


def static_names(model) -> dict:
    """The dygraph encoder's structured parameter names (its ``state_dict``
    keys) -> ``models.bert.encoder``'s parameter names."""
    by_param = {id(model.word.weight): "word_emb", id(model.pos.weight): "pos_emb",
                id(model.sent.weight): "sent_emb", id(model.norm.weight): "layer_norm_0.w_0",
                id(model.norm.bias): "layer_norm_0.b_0"}
    for layer in model.layers:
        for sub, base in layer.names.items():
            if base.startswith("layer_norm_"):
                by_param[id(sub.weight)], by_param[id(sub.bias)] = base + ".w_0", base + ".b_0"
            else:
                by_param[id(sub.weight)], by_param[id(sub.bias)] = base + "_w", base + "_b"
    names = {n: by_param[id(p)] for n, p in model.named_parameters()}
    if len(names) != len(by_param):
        raise ValueError("the static name map does not cover the encoder's parameters")
    return names


def load_static_state(model, arrays) -> None:
    """Set every parameter of the dygraph encoder from ``arrays`` (static
    name -> numpy array or tensor)."""
    model.set_dict({n: arrays[s] for n, s in static_names(model).items()})


def static_encoder(pt, bert, cfg, batch, seq, lr):
    """``models.bert.encoder`` with the loss mean(square(out)) and
    ``Adam(lr)``, at static shapes, under ``unique_name.guard()``. ``pt`` and
    ``bert`` are the DSL's package and its ``models.bert``. Returns (main,
    startup, out, loss)."""
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        ins = [pt.data(n, [batch, seq], dt, append_batch_size=False) for n, dt in FEEDS]
        out = bert.encoder(*ins, cfg)
        total = pt.layers.mean(pt.layers.square(out))
        pt.optimizer.Adam(lr).minimize(total)
    return main, startup, out, total


def feed(rng, cfg, batch, seq):
    """One batch: random ids and segments, positions, a full mask."""
    import numpy as np
    return {"src_ids": rng.randint(0, cfg.vocab_size, (batch, seq)).astype("int64"),
            "pos_ids": np.tile(np.arange(seq, dtype="int64"), (batch, 1)),
            "sent_ids": rng.randint(0, cfg.type_vocab, (batch, seq)).astype("int64"),
            "input_mask": np.ones((batch, seq), "float32")}
