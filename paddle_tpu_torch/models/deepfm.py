"""DeepFM CTR model: the port's copy of ``paddle_tpu/models/deepfm.py``.

The embedding tables are dense parameters (``fm_w1`` [vocab, 1], ``fm_v``
[vocab, embed]) read by ``lookup_table_v2``; their gradients are dense
tables too, filled by the rows the batch reads, and the optimizer updates
every row, as in the JAX package. The parameter names and initializers are
the JAX model's, so a state carries across by name (``convert.py``).
"""
from __future__ import annotations

from .. import layers
from ..initializer import Normal, Uniform
from ..layer_helper import ParamAttr


def deepfm(sparse_ids, dense_feat, label, num_fields, vocab_size=100000,
           embed_dim=16, hidden=(400, 400, 400)):
    """sparse_ids: [B, num_fields] int64; dense_feat: [B, D] float; label
    [B, 1] int64. Returns (loss, auc_var, predictions)."""
    # first order: a scalar weight per feature
    w1 = layers.embedding(sparse_ids, [vocab_size, 1],
                          param_attr=ParamAttr(name="fm_w1",
                                               initializer=Uniform(-1e-3, 1e-3)))
    first_order = layers.reduce_sum(layers.reshape(w1, [-1, num_fields]), 1,
                                    keep_dim=True)
    # second-order FM: 0.5 * ((sum v)^2 - sum v^2)
    emb = layers.embedding(sparse_ids, [vocab_size, embed_dim],
                           param_attr=ParamAttr(name="fm_v",
                                                initializer=Uniform(-1e-3, 1e-3)))
    sum_v = layers.reduce_sum(emb, 1)                       # [B, E]
    sum_sq = layers.square(sum_v)
    sq_sum = layers.reduce_sum(layers.square(emb), 1)
    second_order = layers.scale(
        layers.reduce_sum(layers.elementwise_sub(sum_sq, sq_sum), 1, keep_dim=True),
        scale=0.5)
    # deep part
    deep = layers.reshape(emb, [-1, num_fields * embed_dim])
    if dense_feat is not None:
        deep = layers.concat([deep, dense_feat], axis=1)
    for i, h in enumerate(hidden):
        deep = layers.fc(deep, h, act="relu",
                         param_attr=ParamAttr(name=f"deep_w{i}",
                                              initializer=Normal(0.0, 0.01)))
    deep_out = layers.fc(deep, 1, param_attr=ParamAttr(name="deep_out_w"))
    logit = layers.elementwise_add(layers.elementwise_add(first_order, second_order),
                                   deep_out)
    loss = layers.mean(
        layers.sigmoid_cross_entropy_with_logits(logit, layers.cast(label, "float32")))
    prob = layers.sigmoid(logit)
    pred_2c = layers.concat([layers.scale(prob, scale=-1.0, bias=1.0), prob], axis=1)
    auc_var, _, _ = layers.auc(pred_2c, label)
    return loss, auc_var, prob
