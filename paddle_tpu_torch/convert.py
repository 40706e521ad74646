"""Carry weights from the JAX package into the port.

``state_from_numpy`` takes the JAX package's scope as numpy arrays (name ->
array, e.g. ``{n: np.asarray(scope.find_var(n)) for n in scope.var_names()}``)
and returns torch tensors under the same names. Parameter names are the same
in both packages' models, so the result loads straight into a program built
by the port's DSL. A training state carries across the same way: the
optimizer's accumulators (``{param}_moment1_0``, ``{param}_moment2_0``,
``{param}_beta1_pow_acc_0``, ``{param}_beta2_pow_acc_0``) and
``learning_rate_0`` are named by ``unique_name`` in both packages, so a
program built under ``unique_name.guard()`` in either names its persistable
state identically. The same holds for ResNet (bf16 filters and batch-norm
scales, f32 running statistics, ``{param}_velocity_0``) and for a model
quantized by ``quantize_weights`` in either package (int8 codes under the
weight's name, f32 scales under ``{weight}@scale``): arrays keep their
dtypes. The Transformer's training state is its parameters (the
``ParamAttr``-named projections and embeddings, ``{name}_w`` and
``src_emb`` / ``src_pos`` / ``trg_emb`` / ``trg_pos``, and the
``unique_name``-named fc biases ``fc_N.b_0`` and layer norms
``layer_norm_N.w_0`` / ``.b_0``), Adam's four accumulators for each and
``learning_rate_0``; a decode program built under ``unique_name.guard()``
names its parameters as the training program does, so trained weights load
into it by name. DeepFM's training state is its two tables ``fm_w1``
[vocab, 1] and ``fm_v`` [vocab, embed], the tower ``deep_w{i}`` /
``deep_out_w`` with the ``unique_name``-named biases ``fc_N.b_0``, Adam's
four accumulators for each and ``learning_rate_N``, and the ``auc`` op's
two f32 histograms, persistable globals named by ``unique_name``
(``auc_0.global_0`` for StatPos, ``auc_0.global_1`` for StatNeg); the MNIST
MLP's is its fc weights and biases (``fc_N.w_0`` / ``fc_N.b_0``, ``SGD``
keeps no accumulators) and ``learning_rate_N``. The book chapters'
(``tools/book.py``) carry the same way, with no code of their own: an
LSTM's or GRU's gate weights are the ``unique_name``-named ``fc_N.w_0`` /
``fc_N.b_0`` that its ``Scan`` body creates (global parameters, read by the
``scan`` op as ``Static`` inputs), the CRF's transitions are ``crfw`` (its
``ParamAttr`` name, which ``crf_decoding`` reads too), the recommender's
title convolution is ``sequence_conv_N.w_0`` ([filter_size * D, F]) and
``sequence_conv_N.b_0``, and VGG-16's state is ``conv2d_N.w_0`` /
``conv2d_N.b_0``, ``batch_norm_N.w_0`` / ``.b_0`` (scale, shift) and
``batch_norm_N.global_0`` / ``.global_1`` (the running mean and variance),
with the fc layers and Adam's accumulators as above. A program trained
under a learning-rate schedule also holds the step counter
``@LR_DECAY_COUNTER@`` (``layers/learning_rate_scheduler.py``), int32 in
the JAX package (x64 off) and int64 in the port: it carries by name, and
the port's ``increment`` and ``cast`` run on either width
(``io.load_persistables`` widens a saved int32 counter to the program's
int64). The other optimizers' state carries the same way, named by
``unique_name`` as in the JAX package: ``{param}_moment_0`` (Adagrad,
DecayedAdagrad, Adamax), ``_inf_norm_0`` (Adamax, whose
``_beta1_pow_acc_0`` a ``scale`` advances), ``_avg_squared_grad_0`` /
``_avg_squared_update_0`` (Adadelta), ``_mean_square_0``, ``_momentum_0``
and ``_mean_grad_0`` (RMSProp), ``_squared_0`` / ``_linear_0`` (Ftrl),
``_velocity_0`` (LarsMomentum), Adam's four (AdamW, Lamb), and the
wrappers' ``ema_decay_pow_N`` with ``{param}_ema_N``, ``ma_count_N`` with
``{param}_ma_sum_N``, and ``la_step_N`` with ``{param}_slow_N`` /
``{param}_slow_init_N``. The vision layers' parameters carry by their
``unique_name`` names too: ``group_norm_N.w_0`` / ``.b_0`` and
``instance_norm_N.w_0`` / ``.b_0`` (scale, shift), ``prelu_N.w_0`` (the
alphas: [1], [C] or [C H W] by mode); so do a pruned program's masks,
``{param}@prune_mask`` (float32, persistable and not trainable, in both
packages; ``contrib/slim.py``), and a ``While`` body's parameters (global
parameters that the ``while`` op reads as inputs).

A dygraph model (``dygraph.Layer``) carries through its ``state_dict()``:
the JAX layer's numpy arrays go into the port's layer with ``set_dict``,
which copies each onto its parameter's device in its dtype. The keys are the
structured parameter names (``<sublayer attribute>.`` prefixes over the
``unique_name``-generated ``<layer>_<i>.w_0`` / ``.b_0``), so both models
are built under ``unique_name.guard()`` from the same class structure; a
dygraph ``.npz`` checkpoint (``save_dygraph``) carries the same keys.
``chip_smoke.py``'s phase 29 loads the static ``models.bert.encoder``
program's startup weights into the dygraph encoder of
``tools/dygraph_bert.py`` by ``dygraph_bert.static_names``: ``word_emb``,
``pos_emb``, ``sent_emb``; the embedding's layer norm
``layer_norm_0.w_0`` / ``.b_0``; in layer ``i`` ``layer{i}_attn_qkv_w`` /
``_b``, ``layer{i}_attn_out_w`` / ``_b``, ``layer_norm_{2i+1}``,
``layer{i}_ffn1_w`` / ``_b``, ``layer{i}_ffn2_w`` / ``_b`` and
``layer_norm_{2i+2}``, each onto the dygraph parameter that plays its part.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .core.executor import Scope, resolve_device, tensor_from_numpy  # noqa: F401


def state_from_numpy(arrays: Dict[str, np.ndarray], device=None,
                     dtype_tags: Dict[str, str] = None) -> Dict[str, torch.Tensor]:
    """name -> numpy array  =>  name -> tensor on ``device`` (None: the card).
    ``dtype_tags`` names the uint16 arrays that hold bfloat16 bits. Integer
    widths are kept: int32 stays int32, int64 stays int64.

    Both packages build a model under ``unique_name.guard()`` with the same
    names, so a JAX startup state (and its optimizer state) carries across
    by name. For CRNN-CTC (``tools/ocr.py``): ``conv2d_<i>.w_0`` / ``.b_0``,
    ``batch_norm_<i>.w_0`` / ``.b_0`` with the moving statistics
    ``batch_norm_<i>.global_0`` / ``.global_1``, the encoder's and the
    GRU cells' ``fc_<i>.w_0`` / ``.b_0`` (the output layer over both GRUs
    has ``.w_0`` and ``.w_1``), Momentum's ``<param>_velocity_0`` and
    ``learning_rate_<i>``."""
    dev = resolve_device(device)
    tags = dtype_tags or {}
    return {n: tensor_from_numpy(a, tags.get(n)).to(dev) for n, a in arrays.items()}


def load_state(scope: Scope, state: Dict[str, torch.Tensor]) -> None:
    """Put ``state`` (name -> tensor) into a port Scope."""
    for n, t in state.items():
        scope.set_var(n, t)
