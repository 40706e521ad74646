"""The CRNN-CTC text recogniser of PaddlePaddle's model zoo
(``PaddlePaddle/models``, ``fluid/PaddleCV/ocr_recognition/crnn_ctc_model.py``:
``ocr_convs``, ``encoder_net``, ``ctc_train_net``, ``ctc_infer``; ``DATA_SHAPE``
and ``num_classes()`` from ``data_reader.py``) as programs, built from public
layers only, and its seeded feeds.

``build_crnn_ctc(pkg, cfg, train=True)`` builds the training program (the
summed CTC loss under Momentum, lr 1e-3, momentum 0.9, an ``L2Decay(4e-4)``
regulariser on every parameter through its ``ParamAttr``, as
``ctc_train_net`` sets them) or, with ``train=False``, the decode program
(batch norms in test mode, ``ctc_greedy_decoder`` and ``edit_distance``
against the labels), with the DSL of ``pkg``: the port, or a package with the
same surface (the tests pass the JAX package). Both programs name their
variables under ``unique_name.guard()`` and set ``random_seed``, so weights
carry across by name. Returns ``Crnn``.

The path: four groups of two 3x3 conv (padding 1) + batch norm + ReLU
(filters 16/16, 32/32, 64/64, 128/128), a 2x2 max pool after each of the
first three; ``im2sequence`` with a [H', 1] filter (one step a column); two
``fc`` of 3 x hidden; ``dynamic_gru`` forward and reverse; ``fc`` of both to
classes + 1 (the blank is the last class). The source passes
``candidate_activation='relu'`` to ``dynamic_gru``; both packages' GRU
applies tanh (ROADMAP 3.28). The source pools with ``ceil_mode=True``, which
neither package's ``pool2d`` takes: at [1, 48, 512] every pooled size is
even, so floor and ceil agree. LoD becomes padded labels plus lengths: every
image gives T = W / 8 steps, and the label lengths are drawn from the seed.
No OCR data is in the repository: the images and labels are made from the
seed (``crnn_feed``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

L2_RATE, LR, MOMENTUM = 0.0004, 1.0e-3, 0.9


class CrnnConfig(NamedTuple):
    image: Tuple[int, int, int] = (1, 48, 512)      # data_reader.DATA_SHAPE
    num_classes: int = 95                           # data_reader.num_classes()
    groups: Tuple[Tuple[int, int], ...] = ((16, 16), (32, 32), (64, 64), (128, 128))
    hidden: int = 200                               # encoder_net's rnn_hidden_size
    max_label: int = 24                             # the padded label length
    label_lengths: Tuple[int, int] = (4, 20)        # drawn in [lo, hi]

    @property
    def blank(self) -> int:
        return self.num_classes

    @property
    def steps(self) -> int:
        """T: the map's width after a 2x2 pool for every group but the last."""
        return self.image[2] >> (len(self.groups) - 1)

    @property
    def feature_height(self) -> int:
        return self.image[1] >> (len(self.groups) - 1)


#: the source's configuration
CRNN = CrnnConfig()
#: the CPU tests' cut: [1, 16, 64] images, two conv groups, hidden 16, 11 classes
SMALL = CrnnConfig(image=(1, 16, 64), num_classes=11, groups=((4, 4), (8, 8)), hidden=16,
                   max_label=6, label_lengths=(1, 5))


class Crnn(NamedTuple):
    main: object
    startup: object
    feeds: Tuple[str, ...]
    loss: Optional[object] = None        # the summed CTC loss (train)
    logits: Optional[object] = None      # [B, T, classes + 1]
    decoded: Optional[object] = None     # [B, T] int32 (decode)
    decoded_length: Optional[object] = None
    distance: Optional[object] = None    # edit_distance, [B, 1]
    sequence_num: Optional[object] = None


def _attrs(pkg, regularizer):
    """encoder_net's and ocr_convs' ParamAttrs (a fresh one per call, as the
    source's unnamed attrs give each parameter its own name)."""
    def attr(std, lr=1.0):
        return pkg.ParamAttr(regularizer=regularizer, learning_rate=lr,
                             initializer=pkg.initializer.Normal(0.0, std))
    return attr


def _conv_bn_pool(pkg, x, channels, attr, first, is_test, pool):
    L = pkg.layers
    for ch in channels:
        x = L.conv2d(x, num_filters=ch, filter_size=3, padding=1,
                     param_attr=attr(0.0005 if first else 0.01))
        x = L.batch_norm(x, act="relu", param_attr=attr(0.01), bias_attr=attr(0.0),
                         is_test=is_test)
    if pool:
        x = L.pool2d(x, pool_size=2, pool_type="max", pool_stride=2, ceil_mode=True)
    return x


def encoder_net(pkg, images, cfg: CrnnConfig, regularizer, is_test):
    """ocr_convs + encoder_net: the logits [B, T, classes + 1]."""
    L = pkg.layers
    attr = _attrs(pkg, regularizer)
    x = images
    for g, channels in enumerate(cfg.groups):
        x = _conv_bn_pool(pkg, x, channels, attr, g == 0, is_test, g < len(cfg.groups) - 1)
    seq = L.im2sequence(x, filter_size=[cfg.feature_height, 1], stride=[1, 1])
    h3 = cfg.hidden * 3
    fc_1 = L.fc(seq, h3, num_flatten_dims=2, param_attr=attr(0.02), bias_attr=attr(0.02))
    fc_2 = L.fc(seq, h3, num_flatten_dims=2, param_attr=attr(0.02), bias_attr=attr(0.02))
    fwd = L.dynamic_gru(fc_1, cfg.hidden, param_attr=attr(0.02), bias_attr=attr(0.02, 2.0),
                        candidate_activation="relu")
    bwd = L.dynamic_gru(fc_2, cfg.hidden, is_reverse=True, param_attr=attr(0.02),
                        bias_attr=attr(0.02, 2.0), candidate_activation="relu")
    return L.fc([fwd, bwd], cfg.num_classes + 1, num_flatten_dims=2,
                param_attr=attr(0.02), bias_attr=attr(0.0))


def build_crnn_ctc(pkg, cfg: CrnnConfig = CRNN, train: bool = True, seed: int = 0) -> Crnn:
    """The training (``train``) or decode program of CRNN-CTC in ``pkg``.
    Feeds: ``pixel`` [B, C, H, W] float32, ``label`` [B, max_label] int64
    (padded), ``label_length`` [B] int64 and ``logits_length`` [B] int64
    (T for every row); the decode program's ``edit_distance`` reads the
    labels too."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    A = dict(append_batch_size=False)
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        L = pkg.layers
        images = pkg.data("pixel", [-1] + list(cfg.image), "float32", **A)
        label = pkg.data("label", [-1, cfg.max_label], "int64", **A)
        label_length = pkg.data("label_length", [-1], "int64", **A)
        logits_length = pkg.data("logits_length", [-1], "int64", **A)
        feeds = ("pixel", "label", "label_length", "logits_length")
        regularizer = pkg.regularizer.L2Decay(L2_RATE) if train else None
        logits = encoder_net(pkg, images, cfg, regularizer, is_test=not train)
        if train:
            cost = L.warpctc(logits, label, blank=cfg.blank, norm_by_times=True,
                             input_length=logits_length, label_length=label_length)
            loss = L.reduce_sum(cost)
            pkg.optimizer.Momentum(learning_rate=LR, momentum=MOMENTUM).minimize(loss)
            return Crnn(main, startup, feeds, loss=loss, logits=logits)
        decoded, decoded_length = L.ctc_greedy_decoder(logits, cfg.blank,
                                                       input_length=logits_length)
        distance, seq_num = L.edit_distance(decoded, label,
                                            input_length=decoded_length,
                                            label_length=label_length)
    return Crnn(main, startup, feeds, logits=logits, decoded=decoded,
                decoded_length=decoded_length, distance=distance, sequence_num=seq_num)


def crnn_feed(cfg: CrnnConfig, batch: int, seed: int = 0) -> dict:
    """A seeded batch: images uniform in [0, 1) (grey levels), labels drawn
    uniformly from the classes with lengths uniform in ``label_lengths``,
    zero-padded to ``max_label``; ``logits_length`` T for every row."""
    rng = np.random.RandomState(seed)
    lo, hi = cfg.label_lengths
    lengths = rng.randint(lo, hi + 1, batch).astype("int64")
    label = rng.randint(0, cfg.num_classes, (batch, cfg.max_label)).astype("int64")
    label[np.arange(cfg.max_label)[None, :] >= lengths[:, None]] = 0
    return {"pixel": rng.rand(batch, *cfg.image).astype("float32"), "label": label,
            "label_length": lengths,
            "logits_length": np.full(batch, cfg.steps, "int64")}


def levenshtein(a, b) -> int:
    """The edit distance of two id sequences (the numpy oracle)."""
    d = np.arange(len(b) + 1)
    for i, x in enumerate(a, 1):
        prev, d[0] = d[0], i
        for j, y in enumerate(b, 1):
            prev, d[j] = d[j], min(d[j] + 1, d[j - 1] + 1, prev + (x != y))
    return int(d[-1])


def random_state(state: dict, seed: int = 0) -> dict:
    """A state of the decode program's parameters, drawn from the seed, at
    the scales of a trained net (the source's initialisers keep an untrained
    net's features near zero, so its logits are near uniform and every row
    decodes alike): conv and fc weights N(0, 2 / fan_in), batch-norm scales
    1 + N(0, 0.1), shifts and biases N(0, 0.1), moving means 0 and moving
    variances 1. Keys and shapes are ``state``'s."""
    rng = np.random.RandomState(seed)
    out = {}
    for n, v in sorted(state.items()):
        v = np.asarray(v)
        if v.dtype.kind != "f":
            out[n] = v
        elif n.endswith(".global_0"):
            out[n] = np.zeros_like(v)
        elif n.endswith(".global_1"):
            out[n] = np.ones_like(v)
        elif v.ndim >= 2:
            fan_in = int(np.prod(v.shape[1:])) if v.ndim == 4 else v.shape[0]
            out[n] = (rng.randn(*v.shape) * np.sqrt(2.0 / fan_in)).astype(v.dtype)
        elif n.startswith("batch_norm") and n.endswith(".w_0"):
            out[n] = (1.0 + 0.1 * rng.randn(*v.shape)).astype(v.dtype)
        else:
            out[n] = (0.1 * rng.randn(*v.shape)).astype(v.dtype)
    return out
