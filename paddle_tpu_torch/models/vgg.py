"""VGG-16: the port's copy of ``paddle_tpu/models/vgg.py`` (reference: the
fp16 benchmark workload, paddle/contrib/float16/float16_benchmark.md:21-33,
and the book image-classification VGG,
python/paddle/fluid/tests/book/test_image_classification.py img_conv_group).

The reference's only *published* performance numbers are VGG16/ResNet50
inference latencies on V100 (BASELINE.md); ``chip_smoke.py`` serves this
model at their ImageNet shape (bench_inference.py's). Plain VGG-16 (conv3
stacks + 2x4096 FC), 13 3x3 convolutions (cuDNN through the ``conv2d``
lowering) and 5 max pools; batch_norm optional as in the book variant.
"""
from __future__ import annotations

from .. import layers


_CFG16 = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]


def vgg16(img, label=None, num_classes=1000, use_bn=False, dropout=0.5,
          is_test=False):
    """img: [N,3,H,W]; label: [N,1] int64 or None (inference).

    Returns (loss, acc, logits) when label is given, else logits.
    """
    h = img
    for n_convs, nf in _CFG16:
        for _ in range(n_convs):
            h = layers.conv2d(h, nf, 3, padding=1,
                              act=None if use_bn else "relu")
            if use_bn:
                h = layers.batch_norm(h, act="relu", is_test=is_test)
        h = layers.pool2d(h, 2, "max", 2)
    h = layers.reshape(h, [0, -1])
    for _ in range(2):
        h = layers.fc(h, 4096, act="relu")
        if dropout and not is_test:
            h = layers.dropout(h, dropout)
    logits = layers.fc(h, num_classes)
    if label is None:
        return logits
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(logits, label)
    return loss, acc, logits
