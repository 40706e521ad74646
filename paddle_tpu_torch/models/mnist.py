"""MNIST models: the port's copy of ``paddle_tpu/models/mnist.py``."""
from __future__ import annotations

from .. import layers


def mlp(img, label, hidden=(128, 64), num_classes=10):
    h = img
    for size in hidden:
        h = layers.fc(h, size, act="relu")
    logits = layers.fc(h, num_classes)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(logits, label)
    return loss, acc, logits


def conv_net(img, label, num_classes=10):
    """The conv-pool MNIST net: two 5x5 convolutions with relu, each followed
    by a 2x2 max pool, then an fc to the classes."""
    h = layers.conv2d(img, 20, 5, act="relu")
    h = layers.pool2d(h, 2, "max", 2)
    h = layers.conv2d(h, 50, 5, act="relu")
    h = layers.pool2d(h, 2, "max", 2)
    logits = layers.fc(h, num_classes)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(logits, label)
    return loss, acc, logits
