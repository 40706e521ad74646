"""ResNet for ImageNet, built with the port's DSL (the port's copy of
``paddle_tpu/models/resnet.py``): the same layers, op types, attrs and
parameter names, so a Program and its weights carry across either way.

Build with ``data_format='NHWC'`` and ``dtype='bfloat16'`` for the card's
path (batch-norm statistics stay f32 inside the op). Marking the batch norms
``fuse_stats=True`` and running ``contrib.fuse_conv_bn_stats`` before
``minimize`` puts every 1x1/s1 conv + batch norm (+ relu) chain on the CUDA
1x1-conv + statistics kernel (``ops/conv_bn.py``).
"""
from __future__ import annotations

from .. import layers
from ..layer_helper import ParamAttr


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1, act=None,
                  name=None, is_test=False, data_format="NCHW"):
    conv = layers.conv2d(input, num_filters, filter_size, stride=stride,
                         padding=(filter_size - 1) // 2, groups=groups,
                         bias_attr=False,
                         param_attr=ParamAttr(name=name + "_w" if name else None),
                         data_format=data_format)
    return layers.batch_norm(conv, act=act, is_test=is_test,
                             data_layout=data_format)


def shortcut(input, ch_out, stride, name=None, is_test=False,
             data_format="NCHW"):
    ch_in = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, name=name,
                             is_test=is_test, data_format=data_format)
    return input


def bottleneck_block(input, num_filters, stride, name=None, is_test=False,
                     data_format="NCHW"):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu",
                          name=name and name + "_c0", is_test=is_test,
                          data_format=data_format)
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride, act="relu",
                          name=name and name + "_c1", is_test=is_test,
                          data_format=data_format)
    conv2 = conv_bn_layer(conv1, num_filters * 4, 1,
                          name=name and name + "_c2", is_test=is_test,
                          data_format=data_format)
    short = shortcut(input, num_filters * 4, stride,
                     name=name and name + "_sc", is_test=is_test,
                     data_format=data_format)
    return layers.relu(layers.elementwise_add(short, conv2))


_DEPTHS = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}


def _space_to_depth2(img, data_format):
    """2x2 space-to-depth, channels-last: a reshape/transpose/reshape. (The
    NCHW form is the ``space_to_depth`` op, which the port does not have.)"""
    if data_format == "NCHW":
        raise NotImplementedError(
            "conv1_space_to_depth with data_format='NCHW' needs the space_to_depth "
            "op, which is not ported yet; use data_format='NHWC'")
    n, h, w, c = img.shape
    x = layers.reshape(img, [-1, h // 2, 2, w // 2, 2, c])
    x = layers.transpose(x, [0, 1, 3, 2, 4, 5])
    return layers.reshape(x, [-1, h // 2, w // 2, 4 * c])


def resnet(img, label, depth=50, num_classes=1000, is_test=False,
           data_format="NCHW", conv1_space_to_depth=False):
    """Returns (loss, acc, logits) — logits only if label is None.
    img: [N,3,H,W] (NCHW) or [N,H,W,3] (NHWC), label: [N,1] int64. is_test
    freezes batch-norm to the moving averages (the inference graph).

    conv1_space_to_depth: the stem as a 2x2 space-to-depth followed by a
    4x4/s1 conv over 12 channels (padding 2 before, 1 after) in place of the
    7x7/s2 conv over 3: the same receptive field and output shape. The stem
    weight becomes [64, 12, 4, 4] (not checkpoint-compatible with the 7x7
    stem)."""
    stages = _DEPTHS[depth]
    filters = [64, 128, 256, 512]
    if conv1_space_to_depth:
        h = _space_to_depth2(img, data_format)
        # offsets k in {-2..1} of the factored kernel -> pad (2 before, 1
        # after) each spatial dim; output stays H/2 x W/2.
        h = layers.conv2d(h, 64, 4, stride=1, padding=[2, 1, 2, 1],
                          bias_attr=False,
                          param_attr=ParamAttr(name="conv1_w"),
                          data_format=data_format)
        h = layers.batch_norm(h, act="relu", is_test=is_test,
                              data_layout=data_format)
    else:
        h = conv_bn_layer(img, 64, 7, stride=2, act="relu", name="conv1",
                          is_test=is_test, data_format=data_format)
    h = layers.pool2d(h, 3, "max", 2, pool_padding=1, data_format=data_format)
    for stage, (n_blocks, nf) in enumerate(zip(stages, filters)):
        for i in range(n_blocks):
            stride = 2 if i == 0 and stage > 0 else 1
            h = bottleneck_block(h, nf, stride, name=f"res{stage}_{i}",
                                 is_test=is_test, data_format=data_format)
    h = layers.pool2d(h, pool_type="avg", global_pooling=True,
                      data_format=data_format)
    logits = layers.fc(h, num_classes)
    if label is None:
        return logits
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(logits, label)
    return loss, acc, logits


def resnet50(img, label, num_classes=1000, is_test=False, data_format="NCHW",
             conv1_space_to_depth=False):
    return resnet(img, label, 50, num_classes, is_test=is_test,
                  data_format=data_format,
                  conv1_space_to_depth=conv1_space_to_depth)
