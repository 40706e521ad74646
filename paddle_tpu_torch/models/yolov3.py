"""YOLOv3 object detection, the port's copy of ``paddle_tpu/models/yolov3.py``:
the same layers, op types, attrs and parameter names, so weights carry
across by name (``convert.py``). Reference: the PaddleCV yolov3 config that
`yolov3_loss` / `yolo_box` exist to serve — python/paddle/fluid/layers/
detection.py:yolov3_loss, yolo_box; operators/detection/yolov3_loss_op.cc,
yolo_box_op.cc).

DarkNet-53 backbone + 3-scale YOLO heads, built from the public layers DSL
exactly as a fluid user would. ``scale=1.0`` is the paper model; smaller
scales shrink channels/blocks for CPU tests. Training returns the summed
3-head loss; inference decodes with yolo_box and fuses scales through
multiclass_nms (fixed-shape forms — see ops/detection_ops.py).
"""
from __future__ import annotations

from .. import layers
from ..layer_helper import ParamAttr

ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119,
           116, 90, 156, 198, 373, 326]
ANCHOR_MASKS = [[6, 7, 8], [3, 4, 5], [0, 1, 2]]


def _conv_bn(x, ch, k, stride=1, name=None, is_test=False):
    x = layers.conv2d(x, ch, k, stride=stride, padding=(k - 1) // 2,
                      bias_attr=False,
                      param_attr=ParamAttr(name=name and name + ".w"))
    x = layers.batch_norm(x, is_test=is_test)
    return layers.leaky_relu(x, alpha=0.1)


def _basic_block(x, out_ch, name=None, is_test=False):
    """Residual block: 1x1 squeeze to out_ch//2, 3x3 back to out_ch (the
    residual add always matches, for any channel-scaled config)."""
    h = _conv_bn(x, max(8, out_ch // 2), 1, name=name and name + ".0",
                 is_test=is_test)
    h = _conv_bn(h, out_ch, 3, name=name and name + ".1", is_test=is_test)
    return layers.elementwise_add(x, h)


def darknet53(img, scale=1.0, stage_blocks=(1, 2, 8, 8, 4), is_test=False):
    """Returns feature maps of the last three stages (stride 8/16/32)."""
    c = lambda ch: max(8, int(ch * scale))
    h = _conv_bn(img, c(32), 3, name="dn.stem", is_test=is_test)
    feats = []
    ch = 32
    for si, n_blocks in enumerate(stage_blocks):
        ch *= 2
        h = _conv_bn(h, c(ch), 3, stride=2, name=f"dn.down{si}",
                     is_test=is_test)
        for bi in range(n_blocks):
            h = _basic_block(h, c(ch), name=f"dn.s{si}b{bi}", is_test=is_test)
        feats.append(h)
    return feats[-3:]  # C3, C4, C5


def _detection_block(x, ch, name=None, is_test=False):
    """5-conv block; returns (route, tip)."""
    for i in range(2):
        x = _conv_bn(x, ch, 1, name=name and f"{name}.r{i}a", is_test=is_test)
        x = _conv_bn(x, ch * 2, 3, name=name and f"{name}.r{i}b",
                     is_test=is_test)
    route = _conv_bn(x, ch, 1, name=name and name + ".route", is_test=is_test)
    tip = _conv_bn(route, ch * 2, 3, name=name and name + ".tip",
                   is_test=is_test)
    return route, tip


def _heads(img, num_classes, scale=1.0, stage_blocks=(1, 2, 8, 8, 4),
           is_test=False):
    """Shared backbone+FPN; returns per-scale raw head outputs, coarse first."""
    c3, c4, c5 = darknet53(img, scale, stage_blocks, is_test=is_test)
    c = lambda ch: max(8, int(ch * scale))
    outs, route = [], None
    for i, feat in enumerate((c5, c4, c3)):
        if route is not None:
            # lateral ch = 256//2**(i-1): route carries det-block i-1's
            # c(512>>(i-1)) channels, halved before the upsample (PaddleCV
            # yolov3 parity)
            route = _conv_bn(route, c(512 >> i), 1, name=f"yolo.lat{i}",
                             is_test=is_test)
            route = layers.resize_nearest(route, scale=2)
            feat = layers.concat([route, feat], axis=1)
        route, tip = _detection_block(feat, c(512 >> i), name=f"yolo.det{i}",
                                      is_test=is_test)
        n_anchors = len(ANCHOR_MASKS[i])
        head = layers.conv2d(tip, n_anchors * (5 + num_classes), 1,
                             param_attr=ParamAttr(name=f"yolo.head{i}.w"))
        outs.append(head)
    return outs


def yolov3(img, gt_box, gt_label, num_classes=80, gt_score=None, scale=1.0,
           stage_blocks=(1, 2, 8, 8, 4), ignore_thresh=0.7,
           use_label_smooth=False):
    """Training graph. img [N,3,H,W] (H,W multiples of 32); gt_box [N,B,4]
    normalized cxcywh; gt_label [N,B] int32. Returns the summed loss."""
    outs = _heads(img, num_classes, scale, stage_blocks)
    losses = []
    for i, head in enumerate(outs):
        losses.append(layers.yolov3_loss(
            head, gt_box, gt_label, ANCHORS, ANCHOR_MASKS[i], num_classes,
            ignore_thresh, downsample_ratio=32 >> i, gt_score=gt_score,
            use_label_smooth=use_label_smooth))
    total = losses[0]
    for l in losses[1:]:
        total = layers.elementwise_add(total, l)
    return layers.mean(total)


def yolov3_infer(img, img_size, num_classes=80, scale=1.0,
                 stage_blocks=(1, 2, 8, 8, 4), conf_thresh=0.01,
                 nms_top_k=400, keep_top_k=100, nms_thresh=0.45):
    """Inference graph. img_size [N,2] int32 (h, w of the original images).
    Returns NMS'd detections [N, keep_top_k, 6] (label, score, x1,y1,x2,y2)."""
    outs = _heads(img, num_classes, scale, stage_blocks, is_test=True)
    boxes, scores = [], []
    for i, head in enumerate(outs):
        b, s = layers.yolo_box(head, img_size,
                               [ANCHORS[m * 2 + d] for m in ANCHOR_MASKS[i]
                                for d in range(2)],
                               num_classes, conf_thresh,
                               downsample_ratio=32 >> i)
        boxes.append(b)
        scores.append(layers.transpose(s, [0, 2, 1]))
    all_boxes = layers.concat(boxes, axis=1)
    all_scores = layers.concat(scores, axis=2)
    # background_label=-1: YOLO classes are all real (class 0 = e.g. COCO
    # person); the default 0 would silently suppress them
    return layers.multiclass_nms(all_boxes, all_scores, conf_thresh,
                                 nms_top_k, keep_top_k, nms_thresh,
                                 background_label=-1)
