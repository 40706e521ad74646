"""Faster R-CNN two-stage detector, the port's copy of
``paddle_tpu/models/faster_rcnn.py`` (same layers and parameter names;
reference: the model the detection op suite exists to serve — operators/detection/generate_proposals_op.cc,
generate_proposal_labels_op.cc, rpn_target_assign_op.cc, roi_align_op.cc;
layer surface python/paddle/fluid/layers/detection.py).

C4-style architecture from the public layers DSL: ResNet-ish backbone to a
stride-16 feature map, RPN head, proposals, second-stage target assignment
(fixed-shape weighting form), RoIAlign, box head. ``scale``/``stage_blocks``
shrink the model for CPU tests. The RPN target step is per-image (the op's
contract), so the training graph unrolls over the static batch dim.
"""
from __future__ import annotations

import numpy as np

from .. import layers
from ..layer_helper import ParamAttr
from .resnet import conv_bn_layer, bottleneck_block


def _backbone(img, scale=1.0, stage_blocks=(2, 2, 2), is_test=False):
    """Stride-16 C4 feature map; channel count = c(256*2^last)."""
    c = lambda ch: max(16, int(ch * scale))
    h = conv_bn_layer(img, c(64), 7, stride=2, act="relu", name="bb_stem",
                      is_test=is_test)
    h = layers.pool2d(h, 3, "max", 2, pool_padding=1)
    filters = [64, 128, 256]
    for stage, n_blocks in enumerate(stage_blocks):
        for i in range(n_blocks):
            stride = 2 if i == 0 and stage > 0 else 1
            h = bottleneck_block(h, c(filters[stage]), stride,
                                 name=f"bb_s{stage}_{i}", is_test=is_test)
    return h


def _rpn_head(feat, n_anchors, scale=1.0):
    c = max(16, int(256 * scale))
    rpn = layers.conv2d(feat, c, 3, padding=1, act="relu",
                        param_attr=ParamAttr(name="rpn_conv_w"))
    cls_logits = layers.conv2d(rpn, n_anchors, 1,
                               param_attr=ParamAttr(name="rpn_cls_w"))
    bbox_pred = layers.conv2d(rpn, 4 * n_anchors, 1,
                              param_attr=ParamAttr(name="rpn_bbox_w"))
    return cls_logits, bbox_pred


def _box_head(feat5d, num_classes, scale=1.0):
    """feat5d: [roi, C, ph, pw] RoIAligned features -> (cls_score, bbox_pred)."""
    c = max(32, int(1024 * scale))
    h = layers.reshape(feat5d, [0, -1])
    h = layers.fc(h, c, act="relu", param_attr=ParamAttr(name="head_fc1_w"))
    h = layers.fc(h, c, act="relu", param_attr=ParamAttr(name="head_fc2_w"))
    cls_score = layers.fc(h, num_classes,
                          param_attr=ParamAttr(name="head_cls_w"))
    bbox_pred = layers.fc(h, 4 * num_classes,
                          param_attr=ParamAttr(name="head_bbox_w"))
    return cls_score, bbox_pred


def _anchors(feat, anchor_sizes, aspect_ratios):
    # variance = 1: rpn_target_assign trains RAW deltas, and
    # generate_proposals decodes d * variance — the standard RPN setting.
    # The default (0.1, 0.1, 0.2, 0.2) would shrink decoded proposals 10x.
    anchors, variances = layers.anchor_generator(
        feat, anchor_sizes=list(anchor_sizes),
        aspect_ratios=list(aspect_ratios), stride=[16.0, 16.0],
        variance=(1.0, 1.0, 1.0, 1.0))
    return anchors, variances


def faster_rcnn(img, gt_box, gt_label, im_info, batch_size, num_classes=81,
                is_crowd=None, scale=1.0, stage_blocks=(2, 2, 2),
                anchor_sizes=(32, 64, 128, 256), aspect_ratios=(0.5, 1.0, 2.0),
                post_nms_top_n=64, roi_resolution=7):
    """Training graph. img [N,3,H,W] (H,W multiples of 16); gt_box [N,G,4]
    pixel xyxy (padded rows zero); gt_label [N,G] int32 (1..C-1);
    im_info [N,3]. Returns (total_loss, rpn_loss, head_loss)."""
    feat = _backbone(img, scale, stage_blocks)
    n_anchors = len(anchor_sizes) * len(aspect_ratios)
    cls_logits, bbox_pred = _rpn_head(feat, n_anchors, scale)
    anchors, variances = _anchors(feat, anchor_sizes, aspect_ratios)
    flat_anchors = layers.reshape(anchors, [-1, 4])
    flat_var = layers.reshape(variances, [-1, 4])

    # ---- RPN losses (per-image op contract: unroll the static batch) ----
    # [N, A, H, W] -> [N, H*W*A] score / [N, H*W*A, 4] deltas, matching the
    # anchor_generator's [H, W, A, 4] row order
    sc_hwA = layers.transpose(cls_logits, [0, 2, 3, 1])
    dl_hwA = layers.transpose(
        layers.reshape(bbox_pred, [0, n_anchors, 4, -1, img.shape[3] // 16]),
        [0, 3, 4, 1, 2])
    rpn_cls_losses, rpn_reg_losses = [], []
    for i in range(batch_size):
        sc_i = layers.reshape(layers.slice(sc_hwA, [0], [i], [i + 1]),
                              [-1, 1])
        dl_i = layers.reshape(layers.slice(dl_hwA, [0], [i], [i + 1]),
                              [-1, 4])
        gt_i = layers.reshape(layers.slice(gt_box, [0], [i], [i + 1]),
                              [-1, 4])
        crowd_i = None
        if is_crowd is not None:
            crowd_i = layers.reshape(layers.slice(is_crowd, [0], [i], [i + 1]),
                                     [-1])
        im_i = layers.slice(im_info, [0], [i], [i + 1])
        sp, lp, st, lt, iw = layers.rpn_target_assign(
            dl_i, sc_i, flat_anchors, flat_var, gt_i, is_crowd=crowd_i,
            im_info=im_i)
        rpn_cls_losses.append(layers.mean(
            layers.sigmoid_cross_entropy_with_logits(sp, st)))
        rpn_reg_losses.append(layers.mean(
            layers.smooth_l1(lp, lt, inside_weight=iw, sigma=3.0)))
    rpn_loss = layers.scale(layers.sum(rpn_cls_losses), 1.0 / batch_size)
    rpn_loss = layers.elementwise_add(
        rpn_loss, layers.scale(layers.sum(rpn_reg_losses), 1.0 / batch_size))

    # ---- proposals + second-stage targets --------------------------------
    rpn_probs = layers.sigmoid(cls_logits)
    rois, roi_probs, rois_num = layers.generate_proposals(
        rpn_probs, bbox_pred, im_info, anchors, variances,
        pre_nms_top_n=256, post_nms_top_n=post_nms_top_n, nms_thresh=0.7,
        min_size=4.0)
    (s_rois, s_labels, s_tgt, s_inw, s_outw,
     s_clsw, _matched) = layers.generate_proposal_labels(
        rois, gt_label, is_crowd, gt_box, im_info, class_nums=num_classes,
        fg_thresh=0.5, rpn_rois_num=rois_num)

    # ---- RoIAlign + head -------------------------------------------------
    Rp = s_rois.shape[1]
    flat_rois = layers.reshape(s_rois, [-1, 4])
    # fixed shapes: every image contributes exactly Rp rois
    counts = layers.assign(np.full((batch_size,), Rp, np.int32))
    roi_feat = layers.roi_align(feat, flat_rois,
                                pooled_height=roi_resolution,
                                pooled_width=roi_resolution,
                                spatial_scale=1.0 / 16.0, rois_num=counts)
    cls_score, head_bbox = _box_head(roi_feat, num_classes, scale)

    # cls: ignore rows weight 0, fg/bg weighted to sampled proportions
    flat_labels = layers.reshape(s_labels, [-1, 1])
    flat_clsw = layers.reshape(s_clsw, [-1, 1])
    safe_labels = layers.cast(
        layers.elementwise_max(flat_labels,
                               layers.fill_constant([1], "int32", 0)),
        "int64")
    ce = layers.softmax_with_cross_entropy(cls_score, safe_labels)
    cls_loss = layers.mean(layers.elementwise_mul(ce, flat_clsw))
    # bbox: smooth_l1 over the matched-class slice, fg rows only
    reg_loss = layers.mean(layers.smooth_l1(
        head_bbox, layers.reshape(s_tgt, [-1, 4 * num_classes]),
        inside_weight=layers.reshape(s_inw, [-1, 4 * num_classes]),
        outside_weight=layers.reshape(s_outw, [-1, 4 * num_classes]),
        sigma=1.0))
    head_loss = layers.elementwise_add(cls_loss, reg_loss)
    total = layers.elementwise_add(rpn_loss, head_loss)
    return total, rpn_loss, head_loss


def faster_rcnn_infer(img, im_info, batch_size, num_classes=81, scale=1.0,
                      stage_blocks=(2, 2, 2), anchor_sizes=(32, 64, 128, 256),
                      aspect_ratios=(0.5, 1.0, 2.0), post_nms_top_n=64,
                      roi_resolution=7, score_thresh=0.05, nms_thresh=0.5,
                      keep_top_k=100):
    """Inference graph: proposals -> RoIAlign -> head -> decode -> NMS.
    Returns (dets [N, keep_top_k, 6], counts [N])."""
    feat = _backbone(img, scale, stage_blocks, is_test=True)
    n_anchors = len(anchor_sizes) * len(aspect_ratios)
    cls_logits, bbox_pred = _rpn_head(feat, n_anchors, scale)
    anchors, variances = _anchors(feat, anchor_sizes, aspect_ratios)
    rpn_probs = layers.sigmoid(cls_logits)
    rois, roi_probs, rois_num = layers.generate_proposals(
        rpn_probs, bbox_pred, im_info, anchors, variances,
        pre_nms_top_n=256, post_nms_top_n=post_nms_top_n, nms_thresh=0.7,
        min_size=4.0)
    Rp = rois.shape[1]
    flat_rois = layers.reshape(rois, [-1, 4])
    counts = layers.assign(np.full((batch_size,), Rp, np.int32))
    roi_feat = layers.roi_align(feat, flat_rois,
                                pooled_height=roi_resolution,
                                pooled_width=roi_resolution,
                                spatial_scale=1.0 / 16.0, rois_num=counts)
    cls_score, head_bbox = _box_head(roi_feat, num_classes, scale)
    probs = layers.softmax(cls_score)                      # [N*Rp, C]
    # decode per-class deltas against the proposals; PriorBoxVar = the
    # bbox_reg_weights used to scale the training targets
    var = layers.assign(np.tile(np.asarray([0.1, 0.1, 0.2, 0.2], np.float32),
                                (batch_size * Rp, 1)))
    _, best_box = layers.box_decoder_and_assign(flat_rois, var, head_bbox,
                                                probs)
    # NMS over each roi's best-class box with per-class scores; proposal
    # padding rows (index >= rois_num) are masked to score 0 so degenerate
    # [0,0,-1,-1] boxes can never surface as detections
    scores = layers.reshape(probs, [batch_size, Rp, num_classes])
    idx = layers.assign(np.arange(Rp, dtype=np.int64).reshape(1, Rp))
    valid = layers.cast(
        layers.less_than(idx, layers.reshape(
            layers.cast(rois_num, "int64"), [batch_size, 1])), "float32")
    scores = layers.elementwise_mul(scores, layers.reshape(
        valid, [batch_size, Rp, 1]))
    scores = layers.transpose(scores, [0, 2, 1])
    # reference flow: boxes decode in network-input coords; divide by the
    # im_info scale into ORIGINAL-image space, then clip to those bounds
    # (box_clip clips to round(h/scale)-1 — clipping network-space boxes
    # directly would truncate valid detections whenever scale != 1)
    inv_scale = layers.reshape(
        layers.slice(im_info, [1], [2], [3]), [batch_size, 1, 1])
    best_box = layers.elementwise_div(
        layers.reshape(best_box, [batch_size, Rp, 4]), inv_scale)
    best_box = layers.box_clip(best_box, im_info)
    return layers.multiclass_nms(best_box, scores, score_thresh,
                                 nms_top_k=post_nms_top_n,
                                 keep_top_k=keep_top_k,
                                 nms_threshold=nms_thresh,
                                 background_label=0)
