"""Mask R-CNN with an FPN neck, the port's copy of
``paddle_tpu/models/mask_rcnn.py`` (same layers and parameter names;
reference: the model family the remaining detection ops serve — operators/detection/collect_fpn_proposals_op.cc,
distribute_fpn_proposals_op.cc, generate_mask_labels_op.cc; PaddleCV
mask_rcnn_fpn config).

Fixed-shape design decisions (each documented at its op):
  * per-level proposals are collected by global top-k
    (`collect_fpn_proposals`), not ragged LoD concat;
  * level routing uses a per-roi level INDEX; RoIAlign runs per level on
    the full roi set and rows are selected by level — shape-stable, no
    gathers (`distribute_fpn_proposals` docstring);
  * mask targets are bilinear crop-resizes of gt bitmap masks
    (`generate_mask_targets`), sampling replaced by fg weighting as in the
    box branch.

``scale``/``levels`` shrink the model for CPU tests.
"""
from __future__ import annotations

import numpy as np

from .. import layers
from ..layer_helper import ParamAttr
from .resnet import conv_bn_layer, bottleneck_block
from .faster_rcnn import _rpn_head, _box_head


def _fpn_backbone(img, scale=1.0, blocks_per_stage=1, n_stages=4,
                  is_test=False):
    """ResNet-ish bottom-up pyramid: returns [C2, C3, ...] (stride 4, 8, …)."""
    c = lambda ch: max(16, int(ch * scale))
    h = conv_bn_layer(img, c(64), 7, stride=2, act="relu", name="fpn_stem",
                      is_test=is_test)
    h = layers.pool2d(h, 3, "max", 2, pool_padding=1)
    feats = []
    ch = 64
    for stage in range(n_stages):
        stride = 1 if stage == 0 else 2
        for i in range(blocks_per_stage):
            h = bottleneck_block(h, c(ch), stride if i == 0 else 1,
                                 name=f"fpn_s{stage}_{i}", is_test=is_test)
        feats.append(h)
        ch *= 2
    return feats


def _fpn_neck(feats, out_ch, base_stride=4):
    """Lateral 1x1 + top-down nearest upsample + 3x3 smooth -> P_levels,
    finest first. Returns ([P2, P3, ...], [stride2, stride3, ...]).

    Strides are derived from the actual geometry of ``feats``: the backbone
    yields stride base_stride (4: stem/2 + pool/2) for its first feature and
    doubles per stage -- callers wanting coarser minimum levels slice
    ``feats`` and pass the matching base_stride (there is deliberately no
    relabeling knob: a relabeled level desyncs anchor placement from the
    feature grid)."""
    laterals = [layers.conv2d(f, out_ch, 1,
                              param_attr=ParamAttr(name=f"fpn_lat{i}.w"))
                for i, f in enumerate(feats)]
    outs = [None] * len(feats)
    top = laterals[-1]
    outs[-1] = top
    for i in range(len(feats) - 2, -1, -1):
        top = layers.elementwise_add(layers.resize_nearest(top, scale=2),
                                     laterals[i])
        outs[i] = top
    smoothed = [layers.conv2d(p, out_ch, 3, padding=1,
                              param_attr=ParamAttr(name=f"fpn_smooth{i}.w"))
                for i, p in enumerate(outs)]
    strides = [base_stride * 2 ** i for i in range(len(feats))]
    return smoothed, strides


def _fpn_roi_align(pyramid, strides, rois_flat, levels_flat, counts,
                   resolution, min_level):
    """RoIAlign across the pyramid: run each level on the full roi set and
    select rows by the roi's level (shape-stable select, no gather)."""
    out = None
    for i, (feat, stride) in enumerate(zip(pyramid, strides)):
        pooled = layers.roi_align(feat, rois_flat,
                                  pooled_height=resolution,
                                  pooled_width=resolution,
                                  spatial_scale=1.0 / stride,
                                  rois_num=counts)
        onlvl = layers.cast(
            layers.equal(levels_flat,
                         layers.fill_constant([1], "int32",
                                              min_level + i)), "float32")
        onlvl = layers.reshape(onlvl, [-1, 1, 1, 1])
        term = layers.elementwise_mul(pooled, onlvl)
        out = term if out is None else layers.elementwise_add(out, term)
    return out


def _mask_head(roi_feat, num_classes, scale=1.0, n_convs=2):
    c = max(16, int(256 * scale))
    h = roi_feat
    for i in range(n_convs):
        h = layers.conv2d(h, c, 3, padding=1, act="relu",
                          param_attr=ParamAttr(name=f"mask_c{i}.w"))
    h = layers.conv2d_transpose(h, c, filter_size=2, stride=2, act="relu",
                                param_attr=ParamAttr(name="mask_up.w"))
    return layers.conv2d(h, num_classes, 1,
                         param_attr=ParamAttr(name="mask_out.w"))


def _levels_and_flat(rois, batch_size, min_level, max_level):
    Rp = rois.shape[1]
    lvl = layers.distribute_fpn_proposals(rois, min_level, max_level,
                                          refer_level=min_level + 2,
                                          refer_scale=56)
    flat_rois = layers.reshape(rois, [-1, 4])
    flat_lvl = layers.reshape(lvl, [-1])
    counts = layers.assign(np.full((batch_size,), Rp, np.int32))
    return flat_rois, flat_lvl, counts, Rp


def mask_rcnn(img, gt_box, gt_label, gt_masks, im_info, batch_size,
              num_classes=81, scale=1.0, levels=3, anchor_base=16,
              post_nms_top_n=64, roi_resolution=7, mask_resolution=14):
    """Training graph. img [N,3,H,W]; gt_box [N,G,4] pixel xyxy; gt_label
    [N,G] int32 (1..C-1); gt_masks [N,G,Hm,Wm] {0,1} bitmaps over the image
    canvas; im_info [N,3]. Returns (total, rpn_loss, box_loss, mask_loss)."""
    min_level = 2
    H, W = img.shape[2], img.shape[3]
    feats = _fpn_backbone(img, scale, n_stages=levels)
    pyramid, strides = _fpn_neck(feats, max(16, int(256 * scale)))
    n_anchors = 3

    # ---- RPN over every level (shared weights via fixed param names) ----
    lvl_rois, lvl_scores = [], []
    rpn_cls_losses, rpn_reg_losses = [], []
    for li, (feat, stride) in enumerate(zip(pyramid, strides)):
        cls_logits, bbox_pred = _rpn_head(feat, n_anchors, scale)
        anchors, variances = layers.anchor_generator(
            feat, anchor_sizes=[anchor_base * stride // 4,
                                anchor_base * stride // 2,
                                anchor_base * stride],
            aspect_ratios=[1.0], stride=[float(stride), float(stride)],
            variance=(1.0, 1.0, 1.0, 1.0))
        probs = layers.sigmoid(cls_logits)
        rois, rprobs, rnum = layers.generate_proposals(
            probs, bbox_pred, im_info, anchors, variances,
            pre_nms_top_n=256, post_nms_top_n=post_nms_top_n,
            nms_thresh=0.7, min_size=1.0)
        lvl_rois.append(rois)
        lvl_scores.append(rprobs)
        # per-image target assignment on this level's anchors
        flat_anchors = layers.reshape(anchors, [-1, 4])
        flat_var = layers.reshape(variances, [-1, 4])
        sc_hwA = layers.transpose(cls_logits, [0, 2, 3, 1])
        dl_hwA = layers.transpose(
            layers.reshape(bbox_pred, [0, n_anchors, 4, -1,
                                       W // stride]),
            [0, 3, 4, 1, 2])
        for i in range(batch_size):
            sc_i = layers.reshape(layers.slice(sc_hwA, [0], [i], [i + 1]),
                                  [-1, 1])
            dl_i = layers.reshape(layers.slice(dl_hwA, [0], [i], [i + 1]),
                                  [-1, 4])
            gt_i = layers.reshape(layers.slice(gt_box, [0], [i], [i + 1]),
                                  [-1, 4])
            im_i = layers.slice(im_info, [0], [i], [i + 1])
            sp, lp, st, lt, iw = layers.rpn_target_assign(
                dl_i, sc_i, flat_anchors, flat_var, gt_i, im_info=im_i)
            rpn_cls_losses.append(layers.mean(
                layers.sigmoid_cross_entropy_with_logits(sp, st)))
            rpn_reg_losses.append(layers.mean(
                layers.smooth_l1(lp, lt, inside_weight=iw, sigma=3.0)))
    denom = 1.0 / (batch_size * len(pyramid))
    rpn_loss = layers.elementwise_add(
        layers.scale(layers.sum(rpn_cls_losses), denom),
        layers.scale(layers.sum(rpn_reg_losses), denom))

    # ---- collect across levels + second-stage targets -------------------
    rois, rois_num = layers.collect_fpn_proposals(
        lvl_rois, lvl_scores, min_level, min_level + levels - 1,
        post_nms_top_n)
    (s_rois, s_labels, s_tgt, s_inw, s_outw,
     s_clsw, s_matched) = layers.generate_proposal_labels(
        rois, gt_label, None, gt_box, im_info, class_nums=num_classes,
        fg_thresh=0.5, rpn_rois_num=rois_num)

    # ---- box branch over the pyramid ------------------------------------
    flat_rois, flat_lvl, counts, Rp = _levels_and_flat(
        s_rois, batch_size, min_level, min_level + levels - 1)
    roi_feat = _fpn_roi_align(pyramid, strides, flat_rois, flat_lvl, counts,
                              roi_resolution, min_level)
    cls_score, head_bbox = _box_head(roi_feat, num_classes, scale)
    flat_labels = layers.reshape(s_labels, [-1, 1])
    flat_clsw = layers.reshape(s_clsw, [-1, 1])
    safe_labels = layers.cast(
        layers.elementwise_max(flat_labels,
                               layers.fill_constant([1], "int32", 0)),
        "int64")
    ce = layers.softmax_with_cross_entropy(cls_score, safe_labels)
    cls_loss = layers.mean(layers.elementwise_mul(ce, flat_clsw))
    reg_loss = layers.mean(layers.smooth_l1(
        head_bbox, layers.reshape(s_tgt, [-1, 4 * num_classes]),
        inside_weight=layers.reshape(s_inw, [-1, 4 * num_classes]),
        outside_weight=layers.reshape(s_outw, [-1, 4 * num_classes]),
        sigma=1.0))
    box_loss = layers.elementwise_add(cls_loss, reg_loss)

    # ---- mask branch -----------------------------------------------------
    # fg selector; the matched gt comes from the labeler itself (its
    # crowd/zero-area-masked argmax-IoU), so a fg roi's mask target can
    # never come from a different gt than its class label
    fg = layers.cast(layers.greater_than(
        s_labels, layers.fill_constant([1], "int32", 0)), "float32")
    matched = s_matched
    mask_feat = _fpn_roi_align(pyramid, strides, flat_rois, flat_lvl, counts,
                               mask_resolution, min_level)
    mask_logits = _mask_head(mask_feat, num_classes, scale)  # [N*Rp,C,2m,2m]
    m2 = 2 * mask_resolution
    targets = layers.generate_mask_targets(
        s_rois, gt_masks, matched, fg, (H, W), resolution=m2)
    # pick each fg roi's class channel via one-hot contraction
    onehot = layers.one_hot(layers.reshape(safe_labels, [-1, 1]),
                            num_classes)                     # [N*Rp, C]
    onehot = layers.reshape(onehot, [-1, num_classes, 1, 1])
    sel_logits = layers.reduce_sum(
        layers.elementwise_mul(mask_logits, onehot), 1)      # [N*Rp, 2m, 2m]
    flat_t = layers.reshape(targets, [-1, m2, m2])
    per_px = layers.sigmoid_cross_entropy_with_logits(
        layers.reshape(sel_logits, [-1, m2 * m2]),
        layers.reshape(flat_t, [-1, m2 * m2]))
    per_roi = layers.reduce_mean(per_px, 1, keep_dim=True)   # [N*Rp, 1]
    fg_flat = layers.reshape(fg, [-1, 1])
    mask_loss = layers.mean(layers.elementwise_mul(per_roi, fg_flat))

    total = layers.elementwise_add(
        layers.elementwise_add(rpn_loss, box_loss), mask_loss)
    return total, rpn_loss, box_loss, mask_loss


def mask_rcnn_infer(img, im_info, batch_size, num_classes=81, scale=1.0,
                    levels=3, anchor_base=16, post_nms_top_n=64,
                    roi_resolution=7, mask_resolution=14, score_thresh=0.05,
                    nms_thresh=0.5, keep_top_k=50):
    """Inference: FPN proposals -> box head -> decode+NMS -> mask head on
    the kept boxes. Returns (dets [N,K,6], counts [N],
    masks [N, K, 2*mask_resolution, 2*mask_resolution] probabilities)."""
    min_level = 2
    feats = _fpn_backbone(img, scale, n_stages=levels, is_test=True)
    pyramid, strides = _fpn_neck(feats, max(16, int(256 * scale)))
    n_anchors = 3
    lvl_rois, lvl_scores = [], []
    for li, (feat, stride) in enumerate(zip(pyramid, strides)):
        cls_logits, bbox_pred = _rpn_head(feat, n_anchors, scale)
        anchors, variances = layers.anchor_generator(
            feat, anchor_sizes=[anchor_base * stride // 4,
                                anchor_base * stride // 2,
                                anchor_base * stride],
            aspect_ratios=[1.0], stride=[float(stride), float(stride)],
            variance=(1.0, 1.0, 1.0, 1.0))
        probs = layers.sigmoid(cls_logits)
        rois, rprobs, _ = layers.generate_proposals(
            probs, bbox_pred, im_info, anchors, variances,
            pre_nms_top_n=256, post_nms_top_n=post_nms_top_n,
            nms_thresh=0.7, min_size=1.0)
        lvl_rois.append(rois)
        lvl_scores.append(rprobs)
    rois, rois_num = layers.collect_fpn_proposals(
        lvl_rois, lvl_scores, min_level, min_level + levels - 1,
        post_nms_top_n)

    flat_rois, flat_lvl, counts, Rp = _levels_and_flat(
        rois, batch_size, min_level, min_level + levels - 1)
    roi_feat = _fpn_roi_align(pyramid, strides, flat_rois, flat_lvl, counts,
                              roi_resolution, min_level)
    cls_score, head_bbox = _box_head(roi_feat, num_classes, scale)
    probs = layers.softmax(cls_score)
    var = layers.assign(np.tile(np.asarray([0.1, 0.1, 0.2, 0.2], np.float32),
                                (batch_size * Rp, 1)))
    _, best_box = layers.box_decoder_and_assign(flat_rois, var, head_bbox,
                                                probs)
    scores = layers.reshape(probs, [batch_size, Rp, num_classes])
    idx = layers.assign(np.arange(Rp, dtype=np.int64).reshape(1, Rp))
    valid = layers.cast(
        layers.less_than(idx, layers.reshape(
            layers.cast(rois_num, "int64"), [batch_size, 1])), "float32")
    scores = layers.elementwise_mul(scores, layers.reshape(
        valid, [batch_size, Rp, 1]))
    scores = layers.transpose(scores, [0, 2, 1])
    inv_scale = layers.reshape(
        layers.slice(im_info, [1], [2], [3]), [batch_size, 1, 1])
    best_box = layers.elementwise_div(
        layers.reshape(best_box, [batch_size, Rp, 4]), inv_scale)
    best_box = layers.box_clip(best_box, im_info)
    dets, det_num = layers.multiclass_nms(best_box, scores, score_thresh,
                                          nms_top_k=post_nms_top_n,
                                          keep_top_k=keep_top_k,
                                          nms_threshold=nms_thresh,
                                          background_label=0)

    # ---- mask head on the kept boxes (back in network coords) -----------
    det_boxes = layers.slice(dets, [2], [2], [6])            # [N, K, 4]
    det_boxes_net = layers.elementwise_mul(
        det_boxes, layers.reshape(inv_scale, [batch_size, 1, 1]))
    dflat, dlvl, dcounts, K = _levels_and_flat(
        det_boxes_net, batch_size, min_level, min_level + levels - 1)
    mask_feat = _fpn_roi_align(pyramid, strides, dflat, dlvl, dcounts,
                               mask_resolution, min_level)
    mask_logits = _mask_head(mask_feat, num_classes, scale)
    det_labels = layers.cast(
        layers.elementwise_max(
            layers.reshape(layers.slice(dets, [2], [0], [1]), [-1, 1]),
            layers.fill_constant([1], "float32", 0.0)), "int64")
    onehot = layers.reshape(layers.one_hot(det_labels, num_classes),
                            [-1, num_classes, 1, 1])
    m2 = 2 * mask_resolution
    sel = layers.reduce_sum(layers.elementwise_mul(mask_logits, onehot), 1)
    masks = layers.sigmoid(layers.reshape(sel, [batch_size, K, m2, m2]))
    return dets, det_num, masks
