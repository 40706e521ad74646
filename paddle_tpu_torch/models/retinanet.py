"""RetinaNet one-stage detector, the port's copy of
``paddle_tpu/models/retinanet.py`` (same layers and parameter names;
reference: the model retinanet_target_assign / sigmoid_focal_loss / retinanet_detection_output
exist to serve — operators/detection/retinanet_detection_output_op.cc,
sigmoid_focal_loss_op.cc; PaddleCV retinanet config).

FPN neck (shared with models/mask_rcnn.py) + class/box subnets shared
across levels, focal classification loss, smooth-L1 box loss; inference
decodes per-level against the anchors (box_coder decode) and fuses levels
through retinanet_detection_output. ``scale``/``levels`` shrink for tests.
"""
from __future__ import annotations


from .. import layers
from ..layer_helper import ParamAttr
from .mask_rcnn import _fpn_backbone, _fpn_neck


def _subnet(feat, out_ch, head_ch, n_convs, prefix, scale):
    c = max(16, int(head_ch * scale))
    h = feat
    for i in range(n_convs):
        h = layers.conv2d(h, c, 3, padding=1, act="relu",
                          param_attr=ParamAttr(name=f"{prefix}_c{i}.w"))
    return layers.conv2d(h, out_ch, 1,
                         param_attr=ParamAttr(name=f"{prefix}_head.w"))


def _level_outputs(pyramid, strides, num_classes, n_anchors, scale, n_convs):
    """Per level: (cls [N, A*C, H, W], box [N, A*4, H, W], anchors, var)."""
    outs = []
    for feat, stride in zip(pyramid, strides):
        cls = _subnet(feat, n_anchors * (num_classes - 1), 256, n_convs,
                      "retina_cls", scale)
        box = _subnet(feat, n_anchors * 4, 256, n_convs, "retina_box", scale)
        anchors, variances = layers.anchor_generator(
            feat, anchor_sizes=[stride * 4, stride * 5, stride * 6],
            aspect_ratios=[1.0], stride=[float(stride), float(stride)],
            variance=(1.0, 1.0, 1.0, 1.0))
        outs.append((cls, box, anchors, variances))
    return outs


def _flatten_head(t, n_anchors, k, w, stride, batch=None):
    """[N, A*K, H, W] -> anchor-major rows: [N, H, W, A, K] then flat.
    One helper for train AND infer so the anchor ordering cannot desync
    between target assignment and decode."""
    hwA = layers.transpose(
        layers.reshape(t, [0, n_anchors, k, -1, w // stride]),
        [0, 3, 4, 1, 2])
    if batch is None:
        return hwA                      # caller slices per image
    return layers.reshape(hwA, [batch, -1, k])


def retinanet(img, gt_box, gt_label, im_info, batch_size, num_classes=81,
              scale=1.0, levels=3, n_convs=2, gamma=2.0, alpha=0.25):
    """Training graph. gt_label classes are 1..C-1 (0 = background).
    Returns (total, cls_loss, reg_loss). Note: the class subnet predicts
    C-1 foreground channels (reference convention)."""
    # start at the true stride-8 stage: drop the backbone's stride-4 feature
    # and derive strides from the remaining geometry (a relabeled min_level
    # desynced anchors from features)
    feats = _fpn_backbone(img, scale, n_stages=levels + 1)[1:]
    pyramid, strides = _fpn_neck(feats, max(16, int(256 * scale)),
                                 base_stride=8)
    n_anchors = 3
    level_outs = _level_outputs(pyramid, strides, num_classes, n_anchors,
                                scale, n_convs)
    cls_losses, reg_losses = [], []
    W = img.shape[3]
    for (cls, box, anchors, variances), stride in zip(level_outs, strides):
        flat_anchors = layers.reshape(anchors, [-1, 4])
        C1 = num_classes - 1
        cls_hwA = _flatten_head(cls, n_anchors, C1, W, stride)
        box_hwA = _flatten_head(box, n_anchors, 4, W, stride)
        for i in range(batch_size):
            cls_i = layers.reshape(
                layers.slice(cls_hwA, [0], [i], [i + 1]), [-1, C1])
            box_i = layers.reshape(
                layers.slice(box_hwA, [0], [i], [i + 1]), [-1, 4])
            gt_i = layers.reshape(layers.slice(gt_box, [0], [i], [i + 1]),
                                  [-1, 4])
            lbl_i = layers.reshape(layers.slice(gt_label, [0], [i], [i + 1]),
                                   [-1])
            im_info_i = layers.slice(im_info, [0], [i], [i + 1])
            (sp, lp, st, lt, iw, fg) = layers.retinanet_target_assign(
                box_i, cls_i, flat_anchors,
                layers.reshape(variances, [-1, 4]), gt_i, lbl_i,
                im_info=im_info_i, num_classes=num_classes)
            cls_losses.append(layers.reduce_sum(
                layers.sigmoid_focal_loss(sp, st, fg, gamma=gamma,
                                          alpha=alpha)))
            reg_losses.append(layers.reduce_sum(
                layers.smooth_l1(lp, lt, inside_weight=iw,
                                 outside_weight=iw, sigma=3.0)))
    denom = 1.0 / batch_size
    cls_loss = layers.scale(layers.sum(cls_losses), denom)
    reg_loss = layers.scale(layers.sum(reg_losses), scale=denom * 1e-2)
    total = layers.elementwise_add(cls_loss, reg_loss)
    return total, cls_loss, reg_loss


def retinanet_infer(img, im_info, batch_size, num_classes=81, scale=1.0,
                    levels=3, n_convs=2, score_thresh=0.05, nms_thresh=0.45,
                    keep_top_k=100):
    """Inference: per-level decode vs anchors -> retinanet_detection_output.
    Returns dets [N, keep_top_k, 6] (label=-1 marks padding rows, the
    reference's empty-LoD analog)."""
    feats = _fpn_backbone(img, scale, n_stages=levels + 1, is_test=True)[1:]
    pyramid, strides = _fpn_neck(feats, max(16, int(256 * scale)),
                                 base_stride=8)
    n_anchors = 3
    level_outs = _level_outputs(pyramid, strides, num_classes, n_anchors,
                                scale, n_convs)
    W = img.shape[3]
    boxes_l, scores_l = [], []
    for (cls, box, anchors, variances), stride in zip(level_outs, strides):
        C1 = num_classes - 1
        cls_flat = _flatten_head(cls, n_anchors, C1, W, stride,
                                 batch=batch_size)
        box_flat = _flatten_head(box, n_anchors, 4, W, stride,
                                 batch=batch_size)
        flat_anchors = layers.reshape(anchors, [-1, 4])
        decoded = layers.box_coder(flat_anchors, None, box_flat,
                                   code_type="decode_center_size")
        boxes_l.append(decoded)
        scores_l.append(layers.sigmoid(cls_flat))
    return layers.retinanet_detection_output(
        boxes_l, scores_l, im_info, score_threshold=score_thresh,
        nms_threshold=nms_thresh, keep_top_k=keep_top_k)
