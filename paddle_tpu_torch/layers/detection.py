"""Detection layers (the port's copy of ``paddle_tpu/layers/detection.py``:
the 28 functions of its ``__all__``, with the same signatures, op types,
slots, attrs and composites, so both packages build the same Program).

The ops are ``ops/detection_ops.py``'s fixed-shape forms: NMS outputs are
padded to ``keep_top_k`` with counts, proposals to ``post_nms_top_n``, and
the sampling of ``rpn_target_assign`` / ``generate_proposal_labels`` /
``retinanet_target_assign`` becomes weighting (``use_random`` is accepted
and not read, as in the JAX package: ROADMAP 3.24). ``density_prior_box``
raises, as the JAX one does.
"""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["iou_similarity", "box_coder", "prior_box", "yolo_box",
           "multiclass_nms", "multiclass_nms2", "roi_align", "roi_pool",
           "anchor_generator", "box_clip", "bipartite_match",
           "target_assign", "ssd_loss", "sigmoid_focal_loss",
           "detection_output", "density_prior_box", "generate_proposals",
           "generate_proposal_labels", "rpn_target_assign", "yolov3_loss",
           "collect_fpn_proposals", "distribute_fpn_proposals",
           "generate_mask_targets", "retinanet_target_assign",
           "box_decoder_and_assign", "polygon_box_transform",
           "retinanet_detection_output", "multi_box_head"]


def _out(helper, dtype="float32", stop_gradient=False):
    return helper.create_variable_for_type_inference(dtype, stop_gradient)


def iou_similarity(x, y, name=None):
    helper = LayerHelper("iou_similarity", name=name)
    out = _out(helper, x.dtype)
    helper.append_op("iou_similarity", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return helper.main_program.current_block().var(out.name)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, name=None,
              axis=0):
    helper = LayerHelper("box_coder", name=name)
    out = _out(helper, target_box.dtype)
    inputs = {"PriorBox": [prior_box], "TargetBox": [target_box]}
    attrs = {"code_type": code_type, "box_normalized": box_normalized}
    if prior_box_var is not None:
        if isinstance(prior_box_var, (list, tuple)):
            attrs["variance"] = [float(v) for v in prior_box_var]
        else:
            inputs["PriorBoxVar"] = [prior_box_var]
    helper.append_op("box_coder", inputs=inputs,
                     outputs={"OutputBox": [out]}, attrs=attrs)
    return helper.main_program.current_block().var(out.name)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None,
              min_max_aspect_ratios_order=False):
    helper = LayerHelper("prior_box", name=name)
    boxes = _out(helper, input.dtype, stop_gradient=True)
    variances = _out(helper, input.dtype, stop_gradient=True)
    helper.append_op("prior_box",
                     inputs={"Input": [input], "Image": [image]},
                     outputs={"Boxes": [boxes], "Variances": [variances]},
                     attrs={"min_sizes": list(min_sizes),
                            "max_sizes": list(max_sizes or []),
                            "aspect_ratios": list(aspect_ratios),
                            "variances": list(variance), "flip": flip,
                            "clip": clip, "step_w": steps[0],
                            "step_h": steps[1], "offset": offset})
    blk = helper.main_program.current_block()
    return blk.var(boxes.name), blk.var(variances.name)


def yolo_box(x, img_size, anchors, class_num, conf_thresh, downsample_ratio,
             name=None):
    helper = LayerHelper("yolo_box", name=name)
    boxes = _out(helper, x.dtype, stop_gradient=True)
    scores = _out(helper, x.dtype, stop_gradient=True)
    helper.append_op("yolo_box",
                     inputs={"X": [x], "ImgSize": [img_size]},
                     outputs={"Boxes": [boxes], "Scores": [scores]},
                     attrs={"anchors": list(anchors), "class_num": class_num,
                            "conf_thresh": conf_thresh,
                            "downsample_ratio": downsample_ratio})
    blk = helper.main_program.current_block()
    return blk.var(boxes.name), blk.var(scores.name)


def multiclass_nms(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                   nms_threshold=0.3, normalized=True, nms_eta=1.0,
                   background_label=0, name=None, return_rois_num=True):
    """Reference nn/detection.py:multiclass_nms. Fixed-shape output:
    [N, keep_top_k, 6] (label, score, x1, y1, x2, y2) with label=-1 padding
    + per-image kept counts (the LoD output becomes padded + counts)."""
    helper = LayerHelper("multiclass_nms", name=name)
    out = _out(helper, bboxes.dtype, stop_gradient=True)
    num = _out(helper, "int64", stop_gradient=True)
    helper.append_op("multiclass_nms",
                     inputs={"BBoxes": [bboxes], "Scores": [scores]},
                     outputs={"Out": [out], "NmsRoisNum": [num]},
                     attrs={"score_threshold": float(score_threshold),
                            "nms_top_k": int(nms_top_k),
                            "keep_top_k": int(keep_top_k),
                            "nms_threshold": float(nms_threshold),
                            "normalized": bool(normalized),
                            "nms_eta": float(nms_eta),
                            "background_label": int(background_label)})
    blk = helper.main_program.current_block()
    if return_rois_num:
        return blk.var(out.name), blk.var(num.name)
    return blk.var(out.name)


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, rois_num=None, name=None):
    """Reference detection roi_align. rois_num [N]: per-image ROI counts."""
    helper = LayerHelper("roi_align", name=name)
    out = _out(helper, input.dtype)
    inputs = {"X": [input], "ROIs": [rois]}
    if rois_num is not None:
        inputs["RoisNum"] = [rois_num]
    helper.append_op("roi_align", inputs=inputs, outputs={"Out": [out]},
                     attrs={"pooled_height": int(pooled_height),
                            "pooled_width": int(pooled_width),
                            "spatial_scale": float(spatial_scale),
                            "sampling_ratio": int(sampling_ratio)})
    return helper.main_program.current_block().var(out.name)


def roi_pool(input, rois, pooled_height=1, pooled_width=1, spatial_scale=1.0,
             rois_num=None, name=None):
    helper = LayerHelper("roi_pool", name=name)
    out = _out(helper, input.dtype)
    inputs = {"X": [input], "ROIs": [rois]}
    if rois_num is not None:
        inputs["RoisNum"] = [rois_num]
    helper.append_op("roi_pool", inputs=inputs, outputs={"Out": [out]},
                     attrs={"pooled_height": int(pooled_height),
                            "pooled_width": int(pooled_width),
                            "spatial_scale": float(spatial_scale)})
    return helper.main_program.current_block().var(out.name)


def anchor_generator(input, anchor_sizes=None, aspect_ratios=None,
                     variance=(0.1, 0.1, 0.2, 0.2), stride=None, offset=0.5,
                     name=None):
    helper = LayerHelper("anchor_generator", name=name)
    anchors = _out(helper, input.dtype, stop_gradient=True)
    variances = _out(helper, input.dtype, stop_gradient=True)
    helper.append_op("anchor_generator", inputs={"Input": [input]},
                     outputs={"Anchors": [anchors], "Variances": [variances]},
                     attrs={"anchor_sizes": [float(s) for s in
                                             (anchor_sizes or [64.0])],
                            "aspect_ratios": [float(r) for r in
                                              (aspect_ratios or [1.0])],
                            "variances": [float(v) for v in variance],
                            "stride": [float(s) for s in (stride or [16, 16])],
                            "offset": float(offset)})
    blk = helper.main_program.current_block()
    return blk.var(anchors.name), blk.var(variances.name)


def box_clip(input, im_info, name=None):
    helper = LayerHelper("box_clip", name=name)
    out = _out(helper, input.dtype)
    helper.append_op("box_clip", inputs={"Input": [input],
                                         "ImInfo": [im_info]},
                     outputs={"Output": [out]})
    return helper.main_program.current_block().var(out.name)


def bipartite_match(dist_matrix, match_type="bipartite", dist_threshold=0.5,
                    name=None):
    helper = LayerHelper("bipartite_match", name=name)
    idx = _out(helper, "int32", stop_gradient=True)
    dist = _out(helper, dist_matrix.dtype, stop_gradient=True)
    helper.append_op("bipartite_match", inputs={"DistMat": [dist_matrix]},
                     outputs={"ColToRowMatchIndices": [idx],
                              "ColToRowMatchDist": [dist]},
                     attrs={"match_type": match_type,
                            "dist_threshold": float(dist_threshold)})
    blk = helper.main_program.current_block()
    return blk.var(idx.name), blk.var(dist.name)


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=0.0, name=None):
    helper = LayerHelper("target_assign", name=name)
    out = _out(helper, input.dtype, stop_gradient=True)
    w = _out(helper, input.dtype, stop_gradient=True)
    helper.append_op("target_assign",
                     inputs={"X": [input],
                             "MatchIndices": [matched_indices]},
                     outputs={"Out": [out], "OutWeight": [w]},
                     attrs={"mismatch_value": float(mismatch_value)})
    blk = helper.main_program.current_block()
    return blk.var(out.name), blk.var(w.name)


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True, sample_size=None):
    """Reference detection.py:ssd_loss composite, padded+counts form:
    gt_box [G, 4], gt_label [G, 1] for a single image (batch the program or
    vmap for multi-image). Matches priors to ground truth (bipartite +
    per-prediction), encodes regression targets, smooth-L1 + softmax losses
    with matched-position weighting (hard negative mining simplified to the
    weighting scheme -- documented deviation)."""
    from . import nn as _nn
    from . import tensor as _tensor
    iou = iou_similarity(gt_box, prior_box)                   # [G, M]
    match_idx, match_dist = bipartite_match(iou, match_type,
                                            overlap_threshold)
    # location loss on matched priors; unmatched rows take the prior itself
    # as the (zero-residual) target -- encoding a zero box would log(0)->NaN
    # and poison the whole graph even though its weight is zero
    loc_target, loc_w = target_assign(gt_box, match_idx)      # [M, 4]
    safe_target = _nn.elementwise_add(
        _nn.elementwise_mul(loc_target, loc_w),
        _nn.elementwise_mul(prior_box,
                            _nn.scale(loc_w, -1.0, bias=1.0)))
    enc = box_coder(prior_box, prior_box_var, safe_target)    # encode
    loc_l = _nn.smooth_l1(location, enc)
    loc_l = _nn.reduce_sum(_nn.elementwise_mul(loc_l, loc_w))
    # classification: matched priors take the gt label, rest background
    lbl_target, _ = target_assign(
        _tensor.cast(gt_label, "float32"), match_idx,
        mismatch_value=float(background_label))
    conf_l = _nn.softmax_with_cross_entropy(
        confidence, _tensor.cast(lbl_target, "int64"))
    conf_l = _nn.reduce_sum(conf_l)
    total = _nn.elementwise_add(_nn.scale(loc_l, float(loc_loss_weight)),
                                _nn.scale(conf_l, float(conf_loss_weight)))
    if normalize:
        # loc_w is [M,1]: sum == #matched priors (the reference's normalizer)
        denom = _nn.scale(_nn.reduce_sum(loc_w), 1.0, bias=1e-6)
        total = _nn.elementwise_div(total, denom)
    return total


def sigmoid_focal_loss(x, label, fg_num, gamma=2.0, alpha=0.25):
    """Reference detection.py:sigmoid_focal_loss (RetinaNet): per-class
    sigmoid CE with focal modulation, normalized by foreground count.
    x [N, C] logits; label [N, 1] int (0 = background); fg_num [1] int."""
    helper = LayerHelper("sigmoid_focal_loss")
    out = _out(helper, x.dtype)
    helper.append_op("sigmoid_focal_loss",
                     inputs={"X": [x], "Label": [label], "FgNum": [fg_num]},
                     outputs={"Out": [out]},
                     attrs={"gamma": float(gamma), "alpha": float(alpha)})
    return helper.main_program.current_block().var(out.name)


def detection_output(loc, scores, prior_box, prior_box_var=None,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0,
                     return_index=False):
    """Reference detection.py:detection_output = decode + multiclass NMS
    (the SSD inference head)."""
    from . import nn as _nn
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")
    if len(decoded.shape) == 2:
        decoded = _nn.reshape(decoded, [1] + [int(s) for s in decoded.shape])
    # reference detection.py:detection_output applies softmax over classes
    # and feeds NMS [N, C, M]; accept the reference's [N, M, C] (or [M, C])
    scores = _nn.softmax(scores)
    if len(scores.shape) == 2:                       # [M, C] -> [1, C, M]
        scores = _nn.reshape(_nn.transpose(scores, [1, 0]),
                             [1, int(scores.shape[1]), int(scores.shape[0])])
    else:                                            # [N, M, C] -> [N, C, M]
        scores = _nn.transpose(scores, [0, 2, 1])
    if return_index:
        # reference contract: the second output is the kept boxes' INDEX
        # into the prior list, not the counts
        return multiclass_nms2(decoded, scores, score_threshold, nms_top_k,
                               keep_top_k, nms_threshold, True, nms_eta,
                               background_label, return_index=True)
    out, _ = multiclass_nms(decoded, scores, score_threshold, nms_top_k,
                            keep_top_k, nms_threshold, True, nms_eta,
                            background_label)
    return out


def multiclass_nms2(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                    nms_threshold=0.3, normalized=True, nms_eta=1.0,
                    background_label=0, return_index=False, name=None):
    """Reference multiclass_nms2: multiclass_nms that can also return the
    kept boxes' indices into the input box list (-1 padding)."""
    helper = LayerHelper("multiclass_nms2", name=name)
    out = _out(helper, bboxes.dtype, stop_gradient=True)
    idx = _out(helper, "int64", stop_gradient=True)
    num = _out(helper, "int64", stop_gradient=True)
    helper.append_op("multiclass_nms",
                     inputs={"BBoxes": [bboxes], "Scores": [scores]},
                     outputs={"Out": [out], "Index": [idx],
                              "NmsRoisNum": [num]},
                     attrs={"score_threshold": float(score_threshold),
                            "nms_top_k": int(nms_top_k),
                            "keep_top_k": int(keep_top_k),
                            "nms_threshold": float(nms_threshold),
                            "normalized": bool(normalized),
                            "nms_eta": float(nms_eta),
                            "background_label": int(background_label)})
    blk = helper.main_program.current_block()
    if return_index:
        return blk.var(out.name), blk.var(idx.name)
    return blk.var(out.name)


def density_prior_box(input, image, densities, fixed_sizes, fixed_ratios,
                      variance=(0.1, 0.1, 0.2, 0.2), clip=False, steps=(0, 0),
                      offset=0.5, flatten_to_2d=False, name=None):
    raise NotImplementedError(
        "density_prior_box: the SSDLite density grid; use prior_box / "
        "anchor_generator (COVERAGE.md detection row -- add on demand)")


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       return_rois_num=True, name=None):
    """Reference detection.py:generate_proposals. Fixed-shape outputs:
    (rois [N, post_nms_top_n, 4], roi_probs [N, post_nms_top_n, 1],
    rois_num [N]) -- padded + counts replaces the ragged LoD."""
    helper = LayerHelper("generate_proposals", name=name)
    rois = _out(helper, scores.dtype, stop_gradient=True)
    probs = _out(helper, scores.dtype, stop_gradient=True)
    num = _out(helper, "int64", stop_gradient=True)
    helper.append_op("generate_proposals",
                     inputs={"Scores": [scores], "BboxDeltas": [bbox_deltas],
                             "ImInfo": [im_info], "Anchors": [anchors],
                             "Variances": [variances]},
                     outputs={"RpnRois": [rois], "RpnRoiProbs": [probs],
                              "RpnRoisNum": [num]},
                     attrs={"pre_nms_topN": int(pre_nms_top_n),
                            "post_nms_topN": int(post_nms_top_n),
                            "nms_thresh": float(nms_thresh),
                            "min_size": float(min_size)})
    blk = helper.main_program.current_block()
    if return_rois_num:
        return blk.var(rois.name), blk.var(probs.name), blk.var(num.name)
    return blk.var(rois.name), blk.var(probs.name)


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, is_crowd=None, im_info=None,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True):
    """Reference detection.py:288. Fixed-shape form: returns per-anchor
    (score_pred, loc_pred, score_target, loc_target, bbox_inside_weight)
    with ignore rows weighted 0 instead of the reference's 256-sample
    gather (see op docstring for the deviation rationale)."""
    from . import nn as _nn
    from . import tensor as _tensor
    from .control_flow import equal
    helper = LayerHelper("rpn_target_assign")
    labels = _out(helper, "int32", stop_gradient=True)
    matched = _out(helper, "int32", stop_gradient=True)
    tgt = _out(helper, anchor_box.dtype, stop_gradient=True)
    inputs = {"Anchor": [anchor_box], "GtBoxes": [gt_boxes]}
    if is_crowd is not None:
        inputs["IsCrowd"] = [is_crowd]
    if im_info is not None:
        inputs["ImInfo"] = [im_info]
    helper.append_op("rpn_target_assign", inputs=inputs,
                     outputs={"Labels": [labels], "MatchedGt": [matched],
                              "BboxTargets": [tgt]},
                     attrs={"rpn_positive_overlap": float(
                                rpn_positive_overlap),
                            "rpn_negative_overlap": float(
                                rpn_negative_overlap),
                            "rpn_straddle_thresh": float(
                                rpn_straddle_thresh)})
    blk = helper.main_program.current_block()
    labels = blk.var(labels.name)
    tgt = blk.var(tgt.name)
    pos_mask = _tensor.cast(
        equal(labels, _tensor.fill_constant([1], "int32", 1)), "float32")
    # ignore rows (-1) must not leak into the classification loss: their
    # logits are zero-masked (zero GRADIENT through the multiply) and their
    # targets forced to 0.5 = sigmoid(0) so the residual is zero too. The
    # reference gathers sampled anchors instead -- fixed shapes can't.
    from .extras import logical_not
    valid = _tensor.cast(
        logical_not(equal(labels,
                          _tensor.fill_constant([1], "int32", -1))),
        "float32")
    valid = _nn.reshape(valid, [-1, 1])
    score_pred = _nn.elementwise_mul(cls_logits, valid)
    score_tgt = _nn.elementwise_add(
        _nn.elementwise_mul(_nn.reshape(pos_mask, [-1, 1]), valid),
        _nn.scale(_nn.scale(valid, -1.0, bias=1.0), 0.5))
    inside_w = _nn.reshape(pos_mask, [-1, 1])
    return (score_pred, bbox_pred, score_tgt, tgt, inside_w)


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=False, name=None):
    """Reference detection.py:yolov3_loss (one detection head). gt_box
    [N, B, 4] normalized cxcywh, padded rows have zero area."""
    helper = LayerHelper("yolov3_loss", name=name)
    loss = _out(helper, x.dtype)
    inputs = {"X": [x], "GTBox": [gt_box], "GTLabel": [gt_label]}
    if gt_score is not None:
        inputs["GTScore"] = [gt_score]
    helper.append_op("yolov3_loss", inputs=inputs,
                     outputs={"Loss": [loss]},
                     attrs={"anchors": [int(a) for a in anchors],
                            "anchor_mask": [int(m) for m in anchor_mask],
                            "class_num": int(class_num),
                            "ignore_thresh": float(ignore_thresh),
                            "downsample_ratio": int(downsample_ratio),
                            "use_label_smooth": bool(use_label_smooth)})
    return helper.main_program.current_block().var(loss.name)


def box_decoder_and_assign(prior_box, prior_box_var, target_box, box_score,
                           box_clip_value=4.135, name=None):
    """Reference detection.py:box_decoder_and_assign: decode per-class box
    deltas, then pick each prior's best-scoring class box.
    target_box [M, 4*C]; box_score [M, C]. Returns (decoded_box [M, 4*C],
    output_assign_box [M, 4])."""
    helper = LayerHelper("box_decoder_and_assign", name=name)
    decoded = _out(helper, target_box.dtype)
    assigned = _out(helper, target_box.dtype)
    inputs = {"PriorBox": [prior_box], "TargetBox": [target_box],
              "BoxScore": [box_score]}
    if prior_box_var is not None:
        inputs["PriorBoxVar"] = [prior_box_var]
    helper.append_op("box_decoder_and_assign", inputs=inputs,
                     outputs={"DecodeBox": [decoded],
                              "OutputAssignBox": [assigned]},
                     attrs={"box_clip": float(box_clip_value)})
    blk = helper.main_program.current_block()
    return blk.var(decoded.name), blk.var(assigned.name)


def polygon_box_transform(input, name=None):
    """Reference detection.py:polygon_box_transform (EAST text detection):
    quad offset maps -> absolute vertex coordinates."""
    helper = LayerHelper("polygon_box_transform", name=name)
    out = _out(helper, input.dtype)
    helper.append_op("polygon_box_transform", inputs={"Input": [input]},
                     outputs={"Output": [out]})
    return helper.main_program.current_block().var(out.name)


def retinanet_detection_output(bboxes, scores, im_info, score_threshold=0.05,
                               nms_top_k=1000, keep_top_k=100,
                               nms_threshold=0.3, nms_eta=1.0):
    """Reference detection.py:retinanet_detection_output: per-level decoded
    boxes/scores (already sigmoid) concat -> NMS. bboxes/scores: lists of
    [N, Mi, 4] / [N, Mi, C] per FPN level."""
    from . import nn as _nn
    from .tensor import concat as _concat
    boxes = _concat(list(bboxes), axis=1) if isinstance(
        bboxes, (list, tuple)) else bboxes
    scs = _concat(list(scores), axis=1) if isinstance(
        scores, (list, tuple)) else scores
    boxes = box_clip(boxes, im_info)                 # reference clips to image
    scs = _nn.transpose(scs, [0, 2, 1])              # [N, C, M]
    # deviation: the reference pre-selects nms_top_k PER FPN level before the
    # global NMS; here the top-k is global over the concatenated levels
    # (fixed-shape friendly; revisit if a level-starvation case shows up)
    out, num = multiclass_nms(boxes, scs, score_threshold, nms_top_k,
                              keep_top_k, nms_threshold, True, nms_eta,
                              background_label=-1)
    return out


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """Reference detection.py:multi_box_head (the SSD head): per feature map,
    prior boxes + conv loc/conf predictions, flattened and concatenated.
    Returns (mbox_locs [N, M, 4], mbox_confs [N, M, C], boxes [M, 4],
    variances [M, 4])."""
    from . import nn as _nn
    n_maps = len(inputs)
    if min_sizes is None:
        if n_maps <= 2:
            raise ValueError(
                "multi_box_head: the min_ratio/max_ratio schedule needs at "
                "least 3 feature maps (reference detection.py contract); "
                "pass explicit min_sizes/max_sizes for fewer maps")
        # reference ratio schedule between min_ratio and max_ratio (%)
        min_sizes, max_sizes = [], []
        step = int((max_ratio - min_ratio) / (n_maps - 2))
        for r in range(min_ratio, max_ratio + 1, step or 1):
            min_sizes.append(base_size * r / 100.0)
            max_sizes.append(base_size * (r + step) / 100.0)
        min_sizes = [base_size * 0.10] + min_sizes[:n_maps - 1]
        max_sizes = [base_size * 0.20] + max_sizes[:n_maps - 1]
    locs, confs, priors, vars_ = [], [], [], []
    for i, feat in enumerate(inputs):
        mins = min_sizes[i]
        maxs = max_sizes[i] if max_sizes else None
        ar = aspect_ratios[i] if isinstance(aspect_ratios[0],
                                            (list, tuple)) else aspect_ratios
        if steps:
            st = steps[i]
        elif step_w or step_h:
            st = ((step_w[i] if step_w else 0.0),
                  (step_h[i] if step_h else 0.0))
        else:
            st = (0.0, 0.0)
        box, var = prior_box(feat, image,
                             mins if isinstance(mins, (list, tuple))
                             else [mins],
                             [maxs] if maxs else None, ar, variance, flip,
                             clip, st if isinstance(st, (list, tuple))
                             else (st, st), offset)
        box = _nn.reshape(box, [-1, 4])
        var = _nn.reshape(var, [-1, 4])
        A = int(box.shape[0]) // (int(feat.shape[2]) * int(feat.shape[3]))
        loc = _nn.conv2d(feat, A * 4, kernel_size, padding=pad, stride=stride)
        conf = _nn.conv2d(feat, A * num_classes, kernel_size, padding=pad,
                          stride=stride)
        # [N, A*4, H, W] -> [N, H*W*A, 4]
        loc = _nn.reshape(_nn.transpose(loc, [0, 2, 3, 1]), [0, -1, 4])
        conf = _nn.reshape(_nn.transpose(conf, [0, 2, 3, 1]),
                           [0, -1, num_classes])
        locs.append(loc)
        confs.append(conf)
        priors.append(box)
        vars_.append(var)
    from .tensor import concat as _concat
    mbox_locs = _concat(locs, axis=1)
    mbox_confs = _concat(confs, axis=1)
    boxes = _concat(priors, axis=0)
    variances = _concat(vars_, axis=0)
    return mbox_locs, mbox_confs, boxes, variances



def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes, im_info,
                             batch_size_per_im=256, fg_fraction=0.25,
                             fg_thresh=0.25, bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=None, use_random=True,
                             is_cls_agnostic=False, is_cascade_rcnn=False,
                             rpn_rois_num=None, name=None):
    """Reference detection.py:generate_proposal_labels (second-stage target
    assignment). Fixed-shape form: all R+G rows kept with ClsWeights
    carrying the sampled fg/bg proportions (use_random accepted and
    ignored); returns a 7-tuple — the reference's 5 outputs plus the
    per-roi classification weights and MatchedGt (the labeler's own
    argmax-IoU gt index, for mask-target generation).

    rpn_rois [N,R,4]; gt_classes [N,G]; is_crowd [N,G] or None;
    gt_boxes [N,G,4]; im_info [N,3]; rpn_rois_num [N] masks proposal
    padding rows (pass generate_proposals' RpnRoisNum).
    """
    if is_cls_agnostic or is_cascade_rcnn:
        raise NotImplementedError(
            "generate_proposal_labels: is_cls_agnostic / is_cascade_rcnn "
            "modes are not built (class-specific targets with gts appended "
            "only); see SCOPE.md detection row")
    helper = LayerHelper("generate_proposal_labels", name=name)
    C = int(class_nums or 81)
    rois = _out(helper, rpn_rois.dtype, stop_gradient=True)
    labels = _out(helper, "int32", stop_gradient=True)
    cls_w = _out(helper, "float32", stop_gradient=True)
    tgt = _out(helper, "float32", stop_gradient=True)
    inw = _out(helper, "float32", stop_gradient=True)
    outw = _out(helper, "float32", stop_gradient=True)
    matched = _out(helper, "int32", stop_gradient=True)
    inputs = {"RpnRois": [rpn_rois], "GtClasses": [gt_classes],
              "GtBoxes": [gt_boxes], "ImInfo": [im_info]}
    if is_crowd is not None:
        inputs["IsCrowd"] = [is_crowd]
    if rpn_rois_num is not None:
        inputs["RpnRoisNum"] = [rpn_rois_num]
    helper.append_op("generate_proposal_labels", inputs=inputs,
                     outputs={"Rois": [rois], "LabelsInt32": [labels],
                              "ClsWeights": [cls_w], "BboxTargets": [tgt],
                              "BboxInsideWeights": [inw],
                              "BboxOutsideWeights": [outw],
                              "MatchedGt": [matched]},
                     attrs={"batch_size_per_im": int(batch_size_per_im),
                            "fg_fraction": float(fg_fraction),
                            "fg_thresh": float(fg_thresh),
                            "bg_thresh_hi": float(bg_thresh_hi),
                            "bg_thresh_lo": float(bg_thresh_lo),
                            "bbox_reg_weights": [float(w)
                                                 for w in bbox_reg_weights],
                            "class_nums": C})
    blk = helper.main_program.current_block()
    return (blk.var(rois.name), blk.var(labels.name), blk.var(tgt.name),
            blk.var(inw.name), blk.var(outw.name), blk.var(cls_w.name),
            blk.var(matched.name))


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level,
                          post_nms_top_n, name=None):
    """Reference detection.py:collect_fpn_proposals. Fixed-shape outputs:
    (rois [N, post_nms_top_n, 4], rois_num [N]); zero-score rows are level
    padding and excluded from the counts."""
    helper = LayerHelper("collect_fpn_proposals", name=name)
    rois = _out(helper, multi_rois[0].dtype, stop_gradient=True)
    num = _out(helper, "int64", stop_gradient=True)
    helper.append_op("collect_fpn_proposals",
                     inputs={"MultiLevelRois": list(multi_rois),
                             "MultiLevelScores": list(multi_scores)},
                     outputs={"FpnRois": [rois], "RoisNum": [num]},
                     attrs={"post_nms_topN": int(post_nms_top_n)})
    blk = helper.main_program.current_block()
    return blk.var(rois.name), blk.var(num.name)


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, rois_num=None, name=None):
    """Reference detection.py:distribute_fpn_proposals. Fixed-shape
    form: returns the per-roi LEVEL INDEX [N, R] int32 instead of ragged
    per-level tensors + restore index — run the (static) per-level compute
    and select rows by level (see models/mask_rcnn.py for the pattern)."""
    helper = LayerHelper("distribute_fpn_proposals", name=name)
    lvl = _out(helper, "int32", stop_gradient=True)
    helper.append_op("distribute_fpn_proposals",
                     inputs={"FpnRois": [fpn_rois]},
                     outputs={"RoisLevel": [lvl]},
                     attrs={"min_level": int(min_level),
                            "max_level": int(max_level),
                            "refer_level": int(refer_level),
                            "refer_scale": int(refer_scale)})
    return helper.main_program.current_block().var(lvl.name)


def generate_mask_targets(rois, gt_masks, matched_gt, fg_mask, im_shape,
                          resolution=28, name=None):
    """Mask-head training targets (reference generate_mask_labels analog):
    crop each fg roi's matched gt bitmap and resize to resolution^2 {0,1}.
    rois [N,R,4]; gt_masks [N,G,Hm,Wm]; matched_gt [N,R] int32;
    fg_mask [N,R]; im_shape (h, w) of the canvas the bitmaps cover."""
    helper = LayerHelper("generate_mask_targets", name=name)
    out = _out(helper, "float32", stop_gradient=True)
    helper.append_op("generate_mask_targets",
                     inputs={"Rois": [rois], "GtMasks": [gt_masks],
                             "MatchedGt": [matched_gt], "FgMask": [fg_mask]},
                     outputs={"MaskTargets": [out]},
                     attrs={"resolution": int(resolution),
                            "im_shape": [float(im_shape[0]),
                                         float(im_shape[1])]})
    return helper.main_program.current_block().var(out.name)


def retinanet_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                            gt_boxes, gt_labels, is_crowd=None, im_info=None,
                            num_classes=1, positive_overlap=0.5,
                            negative_overlap=0.4, name=None):
    """Reference detection.py:retinanet_target_assign. Fixed-shape form
    (all anchors kept, +/-1/0 labels instead of sampling): returns
    (score_pred [M, C], loc_pred [M, 4], score_target [M, 1] int32,
    loc_target [M, 4], bbox_inside_weight [M, 4], fg_num [1]).

    Ignore rows (-1) have their logits zero-masked (zero GRADIENT through
    the focal loss) and their labels forced to 0; the resulting constant
    bg-at-sigmoid(0) term has no parameter gradient — the shape-stable
    equivalent of the reference's sampled gather.
    """
    from . import nn as _nn
    from . import tensor as _tensor
    from .control_flow import equal, greater_than
    from .extras import logical_not
    helper = LayerHelper("retinanet_target_assign", name=name)
    labels = _out(helper, "int32", stop_gradient=True)
    matched = _out(helper, "int32", stop_gradient=True)
    tgt = _out(helper, anchor_box.dtype, stop_gradient=True)
    fg_num = _out(helper, "int32", stop_gradient=True)
    inputs = {"Anchor": [anchor_box], "GtBoxes": [gt_boxes],
              "GtLabels": [gt_labels]}
    if is_crowd is not None:
        inputs["IsCrowd"] = [is_crowd]
    if im_info is not None:
        inputs["ImInfo"] = [im_info]
    helper.append_op("retinanet_target_assign", inputs=inputs,
                     outputs={"Labels": [labels], "MatchedGt": [matched],
                              "BboxTargets": [tgt], "FgNum": [fg_num]},
                     attrs={"positive_overlap": float(positive_overlap),
                            "negative_overlap": float(negative_overlap)})
    blk = helper.main_program.current_block()
    labels, tgt = blk.var(labels.name), blk.var(tgt.name)
    minus1 = _tensor.fill_constant([1], "int32", -1)
    valid = _tensor.cast(logical_not(equal(labels, minus1)), "float32")
    valid_col = _nn.reshape(valid, [-1, 1])
    score_pred = _nn.elementwise_mul(cls_logits, valid_col)
    score_target = _nn.reshape(
        _tensor.cast(_nn.elementwise_mul(
            _tensor.cast(labels, "float32"), valid), "int32"), [-1, 1])
    pos = _tensor.cast(
        greater_than(labels, _tensor.fill_constant([1], "int32", 0)),
        "float32")
    inside_w = _nn.expand(_nn.reshape(pos, [-1, 1]), [1, 4])
    return (score_pred, bbox_pred, score_target, tgt, inside_w,
            blk.var(fg_num.name))
