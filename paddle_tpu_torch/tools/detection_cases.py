"""Detection and vision op cases: seeded numpy inputs and attrs for each of
the 24 detection op types (``ops/detection_ops.py``) and the five nn ones
(the resize family and ``conv2d_transpose``, ``ops/nn_ops.py``), with the
tolerance each is held to. ``tests/test_torch_detection_ops.py`` holds the
port against the JAX package on them, and ``chip_smoke.py``'s detection
phase holds the card against the CPU port on them.

``CASES``: id -> (op type, inputs, attrs, tolerance). Tolerances:
- ``EXACT``: integer outputs (labels, indices, counts, levels, matches), and
  every output of an op whose values are selected, not computed
  (``multiclass_nms``: its ``Index``, ``NmsRoisNum`` and rows, which are the
  input scores and boxes);
- ``BOX`` (``rtol 1e-6, atol 1e-6``): f32 box arithmetic, the same
  operations in the same order (``log`` / ``exp`` may round an ulp apart);
- ``SUM`` (``rtol 1e-5, atol 1e-5``): ``yolov3_loss`` and ``roi_align``
  (per-image and per-bin sums in another order), the resize contractions
  and ``conv2d_transpose`` (products summed in another order);
- ``FOCAL`` (``rtol 1e-5, atol 1e-6``): ``sigmoid_focal_loss`` (its pow and
  log-sigmoid).
"""
import numpy as np

EXACT = dict(rtol=0, atol=0)
BOX = dict(rtol=1e-6, atol=1e-6)
SUM = dict(rtol=1e-5, atol=1e-5)
FOCAL = dict(rtol=1e-5, atol=1e-6)


def _rng(seed):
    return np.random.RandomState(seed)


def _boxes(rng, *lead, lo=0.0, span=60.0, size=(4.0, 30.0)):
    """xyxy boxes with positive width and height."""
    ctr = rng.uniform(lo, lo + span, lead + (2,))
    wh = rng.uniform(size[0], size[1], lead + (2,))
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype("float32")


def nms_inputs(seed, N=2, M=24, C=4, ties=False):
    rng = _rng(seed)
    boxes = _boxes(rng, N, M)
    if ties:
        # scores on a coarse grid (many equal values), some rows copied so
        # equal boxes carry equal scores, and a block at exactly the threshold
        scores = rng.randint(0, 5, (N, C, M)).astype("float32") / 4
        boxes[:, 5:9] = boxes[:, 0:4]
        scores[:, :, 12:16] = 0.25
    else:
        scores = rng.rand(N, C, M).astype("float32")
    return {"BBoxes": [boxes], "Scores": [scores]}


def nms_attrs(**kw):
    a = dict(score_threshold=0.25, nms_top_k=16, keep_top_k=12, nms_threshold=0.4,
             normalized=True, nms_eta=1.0, background_label=0)
    a.update(kw)
    return a


def _yolo_gt(seed, N=2, B=6, H=8, W=8):
    """gt boxes (cx, cy, w, h) normalized: rows 0-2 real, 3.. padded (w*h =
    0); row 1 shares row 0's cell (and shape, so the same anchor slot)."""
    rng = _rng(seed)
    gt = np.zeros((N, B, 4), "float32")
    gt[:, :3, :2] = rng.uniform(0.1, 0.9, (N, 3, 2))
    gt[:, :3, 2:] = rng.uniform(0.05, 0.6, (N, 3, 2))
    gt[:, 1, :2] = gt[:, 0, :2] + 0.2 / max(H, W)
    gt[:, 1, 2:] = gt[:, 0, 2:] * 1.01
    labels = rng.randint(0, 5, (N, B)).astype("int32")
    return gt, labels


YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90, 156, 198, 373, 326]


def _yolo_loss_case(seed, smooth=False, score=False, mask=(6, 7, 8), down=32, hw=4):
    rng = _rng(seed)
    C = 5
    x = (rng.randn(2, 3 * (5 + C), hw, hw) * 1.5).astype("float32")
    gt, labels = _yolo_gt(seed + 1, H=hw, W=hw)
    gt[:, 0, 2:] = [[0.5, 0.45], [0.8, 0.7]]   # large: owned by a coarse-head anchor
    gt[:, 1, 2:] = gt[:, 0, 2:] * 1.01
    ins = {"X": [x], "GTBox": [gt], "GTLabel": [labels]}
    if score:
        ins["GTScore"] = [rng.uniform(0.3, 1.0, labels.shape).astype("float32")]
    attrs = dict(anchors=YOLO_ANCHORS, anchor_mask=list(mask), class_num=C,
                 ignore_thresh=0.5, downsample_ratio=down, use_label_smooth=smooth)
    return "yolov3_loss", ins, attrs, SUM


def _roi_inputs(seed, N=2, R=5, H=12, W=12, C=3):
    rng = _rng(seed)
    x = rng.randn(N, C, H, W).astype("float32")
    rois = _boxes(rng, R, lo=1.0, span=8.0 * 4, size=(4.0, 20.0))
    return {"X": [x], "ROIs": [rois], "RoisNum": [np.array([2, R - 2], "int32")]}


def _proposal_inputs(seed, N=2, A=2, H=4, W=4):
    rng = _rng(seed)
    scores = rng.rand(N, A, H, W).astype("float32")
    deltas = (rng.randn(N, 4 * A, H, W) * 0.3).astype("float32")
    ctr = (np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1) + 0.5) * 16.0
    sizes = np.array([[16.0, 16.0], [32.0, 24.0]], "float32")
    anchors = np.concatenate([ctr[:, :, None, :] - sizes / 2,
                              ctr[:, :, None, :] + sizes / 2], -1).astype("float32")
    var = np.ones_like(anchors)
    im_info = np.array([[64, 64, 1.0], [60, 56, 1.5]], "float32")
    return {"Scores": [scores], "BboxDeltas": [deltas], "ImInfo": [im_info],
            "Anchors": [anchors], "Variances": [var]}


def _anchor_assign_inputs(seed, retina=False):
    rng = _rng(seed)
    anchors = _boxes(rng, 30, lo=0.0, span=64.0, size=(8.0, 24.0))
    anchors[3] = [-4, 2, 20, 20]                       # straddles the image
    gt = _boxes(rng, 4, lo=10.0, span=40.0, size=(10.0, 26.0))
    gt[1] = anchors[7]                                 # an exact match
    gt[3] = 0                                          # padding (retinanet)
    ins = {"Anchor": [anchors], "GtBoxes": [gt],
           "IsCrowd": [np.array([0, 0, 1, 0], "int32")],
           "ImInfo": [np.array([[64, 64, 1.0]], "float32")]}
    if retina:
        ins["GtLabels"] = [np.array([2, 5, 1, 3], "int32")]
    return ins


def _proposal_label_inputs(seed):
    rng = _rng(seed)
    rois = _boxes(rng, 2, 8, lo=4.0, span=50.0, size=(6.0, 24.0))
    gt = _boxes(rng, 2, 3, lo=8.0, span=40.0, size=(10.0, 24.0))
    rois[:, 0] = gt[:, 0]
    rois[:, 1] = gt[:, 1] + 1.0
    gt[1, 2] = 0                                       # a padded gt
    return {"RpnRois": [rois], "GtClasses": [rng.randint(1, 5, (2, 3)).astype("int32")],
            "IsCrowd": [np.array([[0, 1, 0], [0, 0, 0]], "int32")], "GtBoxes": [gt],
            "ImInfo": [np.array([[64, 64, 1.0]] * 2, "float32")],
            "RpnRoisNum": [np.array([8, 5], "int64")]}


def _mask_target_inputs(seed):
    rng = _rng(seed)
    masks = (rng.rand(2, 3, 16, 16) > 0.5).astype("float32")
    masks[0, 0, 4:12, 2:10] = 1
    rois = _boxes(rng, 2, 4, lo=4.0, span=24.0, size=(6.0, 20.0))
    return {"Rois": [rois], "GtMasks": [masks],
            "MatchedGt": [rng.randint(0, 3, (2, 4)).astype("int32")],
            "FgMask": [np.array([[1, 0, 1, 1], [1, 1, 0, 1]], "float32")]}


def randn(*shape, seed=0):
    return _rng(seed).randn(*shape).astype("float32")


def _dist(seed, G=4, M=7):
    d = _rng(seed).rand(G, M).astype("float32")
    d[d < 0.3] = 0.0
    d[2, 3] = d[0, 3]                                  # a tie across rows
    return d


# id -> (op type, inputs, attrs, tolerance)
CASES = {
    "iou_similarity": ("iou_similarity", {"X": [_boxes(_rng(0), 5)], "Y": [_boxes(_rng(1), 7)]},
                       {}, BOX),
    "box_coder-encode": ("box_coder", {"PriorBox": [_boxes(_rng(2), 6)],
                                       "PriorBoxVar": [np.full((6, 4), 0.2, "float32")],
                                       "TargetBox": [_boxes(_rng(3), 6)]},
                         {"code_type": "encode_center_size"}, BOX),
    "box_coder-decode": ("box_coder", {"PriorBox": [_boxes(_rng(4), 6)],
                                       "TargetBox": [(_rng(5).randn(2, 6, 4) * 0.3)
                                                     .astype("float32")]},
                         {"code_type": "decode_center_size", "variance": [0.1, 0.1, 0.2, 0.2]},
                         BOX),
    "prior_box": ("prior_box", {"Input": [randn(1, 2, 4, 5)], "Image": [randn(1, 3, 32, 40)]},
                  {"min_sizes": [8.0, 16.0], "max_sizes": [12.0, 24.0],
                   "aspect_ratios": [1.0, 2.0], "variances": [0.1, 0.1, 0.2, 0.2],
                   "flip": True, "clip": True, "step_w": 0.0, "step_h": 0.0, "offset": 0.5},
                  BOX),
    "yolo_box": ("yolo_box", {"X": [randn(2, 3 * 9, 4, 5, seed=6)],
                              "ImgSize": [np.array([[128, 160], [100, 120]], "int32")]},
                 {"anchors": [10, 13, 16, 30, 33, 23], "class_num": 4, "conf_thresh": 0.4,
                  "downsample_ratio": 32}, BOX),
    "multiclass_nms": ("multiclass_nms", nms_inputs(7), nms_attrs(), EXACT),
    "multiclass_nms-ties": ("multiclass_nms", nms_inputs(8, ties=True), nms_attrs(), EXACT),
    "multiclass_nms-ties-bg-1": ("multiclass_nms", nms_inputs(9, ties=True),
                                 nms_attrs(background_label=-1, keep_top_k=60), EXACT),
    "multiclass_nms-pixel": ("multiclass_nms", nms_inputs(10, ties=True),
                             nms_attrs(normalized=False, score_threshold=0.0), EXACT),
    "multiclass_nms-all-pads": ("multiclass_nms", nms_inputs(11, ties=True),
                                nms_attrs(score_threshold=2.0, keep_top_k=100), EXACT),
    "multiclass_nms2": ("multiclass_nms2", nms_inputs(12, ties=True),
                        nms_attrs(background_label=-1), EXACT),
    "roi_align": ("roi_align", _roi_inputs(13),
                  {"pooled_height": 2, "pooled_width": 3, "spatial_scale": 0.25,
                   "sampling_ratio": -1}, SUM),
    "roi_align-ratio3": ("roi_align", _roi_inputs(14),
                         {"pooled_height": 3, "pooled_width": 3, "spatial_scale": 0.5,
                          "sampling_ratio": 3}, SUM),
    "roi_pool": ("roi_pool", _roi_inputs(15),
                 {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 0.25}, EXACT),
    "anchor_generator": ("anchor_generator", {"Input": [randn(1, 2, 3, 4)]},
                         {"anchor_sizes": [32.0, 64.0], "aspect_ratios": [0.5, 1.0, 2.0],
                          "variances": [0.1, 0.1, 0.2, 0.2], "stride": [16.0, 16.0],
                          "offset": 0.5}, BOX),
    "box_clip": ("box_clip", {"Input": [_boxes(_rng(16), 2, 5, lo=-10, span=90)],
                              "ImInfo": [np.array([[64, 60, 1.0], [90, 80, 1.5]], "float32")]},
                 {}, BOX),
    "box_clip-flat": ("box_clip", {"Input": [_boxes(_rng(17), 5, lo=-10, span=90)],
                                   "ImInfo": [np.array([[64, 60, 2.0]], "float32")]}, {}, BOX),
    "bipartite_match": ("bipartite_match", {"DistMat": [_dist(18)]},
                        {"match_type": "bipartite"}, EXACT),
    "bipartite_match-per_prediction": ("bipartite_match", {"DistMat": [_dist(19)]},
                                       {"match_type": "per_prediction", "dist_threshold": 0.5},
                                       EXACT),
    "target_assign": ("target_assign",
                      {"X": [randn(4, 3, seed=20)],
                       "MatchIndices": [np.array([[-1, 2, 0, -1, 3, 3, -1]], "int32")]},
                      {"mismatch_value": 7.0}, EXACT),
    "sigmoid_focal_loss": ("sigmoid_focal_loss",
                           {"X": [randn(6, 4, seed=21)],
                            "Label": [np.array([[0], [1], [4], [2], [0], [3]], "int32")],
                            "FgNum": [np.array([4], "int32")]},
                           {"gamma": 2.0, "alpha": 0.25}, FOCAL),
    "generate_proposals": ("generate_proposals", _proposal_inputs(22),
                           {"pre_nms_topN": 20, "post_nms_topN": 12, "nms_thresh": 0.5,
                            "min_size": 4.0}, BOX),
    "generate_proposals-short": ("generate_proposals", _proposal_inputs(23),
                                 {"pre_nms_topN": 6, "post_nms_topN": 10, "nms_thresh": 0.3,
                                  "min_size": 2.0}, BOX),
    "rpn_target_assign": ("rpn_target_assign", _anchor_assign_inputs(24),
                          {"rpn_positive_overlap": 0.5, "rpn_negative_overlap": 0.3,
                           "rpn_straddle_thresh": 0.0}, BOX),
    "yolov3_loss": _yolo_loss_case(25),
    "yolov3_loss-label-smooth": _yolo_loss_case(26, smooth=True, score=True),
    "yolov3_loss-fine-head": _yolo_loss_case(27, mask=(0, 1, 2), down=8, hw=8),
    "box_decoder_and_assign": ("box_decoder_and_assign",
                               {"PriorBox": [_boxes(_rng(28), 6)],
                                "PriorBoxVar": [np.full((6, 4), 0.1, "float32")],
                                "TargetBox": [(_rng(29).randn(6, 12) * 0.5).astype("float32")],
                                "BoxScore": [_rng(30).rand(6, 3).astype("float32")]},
                               {"box_clip": 4.135}, BOX),
    "polygon_box_transform": ("polygon_box_transform", {"Input": [randn(2, 4, 3, 5, seed=31)]},
                              {}, EXACT),
    "generate_proposal_labels": ("generate_proposal_labels", _proposal_label_inputs(32),
                                 {"batch_size_per_im": 8, "fg_fraction": 0.25,
                                  "fg_thresh": 0.5, "bg_thresh_hi": 0.5, "bg_thresh_lo": 0.0,
                                  "bbox_reg_weights": [0.1, 0.1, 0.2, 0.2], "class_nums": 5},
                                 BOX),
    "distribute_fpn_proposals": ("distribute_fpn_proposals",
                                 {"FpnRois": [_boxes(_rng(33), 2, 9, lo=0.0, span=200.0,
                                                     size=(4.0, 180.0))]},
                                 {"min_level": 2, "max_level": 5, "refer_level": 4,
                                  "refer_scale": 56}, EXACT),
    "generate_mask_targets": ("generate_mask_targets", _mask_target_inputs(34),
                              {"resolution": 6, "im_shape": [32.0, 32.0]}, EXACT),
    "generate_mask_labels": ("generate_mask_labels", _mask_target_inputs(35),
                             {"resolution": 5, "im_shape": [32.0, 32.0]}, EXACT),
    "collect_fpn_proposals": ("collect_fpn_proposals",
                              {"MultiLevelRois": [_boxes(_rng(36), 2, 5), _boxes(_rng(37), 2, 4)],
                               "MultiLevelScores": [
                                   np.concatenate([_rng(38).rand(2, 3, 1),
                                                   np.zeros((2, 2, 1))], 1).astype("float32"),
                                   _rng(39).rand(2, 4, 1).astype("float32")]},
                              {"post_nms_topN": 12}, EXACT),
    "retinanet_target_assign": ("retinanet_target_assign", _anchor_assign_inputs(40, True),
                                {"positive_overlap": 0.5, "negative_overlap": 0.4}, BOX),
    # the five nn op types: resize at 2x, 3/2x and 1/3x (the antialias)
    **{f"interpolate-{m}-{tag}": ("interpolate", {"X": [randn(2, 3, 6, 9, seed=41)]},
                                  dict(interp_method=m, **sz), SUM)
       for m in ("nearest", "bilinear", "bicubic")
       for tag, sz in (("2x", {"scale": 2.0}), ("3-2x", {"out_h": 9, "out_w": 13}),
                       ("1-3x", {"out_h": 2, "out_w": 3}))},
    "nearest_interp": ("nearest_interp", {"X": [randn(1, 2, 5, 4, seed=42)]},
                       {"out_h": 7, "out_w": 10}, EXACT),
    "bilinear_interp": ("bilinear_interp", {"X": [randn(1, 2, 5, 4, seed=43)]},
                        {"out_h": 3, "out_w": 7}, SUM),
    "trilinear_interp": ("trilinear_interp", {"X": [randn(1, 2, 4, 5, 6, seed=44)]},
                         {"out_d": 6, "out_h": 3, "out_w": 9}, SUM),
    "conv2d_transpose-k4s2p1": ("conv2d_transpose",
                                {"Input": [randn(2, 4, 5, 5, seed=45)],
                                 "Filter": [randn(4, 3, 4, 4, seed=46)]},
                                {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
                                 "groups": 1}, SUM),
    "conv2d_transpose-groups2": ("conv2d_transpose",
                                 {"Input": [randn(1, 4, 4, 6, seed=47)],
                                  "Filter": [randn(4, 3, 3, 3, seed=48)]},
                                 {"strides": [2, 1], "paddings": [0, 2], "dilations": [2, 1],
                                  "groups": 2}, SUM),
}

DETECTION_TYPES = {
    "iou_similarity", "box_coder", "prior_box", "yolo_box", "multiclass_nms", "roi_align",
    "roi_pool", "anchor_generator", "box_clip", "bipartite_match", "target_assign",
    "sigmoid_focal_loss", "generate_proposals", "rpn_target_assign", "yolov3_loss",
    "box_decoder_and_assign", "polygon_box_transform", "generate_proposal_labels",
    "distribute_fpn_proposals", "generate_mask_targets", "collect_fpn_proposals",
    "retinanet_target_assign", "multiclass_nms2", "generate_mask_labels"}
NN_TYPES = {"interpolate", "nearest_interp", "bilinear_interp", "trilinear_interp",
            "conv2d_transpose"}
