"""Detection ops (the port's copy of ``paddle_tpu/ops/detection_ops.py``).

The 22 op types of the JAX package's fixed-shape forms, plus its aliases
``multiclass_nms2`` and ``generate_mask_labels``: the box family
(``box_coder``, ``prior_box``, ``yolo_box``, ``iou_similarity``,
``box_clip``, ``anchor_generator``, ``box_decoder_and_assign``,
``polygon_box_transform``), the NMS family (``multiclass_nms`` with the kept
boxes' ``Index``), the RoI ops (``roi_align``, ``roi_pool``,
``collect_fpn_proposals``, ``distribute_fpn_proposals``), the proposal and
target machinery (``generate_proposals``, ``rpn_target_assign``,
``generate_proposal_labels``, ``generate_mask_targets``,
``retinanet_target_assign``, ``target_assign``, ``bipartite_match``) and
``sigmoid_focal_loss`` and ``yolov3_loss``.

Every lowering is fixed-shape and reads no value on the host, so a captured
step or a ``Predictor`` graph holds it: a ragged result is a padded one with
a count or a validity mask, as in the JAX package. A JAX ``vmap`` over
images or classes is a batch dimension here. Every ``jax.lax.top_k`` is
``top_k_lower_first`` (ties to the lower index, as JAX ranks them), and
every ``argmax`` takes the first maximum, in both packages. The greedy NMS
sweep (``_nms_sweep``) is a loop of K steps over a ``[..., K]`` boolean
state, the pairwise overlaps computed once before it; ``multiclass_nms``
and ``generate_proposals`` share it. Constants made from attrs (anchors,
variances) go to the card once per device (``_const``, through
``basic.device_constant``), outside any CUDA-graph capture.

Scatter-adds: ``yolov3_loss`` builds its target grids with ``index_add_`` on
zero grids, masked as the JAX ``.at[].add`` is; the grids carry no
gradient. The gradients of ``roi_align`` and ``roi_pool`` are scatter-adds
of their gathers, so on the card their order of accumulation is not fixed.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.registry import register
from .basic import device_constant
from .tensor_ops import top_k_lower_first

_NEG_INF = float("-inf")

def _const(values, device, dtype=torch.float32):
    """A constant tensor of ``values`` (converted through numpy as the JAX
    package's ``jnp.asarray(np.asarray(values, dtype))``) on ``device``."""
    arr = np.asarray(values, dtype=str(dtype).replace("torch.", ""))
    return device_constant(("const", arr.tobytes(), arr.shape, str(dtype)), device,
                           lambda: torch.from_numpy(arr.copy()))


def _iou_matrix(a, b, norm=0.0):
    """[..., N, 4] x [..., M, 4] xyxy -> [..., N, M] IoU. ``norm`` 1.0 is the
    reference's pixel-coordinate +1 convention (normalized=False boxes)."""
    def area(z):
        return (torch.clamp_min(z[..., 2] - z[..., 0] + norm, 0) *
                torch.clamp_min(z[..., 3] - z[..., 1] + norm, 0))
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp_min(rb - lt + norm, 0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area(a)[..., :, None] + area(b)[..., None, :] - inter + 1e-10)


def _clip(x, lo, hi):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, bounds tensors or numbers."""
    x = torch.clamp_min(x, lo) if not isinstance(lo, torch.Tensor) else torch.maximum(x, lo)
    return torch.clamp_max(x, hi) if not isinstance(hi, torch.Tensor) else torch.minimum(x, hi)


def _gather_rows(x, idx):
    """``x[..., idx, :]`` batched: x [..., M, D], idx [..., K] -> [..., K, D]."""
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _nms_sweep(over, valid=None):
    """The greedy NMS sweep of the JAX ``lax.scan``: ``over`` [..., K, K] is
    "candidate i overlaps candidate j above the threshold" for candidates in
    descending score order; candidate i is kept iff no kept j < i overlaps it
    (and ``valid[..., i]``, when given). K steps over a [..., K] boolean
    state; j >= i is never kept yet at step i, so the JAX ``j < i`` mask is
    implied."""
    K = over.shape[-1]
    kept = torch.zeros(over.shape[:-1], dtype=torch.bool, device=over.device)
    for i in range(K):
        hit = torch.any(over[..., i, :] & kept, dim=-1)
        if valid is None:
            torch.logical_not(hit, out=kept[..., i])
        else:
            torch.logical_and(torch.logical_not(hit), valid[..., i], out=kept[..., i])
    return kept


@register("iou_similarity", grad=None)
def iou_similarity(ctx, ins):
    return {"Out": [_iou_matrix(ins["X"][0], ins["Y"][0])]}


def _encode_deltas(prior, gt, gt_norm=0.0):
    """Center-form box deltas t such that decoding t against ``prior``
    reproduces ``gt`` (the JAX package's shared encode; [..., 4] boxes)."""
    pw = torch.clamp_min(prior[..., 2] - prior[..., 0], 1e-6)
    ph = torch.clamp_min(prior[..., 3] - prior[..., 1], 1e-6)
    pcx = prior[..., 0] + 0.5 * pw
    pcy = prior[..., 1] + 0.5 * ph
    gw = torch.clamp_min(gt[..., 2] - gt[..., 0] + gt_norm, 1e-6)
    gh = torch.clamp_min(gt[..., 3] - gt[..., 1] + gt_norm, 1e-6)
    gcx = gt[..., 0] + 0.5 * gw
    gcy = gt[..., 1] + 0.5 * gh
    return torch.stack([(gcx - pcx) / pw, (gcy - pcy) / ph,
                        torch.log(gw / pw), torch.log(gh / ph)], -1)


@register("box_coder", grad=None)
def box_coder(ctx, ins):
    """box_coder_op.cc: encode divides the center-size offsets by the prior
    variances; decode multiplies them back (PriorBoxVar [M,4] input or the
    4-float ``variance`` attr; absent -> ones)."""
    prior = ins["PriorBox"][0]
    target = ins["TargetBox"][0]
    pv = ins.get("PriorBoxVar", [None])[0]
    if pv is None:
        var_attr = ctx.attr("variance", None)
        pv = _const([list(var_attr)], ctx.device) if var_attr else None
    code_type = ctx.attr("code_type", "encode_center_size")
    pw = prior[:, 2] - prior[:, 0]
    ph = prior[:, 3] - prior[:, 1]
    pcx = prior[:, 0] + 0.5 * pw
    pcy = prior[:, 1] + 0.5 * ph
    if code_type == "encode_center_size":
        tw = target[:, 2] - target[:, 0]
        th = target[:, 3] - target[:, 1]
        tcx = target[:, 0] + 0.5 * tw
        tcy = target[:, 1] + 0.5 * th
        out = torch.stack([(tcx - pcx) / pw, (tcy - pcy) / ph,
                           torch.log(tw / pw), torch.log(th / ph)], 1)
        if pv is not None:
            out = out / pv
    else:
        t = target.reshape(-1, prior.shape[0], 4)
        if pv is not None:
            t = t * pv[None] if pv.ndim == 2 else t * pv
        ocx = pcx + t[..., 0] * pw
        ocy = pcy + t[..., 1] * ph
        ow = torch.exp(t[..., 2]) * pw
        oh = torch.exp(t[..., 3]) * ph
        out = torch.stack([ocx - 0.5 * ow, ocy - 0.5 * oh,
                           ocx + 0.5 * ow, ocy + 0.5 * oh], -1)
    return {"OutputBox": [out]}


@register("prior_box", grad=None)
def prior_box(ctx, ins):
    x, img = ins["Input"][0], ins["Image"][0]
    min_sizes = ctx.attr("min_sizes", [])
    max_sizes = ctx.attr("max_sizes", [])
    ars = ctx.attr("aspect_ratios", [1.0])
    flip = ctx.attr("flip", False)
    offset = ctx.attr("offset", 0.5)
    H, W = x.shape[2], x.shape[3]
    IH, IW = img.shape[2], img.shape[3]
    sw = ctx.attr("step_w", 0.0) or IW / W
    sh = ctx.attr("step_h", 0.0) or IH / H
    full_ars = []
    for ar in ars:
        full_ars.append(ar)
        if flip and ar != 1.0:
            full_ars.append(1.0 / ar)
    boxes = []
    for ms in min_sizes:
        sizes = [(ms, ms)]
        for ar in full_ars:
            if ar == 1.0:
                continue
            sizes.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
        if max_sizes:
            mx = max_sizes[min_sizes.index(ms)]
            sizes.insert(1, (np.sqrt(ms * mx), np.sqrt(ms * mx)))
        boxes.extend(sizes)
    dev = ctx.device
    cx = (torch.arange(W, device=dev) + offset) * sw
    cy = (torch.arange(H, device=dev) + offset) * sh
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    out = [torch.stack([(cxg - bw / 2) / IW, (cyg - bh / 2) / IH,
                        (cxg + bw / 2) / IW, (cyg + bh / 2) / IH], -1) for bw, bh in boxes]
    priors = torch.stack(out, 2)                          # [H, W, nb, 4]
    if ctx.attr("clip", False):
        priors = torch.clamp(priors, 0.0, 1.0)
    var = _const(ctx.attr("variances", [0.1, 0.1, 0.2, 0.2]), dev)
    return {"Boxes": [priors], "Variances": [var.expand(priors.shape)]}


@register("yolo_box", grad=None)
def yolo_box(ctx, ins):
    x = ins["X"][0]                                       # [N, an*(5+cls), H, W]
    imgsize = ins["ImgSize"][0]
    anchors = ctx.attr("anchors", [])
    class_num = ctx.attr("class_num")
    conf_thresh = ctx.attr("conf_thresh", 0.01)
    downsample = ctx.attr("downsample_ratio", 32)
    n, c, h, w = x.shape
    na = len(anchors) // 2
    x = x.reshape(n, na, 5 + class_num, h, w)
    dev = ctx.device
    gx = (torch.arange(w, device=dev)[None, None, None, :] + torch.sigmoid(x[:, :, 0])) / w
    gy = (torch.arange(h, device=dev)[None, None, :, None] + torch.sigmoid(x[:, :, 1])) / h
    aw = _const(anchors[0::2], dev).reshape(1, na, 1, 1)
    ah = _const(anchors[1::2], dev).reshape(1, na, 1, 1)
    in_w, in_h = w * downsample, h * downsample
    bw = torch.exp(x[:, :, 2]) * aw / in_w
    bh = torch.exp(x[:, :, 3]) * ah / in_h
    conf = torch.sigmoid(x[:, :, 4])
    probs = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None]
    mask = (conf > conf_thresh).to(x.dtype)
    img_h = imgsize[:, 0].reshape(n, 1, 1, 1).to(x.dtype)
    img_w = imgsize[:, 1].reshape(n, 1, 1, 1).to(x.dtype)
    boxes = torch.stack([(gx - bw / 2) * img_w, (gy - bh / 2) * img_h,
                         (gx + bw / 2) * img_w, (gy + bh / 2) * img_h], -1)
    boxes = (boxes * mask[..., None]).reshape(n, -1, 4)
    scores = (probs * mask[:, :, None]).permute(0, 1, 3, 4, 2).reshape(n, -1, class_num)
    return {"Boxes": [boxes], "Scores": [scores]}


def _roi_batch_index(rois_num, R, device):
    """RoisNum [N] per-image counts -> per-ROI image index [R] (a
    ``searchsorted`` over their cumulative sum, right side)."""
    if rois_num is None:
        return torch.zeros((R,), dtype=torch.int64, device=device)
    ends = torch.cumsum(rois_num.reshape(-1).to(torch.int64), 0)
    return torch.searchsorted(ends, torch.arange(R, device=device), right=True)


@register("multiclass_nms", grad=None, nondiff_inputs=("BBoxes", "Scores"))
def multiclass_nms(ctx, ins):
    """Per-class NMS + cross-class top-k (multiclass_nms_op.cc).

    BBoxes [N, M, 4]; Scores [N, C, M]. Out: [N, keep_top_k, 6] (label,
    score, x1, y1, x2, y2) padded with label -1 rows, Index [N, keep_top_k]
    int64 (the kept boxes' rows of BBoxes, -1 padding) and NmsRoisNum [N].
    Images and classes are batch dimensions of one sweep (``_nms_sweep``);
    the background class is masked to -inf, not skipped. ``normalized``
    False applies the pixel +1 convention to the IoU; adaptive ``nms_eta``
    != 1 is not supported (raises, as the JAX package does)."""
    bboxes, scores = ins["BBoxes"][0], ins["Scores"][0]
    score_thresh = float(ctx.attr("score_threshold", 0.0))
    nms_thresh = float(ctx.attr("nms_threshold", 0.3))
    nms_top_k = int(ctx.attr("nms_top_k", 400))
    keep_top_k = int(ctx.attr("keep_top_k", 100))
    bg = int(ctx.attr("background_label", 0))
    norm = 0.0 if ctx.attr("normalized", True) else 1.0
    if float(ctx.attr("nms_eta", 1.0)) != 1.0:
        raise NotImplementedError(
            "multiclass_nms: adaptive nms_eta is not supported on the "
            "fixed-shape sweep; use nms_eta=1.0")
    N, C, M = scores.shape
    K = min(nms_top_k, M)
    sc = torch.where(scores > score_thresh, scores, _NEG_INF)
    top_scores, order = top_k_lower_first(sc, K)                    # [N, C, K]
    cand = _gather_rows(bboxes[:, None].expand(N, C, M, 4), order)  # [N, C, K, 4]
    keep = _nms_sweep(_iou_matrix(cand, cand, norm) > nms_thresh)
    cls_scores = torch.where(keep, top_scores, _NEG_INF)
    if 0 <= bg < C:     # -1: no background class (an index past C changes nothing)
        cls_scores[:, bg] = _NEG_INF
    flat_scores = cls_scores.reshape(N, C * K)
    flat_idx = order.reshape(N, C * K)
    Kk = min(keep_top_k, C * K)
    best, sel = top_k_lower_first(flat_scores, Kk)
    valid = best > _NEG_INF
    lab = torch.where(valid, torch.div(sel, K, rounding_mode="floor"), -1).to(torch.float32)
    src = torch.gather(flat_idx, 1, sel)
    index = torch.where(valid, src, -1)
    bx = _gather_rows(bboxes, src)
    row = torch.cat([lab[..., None], torch.where(valid, best, 0.0)[..., None],
                     torch.where(valid[..., None], bx, 0.0)], -1)
    if Kk < keep_top_k:
        pad = torch.zeros((N, keep_top_k - Kk, 6), dtype=row.dtype, device=row.device)
        pad[..., 0] = -1
        row = torch.cat([row, pad], 1)
        index = torch.cat([index, torch.full((N, keep_top_k - Kk), -1, dtype=index.dtype,
                                             device=index.device)], 1)
    return {"Out": [row], "Index": [index.to(torch.int64)],
            "NmsRoisNum": [valid.sum(-1).to(torch.int64)]}


def _bilinear_taps(s, size):
    """roi_align's per-axis sampling (roi_align_op.h border semantics): the
    in-range mask (-1 <= s <= size), the two clamped taps and the weight of
    the second."""
    v = ((s >= -1.0) & (s <= size))
    s = torch.clamp_min(s, 0.0)
    i0 = torch.clamp(torch.floor(s), 0, size - 1)
    i1 = torch.clamp(i0 + 1, 0, size - 1)
    wt = torch.clamp(s - i0, 0, 1)
    return v, i0.to(torch.int64), i1.to(torch.int64), wt


def _gather_nhwc(x, bidx, yy, xx):
    """x [N, C, H, W] sampled at (image bidx[r], row yy[r, i], column
    xx[r, j]) -> [R, Sy, Sx, C]."""
    return x[bidx[:, None, None], :, yy[:, :, None], xx[:, None, :]]


@register("roi_align", nondiff_inputs=("ROIs", "RoisNum"))
def roi_align(ctx, ins):
    """RoIAlign (detection/roi_align_op.cc): the bilinear-sampled mean of a
    fixed ``sampling_ratio`` grid per bin (2 when the attr is <= 0, the JAX
    package's fixed grid). ROIs [R, 4] xyxy in input coords; RoisNum [N]
    per-image counts. Differentiable wrt X (its gradient a scatter-add)."""
    x = ins["X"][0]
    rois = ins["ROIs"][0]
    ph = int(ctx.attr("pooled_height", 1))
    pw = int(ctx.attr("pooled_width", 1))
    spatial_scale = float(ctx.attr("spatial_scale", 1.0))
    ratio = int(ctx.attr("sampling_ratio", -1))
    if ratio <= 0:
        ratio = 2
    N, C, H, W = x.shape
    R = rois.shape[0]
    bidx = _roi_batch_index(ins.get("RoisNum", [None])[0], R, ctx.device)
    r = rois * spatial_scale
    x1, y1, x2, y2 = r[:, 0], r[:, 1], r[:, 2], r[:, 3]
    bw = torch.clamp_min(x2 - x1, 1.0) / pw
    bh = torch.clamp_min(y2 - y1, 1.0) / ph
    dev = ctx.device
    sy = y1[:, None] + (torch.arange(ph * ratio, device=dev) + 0.5)[None, :] * (bh / ratio)[:, None]
    sx = x1[:, None] + (torch.arange(pw * ratio, device=dev) + 0.5)[None, :] * (bw / ratio)[:, None]
    vy, y0, y1_, wy = _bilinear_taps(sy, H)
    vx, x0, x1_, wx = _bilinear_taps(sx, W)
    wyc, wxc = wy[:, :, None, None], wx[:, None, :, None]
    val = (_gather_nhwc(x, bidx, y0, x0) * ((1 - wyc) * (1 - wxc)) +
           _gather_nhwc(x, bidx, y0, x1_) * ((1 - wyc) * wxc) +
           _gather_nhwc(x, bidx, y1_, x0) * (wyc * (1 - wxc)) +
           _gather_nhwc(x, bidx, y1_, x1_) * (wyc * wxc))
    val = val * (vy.to(x.dtype)[:, :, None, None] * vx.to(x.dtype)[:, None, :, None])
    out = val.reshape(R, ph, ratio, pw, ratio, C).mean(dim=(2, 4))
    return {"Out": [out.permute(0, 3, 1, 2)]}


@register("roi_pool", nondiff_inputs=("ROIs", "RoisNum"))
def roi_pool(ctx, ins):
    """RoIPool (roi_pool_op.cc): the max over a dense 8 x 8 sample grid per
    bin, as in the JAX package (exact for bins up to 8 px)."""
    x = ins["X"][0]
    rois = ins["ROIs"][0]
    ph = int(ctx.attr("pooled_height", 1))
    pw = int(ctx.attr("pooled_width", 1))
    spatial_scale = float(ctx.attr("spatial_scale", 1.0))
    S = 8
    N, C, H, W = x.shape
    R = rois.shape[0]
    bidx = _roi_batch_index(ins.get("RoisNum", [None])[0], R, ctx.device)
    r = torch.round(rois * spatial_scale)
    x1, y1 = r[:, 0], r[:, 1]
    rw = torch.clamp_min(r[:, 2] - x1 + 1, 1.0)
    rh = torch.clamp_min(r[:, 3] - y1 + 1, 1.0)
    dev = ctx.device
    sy = y1[:, None] + (torch.arange(ph * S, device=dev) + 0.5)[None, :] * (rh / (ph * S))[:, None]
    sx = x1[:, None] + (torch.arange(pw * S, device=dev) + 0.5)[None, :] * (rw / (pw * S))[:, None]
    yy = torch.clamp(torch.floor(sy), 0, H - 1).to(torch.int64)
    xx = torch.clamp(torch.floor(sx), 0, W - 1).to(torch.int64)
    g = _gather_nhwc(x, bidx, yy, xx).reshape(R, ph, S, pw, S, C)
    return {"Out": [g.amax(dim=(2, 4)).permute(0, 3, 1, 2)]}


@register("anchor_generator", grad=None)
def anchor_generator(ctx, ins):
    """Faster R-CNN anchors per feature-map cell (anchor_generator_op.cc;
    ratio = h / w)."""
    x = ins["Input"][0]
    sizes = [float(s) for s in ctx.attr("anchor_sizes", [64.0])]
    ratios = [float(r) for r in ctx.attr("aspect_ratios", [1.0])]
    stride = [float(s) for s in ctx.attr("stride", [16.0, 16.0])]
    offset = float(ctx.attr("offset", 0.5))
    var = [float(v) for v in ctx.attr("variances", [0.1, 0.1, 0.2, 0.2])]
    H, W = x.shape[2], x.shape[3]
    base = []
    for s in sizes:
        for rt in ratios:
            w = s / np.sqrt(rt)
            h = s * np.sqrt(rt)
            base.append([-w / 2, -h / 2, w / 2, h / 2])
    dev = ctx.device
    base = _const(base, dev)                                          # [A, 4]
    cx = (torch.arange(W, device=dev) + offset) * stride[0]
    cy = (torch.arange(H, device=dev) + offset) * stride[1]
    gy, gx = torch.meshgrid(cy, cx, indexing="ij")                    # [H, W]
    ctr = torch.stack([gx, gy, gx, gy], -1)
    anchors = ctr[:, :, None, :] + base[None, None]                   # [H, W, A, 4]
    return {"Anchors": [anchors], "Variances": [_const(var, dev).expand(anchors.shape)]}


@register("box_clip", grad=None)
def box_clip(ctx, ins):
    """box_clip_op.h: clip to round(h/scale)-1 x round(w/scale)-1, per image
    when the boxes carry a leading batch dim matching ImInfo's rows."""
    boxes, im_info = ins["Input"][0], ins["ImInfo"][0]
    scale = im_info[:, 2]
    hmax = torch.round(im_info[:, 0] / scale) - 1.0
    wmax = torch.round(im_info[:, 1] / scale) - 1.0
    if boxes.ndim >= 3 and boxes.shape[0] == im_info.shape[0]:
        bshape = (boxes.shape[0],) + (1,) * (boxes.ndim - 2)
        h, w = hmax.reshape(bshape), wmax.reshape(bshape)
    else:
        h, w = hmax[0], wmax[0]
    return {"Output": [torch.stack([_clip(boxes[..., 0], 0, w), _clip(boxes[..., 1], 0, h),
                                    _clip(boxes[..., 2], 0, w), _clip(boxes[..., 3], 0, h)],
                                   -1)]}


@register("bipartite_match", grad=None, nondiff_inputs=("DistMat",))
def bipartite_match(ctx, ins):
    """Greedy bipartite matching (bipartite_match_op.cc): G steps, each
    taking the globally largest entry (the first on ties) and retiring its
    row and column."""
    dist = ins["DistMat"][0]                                          # [G, M]
    G, M = dist.shape
    dev = ctx.device
    rows = torch.arange(G, device=dev)
    cols = torch.arange(M, device=dev)
    match = torch.full((M,), -1, dtype=torch.int32, device=dev)
    scores = torch.zeros((M,), dtype=dist.dtype, device=dev)
    d = torch.where(dist > 0, dist, 0.0)
    for _ in range(G):
        flat = torch.argmax(d)
        g = torch.div(flat, M, rounding_mode="floor")
        m = flat % M
        v = torch.gather(d.reshape(-1), 0, flat.reshape(1))   # a tensor index, no sync
        ok = v > 0
        at_m = ok & (cols == m)
        match = torch.where(at_m, g.to(torch.int32), match)
        scores = torch.where(at_m, v, scores)
        d = torch.where(ok & ((rows == g)[:, None] | (cols == m)[None, :]), -1.0, d)
    if ctx.attr("match_type", "bipartite") == "per_prediction":
        thr = float(ctx.attr("dist_threshold", 0.5))
        best_g, best_v = torch.argmax(dist, 0), torch.amax(dist, 0)
        extra = (match < 0) & (best_v >= thr)
        match = torch.where(extra, best_g.to(torch.int32), match)
        scores = torch.where(extra, best_v, scores)
    return {"ColToRowMatchIndices": [match[None, :]], "ColToRowMatchDist": [scores[None, :]]}


@register("target_assign", grad=None, nondiff_inputs=("X", "MatchIndices", "NegIndices"))
def target_assign(ctx, ins):
    """Scatter ground-truth rows to matched predictions (target_assign_op.cc).
    X [G, K]; MatchIndices [1, M] (-1 = unmatched). Out [M, K] + OutWeight."""
    x = ins["X"][0]
    match = ins["MatchIndices"][0].reshape(-1).to(torch.int64)
    mismatch_value = float(ctx.attr("mismatch_value", 0.0))
    out = x[torch.clamp_min(match, 0)]
    matched = (match >= 0)[:, None]
    return {"Out": [torch.where(matched, out, mismatch_value)], "OutWeight": [matched.to(x.dtype)]}


@register("sigmoid_focal_loss", nondiff_inputs=("Label", "FgNum"))
def sigmoid_focal_loss(ctx, ins):
    """RetinaNet focal loss (detection/sigmoid_focal_loss_op.cu math): class
    j is positive for a row iff label == j+1 (0 = background)."""
    x = ins["X"][0]                                                   # [N, C]
    label = ins["Label"][0].reshape(-1).to(torch.int64)
    fg = torch.clamp_min(ins["FgNum"][0].reshape(()).to(torch.float32), 1.0)
    gamma = float(ctx.attr("gamma", 2.0))
    alpha = float(ctx.attr("alpha", 0.25))
    C = x.shape[-1]
    pos = ((label - 1)[:, None] == torch.arange(C, device=ctx.device)).to(x.dtype)
    p = torch.sigmoid(x)
    log_p = F.logsigmoid(x)
    log_1p = F.logsigmoid(-x)
    loss = -(pos * alpha * ((1 - p) ** gamma) * log_p +
             (1 - pos) * (1 - alpha) * (p ** gamma) * log_1p)
    return {"Out": [loss / fg]}


@register("generate_proposals", grad=None,
          nondiff_inputs=("Scores", "BboxDeltas", "ImInfo", "Anchors", "Variances"))
def generate_proposals(ctx, ins):
    """RPN proposal generation (detection/generate_proposals_op.cc): decode
    anchor deltas, clip to the image, drop tiny boxes, pre-NMS top-k, NMS
    (``_nms_sweep``, pixel IoU), post-NMS top-k, padded to post_nms_topN
    with RpnRoisNum counts. Scores [N, A, H, W]; BboxDeltas [N, 4A, H, W];
    Anchors [H, W, A, 4]; Variances like Anchors; ImInfo [N, 3]."""
    scores = ins["Scores"][0]
    deltas = ins["BboxDeltas"][0]
    im_info = ins["ImInfo"][0]
    anchors = ins["Anchors"][0].reshape(-1, 4)
    variances = ins["Variances"][0].reshape(-1, 4)
    pre_n = int(ctx.attr("pre_nms_topN", 6000))
    post_n = int(ctx.attr("post_nms_topN", 1000))
    nms_thresh = float(ctx.attr("nms_thresh", 0.7))
    min_size = float(ctx.attr("min_size", 0.1))
    N, A, H, W = scores.shape
    M = A * H * W
    s = scores.permute(0, 2, 3, 1).reshape(N, -1)                     # [N, H*W*A]
    d = deltas.reshape(N, A, 4, H, W).permute(0, 3, 4, 1, 2).reshape(N, -1, 4)
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = anchors[:, 0] + 0.5 * aw
    acy = anchors[:, 1] + 0.5 * ah
    dv = d * variances
    cx = acx + dv[..., 0] * aw
    cy = acy + dv[..., 1] * ah
    w = torch.exp(torch.clamp_max(dv[..., 2], 10.0)) * aw
    h = torch.exp(torch.clamp_max(dv[..., 3], 10.0)) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    hm = (im_info[:, 0] - 1.0)[:, None]
    wm = (im_info[:, 1] - 1.0)[:, None]
    boxes = torch.stack([_clip(boxes[..., 0], 0, wm), _clip(boxes[..., 1], 0, hm),
                         _clip(boxes[..., 2], 0, wm), _clip(boxes[..., 3], 0, hm)], -1)
    ms = (min_size * im_info[:, 2])[:, None]
    keepable = ((boxes[..., 2] - boxes[..., 0] + 1 >= ms) &
                (boxes[..., 3] - boxes[..., 1] + 1 >= ms))
    s = torch.where(keepable, s, _NEG_INF)
    K = min(pre_n, M)
    top_s, order = top_k_lower_first(s, K)
    cand = _gather_rows(boxes, order)                                 # [N, K, 4]
    keep = _nms_sweep(_iou_matrix(cand, cand, 1.0) > nms_thresh, valid=top_s > _NEG_INF)
    sel_s = torch.where(keep, top_s, _NEG_INF)
    P = min(post_n, K)
    best, sel = top_k_lower_first(sel_s, P)
    valid = best > _NEG_INF
    out_boxes = torch.where(valid[..., None], _gather_rows(cand, sel), 0.0)
    out_scores = torch.where(valid, best, 0.0)
    if P < post_n:
        out_boxes = F.pad(out_boxes, (0, 0, 0, post_n - P))
        out_scores = F.pad(out_scores, (0, post_n - P))
    return {"RpnRois": [out_boxes], "RpnRoiProbs": [out_scores[..., None]],
            "RpnRoisNum": [valid.sum(-1).to(torch.int64)]}


def _anchor_labels(iou, pos_ov, neg_ov, crowd_ov):
    """The rpn / retinanet labeling shared by both: (pos, neg, best gt per
    anchor). Positives: IoU >= pos_ov or the best anchor of some gt;
    negatives: IoU < neg_ov and not positive."""
    best_per_anchor, _ = torch.max(iou, 0)
    arg_gt = torch.argmax(iou, 0)
    best_per_gt = torch.amax(iou, 1, keepdim=True)
    is_best = torch.any((iou >= best_per_gt) & (best_per_gt > 0), 0)
    pos = (best_per_anchor >= pos_ov) | is_best
    neg = (best_per_anchor < neg_ov) & ~pos
    return pos, neg, arg_gt


@register("rpn_target_assign", grad=None,
          nondiff_inputs=("Anchor", "GtBoxes", "IsCrowd", "ImInfo"))
def rpn_target_assign(ctx, ins):
    """RPN anchor labeling (detection/rpn_target_assign_op.cc) in the JAX
    package's fixed-shape form: every anchor kept with label 1 / 0 / -1
    (the reference's random sampling becomes weighting downstream;
    ``use_random`` is ignored). Anchor [M, 4]; GtBoxes [G, 4]. Outputs
    Labels [M] int32, MatchedGt [M] int32, BboxTargets [M, 4]."""
    anchors = ins["Anchor"][0]
    gt = ins["GtBoxes"][0]
    is_crowd = ins.get("IsCrowd", [None])[0]
    im_info = ins.get("ImInfo", [None])[0]
    pos_ov = float(ctx.attr("rpn_positive_overlap", 0.7))
    neg_ov = float(ctx.attr("rpn_negative_overlap", 0.3))
    straddle = float(ctx.attr("rpn_straddle_thresh", 0.0))
    iou_all = _iou_matrix(gt, anchors)                                # [G, M]
    if is_crowd is not None:
        crowd = is_crowd.reshape(-1, 1).to(torch.bool)
        iou = torch.where(crowd, 0.0, iou_all)
        crowd_ov = torch.amax(torch.where(crowd, iou_all, 0.0), 0)
    else:
        iou = iou_all
        crowd_ov = torch.zeros((anchors.shape[0],), dtype=torch.float32, device=ctx.device)
    pos, neg, arg_gt = _anchor_labels(iou, pos_ov, neg_ov, crowd_ov)
    labels = torch.where(pos, 1, torch.where(neg, 0, -1)).to(torch.int32)
    labels = torch.where((crowd_ov >= neg_ov) & ~pos, -1, labels)
    if im_info is not None and straddle >= 0:
        h, w = im_info[0, 0], im_info[0, 1]
        inside = ((anchors[:, 0] >= -straddle) & (anchors[:, 1] >= -straddle) &
                  (anchors[:, 2] < w + straddle) & (anchors[:, 3] < h + straddle))
        labels = torch.where(inside, labels, -1)
    tgt = _encode_deltas(anchors, gt[arg_gt], 0.0)
    tgt = torch.where(pos[:, None], tgt, 0.0)
    return {"Labels": [labels], "MatchedGt": [arg_gt.to(torch.int32)], "BboxTargets": [tgt]}


def _bce(logit, tgt):
    """Sigmoid cross-entropy from logits, the JAX form (``maximum``'s
    gradient split at a tie, as JAX's)."""
    return (torch.maximum(logit, logit.new_zeros(())) - logit * tgt +
            torch.log1p(torch.exp(-torch.abs(logit))))


@register("yolov3_loss", nondiff_inputs=("GTBox", "GTLabel", "GTScore"))
def yolov3_loss(ctx, ins):
    """YOLOv3 training loss (detection/yolov3_loss_op.h), one detection head,
    the JAX package's rules with images as a batch dimension.

    X [N, A*(5+C), H, W]; GTBox [N, B, 4] normalized (cx, cy, w, h); GTLabel
    [N, B] (rows with w*h == 0 are padding). Each gt is owned by its
    best-IoU anchor over all anchors; if that anchor is in this head's mask,
    its cell learns x/y/w/h (scaled by 2 - w*h), objectness and its class.
    Other cells learn objectness 0 unless their decoded box overlaps a gt
    above ``ignore_thresh``. The gts are scattered into the [N, A, H, W]
    target grids by ``index_add_`` of masked values on zero grids (rows that
    own no cell add 0; two gts in one cell and slot sum, then average)."""
    x = ins["X"][0]
    gtbox = ins["GTBox"][0].to(torch.float32)
    gtlabel = ins["GTLabel"][0].to(torch.int64)
    anchors = [float(a) for a in ctx.attr("anchors", [])]
    mask = [int(m) for m in ctx.attr("anchor_mask", [])]
    C = int(ctx.attr("class_num"))
    ignore = float(ctx.attr("ignore_thresh", 0.7))
    down = int(ctx.attr("downsample_ratio", 32))
    N, _, H, W = x.shape
    A = len(mask)
    B = gtbox.shape[1]
    dev = ctx.device
    xi = x.reshape(N, A, 5 + C, H, W)
    in_w, in_h = W * down, H * down
    all_aw = _const(anchors[0::2], dev)
    all_ah = _const(anchors[1::2], dev)
    gsc = ins.get("GTScore", [None])[0]
    gsc = (torch.ones((N, B), dtype=torch.float32, device=dev) if gsc is None
           else gsc.to(torch.float32))

    gb = gtbox
    valid = gb[..., 2] * gb[..., 3] > 0                               # [N, B]
    gw = gb[..., 2] * in_w
    gh = gb[..., 3] * in_h
    inter = (torch.minimum(gw[..., None], all_aw) * torch.minimum(gh[..., None], all_ah))
    union = gw[..., None] * gh[..., None] + (all_aw * all_ah) - inter
    best_anchor = torch.argmax(inter / union, -1)                     # [N, B]
    gi = torch.clamp((gb[..., 0] * W).to(torch.int32), 0, W - 1)
    gj = torch.clamp((gb[..., 1] * H).to(torch.int32), 0, H - 1)
    slot = torch.full((N, B), -1, dtype=torch.int64, device=dev)
    for k, m in enumerate(mask):
        slot = torch.where(best_anchor == m, k, slot)
    own = valid & (slot >= 0)
    s = torch.clamp_min(slot, 0)
    img = torch.arange(N, device=dev)[:, None]
    cell = ((img * A + s) * H + gj) * W + gi                          # [N, B]

    def grid(vals):
        g = torch.zeros((N * A * H * W,), dtype=torch.float32, device=dev)
        g.index_add_(0, cell.reshape(-1), torch.where(own, vals, 0.0).reshape(-1))
        return g.reshape(N, A, H, W)

    obj_raw = grid(torch.ones((N, B), dtype=torch.float32, device=dev))
    obj_tgt = torch.clamp_max(obj_raw, 1.0)
    dedup = torch.where(obj_raw > 0, obj_raw, 1.0)
    tx = grid(gb[..., 0] * W - gi) / dedup
    ty = grid(gb[..., 1] * H - gj) / dedup
    aw_s = _const([anchors[2 * m] for m in mask], dev)
    ah_s = _const([anchors[2 * m + 1] for m in mask], dev)
    tw = grid(torch.log(torch.clamp_min(gw, 1e-6) / torch.clamp_min(aw_s[s], 1e-6))) / dedup
    th = grid(torch.log(torch.clamp_min(gh, 1e-6) / torch.clamp_min(ah_s[s], 1e-6))) / dedup
    scale = grid(2.0 - gb[..., 2] * gb[..., 3]) / dedup
    smooth = bool(ctx.attr("use_label_smooth", False))
    pos_v = 1.0 - 1.0 / C if smooth else 1.0
    neg_v = 1.0 / C if smooth else 0.0
    cls_tgt = torch.full((N * A * H * W * C,), neg_v, dtype=torch.float32, device=dev)
    cls_tgt.index_add_(0, (cell * C + torch.clamp(gtlabel, 0, C - 1)).reshape(-1),
                       torch.where(own, pos_v - neg_v, 0.0).reshape(-1))
    cls_tgt = torch.clamp_max(cls_tgt.reshape(N, A, H, W, C), pos_v)
    obj_score = torch.clamp_max(grid(gsc), 1.0)
    obj_tgt_val = torch.where(obj_tgt > 0, obj_score, 0.0)

    # decoded predictions for the ignore rule (a boolean: no gradient)
    xd = xi.detach()
    px = (torch.arange(W, device=dev)[None, None, None, :] + torch.sigmoid(xd[:, :, 0])) / W
    py = (torch.arange(H, device=dev)[None, None, :, None] + torch.sigmoid(xd[:, :, 1])) / H
    pw = torch.exp(torch.clamp_max(xd[:, :, 2], 10.0)) * aw_s.reshape(1, A, 1, 1) / in_w
    ph = torch.exp(torch.clamp_max(xd[:, :, 3], 10.0)) * ah_s.reshape(1, A, 1, 1) / in_h
    pred = torch.stack([px - pw / 2, py - ph / 2, px + pw / 2, py + ph / 2], -1).reshape(N, -1, 4)
    gxy = torch.stack([gb[..., 0] - gb[..., 2] / 2, gb[..., 1] - gb[..., 3] / 2,
                       gb[..., 0] + gb[..., 2] / 2, gb[..., 1] + gb[..., 3] / 2], -1)
    iou_pg = torch.where(valid[:, None, :], _iou_matrix(pred, gxy), 0.0)   # [N, AHW, B]
    ignore_mask = (torch.amax(iou_pg, -1) > ignore).reshape(N, A, H, W)

    loss_xy = scale * (_bce(xi[:, :, 0], tx) + _bce(xi[:, :, 1], ty)) * obj_tgt
    loss_wh = scale * ((xi[:, :, 2] - tw) ** 2 + (xi[:, :, 3] - th) ** 2) * 0.5 * obj_tgt
    obj_loss = _bce(xi[:, :, 4], obj_tgt_val)
    loss_obj = torch.where(obj_tgt > 0, obj_loss, torch.where(ignore_mask, 0.0, obj_loss))
    loss_cls = torch.sum(_bce(xi[:, :, 5:].permute(0, 1, 3, 4, 2), cls_tgt), -1) * obj_tgt
    red = (1, 2, 3)
    loss = (loss_xy.sum(red) + loss_wh.sum(red) + loss_obj.sum(red) + loss_cls.sum(red))
    return {"Loss": [loss[:, None].to(x.dtype)]}


@register("box_decoder_and_assign", grad=None,
          nondiff_inputs=("PriorBox", "PriorBoxVar", "TargetBox", "BoxScore"))
def box_decoder_and_assign(ctx, ins):
    """detection/box_decoder_and_assign_op.cc: decode per-class deltas
    [M, 4*C] against the priors, clip the log-space sizes, and per prior pick
    the box of its best foreground class (background's score set to -inf
    before the argmax; no foreground winner -> the prior itself)."""
    prior = ins["PriorBox"][0]
    deltas = ins["TargetBox"][0]
    score = ins["BoxScore"][0]
    pv = ins.get("PriorBoxVar", [None])[0]
    clip = float(ctx.attr("box_clip", 4.135))
    M = prior.shape[0]
    C = score.shape[-1]
    d = deltas.reshape(M, C, 4)
    if pv is not None:
        d = d * pv[:, None, :]
    pw = (prior[:, 2] - prior[:, 0])[:, None]
    ph = (prior[:, 3] - prior[:, 1])[:, None]
    pcx = prior[:, 0][:, None] + 0.5 * pw
    pcy = prior[:, 1][:, None] + 0.5 * ph
    cx = pcx + d[..., 0] * pw
    cy = pcy + d[..., 1] * ph
    w = torch.exp(torch.clamp_max(d[..., 2], clip)) * pw
    h = torch.exp(torch.clamp_max(d[..., 3], clip)) * ph
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2 - 1, cy + h / 2 - 1], -1)
    fg_score = score
    if C > 1:
        fg_score = score.clone()
        fg_score[:, 0] = _NEG_INF
    best = torch.argmax(fg_score, -1)
    assigned = torch.gather(boxes, 1, best[:, None, None].expand(M, 1, 4))[:, 0]
    if C > 1:
        assigned = torch.where((best > 0)[:, None], assigned, prior)
    return {"DecodeBox": [boxes.reshape(M, 4 * C)], "OutputAssignBox": [assigned]}


@register("polygon_box_transform", grad=None)
def polygon_box_transform(ctx, ins):
    """detection/polygon_box_transform_op.cc (EAST): quarter-resolution geo
    maps [N, 2K, H, W] of (x, y) offsets -> pixel coordinate * 4 - offset."""
    x = ins["Input"][0]
    N, C2, H, W = x.shape
    dev = ctx.device
    gx = (4.0 * torch.arange(W, dtype=x.dtype, device=dev))[None, None, None, :]
    gy = (4.0 * torch.arange(H, dtype=x.dtype, device=dev))[None, None, :, None]
    coord = torch.where((torch.arange(C2, device=dev) % 2 == 0)[None, :, None, None],
                        gx.expand(x.shape), gy.expand(x.shape))
    return {"Output": [coord - x]}


@register("generate_proposal_labels", grad=None,
          nondiff_inputs=("RpnRois", "GtClasses", "IsCrowd", "GtBoxes", "ImInfo", "RpnRoisNum"))
def generate_proposal_labels(ctx, ins):
    """Second-stage target assignment (generate_proposal_labels_op.cc) in the
    JAX package's fixed-shape form: the gts appended to the proposals, fg
    (IoU >= fg_thresh, pixel convention) with the gt class, bg in
    [bg_thresh_lo, bg_thresh_hi), the rest ignored; all R+G rows kept, with
    ClsWeights carrying the sampled fg/bg proportions (``use_random`` is
    ignored). Padded proposals (index >= RpnRoisNum) and zero-area or crowd
    gts are ignored. Outputs [N, R+G, ...] and MatchedGt [N, R+G] int32."""
    rois = ins["RpnRois"][0].to(torch.float32)
    gt_cls = ins["GtClasses"][0].to(torch.int64)
    gt = ins["GtBoxes"][0].to(torch.float32)
    is_crowd = ins.get("IsCrowd", [None])[0]
    rois_num = ins.get("RpnRoisNum", [None])[0]
    C = int(ctx.attr("class_nums", 81))
    bpi = float(ctx.attr("batch_size_per_im", 256))
    fg_frac = float(ctx.attr("fg_fraction", 0.25))
    fg_th = float(ctx.attr("fg_thresh", 0.5))
    bg_hi = float(ctx.attr("bg_thresh_hi", 0.5))
    bg_lo = float(ctx.attr("bg_thresh_lo", 0.0))
    rw = _const([float(w) for w in ctx.attr("bbox_reg_weights", [0.1, 0.1, 0.2, 0.2])],
                ctx.device)
    N, R = rois.shape[0], rois.shape[1]
    G = gt.shape[1]
    dev = ctx.device
    crowd = (is_crowd.to(torch.int32) if is_crowd is not None
             else torch.zeros((N, G), dtype=torch.int32, device=dev))
    nroi = (rois_num.to(torch.int64) if rois_num is not None
            else torch.full((N,), R, dtype=torch.int64, device=dev))
    all_rois = torch.cat([rois, gt], 1)                               # [N, R', 4]
    Rp = all_rois.shape[1]
    valid_gt = (((gt[..., 2] - gt[..., 0]) * (gt[..., 3] - gt[..., 1]) > 0) & (crowd == 0))
    iou = torch.where(valid_gt[:, None, :], _iou_matrix(all_rois, gt, 1.0), 0.0)
    max_iou = torch.amax(iou, -1)
    matched = torch.argmax(iou, -1)
    fg = max_iou >= fg_th
    bg = (max_iou < bg_hi) & (max_iou >= bg_lo) & ~fg
    row_valid = torch.cat([torch.arange(R, device=dev)[None, :] < nroi[:, None], valid_gt], 1)
    fg, bg = fg & row_valid, bg & row_valid
    label = torch.where(fg, torch.gather(gt_cls, 1, matched),
                        torch.where(bg, 0, -1)).to(torch.int32)
    n_fg = fg.sum(-1).to(torch.float32)
    n_bg = bg.sum(-1).to(torch.float32)
    fg_cap = torch.clamp_max(n_fg, fg_frac * bpi)
    bg_cap = torch.minimum(bpi - fg_cap, n_bg)
    w_fg = torch.where(n_fg > 0, fg_cap / torch.clamp_min(n_fg, 1.0), 0.0)
    w_bg = torch.where(n_bg > 0, bg_cap / torch.clamp_min(n_bg, 1.0), 0.0)
    cls_w = torch.where(fg, w_fg[:, None], torch.where(bg, w_bg[:, None], 0.0))
    deltas = _encode_deltas(all_rois, _gather_rows(gt, matched), 1.0) / rw
    onehot = ((torch.where(fg, label, 0).to(torch.int64)[..., None] ==
               torch.arange(C, device=dev)).to(torch.float32) * fg[..., None])
    tgt = (onehot[..., None] * deltas[..., None, :]).reshape(N, Rp, 4 * C)
    inw = torch.repeat_interleave(onehot, 4, dim=-1)
    outw = inw * cls_w[..., None]
    return {"Rois": [all_rois], "LabelsInt32": [label], "ClsWeights": [cls_w],
            "BboxTargets": [tgt], "BboxInsideWeights": [inw], "BboxOutsideWeights": [outw],
            "MatchedGt": [matched.to(torch.int32)]}


#: f32 log(2), the divisor of the JAX package's ``jnp.log2`` (log(x) / log(2))
_LN2 = float(np.float32(math.log(2.0)))


@register("distribute_fpn_proposals", grad=None, nondiff_inputs=("FpnRois",))
def distribute_fpn_proposals(ctx, ins):
    """FPN level assignment (distribute_fpn_proposals_op.cc): level =
    floor(refer_level + log2(sqrt(area) / refer_scale)), clamped to
    [min_level, max_level], as a per-roi level index [N, R] int32 (the JAX
    package's fixed-shape form; zero-area padding rois get min_level)."""
    rois = ins["FpnRois"][0]
    min_l = int(ctx.attr("min_level", 2))
    max_l = int(ctx.attr("max_level", 5))
    refer_l = int(ctx.attr("refer_level", 4))
    refer_s = float(ctx.attr("refer_scale", 224))
    w = torch.clamp_min(rois[..., 2] - rois[..., 0], 0.0)
    h = torch.clamp_min(rois[..., 3] - rois[..., 1], 0.0)
    scale = torch.sqrt(w * h)
    lvl = torch.floor(refer_l + torch.log(torch.clamp_min(scale, 1e-6) / refer_s) / _LN2)
    return {"RoisLevel": [torch.clamp(lvl, min_l, max_l).to(torch.int32)]}


@register("generate_mask_targets", grad=None,
          nondiff_inputs=("Rois", "GtMasks", "MatchedGt", "FgMask"))
def generate_mask_targets(ctx, ins):
    """Mask-head training targets (generate_mask_labels_op.cc's role): each
    fg roi's matched gt bitmap, bilinear-sampled on a resolution x
    resolution grid inside the roi and thresholded to {0, 1}. Rois [N, R, 4]
    (image coords); GtMasks [N, G, Hm, Wm] over the canvas ``im_shape``;
    MatchedGt [N, R]; FgMask [N, R]. MaskTargets [N, R, res, res]."""
    rois = ins["Rois"][0].to(torch.float32)
    masks = ins["GtMasks"][0].to(torch.float32)
    matched = ins["MatchedGt"][0].to(torch.int64)
    fg = ins["FgMask"][0]
    res = int(ctx.attr("resolution", 28))
    im_h, im_w = [float(v) for v in ctx.attr("im_shape", [0, 0])]
    N, R = rois.shape[0], rois.shape[1]
    Hm, Wm = masks.shape[2], masks.shape[3]
    dev = ctx.device
    sel = masks[torch.arange(N, device=dev)[:, None], matched].reshape(N, R, Hm * Wm)
    x1, y1, x2, y2 = rois[..., 0], rois[..., 1], rois[..., 2], rois[..., 3]
    t = (torch.arange(res, dtype=torch.float32, device=dev) + 0.5) / res
    gx = (x1[..., None] + t * torch.clamp_min(x2 - x1, 1e-6)[..., None]) * (Wm / max(im_w, 1e-6))
    gy = (y1[..., None] + t * torch.clamp_min(y2 - y1, 1e-6)[..., None]) * (Hm / max(im_h, 1e-6))
    ys, xs = gy - 0.5, gx - 0.5
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, Hm - 1)
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, Wm - 1)
    y1i = torch.clamp(y0 + 1, 0, Hm - 1)
    x1i = torch.clamp(x0 + 1, 0, Wm - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0)[..., :, None]
    wx = torch.clamp(xs - x0, 0.0, 1.0)[..., None, :]

    def at(yy, xx):
        idx = (yy[..., :, None] * Wm + xx[..., None, :]).reshape(N, R, res * res)
        return torch.gather(sel, 2, idx).reshape(N, R, res, res)

    out = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1i) * (1 - wy) * wx +
           at(y1i, x0) * wy * (1 - wx) + at(y1i, x1i) * wy * wx)
    out = (out >= 0.5).to(torch.float32)
    return {"MaskTargets": [out * fg.to(torch.float32)[..., None, None]]}


@register("collect_fpn_proposals", grad=None,
          nondiff_inputs=("MultiLevelRois", "MultiLevelScores"))
def collect_fpn_proposals(ctx, ins):
    """Collect per-level RPN proposals (collect_fpn_proposals_op.cc): concat
    every level, keep the post_nms_topN highest scores per image. Outputs
    FpnRois [N, post_nms_topN, 4] and RoisNum [N] (rows with score > 0)."""
    rois = torch.cat(list(ins["MultiLevelRois"]), 1).to(torch.float32)
    scores = torch.cat(list(ins["MultiLevelScores"]), 1)[..., 0]
    post_n = int(ctx.attr("post_nms_topN", 1000))
    k = min(post_n, rois.shape[1])
    top_s, idx = top_k_lower_first(scores, k)
    out = _gather_rows(rois, idx)
    if k < post_n:
        out = F.pad(out, (0, 0, 0, post_n - k))
        top_s = F.pad(top_s, (0, post_n - k))
    return {"FpnRois": [out], "RoisNum": [(top_s > 0).sum(-1).to(torch.int64)]}


@register("retinanet_target_assign", grad=None,
          nondiff_inputs=("Anchor", "GtBoxes", "GtLabels", "IsCrowd", "ImInfo"))
def retinanet_target_assign(ctx, ins):
    """RetinaNet anchor labeling (retinanet_target_assign_op.cc): as
    ``rpn_target_assign`` but class-aware; fg anchors take their gt's class
    (1..C-1), bg 0, the rest -1. Anchor [M, 4]; GtBoxes [G, 4] (zero-area
    rows are padding); GtLabels [G]. Outputs Labels [M] int32, MatchedGt
    [M] int32, BboxTargets [M, 4], FgNum [1] int32."""
    anchors = ins["Anchor"][0]
    gt = ins["GtBoxes"][0]
    gt_labels = ins["GtLabels"][0].to(torch.int32).reshape(-1)
    is_crowd = ins.get("IsCrowd", [None])[0]
    im_info = ins.get("ImInfo", [None])[0]
    pos_ov = float(ctx.attr("positive_overlap", 0.5))
    neg_ov = float(ctx.attr("negative_overlap", 0.4))
    nonzero_gt = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1]) > 0
    iou_all = torch.where(nonzero_gt[:, None], _iou_matrix(gt, anchors), 0.0)
    if is_crowd is not None:
        crowd = (is_crowd.reshape(-1) != 0) & nonzero_gt
        iou = torch.where(crowd[:, None], 0.0, iou_all)
        crowd_ov = torch.amax(torch.where(crowd[:, None], iou_all, 0.0), 0)
    else:
        iou = iou_all
        crowd_ov = torch.zeros((anchors.shape[0],), dtype=torch.float32, device=ctx.device)
    pos, neg, arg_gt = _anchor_labels(iou, pos_ov, neg_ov, crowd_ov)
    labels = torch.where(pos, gt_labels[arg_gt], torch.where(neg, 0, -1)).to(torch.int32)
    labels = torch.where((crowd_ov >= neg_ov) & ~pos, -1, labels)
    if im_info is not None:
        h, w = im_info[0, 0], im_info[0, 1]
        inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0) &
                  (anchors[:, 2] < w) & (anchors[:, 3] < h))
        labels = torch.where(inside, labels, -1)
        pos = pos & inside
    tgt = torch.where(pos[:, None], _encode_deltas(anchors, gt[arg_gt], 0.0), 0.0)
    fg_num = torch.clamp_min(pos.sum(), 1).to(torch.int32).reshape(1)
    return {"Labels": [labels], "MatchedGt": [arg_gt.to(torch.int32)],
            "BboxTargets": [tgt], "FgNum": [fg_num]}


# the reference's v2 names for two of the ops above (the JAX package's
# aliases, ``paddle_tpu/ops/tail_ops.py``): the same lowering and flags
register("multiclass_nms2", grad=None, nondiff_inputs=("BBoxes", "Scores"))(multiclass_nms)
register("generate_mask_labels", grad=None,
         nondiff_inputs=("Rois", "GtMasks", "MatchedGt", "FgMask"))(generate_mask_targets)
