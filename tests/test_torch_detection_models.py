"""The four detectors on the port against the JAX package, on the CPU, each
at its JAX test's TINY size (``tests/test_yolov3.py``, ``test_faster_rcnn.py``,
``test_retinanet.py``, ``test_mask_rcnn.py``), the JAX startup state
carried across by name (``convert.py``). The JAX side of each is built once
(module-scoped fixtures).

Training: the losses of the same Adam steps from the same state. Step 1
within ``rtol 1e-5`` (f32 sums in other orders through the backbone); steps
2 and 3 within ``rtol 2e-3``, steps 4 and 5 (YOLOv3 only) within ``1e-2``:
the batch norms' E[x^2] - E[x]^2 variances cancel, so their f32 sums in
another order move the backbone's gradients by up to ~3e-4 of their scale
(the op-level gradients agree to ~1e-7: ``tests/test_torch_grad.py``), and
Adam's first steps (lr * g / |g|) turn that into update differences the
next losses show. Measured on YOLOv3: 1.1e-6, 5.5e-4, 2.9e-3, 3.2e-3 at
steps 2-5; the other three detectors under 2e-5.

Serving: the inputs of the program's last ``multiclass_nms`` (the heads
after decode) within ``rtol 1e-4, atol 1e-4`` of the JAX package's (the same
weights through a few convolutions and a softmax or sigmoid), then the port's
``multiclass_nms`` lowering on the JAX package's own inputs exactly equal to
the JAX outputs (labels, scores, boxes, counts). For YOLOv3 also the
port's ``yolo_box`` decode of the JAX heads within ``rtol 1e-6, atol 1e-6``
of the JAX decode (``exp`` and ``sigmoid`` round an ulp apart).

``examples/object_detection.py``'s program (YOLOv3 at its TINY size, batch
4) trains 5 Adam steps, is saved with ``save_inference_model`` and served
by the port's ``Predictor``, bit for bit to the port's executor on the
same weights.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.models import faster_rcnn as j_frcnn
from paddle_tpu.models import mask_rcnn as j_mrcnn
from paddle_tpu.models import retinanet as j_retina
from paddle_tpu.models import yolov3 as j_yolo
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.inference import Predictor
from paddle_tpu_torch.models import faster_rcnn as t_frcnn
from paddle_tpu_torch.models import mask_rcnn as t_mrcnn
from paddle_tpu_torch.models import retinanet as t_retina
from paddle_tpu_torch.models import yolov3 as t_yolo

STEP1_RTOL, LATER_RTOL, LATE_RTOL = 1e-5, 2e-3, 1e-2
HEAD_TOL = dict(rtol=1e-4, atol=1e-4)
#: ulps of a float32 ``exp`` and ``sigmoid`` (1 / (1 + exp(-x)): exp's ulps and
#: two roundings) from the exact value in either library's vector math
EXP_ULPS, SIGMOID_ULPS = 2, 4
A = dict(append_batch_size=False)
YOLO_TINY = dict(scale=0.25, stage_blocks=(1, 1, 1, 1, 1), num_classes=4)


def _program(pkg, build):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 0
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        fetch = build(pkg)
    return main, startup, fetch


def _persistables(program):
    return sorted(n for n, v in program.global_block().vars.items() if v.persistable)


def _jax_run(main, startup, feed, fetch, steps, init=None):
    """``steps`` runs of ``main`` from ``startup`` (or ``init``): (the
    startup state, each step's fetches, the final state), as numpy."""
    exe, scope = fluid.Executor(), fluid.Scope()
    names = _persistables(main)
    with fluid.scope_guard(scope):
        exe.run(startup)
        if init is not None:
            for n, a in init.items():
                scope.set_var(n, jnp.asarray(a))
        start = {n: np.array(scope.find_var(n)) for n in names
                 if scope.find_var(n) is not None}
        outs = [[np.array(v) for v in exe.run(main, feed=feed, fetch_list=fetch)]
                for _ in range(steps)]
        final = {n: np.array(scope.find_var(n)) for n in start}
    return start, outs, final


def _port_run(main, feed, fetch, steps, state):
    scope = pt.Scope()
    convert.load_state(scope, convert.state_from_numpy(
        {k: v.copy() for k, v in state.items()}, device="cpu"))
    with pt.scope_guard(scope):
        exe = pt.Executor(pt.CPUPlace())
        outs = [[np.asarray(v) for v in exe.run(main, feed=feed, fetch_list=fetch)]
                for _ in range(steps)]
    return outs, scope


def _losses(outs):
    return [float(np.asarray(o[0]).reshape(())) for o in outs]


def _assert_losses(port, jax_):
    np.testing.assert_allclose(port[0], jax_[0], rtol=STEP1_RTOL)
    np.testing.assert_allclose(port[1:3], jax_[1:3], rtol=LATER_RTOL)
    np.testing.assert_allclose(port[3:], jax_[3:], rtol=LATE_RTOL)
    assert np.isfinite(port).all() and port[-1] < port[0], port


def _last_nms(program):
    return [op for op in program.global_block().ops if op.type == "multiclass_nms"][-1]


def _serve_both(jbuild, tbuild, feed, state):
    """The serving program in both packages on ``state``: fetches the last
    NMS op's inputs and outputs. Returns (jax values, port values, the op)."""
    jmain, jstart, jfetch = _program(fluid, jbuild)
    tmain, _, _ = _program(pt, tbuild)
    op = _last_nms(jmain)
    names = [op.inputs["BBoxes"][0], op.inputs["Scores"][0], op.outputs["Out"][0],
             op.outputs["NmsRoisNum"][0]] + [getattr(v, "name", v) for v in jfetch]
    _, (jv,), _ = _jax_run(jmain, jstart, feed, names, 1,
                           init={n: state[n] for n in _persistables(jmain) if n in state})
    (tv,), _ = _port_run(tmain, feed, names, 1,
                         {n: state[n] for n in _persistables(tmain) if n in state})
    return jv, tv, op


def _port_nms_on(op, boxes, scores):
    outs = treg.get("multiclass_nms").lower(
        treg.LowerCtx(dict(op.attrs)),
        {"BBoxes": [torch.from_numpy(boxes)], "Scores": [torch.from_numpy(scores)]})
    return outs["Out"][0].numpy(), outs["NmsRoisNum"][0].numpy()


def _yolo_box_f64(ctx, ins):
    """``yolo_box`` evaluated in float64, with each output's bound on an f32
    evaluation of the same formula: (Boxes, Scores, their bounds).

    A corner is ``(gx -+ bw / 2) * img`` with ``gx = (i + sigmoid(tx)) / w``
    and ``bw = exp(tw) * anchor / (w * downsample)``. ``sigmoid`` is within
    ``SIGMOID_ULPS`` ulps and ``gx`` takes two roundings more; ``exp`` is
    within ``EXP_ULPS`` ulps and ``bw`` takes two roundings more, so one ulp
    of ``exp`` moves the corner by ``eps * bw / 2 * img``: the anchor's
    scale in pixels. The sum and the product by ``img`` round once each. A
    score is ``sigmoid(c) * sigmoid(conf)``: ``2 SIGMOID_ULPS + 1`` roundings
    of it. Masked rows are exact zeros on every side."""
    x = ins["X"][0].numpy()
    imgsize = ins["ImgSize"][0].numpy().astype(np.float64)
    anchors = ctx.attr("anchors")
    cls = ctx.attr("class_num")
    n, _, h, w = x.shape
    na = len(anchors) // 2
    x = x.reshape(n, na, 5 + cls, h, w)
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))
    sx, sy = sig(x[:, :, 0]), sig(x[:, :, 1])
    gx = (np.arange(w)[None, None, None, :] + sx) / w
    gy = (np.arange(h)[None, None, :, None] + sy) / h
    down = ctx.attr("downsample_ratio")
    bw = np.exp(x[:, :, 2]) * np.asarray(anchors[0::2], np.float64).reshape(1, na, 1, 1) / (w * down)
    bh = np.exp(x[:, :, 3]) * np.asarray(anchors[1::2], np.float64).reshape(1, na, 1, 1) / (h * down)
    conf = sig(x[:, :, 4])
    probs = sig(x[:, :, 5:]) * conf[:, :, None]
    mask = (conf > ctx.attr("conf_thresh", 0.01)).astype(np.float64)
    img_h = imgsize[:, 0].reshape(n, 1, 1, 1)
    img_w = imgsize[:, 1].reshape(n, 1, 1, 1)
    eps = float(np.finfo(np.float32).eps)
    boxes, bounds = [], []
    for g, b, s, img, side in ((gx, bw, sx, img_w, -1), (gy, bh, sy, img_h, -1),
                               (gx, bw, sx, img_w, 1), (gy, bh, sy, img_h, 1)):
        corner = (g + side * b / 2) * img
        boxes.append(corner)
        bounds.append(eps * img * (SIGMOID_ULPS * s / w + 3 * g + (EXP_ULPS + 3) * b / 2)
                      + eps * np.abs(corner))
    boxes = (np.stack(boxes, -1) * mask[..., None]).reshape(n, -1, 4)
    box_bound = (np.stack(bounds, -1) * mask[..., None]).reshape(n, -1, 4)
    scores = (probs * mask[:, :, None]).transpose(0, 1, 3, 4, 2).reshape(n, -1, cls)
    score_bound = (2 * SIGMOID_ULPS + 1) * eps * scores
    return [torch.from_numpy(a) for a in (boxes, scores, box_bound, score_bound)]


def _run_decode(ops, env, f64=False):
    """The decode's ops over ``env`` with the port's lowerings; with ``f64``,
    ``yolo_box`` is ``_yolo_box_f64`` and each variable's bound rides beside
    it as ``<name>@bound`` through the same transposes and concats."""
    for o in ops:
        ctx = treg.LowerCtx(dict(o.attrs))
        ins = {sl: [env[n] for n in ns] for sl, ns in o.inputs.items()}
        if f64 and o.type == "yolo_box":
            boxes, scores, bb, sb = _yolo_box_f64(ctx, ins)
            outs = {"Boxes": [boxes], "Scores": [scores]}
            env[o.outputs["Boxes"][0] + "@bound"] = bb
            env[o.outputs["Scores"][0] + "@bound"] = sb
        else:
            outs = treg.get(o.type).lower(ctx, ins)
            if f64:
                bins = {sl: [env[n + "@bound"] if n + "@bound" in env else env[n] for n in ns]
                        for sl, ns in o.inputs.items()}
                bouts = treg.get(o.type).lower(ctx, bins)
                for sl, ns in o.outputs.items():
                    if ns and bouts[sl][0] is not None and bouts[sl][0].dtype == torch.float64:
                        env.update((n + "@bound", v) for n, v in zip(ns, bouts[sl]))
        for sl, ns in o.outputs.items():
            env.update(zip(ns, outs[sl]))
    return env


def _assert_served(jv, tv, op):
    for a, b in zip(jv[:2], tv[:2]):
        np.testing.assert_allclose(b, a, **HEAD_TOL)
    out, num = _port_nms_on(op, jv[0], jv[1])
    np.testing.assert_array_equal(out, jv[2])
    np.testing.assert_array_equal(num, jv[3].astype(np.int64))


# ------------------------------------------------------------------ YOLOv3

def _yolo_feed():
    rng = np.random.RandomState(0)
    boxes = np.zeros((4, 6, 4), np.float32)
    boxes[:, :2, :2] = rng.uniform(0.3, 0.6, (4, 2, 2))
    boxes[:, :2, 2:] = rng.uniform(0.1, 0.25, (4, 2, 2))
    return {"img": rng.uniform(0, 1, (4, 3, 64, 64)).astype(np.float32), "gt_box": boxes,
            "gt_label": rng.randint(0, 4, (4, 6)).astype(np.int32)}


def _yolo_train(model):
    def build(pkg):
        img = pkg.data("img", [3, 64, 64], "float32")
        gt_box = pkg.data("gt_box", [6, 4], "float32")
        gt_label = pkg.data("gt_label", [6], "int32")
        loss = model.yolov3(img, gt_box, gt_label, **YOLO_TINY)
        pkg.optimizer.Adam(1e-3).minimize(loss)
        return [loss]
    return build


def _yolo_infer(model, heads=None):
    def build(pkg):
        img = pkg.data("img", [3, 64, 64], "float32")
        img_size = pkg.data("img_size", [2], "int32")
        dets, nums = model.yolov3_infer(img, img_size, keep_top_k=10, **YOLO_TINY)
        if heads is not None:         # the three heads: yolo_box's inputs
            heads.extend(op.inputs["X"][0] for op in
                         pkg.default_main_program().global_block().ops
                         if op.type == "yolo_box")
        return [dets, nums]
    return build


@pytest.fixture(scope="module")
def yolo():
    """The example's program: 5 Adam steps in the JAX package."""
    feed = _yolo_feed()
    main, startup, fetch = _program(fluid, _yolo_train(j_yolo))
    init, outs, final = _jax_run(main, startup, feed, fetch, 5)
    return feed, init, _losses(outs), final


def test_yolov3_trains_as_jax(yolo):
    feed, init, jlosses, _ = yolo
    main, _, fetch = _program(pt, _yolo_train(t_yolo))
    assert _persistables(main) == sorted(init)
    outs, _ = _port_run(main, feed, fetch, 5, init)
    _assert_losses(_losses(outs), jlosses)


def test_yolov3_served_as_jax(yolo):
    """The heads at HEAD_TOL; the ``yolo_box`` decode of the JAX heads, the
    port's and the JAX package's, each within ``_yolo_box_f64``'s bound of
    the float64 decode (the two f32 decodes round ``exp`` and ``sigmoid``
    ulps apart); the port's ``multiclass_nms`` on the JAX decode exactly."""
    feed, _, _, final = yolo
    sfeed = {"img": feed["img"][:2], "img_size": np.full((2, 2), 64, np.int32)}
    jheads, theads = [], []
    jmain, jstart, jfetch = _program(fluid, _yolo_infer(j_yolo, jheads))
    tmain, _, _ = _program(pt, _yolo_infer(t_yolo, theads))
    assert jheads == theads and len(jheads) == 3
    op = _last_nms(jmain)
    nms_in = [op.inputs["BBoxes"][0], op.inputs["Scores"][0]]
    names = jheads + nms_in + [v.name for v in jfetch]
    state = {n: final[n] for n in _persistables(jmain)}
    _, (jv,), _ = _jax_run(jmain, jstart, sfeed, names, 1, init=state)
    (tv,), _ = _port_run(tmain, sfeed, names, 1, state)
    for a, b in zip(jv[:3], tv[:3]):
        np.testing.assert_allclose(b, a, **HEAD_TOL)
    ops = tmain.global_block().ops
    decode = ops[[x.type for x in ops].index("yolo_box"):-1]      # the decode, up to NMS
    img_size = torch.from_numpy(sfeed["img_size"])
    env = _run_decode(decode, {"img_size": img_size, **{
        h: torch.from_numpy(a) for h, a in zip(jheads, jv[:3])}})
    exact = _run_decode(decode, {"img_size": img_size, **{
        h: torch.from_numpy(a.astype(np.float64)) for h, a in zip(jheads, jv[:3])}},
        f64=True)
    for n, a in zip(nms_in, jv[3:5]):
        value, bound = exact[n].numpy(), exact[n + "@bound"].numpy()
        for label, out in (("port", env[n].numpy()), ("jax", a)):
            err = np.abs(out.astype(np.float64) - value)
            share = np.max(err / np.maximum(bound, 1e-300))
            print(f"{n} {label}: {share:.3g} of the float64 bound")
            assert share <= 1.0, f"{n} {label}: {share:.3g} of the bound"
    dets, nums = _port_nms_on(op, jv[3], jv[4])
    np.testing.assert_array_equal(dets, jv[5])
    np.testing.assert_array_equal(nums, jv[6].astype(np.int64))
    assert (dets[:, :, 0] >= 0).sum() > 0


def test_object_detection_example_trains_and_serves(yolo, tmp_path):
    """``examples/object_detection.py``'s flow on the port: 5 Adam steps from
    the JAX startup state, then ``save_inference_model`` of ``yolov3_infer``
    with the trained weights and the port's ``Predictor`` on it, equal to the
    executor's run of the same program."""
    feed, init, _, _ = yolo
    main, _, fetch = _program(pt, _yolo_train(t_yolo))
    outs, scope = _port_run(main, feed, fetch, 5, init)
    infer, _, (dets, nums) = _program(pt, _yolo_infer(t_yolo))
    request = {"img": feed["img"][:1], "img_size": np.full((1, 2), 64, np.int32)}
    with pt.scope_guard(scope):
        exe = pt.Executor(pt.CPUPlace())
        pt.io.save_inference_model(str(tmp_path), ["img", "img_size"], [dets, nums], exe,
                                   main_program=infer)
        want = exe.run(infer, feed=request, fetch_list=[dets, nums])
    got = Predictor(str(tmp_path), device="cpu").run(request)
    assert got[0].shape == (1, 10, 6) and got[1].shape == (1,)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    k = int(got[1][0])
    assert 0 <= k <= 10 and (got[0][0, k:, 0] == -1).all()


def test_yolov3_infer_keeps_class_zero():
    """YOLO has no background class: the NMS must not suppress class 0 (the
    JAX test's case, on the port's program)."""
    main, _, _ = _program(pt, _yolo_infer(t_yolo))
    nms_ops = [op for op in main.global_block().ops if op.type == "multiclass_nms"]
    assert nms_ops and all(op.attrs["background_label"] == -1 for op in nms_ops)


# ------------------------------------------- Faster R-CNN, RetinaNet, Mask R-CNN

FRCNN_TINY = dict(scale=0.125, stage_blocks=(1, 1, 1), num_classes=5,
                  anchor_sizes=(32, 64), aspect_ratios=(1.0,), post_nms_top_n=16)
RETINA_TINY = dict(scale=0.1, levels=2, num_classes=5, n_convs=1)
MRCNN_TINY = dict(scale=0.1, levels=2, num_classes=4, post_nms_top_n=12,
                  roi_resolution=4, mask_resolution=4)


def _frcnn_feed():
    rng = np.random.RandomState(0)
    boxes = np.zeros((2, 3, 4), np.float32)
    boxes[:, 0] = [8, 8, 28, 28]
    boxes[:, 1] = [36, 30, 60, 50]
    return {"img": rng.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32), "gt_box": boxes,
            "gt_label": rng.randint(1, 5, (2, 3)).astype(np.int32),
            "im_info": np.tile(np.array([[64, 64, 1.0]], np.float32), (2, 1))}


def _retina_feed():
    rng = np.random.RandomState(0)
    return {"img": rng.uniform(0, 1, (1, 3, 64, 64)).astype(np.float32),
            "gt_box": np.array([[[8, 8, 40, 40], [30, 20, 62, 60]]], np.float32),
            "gt_label": np.array([[1, 3]], np.int32),
            "im_info": np.array([[64, 64, 1.0]], np.float32)}


def _mrcnn_feed():
    feed = _retina_feed()
    feed["gt_box"] = np.array([[[4, 4, 28, 28], [32, 36, 60, 58]]], np.float32)
    masks = np.zeros((1, 2, 32, 32), np.float32)
    masks[0, 0, 2:14, 2:14] = 1
    masks[0, 1, 18:28, 16:30] = 1
    feed["gt_masks"] = masks
    return feed


def _train_build(kind, model):
    def build(pkg):
        n, g = (2, 3) if kind == "frcnn" else (1, 2)
        img = pkg.data("img", [n, 3, 64, 64], "float32", **A)
        gt_box = pkg.data("gt_box", [n, g, 4], "float32", **A)
        gt_label = pkg.data("gt_label", [n, g], "int32", **A)
        im_info = pkg.data("im_info", [n, 3], "float32", **A)
        if kind == "frcnn":
            total = model.faster_rcnn(img, gt_box, gt_label, im_info, batch_size=n,
                                      **FRCNN_TINY)[0]
        elif kind == "retina":
            total = model.retinanet(img, gt_box, gt_label, im_info, batch_size=n,
                                    **RETINA_TINY)[0]
        else:
            gt_masks = pkg.data("gt_masks", [n, g, 32, 32], "float32", **A)
            total = model.mask_rcnn(img, gt_box, gt_label, gt_masks, im_info, batch_size=n,
                                    **MRCNN_TINY)[0]
        pkg.optimizer.Adam(1e-3).minimize(total)
        return [total]
    return build


def _infer_build(kind, model):
    def build(pkg):
        n = 2 if kind == "frcnn" else 1
        img = pkg.data("img", [n, 3, 64, 64], "float32", **A)
        im_info = pkg.data("im_info", [n, 3], "float32", **A)
        if kind == "frcnn":
            return list(model.faster_rcnn_infer(img, im_info, batch_size=n, keep_top_k=20,
                                                **FRCNN_TINY))
        if kind == "retina":
            return [model.retinanet_infer(img, im_info, batch_size=n, keep_top_k=20,
                                          **RETINA_TINY)]
        return list(model.mask_rcnn_infer(img, im_info, batch_size=n, keep_top_k=10,
                                          **MRCNN_TINY))
    return build


MODELS = {"frcnn": (j_frcnn, t_frcnn, _frcnn_feed), "retina": (j_retina, t_retina, _retina_feed),
          "mrcnn": (j_mrcnn, t_mrcnn, _mrcnn_feed)}


@pytest.fixture(scope="module", params=sorted(MODELS))
def detector(request):
    """3 Adam steps of one detector in the JAX package."""
    kind = request.param
    jmodel, tmodel, feed_fn = MODELS[kind]
    feed = feed_fn()
    main, startup, fetch = _program(fluid, _train_build(kind, jmodel))
    init, outs, _ = _jax_run(main, startup, feed, fetch, 3)
    return kind, feed, init, _losses(outs)


def test_detector_trains_and_serves_as_jax(detector):
    kind, feed, init, jlosses = detector
    jmodel, tmodel, _ = MODELS[kind]
    main, _, fetch = _program(pt, _train_build(kind, tmodel))
    assert _persistables(main) == sorted(init)
    outs, _ = _port_run(main, feed, fetch, 3, init)
    _assert_losses(_losses(outs), jlosses)
    sfeed = {"img": feed["img"], "im_info": feed["im_info"]}
    jv, tv, op = _serve_both(_infer_build(kind, jmodel), _infer_build(kind, tmodel), sfeed,
                             init)
    _assert_served(jv, tv, op)
    if kind == "mrcnn":      # the served detections, then the mask head's probabilities
        np.testing.assert_array_equal(tv[4][..., 0], jv[4][..., 0])
        np.testing.assert_allclose(tv[4], jv[4], **HEAD_TOL)
        np.testing.assert_allclose(tv[6], jv[6], **HEAD_TOL)


# ------------------------------------------------- the SSD composites of layers/

def _ssd_build(pkg):
    """``multi_box_head`` over two maps, ``ssd_loss`` on its priors and
    ``detection_output`` (decode + softmax + NMS): the composite layers no
    detector of ``models/`` calls."""
    A = dict(append_batch_size=False)
    f1 = pkg.data("f1", [1, 8, 8, 8], "float32", **A)
    f2 = pkg.data("f2", [1, 8, 4, 4], "float32", **A)
    img = pkg.data("img", [1, 3, 64, 64], "float32", **A)
    gb = pkg.data("gt_box", [3, 4], "float32", **A)
    gl = pkg.data("gt_label", [3, 1], "int64", **A)
    locs, confs, boxes, variances = pkg.layers.multi_box_head(
        [f1, f2], img, base_size=64, num_classes=5, aspect_ratios=[[1.0], [1.0, 2.0]],
        min_sizes=[16.0, 32.0], max_sizes=[None, None], flip=False)
    loss = pkg.layers.ssd_loss(pkg.layers.reshape(locs, [-1, 4]),
                               pkg.layers.reshape(confs, [-1, 5]), gb, gl, boxes, variances)
    dets = pkg.layers.detection_output(locs, confs, boxes, variances, nms_top_k=20,
                                       keep_top_k=10, score_threshold=0.05)
    pkg.optimizer.Adam(0.01).minimize(loss)
    return [loss, dets]


def test_ssd_composites_train_and_detect_as_jax():
    rng = np.random.RandomState(3)
    feed = {"f1": rng.randn(1, 8, 8, 8).astype("float32"),
            "f2": rng.randn(1, 8, 4, 4).astype("float32"),
            "img": rng.rand(1, 3, 64, 64).astype("float32"),
            "gt_box": np.array([[0.1, 0.1, 0.4, 0.45], [0.5, 0.2, 0.9, 0.6],
                                [0.3, 0.6, 0.7, 0.95]], "float32"),
            "gt_label": np.array([[1], [3], [4]], "int64")}
    jmain, jstart, jfetch = _program(fluid, _ssd_build)
    tmain, _, tfetch = _program(pt, _ssd_build)
    assert [v.name for v in tfetch] == [v.name for v in jfetch]
    init, jouts, _ = _jax_run(jmain, jstart, feed, jfetch, 3)
    touts, _ = _port_run(tmain, feed, tfetch, 3, init)
    _assert_losses(_losses(touts), _losses(jouts))
    jdets, tdets = jouts[0][1], touts[0][1]
    np.testing.assert_array_equal(tdets[..., 0], jdets[..., 0])
    np.testing.assert_allclose(tdets, jdets, **HEAD_TOL)
    assert (tdets[..., 0] >= 0).any()
