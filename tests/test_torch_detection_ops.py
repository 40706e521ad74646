"""The port's detection ops and the five vision nn ops against the JAX
package's lowerings, op by op, on the same seeded numpy inputs, on the CPU.

Every case of ``paddle_tpu_torch/tools/detection_cases.py`` lowers its op
in both registries with the same attrs and compares every output slot, at
the case's tolerance (stated there: exact for integer outputs and for
``multiclass_nms``'s selected rows, ``Index`` and ``NmsRoisNum``; ``rtol
1e-6`` for f32 box arithmetic; ``rtol 1e-5`` for ``yolov3_loss``,
``roi_align``, the resize contractions and ``conv2d_transpose``). The JAX
side runs as ``tests/test_detection.py`` runs it: its lowerings on the CPU
(no Pallas kernel lies on these ops), here under one ``jax.jit`` a case.

Then the reference-side faults this slice records (ROADMAP 3.22-3.24),
each held in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import registry as jreg
import paddle_tpu_torch as pt
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.tools.detection_cases import (CASES, DETECTION_TYPES, NN_TYPES, SUM,
                                                   nms_attrs, nms_inputs, randn)


def _lower_both(op_type, ins, attrs):
    # the JAX lowering under one jit: one compile a case, not one per primitive
    jlower = jreg.get(op_type).lower
    jouts = jax.jit(lambda jins: jlower(jreg.LowerCtx(dict(attrs)), jins))(
        {s: [jnp.asarray(a) for a in v] for s, v in ins.items()})
    touts = treg.get(op_type).lower(
        treg.LowerCtx(dict(attrs)),
        {s: [torch.from_numpy(np.array(a)) for a in v] for s, v in ins.items()})
    return jouts, touts


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax(case):
    op_type, ins, attrs, tol = CASES[case]
    jouts, touts = _lower_both(op_type, ins, attrs)
    assert sorted(touts) == sorted(jouts)
    for slot in jouts:
        for j, t in zip(jouts[slot], touts[slot]):
            a, b = np.asarray(j), t.detach().numpy()
            assert a.shape == b.shape, (slot, a.shape, b.shape)
            if a.dtype.kind in "iub":
                np.testing.assert_array_equal(b, a, err_msg=f"{case} {slot}")
            else:
                np.testing.assert_allclose(b, a, err_msg=f"{case} {slot}", **tol)


def test_every_op_type_has_a_case_and_the_jax_flags():
    """The 24 detection op types and the 5 nn ones each have a case, and each
    is registered with the JAX op's ``grad`` and ``nondiff_inputs``."""
    covered = {c[0] for c in CASES.values()}
    assert DETECTION_TYPES | NN_TYPES <= covered
    assert len(DETECTION_TYPES) == 24
    for t in DETECTION_TYPES | NN_TYPES:
        j, p = jreg.get(t), treg.get(t)
        assert (p.grad is None) == (j.grad is None), t
        assert set(p.nondiff_inputs) == set(j.nondiff_inputs), t


def test_nms_index_on_ties_and_pads():
    """On the tie-heavy input every Index row is the kept boxes' rows of
    BBoxes, -1 past NmsRoisNum, and the ranks follow the scores down."""
    _, ins, attrs, _ = CASES["multiclass_nms-ties-bg-1"]
    _, touts = _lower_both("multiclass_nms", ins, attrs)
    out, idx, num = (touts[k][0].numpy() for k in ("Out", "Index", "NmsRoisNum"))
    assert idx.dtype == np.int64 and num.dtype == np.int64
    for n in range(out.shape[0]):
        k = int(num[n])
        assert 0 < k < out.shape[1]
        assert (idx[n, k:] == -1).all() and (out[n, k:, 0] == -1).all()
        np.testing.assert_array_equal(out[n, :k, 2:], ins["BBoxes"][0][n, idx[n, :k]])
        assert (np.diff(out[n, :k, 1]) <= 0).all()


def test_roi_pool_and_align_grads_flow_to_x():
    """The two RoI ops differentiate wrt X only (ROIs and RoisNum carry no
    gradient), as their JAX registrations say; the values are held by
    ``tests/test_torch_grad.py``'s cases."""
    for t in ("roi_align", "roi_pool", "yolov3_loss", "sigmoid_focal_loss"):
        assert treg.get(t).grad == "auto"
    assert treg.get("roi_align").nondiff_inputs == {"ROIs", "RoisNum"}


def _resize_program(pkg, align_corners):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [2, 5, 7], "float32")
        y = pkg.layers.image_resize(x, out_shape=(9, 4), resample="BILINEAR",
                                    align_corners=align_corners, align_mode=0)
        z = pkg.layers.resize_nearest(x, scale=2, align_corners=align_corners)
    return main, startup, [y, z]


def test_3_22_image_resize_ignores_align_corners_in_both_packages():
    """ROADMAP 3.22: ``image_resize`` builds the same op whatever
    ``align_corners`` / ``align_mode`` say, and resizes with half-pixel
    centres; the port keeps that. True and False give the same outputs, in
    each package and across them."""
    x = randn(2, 2, 5, 7, seed=50)
    outs = {}
    for name, pkg, place in (("jax", fluid, None), ("port", pt, pt.CPUPlace())):
        for ac in (True, False):
            main, startup, fetch = _resize_program(pkg, ac)
            ops = main.global_block().ops
            assert all("align_corners" not in op.attrs for op in ops)
            exe = pkg.Executor(place) if place is not None else pkg.Executor()
            with pkg.scope_guard(pkg.Scope()):
                exe.run(startup)
                outs[name, ac] = [np.asarray(v) for v in
                                  exe.run(main, feed={"x": x}, fetch_list=fetch)]
    for name in ("jax", "port"):
        for a, b in zip(outs[name, True], outs[name, False]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(outs["port", True], outs["jax", True]):
        np.testing.assert_allclose(a, b, **SUM)


def test_3_23_multiclass_nms_raises_on_nms_eta_in_both_packages():
    """ROADMAP 3.23: adaptive NMS (``nms_eta`` != 1) is not supported by the
    fixed-shape sweep; both packages raise, and accept 1.0."""
    ins = nms_inputs(51)
    for eta in (0.5, 0.9):
        for reg, conv in ((jreg, jnp.asarray), (treg, lambda a: torch.from_numpy(a))):
            with pytest.raises(NotImplementedError, match="nms_eta"):
                reg.get("multiclass_nms").lower(
                    reg.LowerCtx(nms_attrs(nms_eta=eta)),
                    {s: [conv(a) for a in v] for s, v in ins.items()})
    _lower_both("multiclass_nms", ins, nms_attrs(nms_eta=1.0))


def test_3_24_generate_proposal_labels_ignores_use_random_in_both_packages():
    """ROADMAP 3.24: ``use_random`` is accepted and not read (no sampling in
    the fixed-shape form): the layer builds the same op either way in both
    packages, and the op's outputs are the same."""
    for pkg in (fluid, pt):
        descs = []
        for use_random in (True, False):
            main, startup = pkg.Program(), pkg.Program()
            with pkg.unique_name.guard(), pkg.program_guard(main, startup):
                rois = pkg.data("rois", [2, 8, 4], "float32", append_batch_size=False)
                cls = pkg.data("cls", [2, 3], "int32", append_batch_size=False)
                gt = pkg.data("gt", [2, 3, 4], "float32", append_batch_size=False)
                im = pkg.data("im", [2, 3], "float32", append_batch_size=False)
                pkg.layers.generate_proposal_labels(rois, cls, None, gt, im, class_nums=5,
                                                    use_random=use_random)
            op = next(o for o in main.global_block().ops
                      if o.type == "generate_proposal_labels")
            assert "use_random" not in op.attrs
            descs.append(sorted(op.attrs.items()))
        assert descs[0] == descs[1]
