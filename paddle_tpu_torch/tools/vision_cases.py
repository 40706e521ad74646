"""The case table of the vision op types ``depthwise_conv2d``, ``conv3d``,
``conv3d_transpose``, ``pool3d``, ``group_norm``, ``instance_norm``,
``prelu``, ``sync_batch_norm`` and ``space_to_depth`` (and ``fsp``, which
``contrib.slim``'s ``FSPDistiller`` lowers to), at two sizes:

- ``CASES``: small shapes, each held against the JAX lowering on the CPU,
  forward and generic grad (``tests/test_torch_vision_ops.py``), at
  ``op_cases``' f32 tolerance ``atol 1e-5, rtol 1e-5`` (the two sides sum
  convolutions and statistics in other orders, a few ulps);
- ``card_cases()``: shapes of the models these ops serve (MobileNet-v1's 3x3
  depthwise layers, a C3D block, a GroupNorm ResNet stage with 32 groups,
  an instance-normalised style-transfer layer, a ResNet-50 stage's batch
  norm, the space-to-depth stem of ResNet-50 at 224 x 224), run on the
  card against the CPU port (``chip_smoke.py`` phase 23 C); built when
  called (about 600 MB of inputs).

    from paddle_tpu_torch.tools import vision_cases as vc
    outs = vc.forward(vc.CASES["group_norm"], "cpu")
    grads = vc.grad(vc.CASES["group_norm"], "cpu", outs)

``grad`` runs the port's generic ``<op>_grad`` with the grad op's slots and
attrs as ``append_backward`` builds them and a seeded cotangent for each
float output of ``Case.grad`` (``op_cases.grad_inputs``' rule).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core import registry
from .op_cases import F32_TOL, Case, cotangent, numpy_outs, r

#: the nine op types this table holds, and ``fsp``
VISION_TYPES = frozenset({"depthwise_conv2d", "conv3d", "conv3d_transpose", "pool3d",
                          "group_norm", "instance_norm", "prelu", "sync_batch_norm",
                          "space_to_depth", "fsp"})

CASES: Dict[str, Case] = {}


def _case(table, name, op, ins, attrs=None, grad=("Out",)):
    assert name not in table, name
    table[name] = Case(op, ins, dict(attrs or {}), "float32", F32_TOL, tuple(grad), False,
                       F32_TOL, {})


def _bn_ins(x, c, seed):
    return {"X": [x], "Scale": [1.0 + r(c, seed=seed, scale=0.1)],
            "Bias": [r(c, seed=seed + 1, scale=0.1)], "Mean": [r(c, seed=seed + 2, scale=0.1)],
            "Variance": [r(c, seed=seed + 3, lo=0.5, hi=1.5)]}


def _norm_ins(x, c, seed):
    return {"X": [x], "Scale": [1.0 + r(c, seed=seed, scale=0.1)],
            "Bias": [r(c, seed=seed + 1, scale=0.1)]}


def _fill(table, card):
    """Both tables from one list: ``s(small, card)`` picks the shape."""
    s = (lambda small, big: big) if card else (lambda small, big: small)
    # depthwise: MobileNet-v1's 3x3 layers (stride 1 at 112 x 112, stride 2 into 28)
    for name, (n, c, h), stride, fmt in (("dw-s1", s((2, 4, 8), (32, 32, 112)), 1, "NCHW"),
                                         ("dw-s2", s((2, 6, 9), (32, 256, 56)), 2, "NCHW"),
                                         ("dw-nhwc", s((2, 4, 6), (32, 512, 14)), 1, "NHWC")):
        shape = (n, c, h, h) if fmt == "NCHW" else (n, h, h, c)
        _case(table, f"depthwise_conv2d-{name}", "depthwise_conv2d",
              {"Input": [r(*shape, seed=1)], "Filter": [r(c, 1, 3, 3, seed=2, scale=0.3)]},
              {"strides": [stride, stride], "paddings": [1, 1], "groups": c,
               "data_format": fmt}, grad=("Output",))
    # conv3d / its transpose / pool3d: a C3D block
    n, ci, co, d, h = s((2, 3, 4, 4, 6), (8, 64, 128, 8, 56))
    _case(table, "conv3d", "conv3d",
          {"Input": [r(n, ci, d, h, h, seed=3)], "Filter": [r(co, ci, 3, 3, 3, seed=4, scale=0.2)]},
          {"strides": [1, 1, 1], "paddings": [1, 1, 1]}, grad=("Output",))
    _case(table, "conv3d-strided", "conv3d",
          {"Input": [r(n, ci, d, h, h, seed=5)], "Filter": [r(co, ci, 3, 3, 3, seed=6, scale=0.2)]},
          {"strides": [1, 2, 2], "paddings": [1, 1, 1]}, grad=("Output",))
    n, ci, co, d, h = s((2, 4, 2, 3, 4), (8, 128, 64, 4, 14))
    _case(table, "conv3d_transpose", "conv3d_transpose",
          {"Input": [r(n, ci, d, h, h, seed=7)], "Filter": [r(ci, co, 4, 4, 4, seed=8, scale=0.2)]},
          {"strides": [2, 2, 2], "paddings": [1, 1, 1]}, grad=("Output",))
    n, c, d, h = s((2, 3, 4, 6), (8, 64, 8, 56))
    x3 = r(n, c, d, h, h, seed=9)
    _case(table, "pool3d-max", "pool3d", {"X": [x3]},
          {"pooling_type": "max", "ksize": [2, 2, 2], "strides": [2, 2, 2], "paddings": [0, 0, 0]})
    _case(table, "pool3d-avg-pad", "pool3d", {"X": [x3]},
          {"pooling_type": "avg", "ksize": [3, 3, 3], "strides": [2, 2, 2],
           "paddings": [1, 1, 1], "exclusive": True})
    _case(table, "pool3d-global", "pool3d", {"X": [x3]},
          {"pooling_type": "avg", "global_pooling": True})
    _case(table, "pool3d-adaptive", "pool3d", {"X": [x3]},
          {"pooling_type": "max", "ksize": [2, 2, 2], "adaptive": True})
    # group norm, 32 groups in a ResNet stage; instance norm in a style layer
    n, c, h, g = s((2, 8, 4, 4), (32, 256, 56, 32))
    _case(table, "group_norm", "group_norm", _norm_ins(r(n, c, h, h, seed=10), c, 11),
          {"groups": g, "epsilon": 1e-5}, grad=("Y",))
    n, c, h = s((2, 3, 5), (16, 64, 128))
    _case(table, "instance_norm", "instance_norm", _norm_ins(r(n, c, h, h, seed=12), c, 13),
          {"epsilon": 1e-5}, grad=("Y",))
    # prelu's three modes
    n, c, h = s((2, 3, 4), (32, 64, 56))
    xp = r(n, c, h, h, seed=14)
    for mode, alpha in (("all", r(1, seed=15, lo=0.1, hi=0.4)),
                        ("channel", r(c, seed=16, lo=0.1, hi=0.4)),
                        ("element", r(c * h * h, seed=17, lo=0.1, hi=0.4))):
        _case(table, f"prelu-{mode}", "prelu", {"X": [xp], "Alpha": [alpha]}, {"mode": mode})
    # sync_batch_norm in train and test mode
    n, c, h = s((4, 3, 5), (32, 256, 56))
    for mode, is_test in (("train", False), ("test", True)):
        _case(table, f"sync_batch_norm-{mode}", "sync_batch_norm",
              _bn_ins(r(n, c, h, h, seed=18), c, 19),
              {"momentum": 0.9, "epsilon": 1e-5, "is_test": is_test, "data_layout": "NCHW"},
              grad=("Y",))
    # space_to_depth: ResNet-50's NCHW stem input
    n, c, h = s((2, 3, 8), (128, 3, 224))
    _case(table, "space_to_depth", "space_to_depth", {"X": [r(n, c, h, h, seed=20)]},
          {"blocksize": 2})
    n, c1, c2, h = s((2, 4, 5, 6), (32, 64, 64, 56))
    _case(table, "fsp", "fsp", {"X": [r(n, c1, h, h, seed=21)], "Y": [r(n, c2, h, h, seed=22)]})


_fill(CASES, card=False)


def card_cases() -> Dict[str, Case]:
    """The same cases at the models' shapes."""
    table: Dict[str, Case] = {}
    _fill(table, card=True)
    return table


def _tensors(ins, device):
    return {s: [torch.from_numpy(np.array(a)).to(device) for a in v] for s, v in ins.items()}


def forward(c: Case, device) -> Dict[str, list]:
    """The port's lowering of case ``c`` on ``device``."""
    return registry.get(c.op).lower(registry.LowerCtx(dict(c.attrs), device),
                                    _tensors(c.ins, device))


def grad_inputs(c: Case, outs: Dict[str, list]):
    """(the grad op's numpy inputs, its attrs) for case ``c`` given its
    forward outputs ``outs``: the forward's inputs and outputs and a seeded
    cotangent for each float output of ``c.grad``."""
    gins = {s: list(v) for s, v in c.ins.items()}
    for s, vals in numpy_outs(outs).items():
        gins[s] = list(vals)
        if s in c.grad:
            gins[s + "@GRAD"] = [cotangent(np.shape(v), i) for i, v in enumerate(vals)]
    gattrs = dict(c.attrs, __fwd_attrs__=dict(c.attrs), __fwd_out_slots__=sorted(outs),
                  __fwd_out0__="out0")
    return gins, gattrs


def grad(c: Case, device, outs: Dict[str, list]) -> Dict[str, list]:
    """The port's generic ``<op>_grad`` of case ``c`` on ``device``."""
    gins, gattrs = grad_inputs(c, outs)
    return registry.get(c.op + "_grad").lower(registry.LowerCtx(gattrs, device),
                                              _tensors(gins, device))
