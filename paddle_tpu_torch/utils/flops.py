"""Static FLOP accounting over a Program, and the card's peak table (for MFU).

The port's copy of ``paddle_tpu/utils/flops.py``: ``program_flops`` counts
the matmul-class ops of one run of a Program from their shapes (``mul``,
``matmul``, the convolutions, ``fused_attention``; a grad op counts twice its
forward: dX and dW are each one product of the forward's size). Elementwise
and reduction FLOPs are left out, so an MFU computed from this count is a
slight underestimate: the safe direction for a performance claim.

The peak table is keyed by ``torch.cuda.get_device_name()`` and by the
program's product dtype. The JAX package's TPU rows mean nothing on this
card and are not here. An unknown card gives None, never a guess.
"""
from __future__ import annotations

from typing import Dict, Optional

#: dense peak FLOP/s of the card's matmul units, by device name and dtype.
#: NVIDIA's H100 SXM data sheet (the 700 W part): 989.4 TFLOP/s in bf16 and
#: fp16 on the tensor cores, 66.9 TFLOP/s in float32 outside them (the port
#: runs float32 products in full float32: TF32 is off, ``resolve_device``).
_PEAK = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989.4e12, "float16": 989.4e12,
                              "float32": 66.9e12},
}

#: device-memory bandwidth, bytes/s (the same data sheet: HBM3 at 3.35 TB/s)
_PEAK_HBM = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def device_peak_flops(device_kind: str, dtype: str = "bfloat16") -> Optional[float]:
    """Peak FLOP/s of ``device_kind`` for products in ``dtype`` (bf16 by
    default, as the JAX call), or None when the card or dtype is unknown."""
    return _PEAK.get(device_kind, {}).get(dtype)


def device_peak_hbm_bw(device_kind: str) -> Optional[float]:
    """Peak device-memory bytes/s of ``device_kind``, or None if unknown."""
    return _PEAK_HBM.get(device_kind)


def bandwidth_sanity(value_gbps: float, device_kind: str, domain: str = "hbm"):
    """Clamp a measured bandwidth against the card's physical peak.

    Returns (reported_gbps, suspect, bound_gbps). An estimate above the peak
    is reported AS the peak with suspect=True, so an impossible number is
    never recorded as a measurement. Only ``domain="hbm"`` has a table here;
    any other domain, or an unknown card, passes the value through with
    bound None."""
    peak = _PEAK_HBM.get(device_kind) if domain == "hbm" else None
    if peak is None:
        return value_gbps, False, None
    bound = peak / 1e9
    if value_gbps > bound:
        return bound, True, bound
    return value_gbps, False, bound


def _subst(shape, batch):
    return tuple(batch if d == -1 else int(d) for d in shape)


def _prod(xs):
    p = 1
    for x in xs:
        p *= int(x)
    return p


def _matmul_flops(xs, ys, trans_x, trans_y):
    if len(xs) < 2 or len(ys) < 2:
        return 0
    m = xs[-1] if trans_x else xs[-2]
    k = xs[-2] if trans_x else xs[-1]
    n = ys[-2] if trans_y else ys[-1]
    batch = _prod(max(xs[:-2], ys[:-2], key=len) or (1,))
    return 2 * batch * m * k * n


def _op_flops(op, shape_of, batch) -> int:
    """2 x the multiply-adds of one forward op desc; 0 for non-matmul ops."""
    t = op.type

    def shp(slot, i=0):
        names = op.inputs.get(slot) or ()
        if i >= len(names):
            return None
        s = shape_of(names[i])
        return None if s is None else _subst(s, batch)

    def oshp(slot, i=0):
        names = op.outputs.get(slot) or ()
        if i >= len(names):
            return None
        s = shape_of(names[i])
        return None if s is None else _subst(s, batch)

    if t == "mul":
        xs, ys = shp("X"), shp("Y")
        if xs is None or ys is None:
            return 0
        ncol = op.attr("x_num_col_dims") or 1
        m = _prod(xs[:ncol])
        k = _prod(xs[ncol:])
        n = _prod(ys[1:]) if len(ys) > 1 else 1
        return 2 * m * k * n
    if t == "matmul":
        xs, ys = shp("X"), shp("Y")
        if xs is None or ys is None:
            return 0
        return _matmul_flops(xs, ys, bool(op.attr("transpose_X")),
                             bool(op.attr("transpose_Y")))
    if t in ("conv2d", "depthwise_conv2d", "conv3d"):
        ws, outs = shp("Filter"), oshp("Output")
        if ws is None or outs is None:
            return 0
        # out elements x (Cin/groups * prod(kernel)) multiply-adds each
        return 2 * _prod(outs) * _prod(ws[1:])
    if t == "conv2d_transpose":
        ws, xs = shp("Filter"), shp("Input")
        if ws is None or xs is None:
            return 0
        return 2 * _prod(xs) * _prod(ws[1:])
    if t == "fused_attention":
        qs = shp("Q")  # [B, H, S, D]
        if qs is None or len(qs) != 4:
            return 0
        B_, H_, S_, D_ = qs
        return 2 * 2 * B_ * H_ * S_ * S_ * D_  # the QK^T and PV products
    return 0


#: the input slot whose dtype is a counted op's product dtype
_OPERAND = {"mul": "X", "matmul": "X", "conv2d": "Input", "depthwise_conv2d": "Input",
            "conv3d": "Input", "conv2d_transpose": "Input", "fused_attention": "Q"}


def _counted(program, batch: int):
    """(forward op view, FLOPs counted for it, is a grad op, its block) for
    every op of ``program`` that counts FLOPs."""
    for block in program.blocks:
        def shape_of(name, _b=block):
            v = _b.find_var_recursive(name)
            return None if v is None else v.shape
        for op in block.ops:
            grad = op.type.endswith("_grad")
            view = _FwdView(op) if grad else op
            n = _op_flops(view, shape_of, batch)
            if n:
                yield view, (2 * n if grad else n), grad, block


def program_flops(program, batch: int) -> Dict[str, int]:
    """Matmul-class FLOPs of one run of ``program`` with -1 dims = ``batch``.

    Grad ops count 2x their forward op. Sub-blocks (scan bodies) are counted
    once per op: a caller with iterated sub-blocks scales them itself.
    Returns {"total": n, "forward": n_fwd, "backward": n_bwd}."""
    fwd = bwd = 0
    for _view, n, grad, _block in _counted(program, batch):
        if grad:
            bwd += n
        else:
            fwd += n
    return {"total": fwd + bwd, "forward": fwd, "backward": bwd}


def product_dtype(program, batch: int = 1) -> str:
    """The dtype of the operands that carry most of ``program``'s counted
    FLOPs (what its MFU divides by the peak of); float32 when nothing is
    counted."""
    by_dtype: Dict[str, int] = {}
    for view, n, _grad, block in _counted(program, batch):
        names = view.inputs.get(_OPERAND[view.type]) or ()
        v = block.find_var_recursive(names[0]) if names else None
        if v is not None:
            by_dtype[v.dtype] = by_dtype.get(v.dtype, 0) + n
    return max(by_dtype, key=by_dtype.get) if by_dtype else "float32"


class _FwdView:
    """A grad op desc seen with its forward op's slots: its inputs carry the
    forward's inputs verbatim, and its forward outputs under the slots its
    ``__fwd_out_slots__`` attr lists (``registry``'s generic grad)."""

    def __init__(self, op):
        self.type = op.type[:-len("_grad")]
        self.inputs = {s: n for s, n in op.inputs.items() if not s.endswith("@GRAD")}
        fwd_outs = op.attr("__fwd_out_slots__") or ()
        self.outputs = {s: n for s, n in op.inputs.items() if s in fwd_outs}
        self._attrs = op.attrs

    def attr(self, name):
        return self._attrs.get(name)
