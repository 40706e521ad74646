"""Collective layer wrappers (the port's copy of ``paddle_tpu/layers/collective.py``; reference
python/paddle/fluid/layers/collective.py:20-172).

These append c_* ops to the current program. With no process group bound to
their axis they are the identity; in a run that binds one (the executor's
data-parallel path binds ``dp``) they are ``torch.distributed`` collectives
(``ops/collective.py``).
"""
from __future__ import annotations

from ..layer_helper import LayerHelper


def _one_out(op_type, x, attrs, out=None):
    helper = LayerHelper(op_type)
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs=attrs)
    return helper.main_program.current_block().var(out.name)


def _allreduce(x, out=None, reduce_type="sum", sync_mode=False, axis_name="dp"):
    """Reference layers/collective.py:20 (``sync_mode`` accepted for parity:
    a collective's result is ordered on the compute stream already)."""
    if reduce_type not in ("sum", "max", "min", "prod", "avg"):
        raise ValueError(f"unsupported reduce_type {reduce_type!r}")
    return _one_out(f"c_allreduce_{reduce_type}", x,
                    {"axis_name": axis_name}, out=out)


def _broadcast(x, root=0, sync_mode=False, axis_name="dp"):
    return _one_out("c_broadcast", x, {"root": root, "axis_name": axis_name})


def _c_allreduce(x, out=None, reduce_type="sum", use_calc_stream=False,
                 axis_name="dp"):
    return _allreduce(x, out=out, reduce_type=reduce_type, axis_name=axis_name)


def _c_allgather(x, nranks=None, ring_id=0, use_calc_stream=False,
                 axis_name="dp"):
    """``nranks`` / ``ring_id`` accepted for reference parity; the axis name
    names the group."""
    return _one_out("c_allgather", x, {"axis_name": axis_name})


def _c_broadcast(x, root=0, use_calc_stream=False, axis_name="dp"):
    return _broadcast(x, root=root, axis_name=axis_name)


def _c_reducescatter(x, nranks=None, ring_id=0, use_calc_stream=False,
                     axis_name="dp"):
    return _one_out("c_reducescatter", x, {"axis_name": axis_name})


def _c_sync_calc_stream(x):
    return _one_out("c_sync_calc_stream", x, {})


def _c_sync_comm_stream(x, ring_id=0):
    return _one_out("c_sync_comm_stream", x, {})
