"""Dygraph -> static capture: TracedLayer (reference
python/paddle/fluid/dygraph/jit.py TracedLayer + _trace).

The port's copy of ``paddle_tpu/dygraph/jit.py``. The dygraph tape already
records (op_type, attrs, ins, outs) for every executed op (base.py
trace_op), so tracing is a tape -> Program transcription, with no second
tracer. Inputs become feed vars (batch dim -1), Layer parameters become
persistables carrying their live tensors in a private Scope, and the result
is an ordinary port Program: it runs on the port's ``Executor`` (captured as
a CUDA graph on the card), prunes, and exports through
``save_inference_model`` (then serves via ``inference.Predictor``). The
executor runs on the device of the traced tensors, not on the default card.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .base import VarBase, _state
from .nn import Layer


class TracedLayer:
    """Usage (reference jit.py:TracedLayer.trace)::

        model = MyLayer()
        out, traced = TracedLayer.trace(model, [to_variable(x)])
        pred = traced([x2])                      # static executor run
        traced.save_inference_model("exported")  # -> inference.Predictor
    """

    def __init__(self, program, startup, feed_names, fetch_names, scope, device=None):
        self.program = program
        self._startup = startup
        self.feed_names = feed_names
        self.fetch_names = fetch_names
        self._scope = scope
        self._device = torch.device(device) if device is not None else None
        self._exe = None

    # -- tracing -----------------------------------------------------------------------
    @staticmethod
    def trace(layer: Layer, inputs: Sequence[VarBase]):
        """Run ``layer(*inputs)`` once under the tape and transcribe the tape
        into a static Program. Returns (outputs, TracedLayer)."""
        from .. import unique_name
        from ..core.executor import Scope
        from ..framework import Program, program_guard

        if not isinstance(layer, Layer):
            raise TypeError("TracedLayer.trace expects a dygraph Layer")
        inputs = list(inputs)
        was_enabled = _state.enabled
        _state.enabled = True
        _state.trace_all = True   # capture non-differentiable ops too
        start = len(_state.tape)
        try:
            outputs = layer(*inputs)
        finally:
            _state.enabled = was_enabled
            _state.trace_all = False
            # the trace captured extra (non-differentiable / stop-gradient)
            # entries autograd must never see; the differentiable forward
            # entries STAY so backward() through the returned outputs works
            entries = _state.tape[start:]
            _state.tape[start:] = [e for e in entries
                                   if not e.get("_trace_only")]
        out_list = (list(outputs) if isinstance(outputs, (list, tuple))
                    else [outputs])

        program, startup = Program(), Program()
        scope = Scope()
        block = program.global_block()
        names = {}           # id(VarBase) -> var name
        param_ids = {id(p): p for p in layer.parameters()}
        feed_names = []
        with unique_name.guard(), program_guard(program, startup):
            for i, v in enumerate(inputs):
                n = f"traced_in_{i}"
                names[id(v)] = n
                var = block.create_var(n, (-1,) + tuple(v.shape[1:]),
                                       v.dtype)
                var.is_data = True
                feed_names.append(n)

            def ensure(v):
                if id(v) in names:
                    return names[id(v)]
                if id(v) in param_ids:
                    n = unique_name.generate("traced_param")
                else:
                    # a constant captured from outside the trace (e.g. a
                    # to_variable literal): freeze it as a persistable too
                    n = unique_name.generate("traced_const")
                names[id(v)] = n
                var = block.create_var(n, tuple(v.shape), v.dtype)
                var.persistable = True
                scope.set_var(n, v.value)
                return n

            for e in entries:
                ins, outs = {}, {}
                for slot, vs in e["ins"].items():
                    ins[slot] = [ensure(v) if v is not None else "@EMPTY@"
                                 for v in vs]
                for slot, vs in e["outs"].items():
                    outs[slot] = []
                    for v in vs:
                        if v is None:
                            outs[slot].append("@EMPTY@")
                            continue
                        n = names.get(id(v))
                        if n is None:
                            n = unique_name.generate("traced_tmp")
                            names[id(v)] = n
                            block.create_var(n, tuple(v.shape), v.dtype)
                        outs[slot].append(n)
                block.append_op(e["type"], ins, outs, dict(e["attrs"]),
                                infer_shape=False)

        fetch_names = []
        for v in out_list:
            n = names.get(id(v))
            if n is None:
                raise ValueError(
                    "TracedLayer: an output was not produced by any traced "
                    "op (is it an input/constant passed through?)")
            fetch_names.append(n)
        device = next((v.value.device for v in inputs), None)
        return outputs, TracedLayer(program, startup, feed_names,
                                    fetch_names, scope, device)

    # -- running -----------------------------------------------------------------------
    def _executor(self):
        from ..core.executor import Executor
        if self._exe is None:
            self._exe = Executor(self._device)
        return self._exe

    def __call__(self, inputs):
        from ..core.executor import scope_guard
        feed = {n: v.value if isinstance(v, VarBase) else v
                for n, v in zip(self.feed_names, inputs)}
        with scope_guard(self._scope):
            return self._executor().run(self.program, feed=feed,
                                        fetch_list=self.fetch_names)

    def save_inference_model(self, dirname, feed=None, fetch=None):
        """Export for serving (feeds/fetches by POSITION like the reference)."""
        from .. import io
        from ..core.executor import scope_guard
        feed_names = ([self.feed_names[i] for i in feed] if feed
                      else self.feed_names)
        fetch_sel = ([self.fetch_names[i] for i in fetch] if fetch
                     else self.fetch_names)
        fetch_vars = [self.program.global_block().var(n) for n in fetch_sel]
        with scope_guard(self._scope):
            return io.save_inference_model(
                dirname, feed_names, fetch_vars, self._executor(), self.program)
