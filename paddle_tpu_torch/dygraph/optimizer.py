"""Dygraph optimizers: eager updates through the optimizer-op lowerings.

The port's copy of ``paddle_tpu/dygraph/optimizer.py``: ``minimize(loss)``
is the tape's ``backward`` and then each parameter's update through the
registry's ``sgd`` / ``momentum`` / ``adam`` lowering, the ops the static
path runs (off a grouped ``multi_tensor_update``), so static and eager share
the update math. An optimizer's state and its learning rate (one device
tensor, made once) live on the parameters' device.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..core import registry
from ..core.registry import LowerCtx
from .base import VarBase, backward


class DygraphOptimizer:
    def __init__(self, learning_rate):
        self._lr = learning_rate
        self._state: Dict[int, dict] = {}
        self._lr_t: Dict[torch.device, torch.Tensor] = {}

    def _lr_arr(self, device):
        t = self._lr_t.get(device)
        if t is None:
            t = self._lr_t[device] = torch.tensor([float(self._lr)], dtype=torch.float32,
                                                  device=device)
        return t

    def minimize(self, loss: VarBase, parameter_list: List[VarBase] = None):
        backward(loss)
        params = parameter_list or []
        for p in params:
            if p.grad is None:
                continue
            with torch.no_grad():
                self._apply(p)
            p.clear_gradient()
        return None, None

    def _apply(self, p: VarBase):
        raise NotImplementedError


def _zeros(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.value.device)


class SGDOptimizer(DygraphOptimizer):
    def _apply(self, p):
        d = registry.get("sgd")
        outs = d.lower(LowerCtx({}, p.value.device),
                       {"Param": [p.value], "Grad": [p.grad],
                        "LearningRate": [self._lr_arr(p.value.device)]})
        p.value = outs["ParamOut"][0]


class MomentumOptimizer(DygraphOptimizer):
    def __init__(self, learning_rate, momentum=0.9, use_nesterov=False):
        super().__init__(learning_rate)
        self._mu = momentum
        self._nesterov = use_nesterov

    def _apply(self, p):
        st = self._state.setdefault(id(p), {"velocity": _zeros(p)})
        d = registry.get("momentum")
        outs = d.lower(
            LowerCtx({"mu": self._mu, "use_nesterov": self._nesterov}, p.value.device),
            {"Param": [p.value], "Grad": [p.grad], "Velocity": [st["velocity"]],
             "LearningRate": [self._lr_arr(p.value.device)]})
        p.value = outs["ParamOut"][0]
        st["velocity"] = outs["VelocityOut"][0]


class AdamOptimizer(DygraphOptimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8):
        super().__init__(learning_rate)
        self._b1, self._b2, self._eps = beta1, beta2, epsilon

    def _apply(self, p):
        dev = p.value.device
        st = self._state.get(id(p))
        if st is None:
            st = self._state[id(p)] = {
                "m1": _zeros(p), "m2": _zeros(p),
                "b1p": torch.tensor([self._b1], dtype=torch.float32, device=dev),
                "b2p": torch.tensor([self._b2], dtype=torch.float32, device=dev)}
        d = registry.get("adam")
        outs = d.lower(
            LowerCtx({"beta1": self._b1, "beta2": self._b2, "epsilon": self._eps}, dev),
            {"Param": [p.value], "Grad": [p.grad], "Moment1": [st["m1"]],
             "Moment2": [st["m2"]], "Beta1Pow": [st["b1p"]],
             "Beta2Pow": [st["b2p"]], "LearningRate": [self._lr_arr(dev)]})
        p.value = outs["ParamOut"][0]
        st["m1"], st["m2"] = outs["Moment1Out"][0], outs["Moment2Out"][0]
        st["b1p"], st["b2p"] = outs["Beta1PowOut"][0], outs["Beta2PowOut"][0]
