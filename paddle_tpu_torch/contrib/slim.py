"""Model slimming: pruning and distillation (the port's copy of
``paddle_tpu/contrib/slim.py``: ``Pruner``, ``StructurePruner``,
``compute_magnitude_masks``, ``apply_pruning_masks``, ``sparsity`` and the
``L2Distiller``, ``FSPDistiller`` and ``SoftLabelDistiller``).

Pruning is a rewrite of the Program, as in the JAX package: each mask is
a persistable, non-trainable float32 variable ``{param}@prune_mask``, and
``param = param * mask`` is appended after the optimizer's update, so every
step leaves the pruned weights at exactly zero, and the masks ride
checkpoints and carry across packages by name like any other persistable.
A parameter that is not float32 (a bf16 ResNet's filters) takes the
product through a ``cast`` back to its own dtype: the JAX package writes
the float32 product into the parameter itself, which widens it, and its
next step then fails on the changed dtype (ROADMAP 3.27). The values are
the same: a 0/1 mask times a bf16 weight is exact.

Distillers build loss terms from layers on the default program: merge the
teacher and the student into one program (the teacher's outputs pass
through ``_frozen``) and add the distiller's loss to the task's.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import layers
from ..core.executor import owned_tensor, to_numpy


class Pruner(object):
    """Base class."""

    def prune(self, param):
        raise NotImplementedError


class StructurePruner(Pruner):
    """Group pruning along an axis: ranks the slices of a parameter along
    ``pruning_axis`` by their l1 norm and selects the lowest ``ratio`` of
    them for removal or zeroing."""

    def __init__(self, pruning_axis: Dict[str, int],
                 criterions: Optional[Dict[str, str]] = None):
        self.pruning_axis = dict(pruning_axis)
        self.criterions = dict(criterions or {"*": "l1_norm"})

    def _axis(self, name):
        return self.pruning_axis.get(name, self.pruning_axis.get("*", 0))

    def _criterion(self, name):
        c = self.criterions.get(name, self.criterions.get("*", "l1_norm"))
        if c != "l1_norm":
            raise ValueError(f"criterion {c!r} not supported (l1_norm only, "
                             f"as in the reference)")
        return c

    def cal_pruned_idx(self, name: str, param: np.ndarray, ratio: float,
                       axis: Optional[int] = None) -> List[int]:
        """Indices of the lowest-l1 slices along ``axis``."""
        axis = self._axis(name) if axis is None else axis
        self._criterion(name)
        reduce_axes = tuple(i for i in range(param.ndim) if i != axis)
        scores = np.abs(param).sum(axis=reduce_axes)
        n_prune = int(round(ratio * param.shape[axis]))
        return np.argsort(scores)[:n_prune].tolist()

    def prune_tensor(self, tensor: np.ndarray, pruned_idx: Sequence[int],
                     pruned_axis: int, lazy: bool = False) -> np.ndarray:
        """``lazy=True`` zeroes the slices (mask pruning); ``lazy=False``
        removes them."""
        if lazy:
            out = np.array(tensor)
            sl = [slice(None)] * tensor.ndim
            sl[pruned_axis] = list(pruned_idx)
            out[tuple(sl)] = 0
            return out
        return np.delete(tensor, list(pruned_idx), axis=pruned_axis)


def _select_params(program, params):
    block = program.global_block()
    out = []
    for name, v in block.vars.items():
        if not getattr(v, "trainable", False):
            continue
        if params is None:
            if len(v.shape) >= 2:   # weights, not biases or norm scales
                out.append(v)
        elif any(re.search(p, name) for p in params):
            out.append(v)
    return out


def compute_magnitude_masks(scope, program, ratio: float,
                            params: Optional[Sequence[str]] = None,
                            structured_axis: Optional[int] = None):
    """Masks from the scope's current values, computed on the host.

    ``ratio``: the fraction of the weights (or, with ``structured_axis``, of
    the slices along it) to zero, lowest |w| (l1) first. Returns
    {param name: float32 mask}."""
    masks = {}
    pruner = StructurePruner({"*": structured_axis or 0})
    for v in _select_params(program, params):
        w = to_numpy(scope.find_var(v.name)).astype(np.float32)
        if structured_axis is not None:
            idx = pruner.cal_pruned_idx(v.name, w, ratio, axis=structured_axis)
            mask = pruner.prune_tensor(np.ones_like(w), idx, structured_axis, lazy=True)
        else:
            k = int(ratio * w.size)
            mask = np.ones(w.size, np.float32)
            if k > 0:
                mask[np.argsort(np.abs(w).reshape(-1))[:k]] = 0
            mask = mask.reshape(w.shape)
        masks[v.name] = mask
    return masks


def apply_pruning_masks(program, scope, masks: Dict[str, np.ndarray]):
    """Rewrite ``program`` so that every step applies the masks after the
    optimizer's update (param = param * mask, through a ``cast`` for a
    parameter that is not float32), and zero the current values in place.

    The masks become persistable, non-trainable variables in the scope, on
    the parameters' devices (saved by ``save_persistables``: a pruned
    checkpoint stays pruned on resume)."""
    block = program.global_block()
    for name, mask in masks.items():
        v = block.var(name)
        mname = name + "@prune_mask"
        if mname in block.vars:
            raise ValueError(
                f"{name} already has pruning masks applied (the rewrite is "
                f"not idempotent); to change masks, update the "
                f"'{mname}' scope value instead of re-applying")
        mv = block.create_var(mname, tuple(v.shape), "float32")
        mv.persistable = True
        mv.stop_gradient = True
        if v.dtype == "float32":
            block.append_op("elementwise_mul", inputs={"X": [name], "Y": [mname]},
                            outputs={"Out": [name]}, attrs={"axis": -1}, infer_shape=False)
        else:
            prod = block.create_var(name + "@pruned", tuple(v.shape), "float32")
            block.append_op("elementwise_mul", inputs={"X": [name], "Y": [mname]},
                            outputs={"Out": [prod.name]}, attrs={"axis": -1},
                            infer_shape=False)
            block.append_op("cast", inputs={"X": [prod.name]}, outputs={"Out": [name]},
                            attrs={"in_dtype": "float32", "out_dtype": v.dtype},
                            infer_shape=False)
        cur = scope.find_var(name)
        if not isinstance(cur, torch.Tensor):
            cur = owned_tensor(np.asarray(cur), torch.device("cpu"))
            scope.set_var(name, cur)
        m = torch.from_numpy(np.ascontiguousarray(mask, np.float32)).to(cur.device)
        scope.set_var(mname, m)
        cur.mul_(m.to(cur.dtype))
    program._bump()


def sparsity(scope, masks: Dict[str, np.ndarray]) -> float:
    """The measured fraction of exactly-zero weights in the pruned
    parameters, read from the scope's values: a failed or undone rewrite
    (weights that grew back) shows, unlike a count of the masks' zeros."""
    z = t = 0
    for name in masks:
        w = to_numpy(scope.find_var(name))
        z += (w == 0).sum()
        t += w.size
    return float(z) / max(t, 1)


class L2Distiller(object):
    """|| student_feature - teacher_feature ||^2. The ``*_feature_map``
    names are the reference's surface only: ``distiller_loss`` takes the
    Variables."""

    def __init__(self, student_feature_map=None, teacher_feature_map=None,
                 distillation_loss_weight=1.0):
        self.student_feature_map = student_feature_map
        self.teacher_feature_map = teacher_feature_map
        self.weight = distillation_loss_weight

    def distiller_loss(self, student_var, teacher_var):
        diff = layers.elementwise_sub(student_var, _frozen(teacher_var))
        return layers.reduce_mean(layers.square(diff)) * self.weight


class FSPDistiller(object):
    """Flow-of-solution-procedure distillation: L2 between the student's and
    the teacher's FSP matrices of feature-map pairs."""

    def __init__(self, student_pairs, teacher_pairs, distillation_loss_weight=1.0):
        self.student_pairs = student_pairs
        self.teacher_pairs = teacher_pairs
        self.weight = distillation_loss_weight

    def distiller_loss(self, student_pairs_vars, teacher_pairs_vars):
        losses = []
        for (s0, s1), (t0, t1) in zip(student_pairs_vars, teacher_pairs_vars):
            s_fsp = layers.fsp_matrix(s0, s1)
            t_fsp = layers.fsp_matrix(_frozen(t0), _frozen(t1))
            losses.append(layers.reduce_mean(
                layers.square(layers.elementwise_sub(s_fsp, t_fsp))))
        total = losses[0]
        for loss in losses[1:]:
            total = layers.elementwise_add(total, loss)
        return total * self.weight


class SoftLabelDistiller(object):
    """Cross entropy between temperature-softened logits."""

    def __init__(self, student_feature_map=None, teacher_feature_map=None,
                 student_temperature=1.0, teacher_temperature=1.0,
                 distillation_loss_weight=1.0):
        self.student_feature_map = student_feature_map
        self.teacher_feature_map = teacher_feature_map
        self.student_temperature = student_temperature
        self.teacher_temperature = teacher_temperature
        self.weight = distillation_loss_weight

    def distiller_loss(self, student_logits, teacher_logits):
        s = layers.softmax(student_logits * (1.0 / self.student_temperature))
        t = layers.softmax(_frozen(teacher_logits) * (1.0 / self.teacher_temperature))
        ce = layers.cross_entropy(s, t, soft_label=True)
        return layers.reduce_mean(ce) * self.weight


def _frozen(v):
    """The teacher's tensors carry no gradient."""
    out = layers.assign(v)
    out.stop_gradient = True
    return out
