"""Multi-tensor optimizer updates: one hand-written CUDA kernel
(``csrc/multi_tensor_update.cu``) for a run of ``adam`` or ``momentum`` ops,
and its plain PyTorch version.

The port's counterpart of the JAX package's ``fuse_all_optimizer_ops``
(``paddle_tpu/compiler.py``), which updates every parameter inside the one
XLA step. ``trace_block`` hands each maximal run of consecutive update ops
of one kind with equal attrs (``run_end``) to ``update``. No op type is
added: the ops, their per-parameter accumulators (``optimizer.py``) and
their per-parameter ``LearningRate`` and ``Beta{1,2}Pow`` tensors stay as
they are.

The plain version is a loop over the per-op lowerings of
``ops/optimizer_ops.py``. The kernel computes the same f32 arithmetic in the
same order, every step exactly rounded, so it matches them bit for bit. The
update is out of place, as the JAX step's functional update is: the outputs
are views of one flat buffer per (role, dtype), each view starting on a
16-byte boundary.

Routing is by the device of the tensors: CPU tensors take the plain
version; CUDA tensors launch the kernel, or raise where it refuses the call.
Nothing falls back.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import cuda_build
from ..core.registry import LowerCtx
from . import optimizer_ops

#: the update op types a run is made of, and the attrs (with the per-op
#: lowering's defaults) that must be equal along a run
GROUPED = {"adam": (("beta1", 0.9), ("beta2", 0.999), ("epsilon", 1e-8)),
           "momentum": (("mu", 0.9), ("use_nesterov", False))}

#: the kernel's work item: a chunk of CHUNK elements of one tensor
CHUNK = 65536
#: threads a block; each takes VEC consecutive elements at a time (16-byte
#: loads of bf16, two of f32)
THREADS, VEC = 256, 8
#: flat output views start on multiples of ALIGN elements (16 bytes of bf16)
ALIGN = 8
#: the grid's blocks an SM (at most; about 4 of 256 threads are resident at
#: once, the rest take chunks as those finish)
BLOCKS_PER_SM = 16
#: one descriptor per tensor: 16 int64 slots (see the .cu source)
DESC_SLOTS = 16
_P_BF16, _G_BF16, _VECTOR = 1, 2, 4
_KIND = {"adam": 0, "momentum": 1}
_DTYPES = (torch.float32, torch.bfloat16)


def _attr_key(op) -> tuple:
    return tuple(op.attr(k, d) for k, d in GROUPED[op.type])


def run_end(ops: Sequence, i: int) -> int:
    """The end (exclusive) of the run of update ops that starts at
    ``ops[i]``: the following ops of the same type with equal attrs, up to
    one that reads a variable an earlier op of the run writes."""
    first = ops[i]
    key = _attr_key(first)
    written = set(first.output_arg_names())
    j = i + 1
    while (j < len(ops) and ops[j].type == first.type and _attr_key(ops[j]) == key
           and written.isdisjoint(ops[j].input_arg_names())):
        written.update(ops[j].output_arg_names())
        j += 1
    return j


def update(kind: str, attrs: dict, ins_list: List[Dict[str, list]]) -> List[Dict[str, list]]:
    """One run of ``kind`` update ops: each entry of ``ins_list`` is one op's
    inputs (slot -> tensors), and the result is each op's outputs, as its
    own lowering would return them."""
    if ins_list[0]["Param"][0].device.type == "cpu":
        return update_plain(kind, attrs, ins_list)
    return multi_tensor_update(kind, attrs, ins_list)


def update_plain(kind, attrs, ins_list):
    """The per-op lowerings, one op after the other."""
    lower = optimizer_ops.adam if kind == "adam" else optimizer_ops.momentum
    device = ins_list[0]["Param"][0].device
    return [lower(LowerCtx(attrs, device), ins) for ins in ins_list]


def chunk_table(numels: Sequence[int], chunk: int = CHUNK) -> np.ndarray:
    """The kernel's work items, int32 [C, 2]: (tensor index, chunk index),
    chunk c of tensor t covering elements [c * chunk, min((c + 1) * chunk,
    n_t)). An empty tensor still gets one item: its chunk 0 writes the
    beta-power outputs."""
    counts = np.maximum(1, -(-np.asarray(numels, dtype=np.int64) // chunk))
    tensor = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    first = np.repeat(np.cumsum(counts) - counts, counts)
    return np.stack([tensor, np.arange(len(tensor)) - first], axis=1).astype(np.int32)


def flat_offsets(numels: Sequence[int], align: int = ALIGN):
    """Offsets of each tensor's view in a flat buffer, each a multiple of
    ``align`` elements, and the buffer's length."""
    sizes = -(-np.asarray(numels, dtype=np.int64) // align) * align
    ends = np.cumsum(sizes)
    return (ends - sizes).tolist(), int(ends[-1]) if len(ends) else 0


def kernel_refusal(kind, ins_list) -> Optional[str]:
    """Why the kernel cannot take this run, or None when it can."""
    if kind not in _KIND:
        return f"unknown update kind {kind!r}"
    dev = ins_list[0]["Param"][0].device
    acc = ("Moment1", "Moment2") if kind == "adam" else ("Velocity",)
    scalars = ("LearningRate", "Beta1Pow", "Beta2Pow") if kind == "adam" else ("LearningRate",)
    for k, ins in enumerate(ins_list):
        p, g = ins["Param"][0], ins["Grad"][0]
        for name, t in [("Param", p), ("Grad", g)] + [(s, ins[s][0]) for s in acc + scalars]:
            if t is None or not t.is_cuda or t.device != dev:
                return f"op {k}: {name} must lie on {dev}"
        if p.dtype not in _DTYPES or g.dtype not in _DTYPES:
            return f"op {k}: Param and Grad must be float32 or bfloat16, got {p.dtype}/{g.dtype}"
        if g.numel() != p.numel():
            return f"op {k}: Grad has {g.numel()} elements, Param {p.numel()}"
        for s in acc:
            t = ins[s][0]
            if t.dtype != torch.float32 or t.numel() != p.numel() or not t.is_contiguous():
                return (f"op {k}: {s} must be a contiguous float32 tensor of Param's "
                        f"{p.numel()} elements, got {t.dtype} {tuple(t.shape)}")
        for s in scalars:
            t = ins[s][0]
            if t.dtype != torch.float32 or t.numel() != 1:
                return f"op {k}: {s} must be one float32 element, got {t.dtype} {tuple(t.shape)}"
    return None


#: a descriptor's first 12 slots, in order; the roles read and written 8
#: elements at a time decide whether the tensor takes the 16-byte path
ROLES = ("p", "g", "m", "v", "lr", "b1p", "b2p", "p_out", "m_out", "v_out", "b1p_out",
         "b2p_out")
_WIDE_ROLES = (0, 1, 2, 3, 7, 8, 9)


def work_table(rows: Sequence[Sequence[Optional[torch.Tensor]]]) -> np.ndarray:
    """The kernel's table, int64: one descriptor of DESC_SLOTS slots per
    tensor -- the data pointers of its ROLES (0 where the kind has none),
    its element count, its flags (p bf16, g bf16, all wide roles 16-byte
    aligned) -- then ``chunk_table``'s items, one (tensor, chunk) int32 pair
    in each int64."""
    T = len(rows)
    ptrs = np.array([[t.data_ptr() if t is not None else 0 for t in r] for r in rows],
                    dtype=np.int64).reshape(T, len(ROLES))
    numels = [r[0].numel() for r in rows]
    flags = np.array([(_P_BF16 if r[0].dtype == torch.bfloat16 else 0)
                      | (_G_BF16 if r[1].dtype == torch.bfloat16 else 0) for r in rows],
                     dtype=np.int64)
    flags |= np.where((ptrs[:, _WIDE_ROLES] % 16 == 0).all(axis=1), _VECTOR, 0)
    chunks = chunk_table(numels)
    table = np.zeros(T * DESC_SLOTS + len(chunks), dtype=np.int64)
    desc = table[:T * DESC_SLOTS].reshape(T, DESC_SLOTS)
    desc[:, :len(ROLES)] = ptrs
    desc[:, 12] = numels
    desc[:, 13] = flags
    table[T * DESC_SLOTS:] = chunks.view(np.int64).reshape(-1)
    return table


_P, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _fn():
    fn = cuda_build.load("multi_tensor_update").multi_tensor_update
    if fn.argtypes is None:
        # table, n_tensors, n_chunks, chunk, kind, b1 1-b1 b2 1-b2 eps mu, nesterov, grid, stream
        fn.argtypes = [_P, _I32, _I32, _I32, _I32] + [_F32] * 6 + [_I32, _I32, _P]
        fn.restype = ctypes.c_int
    return fn


def _flat_views(tensors, dtype_of, device):
    """Out-of-place outputs shaped like ``tensors``: views of one flat
    buffer per dtype, each starting on a multiple of ALIGN elements."""
    views = [None] * len(tensors)
    for dt in {dtype_of(t) for t in tensors}:
        idx = [i for i, t in enumerate(tensors) if dtype_of(t) == dt]
        sizes = [tensors[i].numel() for i in idx]
        offs, total = flat_offsets(sizes)
        parts = []   # each view, then the padding to the next ALIGN boundary
        for n, o, end in zip(sizes, offs, offs[1:] + [total]):
            parts += [n, end - o - n]
        flat = torch.empty((total,), dtype=dt, device=device)
        for i, v in zip(idx, flat.split(parts)[::2]):
            views[i] = v.view(tensors[i].shape)
    return views


@cuda_build.counted
def multi_tensor_update(kind: str, attrs: dict, ins_list):
    """Launch the multi-tensor kernel once for a run of ``kind`` ops on CUDA
    tensors; returns each op's outputs. Param and Grad may be f32 or bf16
    (each op its own), the accumulators, the learning rate and the beta
    powers are f32. Raises ValueError for a run the kernel does not take
    (see ``kernel_refusal``) and RuntimeError if the launch fails. Each
    launch adds one to ``multi_tensor_update.launches``."""
    why = kernel_refusal(kind, ins_list)
    if why is not None:
        raise ValueError(f"multi_tensor_update: {why}")
    adam = kind == "adam"
    dev = ins_list[0]["Param"][0].device
    T = len(ins_list)
    ps = [ins["Param"][0].contiguous() for ins in ins_list]
    gs = [ins["Grad"][0].contiguous() for ins in ins_list]
    ms = [ins["Moment1" if adam else "Velocity"][0] for ins in ins_list]
    vs = [ins["Moment2"][0] for ins in ins_list] if adam else [None] * T
    lrs = [ins["LearningRate"][0] for ins in ins_list]
    p_out = _flat_views(ps, lambda t: t.dtype, dev)
    m_out = _flat_views(ms, lambda t: torch.float32, dev)
    if adam:
        v_out = _flat_views(vs, lambda t: torch.float32, dev)
        pows = [(ins["Beta1Pow"][0], ins["Beta2Pow"][0]) for ins in ins_list]
        pow_out = torch.empty((2 * T,), dtype=torch.float32, device=dev).split(1)
        pow_views = [(pow_out[i].view(b1p.shape), pow_out[T + i].view(b2p.shape))
                     for i, (b1p, b2p) in enumerate(pows)]
    else:
        v_out, pows, pow_views = [None] * T, [(None, None)] * T, [(None, None)] * T
    table = work_table([(ps[i], gs[i], ms[i], vs[i], lrs[i], *pows[i], p_out[i], m_out[i],
                         v_out[i], *pow_views[i]) for i in range(T)])
    n_chunks = len(table) - T * DESC_SLOTS
    dev_table = torch.from_numpy(table).pin_memory().to(dev, non_blocking=True)

    b1, b2 = attrs.get("beta1", 0.9), attrs.get("beta2", 0.999)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # 1 - b1 and 1 - b2 in double, then rounded to float (ctypes), as PyTorch
    # rounds the Python scalar (1 - b1) that the per-op lowering multiplies by
    scalars = (b1, 1 - b1, b2, 1 - b2, attrs.get("epsilon", 1e-8), attrs.get("mu", 0.9))
    with torch.cuda.device(dev):
        rc = _fn()(dev_table.data_ptr(), T, n_chunks, CHUNK, _KIND[kind], *scalars,
                   int(bool(attrs.get("use_nesterov", False))),
                   min(n_chunks, sms * BLOCKS_PER_SM), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"multi_tensor_update: kernel launch failed with CUDA error {rc}")
    multi_tensor_update.launches += 1
    if adam:
        return [{"ParamOut": [p_out[i]], "Moment1Out": [m_out[i]], "Moment2Out": [v_out[i]],
                 "Beta1PowOut": [pow_views[i][0]], "Beta2PowOut": [pow_views[i][1]]}
                for i in range(T)]
    return [{"ParamOut": [p_out[i]], "VelocityOut": [m_out[i]]} for i in range(T)]
