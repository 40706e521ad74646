"""The extra layer ops (the port's copy of the 34 op types of
``paddle_tpu/ops/extra_ops.py``): vision rearranges, ranking and distillation
losses, the batch-like random fills, the beam backtrace, ``edit_distance``,
``hash``, ``unique_with_counts``, the stateful ``spectral_norm``,
``center_loss`` and ``data_norm``, ``grid_sampler``, ``py_func`` and
``tree_conv``.

Random draws (``sampling_id``, the two ``*_random_batch_size_like`` fills,
``random_crop``) come from the port's counter-derived generator: Philox4x32-10
keyed by ``LowerCtx.kernel_seed`` (``counter_words``), the generator of the
dropout kernel. Inside an executor on the card the key is derived on the card
from the run counter, so a captured step draws anew at every replay; the two
packages' generators differ, so tests hold these ops by statistics.

A gather whose gradient would add rows with atomics on the card
(``take_along_dim``, ``index_select``) goes through ``tensor_ops.take_rows``
(a fixed order), and a scatter-add through ``tensor_ops._add_rows``
(``index_put``'s sort-based accumulation), so a step reproduces bit for bit.
Constants built on the host go up once, outside any capture
(``basic.device_constant``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.registry import register, torch_dtype
from .basic import device_constant
from .flash_attention import philox4x32_10, philox_key
from .tensor_ops import _add_rows, take_rows

_U32 = 0xFFFFFFFF


# -- the counter-derived generator -------------------------------------------------------

def counter_words(ctx, n: int, offset: int = 0) -> torch.Tensor:
    """``n`` uint32 words (int64) of Philox4x32-10 keyed by the op's
    ``kernel_seed(offset)``, counter ``(i // 4, 0, 0, 0)``, word ``i % 4``:
    the dropout kernel's stream. No value is read on the host."""
    g = torch.arange((n + 3) // 4, dtype=torch.int64, device=ctx.device)
    zero = torch.zeros_like(g)
    words = philox4x32_10(g & _U32, g >> 32, zero, zero, *philox_key(ctx.kernel_seed(offset)))
    return torch.stack(words, dim=-1).reshape(-1)[:n]


def counter_uniform(ctx, shape, offset: int = 0, open_low: bool = False) -> torch.Tensor:
    """float32 uniforms of ``shape`` in [0, 1) (in (0, 1) with ``open_low``)
    from the top 24 bits of ``counter_words``."""
    n = int(np.prod(shape)) if len(shape) else 1
    top = (counter_words(ctx, n, offset) >> 8).float()
    if open_low:
        top = top + 0.5
    return (top * (1.0 / (1 << 24))).reshape(tuple(shape))


def counter_normal(ctx, shape, offset: int = 0) -> torch.Tensor:
    """Standard normals by Box-Muller over two uniform streams."""
    u1 = counter_uniform(ctx, shape, offset, open_low=True)
    u2 = counter_uniform(ctx, shape, offset + 0x5bd1e995, open_low=False)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * np.pi) * u2)


def counter_randint(ctx, shape, high, offset: int = 0) -> torch.Tensor:
    """Integers uniform in [0, high) (``high`` an int or an int64 tensor
    that broadcasts to ``shape``): ``(word * high) >> 32``."""
    n = int(np.prod(shape)) if len(shape) else 1
    return ((counter_words(ctx, n, offset).reshape(tuple(shape)) * high) >> 32)


# -- vision / tensor rearranges ---------------------------------------------------------

@register("maxout")
def maxout(ctx, ins):
    """The maximum over ``groups`` consecutive channels of ``axis``."""
    x = ins["X"][0]
    g = int(ctx.attr("groups"))
    axis = int(ctx.attr("axis", 1))
    shape = list(x.shape)
    shape[axis:axis + 1] = [shape[axis] // g, g]
    return {"Out": [torch.amax(x.reshape(shape), dim=axis + 1)]}


@register("lrn")
def lrn(ctx, ins):
    """Local response normalisation across channels."""
    x = ins["X"][0]
    n = int(ctx.attr("n", 5))
    k, alpha, beta = (float(ctx.attr(a, d)) for a, d in (("k", 1.0), ("alpha", 1e-4),
                                                         ("beta", 0.75)))
    half = n // 2
    pad = F.pad(torch.square(x), (0, 0, 0, 0, half, half))
    acc = pad[:, 0:x.shape[1]]
    for i in range(1, n):
        acc = acc + pad[:, i:i + x.shape[1]]
    return {"Out": [x / torch.pow(k + alpha * acc, beta)]}


@register("multiplex", nondiff_inputs=("Ids",))
def multiplex(ctx, ins):
    """out[b] = X[ids[b]][b]: row b taken from candidate ``ids[b]``."""
    ids = ins["Ids"][0].reshape(-1).long()
    stacked = torch.stack(ins["X"], dim=0)                  # [K, B, ...]
    K, B = stacked.shape[0], stacked.shape[1]
    row = ids * B + torch.arange(B, device=ids.device)
    flat = stacked.reshape((K * B,) + tuple(stacked.shape[2:]))
    return {"Out": [take_rows(flat, row)]}


@register("pixel_shuffle")
def pixel_shuffle(ctx, ins):
    x = ins["X"][0]
    r = int(ctx.attr("upscale_factor"))
    b, c, h, w = x.shape
    out = x.reshape(b, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    return {"Out": [out.reshape(b, c // (r * r), h * r, w * r)]}


@register("shuffle_channel")
def shuffle_channel(ctx, ins):
    x = ins["X"][0]
    g = int(ctx.attr("group"))
    b, c, h, w = x.shape
    return {"Out": [x.reshape(b, g, c // g, h, w).transpose(1, 2).reshape(b, c, h, w)]}


@register("temporal_shift")
def temporal_shift(ctx, ins):
    """[N*T, C, H, W]: the first ``shift_ratio`` of the channels shifted one
    step back in time, the next as many one step forward."""
    x = ins["X"][0]
    t = int(ctx.attr("seg_num"))
    ratio = float(ctx.attr("shift_ratio", 0.25))
    nt, c, h, w = x.shape
    v = x.reshape(nt // t, t, c, h, w)
    c1, c2 = int(c * ratio), int(c * 2 * ratio)
    back = torch.cat([v[:, 1:, :c1], torch.zeros_like(v[:, :1, :c1])], dim=1)
    fwd = torch.cat([torch.zeros_like(v[:, :1, c1:c2]), v[:, :-1, c1:c2]], dim=1)
    return {"Out": [torch.cat([back, fwd, v[:, :, c2:]], dim=2).reshape(nt, c, h, w)]}


@register("unfold")
def unfold(ctx, ins):
    """im2col: [B, C, H, W] -> [B, C * kh * kw, L], features ordered (c, kh,
    kw) as ``lax.conv_general_dilated_patches`` orders them."""
    x = ins["X"][0]
    kh, kw = ctx.attr("kernel_sizes")
    sh, sw = ctx.attr("strides", [1, 1])
    ph, pw = ctx.attr("paddings", [0, 0])[:2]
    dh, dw = ctx.attr("dilations", [1, 1])
    return {"Out": [F.unfold(x, (int(kh), int(kw)), dilation=(int(dh), int(dw)),
                             padding=(int(ph), int(pw)), stride=(int(sh), int(sw)))]}


@register("affine_channel")
def affine_channel(ctx, ins):
    x, scale, bias = ins["X"][0], ins["Scale"][0], ins["Bias"][0]
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return {"Out": [x * scale.reshape(shape) + bias.reshape(shape)]}


@register("bilinear_tensor_product")
def bilinear_tensor_product(ctx, ins):
    """out[b, k] = x[b] W[k] y[b] + bias[k]."""
    x, w, y = ins["X"][0], ins["Weight"][0], ins["Y"][0]
    out = torch.einsum("bm,kmn,bn->bk", x, w, y)
    bias = ins.get("Bias", [None])[0]
    if bias is not None:
        out = out + bias.reshape(1, -1)
    return {"Out": [out]}


def _position_table(t, d):
    """The sinusoid table [t, d], computed in float64 as the JAX lowering's
    numpy table, then rounded to float32."""
    pos = np.arange(t)[:, None]
    i = np.arange(d // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / d)
    pe = np.zeros((t, d), "float32")
    pe[:, 0::2] = np.sin(angle)
    pe[:, 1::2] = np.cos(angle)
    return torch.from_numpy(pe)


@register("add_position_encoding")
def add_position_encoding(ctx, ins):
    """alpha * x + beta * the sinusoid table, x [B, T, D]."""
    x = ins["X"][0]
    _, t, d = x.shape
    pe = device_constant(("position_encoding", int(t), int(d)), x.device,
                         lambda: _position_table(int(t), int(d)))
    return {"Out": [float(ctx.attr("alpha", 1.0)) * x
                    + float(ctx.attr("beta", 1.0)) * pe.to(x.dtype)[None]]}


@register("mean_iou", grad=None, nondiff_inputs=("Predictions", "Labels"))
def mean_iou(ctx, ins):
    """The mean over present classes of intersection over union; the class
    histograms grow by a sort-based scatter-add (whole counts, exact)."""
    pred = ins["Predictions"][0].reshape(-1).long()
    label = ins["Labels"][0].reshape(-1).long()
    n = int(ctx.attr("num_classes"))
    zeros = torch.zeros((n,), dtype=torch.float32, device=pred.device)
    hit = (pred == label).float()
    inter = _add_rows(zeros, torch.where(pred == label, pred, n - 1), hit)
    p_cnt = _add_rows(zeros, pred, torch.ones_like(hit))
    l_cnt = _add_rows(zeros, label, torch.ones_like(hit))
    union = p_cnt + l_cnt - inter
    valid = union > 0
    iou = torch.where(valid, inter / torch.clamp_min(union, 1e-9), torch.zeros_like(union))
    miou = torch.sum(iou) / torch.clamp_min(valid.float().sum(), 1.0)
    return {"OutMeanIou": [miou.reshape(())],
            "OutWrong": [(l_cnt - inter).to(torch.int32)],
            "OutCorrect": [inter.to(torch.int32)]}


@register("crop_tensor")
def crop_tensor(ctx, ins):
    """A ``shape`` window at ``offsets``, each start clamped so the window
    fits, as ``lax.dynamic_slice`` clamps it."""
    x = ins["X"][0]
    out = x
    for axis, (o, s) in enumerate(zip(ctx.attr("offsets"), ctx.attr("shape"))):
        s = int(s)
        start = min(max(int(o), 0), x.shape[axis] - s)
        out = out.narrow(axis, start, s)
    return {"Out": [out]}


def _pad_like_infer(op, block):
    """Out mirrors X (inference through the lowering would see the dynamic
    batch's sentinel on Y and compute a negative pad)."""
    xv = block.find_var_recursive(op.inputs["X"][0])
    out = op.outputs["Out"][0]
    v = block.find_var_recursive(out)
    if v is None:
        block.create_var(out, tuple(xv.shape), xv.dtype)
    else:
        v.shape = tuple(xv.shape)


@register("pad_constant_like", infer_shape=_pad_like_infer)
def pad_constant_like(ctx, ins):
    """Y padded at the end of each dim up to X's shape with ``pad_value``."""
    x, y = ins["X"][0], ins["Y"][0]
    pads = []
    for a, b in reversed(list(zip(x.shape, y.shape))):
        pads += [0, int(a) - int(b)]
    return {"Out": [F.pad(y, pads, value=float(ctx.attr("pad_value", 0.0)))]}


# -- ranking / distillation losses ------------------------------------------------------

@register("rank_loss")
def rank_loss(ctx, ins):
    label, left, right = ins["Label"][0], ins["Left"][0], ins["Right"][0]
    o = left - right
    return {"Out": [torch.logaddexp(torch.zeros_like(o), o) - label * o]}


@register("margin_rank_loss")
def margin_rank_loss(ctx, ins):
    label, left, right = ins["Label"][0], ins["X1"][0], ins["X2"][0]
    z = -label * (left - right) + float(ctx.attr("margin", 0.0))
    return {"Out": [torch.clamp_min(z, 0.0)]}


def _one_hot(ids, n, dtype):
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(dtype)


@register("bpr_loss", nondiff_inputs=("Label",))
def bpr_loss(ctx, ins):
    """-mean over j != y of log sigmoid(x_y - x_j). x_y is picked by a
    one-hot product (its value exactly; its gradient a product)."""
    x = ins["X"][0]
    y = ins["Label"][0].reshape(-1).long()
    C = x.shape[1]
    hot = _one_hot(y, C, x.dtype)
    pos = torch.sum(x * hot, dim=1, keepdim=True)
    diff = F.logsigmoid(pos - x)
    return {"Out": [-torch.sum(diff * (1.0 - hot), dim=1, keepdim=True) / max(C - 1, 1)]}


@register("kldiv_loss")
def kldiv_loss(ctx, ins):
    """target * (log target - x), 0 where target <= 0; reduced by
    ``reduction`` (mean, sum, batchmean, none)."""
    x, t = ins["X"][0], ins["Target"][0]
    loss = torch.where(t > 0, t * (torch.log(torch.clamp_min(t, 1e-30)) - x),
                       torch.zeros_like(x))
    red = ctx.attr("reduction", "mean")
    if red == "mean":
        loss = torch.mean(loss).reshape(())
    elif red == "sum":
        loss = torch.sum(loss).reshape(())
    elif red == "batchmean":
        loss = (torch.sum(loss) / loss.shape[0]).reshape(())
    return {"Loss": [loss]}


@register("teacher_student_sigmoid_loss")
def teacher_student_sigmoid_loss(ctx, ins):
    """The CTR distillation loss over labels {-2, -1, [0, 2)}: the click z
    and the teacher's score z' packed in one number."""
    x = ins["X"][0].reshape(-1)
    label = ins["Label"][0].reshape(-1).to(x.dtype)
    soft_plus = torch.log1p(torch.exp(-torch.abs(x)))
    ce0 = torch.clamp_min(x, 0) + soft_plus                     # z = 0
    ce1 = ce0 - x                                               # z = 1
    soft = label - torch.where(label < 1.0, torch.zeros_like(label), torch.ones_like(label))
    ces = ce0 + torch.clamp_min(x, 0) - x * soft + soft_plus    # 0 <= label < 1
    ces1 = ce1 + torch.clamp_min(x, 0) - x * soft + soft_plus   # label >= 1
    y = torch.where(label < -1.0, ce0,
                    torch.where(label < 0.0, ce1, torch.where(label < 1.0, ces, ces1)))
    return {"Y": [y[:, None]]}


# -- sampling / beam utilities ----------------------------------------------------------

@register("sampling_id", grad=None, nondiff_inputs=("X",))
def sampling_id(ctx, ins):
    """A class drawn from each row of probabilities X [B, C], by the
    Gumbel-max rule over log(max(x, 1e-30)) as ``jax.random.categorical``."""
    x = ins["X"][0]
    u = counter_uniform(ctx, tuple(x.shape), open_low=True)
    gumbel = -torch.log(-torch.log(u))
    logits = torch.log(torch.clamp_min(x.float(), 1e-30))
    return {"Out": [torch.argmax(logits + gumbel, dim=1).to(torch.int64)]}


@register("gather_tree", grad=None, nondiff_inputs=("Ids", "Parents"))
def gather_tree(ctx, ins):
    """The beam backtrace: ids / parents [T, B, K] -> the full beams."""
    ids, parents = ins["Ids"][0], ins["Parents"][0]
    T = ids.shape[0]
    beam = torch.arange(ids.shape[2], dtype=ids.dtype, device=ids.device)[None, :] \
        .expand(ids.shape[1:])
    toks = [None] * T
    for t in range(T - 1, -1, -1):
        toks[t] = torch.take_along_dim(ids[t], beam.long(), dim=1)
        beam = torch.take_along_dim(parents[t], beam.long(), dim=1)
    return {"Out": [torch.stack(toks, dim=0)]}


@register("row_conv")
def row_conv(ctx, ins):
    """Lookahead row convolution: out[b, t] = sum_k f[k] * x[b, t + k]."""
    x, f = ins["X"][0], ins["Filter"][0]
    K, T = f.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, 0, K - 1))
    out = pad[:, 0:T] * f[0][None, None, :]
    for k in range(1, K):
        out = out + pad[:, k:k + T] * f[k][None, None, :]
    return {"Out": [out]}


def _batch_like_shape(ctx, ins):
    """``shape`` with dim ``output_dim_idx`` set to Input's dim
    ``input_dim_idx``."""
    shape = [int(s) for s in ctx.attr("shape")]
    shape[int(ctx.attr("output_dim_idx", 0))] = \
        ins["Input"][0].shape[int(ctx.attr("input_dim_idx", 0))]
    return tuple(shape)


@register("uniform_random_batch_size_like", grad=None)
def uniform_random_batch_size_like(ctx, ins):
    shape = _batch_like_shape(ctx, ins)
    lo, hi = float(ctx.attr("min", -1.0)), float(ctx.attr("max", 1.0))
    out = counter_uniform(ctx, shape) * (hi - lo) + lo
    return {"Out": [out.to(torch_dtype(ctx.attr("dtype", "float32")))]}


@register("gaussian_random_batch_size_like", grad=None)
def gaussian_random_batch_size_like(ctx, ins):
    shape = _batch_like_shape(ctx, ins)
    out = float(ctx.attr("mean", 0.0)) + float(ctx.attr("std", 1.0)) * counter_normal(ctx, shape)
    return {"Out": [out.to(torch_dtype(ctx.attr("dtype", "float32")))]}


@register("random_crop", grad=None, nondiff_inputs=("X", "Seed"))
def random_crop(ctx, ins):
    """A ``shape`` window of X's trailing dims at a start drawn uniformly on
    each (the leading dims whole), taken by an index on the device."""
    x = ins["X"][0]
    shape = [int(s) for s in ctx.attr("shape")]
    nbatch = x.ndim - len(shape)
    out = x
    for i, s in enumerate(shape):
        axis = nbatch + i
        start = counter_randint(ctx, (1,), x.shape[axis] - s + 1, offset=i)
        out = out.index_select(axis, start + torch.arange(s, device=x.device))
    return {"Out": [out]}


# -- edit distance, hash, unique ---------------------------------------------------------

@register("edit_distance", grad=None, nondiff_inputs=("Hyps", "Refs", "HypsLength",
                                                      "RefsLength"))
def edit_distance(ctx, ins):
    """Levenshtein distance of each row's first HypsLength ids of Hyps [B,
    T1] to its first RefsLength ids of Refs [B, T2]: Out [B, 1] float32
    (divided by max(RefsLength, 1) when ``normalized``), SequenceNum [1] =
    B.

    The dynamic programme runs along anti-diagonals, T1 + T2 steps of the
    whole batch (the JAX lowering's row scan with a column scan inside is
    T1 x T2 steps). Diagonal k holds D[i][k - i] at index i; D[i][j] =
    min(D[i-1][j] + 1, D[i][j-1] + 1, D[i-1][j-1] + (hyp[i-1] != ref[j-1])).
    Whole numbers below 2^24 in float32: exact, whatever the order."""
    hyp, ref = ins["Hyps"][0], ins["Refs"][0]
    hlen = ins["HypsLength"][0].reshape(-1).long()
    rlen = ins["RefsLength"][0].reshape(-1).long()
    B, T1 = hyp.shape
    T2 = ref.shape[1]
    K = T1 + T2 + 1
    dev = hyp.device
    # per diagonal k and index i: the cell's column j, the flat index of the
    # (1-based) mismatch table, and the value of a border cell (D[0][j] = j,
    # D[i][0] = i) or of a cell outside the table (1e9)
    kk = torch.arange(K, device=dev)[:, None]
    i = torch.arange(T1 + 1, device=dev)[None, :]
    j = kk - i                                                # [K, T1 + 1]
    inside = (j >= 0) & (j <= T2)
    fixed = torch.where(inside, torch.where(i == 0, j, i).float(),
                        torch.full((), 1e9, device=dev))
    use_fixed = ~inside | (i == 0) | (j == 0)
    neq = F.pad((hyp[:, :, None] != ref[:, None, :]).float(), (1, 0, 1, 0))
    cost = torch.index_select(neq.reshape(B, -1), 1,
                              (i * (T2 + 1) + j.clamp(0, T2)).reshape(-1)).reshape(B, K, T1 + 1)
    far = torch.full((B, T1 + 1), 1e9, device=dev)
    diags = [fixed[0].expand(B, T1 + 1)]
    for k in range(1, K):
        prev1, prev2 = diags[-1], diags[-2] if k > 1 else far
        up = F.pad(prev1[:, :-1], (1, 0), value=1e9)           # D[i-1][j]: diagonal k-1, i-1
        step = F.pad(prev2[:, :-1], (1, 0), value=1e9) + cost[:, k]   # D[i-1][j-1] + mismatch
        d = torch.minimum(torch.minimum(up, prev1) + 1.0, step)       # prev1[i] is D[i][j-1]
        diags.append(torch.where(use_fixed[k], fixed[k], d))
    table = torch.stack(diags, dim=1)                         # [B, K, T1 + 1]
    result = table.reshape(B, -1).gather(1, ((hlen + rlen) * (T1 + 1) + hlen)[:, None])[:, 0]
    dist = result[:, None]
    if ctx.attr("normalized", True):
        dist = dist / torch.clamp_min(rlen[:, None].float(), 1.0)
    return {"Out": [dist], "SequenceNum": [torch.full((1,), B, dtype=torch.int64, device=dev)]}


def _mul_u32(x, c: int):
    """x * c mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant c, with
    every partial product below 2^49."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


@register("hash", grad=None, nondiff_inputs=("X",))
def hash_op(ctx, ins):
    """Per id (as uint32) and hash i: h = id * (2654435761 + 40503 i) +
    0x9E3779B9 (i + 1) mod 2^32, h ^= h >> 16, then h % mod_by. The JAX
    lowering's uint32 arithmetic in int64 with 32-bit masks, bit for bit.
    Out [..., num_hash] int64."""
    x = ins["X"][0].long() & _U32
    mod = int(ctx.attr("mod_by", 100000007))
    outs = []
    for i in range(int(ctx.attr("num_hash", 1))):
        h = (_mul_u32(x, (2654435761 + 40503 * i) & _U32) + ((0x9E3779B9 * (i + 1)) & _U32)) & _U32
        h = h ^ (h >> 16)
        outs.append(h % mod)
    return {"Out": [torch.stack(outs, dim=-1)]}


@register("unique_with_counts", grad=None, nondiff_inputs=("X",))
def unique_with_counts(ctx, ins):
    """The sorted unique values of X (flattened), padded to len(X) with the
    smallest value (what ``jnp.unique(size=len(X), fill_value=None)``
    gives), Index (each element's place among them), Count (0 in the pad)
    and UniqueCount [1]. A stable sort and scatters of fixed shape, so a
    graph can capture it (``torch.unique`` reads its size on the host)."""
    x = ins["X"][0].reshape(-1)
    n = x.shape[0]
    s, order = torch.sort(x, stable=True)
    first = torch.ones((n,), dtype=torch.bool, device=x.device)
    first[1:] = s[1:] != s[:-1]
    rank = torch.cumsum(first.long(), 0) - 1                  # each sorted element's unique slot
    # every element writes its value into its run's slot: equal values, so
    # the order of the writes does not matter
    out = s[:1].expand(n).scatter(0, rank, s)
    index = torch.empty((n,), dtype=torch.int64, device=x.device).scatter(0, order, rank)
    count = _add_rows(torch.zeros((n,), dtype=torch.int64, device=x.device), rank,
                      torch.ones((n,), dtype=torch.int64, device=x.device))
    return {"Out": [out], "Index": [index.to(torch.int32)], "Count": [count.to(torch.int32)],
            "UniqueCount": [first.sum().to(torch.int32).reshape(1)]}


# -- stateful normalisation and losses ---------------------------------------------------

@register("spectral_norm")
def spectral_norm(ctx, ins):
    """Weight / sigma_max(Weight) by ``power_iters`` rounds of power
    iteration from the state U, V, which leave updated (UOut, VOut) and
    carry no gradient."""
    w, u, v = ins["Weight"][0], ins["U"][0], ins["V"][0]
    dim = int(ctx.attr("dim", 0))
    eps = float(ctx.attr("eps", 1e-12))
    perm = [dim] + [i for i in range(w.ndim) if i != dim]
    mat = w.permute(perm).reshape(w.shape[dim], -1)

    def l2n(a):
        return a / (torch.linalg.vector_norm(a) + eps)

    for _ in range(int(ctx.attr("power_iters", 1))):
        v = l2n(mat.t() @ u)
        u = l2n(mat @ v)
    u, v = u.detach(), v.detach()
    sigma = u @ (mat @ v)
    return {"Out": [w / sigma], "UOut": [u], "VOut": [v]}


@register("center_loss", nondiff_inputs=("Label", "CenterUpdateRate"))
def center_loss(ctx, ins):
    """0.5 |x - centers[label]|^2 per row; with ``need_update`` the centers
    move toward their rows' mean difference (CentersOut), the sums added
    in a fixed order."""
    x = ins["X"][0]
    label = ins["Label"][0].reshape(-1).long()
    centers = ins["Centers"][0]
    alpha = ins["CenterUpdateRate"][0].reshape(())
    diff = x - take_rows(centers, label)
    loss = 0.5 * torch.sum(torch.square(diff), dim=1, keepdim=True)
    if ctx.attr("need_update", True):
        d = diff.detach()
        cnt = _add_rows(torch.zeros((centers.shape[0], 1), dtype=x.dtype, device=x.device),
                        label, torch.ones((label.shape[0], 1), dtype=x.dtype, device=x.device))
        upd = _add_rows(torch.zeros_like(centers), label, d)
        centers = centers + alpha * upd / (1.0 + cnt)
    return {"Loss": [loss], "SampleCenterDiff": [diff], "CentersOut": [centers]}


@register("affine_grid")
def affine_grid(ctx, ins):
    """theta [B, 2, 3] -> the sampling grid [B, H, W, 2] over [-1, 1]."""
    theta = ins["Theta"][0]
    _, _, h, w = (int(s) for s in ctx.attr("output_shape"))
    dev = theta.device
    gy, gx = torch.meshgrid(torch.linspace(-1.0, 1.0, h, device=dev),
                            torch.linspace(-1.0, 1.0, w, device=dev), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).reshape(-1, 3)
    out = torch.einsum("bij,pj->bpi", theta.float(), base)
    return {"Output": [out.reshape(theta.shape[0], h, w, 2).to(theta.dtype)]}


def gather_pixels(x, idx):
    """x [B, C, H, W] at flat pixel indices idx [B, P]: [B, C, P]. The rows
    of x as [B * H * W, C] are taken through ``take_rows``, whose gradient
    adds in a fixed order."""
    B, C, H, W = x.shape
    rows = x.permute(0, 2, 3, 1).reshape(B * H * W, C)
    row = (idx + (torch.arange(B, device=idx.device) * (H * W))[:, None]).reshape(-1)
    return take_rows(rows, row).reshape(B, -1, C).transpose(1, 2)


@register("grid_sampler")
def grid_sampler(ctx, ins):
    """Bilinear samples of X at the grid's [-1, 1] coordinates (corners
    aligned), the corners clamped into the map."""
    x, grid = ins["X"][0], ins["Grid"][0]
    B, C, H, W = x.shape
    gx = (grid[..., 0] + 1.0) * (W - 1) / 2.0
    gy = (grid[..., 1] + 1.0) * (H - 1) / 2.0
    x0 = torch.clamp(torch.floor(gx), 0, W - 1)
    y0 = torch.clamp(torch.floor(gy), 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    wx, wy = gx - x0, gy - y0
    Hp, Wp = grid.shape[1], grid.shape[2]

    def at(yy, xx):
        idx = (yy * W + xx).long().reshape(B, Hp * Wp)
        return gather_pixels(x, idx).reshape(B, C, Hp, Wp)

    val = (at(y0, x0) * ((1 - wx) * (1 - wy))[:, None] + at(y0, x1) * (wx * (1 - wy))[:, None]
           + at(y1, x0) * ((1 - wx) * wy)[:, None] + at(y1, x1) * (wx * wy)[:, None])
    return {"Output": [val]}


@register("data_norm")
def data_norm(ctx, ins):
    """Normalisation by the accumulated batch statistics (CTR models): Y =
    (x - sum / size) * sqrt(size / (sqsum - sum * mean + eps)); the three
    accumulators leave grown by this batch."""
    x = ins["X"][0]
    bsize, bsum, bsq = ins["BatchSize"][0], ins["BatchSum"][0], ins["BatchSquareSum"][0]
    eps = float(ctx.attr("epsilon", 1e-4))
    mean = bsum / bsize
    scale = torch.sqrt(bsize / (bsq - bsum * mean + eps))
    y = (x - mean[None, :]) * scale[None, :]
    xs = x.detach()
    return {"Y": [y], "Means": [mean], "Scales": [scale],
            "BatchSizeOut": [bsize + x.shape[0]],
            "BatchSumOut": [bsum + torch.sum(xs, 0)],
            "BatchSquareSumOut": [bsq + torch.sum(torch.square(xs), 0)]}


# -- the host callback -------------------------------------------------------------------

def _py_func_refusal(op):
    return ("op 'py_func' runs a Python callable on the host at every run: a replayed "
            "graph would not call it")


@register("py_func", grad=None, capture_refusal=_py_func_refusal)
def py_func_op(ctx, ins):
    """Runs the registered callable on the inputs' values on the host and
    puts its results on the op's device, in ``out_dtypes``. A -1 dim of an
    output takes the first input's dim on that axis; any other -1 raises,
    as in the JAX package."""
    from ..layers.extras import _PYFUNC_TABLE
    func = _PYFUNC_TABLE[int(ctx.attr("func_key"))]
    dtypes = ctx.attr("out_dtypes")
    ref = ins["X"][0]
    shapes = [[ref.shape[i] if d == -1 and i < ref.ndim else d for i, d in enumerate(s)]
              for s in ctx.attr("out_shapes")]
    if any(-1 in s for s in shapes):
        raise ValueError("py_func outputs need static shapes (only a leading batch dim "
                         "may be -1)")
    if ctx.abstract or ctx.device.type == "meta":
        return {"Out": [torch.empty(tuple(s), dtype=torch_dtype(d), device=ctx.device)
                        for s, d in zip(shapes, dtypes)]}
    args = [np.asarray((t.detach().float() if t.dtype == torch.bfloat16 else t.detach()).cpu())
            for t in ins["X"]]
    r = func(*args)
    if not isinstance(r, (list, tuple)):
        r = (r,)
    outs = []
    for v, s, d in zip(r, shapes, dtypes):
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(v, dtype=np.float32
                                                             if d == "bfloat16" else d)))
        outs.append(t.reshape(tuple(s)).to(torch_dtype(d)).to(ctx.device))
    return {"Out": outs}


# -- tree convolution --------------------------------------------------------------------

@register("tree_conv", nondiff_inputs=("EdgeSet",))
def tree_conv(ctx, ins):
    """Tree-based convolution (TBCNN). NodesVector [B, N, F] (or [N, F]),
    EdgeSet [B, E, 2] 1-indexed parent -> child pairs ((0, 0) rows pad),
    Filter [F, 3, O, K]; Out [B, N, O, K]. As the JAX lowering: the
    continuous-binary-tree coefficients become three dense [N, N] matrices
    (eta_t, eta_l, eta_r summed over depths below ``max_depth``, powers of
    the child adjacency), then three products. The edges set the matrices,
    so the gradient is products only."""
    x, edges, filt = ins["NodesVector"][0], ins["EdgeSet"][0], ins["Filter"][0]
    max_depth = int(ctx.attr("max_depth", 2))
    squeeze = x.ndim == 2
    if squeeze:
        x, edges = x[None], edges[None]
    B, N, _ = x.shape
    E = edges.shape[1]
    dev, dt = x.device, x.dtype
    u = edges[..., 0].long()
    v = edges[..., 1].long()
    valid = (u > 0) & (v > 0)
    ui = torch.where(valid, u - 1, N)                          # pad rows land in a dump slot
    vi = torch.where(valid, v - 1, N)
    bi = torch.arange(B, device=dev)[:, None].expand(B, E)
    one = valid.to(dt)
    A = torch.zeros((B, N + 1, N + 1), dtype=dt, device=dev).index_put(
        (bi, ui, vi), one)[:, :N, :N]
    same_parent = (u[:, :, None] == u[:, None, :]) & valid[:, :, None] & valid[:, None, :]
    earlier = torch.tril(torch.ones((E, E), dtype=dt, device=dev), diagonal=-1)
    index1 = (same_parent.to(dt) * earlier).sum(2) + 1.0
    pclen_e = same_parent.to(dt).sum(2)
    idx_n = torch.zeros((B, N + 1), dtype=dt, device=dev).index_put(
        (bi, vi), torch.where(valid, index1, torch.zeros_like(index1)))[:, :N]
    pcl_n = torch.ones((B, N + 1), dtype=dt, device=dev).index_put(
        (bi, vi), torch.where(valid, pclen_e, torch.ones_like(pclen_e)))[:, :N]
    temp = torch.where(pcl_n <= 1.0, torch.full_like(pcl_n, 0.5),
                       (idx_n - 1.0) / torch.clamp_min(pcl_n - 1.0, 1.0))
    eye = torch.eye(N, dtype=dt, device=dev).expand(B, N, N)
    Ct, Cl, Cr = eye, torch.zeros_like(eye), torch.zeros_like(eye)
    reach = eye
    for d in range(1, max_depth):
        reach = reach @ A
        eta_t = (max_depth - d) / max_depth
        eta_l = (1.0 - eta_t) * temp
        eta_r = (1.0 - eta_t) * (1.0 - eta_l)
        Ct = Ct + reach * eta_t
        Cl = Cl + reach * eta_l[:, None, :]
        Cr = Cr + reach * eta_r[:, None, :]
    out = (torch.einsum("bnf,fok->bnok", Ct @ x, filt[:, 0])
           + torch.einsum("bnf,fok->bnok", Cl @ x, filt[:, 1])
           + torch.einsum("bnf,fok->bnok", Cr @ x, filt[:, 2]))
    return {"Out": [out[0] if squeeze else out]}
