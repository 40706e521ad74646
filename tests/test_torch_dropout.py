"""The run counter on the card and the Philox dropout (``core/registry.py``,
``csrc/philox.cuh``, ``ops/dropout.py``, ``csrc/dropout.cu``), held on the
CPU, and the deterministic row gradients of ``gather`` and
``lookup_table_v2`` (``ops/tensor_ops.py``).

The kernels run only on the card (``chip_smoke.py`` holds them there bit for
bit against their plain versions); here the plain versions are held against
their definitions: the seed a kernel derives from the counter on the card
(``philox_key`` of a ``DeviceSeed``, the kernels' ``seed_of``) equals the host
``seed_int`` exactly; the plain keep mask is Philox's words in the stated
layout, follows (seed, counter, salt) and keeps 1 - p of the elements within
4 standard deviations; Out agrees with the mask exactly. The JAX package's
dropout draws from threefry, so it is held against the port by statistics
only. Tolerances: exact (``torch.equal``) wherever both sides compute the
same integers or the same f32 operations; the JAX comparison 4 standard
deviations of a binomial keep fraction.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import registry as jreg
import paddle_tpu_torch as pt
from paddle_tpu_torch.core import cuda_build
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.registry import DeviceSeed, LowerCtx, seed_int
from paddle_tpu_torch.ops import dropout as dmod
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import tensor_ops

COUNTERS = [0, 1, 2 ** 31, 2 ** 32 + 5]
SALTS = [0, 7, 2 ** 31 - 1, 2 ** 31 - 2, 2 ** 31 + 3]


# ------------------------------------------------------------- the run counter


@pytest.mark.parametrize("counter", COUNTERS)
def test_the_device_seed_equals_seed_int(counter):
    """``philox_key`` of a DeviceSeed (integer tensor ops on the counter's
    device, what a captured graph computes) gives ``seed_int``'s bits, with
    salts near 2^31 (masked to 31 bits on both sides) and program seeds
    that fill 64 bits."""
    t = torch.tensor([counter], dtype=torch.int64)
    for seed in (0, 11, 2 ** 63 - 1, 2 ** 64 - 1):
        for salt in SALTS:
            want = seed_int(seed, counter, salt)
            k0, k1 = fa.philox_key(DeviceSeed(t, seed, salt))
            assert (int(k1) << 32 | int(k0)) == want, (seed, salt)
            ctx = LowerCtx({}, seed=seed, counter=counter, salt=salt, counter_t=t)
            k0, k1 = fa.philox_key(ctx.kernel_seed())
            assert (int(k1) << 32 | int(k0)) == ctx.seed_int() == want


def test_mix_words_is_mix():
    rng = np.random.RandomState(0)
    for _ in range(500):
        h, v = (int(x) for x in rng.randint(0, 2 ** 63, 2, dtype=np.int64) * 2 + 1)
        hi, lo = fa._mix_words((h >> 32, h & 0xFFFFFFFF), (v >> 32, v & 0xFFFFFFFF))
        assert (hi << 32 | lo) == treg._mix(h, v)


def test_seed_int_is_unchanged():
    """The host definition the existing tests pin: LowerCtx.seed_int is the
    three rounds of ``_mix`` over (seed, counter, salt + offset), 63 bits."""
    ctx = LowerCtx({}, seed=3, counter=4, salt=99)
    want = treg._mix(treg._mix(treg._mix(0, 3), 4), (99 + 2) & 0x7FFFFFFF) & (2 ** 63 - 1)
    assert ctx.seed_int(2) == want
    assert ctx.kernel_seed(2) == want            # no counter on the card: the host int
    assert LowerCtx({}, abstract=True).kernel_seed() == 0


def test_the_kernels_mix_is_the_hosts():
    """philox.cuh's mix64 and seed_of carry registry._mix's constants,
    shifts and masks (the CUDA source is compiled only on the card)."""
    src = (Path(cuda_build.CSRC) / "philox.cuh").read_text()
    mix = re.search(r"mix64\(unsigned long long h,.*?\n}", src, re.S).group(0)
    for const in ("0x9E3779B97F4A7C15", "0xBF58476D1CE4E5B9", "0x94D049BB133111EB"):
        assert const in mix
    assert [int(k) for k in re.findall(r">> (\d+)\)", mix)] == [30, 27, 31]
    seed_of = re.search(r"seed_of\(.*?\n}", src, re.S).group(0)
    assert "0x7FFFFFFFull" in seed_of and "0x7FFFFFFFFFFFFFFFull" in seed_of
    for name in ("flash_attn_fwd.cu", "flash_attn_bwd.cu", "dropout.cu"):
        assert "run_seed(p.rng)" in (Path(cuda_build.CSRC) / name).read_text()


def test_attention_masks_follow_the_device_counter():
    """The attention plain version takes a DeviceSeed and drops exactly the
    mask of seed_int for the counter it holds."""
    B, H, S = 1, 2, 40
    t = torch.zeros((1,), dtype=torch.int64)
    for c in COUNTERS[:3]:
        t.fill_(c)
        a = fa.philox_keep_mask(DeviceSeed(t, 5, 2 ** 31 - 2), B, H, S, 0.2)
        b = fa.philox_keep_mask(seed_int(5, c, 2 ** 31 - 2), B, H, S, 0.2)
        assert torch.equal(a, b)


# ------------------------------------------------------------- dropout


def test_keep_mask_is_philox_in_the_stated_layout():
    """Element i takes word i % 4 of the call with counter (i // 4, 0, 0, 0)."""
    seed, n, p = 0x1234_5678_9ABC_DEF0, 37, 0.35
    mask = dmod.keep_mask(seed, n, p)
    for i in range(n):
        c = lambda v: torch.tensor([v], dtype=torch.int64)
        words = fa.philox4x32_10(c(i // 4), c(0), c(0), c(0), seed & 0xFFFFFFFF, seed >> 32)
        assert bool(mask[i]) == (int(words[i % 4]) >= fa.dropout_threshold(p)), i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("upscale", [True, False])
def test_plain_dropout_reproduces_and_agrees_with_its_mask(dtype, upscale):
    x = torch.from_numpy(np.random.RandomState(0).randn(64, 50).astype("float32")).to(dtype)
    p = 0.3
    ctx = lambda counter: LowerCtx({}, seed=9, counter=counter, salt=2 ** 31 - 5)
    out, mask = dmod.dropout(x, p, upscale, ctx(4).seed_int())
    again = dmod.dropout(x, p, upscale, ctx(4).seed_int())
    assert torch.equal(out, again[0]) and torch.equal(mask, again[1])
    other = dmod.dropout(x, p, upscale, ctx(5).seed_int())[1]
    assert not torch.equal(mask, other)                  # the counter moves the mask
    assert mask.dtype == dtype and set(mask.unique().tolist()) <= {0.0, 1.0}
    scale = 1.0 / (1.0 - p) if upscale else 1.0
    want = (x.float() * mask.float() / torch.tensor(1.0 - p) if upscale
            else x.float() * mask.float()).to(dtype)
    assert torch.equal(out, want)
    np.testing.assert_allclose(out.float().numpy(), (x.float() * mask.float() * scale).numpy(),
                               rtol=1e-6 if dtype == torch.float32 else 1e-2)
    # the same mask from the counter on the card (a DeviceSeed)
    t = torch.tensor([4], dtype=torch.int64)
    dev = dmod.dropout(x, p, upscale, DeviceSeed(t, 9, 2 ** 31 - 5))
    assert torch.equal(dev[0], out) and torch.equal(dev[1], mask)


def test_keep_fraction_is_one_minus_p():
    n, p = 200_000, 0.1
    sigma = np.sqrt(p * (1 - p) / n)
    for counter in range(3):
        keep = dmod.keep_mask(seed_int(1, counter, 3), n, p).float().mean().item()
        assert abs(keep - (1 - p)) < 4 * sigma


def test_edge_probabilities():
    x = torch.randn(5, 7)
    out, mask = dmod.dropout(x, 1.0, True, 3)
    assert torch.equal(out, torch.zeros_like(x)) and mask.sum() == 0
    out, mask = dmod.dropout(x, 0.0, False, 3)
    assert torch.equal(out, x) and torch.equal(mask, torch.ones_like(x))
    with pytest.raises(ValueError, match="dropout_prob"):
        dmod.dropout(x, 1.5, True, 3)


def test_the_wrapper_takes_cuda_tensors_only():
    x = torch.zeros(8, 8)
    before = dmod.dropout_fwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        dmod.dropout_fwd(x, 0.1, True, 1)
    assert dmod.dropout_fwd.launches == before
    assert dmod.dropout_fwd in cuda_build.COUNTED and "dropout" in cuda_build.SOURCES
    assert "CUDA" in dmod.kernel_refusal(torch.zeros(2, device="meta"))


def test_kernel_walk_covers_every_element_once():
    """Mirror of dropout_kernel's loop: thread v takes elements [8 v, 8 v +
    8) with the words of calls 2 v and 2 v + 1, so element i gets word i % 4
    of call i // 4, every element once, with 16-byte accesses only for whole
    groups."""
    for n in (1, 7, 8, 9, 1001 * 77, 4096):
        hits = np.zeros(n, np.int64)
        groups = -(-n // dmod.GROUP)
        for v in range(groups):
            for e in range(dmod.GROUP):
                i = v * dmod.GROUP + e
                if i < n:
                    call, word = 2 * v + e // 4, e % 4
                    assert (call, word) == (i // 4, i % 4)
                    hits[i] += 1
        assert (hits == 1).all()
    src = (Path(cuda_build.CSRC) / "dropout.cu").read_text()
    assert int(re.search(r"constexpr int kGroup = (\d+);", src).group(1)) == dmod.GROUP
    assert int(re.search(r"constexpr int kThreads = (\d+);", src).group(1)) == dmod.THREADS


def _dropout_program(upscale):
    main, startup = pt.Program(), pt.Program()
    main.random_seed = 4
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.data("x", [16, 24], "float32", append_batch_size=False)
        x.stop_gradient = False
        y = pt.layers.dropout(x, 0.25, dropout_implementation="upscale_in_train" if upscale
                              else "downgrade_in_infer")
        loss = pt.layers.mean(y)
        pt.append_backward(loss, parameter_list=[])
    mask = next(op for op in main.global_block().ops if op.type == "dropout").output("Mask")[0]
    return main, y, mask


@pytest.mark.parametrize("reuse", [True, False])
@pytest.mark.parametrize("upscale", [True, False])
def test_the_grad_op_regenerates_the_mask(reuse, upscale):
    """dropout_grad on the kept graph and on the recompute path
    (``_reuse_forward = False``) gives Mask * scale / numel for d mean / dx,
    with the Mask the forward drew."""
    main, y, mask_name = _dropout_program(upscale)
    x = np.random.RandomState(1).randn(16, 24).astype("float32")
    exe = pt.Executor(pt.CPUPlace())
    exe._reuse_forward = reuse
    with pt.scope_guard(pt.Scope()):
        out, mask, dx = exe.run(main, feed={"x": x}, fetch_list=[y, mask_name, "x@GRAD"])
    scale = 1 / 0.75 if upscale else 1.0
    np.testing.assert_allclose(dx, mask * scale / x.size, rtol=1e-6)
    np.testing.assert_allclose(out, x * mask * scale, rtol=1e-6)
    assert 0.5 < mask.mean() < 0.95


def test_runs_draw_new_masks_and_a_counter_redraws_one():
    main, _, mask_name = _dropout_program(True)
    x = np.ones((16, 24), "float32")
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        m0, m1 = (exe.run(main, feed={"x": x}, fetch_list=[mask_name])[0] for _ in range(2))
        main._rng_run_counter = 0
        again = exe.run(main, feed={"x": x}, fetch_list=[mask_name])[0]
    assert not np.array_equal(m0, m1) and np.array_equal(m0, again)


@pytest.mark.parametrize("upscale", [True, False])
def test_dropout_agrees_with_jax_in_statistics(upscale):
    """Threefry and Philox draw other bits: the keep fraction of each is
    1 - p within 4 sigma, Out's mean over kept elements is the input's
    times the scale on both."""
    x = np.abs(np.random.RandomState(2).randn(300, 400)).astype("float32") + 1.0
    p, n = 0.2, x.size
    attrs = {"dropout_prob": p, "is_test": False, "seed": 0,
             "dropout_implementation": "upscale_in_train" if upscale else "downgrade_in_infer"}
    jout = jreg.get("dropout").lower(jreg.LowerCtx(dict(attrs)), {"X": [x]})
    tout = treg.get("dropout").lower(LowerCtx(dict(attrs), seed=3, counter=1, salt=8),
                                     {"X": [torch.from_numpy(x)]})
    sigma = np.sqrt(p * (1 - p) / n)
    scale = 1 / (1 - p) if upscale else 1.0
    for out, mask in ((np.asarray(jout["Out"][0]), np.asarray(jout["Mask"][0])),
                      (tout["Out"][0].numpy(), tout["Mask"][0].numpy())):
        assert abs(mask.mean() - (1 - p)) < 4 * sigma
        kept = mask > 0
        np.testing.assert_allclose(out[kept], x[kept] * scale, rtol=1e-6)
        assert (out[~kept] == 0).all()


# ------------------------------------------------------------- row gradients


def test_row_gather_gradient_is_index_selects():
    x = torch.randn(9, 5, dtype=torch.float64, requires_grad=True)
    idx = torch.tensor([3, 3, 0, 8, 3, 1])
    assert torch.autograd.gradcheck(lambda t: tensor_ops.RowGather.apply(t, idx), (x,))
    g = torch.randn(6, 5, dtype=torch.float64)
    a, = torch.autograd.grad(tensor_ops.RowGather.apply(x, idx), x, g)
    b, = torch.autograd.grad(x.index_select(0, idx), x, g)
    assert torch.equal(a, b)


def test_row_gather_of_a_small_table_sums_by_matmul():
    """Few rows, many repeats (BERT's sentence embedding): the one-hot
    product gives index_select's gradient (f64: the sums differ in order
    only, far below 1e-12)."""
    rows = 3
    x = torch.randn(rows, 4, dtype=torch.float64, requires_grad=True)
    idx = torch.from_numpy(np.random.RandomState(4).randint(0, rows, rows * 70))
    assert rows * tensor_ops.DENSE_RATIO <= idx.numel()
    assert torch.autograd.gradcheck(lambda t: tensor_ops.RowGather.apply(t, idx), (x,))
    g = torch.randn(idx.numel(), 4, dtype=torch.float64)
    a, = torch.autograd.grad(tensor_ops.RowGather.apply(x, idx), x, g)
    b, = torch.autograd.grad(x.index_select(0, idx), x, g)
    torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("op_type", ["lookup_table_v2", "gather"])
def test_the_cpu_gradient_is_unchanged(op_type):
    """On the CPU the lowerings keep PyTorch's own gradients (RowGather is
    the card's): the op's generic grad equals autograd through F.embedding /
    index_select bit for bit."""
    rng = np.random.RandomState(3)
    w = torch.from_numpy(rng.randn(12, 6).astype("float32"))
    ids = torch.from_numpy(rng.randint(0, 12, (4, 5, 1)).astype("int64"))
    g = torch.from_numpy(rng.randn(4, 5, 6).astype("float32"))
    slots = {"W": [w], "Ids": [ids]} if op_type == "lookup_table_v2" else \
        {"X": [w], "Index": [ids.reshape(4, 5)]}
    attrs = {"padding_idx": -1} if op_type == "lookup_table_v2" else {"axis": 0}
    out = treg.get(op_type).lower(LowerCtx(dict(attrs)), slots)["Out"][0]
    gattrs = dict(attrs, __fwd_attrs__=dict(attrs), __fwd_out_slots__=["Out"])
    grads = treg.get(op_type + "_grad").lower(LowerCtx(gattrs),
                                              dict(slots, Out=[out], **{"Out@GRAD": [g]}))
    wr = w.clone().requires_grad_()
    ref = torch.nn.functional.embedding(ids.squeeze(-1), wr) if op_type == "lookup_table_v2" \
        else wr.index_select(0, ids.reshape(-1)).reshape(4, 5, 6)
    want, = torch.autograd.grad(ref, wr, g)
    got = grads["W@GRAD" if op_type == "lookup_table_v2" else "X@GRAD"][0]
    assert torch.equal(got, want)


def test_gather_along_another_axis_keeps_its_shape():
    x = torch.randn(3, 7, 4)
    idx = torch.tensor([[6, 0], [2, 2]])
    out = treg.get("gather").lower(LowerCtx({"axis": 1}), {"X": [x], "Index": [idx]})["Out"][0]
    assert out.shape == (3, 2, 2, 4)
    assert torch.equal(out[:, 1, 0], x[:, 2])
    assert fluid is not None            # both packages import in this module
