"""The port's attention: the plain version against the JAX package's composed
attention and its Pallas kernel (interpret mode), the ``fused_attention``
op's routing on the CPU, and the CUDA kernel's gate.

Tolerances are the JAX suite's own (tests/test_pallas_attention.py):
float32 ``atol 1e-5``; bfloat16 ``atol 2e-2``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_attention as pa
from paddle_tpu_torch.core.registry import LowerCtx, get
from paddle_tpu_torch.ops import flash_attention as fa

ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
SHAPES = [(2, 2, 128, 32), (1, 12, 128, 64)]


def _inputs(B, H, S, D, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, S, D).astype("float32") for _ in range(3))
    bias = np.where(rng.rand(B, 1, 1, S) < 0.9, 0.0, -1e4).astype("float32")
    return q, k, v, bias


def _j(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _t(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=["B2H2S128D32", "B1H12S128D64"])
def test_plain_matches_composed_and_pallas(shape, use_bias, causal, dtype):
    q, k, v, bias = _inputs(*shape)
    b = bias if use_bias else None
    scale = 1.0 / np.sqrt(shape[3])
    jargs = [_j(a, dtype) for a in (q, k, v)] + [None if b is None else _j(b, dtype)]
    composed = pa.composed_attention(*jargs, scale, 0.0, causal, jax.random.PRNGKey(0))
    flash = pa._flash(*jargs, jnp.int32(7), scale, 0.0, causal, True)
    out = fa.attention_plain(*[_t(a, dtype) for a in (q, k, v)],
                             None if b is None else _t(b, dtype), scale, causal)
    assert out.dtype == getattr(torch, dtype) and tuple(out.shape) == shape
    np.testing.assert_allclose(_f32(out), _f32(composed), atol=ATOL[dtype])
    np.testing.assert_allclose(_f32(out), _f32(flash), atol=ATOL[dtype])


@pytest.mark.parametrize("impl", ["auto", "pallas", "composed"])
def test_fused_attention_op_on_cpu_takes_the_plain_version(impl):
    q, k, v, bias = _inputs(2, 2, 128, 32, seed=1)
    attrs = {"scale": 0.0, "dropout_prob": 0.1, "is_test": True, "causal": False,
             "impl": impl}
    before = fa.flash_attn_fwd.launches
    ins = {"Q": [torch.from_numpy(q)], "K": [torch.from_numpy(k)],
           "V": [torch.from_numpy(v)], "Bias": [torch.from_numpy(bias)]}
    out = get("fused_attention").lower(LowerCtx(attrs), ins)["Out"][0]
    ref = pa.composed_attention(*(jnp.asarray(a) for a in (q, k, v, bias)),
                                1.0 / np.sqrt(32), 0.0, False, jax.random.PRNGKey(0))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    assert fa.flash_attn_fwd.launches == before


def test_fused_attention_train_mode_on_cpu_drops_out():
    q, k, v, _ = _inputs(1, 2, 128, 32, seed=2)
    attrs = {"scale": 0.0, "dropout_prob": 0.5, "is_test": False, "impl": "auto"}
    ins = {s: [torch.from_numpy(a)] for s, a in zip("QKV", (q, k, v))}
    a = get("fused_attention").lower(LowerCtx(attrs, seed=1, counter=0, salt=3), ins)
    b = get("fused_attention").lower(LowerCtx(attrs, seed=1, counter=1, salt=3), ins)
    plain = fa.attention_plain(*ins["Q"], *ins["K"], *ins["V"])
    assert not torch.allclose(a["Out"][0], plain) and not torch.equal(a["Out"][0], b["Out"][0])


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_kernel_gate():
    ok = _meta(2, 12, 200, 64)
    # the shape-side gate admits ragged S and both compiled head widths; the
    # device check is last, and a non-CUDA tensor is refused, never run
    assert "CUDA" in fa.kernel_refusal(ok, ok, ok, _meta(2, 1, 1, 200))
    assert "CUDA" in fa.kernel_refusal(*[_meta(1, 2, 128, 32, dtype=torch.float32)] * 3)
    assert "head width" in fa.kernel_refusal(*[_meta(2, 2, 128, 48)] * 3)
    assert "dtype" in fa.kernel_refusal(*[_meta(2, 2, 128, 64, dtype=torch.float16)] * 3)
    assert "bias must be [B,1,1,S]" in fa.kernel_refusal(ok, ok, ok, _meta(2, 12, 200, 200))
    assert "bias must match" in fa.kernel_refusal(
        ok, ok, ok, _meta(2, 1, 1, 200, dtype=torch.float32))
    assert "shape" in fa.kernel_refusal(ok, _meta(2, 12, 100, 64), ok)
    assert 64 in fa.HEAD_DIMS and 32 in fa.HEAD_DIMS


def test_wrapper_raises_on_cpu_tensors():
    q = torch.zeros(1, 1, 128, 64, dtype=torch.bfloat16)
    before = fa.flash_attn_fwd.launches
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attn_fwd(q, q, q)
    assert fa.flash_attn_fwd.launches == before


def test_off_cpu_routing_never_falls_back():
    """A tensor that is not on the CPU takes the kernel path, with dropout
    too (the kernels draw their own mask), and a tensor the kernels cannot
    take raises instead of running the plain version."""
    q = _meta(2, 2, 128, 64)
    run = get("fused_attention").lower
    before = fa.flash_attn_fwd.launches
    for attrs in ({"dropout_prob": 0.1, "is_test": False},
                  {"dropout_prob": 0.1, "is_test": True}):
        with pytest.raises(ValueError, match="CUDA"):
            run(LowerCtx(attrs), {"Q": [q], "K": [q], "V": [q]})
    assert fa.flash_attn_fwd.launches == before


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_impls_are_not_ported(impl):
    """Ring and Ulysses run over a bound sp group (tests/test_torch_sequence_parallel.py);
    without one the op raises, naming the impl, as the JAX op does off an sp mesh."""
    q = torch.zeros(1, 2, 128, 32)
    with pytest.raises(ValueError, match=f"impl='{impl}' needs a bound sp group"):
        get("fused_attention").lower(LowerCtx({"impl": impl, "is_test": True}),
                                     {"Q": [q], "K": [q], "V": [q]})


# --------------------------------------------------------------------------------------
# backward: the plain version against JAX's gradients
# --------------------------------------------------------------------------------------

# f32: the JAX suite's grad tolerance (tests/test_pallas_attention.py:52-53). bf16:
# 2e-2 relative to max|ref|. Both JAX paths and the plain version round the grads to
# bf16 once (one ulp, 2^-8 relative), but take P V and the softmax at other roundings
# of P, and the composed path's autodiff rounds its intermediates too.
BWD_TOL = {"float32": dict(atol=5e-5, rtol=1e-4), "bfloat16": dict(rel=2e-2)}


def _assert_close(got, ref, dtype, what):
    got, ref = _f32(got), _f32(ref)
    tol = BWD_TOL[dtype]
    if "rel" in tol:
        err, top = np.abs(got - ref).max(), np.abs(ref).max()
        assert err <= tol["rel"] * top, f"{what}: max err {err} vs max|ref| {top}"
    else:
        np.testing.assert_allclose(got, ref, err_msg=what, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("use_bias", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=["B2H2S128D32", "B1H12S128D64"])
def test_bwd_plain_matches_jax_grads(shape, use_bias, causal, dtype):
    """attention_bwd_plain against jax.vjp of the Pallas kernel (interpret
    mode, i.e. its backward kernel) and of composed_attention."""
    q, k, v, bias = _inputs(*shape)
    do = np.random.RandomState(9).randn(*shape).astype("float32")
    b = bias if use_bias else None
    scale = 1.0 / np.sqrt(shape[3])
    jb = None if b is None else _j(b, dtype)
    flash = lambda q, k, v: pa._flash(q, k, v, jb, jnp.int32(7), scale, 0.0, causal, True)
    composed = lambda q, k, v: pa.composed_attention(q, k, v, jb, scale, 0.0, causal,
                                                     jax.random.PRNGKey(0))
    jq = [_j(a, dtype) for a in (q, k, v)]
    tq = [_t(a, dtype) for a in (q, k, v)]
    tb = None if b is None else _t(b, dtype)
    o = fa.attention_plain(*tq, tb, scale, causal)
    got = fa.attention_bwd_plain(*tq, tb, o, _t(do, dtype), scale, causal)
    for name, f in (("pallas", flash), ("composed", composed)):
        _, vjp = jax.vjp(f, *jq)
        for g, r, which in zip(got, vjp(_j(do, dtype)), "qkv"):
            assert g.dtype == getattr(torch, dtype)
            _assert_close(g, r, dtype, f"d{which} vs {name}")


def test_bwd_plain_is_autograd_of_the_plain_forward_with_dropout():
    """With dropout, the plain backward equals torch autograd through
    attention_plain under the same Philox mask, causal and biased."""
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(2, 2, 40, 8, seed=4))
    do = torch.from_numpy(np.random.RandomState(5).randn(2, 2, 40, 8).astype("float32"))
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    o = fa.attention_plain(*qkv, bias, 0.3, True, 0.25, 77)
    ref = torch.autograd.grad(o, qkv, do)
    got = fa.attention_bwd_plain(q, k, v, bias, o.detach(), do, 0.3, True, 0.25, 77)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------------------
# the kernels' dropout mask
# --------------------------------------------------------------------------------------

def test_philox_known_answers():
    """Philox4x32-10 against the generator's published known-answer vectors."""
    def run(c, k):
        words = fa.philox4x32_10(*(torch.tensor([x], dtype=torch.int64) for x in c), *k)
        return [int(w) for w in words]
    assert run((0, 0, 0, 0), (0, 0)) == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    f = 0xFFFFFFFF
    assert run((f, f, f, f), (f, f)) == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert run((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0)) \
        == [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


def test_philox_mask_keep_rate_and_independence():
    p, B, H, S = 0.1, 2, 3, 128
    a = fa.philox_keep_mask(5, B, H, S, p).double()
    n = a.numel()
    sigma = np.sqrt(p * (1 - p) / n)
    assert abs(a.mean().item() - (1 - p)) < 4 * sigma
    # two independent masks agree on a fraction p^2 + (1-p)^2 of elements
    agree = p * p + (1 - p) * (1 - p)

    def check(x, y):
        m = x.numel()
        frac = (x == y).double().mean().item()
        assert abs(frac - agree) < 4 * np.sqrt(agree * (1 - agree) / m), frac
    check(a[0, 0], a[1, 2])              # across batch*heads
    check(a[:, :, :64], a[:, :, 64:])    # across rows
    check(a[..., :64], a[..., 64:])      # across key columns
    check(a, fa.philox_keep_mask(6, B, H, S, p).double())   # across seeds
    assert torch.equal(a, fa.philox_keep_mask(5, B, H, S, p).double())
    # a ragged S takes the same bits as the first S columns of a wider row
    wide = fa.philox_keep_mask(5, B, H, S, p)
    assert torch.equal(fa.philox_keep_mask(5, B, H, 50, p), wide[:, :, :50, :50])


def test_fused_attention_grad_op_on_cpu_regenerates_the_mask():
    """The op's grad (the generic fused_attention_grad, given the forward's
    salt) with dropout equals autograd of attention_plain under the mask of
    the op's own seed."""
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(1, 2, 128, 32, seed=6))
    do = torch.from_numpy(np.random.RandomState(7).randn(1, 2, 128, 32).astype("float32"))
    attrs = {"scale": 0.0, "dropout_prob": 0.2, "is_test": False, "impl": "auto"}
    ctx = LowerCtx(dict(attrs), seed=3, counter=4, salt=99)
    ins = {"Q": [q], "K": [k], "V": [v], "Bias": [bias]}
    out = get("fused_attention").lower(ctx, ins)["Out"][0]
    gattrs = dict(attrs, __fwd_attrs__=dict(attrs), __fwd_out_slots__=["Out"])
    grads = get("fused_attention_grad").lower(
        LowerCtx(gattrs, seed=3, counter=4, salt=99), dict(ins, Out=[out], **{"Out@GRAD": [do]}))
    assert set(grads) == {"Q@GRAD", "K@GRAD", "V@GRAD"}
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    ref_o = fa.attention_plain(*qkv, bias, 1 / np.sqrt(32), False, 0.2, ctx.seed_int())
    torch.testing.assert_close(out, ref_o.detach(), atol=0, rtol=0)
    ref = torch.autograd.grad(ref_o, qkv, do)
    for s, r in zip(("Q@GRAD", "K@GRAD", "V@GRAD"), ref):
        torch.testing.assert_close(grads[s][0], r, atol=1e-6, rtol=1e-6)
    # another run counter is another mask
    other = get("fused_attention").lower(LowerCtx(dict(attrs), seed=3, counter=5, salt=99), ins)
    assert not torch.equal(other["Out"][0], out)


def test_program_backward_uses_the_forward_ops_mask():
    """Through the executor: the grad op takes its forward op's salt
    (``__fwd_out0__``), so d mean(attention) / dQ is the gradient under the
    mask the forward drew."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.registry import stable_salt
    main, startup = pt.Program(), pt.Program()
    main.random_seed = 11
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        xs = [pt.data(n, [2, 64, 32], "float32") for n in "qkv"]
        for x in xs:
            x.stop_gradient = False
        out = pt.layers.fused_attention(*xs, dropout_prob=0.3)
        loss = pt.layers.mean(out)
        pt.append_backward(loss, parameter_list=[])
    feed = {n: np.random.RandomState(i).randn(1, 2, 64, 32).astype("float32")
            for i, n in enumerate("qkv")}
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        o, dq = exe.run(main, feed=feed, fetch_list=[out, "q@GRAD"])
    ctx = LowerCtx({}, seed=11, counter=0, salt=stable_salt(out.name))
    qkv = [torch.from_numpy(feed[n]).requires_grad_() for n in "qkv"]
    ref = fa.attention_plain(*qkv, None, 1 / np.sqrt(32), False, 0.3, ctx.seed_int())
    np.testing.assert_allclose(o, ref.detach().numpy(), atol=1e-6)
    g, = torch.autograd.grad(ref.mean(), qkv[:1])
    np.testing.assert_allclose(dq, g.numpy(), atol=1e-7, rtol=1e-5)


def test_kernel_path_asks_for_the_lse_only_under_autograd(monkeypatch):
    """Off the CPU, the serving call (no grad) launches the forward kernel
    without the LSE and without dropout; inside a grad op (inputs that
    require grad) the op goes through FlashAttention, which asks for the LSE
    and passes the op's dropout seed."""
    calls = []

    def fake_fwd(q, k, v, bias=None, scale=None, causal=False, dropout=0.0, seed=0,
                 return_lse=False, block_q=128):
        calls.append((dropout, seed, return_lse))
        o = torch.zeros(q.shape, dtype=q.dtype, device=q.device)
        return (o, torch.zeros(q.shape[:3], device=q.device)) if return_lse else o

    monkeypatch.setattr(fa, "flash_attn_fwd", fake_fwd)
    run = get("fused_attention").lower
    q = _meta(2, 2, 128, 64)
    run(LowerCtx({"dropout_prob": 0.1, "is_test": True}, salt=5), {"Q": [q], "K": [q], "V": [q]})
    assert calls == [(0.0, 0, False)]
    qg = _meta(2, 2, 128, 64).requires_grad_()
    ctx = LowerCtx({"dropout_prob": 0.1, "is_test": False}, seed=2, counter=3, salt=5)
    run(ctx, {"Q": [qg], "K": [qg], "V": [qg]})
    assert calls[1] == (0.1, ctx.seed_int(), True) and calls[1][1] != 0


def test_a_narrower_bias_is_widened_before_the_kernel(monkeypatch):
    """A bf16 model served in f32 (``Predictor.run(dtype="float32")``) feeds
    the kernel f32 q/k/v and the program's bf16 mask bias: the op widens
    the bias exactly, as the plain version's promotion does, and the kernel
    takes the call."""
    seen = []

    def fake_fwd(q, k, v, bias=None, scale=None, causal=False, dropout=0.0, seed=0,
                 return_lse=False, block_q=128):
        seen.append(bias.dtype)
        return torch.zeros(q.shape, dtype=q.dtype, device=q.device)

    monkeypatch.setattr(fa, "flash_attn_fwd", fake_fwd)
    q = _meta(2, 2, 128, 64, dtype=torch.float32)
    bias = _meta(2, 1, 1, 128)
    get("fused_attention").lower(LowerCtx({"is_test": True}), {"Q": [q], "K": [q], "V": [q],
                                                               "Bias": [bias]})
    assert seen == [torch.float32]
    x = torch.randn(1, 2, 8, 8)
    b = torch.tensor([0.0] * 5 + [-1e4] * 3, dtype=torch.bfloat16).reshape(1, 1, 1, 8)
    out = get("fused_attention").lower(LowerCtx({"is_test": True}),
                                       {"Q": [x], "K": [x], "V": [x], "Bias": [b]})["Out"][0]
    assert torch.equal(out, fa.attention_plain(x, x, x, b.float(), 8 ** -0.5, False))
