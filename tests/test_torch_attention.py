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
    """A tensor that is not on the CPU takes the kernel path: dropout > 0
    raises (no kernel dropout before the training slice), and a tensor the
    kernel cannot take raises instead of running the plain version."""
    q = _meta(2, 2, 128, 64)
    run = get("fused_attention").lower
    with pytest.raises(NotImplementedError, match="training slice"):
        run(LowerCtx({"dropout_prob": 0.1, "is_test": False}), {"Q": [q], "K": [q], "V": [q]})
    with pytest.raises(ValueError, match="CUDA"):
        run(LowerCtx({"dropout_prob": 0.1, "is_test": True}), {"Q": [q], "K": [q], "V": [q]})


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_impls_are_not_ported(impl):
    q = torch.zeros(1, 2, 128, 32)
    with pytest.raises(NotImplementedError, match=impl):
        get("fused_attention").lower(LowerCtx({"impl": impl, "is_test": True}),
                                     {"Q": [q], "K": [q], "V": [q]})
