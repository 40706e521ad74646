"""The flash-attention kernels' dropout-mask layout and backward variants, on
the CPU.

The kernels (csrc/philox.cuh) give element (row, key) of head b * H + h the
word ``2 * ((row % 16) // 8) + key % 2`` of Philox4x32-10 at counter
``(key // 2, (row // 16) * 8 + row % 8, b * H + h, 0)``, so that one call
serves the four elements a thread holds in an m16n8 score fragment. Here an
independent numpy Philox and a mirror of the kernels' fragment map hold
``philox_keep_mask`` to that layout, and a stubbed launcher shows which
backward variant the wrapper asks for at each S.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import flash_attention as fa

_M = (np.uint64(0xD2511F53), np.uint64(0xCD9E8D57))
_W = (0x9E3779B9, 0xBB67AE85)
_U32 = np.uint64(0xFFFFFFFF)


def _philox_np(c, k0, k1):
    """Philox4x32-10 on uint64 arrays holding 32-bit words (Salmon et al., SC'11)."""
    c = [np.asarray(x, dtype=np.uint64) for x in c]
    for _ in range(10):
        p0, p1 = _M[0] * c[0], _M[1] * c[2]         # < 2^64: exact in uint64
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ np.uint64(k0), p1 & _U32,
             (p0 >> np.uint64(32)) ^ c[3] ^ np.uint64(k1), p0 & _U32]
        k0, k1 = (k0 + _W[0]) & 0xFFFFFFFF, (k1 + _W[1]) & 0xFFFFFFFF
    return np.stack(c)


def _counter(row, key):
    """The documented layout: (counter words 0 and 1, word) of element (row, key)."""
    return key // 2, (row // 16) * 8 + row % 8, 2 * ((row % 16) // 8) + key % 2


def _kernel_fragment(r0, c0):
    """What a kernel thread does for the fragment whose first element is (r0, c0)
    (r0 % 16 < 8, c0 even): one call at counter (c0 / 2, frag_row(r0)), words
    x, y, z, w to (r0, c0), (r0, c0 + 1), (r0 + 8, c0), (r0 + 8, c0 + 1)."""
    call = (c0 >> 1, ((r0 >> 4) << 3) | (r0 & 7))
    return call, [(r0, c0), (r0, c0 + 1), (r0 + 8, c0), (r0 + 8, c0 + 1)]


def _fragments(n):
    """Every m16n8 fragment a kernel thread holds over an n x n score grid: row
    groups of 16 (thread row g), key tiles of 8 (thread column pair t)."""
    for base in range(0, n, 16):
        for g in range(8):
            for k8 in range(0, n, 8):
                for t in range(4):
                    yield _kernel_fragment(base + g, k8 + 2 * t)


@pytest.mark.parametrize("seed", [0x9E3779B97F4A7C15, 12345])
def test_keep_mask_matches_an_independent_numpy_philox(seed):
    B, H, S, p = 2, 3, 37, 0.3         # B*H > 1; S ragged in rows and in key pairs
    rows, keys = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
    c0, c1, word = _counter(rows, keys)
    expect = np.empty((B, H, S, S), dtype=bool)
    for bh in range(B * H):
        ctr = [c0, c1, np.full_like(c0, bh), np.zeros_like(c0)]
        bits = _philox_np(ctr, seed & 0xFFFFFFFF, seed >> 32)
        expect[bh // H, bh % H] = np.take_along_axis(bits, word[None], 0)[0] >= \
            fa.dropout_threshold(p)
    got = fa.philox_keep_mask(seed, B, H, S, p)
    assert got.dtype == torch.bool and tuple(got.shape) == (B, H, S, S)
    np.testing.assert_array_equal(got.numpy(), expect)


@pytest.mark.parametrize("n", [64, 200])
def test_each_fragment_is_one_generator_call(n):
    """The four elements of every fragment share one counter, in word order."""
    for call, elems in _fragments(n):
        for w, (r, c) in enumerate(elems):
            assert _counter(r, c) == (*call, w)


@pytest.mark.parametrize("n", [64, 200])
def test_layout_is_a_bijection(n):
    """(row, key) -> (counter, word) is one-to-one over an n x n grid, and the
    kernels' fragments cover the grid with a quarter call per element."""
    seen = {}
    for r in range(n):
        for c in range(n):
            seen.setdefault(_counter(r, c), (r, c))
    assert len(seen) == n * n
    calls = {call for call, elems in _fragments(n) if any(r < n and c < n for r, c in elems)}
    assert len(calls) * 4 >= n * n and (n % 16 or len(calls) * 4 == n * n)


def test_keep_mask_of_a_ragged_s_is_a_prefix():
    wide = fa.philox_keep_mask(7, 1, 2, 64, 0.5)
    for S in (1, 15, 17, 33):
        assert torch.equal(fa.philox_keep_mask(7, 1, 2, S, 0.5), wide[:, :, :S, :S])


@pytest.mark.parametrize("S, dtype, variant", [
    (64, torch.bfloat16, "fused"), (128, torch.bfloat16, "fused"),
    (129, torch.bfloat16, "split"), (512, torch.bfloat16, "split"),
    (128, torch.float32, "f32")])
def test_backward_variant_by_s(monkeypatch, S, dtype, variant):
    """The wrapper asks for the fused single-launch backward while one block
    spans every key (S <= 128) and for the split one beyond, and allocates the
    D scratch only for the variants where one kernel hands D to another."""
    calls = []
    monkeypatch.setattr(fa, "bwd_refusal", lambda *a: None)
    monkeypatch.setattr(fa, "_launch", lambda name, ptrs, *args: calls.append((name, ptrs, args)))
    q = torch.zeros(1, 2, S, 64, dtype=dtype)
    before = fa.flash_attn_bwd.launches
    dq, dk, dv = fa.flash_attn_bwd(q, q, q, None, q, torch.zeros(1, 2, S), q)
    (name, ptrs, args), = calls
    assert name == "flash_attn_bwd" and fa.bwd_variant(S, dtype) == variant
    assert args[-1] == fa.BWD_VARIANTS[variant]
    assert (ptrs[7] is None) == (variant == "fused")
    assert all(t.shape == q.shape and t.dtype == dtype for t in (dq, dk, dv))
    assert fa.flash_attn_bwd.launches == before + 1
