"""Layouts and schedules of the GEMM kernels K2 (``csrc/conv1x1_bn.cu``) and
K3 (``csrc/int8_matmul.cu``), held on the CPU.

The kernels run only on the card. What they do with indices is mirrored
here: K2's persistent schedule (every (M tile, column block) owned by one
block; its column partials summed in the second kernel's order), K3's codes
scratch and K-stage sums (exact), and K3's on-chip transpose of each w8 tile
(the swizzled slot the copies fill, the 4 x 4 byte-block transpose, and the
shared-memory banks a warp touches). The wrappers' scratch shapes and launch
arguments are read through a stubbed launcher.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import conv_bn as cb
from paddle_tpu_torch.ops import int8_matmul as i8


def _ceil(a, b):
    return -(-a // b)


# ----------------------------------------------------------------------------- K2


def block_tiles(M, rows, gy):
    """The M tiles block row gy walks, in order (the kernel's loop over it)."""
    return list(range(gy, _ceil(M, cb.BF16_TILE_M), rows))


def column_sums_order(part):
    """column_sums_kernel's sum of a [rows, N] partial block: thread ty of 32
    adds rows ty, ty + 32, ... in turn, then the 32 thread sums in order."""
    rows, N = part.shape
    acc = torch.zeros((32, N))
    for r in range(rows):
        acc[r % 32] += part[r]
    total = torch.zeros((N,))
    for ty in range(32):
        total += acc[ty]
    return total


@pytest.mark.parametrize("M,N,sms", [(401408, 256, 132), (401408, 64, 132), (6272, 512, 132),
                                     (1000, 2048, 132), (1000, 100, 3)])
def test_k2_schedule_owns_every_tile_once(M, N, sms):
    """Block (cb, gy) of the (col_blocks, rows) grid walks block_tiles(M, rows,
    gy) of column block cb: each (M tile, column block) has exactly one owner,
    and the grid has about two blocks an SM where there are tiles enough."""
    rows = cb.partial_rows(M, N, torch.bfloat16, sms)
    col_blocks = _ceil(N, cb.bf16_tile_n(N))
    tiles = _ceil(M, cb.BF16_TILE_M)
    assert 1 <= rows <= min(tiles, 65535)
    owners = {}
    for c in range(col_blocks):
        for gy in range(rows):
            mine = block_tiles(M, rows, gy)
            assert mine, "every block of the grid has a tile"
            for mt in mine:
                assert (mt, c) not in owners
                owners[(mt, c)] = (c, gy)
    assert set(owners) == {(mt, c) for mt in range(tiles) for c in range(col_blocks)}
    assert col_blocks * rows >= min(2 * sms, tiles * col_blocks)


@pytest.mark.parametrize("M,K,N,sms", [(1000, 36, 100, 2), (700, 64, 64, 3)])
def test_k2_partials_in_kernel_order_match_plain_stats(M, K, N, sms):
    """Each block's column sums of the rounded y over its tiles, then the
    second kernel's order over the blocks' rows, give conv1x1_bn_plain's
    statistics within f32 summation-order error (1e-5 of sum |y|)."""
    rng = np.random.RandomState(0)
    x2 = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.randn(K, N) / np.sqrt(K)).astype(np.float32)).to(torch.bfloat16)
    z, one = torch.zeros(K), torch.ones(K)
    y, s, ss = cb.conv1x1_bn_plain(x2, w, z, one, z, z, 1e-5, False, False)
    yf = y.float()
    rows = cb.partial_rows(M, N, torch.bfloat16, sms)
    part = torch.zeros((2, rows, N))
    for gy in range(rows):
        for mt in block_tiles(M, rows, gy):
            blk = yf[mt * cb.BF16_TILE_M:(mt + 1) * cb.BF16_TILE_M]
            part[0, gy] += blk.sum(0)
            part[1, gy] += (blk * blk).sum(0)
    ks, kss = column_sums_order(part[0]), column_sums_order(part[1])
    torch.testing.assert_close(ks, s, rtol=0, atol=1e-5 * float(yf.abs().sum(0).max()))
    torch.testing.assert_close(kss, ss, rtol=0, atol=1e-5 * float((yf * yf).sum(0).max()))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k2_launch_arguments(monkeypatch, dtype):
    """One launch per call with the scratch [2, rows, N] and rows passed to
    the C entry: the persistent grid's rows in bf16, 64-row tiles in f32; the
    filter as the contiguous [N, K] it is stored as."""
    calls = []
    monkeypatch.setattr(cb, "kernel_refusal", lambda *a: None)
    monkeypatch.setattr(cb, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(cb, "_launch", lambda dev, ptrs, *ints: calls.append((ptrs, ints)))
    M, K, N = 40000, 64, 256
    x2 = torch.zeros(M, K, dtype=dtype)
    w = torch.zeros(N, K, dtype=dtype).t()
    z = torch.zeros(K)
    before = cb.fused_conv1x1_bn_fwd.launches
    y, s, ss = cb._on_card(x2, w, z, z + 1, z, z, 1e-5, False, False)
    (ptrs, ints), = calls
    rows = _ceil(M, 64) if dtype == torch.float32 else min(_ceil(M, 128), 132)
    assert ints == (M, K, N, cb._DTYPE_CODES[dtype], 0, 0, 1, rows)
    assert ptrs[1] == w.data_ptr()                     # w^T of the [N, K] filter: no copy
    assert y.shape == (M, N) and y.dtype == dtype and s.shape == ss.shape == (N,)
    assert cb.fused_conv1x1_bn_fwd.launches == before + 1


# ----------------------------------------------------------------------------- K3


@pytest.mark.parametrize("M,N,tile", [(4096, 3072, (128, 128)), (4096, 2304, (128, 128)),
                                      (4096, 768, (64, 64)), (1024, 3072, (64, 64))])
def test_k3_tile_by_shape(M, N, tile):
    """128 x 128 where its grid is two waves of two blocks on each of an
    H100's 132 SMs, else 64 x 64."""
    assert i8.TILES[i8.int8_tile(M, N, 132)] == tile


def test_k3_launch_arguments(monkeypatch):
    """One launch per call; the codes scratch [M, Kp] (K rounded up to 16)
    is what return_codes hands back, as a view of its first K columns."""
    calls = []
    monkeypatch.setattr(i8, "kernel_refusal", lambda *a: None)
    monkeypatch.setattr(i8, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(i8, "_launch", lambda dev, ptrs, *ints: calls.append((ptrs, ints)))
    M, K, N = 1001, 301, 131
    x2 = torch.zeros(M, K, dtype=torch.bfloat16)
    before = i8.int8_matmul.launches
    out, xs, xq = i8._on_card(x2, torch.zeros(K, N, dtype=torch.int8), torch.ones(N), True)
    (ptrs, ints), = calls
    assert ints == (M, K, N, 304, 1, 0, 0, i8.int8_tile(M, N, 132))
    assert ptrs[5] == xq.data_ptr() and xq.shape == (M, K) and xq.stride() == (304, 1)
    assert out.shape == (M, N) and out.dtype == torch.bfloat16 and xs.shape == (M,)
    assert i8.int8_matmul.launches == before + 1


@pytest.mark.parametrize("K", [301, 768])
def test_k3_padded_codes_and_k_stages_are_exact(K):
    """The product over the zero-padded codes [M, Kp], as int32 sums of
    64-deep K stages added in any order, then the rescale, is
    int8_matmul_plain bit for bit."""
    rng = np.random.RandomState(K)
    M, N = 70, 96
    x2 = torch.from_numpy((rng.randn(M, K) * 3).astype(np.float32)).to(torch.bfloat16)
    w8 = torch.from_numpy(rng.randint(-127, 128, (K, N)).astype(np.int8))
    ws = torch.from_numpy((rng.rand(N) * 1e-3).astype(np.float32))
    ref, xs, xq = i8.int8_matmul_plain(x2, w8, ws, return_codes=True)
    Kp = i8.padded_k(K)
    codes = torch.zeros((M, Kp), dtype=torch.int32)
    codes[:, :K] = xq.int()
    wp = torch.zeros((Kp, N), dtype=torch.int32)
    wp[:K] = w8.int()
    stages = [codes[:, k:k + 64] @ wp[k:k + 64] for k in range(0, Kp, 64)]
    acc = sum(reversed(stages))
    out = ((acc.float() * xs[:, None]) * ws).to(x2.dtype)
    assert torch.equal(out, ref)


def _transpose_mirror(tile, BN):
    """The kernel's path for one w8 tile [64 k][BN n] (int8): load_w_raw's
    swizzled slot, then transpose_w into the padded K-major tile [BN][80]
    (bytes). Returns the tile and, per warp instruction, the shared-memory
    banks of each lane's 32-bit reads and stores."""
    chunks = BN // 16
    raw = np.zeros(64 * BN, np.uint8)
    for r in range(64):
        for c in range(chunks):
            dst = r * BN + (c ^ ((r >> 2) & (chunks - 1))) * 16
            raw[dst:dst + 16] = tile[r, c * 16:(c + 1) * 16].view(np.uint8)
    sbt = np.zeros(BN * 80, np.uint8)
    reads, stores = {}, {}
    for i in range(4 * BN):
        kb, nb = i & 15, i >> 4
        base = ((nb >> 2) ^ (kb & (chunks - 1))) * 16 + (nb & 3) * 4
        for j in range(4):
            addr = base + (4 * kb + j) * BN
            reads.setdefault((i // 32, j), []).append(addr // 4 % 32)
            word = raw[addr:addr + 4]                  # columns 4 nb .. 4 nb + 3 of row 4 kb + j
            for col in range(4):
                sbt[(4 * nb + col) * 80 + 4 * kb + j] = word[col]
        for col in range(4):
            stores.setdefault((i // 32, col), []).append(((4 * nb + col) * 80 + 4 * kb) // 4 % 32)
    return sbt.reshape(BN, 80)[:, :64], reads, stores


@pytest.mark.parametrize("BN", [128, 64])
def test_k3_w8_transpose_mirror(BN):
    """The transposed tile holds w8^T (column n, k contiguous); each warp's
    transpose stores hit 32 distinct banks, and its reads of the swizzled
    slot at most 2 (BN 128) or 4 (BN 64) lanes a bank."""
    rng = np.random.RandomState(BN)
    tile = rng.randint(-127, 128, (64, BN)).astype(np.int8)
    sbt, reads, stores = _transpose_mirror(tile, BN)
    assert np.array_equal(sbt.view(np.int8), tile.T)
    assert all(len(set(b)) == 32 for b in stores.values())
    worst = max(max(np.bincount(b)) for b in reads.values())
    assert worst <= (2 if BN == 128 else 4)
