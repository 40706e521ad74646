"""Where the hand-written kernels' time goes: each kernel is built again
with parts of its work cut out and timed in turns against the whole one.

    python3 -m paddle_tpu_torch.tools.kernel_ablation [kernel ...]

(kernels: flash_attn_fwd, flash_attn_bwd, conv1x1_bn, int8_matmul; all
when none is named)

A variant is the committed source with an edit at a marked line (a comment
the edit looks for; the tool raises if a source no longer has it), compiled
by ``nvcc`` into ``csrc/build/ablation/`` and swapped in for the wrapper's
library. Variants of ``csrc/flash_attn_fwd.cu``:

- ``full``: the kernel as committed;
- ``no_math``: each tile's copies, syncs and the output stores only;
- ``qk_only``: plus Q K^T;
- ``no_softmax``: plus P V, with P the raw scores (no max, exp or sums).

Variants of ``csrc/flash_attn_bwd.cu`` (the fused and the split backward):

- ``full``;
- ``no_math``: copies, D and the stores only (both kernels of the split);
- ``s_dp_only``: plus S, dP and the P*M / dS tiles (the dK/dV kernel);
- ``no_dq``: all but the fused variant's dQ product.

Variants of ``csrc/conv1x1_bn.cu`` (the bf16 product and its column sums):

- ``full``;
- ``no_math``: the copies, the y stores and the column-sum pass only;
- ``no_stats``: plus the mma (no statistics in the epilogue).

Variants of ``csrc/int8_matmul.cu`` (the quantize pass and the product):

- ``full``;
- ``no_math``: the quantize pass, the copies and the stores only;
- ``no_mma``: plus the on-chip transpose of each w8 tile;
- ``no_rescale``: plus the mma (the epilogue stores float(acc)).

A cut variant's outputs are wrong by design; ``full`` is held against the
plain version (max |error| / max |plain|; for int8_matmul max |error|, 0
when bit-exact). Prints one JSON line per (kernel, shape): the median ms
of each variant (CUDA events, 25 launches each queued behind
``torch.cuda._sleep``, the variants in turns A B .. B A) with the card's
name and power limit. Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess

from ..core import cuda_build

_BWD_NEXT_TILE = "__syncthreads(); if (qt + 2 < n_qt) stage_q(qt + 2, slot); cp_commit(); continue;"
_K2_MMA = "    gemm_tile::warp_mma<T, gemm_tile::MmaBf16>(acc, sA, sA + T::kABytes, wm, wn, lane);"
_K2_STATS = "          if (interior) {"
_K2_NO_STATS = {_K2_STATS: "          if (false) {", "          } else if (m0 + r < p.M) {":
                "          } else if (false) {"}
_K3_T = "    transpose_w<T::BN>(sBt, slot + T::kABytes, tid);"
_K3_MMA = "    gemm_tile::warp_mma<T, gemm_tile::MmaS8>(acc, slot, sBt, wm, wn, lane);"
_K3_RESCALE = {"__fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * h]), xs), sWs[c])":
               "__int2float_rn(acc[mi][ni][2 * h])",
               "__fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * h + 1]), xs), sWs[c + 1])":
               "__int2float_rn(acc[mi][ni][2 * h + 1])"}
# kernel -> variant -> {marked line: replacement}
ABLATIONS = {
    "flash_attn_fwd": {
        "full": {},
        "no_math": {"    // scores for 32 rows x 64 keys": (
            "    if (nxt < n_tiles && tid < kBN) sBias[nslot * kBN + tid] = bias_next;\n"
            "    continue;\n    // scores for 32 rows x 64 keys")},
        "qk_only": {"    // online softmax (base 2);": (
            "    if (nxt < n_tiles && tid < kBN) sBias[nslot * kBN + tid] = bias_next;\n"
            "    continue;\n    // online softmax (base 2);")},
        "no_softmax": {
            "    // online softmax (base 2);": (
                "    uint32_t pa[kMT][kBN / 16][4];\n"
                "    for (int mt = 0; mt < kMT; ++mt)\n"
                "      for (int j = 0; j < kBN / 8; ++j) {\n"
                "        pa[mt][j / 2][(j & 1) * 2] = pack_bf16(s[mt][j][0], s[mt][j][1]);\n"
                "        pa[mt][j / 2][(j & 1) * 2 + 1] = pack_bf16(s[mt][j][2], s[mt][j][3]);\n"
                "      }\n#if 0\n    // online softmax (base 2);"),
            "    // O += P V: B fragments": "#endif\n    // O += P V: B fragments"},
    },
    "flash_attn_bwd": {
        "full": {},
        "no_math": {
            "    // phase 1: S = Q K^T and dP": f"    {_BWD_NEXT_TILE}\n    // phase 1: S = Q K^T and dP",
            "    const bool diagonal = p.causal && k0 + kDqKeys - 1": (
                "    if (kt + 1 < n_tiles && tid < kDqKeys) sBias[nslot * kDqKeys + tid] = bias_next;\n"
                "    continue;\n    const bool diagonal = p.causal && k0 + kDqKeys - 1")},
        "s_dp_only": {"    // phase 2: dV += (P*M)^T dO": f"    {_BWD_NEXT_TILE}\n    // phase 2: dV += (P*M)^T dO"},
        "no_dq": {"    if (kFused) {\n      // dQ = dS K": "    if (false) {\n      // dQ = dS K"},
    },
    "conv1x1_bn": {
        "full": {},
        "no_math": {_K2_MMA: "    // mma cut", **_K2_NO_STATS},
        "no_stats": dict(_K2_NO_STATS),
    },
    "int8_matmul": {
        "full": {},
        "no_math": {_K3_T: "    // transpose cut", _K3_MMA: "    // mma cut", **_K3_RESCALE},
        "no_mma": {_K3_MMA: "    // mma cut", **_K3_RESCALE},
        "no_rescale": dict(_K3_RESCALE),
    },
}


def _edit(source: str, edits: dict) -> str:
    for marked, replacement in edits.items():
        if marked not in source:
            raise RuntimeError(f"kernel_ablation: the source no longer has the line {marked!r}")
        source = source.replace(marked, replacement)
    return source


def build_variants(name: str) -> dict:
    """variant -> loaded library of kernel ``name``, one ``nvcc`` per variant in parallel."""
    out_dir = cuda_build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (cuda_build.CSRC / f"{name}.cu").read_text()
    procs = {}
    for variant, edits in ABLATIONS[name].items():
        src = out_dir / f"{name}_{variant}.cu"
        src.write_text(_edit(source, edits))
        lib = out_dir / f"lib{name}_{variant}.so"
        cmd = [cuda_build._nvcc(), *cuda_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-I", str(cuda_build.CSRC), "-o", str(lib), str(src)]
        procs[variant] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for variant, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"kernel_ablation: {name} {variant} did not build:\n{log}")
        libs[variant] = ctypes.CDLL(str(lib))
    return libs


def _device_ms(torch, fn, runs=25):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _inputs(torch, gen, B, S, H=12, D=64):
    """Head-split views of one packed projection, and a [B,1,1,S] padding bias."""
    qkv = torch.randn((B, S, 3 * H * D), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = (t.reshape(B, S, H, D).transpose(1, 2) for t in qkv.split(H * D, dim=2))
    lens = torch.randint(S // 4, S + 1, (B,), generator=gen, device="cuda")
    valid = torch.arange(S, device="cuda")[None, :] < lens[:, None]
    bias = ((valid.float() - 1.0) * 1e4).to(torch.bfloat16).reshape(B, 1, 1, S)
    do = torch.randn((B, H, S, D), generator=gen, device="cuda").to(torch.bfloat16)
    return q, k, v, bias, do


def _flash_cases(torch, gen):
    """(kernel, label, call, full_error): serving's and training's forward, the
    fused and the split backward. full_error() is the max |kernel - plain| /
    max |plain| of the loaded library's outputs."""
    from ..ops import flash_attention as fa
    cuda_build.load("flash_attn_fwd")        # the backward's inputs come from the full forward
    for name, B, S, drop in (("flash_attn_fwd", 8, 512, 0.0), ("flash_attn_fwd", 128, 128, 0.1),
                             ("flash_attn_bwd", 128, 128, 0.1), ("flash_attn_bwd", 8, 512, 0.1)):
        q, k, v, bias, do = _inputs(torch, gen, B, S)
        o, lse = fa.flash_attn_fwd(q, k, v, bias, 0.125, False, drop, 7, return_lse=True)
        if name == "flash_attn_fwd":
            call = (lambda q=q, k=k, v=v, bias=bias, drop=drop: fa.flash_attn_fwd(
                q, k, v, bias, 0.125, False, drop, 7, return_lse=drop > 0))
            refs = [fa.attention_plain(q, k, v, bias, 0.125, False, drop, 7)]
            got = lambda call=call, drop=drop: [call()] if drop == 0 else [call()[0]]
        else:
            call = (lambda q=q, k=k, v=v, bias=bias, o=o, lse=lse, do=do, drop=drop:
                    fa.flash_attn_bwd(q, k, v, bias, o, lse, do, 0.125, False, drop, 7))
            refs = fa.attention_bwd_plain(q, k, v, bias, o, do, 0.125, False, drop, 7)
            got = lambda call=call: list(call())
        err = lambda got=got, refs=refs: max(
            ((a.float() - r.float()).abs().max() / r.float().abs().max()).item()
            for a, r in zip(got(), refs))
        label = {"shape": [B, 12, S, 64], "dtype": "bfloat16", "bias": True, "dropout": drop,
                 "variant": fa.bwd_variant(S, torch.bfloat16) if "bwd" in name else None}
        yield name, label, call, err


def _gemm_cases(torch, gen):
    """conv1x1_bn at ResNet-50's widest-M and deepest-K shapes; int8_matmul at
    the 8 x 512 and 8 x 128 requests' ffn1, out-projection and ffn2 shapes."""
    from ..ops import conv_bn, int8_matmul as i8
    for M, K, N in ((401408, 64, 256), (6272, 2048, 512)):
        x2 = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn((N, K), generator=gen, device="cuda") * K ** -0.5).to(torch.bfloat16).t()
        z, one = torch.zeros(K, device="cuda"), torch.ones(K, device="cuda")
        args = (x2, w, z, one, z, z, 1e-5, False, False)
        ref = conv_bn.conv1x1_bn_plain(*args)[0].float()
        call = lambda args=args: conv_bn.fused_conv1x1_bn_fwd(*args)
        err = lambda call=call, ref=ref: ((call()[0].float() - ref).abs().max()
                                          / ref.abs().max()).item()
        yield "conv1x1_bn", {"shape": [M, K, N], "dtype": "bfloat16"}, call, err
    for M, K, N in ((4096, 768, 3072), (1024, 768, 768), (1024, 3072, 768)):
        x2 = (torch.randn((M, K), generator=gen, device="cuda") * 3).to(torch.bfloat16)
        w8 = torch.randint(-127, 128, (K, N), generator=gen, device="cuda").to(torch.int8)
        ws = torch.rand((N,), generator=gen, device="cuda") * 1e-3
        ref = i8.int8_matmul_plain(x2, w8, ws).float()
        call = lambda x2=x2, w8=w8, ws=ws: i8.int8_matmul(x2, w8, ws)
        err = lambda call=call, ref=ref: (call().float() - ref).abs().max().item()
        yield "int8_matmul", {"shape": [M, K, N], "dtype": "bfloat16",
                              "tile": i8.TILES[i8.int8_tile(M, N, i8._sm_count("cuda"))]}, call, err


def main():
    import sys
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ablation: needs a CUDA card")
    names = sys.argv[1:] or list(ABLATIONS)
    unknown = set(names) - set(ABLATIONS)
    if unknown:
        raise SystemExit(f"kernel_ablation: unknown kernels {sorted(unknown)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    libs = {name: build_variants(name) for name in names}
    cases = []
    if {"flash_attn_fwd", "flash_attn_bwd"} & set(names):
        cases += _flash_cases(torch, gen)
    if {"conv1x1_bn", "int8_matmul"} & set(names):
        cases += _gemm_cases(torch, gen)
    for name, label, call, err in cases:
        if name not in libs:
            continue
        variants = list(libs[name])
        ms = {vname: [] for vname in variants}
        full_err = None
        for vname in variants + variants[::-1]:       # in turns: A B .. B A
            cuda_build._loaded[name] = libs[name][vname]
            if vname == "full" and full_err is None:
                full_err = err()
            ms[vname].append(_device_ms(torch, call))
        print(json.dumps({"kernel": name, **label, "full_err_vs_plain": full_err,
                          "ms": {vname: statistics.median(t) for vname, t in ms.items()},
                          "device": smi}), flush=True)
    for name in names:
        cuda_build._loaded.pop(name, None)


if __name__ == "__main__":
    main()
