"""Tier-A safety probe: may this build load kernel libraries from the store?

Tier A holds the ``nvcc`` libraries of the port's kernels
(``cuda_build.library_path``), compiled by another process, maybe in
another container. Loading one that a different build made, or that a
crash left wrong with a right checksum, can fault inside ``dlopen`` or
inside a launch, where nothing in the process can catch it. So the
verdict is decided, in this order, by:

1. a **forced verdict** (``PADDLE_TPU_WARMSTORE_PROBE=pass|fail``) for
   tests and the CLI selftest;
2. the **denylist**, builds known to be bad (empty: none found on the
   card so far);
3. a **cached verdict** of an earlier probe, one per build (torch, CUDA,
   ``nvcc``, driver, card), in the store's ``probe/``;
4. the **dynamic probe**: a subprocess that loads each library it is given
   and launches its kernel once against its plain version on the card; a
   crash, a timeout or a wrong answer fails the verdict without taking the
   caller down. With no library to probe yet there is no verdict to cache:
   the answer is a provisional pass that lets a fresh build be stored and
   is decided at the first library.

A failing verdict turns tier A off with a one-time warning: steps are
served from tier B, their kernels built by ``nvcc`` from the checkout's
sources. Nothing here runs unless the warm store is armed or a caller
(the CLI) asks.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
import threading
from typing import Optional, Sequence

ENV_FORCE = "PADDLE_TPU_WARMSTORE_PROBE"
_FORCE_MODES = ("auto", "pass", "fail")

#: builds whose stored libraries are known bad: (device kind prefix, nvcc
#: release substring, reason). None found on the card so far.
DENYLIST: tuple = ()

#: probe subprocesses spawned by this process (the tests' spies read it)
SPAWNS = 0

_lock = threading.Lock()
_mem_cache: dict = {}
_warned_tier_a = False


@dataclasses.dataclass(frozen=True)
class Verdict:
    """The per-build probe outcome; ``tier_a`` gates loading (and storing)
    kernel libraries."""
    tier_a: bool
    reason: str
    source: str          # forced | denylist | cached | subprocess | unprobed
    torch: str = ""
    cuda: str = ""
    nvcc: str = ""
    driver: str = ""
    device_kind: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def build_signature() -> dict:
    from . import keys as _keys
    sig = dict(_keys.versions())
    sig["device_kind"] = _keys.device_kind()
    return sig


def _sig_digest(sig: dict) -> str:
    return hashlib.sha256(json.dumps(sig, sort_keys=True).encode()).hexdigest()[:16]


def forced_mode() -> str:
    """The force variable through the shared mode parser (a typo raises)."""
    from ..observability import journal as _journal
    return _journal.mode_env(ENV_FORCE, _FORCE_MODES, default="auto", truthy="pass")


def _denylisted(sig: dict) -> Optional[str]:
    for kind, nvcc, reason in DENYLIST:
        if sig.get("device_kind", "").startswith(kind) and nvcc in sig.get("nvcc", ""):
            return reason
    return None


def _verdict_path(cache_dir: str, sig: dict) -> str:
    return os.path.join(cache_dir, f"probe_{_sig_digest(sig)}.json")


def _load_cached(cache_dir: Optional[str], sig: dict) -> Optional[Verdict]:
    if not cache_dir:
        return None
    try:
        with open(_verdict_path(cache_dir, sig)) as f:
            doc = json.load(f)
        return Verdict(tier_a=bool(doc["tier_a"]), reason=str(doc.get("reason", "")),
                       source="cached", **sig)
    except (OSError, ValueError, KeyError):
        return None


def _store_cached(cache_dir: Optional[str], sig: dict, v: Verdict) -> None:
    if not cache_dir:
        return
    try:
        os.makedirs(cache_dir, exist_ok=True)
        path = _verdict_path(cache_dir, sig)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(v.to_dict(), f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass   # an uncacheable verdict just probes again in the next process


def run_subprocess_probe(libraries: Sequence[str], timeout: float = 300.0) -> Verdict:
    """Spawn the probe child over ``libraries`` (paths) and turn its fate
    into a Verdict: a signal, a timeout or a missing OK marker fails."""
    global SPAWNS
    import subprocess
    sig = build_signature()
    with _lock:
        SPAWNS += 1
    env = dict(os.environ)
    env.pop(ENV_FORCE, None)
    env.pop("PADDLE_TPU_WARMSTORE", None)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.warmstore.probe", "--child",
             *map(str, libraries)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=timeout, env=env)
    except subprocess.TimeoutExpired:
        return Verdict(False, "probe subprocess timed out", "subprocess", **sig)
    except OSError as e:
        return Verdict(False, f"probe subprocess unlaunchable: {e}", "subprocess", **sig)
    out = (proc.stdout or b"").decode("utf-8", "replace")
    if proc.returncode == 0 and "PROBE-OK" in out:
        return Verdict(True, f"{len(libraries)} stored librar"
                             f"{'y' if len(libraries) == 1 else 'ies'} loaded and agreed with "
                             f"the plain versions", "subprocess", **sig)
    why = f"probe child exited {proc.returncode}" + (
        f" (signal {-proc.returncode})" if proc.returncode and proc.returncode < 0 else "")
    return Verdict(False, f"{why}: {out.strip()[-300:]}", "subprocess", **sig)


def verdict(cache_dir: Optional[str] = None, libraries: Sequence[str] = (),
            force: Optional[str] = None) -> Verdict:
    """The tier-A verdict for this build: forced -> in-memory -> denylist ->
    disk cache -> a subprocess probe over ``libraries``. With none to probe
    and nothing cached, a provisional pass that is not cached."""
    mode = force if force in ("pass", "fail") else forced_mode()
    sig = build_signature()
    if mode == "pass":
        return Verdict(True, "forced by env", "forced", **sig)
    if mode == "fail":
        return Verdict(False, "forced by env", "forced", **sig)
    ck = _sig_digest(sig)
    with _lock:
        v = _mem_cache.get(ck)
    if v is not None:
        return v
    deny = _denylisted(sig)
    if deny is not None:
        v = Verdict(False, deny, "denylist", **sig)
    else:
        v = _load_cached(cache_dir, sig)
        if v is None:
            if not libraries:
                return Verdict(True, "no stored library to probe yet", "unprobed", **sig)
            v = run_subprocess_probe(libraries)
            _store_cached(cache_dir, sig, v)
    with _lock:
        _mem_cache[ck] = v
    return v


def warn_tier_a_disabled_once(v: Verdict) -> None:
    """A one-time, journalled warning when tier A was wanted and the verdict
    said no."""
    global _warned_tier_a
    with _lock:
        if _warned_tier_a:
            return
        _warned_tier_a = True
    import warnings
    from ..observability import journal as _journal
    warnings.warn(f"paddle_tpu_torch warmstore: tier A (stored kernel libraries) disabled "
                  f"on this build -- {v.reason} (source: {v.source}); kernels are built by "
                  f"nvcc from the checkout's sources instead")
    _journal.emit({"event": "warmstore_probe", "tier_a": v.tier_a, "reason": v.reason,
                   "source": v.source})


def reset_for_tests() -> None:
    global _warned_tier_a, SPAWNS
    with _lock:
        _mem_cache.clear()
        _warned_tier_a = False
        SPAWNS = 0


# ---------------------------------------------------------------- child --

def _check_flash_attn_fwd(torch):
    from ..ops.flash_attention import attention_plain, flash_attn_fwd
    q, k, v = (torch.randn((1, 2, 96, 64), device="cuda") for _ in range(3))
    out = flash_attn_fwd(q, k, v, None, 0.125)
    return (out - attention_plain(q, k, v, None, 0.125)).abs().max().item() <= 1e-5


def _check_flash_attn_bwd(torch):
    from ..ops.flash_attention import attention_bwd_plain, attention_plain, flash_attn_bwd
    q, k, v, do = (torch.randn((1, 2, 96, 64), device="cuda") for _ in range(4))
    o = attention_plain(q, k, v, None, 0.125)
    lse = torch.logsumexp(torch.matmul(q, k.transpose(-1, -2)) * 0.125, dim=-1)
    got = flash_attn_bwd(q, k, v, None, o, lse, do, 0.125)
    ref = attention_bwd_plain(q, k, v, None, o, do, 0.125)
    return all((a - b).abs().max().item() <= 1e-5 * (1.0 + b.abs().max().item())
               for a, b in zip(got, ref))


def _check_dropout(torch):
    from ..ops.dropout import dropout_fwd, dropout_plain
    x = torch.randn((4096,), device="cuda")
    out, mask = dropout_fwd(x, 0.1, True, 7)
    ref_out, ref_mask = dropout_plain(x, 0.1, True, 7)
    return torch.equal(out, ref_out) and torch.equal(mask, ref_mask)


def _check_conv1x1_bn(torch):
    from ..ops.conv_bn import conv1x1_bn_plain, fused_conv1x1_bn_fwd
    x2 = torch.randn((256, 64), device="cuda")
    w = torch.randn((64, 64), device="cuda").t()      # the [N, K] filter's view
    mu, var, gamma, beta = (torch.rand((64,), device="cuda") + 0.5 for _ in range(4))
    got = fused_conv1x1_bn_fwd(x2, w, mu, var, gamma, beta)
    ref = conv1x1_bn_plain(x2, w, mu, var, gamma, beta)
    return all((a - b).abs().max().item() <= 1e-5 * (1.0 + b.abs().max().item())
               for a, b in zip(got, ref))


def _check_int8_matmul(torch):
    from ..ops.int8_matmul import int8_matmul, int8_matmul_plain
    x2 = torch.randn((64, 128), device="cuda").to(torch.bfloat16)
    w8 = torch.randint(-127, 128, (128, 64), device="cuda", dtype=torch.int8)
    ws = torch.rand((64,), device="cuda") * 0.01
    return torch.equal(int8_matmul(x2, w8, ws), int8_matmul_plain(x2, w8, ws))


def _check_multi_tensor_update(torch):
    from ..ops.multi_tensor import multi_tensor_update, update_plain

    def ins():
        g = torch.Generator(device="cuda").manual_seed(3)
        return [{"Param": [torch.randn((n,), device="cuda", generator=g)],
                 "Grad": [torch.randn((n,), device="cuda", generator=g)],
                 "LearningRate": [torch.full((1,), 0.1, device="cuda")]} for n in (1000, 77)]
    got = multi_tensor_update("sgd", [{}, {}], ins())
    ref = update_plain("sgd", [{}, {}], ins())
    return all(torch.allclose(a["ParamOut"][0], b["ParamOut"][0], rtol=1e-6, atol=1e-7)
               for a, b in zip(got, ref))


#: each kernel's check: one launch of its wrapper on the card against its plain
#: version, True when they agree (f32 within 1e-5, integer and mask paths equal)
CHECKS = {"flash_attn_fwd": _check_flash_attn_fwd, "flash_attn_bwd": _check_flash_attn_bwd,
          "dropout": _check_dropout, "conv1x1_bn": _check_conv1x1_bn,
          "int8_matmul": _check_int8_matmul,
          "multi_tensor_update": _check_multi_tensor_update}


def kernel_of(path: str) -> str:
    """``lib<name>-<digest>.so`` -> ``<name>``."""
    base = os.path.basename(str(path))
    return base[len("lib"):].rsplit("-", 1)[0]


def _child_main(paths) -> int:
    """The probe body, in a throwaway subprocess: each library is loaded with
    ``dlopen`` in place of a build, then its kernel runs once against its
    plain version. A fault kills this process, not the caller."""
    import ctypes
    import torch
    from ..core import cuda_build
    if not torch.cuda.is_available():
        print("PROBE-BAD: no card to launch on")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    for path in paths:
        name = kernel_of(path)
        check = CHECKS.get(name)
        if check is None:
            print(f"PROBE-BAD: no check for kernel {name!r} ({path})")
            return 1
        cuda_build._loaded[name] = ctypes.CDLL(str(path))
        ok = check(torch)
        torch.cuda.synchronize()
        if not ok:
            print(f"PROBE-BAD: {name} disagrees with its plain version")
            return 1
        print(f"probe: {name} ok")
    print("PROBE-OK")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--child":
        return _child_main(argv[1:])
    v = verdict()
    print(json.dumps(v.to_dict(), indent=1, sort_keys=True))
    return 0 if v.tier_a else 1


if __name__ == "__main__":
    sys.exit(main())
