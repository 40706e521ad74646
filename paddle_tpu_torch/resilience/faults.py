"""Deterministic, seedable fault-injection registry (the port's copy of
``paddle_tpu/resilience/faults.py``).

The recovery paths in ``recovery.py`` must be testable against the faults
that are routine at scale (a preempted host, a transient dispatch error, a
batch that NaNs the loss); this registry arms :class:`Fault` entries from
``PADDLE_TPU_FAULTS`` (parsed once, at import) or :func:`install`, fired
from cheap hook points: ``Executor.run`` (``compile`` at a graph's capture,
``dispatch`` before a step, ``fetch`` after it), ``Checkpointer.save``
(``checkpoint_write``) and the streaming data plane (``read``, ``parse``).

Spec grammar (entries separated by ``;``)::

    kind[@site][:key=value]*

    nan:step=3:var=loss            # overwrite tensor 'loss' with NaN at step 3
    exc@dispatch:step=5            # transient (retryable) error at dispatch
    exc@checkpoint_write:times=2   # first two checkpoint writes fail
    hang@fetch:step=4:seconds=30   # artificial hang (trips the step deadline)
    preempt:step=7                 # simulated SIGTERM (preemption flag)
    kill:step=5                    # hard rank death: SIGKILL this process
    corrupt:step=5:seed=1          # bit-flip a written checkpoint chunk
    truncate:step=5                # cut a written checkpoint chunk in half
    exc@read:prob=0.1:seed=7:times=0      # flaky stream source
    corrupt@parse:step=12                 # garble record 12 into a poison line

Kinds: ``nan`` (also ``value=inf|-inf|<float>``), ``exc``, ``hang``,
``preempt``, ``kill`` (``value=<int>`` exits with that code instead of
SIGKILL), ``corrupt``, ``truncate``. Keys: ``step`` (the program's run
counter at the training sites, the stream record index at ``read`` /
``parse``; omitted = every step), ``var`` (a tensor name at the training
sites, a source name at the stream sites), ``times`` (total fires, default
1; 0 = unlimited), ``seconds``, ``prob`` + ``seed`` (a seeded Bernoulli
draw per match), ``value``.

The serving tier's sites (``serve_dispatch``, ``serve_fetch``,
``serve_hang``, fired by ``serving/pool.py``) and its data hook
(:func:`corrupt_serving`) work as in the JAX package, and so does the warm
store's (``warmstore_write``, :func:`mutate_warmstore`, fired by
``warmstore/store.py`` after each commit). The online publisher's
(``online_export``, :func:`corrupt_delta`) parses as in the JAX package, but
its hook raises: ``online/`` is not ported (ROADMAP item 10 (c)).

Every fire increments ``fault_injected_total{kind,site}`` and journals a
``fault`` event. With nothing armed a hook costs one module-attribute
truthiness check (callers guard on ``faults._active``).
"""
from __future__ import annotations

import dataclasses
import math
import os
import random
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

from ..observability import journal as _journal
from ..observability.metrics import REGISTRY as _OBS

ENV_VAR = "PADDLE_TPU_FAULTS"

KINDS = ("nan", "exc", "hang", "preempt", "kill", "corrupt", "truncate")
SITES = ("compile", "dispatch", "fetch", "checkpoint_write",
         "serve_dispatch", "serve_fetch", "serve_hang", "read", "parse",
         "online_export", "warmstore_write")
#: the serving tier's sites (``var`` names a tenant); nothing in the port
#: fires them yet
SERVING_SITES = ("serve_dispatch", "serve_fetch", "serve_hang")
#: sites fired from the streaming data plane (``data/streaming.py``);
#: ``var`` names a source, ``step`` is the record index
STREAM_SITES = ("read", "parse")
_DEFAULT_SITE = {"nan": "fetch", "exc": "dispatch", "hang": "fetch",
                 "preempt": "dispatch", "kill": "dispatch",
                 "corrupt": "checkpoint_write",
                 "truncate": "checkpoint_write"}
#: kinds that are NOT raised/slept at a fire() hook point: ``nan`` corrupts
#: step outputs (corrupt_step), ``corrupt``/``truncate`` damage the files a
#: checkpoint save just wrote (mutate_checkpoint)
_DATA_KINDS = ("nan", "corrupt", "truncate")


class FaultSpecError(ValueError):
    """A PADDLE_TPU_FAULTS spec string failed to parse."""


class TransientFault(RuntimeError):
    """The injected transient error: shaped like the retryable runtime
    failures (its message carries the UNAVAILABLE marker) so
    ``recovery.is_transient`` and generic marker-matching both classify it
    correctly."""

    def __init__(self, msg: str, site: str = "dispatch",
                 step: Optional[int] = None):
        super().__init__(msg)
        self.site = site
        self.step = step


@dataclasses.dataclass
class Fault:
    """One armed fault. ``times`` is the total fire budget (0 = unlimited);
    a consumed fault never fires again even if its step is replayed after a
    rollback -- that is what makes rollback-past-a-fault terminate."""

    kind: str
    site: str
    step: Optional[int] = None
    var: Optional[str] = None
    times: int = 1
    seconds: float = 30.0
    prob: float = 1.0
    seed: Optional[int] = None
    value: float = float("nan")
    fired: int = dataclasses.field(default=0, compare=False)
    missed: int = dataclasses.field(default=0, compare=False)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise FaultSpecError(
                f"unknown fault kind {self.kind!r}; use one of {KINDS}")
        if self.site not in SITES:
            raise FaultSpecError(
                f"unknown fault site {self.site!r}; use one of {SITES}")
        if not (0.0 < self.prob <= 1.0):
            raise FaultSpecError(f"prob must be in (0, 1], got {self.prob}")
        if self.site in STREAM_SITES and self.kind in ("nan", "truncate"):
            # no stream hook consumes these kinds: arming one would report
            # a clean chaos run in which nothing was ever injected
            raise FaultSpecError(
                f"kind {self.kind!r} has no hook at stream site "
                f"{self.site!r}; use exc/hang/corrupt (or kill/preempt)")
        # per-fault seeded stream: two prob-faults never share draws, and a
        # given (seed, match sequence) always fires at the same steps
        self._rng = random.Random(self.seed)

    def spent(self) -> bool:
        return bool(self.times) and self.fired >= self.times

    def matches(self, site: str, step: Optional[int],
                tags: Optional[Sequence[str]] = None) -> bool:
        if self.spent():
            return False
        if self.kind != "nan" and self.site != site:
            return False
        if self.step is not None and step != self.step:
            return False
        if (tags is not None and self.var is not None
                and self.var not in tags):
            # serving sites pass the batch's tenants as tags: var narrows
            # the fault to batches carrying that tenant
            return False
        if self.prob < 1.0 and self._rng.random() >= self.prob:
            return False
        return True


_INT_KEYS = ("step", "times", "seed")
_FLOAT_KEYS = ("seconds", "prob")


def _parse_value(v: str) -> float:
    low = v.strip().lower()
    if low in ("nan", "inf", "-inf"):
        return float(low)
    try:
        return float(low)
    except ValueError:
        raise FaultSpecError(f"value={v!r} is not nan/inf/-inf or a float")


def parse_spec(text: str) -> List[Fault]:
    """``"nan:step=3:var=loss;exc@dispatch:step=5"`` -> [Fault, Fault]."""
    out: List[Fault] = []
    for raw in str(text).split(";"):
        entry = raw.strip()
        if not entry:
            continue
        head, _, rest = entry.partition(":")
        head = head.strip()
        kind, _, site = head.partition("@")
        kind = kind.strip().lower()
        if kind not in KINDS:
            raise FaultSpecError(
                f"fault entry {entry!r}: unknown kind {kind!r} "
                f"(use one of {KINDS})")
        site = site.strip().lower() or _DEFAULT_SITE[kind]
        kw: Dict[str, object] = {}
        if rest:
            for pair in rest.split(":"):
                pair = pair.strip()
                if not pair:
                    continue
                k, eq, v = pair.partition("=")
                k, v = k.strip().lower(), v.strip()
                if not eq:
                    raise FaultSpecError(
                        f"fault entry {entry!r}: expected key=value, "
                        f"got {pair!r}")
                if k in _INT_KEYS:
                    try:
                        kw[k] = int(v)
                    except ValueError:
                        raise FaultSpecError(
                            f"fault entry {entry!r}: {k}={v!r} is not an int")
                elif k in _FLOAT_KEYS:
                    try:
                        kw[k] = float(v)
                    except ValueError:
                        raise FaultSpecError(
                            f"fault entry {entry!r}: {k}={v!r} is not a "
                            f"float")
                elif k == "var":
                    kw[k] = v
                elif k == "value":
                    kw[k] = _parse_value(v)
                else:
                    raise FaultSpecError(
                        f"fault entry {entry!r}: unknown key {k!r} (use "
                        f"step/var/times/seconds/prob/seed/value)")
        out.append(Fault(kind=kind, site=site, **kw))
    return out


# -- registry ---------------------------------------------------------------

#: armed faults; the executor/checkpointer hooks guard on plain truthiness
#: of this list, so the disarmed hot path is one attribute read
_active: List[Fault] = []


def armed() -> bool:
    return bool(_active)


def active() -> List[Fault]:
    return list(_active)


def may_raise(site: str, step: Optional[int]) -> bool:
    """Whether an armed ``exc`` fault could fire at ``site`` for ``step``.
    Takes no draw from a ``prob`` fault's stream (one that may fire
    counts), so asking leaves the faults that do fire unchanged."""
    return any(f.kind == "exc" and f.site == site and not f.spent()
               and (f.step is None or f.step == step) for f in _active)


def install(spec: Union[str, Fault, Sequence[Fault]]) -> List[Fault]:
    """Arm faults from a spec string, a Fault, or a list of Faults
    (appends to whatever is already armed; ``clear()`` resets)."""
    if isinstance(spec, str):
        fs = parse_spec(spec)
    elif isinstance(spec, Fault):
        fs = [spec]
    else:
        fs = list(spec)
        for f in fs:
            if not isinstance(f, Fault):
                raise FaultSpecError(f"not a Fault: {f!r}")
    _active.extend(fs)
    return list(_active)


def install_from_env() -> List[Fault]:
    """(Re-)arm from ``PADDLE_TPU_FAULTS`` (no-op when unset/empty)."""
    raw = os.environ.get(ENV_VAR, "").strip()
    if raw:
        install(raw)
    return list(_active)


def clear():
    del _active[:]


def _record(f: Fault, site: str, step, program=None, var=None):
    f.fired += 1
    _OBS.counter("fault_injected_total", "injected faults by kind and site",
                 kind=f.kind, site=site).inc()
    _journal.emit({"event": "fault", "kind": f.kind, "site": site,
                   "step": step, "var": var, "program": program})


def fire(site: str, step: Optional[int] = None, program=None,
         tags: Optional[Sequence[str]] = None):
    """Hook point: fire any armed exc/hang/preempt/kill fault matching
    ``site``/``step``. Called by ``Executor.run``, ``Checkpointer.save`` and
    the stream readers only when ``_active`` is non-empty. Data kinds
    (nan/corrupt/truncate) have their own hooks (``corrupt_step``,
    ``corrupt_record``, ``mutate_checkpoint``). ``tags`` narrows a fault
    whose ``var`` is set (a stream source's name)."""
    for f in _active:
        if f.kind in _DATA_KINDS or not f.matches(site, step, tags):
            continue
        _record(f, site, step, program=program)
        if f.kind == "preempt":
            from . import recovery
            recovery.request_preemption(
                f"injected preempt fault (step {step})")
        elif f.kind == "hang":
            time.sleep(f.seconds)
        elif f.kind == "kill":
            # hard rank death: no emergency save, no atexit, no flushed
            # buffers; value=<int> exits with that code instead
            import signal as _signal
            if math.isnan(f.value):
                os.kill(os.getpid(), _signal.SIGKILL)
            os._exit(int(f.value))
        else:  # exc
            raise TransientFault(
                f"UNAVAILABLE: injected transient fault at {site} "
                f"(step {step})", site=site, step=step)


def corrupt_step(step, fetch_names: Sequence[str], fetches, state: dict,
                 program=None) -> list:
    """Hook point: apply armed ``nan`` faults to this step's outputs.

    A fault whose ``var`` names a fetch replaces the fetched tensor by one
    full of its value; one naming a written state var fills the scope's
    tensor in place (the health watchdog and the guardian's verdict both see
    it). ``var`` unset targets the first float fetch. Non-float targets are
    left alone. Returns the fetches."""
    if not _active:
        return list(fetches)
    import torch

    def _is_float(v):
        return isinstance(v, torch.Tensor) and v.dtype.is_floating_point

    fetches = list(fetches)
    for f in _active:
        if f.kind != "nan" or f.site in SERVING_SITES \
                or not f.matches("fetch", step):
            continue
        target = f.var
        if target is None:
            target = next((n for n, v in zip(fetch_names, fetches)
                           if _is_float(v)), None)
        hit = False
        if target is not None:
            for i, n in enumerate(fetch_names):
                if n == target and i < len(fetches) and _is_float(fetches[i]):
                    fetches[i] = torch.full_like(fetches[i], f.value)
                    hit = True
            if target in state and _is_float(state[target]):
                with torch.no_grad():
                    state[target].fill_(f.value)
                hit = True
        if hit:
            _record(f, "fetch", step, program=program, var=target)
        else:
            # a typo'd var would otherwise pass a chaos run that tested
            # nothing: journal the miss once; the fault stays armed
            f.missed += 1
            if f.missed == 1:
                _journal.emit({
                    "event": "fault_miss", "kind": f.kind, "step": step,
                    "var": f.var, "program": program,
                    "detail": "var matched no fetch or written float "
                              "state var; fault not consumed"})
    return fetches


def _not_ported(hook: str, what: str):
    raise NotImplementedError(
        f"faults.{hook}: {what} is not ported yet; nothing in the port fires "
        f"this hook")


def corrupt_serving(outputs, step: Optional[int] = None,
                    tags: Optional[Sequence[str]] = None) -> list:
    """Hook point: apply armed ``nan@serve_fetch`` faults to a serving
    batch's outputs (called by the ``PredictorPool`` worker between the
    predictor's run and the de-slice, only when faults are armed). ``var``
    narrows the fault to batches carrying that tenant (via ``tags``); each
    float output is replaced by one full of the fault's value, so a
    health-checking pool fails the batch typed and the breaker sees the
    poison."""
    if not _active:
        return list(outputs)
    import numpy as np
    outs = list(outputs)
    for f in _active:
        if f.kind != "nan" or f.site != "serve_fetch" \
                or not f.matches("serve_fetch", step, tags):
            continue
        hit = False
        for i, o in enumerate(outs):
            arr = np.asarray(o)
            if np.issubdtype(arr.dtype, np.floating):
                outs[i] = np.full(arr.shape, f.value, dtype=arr.dtype)
                hit = True
        if hit:
            _record(f, "serve_fetch", step, var=f.var)
        else:
            f.missed += 1
            if f.missed == 1:
                _journal.emit({
                    "event": "fault_miss", "kind": f.kind, "step": step,
                    "var": f.var,
                    "detail": "no float serving output to corrupt; "
                              "fault not consumed"})
    return outs


def corrupt_record(text: str, site: str = "read",
                   step: Optional[int] = None,
                   tags: Optional[Sequence[str]] = None) -> str:
    """Hook point: apply armed ``corrupt@read``/``corrupt@parse`` faults to
    one stream record's text (called by the streaming source reader /
    line parser only when faults are armed).  The garbled line fails slot
    parsing, so it exercises the poison-record quarantine path end to
    end; ``var`` narrows the fault to one source (via ``tags``), ``step``
    to a record index.  Deterministic: the mangled text depends only on
    the input."""
    if not _active:
        return text
    for f in _active:
        if f.kind != "corrupt" or f.site not in STREAM_SITES \
                or not f.matches(site, step, tags):
            continue
        _record(f, site, step, var=f.var)
        # un-parseable under any slot count, and visibly marked in the
        # dead-letter file: drop every separator and append a tag
        text = ("\x7fCORRUPT\x7f " +
                text.replace(";", " ").strip() + " ;;;")
    return text


def corrupt_delta(delta: dict, step: Optional[int] = None,
                  tags: Optional[Sequence[str]] = None) -> dict:
    """The online publisher's ``corrupt@online_export`` hook: raises
    (``online/`` moves behind ROADMAP item 10's ``PredictorPool``)."""
    _not_ported("corrupt_delta", "online training (online/, behind ROADMAP item 10)")


def mutate_checkpoint(dirname, step: Optional[int] = None) -> List[dict]:
    """Hook point: apply armed ``corrupt``/``truncate`` faults to the
    checkpoint files a save just wrote under ``dirname`` (the chaos half
    of the durable-checkpoint contract: the restore path must *detect*
    the damage, quarantine the step, and fall through).

    ``corrupt`` flips one bit of a seeded-random chunk file (size
    unchanged -- only the crc32 restore check can catch it); ``truncate``
    cuts a seeded-random chunk to half its bytes (the completeness scan's
    size check catches it).  ``var`` narrows the victim to chunks of that
    var.  Target selection draws from the fault's own seeded rng, so a
    given (seed, match sequence) always damages the same file at the same
    offset.  Returns the applied mutations (chaos CLI reporting)."""
    if not _active:
        return []
    from ..utils import fs as _fsio
    applied = []
    for f in _active:
        if f.kind not in ("corrupt", "truncate") or \
                not f.matches("checkpoint_write", step):
            continue
        try:
            names = sorted(n for n in _fsio.listdir(dirname)
                           if n.endswith(".npy"))
        except OSError:
            names = []
        if f.var is not None:
            base = f.var.replace("/", "__")
            names = [n for n in names if n.startswith(base + ".")
                     or n == base + ".npy"]
        if not names:
            f.missed += 1
            if f.missed == 1:
                _journal.emit({"event": "fault_miss", "kind": f.kind,
                               "step": step, "var": f.var,
                               "detail": f"no chunk file to {f.kind} in "
                                         f"{dirname}"})
            continue
        victim = _fsio.join(dirname, names[f._rng.randrange(len(names))])
        data = _fsio.read_bytes(victim)
        if not data:
            continue
        if f.kind == "corrupt":
            pos = f._rng.randrange(len(data))
            mutated = (data[:pos] + bytes([data[pos] ^ 0x01]) +
                       data[pos + 1:])
            detail = f"bit-flip at byte {pos}"
        else:
            mutated = data[:max(1, len(data) // 2)]
            detail = f"truncated {len(data)} -> {len(mutated)} bytes"
        _fsio.write_bytes(victim, mutated)
        _record(f, "checkpoint_write", step, var=f.var)
        applied.append({"kind": f.kind, "file": str(victim),
                        "detail": detail})
        _journal.emit({"event": "ckpt_fault", "kind": f.kind,
                       "file": str(victim), "step": step,
                       "detail": detail})
    return applied


def mutate_warmstore(entry_dir) -> List[dict]:
    """Hook point: apply armed ``corrupt``/``truncate`` faults to a
    warm-store entry the writer thread just committed under ``entry_dir``
    (a step's record or a kernel library): the read side must catch the
    damage by crc32 and size, quarantine the entry ``.corrupt`` and run the
    step fresh (a library then built by ``nvcc``). Same damage grammar as
    ``mutate_checkpoint``: one seeded bit flip or a cut to half the bytes.
    meta.json is never the victim: the payloads are what the checks guard."""
    if not _active:
        return []
    from ..utils import fs as _fsio
    applied = []
    for f in _active:
        if f.kind not in ("corrupt", "truncate") or not f.matches("warmstore_write", None):
            continue
        try:
            names = sorted(n for n in _fsio.listdir(entry_dir) if n.startswith("tier_"))
        except OSError:
            names = []
        if not names:
            f.missed += 1
            if f.missed == 1:
                _journal.emit({"event": "fault_miss", "kind": f.kind, "var": f.var,
                               "detail": f"no payload to {f.kind} in {entry_dir}"})
            continue
        victim = _fsio.join(entry_dir, names[f._rng.randrange(len(names))])
        data = _fsio.read_bytes(victim)
        if not data:
            continue
        if f.kind == "corrupt":
            pos = f._rng.randrange(len(data))
            mutated = data[:pos] + bytes([data[pos] ^ 0x01]) + data[pos + 1:]
            detail = f"bit-flip at byte {pos}"
        else:
            mutated = data[:max(1, len(data) // 2)]
            detail = f"truncated {len(data)} -> {len(mutated)} bytes"
        _fsio.write_bytes(victim, mutated)
        _record(f, "warmstore_write", None, var=f.var)
        applied.append({"kind": f.kind, "file": str(victim), "detail": detail})
        _journal.emit({"event": "warmstore_fault", "kind": f.kind, "file": str(victim),
                       "detail": detail})
    return applied


def describe() -> List[dict]:
    """Armed faults as JSON-able dicts (for reports)."""
    out = []
    for f in _active:
        d = dataclasses.asdict(f)
        if isinstance(d.get("value"), float) and math.isnan(d["value"]):
            d["value"] = "nan"
        out.append(d)
    return out


# env arming happens once, at import: a subprocess that sets
# PADDLE_TPU_FAULTS gets armed faults with no per-step env read
install_from_env()
