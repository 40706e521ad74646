"""Multi-process launcher (the port's copy of
``paddle_tpu/parallel/launch.py``; reference python/paddle/distributed/
launch.py:147).

Spawns one training process a rank with the environment ``parallel/env.py``
reads (``COORDINATOR_ADDRESS`` / ``NUM_PROCESSES`` / ``PROCESS_ID``, the
``PADDLE_TRAINER_*`` names, ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``), watches
them, and when one dies kills the others (which would wait in their next
collective until the group's timeout) and prints the dead rank's log tail::

    python -m paddle_tpu_torch.parallel.launch --nproc 2 train.py --lr 0.1

The script calls ``parallel.init_parallel_env()``; on one host rank ``r``
takes ``cuda:r`` (``env.choose_backend`` for the backend rule).

``max_restarts`` relaunches the whole job after a failed attempt, with
backoff, and scripts resume from their ``Checkpointer``; an attempt whose
only non-zero exits are ``PREEMPTED_EXIT`` (a rank left through the
resumable preemption path) relaunches without using the budget. The elastic
mode (a relaunch at another world size, its controller) is ROADMAP item
13 (c): ``elastic=True`` or a ``controller`` raises.
"""
from __future__ import annotations

import argparse
import os
import random
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional, Set, Tuple

#: a rank's exit code for a clean, resumable preemption (the JAX package's
#: ``resilience.PREEMPTED_EXIT``)
PREEMPTED_EXIT = 75

ITEM_13C = ("ROADMAP item 13 (c): the elastic launcher (a relaunch at another "
            "world size and its controller)")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(nproc: int, script_argv, coordinator: Optional[str] = None,
           log_dir: Optional[str] = None, poll_interval: float = 0.2,
           max_restarts: int = 0, restart_backoff: float = 1.0,
           restart_backoff_max: float = 30.0, elastic: bool = False,
           healthy_reset_secs: float = 600.0, controller=None,
           max_preempt_restarts: int = 1000, timeout: Optional[float] = None,
           env: Optional[dict] = None) -> List[Optional[int]]:
    """Spawn ``nproc`` copies of ``script_argv`` (a script and its
    arguments, run with this interpreter); returns their exit codes.

    A rank that dies with a non-zero code gets the others terminated and
    its log tail printed. ``timeout`` (seconds, None = none) bounds an
    attempt: past it every rank is terminated and the codes come back.
    ``env`` adds to each rank's environment. ``max_restarts`` /
    ``restart_backoff`` / ``healthy_reset_secs`` / ``max_preempt_restarts``
    as in the JAX package (module docstring); ``elastic`` / ``controller``
    raise (item 13 (c)). The JAX package's ``devices_per_proc`` and
    ``min_ranks`` are not taken: a rank of the port drives one device, and
    the floor belongs to the elastic mode."""
    if elastic or controller is not None:
        raise NotImplementedError(ITEM_13C)
    if max_restarts < 0:
        raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
    from ..resilience.recovery import backoff_delay
    budget_used = clean_used = backoff_attempt = attempt = 0
    while True:
        t_attempt = time.perf_counter()
        codes, terminated = _launch_once(nproc, script_argv, coordinator, log_dir,
                                         poll_interval, attempt, timeout, env)
        runtime = time.perf_counter() - t_attempt
        if all(c == 0 for c in codes):
            return codes
        bad = [r for r, c in enumerate(codes) if c != 0]
        culprits = [r for r in bad if codes[r] != PREEMPTED_EXIT and r not in terminated]
        clean = not culprits and any(codes[r] == PREEMPTED_EXIT for r in bad)
        if not clean:
            budget_used += 1
            if budget_used > max_restarts:
                return codes
        else:
            clean_used += 1
            if max_restarts <= 0 or clean_used > max_preempt_restarts:
                return codes
        if clean or runtime >= healthy_reset_secs:
            backoff_attempt = 0
        backoff_attempt += 1
        delay = backoff_delay(backoff_attempt, restart_backoff, restart_backoff_max, random)
        from ..observability import journal as _journal
        from ..observability.metrics import REGISTRY as _OBS
        _OBS.counter("elastic_restarts_total",
                     "whole-job restarts by the launcher").inc()
        culprit = culprits[0] if culprits else (bad[0] if bad else None)
        _journal.emit({"event": "elastic_restart", "attempt": attempt + 1,
                       "max_restarts": max_restarts, "budget_used": budget_used,
                       "clean": clean, "failed_rank": culprit,
                       "exit_codes": list(codes), "backoff_s": round(delay, 3)})
        sys.stderr.write(
            f"[paddle_tpu_torch.launch] attempt {attempt} "
            f"{'preempted (clean)' if clean else 'failed'} (rank "
            f"{culprit if culprit is not None else '?'}); restarting the job from the "
            f"latest checkpoint in {delay:.1f}s ({budget_used}/{max_restarts} restarts "
            f"used)\n")
        time.sleep(delay)
        attempt += 1


def _launch_once(nproc, script_argv, coordinator, log_dir, poll_interval, attempt,
                 timeout, extra_env) -> Tuple[List[Optional[int]], Set[int]]:
    """One attempt: ``(codes, ranks the monitor terminated)``."""
    if coordinator:
        host = coordinator.rsplit(":", 1)[0]
        eps = [coordinator] + [f"{host}:{_free_port()}" for _ in range(nproc - 1)]
    else:
        eps = [f"127.0.0.1:{_free_port()}" for _ in range(nproc)]
    log_dir = log_dir or os.path.join(os.getcwd(), "launch_logs")
    os.makedirs(log_dir, exist_ok=True)
    procs, logs = [], []
    for rank in range(nproc):
        env = dict(os.environ)
        env.update(extra_env or {})
        env.update({
            "COORDINATOR_ADDRESS": eps[0],
            "NUM_PROCESSES": str(nproc),
            "PROCESS_ID": str(rank),
            "LOCAL_RANK": str(rank),
            "LOCAL_WORLD_SIZE": str(nproc),
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(nproc),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(eps),
            "PADDLE_CURRENT_ENDPOINT": eps[rank],
            "PADDLE_RESTART_ATTEMPT": str(attempt),
        })
        log_path = os.path.join(log_dir, f"rank{rank}.log" if attempt == 0
                                else f"rank{rank}.attempt{attempt}.log")
        logs.append(log_path)
        with open(log_path, "wb") as lf:
            procs.append(subprocess.Popen([sys.executable] + list(script_argv), env=env,
                                          stdout=lf, stderr=lf))
    deadline = None if timeout is None else time.time() + float(timeout)
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            expired = deadline is not None and time.time() > deadline
            if bad or expired:
                running = {r for r, c in enumerate(codes) if c is None}
                for r in running:
                    procs[r].terminate()
                _reap(procs)
                # a rank still running at the poll that then exited by itself
                # with a failure stays blamable
                terminated = {r for r in running
                              if procs[r].returncode in (0, -signal.SIGTERM,
                                                         -signal.SIGKILL)}
                r = bad[0] if bad else min(running)
                what = (f"died with exit code {codes[r]}" if bad else
                        f"was still running at the {timeout}s limit")
                sys.stderr.write(
                    f"\n[paddle_tpu_torch.launch] rank {r} {what}; terminated "
                    f"{len(terminated)} rank(s). Log tail ({logs[r]}):\n"
                    f"{_tail(logs[r])}\n")
                return [p.returncode for p in procs], terminated
            if all(c is not None for c in codes):
                return list(codes), set()
            time.sleep(poll_interval)
    except BaseException:
        for p in procs:
            if p.poll() is None:
                p.kill()
        _reap(procs)
        raise


def _reap(procs) -> None:
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, "rb") as f:
            return f.read()[-n:].decode(errors="replace")
    except OSError:
        return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("paddle_tpu_torch.parallel.launch")
    ap.add_argument("--nproc", type=int, default=1)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--log_dir", default=None)
    ap.add_argument("--max_restarts", type=int, default=0,
                    help="restart the whole job up to N times on failure (resume from "
                         "your Checkpointer); ranks exiting with PREEMPTED_EXIT (75) "
                         "restart without using this budget")
    ap.add_argument("--restart_backoff", type=float, default=1.0,
                    help="base seconds between restarts; doubles per attempt with "
                         "jitter, capped at 30 s")
    ap.add_argument("--healthy_reset_secs", type=float, default=600.0)
    ap.add_argument("--timeout", type=float, default=None,
                    help="kill every rank of an attempt after this many seconds")
    ap.add_argument("--elastic", action="store_true",
                    help="world-size-changing restarts: not ported (ROADMAP item 13 (c))")
    ap.add_argument("script", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if not args.script:
        ap.error("no training script given")
    codes = launch(args.nproc, args.script, args.coordinator, log_dir=args.log_dir,
                   max_restarts=args.max_restarts, restart_backoff=args.restart_backoff,
                   elastic=args.elastic, healthy_reset_secs=args.healthy_reset_secs,
                   timeout=args.timeout)
    return 0 if all(c == 0 for c in codes) else 1


if __name__ == "__main__":
    sys.exit(main())
