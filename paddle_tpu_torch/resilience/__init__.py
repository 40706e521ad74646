"""paddle_tpu_torch.resilience: fault injection and step-level recovery (the
port's copy of ``paddle_tpu/resilience/``, without ``elastic``: world-size
changes are ROADMAP item 13 (c)).

- :mod:`faults` -- deterministic, seedable fault injection
  (``PADDLE_TPU_FAULTS`` / :func:`install`): NaN/Inf into a named tensor at
  step N, transient errors at compile / dispatch / fetch /
  checkpoint_write / read / parse, hangs, simulated preemption.
- :mod:`recovery` -- :class:`StepGuardian` around ``Executor.run`` with the
  nonfinite-step policy ``skip|rollback|raise``, bounded backoff-with-jitter
  retry, a hung-step deadline (:class:`StepTimeout`) and preemption-safe
  emergency checkpointing (:class:`Preempted`).

Off by default: with ``PADDLE_TPU_FAULTS`` unset and a default guardian
there is no per-step file I/O, no signal handler, no watchdog thread and no
snapshot copy.
"""
from . import faults  # noqa: F401
from . import recovery  # noqa: F401
from .faults import (Fault, FaultSpecError, TransientFault, active,  # noqa: F401
                     armed, clear, install, install_from_env, parse_spec)
from .recovery import (Preempted, StepGuardian, StepTimeout,  # noqa: F401
                       clear_preemption, install_signal_handlers, is_transient,
                       preemption_requested, request_preemption, transient_site,
                       uninstall_signal_handlers)
