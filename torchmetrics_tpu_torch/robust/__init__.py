"""Fault-tolerance layer of the port: update guards and fault injection.

Counterpart of ``torchmetrics_tpu/robust``, as far as the engine slice needs it:

- :mod:`~torchmetrics_tpu_torch.robust.policy` — per-metric / global **error
  policies** (``raise`` | ``warn_skip`` | ``quarantine``) applied in the ``Metric``
  update path. The default (no policy configured) screens nothing and lets
  exceptions propagate.
- :mod:`~torchmetrics_tpu_torch.robust.faults` — deterministic fault-injection
  context managers (NaN bursts; collective and download plans).

The retrying fetcher (``retry``), the guard around eager collectives
(``degraded``) and session fencing (``fence``) come with the robust plane and the
migrate slice.
"""

from torchmetrics_tpu_torch.robust.policy import (
    ErrorPolicy,
    UpdateGuardError,
    error_policy,
    get_error_policy,
    set_error_policy,
)

__all__ = [
    "ErrorPolicy",
    "UpdateGuardError",
    "error_policy",
    "get_error_policy",
    "set_error_policy",
]
