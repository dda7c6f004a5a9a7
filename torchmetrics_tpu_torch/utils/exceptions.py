"""Framework exceptions.

Counterpart of ``torchmetrics_tpu/utils/exceptions.py``.
"""


class TorchMetricsUserError(Exception):
    """Error raised on wrong usage of the metric API (lifecycle violations, bad kwargs)."""


class TorchMetricsUserWarning(UserWarning):
    """Warning raised on suspicious-but-legal usage of the metric API."""
