"""Nominal metrics (stateful modules).

Counterpart of ``torchmetrics_tpu/nominal/__init__.py`` (5 classes).
"""

from torchmetrics_tpu_torch.nominal.modules import (
    CramersV,
    FleissKappa,
    PearsonsContingencyCoefficient,
    TheilsU,
    TschuprowsT,
)

__all__ = [
    "CramersV",
    "FleissKappa",
    "PearsonsContingencyCoefficient",
    "TheilsU",
    "TschuprowsT",
]
