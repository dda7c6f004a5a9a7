"""Enums shared across domains.

Counterpart of ``torchmetrics_tpu/utils/enums.py`` (the port keeps its own copy).
"""

from __future__ import annotations

from enum import Enum


class EnumStr(str, Enum):
    """Case-insensitive string enum with a friendly ``from_str`` constructor."""

    @staticmethod
    def _name() -> str:
        return "Task"

    @classmethod
    def from_str(cls, value: str, source: str = "Key") -> "EnumStr":
        try:
            return cls(value.lower().replace("-", "_"))
        except ValueError as err:
            valid = [m.value for m in cls]
            raise ValueError(
                f"Invalid {cls._name()}: expected one of {valid}, but got {value}."
            ) from err

    def __str__(self) -> str:
        return self.value


class ClassificationTask(EnumStr):
    """Task selector for the task-dispatch wrapper classes."""

    @staticmethod
    def _name() -> str:
        return "Classification"

    BINARY = "binary"
    MULTICLASS = "multiclass"
    MULTILABEL = "multilabel"


class ClassificationTaskNoBinary(EnumStr):
    """Task selector for metrics defined for multiclass and multilabel tasks only."""

    @staticmethod
    def _name() -> str:
        return "Classification"

    MULTICLASS = "multiclass"
    MULTILABEL = "multilabel"


class ClassificationTaskNoMultilabel(EnumStr):
    """Task selector for metrics defined for binary and multiclass tasks only."""

    @staticmethod
    def _name() -> str:
        return "Classification"

    BINARY = "binary"
    MULTICLASS = "multiclass"
