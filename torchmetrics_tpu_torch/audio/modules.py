"""Audio metric modules.

Counterpart of ``torchmetrics_tpu/audio/modules.py``: every class averages a
per-sample score, with JAX's states (``sum_score`` float32 and ``total`` int32, both
summed across processes) and compute-group parameters. DNSMOS runs converted ONNX
graphs on the port's executor (``functional/audio/dnsmos.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.functional.audio.dnsmos import deep_noise_suppression_mean_opinion_score
from torchmetrics_tpu_torch.functional.audio.external import perceptual_evaluation_speech_quality
from torchmetrics_tpu_torch.functional.audio.pit import permutation_invariant_training
from torchmetrics_tpu_torch.functional.audio.sdr import (
    scale_invariant_signal_distortion_ratio,
    signal_distortion_ratio,
    source_aggregated_signal_distortion_ratio,
)
from torchmetrics_tpu_torch.functional.audio.snr import (
    complex_scale_invariant_signal_noise_ratio,
    scale_invariant_signal_noise_ratio,
    signal_noise_ratio,
)
from torchmetrics_tpu_torch.functional.audio.srmr import (
    _srmr_arg_validate,
    speech_reverberation_modulation_energy_ratio,
)
from torchmetrics_tpu_torch.functional.audio.stoi import short_time_objective_intelligibility

Tensor = torch.Tensor

# the keyword arguments of ``Metric`` that PermutationInvariantTraining keeps from its
# metric function's keyword arguments
_METRIC_KWARGS = (
    "device", "compute_on_cpu", "dist_sync_on_step", "process_group", "dist_sync_fn", "distributed_available_fn",
    "sync_on_compute", "compute_with_cache", "jit_update", "error_policy",
)


class _MeanScoreMetric(Metric):
    """Base for audio metrics that average a per-sample score."""

    full_state_update = False

    sum_score: Tensor
    total: Tensor

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("sum_score", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def _accumulate(self, scores: Tensor) -> None:
        self.sum_score = self.sum_score + scores.sum()
        self.total = self.total + scores.numel()

    def compute(self) -> Tensor:
        """Mean score over all samples."""
        return self.sum_score / self.total


class SignalNoiseRatio(_MeanScoreMetric):
    r"""Signal-to-noise ratio.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.audio import SignalNoiseRatio
        >>> snr = SignalNoiseRatio(device="cpu")
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> snr(preds, target).round(decimals=4)
        tensor(16.1805)
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate per-sample SNR."""
        self._accumulate(signal_noise_ratio(preds=preds, target=target, zero_mean=self.zero_mean))

    def _compute_group_params(self):
        return (self.zero_mean,)


class ScaleInvariantSignalNoiseRatio(_MeanScoreMetric):
    r"""Scale-invariant signal-to-noise ratio.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.audio import ScaleInvariantSignalNoiseRatio
        >>> si_snr = ScaleInvariantSignalNoiseRatio(device="cpu")
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> si_snr(preds, target).round(decimals=4)
        tensor(15.0918)
    """

    is_differentiable = True
    higher_is_better = True

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate per-sample SI-SNR."""
        self._accumulate(scale_invariant_signal_noise_ratio(preds=preds, target=target))


class ComplexScaleInvariantSignalNoiseRatio(_MeanScoreMetric):
    r"""Complex scale-invariant signal-to-noise ratio.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.audio import ComplexScaleInvariantSignalNoiseRatio
        >>> g = torch.Generator().manual_seed(42)
        >>> preds, target = torch.randn(1, 257, 100, 2, generator=g), torch.randn(1, 257, 100, 2, generator=g)
        >>> c_si_snr = ComplexScaleInvariantSignalNoiseRatio(device="cpu")
        >>> float(c_si_snr(preds, target)) < 0
        True
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(zero_mean, bool):
            raise ValueError(f"Expected argument `zero_mean` to be a bool, but got {zero_mean}")
        self.zero_mean = zero_mean

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate per-sample C-SI-SNR."""
        self._accumulate(
            complex_scale_invariant_signal_noise_ratio(preds=preds, target=target, zero_mean=self.zero_mean)
        )

    def _compute_group_params(self):
        return (self.zero_mean,)


class SignalDistortionRatio(_MeanScoreMetric):
    r"""Signal-to-distortion ratio (BSS-eval).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.audio import SignalDistortionRatio
        >>> g = torch.Generator().manual_seed(1)
        >>> preds, target = torch.randn(8000, generator=g), torch.randn(8000, generator=g)
        >>> sdr = SignalDistortionRatio(device="cpu")
        >>> float(sdr(preds, target)) < 0
        True
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(
        self,
        use_cg_iter: Optional[int] = None,
        filter_length: int = 512,
        zero_mean: bool = False,
        load_diag: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.use_cg_iter = use_cg_iter
        self.filter_length = filter_length
        self.zero_mean = zero_mean
        self.load_diag = load_diag

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate per-sample SDR."""
        self._accumulate(
            signal_distortion_ratio(preds, target, self.use_cg_iter, self.filter_length, self.zero_mean, self.load_diag)
        )

    def _compute_group_params(self):
        return (self.use_cg_iter, self.filter_length, self.zero_mean, self.load_diag)


class ScaleInvariantSignalDistortionRatio(_MeanScoreMetric):
    r"""Scale-invariant signal-to-distortion ratio.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.audio import ScaleInvariantSignalDistortionRatio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> si_sdr = ScaleInvariantSignalDistortionRatio(device="cpu")
        >>> si_sdr(preds, target).round(decimals=4)
        tensor(18.4030)
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(self, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.zero_mean = zero_mean

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate per-sample SI-SDR."""
        self._accumulate(scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=self.zero_mean))

    def _compute_group_params(self):
        return (self.zero_mean,)


class SourceAggregatedSignalDistortionRatio(_MeanScoreMetric):
    r"""Source-aggregated signal-to-distortion ratio.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.audio import SourceAggregatedSignalDistortionRatio
        >>> g = torch.Generator().manual_seed(42)
        >>> preds, target = torch.randn(4, 2, 8000, generator=g), torch.randn(4, 2, 8000, generator=g)
        >>> sa_sdr = SourceAggregatedSignalDistortionRatio(device="cpu")
        >>> float(sa_sdr(preds, target)) < 0
        True
    """

    is_differentiable = True
    higher_is_better = True

    def __init__(self, scale_invariant: bool = True, zero_mean: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if not isinstance(scale_invariant, bool):
            raise ValueError(f"Expected argument `scale_invariant` to be a bool, but got {scale_invariant}")
        if not isinstance(zero_mean, bool):
            raise ValueError(f"Expected argument `zero_mean` to be a bool, but got {zero_mean}")
        self.scale_invariant = scale_invariant
        self.zero_mean = zero_mean

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate per-sample SA-SDR."""
        self._accumulate(source_aggregated_signal_distortion_ratio(preds, target, self.scale_invariant, self.zero_mean))

    def _compute_group_params(self):
        return (self.scale_invariant, self.zero_mean)


class PermutationInvariantTraining(_MeanScoreMetric):
    r"""Permutation-invariant training metric wrapper.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.audio import PermutationInvariantTraining
        >>> from torchmetrics_tpu_torch.functional.audio import scale_invariant_signal_distortion_ratio
        >>> g = torch.Generator().manual_seed(42)
        >>> preds, target = torch.randn(4, 2, 100, generator=g), torch.randn(4, 2, 100, generator=g)
        >>> pit = PermutationInvariantTraining(scale_invariant_signal_distortion_ratio, device="cpu")
        >>> float(pit(preds, target)) < 0
        True
    """

    is_differentiable = True
    higher_is_better = None  # as the reference: it depends on the wrapped metric

    def __init__(
        self,
        metric_func: Callable,
        mode: str = "speaker-wise",
        eval_func: str = "max",
        **kwargs: Any,
    ) -> None:
        base_kwargs = {k: kwargs.pop(k) for k in list(kwargs) if k in _METRIC_KWARGS}
        super().__init__(**base_kwargs)
        if eval_func not in ("max", "min"):
            raise ValueError(f'eval_func can only be "max" or "min" but got {eval_func}')
        if mode not in ("speaker-wise", "permutation-wise"):
            raise ValueError(f'mode can only be "speaker-wise" or "permutation-wise" but got {mode}')
        self.metric_func = metric_func
        self.mode = mode
        self.eval_func = eval_func
        self.kwargs = kwargs

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate the per-sample best-permutation metric."""
        pit_metric = permutation_invariant_training(
            preds, target, self.metric_func, self.mode, self.eval_func, **self.kwargs
        )[0]
        self._accumulate(pit_metric)

    def _compute_group_params(self):
        return None


class PerceptualEvaluationSpeechQuality(_MeanScoreMetric):
    r"""PESQ (requires the external ``pesq`` library)."""

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound: float = -0.5
    plot_upper_bound: float = 4.5

    def __init__(self, fs: int, mode: str, n_processes: int = 1, **kwargs: Any) -> None:
        kwargs.setdefault("jit_update", False)  # the library scores on the host: no capture
        super().__init__(**kwargs)
        self.fs = fs
        self.mode = mode
        self.n_processes = n_processes

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate per-sample PESQ scores (on the host)."""
        self._accumulate(
            perceptual_evaluation_speech_quality(preds, target, self.fs, self.mode, n_processes=self.n_processes)
        )

    def _compute_group_params(self):
        return (self.fs, self.mode)


class ShortTimeObjectiveIntelligibility(_MeanScoreMetric):
    r"""STOI / ESTOI, computed natively on the metric's device (no pystoi).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.audio import ShortTimeObjectiveIntelligibility
        >>> speech = torch.randn(8000, generator=torch.Generator().manual_seed(0))
        >>> stoi = ShortTimeObjectiveIntelligibility(10000, device="cpu")
        >>> float(stoi(speech, speech)) > 0.999
        True
    """

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(self, fs: int, extended: bool = False, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.fs = fs
        self.extended = extended

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate per-sample STOI scores (no host round trip; capturable)."""
        self._accumulate(short_time_objective_intelligibility(preds, target, self.fs, self.extended))

    def _compute_group_params(self):
        return (self.fs, self.extended)


class SpeechReverberationModulationEnergyRatio(_MeanScoreMetric):
    r"""SRMR, computed natively on the metric's device: the full filterbank path and the
    ``fast=True`` gammatonegram path.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.audio import SpeechReverberationModulationEnergyRatio
        >>> preds = torch.randn(8000, generator=torch.Generator().manual_seed(0))
        >>> srmr = SpeechReverberationModulationEnergyRatio(8000, device="cpu")
        >>> bool(srmr(preds) > 0)
        True
    """

    is_differentiable = False
    higher_is_better = True

    def __init__(
        self,
        fs: int,
        n_cochlear_filters: int = 23,
        low_freq: float = 125,
        min_cf: float = 4,
        max_cf: Optional[float] = None,
        norm: bool = False,
        fast: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _srmr_arg_validate(fs, n_cochlear_filters, low_freq, min_cf, max_cf, norm, fast)
        self.fs = fs
        self.n_cochlear_filters = n_cochlear_filters
        self.low_freq = low_freq
        self.min_cf = min_cf
        self.max_cf = max_cf
        self.norm = norm
        self.fast = fast

    def update(self, preds: Tensor) -> None:
        """Accumulate per-sample SRMR scores."""
        self._accumulate(
            speech_reverberation_modulation_energy_ratio(
                preds, self.fs, self.n_cochlear_filters, self.low_freq,
                self.min_cf, self.max_cf, self.norm, self.fast,
            )
        )

    def _compute_group_params(self):
        return (self.fs, self.n_cochlear_filters, self.low_freq, self.min_cf, self.max_cf, self.norm, self.fast)


class DeepNoiseSuppressionMeanOpinionScore(_MeanScoreMetric):
    r"""DNSMOS from converted DNS-challenge ONNX checkpoints, run on the port's ONNX
    executor (drop the .onnx files under ``$TORCHMETRICS_TPU_DNSMOS_DIR`` or
    ``<repo>/weights/dnsmos`` — see ``functional/audio/dnsmos.py``)."""

    is_differentiable = False
    higher_is_better = True
    plot_lower_bound: float = 1.0
    plot_upper_bound: float = 5.0

    def __init__(self, fs: int, personalized: bool, **kwargs: Any) -> None:
        # the pipeline mixes device graphs with host-side calibration (np.polyval),
        # so the update cannot be captured
        kwargs.setdefault("jit_update", False)
        super().__init__(**kwargs)
        self.fs = fs
        self.personalized = personalized

    def update(self, preds: Tensor) -> None:
        """Accumulate per-sample DNSMOS scores (all hops batched on the device)."""
        preds = torch.as_tensor(preds, device=self.device)
        self._accumulate(deep_noise_suppression_mean_opinion_score(preds, self.fs, self.personalized))

    def _compute_group_params(self):
        return (self.fs, self.personalized)
