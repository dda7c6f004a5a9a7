"""torchmetrics_tpu_torch — the PyTorch/CUDA port of ``torchmetrics_tpu``.

It runs on an NVIDIA H100 (Hopper, ``sm_90a``) with hand-written CUDA kernels for the
confusion matrix, the binned-curve counts, the weighted bincount, the bincount and the
SSIM window moments, and on the CPU with their plain PyTorch versions when a metric
is built with ``device="cpu"``. It imports ``torch`` and numpy, never JAX and never
the JAX package.

It holds the metric runtime, ``MetricCollection`` with static compute groups, and
cross-process sync on ``torch.distributed`` (``parallel``); the capture cache of CUDA
graphs (``core/jit.py``), the error policies and fault injection (``robust``), the
telemetry recorder and batch lineage (``obs``) and the streaming pipeline
(``engine``, imported on its own); the whole classification family of the JAX
package, binary, multiclass and multilabel: stat scores, accuracy, precision and recall,
F-beta/F1, specificity, Hamming distance, exact match, confusion matrix, Jaccard index,
Matthews correlation, Cohen's kappa, calibration error, hinge loss, Dice, group
fairness, precision-recall and ROC curves, AUROC, average precision, the fixed
operating points and the label-ranking metrics; and the image-restoration metrics:
SSIM, MS-SSIM, PSNR, PSNR-B, UQI, sliding-window RMSE and total variation; the
aggregation metrics (max, min, sum, mean, cat, running mean and sum); the regression
family (MSE, MAE, MAPE, SMAPE, WMAPE, MSLE, Minkowski, LogCosh, Tweedie, CSI, KL
divergence, cosine similarity, Pearson, Concordance, Spearman, Kendall, R², explained
variance, RSE); the eleven retrieval metrics, which score every query in one batched
pass; the wrappers (bootstrap, classwise, min/max, multioutput, multitask, running,
input transformers, the tracker and feature sharing); the clustering scores (extrinsic
and intrinsic), the nominal association statistics, the segmentation scores and the
pairwise distances (``functional.pairwise``); the text domain's string and token
metrics (error rates, BLEU, SacreBLEU, chrF, TER, EED, ROUGE, SQuAD, perplexity) and its
model-based BERTScore and InfoLM; the multimodal CLIPScore and CLIP-IQA, on plain-torch
BERT, RoBERTa and CLIP encoders with their tokenizers and a local snapshot reader
(``utils/hf``); the audio domain (SNR, SI-SNR, C-SI-SNR, SDR, SI-SDR, SA-SDR,
PIT, native STOI/ESTOI and SRMR, the gated PESQ, and DNSMOS on the port's ONNX executor,
``convert.onnx_torch``); the rest of the image domain (SAM, ERGAS, SCC, VIF, RASE,
D-lambda, D-s, QNR, image gradients, and the model-based LPIPS, FID, IS, KID, MiFID and
perceptual path length on full-float32 ``nn.Module`` networks); detection (COCO mean average precision with
its greedy matcher batched on the device, IoU, GIoU, DIoU, CIoU, and panoptic quality
counted on the bincount kernel); and the fleet plane (``fleet``, ``obs.fleet``) with the live
introspection server (``obs.server``, ``python -m torchmetrics_tpu_torch.obs.serve``).
"""

from torchmetrics_tpu_torch import functional, obs, robust
from torchmetrics_tpu_torch.aggregation import *  # noqa: F401,F403
from torchmetrics_tpu_torch.aggregation import __all__ as _aggregation_all
from torchmetrics_tpu_torch.audio import *  # noqa: F401,F403
from torchmetrics_tpu_torch.audio import __all__ as _audio_all
from torchmetrics_tpu_torch.classification import *  # noqa: F401,F403
from torchmetrics_tpu_torch.classification import __all__ as _classification_all
from torchmetrics_tpu_torch.clustering import *  # noqa: F401,F403
from torchmetrics_tpu_torch.clustering import __all__ as _clustering_all
from torchmetrics_tpu_torch.collections import MetricCollection
from torchmetrics_tpu_torch.core.buffer import MaskedBuffer
from torchmetrics_tpu_torch.core.metric import CompositionalMetric, Metric
from torchmetrics_tpu_torch.detection import *  # noqa: F401,F403
from torchmetrics_tpu_torch.detection import __all__ as _detection_all
from torchmetrics_tpu_torch.image import *  # noqa: F401,F403
from torchmetrics_tpu_torch.image import __all__ as _image_all
from torchmetrics_tpu_torch.multimodal import *  # noqa: F401,F403
from torchmetrics_tpu_torch.multimodal import __all__ as _multimodal_all
from torchmetrics_tpu_torch.nominal import *  # noqa: F401,F403
from torchmetrics_tpu_torch.nominal import __all__ as _nominal_all
from torchmetrics_tpu_torch.regression import *  # noqa: F401,F403
from torchmetrics_tpu_torch.regression import __all__ as _regression_all
from torchmetrics_tpu_torch.retrieval import *  # noqa: F401,F403
from torchmetrics_tpu_torch.retrieval import __all__ as _retrieval_all
from torchmetrics_tpu_torch.segmentation import *  # noqa: F401,F403
from torchmetrics_tpu_torch.segmentation import __all__ as _segmentation_all
from torchmetrics_tpu_torch.text import *  # noqa: F401,F403
from torchmetrics_tpu_torch.text import __all__ as _text_all
from torchmetrics_tpu_torch.wrappers import (
    BootStrapper,
    ClasswiseWrapper,
    MetricTracker,
    MinMaxMetric,
    MultioutputWrapper,
    MultitaskWrapper,
    Running,
)

__version__ = "0.1.0.dev0"

__all__ = [
    "CompositionalMetric", "MaskedBuffer", "Metric", "MetricCollection", "functional", "obs", "robust", *_classification_all,
    *_image_all, *_aggregation_all, *_regression_all, *_retrieval_all, *_clustering_all, *_nominal_all,
    *_segmentation_all, *_text_all, *_audio_all, *_detection_all, *_multimodal_all, "BootStrapper", "ClasswiseWrapper",
    "MetricTracker", "MinMaxMetric", "MultioutputWrapper", "MultitaskWrapper", "Running",
]
