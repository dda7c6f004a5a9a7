"""Functional metrics of the port."""

from torchmetrics_tpu_torch.functional import (
    audio,
    classification,
    clustering,
    detection,
    image,
    multimodal,
    nominal,
    pairwise,
    regression,
    retrieval,
    segmentation,
    text,
)
from torchmetrics_tpu_torch.functional.audio import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.audio import __all__ as _audio_all
from torchmetrics_tpu_torch.functional.classification import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.classification import __all__ as _classification_all
from torchmetrics_tpu_torch.functional.clustering import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.clustering import __all__ as _clustering_all
from torchmetrics_tpu_torch.functional.detection import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.detection import __all__ as _detection_all
from torchmetrics_tpu_torch.functional.image import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.image import __all__ as _image_all
from torchmetrics_tpu_torch.functional.multimodal import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.multimodal import __all__ as _multimodal_all
from torchmetrics_tpu_torch.functional.nominal import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.nominal import __all__ as _nominal_all
from torchmetrics_tpu_torch.functional.pairwise import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.pairwise import __all__ as _pairwise_all
from torchmetrics_tpu_torch.functional.regression import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.regression import __all__ as _regression_all
from torchmetrics_tpu_torch.functional.retrieval import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.retrieval import __all__ as _retrieval_all
from torchmetrics_tpu_torch.functional.segmentation import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.segmentation import __all__ as _segmentation_all
from torchmetrics_tpu_torch.functional.text import *  # noqa: F401,F403
from torchmetrics_tpu_torch.functional.text import __all__ as _text_all

__all__ = [
    "audio", "classification", "clustering", "detection", "image", "multimodal", "nominal", "pairwise", "regression", "retrieval",
    "segmentation", "text", *_audio_all, *_classification_all, *_clustering_all, *_detection_all, *_image_all,
    *_multimodal_all, *_nominal_all, *_pairwise_all, *_regression_all, *_retrieval_all, *_segmentation_all, *_text_all,
]
