from tae_tpu_torch.models.registry import create, list_models, register_model  # noqa: F401
from tae_tpu_torch.models import recognition, segmentation, tae  # noqa: F401  (populate registry)
from tae_tpu_torch.models.recognition import RecognitionConfig, RecognitionViT  # noqa: F401
from tae_tpu_torch.models.segmentation import (SegmentationConfig,  # noqa: F401
                                               SegmentationViT)
from tae_tpu_torch.models.tae import TAE, TAEConfig  # noqa: F401
