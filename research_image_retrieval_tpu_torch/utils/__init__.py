from research_image_retrieval_tpu_torch.utils.config import EvalConfig
from research_image_retrieval_tpu_torch.utils.device import (
    fp32_precision,
    resolve_device,
)

__all__ = ["EvalConfig", "fp32_precision", "resolve_device"]
