from research_image_retrieval_tpu_torch.utils.config import (
    EvalConfig,
    TrainConfig,
    get_preset,
)
from research_image_retrieval_tpu_torch.utils.device import (
    fp32_precision,
    resolve_device,
)

__all__ = ["EvalConfig", "TrainConfig", "fp32_precision", "get_preset",
           "resolve_device"]
