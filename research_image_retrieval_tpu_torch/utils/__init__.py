from research_image_retrieval_tpu_torch.utils.config import (
    EvalConfig,
    TrainConfig,
    get_preset,
)
from research_image_retrieval_tpu_torch.utils.device import (
    fp32_precision,
    resolve_device,
)
from research_image_retrieval_tpu_torch.utils.profiling import (
    deterministic_mode,
    nan_check,
    trace,
)

__all__ = ["EvalConfig", "TrainConfig", "deterministic_mode",
           "fp32_precision", "get_preset", "nan_check", "resolve_device",
           "trace"]
