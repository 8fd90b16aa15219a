"""Models of the port (importing this package registers them)."""

from research_image_retrieval_tpu_torch.models.backbone import (
    RESNET_STAGE_DEPTHS,
    BasicBlock,
    BatchNorm,
    BottleneckBlock,
    ResNet,
    stage_extents,
)
from research_image_retrieval_tpu_torch.models.convert import (
    from_jax_variables,
    load_torchvision_resnet,
    seeded_init,
    training_init,
)
from research_image_retrieval_tpu_torch.models.gem import GeMModel
from research_image_retrieval_tpu_torch.models.registry import (
    MODEL_REGISTRY,
    get_model,
    list_available_models,
    register_model,
)

__all__ = [
    "BasicBlock",
    "BatchNorm",
    "BottleneckBlock",
    "GeMModel",
    "MODEL_REGISTRY",
    "RESNET_STAGE_DEPTHS",
    "ResNet",
    "from_jax_variables",
    "get_model",
    "list_available_models",
    "load_torchvision_resnet",
    "register_model",
    "seeded_init",
    "stage_extents",
    "training_init",
]
