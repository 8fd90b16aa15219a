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
    load_features_resnet,
    load_pycls_resnet,
    load_torchvision_resnet,
    seeded_init,
    training_init,
)
from research_image_retrieval_tpu_torch.models.delg import DELGModel
from research_image_retrieval_tpu_torch.models.dolg import DOLGModel
from research_image_retrieval_tpu_torch.models.gem import GeMModel
from research_image_retrieval_tpu_torch.models.registry import (
    MODEL_REGISTRY,
    TABLE1_TO_MODEL_MAPPING,
    get_model,
    get_model_info,
    list_available_models,
    register_model,
)
from research_image_retrieval_tpu_torch.models.solar import SOLARModel

__all__ = [
    "BasicBlock",
    "BatchNorm",
    "BottleneckBlock",
    "DELGModel",
    "DOLGModel",
    "GeMModel",
    "MODEL_REGISTRY",
    "RESNET_STAGE_DEPTHS",
    "ResNet",
    "SOLARModel",
    "TABLE1_TO_MODEL_MAPPING",
    "from_jax_variables",
    "get_model",
    "get_model_info",
    "list_available_models",
    "load_features_resnet",
    "load_pycls_resnet",
    "load_torchvision_resnet",
    "register_model",
    "seeded_init",
    "stage_extents",
    "training_init",
]
