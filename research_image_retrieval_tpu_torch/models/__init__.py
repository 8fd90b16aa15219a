"""Models of the port (importing this package registers them)."""

from research_image_retrieval_tpu_torch.models.adaptive_hybrid import (
    QAFF,
    AdaptiveHybridModel,
    contrastive_loss,
)
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
    qaff_from_flax,
    seeded_init,
    training_init,
)
from research_image_retrieval_tpu_torch.models.cvnet import (
    CenterPivotConv4d,
    CVLearner,
    CVNetRerank,
)
from research_image_retrieval_tpu_torch.models.delg import DELGModel
from research_image_retrieval_tpu_torch.models.dolg import DOLGModel
from research_image_retrieval_tpu_torch.models.gem import GeMModel
from research_image_retrieval_tpu_torch.models.how import HOWModel
from research_image_retrieval_tpu_torch.models.layers import (
    Attention,
    Decoder,
    DropPath,
    Encoder,
    LayerNorm,
    Mlp,
    TokenBatchNorm,
)
from research_image_retrieval_tpu_torch.models.registry import (
    MODEL_REGISTRY,
    TABLE1_TO_MODEL_MAPPING,
    get_model,
    get_model_info,
    list_available_models,
    register_model,
)
from research_image_retrieval_tpu_torch.models.senet_g2 import SENetG2Model
from research_image_retrieval_tpu_torch.models.solar import SOLARModel
from research_image_retrieval_tpu_torch.models.sosnet import SoSNetModel
from research_image_retrieval_tpu_torch.models.spca import SpCaModel
from research_image_retrieval_tpu_torch.models.spoc import SpoCModel
from research_image_retrieval_tpu_torch.models.token import (
    TokenModel,
    TokenRefine,
)

__all__ = [
    "AdaptiveHybridModel",
    "Attention",
    "BasicBlock",
    "BatchNorm",
    "BottleneckBlock",
    "CVLearner",
    "CVNetRerank",
    "CenterPivotConv4d",
    "DELGModel",
    "DOLGModel",
    "Decoder",
    "DropPath",
    "Encoder",
    "GeMModel",
    "HOWModel",
    "LayerNorm",
    "MODEL_REGISTRY",
    "Mlp",
    "QAFF",
    "RESNET_STAGE_DEPTHS",
    "ResNet",
    "SENetG2Model",
    "SOLARModel",
    "SoSNetModel",
    "SpCaModel",
    "SpoCModel",
    "TABLE1_TO_MODEL_MAPPING",
    "TokenBatchNorm",
    "TokenModel",
    "TokenRefine",
    "contrastive_loss",
    "from_jax_variables",
    "get_model",
    "get_model_info",
    "list_available_models",
    "load_features_resnet",
    "load_pycls_resnet",
    "load_torchvision_resnet",
    "qaff_from_flax",
    "register_model",
    "seeded_init",
    "stage_extents",
    "training_init",
]
