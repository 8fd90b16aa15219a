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
from research_image_retrieval_tpu_torch.models.clip import (
    CLIP,
    CLIPGlobalModel,
    CLIPTextEncoder,
    clip_contrastive_loss,
)
from research_image_retrieval_tpu_torch.models.clip_convert import (
    build_clip_from_torch,
    convert_clip_visual_vit,
    convert_torch_clip,
    load_clip_visual_into,
)
from research_image_retrieval_tpu_torch.models.clip_resnet import (
    AttentionPool2d,
    CLIPBottleneck,
    ModifiedResNet,
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
from research_image_retrieval_tpu_torch.models.hamlet import (
    HAMLETModel,
    hamlet_loss,
)
from research_image_retrieval_tpu_torch.models.how import HOWModel
from research_image_retrieval_tpu_torch.models.iris import IRISModel, iris_loss
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
from research_image_retrieval_tpu_torch.models.sparse import (
    SparseRetrievalModel,
)
from research_image_retrieval_tpu_torch.models.spca import SpCaModel
from research_image_retrieval_tpu_torch.models.spectrum import SPECTRUMModel
from research_image_retrieval_tpu_torch.models.spoc import SpoCModel
from research_image_retrieval_tpu_torch.models.token import (
    TokenModel,
    TokenRefine,
)
from research_image_retrieval_tpu_torch.models.ultron import (
    ULTRON,
    ULTRONRetrievalModel,
)
from research_image_retrieval_tpu_torch.models.vit import (
    ViTGlobalModel,
    VisionTransformer,
)

__all__ = [
    "AdaptiveHybridModel",
    "Attention",
    "AttentionPool2d",
    "BasicBlock",
    "BatchNorm",
    "BottleneckBlock",
    "CLIP",
    "CLIPBottleneck",
    "CLIPGlobalModel",
    "CLIPTextEncoder",
    "CVLearner",
    "CVNetRerank",
    "CenterPivotConv4d",
    "DELGModel",
    "DOLGModel",
    "Decoder",
    "DropPath",
    "Encoder",
    "GeMModel",
    "HAMLETModel",
    "HOWModel",
    "IRISModel",
    "LayerNorm",
    "MODEL_REGISTRY",
    "Mlp",
    "ModifiedResNet",
    "QAFF",
    "RESNET_STAGE_DEPTHS",
    "ResNet",
    "SENetG2Model",
    "SOLARModel",
    "SPECTRUMModel",
    "SoSNetModel",
    "SparseRetrievalModel",
    "SpCaModel",
    "SpoCModel",
    "TABLE1_TO_MODEL_MAPPING",
    "TokenBatchNorm",
    "TokenModel",
    "TokenRefine",
    "ULTRON",
    "ULTRONRetrievalModel",
    "ViTGlobalModel",
    "VisionTransformer",
    "build_clip_from_torch",
    "clip_contrastive_loss",
    "contrastive_loss",
    "convert_clip_visual_vit",
    "convert_torch_clip",
    "from_jax_variables",
    "get_model",
    "get_model_info",
    "hamlet_loss",
    "iris_loss",
    "list_available_models",
    "load_clip_visual_into",
    "load_features_resnet",
    "load_pycls_resnet",
    "load_torchvision_resnet",
    "qaff_from_flax",
    "register_model",
    "seeded_init",
    "stage_extents",
    "training_init",
]
