"""Descriptor ops of the port (NHWC at every public function)."""

from research_image_retrieval_tpu_torch.ops.gem_head import (
    gem_whiten_l2,
    gem_whiten_l2_reference,
)
from research_image_retrieval_tpu_torch.ops.losses import (
    arcface_delg_logits,
    arcface_logits,
    cross_entropy,
    madacos_loss,
    topk_errors,
)
from research_image_retrieval_tpu_torch.ops.masking import (
    ceil_half,
    downsample_extents,
    dynamic_resize_weights,
    floor_half,
    hw_mask,
    mask_attn_logits,
    token_mask,
)
from research_image_retrieval_tpu_torch.ops.norm import (
    at_least_fp32,
    fused_input_norm,
    l2_normalize,
)
from research_image_retrieval_tpu_torch.ops.pooling import (
    avg_pool_all,
    gem_pool,
    max_pool_all,
    spoc_pool,
)
from research_image_retrieval_tpu_torch.ops.resblock import (
    fold_bn,
    fused_bottleneck,
    fused_bottleneck_reference,
)
from research_image_retrieval_tpu_torch.ops.resize import dense_resize_weights
from research_image_retrieval_tpu_torch.ops.topk_stream import (
    approx_streaming_topk,
    int8_streaming_topk,
    quantize_gallery_int8,
    scan_streaming_topk,
    streaming_topk,
)
from research_image_retrieval_tpu_torch.ops.whiten import (
    apply_whitening,
    pca_whiten_learn,
)

__all__ = [
    "apply_whitening",
    "approx_streaming_topk",
    "arcface_delg_logits",
    "arcface_logits",
    "at_least_fp32",
    "avg_pool_all",
    "ceil_half",
    "cross_entropy",
    "dense_resize_weights",
    "downsample_extents",
    "dynamic_resize_weights",
    "floor_half",
    "fold_bn",
    "fused_bottleneck",
    "fused_bottleneck_reference",
    "fused_input_norm",
    "gem_pool",
    "gem_whiten_l2",
    "gem_whiten_l2_reference",
    "hw_mask",
    "int8_streaming_topk",
    "l2_normalize",
    "madacos_loss",
    "mask_attn_logits",
    "max_pool_all",
    "pca_whiten_learn",
    "quantize_gallery_int8",
    "scan_streaming_topk",
    "spoc_pool",
    "streaming_topk",
    "token_mask",
    "topk_errors",
]
