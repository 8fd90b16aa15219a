from research_image_retrieval_tpu_torch.index.extract import (
    extract_vectors,
    multiscale_descriptor,
    resize_bilinear_np,
)
from research_image_retrieval_tpu_torch.index.gallery import HybridGallery
from research_image_retrieval_tpu_torch.index.qe import (
    IterativeQueryExpansion,
    alpha_query_expansion,
    iqe_from_flax,
)
from research_image_retrieval_tpu_torch.index.rerank import (
    geometric_verification_batch,
    geometric_verification_score,
    make_cvnet_batch_scorer,
    mutual_nn_matches,
    rerank_shortlist,
    rerank_shortlist_batched,
)
from research_image_retrieval_tpu_torch.index.search import (
    cosine_similarity,
    rank_full,
    search_topk,
)
from research_image_retrieval_tpu_torch.index.superglobal import (
    gem_aggregate,
    superglobal_rerank,
)

__all__ = ["HybridGallery", "IterativeQueryExpansion", "alpha_query_expansion",
           "cosine_similarity", "extract_vectors", "gem_aggregate",
           "geometric_verification_batch", "geometric_verification_score",
           "iqe_from_flax", "make_cvnet_batch_scorer",
           "multiscale_descriptor", "mutual_nn_matches",
           "rank_full", "rerank_shortlist", "rerank_shortlist_batched",
           "resize_bilinear_np", "search_topk", "superglobal_rerank"]
