from research_image_retrieval_tpu_torch.index.extract import (
    extract_vectors,
    multiscale_descriptor,
    resize_bilinear_np,
)
from research_image_retrieval_tpu_torch.index.qe import alpha_query_expansion
from research_image_retrieval_tpu_torch.index.search import (
    cosine_similarity,
    rank_full,
    search_topk,
)

__all__ = ["alpha_query_expansion", "cosine_similarity", "extract_vectors",
           "multiscale_descriptor", "rank_full", "resize_bilinear_np",
           "search_topk"]
