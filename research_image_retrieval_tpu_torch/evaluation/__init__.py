from research_image_retrieval_tpu_torch.evaluation.driver import (
    EvalConfig,
    evaluate,
    evaluate_synthetic,
)
from research_image_retrieval_tpu_torch.evaluation.revisited import (
    compute_ap,
    compute_map,
    compute_map_and_print,
    evaluate_revisited,
)

__all__ = ["EvalConfig", "compute_ap", "compute_map", "compute_map_and_print",
           "evaluate", "evaluate_revisited", "evaluate_synthetic"]
