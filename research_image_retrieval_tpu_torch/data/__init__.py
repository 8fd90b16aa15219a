from research_image_retrieval_tpu_torch.data.eval_loader import (
    ImageFromList,
    PrefetchedImages,
    load_image,
)
from research_image_retrieval_tpu_torch.data.revisited import RevisitedDataset
from research_image_retrieval_tpu_torch.data.synthetic import (
    SyntheticRetrievalDataset,
    make_synthetic_gnd,
)
from research_image_retrieval_tpu_torch.data.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
)

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "ImageFromList",
           "PrefetchedImages", "RevisitedDataset", "SyntheticRetrievalDataset",
           "load_image", "make_synthetic_gnd"]
