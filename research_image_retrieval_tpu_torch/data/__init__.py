from research_image_retrieval_tpu_torch.data.eval_loader import (
    ImageFromList,
    PrefetchedImages,
    load_image,
)
from research_image_retrieval_tpu_torch.data.gldv2 import (
    GLDv2FileDataset,
    GLDv2LmdbDataset,
    build_gldv2_train_val,
    parse_clean_csv,
    relabel_contiguous,
    stratified_split,
)
from research_image_retrieval_tpu_torch.data.pipeline import (
    ShardedBatchIterator,
)
from research_image_retrieval_tpu_torch.data.records import (
    RecordDataset,
    RecordReader,
    convert_lmdb_to_records,
    write_records,
)
from research_image_retrieval_tpu_torch.data.revisited import RevisitedDataset
from research_image_retrieval_tpu_torch.data.synthetic import (
    SyntheticRetrievalDataset,
    make_synthetic_gnd,
)
from research_image_retrieval_tpu_torch.data.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    EvalTransform,
    TrainTransform,
)

__all__ = ["EvalTransform", "GLDv2FileDataset", "GLDv2LmdbDataset",
           "IMAGENET_MEAN", "IMAGENET_STD", "ImageFromList",
           "PrefetchedImages", "RecordDataset", "RecordReader",
           "RevisitedDataset", "ShardedBatchIterator",
           "SyntheticRetrievalDataset", "TrainTransform",
           "build_gldv2_train_val", "convert_lmdb_to_records", "load_image",
           "make_synthetic_gnd", "parse_clean_csv", "relabel_contiguous",
           "stratified_split", "write_records"]
