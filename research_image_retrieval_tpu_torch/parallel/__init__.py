"""Multi-GPU layer (port of ``research_image_retrieval_tpu/parallel``):
one process per GPU on ``torch.distributed`` (NCCL on the card, gloo on
the CPU), a ``data x model`` layout of ranks with JAX's global-batch
semantics, and row-sharded gallery search in-process (over a list of
devices) and across processes.

JAX's ``replicated`` has no torch counterpart (a tensor every rank holds
whole needs no placement); ``data_sharding`` gives the rows of a global
batch a rank holds.
"""

from research_image_retrieval_tpu_torch.parallel.dist_init import (
    get_rank,
    get_world_size,
    init_distributed_mode,
    is_main_process,
    local_device,
)
from research_image_retrieval_tpu_torch.parallel.dist_search import (
    default_search_mesh,
    make_sharded_stream_fn,
    place_sharded_gallery,
    sharded_search_topk,
    sharded_streaming_topk,
)
from research_image_retrieval_tpu_torch.parallel.mesh import (
    Mesh,
    classifier_sharding,
    data_sharding,
    make_mesh,
    shard_train_state_rules,
)

__all__ = [
    "Mesh",
    "classifier_sharding",
    "data_sharding",
    "default_search_mesh",
    "get_rank",
    "get_world_size",
    "init_distributed_mode",
    "is_main_process",
    "local_device",
    "make_mesh",
    "make_sharded_stream_fn",
    "place_sharded_gallery",
    "shard_train_state_rules",
    "sharded_search_topk",
    "sharded_streaming_topk",
]
