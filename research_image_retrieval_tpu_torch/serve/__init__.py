"""Serving: resident search service + HTTP front end (port of
``research_image_retrieval_tpu/serve``)."""

from research_image_retrieval_tpu_torch.serve.http import make_http_server
from research_image_retrieval_tpu_torch.serve.service import (
    ImageExtractor,
    SearchService,
)

__all__ = ["ImageExtractor", "SearchService", "make_http_server"]
