"""Command-line entry points of the port (``python -m
research_image_retrieval_tpu_torch.cli.<name>``)."""
