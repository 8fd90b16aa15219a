"""PyTorch / CUDA port of the image-retrieval framework.

Mirrors the layout of the JAX package ``research_image_retrieval_tpu``
(``ops/ models/ index/ evaluation/ data/ serve/ cli/ utils/``) and imports
nothing of it, nor JAX.  Entry points run on ``device="cuda"`` unless the
caller names the CPU.  The two Pallas TPU kernels of the JAX package are
hand-written CUDA here (``csrc/``), built with nvcc at first use.
"""
