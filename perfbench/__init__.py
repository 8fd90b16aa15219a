"""The benchmark of the PyTorch / CUDA port: ``BENCHMARK.json`` at the
root names its cells; ``run.py`` runs one (see ``harness.py``)."""
