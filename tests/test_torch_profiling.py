"""PyTorch port, ``utils/profiling.py`` on the CPU (the JAX module has no
numerics to compare; these hold the contract the docstrings state):

* ``deterministic_mode`` sets ``cudnn.deterministic``, clears
  ``cudnn.benchmark`` and turns ``torch.use_deterministic_algorithms``
  on inside the block, and restores all three after it, on an exception
  too; with a card in use it raises unless ``CUBLAS_WORKSPACE_CONFIG`` is
  ``:4096:8`` or ``:16:8``, and never sets the variable itself;
* ``nan_check`` raises on a non-finite output, nested ones included;
* ``trace`` writes a Chrome trace.
"""

import json
import os

import pytest
import torch

from research_image_retrieval_tpu_torch.utils import profiling


def _flags():
    return (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            torch.are_deterministic_algorithms_enabled())


@pytest.mark.parametrize("raise_inside", [False, True])
def test_deterministic_mode_sets_and_restores(monkeypatch, raise_inside):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    before = _flags()
    try:
        with profiling.deterministic_mode():
            assert _flags() == (True, False, True)
            if raise_inside:
                raise KeyError("inside")
    except KeyError:
        assert raise_inside
    assert _flags() == before


def test_deterministic_mode_needs_cublas_config_on_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    before = _flags()
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
        with profiling.deterministic_mode():
            pass
    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    assert _flags() == before
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    with profiling.deterministic_mode():
        assert torch.are_deterministic_algorithms_enabled()
    assert _flags() == before


def test_deterministic_mode_without_card_needs_no_config(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    with profiling.deterministic_mode():
        assert torch.backends.cudnn.deterministic


def test_nan_check():
    ok = profiling.nan_check(lambda x: (x, {"y": x * 2}))
    assert ok(torch.ones(2))[1]["y"].tolist() == [2.0, 2.0]
    bad = profiling.nan_check(lambda x: (x, {"y": x / 0.0}))
    with pytest.raises(FloatingPointError, match=r"\[1\]\['y'\]"):
        bad(torch.zeros(2))
    off = profiling.nan_check(lambda x: x / 0.0, enabled=False)
    assert torch.isnan(off(torch.zeros(1))).all()


def test_trace_writes_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path), name="t"):
        torch.ones(8).sum()
    with open(tmp_path / "t.json") as f:
        assert "traceEvents" in json.load(f)
