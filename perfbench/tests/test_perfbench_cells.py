"""Each cell run end to end on the CPU at a small size: the program's
timed path agrees with the plain reference (``correct``), and the
control (the reference at TF32 in the program's place, and for training
the reference on half of each batch) does not."""

import math

import pytest
import torch

from perfbench import control, harness

from .conftest import TINY

CELLS = sorted(TINY)


def _over(readings: dict, limits: dict) -> list:
    return [k for k, v in readings.items() if k in limits
            and not (math.isfinite(v) and v <= limits[k])]


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_agrees_with_the_reference(cell, root):
    r = harness.run_cell(cell, 2 ** 33 + 17, 2.0, False, device="cpu",
                         overrides=TINY[cell], root=root)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert "setup_s" in r["metrics"] and len(r["metrics"]) == 2
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, root):
    limits = harness.make_cell(cell, 0, 0, False, device="cpu",
                               root=root)[0].limits
    got = control.readings(cell, 2 ** 33 + 19, "tf32", device="cpu",
                           overrides=TINY[cell], root=root)
    assert _over(got, limits), got


def test_half_of_each_batch_is_not_correct():
    cell = "gem_r50.train_512_arcface"
    limits = harness.make_cell(cell, 0, 0, False, device="cpu")[0].limits
    got = control.readings(cell, 2 ** 33 + 23, "halfbatch", device="cpu",
                           overrides=TINY[cell])
    assert _over(got, limits), got


def test_traced_run_reads_its_per_layer_metrics():
    cell = "gem_r50.train_512_arcface"
    r = harness.run_cell(cell, 29, 3.0, True, device="cpu",
                         overrides={**TINY[cell], "traffic": {
                             **TINY[cell]["traffic"], "stretch_at": 0.0,
                             "stretch_steps": 1}})
    assert r["correct"]
    assert "mfu.train" in r["metrics"]
    assert r["device"]["window_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, root):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the cells' sizes)")
    r = harness.run_cell(cell, 2 ** 33 + 31, 5.0, False, root=root)
    assert r["correct"], r["checks"]
