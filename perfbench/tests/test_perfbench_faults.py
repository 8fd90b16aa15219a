"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a chip skipped, the rest of a run driven on the CPU
at a small size, once for each fault the cell can have (one chip: no
exchange between chips to leave out)."""

import pytest
import torch

from perfbench import harness
from research_image_retrieval_tpu_torch.models import gem
from research_image_retrieval_tpu_torch.serve import service
from research_image_retrieval_tpu_torch.train import loop
from research_image_retrieval_tpu_torch.train import optimizer

from .conftest import TINY


@pytest.fixture
def run(root):
    def go(cell):
        return harness.run_cell(cell, 2 ** 33 + 41, 2.0, False, device="cpu",
                                overrides=TINY[cell], root=root)
    return go


def _altered_descriptors(monkeypatch):
    real = gem.GeMModel.extract

    def extract(self, x, valid_hw=None):
        out = real(self, x, valid_hw).clone()
        out[:, 0] += 1e-3            # an answer altered where it is made
        return out
    monkeypatch.setattr(gem.GeMModel, "extract", extract)


def test_index_descriptor_altered(monkeypatch, run):
    _altered_descriptors(monkeypatch)
    assert not run("gem_r101.index_1024_ms3")["correct"]


def test_index_half_of_the_batch_left_out(monkeypatch, run):
    real = gem.GeMModel.extract

    def extract(self, x, valid_hw=None):
        half = x.shape[0] // 2
        out = real(self, x[:half], None if valid_hw is None
                   else valid_hw[:half])
        return torch.cat([out, out[: x.shape[0] - half]])
    monkeypatch.setattr(gem.GeMModel, "extract", extract)
    assert not run("gem_r101.index_1024_ms3")["correct"]


def test_query_descriptor_altered(monkeypatch, run):
    _altered_descriptors(monkeypatch)
    assert not run("gem_r50.query_image_r1m")["correct"]


def test_query_answer_altered(monkeypatch, run):
    real = service.SearchService.search

    def search(self, vecs, k=None):
        scores, ids = real(self, vecs, k=k)
        ids = ids.copy()
        ids[:, 0] = (ids[:, 0] + 1) % self.n_gallery
        return scores, ids
    monkeypatch.setattr(service.SearchService, "search", search)
    assert not run("gem_r50.query_image_r1m")["correct"]


def test_train_state_left_unchanged(monkeypatch, run):
    def step(self):               # the norm as usual, no update
        return optimizer.global_norm([p.grad for p in self.params])
    monkeypatch.setattr(optimizer.Optimizer, "step", step)
    assert not run("gem_r50.train_512_arcface")["correct"]


def test_train_half_of_the_batch_left_out(monkeypatch, run):
    real = loop.make_train_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def half(state, images, labels):
            n = images.shape[0] // 2
            return step(state, images[:n], labels[:n])
        return half
    monkeypatch.setattr(loop, "make_train_step", make)
    assert not run("gem_r50.train_512_arcface")["correct"]


def test_train_loss_altered(monkeypatch, run):
    real = loop.make_train_step

    def make(*a, **kw):
        step = real(*a, **kw)

        def altered(state, images, labels):
            state, m = step(state, images, labels)
            return state, {**m, "loss": m["loss"] * 1.01}
        return altered
    monkeypatch.setattr(loop, "make_train_step", make)
    assert not run("gem_r50.train_512_arcface")["correct"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_unbroken_run_is_correct(cell, run):
    assert run(cell)["correct"]
