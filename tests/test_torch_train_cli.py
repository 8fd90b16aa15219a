"""PyTorch port, the training entry points on the CPU:

* ``cli.train.main([... "--device", "cpu"])`` on the synthetic classes for
  2 epochs writes the same JSONL keys and step counts as the JAX CLI on
  the same flags, and its ``epoch_00002.pt`` loads in ``cli.evaluate``
  (the evaluation driver reads a trainer checkpoint's ``"model"``);
* a resume is bitwise exact: 2 steps, a preemption checkpoint, a restore
  and 2 more steps give the parameters, BN statistics and optimizer state
  of 4 steps straight (and so does the AdamW -> SGD hand-off, whose
  resume tries each optimizer phase);
* the record-file path (``.rirrec``: the head's size from the largest
  label) trains;
* what the port does not run raises: CUDA without a card, a layout that
  is not the world size, more than one rank in one process, a model whose
  batch coupling the multi-GPU step does not make global, an unknown
  compute dtype, TensorBoard without its package (the teacher trains:
  ``tests/test_torch_prototypes_train.py``; multi-GPU training:
  ``tests/test_torch_dist_multiprocess.py``).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from research_image_retrieval_tpu_torch.train import driver as drv
from research_image_retrieval_tpu_torch.train.preemption import PreemptionGuard
from research_image_retrieval_tpu_torch.utils.config import get_preset
from tests.test_torch_model import few_torch_threads  # noqa: F401

# batch 8: the JAX CLI shards the batch over the tests' 8 virtual devices
CLI_ARGS = ["--imsize", "32", "--batch-size", "8", "--num-epochs", "2",
            "--max-steps-per-epoch", "2", "--num-workers", "0"]


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    from research_image_retrieval_tpu_torch.cli.train import main

    d = str(tmp_path_factory.mktemp("port_cli"))
    assert main(CLI_ARGS + ["--directory", d, "--device", "cpu"]) == 0
    return d


def test_cli_train_history_matches_jax(cli_run, tmp_path):
    from research_image_retrieval_tpu.cli.train import main as jax_main

    d = str(tmp_path / "jax")
    assert jax_main(CLI_ARGS + ["--directory", d]) == 0
    got, want = _jsonl(os.path.join(cli_run, "metrics.jsonl")), _jsonl(
        os.path.join(d, "metrics.jsonl"))
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert [(r["step"], r["epoch"]) for r in got] == [
        (r["step"], r["epoch"]) for r in want] == [(2, 0.0), (4, 1.0)]
    assert all(np.isfinite(r["train_loss"]) for r in got)
    # both CLIs draw curves.png (plot_freq 1, matplotlib present)
    assert "curves.png" in os.listdir(d)
    assert sorted(os.listdir(cli_run)) == ["best.pt", "curves.png",
                                          "epoch_00002.pt", "metrics.jsonl"]


def test_cli_evaluate_loads_trained_checkpoint(cli_run, tmp_path, capsys):
    from research_image_retrieval_tpu_torch.cli.evaluate import main
    from research_image_retrieval_tpu_torch.evaluation.driver import (
        _load_model,
        load_checkpoint,
    )
    from research_image_retrieval_tpu_torch.utils.config import EvalConfig

    ckpt = os.path.join(cli_run, "epoch_00002.pt")
    payload = torch.load(ckpt, weights_only=True)
    assert {"model", "optimizer", "step", "it", "rng", "loop_epoch",
            "phase"} <= set(payload)
    sd, backbone_only = load_checkpoint(ckpt)
    assert not backbone_only and set(sd) == set(payload["model"])
    model = _load_model(EvalConfig(checkpoint=ckpt), device="cpu")
    assert model.classifier_w.shape == (16, 2048)  # the trainer's head
    for k, v in model.state_dict().items():
        assert torch.equal(v, payload["model"][k]), k
    out = str(tmp_path / "res.json")
    assert main(["--checkpoint", ckpt, "--device", "cpu", "--imsize", "64",
                 "--datasets", "roxford5k", "--output", out]) == 0
    e, m, h = json.load(open(out))["roxford5k"]
    assert 0.0 <= e <= 100.0 and 0.0 <= h <= 100.0


def _tiny_cfg(tmp_path, **kw):
    base = dict(num_epochs=2, batch_size=4, imsize=32, num_workers=0,
                synthetic_classes=2, synthetic_samples=4,
                synthetic_val_samples=2, synthetic_uint8=True,
                directory=str(tmp_path), device="cpu", plot_freq=0,
                model_overrides={"backbone_name": "resnet18",
                                 "outputdim": 16})
    base.update(kw)
    return get_preset("gem_r50", **base)


class _TripAfter(PreemptionGuard):
    """A guard that asks to stop after ``n`` steps."""

    n = 2

    def __init__(self):
        super().__init__(signals=())
        self.seen = 0

    @property
    def should_stop(self):
        self.seen += 1
        return self.seen >= self.n


def _state_tensors(state):
    out = {f"model.{k}": v.clone() for k, v in
           state.model.state_dict().items()}
    for i, (p, st) in enumerate(state.optimizer.inner.state.items()):
        for k, v in st.items():
            out[f"opt.{i}.{k}"] = torch.as_tensor(v).clone()
    return out


@pytest.mark.parametrize("optimizer, stop_after", [
    ("sgd", 2),              # at the end of epoch 0 (2 steps per epoch)
    ("adamw_then_sgd", 3),   # inside epoch 1, after the hand-off to SGD
])
def test_resume_is_bitwise_exact(tmp_path, monkeypatch, optimizer,
                                 stop_after):
    kw = dict(optimizer=optimizer, switch_epoch=1, base_lr=1e-3)
    straight, hist = drv.train(_tiny_cfg(tmp_path / "a", **kw))
    assert not hist["preempted"] and straight.optimizer.tx.kind == "sgd"
    # the hand-off restarts the step count, as the JAX driver does
    assert straight.step == (4 if optimizer == "sgd" else 2)

    _TripAfter.n = stop_after
    monkeypatch.setattr(drv, "PreemptionGuard", _TripAfter)
    cut, hist = drv.train(_tiny_cfg(tmp_path / "b", **kw))
    assert hist["preempted"]
    assert cut.step == (stop_after if optimizer == "sgd" else 1)
    monkeypatch.setattr(drv, "PreemptionGuard", PreemptionGuard)
    resumed, hist = drv.train(_tiny_cfg(tmp_path / "b", resume="latest",
                                        **kw))
    assert not hist["preempted"] and resumed.step == straight.step
    a, b = _state_tensors(straight), _state_tensors(resumed)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert resumed.optimizer.count == straight.optimizer.count
    assert torch.equal(resumed.rng.get_state(), straight.rng.get_state())


def test_train_from_records(tmp_path):
    """A .rirrec file through the driver: the head is sized by the largest
    label (here 999), one record per class goes to validation."""
    import cv2

    from research_image_retrieval_tpu_torch.data import write_records

    rng = np.random.default_rng(0)
    labels = [0, 0, 5, 5, 999, 999, 3, 3]
    items = [(cv2.imencode(".jpg", rng.integers(0, 256, (40, 52, 3),
                                                dtype=np.uint8))[1].tobytes(),
              lb) for lb in labels]
    path = str(tmp_path / "t.rirrec")
    write_records(path, iter(items))
    cfg = _tiny_cfg(tmp_path / "ck", data_root=path, num_epochs=1)
    train_ds, val_ds, n_cls = drv.build_datasets(cfg)
    assert (len(train_ds), len(val_ds), n_cls) == (4, 4, 1000)
    state, hist = drv.train(cfg)
    assert state.model.classifier_w.shape == (1000, 16)
    assert state.step == 1 and np.isfinite(hist["train_loss"][0])


@pytest.mark.parametrize("override, match, world_of_one", [
    (dict(device="cuda"), "cuda", False),
    # a layout that is not the world size (a launched world of one)
    (dict(data_parallel=2), r"mesh 2x1 != 1", True),
    # more than one rank asked of one process outside torch.distributed
    (dict(model_parallel=2), "torchrun --nproc_per_node=2", False),
    # a model that couples its batch (SPECTRUM's batch attention) trains
    # under a launched world of one (match None: no raise); the case kept
    # the id of the raise it replaces
    pytest.param(dict(model="spectrum_r50", data_parallel=1), None, True,
                 id="override3-BatchCASTLE-False"),
    (dict(compute_dtype="float16"), "compute_dtype", False),
])
def test_unported_options_raise(tmp_path, monkeypatch, override, match,
                                world_of_one):
    """Each option the port cannot run as asked raises; a batch-coupled
    model trains under a layout."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if world_of_one:
        import socket

        from research_image_retrieval_tpu_torch.parallel import (
            init_distributed_mode,
        )

        with socket.socket() as s:
            s.bind(("", 0))
            port = s.getsockname()[1]
        init_distributed_mode(f"localhost:{port}", device="cpu", force=True,
                              quiet_non_main=False)
    try:
        if match is None:  # the gem preset's ArcFace keys dropped
            cfg = dataclasses.replace(
                _tiny_cfg(tmp_path, num_epochs=1, **override),
                model_overrides={"backbone_name": "resnet18",
                                 "outputdim": 16})
            state, hist = drv.train(cfg, max_steps_per_epoch=1)
            assert state.step == 1 and np.isfinite(hist["train_loss"][0])
        else:
            with pytest.raises((NotImplementedError, RuntimeError,
                                ValueError), match=match):
                drv.train(_tiny_cfg(tmp_path, **override))
    finally:
        if world_of_one:
            torch.distributed.destroy_process_group()


def test_tensorboard_without_package_raises(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_tb(name, *a, **k):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("No module named 'tensorboard'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_tb)
    with pytest.raises(RuntimeError, match="tensorboard"):
        drv.train(_tiny_cfg(tmp_path, tensorboard=True))


def test_cli_list_presets(capsys):
    from research_image_retrieval_tpu_torch.cli.train import main

    assert main(["--list-presets"]) == 0
    assert capsys.readouterr().out.split() == [
        "adaptive_hybrid_r50", "delg_r50", "dolg_r101", "gem_r101", "gem_r50",
        "hamlet_r50", "how_asmk_r50", "how_vlad_r50", "senet_g2_r50",
        "solar_r101", "sosnet_r50", "sparse_r50", "spca_r101", "spoc_r50",
        "token_r101", "ultron_s"]
