"""PyTorch port, the transformer step of the zoo in training, on the CPU
against the JAX package (the tiny configurations of
``test_torch_transformer.py``):

* one SGD step per family (ULTRON with MadaCos, ViT, CLIP-ViT, CLIP's
  ModifiedResNet) against JAX ``make_train_step`` from the same seeded
  variables, in float64 on both sides (JAX under ``jax.enable_x64``);
* ``cli.train --preset ultron_s`` reduced to the tiny ULTRON across its
  AdamW -> SGD hand-off, and ``--resume`` from before and after the
  hand-off bit-equal to the straight run;
* ``training_init``'s laws for the new parameters, and the registry
  (Table-1 names, ``get_model_info``) and the ``ultron_s`` preset against
  JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from research_image_retrieval_tpu import models as jmodels
from research_image_retrieval_tpu.train import loop as jloop
from research_image_retrieval_tpu.train import optimizer as jopt
from research_image_retrieval_tpu.train.schedule import (
    warmup_cosine_schedule as jax_schedule,
)
from research_image_retrieval_tpu.utils import config as jconfig
from research_image_retrieval_tpu_torch import models as tmodels
from research_image_retrieval_tpu_torch.models import get_model, training_init
from research_image_retrieval_tpu_torch.train import (
    TrainState,
    make_train_step,
)
from research_image_retrieval_tpu_torch.utils import config as tconfig
from test_torch_model import few_torch_threads  # noqa: F401
from test_torch_train import _as_port, _change_devs, _leaf_devs, _rel
from test_torch_transformer import (
    CASES,
    NORM,
    PX,
    jax_model,
    overrides,
    port_model,
)
from test_torch_zoo_token_how import SCHED, _as_port_state, _sgd

T = torch.from_numpy
NEW = ("ultron_s", "ultron_b", "vit_s16", "vit_b16", "clip_vit_b32",
       "clip_r50")


@pytest.mark.parametrize("kind", list(CASES))
def test_train_step_matches_jax(kind):
    """One step of JAX ``make_train_step`` and of the port's from the same
    seeded state, both in float64 (train-mode BN of nets this small is
    chaotic in float32, ``tests/test_torch_zoo_more_train.py``): the loss
    to 1e-6 relative (JAX's ArcFace and MadaCos heads cast to float32 even
    under x64, so its loss is a float32 number), each leaf's change to
    1e-4 of its largest change (the attention key biases, whose gradient
    is zero, move by the weight decay alone, which JAX applies to them:
    they are [heads, head_dim] in flax),
    the BN statistics to 1e-6 of each leaf's largest magnitude.  JAX
    keeps ULTRON's channel statistics and rate fractions in float32 even
    under x64; the port's float64 model computes them in float64, which
    moves no rate on these inputs."""
    name = CASES[kind][0]
    _, variables = jax_model(kind)
    rng = np.random.default_rng(8)
    x = rng.integers(0, 256, (2, PX, PX, 3), dtype=np.uint8)
    y = np.array([3, 5])
    xf = (x / 255.0 - np.asarray(NORM[0])) / np.asarray(NORM[1])
    with jax.enable_x64(True):
        jm = jmodels.get_model(name, **overrides(kind, dtype=jnp.float64))
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                   variables)
        jtx = jopt.make_sgd_optimizer(jax_schedule(*SCHED),
                                      weight_decay=1e-4, clip_max_norm=1.0)
        jstate = jloop.TrainState(
            step=jnp.zeros((), jnp.int32),
            params=jax.tree_util.tree_map(jnp.asarray, v["params"]),
            batch_stats=jax.tree_util.tree_map(
                jnp.asarray, v.get("batch_stats", {})),
            opt_state=jax.jit(jtx.init)(v["params"]),
            rng=jax.random.PRNGKey(1), model_state={})
        jstep = jloop.make_train_step(jm, jtx, donate=False)
        ref, jmet = jstep(jstate, jnp.asarray(xf), jnp.asarray(y))
        ref = jax.tree_util.tree_map(np.asarray, ref)
    model = port_model(kind, variables).double()
    tstate = TrainState(0, model, _sgd().init(model), torch.Generator())
    tstate, tmet = make_train_step(None)(tstate, T(xf), y)
    assert np.isfinite(float(jmet["loss"]))
    assert _rel(tmet["loss"], jmet["loss"]) <= 1e-6
    init = _as_port(variables["params"], variables.get("batch_stats", {}))
    want = _as_port_state(ref, v, init)
    port = {k: t.detach().numpy() for k, t in
            tstate.model.state_dict().items()}
    devs = _change_devs(port, want, init)
    worst = max(devs, key=devs.get)
    assert devs[worst] <= 1e-4, (worst, devs[worst])
    stats = {k: d for k, d in _leaf_devs(port, want).items()
             if "running" in k}
    assert not stats or max(stats.values()) <= 1e-6, \
        max(stats, key=stats.get)


def _small_ultron_preset(monkeypatch):
    """``ultron_s``'s preset (AdamW then SGD) at the tiny ULTRON, 2
    synthetic classes x 4 images (two steps of 4 per epoch), the hand-off
    after the first of two epochs."""
    monkeypatch.setitem(tconfig.PRESETS, "ultron_s", {
        **tconfig.PRESETS["ultron_s"], "switch_epoch": 1,
        "synthetic_classes": 2, "synthetic_samples": 4,
        "synthetic_val_samples": 2,
        "model_overrides": dict(variant="t", window_size=4, img_size=PX)})


class _StopAt:
    """A preemption guard that asks the loop to stop at its ``n``-th
    check (one check per train step)."""

    def __init__(self, n):
        self.n, self.seen = n, 0

    def __call__(self):
        from research_image_retrieval_tpu_torch.train.preemption import (
            PreemptionGuard,
        )

        outer = self

        class Guard(PreemptionGuard):
            def __init__(self):
                super().__init__(signals=())

            @property
            def should_stop(self):
                outer.seen += 1
                return outer.seen == outer.n

        return Guard()


def _assert_equal(a, b, where):
    """Nested dicts / sequences of tensors and plain values, equal."""
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_equal(a[k], b[k], (*where, k))
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, (*where, i))
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def test_cli_train_ultron_resumes_across_the_handoff(tmp_path, monkeypatch,
                                                     capsys):
    """``cli.train --preset ultron_s`` (reduced) for two epochs, AdamW in
    the first and SGD after the hand-off; then runs stopped by the
    preemption guard in the AdamW epoch and in the SGD epoch, each
    continued by ``--resume latest``: every final checkpoint equals the
    straight run's, the optimizer state included."""
    from research_image_retrieval_tpu_torch.cli import train as cli_train
    from research_image_retrieval_tpu_torch.train import driver as drv
    from research_image_retrieval_tpu_torch.train.preemption import (
        PreemptionGuard,
    )

    _small_ultron_preset(monkeypatch)

    def run(directory, *extra):
        assert cli_train.main([
            "--preset", "ultron_s", "--device", "cpu", "--imsize", str(PX),
            "--batch-size", "4", "--num-epochs", "2", "--num-workers", "0",
            "--directory", str(directory), *extra]) == 0
        last = directory / "epoch_00002.pt"
        return torch.load(last, weights_only=False) if last.exists() else None

    straight = run(tmp_path / "a")
    out = capsys.readouterr().out
    assert "optimizer hand-off to SGD at epoch 1" in out
    assert straight["phase"] == "main"
    for stop, phase in ((1, "warm"), (3, "main")):
        d = tmp_path / f"stop{stop}"
        monkeypatch.setattr(drv, "PreemptionGuard", _StopAt(stop))
        run(d)  # stopped: its last checkpoint is the preemption's
        monkeypatch.setattr(drv, "PreemptionGuard", PreemptionGuard)
        capsys.readouterr()
        resumed = run(d, "--resume", "latest")
        assert f"optimizer phase '{phase}'" in capsys.readouterr().out
        for key in ("model", "optimizer", "step", "phase"):
            _assert_equal(resumed[key], straight[key], (stop, key))


@torch.no_grad()
def test_training_init_laws():
    """``training_init`` draws the new parameters by flax's laws: the
    ViT tokens and position embeddings normal(0.02), ULTRON's position
    embedding and bias tables truncated at two std of 0.02, its channel
    attention weights normal / sqrt(C), CLIP's attention-pool position
    embedding normal(embed_dim^-0.5); ``gamma`` stays 2.0."""
    gen = torch.Generator().manual_seed(0)
    u = get_model("ultron_s", **overrides("ultron"))
    training_init(u, gen)
    assert float(u.global_pool.gamma) == 2.0
    for t in (u.backbone.absolute_pos_embed,
              u.backbone.stage2_block0.attn.relative_position_bias_table):
        assert 0 < t.abs().max() <= 0.04 and 0.01 < t.std() < 0.025
    caw = u.backbone.stage0_block0.cdconv1.channel_attention_weights
    assert abs(float(caw.std()) * 4 - 1) < 0.3  # C = 16
    v = get_model("vit_b16", num_classes=4, img_size=PX)
    training_init(v, gen)
    for t in (v.backbone.cls_token, v.backbone.pos_embed):
        assert abs(float(t.std()) / 0.02 - 1) < 0.2
    c = get_model("clip_r50", **overrides("clip_rn"))
    training_init(c, gen)
    pe = c.visual.attnpool.positional_embedding
    assert abs(float(pe.std()) * 256 ** 0.5 - 1) < 0.2


def test_transformer_registry_and_presets():
    for name in NEW:
        assert tmodels.get_model_info(name) == jmodels.get_model_info(name)
    for t1, cls in (("ULTRON-S", tmodels.ULTRONRetrievalModel),
                    ("ULTRON-B", tmodels.ULTRONRetrievalModel)):
        name = jmodels.registry.TABLE1_TO_MODEL_MAPPING[t1]
        assert tmodels.TABLE1_TO_MODEL_MAPPING[t1] == name
        assert tmodels.MODEL_REGISTRY[name].builder is cls
    for name, cls in (("vit_s16", tmodels.ViTGlobalModel),
                      ("clip_vit_b32", tmodels.CLIPGlobalModel),
                      ("clip_r50", tmodels.CLIPGlobalModel)):
        assert tmodels.MODEL_REGISTRY[name].builder is cls
    assert tconfig.PRESETS["ultron_s"] == jconfig.PRESETS["ultron_s"]
    got, want = tconfig.get_preset("ultron_s"), jconfig.get_preset("ultron_s")
    for f in ("model", "model_overrides", "optimizer", "base_lr",
              "num_epochs", "switch_epoch", "batch_size", "imsize",
              "clip_max_norm", "weight_decay"):
        assert getattr(got, f) == getattr(want, f), f
    for n in ("build_clip_from_torch", "convert_torch_clip"):
        assert callable(getattr(tmodels, n)) and hasattr(jmodels, n)
