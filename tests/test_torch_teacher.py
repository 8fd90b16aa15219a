"""PyTorch port, the offline text teacher of the distillation models
(SPARSE, HAMLET) on the CPU against the JAX package:

* ``TextTeacher`` (a random-init one-layer DistilBERT) gives tables
  bit-equal to the JAX package's for the same texts and seed; without
  ``allow_random_init`` a missing model is a hard error; the label-text
  helpers; ``build_teacher_table``'s rejections;
* ``cli.train --preset sparse_r50 --teacher --teacher-allow-random``
  (the preset's model at resnet18) trains on a tiny record file: its
  first step's loss, from JAX's variables and on its own batch and
  table, equals JAX ``make_train_step(teacher_table=...)``'s at 1e-5;
  the run draws ``curves.png``.

The train steps with a table against JAX's are in
``tests/test_torch_prototypes_train.py``.
"""

import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from research_image_retrieval_tpu import models as jmodels
from research_image_retrieval_tpu.data import teacher as jteacher
from research_image_retrieval_tpu.train import loop as jloop
from research_image_retrieval_tpu.train import optimizer as jopt
from research_image_retrieval_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD
from research_image_retrieval_tpu_torch.data import teacher as tteacher
from research_image_retrieval_tpu_torch.models import (
    from_jax_variables,
    get_model,
)
from research_image_retrieval_tpu_torch.train import driver as drv
from research_image_retrieval_tpu_torch.utils import config as tconfig
from test_torch_model import few_torch_threads  # noqa: F401
from test_torch_prototypes import overrides
from test_torch_train import _rel

NORM = (IMAGENET_MEAN, IMAGENET_STD)
TINY_BERT = dict(n_layers=1, dim=32, hidden_dim=64, n_heads=2)

TEXTS = ["a photo of landmark 0", "the old bridge at night",
         "a photo of landmark 2"]


def test_text_teacher_table_bit_equal_to_jax():
    """Both packages' teachers are torch on the host: the port's copy
    gives the same table, bit for bit, and a deterministic one."""
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        port = tteacher.TextTeacher("no-such-model", seed=3,
                                    config_overrides=TINY_BERT,
                                    allow_random_init=True)
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        ref = jteacher.TextTeacher("no-such-model", seed=3,
                                   config_overrides=TINY_BERT,
                                   allow_random_init=True)
    got = port.class_table(TEXTS, batch_size=2)
    want = ref.class_table(TEXTS, batch_size=2)
    assert got.dtype == np.float32 and got.shape == (3, 32)
    np.testing.assert_array_equal(got, want)
    assert not port.pretrained and port.text_dim == 32
    assert np.abs(got[0] - got[1]).max() > 1e-3
    ids, mask = port._tokenizer(TEXTS)
    jids, jmask = ref._tokenizer(TEXTS)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)


def test_text_teacher_without_random_init_raises():
    with pytest.raises(RuntimeError, match="allow_random_init"):
        tteacher.TextTeacher("no-such-model", config_overrides=TINY_BERT)


def test_label_text_helpers(tmp_path):
    assert tteacher.default_label_texts(3) == \
        jteacher.default_label_texts(3) == [f"a photo of landmark {i}"
                                            for i in range(3)]
    p = tmp_path / "labels.txt"
    p.write_text("alpha\n\nbeta gamma\n delta \n")
    assert tteacher.load_label_texts(str(p)) == \
        jteacher.load_label_texts(str(p)) == ["alpha", "beta gamma", "delta"]
    with pytest.raises(ValueError, match="expected 4"):
        tteacher.load_label_texts(str(p), num_classes=4)


def test_build_teacher_table_rejections(monkeypatch):
    """A model without ``text_features`` (SPECTRUM takes ``text``) and a
    table of another width are refused, as in the JAX driver."""
    cfg = tconfig.get_preset("sparse_r50", teacher=True,
                             teacher_allow_random=True, device="cpu")
    spectrum = get_model("spectrum_r50", **overrides("spectrum_r50"))
    with pytest.raises(ValueError, match="takes no text_features"):
        drv.build_teacher_table(cfg, spectrum, 8)

    monkeypatch.setattr(tteacher, "TextTeacher", _tiny_teacher(32))
    sparse = get_model("sparse_r50", **overrides("sparse_r50"))
    with pytest.warns(UserWarning), pytest.raises(
            ValueError, match="text_dim 32 != model text_dim 48"):
        drv.build_teacher_table(cfg, sparse, 8)
    table = drv.build_teacher_table(
        cfg, get_model("sparse_r50", **overrides("sparse_r50",
                                                 text_dim=32)), 8)
    assert table.shape == (8, 32)
    assert "text_features" in inspect.signature(
        get_model("hamlet_r50", **overrides("hamlet_r50")).forward
    ).parameters


# -- cli.train with the teacher ------------------------------------------------

def _record_file(path, classes=4, per_class=3):
    import cv2

    from research_image_retrieval_tpu_torch.data import write_records

    rng = np.random.default_rng(0)
    items = [(cv2.imencode(".jpg", rng.integers(0, 256, (40, 52, 3),
                                                dtype=np.uint8))[1].tobytes(),
              c) for c in range(classes) for _ in range(per_class)]
    write_records(path, iter(items))


def test_cli_train_sparse_teacher_matches_jax(tmp_path, monkeypatch):
    """``cli.train --preset sparse_r50 --teacher --teacher-allow-random``
    on a 4-class record file (the preset's model at resnet18, 32-d, a
    one-layer 48-wide random-init DistilBERT): the port starts from JAX's
    variables (its ``training_init`` replaced by loading them), and the
    first step's loss on the step's own batch and teacher table equals
    JAX's step at 1e-5.  ``curves.png`` is drawn."""
    from research_image_retrieval_tpu_torch.cli import train as cli_train
    from research_image_retrieval_tpu_torch.train import loop as tloop

    small = dict(backbone_name="resnet18", outputdim=32, distill_dim=16,
                 text_dim=48)
    monkeypatch.setitem(tconfig.PRESETS, "sparse_r50", {
        **tconfig.PRESETS["sparse_r50"], "model_overrides": small})
    monkeypatch.setattr(tteacher, "TextTeacher", _tiny_teacher(48))
    jm = jmodels.get_model("sparse_r50", num_classes=4, **small)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                        labels=jnp.zeros((1,), jnp.int32), train=False))())
    monkeypatch.setattr(tloop, "training_init", lambda model, gen: (
        model.load_state_dict(from_jax_variables(variables))))
    seen = {}
    real_step = drv.make_train_step

    def recording(input_norm=None, teacher_table=None, mesh=None):
        step = real_step(input_norm, teacher_table=teacher_table, mesh=mesh)
        seen["table"] = teacher_table

        def run(state, images, labels):
            if "x" not in seen:
                seen["x"], seen["y"] = np.asarray(images), np.asarray(labels)
            state, m = step(state, images, labels)
            seen.setdefault("loss", float(m["loss"]))
            return state, m

        return run

    monkeypatch.setattr(drv, "make_train_step", recording)
    rec = str(tmp_path / "t.rirrec")
    _record_file(rec)
    d = tmp_path / "ck"
    assert cli_train.main([
        "--preset", "sparse_r50", "--teacher", "--teacher-allow-random",
        "--device", "cpu", "--data-root", rec, "--imsize", "32",
        "--batch-size", "4", "--num-epochs", "1", "--max-steps-per-epoch",
        "1", "--num-workers", "0", "--directory", str(d)]) == 0
    assert seen["table"].shape == (4, 48)
    assert os.path.getsize(d / "curves.png") > 0
    rows = [json.loads(line) for line in open(d / "metrics.jsonl")]
    assert np.isfinite(rows[0]["train_loss"])
    tx = jopt.make_adamw_optimizer(1e-3)
    state = jloop.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), rng=jax.random.PRNGKey(0),
        model_state={})
    want = float(jloop.make_train_step(
        jm, tx, donate=False, input_norm=NORM,
        teacher_table=seen["table"])(
            state, jnp.asarray(seen["x"]), jnp.asarray(seen["y"]))[1]["loss"])
    assert _rel(seen["loss"], want) <= 1e-5, (seen["loss"], want)


def _tiny_teacher(dim):
    """``TextTeacher`` with a one-layer ``dim``-wide random DistilBERT
    whatever model it is asked for (the CLI has no knob for the size;
    random init still needs ``allow_random_init``)."""
    real = tteacher.TextTeacher

    class Tiny(real):
        def __init__(self, model_name, max_length=64, seed=0,
                     config_overrides=None, allow_random_init=False):
            super().__init__("no-such-model", max_length, seed,
                             {**TINY_BERT, "dim": dim, "hidden_dim": 2 * dim},
                             allow_random_init)

    return Tiny
