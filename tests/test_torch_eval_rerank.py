"""PyTorch port, the remaining evaluation and extraction entry points on
the CPU, against the JAX package:

* ``IterativeQueryExpansion`` on the JAX module's params (converted by
  ``iqe_from_flax``): scores to 1e-5, ranks equal where the final scores
  differ by more than 1e-6.
* ``superglobal_rerank`` against the JAX numpy function: scores to 1e-5,
  ids equal where scores differ by more than 1e-6.
* ``evaluate`` on the on-disk Revisited fixture of
  ``tests/test_eval_driver.py`` with IQE (the JAX random init's params
  passed as an ``.npz`` checkpoint) and SuperGlobal, on the JAX init's
  weights: E/M/H mAP equal to the JAX ``evaluate``'s exactly; without a
  checkpoint the port warns that the MLP is untrained.
* ``cli.extract --records`` against the JAX CLI on a small ``.rirrec``:
  the same ``.npz`` keys, names and labels, vectors within 1e-5.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from research_image_retrieval_tpu.cli import extract as jax_cli_extract
from research_image_retrieval_tpu.evaluation import driver as jdriver
from research_image_retrieval_tpu.index import qe as jqe
from research_image_retrieval_tpu.index import superglobal as jsg
from research_image_retrieval_tpu.models import get_model as jax_get_model
from research_image_retrieval_tpu.utils.config import EvalConfig as JaxCfg
from research_image_retrieval_tpu_torch.cli import evaluate as cli_evaluate
from research_image_retrieval_tpu_torch.cli import extract as cli_extract
from research_image_retrieval_tpu_torch.data import write_records
from research_image_retrieval_tpu_torch.evaluation.driver import evaluate
from research_image_retrieval_tpu_torch.index import (
    IterativeQueryExpansion,
    iqe_from_flax,
    superglobal_rerank,
)
from research_image_retrieval_tpu_torch.utils.config import EvalConfig
from test_eval_driver import revisited_dir  # noqa: F401
from test_torch_cli import _same_where_distinct, jnp_to_np
from test_torch_model import few_torch_threads  # noqa: F401

T = torch.from_numpy


def _unit(rng, n, d):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _save_flat(path, variables):
    np.savez(path, **traverse_util.flatten_dict(jnp_to_np(variables),
                                                sep="/"))
    return str(path)


def test_iqe_matches_jax(rng):
    q, db = _unit(rng, 4, 16), _unit(rng, 30, 16)
    jm = jqe.IterativeQueryExpansion(embed_dim=16, top_k=3,
                                     max_iterations=2, gamma=0.6)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(q[:1]),
                        jnp.asarray(db[:2]))
    want = jm.apply(variables, jnp.asarray(q), jnp.asarray(db))
    port = IterativeQueryExpansion(16, top_k=3, max_iterations=2, gamma=0.6)
    port.load_state_dict(iqe_from_flax(jnp_to_np(variables)))
    with torch.no_grad():
        got = port(T(q), T(db))
    for key in ("expanded_query", "initial_scores", "expanded_scores",
                "final_scores"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    final = np.asarray(want["final_scores"])
    order_j = np.argsort(-final, axis=1, kind="stable")
    order_t = torch.argsort(-got["final_scores"], dim=1,
                            stable=True).numpy()
    _same_where_distinct(order_t, order_j,
                         np.take_along_axis(final, order_j, 1), tol=1e-6)


def test_superglobal_matches_jax(rng):
    q, g = _unit(rng, 3, 16), _unit(rng, 40, 16)
    sims = q @ g.T
    idx = np.argsort(-sims, axis=1)[:, :20]
    s = np.take_along_axis(sims, idx, 1)
    want_s, want_i = jsg.superglobal_rerank(q, g, s, idx)
    got_s, got_i = superglobal_rerank(q, g, s, idx, device="cpu")
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-5)
    _same_where_distinct(got_i, want_i, want_s, tol=1e-6)
    assert got_i.dtype == idx.dtype


@pytest.fixture(scope="module")
def r18_weights(tmp_path_factory):
    """The JAX ``_load_model`` init of gem_r50 on resnet18 (32-d, 8
    classes) as an ``.npz``, and its overrides."""
    overrides = dict(backbone_name="resnet18", outputdim=32, num_classes=8)
    jm = jax_get_model("gem_r50", **overrides)
    # _load_model's init (key 0, one 64 px image), jitted: its eager form
    # takes ~15 s here
    variables = jax.jit(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        labels=jnp.zeros((1,), jnp.int32), train=False))()
    path = tmp_path_factory.mktemp("ck") / "r18.npz"
    return _save_flat(path, variables), overrides


def test_evaluate_iqe_superglobal_equals_jax(revisited_dir, r18_weights,  # noqa: F811
                                             tmp_path, capsys):
    """The JAX pipeline with random-init IQE (flax's PRNGKey(0) draw, the
    only init both sides can share) and SuperGlobal over a 5-long
    shortlist: the port, given those IQE params as a checkpoint, gives
    the same E/M/H mAP.  Without the checkpoint it warns."""
    ckpt, overrides = r18_weights
    kw = dict(datasets=("roxford5k",), data_root=revisited_dir, imsize=64,
              iqe=True, iqe_k=3, superglobal=True, sg_m=5)
    want = jdriver.evaluate(JaxCfg(model="gem_r50", model_overrides=overrides,
                                   **kw))
    iqe = jqe.IterativeQueryExpansion(embed_dim=32).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32)), jnp.zeros((2, 32)))
    iqe_npz = _save_flat(tmp_path / "iqe.npz", iqe)
    capsys.readouterr()
    got = evaluate(EvalConfig(model="gem_r50", model_overrides=overrides,
                              checkpoint=ckpt, iqe_checkpoint=iqe_npz, **kw),
                   device="cpu")
    assert tuple(got["roxford5k"]) == tuple(want["roxford5k"])
    assert "IQE checkpoint" in capsys.readouterr().out
    got = evaluate(EvalConfig(model="gem_r50", model_overrides=overrides,
                              checkpoint=ckpt, **kw), device="cpu")
    assert "RANDOM init" in capsys.readouterr().out
    assert all(0.0 <= v <= 100.0 for v in got["roxford5k"])


def test_evaluate_cli_rerank_flags():
    args = cli_evaluate.build_parser().parse_args(
        ["--iqe", "--iqe-k", "4", "--iqe-iterations", "3", "--iqe-gamma",
         "0.5", "--iqe-checkpoint", "q.npz", "--superglobal", "--sg-m", "7"])
    assert (args.iqe, args.iqe_k, args.iqe_iterations, args.iqe_gamma,
            args.iqe_checkpoint, args.superglobal, args.sg_m) == \
        (True, 4, 3, 0.5, "q.npz", True, 7)


def _jpeg(rng, h, w) -> bytes:
    from PIL import Image

    img = Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8),
                          "RGB")
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=90)
    return buf.getvalue()


def test_extract_records_equals_jax_cli(tmp_path, rng, monkeypatch):
    """Both CLIs over one record file with the same weights (the JAX
    CLI's ``_load_model`` init, kept and given to the port as an
    ``.npz``; an 8-way classifier, which extraction does not read):
    thumbnail to 40 px, raw uint8 to the device, ms1."""
    rec = tmp_path / "g.rirrec"
    write_records(str(rec), [(_jpeg(rng, 48 + 8 * (i % 2), 56), i % 3)
                             for i in range(5)])
    kept = []
    real_load = jdriver._load_model
    monkeypatch.setattr(jdriver, "_load_model", lambda cfg, num_classes=0:
                        kept.append(real_load(cfg, num_classes=8)) or kept[0])
    common = ["--model", "gem_r50", "--records", str(rec), "--imsize", "40",
              "--batch-size", "4"]
    assert jax_cli_extract.main([*common, "--output",
                                 str(tmp_path / "j.npz")]) == 0
    ckpt = _save_flat(tmp_path / "w.npz", kept[0][1])
    assert cli_extract.main([*common, "--checkpoint", ckpt, "--output",
                             str(tmp_path / "t.npz"), "--device", "cpu"]) == 0
    want, got = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(got.files) == sorted(want.files) == ["labels", "names",
                                                       "vecs"]
    assert got["names"].tolist() == want["names"].tolist()
    assert got["labels"].tolist() == want["labels"].tolist() == [0, 1, 2,
                                                                 0, 1]
    np.testing.assert_allclose(got["vecs"], want["vecs"], atol=1e-5)
