"""PyTorch port, DELG's local-feature geometric rerank on the CPU against
the JAX package:

* ``geometric_verification_batch`` on consistent-geometry (affine with
  outliers), translated, random-geometry and integer-grid pairs, and on
  pairs with few mutual matches, where many hypotheses pick a match twice
  (singular systems), over chunks with a padded tail: inlier counts
  equal to JAX's; ``geometric_verification_score`` equal;
* the 3x3 solve against numpy, and its singular flag;
* ``rerank_shortlist`` and ``rerank_shortlist_batched`` equal;
* ``evaluate`` with ``--local-rerank`` (through ``cli.evaluate``) on the
  on-disk Revisited fixture of ``tests/test_eval_driver.py`` with a
  resnet18 delg_r50 on the JAX model's seeded variables: the same ranks
  after the rerank and the same E/M/H mAP as the JAX driver (host scales:
  with device scales the JAX driver feeds the rerank un-normalized 0-255
  images, which the port does not copy; its square images are the same
  either way).
"""

import dataclasses
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from flax import traverse_util

from research_image_retrieval_tpu.data import ImageFromList as JImageFromList
from research_image_retrieval_tpu.evaluation import driver as jdriver
from research_image_retrieval_tpu.index import rerank as jrerank
from research_image_retrieval_tpu.models import get_model as jax_get_model
from research_image_retrieval_tpu.utils.config import EvalConfig as JaxCfg
from research_image_retrieval_tpu_torch.cli import evaluate as cli_evaluate
from research_image_retrieval_tpu_torch.data import ImageFromList
from research_image_retrieval_tpu_torch.evaluation import driver as tdriver
from research_image_retrieval_tpu_torch.index import rerank as trerank
from research_image_retrieval_tpu_torch.models import MODEL_REGISTRY, get_model
from research_image_retrieval_tpu_torch.utils.config import EvalConfig
from test_eval_driver import revisited_dir  # noqa: F401
from test_torch_bf16 import _fill_variables
from test_torch_cli import jnp_to_np
from test_torch_model import few_torch_threads  # noqa: F401


def _unit(rng, n, d):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _pairs(seed=17, L=32, D=16):
    """40 pairs of [L, D] descriptors at [L, 2] coordinates, 8 of each
    kind: an affine map with 6 outliers, a translation, random geometry,
    a translation on an integer grid with 10 outliers, and a translation
    where only 6 descriptors match (the rest of the gallery side is one
    repeated fresh vector, which matches mutually at most once): with
    ~6 mutual matches, ~45% of the 200 sampled triples repeat a match,
    and those systems are singular."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(40):
        kind = i % 5
        grid = kind == 3
        desc = _unit(rng, L, D)
        ca = (rng.integers(0, 13, (L, 2)) if grid
              else rng.uniform(0, 13, (L, 2))).astype(np.float32)
        gdesc = desc.copy()
        if kind == 2:
            cb = rng.uniform(0, 13, (L, 2)).astype(np.float32)
        else:
            M, t = ((np.array([[1.1, 0.2], [-0.1, 0.9]]), np.array([3., 1.]))
                    if kind == 0 else (np.eye(2), np.array(
                        [[3., 3.], [0., 0.], [0., 0.], [2., 0.], [1., 2.]][
                            kind])))
            cb = (ca @ M.T + t).astype(np.float32)
            outliers = {0: 6, 3: 10}.get(kind, 0)
            cb[:outliers] = rng.uniform(0, 13, (outliers, 2))
        if kind == 4:
            gdesc[6:] = _unit(rng, 1, D)
        out.append((desc, ca, gdesc, cb))
    return [np.stack([p[j] for p in out]) for j in range(4)]


def test_geometric_verification_batch_equals_jax():
    qd, qxy, gd, gxy = _pairs()
    want = jrerank.geometric_verification_batch(qd, qxy, gd, gxy, chunk=16)
    got = trerank.geometric_verification_batch(qd, qxy, gd, gxy, chunk=16,
                                               device="cpu")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    kinds = got.reshape(8, 5)
    assert (kinds[:, 1] == 32).all()  # a translation keeps every match
    assert (kinds[:, 0] >= 26).all() and (kinds[:, 2] <= 12).all()
    few = trerank.mutual_nn_matches(qd[4], gd[4])[0]
    assert 4 <= len(few) <= 8  # few matches: duplicate picks are common
    for i in (0, 1, 2, 4):  # the per-pair host verifier (numpy, seed 0)
        assert trerank.geometric_verification_score(
            qd[i], qxy[i], gd[i], gxy[i]) == \
            jrerank.geometric_verification_score(qd[i], qxy[i], gd[i],
                                                 gxy[i])


def test_solve3x3_matches_numpy_and_flags_singular():
    rng = np.random.default_rng(3)
    A = rng.uniform(0, 13, (500, 3, 3)).astype(np.float32)
    A[..., 2] = 1.0
    B = rng.uniform(0, 13, (500, 3, 2)).astype(np.float32)
    X, singular = trerank._solve3x3(torch.from_numpy(A), torch.from_numpy(B))
    want = np.linalg.solve(A.astype(np.float64), B.astype(np.float64))
    ok = np.linalg.cond(A.astype(np.float64)) < 1e3
    assert ok.sum() > 400 and not singular.any()
    np.testing.assert_allclose(X.numpy()[ok], want[ok], rtol=1e-3, atol=1e-3)
    dup = np.array([[[1, 2, 1], [1, 2, 1], [3, 4, 1]],
                    [[0, 5, 1], [0, 7, 1], [0, 1, 1]]], np.float32)
    _, singular = trerank._solve3x3(torch.from_numpy(dup),
                                    torch.ones(2, 3, 2))
    assert singular.all()


def test_rerank_shortlist_equals_jax():
    rng = np.random.default_rng(0)
    Q, N, k = 3, 12, 5
    scores = -np.sort(-rng.uniform(0, 1, (Q, k)).astype(np.float32))
    indices = np.stack([rng.choice(N, k, replace=False) for _ in range(Q)])
    table = rng.uniform(0, 1, (Q, N)).astype(np.float32)
    table[0, indices[0, :2]] = 0.25  # a tie: the stable order decides
    for blend in (0.4, 1.0):
        want = jrerank.rerank_shortlist(scores, indices,
                                        lambda q, g: table[q, g], blend)
        got = trerank.rerank_shortlist(scores, indices,
                                       lambda q, g: table[q, g], blend)
        got_b = trerank.rerank_shortlist_batched(
            scores, indices, lambda qs, gs: table[qs, gs], blend)
        for g in (got, got_b):
            np.testing.assert_array_equal(g[0], want[0])
            np.testing.assert_array_equal(g[1], want[1])


def test_square_images_normalize_raw_items(revisited_dir):  # noqa: F811
    """The rerank's square batch is the same from raw uint8 items (device
    scales) as from the loader's normalized float items."""
    import os

    jpg = os.path.join(revisited_dir, "roxford5k", "jpg")
    paths = sorted(os.path.join(jpg, f) for f in os.listdir(jpg))[:3]
    raw = tdriver._square_images(ImageFromList(paths, 64, raw_uint8=True),
                                 range(3), 56)
    flt = tdriver._square_images(ImageFromList(paths, 64), range(3), 56)
    np.testing.assert_array_equal(raw, flt)
    want = jdriver._square_images(JImageFromList(paths, 64), range(3), 56)
    np.testing.assert_allclose(flt, want, atol=1e-5, rtol=0)


def test_local_rerank_needs_extract_local():
    model = get_model("gem_r50", backbone_name="resnet18", outputdim=8,
                      num_classes=4).eval()
    v = np.eye(3, 8, dtype=np.float32)
    with pytest.raises(ValueError, match="extract_local"):
        tdriver._local_rerank_ranks(model, v, v, None, None, None,
                                    EvalConfig(model="gem_r50"), "cpu")
    args = cli_evaluate.build_parser().parse_args(
        ["--model", "delg_r50", "--local-rerank", "--lr-top-attn", "16",
         "--rerank-k", "7", "--rerank-blend", "0.3", "--rerank-imsize", "96"])
    assert (args.local_rerank, args.lr_top_attn, args.rerank_k,
            args.rerank_blend, args.rerank_imsize) == (True, 16, 7, 0.3, 96)


def _recording(module, monkeypatch, name, into):
    real = getattr(module, name)

    def wrapped(*args, **kw):
        out = real(*args, **kw)
        into.append((args, out))
        return out

    monkeypatch.setattr(module, name, wrapped)


def test_evaluate_local_rerank_equals_jax(revisited_dir, tmp_path,  # noqa: F811
                                          monkeypatch):
    """The JAX driver and ``cli.evaluate --local-rerank`` on the same
    seeded resnet18 delg_r50 (its flax variables passed to the port as an
    ``.npz``), 64 px, host scales, the default rerank (top 20 of the 12
    gallery images, 224 px locals: a 7 x 7 grid, all 49 kept): equal
    ranks after the rerank, which moved some query's order, and equal
    E/M/H mAP."""
    overrides = dict(backbone_name="resnet18", num_classes=8)
    jm = jax_get_model("delg_r50", **overrides)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        labels=jnp.zeros((1,), jnp.int32), train=False))
    variables = _fill_variables(shapes, 5)
    monkeypatch.setattr(jdriver, "_load_model",
                        lambda cfg, num_classes=0: (jm, variables))
    ckpt = tmp_path / "delg.npz"
    np.savez(ckpt, **traverse_util.flatten_dict(jnp_to_np(variables),
                                                sep="/"))
    # the CLI builds the registry's delg_r50: make its backbone resnet18
    entry = MODEL_REGISTRY["delg_r50"]
    monkeypatch.setitem(MODEL_REGISTRY, "delg_r50", dataclasses.replace(
        entry, defaults={**entry.defaults, "backbone_name": "resnet18"}))
    jranks, tranks, treranks = [], [], []
    _recording(jdriver, monkeypatch, "compute_map_and_print", jranks)
    _recording(tdriver, monkeypatch, "compute_map_and_print", tranks)
    _recording(tdriver, monkeypatch, "_local_rerank_ranks", treranks)
    kw = dict(datasets=("roxford5k",), data_root=revisited_dir, imsize=64,
              device_scales=False, local_rerank=True)
    want = jdriver.evaluate(JaxCfg(model="delg_r50", model_overrides=overrides,
                                   **kw))
    out = tmp_path / "res.json"
    assert cli_evaluate.main([
        "--model", "delg_r50", "--datasets", "roxford5k", "--data-root",
        revisited_dir, "--imsize", "64", "--host-scales", "--checkpoint",
        str(ckpt), "--local-rerank", "--device", "cpu",
        "--output", str(out)]) == 0
    got = json.loads(out.read_text())["roxford5k"]
    np.testing.assert_array_equal(tranks[0][0][3], jranks[0][0][3])
    assert tuple(got) == tuple(want["roxford5k"])
    before, after = treranks[0][0][3], treranks[0][1]
    assert (before != after).any()  # the rerank reordered a shortlist
