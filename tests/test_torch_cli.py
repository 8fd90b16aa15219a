"""PyTorch port, the CLIs and the evaluation driver on the CPU, against
the JAX package.

* ``cli.extract`` on an image tree, then ``cli.search`` in float and int8;
  each package's ``.npz`` index is read by the other's ``cli.search``
  (ids equal where scores differ by more than 1e-5).
* ``cli.evaluate`` on the on-disk Revisited fixture of
  ``tests/test_eval_driver.py``, with the weights of the JAX
  ``_load_model`` init converted through an ``.npz`` checkpoint, gives
  the JAX ``evaluate``'s E/M/H mAP exactly: plain, with alpha-QE, with
  PCA whitening, and on the synthetic fallback with both.
* ``imthumbnail`` (the port's own Lanczos-4) within 1 grey level of the
  JAX one (OpenCV), downscale and upscale.
* ``pca_whiten_learn`` / ``apply_whitening`` / ``alpha_query_expansion``
  within 1e-5 of JAX.
* ``ImageFromList`` (decode, bbox crop, thumbnail, normalization, native
  prescaled decode) against the JAX loader; Adobe-RGB JPEGs recognised.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from research_image_retrieval_tpu.data import transforms as jtransforms
from research_image_retrieval_tpu.evaluation import driver as jdriver
from research_image_retrieval_tpu.index import qe as jqe
from research_image_retrieval_tpu.ops import whiten as jwhiten
from research_image_retrieval_tpu.utils.config import EvalConfig as JaxCfg
from research_image_retrieval_tpu_torch.cli import evaluate as cli_evaluate
from research_image_retrieval_tpu_torch.cli import extract as cli_extract
from research_image_retrieval_tpu_torch.cli import search as cli_search
from research_image_retrieval_tpu_torch.data import transforms
from research_image_retrieval_tpu_torch.index import alpha_query_expansion
from research_image_retrieval_tpu_torch.models import get_model, seeded_init
from research_image_retrieval_tpu_torch.ops import whiten
from test_eval_driver import revisited_dir  # noqa: F401
from test_torch_model import few_torch_threads  # noqa: F401

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    """Two classes of procedural photos (3 renders each, 40-64 px sides)
    as JPEGs and PNGs in nested folders, and a ``.pt`` checkpoint of a
    seeded gem_r50."""
    import cv2

    from research_image_retrieval_tpu_torch.data import (
        SyntheticRetrievalDataset,
    )

    root = tmp_path_factory.mktemp("tree")
    ds = SyntheticRetrievalDataset(num_classes=2, samples_per_class=3,
                                   image_size=64, seed=4, uint8=True)
    for i in range(len(ds)):
        img = ds[i][0][: 64 - 8 * (i % 3)]
        sub = root / "imgs" / f"c{ds.labels[i]}"
        sub.mkdir(parents=True, exist_ok=True)
        ext = ".png" if i % 2 else ".jpg"
        cv2.imwrite(str(sub / f"{i}{ext}"),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    model = get_model("gem_r50", num_classes=8)
    seeded_init(model, seed=1)
    torch.save(model.state_dict(), root / "gem.pt")
    return root


def _extract(root, out, *extra):
    assert cli_extract.main(["--images", str(root / "imgs"), "--checkpoint",
                             str(root / "gem.pt"), "--imsize", "64",
                             "--batch-size", "4", "--output", str(out),
                             *extra, *CPU]) == 0
    return np.load(out)


def _search(gal, qry, out, *extra):
    assert cli_search.main(["--gallery", str(gal), "--queries", str(qry),
                            "--topk", "4", "--output", str(out), *extra,
                            *CPU]) == 0
    with open(out) as f:
        return json.load(f)


def _names(results):
    return [[m["name"] for m in r["matches"]] for r in results]


def _scores(results):
    return np.array([[m["score"] for m in r["matches"]] for r in results])


def _same_where_distinct(a, b, scores, tol=1e-5):
    for row_a, row_b, s in zip(a, b, scores):
        for j in range(len(row_a)):
            near = [abs(s[j] - s[o]) <= tol for o in (j - 1, j + 1)
                    if 0 <= o < len(s)]
            if not any(near):
                assert row_a[j] == row_b[j], (a, b)


def test_cli_extract_search_float_and_int8(image_tree, tmp_path):
    gal = _extract(image_tree, tmp_path / "g.npz", "--multiscale")
    assert gal["vecs"].shape == (6, 2048)
    assert gal["names"][0] == os.path.join("c0", "0.jpg")
    np.testing.assert_allclose(np.linalg.norm(gal["vecs"], axis=1), 1.0,
                               atol=1e-5)
    q8 = _extract(image_tree, tmp_path / "g8.npz", "--multiscale",
                  "--quantize-int8")
    assert q8["vecs_int8"].dtype == np.int8 and q8["scales"].shape == (6,)
    res = _search(tmp_path / "g.npz", tmp_path / "g.npz", tmp_path / "f.json")
    res8 = _search(tmp_path / "g8.npz", tmp_path / "g.npz",
                   tmp_path / "i.json")
    ex = [r["query"] for r in res]
    assert [n[0] for n in _names(res)] == ex  # every image finds itself
    assert [n[0] for n in _names(res8)] == ex
    np.testing.assert_allclose(_scores(res8), _scores(res), atol=2e-2)
    # the host-scale path gives the device path's descriptors
    host = _extract(image_tree, tmp_path / "h.npz", "--multiscale",
                    "--host-scales")
    np.testing.assert_allclose(host["vecs"], gal["vecs"], atol=1e-4)
    # alpha-QE and the approx engine run through the same CLI
    qe = _search(tmp_path / "g8.npz", tmp_path / "g.npz",
                 tmp_path / "q.json", "--alpha-qe", "--qe-k", "2",
                 "--engine", "approx")
    assert len(qe) == 6


def test_npz_index_read_across_packages(image_tree, tmp_path):
    """The port's index through the JAX ``cli.search``, and the JAX
    ``cli.extract`` index through the port's, float and int8."""
    from research_image_retrieval_tpu.cli import extract as jax_extract
    from research_image_retrieval_tpu.cli import search as jax_search

    _extract(image_tree, tmp_path / "p.npz")
    _extract(image_tree, tmp_path / "p8.npz", "--quantize-int8")
    for gal in ("p.npz", "p8.npz"):
        mine = _search(tmp_path / gal, tmp_path / "p.npz", tmp_path / "m.json")
        assert jax_search.main(["--gallery", str(tmp_path / gal),
                                "--queries", str(tmp_path / "p.npz"),
                                "--topk", "4", "--output",
                                str(tmp_path / "j.json")]) == 0
        with open(tmp_path / "j.json") as f:
            theirs = json.load(f)
        np.testing.assert_allclose(_scores(mine), _scores(theirs), atol=1e-5)
        _same_where_distinct(_names(mine), _names(theirs), _scores(mine))

    assert jax_extract.main(["--images", str(image_tree / "imgs"),
                             "--imsize", "64", "--quantize-int8", "--output",
                             str(tmp_path / "j8.npz")]) == 0
    j8 = np.load(tmp_path / "j8.npz")
    np.savez(tmp_path / "jq.npz",
             vecs=j8["vecs_int8"].astype(np.float32) * j8["scales"][:, None],
             names=j8["names"])
    mine = _search(tmp_path / "j8.npz", tmp_path / "jq.npz",
                   tmp_path / "m8.json")
    assert jax_search.main(["--gallery", str(tmp_path / "j8.npz"),
                            "--queries", str(tmp_path / "jq.npz"), "--topk",
                            "4", "--output", str(tmp_path / "j8.json")]) == 0
    with open(tmp_path / "j8.json") as f:
        theirs = json.load(f)
    assert [n[0] for n in _names(mine)] == [r["query"] for r in mine]
    np.testing.assert_allclose(_scores(mine), _scores(theirs), rtol=1e-6)
    _same_where_distinct(_names(mine), _names(theirs), _scores(mine))


@pytest.fixture(scope="module")
def jax_init_npz(tmp_path_factory):
    """The JAX ``_load_model`` init of gem_r50 (8 classes) as an ``.npz``
    of its variables flattened with "/" keys."""
    _, variables = jdriver._load_model(JaxCfg(
        model="gem_r50", model_overrides=dict(num_classes=8)))
    flat = traverse_util.flatten_dict(jnp_to_np(variables), sep="/")
    path = tmp_path_factory.mktemp("ckpt") / "gem_jax.npz"
    np.savez(path, **flat)
    return str(path)


def jnp_to_np(tree):
    return {k: jnp_to_np(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("case", ["plain", "alpha_qe", "pca_whiten",
                                  "synthetic"])
def test_cli_evaluate_equals_jax(revisited_dir, jax_init_npz, tmp_path,  # noqa: F811
                                 case):
    """The same weights and files: the port's ``cli.evaluate`` E/M/H mAP
    equals the JAX ``evaluate``'s exactly.  ``synthetic``: an empty data
    root falls back to the synthetic fixture, with alpha-QE and PCA."""
    flags = {"plain": [], "alpha_qe": ["--alpha-qe", "--qe-k", "3"],
             "pca_whiten": ["--pca-whiten", "--pca-dim", "8",
                            "--pca-shrinkage", "0.5"],
             "synthetic": ["--alpha-qe", "--qe-k", "3", "--pca-whiten",
                           "--pca-dim", "8"]}[case]
    kw = {"plain": {}, "alpha_qe": dict(alpha_qe=True, qe_k=3),
          "pca_whiten": dict(pca_whiten=True, pca_dim=8, pca_shrinkage=0.5),
          "synthetic": dict(alpha_qe=True, qe_k=3, pca_whiten=True,
                            pca_dim=8)}[case]
    root = str(tmp_path) if case == "synthetic" else revisited_dir
    imsize = 32 if case == "synthetic" else 64
    want = jdriver.evaluate(JaxCfg(
        model="gem_r50", model_overrides=dict(num_classes=8),
        datasets=("roxford5k",), data_root=root, imsize=imsize, **kw))
    out = tmp_path / "res.json"
    assert cli_evaluate.main(["--datasets", "roxford5k", "--data-root", root,
                              "--imsize", str(imsize), "--checkpoint",
                              jax_init_npz, "--output", str(out), *flags,
                              *CPU]) == 0
    with open(out) as f:
        got = json.load(f)
    assert tuple(got["roxford5k"]) == tuple(want["roxford5k"])


@pytest.mark.parametrize("shape,side", [((300, 200), 128), ((97, 131), 64),
                                        ((48, 40), 96), ((50, 64), 100),
                                        ((64, 48), 64)])
def test_imthumbnail_within_one_level_of_jax(rng, shape, side):
    img = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    yy, xx = np.meshgrid(np.linspace(0, 1, shape[0]),
                         np.linspace(0, 1, shape[1]), indexing="ij")
    img[..., 0] = (127 + 120 * np.sin(9 * xx * yy)).astype(np.uint8)
    got = transforms.imthumbnail(img, side)
    want = jtransforms.imthumbnail(img, side)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_whitening_and_qe_match_jax(rng):
    X = rng.standard_normal((60, 24)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    m, P = whiten.pca_whiten_learn(X, s=0.7)
    wm, wP = jwhiten.pca_whiten_learn(X, s=0.7)
    np.testing.assert_array_equal(m, wm)
    np.testing.assert_array_equal(P, wP)
    for dim in (None, 10):
        got = whiten.apply_whitening(torch.from_numpy(X[:7]), m, P,
                                     out_dim=dim).numpy()
        want = np.asarray(jwhiten.apply_whitening(jnp.asarray(X[:7]), wm, wP,
                                                  out_dim=dim))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    q, g = X[:5], X[5:]
    for k, alpha in ((3, 3.0), (10, 0.0), (100, 1.0)):
        got = alpha_query_expansion(torch.from_numpy(q), torch.from_numpy(g),
                                    k=k, alpha=alpha).numpy()
        want = np.asarray(jqe.alpha_query_expansion(q, g, k=k, alpha=alpha))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fast_decode", [False, True])
@pytest.mark.parametrize("raw_uint8", [False, True])
def test_image_from_list_matches_jax(image_tree, fast_decode, raw_uint8):
    """The loader's decode, bbox crop, thumbnail and normalization equal
    the JAX ``ImageFromList``'s (within 1 grey level, the thumbnail's
    bar; normalized floats within 1 level / std)."""
    from research_image_retrieval_tpu.data.eval_loader import (
        ImageFromList as JaxList,
    )
    from research_image_retrieval_tpu_torch.data import ImageFromList

    paths = sorted(str(p) for p in (image_tree / "imgs").rglob("*.*"))
    bbxs = [None, (3, 5, 40, 33)] * (len(paths) // 2)
    kw = dict(imsize=48, bbxs=bbxs, raw_uint8=raw_uint8,
              fast_decode=fast_decode)
    got, want = list(ImageFromList(paths, **kw)), list(JaxList(paths, **kw))
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        tol = 1 if raw_uint8 else 1 / 255 / 0.224
        assert np.abs(g.astype(np.float64) - w).max() <= tol + 1e-6


def test_adobe_rgb_jpegs_are_recognised(rng):
    """A 3-component JPEG whose Adobe APP14 marker says "no transform" is
    recognised (and so never handed to the native library); an ordinary
    YCbCr JPEG is not; both decode."""
    import cv2

    from research_image_retrieval_tpu_torch.data.native_decode import (
        decode_image,
        is_adobe_rgb,
    )

    img = rng.integers(0, 255, (24, 32, 3), dtype=np.uint8)
    ok, buf = cv2.imencode(".jpg", img)
    plain = buf.tobytes()
    app14 = (b"\xff\xee\x00\x0e" + b"Adobe" + b"\x00\x64\x00\x00\x00\x00"
             + b"\x00")  # version 100, flags 0, transform 0
    adobe = plain[:2] + app14 + plain[2:]
    assert not is_adobe_rgb(plain) and is_adobe_rgb(adobe)
    assert not is_adobe_rgb(adobe[:2] + app14[:-1] + b"\x01" + plain[2:])
    for data in (plain, adobe):
        assert decode_image(data, max_side=16).shape[2] == 3
