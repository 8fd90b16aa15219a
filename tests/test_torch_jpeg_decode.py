"""PyTorch port, the split JPEG decode on the CPU, against the JAX package.

* The host half: the port's own entropy decoder
  (``csrc/jpeg_coeffs.cc``, no libjpeg) gives the JAX package's
  libjpeg coefficients, quantization tables, dims and subsampling code
  bit for bit, for files that ``cv2.imencode`` writes from seeded numpy
  images: baseline and progressive, 4:2:0, 4:4:4 and grey, odd sizes, a
  restart interval, quality 50 and 95.
* Its refusals: Cb and Cr on different quantization tables (an SOF table
  id rewritten), Adobe RGB, arithmetic coding (SOF0 rewritten to SOF9)
  and truncated data.  JAX returns coefficients for all four; the port
  returns None and the item takes the RGB path, in ``extract_vectors``
  equal to the RGB loader's descriptor.
* The device half: ``dct_decode_rgb`` against JAX's at every
  ``out_block`` in {8, 4, 2} on both layouts (1e-3 on 0..255), and at
  k = 8 within JAX's own bars of libjpeg's full decode.
* ``extract_vectors(dct_decode=True)`` against JAX's on the same files
  and bridged seeded weights (GeM on resnet18): scales (1,) and (1, 0.5),
  a mixed batch with a boxed RGB item and a PNG, and an oversized source
  that prescales in the DCT domain (1e-4).
* ``cli.evaluate --dct-decode 4 --device cpu`` on a tiny on-disk
  Revisited layout: the JAX ``evaluate``'s mAP.
* ``JpegCoeffs.decoded_hw``: libjpeg's ceiling where JAX rounds.
* The rank-sharded form (``mesh=``) on a gloo world of one.
"""

import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from research_image_retrieval_tpu.data import ImageFromList as JaxList
from research_image_retrieval_tpu.data import native_decode as jnd
from research_image_retrieval_tpu.evaluation import driver as jdriver
from research_image_retrieval_tpu.index import extract as jax_extract
from research_image_retrieval_tpu.models import get_model as jax_get_model
from research_image_retrieval_tpu.ops import jpeg_decode as jjd
from research_image_retrieval_tpu.utils.config import EvalConfig as JaxCfg
from research_image_retrieval_tpu_torch.cli import evaluate as cli_evaluate
from research_image_retrieval_tpu_torch.data import ImageFromList
from research_image_retrieval_tpu_torch.data import native_decode as nd
from research_image_retrieval_tpu_torch.index import extract_vectors
from research_image_retrieval_tpu_torch.models import (
    from_jax_variables,
    get_model,
)
from research_image_retrieval_tpu_torch.ops import jpeg_decode as jd
from test_eval_driver import revisited_dir  # noqa: F401
from test_torch_cli import jax_init_npz  # noqa: F401
from test_torch_model import few_torch_threads  # noqa: F401

NORM = (np.array([0.485, 0.456, 0.406], np.float32),
        np.array([0.229, 0.224, 0.225], np.float32))
S420 = cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420
S444 = cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444


def _image(h, w, seed=0):
    """A seeded structured RGB uint8 image (smooth waves plus noise)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(xx / 17.0) * np.cos(yy / 23.0),
                    128 + 90 * np.cos(xx / 11.0),
                    128 + 80 * np.sin((xx + yy) / 29.0)], -1)
    return np.clip(img + rng.normal(0, 8, img.shape), 0,
                   255).astype(np.uint8)


def _jpeg(img, quality=90, sampling=S420, progressive=False, restart=0):
    flags = [cv2.IMWRITE_JPEG_QUALITY, quality,
             cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
             cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if img.ndim == 3:
        flags += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
        img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    ok, enc = cv2.imencode(".jpg", img, flags)
    assert ok
    return enc.tobytes()


# (h, w, grey, quality, sampling, progressive, restart interval)
FILES = {
    "420": (64, 96, False, 90, S420, False, 0),
    "444": (64, 96, False, 90, S444, False, 0),
    "grey": (64, 96, True, 90, None, False, 0),
    "odd": (61, 93, False, 90, S420, False, 0),
    "odd-444": (37, 59, False, 90, S444, False, 0),
    "odd-grey": (37, 59, True, 90, None, False, 0),
    "restart": (61, 93, False, 90, S420, False, 2),
    "q50": (64, 96, False, 50, S420, False, 0),
    "q95": (64, 96, False, 95, S420, False, 0),
    "progressive": (61, 93, False, 90, S420, True, 0),
    "progressive-444": (64, 96, False, 95, S444, True, 0),
    "progressive-grey": (37, 59, True, 50, None, True, 0),
    "progressive-restart": (61, 93, False, 90, S420, True, 3),
}


def _file(name, seed=0):
    h, w, grey, q, samp, prog, rst = FILES[name]
    img = _image(h, w, seed)
    return _jpeg(img[..., 0] if grey else img, q, samp, prog, rst)


@pytest.mark.parametrize("name", list(FILES))
def test_coefficients_bit_equal_to_jax(name):
    """The port's coefficients, tables, dims and layout code equal the
    JAX package's (libjpeg's ``jpeg_read_coefficients``) bit for bit, at
    k = 8 and k = 4."""
    data = _file(name)
    assert data[:2] == b"\xff\xd8"
    for k in (8, 4):
        want = jnd.decode_jpeg_coeffs(data, k=k)
        got = nd.decode_jpeg_coeffs(data, k=k)
        assert want is not None and got is not None
        for f in ("coef_y", "coef_c", "quant_y", "quant_c"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f"{name} k={k} {f}")
        for f in ("h", "w", "subsamp", "k"):
            assert getattr(got, f) == getattr(want, f), f
        assert got.nbytes == want.nbytes


def _refused(case: str, data: bytes) -> bytes:
    if case == "cb-cr-tables":  # Cr on table 0 (luma's), Cb on table 1
        out = bytearray(data)
        i = data.index(b"\xff\xc0")
        assert out[i + 9] == 3 and out[i + 18] == 1
        out[i + 18] = 0
        return bytes(out)
    if case == "adobe-rgb":  # APP14 "Adobe", transform 0
        return (data[:2] + b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00"
                b"\x00" + data[2:])
    if case == "arithmetic":  # SOF0 -> SOF9
        out = bytearray(data)
        out[data.index(b"\xff\xc0") + 1] = 0xC9
        return bytes(out)
    return data[:-200]  # truncated


REFUSALS = ["cb-cr-tables", "adobe-rgb", "arithmetic", "truncated"]


@pytest.mark.parametrize("case", REFUSALS)
def test_refused_files_take_the_rgb_path(case, tmp_path):
    """JAX's libjpeg hands back coefficients for each of these; the port
    refuses them (None), and the split-decode loader yields the RGB path's
    item: ``extract_vectors(dct_decode=True)`` over it equals the RGB
    loader's extraction exactly, beside a coefficient item.  The
    truncated file has no RGB decode either: both loaders raise the same
    error."""
    good = _jpeg(_image(64, 80, seed=1))
    data = _refused(case, _jpeg(_image(64, 80, seed=2)))
    assert jnd.decode_jpeg_coeffs(data, k=4) is not None
    assert nd.decode_jpeg_coeffs(data, k=4) is None
    paths = []
    for i, d in enumerate((good, data)):
        paths.append(str(tmp_path / f"{i}.jpg"))
        with open(paths[-1], "wb") as f:
            f.write(d)
    rgb = ImageFromList(paths, imsize=64, raw_uint8=True)
    dct = ImageFromList(paths, imsize=64, raw_uint8=True, dct_coeffs=4)
    assert isinstance(dct[0], nd.JpegCoeffs)
    if case == "truncated":
        with pytest.raises(Exception) as want:
            rgb[1]
        with pytest.raises(want.type):
            dct[1]
        return
    assert isinstance(dct[1], np.ndarray)
    np.testing.assert_array_equal(dct[1], rgb[1])
    torch.manual_seed(0)
    model = get_model("gem_r50", backbone_name="resnet18", outputdim=16,
                      num_classes=4).eval()
    fn = lambda x, v: model.extract(x, v)  # noqa: E731
    kw = dict(scales=(1.0, 0.5), bucket=32, batch_size=2, device_scales=True,
              input_norm=NORM, device="cpu")
    got = extract_vectors(fn, dct, dct_decode=True, **kw)
    want = extract_vectors(fn, rgb, **kw)
    np.testing.assert_array_equal(got[1], want[1])
    assert np.isfinite(got).all() and float(got[0] @ want[0]) > 0.99


def _coeffs_batch(data: bytes, k: int):
    co = nd.decode_jpeg_coeffs(data, k=k)
    return co, (co.coef_y[None], co.coef_c[None], co.quant_y[None],
                co.quant_c[None])


@pytest.mark.parametrize("out_block", [8, 4, 2])
@pytest.mark.parametrize("layout", ["420", "444"])
def test_dct_decode_rgb_matches_jax(layout, out_block):
    """``dct_decode_rgb`` at ``out_block`` against JAX's on the same
    coefficients, within 1e-3 on 0..255 (k = 8 and k = 4)."""
    data = _file("odd" if layout == "420" else "odd-444", seed=3)
    for k in (8, 4):
        co, arrays = _coeffs_batch(data, k)
        want = np.asarray(jax.jit(
            jjd.dct_decode_rgb, static_argnums=(4, 5))(
                *(jnp.asarray(a) for a in arrays), co.subsamp, out_block))
        got = jd.dct_decode_rgb(*(torch.from_numpy(a) for a in arrays),
                                co.subsamp, out_block).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


@pytest.mark.parametrize("name", ["420", "444", "grey"])
def test_k8_decode_within_libjpeg_bars(name):
    """At k = 8 the port's whole split decode is within JAX's bars of
    OpenCV's full decode of the same bytes (max < 6, mean < 1 on
    0..255)."""
    data = _file(name, seed=4)
    co, arrays = _coeffs_batch(data, 8)
    dec = jd.dct_decode_rgb(*(torch.from_numpy(a) for a in arrays),
                            co.subsamp, 8).numpy()[0, :co.h, :co.w]
    ref = nd.host_decode(data).astype(np.float32)
    assert np.abs(dec - ref).max() < 6.0
    assert np.abs(dec - ref).mean() < 1.0


def test_decoded_hw_takes_libjpeg_ceiling():
    """At ``out_block`` 2 a 90 x 93 source decodes to libjpeg's
    ``ceil(h * 2 / 8)`` rows (23 x 24: a 2-pixel block's partial last
    row is valid pixels); the JAX package rounds (22 x 23)."""
    data = _jpeg(_image(90, 93, seed=5))
    got, want = nd.decode_jpeg_coeffs(data, k=4), jnd.decode_jpeg_coeffs(
        data, k=4)
    got.out_block = want.out_block = 2
    assert got.decoded_hw == (23, 24)
    assert want.decoded_hw == (22, 23)


def test_extract_dct_over_a_mesh(mixed_files, r18):
    """``extract_vectors(dct_decode=True, mesh=...)`` on a gloo world of
    one gives the descriptors of the plain call bit for bit."""
    import socket

    from research_image_retrieval_tpu_torch.parallel import (
        init_distributed_mode,
        make_mesh,
    )

    paths, bbxs = mixed_files
    port = r18[2]
    loader = ImageFromList(paths, imsize=96, bbxs=bbxs, raw_uint8=True,
                           dct_coeffs=4)
    kw = dict(scales=(1.0, 0.5), bucket=32, batch_size=2,
              device_scales=True, input_norm=NORM, dct_decode=True,
              device="cpu")
    fn = lambda x, v: port.extract(x, v)  # noqa: E731
    want = extract_vectors(fn, loader, **kw)
    with socket.socket() as s:
        s.bind(("", 0))
        addr = f"localhost:{s.getsockname()[1]}"
    init_distributed_mode(addr, device="cpu", force=True,
                          quiet_non_main=False)
    try:
        got = extract_vectors(fn, loader, mesh=make_mesh(1, 1), **kw)
    finally:
        torch.distributed.destroy_process_group()
    np.testing.assert_array_equal(got, want)


def _bridged_r18(seed=0):
    """(JAX gem_r50 on resnet18, seeded variables, the port's model from
    them): weights N(0, 1/fan_in), random BN affine and statistics."""
    kw = dict(backbone_name="resnet18", outputdim=32, num_classes=4)
    jm = jax_get_model("gem_r50", **kw)
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                        labels=jnp.zeros((1,), jnp.int32), train=False))
    rng = np.random.default_rng(seed)

    def fill(path, a):
        v = rng.standard_normal(a.shape)
        name = path[-1].key
        if name == "var":
            v = np.abs(v) + 0.5
        elif name == "scale":
            v = 1.0 + 0.1 * v
        elif len(a.shape) > 1:
            v = v / np.sqrt(np.prod(a.shape[:-1]))
        else:
            v = 0.1 * v
        return v.astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, dict(shapes))
    port = get_model("gem_r50", **kw)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return jm, variables, port.eval()


@pytest.fixture(scope="module")
def mixed_files(tmp_path_factory):
    """A mixed gallery: 4:2:0, 4:4:4 and progressive JPEGs of about the
    same size, a grey JPEG, a boxed JPEG (RGB path), a PNG (RGB path)
    and a 400 x 520 source that prescales to ``out_block`` 2 at 96 px."""
    root = tmp_path_factory.mktemp("mixed")
    files = [("a.jpg", _jpeg(_image(80, 96, 10))),
             ("b.jpg", _jpeg(_image(96, 72, 11), sampling=S444)),
             ("c.jpg", _jpeg(_image(88, 96, 12), progressive=True)),
             ("d.jpg", _jpeg(_image(96, 80, 13)[..., 0])),
             ("e.jpg", _jpeg(_image(96, 96, 14))),
             ("big.jpg", _jpeg(_image(400, 520, 16)))]
    paths = []
    for name, data in files:
        paths.append(str(root / name))
        with open(paths[-1], "wb") as f:
            f.write(data)
    paths.insert(5, str(root / "f.png"))
    cv2.imwrite(paths[5], _image(72, 96, 15))
    bbxs = [None, None, None, None, (8, 4, 90, 80), None, None]
    return paths, bbxs


@pytest.fixture(scope="module")
def r18():
    return _bridged_r18()


@pytest.mark.parametrize("scales", [(1.0,), (1.0, 0.5)])
def test_extract_dct_matches_jax(mixed_files, r18, scales):
    """``extract_vectors(dct_decode=True)`` over the mixed gallery at 96
    px against JAX's on the same files and weights (1e-4): the boxed
    item and the PNG take the RGB buckets, the 520 px source ships
    ``out_block`` 2 coefficients."""
    paths, bbxs = mixed_files
    jm, variables, port = r18
    loader = ImageFromList(paths, imsize=96, bbxs=bbxs, raw_uint8=True,
                           dct_coeffs=4)
    kinds = [type(loader[i]).__name__ for i in range(len(paths))]
    assert kinds == ["JpegCoeffs"] * 4 + ["ndarray"] * 2 + ["JpegCoeffs"]
    big = loader[6]
    assert big.out_block == 2 and big.target_hw == (74, 96)
    assert big.decoded_hw == (100, 130)  # exact: ceiling == round here
    kw = dict(scales=scales, bucket=32, batch_size=2, device_scales=True,
              input_norm=NORM, dct_decode=True)
    jfn = jax.jit(lambda x, v: jm.apply(variables, x, v, method="extract"))
    want = jax_extract.extract_vectors(
        jfn, JaxList(paths, imsize=96, bbxs=bbxs, raw_uint8=True,
                     dct_coeffs=4), **kw)
    got = extract_vectors(lambda x, v: port.extract(x, v), loader,
                          device="cpu", **kw)
    assert got.shape == want.shape == (7, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the same files through the RGB loader: near, not equal (the device
    # decode and the DCT prescale are not libjpeg's)
    rgb = extract_vectors(
        lambda x, v: port.extract(x, v),
        ImageFromList(paths, imsize=96, bbxs=bbxs, raw_uint8=True),
        device="cpu", **{**kw, "dct_decode": False})
    np.testing.assert_array_equal(got[4:6], rgb[4:6])
    assert np.sum(got * rgb, axis=1).min() > 0.99


def test_cli_evaluate_dct_decode_equals_jax(revisited_dir, jax_init_npz,  # noqa: F811
                                            tmp_path):
    """``cli.evaluate --dct-decode 4`` on the Revisited fixture (gallery
    JPEGs on the coefficient path, boxed queries on the RGB path): the
    JAX ``evaluate``'s E/M/H mAP with the same weights and flag."""
    want = jdriver.evaluate(JaxCfg(
        model="gem_r50", model_overrides=dict(num_classes=8),
        datasets=("roxford5k",), data_root=revisited_dir, imsize=64,
        dct_decode=4))
    out = tmp_path / "res.json"
    assert cli_evaluate.main(["--datasets", "roxford5k", "--data-root",
                              revisited_dir, "--imsize", "64",
                              "--checkpoint", jax_init_npz, "--dct-decode",
                              "4", "--output", str(out), "--device",
                              "cpu"]) == 0
    with open(out) as f:
        got = json.load(f)
    assert tuple(got["roxford5k"]) == tuple(want["roxford5k"])
    args = cli_evaluate.build_parser().parse_args(["--dct-decode", "2"])
    assert args.dct_decode == 2


def test_decoder_builds_without_libjpeg():
    """The coefficient decoder's source includes no libjpeg header and
    its build links no libjpeg."""
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "research_image_retrieval_tpu_torch", "csrc",
                       "jpeg_coeffs.cc")
    with open(src) as f:
        assert "jpeglib" not in f.read()
    assert "-ljpeg" not in nd._coeffs._flags
    assert nd.coeffs_available()
