"""PyTorch port, the training data path on the CPU, against the JAX
package on the same inputs (numpy, seeded):

* ``ShardedBatchIterator``: the same batch order for the same seed, per
  shard, and the same batches after a mid-epoch resume;
* ``random_resized_crop`` draws the same crops; ``TrainTransform`` /
  ``EvalTransform`` within one grey level (uint8) and 1e-5 before
  normalization (float) of the JAX ones, which call OpenCV; the port's
  own bilinear / bicubic resize and RGB <-> HSV against OpenCV;
* ``.rirrec`` files written by either package read back in the other,
  with the native and the Python reader; ``cli.pack`` writes the same
  file; the LMDB migration through an injected env;
* ``parse_clean_csv`` / ``relabel_contiguous`` / ``stratified_split``
  and ``build_gldv2_train_val`` equal the JAX ones.
"""

import os
import pickle

import cv2
import numpy as np
import pytest

from research_image_retrieval_tpu.data import gldv2 as jgl
from research_image_retrieval_tpu.data import records as jrec
from research_image_retrieval_tpu.data import transforms as jtf
from research_image_retrieval_tpu.data.pipeline import (
    ShardedBatchIterator as JaxIterator,
)
from research_image_retrieval_tpu_torch.data import gldv2 as tgl
from research_image_retrieval_tpu_torch.data import records as trec
from research_image_retrieval_tpu_torch.data import transforms as ttf
from research_image_retrieval_tpu_torch.data.pipeline import (
    ShardedBatchIterator,
)


class _Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((2,), i, np.int64), int(i) % 5


def _take(it, n):
    out = []
    for imgs, _ in it.epoch_batches():
        out.append(imgs[:, 0].tolist())
        if len(out) == n:
            break
    return out


@pytest.mark.parametrize("shard", [(0, 1), (1, 3)])
@pytest.mark.parametrize("shuffle", [True, False])
def test_iterator_order_and_resume_match_jax(shard, shuffle):
    kw = dict(seed=7, shuffle=shuffle, shard_index=shard[0],
              shard_count=shard[1], num_workers=0)
    ds = _Indexed(29)
    j, t = JaxIterator(ds, 3, **kw), ShardedBatchIterator(ds, 3, **kw)
    assert t.steps_per_epoch() == j.steps_per_epoch()
    for _ in range(3):  # whole epochs
        assert _take(t, 99) == _take(j, 99)
    # mid-epoch resume: two batches, state, a fresh iterator, the rest
    _take(t, 2)
    _take(j, 2)
    assert t.state_dict() == j.state_dict()
    t2 = ShardedBatchIterator(ds, 3, num_workers=2, **{
        k: v for k, v in kw.items() if k != "num_workers"})
    t2.load_state_dict(t.state_dict())
    assert _take(t2, 99) == _take(j, 99)
    assert _take(t2, 99) == _take(j, 99)
    t2.close()


# -- transforms ------------------------------------------------------------------

def _photo(seed, h=120, w=96):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    chans = [np.sin(2 * np.pi * (rng.uniform(1, 6) * xx + rng.uniform()))
             + np.cos(2 * np.pi * rng.uniform(1, 6) * yy) for _ in range(3)]
    img = np.stack(chans, -1) + 0.3 * rng.standard_normal((h, w, 3))
    img = (img - img.min()) / (img.max() - img.min())
    return np.round(img * 255).astype(np.uint8)


def test_random_resized_crop_same_crops(monkeypatch):
    """The crop windows themselves: both resizes replaced by identity."""
    monkeypatch.setattr(jtf, "_cv2_resize", lambda img, h, w, interp: img)
    monkeypatch.setattr(ttf, "resize_bilinear", lambda img, h, w: img)
    for seed in range(8):
        img = _photo(seed, 50 + 7 * seed, 90 - 5 * seed)
        for scale in ((0.2, 1.0), (0.95, 1.0)):  # the second hits the fallback
            a = jtf.random_resized_crop(img, 32, np.random.default_rng(seed),
                                        scale=scale, ratio=(3.0, 4.0))
            b = ttf.random_resized_crop(img, 32, np.random.default_rng(seed),
                                        scale=scale, ratio=(3.0, 4.0))
            np.testing.assert_array_equal(a, b)
        a = jtf.random_resized_crop(img, 32, np.random.default_rng(seed))
        b = ttf.random_resized_crop(img, 32, np.random.default_rng(seed))
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("raw", [True, False])
def test_train_transform_matches_jax(raw):
    """8 (seed, epoch, index) streams: uint8 within 1 grey level; float
    within 1e-5 before normalization (1e-5 / 0.224 after it)."""
    for k in range(8):
        img = _photo(100 + k)
        j = jtf.TrainTransform(64, seed=k, raw_uint8=raw)
        t = ttf.TrainTransform(64, seed=k, raw_uint8=raw)
        j.set_epoch(k % 3)
        t.set_epoch(k % 3)
        a, b = j(img, index=k), t(img, index=k)
        assert a.dtype == b.dtype and a.shape == b.shape == (64, 64, 3)
        if raw:
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, k
        else:
            assert np.abs(a - b).max() <= 1e-5 / 0.224, k


@pytest.mark.parametrize("raw", [True, False])
def test_eval_transform_matches_jax(raw):
    for k, (h, w) in enumerate(((120, 96), (70, 130), (64, 64))):
        img = _photo(200 + k, h, w)
        a = jtf.EvalTransform(48, raw_uint8=raw)(img)
        b = ttf.EvalTransform(48, raw_uint8=raw)(img)
        assert a.shape == b.shape == (48, 48, 3)
        if raw:
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
        else:
            assert np.abs(a - b).max() <= 1e-5 / 0.224


@pytest.mark.parametrize("interp", ["linear", "cubic"])
def test_resize_matches_opencv(interp):
    fn, flag = {"linear": (ttf.resize_bilinear, cv2.INTER_LINEAR),
                "cubic": (ttf.bicubic_resize, cv2.INTER_CUBIC)}[interp]
    rng = np.random.default_rng(6)
    sizes = [(37, 53, 100, 80), (150, 170, 100, 80), (32, 32, 64, 64),
             (41, 31, 40, 30), (512, 512, 683, 512), (9, 200, 13, 7)]
    for h, w, H, W in sizes:
        img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        want = cv2.resize(img, (w, h), interpolation=flag)
        assert np.abs(fn(img, h, w).astype(int) - want).max() <= 1
        f = img.astype(np.float32) / 255
        want = cv2.resize(f, (w, h), interpolation=flag)
        assert np.abs(fn(f, h, w) - want).max() <= 1e-5


def test_hsv_matches_opencv():
    rng = np.random.default_rng(7)
    x = rng.random((40, 40, 3)).astype(np.float32)
    x[0, :3] = [[0.5, 0.5, 0.5], [0, 0, 0], [1, 1, 1]]  # grey: s = 0
    hsv = ttf.rgb_to_hsv(x)
    want = cv2.cvtColor(x, cv2.COLOR_RGB2HSV)
    np.testing.assert_allclose(hsv[..., 1:], want[..., 1:], atol=1e-5)
    np.testing.assert_allclose(hsv[..., 0] / 360, want[..., 0] / 360,
                               atol=1e-7)  # degrees, float32 at 360
    hsv[..., 0] = (hsv[..., 0] + 123.4) % 360
    np.testing.assert_allclose(ttf.hsv_to_rgb(hsv),
                               cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB),
                               atol=1e-5)


# -- records ---------------------------------------------------------------------

def _jpeg(rng, h=24, w=32) -> bytes:
    ok, buf = cv2.imencode(".jpg", rng.integers(0, 256, (h, w, 3),
                                                dtype=np.uint8))
    assert ok
    return buf.tobytes()


@pytest.fixture(scope="module")
def items():
    rng = np.random.default_rng(8)
    return [(_jpeg(rng), int(lb)) for lb in rng.integers(0, 81313, 12)]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("native", [True, False])
def test_records_cross_read(tmp_path, items, writer, native):
    path = str(tmp_path / "r.rirrec")
    write = {"jax": jrec.write_records, "port": trec.write_records}[writer]
    assert write(path, iter(items)) == len(items)
    if native and not trec.records_native_available():
        pytest.fail("native record core did not build (g++ is installed)")
    t = trec.RecordReader(path, native=native)
    j = jrec.RecordReader(path, native=native)
    assert len(t) == len(j) == len(items)
    np.testing.assert_array_equal(t.labels(), j.labels())
    for i, (blob, lb) in enumerate(items):
        got, glb = t.get(i)
        assert got.tobytes() == blob and glb == lb
    t.prefetch([0, 3])
    tds = trec.RecordDataset(path, indices=[2, 5],
                             transform=ttf.EvalTransform(16, raw_uint8=True))
    jds = jrec.RecordDataset(path, indices=[2, 5],
                             transform=jtf.EvalTransform(16, raw_uint8=True))
    for i in range(2):
        (a, la), (b, lb) = tds[i], jds[i]
        assert la == lb
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    t.close()
    j.close()


def test_records_reject_bad_file(tmp_path):
    bad = tmp_path / "bad.rirrec"
    bad.write_bytes(b"NOTAREC" + b"\0" * 40)
    with pytest.raises(ValueError):
        trec.RecordReader(str(bad), native=False)


class _FakeTxn:
    def __init__(self, store):
        self.store = store

    def get(self, key):
        return self.store.get(key)

    def cursor(self):
        return iter(sorted(self.store.items()))

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _FakeEnv:
    def __init__(self, store):
        self.store = store

    def begin(self, write=False):
        return _FakeTxn(self.store)


@pytest.mark.parametrize("with_keys", [True, False])
def test_lmdb_migration_matches_jax(tmp_path, items, with_keys):
    store = {f"k{i:03d}".encode(): pickle.dumps(it)
             for i, it in enumerate(items)}
    if with_keys:
        store[b"__keys__"] = pickle.dumps(sorted(k for k in store))
    paths = [str(tmp_path / f"{w}.rirrec") for w in ("jax", "port")]
    for conv, out in ((jrec.convert_lmdb_to_records, paths[0]),
                      (trec.convert_lmdb_to_records, paths[1])):
        assert conv("fake://", out,
                    open_env=lambda p: _FakeEnv(store)) == len(items)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    with pytest.raises(ImportError, match="lmdb"):
        tgl.GLDv2LmdbDataset(str(tmp_path / "none.lmdb"))


# -- GLDv2 ---------------------------------------------------------------------

def _gldv2_tree(root, csv_path, rng, n_landmarks=4, per_lm=3):
    rows = []
    for lm in range(n_landmarks):
        ids = [f"{lm}{k}abcdef{lm}{k}" for k in range(per_lm)]
        rows.append((100 + lm * 7, " ".join(ids)))
        for iid in ids:
            p = os.path.join(root, iid[0], iid[1], iid[2])
            os.makedirs(p, exist_ok=True)
            with open(os.path.join(p, iid + ".jpg"), "wb") as f:
                f.write(_jpeg(rng, 20, 28))
    with open(csv_path, "w") as f:
        f.write("landmark_id,images\n")
        for lm, imgs in rows:
            f.write(f'{lm},"{imgs}"\n')


def test_gldv2_and_pack_match_jax(tmp_path):
    root, csv = str(tmp_path / "train"), str(tmp_path / "train_clean.csv")
    _gldv2_tree(root, csv, np.random.default_rng(9))
    ids_t, lm_t = tgl.parse_clean_csv(csv)
    ids_j, lm_j = jgl.parse_clean_csv(csv)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_array_equal(lm_t, lm_j)
    lab_t, map_t = tgl.relabel_contiguous(lm_t)
    lab_j, map_j = jgl.relabel_contiguous(lm_j)
    np.testing.assert_array_equal(lab_t, lab_j)
    assert map_t == map_j
    for vpc, seed in ((1, 11), (2, 3)):
        for a, b in zip(tgl.stratified_split(lab_t, vpc, seed),
                        jgl.stratified_split(lab_j, vpc, seed)):
            np.testing.assert_array_equal(a, b)
    tr_t, va_t, n_t = tgl.build_gldv2_train_val(root, csv)
    tr_j, va_j, n_j = jgl.build_gldv2_train_val(root, csv)
    assert (len(tr_t), len(va_t), n_t) == (len(tr_j), len(va_j), n_j)
    for i in range(len(va_t)):
        (a, la), (b, lb) = va_t[i], va_j[i]
        assert la == lb and a.shape == b.shape

    from research_image_retrieval_tpu.cli.pack import main as jax_pack
    from research_image_retrieval_tpu_torch.cli.pack import main as pack

    outs = [str(tmp_path / f"{w}.rirrec") for w in ("jax", "port")]
    assert jax_pack(["--images", root, "--csv", csv, "--output",
                     outs[0]]) == 0
    assert pack(["--images", root, "--csv", csv, "--output", outs[1]]) == 0
    assert open(outs[0], "rb").read() == open(outs[1], "rb").read()
    with open(outs[1] + ".relabeling.pkl", "rb") as f:
        assert pickle.load(f) == map_j
