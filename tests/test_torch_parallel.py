"""PyTorch port, ``parallel/`` in one process on the CPU, held against the
JAX package's mesh (conftest's 8 virtual CPU devices):

* ``make_mesh``: shapes, each rank's coordinates and the ``ValueError``
  against JAX's ``make_mesh`` on the same counts;
* ``shard_train_state_rules`` picks JAX's leaves (the classifier weight,
  and nothing where its feature dimension does not divide the axis) on
  the same model's parameter names; with ``model = 1`` the port keeps the
  classifier whole where JAX shards it over the data axis (ROADMAP
  Queue 3);
* the in-process sharded search over ``["cpu"] * n`` against JAX's
  ``sharded_search_topk`` / ``sharded_streaming_topk`` on its mesh
  (exact and int8, ``N % n != 0``, all-negative similarities, a
  prequantized gallery): ids equal where scores differ by more than
  1e-6, scores within 1e-6; the same ``ValueError``s;
* the sharded ``SearchService`` against the unsharded one and JAX's
  sharded service; ``approx`` refused; ``cli.serve --sharded`` builds;
* ``ShardedBatchIterator(row_shard=...)``: the ranks' rows partition the
  one-process run's global batches, and each rank decodes only its own;
* a world-size-1 gloo group: the step over a ``(1, 1)`` layout (every
  collective run) equals the plain step bit for bit, as on the card.
"""

import copy
import socket

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from research_image_retrieval_tpu.models import get_model as jax_get_model
from research_image_retrieval_tpu.ops import (
    quantize_gallery_int8 as jax_quantize,
)
from research_image_retrieval_tpu.parallel import (
    default_search_mesh as jax_search_mesh,
)
from research_image_retrieval_tpu.parallel import make_mesh as jax_make_mesh
from research_image_retrieval_tpu.parallel import (
    shard_train_state_rules as jax_rules,
)
from research_image_retrieval_tpu.parallel import (
    sharded_search_topk as jax_search,
)
from research_image_retrieval_tpu.parallel import (
    sharded_streaming_topk as jax_stream,
)
from research_image_retrieval_tpu.serve import SearchService as JaxService
from research_image_retrieval_tpu_torch.data import ShardedBatchIterator
from research_image_retrieval_tpu_torch.models import get_model
from research_image_retrieval_tpu_torch.parallel import mesh as mesh_mod
from research_image_retrieval_tpu_torch.parallel import (
    init_distributed_mode,
    make_mesh,
    shard_train_state_rules,
    sharded_search_topk,
    sharded_streaming_topk,
)
from research_image_retrieval_tpu_torch.serve import SearchService
from research_image_retrieval_tpu_torch.train import (
    TrainState,
    create_train_state,
    make_sgd_optimizer,
    make_train_step,
)
from test_torch_model import few_torch_threads  # noqa: F401

CPUS = ["cpu"] * 8


def _as_rank(monkeypatch, world: int, rank: int) -> None:
    """Let ``make_mesh`` see a world of ``world`` processes from ``rank``
    (no process group: the layout alone)."""
    monkeypatch.setattr(mesh_mod, "get_world_size", lambda: world)
    monkeypatch.setattr(mesh_mod, "get_rank", lambda: rank)


@pytest.mark.parametrize("n, data, model", [
    (1, None, 1), (8, None, 1), (8, 4, 2), (8, None, 2), (8, 1, 8),
    (8, 3, 1), (8, 2, 3)])
def test_make_mesh_matches_jax(monkeypatch, n, data, model):
    devices = jax.devices()[:n]
    try:
        want = jax_make_mesh(data, model, devices=devices)
    except ValueError as e:
        _as_rank(monkeypatch, n, 0)
        with pytest.raises(ValueError, match=str(e)):
            make_mesh(data, model)
        return
    grid = np.vectorize(lambda d: devices.index(d))(want.devices)
    for r in range(n):
        _as_rank(monkeypatch, n, r)
        mesh = make_mesh(data, model)
        assert mesh.shape == dict(want.shape)
        i, j = np.argwhere(grid == r)[0]
        assert mesh.coords == {"data": i, "model": j}
        assert mesh.data_group is None and mesh.model_group is None


def _jax_params(dim: int):
    m = jax_get_model("gem_r50", backbone_name="resnet18", outputdim=dim,
                      num_classes=10)
    shapes = jax.eval_shape(
        lambda: m.init(jax.random.PRNGKey(0), np.zeros((1, 32, 32, 3),
                                                       np.float32),
                       labels=np.zeros((1,), np.int32), train=False))
    return shapes["params"]


@pytest.mark.parametrize("dim", [32, 36])
@pytest.mark.parametrize("data, model", [(4, 2), (2, 4), (1, 8), (8, 1)])
def test_shard_rules_match_jax(monkeypatch, dim, data, model):
    mesh = jax_make_mesh(data, model)
    rule = jax_rules(mesh)
    replicated = jax.sharding.PartitionSpec()
    want = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            _jax_params(dim))[0]:
        if rule(path, leaf).spec != replicated:
            want.add(".".join(getattr(p, "key", "") for p in path))
    port = get_model("gem_r50", backbone_name="resnet18", outputdim=dim,
                     num_classes=10)
    got = set()
    for r in range(data * model):
        _as_rank(monkeypatch, data * model, r)
        prule = shard_train_state_rules(make_mesh(data, model))
        got |= {n for n, p in port.named_parameters()
                if prule(n, p) is not None}
    if model == 1:  # JAX shards over the data axis; the port keeps it
        assert got == set() and want == ({"classifier_w"}
                                         if dim % data == 0 else set())
    else:
        assert got == want == ({"classifier_w"} if dim % model == 0
                               else set())


def _unit_rows(rng, n, d):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _same(got, want, k):
    """Ids equal where JAX's scores are distinct by more than 1e-6;
    scores within 1e-6."""
    gs, gi = (np.asarray(t) for t in got)
    ws, wi = (np.asarray(t) for t in want)
    np.testing.assert_allclose(gs, ws, rtol=0, atol=1e-6)
    gap = np.diff(ws, axis=1)
    distinct = np.ones_like(ws, bool)
    distinct[:, 1:] &= np.abs(gap) > 1e-6
    distinct[:, :-1] &= np.abs(gap) > 1e-6
    assert (gi[distinct] == wi[distinct]).all()
    assert gi.shape == (ws.shape[0], k)


@pytest.mark.parametrize("case", ["plain", "negative"])
@pytest.mark.parametrize("engine", ["exact", "int8", "dense"])
def test_sharded_search_matches_jax(case, engine):
    rng = np.random.default_rng(5)
    g = _unit_rows(rng, 509, 32)  # 509 % 8 != 0: pad rows
    q = g[[0, 100, 508]] + 0.01
    if case == "negative":  # every real score < 0, below a pad row's 0
        g = -np.abs(g)
        q = np.abs(q)
    k = 7
    if engine == "dense":
        want = jax_search(q, g, k=k, mesh=jax_search_mesh())
        got = sharded_search_topk(q, g, k=k, mesh=CPUS)
    else:
        want = jax_stream(q, g, k=k, mesh=jax_search_mesh(), chunk=16,
                          engine=engine)
        got = sharded_streaming_topk(q, g, k=k, mesh=CPUS, chunk=16,
                                     engine=engine)
    _same(got, want, k)
    assert (np.asarray(got[1]) < 509).all()


def test_sharded_search_prequantized_and_errors():
    rng = np.random.default_rng(6)
    g = _unit_rows(rng, 300, 16)
    q = g[:4]
    qg, s = jax_quantize(g)
    want = jax_stream(q, np.asarray(qg), k=5, mesh=jax_search_mesh(),
                      chunk=32, engine="int8", g_scales=np.asarray(s))
    got = sharded_streaming_topk(q, torch.from_numpy(np.array(qg)), k=5,
                                 mesh=CPUS, chunk=32, engine="int8",
                                 g_scales=np.asarray(s))
    _same(got, want, 5)
    for kw, match in ((dict(engine="approx"), "engine must be"),
                      (dict(gallery=np.asarray(qg)), "requires engine"),
                      (dict(gallery=np.asarray(qg), engine="int8"),
                       "needs its g_scales")):
        args = dict(gallery=g, engine="exact")
        args.update(kw)
        with pytest.raises(ValueError, match=match):
            sharded_streaming_topk(q, args.pop("gallery"), mesh=CPUS,
                                   **args)


@pytest.mark.parametrize("engine", ["exact", "int8"])
def test_sharded_service_matches_unsharded_and_jax(engine):
    rng = np.random.default_rng(11)
    g = _unit_rows(rng, 509, 32)
    q = g[[3, 100, 508]]
    kw = dict(engine=engine, k=7, max_batch=4, store_dtype="float32")
    with SearchService(g, device="cpu", **kw) as ref:
        ref_s, ref_i = ref.search(q)
    with SearchService(g, device="cpu", mesh=CPUS, **kw) as svc:
        s, i = svc.search(q)
        assert svc.stats()["shards"] == 8
    with JaxService(g, mesh=jax_search_mesh(), **kw) as jsvc:
        js, ji = jsvc.search(q)
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_allclose(s, ref_s, rtol=0, atol=1e-6)
    _same((s, i), (js, ji), 7)
    assert list(i[:, 0]) == [3, 100, 508]


def test_sharded_service_prequantized_refuses_approx():
    rng = np.random.default_rng(12)
    g = _unit_rows(rng, 200, 16)
    qg, s = jax_quantize(g)
    kw = dict(vecs_int8=np.asarray(qg), scales=np.asarray(s), k=5,
              max_batch=8, device="cpu")
    with SearchService(**kw) as ref, SearchService(mesh=CPUS[:3],
                                                   **kw) as svc:
        np.testing.assert_array_equal(svc.search(g[40:44])[1],
                                      ref.search(g[40:44])[1])
    with pytest.raises(ValueError, match="sharded"):
        SearchService(g, engine="approx", mesh=CPUS, device="cpu")


def test_cli_serve_sharded_builds(tmp_path, monkeypatch, capsys):
    from research_image_retrieval_tpu_torch.cli import serve as cli_serve
    from research_image_retrieval_tpu_torch import serve as serve_pkg

    rng = np.random.default_rng(13)
    np.savez(tmp_path / "g.npz", vecs=_unit_rows(rng, 40, 16))
    built = {}

    class Server:
        def __init__(self, service, **kw):
            built["stats"] = service.stats()

        def serve_forever(self):
            raise KeyboardInterrupt

        def server_close(self):
            pass

    monkeypatch.setattr(serve_pkg, "make_http_server", Server)
    assert cli_serve.main(["--gallery", str(tmp_path / "g.npz"),
                           "--sharded", "--device", "cpu",
                           "--no-warmup"]) == 0
    assert built["stats"]["shards"] == 1
    assert "sharding the gallery over 1 devices" in capsys.readouterr().out


class _Counted:
    def __init__(self, n):
        self.labels = np.arange(n)
        self.read = []

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        self.read.append(int(i))
        return np.full((2, 2, 3), i, np.uint8), int(i)


def test_row_shard_partitions_global_batches():
    one = ShardedBatchIterator(_Counted(37), 8, seed=4, num_workers=0)
    want = [lab for _, lab in one.epoch_batches()]
    ranks = [(ds := _Counted(37),
              ShardedBatchIterator(ds, 8, seed=4, num_workers=0,
                                   row_shard=(r, 4))) for r in range(4)]
    got = [[lab for _, lab in it.epoch_batches()] for _, it in ranks]
    for t, w in enumerate(want):
        np.testing.assert_array_equal(
            np.concatenate([g[t] for g in got]), w)
    for (ds, it), g in zip(ranks, got):
        assert sorted(ds.read) == sorted(np.concatenate(g).tolist())
        assert it.state_dict() == {"epoch": 1, "step": 0, "seed": 4}
        assert it.steps_per_epoch() == one.steps_per_epoch() == 4
    with pytest.raises(ValueError, match="equal"):
        ShardedBatchIterator(_Counted(8), 6, row_shard=(0, 4))


@pytest.fixture
def world_of_one():
    """A gloo group of one process (``force=True``), torn down after."""
    with socket.socket() as s:
        s.bind(("", 0))
        port = s.getsockname()[1]
    assert init_distributed_mode(f"localhost:{port}", device="cpu",
                                 force=True, quiet_non_main=False)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("model_parallel", [1])
def test_world_of_one_step_is_the_plain_step(world_of_one, model_parallel):
    """Every collective of the layout runs (BN's statistics and backward
    sums, the gradient buckets, the metrics) and the step equals the
    plain one bit for bit: at one rank each reduction returns its input
    and each correction is exactly 0."""
    model = get_model("gem_r50", backbone_name="resnet18", outputdim=16,
                      num_classes=8)
    tx = make_sgd_optimizer(0.05, weight_decay=1e-4, clip_max_norm=1.0)
    plain = create_train_state(model, 0, tx, device="cpu")
    twin = copy.deepcopy(plain.model)
    laid = TrainState(0, twin, tx.init(twin), torch.Generator())
    mesh = make_mesh(1, model_parallel)
    assert mesh.data_group is not None
    step_p, step_l = make_train_step(), make_train_step(mesh=mesh)
    rng = np.random.default_rng(2)
    for _ in range(2):
        x = torch.from_numpy(rng.standard_normal((4, 32, 32, 3))
                             .astype(np.float32))
        y = torch.from_numpy(rng.integers(0, 8, 4))
        plain, mp = step_p(plain, x, y)
        laid, ml = step_l(laid, x, y)
        for k in mp:
            assert torch.equal(mp[k], ml[k]), k
    for (n, a), b in zip(plain.model.state_dict().items(),
                         laid.model.state_dict().values()):
        assert torch.equal(a, b), n
