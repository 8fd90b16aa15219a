"""Multi-process dry run: one rank of a run over ``torch.distributed``
(port of ``research_image_retrieval_tpu/parallel/dryrun_worker.py``).

Run one process per rank with ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR``
/ ``MASTER_PORT`` set (``torchrun --nproc_per_node=2 -m
research_image_retrieval_tpu_torch.parallel.dryrun_worker``).  The ranks
talk over gloo, on CUDA tensors (``--device cuda``, the default: rank
``r`` on ``cuda:LOCAL_RANK``; ``--device cuda:0``: every rank shares that
card) or on the CPU (``--device cpu``).  Each rank asserts, in order:

1. an ``all_reduce`` of ``rank + 1`` (1 + 2 = 3 for two ranks);
2. the train step on the ``(world, 1)`` and ``(1, world)`` layouts equals
   the single-device step on the same global batch, in float64
   (``parallel.verify.sharded_step_equivalence``): loss and grad_norm
   within 1e-10 relative, parameters and BN statistics within 1e-9; so
   does one step of IRIS (dropout 0) and of SPECTRUM on ``(world, 1)``,
   whose training couples the batch's samples (at least 96 px, so that
   IRIS's layer4 map has rows for its bins);
3. the cross-process sharded search, exact and int8, returns the single
   engine's ids (a gallery whose size the rank count does not divide);
4. rank-sharded extraction gives the single-process descriptors within
   1e-5, and the Revisited mAP of their ranks is equal.

It prints ``RANK<k>_DRYRUN_OK <json>`` (the deviations, the mAP and the
kernel launch counts of step 4, sharded and single-process) on success.
``--size check`` runs step 2 at ``train/device_check``'s reduced size
(ResNet-50, batch 2, 128 px, 512 classes); ``--fixture x.npz`` (arrays
``img_<i>`` and ``labels``) extracts those images with full-width
``gem_r50`` at 1024 px ms3 instead of the small synthetic set.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

SMALL = dict(backbone_name="resnet18", batch_size=4, imsize=32,
             num_classes=64)
BARS = dict(loss=1e-10, grad_norm=1e-10, params=1e-9, batch_stats=1e-9)
# models whose training couples the batch, with their overrides
COUPLED = (("iris_r50", {"dropout": 0.0}), ("spectrum_r50", {}))


def _steps(rank_dev, size: str) -> dict:
    from research_image_retrieval_tpu_torch.parallel import (
        get_world_size,
        make_mesh,
    )
    from research_image_retrieval_tpu_torch.parallel.verify import (
        sharded_step_equivalence,
    )
    from research_image_retrieval_tpu_torch.train.device_check import SHAPE

    kw = SMALL if size == "small" else dict(
        backbone_name="resnet50", batch_size=SHAPE["batch"],
        imsize=SHAPE["px"], num_classes=SHAPE["classes"])
    world = get_world_size()
    runs = [(f"{d}x{m}", (d, m), dict(steps=2, **kw))
            for d, m in ((world, 1), (1, world))]
    runs += [(f"{name} {world}x1", (world, 1),
              dict(kw, steps=1, model_name=name, model_overrides=ov,
                   imsize=max(kw["imsize"], 96)))
             for name, ov in COUPLED]
    out = {}
    for key, layout, args in runs:
        dev = sharded_step_equivalence(make_mesh(*layout),
                                       dtype=torch.float64, device=rank_dev,
                                       **args)
        rel = {"loss": dev["loss"] / abs(dev["loss_value"]),
               "grad_norm": dev["grad_norm"] / abs(dev["grad_norm_value"]),
               "params": dev["params"], "batch_stats": dev["batch_stats"]}
        miss = {k: v for k, v in rel.items() if not v <= BARS[k]}
        assert not miss, f"{key}: {miss} (bars {BARS})"
        out[key] = rel
    return out


def _search(rank_dev) -> None:
    from research_image_retrieval_tpu_torch.ops.topk_stream import (
        int8_streaming_topk,
        quantize_gallery_int8,
    )
    from research_image_retrieval_tpu_torch.parallel import (
        get_world_size,
        make_mesh,
        sharded_streaming_topk,
    )

    world = get_world_size()
    mesh = make_mesh(world, 1)
    rng = np.random.default_rng(11)
    n = 16 * world + 3  # pad rows on the last shard
    full = rng.standard_normal((n, 16)).astype(np.float32)
    full /= np.linalg.norm(full, axis=1, keepdims=True)
    queries = full[:3] + 0.01
    g = torch.from_numpy(full).to(rank_dev)
    q = torch.from_numpy(queries).to(rank_dev)
    refs = {"exact": np.argsort(-(queries @ full.T), axis=1)[:, :5]}
    qg, gs = quantize_gallery_int8(g)
    refs["int8"] = int8_streaming_topk(q, qg, gs, k=5,
                                       chunk=n)[1].cpu().numpy()
    for engine, ref in refs.items():
        _, i = sharded_streaming_topk(q, g, k=5, mesh=mesh, chunk=8,
                                      engine=engine)
        assert (i.cpu().numpy() == ref).all(), (engine, i, ref)


def _small_set():
    from research_image_retrieval_tpu_torch.data import (
        SyntheticRetrievalDataset,
    )

    ds = SyntheticRetrievalDataset(num_classes=4, samples_per_class=3,
                                   image_size=64, seed=3, uint8=True)
    imgs = [np.ascontiguousarray(ds[i][0][: 64 - 8 * (i % 3),
                                          : 64 - 8 * ((i + 1) % 3)])
            for i in range(len(ds))]
    return imgs, np.asarray(ds.labels)


def _extract(rank_dev, fixture: str | None) -> dict:
    from research_image_retrieval_tpu_torch.data import (
        IMAGENET_MEAN,
        IMAGENET_STD,
    )
    from research_image_retrieval_tpu_torch.evaluation import (
        evaluate_revisited,
    )
    from research_image_retrieval_tpu_torch.index import (
        extract_vectors,
        rank_full,
    )
    from research_image_retrieval_tpu_torch.models import (
        get_model,
        seeded_init,
    )
    from research_image_retrieval_tpu_torch.ops import gem_head as gh
    from research_image_retrieval_tpu_torch.ops import resblock as rb
    from research_image_retrieval_tpu_torch.parallel import (
        get_world_size,
        make_mesh,
    )

    if fixture:
        with np.load(fixture) as f:
            labels = f["labels"]
            imgs = [f[f"img_{i}"] for i in range(len(labels))]
        model = get_model("gem_r50", num_classes=8)
        seeded_init(model, seed=0)
        kw = dict(scales=(1.0, 2 ** -0.5, 0.5), bucket=128)
    else:
        imgs, labels = _small_set()
        model = get_model("gem_r50", backbone_name="resnet18", outputdim=32,
                          num_classes=8)
        seeded_init(model, seed=1)
        kw = dict(scales=(1.0, 0.5), bucket=32)
    model = model.to(rank_dev).eval()
    # batch 1: every task is its own batch, so the ranks' kernel launches
    # sum to the single-process run's
    kw.update(batch_size=1, device_scales=True,
              input_norm=(IMAGENET_MEAN, IMAGENET_STD), device=rank_dev)

    def run(mesh):
        gh.gem_whiten_l2.launches = rb.fused_bottleneck.launches = 0
        v = extract_vectors(lambda x, e: model.extract(x, e), imgs,
                            mesh=mesh, **kw)
        return v, {"gem_head": gh.gem_whiten_l2.launches,
                   "bottleneck": rb.fused_bottleneck.launches}

    ref_v, single = run(None)
    got_v, sharded = run(make_mesh(get_world_size(), 1))
    dev = float(np.abs(ref_v - got_v).max())
    assert dev < 1e-5, f"rank-sharded extraction deviates {dev:.3e}"
    gnd = []
    for i in range(len(imgs)):
        same = np.flatnonzero(labels == labels[i])
        gnd.append({"easy": same[same != i], "hard": np.array([], int),
                    "junk": np.array([i])})
    maps = [evaluate_revisited(rank_full(v, v, device=rank_dev), gnd,
                               dataset="dryrun") for v in (ref_v, got_v)]
    got = [(r.map_easy, r.map_medium, r.map_hard) for r in maps]
    assert got[0] == got[1], got
    return {"extract_dev": dev, "mAP": got[1], "images": len(imgs),
            "launches": {"sharded": sharded, "single": single}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (cuda:LOCAL_RANK; raises without a card), "
                        "a card every rank shares (cuda:0), or cpu")
    p.add_argument("--size", choices=("small", "check"), default="small")
    p.add_argument("--fixture", default=None)
    args = p.parse_args(argv)

    from research_image_retrieval_tpu_torch.parallel import (
        get_rank,
        get_world_size,
        init_distributed_mode,
        local_device,
    )
    from research_image_retrieval_tpu_torch.utils.device import (
        resolve_device,
    )

    if resolve_device(args.device).type == "cpu":
        torch.set_num_threads(1)
    ok = init_distributed_mode(backend="gloo", device=args.device,
                               quiet_non_main=False)
    assert ok, "distributed env set but init returned False"
    dev = local_device(args.device)
    rank, world = get_rank(), get_world_size()

    t = torch.tensor([rank + 1.0], device=dev)
    dist.all_reduce(t)
    assert float(t[0]) == world * (world + 1) / 2, float(t[0])

    summary = {"world": world, "steps": _steps(dev, args.size)}
    _search(dev)
    summary.update(_extract(dev, args.fixture))
    print(f"RANK{rank}_DRYRUN_OK {json.dumps(summary)}", flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
