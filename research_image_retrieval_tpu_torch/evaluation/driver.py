"""Evaluation driver: extract -> rank -> Revisited protocol mAP
(port of ``research_image_retrieval_tpu/evaluation/driver.py``: model
loading, ``evaluate`` and ``evaluate_synthetic`` with the JAX pipeline's
order: PCA whitening, alpha-QE, the learned IQE or a plain rank, then
SuperGlobal reranking, then (``evaluate``) CVNet's correlation rerank
and DELG's local-feature geometric rerank).

Both reranks feed their model ImageNet-normalized square images
whatever the loaders yield: with ``device_scales`` the loaders yield raw
uint8, which the JAX driver resizes and passes on un-normalized (0-255);
the port normalizes them first, as the host-scales path's items are.

The CVNet reranker's weights come from ``EvalConfig.rerank_checkpoint``
(a ``.pt`` state dict of ``models.CVNetRerank`` or an ``.npz`` of its
flax variables flattened with ``/`` keys; arrays whose name and shape
match load, as JAX's ``partial_load`` merges), else from
``seeded_init(seed=0)`` with a warning that the scores are untrained.

The IQE MLP's weights come from ``EvalConfig.iqe_checkpoint``: a ``.pt``
state dict of ``index.qe.IterativeQueryExpansion`` or an ``.npz`` of its
flax params flattened with ``/`` keys (``params/expansion_fc1/kernel``
...), not an orbax directory.  Without one it runs from torch's seeded
init, which is not flax's draw: its ranks differ from the JAX
random-init ranks (a warning says the MLP is untrained).

A dataset whose directory is missing falls back to the synthetic fixture
and says so.  Checkpoints are ``.pt`` / ``.pth`` state dicts (the port's
model, or a torchvision-layout ResNet for the backbone), the port
trainer's ``epoch_*.pt`` / ``best.pt`` (the state dict under ``"model"``),
or an ``.npz`` of flax variables flattened with ``/`` keys
(``params/backbone/conv1/kernel`` ...); an orbax checkpoint directory
cannot be read without orbax.
"""

from __future__ import annotations

import inspect
import os
import re

import numpy as np
import torch

from research_image_retrieval_tpu_torch.data import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    ImageFromList,
    PrefetchedImages,
    RevisitedDataset,
    SyntheticRetrievalDataset,
    make_synthetic_gnd,
)
from research_image_retrieval_tpu_torch.data.transforms import normalize
from research_image_retrieval_tpu_torch.evaluation.revisited import (
    compute_map_and_print,
)
from research_image_retrieval_tpu_torch.index import (
    IterativeQueryExpansion,
    alpha_query_expansion,
    extract_vectors,
    geometric_verification_batch,
    iqe_from_flax,
    make_cvnet_batch_scorer,
    rank_full,
    rerank_shortlist_batched,
    resize_bilinear_np,
    search_topk,
    superglobal_rerank,
)
from research_image_retrieval_tpu_torch.models import (
    CVNetRerank,
    from_jax_variables,
    get_model,
    load_torchvision_resnet,
    seeded_init,
)
from research_image_retrieval_tpu_torch.ops.norm import l2_normalize
from research_image_retrieval_tpu_torch.ops.whiten import (
    apply_whitening,
    pca_whiten_learn,
)
from research_image_retrieval_tpu_torch.utils.config import EvalConfig
from research_image_retrieval_tpu_torch.utils.device import resolve_device

__all__ = ["EvalConfig", "cvnet_featuremaps", "evaluate",
           "evaluate_synthetic", "load_checkpoint", "load_cvnet", "load_iqe",
           "local_features"]


def _unflatten(flat) -> dict:
    tree: dict = {}
    for key in flat:
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = flat[key]
    return tree


# keys of a torchvision-layout ResNet (a backbone-only checkpoint)
_RESNET_KEY = re.compile(r"(conv1|bn1|fc)\.\w+|layer\d+\.\d+\..+")


def load_checkpoint(path: str) -> tuple[dict, bool]:
    """(state dict, whether it holds only a backbone) from ``path``.  A
    ``.pt`` state dict is a ResNet for the backbone when every key is a
    torchvision ResNet's, or every key is under ``backbone.``; else it is
    a whole model's (a backbone and a head, or a model with its own
    layers at the top level, as senet_g2's ``layer1_0.se...``)."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint?); the port reads "
            "a .pt / .pth state dict or an .npz of flax variables flattened "
            "with '/' keys (params/..., batch_stats/...)")
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as flat:
            variables = _unflatten({k: flat[k] for k in flat.files})
        if "params" not in variables:
            raise ValueError(f"{path}: no 'params/...' keys "
                             f"(keys: {sorted(variables)})")
        sd = from_jax_variables(variables)
        return sd, all(k.startswith("backbone.") for k in sd)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd.get("model"), dict):  # a trainer checkpoint
        sd = sd["model"]
    if not all(k.startswith("backbone.") for k in sd) and \
            not all(_RESNET_KEY.fullmatch(k) for k in sd):
        return sd, False  # a whole model
    return {f"backbone.{k}": v
            for k, v in load_torchvision_resnet(sd).items()}, True


def _load_model(cfg: EvalConfig, device="cuda", num_classes: int = 81313):
    """The configured model in eval mode on ``device``.  Weights come from
    ``cfg.checkpoint`` (the classifier's size from the checkpoint's, when
    it has one), else from ``seeded_init(seed=0)``; a backbone-only
    checkpoint keeps the seeded head."""
    dev = resolve_device(device)
    overrides = dict(cfg.model_overrides)
    sd, backbone_only = (load_checkpoint(cfg.checkpoint) if cfg.checkpoint
                         else (None, False))
    for key in ("classifier_w", "classifier.weight"):  # ArcFace, Linear
        if sd is not None and key in sd:
            overrides.setdefault("num_classes", int(sd[key].shape[0]))
    overrides.setdefault("num_classes", num_classes)
    model = get_model(cfg.model, **overrides)
    seeded_init(model, seed=0)
    if sd is not None:
        missing, unexpected = model.load_state_dict(sd, strict=False)
        allowed = {"classifier_w", "classifier.weight", "classifier.bias"}
        if backbone_only:
            allowed |= {k for k in model.state_dict()
                        if not k.startswith("backbone.")}
        if unexpected or set(missing) - allowed:
            raise ValueError(
                f"checkpoint {cfg.checkpoint} does not fit {cfg.model}: "
                f"missing {sorted(set(missing) - allowed)}, unexpected "
                f"{sorted(unexpected)}")
        if backbone_only:
            print(f">> {cfg.checkpoint}: backbone only; the head keeps "
                  "its seeded init")
    return model.to(dev).eval()


def _make_extract_fn(model, bucket: int = 128):
    """``(fn, bucket, extent_multiple)`` for ``extract_vectors``.

    A model whose ``extract`` takes ``valid_hw`` runs bucketed and masked
    (every model of the port does); one that does not gets exact-shape
    grouping (``bucket=None``), as the JAX driver falls back when its
    abstract probe of the masked call fails.  Patch and window models
    advertise the grid multiple their masked path needs
    (``model.extent_multiple``: the patch size, or 32 for ULTRON), which
    ``extract_vectors`` snaps image extents to."""
    if "valid_hw" not in inspect.signature(model.extract).parameters:
        return (lambda x: model.extract(x)), None, 1
    multiple = int(getattr(model, "extent_multiple", 1))
    return ((lambda x, valid_hw=None: model.extract(x, valid_hw)), bucket,
            multiple)


def _whiten(vecs, qvecs, cfg: EvalConfig, device):
    """PCA whitening learned on the gallery descriptors, applied to both
    sides and re-L2-normalized."""
    m, P = pca_whiten_learn(np.asarray(vecs), s=cfg.pca_shrinkage)
    dim = cfg.pca_dim or None

    def white(x):
        t = torch.as_tensor(np.asarray(x, np.float32), device=device)
        return l2_normalize(apply_whitening(t, m, P, out_dim=dim)).cpu() \
            .numpy()

    return white(vecs), white(qvecs)


def _expand(qvecs, vecs, cfg: EvalConfig, device):
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return alpha_query_expansion(t(qvecs), t(vecs), k=cfg.qe_k,
                                 alpha=cfg.qe_alpha).cpu().numpy()


def _splice_ranks(ranks: np.ndarray, heads: np.ndarray) -> np.ndarray:
    """Each query's reordered shortlist first, then the rest of the
    gallery in its original rank order.  ``ranks`` [db, nq]; ``heads``
    [nq, k] gallery ids."""
    ranks = np.asarray(ranks).copy()
    for qi in range(ranks.shape[1]):
        head = heads[qi]
        in_head = np.zeros(ranks.shape[0], bool)
        in_head[head] = True
        tail = ranks[:, qi][~in_head[ranks[:, qi]]]
        ranks[:, qi] = np.concatenate([head, tail])
    return ranks


def _read_state(path: str, from_flax) -> dict:
    """The state dict in ``path``: a ``.pt`` file (a trainer's under
    ``"model"``) or an ``.npz`` of flax variables flattened with ``/``
    keys, whose tree ``from_flax`` converts."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory (an orbax checkpoint?); "
                         "the port reads a .pt state dict or an .npz of "
                         "flax variables flattened with '/' keys")
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as flat:
            return from_flax(_unflatten({k: flat[k] for k in flat.files}))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd["model"] if isinstance(sd.get("model"), dict) else sd


def load_iqe(cfg: EvalConfig, embed_dim: int) -> IterativeQueryExpansion:
    """The IQE module of ``cfg``: weights from ``cfg.iqe_checkpoint``
    (``.pt`` state dict, or ``.npz`` of flattened flax params), else
    torch's init under seed 0, with a warning that it is untrained."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = IterativeQueryExpansion(
            embed_dim=embed_dim, top_k=cfg.iqe_k,
            max_iterations=cfg.iqe_iterations, gamma=cfg.iqe_gamma)
    path = cfg.iqe_checkpoint
    if path:
        sd = _read_state(path, iqe_from_flax)
        model.load_state_dict(sd)
        print(f">> IQE checkpoint {path}: {len(sd)} arrays loaded")
    else:
        print(">> WARNING: IQE expansion running from RANDOM init "
              "(no iqe_checkpoint) — the expansion MLP is untrained")
    return model


def _iqe_ranks(qvecs, vecs, cfg: EvalConfig, device) -> np.ndarray:
    """[db, nq] ranks from the IQE's blended final scores (stable order,
    as ``jnp.argsort``)."""
    model = load_iqe(cfg, int(qvecs.shape[1])).to(device)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    with torch.no_grad():
        final = model(t(qvecs), t(vecs))["final_scores"]
        order = torch.argsort(-final, dim=1, stable=True)
    return order.cpu().numpy().T


def _superglobal_ranks(qvecs, vecs, ranks, cfg: EvalConfig, device):
    """The top-M of each query reranked by SuperGlobal, spliced back into
    the full [db, nq] ranks."""
    M = min(cfg.sg_m, vecs.shape[0])
    s, i = search_topk(qvecs, vecs, k=M, device=device)
    _, ni = superglobal_rerank(qvecs, vecs, s, i, device=device)
    return _splice_ranks(ranks, ni)


def _rank(qvecs, vecs, cfg: EvalConfig, device) -> np.ndarray:
    """The ranks of the configured pipeline after whitening and alpha-QE:
    the IQE's or a plain rank, then SuperGlobal."""
    ranks = (_iqe_ranks(qvecs, vecs, cfg, device) if cfg.iqe
             else rank_full(qvecs, vecs, device=device))
    if cfg.superglobal:
        ranks = _superglobal_ranks(qvecs, vecs, ranks, cfg, device)
    return ranks


def _square_images(loader, idxs, size: int) -> np.ndarray:
    """[len(idxs), size, size, 3] float32 batch of the loader's items as
    pixels (``rgb_item`` where the loader has it: a split-decode loader
    yields coefficients), bilinear-resized; a raw uint8 item is
    normalized first, as the loader's float items are."""
    out = np.empty((len(idxs), size, size, 3), np.float32)
    pixels = getattr(loader, "rgb_item", loader.__getitem__)
    for j, i in enumerate(idxs):
        img = np.asarray(pixels(int(i)))
        if img.dtype == np.uint8:
            img = normalize(img.astype(np.float32) / 255.0, IMAGENET_MEAN,
                            IMAGENET_STD)
        out[j] = resize_bilinear_np(img, size, size)
    return out


def load_cvnet(cfg: EvalConfig, device) -> CVNetRerank:
    """The CVNet reranker of ``cfg`` in eval mode on ``device``: a
    ``rerank_backbone`` encoder, ``seeded_init(seed=0)``, then every array
    of ``cfg.rerank_checkpoint`` whose name and shape match (the loaded /
    shape-mismatched counts printed, as JAX's ``partial_load`` reports)."""
    model = CVNetRerank(backbone_name=cfg.rerank_backbone)
    seeded_init(model, seed=0)
    path = cfg.rerank_checkpoint
    if not path:
        print(">> WARNING: CVNet reranker running from RANDOM init "
              "(no --rerank-checkpoint) — scores are untrained")
    else:
        src = _read_state(path, from_jax_variables)
        own = model.state_dict()
        keys = [k for k in src if k in own
                and not k.endswith("num_batches_tracked")]
        loaded = {k: src[k] for k in keys if src[k].shape == own[k].shape}
        model.load_state_dict(loaded, strict=False)
        print(f">> CVNet rerank checkpoint: {len(loaded)} arrays loaded, "
              f"{len(keys) - len(loaded)} shape-mismatched")
    return model.to(resolve_device(device)).eval()


def cvnet_featuremaps(model: CVNetRerank, loader, ids,
                      size: int) -> torch.Tensor:
    """[len(ids), h, w, C] feature maps, on the model's device, of the
    loader's images ``ids`` as ``size`` square images, 8 at a time."""
    dev = next(model.parameters()).device
    out = []
    with torch.no_grad():
        for lo in range(0, len(ids), 8):
            imgs = _square_images(loader, ids[lo:lo + 8], size)
            out.append(model.extract_featuremap(torch.from_numpy(imgs)
                                                .to(dev)))
    return torch.cat(out)


def _cvnet_rerank_ranks(qvecs, vecs, ranks, q_loader, db_loader,
                        cfg: EvalConfig, device):
    """CVNet correlation re-verification of each query's top
    ``rerank_k``: feature maps of the queries and of the union of
    shortlisted gallery images, every pair scored in 16-pair chunks
    (``make_cvnet_batch_scorer``) and blended with the first-stage
    score, the shortlist reordered ahead of the rest."""
    model = load_cvnet(cfg, device)
    k = min(cfg.rerank_k, vecs.shape[0])
    scores, indices = search_topk(qvecs, vecs, k=k, device=device)
    q_fmaps = cvnet_featuremaps(model, q_loader, np.arange(len(qvecs)),
                                cfg.rerank_imsize)
    union = np.unique(indices.reshape(-1))
    g_fmaps = cvnet_featuremaps(model, db_loader, union, cfg.rerank_imsize)
    scorer = make_cvnet_batch_scorer(model, q_fmaps, g_fmaps)
    _, new_local = rerank_shortlist_batched(
        scores, np.searchsorted(union, indices), scorer,
        blend=cfg.rerank_blend)
    return _splice_ranks(ranks, union[new_local])


def local_features(model, loader, ids, top: int, size: int, device):
    """(descriptors [n, top, D], coordinates [n, top, 2]) of the loader's
    images ``ids``: ``model.extract_local`` of ``size`` square images, 8
    at a time, each image's ``top`` highest-attention cells with their
    (row, col) on the local grid."""
    descs, coords = [], []
    with torch.no_grad():
        for lo in range(0, len(ids), 8):
            chunk = ids[lo:lo + 8]
            imgs = torch.from_numpy(_square_images(loader, chunk, size))
            lf, att = (t.cpu().numpy()
                       for t in model.extract_local(imgs.to(device)))
            grid = int(round(lf.shape[1] ** 0.5))  # square in, square grid
            yy, xx = np.meshgrid(np.arange(grid), np.arange(grid),
                                 indexing="ij")
            cells = np.stack([yy.ravel(), xx.ravel()], 1).astype(np.float32)
            for b in range(len(chunk)):
                keep = np.argsort(-att[b])[:top]
                descs.append(lf[b][keep])
                coords.append(cells[keep])
    return np.stack(descs), np.stack(coords)


def _local_rerank_ranks(model, qvecs, vecs, ranks, q_loader, db_loader,
                        cfg: EvalConfig, device):
    """DELG local-feature geometric rerank of each query's top
    ``rerank_k``: locals of the queries and of the union of shortlisted
    gallery images, every pair's affine-RANSAC inlier count on ``device``
    (``geometric_verification_batch``) over ``lr_top_attn`` blended with
    the first-stage score, the shortlist reordered ahead of the rest."""
    if not hasattr(model, "extract_local"):
        raise ValueError(
            f"--local-rerank needs a model exposing extract_local (the "
            f"delg family); {cfg.model} does not")
    k = min(cfg.rerank_k, vecs.shape[0])
    scores, indices = search_topk(qvecs, vecs, k=k, device=device)
    qd, qxy = local_features(model, q_loader, np.arange(len(qvecs)),
                             cfg.lr_top_attn, cfg.rerank_imsize, device)
    union = np.unique(indices.reshape(-1))
    gd, gxy = local_features(model, db_loader, union, cfg.lr_top_attn,
                             cfg.rerank_imsize, device)

    def scorer(qids, gids):
        inliers = geometric_verification_batch(
            qd[qids], qxy[qids], gd[gids], gxy[gids], device=device)
        return inliers / float(cfg.lr_top_attn)

    _, new_local = rerank_shortlist_batched(
        scores, np.searchsorted(union, indices), scorer,
        blend=cfg.rerank_blend)
    return _splice_ranks(ranks, union[new_local])


def evaluate(cfg: EvalConfig, device="cuda") -> dict:
    """Evaluate on the configured Revisited datasets on ``device``;
    returns ``{dataset: (E, M, H)}`` mAP in percent."""
    dev = resolve_device(device)
    model = _load_model(cfg, device=dev)
    extract, bucket, multiple = _make_extract_fn(model, bucket=cfg.bucket)
    results = {}
    with torch.no_grad():
        for dataset in cfg.datasets:
            gnd_file = os.path.join(cfg.data_root, dataset,
                                    f"gnd_{dataset}.pkl")
            if not os.path.exists(gnd_file):
                print(f">> {dataset}: dataset not found at {cfg.data_root}; "
                      "using the SYNTHETIC fixture (clearly not real data)")
                results[dataset] = evaluate_synthetic(model, cfg, device=dev)
                continue
            ds = RevisitedDataset(dataset, cfg.data_root)
            # device_scales: raw uint8 to the device, normalization and
            # scale resizes there; dct_decode: the split JPEG decode (host
            # entropy decode, the rest on the device) where device_scales
            # holds, the boxed queries taking the RGB path item by item
            dsc = cfg.device_scales and bucket is not None
            norm = (IMAGENET_MEAN, IMAGENET_STD) if dsc else None
            dct_k = int(cfg.dct_decode) if dsc else 0
            db_loader = PrefetchedImages(ImageFromList(
                ds.im_fnames, imsize=cfg.imsize, raw_uint8=dsc,
                dct_coeffs=dct_k))
            q_loader = PrefetchedImages(ImageFromList(
                ds.qim_fnames, imsize=cfg.imsize,
                bbxs=[ds.query_bbx(i) for i in range(ds.nq)], raw_uint8=dsc,
                dct_coeffs=dct_k))
            kw = dict(scales=cfg.multiscale, print_freq=100, bucket=bucket,
                      device_scales=dsc, input_norm=norm,
                      extent_multiple=multiple, device=dev,
                      dct_decode=dct_k > 0)
            vecs = extract_vectors(extract, db_loader, **kw)
            qvecs = extract_vectors(extract, q_loader, **kw)
            if cfg.pca_whiten:
                vecs, qvecs = _whiten(vecs, qvecs, cfg, dev)
            if cfg.alpha_qe:
                qvecs = _expand(qvecs, vecs, cfg, dev)
            ranks = _rank(qvecs, vecs, cfg, dev)
            if cfg.cvnet_rerank:
                ranks = _cvnet_rerank_ranks(qvecs, vecs, ranks, q_loader,
                                            db_loader, cfg, dev)
            if cfg.local_rerank:
                ranks = _local_rerank_ranks(model, qvecs, vecs, ranks,
                                            q_loader, db_loader, cfg, dev)
            results[dataset] = compute_map_and_print(
                dataset, "global", "test", ranks, ds.gnd,
                kappas=list(cfg.kappas))
    return results


def evaluate_synthetic(model, cfg: EvalConfig = EvalConfig(),
                       device="cuda") -> tuple:
    """Deterministic synthetic evaluation (pipeline smoke metric).

    ``model`` (in eval mode) extracts 12 classes x 8 renders at
    ``min(cfg.imsize, 128)`` px on ``device``; the first render of each
    class is its query; PCA whitening and alpha-QE follow ``cfg`` in
    ``evaluate``'s order, then IQE and SuperGlobal.  Returns the (E, M,
    H) mAP in percent.
    """
    dev = resolve_device(device)
    ds = SyntheticRetrievalDataset(num_classes=12, samples_per_class=8,
                                   image_size=min(cfg.imsize, 128), seed=7)
    imgs, labels = ds.as_arrays()
    extract, bucket, multiple = _make_extract_fn(model, bucket=cfg.bucket)
    vecs = extract_vectors(extract, list(imgs), scales=cfg.multiscale,
                           bucket=bucket, extent_multiple=multiple,
                           device=dev)
    q_idx = np.arange(0, len(ds), 8)
    qvecs = vecs[q_idx]
    if cfg.pca_whiten:
        vecs, qvecs = _whiten(vecs, qvecs, cfg, dev)
    if cfg.alpha_qe:
        qvecs = _expand(qvecs, vecs, cfg, dev)
    gnd = make_synthetic_gnd(labels, q_idx)
    ranks = _rank(qvecs, vecs, cfg, dev)
    return compute_map_and_print("roxford5k", "global", "synthetic", ranks,
                                 gnd, kappas=list(cfg.kappas))
