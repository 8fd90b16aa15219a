"""Descriptor-extraction CLI: images in, L2-normalized descriptors out
(port of ``research_image_retrieval_tpu/cli/extract.py``).

Point it at an image directory, a packed record file (``.rirrec``) or a
Revisited dataset and it writes an ``.npz`` index (``vecs`` [N, D]
float32, or ``vecs_int8`` + ``scales``, plus ``names``, and ``labels``
for a record file) in the JAX package's layout, ready for ``cli.search``
or ``cli.serve`` of either package.

    python -m research_image_retrieval_tpu_torch.cli.extract \
        --model gem_r50 --images /data/jpegs --checkpoint gem_r50.pt \
        --multiscale --output gallery.npz [--device cpu]
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="descriptor extraction")
    p.add_argument("--model", default="gem_r50")
    p.add_argument("--checkpoint", default=None,
                   help=".pt state dict or .npz of flattened flax variables")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--images", default=None,
                     help="directory of images (jpg/jpeg/png, recursive)")
    src.add_argument("--records", default=None,
                     help="packed .rirrec file (cli.pack)")
    src.add_argument("--dataset", default=None,
                     help="Revisited dataset name (needs --data-root)")
    p.add_argument("--data-root", default="")
    p.add_argument("--queries", action="store_true",
                   help="with --dataset: extract the query set (bbox-cropped)")
    p.add_argument("--imsize", type=int, default=1024,
                   help="max side for thumbnailing (0 = original size)")
    p.add_argument("--multiscale", action="store_true")
    p.add_argument("--host-scales", action="store_true",
                   help="multi-scale resizes on the host instead of the "
                        "device (debug)")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--fast-decode", action="store_true",
                   help="native DCT-prescaled JPEG decode (the smallest "
                        "1/2^k scale still >= --imsize; not the "
                        "strict-parity decode path)")
    p.add_argument("--quantize-int8", action="store_true",
                   help="store the index as symmetric per-row int8 "
                        "(vecs_int8 + scales; half the stream of a bf16 "
                        "gallery in cli.search/serve --engine int8)")
    p.add_argument("--output", required=True)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def _iter_image_files(root: str):
    exts = {".jpg", ".jpeg", ".png"}
    for dirpath, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            if os.path.splitext(f)[1].lower() in exts:
                yield os.path.join(dirpath, f)


def extract_index(model, images, names, *, imsize: int = 1024,
                  multiscale: bool = False, host_scales: bool = False,
                  batch_size: int = 16, quantize_int8: bool = False,
                  device="cuda", print_freq: int = 100) -> dict:
    """The index of ``images`` as the ``.npz`` payload: ``{"vecs"}`` or
    ``{"vecs_int8", "scales"}``, plus ``"names"``.

    ``images`` is an iterable of RGB uint8 [H, W, 3] arrays (thumbnailed
    here to ``imsize``: the identity for images already at that max
    side); ``model`` is an eval-mode model on ``device``.  Raw uint8 goes
    to the device, normalized and resized for every scale there, unless
    ``host_scales``."""
    import numpy as np

    from research_image_retrieval_tpu_torch.data.transforms import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        imthumbnail,
        normalize,
    )
    from research_image_retrieval_tpu_torch.evaluation.driver import (
        _make_extract_fn,
    )
    from research_image_retrieval_tpu_torch.index import extract_vectors
    from research_image_retrieval_tpu_torch.ops import quantize_gallery_int8

    extract, bucket, multiple = _make_extract_fn(model)
    host_scales = host_scales or bucket is None
    scales = (1.0, 2 ** -0.5, 0.5) if multiscale else (1.0,)

    def prepped():
        for img in images:
            if imsize:
                img = imthumbnail(img, imsize)
            yield (np.ascontiguousarray(img, np.uint8) if not host_scales
                   else normalize(np.asarray(img, np.float32) / 255.0))

    vecs = extract_vectors(
        extract, prepped(), scales=scales, bucket=bucket,
        batch_size=batch_size, print_freq=print_freq,
        extent_multiple=multiple, device_scales=not host_scales,
        input_norm=None if host_scales else (IMAGENET_MEAN, IMAGENET_STD),
        device=device)
    if quantize_int8:
        import torch

        qv, s = quantize_gallery_int8(torch.from_numpy(vecs))
        return {"vecs_int8": qv.numpy(), "scales": s.numpy(),
                "names": np.asarray(names)}
    return {"vecs": vecs, "names": np.asarray(names)}


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np

    from research_image_retrieval_tpu_torch.data import (
        ImageFromList,
        PrefetchedImages,
        RevisitedDataset,
    )
    from research_image_retrieval_tpu_torch.evaluation.driver import (
        _load_model,
    )
    from research_image_retrieval_tpu_torch.utils.config import EvalConfig

    cfg = EvalConfig(model=args.model, checkpoint=args.checkpoint,
                     imsize=args.imsize)
    model = _load_model(cfg, device=args.device)
    imsize = args.imsize or None
    labels = None
    if args.records:
        from research_image_retrieval_tpu_torch.data import RecordDataset

        # records decode to RGB uint8; max_side only prescales (1/2^k), so
        # extract_index's thumbnail still applies, as for image files
        ds = RecordDataset(args.records,
                           max_side=args.imsize if args.fast_decode else 0)
        labels = ds.labels()
        names = [str(i) for i in range(len(ds))]
        loader = (ds[i][0] for i in range(len(ds)))
    elif args.images:
        paths = list(_iter_image_files(args.images))
        if not paths:
            raise SystemExit(f"no images under {args.images}")
        names = [os.path.relpath(p, args.images) for p in paths]
        bbxs = None
    else:
        ds = RevisitedDataset(args.dataset, args.data_root)
        if args.queries:
            names, paths = list(ds.qimlist), ds.qim_fnames
            bbxs = [ds.query_bbx(i) for i in range(ds.nq)]
        else:
            names, paths, bbxs = list(ds.imlist), ds.im_fnames, None
    if not args.records:
        loader = PrefetchedImages(ImageFromList(
            paths, imsize=imsize, bbxs=bbxs, raw_uint8=True,
            fast_decode=args.fast_decode))
    out = extract_index(model, loader, names, imsize=args.imsize,
                        multiscale=args.multiscale,
                        host_scales=args.host_scales,
                        batch_size=args.batch_size,
                        quantize_int8=args.quantize_int8, device=args.device)
    if labels is not None:
        out["labels"] = np.asarray(labels)
    np.savez(args.output, **out)
    shape = out.get("vecs", out.get("vecs_int8")).shape
    kind = "int8 " if args.quantize_int8 else ""
    print(f"wrote {shape} {kind}descriptors -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
