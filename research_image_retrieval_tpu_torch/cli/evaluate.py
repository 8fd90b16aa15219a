"""Evaluation CLI: extract + rank + Revisited protocol mAP
(port of ``research_image_retrieval_tpu/cli/evaluate.py`` with the flags
of what the port has: multiscale, host scales, alpha-QE, PCA whitening,
the learned IQE, SuperGlobal, CVNet's correlation reranking, DELG's
local-feature geometric reranking and the split JPEG decode,
``--dct-decode K``).  ``--iqe-checkpoint`` and ``--rerank-checkpoint``
read a ``.pt`` state dict or an ``.npz`` of flattened flax variables,
not orbax.
``--model`` takes any registry or Table-1 name (``gem_r50``,
``dolg_r101``, ``R101-SOLAR``, ``delg_r50``, ``R101-Token`` ...);
``--local-rerank`` needs a delg model.
A dataset missing under ``--data-root`` falls back to the synthetic
fixture and says so.

    python -m research_image_retrieval_tpu_torch.cli.evaluate \
        --model gem_r50 --datasets roxford5k rparis6k \
        --data-root /data/revisited --checkpoint gem_r50.pt \
        --multiscale --alpha-qe [--device cpu]

    python -m research_image_retrieval_tpu_torch.cli.evaluate \
        --model delg_r50 --datasets roxford5k --data-root /data/revisited \
        --local-rerank --rerank-k 20 [--device cpu]

    python -m research_image_retrieval_tpu_torch.cli.evaluate \
        --model gem_r50 --datasets roxford5k --data-root /data/revisited \
        --multiscale --cvnet-rerank --rerank-checkpoint cvnet.pt

    python -m research_image_retrieval_tpu_torch.cli.evaluate \
        --model gem_r50 --datasets roxford5k --data-root /data/revisited \
        --multiscale --dct-decode 4

``--dct-decode K`` entropy-decodes each gallery JPEG on the host to its
top-left K x K quantized DCT coefficients (the port's own decoder,
``csrc/jpeg_coeffs.cc``, built with g++ at first use; no libjpeg) and
finishes the decode on the device: (K*K/64) * 3 of the RGB-uint8 bytes
cross to the device, 4x fewer at K = 4.  Boxed queries, non-JPEG files
and files the decoder refuses take the RGB path.
"""

from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Revisited-protocol evaluation")
    p.add_argument("--model", default="gem_r50")
    p.add_argument("--datasets", nargs="+", default=["roxford5k", "rparis6k"])
    p.add_argument("--data-root", default="")
    p.add_argument("--imsize", type=int, default=1024)
    p.add_argument("--checkpoint", default=None,
                   help=".pt state dict or .npz of flattened flax variables")
    p.add_argument("--dct-decode", type=int, default=0, metavar="K",
                   help="split JPEG decode: the host entropy-decodes to "
                        "K x K DCT coefficients per block, the device "
                        "finishes the decode (4x fewer wire bytes at K=4)")
    p.add_argument("--host-scales", action="store_true",
                   help="multi-scale resizes on the host instead of the "
                        "device (debug)")
    p.add_argument("--multiscale", action="store_true",
                   help="3-scale extraction (1, 1/sqrt(2), 1/2)")
    p.add_argument("--alpha-qe", action="store_true")
    p.add_argument("--qe-k", type=int, default=10)
    p.add_argument("--qe-alpha", type=float, default=3.0)
    p.add_argument("--pca-whiten", action="store_true",
                   help="learn PCA whitening on the gallery, apply both sides")
    p.add_argument("--pca-dim", type=int, default=0)
    p.add_argument("--pca-shrinkage", type=float, default=1.0)
    p.add_argument("--superglobal", action="store_true",
                   help="SuperGlobal-style global-feature reranking of the "
                        "top-M shortlist (index/superglobal.py)")
    p.add_argument("--sg-m", type=int, default=100)
    p.add_argument("--iqe", action="store_true",
                   help="learned iterative query expansion (index/qe.py); "
                        "loads its MLP from --iqe-checkpoint, else it runs "
                        "random-init")
    p.add_argument("--iqe-k", type=int, default=5)
    p.add_argument("--iqe-iterations", type=int, default=2)
    p.add_argument("--iqe-gamma", type=float, default=0.6)
    p.add_argument("--iqe-checkpoint", default=None,
                   help=".pt state dict or .npz of flattened flax params")
    p.add_argument("--cvnet-rerank", action="store_true",
                   help="CVNet correlation-verification reranking of the "
                        "top --rerank-k")
    p.add_argument("--local-rerank", action="store_true",
                   help="DELG local-feature affine-RANSAC reranking of the "
                        "top --rerank-k (needs a delg model)")
    p.add_argument("--lr-top-attn", type=int, default=128,
                   help="highest-attention locals kept per image")
    p.add_argument("--rerank-k", type=int, default=20)
    p.add_argument("--rerank-blend", type=float, default=0.5,
                   help="weight of the first-stage score in the blend")
    p.add_argument("--rerank-imsize", type=int, default=224,
                   help="square side of the rerank's images")
    p.add_argument("--rerank-checkpoint", default=None,
                   help="CVNet weights: .pt state dict or .npz of flattened "
                        "flax variables (else random init, with a warning)")
    p.add_argument("--output", default=None, help="write results JSON here")
    p.add_argument("--output-csv", default=None,
                   help="write a combined CSV (dataset, easy, medium, hard)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from research_image_retrieval_tpu_torch.evaluation.driver import evaluate
    from research_image_retrieval_tpu_torch.utils.config import EvalConfig

    cfg = EvalConfig(
        model=args.model,
        datasets=tuple(args.datasets),
        data_root=args.data_root,
        imsize=args.imsize,
        checkpoint=args.checkpoint,
        multiscale=(1.0, 2**-0.5, 0.5) if args.multiscale else (1.0,),
        device_scales=not args.host_scales,
        dct_decode=args.dct_decode,
        alpha_qe=args.alpha_qe,
        qe_k=args.qe_k,
        qe_alpha=args.qe_alpha,
        pca_whiten=args.pca_whiten,
        pca_dim=args.pca_dim,
        pca_shrinkage=args.pca_shrinkage,
        iqe=args.iqe,
        iqe_k=args.iqe_k,
        iqe_iterations=args.iqe_iterations,
        iqe_gamma=args.iqe_gamma,
        iqe_checkpoint=args.iqe_checkpoint,
        superglobal=args.superglobal,
        sg_m=args.sg_m,
        cvnet_rerank=args.cvnet_rerank,
        rerank_checkpoint=args.rerank_checkpoint,
        local_rerank=args.local_rerank,
        lr_top_attn=args.lr_top_attn,
        rerank_k=args.rerank_k,
        rerank_blend=args.rerank_blend,
        rerank_imsize=args.rerank_imsize,
    )
    results = evaluate(cfg, device=args.device)
    if args.output:
        with open(args.output, "w") as f:
            json.dump({k: list(v) if isinstance(v, tuple) else v
                       for k, v in results.items()}, f, indent=2)
        print(f">> wrote {args.output}")
    if args.output_csv:
        with open(args.output_csv, "w") as f:
            f.write("dataset,mAP_easy,mAP_medium,mAP_hard\n")
            for ds, res in results.items():
                e, m, h = res if isinstance(res, tuple) else (res, res, res)
                f.write(f"{ds},{e},{m},{h}\n")
        print(f">> wrote {args.output_csv}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
