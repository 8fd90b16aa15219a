"""Dataset packing CLI: GLDv2 image tree (or an LMDB) -> .rirrec
(port of ``research_image_retrieval_tpu/cli/pack.py``; the same flags and
output, which either package's trainer reads).

    # GLDv2-clean layout: 3-level hash dirs + train_clean.csv
    python -m research_image_retrieval_tpu_torch.cli.pack \
        --images /data/gldv2/train --csv /data/train_clean.csv \
        --output /data/train.rirrec

    # migrate an LMDB of pickled (jpeg_bytes, label) (needs lmdb)
    python -m research_image_retrieval_tpu_torch.cli.pack \
        --lmdb /data/train.lmdb --output /data/train.rirrec

Labels are relabeled contiguously (the mapping persists next to the
output as ``<output>.relabeling.pkl``).  JPEG payloads are copied byte
for byte: no decode or re-encode.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="pack a dataset into .rirrec")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--images", default=None,
                     help="GLDv2 image root (3-level hash dirs)")
    src.add_argument("--lmdb", default=None,
                     help="LMDB to migrate (needs the lmdb package)")
    p.add_argument("--csv", default=None,
                   help="train_clean.csv (landmark_id -> image ids); "
                        "required with --images")
    p.add_argument("--limit", type=int, default=0,
                   help="pack only the first N images (debug)")
    p.add_argument("--output", required=True, help="output .rirrec path")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from research_image_retrieval_tpu_torch.data import (
        convert_lmdb_to_records,
        write_records,
    )

    if args.lmdb:
        n = convert_lmdb_to_records(args.lmdb, args.output)
        print(f"packed {n} records from {args.lmdb} -> {args.output}")
        return 0

    if not args.csv:
        raise SystemExit("--images requires --csv (train_clean.csv)")

    import numpy as np

    from research_image_retrieval_tpu_torch.data.gldv2 import (
        _hash_path,
        parse_clean_csv,
        relabel_contiguous,
    )

    image_ids, landmark_ids = parse_clean_csv(args.csv)
    labels, _ = relabel_contiguous(
        np.asarray(landmark_ids),
        save_path=args.output + ".relabeling.pkl",
    )
    if args.limit:
        image_ids, labels = image_ids[: args.limit], labels[: args.limit]

    missing = 0

    def items():
        nonlocal missing
        for iid, label in zip(image_ids, labels):
            path = os.path.join(args.images, _hash_path(iid))
            if not os.path.exists(path):
                missing += 1
                continue
            with open(path, "rb") as f:
                yield f.read(), int(label)

    n = write_records(args.output, items())
    print(f"packed {n} records ({missing} listed images missing on disk) "
          f"-> {args.output}")
    if n == 0:
        raise SystemExit("no images found — check --images/--csv")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
