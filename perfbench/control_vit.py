"""Read the ViT index cell's compared number for its control.

    python3 perfbench/control_vit.py \
        --workload vit_b16.index_vit_1024_ms3 --seeds 1,2,3

The control is ``reference/vit.py`` put in the program's place at TF32,
the nearest precision below the configuration's fp32 with TF32 off (on
the card its TF32 tensor cores; on the CPU every operand of every
convolution and matrix product rounded to TF32), held against the fp32
reference on the same seed's inputs, as the cell's own check holds the
program (``desc_max_abs``).  One JSON line per seed.  The benchmark's
runs never run this: it is how the upper reading behind the limit in
``perfbench/limits/vit_b16.index_vit_1024_ms3.json`` was read (on the
chip, at the cell's size).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __name__ == "__main__":  # a script: import from the checkout's root
    sys.path[0] = str(Path(__file__).resolve().parents[1])

import numpy as np  # noqa: E402

from perfbench import inputs, inputs_vit  # noqa: E402
from perfbench.drivers.extract import pool_sizes  # noqa: E402
from perfbench.harness import make_cell  # noqa: E402
from perfbench.reference import vit as ref  # noqa: E402

__all__ = ["readings"]


def readings(workload: str, seed: int, mode: str = "tf32", device=None,
             overrides=None, root=None) -> dict:
    kw = {} if root is None else {"root": root}
    cell = make_cell(workload, seed, 0.0, False, device=device,
                     overrides=overrides, **kw)[0]
    if cell.traffic["kind"] != "extract_vit":
        raise ValueError(f"{workload} is not a ViT index cell")
    cfg, mix, dev = cell.config, cell.traffic, cell.device
    images = inputs.renders(pool_sizes(mix),
                            inputs.sub_seed(cell.seed, "images"), dev,
                            noise=mix["noise"])

    def desc(precision):
        return ref.descriptors(images, inputs_vit.vit_weights(
            cfg, inputs.sub_seed(cell.seed, "weights"), dev), cfg,
            tuple(mix["scales"]), inputs.IMAGENET_MEAN, inputs.IMAGENET_STD,
            dev, precision=precision)

    return {"desc_max_abs": float(np.abs(desc(mode) - desc("fp32")).max())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="vit_b16.index_vit_1024_ms3")
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    for seed in [int(s) for s in args.seeds.split(",")]:
        r = readings(args.workload, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "mode": "tf32", **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
