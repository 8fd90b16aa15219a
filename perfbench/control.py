"""Read a cell's compared numbers for its control and its planted faults.

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 \
        --mode tf32|halfbatch

The control is the reference put in the program's place at the nearest
precision below the configuration's: TF32 for fp32 with TF32 off (on
the card its TF32 tensor cores; on the CPU every operand of every
convolution and matrix product rounded to TF32), and, for the int8
search, int4.  ``halfbatch`` (training
only) is the reference stepping on the first half of each batch, the
mean taken over it.  Each reading is held against the fp32 reference
on the same seed's inputs, exactly as the cell's own check holds the
program, and the numbers are printed one JSON line per seed.  The
benchmark's runs never run this: it is how the upper readings behind
the limits in ``perfbench/limits/`` were read (on the chip, at the
cells' sizes).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import inputs  # noqa: E402
from perfbench.harness import make_cell  # noqa: E402
from perfbench.reference import resnet_gem as ref  # noqa: E402
from perfbench.reference import search as ref_search  # noqa: E402

__all__ = ["readings"]


def _extract(cell, mode: str) -> dict:
    from perfbench.drivers import extract

    cfg, mix, dev = cell.config, cell.traffic, cell.device
    images = inputs.renders(extract.pool_sizes(mix),
                            inputs.sub_seed(cell.seed, "images"), dev,
                            noise=mix["noise"])

    def desc(precision):
        return ref.descriptors(images, inputs.resnet_gem_weights(
            cfg, inputs.sub_seed(cell.seed, "weights"), dev), cfg,
            tuple(mix["scales"]), inputs.IMAGENET_MEAN, inputs.IMAGENET_STD,
            dev, precision=precision)

    return {"desc_max_abs": float(np.abs(desc(mode) - desc("fp32")).max())}


def _serve(cell, mode: str) -> dict:
    from perfbench.drivers import serve_image as si

    mix = cell.traffic
    jpegs = si.pool_jpegs(cell)
    used = list(range(len(jpegs)))
    want = si.reference_descriptors(cell, jpegs, used)
    ctrl = si.reference_descriptors(cell, jpegs, used, precision=mode)
    qs = np.stack([ctrl[j] for j in used])
    blocks = inputs.gallery_blocks(mix["gallery_rows"],
                                   cell.config["outputdim"],
                                   inputs.sub_seed(cell.seed, "gallery"),
                                   cell.device)
    s4 = ref_search.scores(qs, blocks, "int4")
    top = torch.topk(s4, mix["k"], dim=1)
    answers = [(j, qs[n], top.indices[n].cpu().numpy(),
                top.values[n].double().cpu().numpy())
               for n, j in enumerate(used)]
    return si.compare(cell, answers, want)


def _train(cell, mode: str) -> dict:
    from perfbench.drivers import train

    want = train.reference_readings(cell)
    if mode == "halfbatch":
        got = train.reference_readings(cell, rows=cell.traffic["batch"] // 2)
    else:
        got = train.reference_readings(cell, precision=mode)
    checks, notes = train.compare(got, want, cell.traffic["loss_steps"])
    return {**checks, "note": notes[0]}


def readings(workload: str, seed: int, mode: str, device=None,
             overrides=None, root=None) -> dict:
    kw = {} if root is None else {"root": root}
    cell = make_cell(workload, seed, 0.0, False, device=device,
                     overrides=overrides, **kw)[0]
    kind = cell.traffic["kind"]
    if mode == "halfbatch" and kind != "train":
        raise ValueError("halfbatch is a training fault")
    fn = {"extract": _extract, "serve_image": _serve, "train": _train}[kind]
    return fn(cell, mode)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", choices=("tf32", "halfbatch"), default="tf32")
    args = p.parse_args(argv)
    for seed in [int(s) for s in args.seeds.split(",")]:
        r = readings(args.workload, seed, args.mode)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "mode": args.mode, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
