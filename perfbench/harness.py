"""Run one cell of ``BENCHMARK.json`` once and print its result line.

Everything is found by name from data:

* the cell: ``BENCHMARK.json`` ``workloads[]`` by ``--workload``;
* its configuration: ``configs[]`` by the cell's ``config``, whose
  ``file`` holds the sizes (``perfbench/configs/<config>.json``);
* its traffic mix: ``perfbench/traffic/<traffic>.json``, whose ``kind``
  names the generator that drives it, ``perfbench/drivers/<kind>.py``
  (a function ``run(cell) -> Outcome``);
* its correctness limits: ``perfbench/limits/<workload>.json``;
* its metrics: the ``end_to_end`` metrics that list the cell (or list no
  cells) come from the driver's ``Outcome.metrics``; each ``per_layer``
  metric that lists the cell is read with ``--trace 1`` by
  ``perfbench/metrics/<metric>.py`` (a function ``read(obs) -> float |
  None``; ``None`` leaves the metric out of the line).

So a new cell, configuration, mix or per-layer metric is new files and
new ``BENCHMARK.json`` entries, and no edit of a file that is there.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

__all__ = ["Cell", "Outcome", "forbidden_modules", "load_cell", "main",
           "make_cell", "run_cell"]

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "research_image_retrieval_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name, taken whole (the part before
    the first dot), is JAX's, its libraries' or the JAX package's.  The
    port's own name only begins with the last of these."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


@dataclasses.dataclass
class Cell:
    """One cell as a driver sees it."""

    name: str
    config: dict
    traffic: dict
    chips: int
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object = None      # torch.device


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the window's counts and end-to-end
    values, what the per-layer readers read (``obs``), the compared
    numbers ``checks`` as ``{name: (value, limit)}`` (a value above its
    limit is not correct), the set-up's end and the memory peak."""

    attempted: int
    failed: int
    metrics: dict
    checks: dict
    setup_end: float
    memory_peak_bytes: int
    obs: dict = dataclasses.field(default_factory=dict)
    notes: list = dataclasses.field(default_factory=list)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: Path = ROOT) -> tuple[dict, dict, dict,
                                                          list, list]:
    """(workload entry, configuration, traffic mix, end-to-end specs,
    per-layer specs) of ``workload`` in ``root/BENCHMARK.json``."""
    bench = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(root / configs[cell["config"]]["file"])
    traffic = _read_json(HERE / "traffic" / f"{cell['traffic']}.json")

    def mine(spec):
        return "workloads" not in spec or workload in spec["workloads"]

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    per_layer = [m for m in bench["per_layer"] if mine(m)]
    return cell, config, traffic, e2e, per_layer


def _reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _device_info(device, chips: int, peak: int, trace_summary) -> dict:
    import torch

    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": chips}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = int(peak)
    if trace_summary is not None:
        info["busy_s"] = trace_summary["busy_s"]
        info["window_s"] = trace_summary["window_s"]
    return info


def make_cell(workload: str, seed: int, seconds: float, trace: bool, *,
              device=None, overrides: dict | None = None, root: Path = ROOT):
    """(``Cell``, end-to-end specs, per-layer specs) of ``workload``;
    ``overrides`` as in ``run_cell``."""
    import torch

    entry, config, traffic, e2e, per_layer = load_cell(workload, root)
    overrides = overrides or {}
    config = {**config, **overrides.get("config", {})}
    traffic = {**traffic, **overrides.get("traffic", {})}
    limits = _read_json(HERE / "limits" / f"{workload}.json")
    cell = Cell(workload, config, traffic, int(entry["chips"]), limits,
                int(seed), float(seconds), bool(trace),
                torch.device(device or "cuda:0"))
    return cell, e2e, per_layer


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device=None, overrides: dict | None = None,
             t_start: float | None = None, root: Path = ROOT) -> dict:
    """Run one cell once; returns the result line as a dict (without
    printing).  ``device`` (default ``cuda:0``) and ``overrides`` (``{
    "config": {...}, "traffic": {...}}`` merged over the files) are for
    the tests, which run the cells at a small size on the CPU."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell, e2e, per_layer = make_cell(workload, seed, seconds, trace,
                                     device=device, overrides=overrides,
                                     root=root)
    dev = cell.device
    driver = importlib.import_module(
        f"perfbench.drivers.{cell.traffic['kind']}")
    out: Outcome = driver.run(cell)
    for note in out.notes:
        print(note, file=sys.stderr, flush=True)

    values = {**out.metrics, "setup_s": out.setup_end - t_start}
    units = {m["name"]: m["unit"] for m in e2e + per_layer}
    metrics = {}
    if trace:
        for m in per_layer:
            v = _reader(m["name"])(out.obs)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": units[m["name"]]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    summary = out.obs.get("trace")
    result = {
        "correct": all(math.isfinite(v) and v <= lim
                       for v, lim in out.checks.values()),
        "attempted": int(out.attempted),
        "failed": int(out.failed),
        "metrics": metrics,
        "device": _device_info(dev, cell.chips, out.memory_peak_bytes,
                               summary if trace else None),
    }
    if trace and summary is not None:
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in summary["device_ops"]],
            "idle_gaps": [[n, s] for n, s in summary["idle_gaps"]]}
    if out.failed:
        result["correct"] = False
    result["checks"] = {k: {"value": v if math.isfinite(v) else 1e300,
                            "limit": lim}
                        for k, (v, lim) in out.checks.items()}
    return result


def _parse(argv):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start: float | None = None) -> int:
    args = _parse(argv)
    import torch

    entry = load_cell(args.workload)[0]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(entry["chips"]):
        print(f"perfbench: {args.workload} needs {entry['chips']} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"perfbench: JAX modules loaded in the run's process: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
