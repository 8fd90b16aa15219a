"""Small sizes at which the tests run the benchmark's cells on the CPU,
and a checkout root whose BENCHMARK.json also holds the shelved cells."""

import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]

TINY = {
    "gem_r101.index_1024_ms3": {
        "traffic": {"pool": 8, "longest": 128, "bucket": 32, "batch": 4}},
    "gem_r50.query_image_r1m": {
        "traffic": {"phones": 2, "phone": [120, 160], "crops": 2,
                    "crop_min": 40, "crop_max": 128, "imsize": 128,
                    "gallery_rows": 5000, "rate_rps": 2.0}},
    "gem_r50.train_512_arcface": {
        "config": {"num_classes": 512},
        "traffic": {"batch": 8, "image_size": 96}},
}


@pytest.fixture(autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="session")
def root(tmp_path_factory):
    """A checkout root: the repository's ``perfbench/`` and a
    BENCHMARK.json with the entries of ``perfbench/shelved/`` merged in."""
    out = tmp_path_factory.mktemp("checkout")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for f in sorted((ROOT / "perfbench" / "shelved").glob("*.json")):
        extra = json.loads(f.read_text())
        for key in ("workloads", "end_to_end", "per_layer"):
            bench[key] += extra[key]
    (out / "BENCHMARK.json").write_text(json.dumps(bench))
    (out / "perfbench").symlink_to(ROOT / "perfbench")
    return out
