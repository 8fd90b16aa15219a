"""No module whose top-level name, taken whole, is JAX's, its libraries'
or the JAX package's is loaded by the benchmark, its reference or the
port it drives."""

import ast
import subprocess
import sys
from pathlib import Path

from perfbench.harness import FORBIDDEN, forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


def test_top_level_names_are_compared_whole():
    mods = ["research_image_retrieval_tpu_torch",
            "research_image_retrieval_tpu_torch.serve", "jaxtyping",
            "flaxen", "numpy"]
    assert forbidden_modules(mods) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "optax",
           "research_image_retrieval_tpu", "research_image_retrieval_tpu.ops"]
    assert forbidden_modules(bad + mods) == sorted(bad)


def test_no_source_under_perfbench_imports_them():
    for path in (ROOT / "perfbench").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)


def test_a_process_that_loads_every_driver_and_the_port_finds_none():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import perfbench.harness as h, perfbench.control\n"
        "import perfbench.drivers.extract, perfbench.drivers.serve_image\n"
        "import perfbench.drivers.train\n"
        "import research_image_retrieval_tpu_torch.serve\n"
        "import research_image_retrieval_tpu_torch.train.loop\n"
        "import research_image_retrieval_tpu_torch.index.extract\n"
        "print(h.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
