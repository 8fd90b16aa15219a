"""The bottleneck kernel's stream-K plan (``csrc/stream_k.h``), on the host.

``tests/stream_k_sim.cc`` builds the plan with the header the kernel
includes, walks every CTA's units as the kernel does, and checks the
invariants the kernel relies on (its header comment lists them); it
prints, per launch, the grid, the tiles, the whole and split tiles and
the SMs' modelled busy share.  Needs g++ (as the port's JPEG coefficient
decoder does).  The SM count is an H100 SXM's.
"""

import shutil
import subprocess
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "research_image_retrieval_tpu_torch" / "csrc"
SMS = 132


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build tests/stream_k_sim.cc")
    exe = tmp_path_factory.mktemp("stream_k") / "stream_k_sim"
    subprocess.run([gxx, "-O2", "-std=c++17", "-Wall", "-Wextra", "-Werror",
                    "-I", str(CSRC), "-o", str(exe),
                    str(ROOT / "tests" / "stream_k_sim.cc")],
                   check=True, capture_output=True, text=True)

    def run(*args):
        r = subprocess.run([str(exe), *map(str, args)], capture_output=True,
                           text=True)
        assert r.returncode == 0, r.stdout + r.stderr
        return r.stdout

    return run


def _plans(sim, launches):
    """(grid, tiles, whole, split, sm_use) of each (M, N, K) launch."""
    out = sim(*[v for m, n, k in launches for v in (m, n, k, SMS)])
    rows = [line.split() for line in out.splitlines()]
    return [(int(g), int(t), int(w), int(s), float(u))
            for g, t, w, s, u in rows]


def _block(M, C):
    """The three launches of one identity block: conv1, conv2, conv3."""
    cw = C // 4
    return [(M, cw, C), (M, cw, 9 * cw), (M, C, cw)]


@pytest.mark.parametrize("M", [24576, 18432, 15360, 12288, 9216, 6144, 4608])
def test_index_cell_layer3_splits(sim, M):
    """The index cell's layer-3 launches (B = 8, its buckets and scales):
    every block splits the tiles of some launch's partial wave, and the
    SMs' modelled busy share is 0.96 or more in every launch (whole waves
    all but full stay whole)."""
    plans = _plans(sim, _block(M, 1024))
    assert any(split > 0 for _, _, _, split, _ in plans)
    for grid, tiles, whole, split, use in plans:
        assert grid == SMS and whole + split == tiles
        assert use >= 0.96


def test_split_only_where_it_pays(sim):
    """128 tiles on 132 SMs finish in one wave: splitting them would save
    3% of a tile's stages and cost a fixup, so they stay whole (layer 4's
    conv1 and conv2 at M = 4096); 72 tiles of 72 stages split."""
    keep, _, _ = _plans(sim, _block(4096, 2048))
    assert keep == (128, 128, 128, 0, 0.9697)
    assert _plans(sim, _block(4608, 1024))[1][3] == 72


@pytest.mark.parametrize("C", [1024, 2048])
def test_whole_waves_split_nothing(sim, C):
    """Where the tiles fill whole waves the kernel is a plain persistent
    GEMM: 128 * SMS rows give whole waves at every column count."""
    for grid, tiles, whole, split, use in _plans(sim, _block(128 * SMS, C)):
        assert (grid, split, whole) == (SMS, 0, tiles)
        assert tiles % SMS == 0 and use == 1.0


@pytest.mark.parametrize("hw", [(32, 24), (16, 16)])
def test_serving_layer4_batch1(sim, hw):
    """``cli.serve`` at batch 1: layer 4 of a 1024 or 512 px query gives
    6 or 2 row tiles, far under a wave; the plan spreads conv1's and
    conv2's K (64 and 144 stages a tile) over many more CTAs than
    tiles."""
    for grid, tiles, whole, split, use in _plans(sim, _block(hw[0] * hw[1],
                                                             2048))[:2]:
        assert whole == 0 and split == tiles
        assert grid > tiles and use >= 0.96


@pytest.mark.parametrize("M,C", [(8 * 256 * 192, 256), (8 * 64 * 48, 512),
                                 (494, 256), (2 * 128 * 128, 512)])
def test_short_k_stays_whole(sim, M, C):
    """Tiles of fewer than two shares of kMinShare stages are never split:
    layer 1's conv3 (K = 64, 2 stages) and layer 2's (K = 128, 4 stages)
    keep every tile whole, partial wave and all."""
    grid, tiles, whole, split, _ = _plans(sim, _block(M, C))[2]
    assert (split, whole) == (0, tiles)
    assert grid == min(SMS, tiles)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_launches(sim, seed):
    """Random M, widths 256-2048 and SM counts 1-160: every invariant."""
    assert sim("--random", seed, 2000).strip() == "ok"
