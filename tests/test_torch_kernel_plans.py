"""Host-side plans of the port's CUDA kernels, checked on the CPU.

csrc/temporal_plan.cuh says how ``temporal_attention_fwd`` / ``_bwd`` cut
their work (these tests compile it with the host's g++ and check its plan at
every shape of the grid; ``temporal.units_of`` mirrors its unit split);
``geglu.geglu_out_bwd_l2_read_bytes`` counts what ``geglu_out_bwd``'s tiles
copy from L2; csrc/int8_plan.cuh says how ``int8_dense`` splits K, sizes its
blocks and workspace and reads x (compiled the same way; ``int8_dense.k_splits``
mirrors its split). The
kernels themselves run only on the card (tests/test_torch_gpu.py).
"""

import json
import os
import shutil
import subprocess

import pytest

from eeg2video_tpu_torch.ops import _build, geglu, int8_dense, temporal

# every (heads, head_dim) the staged route takes at these widths: heads
# divides 32, head_dim a multiple of 32 / heads
SHAPES = sorted({(heads, d) for heads in (1, 2, 4, 8, 16, 32)
                 for d in (8, 40, 80, 160, 1280 // heads) if d % (32 // heads) == 0})


def temporal_grid(widths=(320, 640, 1280)):
    """(width, heads, head_dim, frames) of every call the temporal kernels must
    run (tests/test_torch_gpu.py runs them on the card): widths 320, 640, 1280
    at heads 1-40 (D = width // heads, as models/unet_blocks.py derives it, up
    to the attention's 160), F = 1, 2, 6, 8, 9, 10, 16, and F = 24, 32 at 8
    heads."""
    return [(width, heads, width // heads, f)
            for width in widths
            for heads in (1, 2, 4, 5, 8, 10, 12, 16, 20, 40) if width // heads <= 160
            for f in (1, 2, 6, 8, 9, 10, 16) + ((24, 32) if heads == 8 else ())]


_PLAN_MAIN = r"""
#include <cstdio>
#include "temporal_plan.cuh"
using namespace e2v::temporal_plan;
int main() {
  std::printf("[%d,%d,%d,%d,%d,%d]\n", kUnitBytes, kStagedMaxFrames, kWarps, kStages, kSmem,
              kDoesNotFit);
  int heads, d, f, elem, bwd;
  while (std::scanf("%d %d %d %d %d", &heads, &d, &f, &elem, &bwd) == 5) {
    const Plan p = plan(heads, d, f, elem, bwd != 0);
    std::printf("[%d,%d,%d,%d,%d,%d,%d,%d,%d,%d,%d]\n", p.route, p.units, p.W, p.lph, p.vec,
                p.iters, p.R, p.row, p.in_bytes, p.warp_bytes, p.nw);
  }
  return 0;
}
"""
_FIELDS = ("route", "units", "width", "lanes", "vec", "iters", "run", "row", "in_bytes",
           "warp_bytes", "warps")
REFUSED, STAGED, ANY = 0, 1, 2


@pytest.fixture(scope="module")
def cplan(tmp_path_factory):
    """csrc/temporal_plan.cuh compiled with the host's C++ compiler: a function of
    [(heads, head_dim, frames, itemsize, backward)] giving the kernels' constants
    and one dict of plan fields a shape."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx is not None, "no C++ compiler (g++) found"
    tmp = tmp_path_factory.mktemp("plan")
    src, exe = tmp / "plan.cpp", tmp / "plan"
    src.write_text(_PLAN_MAIN)
    csrc = os.path.join(os.path.dirname(temporal.__file__), "..", "csrc")
    subprocess.run([cxx, "-std=c++17", "-O1", "-I", csrc, "-o", str(exe), str(src)], check=True)

    def run(shapes):
        out = subprocess.run([str(exe)], input="".join(f"{h} {d} {f} {e} {int(b)}\n"
                                                       for h, d, f, e, b in shapes),
                             capture_output=True, text=True, check=True).stdout.split()
        consts = dict(zip(("unit_bytes", "staged_max_frames", "warps", "stages", "smem",
                           "does_not_fit"), json.loads(out[0])))
        plans = [dict(zip(_FIELDS, json.loads(line))) for line in out[1:]]
        assert len(plans) == len(shapes)
        return consts, plans

    return run


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("d", [40, 80, 160])
def test_model_widths_take_640_byte_units_of_five_steps(cplan, d, itemsize):
    """H = 8 at the model's head dims: every unit is 640 bytes and every lane takes
    five 4-byte steps through it (the instantiation chip_smoke.py checks for spills);
    both directions take the staged route at F = 6, eight units a forward run and
    seven a backward one."""
    units, width, vec, iters = temporal.units_of(8, d, itemsize)
    assert width * itemsize == temporal.UNIT_BYTES
    assert units * width == 8 * d and vec * itemsize == 4 and iters == 5
    consts, plans = cplan([(8, d, 6, itemsize, b) for b in (False, True)])
    assert consts["unit_bytes"] == temporal.UNIT_BYTES
    for p, run in zip(plans, (8, 7)):
        assert p["route"] == STAGED and p["run"] == run
        assert (p["units"], p["width"], p["vec"], p["iters"]) == (units, width, vec, iters)
        assert p["lanes"] == 32 * units // 8


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("heads,d", SHAPES)
def test_lanes_cover_every_value_of_a_unit_once(heads, d, itemsize):
    """A unit holds whole heads; lane j of head h takes values h D + vec (j + lph i) + e,
    which cover the unit's values exactly once."""
    units, width, vec, iters = temporal.units_of(heads, d, itemsize)
    assert units * width == heads * d and width % d == 0 and width % 32 == 0
    lph = 32 * units // heads  # lanes a head
    taken = sorted((lane // lph) * d + vec * (lane % lph + lph * i) + e
                   for lane in range(32) for i in range(iters) for e in range(vec))
    assert taken == list(range(width))


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_every_grid_shape_has_a_route_that_fits(cplan, itemsize, backward):
    """No call of the grid is refused. The staged route's units hold whole heads, its
    bulk copies move 16-byte multiples from 16-byte aligned rows, and its two stages
    fit a block's shared memory; the any route's warps fit it too."""
    nt = 4 if backward else 3
    grid = temporal_grid()
    c, plans = cplan([(heads, d, f, itemsize, backward) for _, heads, d, f in grid])
    for (_, heads, d, f), p in zip(grid, plans):
        assert p["route"] != REFUSED, (heads, d, f)
        if p["route"] == STAGED:
            assert f <= c["staged_max_frames"] and 32 % heads == 0
            assert p["units"] * p["width"] == heads * d and p["width"] % d == 0
            assert (p["width"] * itemsize) % 16 == 0 and (heads * d * itemsize) % 16 == 0
            assert 1 <= p["run"] <= c["warps"]
            assert c["stages"] * nt * f * p["run"] * p["width"] * itemsize <= c["smem"]
        else:
            # rows an odd number of 4-byte words apart: 32 rows fall on 32 banks
            assert p["row"] >= d and (p["row"] * itemsize // 4) % 2 == 1
            assert p["in_bytes"] >= nt * f * p["row"] * itemsize and p["in_bytes"] % 16 == 0
            assert 1 <= p["warps"] <= c["warps"]
            assert p["warps"] * p["warp_bytes"] <= c["smem"]
    assert {p["route"] for p in plans} == {STAGED, ANY}


def test_a_head_too_wide_for_shared_memory_is_refused_and_the_old_refusal_runs(cplan):
    """One f32 head of 1280 values over 32 frames does not fit a block's shared memory
    in either direction (refused by name on the card: the C entry returns the status
    that ``_build.check`` turns into a ValueError). Over 6 frames the backward's unit
    does not fit two stages, which refused it until the any route came; it runs there
    now, and the forward's three tensors fit one unit a run."""
    c, (fwd32, bwd32, bwd6, fwd6) = cplan([(1, 1280, 32, 4, False), (1, 1280, 32, 4, True),
                                           (1, 1280, 6, 4, True), (1, 1280, 6, 4, False)])
    assert fwd32["route"] == bwd32["route"] == REFUSED
    assert c["does_not_fit"] == _build.DOES_NOT_FIT
    assert bwd6["route"] == ANY
    assert fwd6["route"] == STAGED and fwd6["run"] == 1
    with pytest.raises(ValueError, match="temporal_attention_bwd_f32.*shared memory"):
        _build.check(_build.DOES_NOT_FIT, "temporal_attention_bwd_f32")


@pytest.mark.parametrize("itemsize", [2, 4])
def test_units_of_mirrors_the_cuda_source(cplan, itemsize):
    """``temporal.units_of`` (which names the instantiations chip_smoke.py checks)
    cuts a row as csrc/temporal_plan.cuh does at every staged shape of the grid, the
    model's, and shapes that leave the staged route for want of shared memory or are
    refused."""
    shapes = [(h, d, f, itemsize, b) for _, h, d, f in temporal_grid() + [
        (320, 8, 40, 6), (1280, 1, 1280, 6), (256, 32, 8, 3), (8000, 2, 4000, 8)]
        if 32 % h == 0 and d % (32 // h) == 0 and f <= 8 for b in (False, True)]
    _, plans = cplan(shapes)
    assert {p["route"] for p in plans} == {REFUSED, STAGED, ANY}
    for (h, d, f, _, b), p in zip(shapes, plans):
        if p["route"] == STAGED:
            units, width, vec, iters = temporal.units_of(h, d, itemsize)
            assert (p["units"], p["width"], p["vec"], p["iters"]) == (units, width, vec, iters)
            assert p["lanes"] == 32 * units // h, (h, d, f, b)


def test_geglu_out_bwd_l2_read_bytes_matches_a_hand_count():
    """T = 130, I = 200, C = 96: 2 x 2 tiles of 128; each reads its rows of g (C values)
    and W's C rows at its columns; h2 once."""
    g_bytes = 2 * (130 * 96)        # two columns of tiles, each all 130 rows of g
    w_bytes = 2 * (96 * 200)        # two rows of tiles, each all of W
    h2_bytes = 130 * 400
    assert geglu.geglu_out_bwd_l2_read_bytes(130, 200, 96) == 2 * (g_bytes + w_bytes + h2_bytes)
    # the train step's level 2: 68 x 40 tiles
    assert geglu.geglu_out_bwd_l2_read_bytes(8640, 5120, 1280) == 2 * (
        40 * 8640 * 1280 + 68 * 1280 * 5120 + 8640 * 10240)


_INT8_MAIN = r"""
#include <cstdio>
#include "int8_plan.cuh"
using namespace e2v::int8_plan;
int main() {
  std::printf("[%d,%d,%d,%d,%d,%d,[", kCols, kSlabK, kCluster, kStages, kSmemMax, kMaxWidth);
  for (int i = 0; i < kNumWidths; ++i) std::printf(i ? ",%d" : "%d", kWidths[i]);
  std::printf("]]\n");
  int m, kp, np;
  while (std::scanf("%d %d %d", &m, &kp, &np) == 3) {
    const Plan p = plan(m, kp, np);
    std::printf("[%d,%d,%d,%d,%d,%lld,%lld,%lld,[", p.slabs, p.tiles, p.splits, p.width,
                p.row_blocks, p.smem, workspace_bytes(p, m, kp, np), x_l2_read_bytes(p, m, kp));
    for (int i = 0; i <= p.splits; ++i)
      std::printf(i ? ",%d" : "%d", split_begin(p.slabs, p.splits, i));
    std::printf("]]\n");
  }
  return 0;
}
"""
# (M, Kp, Np) of the semantic MLP's layers (310 -> 4 x 10000 -> 77 * 768, N
# padded to 512 by quantize_int8) at one row, the serving chunk's 100 rows,
# and M around the kernel's widths
MLP_LAYERS = [(320, 10240), (10016, 10240), (10016, 59392)]
INT8_ROWS = (1, 7, 8, 9, 64, 65, 100, 104, 105, 113, 200, 1000)


@pytest.fixture(scope="module")
def int8_cplan(tmp_path_factory):
    """csrc/int8_plan.cuh compiled with the host's C++ compiler: a function of
    [(M, Kp, Np)] giving the kernel's constants and one dict of plan fields a call."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx is not None, "no C++ compiler (g++) found"
    tmp = tmp_path_factory.mktemp("int8_plan")
    src, exe = tmp / "plan.cpp", tmp / "plan"
    src.write_text(_INT8_MAIN)
    csrc = os.path.join(os.path.dirname(int8_dense.__file__), "..", "csrc")
    subprocess.run([cxx, "-std=c++17", "-O1", "-I", csrc, "-o", str(exe), str(src)], check=True)

    def run(calls):
        out = subprocess.run([str(exe)], input="".join(f"{m} {kp} {np_}\n" for m, kp, np_ in calls),
                             capture_output=True, text=True, check=True).stdout.split()
        consts = dict(zip(("cols", "slab_k", "cluster", "stages", "smem_max", "max_width",
                           "widths"), json.loads(out[0])))
        fields = ("slabs", "tiles", "splits", "width", "row_blocks", "smem", "workspace_bytes",
                  "x_l2_bytes", "begins")
        plans = [dict(zip(fields, json.loads(line))) for line in out[1:]]
        assert len(plans) == len(calls)
        return consts, plans

    return run


@pytest.mark.parametrize("kp,np_", MLP_LAYERS)
def test_int8_plan_covers_k_once_and_fits_shared_memory(int8_cplan, kp, np_):
    """Every layer of the semantic MLP at every row count: the splits cover the K
    slabs once, each at least one slab; the column tiles cover Np in whole
    clusters; the rows fit the instantiated width (several row blocks above the
    widest); a block's ring fits its shared memory; the workspace holds two
    counters a tile, x in bf16 and, with a split, every split's partial sums."""
    c, plans = int8_cplan([(m, kp, np_) for m in INT8_ROWS])
    for m, p in zip(INT8_ROWS, plans):
        b = p["begins"]
        assert p["slabs"] * c["slab_k"] >= kp > (p["slabs"] - 1) * c["slab_k"]
        assert b[0] == 0 and b[-1] == p["slabs"] and len(b) == p["splits"] + 1
        assert all(hi > lo for lo, hi in zip(b, b[1:])), b
        assert p["tiles"] % c["cluster"] == 0
        assert p["tiles"] * c["cols"] >= np_ > (p["tiles"] - c["cluster"]) * c["cols"]
        assert p["width"] in c["widths"] and p["width"] % 8 == 0
        assert p["width"] == (8 if m <= 8 else 104)
        assert p["row_blocks"] * p["width"] >= m > (p["row_blocks"] - 1) * p["width"]
        assert m > c["max_width"] or p["row_blocks"] == 1
        assert p["smem"] == 1024 + c["stages"] * (c["cols"] * c["slab_k"] + p["width"] * 128)
        assert p["smem"] <= c["smem_max"]
        partials = p["splits"] * m * np_ * 4 if p["splits"] > 1 else 0
        assert p["workspace_bytes"] >= p["tiles"] * p["row_blocks"] * 8 + m * kp * 2 + partials


def test_int8_plan_splits_from_the_weight_shape_alone(int8_cplan):
    """A row's bits must not depend on M: the split of K is the same at every row
    count. The middle layers (10 clusters of 4 x 256 columns) take 3 splits, 120
    blocks for 132 SMs; the first layer too (5 slabs); the out layer (58 clusters)
    none."""
    calls = [(m, kp, np_) for kp, np_ in MLP_LAYERS for m in INT8_ROWS]
    _, plans = int8_cplan(calls)
    by_layer = {}
    for (m, kp, np_), p in zip(calls, plans):
        by_layer.setdefault((kp, np_), set()).add((p["splits"], tuple(p["begins"])))
    assert all(len(v) == 1 for v in by_layer.values()), by_layer
    splits = {k: next(iter(v))[0] for k, v in by_layer.items()}
    assert splits == {(320, 10240): 3, (10016, 10240): 3, (10016, 59392): 1}
    tiles = {(kp, np_): p["tiles"] for (m, kp, np_), p in zip(calls, plans)}
    assert tiles == {(320, 10240): 40, (10016, 10240): 40, (10016, 59392): 232}


@pytest.mark.parametrize("np_", [128, 256, 1280, 10240, 59392])
@pytest.mark.parametrize("kp", [32, 64, 96, 320, 6400, 10016])
def test_int8_plan_mirror_equals_the_header(int8_cplan, kp, np_):
    """``int8_dense.k_splits``, the one part of the plan with a Python mirror, and
    the constants it reads give what csrc/int8_plan.cuh gives, at one K step, the
    MLP's shapes and others."""
    calls = [(m, kp, np_) for m in INT8_ROWS]
    c, plans = int8_cplan(calls)
    assert (c["cols"], c["slab_k"], c["cluster"]) == (int8_dense.BLOCK_COLS, int8_dense.SLAB_K,
                                                      int8_dense.CLUSTER)
    for (m, _, _), p in zip(calls, plans):
        assert int8_dense.k_splits(np_, kp) == p["splits"], (m, kp, np_)


def test_int8_x_l2_read_bytes_matches_a_hand_count(int8_cplan):
    """Each cluster of four 256-column blocks reads x's (M, Kp) bf16 once: the out layer
    at 100 rows, 58 clusters x 2.0 MB, about 0.19 of its weight's bytes."""
    _, (out, mid, one) = int8_cplan([(100, 10016, 59392), (100, 10016, 10240), (1, 32, 128)])
    assert out["x_l2_bytes"] == 58 * 100 * 10016 * 2
    assert mid["x_l2_bytes"] == 10 * 100 * 10016 * 2
    assert one["x_l2_bytes"] == 1 * 1 * 32 * 2
    assert out["x_l2_bytes"] / (10016 * 59392) < 0.25
