"""Host-side plans of the port's CUDA kernels, checked on the CPU.

``temporal.bwd_plan`` says how ``temporal_attention_bwd`` cuts a token's row
of (B, F, L, H*D) operands into units (csrc/temporal_attention.cu mirrors
it); ``geglu.geglu_out_bwd_l2_read_bytes`` counts what ``geglu_out_bwd``'s
tiles copy from L2. The kernels themselves run only on the card
(tests/test_torch_gpu.py).
"""

import pytest

from eeg2video_tpu_torch.ops import geglu, temporal

# every (heads, head_dim) the wrapper takes at these widths: heads divides 32,
# head_dim a multiple of 32 / heads
SHAPES = sorted({(heads, d) for heads in (1, 2, 4, 8, 16, 32)
                 for d in (8, 40, 80, 160, 1280 // heads) if d % (32 // heads) == 0})


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("d", [40, 80, 160])
def test_model_widths_take_640_byte_units_of_five_steps(d, itemsize):
    """H = 8 at the model's head dims: every unit is 640 bytes and every lane takes
    five 4-byte steps through it (the instantiation chip_smoke.py checks for spills)."""
    units, width, vec, iters = temporal.bwd_plan(8, d, itemsize)
    assert width * itemsize == temporal.BWD_UNIT_BYTES
    assert units * width == 8 * d and vec * itemsize == 4 and iters == 5


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("heads,d", SHAPES)
def test_lanes_cover_every_value_of_a_unit_once(heads, d, itemsize):
    """A unit holds whole heads; lane j of head h takes values h D + vec (j + lph i) + e,
    which cover the unit's values exactly once."""
    units, width, vec, iters = temporal.bwd_plan(heads, d, itemsize)
    assert units * width == heads * d and width % d == 0 and width % 32 == 0
    lph = 32 * units // heads  # lanes a head
    taken = sorted((lane // lph) * d + vec * (lane % lph + lph * i) + e
                   for lane in range(32) for i in range(iters) for e in range(vec))
    assert taken == list(range(width))


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
