"""The band geometry of B5 and B6 (``ops/fused_model.band_rows``): how many
image rows a block of the band pass holds and how much shared memory it
asks for, on the repo's shapes.  Light: no twin, no JAX, no card."""

import pytest

torch = pytest.importorskip("torch")

from better_flow_tpu_torch.config import (  # noqa: E402
    SensorConfig, low_latency_config,
)
from better_flow_tpu_torch.models.global_flow import (  # noqa: E402
    static_image_shape,
)
from better_flow_tpu_torch.ops import fused_model as fm  # noqa: E402

SMS = 132
SHARED_PER_BLOCK = 227 * 1024

# sensor, scale, the band height expected
SHAPES = {
    "production 180x240 scale 3": ((180, 240), 3, 3),
    "live preset scale 1": (None, 1, 1),
    "megapixel 720x1280 scale 1": ((720, 1280), 1, 3),
    "small 24x32 scale 3": ((24, 32), 3, 1),
    "tiled test 96x128 scale 3": ((96, 128), 3, 2),
}


def _image(res, scale):
    sensor = low_latency_config().sensor if res is None else \
        SensorConfig(*res)
    return static_image_shape(scale, sensor)


@pytest.mark.parametrize("name", list(SHAPES))
def test_band_rows_on_repo_shapes(name):
    res, scale, want = SHAPES[name]
    H, W = _image(res, scale)
    R, smem = fm.band_rows(H, W, scale, SMS)
    assert R == want
    assert smem == fm.band_smem_bytes(R, W, scale)
    assert smem <= fm.BAND_SMEM_BUDGET <= SHARED_PER_BLOCK
    if H >= SMS:
        assert -(-H // R) >= SMS          # at least one band per SM
    # The largest such R: one more row breaks a condition.
    assert (R == fm.BAND_MAX_ROWS or -(-H // (R + 1)) < SMS
            or fm.band_smem_bytes(R + 1, W, scale) > fm.BAND_SMEM_BUDGET)


def test_production_band_layout_bytes():
    """The layout at the main path's shapes (543x723 at scale 3, R = 3),
    counted by hand: the three rows' leaves of nine f64 sums, 3 * 9 * 256
    * 8 bytes, in the space of the staged time and count rows (2 * 7 rows
    * 728 floats, fewer bytes); then the f32 rows, 5 * 728 floats.  Wide
    rows: the staged rows take more space than the leaves."""
    assert 2 * 7 * 728 * 4 < 3 * 9 * 256 * 8
    assert fm.band_smem_bytes(3, 723, 3) == (
        3 * 9 * 256 * 8 + 4 * 5 * 728) == 69856
    assert fm.band_smem_bytes(1, 3663, 3) == (
        2 * 5 * 3668 * 4 + 4 * 3 * 3668) == 190736
    # Never below what the tail reuses it as (finish.cuh's FinishShared).
    assert fm.band_smem_bytes(1, 3, 1) >= 9 * 256 * 8


def test_wide_image_forces_one_row_and_too_wide_raises():
    H, W = static_image_shape(3, SensorConfig(100, 1220))   # 303 x 3663
    assert -(-H // 2) >= SMS
    assert fm.band_smem_bytes(2, W, 3) > fm.BAND_SMEM_BUDGET
    assert fm.band_rows(H, W, 3, SMS)[0] == 1
    with pytest.raises(ValueError, match="shared memory"):
        fm.band_rows(H, 5000, 3, SMS)


def test_band_height_is_capped_and_follows_the_sm_count():
    H, W = static_image_shape(3, SensorConfig(180, 240))
    assert fm.band_rows(H, W, 3, 66)[0] == fm.BAND_MAX_ROWS == 3
    assert fm.band_rows(H, W, 3, 200)[0] == 2
    assert fm.band_rows(H, W, 3, 1000)[0] == 1


@pytest.mark.parametrize("tiles,H,W,n_tiles,want_R,want_bytes", [
    ("1x1", 785, 1345, 1, 3, 82_256), ("4x2 one tile", 245, 705, 1, 1, None),
    ("4x2 batch", 245, 705, 8, 3, 69_456)])
def test_band_rows_counts_the_bands_of_every_tile(tiles, H, W, n_tiles,
                                                  want_R, want_bytes):
    """B9's batch at the tiled path's shapes (720x1280, scale 1, halo 32):
    the bands of all the tiles count toward one band per SM, each tile's
    rows apart (never ``H * n_tiles`` rows).  One 4x2 tile alone has 123
    two-row bands, fewer than the SMs; the batch of eight 656 three-row
    bands: 3 * 9 * 256 * 8 bytes of leaves and 5 f32 rows of 708."""
    R, smem = fm.band_rows(H, W, 1, SMS, n_tiles)
    assert R == want_R
    assert smem == fm.band_smem_bytes(R, W, 1)
    if want_bytes is not None:
        assert smem == want_bytes
    if n_tiles == 8:
        assert 8 * -(-H // 3) == 656 >= SMS
        assert smem == 3 * 9 * 256 * 8 + 4 * 5 * 708
    else:
        assert -(-H // (R + 1)) < SMS or R == fm.BAND_MAX_ROWS
    assert fm.band_rows(H, W, 1, SMS) == fm.band_rows(H, W, 1, SMS, 1)
