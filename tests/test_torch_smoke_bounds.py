"""The one counting rule of ``chip_smoke.py``'s bounds for an image pair.

``pair_bytes`` gives the bytes of an image pair (int64 time and int32 count
images, 12 B a pixel) that a kernel's bound counts: a finish reads each
logical H x W pixel of every image once, not the padding the pair carries;
a splat writes each pixel it hits once, however many events land there; an
image that never leaves the launch counts nothing.  Held here on the CPU
with a tiny pair, and on the splat of B1's twin.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from better_flow_tpu_torch.ops import fused_model as tfm  # noqa: E402
from torch_inputs import H, SCALE, W, slice_inputs  # noqa: E402

TINY_H, TINY_W = 5, 6


@pytest.mark.parametrize("tiles", [None, 3])
def test_a_finish_counts_the_logical_pixels_not_the_padding(tiles):
    """A finish counts 12 B for each of the H x W pixels of each tile; the
    pair's padded rows and columns (128 x 256 here) are not counted."""
    _, acc_c = tfm.image_pair("cpu", TINY_H, TINY_W, n_tiles=tiles)
    assert acc_c.shape[-2:] == (128, 256)
    n_img = 1 if tiles is None else tiles
    assert cs.pair_bytes("finish", acc_c, TINY_H, TINY_W) == \
        12 * n_img * TINY_H * TINY_W


def test_a_splat_counts_each_hit_pixel_once():
    """A splat counts 12 B for each pixel it hit, once however many events
    it holds; pixels it did not hit, padding or not, count nothing."""
    _, acc_c = tfm.image_pair("cpu", TINY_H, TINY_W)
    acc_c[1, 1] = 5
    acc_c[2, 3] = 1
    acc_c[4, 5] = 2
    assert cs.pair_bytes("splat", acc_c) == 12 * 3


def test_a_splat_of_b1s_twin_counts_its_distinct_pixels():
    """On B1's twin: the count image's distinct hit pixels, fewer than the
    events it holds (they pile up), and none in the padding."""
    d = slice_inputs(0)
    args = [torch.from_numpy(np.ascontiguousarray(d[k]))
            for k in ("stat", "act", "pr", "st", "geo")]
    _, _, ac = tfm.warp_images_st_plain(*args, *tfm.image_pair("cpu", H, W),
                                        scale=SCALE, H=H, W=W)
    hit = int((ac > 0).sum())
    assert 0 < hit < int(ac.sum())
    assert not ac[H:].any() and not ac[:, W:].any()
    assert cs.pair_bytes("splat", ac) == 12 * hit


def test_an_internal_image_counts_nothing_and_roles_are_checked():
    assert cs.pair_bytes("internal") == 0
    with pytest.raises(ValueError, match="unknown role"):
        cs.pair_bytes("zeroing")
