"""The traffic: the same seed gives the same events, every seed the same
sizes, and the live stream's packets are the stream."""

import numpy as np
import pytest

from conftest import TINY_SEED, tiny_cell
from portbench import traffic


@pytest.mark.parametrize("subpixel", [False, True])
def test_recordings_repeat_by_seed(subpixel):
    mix = tiny_cell("offline-fast-long", subpixel).mix
    a = traffic.recordings(mix, TINY_SEED)
    b = traffic.recordings(mix, TINY_SEED)
    c = traffic.recordings(mix, TINY_SEED + 1)
    assert len(a) == mix["pool_recordings"]
    for ra, rb, rc in zip(a, b, c):
        for k in ("x", "y", "t_ns"):
            np.testing.assert_array_equal(ra[k], rb[k])
        assert len(ra["t_ns"]) == len(rc["t_ns"]) == mix["recording_events"]
        assert not np.array_equal(ra["x"], rc["x"])
        assert np.all(np.diff(ra["t_ns"]) >= 0)
    integral = np.all(a[0]["x"] == np.floor(a[0]["x"]))
    assert integral == (not mix.get("subpixel"))
    assert a[0]["x"].max() < mix["scene"]["res_x"]


def test_pool_recordings_differ():
    a = traffic.recordings(tiny_cell("offline-fast-long").mix, TINY_SEED)
    assert not np.array_equal(a[0]["x"], a[1]["x"])


def test_stream_repeats_by_seed_and_packets_tile():
    mix = tiny_cell("live-ros-steady").mix
    s1 = traffic.stream(mix, TINY_SEED, 1.5)
    s2 = traffic.stream(mix, TINY_SEED, 1.5)
    whole = s1.events(int(1.2e9))
    np.testing.assert_array_equal(whole[2], s2.events(int(1.2e9))[2])
    parts = [s1.take(lo, lo + 1_000_000)
             for lo in range(0, int(1.2e9), 1_000_000)]
    for k in range(3):
        np.testing.assert_array_equal(
            np.concatenate([p[k] for p in parts]), whole[k])
    rate = len(whole[2]) / 1.2
    assert 0.9 * mix["rate_eps"] < rate <= mix["rate_eps"]
    # Another seed takes the same pool in another order: over a stream of
    # 40 segments, two seeds' orders differ.
    order = lambda seed: traffic.stream(mix, seed, 20.0).order
    assert not np.array_equal(order(TINY_SEED + 1), order(TINY_SEED))


def test_a_fixed_pool_gives_every_seed_the_same_work():
    mix = dict(tiny_cell("live-ros-steady").mix, pool_segments=4,
               segment_s=0.05)
    a, b = (traffic.stream(mix, TINY_SEED + k, 2.0) for k in (0, 1))
    for sa, sb in zip(a.segs, b.segs):
        np.testing.assert_array_equal(sa["x"], sb["x"])
    assert not np.array_equal(a.order, b.order)
    for s in (a, b):
        for r in range(0, len(s.order) - 4, 4):
            assert sorted(s.order[r:r + 4]) == [0, 1, 2, 3]
    c = traffic.stream(dict(mix, pool_seed=mix["pool_seed"] + 1),
                       TINY_SEED, 2.0)
    assert not np.array_equal(c.segs[0]["x"], a.segs[0]["x"])
