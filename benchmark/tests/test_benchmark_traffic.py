"""The generators: the same seed gives the same inputs and schedule, and
every seed the same amount of work."""

import numpy as np
import pytest

from benchmark.tests.tiny import tiny_cell
from benchmark.traffic.arrivals import periodic
from benchmark.traffic.generate import make_traffic

SEEDS = (2**33 + 17, 2**33 + 18)


@pytest.mark.parametrize("name", ["shelf_jln64.heatmaps.live", "panoptic_jln64.images.live"])
def test_same_seed_same_traffic(name):
    cell = tiny_cell(name, pool=4)
    a = make_traffic(cell.mix, cell.config, 30.0, 1.0, SEEDS[0], "cpu")
    b = make_traffic(cell.mix, cell.config, 30.0, 1.0, SEEDS[0], "cpu")
    c = make_traffic(cell.mix, cell.config, 30.0, 1.0, SEEDS[1], "cpu")
    assert np.array_equal(a.rig, b.rig) and np.array_equal(a.due, b.due)
    assert np.array_equal(a.order, b.order)
    assert all(np.array_equal(x, y) for x, y in zip(a.pool, b.pool))
    assert not all(np.array_equal(x, y) for x, y in zip(a.pool, c.pool))
    assert len(a.due) == len(c.due) == 30
    assert sorted(a.people) == sorted(c.people) or max(a.people) <= 10


def test_people_counts_spread_evenly_over_the_pool():
    cell = tiny_cell("shelf_jln64.heatmaps.live", pool=20)
    t = make_traffic(cell.mix, cell.config, 10.0, 1.0, SEEDS[0], "cpu")
    want = sorted(np.resize(np.arange(1, 5), 20))  # K = 4 in the tiny cell
    assert sorted(t.people) == want or sum(t.people) >= sum(want) - 2


def test_periodic_schedule():
    due = periodic(50.0, 2.0, 0.25, np.random.default_rng(3))
    assert len(due) == 100
    period = np.diff(due)
    assert (period > 0).all() and abs(due.mean() - 1.0) < 0.02
    k = np.arange(100)
    assert (np.abs(due * 50.0 - (k + 0.5)) <= 0.25 + 1e-9).all()


def test_heatmaps_peak_at_the_visible_joints():
    cell = tiny_cell("shelf_jln64.heatmaps.live", pool=2)
    t = make_traffic(cell.mix, cell.config, 10.0, 1.0, SEEDS[0], "cpu")
    for hm in t.pool:
        assert hm.dtype == np.float32 and hm.shape == (3, 16, 32, 17)
        assert 0.0 <= hm.min() and hm.max() <= 1.0 and hm.max() > 0.5


def test_frames_are_uint8_views():
    cell = tiny_cell("panoptic_jln64.images.live", pool=2)
    t = make_traffic(cell.mix, cell.config, 10.0, 1.0, SEEDS[0], "cpu")
    for f in t.pool:
        assert f.dtype == np.uint8 and f.shape == (3, 64, 128, 3) and f.flags["C_CONTIGUOUS"]
