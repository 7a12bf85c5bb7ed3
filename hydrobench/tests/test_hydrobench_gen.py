"""The generators give the same inputs for one seed and others for
another, with the same sizes."""

import numpy as np
import torch

from hydrobench.gen import forcing, networks

BIG = 2 ** 31 + 12345


def test_conus_network_is_a_function_of_the_seed():
    net = dict(segments=5000, basins=50, span=4, lake_per_segments=100)
    a, b = networks.conus_network(net, BIG), networks.conus_network(net, BIG)
    c = networks.conus_network(net, BIG + 1)
    for k in ("ids", "down", "lakes", "lake_params"):
        np.testing.assert_array_equal(a[k], b[k])
    for k in networks.CHANNEL_KEYS:
        np.testing.assert_array_equal(a["chan"][k], b["chan"][k])
    assert not np.array_equal(a["down"], c["down"])
    assert a["ids"].size == c["ids"].size == 5000
    # lakes sit on inner segments and never drain straight into a lake
    lakes = a["lakes"]
    assert np.all(a["down"][lakes] > 0)
    assert not np.isin(a["down"][lakes] - 1, lakes).any()
    assert np.all(a["chan"]["dx"][lakes] == 1.0)


def test_synthetic_conus_keeps_the_conus_skew():
    ids, down = networks.synthetic_conus(100_000, 540, seed=3)
    tails = np.flatnonzero(down == 0)
    sizes = np.diff(np.concatenate([[-1], tails]))
    assert tails.size == 540
    assert sizes.max() == 45_000          # the Mississippi's share
    assert np.all(down[down > 0] > ids[down > 0])   # hops go forward


def test_bmi_pushes_are_a_function_of_the_seed():
    net = dict(segments=2000, basins=20, lake_per_segments=100)
    a, b = networks.bmi_pushes(net, BIG), networks.bmi_pushes(net, BIG)
    c = networks.bmi_pushes(net, 7)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["segment_id"], c["segment_id"])
    # pushed in a drawn order, not sorted; every lake between two segments
    assert not np.all(np.diff(a["segment_id"]) > 0)
    fed = np.isin(a["segment_toid"], a["waterbody_id"])
    assert fed.sum() == 20
    assert np.isin(a["waterbody_toid"], a["segment_id"]).all()


def test_forcing_rings_are_a_function_of_the_seed():
    t = dict(spinup_units=1, baseflow=dict(low=0.1, high=2.0, ring=24),
             storm=None)
    a = forcing.baseflow_ring(t, 1000, BIG, "cpu")
    b = forcing.baseflow_ring(t, 1000, BIG, "cpu")
    c = forcing.baseflow_ring(t, 1000, BIG + 1, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (24, 1000)
    assert float(a.min()) >= 0.1 and float(a.max()) < 2.0
    assert forcing.window_ring(t, a, BIG) is a


def test_storm_ring():
    t = dict(spinup_units=1, baseflow=dict(low=0.1, high=2.0, ring=24),
             storm=dict(share=0.2, rise=6, recede=12, peak_low=5.0,
                        peak_high=40.0))
    base = forcing.baseflow_ring(t, 1000, 11, "cpu")
    ring = forcing.window_ring(t, base, 11)
    again = forcing.window_ring(t, base, 11)
    assert torch.equal(ring, again)
    assert ring.shape == (72, 1000)        # lcm(24, 18) hours, 4 storms
    extra = ring - base[torch.arange(72) % 24]
    for storm in range(4):
        peak = extra[storm * 18 + 5]       # the end of the rise
        on = peak > 0
        assert int(on.sum()) == 200        # 20% of the segments
        idx = torch.nonzero(on).flatten()
        assert int(idx[-1] - idx[0]) == 199     # one run of segments
        assert float(peak[on].min()) >= 5.0
        assert float(peak[on].max()) < 40.0 + 1e-4
        # rises linearly, then recedes to nothing at the storm's end
        np.testing.assert_allclose(extra[storm * 18][on], peak[on] / 6,
                                   rtol=1e-5)
        np.testing.assert_allclose(extra[storm * 18 + 11][on],
                                   peak[on] * 6 / 12, rtol=1e-5)
        assert float(extra[storm * 18 + 17].abs().max()) == 0.0
    assert [forcing.storm_factor(t, h) for h in (0, 5, 6, 17)] == \
        [1 / 6, 1.0, 11 / 12, 0.0]
