"""The AWB expert placement's properties on the port (hypothesis), as
``tests/test_moe.py`` states them for the reference, with every placement
also equal to the reference's array for array. Skipped wholesale when
hypothesis is absent, like the other property suites."""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="property tests need hypothesis "
                    "(pip install -r requirements-dev.txt)")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import moe_balance as jbal  # noqa: E402
from repro_torch.core import moe_balance as tbal  # noqa: E402


@settings(max_examples=25, deadline=None)
@given(st.integers(8, 64), st.integers(2, 8), st.integers(0, 3),
       st.integers(0, 2**16))
def test_placement_properties(e, d, spare_per_dev, seed):
    load = tbal.zipf_expert_load(e, 10000, alpha=1.0, seed=seed)
    spd = -(-e // d) + spare_per_dev
    p = tbal.balance_placement(load, d, slots_per_device=spd)
    # every expert has >= 1 replica and replica counts match slot counts
    assert (p.replica_count >= 1).all()
    placed = p.slots[p.slots >= 0]
    counts = np.bincount(placed, minlength=e)
    np.testing.assert_array_equal(counts, p.replica_count)
    # no device exceeds its slots
    assert p.slots.shape == (d, spd)
    want = jbal.balance_placement(load, d, slots_per_device=spd)
    for a, b in ((p.slots, want.slots), (p.replica_count, want.replica_count),
                 (p.replica_rank, want.replica_rank)):
        assert np.array_equal(a, b)


@settings(max_examples=25, deadline=None)
@given(st.integers(2, 64), st.integers(1, 8), st.integers(0, 3),
       st.integers(0, 2**16), st.floats(0.0, 2.0))
def test_device_loads_conserve_the_load_and_equal_the_reference(e, d, spare, seed,
                                                                 alpha):
    """Replicas split an expert's load without losing any of it, and both
    packages agree on every device's load and the imbalance."""
    load = tbal.zipf_expert_load(e, 5000, alpha=alpha, seed=seed)
    spd = -(-e // d) + spare
    for tp, jp in ((tbal.static_placement(e, d), jbal.static_placement(e, d)),
                   (tbal.balance_placement(load, d, slots_per_device=spd),
                    jbal.balance_placement(load, d, slots_per_device=spd))):
        got = tbal.device_loads(tp, load)
        np.testing.assert_allclose(got.sum(), load.sum(), rtol=1e-12)
        assert np.array_equal(got, jbal.device_loads(jp, load))
        assert tbal.imbalance(got) == jbal.imbalance(got)
