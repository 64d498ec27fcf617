"""Shard-splitting properties of the port (hypothesis), as
``tests/test_shard_properties.py`` states them for the reference: the
contiguous step split partitions all steps exactly once for arbitrary
(n_steps, n_devices) — including n_devices > n_steps — and equals the
reference's split; shard work stays within one step budget of the mean;
the stacked shards conserve every slot. Skipped wholesale when hypothesis
is absent, like the other property suites."""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="property tests need hypothesis "
                    "(pip install -r requirements-dev.txt)")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.sharding import schedule_shard as jshard  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.graphs import synth as tsynth  # noqa: E402
from repro_torch.sharding import schedule_shard as tshard  # noqa: E402




@settings(max_examples=60, deadline=None)
@given(n_steps=st.integers(0, 5000), n_devices=st.integers(1, 128))
def test_split_partitions_steps_exactly_once(n_steps, n_devices):
    ranges = tshard.split_step_ranges(n_steps, n_devices)
    assert np.array_equal(ranges, jshard.split_step_ranges(n_steps, n_devices))
    assert ranges.shape == (n_devices, 2)
    assert ranges[0, 0] == 0 and ranges[-1, 1] == n_steps
    np.testing.assert_array_equal(ranges[1:, 0], ranges[:-1, 1])
    sizes = ranges[:, 1] - ranges[:, 0]
    assert (sizes >= 0).all() and int(sizes.sum()) == n_steps
    assert int(sizes.max() - sizes.min()) <= (1 if n_steps else 0)
    np.testing.assert_array_equal(sizes, tshard.shard_step_counts(n_steps, n_devices))


@st.composite
def sched_case(draw):
    n = draw(st.integers(24, 150))
    alpha = draw(st.sampled_from([0.6, 0.9, 1.2]))
    density = draw(st.sampled_from([0.02, 0.05, 0.12]))
    seed = draw(st.integers(0, 2**16))
    k = draw(st.sampled_from([8, 16, 33]))
    r = draw(st.sampled_from([4, 16]))
    d = draw(st.integers(1, 48))
    return n, density, alpha, seed, k, r, d


@settings(max_examples=25, deadline=None)
@given(sched_case())
def test_shard_work_within_one_step_budget_of_mean(case):
    n, density, alpha, seed, k, r, d = case
    a = tsynth.power_law_adjacency(n, density, alpha, seed=seed)
    s = tsched.build_balanced_schedule(a, nnz_per_step=k, rows_per_window=r)
    issued = tshard.shard_step_counts(s.n_steps, d) * s.nnz_per_step
    assert (np.abs(issued - issued.mean()) <= s.nnz_per_step).all()
    nnz = tshard.shard_nnz(s, d)
    assert int(nnz.sum()) == s.nnz
    assert (nnz >= 0).all() and (nnz <= issued).all()


@settings(max_examples=15, deadline=None)
@given(sched_case())
def test_stacked_shards_conserve_slots(case):
    n, density, alpha, seed, k, r, d = case
    a = tsynth.power_law_adjacency(n, density, alpha, seed=seed)
    s = tsched.build_balanced_schedule(a, nnz_per_step=k, rows_per_window=r)
    shards = tshard.shard_schedule(s, d)
    sizes = shards.ranges[:, 1] - shards.ranges[:, 0]
    val = np.concatenate([shards.val[i, :sizes[i]] for i in range(d)])
    np.testing.assert_array_equal(val.reshape(-1), s.val)
    for i in range(d):
        assert not shards.val[i, sizes[i]:].any()
