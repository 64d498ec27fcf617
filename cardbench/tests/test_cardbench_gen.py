"""The frozen generator against the port's ``graphs.synth``: bit-equal."""

import numpy as np
import pytest

from cardbench import gen
from repro_torch.graphs import synth


@pytest.mark.parametrize("n, density, alpha, max_degree, seed", [
    (500, 0.01, 0.55, 60, 0),
    (800, 0.004, 1.05, 90, 7),
    (300, 0.02, 0.8, None, 2**31 + 11),
])
def test_frozen_adjacency_is_bit_equal_to_the_port(n, density, alpha, max_degree, seed):
    rows, cols, vals = gen.power_law_adjacency(n, density, alpha, seed=seed,
                                               max_degree=max_degree)
    coo = synth.power_law_adjacency(n, density, alpha, seed=seed, max_degree=max_degree)
    np.testing.assert_array_equal(rows, coo.row.numpy())
    np.testing.assert_array_equal(cols, coo.col.numpy())
    np.testing.assert_array_equal(vals, coo.val.numpy())
    assert rows.dtype == np.int64 and vals.dtype == np.float32


def test_frozen_adjacency_is_sorted_with_self_loops():
    rows, cols, _ = gen.power_law_adjacency(400, 0.01, 0.7, seed=3, max_degree=50)
    key = rows * 400 + cols
    assert np.all(np.diff(key) > 0)
    assert set(np.arange(400)) <= set(rows[rows == cols])
