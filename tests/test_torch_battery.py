"""The synthetic sweep battery against ``loops_tpu``'s: the same names at
every ``max_rows`` cap, and every recipe up to 16384 rows giving the same
CSR, array for array (shape, offsets, indices and values, with their
dtypes)."""
import numpy as np
import pytest

from loops_tpu.utils import battery as jb
from loops_tpu_torch.utils import battery as tb

SMALL = 16384


@pytest.mark.parametrize("max_rows", [2048, 4096, SMALL, 65536])
def test_names_equal(max_rows):
    assert tb.names(max_rows) == jb.names(max_rows)
    assert set(tb.battery(max_rows)) == set(jb.battery(max_rows))


@pytest.mark.parametrize("name", tb.names(SMALL))
def test_build_equal(name):
    t, j = tb.build(name, SMALL), jb.build(name, SMALL)
    assert t.shape == j.shape
    for field in ("offsets", "indices", "vals"):
        a, b = getattr(t, field), getattr(j, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=f"{name}.{field}")


def test_build_is_deterministic():
    a, b = tb.build("rmat_n8192_d8_g500_s0"), tb.build("rmat_n8192_d8_g500_s0")
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.vals, b.vals)
    with pytest.raises(KeyError):
        tb.build("no_such_matrix")
