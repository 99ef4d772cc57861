"""Every logged stat-matched replica under 200k nonzeros equal, array for
array, to ``loops_tpu.utils.statmatch.replica`` at seed 1, the seed of
the rep population (seed 0 in ``test_torch_statmatch.py``; the two
halves run in separate files so that each stays short)."""
import pytest

from test_torch_statmatch import SMALL, replica_equal


@pytest.mark.parametrize("name", SMALL)
def test_replica_equal_seed1(name):
    replica_equal(name, 1)
