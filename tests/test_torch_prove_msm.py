"""The commit and prove entry-point tests of tests/test_torch_prove.py,
run through the windowed Pippenger (comb_h = 0, kernel K7's plain
version) instead of the comb.  A file of its own, so that the two commit
paths run in parallel test workers."""

import pytest

import test_torch_prove as base
from test_torch_prove import (  # noqa: F401 (fixtures and tests collected here too)
    arrays,
    one_thread,
    osetup,
    test_blob_proofs_match_oracle,
    test_commitments_match_oracle,
    test_kzg_proofs_match_oracle,
    test_single_entry_points_match_oracle,
)


@pytest.fixture(scope="module")
def kzg(arrays):
    return base.make_kzg(arrays, 0)

