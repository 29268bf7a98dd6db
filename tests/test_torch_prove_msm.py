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


@pytest.mark.parametrize("n", [1, 3, 5])
def test_small_batches_match_oracle(arrays, osetup, n):
    """1, 3 and 5 blobs run on 1, 4 and 8 lanes through the windowed
    commit at msm_window = 2, byte for byte as the oracle has them.  A
    windowed commit or proof takes about 15 s here, so the blob proofs
    stand for compute_kzg_proofs (the same prove program), and the split
    into programs of 8 is left to the comb's cases."""
    base.check_small_batch(base.make_kzg(arrays, 0, canon_batch=8, msm_window=2), osetup, n,
                           kzg_proofs=False)

