"""The port's commit and prove entry points on CPU at n = 8, byte for byte
against the oracle, through the fixed-base comb (comb_h = 4, kernel K8's
plain version), and their errors as tests/test_kzg_api.py has them.
tests/test_torch_prove_msm.py runs the same entry-point tests through the
windowed Pippenger (comb_h = 0)."""

import random

import numpy as np
import pytest
import torch

from kateth_tpu.kzg import DeviceSetup
from kateth_tpu.kzg import KzgConfig as JaxKzgConfig
from kateth_tpu.oracle import field as of
from kateth_tpu.oracle.kzg import OracleSetup, blob_to_bytes
from kateth_tpu_torch.kzg import Kzg, KzgConfig, KzgError, TorchSetup
from kateth_tpu_torch.kzg.setup import FIELDS

N = 8
rng = random.Random(0x70726F76)


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def osetup():
    return OracleSetup.generate_insecure(N, g2_len=2)


@pytest.fixture(scope="module")
def arrays(osetup):
    js = DeviceSetup.from_oracle(osetup, JaxKzgConfig(n=N, g2_len=2))
    return [np.asarray(getattr(js, k)) for k in FIELDS]


def make_kzg(arrays, h: int, canon_batch: int = 2, msm_window: int = 8) -> Kzg:
    """The port on CPU, by default with a batch quantum of 2."""
    cfg = KzgConfig(n=N, g2_len=2, canon_batch=canon_batch, comb_h=h, msm_window=msm_window)
    return Kzg(TorchSetup.from_arrays(arrays, cfg, "cpu"))


@pytest.fixture(scope="module")
def kzg(arrays):
    return make_kzg(arrays, 4)


def rand_blob() -> bytes:
    return blob_to_bytes([rng.randrange(of.R) for _ in range(N)])


def test_commitments_match_oracle(kzg, osetup):
    blobs = [rand_blob() for _ in range(2)]
    want = [osetup.blob_to_commitment(b) for b in blobs]
    assert kzg.blobs_to_kzg_commitments(blobs) == want
    assert kzg.blobs_to_kzg_commitments([]) == []


def test_kzg_proofs_match_oracle(kzg, osetup):
    """A random z, and z on the root w_5 (the quotient's special row)."""
    blobs = [rand_blob() for _ in range(2)]
    zs = [of.fr_to_be_bytes(rng.randrange(of.R)), of.fr_to_be_bytes(osetup.roots_brp[5])]
    want = [osetup.proof(b, z) for b, z in zip(blobs, zs)]
    proofs, ys = kzg.compute_kzg_proofs(blobs, zs)
    assert list(zip(proofs, ys)) == want


def test_blob_proofs_match_oracle(kzg, osetup):
    blobs = [rand_blob() for _ in range(2)]
    cms = [osetup.blob_to_commitment(b) for b in blobs]
    want = [osetup.blob_proof(b, c) for b, c in zip(blobs, cms)]
    assert kzg.compute_blob_kzg_proofs(blobs, cms) == want


def test_single_entry_points_match_oracle(kzg, osetup):
    blob = rand_blob()
    z = of.fr_to_be_bytes(rng.randrange(of.R))
    cm = osetup.blob_to_commitment(blob)
    assert kzg.blob_to_kzg_commitment(blob) == cm
    assert kzg.compute_kzg_proof(blob, z) == osetup.proof(blob, z)
    assert kzg.compute_blob_kzg_proof(blob, cm) == osetup.blob_proof(blob, cm)


def test_commit_in_chunks_and_lazy_table(arrays, osetup):
    """Three blobs commit in chunks of two, the batch quantum (the last one
    padded), and the comb table is built at the first commit, not at
    construction."""
    kzg = make_kzg(arrays, 4)
    assert kzg._comb_table is None
    blobs = [rand_blob() for _ in range(3)]
    assert kzg.blobs_to_kzg_commitments(blobs) == [osetup.blob_to_commitment(b) for b in blobs]
    assert kzg._comb_table[0].shape == (N << 4, 24)
    assert kzg.lanes == {"commit": [3, 4]}


#: blobs given -> lanes run at a batch quantum of 8: the next power of two
#: below it, programs of 8 from it on
SMALL_BATCHES = {1: 1, 3: 4, 5: 8, 9: 16}


def check_small_batch(kzg, osetup, n: int, kzg_proofs: bool) -> None:
    """n blobs through a Kzg with a batch quantum of 8 give the oracle's
    commitments and blob proofs (and with kzg_proofs its proofs and ys at
    random points), and Kzg.lanes counts each program's lanes."""
    blobs = [rand_blob() for _ in range(n)]
    cms = [osetup.blob_to_commitment(b) for b in blobs]
    assert kzg.blobs_to_kzg_commitments(blobs) == cms
    assert kzg.compute_blob_kzg_proofs(blobs, cms) == [osetup.blob_proof(b, c)
                                                       for b, c in zip(blobs, cms)]
    run = SMALL_BATCHES[n]
    lanes = {"commit": [n, run], "validate_g1": [n, run], "prove": [n, run]}
    if kzg_proofs:
        zs = [of.fr_to_be_bytes(rng.randrange(of.R)) for _ in blobs]
        proofs, ys = kzg.compute_kzg_proofs(blobs, zs)
        assert list(zip(proofs, ys)) == [osetup.proof(b, z) for b, z in zip(blobs, zs)]
        lanes["prove"] = [2 * n, 2 * run]
    assert kzg.lanes == lanes


@pytest.mark.parametrize("n", sorted(SMALL_BATCHES))
def test_small_batches_match_oracle(arrays, osetup, n):
    """1, 3 and 5 blobs run on 1, 4 and 8 lanes, 9 blobs on two programs
    of 8, through the comb, byte for byte as the oracle has them."""
    check_small_batch(make_kzg(arrays, 4, canon_batch=8), osetup, n, kzg_proofs=True)


class TestErrors:
    def test_bad_blob_length(self, kzg):
        with pytest.raises(KzgError, match="blob length"):
            kzg.blob_to_kzg_commitment(b"\x00" * 31)

    def test_noncanonical_blob_element(self, kzg):
        blob = bytearray(rand_blob())
        blob[0:32] = b"\xff" * 32
        with pytest.raises(KzgError, match="non-canonical field element in blob"):
            kzg.blob_to_kzg_commitment(bytes(blob))

    def test_noncanonical_z(self, kzg):
        with pytest.raises(KzgError, match="non-canonical field element"):
            kzg.compute_kzg_proof(rand_blob(), b"\xff" * 32)

    def test_bad_point(self, kzg):
        with pytest.raises(KzgError, match="BadEncoding"):
            kzg.compute_blob_kzg_proof(rand_blob(), b"\x01" * 48)

    def test_points_validated_before_blobs(self, kzg):
        with pytest.raises(KzgError, match="point length"):
            kzg.compute_blob_kzg_proof(b"\x00", b"\x01" * 47)

    @pytest.mark.parametrize("op", ["compute_kzg_proofs", "compute_blob_kzg_proofs"])
    def test_length_mismatch(self, kzg, op):
        with pytest.raises(KzgError, match="length mismatch"):
            getattr(kzg, op)([rand_blob()], [])
