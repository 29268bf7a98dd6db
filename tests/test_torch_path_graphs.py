"""The public operations over the device programs that graphs.py captures
(kzg/protocol.py verify_kzg, validate_g1, commit_chunk, prove_chunk), on
the CPU at n = 8 with a batch quantum of 2 and comb_h = 4, which runs the
same programs eagerly: the errors when two inputs of one call are bad at
once, the one the JAX package raises first with its message
(kateth_tpu/kzg/api.py), also at a batch padded to a power of two, and a
batch split into programs of canon_batch blobs giving what one program
gives.

Each operation now runs as whole device programs (kzg/protocol.py), which
compute everything before any mask is read, so an error the host can decide
early is raised only after the device masks the JAX package checks first:

* compute_kzg_proofs (JAX api.py:253-265): a non-canonical blob element
  before a bad z;
* compute_blob_kzg_proofs (JAX api.py:289-305): the commitments' length,
  then their device masks, then the blobs' lengths and canonicality;
* verify_kzg_proof (JAX api.py:354-377): the proof's masks, then the
  commitment's.

The errors are raised before any commitment or pairing is used, so the
kernels whose results only those need have stand-ins here: K3 gives the
identity (every point passes the subgroup check), K4-K6 and K8 cheap values
of the right shapes, and the comb table is random rows.  K2 keeps its plain
version: the curve check needs its square roots.  Each message is compared
whole.  tests/test_torch_prove.py holds the same operations' outputs
against the oracle with every kernel's plain version.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from kateth_tpu.kzg import DeviceSetup
from kateth_tpu.kzg import KzgConfig as JaxKzgConfig
from kateth_tpu.oracle import curve as oc
from kateth_tpu.oracle import field as of
from kateth_tpu.oracle.kzg import OracleSetup, blob_to_bytes
from kateth_tpu_torch import cuda_pairing
from kateth_tpu_torch.curves import cuda_msm
from kateth_tpu_torch.fields import cuda_mont
from kateth_tpu_torch.fields import limbs as L
from kateth_tpu_torch.fields.specs import FP
from kateth_tpu_torch.kzg import Kzg, KzgConfig, KzgError, TorchSetup
from kateth_tpu_torch.kzg.setup import FIELDS

N = 8
rng = random.Random(0x6F726472)

#: the JAX package's messages (kateth_tpu/kzg/api.py)
BLOB_LENGTH = "invalid blob length"
BLOB_ELEMENT = "non-canonical field element in blob"
FR_ELEMENT = "non-canonical field element"
FR_LENGTH = "invalid field element length"
BAD_ENCODING = "invalid G1 point: BadEncoding"
NOT_ON_CURVE = "invalid G1 point: NotOnCurve"


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def identity_ladder(point, scalar_digits):
    batch = torch.broadcast_shapes(scalar_digits.shape[:-1], *(c.shape[:-1] for c in point))
    zero = torch.zeros((*batch, FP.n_digits), dtype=torch.int64)
    return zero, zero + torch.as_tensor(FP.one_mont), zero.clone()


def g2_ladder_stand_in(point, scalar_digits):
    return tuple(c.clone() for c in point)


def miller_stand_in(xp, yp, xq, yq):
    return torch.zeros((*xp.shape[:-1], 2, 3, 2, FP.n_digits), dtype=torch.int64)


def comb_chain_stand_in(x, y, flags, g=cuda_msm.COMB_CHAIN):
    x0, y0 = (c.reshape(*c.shape[:-2], -1, g, FP.n_digits)[..., 0, :] for c in (x, y))
    return x0, y0, L.add(FP, x0, y0)


@pytest.fixture(scope="module")
def osetup():
    return OracleSetup.generate_insecure(N, g2_len=2)


@pytest.fixture(scope="module")
def kzg(osetup):
    js = DeviceSetup.from_oracle(osetup, JaxKzgConfig(n=N, g2_len=2))
    arrays = [np.asarray(getattr(js, k)) for k in FIELDS]
    cfg = KzgConfig(n=N, g2_len=2, canon_batch=2, comb_h=4)
    k = Kzg(TorchSetup.from_arrays(arrays, cfg, "cpu"))
    gen = np.random.default_rng(7)
    k._comb_table = tuple(torch.as_tensor(gen.integers(0, 1 << 16, (N << 4, FP.n_digits)))
                          for _ in range(2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_mont, "g1_scalar_mul", identity_ladder)
        mp.setattr(cuda_pairing, "g2_scalar_mul", g2_ladder_stand_in)
        mp.setattr(cuda_pairing, "miller_loop_affine", miller_stand_in)
        mp.setattr(cuda_pairing, "hard_part", torch.clone)
        mp.setattr(cuda_msm, "comb_chain_sum", comb_chain_stand_in)
        yield k


def with_quantum(kzg, canon_batch: int) -> Kzg:
    """A Kzg on kzg's setup and comb table with another batch quantum."""
    cfg = dataclasses.replace(kzg.config, canon_batch=canon_batch)
    k = Kzg(dataclasses.replace(kzg.setup, config=cfg))
    k._comb_table = kzg._comb_table
    return k


def rand_blob() -> bytes:
    return blob_to_bytes([rng.randrange(of.R) for _ in range(N)])


def bad_element(blob: bytes) -> bytes:
    return b"\xff" * 32 + blob[32:]


def off_curve() -> bytes:
    x = next(x for x in range(1, 100) if oc.fp_sqrt((x**3 + 4) % of.P) is None)
    return bytes([0x80]) + x.to_bytes(47, "big")


def raised(fn, *args) -> str:
    with pytest.raises(KzgError) as e:
        fn(*args)
    return str(e.value)


@pytest.mark.parametrize("z_fault, z_error", [("value", FR_ELEMENT), ("length", FR_LENGTH)])
def test_compute_kzg_proofs_blob_before_z(kzg, z_fault, z_error):
    """A non-canonical blob element and a bad z in one call raise the
    blob's error; the bad z alone raises its own, after the device ran."""
    bad_z = of.R.to_bytes(32, "big") if z_fault == "value" else b"\x01" * 31
    good_z = of.fr_to_be_bytes(rng.randrange(of.R))
    blobs = [rand_blob(), bad_element(rand_blob()), rand_blob()]
    assert raised(kzg.compute_kzg_proofs, blobs, [bad_z, good_z, good_z]) == BLOB_ELEMENT
    blobs[1] = rand_blob()
    assert raised(kzg.compute_kzg_proofs, blobs, [good_z, good_z, bad_z]) == z_error


def test_compute_blob_kzg_proofs_commitment_before_blob(kzg, osetup):
    """A commitment's device mask comes before a blob of the wrong length
    and before a non-canonical blob element; with valid commitments the
    blob's errors follow in that order."""
    blobs = [rand_blob() for _ in range(3)]
    cms = [osetup.blob_to_commitment(b) for b in blobs]
    short = [blobs[0][:-1], *blobs[1:]]
    assert raised(kzg.compute_blob_kzg_proofs, short, [cms[0], b"\x01" * 48, cms[2]]) == BAD_ENCODING
    noncanon = [blobs[0], blobs[1], bad_element(blobs[2])]
    assert raised(kzg.compute_blob_kzg_proofs, noncanon, [cms[0], off_curve(), cms[2]]) == NOT_ON_CURVE
    assert raised(kzg.compute_blob_kzg_proofs, [short[0], noncanon[2]], cms[:2]) == BLOB_LENGTH
    assert raised(kzg.compute_blob_kzg_proofs, noncanon, cms) == BLOB_ELEMENT


def test_verify_kzg_proof_proof_before_commitment(kzg, osetup):
    """A proof with a bad encoding and a commitment off the curve raise the
    proof's error; a valid proof with that commitment, the commitment's."""
    blob = rand_blob()
    z = of.fr_to_be_bytes(rng.randrange(of.R))
    proof, y = osetup.proof(blob, z)
    assert raised(kzg.verify_kzg_proof, bytes(48), off_curve(), z, y) == BAD_ENCODING
    assert raised(kzg.verify_kzg_proof, proof, off_curve(), z, y) == NOT_ON_CURVE


@pytest.mark.parametrize("op, error, lanes", [
    ("compute_blob_kzg_proofs", NOT_ON_CURVE, {"validate_g1": [3, 4], "prove": [3, 4]}),
    ("verify_blob_kzg_proof_batch", BLOB_ELEMENT, {"verify_batch": [3, 4]}),
])
def test_padded_batch_error_order(kzg, osetup, op, error, lanes):
    """Three blobs, padded to four lanes at a batch quantum of 8, with a
    commitment off the curve and a non-canonical blob element: the blob
    proofs raise the commitment's error (its masks come first), the batch
    verification the blob's (blobs, then commitments, then proofs)."""
    k = with_quantum(kzg, 8)
    blobs = [rand_blob() for _ in range(3)]
    cms = [osetup.blob_to_commitment(b) for b in blobs]
    proofs = [osetup.blob_proof(b, c) for b, c in zip(blobs, cms)]
    blobs[2], cms[1] = bad_element(blobs[2]), off_curve()
    args = (blobs, cms) if op == "compute_blob_kzg_proofs" else (blobs, cms, proofs)
    assert raised(getattr(k, op), *args) == error
    assert k.lanes == lanes


def test_chunks_give_what_one_program_gives(kzg, osetup, monkeypatch):
    """Five blobs in programs of two (a batch quantum of 2, the last one
    padded) give the proofs, ys, commitments and validation masks of one
    program of eight (a quantum of 8), blob by blob.  K2 gets a cheap
    stand-in too: only the equality matters here."""
    monkeypatch.setattr(cuda_mont, "pow_const", lambda spec, a, e: L.add(spec, a, a))
    blobs = [rand_blob() for _ in range(5)]
    zs = [of.fr_to_be_bytes(rng.randrange(of.R)) for _ in blobs]
    cms = [osetup.blob_to_commitment(b) for b in blobs]

    def run(k):
        masks = torch.cat(k._validate_dispatch(cms), 1)[:, :5]
        return k.compute_kzg_proofs(blobs, zs), k.blobs_to_kzg_commitments(blobs), masks

    one = with_quantum(kzg, 8)
    (proofs, ys), commitments, masks = run(one)
    assert [len(m[0]) for m in one._validate_dispatch(cms)] == [8]
    assert [len(m[0]) for m in kzg._validate_dispatch(cms)] == [2, 2, 2]
    (c_proofs, c_ys), c_commitments, c_masks = run(kzg)
    assert (c_proofs, c_ys, c_commitments) == (proofs, ys, commitments)
    assert torch.equal(c_masks, masks)
    assert [len(x) for x in (proofs, ys, commitments)] == [5] * 3
    assert kzg.compute_kzg_proofs([], []) == ([], [])
    assert kzg.blobs_to_kzg_commitments([]) == [] and kzg.compute_blob_kzg_proofs([], []) == []
