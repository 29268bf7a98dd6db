"""The port's single-point verification on CPU: the G2 ladder's plain
version (kernel K6's reference) against the jitted JAX ladder, and
Kzg.verify_kzg_proof's verdicts and errors against the oracle (the JAX
single-point verify ends in the pairing, minutes of XLA compile here)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kateth_tpu.curves import ops as jops
from kateth_tpu.kzg import DeviceSetup
from kateth_tpu.kzg import KzgConfig as JaxKzgConfig
from kateth_tpu.oracle import curve as oc
from kateth_tpu.oracle import field as of
from kateth_tpu.oracle.kzg import OracleSetup, blob_to_bytes
from kateth_tpu_torch import cuda_pairing
from kateth_tpu_torch.curves import g2, ops
from kateth_tpu_torch.fields import limbs as L
from kateth_tpu_torch.kzg import Kzg, KzgConfig, KzgError, TorchSetup
from kateth_tpu_torch.kzg.setup import FIELDS

N = 8
rng = random.Random(0x766B7A67)


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
def kzg(osetup):
    js = DeviceSetup.from_oracle(osetup, JaxKzgConfig(n=N, g2_len=2))
    arrays = [np.asarray(getattr(js, k)) for k in FIELDS]
    return Kzg(TorchSetup.from_arrays(arrays, KzgConfig(n=N, g2_len=2, canon_batch=2), "cpu"))


@pytest.fixture(scope="module")
def opening(osetup):
    """(proof, commitment, z, y) of a random blob at a random point."""
    blob = blob_to_bytes([rng.randrange(of.R) for _ in range(N)])
    z = of.fr_to_be_bytes(rng.randrange(of.R))
    proof, y = osetup.proof(blob, z)
    return proof, osetup.blob_to_commitment(blob), z, y


def test_g2_ladder_plain_matches_jax():
    """K6's plain version against the JAX scan ladder over 256 bits, with
    scalars r - 1, 0, 1 and a random one, and the point at infinity."""
    pts = [oc.g2_mul(oc.G2_GEN, rng.randrange(1, of.R)), oc.G2_GEN, oc.G2_GEN, oc.g2_infinity()]
    scalars = [of.R - 1, 0, 1, rng.randrange(of.R)]
    P = g2.from_ints(pts)
    sc = np.stack([L.int_to_digits(s, 16) for s in scalars])
    want = jax.jit(lambda a, s: jops.scalar_mul(jops.FP2_FIELD, a, s, n_bits=256))(
        tuple(jnp.asarray(c.astype(np.uint32)) for c in P), jnp.asarray(sc.astype(np.uint32))
    )
    got = cuda_pairing.g2_scalar_mul(tuple(torch.as_tensor(c) for c in P), torch.as_tensor(sc))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    # zero and the point at infinity give the identity
    assert ops.is_identity(ops.FP2_FIELD, got).tolist() == [False, True, False, True]


def test_verdicts_match_oracle(kzg, osetup, opening):
    proof, cm, z, y = opening
    bad_y = of.fr_to_be_bytes((int.from_bytes(y, "big") + 1) % of.R)
    assert kzg.verify_kzg_proof(proof, cm, z, y) is True
    assert kzg.verify_kzg_proof(proof, cm, z, bad_y) is False
    assert osetup.verify_proof(proof, cm, z, y) is True
    assert osetup.verify_proof(proof, cm, z, bad_y) is False


class TestErrors:
    def test_point_length(self, kzg, opening):
        proof, cm, z, y = opening
        with pytest.raises(KzgError, match="point length"):
            kzg.verify_kzg_proof(proof[:-1], cm, z, y)

    @pytest.mark.parametrize("which", ["z", "y"])
    def test_noncanonical_scalar(self, kzg, opening, which):
        proof, cm, z, y = opening
        args = {"z": z, "y": y}
        args[which] = of.R.to_bytes(32, "big")
        with pytest.raises(KzgError, match="non-canonical"):
            kzg.verify_kzg_proof(proof, cm, args["z"], args["y"])

    def test_proof_errors_before_commitment(self, kzg, osetup, opening):
        """A badly encoded proof with an off-curve commitment raises for the
        proof; a valid proof with it, for the commitment; as the oracle."""
        proof, cm, z, y = opening
        x = next(x for x in range(1, 100) if oc.fp_sqrt((x**3 + 4) % of.P) is None)
        off_curve = bytes([0x80]) + x.to_bytes(47, "big")
        for bad_proof, error in ((b"\x01" * 48, oc.BadEncoding), (proof, oc.NotOnCurve)):
            with pytest.raises(error):
                osetup.verify_proof(bad_proof, off_curve, z, y)
            with pytest.raises(KzgError, match=error.__name__):
                kzg.verify_kzg_proof(bad_proof, off_curve, z, y)
