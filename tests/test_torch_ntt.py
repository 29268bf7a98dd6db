"""The port's NTT (kateth_tpu_torch/ntt.py) and the Kzg form conversion
against the JAX package on CPU, exactly: the transform on the same
Montgomery digit planes at n = 16 (the shapes of tests/test_ntt.py, so the
JAX compiles are shared), the 1-point transform, and
blobs_to_coefficients / coefficients_to_blobs at n = 8 against the JAX Kzg
on the same setup."""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kateth_tpu import ntt as jntt
from kateth_tpu.kzg import DeviceSetup
from kateth_tpu.kzg import Kzg as JaxKzg
from kateth_tpu.kzg import KzgConfig as JaxKzgConfig
from kateth_tpu.oracle import field as of
from kateth_tpu.oracle.kzg import OracleSetup, blob_to_bytes
from kateth_tpu_torch import ntt
from kateth_tpu_torch.fields.specs import FR
from kateth_tpu_torch.kzg import Kzg, KzgConfig, KzgError, TorchSetup
from kateth_tpu_torch.kzg.setup import FIELDS

rng = random.Random(0x6E7474)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def mont_planes(shape) -> np.ndarray:
    vals = np.array([FR.from_int(rng.randrange(of.R)) for _ in range(int(np.prod(shape)))])
    return vals.reshape(*shape, FR.n_digits)


#: (inverse, bitrev_input, bitrev_output): each direction with each flag
#: both ways; the first two are the blob conversions of tests/test_ntt.py
CASES = [(False, False, True), (True, True, False), (False, True, False), (True, False, True)]


def _jax_fn(inverse, bitrev_input, bitrev_output):
    if (inverse, bitrev_input, bitrev_output) == CASES[0]:
        return jntt.monomial_to_lagrange_brp
    if (inverse, bitrev_input, bitrev_output) == CASES[1]:
        return jntt.lagrange_brp_to_monomial
    return functools.partial(jntt.ntt_mont, inverse=inverse, bitrev_input=bitrev_input,
                             bitrev_output=bitrev_output)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "inv%d-brin%d-brout%d" % c)
def test_ntt_matches_jax(case):
    x = mont_planes((3, 16))
    want = np.asarray(jax.jit(_jax_fn(*case))(jnp.asarray(x.astype(np.uint32))))
    got = ntt.ntt_mont(torch.as_tensor(x), *case)
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_ntt_along_another_axis_and_round_trip():
    x = torch.as_tensor(mont_planes((16, 2)))  # the transform axis is -3
    fwd = ntt.ntt_mont(x, axis=-3)
    assert torch.equal(fwd, ntt.ntt_mont(x.movedim(0, 1)).movedim(1, 0))
    assert torch.equal(ntt.ntt_mont(fwd, inverse=True, axis=0), x)
    coeffs = torch.as_tensor(mont_planes((16,)))
    assert torch.equal(ntt.lagrange_brp_to_monomial(ntt.monomial_to_lagrange_brp(coeffs)), coeffs)


def test_one_point_ntt_is_the_identity():
    x = torch.as_tensor(mont_planes((3, 1)))
    for case in CASES:
        assert torch.equal(ntt.ntt_mont(x, *case), x)
    with pytest.raises(ValueError, match="power of two"):
        ntt.ntt_mont(torch.as_tensor(mont_planes((12,))))


N = 8


@pytest.fixture(scope="module")
def kzgs():
    """The JAX Kzg with the config of tests/test_kzg_api.py, and the port's
    on the same setup with a batch quantum of 4.  The JAX Kzg calls its two
    transforms op by op, hundreds of small XLA compiles (about 30 s on this
    CPU); here it gets the same functions jitted, each one compile."""
    mp = pytest.MonkeyPatch()
    for name in ("lagrange_brp_to_monomial", "monomial_to_lagrange_brp"):
        mp.setattr(jntt, name, jax.jit(getattr(jntt, name)))
    osetup = OracleSetup.generate_insecure(N, g2_len=2)
    js = DeviceSetup.from_oracle(osetup, JaxKzgConfig(n=N, g2_len=2))
    arrays = [np.asarray(getattr(js, k)) for k in FIELDS]
    port = Kzg(TorchSetup.from_arrays(arrays, KzgConfig(n=N, g2_len=2, canon_batch=4), "cpu"))
    yield JaxKzg(js), port, osetup
    mp.undo()


def test_form_conversion_matches_jax(kzgs):
    jkzg, kzg, osetup = kzgs
    blobs = [blob_to_bytes([rng.randrange(of.R) for _ in range(N)]) for _ in range(5)]
    coeffs = kzg.blobs_to_coefficients(blobs)
    assert coeffs == jkzg.blobs_to_coefficients(blobs)
    assert all(len(cs) == N and all(len(c) == 32 for c in cs) for cs in coeffs)
    assert kzg.coefficients_to_blobs(coeffs) == blobs
    # the coefficients are the polynomial: Horner at each bit-reversed root
    cs = [int.from_bytes(c, "big") for c in coeffs[0]]
    for i, w in enumerate(osetup.roots_brp):
        acc = 0
        for c in reversed(cs):
            acc = (acc * w + c) % of.R
        assert acc.to_bytes(32, "big") == blobs[0][i * 32 : (i + 1) * 32]
    # and back, against the JAX package, from coefficients it never made
    other = [[rng.randrange(of.R).to_bytes(32, "big") for _ in range(N)] for _ in range(2)]
    assert kzg.coefficients_to_blobs(other) == jkzg.coefficients_to_blobs(other)


def test_form_conversion_errors(kzgs):
    _, kzg, _ = kzgs
    good = [bytes(32)] * N
    with pytest.raises(KzgError, match="invalid coefficient count"):
        kzg.coefficients_to_blobs([good, good[:-1]])
    with pytest.raises(KzgError, match="non-canonical"):
        kzg.coefficients_to_blobs([good, [of.R.to_bytes(32, "big")] + good[1:]])
    with pytest.raises(KzgError, match="non-canonical"):
        kzg.blobs_to_coefficients([b"\xff" * 32 * N])
    with pytest.raises(KzgError, match="invalid blob length"):
        kzg.blobs_to_coefficients([bytes(32 * N - 1)])


@pytest.mark.parametrize("a,b", [(2, 16), (4, 8)])
def test_sharded_twiddles_match_jax(a, b):
    """The four-step NTT's step-2 tables of kateth_tpu_torch.parallel
    against the JAX package's, both row orders and directions."""
    from kateth_tpu.parallel import ntt as jpntt
    from kateth_tpu_torch.parallel import ntt as pntt

    for inverse in (False, True):
        for name in ("_twiddle_matrix", "_twiddle_matrix_rowbrp"):
            want = getattr(jpntt, name)(a, b, inverse).astype(np.int64)
            assert np.array_equal(getattr(pntt, name)(a, b, inverse), want), (name, inverse)
