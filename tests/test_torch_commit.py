"""The field, polynomial and codec pieces of the port's commit and prove
path against the jitted JAX functions on CPU, exactly: batched inversion,
the quotient polynomial (with a z on a root), and G1 compression (the
identity and both signs of y), round-tripped through the port's
decompression."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kateth_tpu.curves import compress as jcompress
from kateth_tpu.fields import limbs as JL
from kateth_tpu.fields.specs import FR as JFR
from kateth_tpu.kzg import DeviceSetup
from kateth_tpu.kzg import KzgConfig as JaxKzgConfig
from kateth_tpu.kzg import protocol as jprotocol
from kateth_tpu.oracle import curve as oc
from kateth_tpu.oracle import field as of
from kateth_tpu.oracle.kzg import OracleSetup
from kateth_tpu_torch.curves import compress, decompress, g1, ops
from kateth_tpu_torch.fields import limbs as L
from kateth_tpu_torch.fields.specs import FP, FR
from kateth_tpu_torch.kzg import protocol

N = 8
rng = random.Random(0x636F6D6D)


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def j(a):
    return jnp.asarray(np.asarray(a).astype(np.uint32))


def same(got, want) -> bool:
    return np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def fr_mont(vals):
    return np.stack([FR.from_int(v) for v in vals])


def test_batch_inv_matches_jax():
    """Rows of random elements with zeros among them (zeros stay zero)."""
    vals = [[rng.randrange(of.R) for _ in range(N)] for _ in range(3)]
    vals[0][3] = 0
    vals[2] = [0] * N
    a = np.stack([fr_mont(row) for row in vals])  # (3, N, 16)
    want = jax.jit(lambda x: JL.batch_inv(JFR, x, axis=-2))(j(a))
    got = L.batch_inv(FR, torch.as_tensor(a))
    assert same(got, want)
    for r, row in enumerate(vals):
        for i, v in enumerate(row):
            assert FR.to_int(got[r, i].numpy()) == (pow(v, -1, of.R) if v else 0)


@pytest.fixture(scope="module")
def setup_roots():
    osetup = OracleSetup.generate_insecure(N, g2_len=2)
    js = DeviceSetup.from_oracle(osetup, JaxKzgConfig(n=N, g2_len=2))
    return np.asarray(js.roots).astype(np.int64), np.asarray(js.inv_roots).astype(np.int64)


def test_quotient_matches_jax(setup_roots):
    """Two blobs at random points and one at the root w_5 (the special
    row), with y from the port's evaluate."""
    roots, inv_roots = setup_roots
    elements = np.stack([fr_mont([rng.randrange(of.R) for _ in range(N)]) for _ in range(3)])
    z = np.stack([fr_mont([rng.randrange(of.R)])[0], roots[5], fr_mont([rng.randrange(of.R)])[0]])
    e_t, z_t, r_t = (torch.as_tensor(x) for x in (elements, z, roots))
    y = protocol.evaluate(e_t, z_t, r_t)
    got = protocol.quotient(e_t, z_t, y, r_t, torch.as_tensor(inv_roots))
    want = jprotocol.quotient(j(elements), j(z), j(y.numpy()), j(roots), j(inv_roots))
    assert same(got, want)


def test_fr_mont_round_trip():
    plain = np.stack([L.int_to_digits(rng.randrange(of.R), 16) for _ in range(4)])
    mont = protocol.fr_to_mont(torch.as_tensor(plain))
    assert same(mont, jprotocol.fr_to_mont(j(plain)))
    assert np.array_equal(protocol.fr_from_mont(mont).numpy(), plain)


def test_g1_compress_matches_jax():
    """Random points, G and -G (the two signs of one x), the identity, and
    projective inputs with Z != 1 (a point doubled)."""
    pts = [oc.g1_mul(oc.G1_GEN, rng.randrange(1, of.R)) for _ in range(3)]
    pts += [oc.G1_GEN, oc.g1_neg(oc.G1_GEN), oc.g1_infinity()]
    P = tuple(torch.as_tensor(c) for c in g1.from_ints(pts))
    P = tuple(torch.cat([c, d]) for c, d in zip(P, ops.pdouble(ops.FP_FIELD, tuple(c[:2] for c in P))))
    want = jax.jit(jcompress.g1_compress_planes)(tuple(j(c.numpy()) for c in P))
    got = compress.g1_compress_planes(P)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), np.asarray(want))
    as_bytes = compress.points_to_bytes(P)
    wanted = [oc.g1_compress(p) for p in pts] + [oc.g1_compress(oc.g1_add(p, p)) for p in pts[:2]]
    assert as_bytes == wanted
    assert {b[0] & 0x20 for b in as_bytes[3:5]} == {0, 0x20}  # G and -G differ in sign
    assert as_bytes[5] == bytes([0xC0]) + bytes(47)
    # round trip through the port's decompression, in affine
    back, enc, curve, sub = decompress.g1_decompress(got)
    assert bool((enc & curve & sub).all())
    for a, b in zip(ops.to_affine(ops.FP_FIELD, back), ops.to_affine(ops.FP_FIELD, P)):
        assert torch.equal(a, b)


def test_digits_to_be_bytes_inverts_be_bytes_to_digits():
    raw = np.frombuffer(bytes(rng.randrange(256) for _ in range(96)), dtype=np.uint8).reshape(2, 48)
    digits = L.be_bytes_to_digits(FP, torch.as_tensor(raw.copy()))
    assert np.array_equal(L.digits_to_be_bytes(FP, digits).numpy(), raw)
