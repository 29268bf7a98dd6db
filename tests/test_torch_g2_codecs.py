"""The port's G2 codecs (curves/decompress.py and curves/compress.py, the
96-byte Zcash format) and its trusted-setup load, which decodes the G2
points on the setup's device, on CPU.

Decompression is held against the oracle (kateth_tpu.oracle.curve) and
the JAX package's digit planes of the oracle's points, not against the JAX
g2_decompress: that call takes about 54 s of XLA work cold on this CPU (its
square-root chains and the subgroup check are scans of Fp2 steps).  Every
case sits in one batch, so the plain G2 ladder of the subgroup check runs
once.  Compression is held against the jitted JAX g2_points_to_bytes at the
9-point shape of tests/test_compress.py and against the oracle.  The setup
load is held plane for plane against the JAX DeviceSetup of the same
setup."""

import json
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kateth_tpu.curves import compress as jcompress
from kateth_tpu.curves import g2 as jg2
from kateth_tpu.kzg import DeviceSetup
from kateth_tpu.kzg import KzgConfig as JaxKzgConfig
from kateth_tpu.oracle import curve as oc
from kateth_tpu.oracle import field as of
from kateth_tpu.oracle.kzg import OracleSetup
from kateth_tpu_torch.curves import compress, decompress, g2
from kateth_tpu_torch.fields import fp2
from kateth_tpu_torch.fields.specs import FP
from kateth_tpu_torch.kzg import KzgConfig, KzgError, TorchSetup
from kateth_tpu_torch.kzg.setup import FIELDS

rng = random.Random(0x6732636F)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def twist_x(on_curve: bool):
    """The first x = (k, 1) whose x^3 + 4(1 + u) is (or is not) a square in
    Fp2; with one, the point lies on the twist, and almost never in G2."""
    k = 1
    while True:
        x = (k, 1)
        t = of.fp2_add(of.fp2_mul(of.fp2_sqr(x), x), (4, 4))
        if (of.fp2_sqrt(t) is not None) == on_curve:
            return x
        k += 1


def x_bytes(x, flags=0x80) -> bytes:
    b = bytearray(x[1].to_bytes(48, "big") + x[0].to_bytes(48, "big"))
    b[0] |= flags
    return bytes(b)


def cases() -> list[tuple[str, bytes]]:
    """(name, encoding): the 5 valid points of tests/test_decompress.py, then
    the identity, -G2, and each kind of invalid encoding."""
    out = [(f"{k} G2", oc.g2_compress(oc.g2_mul(oc.G2_GEN, k)))
           for k in (1, 2, 7, 0xDEADBEEF, of.R - 1)]
    gen = oc.g2_compress(oc.G2_GEN)
    flipped = bytes([gen[0] ^ 0x20]) + gen[1:]
    c1_big = bytearray(gen)
    c1_big[0:48] = (of.P + 1).to_bytes(48, "big")
    c1_big[0] |= 0x80
    c0_big = bytearray(gen)
    c0_big[48:] = of.P.to_bytes(48, "big")
    return out + [
        ("infinity", bytes([0xC0]) + bytes(95)),
        ("-G2 (sign flag flipped)", flipped),
        ("x.c1 >= p", bytes(c1_big)),
        ("x.c0 = p", bytes(c0_big)),
        ("compression bit clear", bytes([gen[0] & 0x7F]) + gen[1:]),
        ("infinity with the sign flag", bytes([0xE0]) + bytes(95)),
        ("infinity with x != 0", bytes([0xC0]) + bytes(94) + b"\x01"),
        ("x off the curve", x_bytes(twist_x(False))),
        ("on the twist, not in G2", x_bytes(twist_x(True))),
        ("on the twist, not in G2, sign set", x_bytes(twist_x(True), 0xA0)),
    ]


def oracle_masks(b: bytes):
    """(ok_encoding, ok_curve, ok_subgroup, affine point or None) from the
    oracle's decoder; a failed check leaves the later ones unknown (None)."""
    try:
        p = oc.g2_decompress(b)
    except oc.BadEncoding:
        return False, None, None, None
    except oc.NotOnCurve:
        return True, False, None, None
    except oc.NotInGroup:
        return True, True, False, None
    return True, True, True, p


@pytest.fixture(scope="module")
def decoded():
    cs = cases()
    raw = np.frombuffer(b"".join(b for _, b in cs), dtype=np.uint8).reshape(len(cs), 96)
    return cs, decompress.g2_decompress(torch.as_tensor(raw.copy()))


def test_g2_decompress_matches_oracle(decoded):
    cs, (pt, ok_enc, ok_curve, ok_sub) = decoded
    want_planes = jg2.from_oracle  # the JAX package's converter: affine, Z = 1
    for i, (name, b) in enumerate(cs):
        enc, curve, sub, p = oracle_masks(b)
        assert bool(ok_enc[i]) == enc, name
        if curve is not None:
            assert bool(ok_curve[i]) == curve, name
        if sub is not None:
            assert bool(ok_sub[i]) == sub, name
        if p is not None:
            want = want_planes([p])
            for got_c, want_c in zip(pt, want):
                assert np.array_equal(got_c[i].numpy(), np.asarray(want_c[0]).astype(np.int64)), name
    # the kinds of failure are all there
    assert not ok_enc.all() and not ok_curve[ok_enc].all() and not ok_sub[ok_enc & ok_curve].all()


def test_g2_round_trip(decoded):
    """Compressing the decoded valid points gives back their encodings."""
    cs, (pt, ok_enc, ok_curve, ok_sub) = decoded
    valid = (ok_enc & ok_curve & ok_sub).nonzero().flatten()
    got = compress.g2_points_to_bytes(tuple(c[valid] for c in pt))
    assert got == [cs[i][1] for i in valid.tolist()]
    assert len(got) == 7


def test_g2_compress_matches_jax_and_oracle():
    pts = [oc.g2_mul(oc.G2_GEN, rng.randrange(1, of.R)) for _ in range(8)] + [oc.g2_infinity()]
    planes = jg2.from_oracle(pts)
    want = jcompress.g2_points_to_bytes(tuple(jnp.asarray(c) for c in planes))
    got = compress.g2_points_to_bytes(tuple(torch.as_tensor(np.asarray(c).astype(np.int64))
                                            for c in planes))
    assert got == want == [oc.g2_compress(p) for p in pts]


def test_g2_compress_normalizes_and_signs():
    """A point and its negation, each scaled by a random lambda in Z."""
    p = oc.g2_mul(oc.G2_GEN, 0xFEEDFACE)
    pts = [p, oc.g2_neg(p)]
    X, Y, Z = (torch.as_tensor(c) for c in g2.from_ints(pts))
    lam = torch.as_tensor(np.stack([FP.from_int(rng.randrange(2, of.P)), FP.from_int(0)]))
    got = compress.g2_points_to_bytes(tuple(fp2.mul(c, lam) for c in (X, Y, Z)))
    assert got == [oc.g2_compress(q) for q in pts]
    assert got[0][0] ^ got[1][0] == 0x20 and got[0][1:] == got[1][1:]


N = 8


@pytest.fixture(scope="module")
def setup_json(tmp_path_factory):
    osetup = OracleSetup.generate_insecure(N, g2_len=3)
    path = tmp_path_factory.mktemp("setup") / "setup.json"
    path.write_text(json.dumps(osetup.to_json_dict()))
    return osetup, path


def test_setup_load_decodes_g2_on_the_device(setup_json):
    osetup, path = setup_json
    loaded = TorchSetup.load_json(str(path), KzgConfig(n=N, g2_len=3), device="cpu", cache_dir=None)
    want = DeviceSetup.from_oracle(osetup, JaxKzgConfig(n=N, g2_len=3))
    for k in FIELDS:
        assert np.array_equal(getattr(loaded, k).numpy(), np.asarray(getattr(want, k)).astype(np.int64)), k


@pytest.mark.parametrize("bad", ["off the curve", "95 bytes"])
def test_setup_load_rejects_a_bad_g2_point(bad, setup_json, tmp_path):
    """A G2 point off the curve, or of the wrong length, raises KzgError
    (before the subgroup check runs)."""
    _, path = setup_json
    obj = json.loads(path.read_text())
    enc = x_bytes(twist_x(False)) if bad == "off the curve" else bytes.fromhex(obj["g2_monomial"][2][2:])[:95]
    obj["g2_monomial"][2] = "0x" + enc.hex()
    bad_path = tmp_path / "bad.json"
    bad_path.write_text(json.dumps(obj))
    with pytest.raises(KzgError, match="invalid G2 point"):
        TorchSetup.load_json(str(bad_path), KzgConfig(n=N, g2_len=3), device="cpu", cache_dir=None)
