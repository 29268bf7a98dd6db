"""The benchmark's plain reference (kzgbench/reference) against the vendored
spec vectors and against its own known-tau setup.  On the CPU, in tens of
seconds: python3 -m pytest kzgbench/tests -q"""

from __future__ import annotations

import glob
import json
import os
import random

import pytest

from kzgbench import make_setup
from kzgbench.reference import g1, g2
from kzgbench.reference.fields import P, R, batch_inverse, bit_reversal_permutation, fp_sqrt, roots_of_unity
from kzgbench.reference.kzg import TAU, Domain, KnownTau, blob_scalars, compute_challenge

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VECTORS = os.path.join(REPO, "tests", "vectors")
MAINNET_SETUP = os.path.join(REPO, "kateth_tpu", "data", "trusted_setup_4096.json")
KNOWN_SETUP = os.path.join(REPO, "kzgbench", "data", "setup_known_tau_4096.json")


def vector(path: str) -> dict:
    """A vendored data.yaml: input fields of quoted hex, then output: a
    hex string, a list of them, a boolean or null."""
    inp, out = {}, None
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("output:"):
                v = line.split(":", 1)[1].strip()
                out = [] if v == "" else {"true": True, "false": False, "null": None}.get(
                    v, v and bytes.fromhex(v.strip("'")[2:]))
            elif line.startswith("- "):
                out.append(bytes.fromhex(line[2:].strip("'")[2:]))
            elif line.startswith("  ") and ":" in line:
                k, v = (s.strip() for s in line.split(":", 1))
                inp[k] = bytes.fromhex(v.strip("'")[2:])
    return {"input": inp, "output": out}


def valid(op: str) -> list[str]:
    return sorted(glob.glob(os.path.join(VECTORS, op, "valid_*", "data.yaml")))


@pytest.fixture(scope="module")
def mainnet_points():
    """The vendored ceremony setup's G1 points, bit-reversed as the spec's
    g1_lincomb takes them."""
    with open(MAINNET_SETUP) as f:
        hexes = json.load(f)["g1_lagrange"]
    return bit_reversal_permutation([g1.decompress(bytes.fromhex(h[2:])) for h in hexes])


def test_fields():
    vals = [random.Random(1).randrange(1, R) for _ in range(50)]
    assert batch_inverse(vals, R) == [pow(v, -1, R) for v in vals]
    assert fp_sqrt(4) in (2, P - 2)
    assert fp_sqrt(P - 1) is None  # -1 is a non-residue, p = 3 mod 4
    roots = roots_of_unity(8)
    assert pow(roots[1], 8, R) == 1 and pow(roots[1], 4, R) != 1
    assert bit_reversal_permutation(list(range(8))) == [0, 4, 2, 6, 1, 5, 3, 7]


def test_g1_generator_encoding_and_arithmetic():
    gen = bytes.fromhex("97f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac58"
                        "6c55e83ff97a1aeffb3af00adb22c6bb")
    assert g1.compress_many([g1.GEN]) == [gen]
    assert g1.decompress(gen) == (g1.GEN_X, g1.GEN_Y)
    assert g1.compress_many([g1.INF]) == [g1.INFINITY_BYTES]
    assert g1.decompress(g1.INFINITY_BYTES) is None
    assert g1.mul(g1.GEN, R)[2] == 0  # the generator has order r
    base = g1.FixedBase()
    for k in (0, 1, 2, 255, 256, R - 1, random.Random(2).randrange(R)):
        assert g1.equal(base.mul(k), g1.mul(g1.GEN, k))
        a = g1.to_affine_many([base.mul(k)])[0]
        assert g1.decompress(g1.compress(a)) == a
    p3 = g1.mul(g1.GEN, 3)
    assert g1.equal(g1.add(p3, g1.neg(p3)), g1.INF)
    assert g1.equal(g1.add(p3, p3), g1.double(p3))
    a3 = g1.to_affine_many([p3])[0]
    assert g1.equal(g1.add_affine(p3, a3), g1.double(p3))
    with pytest.raises(ValueError):
        g1.decompress(b"\x01" * 48)


@pytest.mark.parametrize("path", valid("compute_kzg_proof"), ids=lambda p: p.split(os.sep)[-2])
def test_evaluation_reproduces_compute_kzg_proof_y(path):
    """y = p(z), barycentric, for every valid compute_kzg_proof vector (the
    root hits among them); its proof needs the ceremony's tau."""
    v = vector(path)
    y = Domain().evaluate(blob_scalars(v["input"]["blob"]), int.from_bytes(v["input"]["z"], "big"))
    assert y.to_bytes(32, "big") == v["output"][1]


def test_slow_msm_reproduces_a_commitment_and_a_blob_proof(mainnet_points):
    """The reference's Pippenger MSM over the ceremony's setup gives a
    vendored commitment, and its quotient at the spec's challenge a
    vendored blob proof: the challenge, the evaluation, the quotient and
    the encoding, all without tau."""
    c = vector(os.path.join(VECTORS, "blob_to_kzg_commitment", "valid_0", "data.yaml"))
    blob = c["input"]["blob"]
    f = blob_scalars(blob)
    assert g1.compress_many([g1.msm(mainnet_points, f)]) == [c["output"]]

    p = vector(os.path.join(VECTORS, "compute_blob_kzg_proof", "valid_0", "data.yaml"))
    assert p["input"]["blob"] == blob
    domain = Domain()
    z = compute_challenge(blob, p["input"]["commitment"])
    y = domain.evaluate(f, z)
    q = [(fi - y) * d % R for fi, d in zip(f, batch_inverse([(w - z) % R for w in domain.roots], R))]
    assert g1.compress_many([g1.msm(mainnet_points, q)]) == [p["output"]]


def test_committed_setup_points_are_lagrange_at_tau():
    """A seeded sample of the committed setup: g1_lagrange[j] = L_j(tau) G1
    for the basis of w^j in natural order, g2_monomial[j] = tau^j G2."""
    with open(KNOWN_SETUP) as f:
        setup = json.load(f)
    n = 4096
    assert len(setup["g1_lagrange"]) == n and len(setup["g2_monomial"]) == 65
    roots = roots_of_unity(n)
    scale = (pow(TAU, n, R) - 1) * pow(n, -1, R) % R
    for j in random.Random(3).sample(range(n), 12) + [0, n - 1]:
        lj = scale * roots[j] * pow(TAU - roots[j], -1, R) % R
        assert setup["g1_lagrange"][j] == "0x" + g1.compress_many([g1.mul(g1.GEN, lj)])[0].hex()
    for j in (0, 1, 64):
        pt = g2.mul(g2.GEN, pow(TAU, j, R))
        assert g2.on_curve(pt)
        assert setup["g2_monomial"][j] == "0x" + g2.compress(pt).hex()


def test_make_setup_writes_the_committed_file():
    with open(KNOWN_SETUP) as f:
        assert json.load(f) == make_setup.setup_json()


def test_known_tau_scalars_follow_the_points():
    """p(tau) is the scalar of the setup's MSM; a blob proof's scalar
    satisfies the opening; a wrong y does not."""
    with open(KNOWN_SETUP) as f:
        hexes = json.load(f)["g1_lagrange"]
    points = bit_reversal_permutation([g1.decompress(bytes.fromhex(h[2:])) for h in hexes])
    ref = KnownTau()
    rng = random.Random(4)
    f = [rng.randrange(R) for _ in range(4096)]
    c = ref.commitment(f)
    assert g1.equal(g1.msm(points, f), g1.mul(g1.GEN, c))
    z = rng.randrange(R)
    y = ref.domain.evaluate(f, z)
    pi = ref.proof(c, z, y)
    assert ref.valid(c, z, y, pi) and not ref.valid(c, z, (y + 1) % R, pi)
