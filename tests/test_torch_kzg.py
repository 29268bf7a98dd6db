"""The port's batch blob-proof verification slice, end to end on CPU.

The known-secret setup is the one of tests/test_kzg_api.py
(OracleSetup.generate_insecure(8, g2_len=2)).  The JAX package provides the
setup arrays (DeviceSetup.from_oracle), the host staging of a batch and the
batch challenge; the device results (the fused program's outputs and the
verdicts) are held against the pure-Python oracle, because the JAX fused
verification and pairing take minutes of XLA compile on this CPU.
"""

import dataclasses
import json
import random

import numpy as np
import pytest
import torch

from kateth_tpu.kzg import DeviceSetup
from kateth_tpu.kzg import Kzg as JaxKzg
from kateth_tpu.kzg import KzgConfig as JaxKzgConfig
from kateth_tpu.oracle import curve as oc
from kateth_tpu.oracle import field as of
from kateth_tpu.oracle.kzg import OracleSetup, blob_from_bytes, blob_to_bytes
from kateth_tpu_torch.curves import ops
from kateth_tpu_torch.fields.specs import FP
from kateth_tpu_torch.kzg import Kzg, KzgConfig, KzgError, TorchSetup
from kateth_tpu_torch.kzg import protocol
from kateth_tpu_torch.kzg.setup import FIELDS

N = 8
rng = random.Random(0x6B7A67)


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
def jax_setup(osetup):
    return DeviceSetup.from_oracle(osetup, JaxKzgConfig(n=N, g2_len=2))


@pytest.fixture(scope="module")
def kzg(jax_setup):
    """The port on CPU with a batch quantum of 4 (3 blobs + 1 pad lane)."""
    arrays = [np.asarray(getattr(jax_setup, k)) for k in FIELDS]
    return Kzg(TorchSetup.from_arrays(arrays, KzgConfig(n=N, g2_len=2, canon_batch=4), "cpu"))


@pytest.fixture(scope="module")
def triples(osetup):
    blobs = [blob_to_bytes([rng.randrange(of.R) for _ in range(N)]) for _ in range(3)]
    cms = [osetup.blob_to_commitment(b) for b in blobs]
    proofs = [osetup.blob_proof(b, c) for b, c in zip(blobs, cms)]
    return blobs, cms, proofs


def test_from_arrays_holds_the_jax_setup(kzg, jax_setup):
    for k in FIELDS:
        want = np.asarray(getattr(jax_setup, k)).astype(np.int64)
        assert np.array_equal(getattr(kzg.setup, k).numpy(), want), k


def test_load_json_decompresses_and_caches(osetup, kzg, tmp_path):
    path = tmp_path / "setup.json"
    path.write_text(json.dumps(osetup.to_json_dict()))
    cfg = KzgConfig(n=N, g2_len=2, canon_batch=4)
    for _ in range(2):  # the second load reads the .npz cache
        loaded = TorchSetup.load_json(str(path), cfg, device="cpu", cache_dir=str(tmp_path))
        for k in FIELDS:
            assert torch.equal(getattr(loaded, k), getattr(kzg.setup, k)), k
    assert len(list(tmp_path.glob("*.npz"))) == 1


@pytest.mark.parametrize("group", ["G1", "G2"])
def test_load_json_rejects_a_bad_point(osetup, tmp_path, group):
    d = osetup.to_json_dict()
    if group == "G1":  # x = 1 << 376: off the curve, found on the device
        d["g1_lagrange"][3] = "0x" + (b"\x81" + bytes(47)).hex()
    else:  # no compression flag, found by the host check
        d["g2_monomial"][1] = "0x" + bytes(96).hex()
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(d))
    with pytest.raises(KzgError, match=group):
        TorchSetup.load_json(str(path), KzgConfig(n=N, g2_len=2), device="cpu", cache_dir=None)


def test_challenges_match_jax(kzg, jax_setup, triples):
    """Fiat-Shamir digests and the batch challenge r, byte for byte."""
    jkzg = JaxKzg(jax_setup)
    blobs, cms, proofs = triples
    jb, jc, jp = b"".join(blobs), b"".join(cms), b"".join(proofs)
    digests = kzg._challenge_digests(jb, jc, 3)
    assert digests == jkzg._challenge_digests(jb, jc, 3)
    assert kzg._rlc_challenge(digests, jc, jp, 3) == jkzg._rlc_challenge(digests, jc, jp, 3)


def test_staging_matches_jax(jax_setup, triples):
    """The padded device arguments of the fused program, at the JAX
    package's batch quantum of 64: the port pads 3 triples to 4 lanes, the
    JAX package to 64, and each of the JAX package's pad lanes is the
    port's pad lane."""
    arrays = [np.asarray(getattr(jax_setup, k)) for k in FIELDS]
    port = Kzg(TorchSetup.from_arrays(arrays, KzgConfig(n=N, g2_len=2), "cpu"))
    n, got = port._verify_batch_stage(*triples)
    jn, want = JaxKzg(jax_setup)._verify_batch_stage(*triples)
    assert n == jn == 3
    assert port.lanes == {"verify_batch": [3, 4]}
    for g, w in zip(got[:6], want[:6]):
        g, w = g.numpy().astype(np.int64), np.asarray(w).astype(np.int64)
        assert g.shape[0] == 4 and w.shape[0] == 64
        assert np.array_equal(g, w[:4])
        assert (w[4:] == g[3]).all()
    flat_got = [got[6]] + list(got[7])
    flat_want = [want[6]] + list(want[7])
    for g, w in zip(flat_got, flat_want):
        assert np.array_equal(g.numpy().astype(np.int64), np.asarray(w).astype(np.int64))


def _affine_digits(pt):
    aff = oc.g1_to_affine(pt)
    return np.stack([FP.from_int(aff[0]), FP.from_int(aff[1])])


def test_fused_outputs_match_oracle(kzg, osetup, triples):
    """verify_blob_batch_fused: the (7, B) masks, and the pairing-check
    inputs sum w P and sum w (C - y G) + sum w z P against the oracle."""
    blobs, cms, proofs = triples
    bad_proofs = [proofs[0], b"\x01" * 48, proofs[2]]  # proof 1: no compression bit
    n, args = kzg._verify_batch_stage(blobs, cms, bad_proofs)
    (lhs, tau2, rhs), packed = protocol.verify_blob_batch_fused(*args)
    masks = packed.numpy()
    assert masks.shape == (7, 4)
    assert masks[:4].all()  # blobs and commitments
    assert masks[4].tolist() == [True, False, True, True]  # proof encodings
    assert masks[5:, [0, 2, 3]].all()  # the other proofs and the pad lane

    n, args = kzg._verify_batch_stage(blobs, cms, proofs)
    (lhs, tau2, rhs), packed = protocol.verify_blob_batch_fused(*args)
    assert packed.numpy().all()
    z = [osetup._challenge(blob_from_bytes(b, N), c) for b, c in zip(blobs, cms)]
    y = [osetup._evaluate(blob_from_bytes(b, N), zi) for b, zi in zip(blobs, z)]
    w = [int(protocol.FR.to_int(args[5][i].numpy(), mont=False)) for i in range(3)]
    ppts = [oc.g1_decompress(p) for p in proofs]
    cpts = [oc.g1_decompress(c) for c in cms]
    want_lhs = oc.g1_lincomb(ppts, w)
    gy = [oc.g1_add(c, oc.g1_mul(oc.g1_neg(oc.G1_GEN), yi)) for c, yi in zip(cpts, y)]
    want_rhs = oc.g1_add(oc.g1_lincomb(gy, w), oc.g1_lincomb(ppts, [a * b for a, b in zip(w, z)]))
    for got, want in ((lhs, want_lhs), (rhs, want_rhs)):
        aff = ops.to_affine(ops.FP_FIELD, tuple(c[0] for c in got))
        assert np.array_equal(np.stack([a.numpy() for a in aff]), _affine_digits(want))
    assert all(torch.equal(t[0], s) for t, s in zip(tau2, kzg.setup.tau2))


def test_verdicts_match_oracle(kzg, osetup, triples):
    """Honest batches verify and swapped proofs do not, through the
    streaming entry point (with an empty batch inside the stream) and the
    single-proof one, as the oracle decides on the same inputs."""
    blobs, cms, proofs = triples
    swapped = [proofs[1], proofs[0], proofs[2]]
    batches = [
        (blobs, cms, proofs),
        ([], [], []),
        (blobs[:1], cms[:1], proofs[:1]),
        (blobs, cms, swapped),
    ]
    assert kzg.verify_blob_kzg_proof_batches(batches) == [True, True, True, False]
    assert kzg.verify_blob_kzg_proof(blobs[0], cms[0], proofs[1]) is False
    assert kzg.verify_blob_kzg_proof_batches([]) == []
    assert kzg.verify_blob_kzg_proof_batch([], [], []) is True
    assert osetup.verify_blob_proof_batch(blobs, cms, proofs) is True
    assert osetup.verify_blob_proof_batch(blobs, cms, swapped) is False
    assert osetup.verify_blob_proof(blobs[0], cms[0], proofs[1]) is False


@pytest.mark.parametrize("n, valid", [(1, True), (3, False), (5, False), (9, True)])
def test_small_batches_verify_and_convert(kzg, osetup, n, valid):
    """At a batch quantum of 8, 1, 3 and 5 triples verify on 1, 4 and 8
    lanes and 9 on 16, with the oracle's verdict (a proof swapped for
    another blob's is refused); blobs_to_coefficients of the blobs gives,
    byte for byte, what the same Kzg gives when it pads to a multiple of
    8."""
    k = Kzg(dataclasses.replace(kzg.setup, config=KzgConfig(n=N, g2_len=2, canon_batch=8)))
    blobs = [blob_to_bytes([rng.randrange(of.R) for _ in range(N)]) for _ in range(n)]
    cms = [osetup.blob_to_commitment(b) for b in blobs]
    proofs = [osetup.blob_proof(b, c) for b, c in zip(blobs, cms)]
    if not valid:
        proofs[0], proofs[1] = proofs[1], proofs[0]
    assert osetup.verify_blob_proof_batch(blobs, cms, proofs) is valid
    assert k.verify_blob_kzg_proof_batch(blobs, cms, proofs) is valid
    padded = {1: 1, 3: 4, 5: 8, 9: 16}[n]
    assert k.lanes == {"verify_batch": [n, padded]}
    coeffs = k.blobs_to_coefficients(blobs)
    k._canon = lambda m: 8 * -(-max(m, 1) // 8)
    assert coeffs == k.blobs_to_coefficients(blobs)


class TestErrors:
    def test_bad_blob_length(self, kzg, triples):
        blobs, cms, proofs = triples
        with pytest.raises(KzgError, match="blob length"):
            kzg.verify_blob_kzg_proof(blobs[0][:-1], cms[0], proofs[0])

    def test_length_mismatch(self, kzg, triples):
        blobs, cms, proofs = triples
        with pytest.raises(KzgError, match="length mismatch"):
            kzg.verify_blob_kzg_proof_batch(blobs, cms[:2], proofs)

    def test_bad_point_length(self, kzg, triples):
        blobs, cms, proofs = triples
        with pytest.raises(KzgError, match="point length"):
            kzg.verify_blob_kzg_proof(blobs[0], cms[0] + b"\x00", proofs[0])

    def test_order_blob_then_commitment_then_proof(self, kzg, triples):
        """One batch with a non-canonical blob, an off-curve commitment and
        a badly encoded proof raises for the blob; without the bad blob,
        for the commitment (blob, then commitments, then proofs)."""
        blobs, cms, proofs = triples
        bad_blob = b"\xff" * 32 + blobs[0][32:]
        x = next(x for x in range(1, 100) if oc.fp_sqrt((x**3 + 4) % of.P) is None)
        off_curve = bytes([0x80]) + x.to_bytes(47, "big")
        with pytest.raises(KzgError, match="non-canonical"):
            kzg.verify_blob_kzg_proof_batch(
                [bad_blob, blobs[1]], [cms[0], off_curve], [b"\x01" * 48, proofs[1]]
            )
        with pytest.raises(KzgError, match="NotOnCurve"):
            kzg.verify_blob_kzg_proof_batch(
                blobs[:2], [cms[0], off_curve], [b"\x01" * 48, proofs[1]]
            )

    def test_streaming_error_ordering(self, kzg, triples):
        """The earliest bad batch's error wins, found at dispatch or at
        finalize, as a loop of single-batch calls would raise it."""
        blobs, cms, proofs = triples
        bad = b"\xff" * 32 + blobs[0][32:]
        with pytest.raises(KzgError, match="non-canonical"):
            kzg.verify_blob_kzg_proof_batches([([bad], cms[:1], proofs[:1]), (blobs, [], [])])
        with pytest.raises(KzgError, match="length mismatch"):
            kzg.verify_blob_kzg_proof_batches([(blobs, [], []), (blobs, cms, proofs)])
