"""The EIP-4844 KZG scalars in Python integers, after the deneb spec
(consensus-specs, specs/deneb/polynomial-commitments.md), for a setup made
from a tau that this module knows.

With tau known no MSM and no pairing is needed: a blob's commitment is
p(tau) G1, its blob proof ((p(tau) - y) / (tau - z)) G1 with z the spec's
Fiat-Shamir challenge and y = p(z), and an opening (c, z, y, pi), given by
the scalars of its points, is valid iff c - y = (tau - z) pi."""

from __future__ import annotations

import hashlib
import operator

from .fields import R, batch_inverse, bit_reversal_permutation, roots_of_unity

FIELD_ELEMENTS_PER_BLOB = 4096
BYTES_PER_FIELD_ELEMENT = 32
FIAT_SHAMIR_PROTOCOL_DOMAIN = b"FSBLOBVERIFY_V1_"

#: the secret of the benchmark's setup, known to the benchmark alone: it
#: is not secret, and a deployment's setup is not made so
TAU = int.from_bytes(hashlib.sha256(b"kzgbench known-tau setup").digest(), "big") % R


def blob_scalars(blob: bytes) -> list[int]:
    """A blob's field elements; ValueError for a non-canonical one."""
    out = [int.from_bytes(blob[i:i + 32], "big") for i in range(0, len(blob), BYTES_PER_FIELD_ELEMENT)]
    if any(v >= R for v in out):
        raise ValueError("non-canonical field element")
    return out


def compute_challenge(blob: bytes, commitment: bytes, n: int = FIELD_ELEMENTS_PER_BLOB) -> int:
    """The spec's compute_challenge: hash_to_bls_field(domain ||
    n as 16 big-endian bytes || blob || commitment)."""
    digest = hashlib.sha256(FIAT_SHAMIR_PROTOCOL_DOMAIN + n.to_bytes(16, "big") + blob + commitment)
    return int.from_bytes(digest.digest(), "big") % R


class Domain:
    """The roots of unity in bit-reversed order, at which a blob's elements
    are the polynomial's values."""

    def __init__(self, n: int = FIELD_ELEMENTS_PER_BLOB):
        self.n = n
        self.roots = bit_reversal_permutation(roots_of_unity(n))
        self._n_inv = pow(n, -1, R)

    def evaluate(self, elements: list[int], z: int) -> int:
        """The spec's evaluate_polynomial_in_evaluation_form, barycentric:
        (z^n - 1)/n sum f_i w_i / (z - w_i), or f_i where z = w_i."""
        if z in self.roots:
            return elements[self.roots.index(z)]
        invs = batch_inverse([(z - w) % R for w in self.roots], R)
        terms = [w * d % R for w, d in zip(self.roots, invs)]
        s = sum(map(operator.mul, elements, terms)) % R
        return s * (pow(z, self.n, R) - 1) * self._n_inv % R

    def lagrange_at(self, tau: int) -> list[int]:
        """L_i(tau) for the basis of each root, in the roots' order:
        (tau^n - 1)/n w_i / (tau - w_i)."""
        scale = (pow(tau, self.n, R) - 1) * self._n_inv % R
        invs = batch_inverse([(tau - w) % R for w in self.roots], R)
        return [scale * w % R * d % R for w, d in zip(self.roots, invs)]


class KnownTau:
    """Commitments, proofs and openings as scalars of G1, for the setup of
    the known tau."""

    def __init__(self, tau: int = TAU, n: int = FIELD_ELEMENTS_PER_BLOB):
        self.tau = tau
        self.domain = Domain(n)
        self.lagrange = self.domain.lagrange_at(tau)

    def commitment(self, elements: list[int]) -> int:
        """p(tau): the scalar of blob_to_kzg_commitment."""
        return sum(map(operator.mul, elements, self.lagrange)) % R

    def proof(self, c: int, z: int, y: int) -> int:
        """The scalar of the proof of p(z) = y for a p with p(tau) = c."""
        return (c - y) * pow((self.tau - z) % R, -1, R) % R

    def valid(self, c: int, z: int, y: int, pi: int) -> bool:
        """Whether the opening of scalars (c, z, y, pi) verifies:
        e(pi G1, (tau - z) G2) = e((c - y) G1, G2)."""
        return (c - y) % R == (self.tau - z) * pi % R
