"""Fr and Fp of BLS12-381 as Python integers, and the blob's evaluation
domain (consensus-specs, specs/deneb/polynomial-commitments.md)."""

from __future__ import annotations

#: the base field's modulus
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
#: the scalar field's modulus, BLS_MODULUS in the spec
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
#: PRIMITIVE_ROOT_OF_UNITY in the spec
PRIMITIVE_ROOT_OF_UNITY = 7


def batch_inverse(values: list[int], m: int) -> list[int]:
    """Inverses mod m of nonzero values, by Montgomery's trick: one
    inversion and three products an element."""
    prefix, acc = [], 1
    for v in values:
        prefix.append(acc)
        acc = acc * v % m
    inv = pow(acc, -1, m)
    out = [0] * len(values)
    for i in range(len(values) - 1, -1, -1):
        out[i] = inv * prefix[i] % m
        inv = inv * values[i] % m
    return out


def fp_sqrt(a: int) -> int | None:
    """A square root in Fp (p = 3 mod 4), or None for a non-residue."""
    c = pow(a, (P + 1) // 4, P)
    return c if c * c % P == a % P else None


def bit_reversal_permutation(seq: list) -> list:
    n = len(seq)
    bits = n.bit_length() - 1
    return [seq[int(format(i, f"0{bits}b")[::-1], 2) if bits else 0] for i in range(n)]


def roots_of_unity(n: int) -> list[int]:
    """[1, w, w^2, ...] for w = 7^((r - 1)/n), the spec's
    compute_roots_of_unity."""
    w = pow(PRIMITIVE_ROOT_OF_UNITY, (R - 1) // n, R)
    out, cur = [], 1
    for _ in range(n):
        out.append(cur)
        cur = cur * w % R
    return out
