"""Host-side BLS12-381 constants and big-int arithmetic for the port.

Plain Python integers, no tensors: the curve and field constants, the Fp
and Fp2 arithmetic behind the Frobenius gammas and the G2 setup points,
Jacobian point arithmetic over Fp/Fp2, the Zcash compressed encodings the
verify path needs (G1 compression of the pad point, G2 decompression with
its curve and subgroup checks), and the KZG domain strings and error type.

Tower: Fp2 = Fp[u]/(u^2+1), Fp6 = Fp2[v]/(v^3 - (1+u)), Fp12 = Fp6[w]/(w^2-v).
Fp2 elements are (c0, c1) pairs; points are Jacobian triples (X, Y, Z) with
x = X/Z^2, y = Y/Z^3 and infinity at Z == 0.
"""

from __future__ import annotations

import hashlib

#: Base field modulus.
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

#: Scalar field modulus (the order of G1 and G2).
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

#: BLS parameter x (negative).
BLS_X = -0xD201000000010000

FS_DOMAIN = b"FSBLOBVERIFY_V1_"
RC_DOMAIN = b"RCKZGBATCH___V1_"


class KzgError(Exception):
    """Any input-validation failure (vs. an honest `False` verification)."""


class DecompressError(Exception):
    pass


class BadEncoding(DecompressError):
    pass


class NotOnCurve(DecompressError):
    pass


class NotInGroup(DecompressError):
    pass


def hash_to_fr(data: bytes) -> int:
    """SHA-256 then reduce mod r."""
    return int.from_bytes(hashlib.sha256(data).digest(), "big") % R


# ---------------------------------------------------------------------------
# Fp and Fp2
# ---------------------------------------------------------------------------

def fp_inv(a: int) -> int:
    return pow(a, P - 2, P)


def fp_sqrt(a: int) -> int | None:
    """Square root in Fp (p = 3 mod 4), or None for a non-residue."""
    c = pow(a, (P + 1) // 4, P)
    return c if c * c % P == a % P else None


FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)


def fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fp2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fp2_neg(a):
    return (-a[0] % P, -a[1] % P)


def fp2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0
    t1 = a1 * b1
    return ((t0 - t1) % P, ((a0 + a1) * (b0 + b1) - t0 - t1) % P)


def fp2_sqr(a):
    a0, a1 = a
    return ((a0 + a1) * (a0 - a1) % P, 2 * a0 * a1 % P)


def fp2_scalar(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def fp2_inv(a):
    a0, a1 = a
    ninv = fp_inv((a0 * a0 + a1 * a1) % P)
    return (a0 * ninv % P, -a1 * ninv % P)


def fp2_is_zero(a) -> bool:
    return a[0] == 0 and a[1] == 0


def fp2_pow(a, n: int):
    out = FP2_ONE
    while n:
        if n & 1:
            out = fp2_mul(out, a)
        a = fp2_sqr(a)
        n >>= 1
    return out


def fp2_sqrt(a):
    """Square root in Fp2 via Fp square roots of the norm, or None."""
    if fp2_is_zero(a):
        return (0, 0)
    a0, a1 = a
    if a1 == 0:
        s = fp_sqrt(a0)
        if s is not None:
            return (s, 0)
        s = fp_sqrt(-a0 % P)  # sqrt(n) = u * sqrt(-n) since u^2 = -1
        return None if s is None else (0, s)
    n = fp_sqrt((a0 * a0 + a1 * a1) % P)
    if n is None:
        return None
    inv2 = fp_inv(2)
    for sign in (n, -n % P):
        x = fp_sqrt((a0 + sign) * inv2 % P)
        if x is None or x == 0:
            continue
        y = a1 * fp_inv(2 * x % P) % P
        if fp2_sqr((x, y)) == (a0 % P, a1 % P):
            return (x, y)
    return None


#: GAMMA1[i-1] = xi^(i (p-1)/6) for xi = 1 + u, i = 1..5: the Fp12
#: Frobenius twists.
GAMMA1 = [fp2_pow((1, 1), i * ((P - 1) // 6)) for i in range(1, 6)]


# ---------------------------------------------------------------------------
# Jacobian curve arithmetic over Fp (G1) and Fp2 (G2)
# ---------------------------------------------------------------------------

class _FieldOps:
    __slots__ = ("add", "sub", "mul", "sqr", "inv", "scalar", "is_zero", "zero", "one", "b")

    def __init__(self, add, sub, mul, sqr, inv, scalar, is_zero, zero, one, b):
        self.add, self.sub, self.mul, self.sqr, self.inv = add, sub, mul, sqr, inv
        self.scalar, self.is_zero = scalar, is_zero
        self.zero, self.one, self.b = zero, one, b


FP_OPS = _FieldOps(
    add=lambda a, b: (a + b) % P,
    sub=lambda a, b: (a - b) % P,
    mul=lambda a, b: a * b % P,
    sqr=lambda a: a * a % P,
    inv=fp_inv,
    scalar=lambda a, k: a * k % P,
    is_zero=lambda a: a % P == 0,
    zero=0,
    one=1,
    b=4,
)

FP2_OPS = _FieldOps(
    add=fp2_add,
    sub=fp2_sub,
    mul=fp2_mul,
    sqr=fp2_sqr,
    inv=fp2_inv,
    scalar=fp2_scalar,
    is_zero=fp2_is_zero,
    zero=FP2_ZERO,
    one=FP2_ONE,
    b=(4, 4),  # 4 (1 + u)
)


def jac_infinity(F: _FieldOps):
    return (F.one, F.one, F.zero)


def jac_is_infinity(F: _FieldOps, p) -> bool:
    return F.is_zero(p[2])


def jac_double(F: _FieldOps, p):
    X, Y, Z = p
    if F.is_zero(Z) or F.is_zero(Y):
        return jac_infinity(F)
    A = F.sqr(X)
    B = F.sqr(Y)
    C = F.sqr(B)
    D = F.scalar(F.sub(F.sqr(F.add(X, B)), F.add(A, C)), 2)
    E = F.scalar(A, 3)
    X3 = F.sub(F.sqr(E), F.scalar(D, 2))
    Y3 = F.sub(F.mul(E, F.sub(D, X3)), F.scalar(C, 8))
    Z3 = F.scalar(F.mul(Y, Z), 2)
    return (X3, Y3, Z3)


def jac_add(F: _FieldOps, p, q):
    if jac_is_infinity(F, p):
        return q
    if jac_is_infinity(F, q):
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = F.sqr(Z1)
    Z2Z2 = F.sqr(Z2)
    U1 = F.mul(X1, Z2Z2)
    U2 = F.mul(X2, Z1Z1)
    S1 = F.mul(F.mul(Y1, Z2), Z2Z2)
    S2 = F.mul(F.mul(Y2, Z1), Z1Z1)
    if U1 == U2:
        return jac_double(F, p) if S1 == S2 else jac_infinity(F)
    H = F.sub(U2, U1)
    I = F.sqr(F.scalar(H, 2))
    J = F.mul(H, I)
    rr = F.scalar(F.sub(S2, S1), 2)
    V = F.mul(U1, I)
    X3 = F.sub(F.sub(F.sqr(rr), J), F.scalar(V, 2))
    Y3 = F.sub(F.mul(rr, F.sub(V, X3)), F.scalar(F.mul(S1, J), 2))
    Z3 = F.mul(F.scalar(F.mul(Z1, Z2), 2), H)
    return (X3, Y3, Z3)


def jac_mul_raw(F: _FieldOps, p, k: int):
    """k * p by MSB-first double-and-add, k NOT reduced mod r (so k == r
    really walks the chain, as the subgroup check needs)."""
    out = jac_infinity(F)
    if k == 0 or jac_is_infinity(F, p):
        return out
    for bit in bin(k)[2:]:
        out = jac_double(F, out)
        if bit == "1":
            out = jac_add(F, out, p)
    return out


def jac_to_affine(F: _FieldOps, p):
    """(x, y), or None for infinity."""
    X, Y, Z = p
    if F.is_zero(Z):
        return None
    zinv = F.inv(Z)
    zinv2 = F.sqr(zinv)
    return (F.mul(X, zinv2), F.mul(Y, F.mul(zinv, zinv2)))


G1_GEN = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
    1,
)
G2_GEN = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
    (1, 0),
)


# ---------------------------------------------------------------------------
# Zcash compressed encodings: 0x80 compressed, 0x40 infinity, 0x20 sign
# (y is the lexicographically larger root)
# ---------------------------------------------------------------------------

def _fp2_is_larger(y) -> bool:
    ny = fp2_neg(y)
    if y[1] != ny[1]:
        return y[1] > ny[1]
    return y[0] > ny[0]


def g1_compress(p) -> bytes:
    aff = jac_to_affine(FP_OPS, p)
    if aff is None:
        return bytes([0xC0] + [0] * 47)
    x, y = aff
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= 0x80
    if y > P - y:
        out[0] |= 0x20
    return bytes(out)


def g2_decompress(b: bytes):
    """96 compressed bytes -> Jacobian G2 point, with the curve and
    subgroup checks; raises a DecompressError subclass."""
    if len(b) != 96:
        raise BadEncoding("bad length")
    flags = b[0]
    if not flags & 0x80:
        raise BadEncoding("uncompressed bit")
    infinity = bool(flags & 0x40)
    sign = bool(flags & 0x20)
    x1 = int.from_bytes(bytes([flags & 0x1F]) + b[1:48], "big")
    x0 = int.from_bytes(b[48:], "big")
    if infinity:
        if sign or x0 != 0 or x1 != 0:
            raise BadEncoding("nonzero infinity encoding")
        return jac_infinity(FP2_OPS)
    if x0 >= P or x1 >= P:
        raise BadEncoding("x >= p")
    x = (x0, x1)
    y = fp2_sqrt(fp2_add(fp2_mul(fp2_sqr(x), x), FP2_OPS.b))
    if y is None:
        raise NotOnCurve("x not on curve")
    if _fp2_is_larger(y) != sign:
        y = fp2_neg(y)
    pt = (x, y, FP2_ONE)
    if not jac_is_infinity(FP2_OPS, jac_mul_raw(FP2_OPS, pt, R)):
        raise NotInGroup("not in G2")
    return pt


# ---------------------------------------------------------------------------
# evaluation domain
# ---------------------------------------------------------------------------

def brp_indices(n: int) -> list[int]:
    """Bit-reversal permutation of range(n), n a power of two."""
    bits = n.bit_length() - 1
    return [int(format(i, f"0{bits}b")[::-1], 2) if bits else 0 for i in range(n)]


def roots_of_unity(n: int) -> list[int]:
    """[1, w, w^2, ...] for w = 7^((r-1)/n), the n-th roots of unity."""
    w = pow(7, (R - 1) // n, R)
    out, cur = [], 1
    for _ in range(n):
        out.append(cur)
        cur = cur * w % R
    return out
