"""G2 of BLS12-381 (y^2 = x^3 + 4(1 + u) over Fp2 = Fp[u]/(u^2 + 1)) in
Python integers: only what writing a setup's 65 monomial points takes,
multiples of the generator and their 96-byte compressed encodings.

An Fp2 element is a pair (c0, c1) for c0 + c1 u."""

from __future__ import annotations

from .fields import P

GEN_X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
GEN_Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)
ZERO, ONE = (0, 0), (1, 0)
GEN = (GEN_X, GEN_Y, ONE)
INF = (ONE, ONE, ZERO)
B = (4, 4)


def f_add(a, b):
    return (a[0] + b[0]) % P, (a[1] + b[1]) % P


def f_sub(a, b):
    return (a[0] - b[0]) % P, (a[1] - b[1]) % P


def f_mul(a, b):
    return (a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P


def f_scale(a, k: int):
    return a[0] * k % P, a[1] * k % P


def f_inv(a):
    d = pow((a[0] * a[0] + a[1] * a[1]) % P, -1, P)
    return a[0] * d % P, -a[1] * d % P


def double(p):
    """dbl-2009-l (a = 0) over Fp2."""
    X, Y, Z = p
    if Z == ZERO or Y == ZERO:
        return INF
    A = f_mul(X, X)
    Bq = f_mul(Y, Y)
    C = f_mul(Bq, Bq)
    XB = f_add(X, Bq)
    D = f_scale(f_sub(f_mul(XB, XB), f_add(A, C)), 2)
    E = f_scale(A, 3)
    X3 = f_sub(f_mul(E, E), f_scale(D, 2))
    return X3, f_sub(f_mul(E, f_sub(D, X3)), f_scale(C, 8)), f_scale(f_mul(Y, Z), 2)


def add(p, q):
    """add-2007-bl over Fp2, with the equal and opposite cases."""
    if p[2] == ZERO:
        return q
    if q[2] == ZERO:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1, Z2Z2 = f_mul(Z1, Z1), f_mul(Z2, Z2)
    U1, U2 = f_mul(X1, Z2Z2), f_mul(X2, Z1Z1)
    S1, S2 = f_mul(f_mul(Y1, Z2), Z2Z2), f_mul(f_mul(Y2, Z1), Z1Z1)
    H, rr = f_sub(U2, U1), f_scale(f_sub(S2, S1), 2)
    if H == ZERO:
        return double(p) if rr == ZERO else INF
    I = f_scale(f_mul(H, H), 4)
    J = f_mul(H, I)
    V = f_mul(U1, I)
    X3 = f_sub(f_sub(f_mul(rr, rr), J), f_scale(V, 2))
    Y3 = f_sub(f_mul(rr, f_sub(V, X3)), f_scale(f_mul(S1, J), 2))
    Z12 = f_add(Z1, Z2)
    return X3, Y3, f_mul(f_sub(f_mul(Z12, Z12), f_add(Z1Z1, Z2Z2)), H)


def mul(p, k: int):
    out = INF
    for bit in bin(k)[2:]:
        out = double(out)
        if bit == "1":
            out = add(out, p)
    return out


def on_curve(p) -> bool:
    """Whether an affine (x, y), given as a Jacobian point, lies on the
    curve."""
    X, Y, Z = p
    zi = f_inv(Z)
    zi2 = f_mul(zi, zi)
    x, y = f_mul(X, zi2), f_mul(Y, f_mul(zi2, zi))
    return f_mul(y, y) == f_add(f_mul(f_mul(x, x), x), B)


def compress(p) -> bytes:
    """96 bytes: x's c1 then c0, big-endian, with the flags of G1's
    encoding; y is the larger if its c1 is, or its c1 is 0 and its c0 is."""
    X, Y, Z = p
    if Z == ZERO:
        return bytes([0xC0]) + bytes(95)
    zi = f_inv(Z)
    zi2 = f_mul(zi, zi)
    x, y = f_mul(X, zi2), f_mul(Y, f_mul(zi2, zi))
    larger = y[1] > P - y[1] if y[1] else y[0] > P - y[0]
    out = bytearray(x[1].to_bytes(48, "big") + x[0].to_bytes(48, "big"))
    out[0] |= 0x80 | (0x20 if larger else 0)
    return bytes(out)
