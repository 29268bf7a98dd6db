"""G1 of BLS12-381 (y^2 = x^3 + 4 over Fp) in Python integers: Jacobian
arithmetic, the Zcash compressed encoding of 48 bytes, a fixed-base table
for the generator, and a plain Pippenger MSM.

A Jacobian point (X, Y, Z) stands for (X/Z^2, Y/Z^3); Z = 0 is the point
at infinity.  An affine point is (x, y), or None at infinity."""

from __future__ import annotations

from .fields import P, R, batch_inverse, fp_sqrt

B = 4
GEN_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
GEN_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
GEN = (GEN_X, GEN_Y, 1)
INF = (1, 1, 0)
INFINITY_BYTES = bytes([0xC0]) + bytes(47)


def double(p):
    """dbl-2009-l (a = 0)."""
    X, Y, Z = p
    if Z == 0 or Y == 0:
        return INF
    A = X * X % P
    Bq = Y * Y % P
    C = Bq * Bq % P
    D = 2 * ((X + Bq) ** 2 - A - C) % P
    E = 3 * A % P
    X3 = (E * E - 2 * D) % P
    return X3, (E * (D - X3) - 8 * C) % P, 2 * Y * Z % P


def add(p, q):
    """add-2007-bl, with the equal and opposite cases."""
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1, Z2Z2 = Z1 * Z1 % P, Z2 * Z2 % P
    U1, U2 = X1 * Z2Z2 % P, X2 * Z1Z1 % P
    S1, S2 = Y1 * Z2 * Z2Z2 % P, Y2 * Z1 * Z1Z1 % P
    H, rr = (U2 - U1) % P, 2 * (S2 - S1) % P
    if H == 0:
        return double(p) if rr == 0 else INF
    I = 4 * H * H % P
    J = H * I % P
    V = U1 * I % P
    X3 = (rr * rr - J - 2 * V) % P
    return X3, (rr * (V - X3) - 2 * S1 * J) % P, ((Z1 + Z2) ** 2 - Z1Z1 - Z2Z2) * H % P


def add_affine(p, a):
    """madd-2007-bl: p + a for an affine a, with the equal and opposite
    cases."""
    if a is None:
        return p
    x2, y2 = a
    if p[2] == 0:
        return x2, y2, 1
    X1, Y1, Z1 = p
    Z1Z1 = Z1 * Z1 % P
    H = (x2 * Z1Z1 - X1) % P
    rr = 2 * (y2 * Z1 * Z1Z1 - Y1) % P
    if H == 0:
        return double(p) if rr == 0 else INF
    HH = H * H % P
    I = 4 * HH
    J = H * I % P
    V = X1 * I % P
    X3 = (rr * rr - J - 2 * V) % P
    return X3, (rr * (V - X3) - 2 * Y1 * J) % P, ((Z1 + H) ** 2 - Z1Z1 - HH) % P


def neg(p):
    return p[0], -p[1] % P, p[2]


def mul(p, k: int):
    """k p by double-and-add, most significant bit first."""
    out = INF
    for bit in bin(k % R)[2:]:
        out = double(out)
        if bit == "1":
            out = add(out, p)
    return out


def to_affine_many(points) -> list:
    """Jacobian points -> affine points (None at infinity), with one field
    inversion for all of them."""
    zs = [p[2] for p in points if p[2]]
    invs = iter(batch_inverse(zs, P)) if zs else iter(())
    out = []
    for X, Y, Z in points:
        if Z == 0:
            out.append(None)
            continue
        zi = next(invs)
        zi2 = zi * zi % P
        out.append((X * zi2 % P, Y * zi2 * zi % P))
    return out


def equal(p, q) -> bool:
    """Equality of two Jacobian points."""
    if p[2] == 0 or q[2] == 0:
        return p[2] == q[2] == 0
    z1, z2 = p[2] * p[2] % P, q[2] * q[2] % P
    return (p[0] * z2 - q[0] * z1) % P == 0 and (p[1] * z2 * q[2] - q[1] * z1 * p[2]) % P == 0


def compress(a) -> bytes:
    """An affine point's 48 bytes: x big-endian, with the flags 0x80
    (compressed), 0x40 (infinity) and 0x20 (y is the larger of y, -y)."""
    if a is None:
        return INFINITY_BYTES
    x, y = a
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= 0x80 | (0x20 if y > P - y else 0)
    return bytes(out)


def compress_many(points) -> list[bytes]:
    return [compress(a) for a in to_affine_many(points)]


def decompress(b: bytes):
    """48 bytes -> an affine point (None at infinity); ValueError for a
    bad encoding or an x off the curve.  The subgroup is not checked."""
    if len(b) != 48 or not b[0] & 0x80:
        raise ValueError("bad G1 encoding")
    infinity, sign = bool(b[0] & 0x40), bool(b[0] & 0x20)
    x = int.from_bytes(bytes([b[0] & 0x1F]) + b[1:], "big")
    if infinity:
        if sign or x:
            raise ValueError("bad G1 infinity encoding")
        return None
    if x >= P:
        raise ValueError("G1 x not canonical")
    y = fp_sqrt((x * x * x + B) % P)
    if y is None:
        raise ValueError("G1 x not on the curve")
    return x, (P - y if (y > P - y) != sign else y)


def from_affine(a):
    return INF if a is None else (a[0], a[1], 1)


class FixedBase:
    """Multiples of one point by a table of d 2^(w k) G for every window k
    and digit d: a product is one mixed addition a nonzero digit."""

    def __init__(self, base=GEN, window: int = 8, bits: int = 256):
        self.window = window
        self.windows = -(-bits // window)
        digits = (1 << window) - 1
        jac, step = [], base
        for _ in range(self.windows):
            row = [step]
            for _ in range(digits - 1):
                row.append(add(row[-1], step))
            jac.extend(row)
            step = add(row[-1], step)  # 2^w step = (2^w - 1) step + step
        flat = to_affine_many(jac)
        self.table = [flat[k * digits:(k + 1) * digits] for k in range(self.windows)]

    def mul(self, k: int):
        k %= R
        out, mask = INF, (1 << self.window) - 1
        for row in self.table:
            d = k & mask
            if d:
                out = add_affine(out, row[d - 1])
            k >>= self.window
        return out

    def compress_many(self, scalars) -> list[bytes]:
        """The compressed encodings of k G for each k."""
        return compress_many([self.mul(k) for k in scalars])


def msm(points, scalars, window: int = 8):
    """sum k_i P_i over affine points by Pippenger's bucket method, windows
    of `window` bits: plain and slow, for checks against a setup whose tau
    nobody knows."""
    acc = INF
    for shift in range((255 // window) * window, -1, -window):
        for _ in range(window):
            acc = double(acc)
        buckets = [INF] * (1 << window)
        for pt, k in zip(points, scalars):
            d = (k >> shift) & ((1 << window) - 1)
            if d and pt is not None:
                buckets[d] = add_affine(buckets[d], pt)
        running, total = INF, INF
        for d in range((1 << window) - 1, 0, -1):
            running = add(running, buckets[d])
            total = add(total, running)
        acc = add(acc, total)
    return acc
