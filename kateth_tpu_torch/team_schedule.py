"""Round schedules of the team kernels K3 (G1 ladder), K4 (Miller loop),
K5 (hard part of the final exponentiation), K6 (G2 ladder), K7 (chain
prefix sums) and K8 (comb chain sum).

A team of threads works on one lane and runs each step's independent Fp
operations in parallel, round by round.  This module writes each step as
rounds of instructions into a header in csrc/ that the kernels include:

  schedule_g1.cuh         one ladder bit of kernels.cu's g1_ladder_kernel
  schedule_miller.cuh     one bit of |x| of miller.cu's miller_kernel, in two
                          programs: bit 0 and bit 1
  schedule_hard_part.cuh  hard_part.cu's hard_part_kernel: a cyclotomic
                          squaring, a squaring and a product (a set bit of
                          |x|), and the five steps between the |x|-powers
  schedule_comb.cuh       one row of msm.cu's comb_chain_sum_kernel
  schedule_prefix.cuh     one row of msm.cu's chain_prefix_kernel
  schedule_g2.cuh         one ladder bit of g2_ladder.cu's g2_ladder_kernel

The headers are committed; the build only compiles them.  After editing
this module or the formulas it traces, rewrite them from the repository
root:

  python3 -m kateth_tpu_torch.team_schedule

An instruction is (op, dst, a, b) over Fp slots of 12 32-bit limbs in
shared memory: MUL dst = a b (Montgomery), ADD dst = a + b, SUB dst = a - b,
SMALL dst = b a for a small constant b, SEL dst = bit ? a : b with the
lane's scalar bit, COPY dst = a.  A product round holds MUL only, at most
one a thread of the team; a linear round holds the rest, so a warp never
diverges between the two kinds.  No instruction reads a slot that another
instruction of its round writes, so a round's instructions may run in any
order, on any thread.

The point formulas are traced: curves/ops.py's pdouble and padd run on a
CurveField whose values are node ids (graph_field), so they build the
graph where the plain versions compute.  The line functions and the tower
operations, which take no field object, are written out here over Fp:
cuda_pairing.py _line_dbl, _line_add and _merge_lines, and fields/fp6.py
and fp12.py mul, sqr, conj, frob and the Granger-Scott cyc_sqr.  Every
slot holds a canonical field element, so any sequence of operations that
computes the same field elements gives the same bits as the plain
versions: products by the constants 0 and 1 are folded away, equal
operations are computed once, and products run as early as their operands
and the team's width allow (linear operations as late as their users
allow).  cyc_sqr is the square only on the cyclotomic subgroup, where the
hard part's values lie.

tests/test_torch_team_schedule.py runs the schedules with the plain Fp
operations and holds them bit for bit against the plain ladder, the plain
Miller loop, the plain hard part, the plain chain sums, the plain chain
prefix sums and the plain G2 ladder.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from .curves import ops
from .fields import fp12 as fp12_plain
from .fields import limbs as L

MUL, ADD, SUB, SMALL, SEL, COPY = range(6)
OP_NAMES = ("MUL", "ADD", "SUB", "SMALL", "SEL", "COPY")

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")


# ---------------------------------------------------------------------------
# expression graph over Fp
# ---------------------------------------------------------------------------

class Graph:
    """A DAG of Fp operations, built through the methods below.  Node ids
    are topologically ordered; nodes 0 and 1 are the constants zero and
    one (Montgomery), then the named inputs."""

    ZERO, ONE = 0, 1

    def __init__(self, inputs: list[str]):
        self.nodes: list[tuple] = []
        self.memo: dict[tuple, int] = {}
        self.inputs = ["zero", "one", *inputs]
        for name in self.inputs:
            self._node(("in", name, None))

    def _node(self, key: tuple) -> int:
        if key not in self.memo:
            self.memo[key] = len(self.nodes)
            self.nodes.append(key)
        return self.memo[key]

    def inp(self, name: str) -> int:
        return self.memo[("in", name, None)]

    def mul(self, a: int, b: int) -> int:
        if self.ZERO in (a, b):
            return self.ZERO
        if a == self.ONE:
            return b
        if b == self.ONE:
            return a
        return self._node((MUL, min(a, b), max(a, b)))

    def add(self, a: int, b: int) -> int:
        if a == self.ZERO:
            return b
        if b == self.ZERO:
            return a
        return self._node((ADD, min(a, b), max(a, b)))

    def sub(self, a: int, b: int) -> int:
        if b == self.ZERO:
            return a
        if a == b:
            return self.ZERO
        return self._node((SUB, a, b))

    def small(self, a: int, k: int) -> int:
        if a == self.ZERO or k == 1:
            return a
        return self._node((SMALL, a, k))

    def sel(self, a: int, b: int) -> int:
        return a if a == b else self._node((SEL, a, b))

    def copy(self, a: int) -> int:
        """a in a second slot: for a value that two state outputs take."""
        return self._node((COPY, a, None))


# --- the tower over Fp: Fp2 = (c0, c1), Fp6 = 3 Fp2, Fp12 = 2 Fp6 ----------

def f2_add(g, a, b):
    return (g.add(a[0], b[0]), g.add(a[1], b[1]))


def f2_sub(g, a, b):
    return (g.sub(a[0], b[0]), g.sub(a[1], b[1]))


def f2_neg(g, a):
    return (g.sub(g.ZERO, a[0]), g.sub(g.ZERO, a[1]))


def f2_xi(g, a):
    """(1 + u)(c0 + c1 u) = (c0 - c1) + (c0 + c1) u"""
    return (g.sub(a[0], a[1]), g.add(a[0], a[1]))


def f2_small(g, a, k):
    return (g.small(a[0], k), g.small(a[1], k))


def f2_conj(g, a):
    return (a[0], g.sub(g.ZERO, a[1]))


def f2_mul(g, a, b):
    """Karatsuba (fields/fp2.py mul); an operand in Fp (c1 = 0) scales."""
    if b[1] == g.ZERO:
        return (g.mul(a[0], b[0]), g.mul(a[1], b[0]))
    if a[1] == g.ZERO:
        return (g.mul(a[0], b[0]), g.mul(a[0], b[1]))
    t0 = g.mul(a[0], b[0])
    t1 = g.mul(a[1], b[1])
    t2 = g.mul(g.add(a[0], a[1]), g.add(b[0], b[1]))
    return (g.sub(t0, t1), g.sub(t2, g.add(t0, t1)))


def f2_sqr(g, a):
    """fields/fp2.py sqr: (a0 + a1)(a0 - a1) + 2 a0 a1 u."""
    p = g.mul(g.add(a[0], a[1]), g.sub(a[0], a[1]))
    q = g.mul(a[0], a[1])
    return (p, g.add(q, q))


def f6_add(g, a, b):
    return tuple(f2_add(g, x, y) for x, y in zip(a, b))


def f6_sub(g, a, b):
    return tuple(f2_sub(g, x, y) for x, y in zip(a, b))


def f6_neg(g, a):
    return tuple(f2_neg(g, x) for x in a)


def f6_mul_by_v(g, a):
    return (f2_xi(g, a[2]), a[0], a[1])


def f6_mul(g, a, b):
    """fields/fp6.py mul: t_i = a_i b_i and three cross products."""
    t0, t1, t2 = (f2_mul(g, a[i], b[i]) for i in range(3))
    s0 = f2_mul(g, f2_add(g, a[1], a[2]), f2_add(g, b[1], b[2]))
    s1 = f2_mul(g, f2_add(g, a[0], a[1]), f2_add(g, b[0], b[1]))
    s2 = f2_mul(g, f2_add(g, a[0], a[2]), f2_add(g, b[0], b[2]))
    c0 = f2_add(g, t0, f2_xi(g, f2_sub(g, s0, f2_add(g, t1, t2))))
    c1 = f2_add(g, f2_sub(g, s1, f2_add(g, t0, t1)), f2_xi(g, t2))
    c2 = f2_add(g, f2_sub(g, s2, f2_add(g, t0, t2)), t1)
    return (c0, c1, c2)


def f12_mul(g, a, b):
    """fields/fp12.py mul: c0 = t0 + v t1, c1 = s - t0 - t1."""
    t0 = f6_mul(g, a[0], b[0])
    t1 = f6_mul(g, a[1], b[1])
    s = f6_mul(g, f6_add(g, a[0], a[1]), f6_add(g, b[0], b[1]))
    return (f6_add(g, t0, f6_mul_by_v(g, t1)), f6_sub(g, s, f6_add(g, t0, t1)))


def f12_sqr(g, a):
    """fields/fp12.py sqr: t = a0 a1, c0 = (a0 + a1)(a0 + v a1) - t - v t,
    c1 = 2 t."""
    t = f6_mul(g, a[0], a[1])
    s = f6_mul(g, f6_add(g, a[0], a[1]), f6_add(g, a[0], f6_mul_by_v(g, a[1])))
    return (f6_sub(g, s, f6_add(g, t, f6_mul_by_v(g, t))), f6_add(g, t, t))


def f12_conj(g, a):
    """fields/fp12.py conj: a0 - a1 w."""
    return (a[0], f6_neg(g, a[1]))


def f12_cyc_sqr(g, a):
    """fields/fp12.py cyc_sqr (Granger-Scott), the square on the cyclotomic
    subgroup: 9 Fp2 squares."""
    (a0, a1, a2), (b0, b1, b2) = a
    lo, hi = (b1, a2, b2), (a0, b0, a1)
    tl = [f2_sqr(g, x) for x in lo]
    th = [f2_sqr(g, x) for x in hi]
    ts = [f2_sqr(g, f2_add(g, x, y)) for x, y in zip(lo, hi)]
    cross = [f2_sub(g, s, f2_add(g, x, y)) for s, x, y in zip(ts, tl, th)]
    u = [f2_add(g, f2_xi(g, x), y) for x, y in zip(tl, th)]
    d0 = [f2_sub(g, x, c) for x, c in zip(u, (a0, a1, a2))]
    c0 = tuple(f2_add(g, f2_add(g, d, d), x) for d, x in zip(d0, u))
    t = (f2_xi(g, cross[2]), cross[0], cross[1])
    d1 = [f2_add(g, x, c) for x, c in zip(t, (b0, b1, b2))]
    c1 = tuple(f2_add(g, f2_add(g, d, d), x) for d, x in zip(d1, t))
    return (c0, c1)


def f12_frob(g, a, gamma):
    """fields/fp12.py frob: conjugate every Fp2 coordinate, then twist the
    coordinates (c0.1, c0.2, c1.0, c1.1, c1.2) by gamma (2, 4, 1, 3, 5);
    gamma[i] is the node pair of gamma_(i+1)."""
    coords = [f2_conj(g, a[j // 3][j % 3]) for j in range(6)]
    for j, i in zip(range(1, 6), (1, 3, 0, 2, 4)):
        coords[j] = f2_mul(g, coords[j], gamma[i])
    return (tuple(coords[:3]), tuple(coords[3:]))


# --- curves/ops.py traced: a CurveField over node ids ----------------------

def _elementwise(fn, *xs: torch.Tensor) -> torch.Tensor:
    flat = zip(*(x.reshape(-1).tolist() for x in xs))
    return torch.tensor([fn(*v) for v in flat], dtype=torch.int64).reshape(xs[0].shape)


def _unused(*_):
    raise NotImplementedError("not traced")


def graph_field(g: Graph, fdim: int) -> ops.CurveField:
    """ops.CurveField whose values are int64 tensors of g's node ids: an Fp
    value is a 0-d tensor, an Fp2 value a (2,) tensor (c0, c1).  The point
    formulas stack such values as they stack digit planes, and each
    operation adds nodes to g instead of computing."""

    def mul(a, b):
        if fdim == 1:
            return torch.tensor(g.mul(int(a), int(b)))
        return torch.tensor(f2_mul(g, tuple(a.tolist()), tuple(b.tolist())))

    def small(x, k, xi):
        v = tuple(x.tolist()) if fdim == 2 else (int(x),)
        if xi and fdim == 2:
            v = f2_xi(g, v)
        return torch.tensor([g.small(c, k) for c in v]).reshape(x.shape)

    return ops.CurveField(
        name=f"graph{fdim}",
        fdim=fdim,
        add=lambda a, b: _elementwise(g.add, a, b),
        sub=lambda a, b: _elementwise(g.sub, a, b),
        neg=lambda a: _elementwise(lambda c: g.sub(g.ZERO, c), a),
        mul_many=lambda pairs: [mul(a, b) for a, b in pairs],
        smallmul_many=lambda items: [small(*it) for it in items],
        zero=_unused,
        one=_unused,
        is_zero=_unused,
        inv=_unused,
    )


def _pdouble(g: Graph, fdim: int, p: tuple) -> tuple:
    """ops.pdouble on the node ids p (ints, or Fp2 pairs), traced into g."""
    return _ids(ops.pdouble(graph_field(g, fdim), tuple(torch.tensor(c) for c in p)))


def _padd(g: Graph, fdim: int, p: tuple, q: tuple) -> tuple:
    """ops.padd on the node ids p and q, traced into g."""
    F = graph_field(g, fdim)
    return _ids(ops.padd(F, tuple(torch.tensor(c) for c in p), tuple(torch.tensor(c) for c in q)))


def _ids(point) -> tuple:
    return tuple(c.item() if c.ndim == 0 else tuple(c.tolist()) for c in point)


# --- the two kernels' steps ----------------------------------------------------

G1_STATE = ["x", "y", "z"]
G1_INPUTS = [*G1_STATE, "bx", "by", "bz"]


def g1_step() -> tuple[Graph, dict[str, int]]:
    """acc = 2 acc, then acc = bit ? acc + base : acc (ops.scalar_mul)."""
    g = Graph(G1_INPUTS)
    acc = tuple(g.inp(n) for n in G1_STATE)
    base = tuple(g.inp(n) for n in ("bx", "by", "bz"))
    dbl = _pdouble(g, 1, acc)
    s = _padd(g, 1, dbl, base)
    return g, {n: g.sel(s[i], dbl[i]) for i, n in enumerate(G1_STATE)}


COMB_INPUTS = [*G1_STATE, "x2", "y2"]


def comb_step() -> tuple[Graph, dict[str, int]]:
    """acc = acc + (x2 : y2 : z2) with z2 = bit ? 1 : 0, the row's flag
    (cuda_msm.comb_chain_sum_plain)."""
    g = Graph(COMB_INPUTS)
    acc = tuple(g.inp(n) for n in G1_STATE)
    s = _padd(g, 1, acc, (g.inp("x2"), g.inp("y2"), g.sel(g.ONE, g.ZERO)))
    return g, dict(zip(G1_STATE, s))


PREFIX_INPUTS = [*G1_STATE, "x2", "y2", "z2"]


def prefix_step() -> tuple[Graph, dict[str, int]]:
    """acc = acc + (x2 : y2 : z2), a projective row of the windowed MSM's
    bucket scan (cuda_msm.chain_prefix_plain)."""
    g = Graph(PREFIX_INPUTS)
    acc = tuple(g.inp(n) for n in G1_STATE)
    s = _padd(g, 1, acc, tuple(g.inp(n) for n in ("x2", "y2", "z2")))
    return g, dict(zip(G1_STATE, s))


def _fp2_names(stem: str) -> list[str]:
    return [f"{stem}_{i}" for i in range(2)]


#: the G2 ladder's state, acc over projective Fp2, and its base
G2_STATE = [n for c in ("x", "y", "z") for n in _fp2_names(c)]
G2_INPUTS = [*G2_STATE, *(n for c in ("bx", "by", "bz") for n in _fp2_names(c))]


def g2_step() -> tuple[Graph, dict[str, int]]:
    """g1_step over Fp2: acc = 2 acc, then acc = bit ? acc + base : acc,
    a SEL on each of the six Fp components."""
    g = Graph(G2_INPUTS)
    two = lambda stem: tuple(g.inp(n) for n in _fp2_names(stem))  # noqa: E731
    acc = (two("x"), two("y"), two("z"))
    dbl = _pdouble(g, 2, acc)
    s = _padd(g, 2, dbl, (two("bx"), two("by"), two("bz")))
    return g, {n: g.sel(s[i // 2][i % 2], dbl[i // 2][i % 2]) for i, n in enumerate(G2_STATE)}


def _f12_names(stem: str) -> list[str]:
    """An Fp12 value's 12 coefficients m = (w 3 + v) 2 + u (the digit-plane
    order of (2, 3, 2, 24))."""
    return [f"{stem}_{m}" for m in range(12)]


def _f12_in(g: Graph, stem: str) -> tuple:
    """The Fp12 input `stem` as two Fp6 of three Fp2 node pairs."""
    v = [g.inp(n) for n in _f12_names(stem)]
    return tuple(tuple((v[(w * 3 + k) * 2], v[(w * 3 + k) * 2 + 1]) for k in range(3))
                 for w in range(2))


def _f12_flat(a) -> list[int]:
    return [c for half in a for x in half for c in x]


#: the step state: T on the twist, projective; f in Fp12
T_NAMES = [n for c in ("tx", "ty", "tz") for n in _fp2_names(c)]
F_NAMES = _f12_names("f")
MILLER_STATE = [*T_NAMES, *F_NAMES]
MILLER_INPUTS = [*MILLER_STATE, "xp", "yp", *_fp2_names("xq"), *_fp2_names("yq")]


def miller_step(bit: int) -> tuple[Graph, dict[str, int]]:
    """One bit of |x| (cuda_pairing.miller_loop_affine_plain): the tangent
    line at T, T doubled, for a set bit the chord through T and Q and
    T + Q, both lines folded with P and merged, then f = f^2 line."""
    g = Graph(MILLER_INPUTS)
    two = lambda stem: tuple(g.inp(n) for n in _fp2_names(stem))  # noqa: E731
    T = (two("tx"), two("ty"), two("tz"))
    f = _f12_in(g, "f")
    xp, yp = (g.inp("xp"), g.ZERO), (g.inp("yp"), g.ZERO)
    xq, yq = two("xq"), two("yq")
    zero2, one2 = (g.ZERO, g.ZERO), (g.ONE, g.ZERO)
    mul = lambda a, b: f2_mul(g, a, b)  # noqa: E731
    add = lambda a, b: f2_add(g, a, b)  # noqa: E731
    sub = lambda a, b: f2_sub(g, a, b)  # noqa: E731
    # _line_dbl
    X, Y, Z = T
    x2, y2, yz = mul(X, X), mul(Y, Y), mul(Y, Z)
    x3, y2z, yz2, x2z = mul(x2, X), mul(y2, Z), mul(yz, Z), mul(x2, Z)
    a = sub(f2_small(g, x3, 3), f2_small(g, y2z, 2))
    b = f2_neg(g, f2_small(g, x2z, 3))
    c = f2_small(g, yz2, 2)
    l1 = (a, mul(b, xp), mul(c, yp))
    T = _pdouble(g, 2, T)
    if bit:
        # _line_add with the doubled T, then T + Q
        X, Y, Z = T
        n = sub(mul(yq, Z), Y)
        d = sub(mul(xq, Z), X)
        l2 = (sub(mul(n, xq), mul(d, yq)), mul(f2_neg(g, n), xp), mul(d, yp))
        T = _padd(g, 2, T, (xq, yq, one2))
    else:
        l2 = (one2, zero2, zero2)
    # _merge_lines
    (a1, b1, c1), (a2, b2, c2) = l1, l2
    aa, bb, cc = mul(a1, a2), mul(b1, b2), mul(c1, c2)
    ab = sub(mul(add(a1, b1), add(a2, b2)), add(aa, bb))
    ac = sub(mul(add(a1, c1), add(a2, c2)), add(aa, cc))
    bc = sub(mul(add(b1, c1), add(b2, c2)), add(bb, cc))
    line = ((add(aa, f2_xi(g, cc)), ab, bb), (zero2, ac, bc))
    f = f12_mul(g, f12_sqr(g, f), line)
    out = {n: T[i // 2][i % 2] for i, n in enumerate(T_NAMES)}
    out.update(zip(F_NAMES, _f12_flat(f)))
    return g, out


def _hard_part_consts() -> dict[str, int]:
    """The nonzero coefficients of the Frobenius gammas, each value once:
    gamma{i}_{c} -> its Montgomery value."""
    out: dict[str, int] = {}
    for i, gamma in enumerate(fp12_plain.GAMMA):
        for c in range(2):
            v = L.digits_to_int(gamma[c])
            if v and v not in out.values():
                out[f"gamma{i + 1}_{c}"] = v
    return out


HARD_PART_CONSTS = _hard_part_consts()
#: the step state: acc (the running power), g (the power's base), f (the
#: input, then f^3), s (the factor frob^2(t2) conj(t2) f^3)
HARD_PART_STATE = [n for stem in ("acc", "g", "f", "s") for n in _f12_names(stem)]
HARD_PART_INPUTS = [*HARD_PART_CONSTS, *HARD_PART_STATE]
#: the programs, in their order in the header: hard_part.cu drives each
#: of the five |x|-powers as acc = g, then for the bits of |x| after its
#: leading one sqr or sqr_mul, then the next glue step
HARD_PART_PROGRAMS = ("sqr", "sqr_mul", "glue0", "glue1", "glue2", "glue3", "glue4")


def hard_part_step(name: str) -> tuple[Graph, dict[str, int]]:
    """One program of the hard part (cuda_pairing.hard_part_plain):

      sqr      acc = cyc_sqr(acc)
      sqr_mul  acc = cyc_sqr(acc) g
      glue0    t0 = conj(acc) conj(f): g = acc = t0; f = cyc_sqr(f) f
      glue1    t1 = conj(acc) conj(g): g = acc = t1
      glue2    t2 = conj(acc) frob(g): g = acc = t2;
               s = frob(frob(t2)) conj(t2) f
      glue3    g = acc
      glue4    acc = acc s

    After a power's loop, acc = g^|x|, and conj(acc) = g^x.  The fourth
    power runs on x(t2) conjugated, so glue3 and glue4 take acc as it is:
    conj(a)^|x| = conj(a^|x|), and the two conjugations of x(x(t2)) cancel.
    The result is t3 f^3 of the plain chain, grouped as x(x(t2)) s."""
    g = Graph(HARD_PART_INPUTS)
    node_of = {v: g.inp(n) for n, v in HARD_PART_CONSTS.items()}
    gamma = [tuple(node_of.get(L.digits_to_int(gm[c]), g.ZERO) for c in range(2))
             for gm in fp12_plain.GAMMA]
    acc, base, f, s = (_f12_in(g, stem) for stem in ("acc", "g", "f", "s"))
    mul = lambda a, b: f12_mul(g, a, b)  # noqa: E731
    conj = lambda a: f12_conj(g, a)  # noqa: E731
    new = {}
    if name == "sqr":
        new["acc"] = f12_cyc_sqr(g, acc)
    elif name == "sqr_mul":
        new["acc"] = mul(f12_cyc_sqr(g, acc), base)
    elif name == "glue0":
        new["g"] = mul(conj(acc), conj(f))
        new["f"] = mul(f12_cyc_sqr(g, f), f)
    elif name == "glue1":
        new["g"] = mul(conj(acc), conj(base))
    elif name == "glue2":
        t2 = new["g"] = mul(conj(acc), f12_frob(g, base, gamma))
        frob2 = f12_frob(g, f12_frob(g, t2, gamma), gamma)
        new["s"] = mul(mul(frob2, conj(t2)), f)
    elif name == "glue4":
        new["acc"] = mul(acc, s)
    out = {}
    for stem, v in new.items():
        out.update(zip(_f12_names(stem), _f12_flat(v)))
    if name in ("glue0", "glue1", "glue2"):
        out.update(zip(_f12_names("acc"), map(g.copy, _f12_flat(new["g"]))))
    elif name == "glue3":
        out.update(zip(_f12_names("g"), map(g.copy, _f12_flat(acc))))
    return g, out


# ---------------------------------------------------------------------------
# scheduling and slot allocation
# ---------------------------------------------------------------------------

@dataclass
class Program:
    """Rounds of one step: (is_product_round, [(op, dst, a, b), ...])."""

    name: str
    rounds: list[tuple[bool, list[tuple[int, int, int, int]]]]

    @property
    def n_products(self) -> int:
        return sum(len(ins) for m, ins in self.rounds if m)

    @property
    def n_product_rounds(self) -> int:
        return sum(1 for m, _ in self.rounds if m)


def _args(node: tuple) -> tuple[int, ...]:
    op, a, b = node
    if op == "in":
        return ()
    return (a,) if op in (SMALL, COPY) else (a, b)


def schedule(g: Graph, outputs: dict[str, int], slot_of: dict[str, int],
             name: str, width: int) -> tuple[Program, int]:
    """Rounds for the graph's live nodes and slots for their values.

    Products run at their earliest round that holds fewer than `width`
    products (the team's threads).  Between two product rounds lies
    a gap of linear rounds; each linear operation runs in the latest gap,
    and at the latest level of that gap, that its users allow.  Inputs
    live in their fixed slots (slot_of); a state output is written straight
    into its input's slot, which the old value must have left by then.
    Returns the program and the number of slots used."""
    nodes = g.nodes
    live, stack = set(), list(outputs.values())
    while stack:
        n = stack.pop()
        if n not in live:
            live.add(n)
            stack.extend(_args(nodes[n]))
    order = sorted(n for n in live if nodes[n][0] != "in")
    users: dict[int, list[int]] = {n: [] for n in live}
    for n in order:
        for a in _args(nodes[n]):
            users[a].append(n)
    is_out = set(outputs.values())

    # products at the earliest round with room; pos = round (product) or
    # gap (linear)
    pos = {n: 0 for n in live if nodes[n][0] == "in"}
    filled: dict[int, int] = {}
    for n in order:
        p = max((pos[a] for a in _args(nodes[n])), default=0)
        if nodes[n][0] == MUL:
            p += 1
            while filled.get(p, 0) == width:
                p += 1
            filled[p] = filled.get(p, 0) + 1
        pos[n] = p
    depth = max((pos[n] for n in order if nodes[n][0] == MUL), default=0)
    # linear operations at the latest gap, then at the latest level of it
    gap, height = {}, {}
    for n in reversed(order):
        if nodes[n][0] == MUL:
            continue
        lim = [depth] if n in is_out else []
        for u in users[n]:
            lim.append(pos[u] - 1 if nodes[u][0] == MUL else gap[u])
        gap[n] = min(lim)
        assert gap[n] >= pos[n], (name, n)
        height[n] = max(
            (height[u] + 1 for u in users[n] if nodes[u][0] != MUL and gap[u] == gap[n]), default=0
        )
    depth_of = {}
    for n, gp in gap.items():
        depth_of[gp] = max(depth_of.get(gp, 0), height[n] + 1)
    # the nodes of each round, in order
    nodes_by_round: list[tuple[bool, list[int]]] = []
    for gp in range(depth + 1):
        d = depth_of.get(gp, 0)
        level_nodes = [[] for _ in range(d)]
        for n in order:
            if nodes[n][0] != MUL and gap[n] == gp:
                level_nodes[d - 1 - height[n]].append(n)
        nodes_by_round += [(False, ns) for ns in level_nodes]
        if gp < depth:
            nodes_by_round.append((True, [n for n in order if nodes[n][0] == MUL and pos[n] == gp + 1]))
    rnd = {n: r for r, (_, ns) in enumerate(nodes_by_round) for n in ns}

    # slots: inputs fixed; state outputs in their input's slot; the rest
    # from a free list
    last_use = {n: max((rnd[u] for u in users[n]), default=-1) for n in live}
    home = {g.inp(s): slot_of[s] for s in slot_of}
    for s, n in outputs.items():
        assert n not in home and rnd[n] > last_use.get(g.inp(s), -1), (name, s, "needs a copy")
        home[n] = slot_of[s]
    free: list[int] = []
    next_slot = len(slot_of)
    release: dict[int, list[int]] = {}
    rounds = []
    for r, (is_mul, ns) in enumerate(nodes_by_round):
        free = sorted(free + release.pop(r, []))
        ins = []
        for n in ns:
            if n not in home:
                if free:
                    home[n] = free.pop(0)
                else:
                    home[n] = next_slot
                    next_slot += 1
                release.setdefault(last_use[n] + 1, []).append(home[n])
            op, a, b = nodes[n]
            if op == SMALL:
                ins.append((op, home[n], home[a], b))
            elif op == COPY:
                ins.append((op, home[n], home[a], 0))
            else:
                ins.append((op, home[n], home[a], home[b]))
        rounds.append((is_mul, ins))
    return Program(name, rounds), next_slot


def check_program(p: Program, n_slots: int, width: int) -> None:
    """Each round: one kind, distinct destinations, no slot both read and
    written, and no more products than the team has threads."""
    for is_mul, ins in p.rounds:
        assert ins, p.name
        dst = [i[1] for i in ins]
        reads = {s for op, _, a, b in ins for s in ((a,) if op in (SMALL, COPY) else (a, b))}
        assert len(set(dst)) == len(dst), p.name
        assert not set(dst) & reads, p.name
        assert all((op == MUL) == is_mul for op, *_ in ins), p.name
        assert not is_mul or len(ins) <= width, p.name
        assert max(dst) < n_slots and max(reads, default=0) < n_slots, p.name


@dataclass
class Schedule:
    """The programs of one kernel over one slot file."""

    kernel: str
    slot_of: dict[str, int]  # named inputs (constants, state, operands)
    n_slots: int
    programs: list[Program]
    threads: int  # threads of a team
    consts: dict[str, int] | None = None  # named constant inputs -> Montgomery value


def _schedule_all(kernel: str, steps: dict, threads: int, consts=None) -> Schedule:
    """The programs of `steps` (name -> (graph, outputs), graphs over one
    input list) over one slot file."""
    progs, n_slots = [], 0
    for name, (g, out) in steps.items():
        slot_of = {n: i for i, n in enumerate(g.inputs)}
        prog, n = schedule(g, out, slot_of, name, threads)
        progs.append(prog)
        n_slots = max(n_slots, n)
    for p in progs:
        check_program(p, n_slots, threads)
    return Schedule(kernel, slot_of, n_slots, progs, threads, consts)


def g1_schedule() -> Schedule:
    return _schedule_all("g1_ladder", {"g1_step": g1_step()}, 8)


def comb_schedule() -> Schedule:
    return _schedule_all("comb", {"comb_step": comb_step()}, 8)


def prefix_schedule() -> Schedule:
    return _schedule_all("prefix", {"prefix_step": prefix_step()}, 8)


def g2_schedule() -> Schedule:
    """A warp per lane: the widest product round, the addition's six Fp2
    products (18 Fp products after Karatsuba), runs in one pass."""
    return _schedule_all("g2_ladder", {"g2_step": g2_step()}, 32)


def miller_schedule() -> Schedule:
    return _schedule_all("miller", {f"miller_bit{b}": miller_step(b) for b in (0, 1)}, 64)


def hard_part_schedule() -> Schedule:
    return _schedule_all(
        "hard_part", {name: hard_part_step(name) for name in HARD_PART_PROGRAMS}, 64,
        HARD_PART_CONSTS)


# ---------------------------------------------------------------------------
# the headers
# ---------------------------------------------------------------------------

def _ident(name: str) -> str:
    return "kSlot_" + name


def emit(s: Schedule) -> str:
    rounds = [r for p in s.programs for r in p.rounds]
    starts, total = [], 0
    for _, ins in rounds:
        starts.append(total)
        total += len(ins)
    starts.append(total)
    prog_rounds, acc = [0], 0
    for p in s.programs:
        acc += len(p.rounds)
        prog_rounds.append(acc)
    ns = f"sched_{s.kernel}"
    lines = [
        f"// Round schedule of the team kernel {s.kernel}: generated by",
        "// kateth_tpu_torch/team_schedule.py, which documents the format.",
        "// Do not edit; rerun the generator.",
        "//",
    ]
    for p in s.programs:
        widest = max((len(ins) for m, ins in p.rounds if m), default=0)
        lines.append(
            f"// {p.name}: {len(p.rounds)} rounds, {p.n_product_rounds} of them products "
            f"({p.n_products} Fp products, at most {widest} a round)"
        )
    lines += [
        "",
        "#pragma once",
        "",
        "#include <cstdint>",
        "",
        '#include "team.cuh"',
        "",
        f"namespace kt {{\nnamespace {ns} {{",
        "",
        f"constexpr int kSlots = {s.n_slots};",
        f"constexpr int kTeamThreads = {s.threads};",
        f"constexpr int kPrograms = {len(s.programs)};",
        f"constexpr int kRounds = {len(rounds)};",
        "// the Fp products of each program",
        f"constexpr int kProgramProducts[{len(s.programs)}] = {{"
        + ", ".join(str(p.n_products) for p in s.programs) + "};",
        "// the product rounds of each program",
        f"constexpr int kProgramProductRounds[{len(s.programs)}] = {{"
        + ", ".join(str(p.n_product_rounds) for p in s.programs) + "};",
        "// the programs by name",
        *(f"constexpr int kProg_{p.name} = {i};" for i, p in enumerate(s.programs)),
        "// the named input slots [0, kInputs): constants, the step's state, operands",
        f"constexpr int kInputs = {len(s.slot_of)};",
    ]
    for name, i in s.slot_of.items():
        lines.append(f"constexpr int {_ident(name)} = {i};")
    if s.consts:
        first = s.slot_of[next(iter(s.consts))]
        assert [s.slot_of[n] for n in s.consts] == list(range(first, first + len(s.consts)))
        lines += [
            "",
            "// the named constants' Montgomery limbs: slot kConst0 + k holds kConstLimbs[k]",
            f"constexpr int kConst0 = {first};",
            f"constexpr int kConsts = {len(s.consts)};",
            f"__constant__ uint32_t kConstLimbs[{len(s.consts)}][12] = {{",
        ]
        for name, v in s.consts.items():
            limbs = [f"0x{(v >> (32 * j)) & 0xFFFFFFFF:08x}u" for j in range(12)]
            lines.append(f"    // {name}")
            lines += ["    {" + ", ".join(limbs[:6]) + ",", "     " + ", ".join(limbs[6:]) + "},"]
        lines.append("};")
    lines += [
        "",
        "// program p runs rounds [kProgram[p], kProgram[p + 1])",
        f"__constant__ uint16_t kProgram[{len(prog_rounds)}] = {{"
        + ", ".join(map(str, prog_rounds)) + "};",
        "// round r runs instructions [kRoundStart[r], kRoundStart[r + 1])",
    ]
    lines.append(f"__constant__ uint16_t kRoundStart[{len(starts)}] = {{")
    lines += _wrap([str(v) for v in starts])
    lines.append("};")
    lines.append("// 1: a product round")
    lines.append(f"__constant__ uint8_t kRoundIsMul[{len(rounds)}] = {{")
    lines += _wrap([str(int(m)) for m, _ in rounds])
    lines.append("};")
    lines.append(f"__device__ const uint2 kInstr[{total}] = {{")
    for r, (_, ins) in enumerate(rounds):
        lines.append(f"    // round {r}")
        lines += _wrap([f"KT_INSTR({OP_NAMES[op]}, {d}, {a}, {b})" for op, d, a, b in ins])
    lines += [
        "};",
        "",
        "// what run_program (team.cuh) reads",
        "struct Sched {",
        "  static constexpr int kTeam = kTeamThreads;",
        "  __device__ __forceinline__ static int program(int p) { return kProgram[p]; }",
        "  __device__ __forceinline__ static int round_start(int r) { return kRoundStart[r]; }",
        "  __device__ __forceinline__ static bool round_is_mul(int r) { return kRoundIsMul[r]; }",
        "  __device__ __forceinline__ static uint2 instr(int i) { return __ldg(&kInstr[i]); }",
        "};",
        "",
        f"}}  // namespace {ns}",
        "}  // namespace kt",
        "",
    ]
    return "\n".join(lines)


def _wrap(items: list[str], width: int = 96) -> list[str]:
    out, line = [], "    "
    for it in items:
        piece = it + ","
        if len(line) + len(piece) + 1 > width and line.strip():
            out.append(line.rstrip())
            line = "    "
        line += piece + " "
    if line.strip():
        out.append(line.rstrip())
    return out


HEADERS = {
    "schedule_g1.cuh": g1_schedule,
    "schedule_miller.cuh": miller_schedule,
    "schedule_hard_part.cuh": hard_part_schedule,
    "schedule_comb.cuh": comb_schedule,
    "schedule_prefix.cuh": prefix_schedule,
    "schedule_g2.cuh": g2_schedule,
}


def main() -> None:
    for fname, make in HEADERS.items():
        with open(os.path.join(CSRC, fname), "w") as f:
            f.write(emit(make()))


if __name__ == "__main__":
    main()
