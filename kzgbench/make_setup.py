#!/usr/bin/env python3
"""Write the benchmark's trusted setup: the mainnet shape and JSON format
(4096 G1 Lagrange points in natural order, 65 G2 monomial points, each
compressed, 0x-prefixed hex), made from the known tau of
kzgbench/reference/kzg.py, so that the plain reference needs no MSM and
no pairing.  The library under test loads it as it loads the ceremony's.

  python3 kzgbench/make_setup.py [--out kzgbench/data/setup_known_tau_4096.json]

The committed file is the one this writes (kzgbench/tests checks it)."""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kzgbench.reference import g1, g2  # noqa: E402
from kzgbench.reference.fields import R, bit_reversal_permutation  # noqa: E402
from kzgbench.reference.kzg import TAU, Domain  # noqa: E402

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                           "setup_known_tau_4096.json")
G2_POINTS = 65


def setup_json(tau: int = TAU, n: int = 4096, g2_len: int = G2_POINTS) -> dict:
    # Domain's roots are bit-reversed; the file holds L_j(tau) G1 for the
    # basis of w^j in natural order, as the spec's KZG_SETUP_G1_LAGRANGE
    lagrange = bit_reversal_permutation(Domain(n).lagrange_at(tau))
    g1_hex = ["0x" + b.hex() for b in g1.FixedBase().compress_many(lagrange)]
    g2_hex = ["0x" + g2.compress(g2.mul(g2.GEN, pow(tau, j, R))).hex() for j in range(g2_len)]
    return {"g1_lagrange": g1_hex, "g2_monomial": g2_hex}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()
    with open(args.out, "w") as f:
        json.dump(setup_json(), f, indent=2)
        f.write("\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
