"""K3, the G1 ladder, in a batch verification: the work its algorithm
needs for a batch of B blobs (the blobs given, not the library's
padding of the batch to its canonical size).

The batch needs 5B + 1 scalar multiplications of G1 points by scalars of
up to 255 bits, each a double-and-add ladder of 256 steps: the random
linear combinations of the proofs, the commitments and the proofs by
z w (3B), the sum of w y times -G1 (1), and the subgroup checks [r] P of
every commitment and proof (2B).

A step is a doubling and an addition with the complete projective
formulas for a = 0 (Renes, Costello and Batina 2016, algorithms 7 and 9;
EFD shortw/projective add-2015-rcb and dbl-2015-rcb): 12M and 6M + 2S,
20 Fp products; the multiplications by 3b are left out.  Bytes: each
lane reads a projective point (3 x 48) and a scalar (32), and writes a
projective point."""

KERNEL = "g1_ladder_kernel"
STEPS = 256
PRODUCTS_PER_STEP = 12 + 6 + 2


def work(shape: dict) -> dict:
    lanes = 5 * shape["batch"] + 1
    return {"products": lanes * STEPS * PRODUCTS_PER_STEP, "limbs": 12,
            "bytes": lanes * (3 * 48 + 32 + 3 * 48)}
