"""K6, the G2 ladder, in a single-point verification: z (-G2), one lane of
256 steps over Fp2.

A step is a doubling and an addition with the complete projective
formulas for a = 0 (Renes, Costello and Batina 2016, algorithms 7 and 9;
EFD shortw/projective add-2015-rcb and dbl-2015-rcb): 12M and 6M + 2S
over Fp2.  An Fp2 product is 3 Fp products (Karatsuba), a square 2
(complex squaring): 36 + 18 + 4 = 58 Fp products a step.  Bytes: a
projective G2 point read (3 x 96) and written, and the scalar (32)."""

KERNEL = "g2_ladder_kernel"
STEPS = 256
PRODUCTS_PER_STEP = 12 * 3 + 6 * 3 + 2 * 2


def work(shape: dict) -> dict:
    lanes = shape["batch"]
    return {"products": lanes * STEPS * PRODUCTS_PER_STEP, "limbs": 12,
            "bytes": lanes * (3 * 96 + 32 + 3 * 96)}
