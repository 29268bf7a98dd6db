"""K7, the chain prefix sums of the windowed Pippenger commit (comb_h = 0),
one launch a window: every setup point of every blob of the chunk is
added once into its bucket's running sum, B x N additions a window.

An addition of an affine setup point to a projective sum is a mixed
addition: 11M with the complete formula for a = 0 (Renes, Costello and
Batina 2016, algorithm 8; EFD shortw/projective madd-2015-rcb) or 7M + 4S
in Jacobian coordinates (EFD shortw/jacobian-0 madd-2007-bl): 11 Fp
products.  Bytes: each addition reads an affine point (2 x 48)."""

KERNEL = "chain_prefix_kernel"
PRODUCTS_PER_ADDITION = 11


def work(shape: dict) -> dict:
    additions = shape["batch"] * shape["n"]
    return {"products": additions * PRODUCTS_PER_ADDITION, "limbs": 12,
            "bytes": additions * 2 * 48}
