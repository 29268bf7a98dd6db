"""K8, the comb chain sum of the fixed-base comb commit, one launch a
commit of a chunk of B blobs: for each of the ceil(255 / h) columns
(22 at h = 12), every setup point of every blob adds one precomputed
affine table row, 22 x B x N mixed additions.

A mixed addition is 11M with the complete formula for a = 0 (Renes,
Costello and Batina 2016, algorithm 8; EFD shortw/projective
madd-2015-rcb) or 7M + 4S in Jacobian coordinates (EFD
shortw/jacobian-0 madd-2007-bl): 11 Fp products.  Bytes: each addition
reads an affine table row (2 x 48)."""

KERNEL = "comb_chain_sum_kernel"
PRODUCTS_PER_ADDITION = 11


def work(shape: dict) -> dict:
    columns = -(-255 // shape["comb_h"])
    additions = columns * shape["batch"] * shape["n"]
    return {"products": additions * PRODUCTS_PER_ADDITION, "limbs": 12,
            "bytes": additions * 2 * 48}
