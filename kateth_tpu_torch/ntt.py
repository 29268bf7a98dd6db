"""Number-theoretic transform over Fr digit planes: the monomial <->
Lagrange (blob) form conversion.

A radix-2 decimation-in-time transform on bit-reversed input: log2 n
stages, each one batched Montgomery multiply (kernel K1 on a CUDA tensor)
of the odd halves by the stage's twiddles over n/2 lanes a row, then one
modular addition and one subtraction.  The twiddles are Montgomery tables,
one per stage, made once per (n, direction, device).  A blob lists its
evaluations over the bit-reversed roots, which is exactly the input order
the transform wants, so the conversion to coefficients permutes nothing.

The roots are those of the setup: w = 7^((r-1)/n) (host.roots_of_unity).
A 1-point transform is the identity (its inverse scales by 1^-1 = 1).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import host
from .fields import limbs as L
from .fields.specs import FR


@functools.cache
def root_powers(n: int) -> np.ndarray:
    """(n, 16) Montgomery digits of w^k, k < n, for the n-th root w."""
    return np.stack([FR.from_int(v) for v in host.roots_of_unity(n)])


@functools.cache
def _stage_twiddles_host(n: int, inverse: bool) -> tuple[np.ndarray, ...]:
    """Per-stage twiddles: stage s (block size m = 2^s) uses w_m^j, j < m/2,
    with w_m = w^(n/m), as a (m/2, 16) table; the inverse transform uses
    w^-1, so w^-k = w^(n - k)."""
    powers = root_powers(n)
    out = []
    m = 2
    while m <= n:
        k = np.arange(m // 2) * (n // m)
        out.append(powers[(n - k) % n if inverse else k])
        m *= 2
    return tuple(out)


@functools.cache
def _stage_twiddles(n: int, inverse: bool, device: str) -> tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(t).to(device) for t in _stage_twiddles_host(n, inverse))


@functools.cache
def _brp(n: int, device: str) -> torch.Tensor:
    return torch.as_tensor(host.brp_indices(n)).to(device)


@functools.cache
def _n_inv_mont(n: int, device: str) -> torch.Tensor:
    return torch.as_tensor(FR.from_int(pow(n, host.R - 2, host.R))).to(device)


def _ntt_stages(x: torch.Tensor, n: int, inverse: bool) -> torch.Tensor:
    batch = x.shape[:-2]
    for s, tw in enumerate(_stage_twiddles(n, inverse, str(x.device)), start=1):
        m = 1 << s
        xr = x.reshape(*batch, n // m, 2, m // 2, FR.n_digits)
        u = xr[..., 0, :, :]
        v = L.mont_mul(FR, xr[..., 1, :, :], tw)
        # the lo half of each block, then the hi half: DIT on bit-reversed input
        x = torch.stack([L.add(FR, u, v), L.sub(FR, u, v)], dim=-3).reshape(*batch, n, FR.n_digits)
    return x


def ntt_mont(x_mont: torch.Tensor, inverse: bool = False, bitrev_input: bool = False,
             bitrev_output: bool = False, axis: int = -2) -> torch.Tensor:
    """Radix-2 DIT transform along `axis` (default -2) of Montgomery Fr
    digit planes (..., n, ..., 16), n a power of two.

    The transform reads bit-reversed input and writes natural order; the
    flags say which order the caller's data is in and wants, so data that
    already lives in bit-reversed order is never permuted."""
    if axis % x_mont.ndim != x_mont.ndim - 2:
        out = ntt_mont(x_mont.movedim(axis, -2), inverse, bitrev_input, bitrev_output)
        return out.movedim(-2, axis)
    n = x_mont.shape[-2]
    if n < 1 or n & (n - 1):
        raise ValueError(f"the transform length must be a power of two, not {n}")
    dev = str(x_mont.device)
    x = x_mont if bitrev_input else x_mont[..., _brp(n, dev), :]
    x = _ntt_stages(x, n, inverse)
    if bitrev_output:
        x = x[..., _brp(n, dev), :]
    if inverse:
        x = L.mont_mul(FR, x, _n_inv_mont(n, dev))
    return x


def lagrange_brp_to_monomial(evals_brp_mont: torch.Tensor) -> torch.Tensor:
    """Blob layout (evaluations over the bit-reversed roots) -> monomial
    coefficients, ascending degree; Montgomery in and out."""
    return ntt_mont(evals_brp_mont, inverse=True, bitrev_input=True)


def monomial_to_lagrange_brp(coeffs_mont: torch.Tensor) -> torch.Tensor:
    """Monomial coefficients -> evaluations in bit-reversed (blob) order."""
    return ntt_mont(coeffs_mont, bitrev_output=True)
