"""Batched quartic roots by Durand-Kerner iteration in complex64
(counterpart of slam3d_gx_tpu/ops/polynomial.py).

Used by the P3P minimal solver. Durand-Kerner is branch-free
simultaneous iteration, so it batches over large hypothesis sets where
closed forms (Ferrari) need case analysis. The 24 steps are a plain
Python loop.
"""

from __future__ import annotations

import torch


def _int_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x**n by binary exponentiation (lax.integer_pow's multiplication
    order, so complex powers round as in the reference)."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n:
            x = x * x
    return acc


def quartic_roots(coeffs: torch.Tensor, iters: int = 24) -> torch.Tensor:
    """Roots of c4 x^4 + c3 x^3 + c2 x^2 + c1 x + c0.

    Args:
      coeffs: (...,5) real, ordered [c4, c3, c2, c1, c0].
    Returns:
      (...,4) complex64 roots. A tiny leading coefficient is regularized
      (callers gate on residual checks anyway).
    """
    c4 = coeffs[..., 0]
    c4 = torch.where(torch.abs(c4) > 1e-12, c4, 1e-12)
    p = [(coeffs[..., k] / c4).to(torch.complex64) for k in range(1, 5)]

    # scale roots to O(1): x = s*y with s from the coefficient magnitudes
    s = torch.clamp(
        torch.maximum(
            torch.maximum(torch.abs(p[0]), torch.abs(p[1]) ** 0.5),
            torch.maximum(torch.abs(p[2]) ** (1.0 / 3.0), torch.abs(p[3]) ** 0.25),
        ),
        min=1e-6,
    ).to(torch.complex64)
    q = [p[0] / s, p[1] / _int_pow(s, 2), p[2] / _int_pow(s, 3), p[3] / _int_pow(s, 4)]

    def poly(y):
        return (((y + q[0]) * y + q[1]) * y + q[2]) * y + q[3]

    # standard DK initialization (0.4+0.9i)^k
    # made by a fill on the device: a tensor built from host data would be a
    # copy that waits for the stream
    base = torch.full((), 0.4 + 0.9j, dtype=torch.complex64, device=coeffs.device)
    z = [_int_pow(base, k + 1).expand(q[0].shape) for k in range(4)]
    for _ in range(iters):
        z0, z1, z2, z3 = z
        z = [
            z0 - poly(z0) / ((z0 - z1) * (z0 - z2) * (z0 - z3)),
            z1 - poly(z1) / ((z1 - z0) * (z1 - z2) * (z1 - z3)),
            z2 - poly(z2) / ((z2 - z0) * (z2 - z1) * (z2 - z3)),
            z3 - poly(z3) / ((z3 - z0) * (z3 - z1) * (z3 - z2)),
        ]
    return torch.stack(z, dim=-1) * s[..., None]


def real_roots_mask(roots: torch.Tensor, rel_tol: float = 1e-3) -> torch.Tensor:
    """Boolean mask of (approximately) real roots."""
    return torch.abs(roots.imag) <= rel_tol * (1.0 + torch.abs(roots.real))
