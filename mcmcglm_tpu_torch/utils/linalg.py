"""Small linear-algebra helpers.

``matvec`` computes eta0 = beta0 @ Xt, the ONLY full matrix product the
CGGibbs engines run: eta is maintained incrementally in float32 from then
on, so any error in the initial product stays with the chain for its
whole life (an intercept column turns a rounded beta0[0] into a constant
per-chain eta offset).  On a CUDA card a float32 product may run in TF32
(about three decimal digits) whenever ``torch.backends.cuda.matmul.
allow_tf32`` is set, so the product is taken in float64 and rounded to the
working dtype once, whatever the matmul precision setting says.
"""

from __future__ import annotations

import torch

__all__ = ["matvec"]


def matvec(beta: torch.Tensor, Xt: torch.Tensor) -> torch.Tensor:
    """eta = beta @ Xt for beta (..., d) and Xt (d, n) -> (..., n), in
    float64 and rounded once to ``beta``'s dtype."""
    return torch.matmul(beta.double(), Xt.double()).to(beta.dtype)
