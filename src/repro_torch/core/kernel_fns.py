"""Kernel functions for kernel-based sampling (paper §3.1, §3.3) —
``repro.core.kernel_fns`` without the rff functions (they arrive with the
rff slice).

A sampling kernel is a non-negative function ``K(h, w) = f(<h, w>)`` with a
feature map ``phi`` such that ``K(a, b) = <phi(a), phi(b)>``.  For the
quadratic kernel ``K = alpha*<h,w>^2 + 1`` the summary statistic of a class
set C is the Gram-sum matrix ``Z_C = sum_{j in C} w_j w_j^T`` plus the count
``|C|``:

    <phi(h), z(C)> = alpha * h^T Z_C h + |C|
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SamplingKernel:
    """A kernel of the form K(a, b) = f(<a, b>), f >= 0.

    Attributes:
      name: identifier used in configs / logs.
      of_dot: f, applied to raw dot products.  Must be non-negative.
      degree: polynomial degree of f (2 for quadratic, 4 for quartic): Gram
        statistics are exact only for degree 2, and only degree-2 kernels
        route through the CUDA scoring kernels.
      alpha: scale inside f (kept for reporting; already baked into of_dot).
      feature_dim, tau, phi_fn: random-feature kernels (the rff slice).
    """

    name: str
    of_dot: Callable[[Tensor], Tensor]
    degree: int
    alpha: float
    feature_dim: int | None = None
    tau: float = 1.0
    phi_fn: Callable[[Tensor], Tensor] | None = None

    def pair_scores(self, h: Tensor, w: Tensor) -> Tensor:
        """K(h, w_j) for h: (..., d) against w: (n, d) -> (..., n)."""
        return self.of_dot(torch.einsum("...d,nd->...n", h, w))

    def phi(self, a: Tensor) -> Tensor:
        """Explicit feature map (test-scale only for degree-2: D = d^2+1)."""
        if self.phi_fn is not None:
            return self.phi_fn(a)
        if self.degree == 2:
            outer = torch.einsum("...i,...j->...ij", a, a)
            flat = outer.reshape(*a.shape[:-1], -1)
            return torch.cat(
                [math.sqrt(self.alpha) * flat,
                 torch.ones((*a.shape[:-1], 1), dtype=a.dtype,
                            device=a.device)], dim=-1)
        raise NotImplementedError(
            f"explicit phi only provided for degree-2 kernels, not {self.name}")


def quadratic_kernel(alpha: float = 100.0) -> SamplingKernel:
    """The paper's suggested kernel: K = alpha * t^2 + 1  (§3.3, §4.1.2)."""
    return SamplingKernel(
        name=f"quadratic(alpha={alpha:g})",
        of_dot=lambda t: alpha * torch.square(t) + 1.0,
        degree=2,
        alpha=alpha,
    )


def quartic_kernel(alpha: float = 1.0) -> SamplingKernel:
    """4th-degree polynomial kernel q_i ∝ alpha * t^4 + 1 (paper Fig. 2)."""
    return SamplingKernel(
        name=f"quartic(alpha={alpha:g})",
        of_dot=lambda t: alpha * torch.square(torch.square(t)) + 1.0,
        degree=4,
        alpha=alpha,
    )


# --- Gram-sum summary statistics (quadratic kernel) -------------------------


def gram_stats(w: Tensor) -> tuple[Tensor, Tensor]:
    """Summary statistics of a class set: (Z = sum w w^T, count).

    w: (B, d) block of class embeddings (zero rows = padding; the caller
    supplies the true count when padding is present).
    Returns Z: (d, d) fp32 and the row count as a 0-dim fp32 tensor."""
    w32 = w.float()
    return (torch.einsum("bi,bj->ij", w32, w32),
            torch.tensor(float(w.shape[0]), device=w.device))


def gram_set_mass(kernel: SamplingKernel, z: Tensor, cnt: Tensor,
                  h: Tensor) -> Tensor:
    """<phi(h), z(C)> = alpha * h^T Z h + |C| for the quadratic kernel.

    z: (..., d, d), cnt: (...,), h: (d,) -> (...,) total kernel mass."""
    assert kernel.degree == 2, "Gram stats are exact only for quadratic kernels"
    h32 = h.float()
    quad = torch.einsum("...ij,i,j->...", z, h32, h32)
    return kernel.alpha * quad + cnt


def gram_set_mass_batch(kernel: SamplingKernel, z: Tensor, cnt: Tensor,
                        hh: Tensor, total) -> Tensor:
    """Batch-summed set mass: sum_p <phi(h_p), z(C)> = alpha*<Z, H>_F + T*|C|.

    hh: (d, d) = sum_p h_p h_p^T (the context Gram), total: number of
    contexts T."""
    assert kernel.degree == 2
    frob = torch.einsum("...ij,ij->...", z, hh)
    return kernel.alpha * frob + total * cnt
