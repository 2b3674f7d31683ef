"""Kernel functions for kernel-based sampling (paper §3.1, §3.3) —
``repro.core.kernel_fns``: the quadratic and quartic kernels, Gram-sum
statistics, and the positive random features of the rff family.  The
reference's self-contained ``rff_kernel`` (used by its ``rff-oracle``)
arrives with that family.

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


# --- positive random Fourier features for the exp kernel (DESIGN.md §2.7) ----
#
# Rawat et al. 2019: with Gaussian directions omega ~ N(0, I_d), the feature
#
#   phi_k(x) = D^{-1/2} exp( <omega_k, x>/sqrt(tau) - |x|^2/(2 tau) )     (*)
#
# is NON-NEGATIVE and E[<phi(a), phi(b)>] = exp(<a,b>/tau), so feature sums
# z(C) = sum_j phi(w_j) are valid sampling statistics.  Everything works in
# the log domain and exponentiates after a shift (the per-query max on the h
# side, a build-time bound on the w side); shifts scale every mass of a
# level alike and cancel in the sampling probabilities.


def rff_directions(gen: torch.Generator, dim: int, d: int) -> Tensor:
    """Gaussian feature directions omega: (D, d), omega_k ~ N(0, I_d), on
    the generator's device."""
    return torch.randn((dim, d), generator=gen, device=gen.device)


def rff_log_phi(x: Tensor, omega: Tensor, tau: float) -> Tensor:
    """log of the UNNORMALIZED positive features (*) (no D^{-1/2}, no
    shift).  x: (..., d); omega: (D, d) -> (..., D) fp32."""
    x32 = x.float()
    proj = torch.einsum("...d,kd->...k", x32, omega.float()) / math.sqrt(tau)
    nrm = torch.sum(x32 * x32, dim=-1, keepdim=True) / (2.0 * tau)
    return proj - nrm


def rff_logshift_bound(w: Tensor, omega: Tensor, tau: float) -> Tensor:
    """Cheap analytic upper bound on the max log-feature over rows of w:

        max_{i,k} log phi <= max_i ( g |w_i| / sqrt(tau) - |w_i|^2 / (2 tau) )

    with g = max_k |omega_k|; O(n d + D d), no (n, D) product.  Features
    built as exp(log phi - shift) stay <= 1.  Returns a 0-dim fp32 tensor
    on w's device (never read on the host); an all-padding table gives 0."""
    w32 = w.float()
    g = torch.sqrt(torch.max(torch.sum(omega.float() ** 2, dim=-1)))
    nrm = torch.sqrt(torch.sum(w32 * w32, dim=-1))
    per_row = g * nrm / math.sqrt(tau) - nrm * nrm / (2.0 * tau)
    return torch.clamp(torch.max(per_row), min=0.0)


def rff_phi(x: Tensor, omega: Tensor, tau: float,
            logshift: Tensor | float = 0.0) -> Tensor:
    """The positive feature map (*), shifted by ``logshift`` in the log
    domain.  x: (..., d) -> (..., D) fp32 non-negative features."""
    lphi = rff_log_phi(x, omega, tau) - logshift
    return torch.exp(lphi) / math.sqrt(omega.shape[0])
