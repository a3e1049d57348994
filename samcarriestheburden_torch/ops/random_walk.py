"""Seeded random-walker segmentation (JAX ``ops/random_walk.py``, reference
utils/random_walk.py + utils/seg_refinement.py:119-203).

The reference assembles a sparse graph Laplacian with exp(-dI^2/sigma^2) edge
weights and solves the seeded/unseeded split with pyamg on the host.  The
Laplacian of an image grid is a 5-point stencil, so, as in the JAX package,
the system is solved on the tensors' device with Jacobi-preconditioned
conjugate gradients, every iteration one stencil application, all classes
at once.

System (reference laplace_matrix, seg_refinement.py:175-203):
  L = diag(1e-5 + lam * D) - lam * A,  A = 4-neighbour adjacency with
  w_ij = exp(-(I_i - I_j)^2 / sigma^2),  D = sum_j A_ij.
Split into seeded (Dirichlet) and unseeded nodes: L_u u_u = -B^T u_s, applied
on the full grid through the unseeded mask M:
  matvec(x) = M * L(M * x),  rhs = -(M * L(S * u_s)).

:func:`conjugate_gradient` is JAX's ``jax.scipy.sparse.linalg.cg`` step for
step (``_cg_solve``) over a batch of K systems: x0 = 0, stop when
<r, r> <= max(tol^2 <b, b>, 0) (the unpreconditioned residual, since M is
given) or after ``maxiter`` steps, each system frozen at its own stopping
step as a batched ``while_loop`` freezes it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from samcarriestheburden_torch.ops.morphology import erode_mask_with_disc_struct

#: CG iterations between two reads of the all-converged flag: the loop syncs
#: with the host once per this many steps, never per step.  Frozen systems do
#: not move, so the result does not depend on it.
CHECK_EVERY = 16


def edge_weights(img: torch.Tensor, sigma: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Horizontal (H, W-1) and vertical (H-1, W) edge weights of an (H, W) image."""
    img = torch.as_tensor(img).float()
    # a true division on every device: the card computes a division by a
    # host scalar as a product with its reciprocal
    s2 = torch.full((), sigma ** 2, dtype=torch.float32, device=img.device)
    wh = torch.exp(-((img[:, 1:] - img[:, :-1]) ** 2) / s2)
    wv = torch.exp(-((img[1:, :] - img[:-1, :]) ** 2) / s2)
    return wh, wv


def _degree(wh: torch.Tensor, wv: torch.Tensor) -> torch.Tensor:
    """D of the stencil, summed right, left, down, up (JAX's order)."""
    deg = wh.new_zeros((wh.shape[0], wv.shape[1]))
    deg[:, 1:] += wh
    deg[:, :-1] += wh
    deg[1:, :] += wv
    deg[:-1, :] += wv
    return deg


def _stencil(x: torch.Tensor, wh: torch.Tensor, wv: torch.Tensor, diag: torch.Tensor,
             lam: float) -> torch.Tensor:
    """``diag * x - lam * A x`` over the last two axes of (..., H, W) ``x``."""
    ax = torch.zeros_like(x)
    ax[..., :, 1:] += wh * x[..., :, :-1]
    ax[..., :, :-1] += wh * x[..., :, 1:]
    ax[..., 1:, :] += wv * x[..., :-1, :]
    ax[..., :-1, :] += wv * x[..., 1:, :]
    return diag * x - lam * ax


def apply_laplacian(x: torch.Tensor, wh: torch.Tensor, wv: torch.Tensor,
                    lam: float = 1.0, eps: float = 1e-5) -> torch.Tensor:
    """y = (diag(eps + lam * D) - lam * A) x for (..., H, W) x: one stencil."""
    return _stencil(x, wh, wv, eps + lam * _degree(wh, wv), lam)


def _vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a_k, b_k> of each (H, W) system of (K, H, W) tensors -> (K,)."""
    return (a * b).sum(dim=(-2, -1))


def conjugate_gradient(matvec, b: torch.Tensor, precondition, *, tol: float, maxiter: int,
                       check_every: int = CHECK_EVERY) -> Tuple[torch.Tensor, torch.Tensor]:
    """Preconditioned CG over the K systems of (K, H, W) ``b`` -> (x, the
    iterations each system ran (K,) int64).  JAX ``_cg_solve``: a system
    runs while <r, r> > tol^2 <b, b> and its count is below ``maxiter``; a
    stopped system keeps its state (``torch.where``, so a 0/0 of a system
    whose ``b`` is zero never reaches its values)."""
    x = torch.zeros_like(b)
    r = b.clone()                       # b - A(x0), x0 = 0
    z = precondition(r)
    p = z
    gamma = _vdot(r, z)
    atol2 = torch.clamp(torch.tensor(tol, dtype=torch.float32).square() * _vdot(b, b), min=0.0)
    k = torch.zeros(b.shape[0], dtype=torch.int64, device=b.device)

    for step in range(maxiter):
        active = (_vdot(r, r) > atol2) & (k < maxiter)
        if step % check_every == 0 and not bool(active.any()):
            break
        ap = matvec(p)
        alpha = gamma / _vdot(p, ap)
        x_ = x + alpha[:, None, None] * p
        r_ = r - alpha[:, None, None] * ap
        z_ = precondition(r_)
        gamma_ = _vdot(r_, z_)
        beta = gamma_ / gamma
        p_ = z_ + beta[:, None, None] * p
        on = active[:, None, None]
        x, r, p = torch.where(on, x_, x), torch.where(on, r_, r), torch.where(on, p_, p)
        gamma = torch.where(active, gamma_, gamma)
        k = k + active.long()
    return x, k


def solve_seeded(img: torch.Tensor, initial_segmentation: torch.Tensor, *, sigma: float = 10.0,
                 lam: float = 1.0, tol: float = 1e-3, maxiter: int = 600,
                 check_every: int = CHECK_EVERY) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`random_walk_probs` and the CG iterations of each class (K,)."""
    seg = torch.as_tensor(initial_segmentation)
    img = torch.as_tensor(img).to(seg.device).float()
    seeds = seg.float()
    seeded = seg.bool().any(dim=0)
    m = (~seeded).float()
    wh, wv = edge_weights(img, sigma)
    diag = 1e-5 + lam * _degree(wh, wv)

    def matvec(x):
        return m * _stencil(m * x, wh, wv, diag, lam)

    def precondition(r):               # Jacobi: the inverse diagonal on unseeded nodes
        return m * r / diag

    b = -(m * _stencil(seeds * seeded, wh, wv, diag, lam))
    u_u, iters = conjugate_gradient(matvec, b, precondition, tol=tol, maxiter=maxiter,
                                    check_every=check_every)
    return torch.where(seeded[None], seeds, u_u), iters


def random_walk_probs(img: torch.Tensor, initial_segmentation: torch.Tensor, *,
                      sigma: float = 10.0, lam: float = 1.0, tol: float = 1e-3,
                      maxiter: int = 600) -> torch.Tensor:
    """Solve the seeded random walk for (K, H, W) seed maps on their device.

    ``initial_segmentation`` marks seeds (a pixel nonzero in any class is
    seeded, each class with its own value there).  Returns (K, H, W) fp32
    probabilities, seeded pixels at their seed values (reference
    random_walk.py:112-126)."""
    return solve_seeded(img, initial_segmentation, sigma=sigma, lam=lam, tol=tol,
                        maxiter=maxiter)[0]


def random_walk(img: torch.Tensor, initial_segmentation: torch.Tensor, *,
                background_erosion_radius: int = 12, sigma: float = 10.0, lam: float = 1.0,
                tol: float = 1e-3, maxiter: int = 600) -> torch.Tensor:
    """Reference ``random_walk`` (utils/random_walk.py:90-126): add an eroded
    background class, solve, drop the background.  img: (H, W) uint8;
    initial_segmentation: (C, H, W) bool.  Returns (C, H, W) probabilities
    on ``initial_segmentation``'s device."""
    img = torch.as_tensor(img)
    if img.ndim != 2:
        raise ValueError("img should be 2D")
    seg = torch.as_tensor(initial_segmentation).bool()
    background = ~seg.any(dim=0)
    if background_erosion_radius > 1:
        background = erode_mask_with_disc_struct(background[None],
                                                 radius=background_erosion_radius)[0]
    full = torch.cat([background[None], seg], dim=0)
    return random_walk_probs(img, full, sigma=sigma, lam=lam, tol=tol, maxiter=maxiter)[1:]
