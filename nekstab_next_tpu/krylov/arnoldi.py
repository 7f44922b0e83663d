"""Arnoldi factorization with classical Gram-Schmidt + full re-orthogonalization.

Rebuild of the reference's ``arnoldi_factorization`` / ``update_hessenberg_matrix``
(core/krylov_decomposition.f90:2-189): CGS orthogonalization followed by one
full re-orthogonalization pass (the reference notes plain CGS is unstable,
krylov_decomposition.f90:170).  Classical (not modified) GS is chosen
deliberately: all k dot products batch into one reduction — one fused psum
instead of k sequential ones.

The orthogonalization is a single jitted function over the *preallocated*
basis with masked columns, so one compiled executable serves every iteration
(no per-k recompilation)."""

from __future__ import annotations

from functools import partial
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .vector import Basis, VectorSpace


def orthogonalize(space: VectorSpace, basis: Basis, w, ncols: int, reorth: int = 1):
    """CGS + ``reorth`` re-orthogonalization passes of ``w`` against the first
    ``ncols`` basis columns.  Returns (w_orth, h) with h the accumulated
    projection coefficients (length = capacity, zero beyond ncols)."""
    h = basis.dots(w, ncols)
    w = space.sub(w, basis.combine(h))
    for _ in range(reorth):
        c = basis.dots(w, ncols)
        w = space.sub(w, basis.combine(c))
        h = h + c
    return w, h


def arnoldi_step(
    matvec: Callable,
    space: VectorSpace,
    basis: Basis,
    H: np.ndarray,
    j: int,
    breakdown_tol: float = 1e-12,
) -> float:
    """Extend an Arnoldi factorization by one column: w = A q_j, orthogonalize
    against q_0..q_j, normalize into q_{j+1}.  Updates H[:, j] in place
    (host-side numpy, mirroring the reference's replicated Hessenberg —
    SURVEY.md section 2.3 item 2).  Returns the residual norm H[j+1, j]."""
    w = matvec(basis.get(j))
    # fused orthogonalize + normalize + column insert: one device launch
    # (Basis.ortho_insert); the garbage column written on breakdown
    # (beta ~ 0) is never read — callers stop at breakdown_tol
    h, beta = basis.ortho_insert(w, j)
    beta = float(beta)
    H[: basis.capacity, j] = np.asarray(h)
    H[j + 1, j] = beta
    del breakdown_tol
    return beta


def arnoldi_factorization(
    matvec: Callable,
    space: VectorSpace,
    basis: Basis,
    H: np.ndarray,
    j_start: int,
    j_end: int,
    callback: Callable = None,
) -> np.ndarray:
    """Run Arnoldi steps j_start..j_end-1 (the reference's k-step loop,
    krylov_decomposition.f90:68-96).  ``basis`` must hold an orthonormal
    q_0..q_{j_start} set already."""
    for j in range(j_start, j_end):
        beta = arnoldi_step(matvec, space, basis, H, j)
        if callback is not None:
            callback(j, beta)
        if beta <= 1e-12:
            break  # invariant subspace found
    return H
