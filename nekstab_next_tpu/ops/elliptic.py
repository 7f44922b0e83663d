"""Assembled SPD elliptic solves with exact transposability.

The assembled operator of a naive masked direct-stiffness form,
``mask . dssum . K_local``, is self-adjoint only in a multiplicity-weighted
product — good enough for CG, but ``lax.custom_linear_solve(symmetric=True)``
(which gives us exact jvp/transpose of every inner solve, and hence the exact
discrete adjoint of the whole time step) requires *Euclidean* symmetry.

We get it by conjugating with the Euclid-orthogonal projector onto the
continuous-and-unmasked subspace:

    P = mask . dsavg . mask        (dsavg = Q diag(1/mult) Q^T is symmetric)
    A = P K_local P + (I - P)

``A`` is Euclid-SPD, and on ``range(P)`` the system ``A x = P r_local`` is
exactly the assembled Galerkin system (the diagonal scaling introduced by the
averaging cancels between both sides).  This is the equivalent of Nek5000's
masked Helmholtz solves with ``vmult``-weighted CG dots."""

from __future__ import annotations

from typing import Callable, Optional

import jax.numpy as jnp

from .cg import cg_solve


def make_projector(sem, mask: jnp.ndarray) -> Callable:
    def P(x):
        return mask * sem.dsavg(mask * x)

    return P


def elliptic_solve(
    sem,
    local_op: Callable,
    rhs_local: jnp.ndarray,
    mask: jnp.ndarray,
    tol: float,
    maxiter: int,
    diag_local: Optional[jnp.ndarray] = None,
    project_mean: bool = False,
    fdm: Optional[tuple] = None,
    coarse: bool = False,
    lanes: Optional[tuple] = None,
    vblocks: Optional[jnp.ndarray] = None,
    fixed_iters: bool = False,
    inner_solve=None,
    ir_cycles: int = 0,
):
    """Solve the assembled system  (P local_op P) x = P rhs_local  by PCG
    under ``lax.custom_linear_solve`` (symmetric, hence exactly transposable).

    ``local_op``   : unassembled element-local SPD weak operator
    ``rhs_local``  : unassembled local weak RHS (will be P-projected)
    ``mask``       : 1 = free dof, 0 = Dirichlet (may carry component axes)
    ``diag_local`` : local diagonal of ``local_op`` for Jacobi preconditioning
    ``project_mean``: remove the constant nullspace (pure-Neumann Poisson)
    ``fdm``        : (h1, h2) Helmholtz coefficients — use the tensor-product
                     fast-diagonalization block preconditioner (ops/fdm.py)
                     instead of Jacobi (additive Schwarz wrapped in P)
    ``lanes``      : optional lanes-layout bundle (ops/lanes.py
                     ``velocity_bundle``) — the CG iteration runs in the
                     ``(n^2, ndim*nelem)`` layout (see cg_solve)
    ``inner_solve``: approximate subspace solve for iterative refinement
                     (``ir_cycles`` cycles; see cg_solve)
    """
    P = make_projector(sem, mask)

    def A(x):
        Px = P(x)
        return P(local_op(Px)) + (x - Px)

    rhs = P(rhs_local)

    dot = lambda a, b: sem._reduce(jnp.sum(a * b))

    # ---- fast subspace path for the CG iteration ------------------------
    # All Krylov iterates live in range(P) (continuous, masked fields), where
    # P x = x — so the inner apply needs ONE gather-scatter (the assembly
    # after the local operator) instead of the four that the fully projected
    # forms above spend.  cg_solve keeps ``A`` as the differentiation anchor
    # and handles RHS components outside range(P) (transpose cotangents)
    # explicitly.
    def A_sub(x):
        return P(local_op(x))

    if vblocks is not None:
        # exact element-block inverse of the assembled operator
        # (ops/schwarz.py build_velocity_blocks): one batched matmul per
        # component, no gather/scatter
        from .schwarz import velocity_block_apply

        def M_sub(r):
            return P(velocity_block_apply(vblocks, r))

    elif fdm is not None:
        h1, h2 = fdm

        def M_sub(r):
            z = sem.fdm_apply(r, h1, h2)
            if coarse:
                z = z + sem.coarse_apply_pressure(r)
            return P(z)

    elif diag_local is not None:
        dinv = 1.0 / sem.dssum(diag_local)
        if dinv.ndim < rhs.ndim:
            dinv = dinv.reshape(dinv.shape + (1,) * (rhs.ndim - dinv.ndim))

        def M_sub(r):
            return P(dinv * r)

    else:
        M_sub = None

    project = None
    if project_mean:
        ones = jnp.ones_like(rhs)
        csq = dot(ones, ones)

        def project(q):
            return q - (dot(q, ones) / csq) * ones

    return cg_solve(
        A, rhs, tol=tol, maxiter=maxiter, dot=dot, project=project,
        inner_op=(A_sub, P, M_sub), lanes=lanes, fixed_iters=fixed_iters,
        inner_solve=inner_solve, ir_cycles=ir_cycles,
    )
