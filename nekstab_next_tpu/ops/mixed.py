"""Mixed-precision elliptic solves on the GLL-grid scheme: f32 inner CG + f64
iterative refinement.

The reference's 1e-8..1e-10 solver tolerances (examples/cylinder/1cyl.par:8,18)
demand f64 *accuracy*, not f64 *arithmetic*: classical iterative refinement
gets there with almost all FLOPs in f32 —

    repeat:  r  = b - A x            (f64, exact residual)
             dx = CG_f32(A32, r)     (cheap inner solve)
             x  = x + dx             (f64 accumulate)

Each refinement cycle multiplies the error by the inner solve's relative
accuracy (~1e-5..1e-6), so 2-3 cycles reach 1e-10.  The inner operator is the
same assembled projected operator that ``ops/elliptic.py`` builds, applied on
an f32 copy of the SEM (``SEM.astype``) with the FDM/coarse preconditioners.

This is the legacy route of ``NavierStokes(..., mixed_precision=True)``: it
serves sharded runs and the non-PnPn-2 pressure schemes; single-device PnPn-2
runs refine around f32 solves of the full scheme instead
(stepper/navier_stokes.py).  Under ``lax.custom_linear_solve`` the refined
solve is still exactly transposable, so the linearized/adjoint propagators
keep their exact discrete-adjoint property.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from .cg import pcg
from .elliptic import make_projector

_f32 = jnp.float32
_f64 = jnp.float64


class MixedPrecision:
    """f32 solve context for one SEM: an f32 copy of its operators and of
    the FDM and Q1-coarse preconditioner constants."""

    def __init__(self, sem, inner_tol: float = 3e-6, cycles: int = 3):
        self.sem = sem
        self.sem32 = sem.astype(_f32)
        self.inner_tol = float(inner_tol)
        self.cycles = int(cycles)
        self.ndim = sem.ndim

    # -- local applies ---------------------------------------------------
    def helmholtz32(self, u: jnp.ndarray, h1, h2) -> jnp.ndarray:
        """f32 local Helmholtz; accepts a trailing component axis."""
        s32 = self.sem32
        h1 = jnp.asarray(h1, _f32)
        h2 = jnp.asarray(h2, _f32)
        if u.ndim == self.ndim + 2:
            return jnp.stack(
                [s32.helmholtz_local(u[..., d], h1, h2)
                 for d in range(u.shape[-1])],
                axis=-1,
            )
        return s32.helmholtz_local(u, h1, h2)

    def fdm32(self, r: jnp.ndarray, h1, h2) -> jnp.ndarray:
        """f32 ``fdm_apply``."""
        return self.sem32.fdm_apply(
            r, jnp.asarray(h1, _f32), jnp.asarray(h2, _f32)
        )

    # -- assembled operator / projector in f32 ----------------------------
    def assembled32(self, mask: jnp.ndarray, h1, h2):
        P32 = make_projector(self.sem32, mask.astype(_f32))

        def A32(x):
            Px = P32(x)
            return P32(self.helmholtz32(Px, h1, h2)) + (x - Px)

        return A32, P32

    def dot32(self, a, b):
        s = jnp.sum((a * b).astype(_f64))
        return self.sem._reduce(s).astype(_f32)

    # -- the refined solve -------------------------------------------------
    def ir_solve(
        self,
        mask: jnp.ndarray,
        h1,
        h2,
        A64: Callable,
        rhs: jnp.ndarray,
        maxiter: int,
        use_fdm: bool = True,
        coarse: bool = False,
        project: Optional[Callable] = None,
        cycles: Optional[int] = None,
    ) -> jnp.ndarray:
        """Iteratively-refined solve of the assembled system A64 x = rhs.
        ``rhs`` must already be projected (range of P, nullspace removed)."""
        A32, P32 = self.assembled32(mask, h1, h2)

        if use_fdm:
            def precond32(r):
                Pr = P32(r)
                z = self.fdm32(Pr, h1, h2)
                if coarse:
                    z = z + self.sem32.coarse_apply_pressure(Pr)
                return P32(z) + (r - Pr)
        else:
            precond32 = None

        def inner(r64):
            dx = pcg(A32, r64.astype(_f32), precond=precond32,
                     tol=self.inner_tol, maxiter=maxiter, dot=self.dot32)
            return dx.astype(_f64)

        def cycle(carry, _):
            x, r = carry
            dx = inner(r)
            if project is not None:
                dx = project(dx)
            x = x + dx
            r = rhs - A64(x)
            if project is not None:
                r = project(r)
            return (x, r), None

        ncyc = self.cycles if cycles is None else cycles
        x0 = jnp.zeros_like(rhs)
        (x, _), _ = jax.lax.scan(cycle, (x0, rhs), None, length=ncyc)
        return x


def elliptic_solve_mixed(
    sem,
    mixed: MixedPrecision,
    h1,
    h2,
    rhs_local: jnp.ndarray,
    mask: jnp.ndarray,
    maxiter: int,
    project_mean: bool = False,
    coarse: bool = False,
    cycles: Optional[int] = None,
):
    """Mixed-precision twin of ``ops.elliptic.elliptic_solve`` for Helmholtz
    operators (local op = h1 K + h2 B).  Exactly transposable through
    ``lax.custom_linear_solve(symmetric=True)``."""
    P = make_projector(sem, mask)

    def helm64(u):
        if u.ndim == sem.ndim + 2:  # trailing velocity-component axis
            return jnp.stack(
                [sem.helmholtz_local(u[..., d], h1, h2) for d in range(u.shape[-1])],
                axis=-1,
            )
        return sem.helmholtz_local(u, h1, h2)

    def A(x):
        Px = P(x)
        return P(helm64(Px)) + (x - Px)

    rhs = P(rhs_local)

    dot = lambda a, b: sem._reduce(jnp.sum(a * b))
    project = None
    if project_mean:
        ones = jnp.ones_like(rhs)
        csq = dot(ones, ones)

        def project(q):
            return q - (dot(q, ones) / csq) * ones

    def solve(mv, rhs_):
        if project is not None:
            rhs_ = project(rhs_)
        x = mixed.ir_solve(mask, h1, h2, mv, rhs_, maxiter,
                           coarse=coarse, project=project, cycles=cycles)
        if project is not None:
            x = project(x)
        return x

    return jax.lax.custom_linear_solve(A, rhs, solve, symmetric=True)
