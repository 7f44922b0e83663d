"""Newton-Krylov fixed points and unstable periodic orbits (UPOs).

Rebuild of the reference's core/newton_krylov.f90:

* outer Newton loop on  F(q) = Phi_T(q) - q  (:44-133) with the
  time-stepper GMRES inner solve (``ts_gmres``, :170-299) on the Jacobian
  J = D Phi_T - I;
* UPOs (uparam 2.1): the period T joins the unknowns; the bordered Jacobian
  gets the column  b = d Phi_T / dT  (time derivative of the flow at t = T,
  the reference's ``compute_bvec`` one-step estimate, core/matvec.f90:575-613)
  and the phase-condition row  <qdot(0), dq> = 0  (:550-563);
* dynamic forcing of the GMRES tolerance from the current residual
  (``spec_tole``, :408-435).

Device shape: the nonlinear map and the tangent map are two jit-compiled
functions taking (q, dt) — no recompilation across Newton iterations even
though the base flow and the UPO period change every step."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import NewtonConfig
from ..krylov.gmres import gmres
from ..krylov.vector import VectorSpace
from ..stepper.linearized import (
    make_orbit_tangent_propagator,
    make_tangent_propagator,
)
from ..stepper.navier_stokes import NavierStokes


@dataclasses.dataclass
class NewtonResult:
    u: jnp.ndarray
    p: jnp.ndarray
    period: Optional[float]
    residual: float
    converged: bool
    iterations: int
    n_matvecs: int
    history: list


def _dotv(sem, a, b):
    return sum(
        sem.inner(a[..., d], b[..., d], masked=False) for d in range(a.shape[-1])
    )


def _vspace(sem) -> VectorSpace:
    return VectorSpace(lambda a, b: _dotv(sem, a, b))


def _vspace_upo(sem) -> VectorSpace:
    """Augmented (velocity, period) vector space — the reference's
    ``krylov_vector`` with its ``time`` component in the inner product
    (core/krylov_subspace.f90:26-60)."""

    def dot(a, b):
        u, t = a
        v, s = b
        return _dotv(sem, u, v) + t * s

    return VectorSpace(dot)


def newton_krylov(
    ns: NavierStokes,
    u0: jnp.ndarray,
    horizon: float,
    nsteps: int,
    upo: bool = False,
    forced: bool = False,
    cfg: NewtonConfig = NewtonConfig(),
    k_dim: int = 64,
    callback: Optional[Callable] = None,
) -> NewtonResult:
    """Solve Phi_T(q) = q (fixed point), or (Phi_T(q) = q, T) for a UPO.

    For fixed points ``horizon`` is an arbitrary integration time (larger T
    damps stable transients harder per Newton step); for UPOs it is the
    initial period guess.

    ``forced=True`` is the reference's uparam 2.2 (core/main.f90:183-192,
    newton_krylov.f90:77,145): a periodic orbit of a *time-periodically
    forced* system.  The period is then fixed at ``horizon`` (the forcing
    period — not an unknown, so no bordered row), the orbit is phase-locked
    to the forcing (integration starts at t=0), and the Jacobian is the
    monodromy linearized along the trajectory with physical time threaded
    through (``make_orbit_tangent_propagator``).  Autonomous UPOs
    (``upo=True``) use the same trajectory-linearized monodromy plus the
    period column / phase-condition row."""
    if upo and forced:
        raise ValueError(
            "upo=True (unknown period) and forced=True (fixed forcing "
            "period) are mutually exclusive — pick the reference's uparam "
            "2.1 or 2.2"
        )
    s = ns.sem
    q = u0.astype(s.dtype)
    T = float(horizon)
    dt = T / nsteps

    prop = jax.jit(lambda u, dt_: ns.propagator(u, nsteps, dt=dt_))
    prop1 = jax.jit(lambda u, dt_: ns.propagator(u, 1, dt=dt_))
    if upo or forced:
        # periodic orbits: linearize along the evolving trajectory (the
        # frozen-base tangent is exact only at a steady state)
        orbit_tangent = make_orbit_tangent_propagator(ns, nsteps)
        t0 = jnp.asarray(0.0, s.dtype)
        tangent = lambda b, p, v, dt_: orbit_tangent(b, p, v, dt_, t0)
    else:
        tangent = make_tangent_propagator(ns, nsteps)

    space = _vspace_upo(s) if upo else _vspace(s)
    nmv_total = 0
    history = []
    res = np.inf
    p_final = jnp.zeros(ns.p_shape, dtype=s.dtype)

    for it in range(cfg.max_iter):
        dt = T / nsteps
        # pass dt in the SEM dtype: a Python float traced under x64 is a
        # weak f64 that silently promotes the whole f32 step (round-5 bug
        # found by the f32 Newton warm phase)
        dtj = jnp.asarray(dt, s.dtype)
        Phi = prop(q, dtj)
        F = Phi - q
        res = float(jnp.sqrt(_dotv(s, F, F)))
        history.append((it, res, T))
        if callback is not None:
            callback(it, res, T)
        if not np.isfinite(res):
            raise FloatingPointError(f"Newton residual not finite at iter {it}")
        if res < cfg.tol:
            # recover the steady pressure: integrate a few steps from the
            # fixed point (the per-step pressure solve converges to the
            # steady field; the Newton unknown is velocity-only, matching
            # the reference's time-stepper formulation)
            stf = jax.jit(lambda u: ns.advance(ns.make_state(u), min(nsteps, 20)))(q)
            return NewtonResult(q, stf.p, T if (upo or forced) else None,
                                res, True, it, nmv_total, history)

        # dynamic inner tolerance.  gmres() treats tol as RELATIVE to ||F||,
        # so the forcing term is Eisenstat-Walker-style: loose solves while
        # the residual is large (eta ~ 0.1 sqrt(res)), tightened near
        # convergence just enough that one more Newton step reaches cfg.tol.
        # (The reference's spec_tole instead schedules the inner *PDE solver*
        # tolerances, newton_krylov.f90:408-435 — our elliptic tolerances
        # stay fixed and the Krylov solve carries the scheduling.)
        if cfg.dynamic_tol:
            gtol = float(np.clip(0.1 * np.sqrt(res), 1e-6, 0.1))
        else:
            gtol = cfg.tol

        if upo:
            # bordered system: J (dq, dT) = (-F, 0)
            bvec = (prop1(Phi, dtj) - Phi) / dt  # d Phi_T / dT ~ u_dot(T)
            qdot0 = (prop1(q, dtj) - q) / dt  # phase direction at t=0

            def J(x):
                dq, dT = x
                Mdq = tangent(q, p_final, dq, dtj)
                phase = _dotv(s, qdot0, dq)
                return (Mdq - dq + dT * bvec, phase)

            rhs = (-F, jnp.asarray(0.0, s.dtype))
            x0 = (jnp.zeros_like(q), jnp.asarray(0.0, s.dtype))
            sol, info = gmres(J, space, rhs, x0=x0, k_dim=k_dim, tol=gtol,
                              max_restarts=cfg.gmres_restarts)
            dq, dT = sol
            # keep the iterate in the SEM dtype: gmres' host-side (f64)
            # recombination coefficients otherwise promote f32 states
            q = (q + dq).astype(s.dtype)
            T = float(T + float(dT))
        else:
            def J(dq):
                return tangent(q, p_final, dq, dtj) - dq

            sol, info = gmres(J, space, -F, k_dim=k_dim, tol=gtol,
                              max_restarts=cfg.gmres_restarts)
            q = (q + sol).astype(s.dtype)
        nmv_total += info["iterations"] + 2

    return NewtonResult(q, p_final, T if (upo or forced) else None, res,
                        False, cfg.max_iter, nmv_total, history)
