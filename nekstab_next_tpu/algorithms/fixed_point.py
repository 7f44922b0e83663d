"""Fixed-point / steady-state accelerators: SFD, BoostConv, TDF.

Rebuilds of the reference's core/fixedp.f90:

* SFD  (:124-216) — selective frequency damping: DNS forced by
  ``chi (ubar - u)`` where ``ubar`` is a low-pass-filtered copy of the flow;
  converges to unstable steady states.  Supports both the Akervik gain
  parameterization and Casacuberta's optimal (gain, cutoff) given the leading
  eigenvalue.
* BoostConv (:218-329) — residual-subspace acceleration of DNS toward a
  steady state: every ``skip`` steps the update residual is boosted through a
  least-squares problem on a small stored subspace (QR on host).
* TDF (:2-121) — time-delayed feedback ``-chi (u(t) - u(t-T))`` with a device
  ring buffer of one-period snapshots; stabilizes periodic orbits.

Device shape: the per-step work runs as jitted chunks of ``chunk`` steps
(lax.scan); the host loop only checks residuals between chunks and decides
termination (compile-once / run-many)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..stepper.navier_stokes import NavierStokes
from ..stepper.state import FlowState, initial_state


@dataclasses.dataclass
class FixedPointResult:
    u: jnp.ndarray
    p: jnp.ndarray
    residual: float
    converged: bool
    iterations: int
    history: list


def sfd(
    ns: NavierStokes,
    u0: jnp.ndarray,
    gain: float = -0.05,
    cutoff: float = 0.05,
    tol: float = 1e-9,
    max_steps: int = 200_000,
    chunk: int = 200,
    callback: Optional[Callable] = None,
) -> FixedPointResult:
    """Selective frequency damping toward an unstable steady state.

    Filter ODE  d(ubar)/dt = cutoff * (u - ubar)  integrated forward-Euler
    alongside the flow; forcing  fc = gain * (u - ubar)  (gain < 0 damps).
    Residual = ||u - ubar||_B -> 0 at the steady state (the reference logs
    the same measure to residu.dat, fixedp.f90:186-211)."""
    s = ns.sem
    dt = ns.dt

    def chunk_fn(st: FlowState, ubar: jnp.ndarray):
        def body(carry, _):
            st, ubar = carry
            fc = gain * (st.u - ubar)
            st = ns.step(st, fc=fc)
            ubar = ubar + dt * cutoff * (st.u - ubar)
            return (st, ubar), None

        (st, ubar), _ = jax.lax.scan(body, (st, ubar), None, length=chunk)
        du = st.u - ubar
        res = jnp.sqrt(sum(
            s.inner(du[..., d], du[..., d], masked=False)
            for d in range(du.shape[-1])
        ))
        return st, ubar, res

    run = jax.jit(chunk_fn)
    st = ns.make_state(u0)
    ubar = st.u
    history = []
    steps = 0
    res = np.inf
    while steps < max_steps:
        st, ubar, r = run(st, ubar)
        steps += chunk
        res = float(r)
        history.append((steps, res))
        if callback is not None:
            callback(steps, res)
        if not np.isfinite(res):
            raise FloatingPointError(f"SFD diverged at step {steps}")
        if res < tol:
            return FixedPointResult(st.u, st.p, res, True, steps, history)
    return FixedPointResult(st.u, st.p, res, False, steps, history)


def boostconv_dns(
    ns: NavierStokes,
    u0: jnp.ndarray,
    skip: int = 10,
    subspace: int = 10,
    tol: float = 1e-9,
    max_steps: int = 200_000,
    callback: Optional[Callable] = None,
) -> FixedPointResult:
    """BoostConv-accelerated march to a steady state — a faithful rebuild of
    the reference's ``BoostConv``/``boostconv_core`` (core/fixedp.f90:218-329,
    after Citro et al. 2017).

    Every ``skip`` DNS steps the ONE-step residual  r = u(t) - u(t-dt)  is
    replaced by a boosted residual  xi  and the state reset to
    ``u(t-dt) + xi``.  The accelerator keeps cyclic buffers of input-residual
    differences Y and boosted outputs X with the reference's recursive
    update (y_rot -= r; x_rot -= y_rot), solves the small least-squares
    problem on the Y subspace by modified Gram-Schmidt QR in the
    mass-weighted inner product (``qr_dec``, :331-385, with its zero-column
    guards) and back-substitution (``linear_system``, :387-403), then
    emits  xi = r + X ccb."""
    s = ns.sem
    nd = s.ndim
    dot = lambda a, b: sum(
        float(s.inner(a[..., d], b[..., d], masked=False)) for d in range(nd)
    )

    adv = jax.jit(lambda st: ns.advance(st, skip - 1)) if skip > 1 else None
    one = jax.jit(ns.step)
    st = ns.make_state(u0)
    m = subspace
    zeros = jnp.zeros_like(st.u)
    X = [zeros] * m
    Y = [zeros] * m
    rot = 0
    init = False
    history = []
    steps = 0
    res = np.inf
    while steps < max_steps:
        st_prev = adv(st) if adv is not None else st
        st = one(st_prev)
        steps += skip
        r = st.u - st_prev.u
        res = float(np.sqrt(max(dot(r, r), 0.0)))
        history.append((steps, res))
        if callback is not None:
            callback(steps, res)
        if not np.isfinite(res):
            raise FloatingPointError(f"BoostConv diverged at step {steps}")
        if res < tol:
            return FixedPointResult(st.u, st.p, res, True, steps, history)

        # --- boostconv_core -------------------------------------------
        if not init:
            X[0] = r
            Y[0] = r
            rot = 0
            init = True
            xi = r  # first call: unboosted (v = vold + r)
        else:
            Y[rot] = Y[rot] - r
            X[rot] = X[rot] - Y[rot]
            # MGS QR of the Y buffer in the mass-weighted product, with the
            # reference's zero/degenerate-column guard (norma -> 1, q -> 0)
            Q = []
            R = np.zeros((m, m))
            for j in range(m):
                v = Y[j]
                for i in range(j):
                    R[i, j] = dot(v, Q[i])
                    v = v - R[i, j] * Q[i]
                nrm2 = dot(v, v)
                if nrm2 < 1e-60:
                    Q.append(jax.tree.map(jnp.zeros_like, v))
                    R[j, j] = 1.0
                else:
                    nrm = float(np.sqrt(nrm2))
                    Q.append(v / nrm)
                    R[j, j] = nrm
            c = np.array([dot(r, q) for q in Q])
            ccb = np.zeros(m)
            for j in range(m - 1, -1, -1):
                ccb[j] = (c[j] - R[j, j + 1:] @ ccb[j + 1:]) / R[j, j]
            rot = (rot + 1) % m
            Y[rot] = r
            xi = r
            for j in range(m):
                xi = xi + ccb[j] * X[j]
            X[rot] = xi
        st = ns.make_state(st_prev.u + xi, p=st.p, time=float(st.time))
    return FixedPointResult(st.u, st.p, res, False, steps, history)


def tdf(
    ns: NavierStokes,
    u0: jnp.ndarray,
    period: float,
    gain: float = -0.05,
    tol: float = 1e-8,
    max_periods: int = 200,
    callback: Optional[Callable] = None,
) -> FixedPointResult:
    """Time-delayed feedback stabilization of a periodic orbit (reference
    fixedp.f90:2-121): forcing  fc = gain * (u(t) - u(t - T))  with a device
    ring buffer of the last period's snapshots."""
    s = ns.sem
    dt = ns.dt
    norbit = max(int(round(period / dt)), 1)

    def one_period(st: FlowState, ring: jnp.ndarray):
        def body(carry, i):
            st, ring = carry
            delayed = ring[i]
            fc = gain * (st.u - delayed)
            st = ns.step(st, fc=fc)
            ring = ring.at[i].set(st.u)
            return (st, ring), None

        (st, ring), _ = jax.lax.scan(body, (st, ring), jnp.arange(norbit))
        return st, ring

    run = jax.jit(one_period)
    st = ns.make_state(u0)
    ring = jnp.broadcast_to(st.u, (norbit,) + st.u.shape).copy()
    history = []
    res = np.inf
    for it in range(max_periods):
        u_prev = st.u
        st, ring = run(st, ring)
        du = st.u - u_prev
        res = float(
            jnp.sqrt(sum(
                s.inner(du[..., d], du[..., d], masked=False)
                for d in range(du.shape[-1])
            ))
        )
        history.append(((it + 1) * norbit, res))
        if callback is not None:
            callback(it, res)
        if res < tol:
            return FixedPointResult(st.u, st.p, res, True, (it + 1) * norbit, history)
    return FixedPointResult(st.u, st.p, res, False, max_periods * norbit, history)
