"""Linearized and adjoint exponential propagators.

The reference implements three hand-written integrators on Nek's perturbation
solver — ``forward_linearized_map``, ``adjoint_linearized_map`` and the
Floquet orbit store/replay (core/matvec.f90:150-474, linear_operators.f90) —
plus a finite-difference Frechet fallback.  Here all of them derive from the
*nonlinear* discrete step by JAX transforms, so the tangent map is the exact
Jacobian of the time-stepper and the adjoint is its exact transpose:

* steady base: ``jax.linearize`` of the step at the frozen base state, done
  once per BDF-ramp stage (k = 0, 1, 2), then a ``lax.scan`` over the BDF3
  tangent map — cost one *linear* step per time step (no primal recompute),
  exactly like the reference's perturbation solver;
* adjoint: ``jax.linear_transpose`` of the whole tangent propagator, wrapped
  with mass weights so it is the adjoint in the energy inner product
  <u, v>_B (the product used by the reference's ``k_dot``,
  core/krylov_subspace.f90:26-60):  M* = B^{-1} M^T B;
* Floquet (periodic base): ``jax.linearize`` over the full nonlinear
  trajectory — JAX's stored linearization residuals *are* the reference's
  orbit arrays ``uor/vor/wor`` (core/matvec.f90:189-231), with
  ``jax.checkpoint`` available to trade recompute for memory.

Machine-precision adjoint consistency <Mq, w>_B = <q, M*w>_B is guaranteed by
construction and asserted in tests (the reference could only check this
approximately)."""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from .navier_stokes import NavierStokes
from .state import initial_state


def _zeros_like(tree):
    return jax.tree.map(jnp.zeros_like, tree)


class LinearizedOperator:
    """Tangent propagator  q -> D Phi_T(base) q  around a frozen steady base
    flow (the reference's ``exponential_prop``, core/linear_operators.f90:
    17-23).

    Velocity-only steppers act on velocity fields; steppers with scalars
    (``ns.nscal > 0``) act on coupled ``(u, T)`` tuples — the Boussinesq/
    thermal analog of the reference's (vx,vy,vz,t) ``krylov_vector`` block
    (core/krylov_subspace.f90:12-17)."""

    def __init__(
        self,
        ns: NavierStokes,
        base_u: jnp.ndarray,
        base_p: Optional[jnp.ndarray] = None,
        nsteps: int = 100,
        t0: float = 0.0,
        base_T: Optional[jnp.ndarray] = None,
    ):
        self.ns = ns
        self.sem = ns.sem
        self.nsteps = int(nsteps)
        self.T = self.nsteps * ns.dt
        self.coupled = ns.nscal > 0
        s = ns.sem
        base_u = base_u.astype(s.dtype)
        if base_p is None:
            base_p = jnp.zeros(ns.p_shape, dtype=s.dtype)
        if self.coupled and base_T is None:
            base_T = jnp.zeros(s.bm.shape + (ns.nscal,), dtype=s.dtype)
        E0 = ns._explicit_weak(base_u, jnp.asarray(t0, s.dtype), T=base_T)
        base_fields = (
            base_u,
            base_p.astype(s.dtype),
            jnp.stack([base_u, base_u]),
            jnp.stack([E0, E0]),
        )
        if self.coupled:
            base_T = base_T.astype(s.dtype)
            ET0 = ns._explicit_scalar(base_u, base_T, jnp.asarray(t0, s.dtype))
            base_fields = base_fields + (
                base_T,
                jnp.stack([base_T, base_T]),
                jnp.stack([ET0, ET0]),
            )
        # pressure-increment carry: steady base -> zero increment; the
        # tangent of this slot warm-starts each tangent pressure solve from
        # the previous step's tangent increment (navier_stokes._core)
        self.warm = ns.solver.warm_start
        if self.warm:
            base_fields = base_fields + (jnp.zeros_like(base_fields[1]),)
        self._t0 = jnp.asarray(t0, s.dtype)
        self._template = base_fields
        self._matvec = jax.jit(self._apply)
        self._rmatvec = None  # built lazily (needs one transpose trace)

    def _linearize(self):
        """One tangent map per BDF-ramp stage, linearized at the frozen base.

        Called under a trace (inside the jitted ``_apply``) so the primal
        ramp solves are *compiled into* the propagator executable instead of
        being dispatched op-by-op at construction; the three loop-invariant
        primal steps are hoisted/CSEd by XLA and amount to a ~3/nsteps
        overhead per matvec."""
        return [
            jax.linearize(
                partial(self.ns._core, time=self._t0, k=k), self._template
            )[1]
            for k in range(3)
        ]

    # -- direct --------------------------------------------------------
    def _tangent0(self, q):
        """Zero-history tangent field tuple seeded with q (u or (u, T))."""
        t = self._template
        if self.coupled:
            qu, qT = q
            df = (
                qu, jnp.zeros_like(t[1]), jnp.zeros_like(t[2]),
                jnp.zeros_like(t[3]),
                qT, jnp.zeros_like(t[5]), jnp.zeros_like(t[6]),
            )
        else:
            df = (
                q, jnp.zeros_like(t[1]), jnp.zeros_like(t[2]),
                jnp.zeros_like(t[3]),
            )
        if self.warm:
            df = df + (jnp.zeros_like(t[1]),)
        return df

    def _apply(self, q):
        lin = self._linearize()
        df = self._tangent0(q)
        n = self.nsteps
        if n >= 1:
            df = lin[0](df)
        if n >= 2:
            df = lin[1](df)
        if n > 2:
            def body(c, _):
                return lin[2](c), None

            df, _ = jax.lax.scan(body, df, None, length=n - 2)
        if self.coupled:
            return (df[0], df[4])
        return df[0]

    def matvec(self, q):
        """Direct map: one compiled propagator application (the hot loop of
        SURVEY.md section 3.2)."""
        return self._matvec(q)

    # -- adjoint -------------------------------------------------------
    def _mass_weight(self, w):
        # the SPONGE-MASKED weight bm1s — the same inner product the
        # Krylov space uses (velocity_space masked=True; the reference's
        # k_dot weighs with bm1s, core/krylov_subspace.f90:26-60).  Using
        # the unmasked bm here while the svds dots used bms made the
        # adjoint inconsistent whenever a sponge was active (round-4 fix).
        bm = self.sem.bms[..., None]
        if self.coupled:
            return (w[0] * bm, w[1] * bm)
        return w * bm

    def _mass_unweight(self, w):
        # pseudo-inverse: bms is zero inside the sponge (a semi-norm);
        # those components carry no energy and are quotiented out.  The
        # vmask/tmask projection keeps the adjoint on the ADMISSIBLE
        # (homogeneous-BC) subspace: the raw transpose has nonzero rows at
        # Dirichlet input dofs (the BDF mass term reads them on step 1),
        # and without the projection svds optimizes over BC-violating
        # perturbations (measured +0.3% spurious gain on a tiny BFS vs
        # the dense restricted ground truth; the direct map is admissible
        # by construction since every step masks its output).
        bm = self.sem.bms[..., None]
        inv = jnp.where(bm > 0, 1.0 / jnp.where(bm > 0, bm, 1.0), 0.0)
        if self.coupled:
            return (w[0] * inv * self.sem.vmask,
                    w[1] * inv * self.sem.tmask[..., None])
        return w * inv * self.sem.vmask

    def rmatvec(self, w):
        """Adjoint in the (sponge-masked) energy product:
        M* = W^+ M^T W with W = diag(bm1s)."""
        if self._rmatvec is None:
            example = (
                (self._template[0], self._template[4])
                if self.coupled else self._template[0]
            )
            transpose = jax.linear_transpose(self._apply, example)

            def rmv(w_):
                (ct,) = transpose(self._mass_weight(w_))
                return self._mass_unweight(ct)

            self._rmatvec = jax.jit(rmv)
        return self._rmatvec(w)


class FloquetOperator:
    """Tangent propagator around a *periodic* base orbit (the reference's
    Floquet path: per-step orbit store/replay, core/matvec.f90:189-231,
    ``ifstorebase`` in linear_operators.f90:133-146).

    ``jax.linearize`` over the nonlinear trajectory stores the orbit as the
    linearization residuals; ``remat`` wraps each step in ``jax.checkpoint``
    so memory goes from O(nsteps) to O(sqrt-ish) with recompute."""

    def __init__(
        self,
        ns: NavierStokes,
        base_u: jnp.ndarray,
        base_p: Optional[jnp.ndarray] = None,
        nsteps: int = 100,
        t0: float = 0.0,
        remat: bool = True,
        base_T: Optional[jnp.ndarray] = None,
    ):
        self.ns = ns
        self.sem = ns.sem
        self.nsteps = int(nsteps)
        self.T = self.nsteps * ns.dt
        self.coupled = ns.nscal > 0
        s = ns.sem

        step = ns.step
        if remat:
            step = jax.checkpoint(step)

        if self.coupled and base_T is None:
            base_T = jnp.zeros(s.bm.shape + (ns.nscal,), dtype=s.dtype)

        def prop(q0):
            if self.coupled:
                u0, T0 = q0
                st = ns.make_state(u0, p=base_p, time=t0, T=T0)
            else:
                st = ns.make_state(q0, p=base_p, time=t0)

            def body(c, _):
                return step(c), None

            out, _ = jax.lax.scan(body, st, None, length=self.nsteps)
            return (out.u, out.T) if self.coupled else out.u

        self._prop = prop
        self._base = (
            (base_u.astype(s.dtype), base_T.astype(s.dtype))
            if self.coupled else base_u.astype(s.dtype)
        )
        self._matvec = None
        self._rmatvec = None

    def _build(self):
        if self._matvec is None:
            primal, lin = jax.linearize(self._prop, self._base)
            if self.coupled:
                self.monodromy_drift = self.sem.norm(primal[0] - self._base[0])
            else:
                self.monodromy_drift = self.sem.norm(primal - self._base)
            self._lin = lin
            self._matvec = jax.jit(lin)
        return self._matvec

    def matvec(self, q):
        return self._build()(q)

    # sponge-masked energy weighting, as in LinearizedOperator
    _mass_weight = LinearizedOperator._mass_weight
    _mass_unweight = LinearizedOperator._mass_unweight

    def rmatvec(self, w):
        if self._rmatvec is None:
            self._build()
            transpose = jax.linear_transpose(self._lin, self._base)

            def rmv(w_):
                (ct,) = transpose(self._mass_weight(w_))
                return self._mass_unweight(ct)

            self._rmatvec = jax.jit(rmv)
        return self._rmatvec(w)


class FiniteDifferenceOperator:
    """Frechet derivative of the nonlinear propagator by central finite
    differences — the reference's ``forward_finite_difference_map``
    (core/matvec.f90:246-379; selected there by uparam(1)=3.x with
    ``isFD``, here by ``SolverConfig.finite_difference``).

    Exists as a cross-check on the exact ``jax.linearize`` tangent (the
    reference needed it because Nek's linearized solver and nonlinear solver
    are separate code paths; here they agree by construction, so this
    operator is validation/debug machinery).  ``order`` = 2 or 4;
    eps = eps_base * ||base|| / ||q|| per apply (matvec.f90:289-300)."""

    def __init__(
        self,
        ns: NavierStokes,
        base_u: jnp.ndarray,
        nsteps: int = 100,
        t0: float = 0.0,
        order: int = 2,
        eps_base: float = 1e-6,
    ):
        if order not in (2, 4):
            raise ValueError("finite-difference order must be 2 or 4")
        self.ns = ns
        self.sem = ns.sem
        self.nsteps = int(nsteps)
        self.T = self.nsteps * ns.dt
        self.order = order
        s = ns.sem
        base_u = base_u.astype(s.dtype)
        # eps ~ eps_base * ||base|| / ||q|| (matvec.f90:289-300), with a +1
        # floor so a zero/weak base still perturbs at eps_base scale
        eps0 = eps_base * (1.0 + float(s.norm(base_u)))

        def prop(u0):
            return ns.propagator(u0, self.nsteps, time0=t0)

        def apply(q):
            eps = jnp.asarray(eps0, s.dtype) / jnp.maximum(
                s.norm(q), jnp.asarray(1e-30, s.dtype)
            )
            fp = prop(base_u + eps * q)
            fm = prop(base_u - eps * q)
            if order == 2:
                return (fp - fm) / (2.0 * eps)
            fp2 = prop(base_u + 2.0 * eps * q)
            fm2 = prop(base_u - 2.0 * eps * q)
            return (-fp2 + 8.0 * fp - 8.0 * fm + fm2) / (12.0 * eps)

        self._matvec = jax.jit(apply)

    def matvec(self, q):
        return self._matvec(q)


def make_tangent_propagator(ns: NavierStokes, nsteps: int):
    """Jit-cacheable tangent propagator  (base_u, base_p, q, dt) -> M q.

    Unlike :class:`LinearizedOperator` (which closes over a fixed base), the
    base flow and dt are runtime arguments, so Newton-Krylov re-linearizes
    around the updated state every outer iteration *without recompiling*
    (the reference instead re-runs its perturbation solver setup,
    core/newton_krylov.f90:72).  ``jax.linearize`` runs inside the jit: the
    primal (3 ramp-stage step solves) is traced once and its residuals are
    loop-invariant constants of the tangent scan."""
    s = ns.sem

    def apply(base_u, base_p, q, dt):
        E0 = ns._explicit_weak(base_u, jnp.asarray(0.0, s.dtype))
        base_fields = (
            base_u,
            base_p,
            jnp.stack([base_u, base_u]),
            jnp.stack([E0, E0]),
        )
        if ns.solver.warm_start:
            base_fields = base_fields + (jnp.zeros_like(base_p),)
        lins = [
            jax.linearize(
                partial(ns._core, time=jnp.asarray(0.0, s.dtype), k=k, dt=dt),
                base_fields,
            )[1]
            for k in range(min(nsteps, 3))
        ]
        df = jax.tree.map(jnp.zeros_like, base_fields)
        df = (q,) + df[1:]
        if nsteps >= 1:
            df = lins[0](df)
        if nsteps >= 2:
            df = lins[1](df)
        if nsteps > 2:
            def body(c, _):
                return lins[2](c), None

            df, _ = jax.lax.scan(body, df, None, length=nsteps - 2)
        return df[0]

    return jax.jit(apply)


def make_orbit_tangent_propagator(ns: NavierStokes, nsteps: int,
                                  remat: bool = True):
    """Jit-cacheable tangent of the full nonlinear trajectory:
    ``(base_u, base_p, q, dt, t0) -> D Phi_T(base_u) q`` linearized *along
    the orbit* launched from ``base_u`` at physical time ``t0``.

    This is the correct Jacobian for Newton on periodic orbits: the
    linearization point evolves over the horizon (the reference stores and
    replays the orbit for exactly this, ``uor/vor/wor`` in
    core/matvec.f90:189-231), and physical time is threaded through every
    step so time-periodic forcing ``ns.forcing(u, t)`` is linearized at the
    right phase — the forced-UPO map of uparam 2.2
    (core/main.f90:183-192, core/newton_krylov.f90:77,145).  Contrast
    :func:`make_tangent_propagator`, which freezes the base (exact for
    steady fixed points only).

    Cost note: ``jax.jvp`` recomputes the primal trajectory inside every
    matvec (~2x the reference's store/replay, which pays the primal once per
    Newton iteration).  The trade buys zero recompilation across Newton
    iterations — under jit the base is a runtime argument, whereas a
    LightKrylov-style cached linearization would bake the orbit in as
    constants and recompile every outer step.  ``remat`` wraps each step in
    ``jax.checkpoint`` so trajectory storage is traded for recompute."""

    def apply(base_u, base_p, q, dt, t0):
        step = lambda c: ns.step(c, dt=dt)
        if remat:
            step = jax.checkpoint(step)

        def prop(u0):
            st = ns.make_state(u0, p=base_p, time=t0)

            def body(c, _):
                return step(c), None

            out, _ = jax.lax.scan(body, st, None, length=nsteps)
            return out.u

        return jax.jvp(prop, (base_u,), (q,))[1]

    return jax.jit(apply)


def compute_dt_nsteps(
    mesh, umax: float, horizon: float, target_cfl: float = 0.5, dt: Optional[float] = None
) -> Tuple[float, int]:
    """Constant dt + step count for a fixed horizon (the reference's
    ``prepare_linearized_solver``: CFL-targeted dt, then nsteps =
    ceil(T/dt) and dt = T/nsteps — core/matvec.f90:21-52)."""
    if dt is None:
        dt = target_cfl * mesh.min_spacing() / max(umax, 1e-12)
    nsteps = max(int(-(-horizon // dt)), 1)
    return horizon / nsteps, nsteps
