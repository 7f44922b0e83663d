"""Incompressible Navier-Stokes time-stepper (the reference's ``nek_advance``).

Scheme: BDFk/EXTk (k ramps 1->3, matching Nek TORDER=3 that the reference
uses, SURVEY.md section 2.2) with incremental pressure correction:

1. explicit terms  E^n = -C(u^n)u^n + B f^n  (dealiased weak convection,
   sponge + user forcing), extrapolated with EXTk;
2. velocity Helmholtz solve  (g0/dt B + nu K) u* = rhs  with Dirichlet lift;
3. pressure-increment Poisson  K dp = -(g0/dt) B div(u*)  (Neumann at walls,
   Dirichlet 0 at outflow);
4. projection  u <- u* - (dt/g0) grad(dp), mass-averaged back onto the C0
   space, BCs re-imposed; p <- p + dp.

Both elliptic solves go through ``lax.custom_linear_solve`` (ops/cg.py), so
``jax.jvp`` of :meth:`step` IS the linearized (perturbation) step and
``jax.linear_transpose`` IS the discrete adjoint step — replacing the
reference's ``forward_linearized_map`` / ``adjoint_linearized_map``
(core/matvec.f90:150-474) without a second hand-derived solver.

One :meth:`advance` call = one jitted ``lax.scan`` over nsteps = one
application of the exponential propagator exp(T L) (core/matvec.f90:56-146).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SolverConfig
from ..ops.cg import cg_solve, pcg
from ..ops.core import SEM
from ..ops.elliptic import elliptic_solve, make_projector
from .state import FlowState, initial_state

# BDFk / EXTk coefficients, index k-1 (padded to length 3)
_BDF = {
    1: (1.0, [1.0, 0.0, 0.0]),
    2: (1.5, [2.0, -0.5, 0.0]),
    3: (11.0 / 6.0, [3.0, -1.5, 1.0 / 3.0]),
}
_EXT = {
    1: [1.0, 0.0, 0.0],
    2: [2.0, -1.0, 0.0],
    3: [3.0, -3.0, 1.0],
}


def _pressure_operator(s, u_like) -> Callable:
    """E = D M^-1 D^T on the P_{N-2} Gauss pressure space of ``s``: the
    weak divergence D, the masked inverse mass M^-1 and the exact transpose
    D^T (``u_like`` gives the velocity shape and dtype)."""
    grad_wt = jax.linear_transpose(s.div_to_p, u_like)
    vmask = s.vmask
    binv = s.binv_assembled[..., None]

    def E(q):
        g = grad_wt(q)[0]
        return s.div_to_p(vmask * (binv * s.dssum(vmask * g)))

    return E


def _pressure_precond(s, name: str) -> Callable:
    """The PnPn-2 pressure preconditioner ``name`` of ``s``, where built
    ('schwarz' patches do not exist under shard_map: 'block' serves)."""
    if name == "schwarz" and s.pschwarz is not None:
        return s.pressure_precond_schwarz
    if name in ("block", "schwarz") and s.pblock_inv is not None:
        return s.pressure_precond_block
    return s.pressure_precond_pnpn2


class NavierStokes:
    """Matrix-free incompressible NS stepper on one SEM mesh.

    Parameters
    ----------
    sem : SEM operator context
    viscosity : kinematic viscosity (1/Re)
    dt : time step (constant — the reference forces constant dt,
         core/matvec.f90:40-52)
    u_bc : (nelem, n, n, 2) Dirichlet values (zero except at Dirichlet nodes)
    forcing : optional ``f(u, t) -> (nelem,n,n,2)`` pointwise acceleration
              (user hook, the reference's ``nekStab_forcing``)
    sponge_ref : reference field toward which the sponge damps (DNS) — for
              perturbation solves pass zeros (reference forcing.f90:35-50)

    Temperature / passive scalars (the reference's heat solver + ``ifto/
    ifpsco`` machinery, core/nek_vectors.f90:209-362, forcing.f90:54-79):

    scalar_diff : per-scalar diffusivities (alpha_i); enables the coupled
              advection-diffusion solve  dT/dt + u.grad T = alpha lap T + q
    t_bc : (nelem, n, n, nscal) Dirichlet values at tmask==0 nodes
    t_forcing : optional ``q(u, T, t) -> (nelem,n,n,nscal)`` scalar source
    buoyancy : optional ``b(T) -> (nelem,n,n,ndim)`` body acceleration added
              to the momentum equation (Boussinesq coupling); because the
              coupled step is one differentiable function, its ``jax.jvp``/
              ``linear_transpose`` are the exact coupled linearized/adjoint
              operators (thermal instability analyses for free)
    sponge_ref_T : scalar field the sponge damps T toward (reference
              ``fct`` temperature sponge, forcing.f90:54-79)
    """

    def __init__(
        self,
        sem: SEM,
        viscosity: float,
        dt: float,
        u_bc: Optional[jnp.ndarray] = None,
        forcing: Optional[Callable] = None,
        sponge_ref: Optional[jnp.ndarray] = None,
        solver: SolverConfig = SolverConfig(),
        mixed_precision: bool = False,
        u_bc_fn: Optional[Callable] = None,
        scalar_diff: Optional[Tuple[float, ...]] = None,
        t_bc: Optional[jnp.ndarray] = None,
        t_forcing: Optional[Callable] = None,
        buoyancy: Optional[Callable] = None,
        sponge_ref_T: Optional[jnp.ndarray] = None,
    ):
        self.sem = sem
        self.ndim = sem.ndim
        self.nu = float(viscosity)
        self.dt = float(dt)
        self.solver = solver
        s = sem
        self.u_bc = (
            jnp.zeros(s.bm.shape + (self.ndim,), dtype=s.dtype)
            if u_bc is None else u_bc.astype(s.dtype)
        )
        # keep only Dirichlet-node values in the lift field
        self.u_bc = (1.0 - s.vmask) * self.u_bc
        # optional time-dependent Dirichlet BC (e.g. FST inflow, stepper/
        # fst.py — the reference's fst_uin/vin/win BC arrays, core/fst.f90):
        # evaluated at the new time level inside the jitted step
        self.u_bc_fn = u_bc_fn
        self.forcing = forcing
        self.sponge_ref = sponge_ref
        self._convect = s.convect if solver.dealias else s.convect_colloc_v

        # temperature / passive scalars
        self.scalar_diff = tuple(float(a) for a in scalar_diff) if scalar_diff else ()
        self.nscal = len(self.scalar_diff)
        self.t_forcing = t_forcing
        self.buoyancy = buoyancy
        self.sponge_ref_T = sponge_ref_T
        if self.nscal:
            tmaskc = s.tmask[..., None]
            self.t_bc = (
                jnp.zeros(s.bm.shape + (self.nscal,), dtype=s.dtype)
                if t_bc is None else (1.0 - tmaskc) * t_bc.astype(s.dtype)
            )
        else:
            self.t_bc = None

        # local operator diagonal for Jacobi preconditioning (assembled
        # inside elliptic_solve)
        self._kdiag_local = s.stiffness_diag()

        # mesh-robust pressure preconditioners (ops/schwarz.py): build
        # eagerly — the construction runs real device computations, which
        # must not happen mid-trace.  Under shard_map the shard view
        # carries the sharded pblock_inv slices ('schwarz' patches gather
        # across element boundaries, so the sharded path falls back to
        # 'block'; see SolverConfig.pressure_precond).
        if solver.pressure_operator == "pnpn2" and s.axis_name is None:
            if solver.pressure_precond == "schwarz":
                s.setup_pressure_schwarz(adjacency=solver.pressure_patch_overlap)
            elif solver.pressure_precond == "block":
                s.setup_pressure_blocks()
        self._vblocks = None
        if (solver.velocity_precond == "block" and s.axis_name is None
                and not mixed_precision):
            # built for the final (BDF3) stage's h2 = (11/6)/dt; the two
            # ramp steps see a mildly mismatched but SPD preconditioner
            self._vblocks = s.setup_velocity_blocks(
                self.nu, _BDF[3][0] / self.dt
            )

        # opt-in mixed precision (f64 accuracy from f32 arithmetic).  Two
        # routes:
        # * refinement (2-D, single-device, PnPn-2): f64 state on the SAME
        #   scheme as the f64 path, with both inner solves replaced by
        #   iterative refinement (ops/cg.py) around f32 subspace PCG on an
        #   f32 copy of the SEM (``_sem32``);
        # * legacy (ops/mixed.py): GLL-grid approximate projection
        #   ('laplacian') with f32 inner CG — sharded runs and the other
        #   pressure schemes.
        self.mixed = None
        self._sem32 = None
        if mixed_precision:
            if (sem.ndim == 2 and sem.axis_name is None
                    and solver.pressure_operator == "pnpn2"):
                # cast after the preconditioner setup above, so the copy
                # carries the built blocks/patches
                self._sem32 = s.astype(jnp.float32)
            else:
                from ..ops.mixed import MixedPrecision

                self.mixed = MixedPrecision(s)
        self._ir_cycles = int(solver.mixed_ir_cycles)
        self._scheme = (
            "laplacian" if self.mixed is not None else solver.pressure_operator
        )

        # opt-in lanes-layout CG iterations (ops/lanes.py): 2-D single-device
        # only — the sharded path's per-element arrays are shard_map tracers
        self.lanes = None
        if (solver.lanes_layout and sem.ndim == 2 and sem.axis_name is None
                and self.mixed is None):
            from ..ops.lanes import LanesOps

            self.lanes = LanesOps(sem)
            if solver.pressure_direct and self._scheme == "pnpn2":
                # build eagerly: the dense-inverse construction runs real
                # device computations, which must not happen mid-trace
                self.lanes.direct_pressure_inv()

    # ------------------------------------------------------------------
    @property
    def p_shape(self):
        """Shape of the pressure field: the P_{N-2} Gauss space for the
        PnPn-2 formulation (matching the reference's P_N/P_{N-2} SEM),
        else the velocity GLL grid."""
        if self._scheme == "pnpn2":
            return self.sem.p_shape
        return self.sem.bm.shape

    def make_state(self, u, p=None, time: float = 0.0, T=None) -> FlowState:
        """Fresh :class:`FlowState` with pressure (and the warm-start dp
        carry) in THIS stepper's pressure space."""
        s = self.sem
        if p is None:
            p = jnp.zeros(self.p_shape, dtype=s.dtype)
        return initial_state(
            u.astype(s.dtype), p=p, time=time, dtype=s.dtype, T=T,
            warm_start=self.solver.warm_start,
        )

    def _explicit_weak(self, u: jnp.ndarray, t: jnp.ndarray, fc=None, T=None) -> jnp.ndarray:
        """Weak explicit terms E = -C(u)u + B f(u,t) + B fc (local form).

        ``fc`` is an explicit pointwise acceleration field — the equivalent of
        the reference's accumulated forcing arrays ``fcx/fcy`` applied through
        the ``userf`` hook (core/forcing.f90:2-33); SFD/TDF/BoostConv and the
        resolvent's harmonic forcing inject through it.  ``T`` feeds the
        optional Boussinesq buoyancy coupling."""
        s = self.sem
        conv = jnp.stack(
            [self._convect(u, u[..., d]) for d in range(u.shape[-1])], axis=-1
        )
        E = -conv
        bm = s.bm[..., None]
        if self.sponge_ref is not None:
            lam = s.sponge[..., None]
            E = E + bm * lam * (self.sponge_ref - u)
        if self.forcing is not None:
            E = E + bm * self.forcing(u, t)
        if self.buoyancy is not None and T is not None:
            E = E + bm * self.buoyancy(T)
        if fc is not None:
            E = E + bm * fc
        return E

    def _explicit_scalar(self, u, T, t, fcT=None) -> jnp.ndarray:
        """Weak explicit scalar terms E_T = -C(u)T + B q(u,T,t) + B fcT,
        per scalar (the reference's heat/passive-scalar convection plus the
        ``nekStab_forcing_temp`` hook, forcing.f90:54-79)."""
        s = self.sem
        conv = jnp.stack(
            [self._convect(u, T[..., i]) for i in range(T.shape[-1])], axis=-1
        )
        E = -conv
        bm = s.bm[..., None]
        if self.sponge_ref_T is not None:
            lam = s.sponge[..., None]
            E = E + bm * lam * (self.sponge_ref_T - T)
        if self.t_forcing is not None:
            E = E + bm * self.t_forcing(u, T, t)
        if fcT is not None:
            E = E + bm * fcT
        return E

    # ------------------------------------------------------------------
    def step(self, state: FlowState, fc=None, dt=None) -> FlowState:
        """Advance one time step (pure function; jvp/transpose-safe).

        ``dt`` optionally overrides the constructor time step (may be a
        traced scalar — lets UPO Newton vary the period without recompiling,
        the reference instead recomputes nsteps host-side each iteration,
        core/newton_krylov.f90:72)."""
        k = jnp.minimum(state.step, 2)  # 0,1,2 -> BDF1,2,3
        dt_ = self.dt if dt is None else dt
        carry_dp = state.dp is not None
        dp_t = (state.dp,) if carry_dp else ()
        if self.nscal:
            fields = (state.u, state.p, state.ulag, state.nlag,
                      state.T, state.tlag, state.ntlag) + dp_t
            out = self._core(fields, state.time, k, fc=fc, dt=dt)
            u, p, ulag, nlag, T, tlag, ntlag = out[:7]
            return FlowState(
                u=u, p=p, ulag=ulag, nlag=nlag,
                time=state.time + dt_, step=state.step + 1,
                T=T, tlag=tlag, ntlag=ntlag,
                dp=out[7] if carry_dp else None,
            )
        fields = (state.u, state.p, state.ulag, state.nlag) + dp_t
        out = self._core(fields, state.time, k, fc=fc, dt=dt)
        u, p, ulag, nlag = out[:4]
        return FlowState(
            u=u, p=p, ulag=ulag, nlag=nlag,
            time=state.time + dt_, step=state.step + 1,
            dp=out[4] if carry_dp else None,
        )

    def _core(self, fields: Tuple, time, k, fc=None, dt=None, fcT=None) -> Tuple:
        """One step on the raw field tuple (u, p, ulag, nlag[, T, tlag, ntlag]).

        ``k`` selects the BDF/EXT order (0,1,2 -> BDF1,2,3); it may be a
        traced value (nonlinear scan) or a concrete int — the linearized
        operator (linearized.py) linearizes this function at each concrete k
        so the startup ramp is frozen into three compiled tangent maps.

        An optional trailing ``dp`` entry (the previous step's pressure
        increment) warm-starts the elliptic solves in residual-correction
        form  x = x0 + A^-1(b - A x0) — the reference's Nek ``residualProj``
        plays this role (examples/cylinder/1cyl.par [PRESSURE] residualProj).
        Because the correction form is differentiated as a whole, the
        *tangent* scan warm-starts from the previous tangent increment
        automatically."""
        if self.nscal:
            u0, p0, ulag0, nlag0, T0, tlag0, ntlag0 = fields[:7]
            rest = fields[7:]
        else:
            u0, p0, ulag0, nlag0 = fields[:4]
            rest = fields[4:]
            T0 = None
        dp0 = rest[0] if rest else None
        s = self.sem
        if dt is None:
            dt = self.dt

        g0s = jnp.asarray([_BDF[1][0], _BDF[2][0], _BDF[3][0]], dtype=s.dtype)
        bdfs = jnp.asarray([_BDF[1][1], _BDF[2][1], _BDF[3][1]], dtype=s.dtype)
        exts = jnp.asarray([_EXT[1], _EXT[2], _EXT[3]], dtype=s.dtype)
        g0 = g0s[k]
        b = bdfs[k]
        a = exts[k]

        E0 = self._explicit_weak(u0, time, fc=fc, T=T0)
        bm = s.bm[..., None]
        scheme = self._scheme
        consistent = scheme in ("consistent", "pnpn2")

        # discrete weak divergence D and its EXACT transpose (the weak
        # pressure gradient).  Using one D for the momentum pressure term,
        # the Poisson operator E = D M^-1 D^T, and the projection makes the
        # corrected velocity discretely divergence-free — a strong-gradient
        # correction against the weak Laplacian is inconsistent on curved/
        # graded elements and grows a few %/step (diagnosed on the cylinder
        # O-mesh).  'pnpn2' puts the pressure in discontinuous P_{N-2}
        # (Gauss points), which also removes the same-order spurious
        # pressure modes that cripple the CG conditioning of the continuous
        # same-order 'consistent' variant — the reference's P_N/P_{N-2}.
        if scheme == "pnpn2":
            def div_w(u):
                return s.div_to_p(u)
        else:
            def div_w(u):
                return s.bm * s.divv(u)

        if consistent:
            grad_wt = jax.linear_transpose(div_w, u0)
            grad_w = lambda q: grad_wt(q)[0]
            vmask_ = s.vmask
            binv = s.binv_assembled[..., None]

            def Minv_free(g):
                return vmask_ * (binv * s.dssum(vmask_ * g))

        # weak RHS for the Helmholtz solve
        rhs = (
            (1.0 / dt) * bm * (b[0] * u0 + b[1] * ulag0[0] + b[2] * ulag0[1])
            + a[0] * E0 + a[1] * nlag0[0] + a[2] * nlag0[1]
        )
        # incremental pressure: weak gradient of current pressure
        # (D^T p ~ -B grad p + outflow boundary term)
        if consistent:
            rhs = rhs + grad_w(p0)
        else:
            rhs = rhs - bm * s.gradv(p0)

        # ---- velocity Helmholtz solve with Dirichlet lift ---------------
        vmask = s.vmask
        h2 = g0 / dt
        ndim = u0.shape[-1]
        u_bc = self.u_bc
        if self.u_bc_fn is not None:
            u_bc = u_bc + (1.0 - vmask) * self.u_bc_fn(time + dt)

        def helm_local(w):
            return jnp.stack(
                [s.helmholtz_local(w[..., d], self.nu, h2) for d in range(ndim)],
                axis=-1,
            )

        if self.mixed is not None:
            from ..ops.mixed import elliptic_solve_mixed

            w = elliptic_solve_mixed(
                s, self.mixed, self.nu, h2,
                rhs - helm_local(u_bc), vmask,
                maxiter=self.solver.velocity_maxiter,
            )
        else:
            # warm start from the current velocity (w ~ u* ~ u^n): solve for
            # the O(dt) correction only.  The guess MUST lie in the solver's
            # continuous masked subspace or the residual-correction identity
            # x0 + A^-1(b - A x0) = A^-1 b fails by (I-P)x0 — the primal
            # state is C0 so this is free there, but tangent/cotangent
            # vectors (jvp/transpose of the step) need not be, so project.
            if self.solver.warm_start:
                x0v = vmask * s.dsavg(vmask * (u0 - u_bc))
            else:
                x0v = 0.0
            # the lanes velocity bundle carries its own FDM preconditioner;
            # it must not silently shadow a requested exact-block velocity
            # preconditioner (round-4 ADVICE) — with 'block' requested the
            # standard-layout path with vblocks runs instead
            lanes_v = None
            if (self.lanes is not None and self.solver.fdm_precond
                    and self._vblocks is None):
                lanes_v = self.lanes.velocity_bundle(self.nu, h2)
            inner_v = None
            if self._sem32 is not None:
                inner_v = self._velocity_inner32(h2)
            w = x0v + elliptic_solve(
                s,
                helm_local,
                rhs - helm_local(u_bc + x0v),
                vmask,
                tol=self.solver.velocity_tol,
                maxiter=self.solver.velocity_maxiter,
                diag_local=self.nu * self._kdiag_local + h2 * s.bm,
                fdm=(self.nu, h2) if self.solver.fdm_precond else None,
                lanes=lanes_v,
                vblocks=self._vblocks,
                fixed_iters=self.solver.cg_fixed_iters,
                inner_solve=inner_v,
                ir_cycles=self._ir_cycles,
            )
        ustar = w + u_bc

        # ---- pressure-increment Poisson --------------------------------
        if self.mixed is not None:
            from ..ops.mixed import elliptic_solve_mixed

            dp = elliptic_solve_mixed(
                s, self.mixed, 1.0, 0.0,
                -(g0 / dt) * s.bm * s.divv(ustar), s.pmask,
                maxiter=self.solver.pressure_maxiter,
                project_mean=not s.has_pressure_dirichlet,
                coarse=True,
            )
        elif scheme == "pnpn2":
            # E = D M^-1 D^T on the discontinuous Gauss pressure space: SPD,
            # spurious-mode free, Euclid-symmetric by transpose construction
            # — plain CG, no continuity projector or mask needed.
            E_op = _pressure_operator(s, u0)

            x0p = dp0 if (dp0 is not None and self.solver.warm_start) else None
            project = None
            if not s.has_pressure_dirichlet:
                # fully-enclosed flow: constants span null(E) exactly
                ones = jnp.ones(s.p_shape, dtype=s.dtype)
                csq = s._reduce(jnp.sum(ones * ones))

                def project(q):
                    return q - (s._reduce(jnp.sum(q * ones)) / csq) * ones

                if x0p is not None:
                    # keep the warm guess out of null(E): the correction
                    # identity only cancels x0 on range(E)
                    x0p = project(x0p)
            rhs_p = -(g0 / dt) * div_w(ustar)
            if x0p is not None:
                rhs_p = rhs_p - E_op(x0p)

            lanes_p = None
            if self.lanes is not None:
                lanes_p = self.lanes.pressure_bundle(
                    project_mean=not s.has_pressure_dirichlet,
                    direct=self.solver.pressure_direct,
                    precond=self.solver.pressure_precond,
                )
            inner_p = None
            if self._sem32 is not None:
                inner_p = self._pressure_inner32(u0)
            dp = cg_solve(
                E_op,
                rhs_p,
                precond=_pressure_precond(s, self.solver.pressure_precond),
                tol=self.solver.pressure_tol,
                maxiter=self.solver.pressure_maxiter,
                dot=lambda a, c: s._reduce(jnp.sum(a * c)),
                project=project,
                lanes=lanes_p,
                fixed_iters=self.solver.cg_fixed_iters,
                inner_solve=inner_p,
                ir_cycles=self._ir_cycles,
            )
            if x0p is not None:
                dp = dp + x0p
        else:
            p_op = (
                (lambda q: div_w(Minv_free(grad_w(q))))
                if consistent else s.stiffness_local
            )
            # warm start from the previous pressure increment when the state
            # carries one (residual-correction form; see _core docstring)
            x0p = dp0 if (dp0 is not None and self.solver.warm_start) else None
            rhs_p = -(g0 / dt) * div_w(ustar)
            if x0p is not None:
                rhs_p = rhs_p - p_op(x0p)
            dp = elliptic_solve(
                s,
                p_op,
                rhs_p,
                s.pmask,
                tol=self.solver.pressure_tol,
                maxiter=self.solver.pressure_maxiter,
                diag_local=self._kdiag_local,
                project_mean=not s.has_pressure_dirichlet,
                fdm=(1.0, 0.0) if self.solver.fdm_precond else None,
                coarse=self.solver.fdm_precond,
                fixed_iters=self.solver.cg_fixed_iters,
            )
            if x0p is not None:
                dp = dp + x0p

        # ---- projection / correction -----------------------------------
        if consistent and self.mixed is None:
            # discretely divergence-free by construction; Dirichlet rows of
            # the correction vanish (Minv_free masks), so BCs stay intact
            u_new = ustar + (dt / g0) * Minv_free(grad_w(dp))
        else:
            u_new = ustar - (dt / g0) * s.gradv(dp)
            u_new = s.dsavg_mass(u_new)
            u_new = vmask * u_new + u_bc
        p_new = p0 + dp

        out = (
            u_new,
            p_new,
            jnp.stack([u0, ulag0[0]]),
            jnp.stack([E0, nlag0[0]]),
        )

        # ---- temperature / passive scalars ------------------------------
        # advection-diffusion Helmholtz solves, one per scalar (the
        # reference's heat solver inside nek_advance; diffusivities play the
        # role of 1/(Re Pr) etc.).  Convected by u^n (same EXTk treatment as
        # the momentum convection).
        if self.nscal:
            ET0 = self._explicit_scalar(u0, T0, time, fcT=fcT)
            rhsT = (
                (1.0 / dt) * bm * (b[0] * T0 + b[1] * tlag0[0] + b[2] * tlag0[1])
                + a[0] * ET0 + a[1] * ntlag0[0] + a[2] * ntlag0[1]
            )
            tmask = s.tmask
            Ti = []
            for i, alpha in enumerate(self.scalar_diff):
                local = partial(s.helmholtz_local, h1=alpha, h2=h2)
                tb = self.t_bc[..., i]
                wT = elliptic_solve(
                    s,
                    local,
                    rhsT[..., i] - local(tb),
                    tmask,
                    tol=self.solver.scalar_tol,
                    maxiter=self.solver.scalar_maxiter,
                    diag_local=alpha * self._kdiag_local + h2 * s.bm,
                    fdm=(alpha, h2) if self.solver.fdm_precond else None,
                    fixed_iters=self.solver.cg_fixed_iters,
                )
                Ti.append(wT + tb)
            T_new = jnp.stack(Ti, axis=-1)
            out = out + (
                T_new,
                jnp.stack([T0, tlag0[0]]),
                jnp.stack([ET0, ntlag0[0]]),
            )
        if dp0 is not None:
            out = out + (dp,)
        return out

    # ------------------------------------------------------------------
    # mixed-precision inner solves (refinement route; see __init__)
    def _f32_pcg(self, op, precond, maxiter: int) -> Callable:
        """f32 PCG to the f32-reachable relative residual 3e-6 (dots
        accumulated in f64); takes and returns fields in the state dtype.
        Refinement in ops/cg.py supplies the remaining digits, so the caps
        stay bounded even under the reference's large safety maxiters."""

        def dot(a, b):
            return jnp.sum(a * b, dtype=jnp.float64).astype(jnp.float32)

        def solve(r):
            x = pcg(op, r.astype(jnp.float32), precond=precond, tol=3e-6,
                    maxiter=maxiter, dot=dot)
            return x.astype(r.dtype)

        return solve

    def _velocity_inner32(self, h2) -> Callable:
        """f32 subspace PCG of the assembled velocity Helmholtz system
        P (nu K + h2 B) P with the FDM preconditioner."""
        s32 = self._sem32
        h2 = jnp.asarray(h2, jnp.float32)
        P = make_projector(s32, s32.vmask)

        def A(w):
            return P(jnp.stack(
                [s32.helmholtz_local(w[..., d], self.nu, h2)
                 for d in range(w.shape[-1])], axis=-1,
            ))

        def M(r):
            return P(s32.fdm_apply(r, self.nu, h2))

        return self._f32_pcg(A, M, min(self.solver.velocity_maxiter, 100))

    def _pressure_inner32(self, u_like) -> Callable:
        """f32 PCG of the PnPn-2 pressure system E = D M^-1 D^T with the
        f64 path's preconditioner choice."""
        s32 = self._sem32
        E = _pressure_operator(
            s32, jax.ShapeDtypeStruct(u_like.shape, jnp.float32)
        )
        M = _pressure_precond(s32, self.solver.pressure_precond)
        return self._f32_pcg(E, M, min(self.solver.pressure_maxiter, 150))

    # ------------------------------------------------------------------
    def advance(self, state: FlowState, nsteps: int, dt=None) -> FlowState:
        """nsteps time steps as one ``lax.scan`` — one propagator apply."""

        def body(st, _):
            return self.step(st, dt=dt), None

        out, _ = jax.lax.scan(body, state, None, length=nsteps)
        return out

    def propagator(self, u0: jnp.ndarray, nsteps: int, time0: float = 0.0, dt=None) -> jnp.ndarray:
        """exp(T L)-style map on velocity fields: fresh state, integrate,
        return final velocity (the reference's matvec shape)."""
        st = self.make_state(u0, time=time0)
        return self.advance(st, nsteps, dt=dt).u
