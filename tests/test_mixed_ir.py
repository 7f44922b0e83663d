"""Mixed-precision stepper, refinement route: f64 state on the PnPn-2
scheme, both inner solves refined around f32 subspace PCG on an f32 copy of
the SEM (stepper/navier_stokes.py, ops/cg.py).  Each solve, the step and the
tangent matvec must match the plain f64 path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nekstab_next_tpu.config import SolverConfig
from nekstab_next_tpu.mesh import cylinder_mesh
from nekstab_next_tpu.ops import SEM
from nekstab_next_tpu.ops.cg import cg_solve
from nekstab_next_tpu.ops.elliptic import elliptic_solve, make_projector
from nekstab_next_tpu.stepper import NavierStokes
from nekstab_next_tpu.stepper.linearized import LinearizedOperator
from nekstab_next_tpu.stepper.navier_stokes import (
    _pressure_operator, _pressure_precond,
)

NU, DT = 1.0 / 40.0, 0.01
SOLVER = SolverConfig(pressure_tol=1e-10, velocity_tol=1e-11,
                      pressure_maxiter=500, velocity_maxiter=200,
                      pressure_precond="block")


@pytest.fixture(scope="module")
def mesh():
    return cylinder_mesh(nr=4, ntheta=8, order=6, outer_radius=10.0)


@pytest.fixture(scope="module")
def pair(mesh):
    """(plain f64 stepper, mixed-precision stepper) on twin SEMs."""
    ns64 = NavierStokes(SEM(mesh), viscosity=NU, dt=DT, solver=SOLVER)
    nsmx = NavierStokes(SEM(mesh), viscosity=NU, dt=DT, solver=SOLVER,
                        mixed_precision=True)
    assert nsmx._sem32 is not None and nsmx.mixed is None
    assert nsmx._sem32.dtype == jnp.float32
    assert nsmx._sem32.pblock_inv.dtype == jnp.float32
    return ns64, nsmx


def _rel(a, b):
    return float(jnp.max(jnp.abs(a - b)) / jnp.max(jnp.abs(b)))


def test_velocity_subspace_solve_matches_f64(pair):
    _, ns = pair
    s = ns.sem
    h2 = (11.0 / 6.0) / DT
    rng = np.random.default_rng(0)
    rhs = jnp.asarray(rng.standard_normal(s.bm.shape + (2,)))

    def helm(w):
        return jnp.stack([s.helmholtz_local(w[..., d], NU, h2)
                          for d in range(2)], axis=-1)

    kw = dict(tol=1e-13, maxiter=400, fdm=(NU, h2))
    x64 = elliptic_solve(s, helm, rhs, s.vmask, **kw)
    x_ir = elliptic_solve(s, helm, rhs, s.vmask, **kw,
                          inner_solve=ns._velocity_inner32(h2),
                          ir_cycles=ns._ir_cycles)
    assert x_ir.dtype == jnp.float64
    err = _rel(x_ir, x64)
    assert err < 1e-9, err


def test_pressure_subspace_solve_matches_f64(pair):
    _, ns = pair
    s = ns.sem
    u_like = jax.ShapeDtypeStruct(s.bm.shape + (2,), s.dtype)
    E = _pressure_operator(s, u_like)
    rng = np.random.default_rng(1)
    rhs = jnp.asarray(rng.standard_normal(s.p_shape))
    dot = lambda a, b: jnp.sum(a * b)

    kw = dict(precond=_pressure_precond(s, "block"), tol=1e-13, maxiter=600,
              dot=dot)
    x64 = cg_solve(E, rhs, **kw)
    x_ir = cg_solve(E, rhs, **kw, inner_solve=ns._pressure_inner32(u_like),
                    ir_cycles=ns._ir_cycles)
    err = _rel(x_ir, x64)
    assert err < 1e-9, err


def test_refinement_needs_a_cycle():
    with pytest.raises(ValueError):
        cg_solve(lambda x: x, jnp.ones(3), inner_solve=lambda r: r,
                 ir_cycles=0)


def test_mixed_step_matches_f64(pair):
    outs = []
    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.standard_normal(pair[0].sem.bm.shape + (2,)))
    for ns in pair:
        st = ns.make_state(0.05 * ns.sem.vmask * u)
        st = jax.jit(lambda s, ns=ns: ns.advance(s, 3))(st)
        assert st.u.dtype == jnp.float64
        outs.append(st.u)
    err = _rel(outs[1], outs[0])
    assert err < 1e-8, err


def test_mixed_tangent_matches_f64(pair):
    # the tangent (jvp) of the step re-solves through the SAME refined
    # solve callback: the linearized propagators must agree
    outs = []
    shape = pair[0].sem.bm.shape + (2,)
    base = jnp.zeros(shape).at[..., 0].set(1.0)
    rng = np.random.default_rng(5)
    q = jnp.asarray(rng.standard_normal(shape))
    for ns in pair:
        op = LinearizedOperator(ns, ns.sem.vmask * base, nsteps=3)
        outs.append(op.matvec(ns.sem.vmask * q))
    err = _rel(outs[1], outs[0])
    assert err < 1e-8, err


def test_mixed_falls_back_to_legacy_off_pnpn2(mesh):
    # the GLL-grid schemes keep the legacy f32 inner-CG route (ops/mixed.py)
    ns = NavierStokes(SEM(mesh), viscosity=NU, dt=DT, mixed_precision=True,
                      solver=SolverConfig(pressure_operator="laplacian"))
    assert ns._sem32 is None and ns.mixed is not None
    assert ns.p_shape == ns.sem.bm.shape


def test_sem_astype_casts_floats_only(mesh):
    s = SEM(mesh)
    s.setup_pressure_blocks()
    s32 = s.astype(jnp.float32)
    assert s32.bm.dtype == jnp.float32 and s32.D.dtype == jnp.float32
    assert s32.pblock_inv.dtype == jnp.float32
    assert s32.gid.dtype == s.gid.dtype and s32.pc_cid.dtype == jnp.int32
    assert s.bm.dtype == jnp.float64  # the source is untouched
    P = make_projector(s32, s32.vmask)
    x = jnp.ones(s.bm.shape + (2,), jnp.float32)
    assert P(x).dtype == jnp.float32
