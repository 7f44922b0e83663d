"""f32 Helmholtz apply + legacy mixed-precision iterative refinement
(ops/mixed.py).

The f32 apply runs on an f32 copy of the SEM (``SEM.astype``) at HIGHEST
matmul precision; numerics are checked against the f64 ``helmholtz_local``
and the f64 assembled solve of ops/elliptic.py."""

import jax.numpy as jnp
import numpy as np
import pytest

from nekstab_next_tpu.mesh import box_mesh_2d, box_mesh_3d
from nekstab_next_tpu.ops.core import SEM
from nekstab_next_tpu.ops.core3 import SEM3
from nekstab_next_tpu.ops.elliptic import elliptic_solve
from nekstab_next_tpu.ops.mixed import MixedPrecision, elliptic_solve_mixed


@pytest.fixture(scope="module")
def sem2():
    mesh = box_mesh_2d(3, 3, order=6, grading_x=1.3)
    return SEM(mesh)


def test_fused_helmholtz_2d_matches_einsum(sem2):
    mixed = MixedPrecision(sem2)
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal((sem2.nelem, sem2.n, sem2.n)))
    ref = sem2.helmholtz_local(u, 0.7, 1.3)
    got = mixed.helmholtz32(u.astype(jnp.float32), 0.7, 1.3)
    assert got.dtype == jnp.float32
    scale = float(jnp.max(jnp.abs(ref)))
    assert np.allclose(np.asarray(got), np.asarray(ref), atol=2e-5 * scale)


def test_fused_helmholtz_3d_matches_einsum():
    mesh = box_mesh_3d(2, 2, 2, order=4)
    sem = SEM3(mesh)
    mixed = MixedPrecision(sem)
    rng = np.random.default_rng(1)
    u = jnp.asarray(rng.standard_normal((sem.nelem,) + (sem.n,) * 3))
    ref = sem.helmholtz_local(u, 1.0, 0.4)
    got = mixed.helmholtz32(u.astype(jnp.float32), 1.0, 0.4)
    assert got.dtype == jnp.float32
    scale = float(jnp.max(jnp.abs(ref)))
    assert np.allclose(np.asarray(got), np.asarray(ref), atol=2e-5 * scale)


def test_mixed_precision_refinement_matches_f64(sem2):
    """IR with f32 inner CG reaches the f64 solution of the assembled
    Dirichlet Helmholtz problem well beyond f32 accuracy."""
    sem = sem2
    mixed = MixedPrecision(sem)
    rng = np.random.default_rng(2)
    rhs = sem.bm * jnp.asarray(rng.standard_normal((sem.nelem, sem.n, sem.n)))
    mask = sem.tmask  # scalar Dirichlet mask
    h1, h2 = 1.0, 0.5

    x64 = elliptic_solve(
        sem, lambda u: sem.helmholtz_local(u, h1, h2), rhs, mask,
        tol=1e-12, maxiter=400, diag_local=h1 * sem.stiffness_diag() + h2 * sem.bm,
    )
    x_ir = elliptic_solve_mixed(sem, mixed, h1, h2, rhs, mask, maxiter=400)
    err = float(jnp.max(jnp.abs(x_ir - x64)) / jnp.max(jnp.abs(x64)))
    assert err < 1e-9, err


def test_mixed_precision_pressure_poisson(sem2):
    """Pure-Neumann Poisson (nullspace projection + Q1 coarse level in f32)."""
    sem = sem2
    mixed = MixedPrecision(sem)
    rng = np.random.default_rng(3)
    raw = jnp.asarray(rng.standard_normal((sem.nelem, sem.n, sem.n)))
    rhs = sem.bm * (raw - sem.mean(raw))  # compatible RHS
    mask = sem.pmask

    x64 = elliptic_solve(
        sem, sem.stiffness_local, rhs, mask, tol=1e-12, maxiter=600,
        diag_local=sem.stiffness_diag(), project_mean=True,
    )
    x_ir = elliptic_solve_mixed(
        sem, mixed, 1.0, 0.0, rhs, mask, maxiter=600,
        project_mean=True, coarse=True, cycles=4,
    )
    err = float(jnp.max(jnp.abs(x_ir - x64)) / jnp.max(jnp.abs(x64)))
    assert err < 1e-8, err


def test_mixed_precision_full_step():
    """One NS step with mixed-precision solves matches the f64 step."""
    from nekstab_next_tpu.stepper.navier_stokes import NavierStokes
    from nekstab_next_tpu.stepper.state import initial_state

    mesh = box_mesh_2d(3, 3, order=5, x1=2 * np.pi, y1=2 * np.pi,
                       periodic_x=True, periodic_y=True)
    sem_a, sem_b = SEM(mesh), SEM(mesh)
    u0 = jnp.asarray(
        np.stack([-np.cos(mesh.x) * np.sin(mesh.y),
                  np.sin(mesh.x) * np.cos(mesh.y)], axis=-1)
    )
    from nekstab_next_tpu.config import SolverConfig

    # the legacy mixed route serves the GLL-grid schemes — compare
    # like-for-like (PnPn-2 refines instead: tests/test_mixed_ir.py)
    laplacian = SolverConfig(pressure_operator="laplacian")
    ns64 = NavierStokes(sem_a, viscosity=0.05, dt=0.01, solver=laplacian)
    nsmx = NavierStokes(sem_b, viscosity=0.05, dt=0.01, solver=laplacian,
                        mixed_precision=True)
    assert nsmx.mixed is not None

    a = ns64.step(ns64.make_state(u0))
    b = nsmx.step(nsmx.make_state(u0))
    du = float(jnp.max(jnp.abs(a.u - b.u)))
    scale = float(jnp.max(jnp.abs(a.u)))
    assert du < 1e-8 * scale, du
