"""Fast-diagonalization (FDM) element preconditioner + Q1 coarse level.

JAX-native stand-in for the overlapping-Schwarz/FDM preconditioners and the
XXT coarse solve the reference inherits from Nek5000 (SURVEY.md section 2.2).
Checks: symmetry/positivity of the preconditioner (a CG requirement), and an
iteration-count win over Jacobi on the deformed cylinder mesh for both the
pure-Neumann pressure Poisson and the velocity Helmholtz solve.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from nekstab_next_tpu.mesh import cylinder_mesh
from nekstab_next_tpu.ops import SEM
from nekstab_next_tpu.ops.cg import pcg
from nekstab_next_tpu.ops.elliptic import make_projector


@pytest.fixture(scope="module")
def cyl():
    mesh = cylinder_mesh(nr=6, ntheta=16, order=6, outer_radius=15.0)
    return mesh, SEM(mesh)


def _setup_poisson(sem, mask):
    P = make_projector(sem, mask)

    def A(x):
        Px = P(x)
        return P(sem.stiffness_local(Px)) + (x - Px)

    dot = lambda a, b: jnp.sum(a * b)
    return P, A, dot


def test_fdm_apply_symmetric_positive(cyl):
    mesh, sem = cyl
    rng = np.random.default_rng(3)
    r = jnp.asarray(rng.standard_normal(mesh.x.shape))
    s = jnp.asarray(rng.standard_normal(mesh.x.shape))
    h1, h2 = 1.0, 0.7
    a = float(jnp.sum(s * sem.fdm_apply(r, h1, h2)))
    b = float(jnp.sum(r * sem.fdm_apply(s, h1, h2)))
    assert abs(a - b) < 1e-10 * max(abs(a), 1.0)
    assert float(jnp.sum(r * sem.fdm_apply(r, h1, h2))) > 0.0


def test_coarse_apply_symmetric(cyl):
    mesh, sem = cyl
    rng = np.random.default_rng(4)
    r = jnp.asarray(rng.standard_normal(mesh.x.shape))
    s = jnp.asarray(rng.standard_normal(mesh.x.shape))
    a = float(jnp.sum(s * sem.coarse_apply_pressure(r)))
    b = float(jnp.sum(r * sem.coarse_apply_pressure(s)))
    assert abs(a - b) < 1e-10 * max(abs(a), 1.0)


def _solve_both(sem, local_op, rhs_local, mask, h1, h2, coarse, project_mean):
    """Return (x_jac, it_jac, x_fdm, it_fdm) for the same assembled system."""
    P = make_projector(sem, mask)

    def A(x):
        Px = P(x)
        return P(local_op(Px)) + (x - Px)

    rhs = P(rhs_local)
    dot = lambda a, b: jnp.sum(a * b)

    project = None
    if project_mean:
        ones = jnp.ones_like(rhs)
        csq = float(dot(ones, ones))

        def project(q):
            return q - (dot(q, ones) / csq) * ones

        rhs = project(rhs)

    dinv = 1.0 / sem.dssum(h1 * sem.stiffness_diag() + h2 * sem.bm)
    if dinv.ndim < rhs.ndim:
        dinv = dinv.reshape(dinv.shape + (1,) * (rhs.ndim - dinv.ndim))

    def jac(r):
        Pr = P(r)
        return P(dinv * Pr) + (r - Pr)

    def fdm(r):
        Pr = P(r)
        z = sem.fdm_apply(Pr, h1, h2)
        if coarse:
            z = z + sem.coarse_apply_pressure(Pr)
        return P(z) + (r - Pr)

    out = {}
    for name, pc in (("jac", jac), ("fdm", fdm)):
        x, k = pcg(A, rhs, precond=pc, tol=1e-10, maxiter=3000, dot=dot,
                   return_iters=True)
        if project is not None:
            x = project(x)
        out[name] = (x, int(k))
    return out


def test_fdm_beats_jacobi_on_pressure_poisson(cyl):
    mesh, sem = cyl
    rng = np.random.default_rng(5)
    # cylinder has an outflow -> pressure Dirichlet at the outlet, so the
    # Poisson operator is non-singular (mesh.has_pressure_dirichlet)
    mask = jnp.asarray(mesh.pmask)
    rhs_local = sem.bm * jnp.asarray(rng.standard_normal(mesh.x.shape))
    out = _solve_both(sem, sem.stiffness_local, rhs_local, mask,
                      1.0, 0.0, coarse=True, project_mean=False)
    x_j, it_j = out["jac"]
    x_f, it_f = out["fdm"]
    rel = float(jnp.linalg.norm(x_f - x_j) / jnp.linalg.norm(x_j))
    assert rel < 1e-6
    # the two-level FDM must cut iterations at least 2x on this mesh
    assert it_f * 2 <= it_j, (it_f, it_j)


def test_fdm_beats_jacobi_on_velocity_helmholtz(cyl):
    mesh, sem = cyl
    rng = np.random.default_rng(6)
    mask = jnp.asarray(mesh.vmask)  # carries the velocity-component axis
    h1, h2 = 1.0 / 60.0, 1.5 / 1e-2  # nu K + (bd0/dt) B at cylinder scales
    rhs_local = sem.bm[..., None] * jnp.asarray(
        rng.standard_normal(mesh.x.shape + (2,))
    )

    def op(u):
        return jnp.stack(
            [sem.helmholtz_local(u[..., d], h1, h2) for d in range(2)], axis=-1
        )

    out = _solve_both(sem, op, rhs_local, mask, h1, h2,
                      coarse=False, project_mean=False)
    x_j, it_j = out["jac"]
    x_f, it_f = out["fdm"]
    rel = float(jnp.linalg.norm(x_f - x_j) / jnp.linalg.norm(x_j))
    assert rel < 1e-7
    assert it_f <= it_j, (it_f, it_j)
