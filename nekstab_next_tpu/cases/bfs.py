"""Backward-facing-step case — the reference's quantitative regression
fixture (examples/back_fstep: Re=500 transient growth vs Barkley, Blackburn
& Sherwin 2008 fig. 5, digitized in barkley2008_fig5.ref).

Geometry (Barkley et al. 2008): step height h = 1, inflow channel height 1
(y in [0, 1], x < 0), downstream channel height 2 (y in [-1, 1]), expansion
ratio 2.  Parabolic inflow with peak velocity 1; Re = U_peak h / nu."""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..config import SolverConfig
from ..mesh.box import box_mesh_2d
from ..mesh.mesh import BoundaryCondition as BC
from ..ops.core import SEM
from ..stepper.navier_stokes import NavierStokes


def _geometric_breaks(x0: float, x1: float, nel: int, h_at_x0: float) -> np.ndarray:
    """nel-element breakpoints on [x0, x1], geometrically grown from a first
    cell of width ``h_at_x0`` at x0 (the reference mesh refines this way into
    the step corner — its first downstream cell is 0.1 step heights wide)."""
    L = x1 - x0
    if h_at_x0 * nel >= L:  # uniform already finer than requested
        return np.linspace(x0, x1, nel + 1)
    # solve h*(g^nel - 1)/(g - 1) = L for the growth factor g > 1
    g_lo, g_hi = 1.0 + 1e-12, 10.0
    for _ in range(80):
        g = 0.5 * (g_lo + g_hi)
        tot = h_at_x0 * (g ** nel - 1.0) / (g - 1.0)
        if tot < L:
            g_lo = g
        else:
            g_hi = g
    sizes = h_at_x0 * g ** np.arange(nel)
    sizes *= L / sizes.sum()
    return x0 + np.concatenate([[0.0], np.cumsum(sizes)])


@dataclasses.dataclass
class BackwardFacingStepCase:
    reynolds: float = 500.0
    inflow_length: float = 10.0
    outflow_length: float = 50.0
    order: int = 6
    elems_upstream: int = 8
    elems_downstream: int = 40
    elems_y: int = 8  # over the full height [-1, 1]
    dt: Optional[float] = None
    target_cfl: float = 0.5
    solver: SolverConfig = SolverConfig()
    dtype: object = jnp.float64  # SEM arithmetic dtype (f32: the single-precision path)
    step_dx: Optional[float] = None  # first-cell width at the step corner;
    # None -> uniform spacing (coarse presets).  The reference fixture grades
    # to 0.1 there (examples/back_fstep/transient_growth/bfs.re2).
    sponge: bool = False  # reference TG setup: left/right sponges damping
    # perturbations, widths (5, 10), strength 2, with the inner-product
    # weight zeroed inside (examples/back_fstep/transient_growth/bfs.par
    # userparam08-10; core/forcing.f90:82-252)
    sponge_left: float = 5.0
    sponge_right: float = 10.0
    sponge_strength: float = 2.0

    def __post_init__(self):
        nx = self.elems_upstream + self.elems_downstream
        if self.step_dx is not None:
            up = _geometric_breaks(
                0.0, self.inflow_length, self.elems_upstream, self.step_dx
            )
            bx = np.concatenate([
                (-up[::-1])[:-1],
                _geometric_breaks(0.0, self.outflow_length,
                                  self.elems_downstream, self.step_dx),
            ])
        else:
            # uniform upstream, uniform downstream (legacy coarse layout)
            bx = np.concatenate([
                np.linspace(-self.inflow_length, 0.0,
                            self.elems_upstream + 1)[:-1],
                np.linspace(0.0, self.outflow_length,
                            self.elems_downstream + 1),
            ])
        self.mesh = box_mesh_2d(
            nx,
            self.elems_y,
            order=self.order,
            x0=-self.inflow_length,
            x1=self.outflow_length,
            y0=-1.0,
            y1=1.0,
            bc={
                "left": BC.DIRICHLET,
                "right": BC.OUTFLOW,
                "bottom": BC.WALL,
                "top": BC.WALL,
            },
            grading_x=bx,
            mask=lambda xc, yc: xc < 0.0 and yc < 0.0,  # carve the step
            mask_bc=BC.WALL,
        )
        m = self.mesh
        self.sem = SEM(m, dtype=self.dtype)

        # parabolic inflow u(y) = 4 y (1-y) on the upper channel
        ubc = np.zeros(m.x.shape + (2,))
        inflow = m.dirichlet_nodes & np.isclose(m.x, -self.inflow_length)
        yv = m.y
        ubc[..., 0] = np.where(inflow, np.clip(4.0 * yv * (1.0 - yv), 0.0, None), 0.0)
        self.u_bc = jnp.asarray(ubc)

        # sponge layers (reference TG fixture: widths 5/10, strength 2, with
        # bm1s zeroed inside so the energy norm excludes the damped zones)
        if self.sponge:
            from .cylinder import smooth_step

            xl = -self.inflow_length + self.sponge_left
            xr = self.outflow_length - self.sponge_right
            lam = np.zeros_like(m.x)
            if self.sponge_left > 0:
                lam += smooth_step((xl - m.x) / self.sponge_left)
            if self.sponge_right > 0:
                lam += smooth_step((m.x - xr) / self.sponge_right)
            self.sem.set_sponge(self.sponge_strength * lam)

        if self.dt is None:
            self.dt = float(self.target_cfl * m.min_spacing() / 1.5)

    def make_ns(self, sponge_ref=None) -> NavierStokes:
        """``sponge_ref`` (with ``sponge=True``): field the sponge damps
        toward — pass the steady base flow so it stays an equilibrium of the
        sponged system while perturbations are damped (reference
        forcing.f90:35-50 damps toward the stored base)."""
        return NavierStokes(
            self.sem,
            viscosity=1.0 / self.reynolds,
            dt=self.dt,
            u_bc=self.u_bc,
            solver=self.solver,
            sponge_ref=sponge_ref,
        )

    def initial_flow(self) -> jnp.ndarray:
        """Smooth initial condition: inflow profile extended downstream
        (upper-channel profile relaxing to the full-height parabola).

        The blend starts strictly AT the step (w = 0 for x <= 0): letting
        the full-height profile leak upstream puts O(1) velocity onto the
        first GLL layer above the upstream bottom wall — on a corner-graded
        mesh that near-wall shear spike blows the march up within ~70 steps
        (diagnosed round 3)."""
        from .cylinder import smooth_step

        m = self.mesh
        y = m.y
        up = np.clip(4.0 * y * (1.0 - y), 0.0, None)  # upstream profile
        dn = np.clip((1.0 + y) * (1.0 - y), 0.0, None)  # full-height profile
        w = smooth_step(m.x / 4.0)  # 0 for x <= 0, 1 beyond x = 4
        u = (1.0 - w) * up + w * dn
        vel = np.stack([u, np.zeros_like(u)], axis=-1)
        return jnp.asarray(vel) * self.sem.vmask + self.u_bc
