"""Typed configuration — single tier replacing the reference's three tiers.

The reference splits configuration across (1) the Nek ``.par`` file
(``param(·)`` / ``uparam(1..10)``), (2) compiled-in defaults broadcast in
``nekStab_setDefault`` (reference core/main.f90:2-75), and (3) per-case
``nekStab_usrchk`` overrides compiled into the binary.  Here a single frozen
dataclass covers all of it; the ``uparam(1)`` mode table (reference
RELEASE.md:1-45, core/main.f90:138-251) survives only as the ``AnalysisMode``
enum for users coming from nekStab.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class AnalysisMode(enum.Enum):
    """The reference's uparam(1) dispatch codes (reference RELEASE.md:1-45)."""

    DNS = 0.0
    SFD = 1.1
    BOOSTCONV = 1.2
    DMT = 1.3
    TDF = 1.4
    NEWTON_FIXED_POINT = 2.0
    NEWTON_UPO = 2.1
    NEWTON_FORCED_UPO = 2.2
    DIRECT = 3.1
    DIRECT_FLOQUET = 3.11
    ADJOINT = 3.2
    ADJOINT_FLOQUET = 3.21
    TRANSIENT_GROWTH = 3.3
    TRANSIENT_GROWTH_FLOQUET = 3.31
    RESOLVENT = 3.4
    RESOLVENT_FLOQUET = 3.41
    POSTPROC_ALL = 4.0
    POSTPROC_BUDGET = 4.1
    POSTPROC_WAVEMAKER = 4.2
    POSTPROC_BF_SENSITIVITY = 4.3
    POSTPROC_FORCE_SENSITIVITY = 4.41
    POSTPROC_DELTA_FORCING = 4.43


@dataclasses.dataclass(frozen=True)
class SpongeConfig:
    """Sponge-layer extents/strength (reference core/forcing.f90:82-252).

    The sponge damps both the *dynamics* (forcing term) and the *inner
    product* (the reference zeroes the masked mass matrix ``bm1s`` inside the
    sponge, core/forcing.f90:100-104)."""

    x_left: float = 0.0  # sponge width at the -x boundary (xLspg)
    x_right: float = 0.0  # xRspg
    y_left: float = 0.0
    y_right: float = 0.0
    z_left: float = 0.0
    z_right: float = 0.0
    strength: float = 0.0  # spng_st
    accel_fraction: float = 0.333  # acc_spg: rise fraction of the smooth step

    @property
    def active(self) -> bool:
        return self.strength != 0.0 and (
            self.x_left + self.x_right + self.y_left + self.y_right
            + self.z_left + self.z_right
        ) > 0.0


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Time-integration / inner-solver knobs (reference core/matvec.f90:1-52,
    examples/cylinder/1cyl.par)."""

    dt: Optional[float] = None  # None -> from target_cfl
    target_cfl: float = 0.5  # reference caps param(26) at 0.5 (matvec.f90:21)
    bdf_order: int = 3  # BDF3/EXT3 (reference uses Nek TORDER=3)
    pressure_tol: float = 1e-8  # .par pressure residualTol
    velocity_tol: float = 1e-9  # .par velocity residualTol
    scalar_tol: float = 1e-9  # temperature/passive-scalar Helmholtz solves
    pressure_maxiter: int = 2000
    velocity_maxiter: int = 500
    scalar_maxiter: int = 500
    dealias: bool = True  # over-integration of convection (Nek lxd = 3/2 lx1)
    fdm_precond: bool = True  # tensor-product fast-diagonalization element
    # preconditioner for the elliptic solves (ops/fdm.py); False -> Jacobi
    pressure_operator: str = "pnpn2"  # pressure formulation:
    # 'pnpn2' (default): pressure in DISCONTINUOUS P_{N-2} on Gauss points,
    #   E = D M^-1 D^T built from the discrete weak divergence D and its
    #   exact transpose — the reference's P_N/P_{N-2} SEM.  Discretely
    #   divergence-free projection (no splitting feedback can grow — the
    #   strong-gradient/weak-Laplacian mismatch is unstable on curved/
    #   graded elements), no spurious pressure modes, and the pressure
    #   solve needs no gather-scatter.
    # 'consistent': same-order continuous-pressure E operator (PnPn);
    #   consistent but ill-conditioned (spurious-mode tail).
    # 'laplacian': approximate projection with the weak Laplacian K
    #   (cheapest per iteration; only safe on affine meshes).
    finite_difference: bool = False  # evaluate the tangent map by finite
    # differences of the *nonlinear* stepper around the base flow instead of
    # the exact linearization (reference matvec.f90:246-379) — a cross-check
    # path; direct matvec only (FD has no adjoint)
    fd_order: int = 2  # central-difference order, 2 or 4
    warm_start: bool = True  # residual-correction warm start of the elliptic
    # solves from the previous step (velocity: from u^n; pressure: from the
    # carried dp) — Nek residualProj analog.  NOTE: tolerances then apply to
    # the *correction* solve, i.e. the absolute step accuracy improves at
    # equal tol; loosen tol to trade that margin back into speed.
    pressure_precond: str = "fdm"  # preconditioner for the PnPn-2 pressure
    # solve (ops/schwarz.py; measured iteration counts to 1e-5, round 4 —
    # quick-BFS / graded-Barkley-BFS / cylinder-O-mesh):
    # 'fdm'     — two-level box-FDM + Q1 coarse (232 / 1779 / 86): adequate
    #   on mild meshes, collapses on graded/stretched elements (the
    #   axis-aligned-box assumption breaks);
    # 'block'   — EXACT element-diagonal blocks of E + Q1 coarse
    #   (68 / 309 / 41): mesh-robust local solves, extraction via
    #   graph-colored operator applies;
    # 'schwarz' — overlapping element+face-neighbor patch solves (exact
    #   restrictions of E) + P0 element-constant coarse + Q1 vertex coarse
    #   (20 / 53 / 19): the equivalent of Nek5000's overlapping
    #   Schwarz + XXT hierarchy (SURVEY.md section 2.2); setup = one
    #   colored sparse-E extraction + host patch inversion per mesh.
    # The sharded (multi-chip) path supports 'fdm' and 'block' (element-
    # local applies); 'schwarz' patches gather across element boundaries
    # and currently fall back to 'block' under shard_map.
    pressure_patch_overlap: str = "face"  # 'schwarz' patch extent: 'face'
    # (element + face neighbors) or 'node' (+ vertex-diagonal neighbors —
    # ~2x patch cost, a few fewer iterations on strongly graded meshes:
    # 53 -> 49 on the Barkley BFS mesh)
    velocity_precond: str = "fdm"  # velocity Helmholtz preconditioner:
    # 'fdm' (box tensor-product, default) or 'block' (exact element-
    # diagonal blocks of the ASSEMBLED P(h1 K + h2 B)P, ops/schwarz.py —
    # built for the final BDF stage's h2; single-device only, falls back
    # to 'fdm' under shard_map)
    pressure_direct: bool = False  # precondition the PnPn-2 pressure solve
    # with a dense exact inverse of E (lanes path only; ops/lanes.py
    # direct_pressure_inv) — CG converges in 1-2 iterations.  For small
    # fixtures (<~25k pressure dofs) on meshes where the two-level FDM+Q1
    # preconditioner degrades (graded/stretched elements, e.g. the BFS
    # fixture).  Build cost: N operator applies + one host inversion.
    mixed_ir_cycles: int = 2  # refinement cycles of the mixed-precision
    # stepper (f64-residual corrections around f32 inner solves,
    # stepper/navier_stokes.py); each cycle contracts the solve error by the
    # inner relative accuracy (~1e-5).  On the flagship matvec, cycles=1
    # drifted 7.7e-6 and cycles=2 1.5e-10 against cycles=3 — two cycles sit
    # in the reference's 1e-8..1e-10 tolerance class
    cg_fixed_iters: bool = False  # run the elliptic CG solves for EXACTLY
    # maxiter iterations under lax.fori_loop: no early-exit condition, no
    # live mask, 2 dots/iteration instead of 4, and no data-dependent loop
    # predicate per iteration.  With the iteration caps set at the measured
    # accuracy knee the tolerance is never reached anyway.  Only enable
    # with capped maxiters — with large maxiter this wastes iterations past
    # convergence (and lets f32 CG drift beyond its attainable accuracy).
    lanes_layout: bool = False  # run the elliptic CG iterations in the
    # lanes layout (n^2, nelem) — the element axis is the minor (vector)
    # dimension instead of the small (n, n) tiles (ops/lanes.py).  Exactly
    # the same operators up to an orthogonal permutation; off by default so
    # sharded-vs-single bitwise tests compare identical iteration paths
    # (2-D single-device only; silently ignored elsewhere).


@dataclasses.dataclass(frozen=True)
class KrylovConfig:
    """Eigensolver / Krylov knobs (reference core/main.f90:9-30)."""

    k_dim: int = 100  # Krylov subspace dimension
    schur_tgt: int = 2  # number of eigenpairs targeted per Schur restart
    eigen_tol: float = 1e-6  # Ritz residual tolerance
    schur_del: float = 0.10  # |lambda| >= 1 - schur_del selection band
    maxmodes: int = 20  # max converged modes written to disk
    max_restarts: int = 50
    seed: str = "noise"  # 'noise' | 'symmetric' | 'load' | 'baseflow'
    checkpoint: bool = False  # outpost (basis, H) each iteration (ifres)


@dataclasses.dataclass(frozen=True)
class NewtonConfig:
    """Newton-Krylov knobs (reference core/newton_krylov.f90)."""

    max_iter: int = 100
    tol: float = 1e-10
    gmres_restarts: int = 100
    dynamic_tol: bool = True  # spec_tole scheduling (newton_krylov.f90:408-435)
    finite_difference: bool = False  # Frechet derivative by FD instead of jvp
    fd_order: int = 2  # central-difference order, 2 or 4 (matvec.f90:246-379)
    fd_epsilon: float = 1e-6  # epsilon_base


@dataclasses.dataclass(frozen=True)
class SFDConfig:
    """Selective frequency damping (reference core/fixedp.f90:124-216)."""

    gain: float = -0.05  # forcing gain (chi); negative as in reference
    cutoff: float = 0.05  # filter cutoff frequency (Delta = 1/cutoff)
    tol: float = 1e-9


@dataclasses.dataclass(frozen=True)
class BoostConvConfig:
    """BoostConv accelerator (reference core/fixedp.f90:218-329)."""

    skip: int = 10  # bst_skp
    subspace: int = 10  # bst_snp


@dataclasses.dataclass(frozen=True)
class Config:
    """Top-level run configuration."""

    reynolds: float = 50.0
    mode: AnalysisMode = AnalysisMode.DNS
    end_time: float = 1.0  # horizon T of the propagator exp(T L)
    num_steps: Optional[int] = None  # None -> ceil(end_time / dt)
    solver: SolverConfig = SolverConfig()
    krylov: KrylovConfig = KrylovConfig()
    newton: NewtonConfig = NewtonConfig()
    sfd: SFDConfig = SFDConfig()
    boostconv: BoostConvConfig = BoostConvConfig()
    sponge: SpongeConfig = SpongeConfig()
    floquet: bool = False  # periodic base flow (orbit stored & replayed)
    store_orbit: bool = True  # ifstorebase
    output_dir: str = "."
    session: str = "run"

    @property
    def viscosity(self) -> float:
        return 1.0 / self.reynolds

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
