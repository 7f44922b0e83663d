"""Core spectral-element operators on ``(nelem, n, n)`` fields.

JAX-native replacements for the Nek5000 operator layer the reference uses
(SURVEY.md section 2.2): tensor-product derivatives (``gradm1``), the
gather-scatter direct-stiffness sum (gslib ``dssum/dsavg``), mass-weighted
global inner products (``glsc3`` + MPI all-reduce), weak Laplacian/Helmholtz
applies, and dealiased convection (``convect_new`` with the 3/2 rule).

Design:

* Per-element operators are batched dense contractions (``einsum`` over the
  element axis) that XLA fuses; a fused element kernel can replace the
  einsums later without touching callers.
* ``dssum`` is a segment-sum into the global-node vector followed by a
  gather.  Under SPMD (``shard_map`` over the element axis) the global-node
  vector is psum-reduced across devices — the XLA-collective equivalent of
  gslib's neighbor exchange.  ``axis_name=None`` means single-device.
* All reductions accept ``axis_name`` so the same code runs single-chip and
  under a device mesh.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..mesh.gll import (
    diff_matrix,
    gauss_points_weights,
    gll_points_weights,
    lagrange_interp_matrix,
)
from ..mesh.mesh import Mesh2D


class SEM:
    """Device-resident spectral-element operator context for one mesh.

    Holds jnp copies of the mesh's precomputed factors; all methods are pure
    (jit/vmap/grad-safe) and close over these arrays as constants.
    """

    ndim = 2

    def __init__(self, mesh: Mesh2D, dtype=jnp.float64, axis_name: Optional[str] = None):
        self.mesh = mesh
        self.dtype = dtype
        self.axis_name = axis_name
        n = mesh.n
        self.n = n
        self.nelem = mesh.nelem
        self.nglobal = mesh.nglobal

        f = lambda a: jnp.asarray(a, dtype=dtype)
        self.D = f(diff_matrix(n))
        _, w = gll_points_weights(n)
        self.w = f(w)
        self.gid = jnp.asarray(mesh.gid.reshape(-1), dtype=jnp.int32)
        self.rx, self.ry = f(mesh.rx), f(mesh.ry)
        self.sx, self.sy = f(mesh.sx), f(mesh.sy)
        self.jac = f(mesh.jac)
        self.bm = f(mesh.bm)
        self.g11, self.g12, self.g22 = f(mesh.g11), f(mesh.g12), f(mesh.g22)
        self.vmask = f(mesh.vmask)
        self.pmask = f(mesh.pmask)
        self.tmask = f(mesh.tmask)
        # sponge-masked inner-product weight (reference bm1s, core/NEKSTAB:86);
        # starts equal to bm and is overwritten by set_sponge_mask().
        self.bms = self.bm
        self.sponge = jnp.zeros_like(self.bm)  # sponge strength field lambda(x)

        # assembled inverse mass and multiplicity (host-assembled, exact)
        bmg = np.zeros(mesh.nglobal)
        np.add.at(bmg, mesh.gid.reshape(-1), mesh.bm.reshape(-1))
        self.binv_assembled = f(1.0 / bmg[mesh.gid])
        self.inv_mult = f(1.0 / mesh.mult)

        # dealiasing (3/2 over-integration) operators
        nd = int(math.ceil(3 * n / 2))
        self.nd = nd
        zf, wf = gauss_points_weights(nd)
        zc, _ = gll_points_weights(n)
        J = lagrange_interp_matrix(zc, zf)  # (nd, n)
        self.Jd = f(J)
        self.wf2 = f(np.outer(wf, wf))
        # fine-grid metrics/jacobian by interpolation of the coarse nodal ones
        interp2 = lambda a: np.einsum("ai,bj,eij->eab", J, J, a)
        self.jac_d = f(interp2(mesh.jac))
        self.rx_d, self.ry_d = f(interp2(mesh.rx)), f(interp2(mesh.ry))
        self.sx_d, self.sy_d = f(interp2(mesh.sx)), f(interp2(mesh.sy))

        # PnPn-2 pressure space: P_{N-2} on (n-2)^2 Gauss points per element,
        # DISCONTINUOUS across elements (the reference's P_N/P_{N-2}
        # formulation, SURVEY.md L0).  No spurious pressure modes, and the
        # pressure solve needs no gather-scatter at all.
        npr = n - 2
        self.npr = npr
        zg_, wg_ = gauss_points_weights(npr)
        zc_, _ = gll_points_weights(n)
        Jp = lagrange_interp_matrix(zc_, zg_)  # (npr, n): GLL -> Gauss
        self.Jp = f(Jp)
        self.Jpg = f(lagrange_interp_matrix(zg_, zc_))  # Gauss -> GLL (postproc)
        interp2p = lambda a: np.einsum("ai,bj,eij->eab", Jp, Jp, a)
        self.bp = f(np.outer(wg_, wg_)) * f(interp2p(mesh.jac))

        # fast-diagonalization preconditioner setup (ops/fdm.py)
        from .fdm import coarse_setup, element_half_lengths_2d, fdm_eigensetup

        S_fdm, lam_fdm = fdm_eigensetup(n)
        self.fdm_S = f(S_fdm)
        self.fdm_lam = f(lam_fdm)
        self.fdm_len = f(element_half_lengths_2d(mesh))  # (nelem, 2)

        # Q1 vertex coarse level for the pressure Poisson (XXT equivalent)
        z, _ = gll_points_weights(n)
        cid, Jc, Acinv = coarse_setup(
            mesh.gid, (mesh.g11, mesh.g12, mesh.g22),
            diff_matrix(n), z, np.asarray(mesh.pmask),
        )
        self.pc_cid = jnp.asarray(cid, dtype=jnp.int32)
        self.pc_Jc = f(Jc)
        self.pc_Acinv = f(Acinv)
        self.pc_nc = int(Acinv.shape[0])

        # number of devices sharing the element axis (set by parallel wrapper)
        self.num_shards = 1
        # light metadata used device-side (so a shard view needs no Mesh2D)
        self.has_pressure_dirichlet = mesh.has_pressure_dirichlet
        # exact element-block / overlapping-Schwarz pressure preconditioners
        # (ops/schwarz.py); built on demand by setup_pressure_blocks() /
        # setup_pressure_schwarz()
        self.pblock_inv = None
        self.pschwarz = None
        self.p0Acinv = None
        self.vblock_inv = {}  # (h1, h2) -> velocity block inverses

    # ------------------------------------------------------------------
    # sharding support
    # ------------------------------------------------------------------
    _ELEM_FIELDS = (
        "rx", "ry", "sx", "sy", "jac", "bm", "bms", "sponge",
        "g11", "g12", "g22", "vmask", "pmask", "tmask",
        "binv_assembled", "inv_mult", "bp",
        "jac_d", "rx_d", "ry_d", "sx_d", "sy_d",
        "fdm_len", "pc_cid",
    )

    def elem_arrays(self) -> dict:
        """Per-element array pytree (leading axis = element, the sharded
        axis).  ``gid`` is reshaped to (nelem, n, n) for sharding."""
        d = {k: getattr(self, k) for k in self._ELEM_FIELDS}
        d["gid"] = self.gid.reshape(self.nelem, self.n, self.n)
        if self.pblock_inv is not None:
            d["pblock_inv"] = self.pblock_inv
        return d

    def shard_view(self, elem_arrays: dict, axis_name: str) -> "SEM":
        """Shallow view of this SEM with per-element arrays replaced by the
        given (device-local) slices and collectives enabled on ``axis_name``.
        Used inside ``shard_map``; all host-precomputed small operators
        (D, dealiasing matrices) are shared."""
        v = object.__new__(SEM)
        v.__dict__.update(self.__dict__)
        for k in self._ELEM_FIELDS:
            setattr(v, k, elem_arrays[k])
        v.gid = elem_arrays["gid"].reshape(-1)
        v.nelem = elem_arrays["gid"].shape[0]
        v.axis_name = axis_name
        v.pblock_inv = elem_arrays.get("pblock_inv")
        # host-built preconditioners whose setup is NOT element-local must
        # not leak into the shard view: 'schwarz' patch indices address the
        # full mesh, so JAX would clamp out-of-range gathers against
        # shard-local residuals and silently corrupt the preconditioner
        # (round-4 ADVICE).  The element-local exact blocks shard fine and
        # arrive through elem_arrays above.
        v.pschwarz = None
        v.p0Acinv = None
        v.vblock_inv = {}
        return v

    def astype(self, dtype) -> "SEM":
        """Shallow copy of this context with every floating array (geometry,
        operators, built preconditioners) cast to ``dtype``; integer index
        arrays and host metadata are shared.  The mixed-precision stepper
        runs its inner solves on an f32 copy of the f64 context."""

        def cast(a):
            if (isinstance(a, (jax.Array, np.ndarray))
                    and jnp.issubdtype(a.dtype, jnp.floating)):
                return jnp.asarray(a, dtype)
            return a

        v = object.__new__(type(self))
        v.__dict__.update(
            {k: jax.tree.map(cast, a) for k, a in self.__dict__.items()}
        )
        v.dtype = dtype
        return v

    # ------------------------------------------------------------------
    # gather-scatter
    # ------------------------------------------------------------------
    def dssum(self, u: jnp.ndarray) -> jnp.ndarray:
        """Direct-stiffness sum: add contributions of all elements sharing a
        global node, return the summed value at every local node.

        Equivalent of gslib ``dssum`` (reference utils.f90:287-343 uses it for
        noise smoothing; every elliptic solve needs it).

        Accepts trailing component axes: (nelem, n, n, ...)."""
        flat = u.reshape((self.gid.shape[0],) + u.shape[3:])
        g = jax.ops.segment_sum(flat, self.gid, num_segments=self.nglobal)
        if self.axis_name is not None:
            g = jax.lax.psum(g, self.axis_name)
        return g[self.gid].reshape(u.shape)

    @staticmethod
    def _bc(w: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
        """Broadcast a (nelem,n,n) weight against trailing component axes."""
        return w.reshape(w.shape + (1,) * (u.ndim - 3))

    def dsavg(self, u: jnp.ndarray) -> jnp.ndarray:
        """Multiplicity-weighted average at shared nodes (Nek ``dsavg``)."""
        return self.dssum(u) * self._bc(self.inv_mult, u)

    def dsavg_mass(self, u: jnp.ndarray) -> jnp.ndarray:
        """Mass-weighted average at shared nodes: B^-1_assembled dssum(B u).
        The projection onto the C0 space that is self-adjoint in the B inner
        product — used for the pressure-correction update."""
        return self._bc(self.binv_assembled, u) * self.dssum(self._bc(self.bm, u) * u)

    # ------------------------------------------------------------------
    # derivatives
    # ------------------------------------------------------------------
    def grad_ref(self, u: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Reference-element derivatives (u_xi, u_eta)."""
        ur = jnp.einsum("ai,eij->eaj", self.D, u)
        us = jnp.einsum("bj,eij->eib", self.D, u)
        return ur, us

    def grad(self, u: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Physical gradient (u_x, u_y) — the reference's ``gradm1``."""
        ur, us = self.grad_ref(u)
        return self.rx * ur + self.sx * us, self.ry * ur + self.sy * us

    def div(self, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
        ux, _ = self.grad(u)
        _, vy = self.grad(v)
        return ux + vy

    # vector-form aliases shared with SEM3 (dimension-agnostic stepper)
    def gradv(self, u: jnp.ndarray) -> jnp.ndarray:
        return jnp.stack(self.grad(u), axis=-1)

    def divv(self, u: jnp.ndarray) -> jnp.ndarray:
        return self.div(u[..., 0], u[..., 1])

    def convect(self, c: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
        return self.convect_weak(c[..., 0], c[..., 1], u)

    def convect_colloc_v(self, c: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
        return self.convect_colloc(c[..., 0], c[..., 1], u)

    def curl(self, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
        """z-vorticity dv/dx - du/dy (``comp_vort3`` 2-D)."""
        _, uy = self.grad(u)
        vx, _ = self.grad(v)
        return vx - uy

    # ------------------------------------------------------------------
    # weak-form elliptic operators (local, unassembled)
    # ------------------------------------------------------------------
    def stiffness_local(self, u: jnp.ndarray) -> jnp.ndarray:
        """Local weak Laplacian K u (integral of grad(phi).grad(u))."""
        ur, us = self.grad_ref(u)
        wr = self.g11 * ur + self.g12 * us
        ws = self.g12 * ur + self.g22 * us
        return jnp.einsum("ai,eaj->eij", self.D, wr) + jnp.einsum(
            "bj,eib->eij", self.D, ws
        )

    def stiffness_diag(self) -> jnp.ndarray:
        """Diagonal of the local stiffness (for Jacobi preconditioning)."""
        D2 = self.D * self.D
        d = jnp.einsum("ai,eaj->eij", D2, self.g11) + jnp.einsum(
            "bj,eib->eij", D2, self.g22
        )
        dd = jnp.diagonal(self.D)
        d = d + 2.0 * self.g12 * dd[:, None] * dd[None, :]
        return d

    def helmholtz_local(self, u: jnp.ndarray, h1, h2) -> jnp.ndarray:
        """Local weak Helmholtz: h1 * K u + h2 * B u  (Nek ``axhelm``)."""
        return h1 * self.stiffness_local(u) + h2 * self.bm * u

    def fdm_apply(self, r: jnp.ndarray, h1, h2) -> jnp.ndarray:
        """Approximate elementwise inverse of (h1 K + h2 B) via tensor-product
        fast diagonalization on each element's bounding box (ops/fdm.py).
        Symmetric positive definite — valid as a CG preconditioner block.

        Accepts trailing component axes: (nelem, n, n, ...)."""
        S, lam = self.fdm_S, self.fdm_lam
        a = self.fdm_len[:, 0][:, None, None]
        b = self.fdm_len[:, 1][:, None, None]
        denom = h1 * ((b / a) * lam[:, None] + (a / b) * lam[None, :]) + h2 * (a * b)
        # the Neumann constant mode (lam=0 twice) has denom ~ h2*ab; when h2=0
        # give it the scale of the lowest genuine mode so M stays SPD
        ref = h1 * (b / a + a / b) * lam[1] + h2 * (a * b)
        inv = jnp.where(denom > 1e-8 * ref, 1.0 / jnp.maximum(denom, 1e-300), 1.0 / ref)
        inv = inv.reshape(inv.shape + (1,) * (r.ndim - 3))
        t = jnp.einsum("ia,jb,eij...->eab...", S, S, r)
        t = t * inv
        return jnp.einsum("ia,jb,eab...->eij...", S, S, t)

    # ------------------------------------------------------------------
    # PnPn-2 pressure space operators
    # ------------------------------------------------------------------
    @property
    def p_shape(self):
        return self.bm.shape[:1] + (self.npr,) * (self.bm.ndim - 1)

    def div_to_p(self, u: jnp.ndarray) -> jnp.ndarray:
        """Weak divergence into the P_{N-2} Gauss pressure space (the PnPn-2
        D operator): <q, div u> integrated on the velocity GLL grid with the
        pressure test function lifted Gauss->GLL — exact quadrature for the
        polynomial degrees involved (evaluating the integral on the coarser
        Gauss grid instead under-integrates and costs an order of accuracy)."""
        d = self.bm * self.divv(u)
        return jnp.einsum("ia,jb,eij->eab", self.Jpg, self.Jpg, d)

    def p_to_gll(self, p: jnp.ndarray) -> jnp.ndarray:
        """Interpolate a Gauss pressure field to the velocity GLL nodes
        (for output/postprocessing only)."""
        return jnp.einsum("ia,jb,eab->eij", self.Jpg, self.Jpg, p)

    def p_from_gll(self, p: jnp.ndarray) -> jnp.ndarray:
        """Sample a GLL nodal pressure field at the Gauss pressure points
        (e.g. exact initial pressure for tests)."""
        return jnp.einsum("ai,bj,eij->eab", self.Jp, self.Jp, p)

    def pressure_precond_pnpn2(self, r: jnp.ndarray) -> jnp.ndarray:
        """SPD preconditioner for E = D M^-1 D^T: lift Gauss residual to the
        GLL grid (transpose-interp), apply the two-level FDM + Q1-coarse
        Poisson preconditioner there, restrict back.  M = R S R^T with S SPD
        and R full-rank => SPD on the pressure space."""
        rg = jnp.einsum("ai,bj,eab->eij", self.Jp, self.Jp, r)  # R^T r
        z = self.fdm_apply(rg, 1.0, 0.0) + self.coarse_apply_pressure(rg)
        return jnp.einsum("ai,bj,eij->eab", self.Jp, self.Jp, z)  # R z

    def setup_pressure_blocks(self) -> None:
        """Build the exact element-block pressure preconditioner
        (ops/schwarz.py) — runs real device computations, so call it
        eagerly, never mid-trace."""
        if self.pblock_inv is None:
            from .schwarz import build_pressure_blocks

            self.pblock_inv = build_pressure_blocks(self)

    def setup_pressure_schwarz(self, adjacency: str = "face") -> None:
        """Build the overlapping patch + P0 coarse pressure preconditioner
        (ops/schwarz.py) — one sparse-E extraction shared by both levels.
        Runs real device computations; call eagerly, never mid-trace.

        ``adjacency``: 'face' (default — element + face neighbors) or
        'node' (+ vertex-diagonal neighbors: ~2x patch cost, a few fewer
        iterations on strongly graded meshes — measured 53 -> 49 on the
        Barkley BFS mesh, 19 -> 21 on the cylinder)."""
        if self.pschwarz is None:
            from .schwarz import (
                build_p0_coarse, build_pressure_patches, extract_sparse_E,
            )

            B = extract_sparse_E(self)
            self.pschwarz = build_pressure_patches(
                self, weighted=False, B=B, adjacency=adjacency
            )
            self.p0Acinv = jnp.asarray(build_p0_coarse(self, B=B), self.dtype)

    def pressure_precond_schwarz(self, r: jnp.ndarray) -> jnp.ndarray:
        """Three-level overlapping-Schwarz preconditioner for E = D M^-1 D^T:
        exact element+face-neighbor patch solves + P0 element-constant
        coarse + Q1 vertex coarse (ops/schwarz.py) — the equivalent of
        Nek5000's overlapping Schwarz + XXT hierarchy
        (SURVEY.md section 2.2).  Measured round 4: 20/53/19 CG iterations
        to 1e-5 on quick-BFS/Barkley-BFS/cylinder vs 232/1779/86 for the
        box-FDM two-level."""
        from .schwarz import p0_coarse_apply, patch_apply

        z = patch_apply(*self.pschwarz, r) + p0_coarse_apply(self.p0Acinv, r)
        rg = jnp.einsum("ai,bj,eab->eij", self.Jp, self.Jp, r)
        zc = self.coarse_apply_pressure(rg)
        return z + jnp.einsum("ai,bj,eij->eab", self.Jp, self.Jp, zc)

    def setup_velocity_blocks(self, h1: float, h2: float) -> jnp.ndarray:
        """Exact element-block preconditioner for the assembled velocity
        Helmholtz P(h1 K + h2 B)P (ops/schwarz.py) — cached per (h1, h2).
        Runs real device computations; call eagerly, never mid-trace."""
        key = (float(h1), float(h2))
        if key not in self.vblock_inv:
            from .schwarz import build_velocity_blocks

            self.vblock_inv[key] = build_velocity_blocks(self, h1, h2)
        return self.vblock_inv[key]

    def pressure_precond_block(self, r: jnp.ndarray) -> jnp.ndarray:
        """Two-level exact-block + Q1-coarse preconditioner for
        E = D M^-1 D^T (ops/schwarz.py — the mesh-robust replacement for
        :meth:`pressure_precond_pnpn2` on graded/deformed meshes; the
        reference's Nek5000 Schwarz+XXT hierarchy plays this role,
        SURVEY.md section 2.2)."""
        from .schwarz import block_apply

        z = block_apply(self.pblock_inv, r)
        rg = jnp.einsum("ai,bj,eab->eij", self.Jp, self.Jp, r)
        zc = self.coarse_apply_pressure(rg)
        return z + jnp.einsum("ai,bj,eij->eab", self.Jp, self.Jp, zc)

    def coarse_apply_pressure(self, r: jnp.ndarray) -> jnp.ndarray:
        """Q1 vertex coarse-grid correction for the pressure Poisson — the
        two-level additive-Schwarz complement of :meth:`fdm_apply` (Nek's XXT
        coarse solve plays this role, SURVEY.md section 2.2)."""
        rc_e = jnp.einsum("cij,eij->ec", self.pc_Jc, r)
        rc = jax.ops.segment_sum(
            rc_e.reshape(-1), self.pc_cid.reshape(-1), num_segments=self.pc_nc
        )
        if self.axis_name is not None:
            rc = jax.lax.psum(rc, self.axis_name)
        xc = self.pc_Acinv @ rc
        return jnp.einsum("cij,ec->eij", self.pc_Jc, xc[self.pc_cid])

    # ------------------------------------------------------------------
    # convection
    # ------------------------------------------------------------------
    def convect_weak(self, cx, cy, u) -> jnp.ndarray:
        """Weak convection  integral of  phi * (c . grad u), dealiased by
        over-integration on the 3/2 Gauss grid (Nek ``convect_new``;
        the reference relies on Nek dealiasing, SURVEY.md section 2.2)."""
        ux, uy = self.grad(u)
        J = self.Jd
        to_fine = lambda a: jnp.einsum("ai,bj,eij->eab", J, J, a)
        F = to_fine(cx) * to_fine(ux) + to_fine(cy) * to_fine(uy)
        W = self.wf2 * self.jac_d * F
        return jnp.einsum("ai,bj,eab->eij", J, J, W)

    def convect_colloc(self, cx, cy, u) -> jnp.ndarray:
        """Collocated (aliased) weak convection: B * (c . grad u)."""
        ux, uy = self.grad(u)
        return self.bm * (cx * ux + cy * uy)

    # ------------------------------------------------------------------
    # inner products / norms
    # ------------------------------------------------------------------
    def _reduce(self, s: jnp.ndarray) -> jnp.ndarray:
        if self.axis_name is not None:
            s = jax.lax.psum(s, self.axis_name)
        return s

    def inner(self, u: jnp.ndarray, v: jnp.ndarray, masked: bool = True) -> jnp.ndarray:
        """Mass-weighted global inner product <u, v>_B — the reference's
        ``glsc3(u, bm1s, v)`` (core/krylov_subspace.f90:26-60).  ``masked``
        uses the sponge-masked weight bm1s."""
        w = self.bms if masked else self.bm
        return self._reduce(jnp.sum(u * v * self._bc(w, u)))

    def norm(self, u: jnp.ndarray, masked: bool = True) -> jnp.ndarray:
        return jnp.sqrt(self.inner(u, u, masked=masked))

    def glsum(self, u: jnp.ndarray) -> jnp.ndarray:
        return self._reduce(jnp.sum(u))

    def cgdot(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        """Inner product for the elliptic CG solves: multiplicity-weighted so
        each *global* node counts once.  Required for the assembled operator
        mask.dssum(K .) to be self-adjoint (Nek weights its solver dots with
        ``vmult/tmult`` for the same reason)."""
        w = self._bc(self.inv_mult, a)
        return self._reduce(jnp.sum(a * b * w))

    def glmax(self, u: jnp.ndarray) -> jnp.ndarray:
        m = jnp.max(u)
        if self.axis_name is not None:
            m = jax.lax.pmax(m, self.axis_name)
        return m

    def volume(self) -> jnp.ndarray:
        return self.glsum(self.bm)

    def mean(self, u: jnp.ndarray) -> jnp.ndarray:
        return self._reduce(jnp.sum(u * self.bm)) / self.volume()

    # ------------------------------------------------------------------
    # sponge (reference core/forcing.f90:82-252)
    # ------------------------------------------------------------------
    def set_sponge(self, strength_field: np.ndarray) -> None:
        """Install a sponge strength field lambda(x) >= 0; zeroes the
        inner-product weight bm1s where the sponge acts (reference
        forcing.f90:100-104 — essential for eigensolver cleanliness)."""
        lam = jnp.asarray(strength_field, dtype=self.dtype)
        self.sponge = lam
        self.bms = jnp.where(lam > 0.0, 0.0, self.bm)

    # ------------------------------------------------------------------
    # CFL (reference utils.f90 compute_cfl; used for dt selection)
    # ------------------------------------------------------------------
    def cfl(self, u: jnp.ndarray, v: jnp.ndarray, dt: float) -> jnp.ndarray:
        """Convective CFL number max |u.grad(xi)| dt / dxi_min."""
        dz = float(np.min(np.diff(gll_points_weights(self.n)[0])))
        ur = jnp.abs(u * self.rx + v * self.ry)
        us = jnp.abs(u * self.sx + v * self.sy)
        return self.glmax((ur + us) * dt / dz)
