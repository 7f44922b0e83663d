"""3-D spectral-element operators on ``(nelem, n, n, n)`` fields.

Same design as the 2-D :class:`~nekstab_next_tpu.ops.core.SEM` (batched dense
tensor-product contractions on the matrix units, segment-sum gather-scatter, psum
reductions under SPMD) extended to hexahedral elements — the reference's
``if3d`` capability (SURVEY.md section 2.2).  The API matches SEM so the
Navier-Stokes stepper is dimension-agnostic: ``ndim``, ``grad`` (tuple),
``gradv``/``divv``/``convect`` vector forms, ``stiffness_local``,
``helmholtz_local``, ``dssum/dsavg/dsavg_mass``, ``inner/norm/glsum``."""

from __future__ import annotations

import math
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
from ..mesh.mesh3 import Mesh3D
from .core import SEM


class SEM3:
    ndim = 3

    def __init__(self, mesh: Mesh3D, dtype=jnp.float64, axis_name: Optional[str] = None):
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
        for k in ("drdx", "drdy", "drdz", "dsdx", "dsdy", "dsdz",
                  "dtdx", "dtdy", "dtdz", "jac", "bm",
                  "g11", "g12", "g13", "g22", "g23", "g33",
                  "vmask", "pmask", "tmask"):
            setattr(self, k, f(getattr(mesh, k)))
        self.bms = self.bm
        self.sponge = jnp.zeros_like(self.bm)

        bmg = np.zeros(mesh.nglobal)
        np.add.at(bmg, mesh.gid.reshape(-1), mesh.bm.reshape(-1))
        self.binv_assembled = f(1.0 / bmg[mesh.gid])
        self.inv_mult = f(1.0 / mesh.mult)

        # PnPn-2 pressure space (see ops/core.py): P_{N-2} on Gauss, L2
        npr = n - 2
        self.npr = npr
        zg_, wg_ = gauss_points_weights(npr)
        zc0, _ = gll_points_weights(n)
        Jp = lagrange_interp_matrix(zc0, zg_)
        self.Jp = f(Jp)
        self.Jpg = f(lagrange_interp_matrix(zg_, zc0))
        wp3 = np.einsum("a,b,c->abc", wg_, wg_, wg_)
        jac_p = np.einsum("ai,bj,ck,eijk->eabc", Jp, Jp, Jp, mesh.jac)
        self.bp = f(wp3) * f(jac_p)

        # dealiasing (3/2 over-integration)
        nd = int(math.ceil(3 * n / 2))
        self.nd = nd
        zf, wf = gauss_points_weights(nd)
        zc, _ = gll_points_weights(n)
        J = lagrange_interp_matrix(zc, zf)
        self.Jd = f(J)
        self.wf3 = f(
            wf[:, None, None] * wf[None, :, None] * wf[None, None, :]
        )
        interp3 = lambda a: np.einsum(
            "ai,bj,ck,eijk->eabc", J, J, J, np.asarray(a)
        )
        self.jac_d = f(interp3(mesh.jac))
        for k in ("drdx", "drdy", "drdz", "dsdx", "dsdy", "dsdz",
                  "dtdx", "dtdy", "dtdz"):
            setattr(self, k + "_d", f(interp3(getattr(mesh, k))))

        # fast-diagonalization preconditioner setup (ops/fdm.py)
        from .fdm import coarse_setup, element_half_lengths_3d, fdm_eigensetup

        S_fdm, lam_fdm = fdm_eigensetup(n)
        self.fdm_S = f(S_fdm)
        self.fdm_lam = f(lam_fdm)
        self.fdm_len = f(element_half_lengths_3d(mesh))  # (nelem, 3)

        # Q1 vertex coarse level for the pressure Poisson (XXT equivalent)
        zc_, _ = gll_points_weights(n)
        cid, Jc, Acinv = coarse_setup(
            mesh.gid,
            (mesh.g11, mesh.g12, mesh.g13, mesh.g22, mesh.g23, mesh.g33),
            diff_matrix(n), zc_, np.asarray(mesh.pmask),
        )
        self.pc_cid = jnp.asarray(cid, dtype=jnp.int32)
        self.pc_Jc = f(Jc)
        self.pc_Acinv = f(Acinv)
        self.pc_nc = int(Acinv.shape[0])

        self.num_shards = 1
        self.has_pressure_dirichlet = mesh.has_pressure_dirichlet
        # mesh-robust pressure preconditioners (ops/schwarz.py); see SEM
        self.pblock_inv = None
        self.pschwarz = None
        self.p0Acinv = None

    # ------------------------------------------------------------------
    _ELEM_FIELDS = (
        "drdx", "drdy", "drdz", "dsdx", "dsdy", "dsdz",
        "dtdx", "dtdy", "dtdz", "jac", "bm", "bms", "sponge",
        "g11", "g12", "g13", "g22", "g23", "g33",
        "vmask", "pmask", "tmask", "binv_assembled", "inv_mult", "bp",
        "jac_d",
        "drdx_d", "drdy_d", "drdz_d", "dsdx_d", "dsdy_d", "dsdz_d",
        "dtdx_d", "dtdy_d", "dtdz_d",
        "fdm_len", "pc_cid",
    )

    def elem_arrays(self) -> dict:
        d = {k: getattr(self, k) for k in self._ELEM_FIELDS}
        d["gid"] = self.gid.reshape(self.nelem, self.n, self.n, self.n)
        if self.pblock_inv is not None:
            d["pblock_inv"] = self.pblock_inv
        return d

    astype = SEM.astype

    def shard_view(self, elem_arrays: dict, axis_name: str) -> "SEM3":
        v = object.__new__(SEM3)
        v.__dict__.update(self.__dict__)
        for k in self._ELEM_FIELDS:
            setattr(v, k, elem_arrays[k])
        v.gid = elem_arrays["gid"].reshape(-1)
        v.nelem = elem_arrays["gid"].shape[0]
        v.axis_name = axis_name
        v.pblock_inv = elem_arrays.get("pblock_inv")
        # non-element-local host preconditioner state must not leak into the
        # shard view (see SEM.shard_view; round-4 ADVICE)
        v.pschwarz = None
        v.p0Acinv = None
        return v

    # ------------------------------------------------------------------
    def dssum(self, u: jnp.ndarray) -> jnp.ndarray:
        flat = u.reshape((self.gid.shape[0],) + u.shape[4:])
        g = jax.ops.segment_sum(flat, self.gid, num_segments=self.nglobal)
        if self.axis_name is not None:
            g = jax.lax.psum(g, self.axis_name)
        return g[self.gid].reshape(u.shape)

    @staticmethod
    def _bc(w: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
        return w.reshape(w.shape + (1,) * (u.ndim - 4))

    def dsavg(self, u: jnp.ndarray) -> jnp.ndarray:
        return self.dssum(u) * self._bc(self.inv_mult, u)

    def dsavg_mass(self, u: jnp.ndarray) -> jnp.ndarray:
        return self._bc(self.binv_assembled, u) * self.dssum(self._bc(self.bm, u) * u)

    # ------------------------------------------------------------------
    def grad_ref(self, u: jnp.ndarray):
        ur = jnp.einsum("ai,eijk->eajk", self.D, u)
        us = jnp.einsum("aj,eijk->eiak", self.D, u)
        ut = jnp.einsum("ak,eijk->eija", self.D, u)
        return ur, us, ut

    def grad(self, u: jnp.ndarray):
        """Physical gradient (u_x, u_y, u_z) — 3-D ``gradm1``."""
        ur, us, ut = self.grad_ref(u)
        return (
            self.drdx * ur + self.dsdx * us + self.dtdx * ut,
            self.drdy * ur + self.dsdy * us + self.dtdy * ut,
            self.drdz * ur + self.dsdz * us + self.dtdz * ut,
        )

    def gradv(self, u: jnp.ndarray) -> jnp.ndarray:
        return jnp.stack(self.grad(u), axis=-1)

    def divv(self, u: jnp.ndarray) -> jnp.ndarray:
        gx, _, _ = self.grad(u[..., 0])
        _, gy, _ = self.grad(u[..., 1])
        _, _, gz = self.grad(u[..., 2])
        return gx + gy + gz

    def curl(self, u, v, w):
        """(curl u) components — 3-D ``comp_vort3``."""
        _, uy, uz = self.grad(u)
        vx, _, vz = self.grad(v)
        wx, wy, _ = self.grad(w)
        return wy - vz, uz - wx, vx - uy

    # ------------------------------------------------------------------
    def stiffness_local(self, u: jnp.ndarray) -> jnp.ndarray:
        ur, us, ut = self.grad_ref(u)
        wr = self.g11 * ur + self.g12 * us + self.g13 * ut
        ws = self.g12 * ur + self.g22 * us + self.g23 * ut
        wt = self.g13 * ur + self.g23 * us + self.g33 * ut
        return (
            jnp.einsum("ai,eajk->eijk", self.D, wr)
            + jnp.einsum("aj,eiak->eijk", self.D, ws)
            + jnp.einsum("ak,eija->eijk", self.D, wt)
        )

    def stiffness_diag(self) -> jnp.ndarray:
        D2 = self.D * self.D
        d = (
            jnp.einsum("ai,eajk->eijk", D2, self.g11)
            + jnp.einsum("aj,eiak->eijk", D2, self.g22)
            + jnp.einsum("ak,eija->eijk", D2, self.g33)
        )
        dd = jnp.diagonal(self.D)
        d = d + 2.0 * (
            self.g12 * dd[:, None, None] * dd[None, :, None]
            + self.g13 * dd[:, None, None] * dd[None, None, :]
            + self.g23 * dd[None, :, None] * dd[None, None, :]
        )
        return d

    def helmholtz_local(self, u: jnp.ndarray, h1, h2) -> jnp.ndarray:
        return h1 * self.stiffness_local(u) + h2 * self.bm * u

    # -- PnPn-2 pressure space (see ops/core.py) -----------------------
    @property
    def p_shape(self):
        return (self.nelem,) + (self.npr,) * 3

    def div_to_p(self, u: jnp.ndarray) -> jnp.ndarray:
        # GLL-grid quadrature with lifted test function (see ops/core.py)
        d = self.bm * self.divv(u)
        return jnp.einsum(
            "ia,jb,kc,eijk->eabc", self.Jpg, self.Jpg, self.Jpg, d
        )

    def p_to_gll(self, p: jnp.ndarray) -> jnp.ndarray:
        return jnp.einsum(
            "ia,jb,kc,eabc->eijk", self.Jpg, self.Jpg, self.Jpg, p
        )

    def pressure_precond_pnpn2(self, r: jnp.ndarray) -> jnp.ndarray:
        rg = jnp.einsum("ai,bj,ck,eabc->eijk", self.Jp, self.Jp, self.Jp, r)
        z = self.fdm_apply(rg, 1.0, 0.0) + self.coarse_apply_pressure(rg)
        return jnp.einsum("ai,bj,ck,eijk->eabc", self.Jp, self.Jp, self.Jp, z)

    def setup_pressure_blocks(self) -> None:
        """Exact element-block pressure preconditioner (see SEM)."""
        if self.pblock_inv is None:
            from .schwarz import build_pressure_blocks

            self.pblock_inv = build_pressure_blocks(self)

    def setup_pressure_schwarz(self, adjacency: str = "face") -> None:
        """Overlapping patch + P0 coarse pressure preconditioner (see SEM).
        3-D note: patch dimension is 7 x npr^3 — memory scales as
        nelem x pdim^2; prefer 'block' beyond ~1k elements."""
        if self.pschwarz is None:
            from .schwarz import (
                build_p0_coarse, build_pressure_patches, extract_sparse_E,
            )

            B = extract_sparse_E(self)
            self.pschwarz = build_pressure_patches(
                self, weighted=False, B=B, adjacency=adjacency
            )
            self.p0Acinv = jnp.asarray(build_p0_coarse(self, B=B), self.dtype)

    def pressure_precond_block(self, r: jnp.ndarray) -> jnp.ndarray:
        """Exact element-block + Q1 coarse (3-D analogue of SEM's)."""
        from .schwarz import block_apply

        z = block_apply(self.pblock_inv, r)
        rg = jnp.einsum("ai,bj,ck,eabc->eijk", self.Jp, self.Jp, self.Jp, r)
        zc = self.coarse_apply_pressure(rg)
        return z + jnp.einsum("ai,bj,ck,eijk->eabc", self.Jp, self.Jp, self.Jp, zc)

    def pressure_precond_schwarz(self, r: jnp.ndarray) -> jnp.ndarray:
        """Overlapping patches + P0 + Q1 coarse (3-D analogue of SEM's)."""
        from .schwarz import p0_coarse_apply, patch_apply

        z = patch_apply(*self.pschwarz, r) + p0_coarse_apply(self.p0Acinv, r)
        rg = jnp.einsum("ai,bj,ck,eabc->eijk", self.Jp, self.Jp, self.Jp, r)
        zc = self.coarse_apply_pressure(rg)
        return z + jnp.einsum("ai,bj,ck,eijk->eabc", self.Jp, self.Jp, self.Jp, zc)

    def fdm_apply(self, r: jnp.ndarray, h1, h2) -> jnp.ndarray:
        """Approximate elementwise inverse of (h1 K + h2 B) via tensor-product
        fast diagonalization (3-D analogue of SEM.fdm_apply, ops/fdm.py)."""
        S, lam = self.fdm_S, self.fdm_lam
        a = self.fdm_len[:, 0][:, None, None, None]
        b = self.fdm_len[:, 1][:, None, None, None]
        c = self.fdm_len[:, 2][:, None, None, None]
        li = lam[:, None, None]
        lj = lam[None, :, None]
        lk = lam[None, None, :]
        denom = h1 * (
            (b * c / a) * li + (a * c / b) * lj + (a * b / c) * lk
        ) + h2 * (a * b * c)
        ref = h1 * (b * c / a + a * c / b + a * b / c) * lam[1] + h2 * (a * b * c)
        inv = jnp.where(denom > 1e-8 * ref, 1.0 / jnp.maximum(denom, 1e-300), 1.0 / ref)
        inv = inv.reshape(inv.shape + (1,) * (r.ndim - 4))
        t = jnp.einsum("ia,jb,kc,eijk...->eabc...", S, S, S, r)
        t = t * inv
        return jnp.einsum("ia,jb,kc,eabc...->eijk...", S, S, S, t)

    def coarse_apply_pressure(self, r: jnp.ndarray) -> jnp.ndarray:
        """Q1 vertex coarse-grid correction (3-D analogue, see SEM)."""
        rc_e = jnp.einsum("cijk,eijk->ec", self.pc_Jc, r)
        rc = jax.ops.segment_sum(
            rc_e.reshape(-1), self.pc_cid.reshape(-1), num_segments=self.pc_nc
        )
        if self.axis_name is not None:
            rc = jax.lax.psum(rc, self.axis_name)
        xc = self.pc_Acinv @ rc
        return jnp.einsum("cijk,ec->eijk", self.pc_Jc, xc[self.pc_cid])

    # ------------------------------------------------------------------
    def _to_fine(self, a: jnp.ndarray) -> jnp.ndarray:
        J = self.Jd
        return jnp.einsum("ai,bj,ck,eijk->eabc", J, J, J, a)

    def convect(self, c: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
        """Dealiased weak convection  integral phi (c . grad u) with the
        3/2-rule over-integration (Nek ``convect_new``)."""
        ux, uy, uz = self.grad(u)
        F = (
            self._to_fine(c[..., 0]) * self._to_fine(ux)
            + self._to_fine(c[..., 1]) * self._to_fine(uy)
            + self._to_fine(c[..., 2]) * self._to_fine(uz)
        )
        W = self.wf3 * self.jac_d * F
        J = self.Jd
        return jnp.einsum("ai,bj,ck,eabc->eijk", J, J, J, W)

    def convect_colloc(self, c: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
        ux, uy, uz = self.grad(u)
        return self.bm * (c[..., 0] * ux + c[..., 1] * uy + c[..., 2] * uz)

    convect_colloc_v = convect_colloc

    # ------------------------------------------------------------------
    def _reduce(self, s):
        if self.axis_name is not None:
            s = jax.lax.psum(s, self.axis_name)
        return s

    def inner(self, u, v, masked: bool = True):
        w = self.bms if masked else self.bm
        return self._reduce(jnp.sum(u * v * self._bc(w, u)))

    def norm(self, u, masked: bool = True):
        return jnp.sqrt(self.inner(u, u, masked=masked))

    def glsum(self, u):
        return self._reduce(jnp.sum(u))

    def cgdot(self, a, b):
        w = self._bc(self.inv_mult, a)
        return self._reduce(jnp.sum(a * b * w))

    def glmax(self, u):
        m = jnp.max(u)
        if self.axis_name is not None:
            m = jax.lax.pmax(m, self.axis_name)
        return m

    def volume(self):
        return self.glsum(self.bm)

    def mean(self, u):
        return self._reduce(jnp.sum(u * self.bm)) / self.volume()

    # ------------------------------------------------------------------
    def set_sponge(self, strength_field: np.ndarray) -> None:
        lam = jnp.asarray(strength_field, dtype=self.dtype)
        self.sponge = lam
        self.bms = jnp.where(lam > 0.0, 0.0, self.bm)

    # ------------------------------------------------------------------
    def cfl(self, u: jnp.ndarray, dt: float) -> jnp.ndarray:
        dz = float(np.min(np.diff(gll_points_weights(self.n)[0])))
        ur = jnp.abs(u[..., 0] * self.drdx + u[..., 1] * self.drdy + u[..., 2] * self.drdz)
        us = jnp.abs(u[..., 0] * self.dsdx + u[..., 1] * self.dsdy + u[..., 2] * self.dsdz)
        ut = jnp.abs(u[..., 0] * self.dtdx + u[..., 1] * self.dtdy + u[..., 2] * self.dtdz)
        return self.glmax((ur + us + ut) * dt / dz)
