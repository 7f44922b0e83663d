"""Lanes-layout ``(n^2, nelem)`` elliptic inner solves.

Motivation: fields stored ``(nelem, n, n)`` have a tiny trailing
``(n, n) = (7, 7)`` block; a vector unit that tiles the two minor
dimensions in wide registers pads it many times over, and the elliptic CG
iterations (~45 per time step, the hot loop of every matvec of every
analysis, SURVEY.md section 3.2) pay that on every operand.  Whether the
layout pays on the GPU is unmeasured (ROADMAP C2 proposes deleting it).

This module re-expresses the two inner solves (velocity Helmholtz,
PnPn-2 pressure Poisson) on arrays transposed to ``(n^2, nelem)`` with the
velocity components folded into the lane axis ``(n^2, ndim*nelem)``: the
element axis is the minor dimension, every tensor-product contraction
becomes one ``(n^2, n^2)`` Kronecker matmul against thousands of element
columns, in plain XLA so the whole CG iteration fuses.

The standard-layout operators remain the differentiation anchors inside
``lax.custom_linear_solve`` (ops/cg.py); the lanes path only replaces the
*solve* callback's CG iteration — the layout transform is an orthogonal
permutation, so the lanes CG solves the exactly-permuted system with the
exactly-permuted preconditioner and tangent/adjoint exactness is untouched.

Reference hot loop this accelerates: the Nek5000 pressure/velocity solves
inside ``nek_advance`` (SURVEY.md section 2.2/3.2).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# All lanes matmuls pin full-f32 precision: a reduced-precision matmul
# input (bf16, or TF32 on the GPU) loses ~3 digits per CG iteration and the
# 50-step tangent matvec drifts to ~8e-2.
_PREC = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_PREC)


class LanesOps:
    """Lanes-layout operator pack for one 2-D SEM context.

    Built host-side once per mesh (numpy); all jnp methods are pure and
    close over device constants.  Only single-device 2-D meshes: the
    sharded path keeps the standard layout (its per-element arrays are
    device-local tracers inside ``shard_map``).
    """

    def __init__(self, sem):
        if sem.ndim != 2:
            raise ValueError("LanesOps is 2-D only")
        if sem.axis_name is not None:
            raise ValueError("LanesOps does not support sharded SEM views")
        self.sem = sem
        n = sem.n
        npr = sem.npr
        E = int(sem.nelem)
        n2 = n * n
        npr2 = npr * npr
        self.n, self.npr, self.nelem = n, npr, E
        self.n2, self.npr2 = n2, npr2
        self.nglobal = int(sem.nglobal)
        self.ndim = 2
        dtype = sem.dtype
        f = lambda a: jnp.asarray(a, dtype)

        def tl(a):  # (E, n, n) -> (n2, E)
            return np.asarray(a, np.float64).reshape(E, -1).T.copy()

        # ---- Kronecker derivative matrices --------------------------------
        D = np.asarray(sem.D, np.float64)
        I = np.eye(n)
        Dr = np.kron(D, I)  # vec (i,j) row-major: ur = Dr @ u
        Ds = np.kron(I, D)
        self.Dr, self.Ds = f(Dr), f(Ds)
        self.DrT, self.DsT = f(Dr.T), f(Ds.T)

        # ---- lanes metric / mask fields -----------------------------------
        scal = {}
        for name in ("rx", "ry", "sx", "sy", "bm", "g11", "g12", "g22",
                     "binv_assembled", "inv_mult"):
            scal[name] = tl(getattr(sem, name))
        for name in ("rx", "ry", "sx", "sy", "bm"):
            setattr(self, name + "_s", f(scal[name]))
        d = self.ndim
        tile = lambda a: np.tile(a, (1, d))  # (n2, d*E), component-major blocks
        self.g11_v = f(tile(scal["g11"]))
        self.g12_v = f(tile(scal["g12"]))
        self.g22_v = f(tile(scal["g22"]))
        self.bm_v = f(tile(scal["bm"]))
        # vmask carries a component axis (nelem, n, n, ndim)
        vm = np.asarray(sem.vmask, np.float64)
        self.vmask_v = f(vm.transpose(1, 2, 3, 0).reshape(n2, d * E))
        self.binv_v = f(tile(scal["binv_assembled"]))
        self.invmult_v = f(tile(scal["inv_mult"]))

        # ---- gather-scatter index vectors ---------------------------------
        gid = np.asarray(sem.mesh.gid).reshape(E, n2).T  # (n2, E)
        self.gid_s = jnp.asarray(gid.reshape(-1), jnp.int32)
        gid_v = np.concatenate(
            [gid + c * self.nglobal for c in range(d)], axis=1
        )
        self.gid_v = jnp.asarray(gid_v.reshape(-1), jnp.int32)

        # ---- scatter-free dssum: face-exchange gathers + corner assembly --
        # On a conforming quad mesh the direct-stiffness sum decomposes
        # exactly into (a) pairwise exchange of edge-interior face nodes —
        # a static row slice plus one lane-axis neighbor GATHER per
        # (dst-face, src-face, flip) bucket (round 3 used one-hot (E, E)
        # matmuls here: O(E^2) matmul work that made the path 3.7x slower) —
        # and (b) a vertex assembly over the 4E corner values via a compact
        # segment-sum + gather.  Falls back to segment_sum when the mesh is
        # not 2-conforming.
        self._exchange = self._build_face_exchange(
            np.asarray(sem.mesh.gid), f
        )

        # ---- FDM tensor-product preconditioner ----------------------------
        S = np.asarray(sem.fdm_S, np.float64)
        lam = np.asarray(sem.fdm_lam, np.float64)
        SYN = np.kron(S, S)       # coeffs -> nodal
        self.ANA = f(SYN.T)       # nodal -> coeffs (S^T B-orthonormal)
        self.SYN = f(SYN)
        self.lamA = f(np.repeat(lam, n)[:, None])  # (n2, 1)
        self.lamB = f(np.tile(lam, n)[:, None])
        self._lam1 = float(lam[1])
        hl = np.asarray(sem.fdm_len, np.float64)  # (E, 2)
        a_, b_ = hl[:, 0][None, :], hl[:, 1][None, :]
        self.boa_s, self.aob_s, self.ab_s = f(b_ / a_), f(a_ / b_), f(a_ * b_)
        self.boa_v = f(tile(b_ / a_))
        self.aob_v = f(tile(a_ / b_))
        self.ab_v = f(tile(a_ * b_))

        # ---- PnPn-2 pressure operators ------------------------------------
        Jp = np.asarray(sem.Jp, np.float64)    # (npr, n): GLL -> Gauss
        Jg = np.asarray(sem.Jpg, np.float64)   # (n, npr): Gauss -> GLL
        # div_to_p second stage: out(a,b) = sum_ij Jg[i,a] Jg[j,b] d(i,j)
        self.P2 = f(np.kron(Jg, Jg).T)         # (npr2, n2)
        # precond lift: rg(i,j) = sum_ab Jp[a,i] Jp[b,j] r(a,b)
        LIFT = np.kron(Jp, Jp).T               # (n2, npr2)
        GF = SYN.T @ LIFT                      # residual -> FDM coeffs
        self.GF, self.GFT = f(GF), f(GF.T)
        # static (h1=1, h2=0) FDM eigen-inverse for the pressure Poisson
        denom = (b_ / a_) * np.repeat(lam, n)[:, None] \
            + (a_ / b_) * np.tile(lam, n)[:, None]
        ref = (b_ / a_ + a_ / b_) * lam[1]
        self.inv_p = f(np.where(denom > 1e-8 * ref,
                                1.0 / np.maximum(denom, 1e-300), 1.0 / ref))
        # Q1 vertex coarse level, fused with the lift/restrict
        Jc2 = np.asarray(sem.pc_Jc, np.float64).reshape(-1, n2)  # (nv, n2)
        JCG = Jc2 @ LIFT                       # (nv, npr2)
        self.JCG, self.JCGT = f(JCG), f(JCG.T)
        cid = np.asarray(sem.pc_cid).T         # (nv, E)
        self.cid_mat = jnp.asarray(cid, jnp.int32)
        self.cid_l = jnp.asarray(cid.reshape(-1), jnp.int32)
        self.nc = int(sem.pc_nc)
        self.Acinv = f(sem.pc_Acinv)

    # ------------------------------------------------------------------
    # scatter-free dssum construction
    # ------------------------------------------------------------------
    def _build_face_exchange(self, gid: np.ndarray, f):
        """Connectivity for the matmul dssum; None if the mesh is not a
        conforming quad mesh (every edge shared by <= 2 elements with the
        interior-node sequences matching forward or reversed)."""
        E, n = self.nelem, self.n
        if n < 3:
            return None
        # face node index paths (i-, j- index arrays along the face), in a
        # fixed traversal order; interior nodes only (corners handled apart)
        r = np.arange(1, n - 1)
        faces = {
            "W": (np.zeros_like(r), r),
            "E": (np.full_like(r, n - 1), r),
            "S": (r, np.zeros_like(r)),
            "N": (r, np.full_like(r, n - 1)),
        }
        seqs = {
            fc: gid[:, ii, jj] for fc, (ii, jj) in faces.items()
        }  # (E, n-2) gid sequences
        bykey = {}
        for fc in faces:
            for e in range(E):
                s = seqs[fc][e]
                key = tuple(sorted(s.tolist()))
                bykey.setdefault(key, []).append((e, fc))
        buckets = {}  # (dst_face, src_face, flip) -> list of (e_dst, e_src)
        for key, members in bykey.items():
            if len(members) == 1:
                continue  # domain-boundary face
            if len(members) > 2:
                return None  # non-conforming: fall back to segment_sum
            (e1, f1), (e2, f2) = members
            for (ed, fd), (es, fs) in (((e1, f1), (e2, f2)),
                                       ((e2, f2), (e1, f1))):
                sd, ss = seqs[fd][ed], seqs[fs][es]
                if np.array_equal(sd, ss):
                    flip = False
                elif np.array_equal(sd, ss[::-1]):
                    flip = True
                else:
                    return None  # irregular matching
                buckets.setdefault((fd, fs, flip), []).append((ed, es))
        fx = []
        for (fd, fs, flip), pairs in sorted(buckets.items()):
            # neighbor map as a lane-axis GATHER, not a one-hot (E, E)
            # matmul: the matmul form measured O(E^2) matmul work per bucket
            # (~4.5 GFLOP apiece at E=768) and made the whole lanes path
            # 3.7x slower than standard (measured in round 3); the
            # gather is the logical O(E) data movement.  idx[ed] = es, or
            # E (a zero pad slot) for boundary elements.
            idx = np.full(E, E, dtype=np.int64)
            for ed, es in pairs:
                idx[ed] = es
            fx.append((fd, fs, flip, jnp.asarray(idx, jnp.int32)))

        # vertex (corner) assembly: segment-sum over the compact vertex ids
        # + gather back (was a one-hot (4E, ncc) matmul pair)
        ci = np.array([0, 0, n - 1, n - 1])
        cj = np.array([0, n - 1, 0, n - 1])
        cg = gid[:, ci, cj].T  # (4, E)
        uniq, inv = np.unique(cg.reshape(-1), return_inverse=True)
        ncc = uniq.size
        return dict(fx=fx, faces=faces, ci=ci, cj=cj,
                    inv=jnp.asarray(inv, jnp.int32), ncc=ncc)

    @staticmethod
    def _face_get(xr, fc):
        """Edge-interior slice of a face (basic indexing only)."""
        if fc == "W":
            return xr[0, 1:-1]
        if fc == "E":
            return xr[-1, 1:-1]
        if fc == "S":
            return xr[1:-1, 0]
        return xr[1:-1, -1]  # N

    def _dssum_exchange(self, x: jnp.ndarray) -> jnp.ndarray:
        """dssum on (n2, C*E) lanes fields via face-exchange matmuls.

        Basic slices + dynamic_update_slice only — no scatter ops."""
        n, E = self.n, self.nelem
        ex = self._exchange
        C = x.shape[1] // E
        xr = x.reshape(n, n, C, E)
        contrib = {}
        for fd, fs, flip, idx in ex["fx"]:
            src = self._face_get(xr, fs)  # (n-2, C, E)
            if flip:
                src = src[::-1]
            ext = jnp.concatenate(
                [src, jnp.zeros(src.shape[:2] + (1,), src.dtype)], axis=-1
            )
            add = ext[:, :, idx]  # lane gather: neighbor or zero pad
            contrib[fd] = contrib.get(fd, 0.0) + add
        out = xr
        for fd, add in contrib.items():
            cur = self._face_get(out, fd) + add
            if fd == "W":
                out = out.at[0, 1:-1].set(cur)
            elif fd == "E":
                out = out.at[-1, 1:-1].set(cur)
            elif fd == "S":
                out = out.at[1:-1, 0].set(cur)
            else:
                out = out.at[1:-1, -1].set(cur)
        # corners: global vertex sums via segment-sum + gather
        vals = jnp.stack(
            [xr[0, 0], xr[0, -1], xr[-1, 0], xr[-1, -1]]
        )  # (4, C, E)
        flat = vals.transpose(1, 0, 2).reshape(C, 4 * E)
        z = jax.vmap(
            lambda row: jax.ops.segment_sum(row, ex["inv"],
                                            num_segments=ex["ncc"])
        )(flat)  # (C, ncc) vertex sums
        spread = z[:, ex["inv"]].reshape(C, 4, E).transpose(1, 0, 2)
        out = out.at[0, 0].set(spread[0])
        out = out.at[0, -1].set(spread[1])
        out = out.at[-1, 0].set(spread[2])
        out = out.at[-1, -1].set(spread[3])
        return out.reshape(x.shape)

    # ------------------------------------------------------------------
    # layout transforms (orthogonal permutations)
    # ------------------------------------------------------------------
    def vel_to_l(self, u: jnp.ndarray) -> jnp.ndarray:
        """(E, n, n, d) -> (n2, d*E), component-major column blocks."""
        n2, d, E = self.n2, u.shape[-1], self.nelem
        return u.transpose(1, 2, 3, 0).reshape(n2, d * E)

    def vel_from_l(self, x: jnp.ndarray) -> jnp.ndarray:
        n, E = self.n, self.nelem
        d = x.shape[1] // E
        return x.reshape(n, n, d, E).transpose(3, 0, 1, 2)

    def p_to_l(self, q: jnp.ndarray) -> jnp.ndarray:
        return q.transpose(1, 2, 0).reshape(self.npr2, self.nelem)

    def p_from_l(self, x: jnp.ndarray) -> jnp.ndarray:
        npr, E = self.npr, self.nelem
        return x.reshape(npr, npr, E).transpose(2, 0, 1)

    # ------------------------------------------------------------------
    # gather-scatter
    # ------------------------------------------------------------------
    def dssum_v(self, x: jnp.ndarray) -> jnp.ndarray:
        if self._exchange is not None:
            return self._dssum_exchange(x)
        g = jax.ops.segment_sum(
            x.reshape(-1), self.gid_v, num_segments=self.ndim * self.nglobal
        )
        return g[self.gid_v].reshape(x.shape)

    # ------------------------------------------------------------------
    # velocity Helmholtz (assembled subspace form)
    # ------------------------------------------------------------------
    def helm_v(self, u: jnp.ndarray, h1, h2) -> jnp.ndarray:
        """h1*K u + h2*B u on (n2, d*E) — 4 Kronecker matmuls."""
        ur = _mm(self.Dr, u)
        us = _mm(self.Ds, u)
        wr = self.g11_v * ur + self.g12_v * us
        ws = self.g12_v * ur + self.g22_v * us
        return h1 * (_mm(self.DrT, wr) + _mm(self.DsT, ws)) + h2 * (self.bm_v * u)

    def proj_v(self, x: jnp.ndarray) -> jnp.ndarray:
        """Continuity projector P = mask . dsavg . mask (ops/elliptic.py)."""
        return self.vmask_v * (self.invmult_v * self.dssum_v(self.vmask_v * x))

    def fdm_v(self, r: jnp.ndarray, h1, h2) -> jnp.ndarray:
        """Tensor-product FDM block inverse of (h1 K + h2 B) in lanes layout
        (matches SEM.fdm_apply including the Neumann-mode guard)."""
        denom = h1 * (self.boa_v * self.lamA + self.aob_v * self.lamB) \
            + h2 * self.ab_v
        ref = h1 * (self.boa_v + self.aob_v) * self._lam1 + h2 * self.ab_v
        inv = jnp.where(denom > 1e-8 * ref,
                        1.0 / jnp.maximum(denom, 1e-300), 1.0 / ref)
        return _mm(self.SYN, inv * _mm(self.ANA, r))

    def velocity_bundle(self, h1, h2):
        """(to_l, from_l, A_sub, M_sub, dot) for cg_solve's lanes path."""
        A = lambda x: self.proj_v(self.helm_v(x, h1, h2))
        M = lambda r: self.proj_v(self.fdm_v(r, h1, h2))
        dot = lambda a, b: jnp.sum(a * b)
        return (self.vel_to_l, self.vel_from_l, A, M, dot, None)

    # ------------------------------------------------------------------
    # PnPn-2 pressure Poisson  E = D M^-1 D^T
    # ------------------------------------------------------------------
    def div_p(self, u: jnp.ndarray) -> jnp.ndarray:
        """Weak divergence into P_{N-2} (SEM.div_to_p) on lanes velocity."""
        E = self.nelem
        du = _mm(self.Dr, u)
        dv = _mm(self.Ds, u)
        div = (self.rx_s * du[:, :E] + self.sx_s * dv[:, :E]
               + self.ry_s * du[:, E:] + self.sy_s * dv[:, E:])
        return _mm(self.P2, self.bm_s * div)

    def minv_free(self, g: jnp.ndarray) -> jnp.ndarray:
        """Masked assembled inverse-mass B^-1 (SEM binv path) on lanes."""
        return self.vmask_v * (self.binv_v * self.dssum_v(self.vmask_v * g))

    def precond_p(self, r: jnp.ndarray) -> jnp.ndarray:
        """Two-level FDM + Q1-coarse preconditioner, fused with the
        Gauss<->GLL lift/restrict (SEM.pressure_precond_pnpn2)."""
        z = _mm(self.GFT, self.inv_p * _mm(self.GF, r))
        rc = jax.ops.segment_sum(
            _mm(self.JCG, r).reshape(-1), self.cid_l, num_segments=self.nc
        )
        xc = _mm(self.Acinv, rc[:, None])[:, 0]
        return z + _mm(self.JCGT, xc[self.cid_mat])

    # ------------------------------------------------------------------
    # direct (dense-inverse) pressure preconditioner
    # ------------------------------------------------------------------
    def direct_pressure_inv(self, chunk: int = 512) -> jnp.ndarray:
        """Dense inverse of the PnPn-2 pressure operator E = D M^-1 D^T.

        The two-level FDM+Q1 preconditioner collapses on graded/stretched
        meshes (measured 1229 CG iterations to 1e-5 on the Barkley BFS mesh
        vs ~30 on the cylinder O-mesh); for the small fixtures where these
        meshes appear (<~25k pressure dofs) an exact dense inverse is cheap
        to build (N operator applies, vmapped) and makes CG converge in 1-2
        iterations — the full-rank analogue of Nek5000's XXT direct coarse
        solve (SURVEY.md section 2.2).  One (N, N) matmul per apply."""
        if getattr(self, "_einv", None) is not None:
            return self._einv
        N = self.npr2 * self.nelem
        if N > 30_000:
            # dense (N, N) inverse: ~3.6 GB host + device at the cap; a
            # larger mesh would silently attempt a multi-GB build
            raise ValueError(
                f"direct_pressure_inv: {N} pressure dofs exceeds the "
                "~30k dense-inverse cap; use the two-level/Schwarz "
                "preconditioner (pressure_direct=False)"
            )
        bundle_in = jax.ShapeDtypeStruct(
            (self.n2, self.ndim * self.nelem), self.sem.dtype
        )
        grad_p = jax.linear_transpose(self.div_p, bundle_in)

        def E_op(q):
            return self.div_p(self.minv_free(grad_p(q)[0]))

        apply_block = jax.jit(jax.vmap(E_op))
        cols = []
        for i0 in range(0, N, chunk):
            nb = min(chunk, N - i0)
            blk = np.zeros((nb, N), dtype=np.float32)
            blk[np.arange(nb), i0 + np.arange(nb)] = 1.0
            blk = jnp.asarray(
                blk.reshape(-1, self.npr2, self.nelem), self.sem.dtype
            )
            cols.append(np.asarray(apply_block(blk)).reshape(-1, N))
        Em = np.concatenate(cols, 0).T.astype(np.float64)
        Em = 0.5 * (Em + Em.T)
        if self.sem.has_pressure_dirichlet:
            Einv = np.linalg.inv(Em)
        else:  # pure-Neumann: constant nullspace
            Einv = np.linalg.pinv(Em, rcond=1e-12)
        self._einv = jnp.asarray(Einv, self.sem.dtype)
        return self._einv

    def _q1_coarse_p(self, r: jnp.ndarray) -> jnp.ndarray:
        """Q1 vertex coarse correction fused with the Gauss lift/restrict."""
        rc = jax.ops.segment_sum(
            _mm(self.JCG, r).reshape(-1), self.cid_l, num_segments=self.nc
        )
        xc = _mm(self.Acinv, rc[:, None])[:, 0]
        return _mm(self.JCGT, xc[self.cid_mat])

    def precond_p_blocks(self, r: jnp.ndarray) -> jnp.ndarray:
        """Exact element-block + Q1-coarse preconditioner in lanes layout
        (ops/schwarz.py blocks; mirrors SEM.pressure_precond_block)."""
        Binv = self.sem.pblock_inv  # (E, npr2, npr2)
        z = jnp.einsum("elk,ke->le", Binv, r, precision=_PREC)
        return z + self._q1_coarse_p(r)

    def _lanes_patch_idx(self) -> jnp.ndarray:
        """Patch gather indices translated from standard (e*nloc+k) to
        lanes (k*E+e) flat order.  Built EAGERLY (host numpy -> device
        constant) — building it lazily inside the traced preconditioner
        leaked a tracer through the cache (round-4 sweep failure)."""
        if getattr(self, "_pidx_l", None) is None:
            import numpy as _np

            pi = _np.asarray(self.sem.pschwarz[0])
            N = self.npr2 * self.nelem
            pad = pi == N
            pl = (pi % self.npr2) * self.nelem + (pi // self.npr2)
            pl[pad] = N
            self._pidx_l = jnp.asarray(pl, jnp.int32)
        return self._pidx_l

    def precond_p_schwarz(self, r: jnp.ndarray) -> jnp.ndarray:
        """Overlapping patches + P0 + Q1 coarse in lanes layout (mirrors
        SEM.pressure_precond_schwarz)."""
        sem = self.sem
        pidx, Pinv, w = sem.pschwarz
        N = self.npr2 * self.nelem
        rf = jnp.concatenate([r.reshape(-1), jnp.zeros((1,), r.dtype)])
        pidx_l = self._lanes_patch_idx()
        rp = rf[pidx_l] * w
        z = jnp.einsum("eab,eb->ea", Pinv, rp, precision=_PREC) * w
        zf = jax.ops.segment_sum(z.reshape(-1), pidx_l.reshape(-1),
                                 num_segments=N + 1)
        zl = zf[:N].reshape(self.npr2, self.nelem)
        # P0 element-constant coarse: element sums live on the lane axis
        rc = jnp.sum(r, axis=0)
        xc = _mm(sem.p0Acinv, rc[:, None])[:, 0]
        return zl + xc[None, :] + self._q1_coarse_p(r)

    def pressure_bundle(self, project_mean: bool, direct: bool = False,
                        precond: str = "fdm"):
        """(to_l, from_l, E_op, M, dot, project) for cg_solve's lanes path."""
        u_example = jax.ShapeDtypeStruct(
            (self.n2, self.ndim * self.nelem), self.sem.dtype
        )
        grad_p = jax.linear_transpose(self.div_p, u_example)

        def E_op(q):
            return self.div_p(self.minv_free(grad_p(q)[0]))

        dot = lambda a, b: jnp.sum(a * b)
        project = None
        if project_mean:
            csq = float(self.npr2 * self.nelem)

            def project(q):
                return q - (jnp.sum(q) / csq)

        M = self.precond_p
        if precond == "schwarz" and not direct:
            if self.sem.pschwarz is None:
                self.sem.setup_pressure_schwarz()
            self._lanes_patch_idx()  # build eagerly, never mid-trace
            M = self.precond_p_schwarz
        elif precond == "block" and not direct:
            if self.sem.pblock_inv is None:
                self.sem.setup_pressure_blocks()
            M = self.precond_p_blocks
        if direct:
            Einv = self.direct_pressure_inv()
            shape = (self.npr2, self.nelem)

            def M(r):  # noqa: F811 - intentional override
                return _mm(Einv, r.reshape(-1, 1)).reshape(shape)

        return (self.p_to_l, self.p_from_l, E_op, M, dot, project)
