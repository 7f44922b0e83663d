"""Krylov-Schur eigensolver on a matrix-free operator.

Rebuild of the reference's ``krylov_schur`` + ``schur_condensation``
(core/eigensolvers.f90:120-468) and of the LightKrylov ``eigs`` it migrates to
(core/linear_stab.f90:66): k-step Arnoldi, Ritz residuals from the rank-one
remainder, and Schur-condensation restarts that keep the cluster
|lambda| >= 1 - schur_del (at least nev+4 vectors, conjugate pairs intact —
reference ``select_eigenvalues``, eigensolvers.f90:688-756).

Host orchestrates (k_dim-sized dense work on LAPACK, replicated); every
device-side operation is a compiled call: the matvec (one propagator scan),
the batched orthogonalization, and the basis rotation Q @ Z (one matrix-unit matmul —
the reference's second hot spot, eigensolvers.f90:433-446)."""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from .arnoldi import arnoldi_step
from .dense import eig_sorted, schur_select
from .vector import Basis, VectorSpace


@dataclasses.dataclass
class EigenResult:
    eigenvalues: np.ndarray  # complex, sorted by decreasing |mu|
    residuals: np.ndarray  # Ritz residual per eigenvalue
    eigvecs_H: np.ndarray  # (k, k) complex Ritz vectors in the H basis
    basis: Basis
    H: np.ndarray
    k: int  # active Krylov dimension at exit
    n_converged: int
    n_matvecs: int
    history: List[dict]

    def mode(self, i: int):
        """Reconstruct Ritz vector i as a (real_part, imag_part) pytree pair
        (the reference's ``outpost_ks`` mode reconstruction Phi = Q y,
        eigensolvers.f90:587-680)."""
        y = np.zeros(self.basis.capacity, dtype=np.complex128)
        y[: self.k] = self.eigvecs_H[: self.k, i]
        re = self.basis.combine(np.ascontiguousarray(y.real))
        im = self.basis.combine(np.ascontiguousarray(y.imag))
        return re, im

    def orthonormality_audit(self, space: VectorSpace, ncols: Optional[int] = None) -> float:
        """max |<q_i, q_j> - delta_ij| over the converged basis — the
        reference's post-hoc audit written to ``orthonormality.dat``
        (eigensolvers.f90:335-345)."""
        k = self.k if ncols is None else ncols
        G = np.zeros((k, k))
        for i in range(k):
            qi = self.basis.get(i)
            for j in range(i, k):
                G[i, j] = G[j, i] = float(space.dot(qi, self.basis.get(j)))
        return float(np.max(np.abs(G - np.eye(k))))


def eigs(
    matvec: Callable,
    space: VectorSpace,
    x0,
    k_dim: int = 100,
    nev: int = 2,
    tol: float = 1e-6,
    schur_del: float = 0.10,
    max_restarts: int = 50,
    callback: Optional[Callable] = None,
    checkpoint=None,
    checkpoint_steps: bool = False,
) -> EigenResult:
    """Leading eigenpairs of the (propagator) operator ``matvec``.

    ``x0`` is the seed vector (pytree).  Convergence: Ritz residual
    |beta e_k^T y_i| < tol for the ``nev`` leading pairs (reference
    eigensolvers.f90:295-311).

    ``checkpoint``: optional :class:`~nekstab_next_tpu.io.checkpoint.
    ArnoldiCheckpoint`; the (basis, H) pair persists after every restart and
    a fresh call resumes from the last saved restart (the reference's
    ``ifres`` KRY/HES checkpointing, eigensolvers.f90:240-285, 758-857).

    ``checkpoint_steps``: additionally persist every Arnoldi column + the
    Hessenberg as it is produced (one .npz per column + an atomically-
    replaced state file), so a crash mid-factorization resumes at the last
    completed matvec instead of the last Schur restart — the reference
    outposts KRY/HES every step for the same reason
    (core/eigensolvers.f90:758-857, reload core/IO.f90:12-73)."""
    import jax

    basis = Basis(space, x0, capacity=k_dim + 1)
    q0, _ = space.normalize(x0)
    basis.set(0, q0)
    H = np.zeros((k_dim + 1, k_dim))
    m = 0  # number of columns kept from restarts
    nmv = 0
    history: List[dict] = []

    if checkpoint is not None:
        saved = checkpoint.load()
        if saved is not None:
            leaves, Hs, mcols, _meta = saved
            template = jax.tree.leaves(basis.Q)
            basis.Q = jax.tree.unflatten(
                jax.tree.structure(basis.Q),
                [jax.numpy.asarray(l, dtype=t.dtype) for l, t in
                 zip(leaves, template)],
            )
            H[:] = Hs
            m = mcols
        # per-step columns extend past the last restart bundle (cleared at
        # each restart, so whatever is on disk postdates the bundle).  Only
        # a run that opted into step checkpointing may adopt them — stale
        # step files from an earlier stepped run in the same directory must
        # not leak into a bundle-only resume (round-4 ADVICE).
        stepsave = checkpoint.load_columns() if checkpoint_steps else None
        if stepsave is not None:
            cols, Hc, ncols, _smeta = stepsave
            # columns <= m come from the restart bundle; the step files
            # only need to cover what postdates it
            if ncols > m and all(j in cols for j in range(m, ncols + 1)):
                qt = basis.get(0)
                struct = jax.tree.structure(qt)
                tleaves = jax.tree.leaves(qt)
                for j, lv in cols.items():
                    basis.set(j, jax.tree.unflatten(
                        struct,
                        [jax.numpy.asarray(l, dtype=t.dtype)
                         for l, t in zip(lv, tleaves)],
                    ))
                H[:] = Hc
                m = ncols

    def _save_col(j: int, restart: int) -> None:
        if checkpoint is not None and checkpoint_steps:
            checkpoint.save_column(
                j, [np.asarray(l) for l in jax.tree.leaves(basis.get(j))],
                H, j, restart=restart, n_matvecs=nmv,
            )

    _save_col(m, 0)  # seed (or resumed head) column

    # max_restarts counts Schur *condensations*; the factorization + Ritz
    # analysis always runs at least once (so max_restarts=0 still returns a
    # well-formed single-pass result instead of tripping on unbound state).
    for restart in range(max_restarts + 1):
        for j in range(m, k_dim):
            beta = arnoldi_step(matvec, space, basis, H, j)
            nmv += 1
            _save_col(j + 1, restart)
            if callback is not None:
                callback(restart, j, beta)
            if beta <= 1e-12:
                break

        Hk = H[:k_dim, :k_dim]
        beta = H[k_dim, k_dim - 1]
        vals, vecs = eig_sorted(Hk)
        # rank-one remainder: A Q - Q H = q_{k+1} * beta * e_k^T
        res = np.abs(beta * vecs[k_dim - 1, :])
        ncv = int(np.sum(res[:nev] < tol)) if len(res) >= nev else 0
        history.append(
            dict(restart=restart, n_converged=int(np.sum(res < tol)),
                 leading=vals[: max(nev, 4)].copy(), residuals=res[: max(nev, 4)].copy())
        )
        if np.all(res[:nev] < tol):
            return EigenResult(vals, res, vecs, basis, H, k_dim, nev, nmv, history)
        if restart == max_restarts:
            break

        # ---- Schur condensation restart ------------------------------
        def select(lams: np.ndarray) -> np.ndarray:
            keep = np.abs(lams) >= 1.0 - schur_del
            need = min(max(int(keep.sum()), nev + 4), k_dim - 2)
            order = np.argsort(-np.abs(lams))
            mask = np.zeros(len(lams), dtype=bool)
            mask[order[:need]] = True
            return mask

        T, Z, mm = schur_select(Hk, select)
        m = mm
        # rotate device basis: new q_0..q_{m-1} = Q Z[:, :m]; q_m = old q_{k}
        qk = basis.get(k_dim)
        V = np.zeros((k_dim + 1, m))
        V[:k_dim, :] = Z[:, :m]
        basis.rotate(np.asarray(V), m + 1)
        basis.set(m, qk)
        # new H: leading block T_m, residual row beta * Z[k-1, :m]
        H[:] = 0.0
        H[:m, :m] = T[:m, :m]
        H[m, :m] = beta * Z[k_dim - 1, :m]

        if checkpoint is not None:
            checkpoint.save(
                [np.asarray(l) for l in jax.tree.leaves(basis.Q)],
                H, m, restart=restart, n_matvecs=nmv,
            )
            # the rotation rewrote every column: step files are stale
            checkpoint.clear_columns()
            _save_col(m, restart + 1)

    return EigenResult(vals, res, vecs, basis, H, k_dim, ncv, nmv, history)
