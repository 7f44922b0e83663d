"""Krylov vector algebra over arbitrary pytrees with a weighted inner product.

The framework's own replacement for the reference's two vector layers — the
``krylov_vector`` type + ``k_dot/k_normalize/k_matmul`` algebra
(core/krylov_subspace.f90:12-209) and the LightKrylov-conforming
``real_nek_vector`` (core/nek_vectors.f90:20-42).  A "vector" is any pytree of
arrays (e.g. a velocity field, or (velocity, period) for UPOs); the inner
product is supplied by the operator (mass-weighted, sponge-masked — the
reference's ``glsc3(·, bm1s, ·)``).

A :class:`Basis` stores k_dim+1 vectors as one stacked pytree (leading axis =
column) — the sharded "Krylov basis" memory object of SURVEY.md section 2.3.
Basis-matrix products (``k_matmul``, the Schur-restart rotation Q @ V —
reference eigensolvers.f90:433-446) are single batched contractions that XLA
maps to the matrix units.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec


def _stacked_like(leaf, capacity: int):
    """Zeros of shape (capacity, *leaf.shape) carrying the leaf's sharding.

    If the template leaf lives sharded on a device mesh (NamedSharding), the
    stacked basis column axis is replicated and every trailing axis keeps the
    leaf's partitioning — the sharded Krylov basis of SURVEY.md section 2.3
    item 3 (the reference holds it distributed the same way,
    core/eigensolvers.f90:149).  Unsharded leaves stay unsharded."""
    z = jnp.zeros((capacity,) + leaf.shape, dtype=leaf.dtype)
    sh = getattr(leaf, "sharding", None)
    if isinstance(sh, NamedSharding) and any(p is not None for p in sh.spec):
        z = jax.device_put(
            z, NamedSharding(sh.mesh, PartitionSpec(None, *sh.spec))
        )
    return z


class VectorSpace:
    """Bundles the weighted inner product and elementary vector algebra."""

    def __init__(self, dot: Callable[[Any, Any], jnp.ndarray]):
        self._dot = dot

    # -- algebra (all jit-safe) ---------------------------------------
    def dot(self, x, y):
        return self._dot(x, y)

    def norm(self, x):
        return jnp.sqrt(self._dot(x, x))

    def scale(self, a, x):
        return jax.tree.map(lambda l: a * l, x)

    def axpby(self, a, x, b, y):
        return jax.tree.map(lambda lx, ly: a * lx + b * ly, x, y)

    def add(self, x, y):
        return jax.tree.map(jnp.add, x, y)

    def sub(self, x, y):
        return jax.tree.map(jnp.subtract, x, y)

    def zeros_like(self, x):
        return jax.tree.map(jnp.zeros_like, x)

    def normalize(self, x):
        n = self.norm(x)
        return self.scale(1.0 / n, x), n


class Basis:
    """Preallocated stacked basis of ``capacity`` vectors (leading axis)."""

    def __init__(self, space: VectorSpace, template, capacity: int):
        self.space = space
        self.capacity = capacity
        self.Q = jax.tree.map(lambda l: _stacked_like(l, capacity), template)

    def set(self, j: int, x) -> None:
        self.Q = jax.tree.map(
            lambda B, l: B.at[j].set(l), self.Q, x
        )

    def get(self, j: int):
        return jax.tree.map(lambda B: B[j], self.Q)

    def dots(self, w, ncols: Optional[int] = None) -> jnp.ndarray:
        """Inner products of w against all (or the first ncols) columns."""
        d = jax.vmap(lambda q: self.space.dot(q, w))(self.Q)
        if ncols is not None:
            mask = jnp.arange(self.capacity) < ncols
            d = jnp.where(mask, d, 0.0)
        return d

    def combine(self, y: jnp.ndarray):
        """Linear combination sum_j y[j] Q_j (the reference's ``k_matmul``).
        ``y`` has length ``capacity`` (zero-padded beyond the active columns).
        Coefficients are cast to each leaf's dtype — host-side f64 numpy
        coefficients must not silently promote an f32 basis (round-5 bug
        found by the f32 Newton warm phase)."""
        return jax.tree.map(
            lambda B: jnp.tensordot(jnp.asarray(y, B.dtype), B, axes=(0, 0)),
            self.Q,
        )

    def ortho_insert(self, w, j: int, reorth: int = 1):
        """One fused device call: CGS-orthogonalize ``w`` against columns
        0..j, normalize, and write the result into column j+1.  Returns
        (h, beta) with h the accumulated projection coefficients.

        This is the whole non-matvec part of an Arnoldi step as ONE
        executable: the eager-op version would pay one dispatch per
        operation, which at k_dim-sized work costs more than the math."""
        if not hasattr(self, "_ortho_jit"):
            space = self.space
            cap = self.capacity

            def kernel(Q, w, j):
                ncols = j + 1
                mask = (jnp.arange(cap) < ncols).astype(
                    jnp.result_type(*jax.tree.leaves(Q))
                )
                dots = lambda v: jax.vmap(
                    lambda q: space.dot(q, v)
                )(Q) * mask
                comb = lambda y: jax.tree.map(
                    lambda B: jnp.tensordot(y, B, axes=(0, 0)), Q
                )
                h = dots(w)
                w1 = space.sub(w, comb(h))
                for _ in range(reorth):
                    c = dots(w1)
                    w1 = space.sub(w1, comb(c))
                    h = h + c
                beta = space.norm(w1)
                qn = space.scale(1.0 / jnp.maximum(beta, 1e-300), w1)
                Q = jax.tree.map(lambda B, l: B.at[j + 1].set(l), Q, qn)
                return Q, h, beta

            self._ortho_jit = jax.jit(kernel, donate_argnums=(0,))

        self.Q, h, beta = self._ortho_jit(self.Q, w, jnp.asarray(j))
        return h, beta

    def rotate(self, V: jnp.ndarray, ncols_out: int) -> None:
        """In-place basis rotation Q[:, :m] <- Q @ V with V (capacity, m) —
        the Schur-condensation hot spot (reference eigensolvers.f90:433-446),
        one big device matmul here."""
        m = V.shape[1]
        newQ = jax.tree.map(
            lambda B: jnp.tensordot(V.T, B, axes=(1, 0)), self.Q
        )  # (m, ...) leading axis
        # write into zeros_like(B) so the stacked basis keeps its sharding
        # (zeros_like preserves NamedSharding; concatenating with fresh
        # unsharded zeros would not)
        self.Q = jax.tree.map(
            lambda B, Bn: jnp.zeros_like(B).at[:m].set(Bn.astype(B.dtype)),
            self.Q,
            newQ,
        )
        del ncols_out
