"""Vortex-identification criteria (reference ``vortex_core``,
core/postproc.f90:2-523: lambda2 / Q / delta / swirling / omega).

All criteria derive from the velocity-gradient tensor G_ab = du_a/dx_b,
computed per element with the tensor-product derivative kernels and made C0
by dsavg (the reference's ``comp_gije`` + ``dsavg``).  In 2-D the flow embeds
in 3-D with w = d/dz = 0, so S^2 + Omega^2 has one zero eigenvalue and the
criteria reduce to closed forms on the 2x2 block — no eigensolver needed
(pure elementwise math)."""

from __future__ import annotations

import jax.numpy as jnp


def velocity_gradient(sem, u: jnp.ndarray, smooth: bool = True) -> jnp.ndarray:
    """G[..., a, b] = du_a/dx_b, shape (nelem, n, n, 2, 2)."""
    cols = []
    for a in range(u.shape[-1]):
        gx, gy = sem.grad(u[..., a])
        cols.append(jnp.stack([gx, gy], axis=-1))
    G = jnp.stack(cols, axis=-2)
    if smooth:
        G = sem.dsavg(G)
    return G


def vorticity(sem, u: jnp.ndarray, smooth: bool = True) -> jnp.ndarray:
    """Out-of-plane vorticity dv/dx - du/dy (reference ``comp_vort3`` 2-D)."""
    w = sem.curl(u[..., 0], u[..., 1])
    return sem.dsavg(w) if smooth else w


def _split(G):
    S = 0.5 * (G + jnp.swapaxes(G, -1, -2))
    W = 0.5 * (G - jnp.swapaxes(G, -1, -2))
    return S, W


def symmetric_criterion(G: jnp.ndarray) -> jnp.ndarray:
    """Pointwise strain magnitude |S|, S = (G + G^T)/2 — the reference's
    'symmetric' vortex output (``compute_symmetricVec``,
    core/postproc.f90:106-125, kernel :327-344)."""
    S, _ = _split(G)
    return jnp.sqrt(jnp.sum(S * S, axis=(-1, -2)))


def antisymmetric_criterion(G: jnp.ndarray) -> jnp.ndarray:
    """Pointwise rotation magnitude |Omega|, Omega = (G - G^T)/2 — the
    reference's 'antisym' output (``compute_antisymmetricVec``,
    core/postproc.f90:127-144, kernel :307-325)."""
    _, W = _split(G)
    return jnp.sqrt(jnp.sum(W * W, axis=(-1, -2)))


def q_criterion(G: jnp.ndarray) -> jnp.ndarray:
    """Q = (|Omega|^2 - |S|^2) / 2; Q > 0 marks vortex cores."""
    S, W = _split(G)
    return 0.5 * (
        jnp.sum(W * W, axis=(-1, -2)) - jnp.sum(S * S, axis=(-1, -2))
    )


def lambda2_criterion(G: jnp.ndarray) -> jnp.ndarray:
    """lambda2 of S^2 + Omega^2 (Jeong & Hussain); < 0 marks vortex cores.

    2-D: the 3-D tensor has eigenvalues {mu1, mu2, 0} with mu_i from the 2x2
    block; lambda2 is the median of the three."""
    S, W = _split(G)
    M = jnp.einsum("...ik,...kj->...ij", S, S) + jnp.einsum(
        "...ik,...kj->...ij", W, W
    )
    if G.shape[-1] == 2:
        tr = M[..., 0, 0] + M[..., 1, 1]
        det = M[..., 0, 0] * M[..., 1, 1] - M[..., 0, 1] * M[..., 1, 0]
        disc = jnp.sqrt(jnp.maximum(0.25 * tr * tr - det, 0.0))
        mu1 = 0.5 * tr - disc
        mu2 = 0.5 * tr + disc
        zero = jnp.zeros_like(mu1)
        # median of {mu1, mu2, 0}
        return jnp.median(jnp.stack([mu1, mu2, zero], axis=-1), axis=-1)
    evals = jnp.linalg.eigvalsh(M)  # ascending
    return evals[..., 1]


def delta_criterion(G: jnp.ndarray) -> jnp.ndarray:
    """Discriminant of the characteristic polynomial of G; > 0 means complex
    eigenvalues (swirling motion).  2-D: delta = det(G) - (tr G / 2)^2."""
    if G.shape[-1] == 2:
        tr = G[..., 0, 0] + G[..., 1, 1]
        det = G[..., 0, 0] * G[..., 1, 1] - G[..., 0, 1] * G[..., 1, 0]
        return det - 0.25 * tr * tr
    # 3-D: (Q/3)^3 + (R/2)^2 with P = tr G = 0 assumed (incompressible)
    S, W = _split(G)
    Q = 0.5 * (jnp.sum(W * W, axis=(-1, -2)) - jnp.sum(S * S, axis=(-1, -2)))
    R = -jnp.linalg.det(G)
    return (Q / 3.0) ** 3 + (R / 2.0) ** 2


def swirling_strength(G: jnp.ndarray) -> jnp.ndarray:
    """lambda_ci: imaginary part of the complex eigenvalue pair of G."""
    d = delta_criterion(G)
    if G.shape[-1] == 2:
        return jnp.sqrt(jnp.maximum(d, 0.0))
    return jnp.sqrt(jnp.maximum(d, 0.0)) ** (1.0 / 3.0)


def omega_criterion(G: jnp.ndarray, eps: float = 1e-6) -> jnp.ndarray:
    """Liu et al. Omega method: |W|^2 / (|W|^2 + |S|^2 + eps); ~1 in cores."""
    S, W = _split(G)
    a = jnp.sum(W * W, axis=(-1, -2))
    b = jnp.sum(S * S, axis=(-1, -2))
    return a / (a + b + eps)
