"""Matrix-free preconditioned conjugate gradient + implicit-solve wrapper.

The inner elliptic solves (pressure Poisson, velocity Helmholtz — the
reference gets these from Nek5000 inside ``nek_advance``) are wrapped in
``lax.custom_linear_solve`` so that:

* ``jax.jvp`` of a time step re-solves the *same* SPD system for the tangent
  (exact linearized step, no differentiation through CG iterations), and
* ``jax.linear_transpose`` of a step re-solves the same symmetric system —
  giving the exact discrete adjoint of the propagator.

This replaces the reference's hand-written linearized/adjoint solvers
(Nek ``ifpert/ifadj``, SURVEY.md section 2.2).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

# lanes-path CG solves with maxiter at or below this cap run fully inlined
# (zero While trips); above it, `unroll` iterations per trip.  Default 0:
# fully-inlined solves were bit-identical to the While form at single-solve
# level but drifted to ~7e-2 inside the 50-step tangent matvec (cause
# unresolved — suspected XLA optimization across the huge unrolled step
# body); the 4-per-trip While form keeps matvec accuracy at the f32 floor.
LANES_UNROLL_CAP = 0


def pcg(
    operator: Callable,
    b,
    precond: Optional[Callable] = None,
    tol: float = 1e-8,
    maxiter: int = 500,
    dot: Optional[Callable] = None,
    x0=None,
    return_iters: bool = False,
    unroll: int = 1,
    fixed_iters: bool = False,
):
    """Preconditioned CG on an SPD operator over an arbitrary pytree.

    ``dot`` must be the *global* inner product (psum under SPMD).  Returns the
    solution pytree (or ``(x, niter)`` when ``return_iters``).  Fixed-shape
    ``lax.while_loop`` with early exit on ||r|| <= tol * ||b||.

    ``unroll > 1`` runs that many CG iterations per while-loop trip and
    checks the exit test once per trip — each trip of an XLA While carries a
    fixed cost (the loop predicate is evaluated and read back before the
    next trip), so amortizing it can matter more than the <= unroll-1 extra
    iterations past tolerance.
    """
    if precond is None:
        precond = lambda r: r
    if dot is None:
        dot = lambda a, c: sum(
            jnp.vdot(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(c))
        )
    add = lambda a, c, s: jax.tree.map(lambda x, y: x + s * y, a, c)

    bnorm = jnp.sqrt(dot(b, b))
    atol2 = (tol * jnp.maximum(bnorm, 1e-300)) ** 2

    if x0 is None:
        x = jax.tree.map(jnp.zeros_like, b)
        r = b
    else:
        x = x0
        r = add(b, operator(x0), -1.0)
    z = precond(r)
    rz = dot(r, z)
    p = z

    if fixed_iters:
        # Capped mode: run EXACTLY maxiter iterations under lax.fori_loop
        # with no early-exit condition and no live mask.  A data-dependent
        # While exit needs the exit dot before each trip; with the caps set
        # at the measured accuracy knee the tolerance is never reached
        # anyway, so the exit test buys nothing.  The live mask's
        # past-attainable-accuracy guard is not needed below the knee
        # either.  sdiv guards breakdown (rz -> 0) the same way.
        sdiv_f = lambda a, d: jnp.where(d > 0, a / jnp.where(d > 0, d, 1.0), 0.0)

        def body(_k, carry):
            x, r, p, rz = carry
            Ap = operator(p)
            alpha = sdiv_f(rz, dot(p, Ap))
            x = add(x, p, alpha)
            r = add(r, Ap, -alpha)
            z = precond(r)
            rz_new = dot(r, z)
            beta = sdiv_f(rz_new, rz)
            p = add(z, p, beta)
            return (x, r, p, rz_new)

        x, _, _, _ = jax.lax.fori_loop(
            0, maxiter, body, (x, r, p, rz), unroll=max(1, unroll)
        )
        if return_iters:
            return x, jnp.asarray(maxiter)
        return x

    # One live-masked CG iteration.  The freeze mask is essential, not just
    # an optimization: letting CG iterate past its (f32) attainable accuracy
    # turns beta into amplified rounding noise and the iterate drifts away
    # (measured 7e-2 on the 50-step tangent matvec without the mask).  The
    # mask also enforces the maxiter contract exactly under unroll > 1 (the
    # While cond only tests once per trip).
    sdiv = lambda a, d: jnp.where(d > 0, a / jnp.where(d > 0, d, 1.0), 0.0)

    def one_masked(carry):
        x, r, p, rz, k = carry
        live = jnp.logical_and(k < maxiter, dot(r, r) > atol2)
        Ap = operator(p)
        alpha = jnp.where(live, sdiv(rz, dot(p, Ap)), 0.0)
        x = add(x, p, alpha)
        r = add(r, Ap, -alpha)
        z = precond(r)
        rz_new = dot(r, z)
        beta = jnp.where(live, sdiv(rz_new, rz), 0.0)
        p = jax.tree.map(
            lambda zz, pp: jnp.where(live, zz + beta * pp, pp), z, p
        )
        rz = jnp.where(live, rz_new, rz)
        return (x, r, p, rz, k + live.astype(k.dtype))

    carry = (x, r, p, rz, jnp.array(0))
    if unroll >= maxiter:
        # fully inline: zero While trips
        for _ in range(maxiter):
            carry = one_masked(carry)
        x, _, _, _, k = carry
        if return_iters:
            return x, k
        return x

    def cond(carry):
        _, r, _, _, k = carry
        return jnp.logical_and(k < maxiter, dot(r, r) > atol2)

    def body(carry):
        for _ in range(unroll):
            carry = one_masked(carry)
        return carry

    x, r, p, rz, k = jax.lax.while_loop(cond, body, carry)
    if return_iters:
        return x, k
    return x


def cg_solve(
    operator: Callable,
    b,
    precond: Optional[Callable] = None,
    tol: float = 1e-8,
    maxiter: int = 500,
    dot: Optional[Callable] = None,
    project: Optional[Callable] = None,
    inner_op: Optional[Callable] = None,
    lanes: Optional[tuple] = None,
    fixed_iters: bool = False,
    inner_solve: Optional[Callable] = None,
    ir_cycles: int = 0,
):
    """Solve the SPD system A x = b via ``lax.custom_linear_solve``.

    ``project`` (optional) is an idempotent symmetric projection applied to
    both RHS and solution — used to remove the nullspace of the pure-Neumann
    pressure Poisson operator (constant mode).

    ``inner_op`` (optional) is ``(A_sub, P, M_sub)``: a cheaper operator
    equal to ``operator`` on ``range(P)`` (an invariant subspace on whose
    complement ``operator`` is the identity), the idempotent symmetric
    projector itself, and a preconditioner mapping ``range(P)`` into itself.
    The CG iteration then runs entirely in ``range(P)`` with ``A_sub``/
    ``M_sub``, and the complement part of the RHS passes through unchanged —
    this drops redundant gather-scatter projections from every iteration.
    ``operator`` remains what JAX differentiates/transposes (the correctness
    anchor); the solve
    handles arbitrary RHS (tangent and cotangent solves included) by
    splitting it across the subspace first.

    ``lanes`` (optional) is ``(to_l, from_l, A_l, M_l, dot_l, project_l)``
    from ops/lanes.py: run the CG iteration in the lanes layout —
    ``to_l``/``from_l`` are mutually inverse orthogonal layout permutations
    and ``A_l``/``M_l``/``project_l`` the exactly-permuted operator,
    preconditioner, and nullspace projector.  Composes with ``inner_op``
    (the subspace split happens in standard layout, the iteration in lanes).
    ``operator`` stays the differentiation anchor.

    ``inner_solve`` (optional, with ``ir_cycles`` >= 1) switches the solve
    to iterative refinement: ``inner_solve`` is a cheap approximate solve
    of the same system (the mixed-precision stepper's f32 subspace PCG,
    stepper/navier_stokes.py), and each cycle corrects it with a residual
    of ``operator`` (or ``A_sub``) in the caller's precision."""
    if inner_solve is not None and ir_cycles < 1:
        raise ValueError("inner_solve needs ir_cycles >= 1")

    def _iterate(A_it, rhs, M_it, dot_it, proj_it):
        """The actual CG iteration, in lanes layout when available."""
        if lanes is not None:
            to_l, from_l, A_l, M_l, dot_l, project_l = lanes
            # the lanes branch replaces proj_it with the bundle's own
            # project_l — a bundle without one must not silently drop a
            # requested nullspace projection (CG would stall or drift
            # along the nullspace)
            assert project_l is not None or proj_it is None, (
                "lanes bundle carries no project_l but a nullspace "
                "projection was requested"
            )
            r = to_l(rhs)
            if project_l is not None:
                r = project_l(r)
            # full unroll for tightly-capped solves (see LANES_UNROLL_CAP)
            unroll = maxiter if maxiter <= LANES_UNROLL_CAP else 4
            x = pcg(A_l, r, precond=M_l, tol=tol, maxiter=maxiter, dot=dot_l,
                    unroll=unroll, fixed_iters=fixed_iters)
            if project_l is not None:
                x = project_l(x)
            return from_l(x)
        if proj_it is not None:
            rhs = proj_it(rhs)
        x = pcg(A_it, rhs, precond=M_it, tol=tol, maxiter=maxiter, dot=dot_it,
                fixed_iters=fixed_iters)
        if proj_it is not None:
            x = proj_it(x)
        return x

    def _refined(inner, A64, rhs):
        """Iterative refinement: f32 inner solves + full-precision residual
        correction (the SURVEY section-7 mixed-precision recipe) —
        ``ir_cycles`` cycles, each contracting the error by the inner
        solve's relative accuracy (~1e-5 for f32 PCG at tol 3e-6), so
        2 cycles reach the reference's 1e-8..1e-10 class."""
        x = jax.tree.map(jnp.zeros_like, rhs)
        r = rhs
        for i in range(ir_cycles):
            if i:
                r = jax.tree.map(jnp.subtract, rhs, A64(x))
            if project is not None:
                r = project(r)
            dx = inner(r)
            if project is not None:
                dx = project(dx)
            x = jax.tree.map(jnp.add, x, dx)
        return x

    def solve(mv, rhs):
        if inner_op is not None:
            A_sub, P, M_sub = inner_op
            rP = P(rhs)
            comp = jax.tree.map(jnp.subtract, rhs, rP)
            # the refined solve is mathematically the same subspace solve;
            # the anchor ``operator`` still defines jvp/transpose exactness
            if inner_solve is not None:
                x = _refined(inner_solve, A_sub, rP)
            else:
                x = _iterate(A_sub, rP, M_sub, dot, project)
            return jax.tree.map(jnp.add, x, comp)
        if inner_solve is not None:
            return _refined(inner_solve, mv, rhs)
        return _iterate(mv, rhs, precond, dot, project)

    return jax.lax.custom_linear_solve(operator, b, solve, symmetric=True)
