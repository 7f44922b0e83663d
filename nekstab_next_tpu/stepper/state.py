"""Flow state pytree.

The JAX-native replacement for Nek5000's velocity/pressure commons plus lag
arrays (``vx/vy/pr``, ``vxlag``, ``abx1/abx2`` ...), which the reference
manipulates through its ``krylov_vector`` type (core/krylov_subspace.f90:12-17).
All arrays carry the element axis first — the sharded axis under SPMD.

Temperature / passive scalars: the reference's ``krylov_vector`` carries a
``t(lv, ldimt)`` block and the solver loops the (u,v,w,p,T,scalars) tuple
(core/nek_vectors.f90:209-362, ``ifto/ifpsco``).  Here the optional ``T``
field is ``(nelem, n, n, nscal)`` with its own BDF/EXT history; ``T=None``
(the default) keeps the velocity-only layout bit-identical to round 1.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
class FlowState:
    """One time level of the flow plus BDF3/EXT3 history.

    u     : (nelem, n, n, 2|3)    velocity
    p     : (nelem, n, n[, n])    pressure
    ulag  : (2, *u.shape)         u at steps n-1, n-2 (BDF history)
    nlag  : (2, *u.shape)         weak explicit terms at steps n-1, n-2 (EXT)
    time  : ()                    physical time
    step  : ()  int               step counter (drives the BDF startup ramp)
    T     : (nelem, n, n, nscal)  temperature + passive scalars (optional)
    tlag  : (2, *T.shape)         scalar BDF history (optional)
    ntlag : (2, *T.shape)         scalar explicit-term history (optional)
    dp    : (nelem, n, n[, n])    previous pressure increment — warm-starts
                                  the pressure solve (optional)
    """

    def __init__(self, u, p, ulag, nlag, time, step, T=None, tlag=None,
                 ntlag=None, dp=None):
        self.u = u
        self.p = p
        self.ulag = ulag
        self.nlag = nlag
        self.time = time
        self.step = step
        self.T = T
        self.tlag = tlag
        self.ntlag = ntlag
        self.dp = dp

    def tree_flatten(self):
        return (
            self.u, self.p, self.ulag, self.nlag, self.time, self.step,
            self.T, self.tlag, self.ntlag, self.dp,
        ), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    def replace(self, **kw) -> "FlowState":
        d = dict(
            u=self.u, p=self.p, ulag=self.ulag, nlag=self.nlag,
            time=self.time, step=self.step,
            T=self.T, tlag=self.tlag, ntlag=self.ntlag, dp=self.dp,
        )
        d.update(kw)
        return FlowState(**d)


def initial_state(
    u: jnp.ndarray,
    p: Optional[jnp.ndarray] = None,
    time: float = 0.0,
    dtype=None,
    T: Optional[jnp.ndarray] = None,
    warm_start: bool = True,
) -> FlowState:
    """Fresh state from a velocity field; lag arrays zeroed, step=0 so the
    BDF1/2/3 startup ramp applies (mirrors Nek's restart behaviour that the
    reference relies on when it reseeds each matvec, core/matvec.f90:150-242).

    ``T``: optional (nelem, n, n, nscal) scalar block (temperature first),
    matching the reference's ``t(lv, ldimt)``.  ``warm_start`` allocates the
    ``dp`` pressure-increment carry used by the stepper's residual-correction
    warm start (SolverConfig.warm_start)."""
    if dtype is not None:
        u = u.astype(dtype)
    if p is None:
        p = jnp.zeros(u.shape[:-1], dtype=u.dtype)
    ulag = jnp.zeros((2,) + u.shape, dtype=u.dtype)
    nlag = jnp.zeros((2,) + u.shape, dtype=u.dtype)
    dp = jnp.zeros_like(p) if warm_start else None
    tfields = {}
    if T is not None:
        T = T.astype(u.dtype)
        tfields = dict(
            T=T,
            tlag=jnp.zeros((2,) + T.shape, dtype=u.dtype),
            ntlag=jnp.zeros((2,) + T.shape, dtype=u.dtype),
        )
    return FlowState(
        u=u,
        p=p.astype(u.dtype),
        ulag=ulag,
        nlag=nlag,
        time=jnp.asarray(time, dtype=u.dtype),
        step=jnp.asarray(0, dtype=jnp.int32),
        dp=dp,
        **tfields,
    )
