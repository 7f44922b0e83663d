"""SPMD execution over a device mesh: element-partitioned domain decomposition.

The reference's single distribution axis is Nek5000's element partition over
MPI ranks, with gather-scatter face exchange and all-reduce inner products
(SURVEY.md section 2.3).  JAX mapping:

* elements are sharded over a 1-D ``jax.sharding.Mesh`` axis ('e');
* the whole computation (step / propagator / tangent operator) runs under
  ``shard_map``; inside it every SEM reduction carries ``axis_name='e'``, so
  the gather-scatter's cross-device sum and all dot products lower to XLA
  ``psum`` collectives over the device interconnect;
* geometry/mask arrays are sharded along the element axis and passed as
  arguments; the small dense operators (GLL derivative matrices) replicate.

Krylov vectors stay sharded end-to-end: the basis is a stacked pytree whose
element axis carries the same sharding (the "sharded Krylov basis" of the
north star), and the orthogonalization dots reduce with one psum each.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from ..config import SolverConfig
from ..mesh.mesh import Mesh2D
from ..ops.core import SEM
from ..stepper.navier_stokes import NavierStokes
from ..stepper.state import FlowState, initial_state


def make_device_mesh(n_devices: Optional[int] = None, axis: str = "e") -> JaxMesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return JaxMesh(np.array(devs), (axis,))


class ShardedContext:
    """Bundles a mesh, its sharded geometry arrays, and shard_map wrappers.

    Usage::

        ctx = ShardedContext(mesh, jmesh, viscosity=1/Re, dt=dt, u_bc=ubc)
        state = ctx.shard_state(initial_state(u0))
        step = ctx.compile(lambda ns, st: ns.step(st))
        state = step(state)
    """

    def __init__(
        self,
        mesh: Mesh2D,
        jmesh: Optional[JaxMesh] = None,
        axis: str = "e",
        dtype=jnp.float64,
        u_bc: Optional[jnp.ndarray] = None,
        forcing: Optional[Callable] = None,
        sponge_strength: Optional[np.ndarray] = None,
        sponge_ref: Optional[jnp.ndarray] = None,
        **ns_kwargs,
    ):
        self.mesh = mesh
        self.jmesh = jmesh if jmesh is not None else make_device_mesh(axis=axis)
        self.axis = axis
        ndev = self.jmesh.devices.size
        if mesh.nelem % ndev != 0:
            raise ValueError(
                f"nelem={mesh.nelem} must be divisible by the {ndev}-device mesh "
                "(choose element counts accordingly; padding lands later)"
            )
        if getattr(mesh, "ndim", 2) == 3:
            from ..ops.core3 import SEM3

            self._sem_host = SEM3(mesh, dtype=dtype)
        else:
            self._sem_host = SEM(mesh, dtype=dtype)
        if sponge_strength is not None:
            self._sem_host.set_sponge(sponge_strength)
        self.ns_kwargs = dict(ns_kwargs)
        self._forcing = forcing

        # mesh-robust pressure preconditioning under SPMD: the exact
        # element blocks are element-local, so they shard along 'e' like
        # any geometry array ('schwarz' patches gather across element
        # boundaries and fall back to 'block' here; SolverConfig docs)
        solver = self.ns_kwargs.get("solver", SolverConfig())
        if (solver.pressure_precond in ("block", "schwarz")
                and solver.pressure_operator == "pnpn2"):
            self._sem_host.setup_pressure_blocks()

        eshard = NamedSharding(self.jmesh, P(axis))
        arrays = self._sem_host.elem_arrays()
        s = self._sem_host
        nd = s.ndim
        arrays["u_bc"] = (
            jnp.zeros(s.bm.shape + (nd,), dtype=dtype) if u_bc is None else
            (1.0 - s.vmask) * u_bc.astype(dtype)
        )
        arrays["sponge_ref"] = (
            jnp.zeros(s.bm.shape + (nd,), dtype=dtype) if sponge_ref is None
            else sponge_ref.astype(dtype)
        )
        self._has_sponge_ref = sponge_ref is not None
        self.arrays = jax.device_put(arrays, eshard)
        self._arr_specs = jax.tree.map(lambda _: P(axis), arrays)

    # ------------------------------------------------------------------
    def make_ns(self, local_arrays: dict) -> NavierStokes:
        """Build a device-local NavierStokes inside a shard_map region.

        Goes through the real constructor (round-1 built the object via
        ``__new__`` and missed late-added attributes like ``u_bc_fn``)."""
        sem_l = self._sem_host.shard_view(local_arrays, axis_name=self.axis)
        return NavierStokes(
            sem_l,
            viscosity=self.ns_kwargs.get("viscosity", 1.0),
            dt=self.ns_kwargs.get("dt", 1e-3),
            u_bc=local_arrays["u_bc"],
            forcing=self._forcing,
            sponge_ref=(
                local_arrays["sponge_ref"] if self._has_sponge_ref else None
            ),
            solver=self.ns_kwargs.get("solver", SolverConfig()),
            mixed_precision=self.ns_kwargs.get("mixed_precision", False),
            u_bc_fn=self.ns_kwargs.get("u_bc_fn", None),
        )

    # ------------------------------------------------------------------
    def state_spec(self, thermal: bool = False, warm: bool = True):
        a = self.axis
        extra = (
            dict(T=P(a), tlag=P(None, a), ntlag=P(None, a)) if thermal else {}
        )
        if warm:
            extra["dp"] = P(a)
        return FlowState(
            u=P(a), p=P(a), ulag=P(None, a), nlag=P(None, a), time=P(),
            step=P(), **extra,
        )

    def field_spec(self):
        return P(self.axis)

    def make_host_state(self, u, time: float = 0.0, T=None) -> FlowState:
        """Fresh full-domain state matching this context's stepper config
        (pressure space + warm-start carry)."""
        solver = self.ns_kwargs.get("solver", SolverConfig())
        s = self._sem_host
        scheme = (
            "laplacian" if self.ns_kwargs.get("mixed_precision")
            else solver.pressure_operator
        )
        p = jnp.zeros(
            s.p_shape if scheme == "pnpn2" else s.bm.shape, dtype=s.dtype
        )
        return initial_state(
            u.astype(s.dtype), p=p, time=time, T=T,
            warm_start=solver.warm_start,
        )

    def shard_state(self, state: FlowState) -> FlowState:
        put = lambda x, sp: jax.device_put(x, NamedSharding(self.jmesh, sp))
        return jax.tree.map(put, state, self.state_spec())

    def shard_field(self, u: jnp.ndarray) -> jnp.ndarray:
        return jax.device_put(u, NamedSharding(self.jmesh, P(self.axis)))

    # ------------------------------------------------------------------
    def compile(self, fn: Callable, in_specs: Tuple = None, out_specs=None):
        """shard_map + jit a function ``fn(ns_local, *args)``.

        ``in_specs`` / ``out_specs`` are PartitionSpecs (or pytrees thereof)
        for ``*args`` / outputs; default: everything element-sharded with the
        FlowState layout inferred per-leaf at trace time."""

        def inner(arrays, *args):
            ns = self.make_ns(arrays)
            return fn(ns, *args)

        wrapped = jax.shard_map(
            inner,
            mesh=self.jmesh,
            in_specs=(self._arr_specs,) + tuple(in_specs or ()),
            out_specs=out_specs,
            check_vma=False,
        )
        jitted = jax.jit(wrapped)
        return lambda *args: jitted(self.arrays, *args)
