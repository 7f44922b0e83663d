"""Short f64 CPU march on a BFS preset with robust solver settings —
distinguishes 'the scheme/mesh/IC is unstable' from 'the f32 capped-CG
config is unstable' (the graded 'barkley' mesh diverged in f32 within ~1000
steps, undiagnosed — VERDICT Weak #2).

Usage: python tools/bfs_cpu_probe.py [--preset barkley] [--steps 3000]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from examples.bfs_transient_growth import PRESETS, build_case
from nekstab_next_tpu.config import SolverConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="barkley", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--chunk", type=int, default=200)
    ap.add_argument("--precond", default="schwarz",
                    choices=("fdm", "block", "schwarz"))
    args = ap.parse_args()
    P = PRESETS[args.preset]

    solver = SolverConfig(pressure_tol=1e-8, velocity_tol=1e-9,
                          pressure_maxiter=2000, velocity_maxiter=500,
                          pressure_precond=args.precond)
    case = build_case(P, solver=solver, sponge=False)
    sem = case.sem
    ns = case.make_ns()
    print(f"[probe] nelem={case.mesh.nelem} order={P['order']} "
          f"dt={case.dt:.5f} precond={args.precond}", flush=True)

    def chunk_fn(st):
        st1 = ns.advance(st, args.chunk - 1)
        st2 = ns.step(st1)
        du = st2.u - st1.u
        res = jnp.sqrt(sum(sem.inner(du[..., d], du[..., d], masked=False)
                           for d in range(2)))
        umax = jnp.max(jnp.abs(st2.u))
        cfl = sem.cfl(st2.u[..., 0], st2.u[..., 1], case.dt)
        return st2, res, umax, cfl

    run = jax.jit(chunk_fn)
    st = ns.make_state(case.initial_flow())
    t0 = time.time()
    steps = 0
    while steps < args.steps:
        st, r, umax, cfl = run(st)
        steps += args.chunk
        print(f"[probe] step {steps}  res={float(r):.3e}  "
              f"umax={float(umax):.3f}  cfl={float(cfl):.3f}  "
              f"({time.time()-t0:.0f}s)", flush=True)
        if not np.isfinite(float(r)) or float(r) > 1e3:
            raise SystemExit(f"diverged at step {steps}")
    print("[probe] stable", flush=True)


if __name__ == "__main__":
    main()
