"""Transient growth on the REFERENCE's own BFS mesh + committed base flow.

The decisive cross-check for the persistent G(t) deficit (round 3/4: our
meshes give G(1.723) ~ 6.3-6.5 vs Barkley's 15.54 regardless of
resolution): load the reference TG fixture exactly — bfs.re2 (1670
elements, graded 0.1 cells into the corner), the converged BF_bfs0.f00001
base flow, the bfs.par sponge (widths 5/10, strength 2) and the TG case's
BCs (inflow 'v', outflow 'v' pinned to the base flow, walls 'W';
transient_growth/bfs.usr setbc + userbc) — and run OUR svds-based TG on
it.  If G matches Barkley, the gap is our case setup; if not, the gap is
in the analysis machinery.

Usage: python tools/bfs_ref_tg.py [--horizons 1.723] [--k-dim 16] [--cpu]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from nekstab_next_tpu.utils.compile_cache import enable_compile_cache

REF = "/root/reference/examples/back_fstep/transient_growth"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--horizons", type=float, nargs="*", default=[1.723])
    ap.add_argument("--k-dim", type=int, default=16)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--outdir", default="bfs_out")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
    enable_compile_cache()

    import jax.numpy as jnp
    import numpy as np

    from examples.bfs_transient_growth import BARKLEY_REF
    from nekstab_next_tpu.algorithms import transient_growth_analysis
    from nekstab_next_tpu.cases.cylinder import smooth_step
    from nekstab_next_tpu.config import SolverConfig
    from nekstab_next_tpu.io.nek import nek_to_layout, read_nek_field
    from nekstab_next_tpu.mesh.mesh import BoundaryCondition as BC
    from nekstab_next_tpu.mesh.re2 import mesh_from_re2
    from nekstab_next_tpu.ops.core import SEM
    from nekstab_next_tpu.stepper.navier_stokes import NavierStokes

    dtype = jnp.float64 if args.cpu else jnp.float32
    t0 = time.time()

    # TG-case BCs (transient_growth/bfs.usr:124-126): inflow id4 'v',
    # outflow id2 'v' (pinned to the base flow), walls id3 'W'
    mesh = mesh_from_re2(
        f"{REF}/bfs.re2", order=5,
        boundary_ids={4: BC.DIRICHLET, 2: BC.DIRICHLET, 3: BC.WALL},
    )
    sem = SEM(mesh, dtype=dtype)
    print(f"[ref-tg] nelem={mesh.nelem} n={mesh.n} ({time.time()-t0:.0f}s)",
          flush=True)

    f = read_nek_field(f"{REF}/BF_bfs0.f00001")
    u = np.zeros((mesh.nelem,) + f.u.shape[1:])
    u[f.elmap - 1] = f.u
    base = jnp.asarray(nek_to_layout(u), dtype)
    print(f"[ref-tg] base flow loaded: time={f.time} "
          f"umax={float(jnp.max(jnp.abs(base))):.3f}", flush=True)

    # sponge: bfs.par userparam08-10 -> widths (5, 10), strength 2, with
    # the energy weight bm1s zeroed inside (core/forcing.f90:100-104)
    x = np.asarray(mesh.x)
    lam = 2.0 * (smooth_step((-10.0 + 5.0 - x) / 5.0)
                 + smooth_step((x - (50.0 - 10.0)) / 10.0))
    sem.set_sponge(lam)

    u_bc = (1.0 - sem.vmask) * base
    solver = SolverConfig(pressure_tol=1e-5 if not args.cpu else 1e-8,
                          velocity_tol=1e-6 if not args.cpu else 1e-9,
                          pressure_maxiter=40 if not args.cpu else 2000,
                          velocity_maxiter=24 if not args.cpu else 500,
                          pressure_precond="schwarz")
    dt = float(0.5 * mesh.min_spacing() / 1.5)
    ns = NavierStokes(sem, viscosity=1.0 / 500.0, dt=dt, u_bc=u_bc,
                      solver=solver, sponge_ref=base)
    print(f"[ref-tg] dt={dt:.5f}", flush=True)

    ref = np.loadtxt(BARKLEY_REF) if os.path.exists(BARKLEY_REF) else None
    rows = []
    for T in args.horizons:
        nsteps = max(int(round(T / dt)), 1)
        res = transient_growth_analysis(
            ns, base, horizon=T, nsteps=nsteps, nsv=1,
            k_dim=args.k_dim, tol=1e-4,
        )
        G = float(res.gains[0])
        Gref = (float(np.interp(T, ref[:, 0], ref[:, 1]))
                if ref is not None else None)
        rows.append(dict(t=T, G=G, G_barkley=Gref,
                         rel=None if Gref is None else G / Gref - 1.0))
        print(f"[ref-tg] G({T}) = {G:.2f}"
              + (f"  (Barkley {Gref:.2f}, {100*(G/Gref-1):+.1f}%)"
                 if Gref else "")
              + f"  [{res.n_matvecs} matvecs, svds-res {float(res.residuals[0]):.1e}, {time.time()-t0:.0f}s]",
              flush=True)
    os.makedirs(args.outdir, exist_ok=True)
    with open(os.path.join(args.outdir, "growth_refmesh.json"), "w") as fh:
        json.dump(rows, fh, indent=1)


if __name__ == "__main__":
    main()
