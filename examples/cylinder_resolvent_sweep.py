"""Cylinder resolvent frequency sweep (BASELINE.md ladder config 4).

Sweeps the resolvent gain sigma_1(omega) of the Re = 50 cylinder steady
state through the shedding frequency (St ~ 0.12-0.13, omega ~ 0.75-0.82) —
the reference's ``uparam 3.4`` path (core/linear_stab.f90:121-163,
core/linear_operators.f90:312-431).  Outputs, campaign.py-gated:

* ``resolvent_out/BF_cyl_00001.npz``      — Newton base flow;
* ``resolvent_out/Spectre_Sd.dat``        — omega / gains table (the
  reference's ``Spectre_S*`` convention);
* ``resolvent_out/gains.json``            — full summary;
* ``resolvent_out/f{Re,Im}/u{Re,Im}_*.npz`` — leading forcing/response
  mode at the peak-gain frequency.

The sweep mesh keeps a gentle radial grading so the CFL time step stays
large enough for the per-frequency periodicity solves (the steps/period is
set from the CFL dt per omega, not fixed).  ``--precision`` picks the
arithmetic: f64 throughout (the default), an f32 sweep (gains to ~0.1%)
on a mixed-precision base flow, or the mixed-precision stepper throughout.

Usage: python examples/cylinder_resolvent_sweep.py [--omegas ...]
       [--precision f64|f32|mixed]   (JAX_PLATFORMS=cpu runs on the CPU)
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from nekstab_next_tpu.algorithms import newton_krylov
from nekstab_next_tpu.algorithms.resolvent import (
    ResolventOperator, _complex_space,
)
from nekstab_next_tpu.campaign import Campaign, Stage, artifact_exists
from nekstab_next_tpu.cases.cylinder import CylinderCase
from nekstab_next_tpu.config import NewtonConfig, SolverConfig
from nekstab_next_tpu.io import load_field, save_field
from nekstab_next_tpu.krylov.svd import svds
from nekstab_next_tpu.utils.compile_cache import enable_compile_cache
from nekstab_next_tpu.utils.noise import velocity_noise

OMEGAS = (0.45, 0.60, 0.70, 0.78, 0.85, 0.95, 1.10)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reynolds", type=float, default=50.0)
    ap.add_argument("--outdir", default="resolvent_out")
    ap.add_argument("--omegas", type=float, nargs="*", default=None)
    ap.add_argument("--k-dim", type=int, default=8)
    ap.add_argument("--precision", choices=["f64", "f32", "mixed"],
                    default="f64",
                    help="'f64' throughout; 'f32' sweep (capped f32 inner "
                         "solves) on a base flow polished by the mixed-"
                         "precision stepper; 'mixed' stepper throughout")
    args = ap.parse_args()
    enable_compile_cache()
    omegas = tuple(args.omegas) if args.omegas else OMEGAS
    os.makedirs(args.outdir, exist_ok=True)
    f32 = args.precision == "f32"

    # gentle grading (the sweep needs a workable CFL dt for the hundreds of
    # steps per period)
    mk = dict(reynolds=args.reynolds, nr=8, ntheta=24, order=6,
              outer_radius=20.0, grading=8.0)
    if args.precision == "f64":
        case = CylinderCase(
            **mk, solver=SolverConfig(pressure_precond="schwarz"))
        case_bf = case
    else:
        case_bf = CylinderCase(
            **mk,
            solver=SolverConfig(pressure_tol=1e-8, velocity_tol=1e-9,
                                pressure_maxiter=400, velocity_maxiter=150,
                                pressure_precond="block"),
            mixed_precision=True)
        case = case_bf if not f32 else CylinderCase(
            **mk, dtype=jnp.float32,
            solver=SolverConfig(pressure_tol=1e-5, velocity_tol=1e-6,
                                pressure_maxiter=24, velocity_maxiter=12,
                                pressure_precond="block"))
    ns = case.make_ns()
    ns_bf = case_bf.make_ns()
    t0 = time.time()
    print(f"[res] Re={args.reynolds} nelem={case.mesh.nelem} "
          f"dt={case.dt:.4f} precision={args.precision} "
          f"backend={jax.default_backend()}", flush=True)

    bf_path = "BF_cyl_00001.npz"

    def run_baseflow(wd):
        st = ns.make_state(case.uniform_flow())
        st = jax.jit(lambda s: ns.advance(s, 600))(st)
        print(f"[res] settle done ({time.time()-t0:.0f}s)", flush=True)

        def cb(it, res, T):
            print(f"[res] newton iter {it} res={res:.3e} "
                  f"({time.time()-t0:.0f}s)", flush=True)

        horizon = 1.0
        nst = max(int(round(horizon / case.dt)), 1)
        if f32:
            # f32 warm phase to the f32-reachable 3e-4, then the polish
            warm = newton_krylov(ns, st.u, horizon=horizon, nsteps=nst,
                                 cfg=NewtonConfig(tol=3e-4, max_iter=20),
                                 k_dim=40, callback=cb)
            seed = jnp.asarray(np.asarray(warm.u), jnp.float64)
        else:
            seed = st.u
        result = newton_krylov(ns_bf, seed, horizon=horizon, nsteps=nst,
                               cfg=NewtonConfig(tol=1e-9, max_iter=25),
                               k_dim=40, callback=cb)
        assert result.converged, result.history[-3:]
        save_field(os.path.join(wd, bf_path),
                   jnp.asarray(np.asarray(result.u)),
                   p=jnp.asarray(np.asarray(result.p)),
                   residual=result.residual, reynolds=args.reynolds)
        print(f"[res] base flow res={result.residual:.2e} "
              f"({time.time()-t0:.0f}s)", flush=True)
        return dict(residual=result.residual)

    def run_sweep(wd):
        bf = load_field(os.path.join(wd, bf_path))
        base = jnp.asarray(bf.u, case.sem.dtype)
        space = _complex_space(ns.sem)
        rows = []
        best = None
        for om in omegas:
            T = 2 * np.pi / om
            # steps/period from the CFL dt, rounded up to a multiple of 4
            spp = int(np.ceil(T / case.dt / 4.0)) * 4
            op = ResolventOperator(
                ns, base, om, steps_per_period=spp,
                gmres_kdim=20, gmres_restarts=2,
                gmres_tol=2e-5 if f32 else 1e-8,
            )
            x0 = (velocity_noise(ns.sem, seed=7), velocity_noise(ns.sem, seed=8))
            res = svds(op.matvec_pure, op.rmatvec, space, x0, nsv=1,
                       k_dim=args.k_dim, tol=1e-4)
            sig = float(res.sigma[0])
            rows.append(dict(omega=om, strouhal=om / (2 * np.pi),
                             sigma=sig, steps_per_period=spp,
                             n_matvecs=int(res.n_matvecs),
                             svds_residual=float(res.residuals[0])))
            print(f"[res] omega={om:.3f} St={om/(2*np.pi):.4f} "
                  f"sigma1={sig:.4e}  [{res.n_matvecs} matvecs, "
                  f"{time.time()-t0:.0f}s]", flush=True)
            if best is None or sig > best[0]:
                best = (sig, om, res)
            # incremental write: long sweeps survive round/wall-clock cuts
            with open(os.path.join(wd, "gains.json"), "w") as fh:
                json.dump(dict(reynolds=args.reynolds,
                               nelem=int(case.mesh.nelem),
                               backend=jax.default_backend(),
                               dtype=str(case.sem.dtype),
                               partial=True, points=rows), fh, indent=1)
        # Spectre_S* convention: omega, gain(s)
        np.savetxt(os.path.join(wd, "Spectre_Sd.dat"),
                   np.array([[r["omega"], r["sigma"]] for r in rows]),
                   header="omega sigma1")
        sig, om, res = best
        (fr, fi), (ur, ui) = res.right[0], res.left[0]
        for name, fld in [("fRe", fr), ("fIm", fi), ("uRe", ur), ("uIm", ui)]:
            save_field(os.path.join(wd, f"{name}_cyl_00001.npz"),
                       jnp.asarray(np.asarray(fld)), omega=om, sigma=sig)
        out = dict(reynolds=args.reynolds, nelem=int(case.mesh.nelem),
                   backend=jax.default_backend(),
                   dtype=str(case.sem.dtype), points=rows,
                   peak=dict(omega=om, sigma=sig,
                             strouhal=om / (2 * np.pi)))
        with open(os.path.join(wd, "gains.json"), "w") as fh:
            json.dump(out, fh, indent=1)
        sigs = [r["sigma"] for r in rows]
        assert all(np.isfinite(sigs)), sigs
        if len(sigs) > 2:
            # gate: a genuine interior peak across the sweep
            imax = int(np.argmax(sigs))
            assert 0 < imax < len(sigs) - 1, (
                f"gain peak at the sweep boundary (omega={rows[imax]['omega']})")
        return out

    camp = Campaign(args.outdir, [
        Stage("baseflow", run_baseflow, done=artifact_exists(bf_path)),
        Stage("sweep", run_sweep, done=artifact_exists("gains.json")),
    ])
    camp.run()
    print(f"[res] done in {time.time()-t0:.0f}s -> {args.outdir}/gains.json",
          flush=True)


if __name__ == "__main__":
    main()
