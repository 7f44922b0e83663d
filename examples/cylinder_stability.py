"""Flagship end-to-end run: cylinder-in-crossflow global stability analysis.

Pipeline (BASELINE.md configs 1-3 on one case):

1. Newton-Krylov base flow at Re (the reference's uparam 2.0 path,
   core/newton_krylov.f90), seeded by a short DNS transient;
2. direct leading eigenmodes (uparam 3.1 / linear_stability_analysis);
3. adjoint leading eigenmodes (uparam 3.2);
4. wavemaker + base-flow sensitivity (uparam 4.2/4.3);
5. outputs: BF/mode snapshots (npz), spectrum files, lift/drag of the base
   flow, and a JSON summary.

Literature anchors at Re = 60 (validation targets): growth rate
sigma ~ 0.045-0.05, Strouhal St = omega/(2 pi) ~ 0.135-0.14
(Barkley EPL 2006 fig. 2; Giannetti & Luchini JFM 2007).

Usage:  python examples/cylinder_stability.py [--preset quick|full]
        [--precision f64|mixed]
        (quick: coarse mesh, CPU-runnable in ~1-2 h; full: fixture scale;
        JAX_PLATFORMS=cpu runs on the CPU)
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

from nekstab_next_tpu.algorithms import linear_stability_analysis, newton_krylov
from nekstab_next_tpu.cases.cylinder import CylinderCase
from nekstab_next_tpu.config import NewtonConfig
from nekstab_next_tpu.io import save_field
from nekstab_next_tpu.mesh.mesh import BoundaryCondition as BC
from nekstab_next_tpu.postproc import bf_sensitivity, wave_maker
from nekstab_next_tpu.stepper.state import initial_state
from nekstab_next_tpu.utils import boundary_quadrature, surface_force_and_torque
from nekstab_next_tpu.utils.compile_cache import enable_compile_cache

PRESETS = {
    "quick": dict(nr=6, ntheta=16, order=6, outer_radius=20.0, k_dim=48,
                  horizon=1.0, settle=300, newton_kdim=40),
    "medium": dict(nr=10, ntheta=28, order=6, outer_radius=30.0, k_dim=64,
                   horizon=1.0, settle=400, newton_kdim=48),
    "full": dict(nr=16, ntheta=48, order=6, outer_radius=40.0, k_dim=128,
                 horizon=1.0, settle=600, newton_kdim=64),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="quick", choices=sorted(PRESETS))
    ap.add_argument("--reynolds", type=float, default=60.0)
    ap.add_argument("--outdir", default="cylinder_out")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--modes", default="direct,adjoint",
                    help="comma list: direct[,adjoint]; adjoint enables the "
                         "wavemaker/sensitivity stage")
    ap.add_argument("--precision", choices=["f64", "mixed"], default="f64",
                    help="'f64' (the default) or 'mixed': f32 settle + "
                         "Newton warm phase, then the mixed-precision "
                         "stepper (f64 state, f32 inner solves under f64 "
                         "refinement, 1e-8/1e-9 tolerances) for the "
                         "Newton polish and the eigen stages")
    args = ap.parse_args()
    enable_compile_cache()
    P = PRESETS[args.preset]
    os.makedirs(args.outdir, exist_ok=True)

    # schwarz pressure preconditioning: 19 vs 86 CG iterations to 1e-5 on
    # the cylinder O-mesh (ops/schwarz.py, round 4) — the same solve, just
    # cheaper; tolerances unchanged
    from nekstab_next_tpu.config import SolverConfig

    mixed = args.precision == "mixed"
    solver = (
        SolverConfig(pressure_tol=1e-8, velocity_tol=1e-9,
                     pressure_maxiter=500, velocity_maxiter=200,
                     pressure_precond="block")
        if mixed else SolverConfig(pressure_precond="schwarz")
    )
    case = CylinderCase(
        reynolds=args.reynolds, nr=P["nr"], ntheta=P["ntheta"],
        order=P["order"], outer_radius=P["outer_radius"],
        solver=solver, mixed_precision=mixed,
    )
    ns = case.make_ns()
    if mixed:
        assert ns._sem32 is not None, "mixed-precision refinement did not engage"
    nsteps = max(int(round(P["horizon"] / case.dt)), 1)
    dt = P["horizon"] / nsteps
    ns.dt = dt
    print(f"[cyl] Re={args.reynolds} nelem={case.mesh.nelem} order={P['order']} "
          f"dt={dt:.5f} nsteps/matvec={nsteps} precision={args.precision}",
          flush=True)

    # ---- 1. base flow --------------------------------------------------
    t0 = time.time()

    def newton_cb(it, res, T):
        print(f"[cyl] newton iter {it}  res={res:.3e}  ({time.time()-t0:.0f}s)",
              flush=True)

    if mixed:
        # warm phase on the f32 path (same mesh, same dt): DNS settle
        # + inexact Newton down to the f32-reachable 1e-4, then hand the
        # iterate to the mixed-IR stepper for the 1e-9 polish — all heavy
        # transient work at f32 speed, all converged numbers at f64 class
        case32 = CylinderCase(
            reynolds=args.reynolds, nr=P["nr"], ntheta=P["ntheta"],
            order=P["order"], outer_radius=P["outer_radius"], dt=dt,
            solver=SolverConfig(pressure_tol=1e-5, velocity_tol=1e-6,
                                pressure_maxiter=16, velocity_maxiter=10,
                                pressure_precond="block"),
            dtype=jnp.float32,
        )
        ns32 = case32.make_ns()
        st32 = ns32.make_state(case32.uniform_flow())
        st32 = jax.jit(lambda s: ns32.advance(s, P["settle"]))(st32)
        print(f"[cyl] f32 DNS settle {P['settle']} steps done "
              f"({time.time()-t0:.0f}s)", flush=True)
        warm = newton_krylov(
            ns32, st32.u, horizon=P["horizon"], nsteps=nsteps,
            cfg=NewtonConfig(tol=3e-4, max_iter=20), k_dim=P["newton_kdim"],
            callback=newton_cb,
        )
        print(f"[cyl] f32 Newton warm res={warm.residual:.2e} "
              f"({time.time()-t0:.0f}s)", flush=True)
        u_seed = jnp.asarray(np.asarray(warm.u), jnp.float64)
    else:
        st = ns.make_state(case.uniform_flow())
        st = jax.jit(lambda s: ns.advance(s, P["settle"]))(st)
        print(f"[cyl] DNS settle {P['settle']} steps done "
              f"({time.time()-t0:.0f}s)", flush=True)
        u_seed = st.u

    result = newton_krylov(
        ns, u_seed, horizon=P["horizon"], nsteps=nsteps,
        cfg=NewtonConfig(tol=1e-9, max_iter=30), k_dim=P["newton_kdim"],
        callback=newton_cb,
    )
    assert result.converged, f"Newton failed: {result.history[-3:]}"
    base = result.u
    save_field(os.path.join(args.outdir, "BF_cyl_00001.npz"), base,
               p=result.p, time=0.0, reynolds=args.reynolds)
    bq = boundary_quadrature(case.mesh, tags=(BC.WALL,))
    fx, fy, _ = surface_force_and_torque(case.sem, bq, base, result.p,
                                         viscosity=ns.nu)
    cd = 2.0 * float(fx)  # Cd = Fx / (1/2 rho U^2 D), U = D = 1
    print(f"[cyl] base flow converged res={result.residual:.2e} "
          f"Cd={cd:.4f} ({time.time()-t0:.0f}s)", flush=True)

    # ---- 2./3. direct + adjoint eigenmodes ------------------------------
    out = {"reynolds": args.reynolds, "preset": args.preset,
           "precision": args.precision, "nelem": case.mesh.nelem, "cd": cd,
           "newton_residual": result.residual}
    modes = tuple(m.strip() for m in args.modes.split(",") if m.strip())
    for mode in modes:
        res = linear_stability_analysis(
            ns, base, horizon=P["horizon"], nsteps=nsteps, mode=mode,
            k_dim=P["k_dim"], nev=2, tol=args.tol, nmodes_out=2,
        )
        lam = res.lam[0]
        print(f"[cyl] {mode}: lambda = {lam.real:+.6f} {lam.imag:+.6f}i  "
              f"St = {abs(lam.imag)/(2*np.pi):.5f}  res={res.residuals[0]:.2e} "
              f"({res.n_matvecs} matvecs, {time.time()-t0:.0f}s)", flush=True)
        out[mode] = dict(
            sigma=float(lam.real), omega=float(lam.imag),
            strouhal=float(abs(lam.imag) / (2 * np.pi)),
            ritz_residual=float(res.residuals[0]),
            n_matvecs=int(res.n_matvecs),
        )
        prefix = "d" if mode == "direct" else "a"
        re_, im_ = res.modes[0]
        save_field(os.path.join(args.outdir, f"{prefix}Re_cyl_00001.npz"),
                   re_, time=P["horizon"], eigenvalue=[lam.real, lam.imag])
        save_field(os.path.join(args.outdir, f"{prefix}Im_cyl_00001.npz"),
                   im_, time=P["horizon"], eigenvalue=[lam.real, lam.imag])
        np.savetxt(
            os.path.join(args.outdir, f"Spectre_NS{prefix}.dat"),
            np.column_stack([res.lam.real, res.lam.imag, res.residuals]),
            header="sigma omega ritz_residual",
        )
        out[f"{mode}_modes"] = res.modes

    # ---- 4. wavemaker + base-flow sensitivity ---------------------------
    if "adjoint" not in modes:
        out.pop("direct_modes", None)
        with open(os.path.join(args.outdir, "summary.json"), "w") as f:
            json.dump(out, f, indent=2)
        print(f"[cyl] done (direct-only) in {time.time()-t0:.0f}s -> "
              f"{args.outdir}/summary.json", flush=True)
        return
    d_re, d_im = out["direct_modes"][0]
    a_re, a_im = out["adjoint_modes"][0]
    wm = wave_maker(case.sem, d_re, d_im, a_re, a_im)
    save_field(os.path.join(args.outdir, "wm_cyl_00001.npz"),
               jnp.stack([wm, wm], axis=-1), time=0.0)
    sens = bf_sensitivity(case.sem, d_re, d_im, a_re, a_im)
    for k, v in sens.items():
        save_field(os.path.join(args.outdir, f"{k}_cyl_00001.npz"), v, time=0.0)
    ix = int(jnp.argmax(wm))
    print(f"[cyl] wavemaker peak {float(jnp.max(wm)):.3f} at "
          f"x={float(case.mesh.x.reshape(-1)[ix]):.2f} "
          f"y={float(case.mesh.y.reshape(-1)[ix]):.2f}", flush=True)
    out["wavemaker_peak"] = dict(
        value=float(jnp.max(wm)),
        x=float(case.mesh.x.reshape(-1)[ix]),
        y=float(case.mesh.y.reshape(-1)[ix]),
    )

    del out["direct_modes"], out["adjoint_modes"]
    with open(os.path.join(args.outdir, "summary.json"), "w") as f:
        json.dump(out, f, indent=2)
    print(f"[cyl] done in {time.time()-t0:.0f}s -> {args.outdir}/summary.json",
          flush=True)


if __name__ == "__main__":
    main()
