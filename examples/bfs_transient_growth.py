"""Backward-facing-step optimal transient growth vs Barkley et al. (2008).

The reference's quantitative regression (SURVEY.md section 4.2): the optimal
energy-growth envelope G(t) of the Re=500 backward-facing step, against the
digitized fig. 5 of Barkley, Blackburn & Sherwin (2008) shipped as
examples/back_fstep/barkley2008_fig5.ref (41 (t, G) pairs).  The reference
drives this with a PBS campaign (back_fstep/autorun.py sweeping endTime);
here it is a :class:`~nekstab_next_tpu.campaign.Campaign` of artifact-gated
stages: base flow (Newton seeded by SFD) -> G(t) sweep -> comparison table.

Usage:  python examples/bfs_transient_growth.py \
            [--preset quick|full] [--horizons 1.723 5.901 ...]

quick: coarsened mesh + the two shortest Barkley horizons; expects G within
~15% (resolution-limited).  full: fixture-scale mesh, more horizons.
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

from nekstab_next_tpu.algorithms import transient_growth_analysis
from nekstab_next_tpu.algorithms.fixed_point import boostconv_dns
from nekstab_next_tpu.campaign import Campaign, Stage, artifact_exists
from nekstab_next_tpu.config import SolverConfig
from nekstab_next_tpu.cases.bfs import BackwardFacingStepCase
from nekstab_next_tpu.io import load_field, save_field

BARKLEY_REF = "/root/reference/examples/back_fstep/barkley2008_fig5.ref"

PRESETS = {
    # legacy coarse layout (uniform x) — demonstrably too coarse at the
    # step corner (G low by ~58%); kept for smoke runs only
    "quick": dict(order=5, eu=6, ed=24, ey=6, outflow=35.0, k_dim=24,
                  horizons=(1.723, 5.901)),
    # reference-fixture-like: geometric grading into the step corner
    # (reference bfs.re2: first downstream cell 0.1, 20 y-elements) and the
    # reference sponge/energy-mask setup (bfs.par userparam08-10)
    # horizons: the three t >= 9 points carry the quantitative gate (the
    # published curve is reliably readable there; measured round 4:
    # -10.0% / +2.0% at 9.795 / 13.729 on this mesh, and the t <= 6
    # points deviate identically on the reference's own 1670-element
    # fixture mesh + base flow — see VALIDATION.md / growth_refmesh.json);
    # the two short horizons are reported informationally
    "barkley": dict(order=5, eu=8, ed=28, ey=10, outflow=50.0, k_dim=24,
                    horizons=(1.723, 5.901, 9.795, 11.793, 13.729),
                    step_dx=0.22, sponge=True),
    "full": dict(order=6, eu=10, ed=40, ey=14, outflow=50.0, k_dim=48,
                 horizons=(1.723, 3.853, 5.901, 9.795, 15.9),
                 step_dx=0.1, sponge=True),
}


def build_case(P, dtype=None, solver=None, sponge=None):
    """Shared case construction for the campaign and the tools."""
    kw = dict(
        reynolds=500.0, order=P["order"], elems_upstream=P["eu"],
        elems_downstream=P["ed"], elems_y=P["ey"],
        outflow_length=P["outflow"],
        step_dx=P.get("step_dx"),
        sponge=P.get("sponge", False) if sponge is None else sponge,
    )
    if solver is not None:
        kw["solver"] = solver
    if dtype is not None:
        kw["dtype"] = dtype
    return BackwardFacingStepCase(**kw)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="quick", choices=sorted(PRESETS))
    ap.add_argument("--outdir", default="bfs_out")
    ap.add_argument("--horizons", type=float, nargs="*", default=None)
    ap.add_argument("--gate", type=float, default=0.15,
                    help="relative G(t) tolerance vs Barkley for the "
                         "campaign to pass (>= 3 horizons required)")
    args = ap.parse_args()
    P = PRESETS[args.preset]
    horizons = tuple(args.horizons) if args.horizons else P["horizons"]

    # build_case honors step_dx/sponge, so the campaign and the tools
    # (tools/bfs_cpu_probe.py) construct IDENTICAL cases (round-3 bug: main() built the legacy uniform mesh inline, so
    # the graded 'barkley' preset never actually ran).  The base-flow march
    # runs unsponged (steady state of pure NS); the TG stage turns the
    # sponge on with sponge_ref = base flow.  Schwarz pressure
    # preconditioning: the box-FDM two-level collapses on the graded
    # presets (1779 CG iterations to 1e-5; ops/schwarz.py holds ~50).
    solver = SolverConfig(pressure_precond="schwarz")
    case = build_case(P, sponge=False, solver=solver)
    ns = case.make_ns()
    t0 = time.time()
    print(f"[bfs] nelem={case.mesh.nelem} order={P['order']} dt={case.dt:.4f}",
          flush=True)

    bf_path = "BF_bfs_00001.npz"

    def mesh_fingerprint():
        m = case.mesh
        return dict(nelem=int(m.nelem), order=int(P["order"]),
                    xhash=float(np.sum(np.asarray(m.x) ** 2)))

    def baseflow_ok(wd):
        """Quality-gated done check: artifact exists AND its stored residual
        meets the gate AND it was computed on THIS preset's mesh (round-3
        bug: an existence-only check banked a base flow from the wrong mesh
        at residual 1.95e-6; the reference gates at 1e-10 on
        residu_newton.dat, /root/reference/check_next.py:66-70)."""
        p = os.path.join(wd, bf_path)
        if not os.path.exists(p):
            return False
        f = load_field(p)
        fp = mesh_fingerprint()
        ok = (f.meta.get("residual", np.inf) < 2e-6
              and f.meta.get("nelem") == fp["nelem"]
              and abs(f.meta.get("xhash", -1.0) - fp["xhash"]) < 1e-6 * (1 + fp["xhash"]))
        if not ok:
            print(f"[bfs] stale/unconverged {bf_path} "
                  f"(meta={f.meta}) — recomputing", flush=True)
        return ok

    def run_baseflow(wd):
        # The Re=500 2-D BFS is linearly stable (its interest is transient
        # growth: Barkley et al. 2008 — the 2-D flow stays stable to
        # Re ~ 3000), so the steady state is reached by plain DNS marching.
        # A march written earlier to bfs_march.npz (an f32 accelerator
        # march of the same mesh) is continued in f64 below.  Otherwise: a
        # BoostConv-accelerated march (reference uparam 1.2,
        # core/fixedp.f90:218-329).
        march = os.path.join(wd, "bfs_march.npz")
        u0 = None
        if os.path.exists(march):
            mf = load_field(march)
            fp = mesh_fingerprint()
            same_mesh = (
                mf.u.shape[0] == case.mesh.nelem
                and mf.meta.get("nelem") == fp["nelem"]
                and abs(mf.meta.get("xhash", -1.0) - fp["xhash"])
                < 1e-6 * (1 + fp["xhash"])
            )
            if same_mesh:
                u0 = jnp.asarray(mf.u)
                print(f"[bfs] continuing from march {march}", flush=True)
            else:
                print(f"[bfs] ignoring {march}: wrong mesh "
                      f"(meta={mf.meta}, want {fp})", flush=True)
        if u0 is None:
            last = [0.0]

            def cb(steps, res):
                if time.time() - last[0] > 30:
                    last[0] = time.time()
                    print(f"[bfs] boostconv step {steps}  res={res:.3e}  "
                          f"({time.time()-t0:.0f}s)", flush=True)

            st = jax.jit(lambda s: ns.advance(s, int(round(20.0 / case.dt))))(
                ns.make_state(case.initial_flow()))
            r = boostconv_dns(ns, st.u, skip=50, subspace=12, tol=1e-4,
                              max_steps=200_000, callback=cb)
            u0 = r.u
            print(f"[bfs] boostconv reached res={r.residual:.2e} "
                  f"({r.iterations} steps, {time.time()-t0:.0f}s)", flush=True)

        # Finish with an f64 DNS continuation: the flow is linearly stable,
        # so the march converges unconditionally — unlike Newton, whose
        # GMRES stagnates on this Jacobian (transient growth G ~ 1e4 makes
        # J = M - I pathologically non-normal; even one 120-dim cycle
        # returns steps that *raise* the residual).  The per-step residual
        # ||u(t)-u(t-dt)|| <= 2e-6 puts the steady-state defect |du/dt|
        # at ~1.5e-4, two orders below the G(t) accuracy this comparison
        # targets (~10% at quick resolution).
        chunk = 2000
        run = jax.jit(lambda s: ns.advance(s, chunk - 1))
        one = jax.jit(ns.step)
        st = ns.make_state(u0)
        res = np.inf
        for it in range(60):
            st1 = run(st)
            st = one(st1)
            du = st.u - st1.u
            res = float(jnp.sqrt(sum(
                case.sem.inner(du[..., d], du[..., d], masked=False)
                for d in range(2))))
            print(f"[bfs] f64 march step {(it+1)*chunk}  res={res:.3e}  "
                  f"({time.time()-t0:.0f}s)", flush=True)
            if res < 2e-6:
                break
        assert res < 2e-6, f"f64 march stalled at {res:.3e}"
        save_field(os.path.join(wd, bf_path), st.u, p=st.p, time=0.0,
                   residual=res, **mesh_fingerprint())
        print(f"[bfs] base flow converged res={res:.2e} "
              f"({time.time()-t0:.0f}s)", flush=True)
        return {"residual": res}

    def run_growth(wd):
        base = jnp.asarray(load_field(os.path.join(wd, bf_path)).u)
        # TG runs with the preset's sponge active (reference TG fixture
        # bfs.par userparam08-10): same mesh, perturbations damped in the
        # sponge zones and the energy norm (bm1s) zeroed there; the sponge
        # damps toward the base flow so it remains an equilibrium.
        if P.get("sponge"):
            case_tg = build_case(P, solver=solver)
            ns_tg = case_tg.make_ns(sponge_ref=base)
        else:
            ns_tg = ns
        ref = np.loadtxt(BARKLEY_REF) if os.path.exists(BARKLEY_REF) else None
        rows = []
        for T in horizons:
            nsteps = max(int(round(T / case.dt)), 1)
            res = transient_growth_analysis(
                ns_tg, base, horizon=T, nsteps=nsteps, nsv=1,
                k_dim=P["k_dim"], tol=1e-6,
            )
            G = float(res.gains[0])
            Gref = float(np.interp(T, ref[:, 0], ref[:, 1])) if ref is not None else None
            rows.append(dict(t=T, G=G, G_barkley=Gref,
                             rel=None if Gref is None else G / Gref - 1.0))
            print(f"[bfs] G({T}) = {G:.2f}"
                  + (f"  (Barkley {Gref:.2f}, {100*(G/Gref-1):+.1f}%)"
                     if Gref else ""), flush=True)
        with open(os.path.join(wd, "growth.json"), "w") as fh:
            json.dump(rows, fh, indent=1)
        # quantitative gate (reference autorun.py + barkley2008_fig5.ref):
        # the campaign FAILS unless >= 3 horizons agree with Barkley to
        # the gate tolerance — an existence-only check banked a -58%
        # result in round 3
        within = [r for r in rows
                  if r["rel"] is not None and abs(r["rel"]) <= args.gate]
        if len([r for r in rows if r["rel"] is not None]) >= 3:
            assert len(within) >= 3, (
                f"Barkley G(t) gate: only {len(within)} of {len(rows)} "
                f"horizons within {args.gate:.0%}: {rows}"
            )
        return {"points": rows, "n_within_gate": len(within)}

    campaign = Campaign(args.outdir, [
        Stage("baseflow", run_baseflow, done=baseflow_ok),
        Stage("transient_growth", run_growth,
              done=artifact_exists("growth.json")),
    ])
    rep = campaign.run()
    print(f"[bfs] done in {time.time()-t0:.0f}s -> {args.outdir}/report.json",
          flush=True)


if __name__ == "__main__":
    main()
