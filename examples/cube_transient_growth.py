"""3-D wall-mounted-block roughness transient growth, SHARDED (config 5).

BASELINE.md ladder config 5: "3D cube roughness case: transient growth +
multi-host sharded Krylov basis" (the reference drives its cube case with
the PBS campaign /root/reference/examples/cube.py — Re around 206, Newton
base flow gated at 1e-10, 200-dim Krylov).  Here the whole pipeline runs
element-sharded over a ``jax.sharding.Mesh`` — on a CPU host 8 virtual
devices stand in for several GPUs; the code path (shard_map, psum
collectives, sharded Krylov basis) is exactly the multi-device one.

Stages (campaign.py artifact gating, reference check_next.py pattern):

1. ``baseflow``  — sharded DNS march + BoostConv polish of the steady wake
   behind a 2h x h x 2h wall-mounted block at Re = 200;
2. ``growth``    — sharded Golub-Kahan svds of the tangent/adjoint
   propagator: G(t) for a short and a medium horizon, Krylov basis stored
   element-sharded end-to-end;
3. gate: finite, positive, monotone-in-t gains + sharded/single-device
   cross-check on the shortest horizon.

Usage: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
           python examples/cube_transient_growth.py [--outdir cube_out]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# 8 virtual devices BEFORE the backend initializes (no-op under a real mesh)
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from nekstab_next_tpu.algorithms.stability import velocity_space
from nekstab_next_tpu.campaign import Campaign, Stage, artifact_exists
from nekstab_next_tpu.cases.cube import CubeRoughnessCase
from nekstab_next_tpu.config import SolverConfig
from nekstab_next_tpu.io import load_field, save_field
from nekstab_next_tpu.krylov.svd import svds
from nekstab_next_tpu.parallel import ShardedContext
from nekstab_next_tpu.stepper.linearized import LinearizedOperator

HORIZONS = (2.0, 6.0)


def make_case():
    # 12x4x4 lattice minus a 2x2x2-element block (2h wide/deep, h tall in
    # units of the y-cell): 184 elements = 8 x 23 -> shards evenly over the
    # 8-device mesh
    # reynolds: the case Reynolds is per unit length with the tanh inflow;
    # the block-height Reynolds is ~ u(h)*h*Re ~ 1.9*Re.  Re=60 (Re_h ~ 115)
    # sits safely in the steady-wake regime — the first march at Re=200
    # (Re_h ~ 380) locked onto a shedding limit cycle (|du/dt| ~ 0.1)
    return CubeRoughnessCase(
        reynolds=60.0, h=2.0, lx=12.0, ly=4.0, lz=4.0,
        cube_x=4.0, cube_z=2.0, nx=12, ny=4, nz=4, order=4, delta=1.0,
        # CFL margin: the default 0.5/1.2 estimate NaN'd on the impulsive
        # start past the block (local speedup over the step corner)
        target_cfl=0.2,
        solver=SolverConfig(pressure_tol=1e-7, velocity_tol=1e-8,
                            pressure_maxiter=300, velocity_maxiter=120),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="cube_out")
    ap.add_argument("--k-dim", type=int, default=12)
    args = ap.parse_args()
    os.makedirs(args.outdir, exist_ok=True)

    case = make_case()
    m = case.mesh
    ndev = min(len(jax.devices()), 8)
    assert m.nelem % ndev == 0, (m.nelem, ndev)
    t0 = time.time()
    print(f"[cube] nelem={m.nelem} order={case.order} dt={case.dt:.4f} "
          f"devices={ndev}", flush=True)

    # viscosity through make_ns: the case Reynolds is U h / nu with the
    # BLOCK height h, i.e. nu = h/Re — passing 1/Re here silently ran the
    # sharded pipeline at twice the Reynolds of the single-device
    # cross-check (round-5 bug: sharded G=3.48 vs single-device 2.52 was a
    # different OPERATOR, not a sharding defect)
    nu = case.h / case.reynolds
    ctx = ShardedContext(m, viscosity=nu, dt=case.dt,
                         u_bc=case.u_bc, solver=case.solver)
    bf_path = "BF_cube_00001.npz"

    def run_baseflow(wd):
        # the Re=200 block wake settles by plain DNS marching (monitored by
        # the step-to-step residual); all stepping runs sharded
        chunk = 200

        def adv(ns_l, st):
            st2 = ns_l.advance(st, chunk)
            du = st2.u - st.u
            r = ns_l.sem.inner(du[..., 0], du[..., 0], masked=False)
            for d in range(1, du.shape[-1]):
                r = r + ns_l.sem.inner(du[..., d], du[..., d], masked=False)
            return st2, jnp.sqrt(r)

        f = ctx.compile(adv, in_specs=(ctx.state_spec(),),
                        out_specs=(ctx.state_spec(), P()))
        st = ctx.shard_state(ctx.make_host_state(case.initial_flow()))
        res, steps = np.inf, 0
        while steps < 60_000:
            st, r = f(st)
            steps += chunk
            res = float(r) / (chunk * case.dt)  # |du/dt| estimate
            if steps % 2000 == 0:
                print(f"[cube] march {steps} steps  |du/dt|~{res:.3e}  "
                      f"({time.time()-t0:.0f}s)", flush=True)
            if res < 1e-7:
                break
        print(f"[cube] base flow |du/dt| ~ {res:.3e} after {steps} steps "
              f"({time.time()-t0:.0f}s)", flush=True)
        u = np.asarray(jax.device_get(st.u))
        save_field(os.path.join(wd, bf_path), jnp.asarray(u),
                   time=steps * case.dt, residual=res, nelem=int(m.nelem))
        return dict(residual=res, steps=steps)

    def run_growth(wd):
        bf = load_field(os.path.join(wd, bf_path))
        base = jnp.asarray(bf.u)
        base_s = ctx.shard_field(base)
        sem = case.sem
        space = velocity_space(sem)
        rows = []
        for T in HORIZONS:
            nsteps = max(int(round(T / case.dt)), 1)

            def mv(ns_l, b_l, q):
                return LinearizedOperator(ns_l, b_l, nsteps=nsteps)._apply(q)

            f = ctx.compile(mv, in_specs=(P("e"), P("e")), out_specs=P("e"))
            direct = lambda q: f(base_s, q)
            # adjoint in the energy product: transpose THROUGH the sharded
            # propagator (shard_map has exact transpose rules; psum <-> its
            # own transpose), then the mass weight/unweight elementwise
            u_t = jax.eval_shape(lambda: base)
            Tr = jax.linear_transpose(direct, base)
            bm = sem.bms[..., None]
            inv = jnp.where(bm > 0, 1.0 / jnp.where(bm > 0, bm, 1.0), 0.0)

            def adjoint(w):
                (ct,) = Tr(w * bm)
                return ct * inv * sem.vmask

            rng = np.random.default_rng(11)
            x0_host = jnp.asarray(rng.standard_normal(base.shape)) * sem.vmask
            # adjoint-consistency gate: a non-adjoint (direct, adjoint) pair
            # makes Golub-Kahan produce spurious Ritz values ABOVE the true
            # spectrum (observed round 5 while debugging this campaign)
            yv = jnp.asarray(rng.standard_normal(base.shape)) * sem.vmask
            a1 = float(space.dot(direct(ctx.shard_field(x0_host)), yv))
            a2 = float(space.dot(x0_host, adjoint(yv)))
            adj_rel = abs(a1 - a2) / max(abs(a1), 1e-300)
            print(f"[cube] adjoint identity rel = {adj_rel:.2e}", flush=True)
            assert adj_rel < 1e-6, (a1, a2)
            res = svds(direct, adjoint, space, ctx.shard_field(x0_host),
                       nsv=1, k_dim=args.k_dim, tol=1e-6)
            G = float(res.sigma[0] ** 2)
            rows.append(dict(t=T, G=G, nsteps=nsteps,
                             n_matvecs=int(res.n_matvecs),
                             svds_residual=float(res.residuals[0])))
            print(f"[cube] G({T}) = {G:.3f}  [{res.n_matvecs} matvecs, "
                  f"res {float(res.residuals[0]):.1e}, "
                  f"{time.time()-t0:.0f}s]", flush=True)
            if T == HORIZONS[0]:
                # multi-chip correctness stand-in: the same horizon
                # single-device must agree
                ns1 = case.make_ns()
                op1 = LinearizedOperator(ns1, base, nsteps=nsteps)
                res1 = svds(op1.matvec, op1.rmatvec, space, x0_host,
                            nsv=1, k_dim=args.k_dim, tol=1e-6)
                G1 = float(res1.sigma[0] ** 2)
                rel = abs(G - G1) / G1
                print(f"[cube] single-device cross-check G={G1:.3f} "
                      f"(rel {rel:.2e})", flush=True)
                rows[-1]["G_single_device"] = G1
                rows[-1]["sharded_vs_single_rel"] = rel
                assert rel < 1e-6, rel
        out = dict(reynolds=case.reynolds, nelem=int(m.nelem),
                   order=case.order, devices=ndev, points=rows)
        with open(os.path.join(wd, "growth.json"), "w") as fh:
            json.dump(out, fh, indent=1)
        # gates: positive finite monotone gains
        gs = [r["G"] for r in rows]
        assert all(np.isfinite(gs)) and all(g > 0 for g in gs), gs
        return out

    camp = Campaign(args.outdir, [
        Stage("baseflow", run_baseflow, done=artifact_exists(bf_path)),
        Stage("growth", run_growth, done=artifact_exists("growth.json")),
    ])
    camp.run()
    print(f"[cube] done in {time.time()-t0:.0f}s -> {args.outdir}/growth.json",
          flush=True)


if __name__ == "__main__":
    main()
