"""Flagship-f32 matvec: preconditioner x iteration-cap x layout sweep.

Round-4 question (VERDICT Next #2): with the schwarz pressure
preconditioner (19 CG iterations to 1e-5 on this mesh vs 86 for fdm+Q1),
where is the new f32 accuracy/speed knee, and does the gather-based lanes
path now win?  Each config reports ms/matvec and the relative drift of the
50-step tangent output vs a near-converged f32 reference.

Usage: python tools/flagship_sweep.py [--configs a,b,...]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from nekstab_next_tpu.cases.cylinder import CylinderCase
from nekstab_next_tpu.config import SolverConfig
from nekstab_next_tpu.stepper.linearized import LinearizedOperator
from nekstab_next_tpu.utils.compile_cache import enable_compile_cache

NSTEPS = 50
REPS = 3

CONFIGS = {
    # label: (precond, lanes, p_cap, v_cap); 'ref' first — drift anchor
    "ref": ("schwarz", False, 200, 100),
    "fdm-30-15": ("fdm", False, 30, 15),
    "sch-30-15": ("schwarz", False, 30, 15),
    "sch-20-15": ("schwarz", False, 20, 15),
    "sch-15-12": ("schwarz", False, 15, 12),
    "sch-10-10": ("schwarz", False, 10, 10),
    "sch-lanes-20-15": ("schwarz", True, 20, 15),
    "fdm-lanes-30-15": ("fdm", True, 30, 15),
    # 'block' = exact element blocks + Q1: no gather/scatter in the apply
    # (one batched (E, nloc, nloc) matmul) — ~41 iters to 1e-5 on this
    # mesh vs 86 (fdm) / 19 (schwarz, whose patch gather + segment-sum
    # makes each iteration dearer)
    "blk-30-15": ("block", False, 30, 15),
    "blk-20-15": ("block", False, 20, 15),
    "blk-15-12": ("block", False, 15, 12),
    "blk-12-10": ("block", False, 12, 10),
    "blk-10-8": ("block", False, 10, 8),
    "blk-8-6": ("block", False, 8, 6),
    # 'blkv-*': pressure block + VELOCITY block (exact assembled-operator
    # element blocks, ops/schwarz.py build_velocity_blocks)
    "blkv-15-10": ("block", False, 15, 10),
    "blkv-15-8": ("block", False, 15, 8),
    "blkv-12-8": ("block", False, 12, 8),
    # '-fix' = cg_fixed_iters: exact-cap fori_loop CG, no While trips, no
    # exit/live dots (SolverConfig.cg_fixed_iters)
    "blk-16-10": ("block", False, 16, 10),
    "blk-12-10-fix": ("block", False, 12, 10, {"cg_fixed_iters": True}),
    "blk-15-12-fix": ("block", False, 15, 12, {"cg_fixed_iters": True}),
    "blkv-12-8-fix": ("block", False, 12, 8, {"cg_fixed_iters": True}),
    "blkv-12-10-fix": ("block", False, 12, 10, {"cg_fixed_iters": True}),
}


def build(precond, lanes, p_cap, v_cap, vprecond="fdm", extra=None):
    solver = SolverConfig(
        pressure_tol=1e-5, velocity_tol=1e-6,
        pressure_maxiter=p_cap, velocity_maxiter=v_cap,
        pressure_precond=precond, lanes_layout=lanes,
        velocity_precond=vprecond,
        **(extra or {}),
    )
    case = CylinderCase(
        reynolds=60.0, nr=16, ntheta=48, order=6, outer_radius=40.0,
        dtype=jnp.float32, solver=solver,
    )
    ns = case.make_ns()
    base = case.uniform_flow()
    op = LinearizedOperator(ns, base, nsteps=NSTEPS)
    q = case.sem.vmask * jnp.asarray(base)
    return case, op, q


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default=",".join(CONFIGS))
    args = ap.parse_args()
    enable_compile_cache()

    ref_out = None
    for label in args.configs.split(","):
        cfg = CONFIGS[label]
        precond, lanes, p_cap, v_cap = cfg[:4]
        extra = cfg[4] if len(cfg) > 4 else None
        try:
            case, op, q = build(precond, lanes, p_cap, v_cap,
                                vprecond='block' if label.startswith('blkv') else 'fdm',
                                extra=extra)
            t0 = time.perf_counter()
            out = op.matvec(q)
            jax.block_until_ready(out)
            t_compile = time.perf_counter() - t0
            t0 = time.perf_counter()
            for _ in range(REPS):
                out2 = op.matvec(q)
            jax.block_until_ready(out2)
            dt = (time.perf_counter() - t0) / REPS
            ndof = case.mesh.npoints * 2
            drift = float("nan")
            if label == "ref":
                ref_out = np.asarray(out)
            elif ref_out is not None:
                o = np.asarray(out)
                drift = float(np.linalg.norm(o - ref_out)
                              / np.linalg.norm(ref_out))
            print(f"{label:18s} {dt*1e3:8.1f} ms/matvec  "
                  f"{ndof*NSTEPS/dt:.3e} dof-steps/s  drift={drift:.2e}  "
                  f"(compile {t_compile:.0f}s)", flush=True)
        except Exception as e:  # noqa: BLE001
            print(f"{label:18s} FAILED: {e!r}", flush=True)


if __name__ == "__main__":
    main()
