"""Headline benchmark: linearized-propagator (matvec) throughput on the
cylinder fixture, on one GPU.

The hot loop of every analysis in the reference is the time-stepper matvec
(SURVEY.md section 3.2: istep=1..nsteps of ``nek_advance`` per Arnoldi step).
We measure sustained degrees-of-freedom x time-steps per second of the
compiled tangent propagator at the reference's fixture scale: the flagship
rung is 768 elements at order 6 = ~75k velocity dof, matching the reference
cylinder fixture (1996 elements at order 5, ~75k dof —
/root/reference/examples/cylinder/SIZE:13-17).

Two code paths are timed:

* ``f32``   — single-precision compute (f32 fields, f32-reachable inner
  tolerances 1e-5/1e-6, iteration caps 16/10 at the accuracy knee);
* ``mixed`` — reference-grade (1e-8..1e-10) tolerances: f64 state with f32
  inner solves under f64 iterative refinement (stepper/navier_stokes.py).

Each rung prints its time per matvec, compile time and a roofline share from
XLA's cost analysis of the executable (the larger of flops / peak rate and
bytes / peak bandwidth, over the measured time) against the card's published
peaks (``PEAKS``).  ``--profile`` traces the flagship f32 matvec and reduces
the trace to device busy/idle time and the top device operations.

The reference publishes no wall-clock numbers (BASELINE.md), so
``vs_baseline`` is the ratio against a fixed nominal anchor of 1.0e7
dof-steps/s, kept to make progress visible across changes.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.
A run without a GPU fails.
"""

import json
import os
import subprocess
import sys
import time

NOMINAL_BASELINE = 1.0e7  # dof-steps/s anchor (no reference number exists)

# Published peaks, keyed by ``jax.Device.device_kind``: NVIDIA H100 Tensor
# Core GPU data sheet, SXM5 part (dense, no sparsity; at the full 700 W
# power limit — a card set lower cannot hold its top clock under load).
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(
        hbm_bytes_per_s=3.35e12, f32_flops=67e12, f64_flops=34e12,
    ),
}

NSTEPS = 50
REPS = 3

# (label, nr, ntheta, mixed)
CONFIGS = [
    ("flagship-f32", 16, 48, False),
    ("flagship-mixed", 16, 48, True),
    ("small-f32", 8, 24, False),
]

ROOT = os.path.dirname(os.path.abspath(__file__))


def require_gpu() -> dict:
    """Fail unless JAX's first device is a GPU with known peaks; print and
    return the device record."""
    import jax

    devs = jax.devices()
    d0 = devs[0]
    if d0.platform != "gpu":
        raise SystemExit(f"bench: no GPU found (first device: {d0.platform})")
    if d0.device_kind not in PEAKS:
        raise SystemExit(f"bench: no published peaks for {d0.device_kind!r}; "
                         "add them to PEAKS")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    dev = dict(platform=d0.platform, kind=d0.device_kind, count=len(devs),
               card=smi)
    print(f"bench: device {dev}", file=sys.stderr)
    return dev


def _flagship_solver(mixed: bool):
    from nekstab_next_tpu.config import SolverConfig

    if mixed:
        return SolverConfig(
            pressure_tol=1e-8, velocity_tol=1e-9,
            pressure_maxiter=500, velocity_maxiter=200,
            pressure_precond="block",
        )
    # exact element-block pressure preconditioner + Q1 coarse; the caps are
    # the accuracy knee found by tools/flagship_sweep.py (f32 output drift
    # at the f32 floor, ~2e-4)
    return SolverConfig(
        pressure_tol=1e-5, velocity_tol=1e-6,
        pressure_maxiter=16, velocity_maxiter=10,
        pressure_precond="block",
    )


def _operator(nr: int, ntheta: int, mixed: bool):
    import jax.numpy as jnp

    from nekstab_next_tpu.cases.cylinder import CylinderCase
    from nekstab_next_tpu.stepper.linearized import LinearizedOperator
    from nekstab_next_tpu.stepper.navier_stokes import NavierStokes

    solver = _flagship_solver(mixed)
    case = CylinderCase(
        reynolds=60.0, nr=nr, ntheta=ntheta, order=6, outer_radius=40.0,
        dtype=jnp.float64 if mixed else jnp.float32, solver=solver,
    )
    if mixed:
        ns = NavierStokes(
            case.sem, viscosity=1.0 / 60.0, dt=case.dt, u_bc=case.u_bc,
            solver=solver, mixed_precision=True,
        )
    else:
        ns = case.make_ns()
    base = case.uniform_flow()
    op = LinearizedOperator(ns, base, nsteps=NSTEPS)
    q = case.sem.vmask * jnp.asarray(base)
    return case, ns, op, q


def run(nr: int, ntheta: int, mixed: bool, peaks: dict) -> dict:
    import jax

    case, _, op, q = _operator(nr, ntheta, mixed)
    tc0 = time.perf_counter()
    out = op.matvec(q)
    jax.block_until_ready(out)
    t_compile = time.perf_counter() - tc0

    t0 = time.perf_counter()
    for _ in range(REPS):
        out = op.matvec(out)
    jax.block_until_ready(out)
    dt_wall = time.perf_counter() - t0

    ndof = case.mesh.npoints * 2  # velocity dofs
    value = ndof * NSTEPS * REPS / dt_wall

    # roofline share from XLA's own flop/byte estimate of the executable
    # (lowered through op._matvec, the jit object the timing used, so the
    # compile is reused)
    cost = op._matvec.lower(q).compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    peak_flops = peaks["f64_flops" if mixed else "f32_flops"]
    t_min = max(flops / peak_flops, nbytes / peaks["hbm_bytes_per_s"])
    return dict(
        value=value, ndof=ndof, nelem=case.mesh.nelem, mixed=mixed,
        t_compile=t_compile, t_per_matvec=dt_wall / REPS,
        xla_flops=flops, xla_bytes=nbytes,
        roofline_share=t_min * REPS / dt_wall,
    )


def trace_summary(path: str, top: int = 15) -> dict:
    """Reduce a ``jax.profiler`` trace (the ``.xplane.pb`` file) to device
    metrics: the window from the first to the last device operation, the
    busy time (union of operation intervals), the idle share, the idle gaps
    by size, and the operations with the most device time."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    events = []
    lines_seen = []
    copies = {}  # host<->device copies, e.g. a loop predicate read back
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        lines_seen += [f"{plane.name}:{ln.name}" for ln in lines]
        for ln in lines:
            for e in ln.events:
                if "memcpy" in e.name.lower():
                    t, n = copies.get(e.name, (0.0, 0))
                    copies[e.name] = (t + e.duration_ns / 1e6, n + 1)
        ops = [ln for ln in lines if "Ops" in ln.name]
        for ln in ops or [ln for ln in lines
                          if "Module" not in ln.name and "Step" not in ln.name]:
            events += [(e.name, e.start_ns, e.duration_ns) for e in ln.events]
    if not events:
        raise ValueError(f"no device operations in {path}; lines: {lines_seen}")
    iv = sorted((s, s + d) for _, s, d in events)
    busy = 0.0
    gaps = []
    cur_s, cur_e = iv[0]
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append(s - cur_e)
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = iv[-1][1] - iv[0][0]
    per_op = {}
    for name, _, d in events:
        t, n = per_op.get(name, (0.0, 0))
        per_op[name] = (t + d, n + 1)
    ranked = sorted(per_op.items(), key=lambda kv: -kv[1][0])[:top]
    edges = [1e3, 1e4, 1e5, 1e6]  # ns
    hist = {f"<{int(b / 1e3)}us": sum(1 for g in gaps if g < b) for b in edges}
    return dict(
        lines=lines_seen,
        window_ms=window / 1e6, busy_ms=busy / 1e6,
        idle_share=1.0 - busy / window, n_ops=len(events), n_gaps=len(gaps),
        gap_ms=sum(gaps) / 1e6, gaps_cumulative=hist,
        copies={k: dict(ms=v[0], count=v[1]) for k, v in copies.items()},
        top_ops=[dict(op=k, ms=v[0] / 1e6, count=v[1],
                      share_of_busy=v[0] / busy) for k, v in ranked],
    )


def profile(dev: dict) -> dict:
    """``bench.py --profile``: trace three flagship f32 matvecs (compiled
    outside the trace) into ``bench_profile/`` and reduce the trace."""
    import glob

    import jax

    _, _, op, q = _operator(16, 48, False)
    jax.block_until_ready(op.matvec(q))
    logdir = os.path.join(ROOT, "bench_profile")
    with jax.profiler.trace(logdir):
        out = q
        for _ in range(3):
            out = op.matvec(out)
        jax.block_until_ready(out)
    path = max(glob.glob(os.path.join(logdir, "plugins", "profile", "*",
                                      "*.xplane.pb")), key=os.path.getmtime)
    summary = trace_summary(path)
    summary.update(trace=path, device=dev, matvecs=3, nsteps=NSTEPS)
    with open(os.path.join(ROOT, "BENCH_PROFILE.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(f"bench: trace {path}: window {summary['window_ms']:.1f} ms, "
          f"busy {summary['busy_ms']:.1f} ms, idle share "
          f"{summary['idle_share']:.3f}, {summary['n_gaps']} gaps "
          f"{summary['gaps_cumulative']}; copies {summary['copies']}",
          file=sys.stderr)
    for r in summary["top_ops"]:
        print(f"bench:   {r['ms']:9.2f} ms {r['count']:7d}x "
              f"{r['share_of_busy']:.3f}  {r['op']}", file=sys.stderr)
    return summary


def main():
    from nekstab_next_tpu.utils.compile_cache import enable_compile_cache

    dev = require_gpu()
    enable_compile_cache()
    if "--profile" in sys.argv:
        s = profile(dev)
        print(json.dumps({"metric": "device_idle_share",
                          "value": s["idle_share"], "unit": "fraction",
                          "vs_baseline": 1.0, "device": dev}))
        return
    peaks = PEAKS[dev["kind"]]
    results = []
    for label, nr, ntheta, mixed in CONFIGS:
        r = run(nr, ntheta, mixed, peaks)
        r["label"] = label
        results.append(r)
        print(f"bench: {label}: {r['value']:.3e} dof-steps/s "
              f"({r['ndof']} dof, {r['t_per_matvec']*1e3:.1f} ms/matvec, "
              f"compile {r['t_compile']:.1f}s, roofline share "
              f"{r['roofline_share']:.4f})", file=sys.stderr)
    with open(os.path.join(ROOT, "BENCH_DETAIL.json"), "w") as fh:
        json.dump(dict(device=dev, rungs=results), fh, indent=1)
    best = max(r["value"] for r in results)
    print(json.dumps({
        "metric": "linearized_propagator_throughput",
        "value": best,
        "unit": "dof-steps/s",
        "vs_baseline": best / NOMINAL_BASELINE,
        "device": dev,
    }))


if __name__ == "__main__":
    main()
