"""Smoke run of the cylinder stability pipeline on one GPU.

Drives the library's own entry points (``CylinderCase`` -> ``NavierStokes``
-> ``LinearizedOperator`` -> ``newton_krylov`` / ``linear_stability_analysis``)
on the flagship cylinder mesh (768 elements at order 6, ~75k velocity dof:
the reference's fixture scale) and holds each phase to a bound:

* device   -- JAX's first device is a GPU; prints the card, its power limit
              and the numerical settings;
* step     -- 50 nonlinear steps in f32 and in f64; f32-vs-f64 drift <= 1e-3
              (the f32 floor is ~2e-4; a TF32 leak reads near 1e-2);
* tangent  -- the 50-step tangent matvec in f32 and f64 (drift <= 1e-3), and
              a 10-step f64 matvec on the quick mesh, GPU against this
              process's CPU backend, <= 1e-8 (inner solves at 1e-12: at
              1e-8/1e-9 their early exit lets rounding move a CG iteration);
* mixed    -- the mixed-precision matvec (f64 state, f32 inner solves under
              iterative refinement) against the plain f64 matvec, both at
              1e-8/1e-9 inner tolerances, <= 1e-8;
* analysis -- a DNS settle, two Newton-Krylov iterations and one
              16-vector Krylov-Schur pass; the Newton residual must fall and
              the Ritz values must be finite.

``--multi`` runs only the 4-card phase: the flagship mesh sharded over four
GPUs by element (f64 steps, a tangent matvec, one Arnoldi step on the
sharded Krylov basis, inner solves at 1e-12), each compared with the same
on device 0, <= 1e-9.

Usage:  python chip_smoke.py [--multi]

The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
A failed phase exits non-zero without printing it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

if __name__ == "__main__":
    # the tangent phase compares the GPU with this process's CPU backend,
    # so a platform list that names only the GPU gets the CPU added
    _plat = os.environ.get("JAX_PLATFORMS")
    if _plat and "cpu" not in _plat.split(","):
        os.environ["JAX_PLATFORMS"] = _plat + ",cpu"

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

REYNOLDS = 60.0
BOUND_F32 = 1e-3      # f32 vs f64: step and matvec drift
BOUND_BACKEND = 1e-8  # f64 matvec, GPU vs CPU
BOUND_MIXED = 1e-8    # mixed-precision vs plain f64 matvec
BOUND_SHARDED = 1e-9  # 4-card sharded vs device 0


class SmokeError(RuntimeError):
    """A phase missed its bound or found no GPU."""


@dataclasses.dataclass(frozen=True)
class Sizes:
    mesh: dict          # CylinderCase geometry of the main phases
    nsteps: int         # steps per advance and per matvec
    quick_mesh: dict    # geometry of the GPU-vs-CPU comparison
    quick_nsteps: int
    settle: int         # DNS steps before Newton (a multiple of nsteps)
    newton_kdim: int    # GMRES vectors per Newton iteration
    eig_kdim: int       # Krylov-Schur subspace
    multi_nsteps: int   # steps and matvec length of the sharded phase


FLAGSHIP = Sizes(
    mesh=dict(nr=16, ntheta=48, order=6, outer_radius=40.0),
    nsteps=50,
    quick_mesh=dict(nr=6, ntheta=16, order=6, outer_radius=20.0),
    quick_nsteps=10,
    settle=200,
    newton_kdim=16,
    eig_kdim=16,
    multi_nsteps=10,
)


def _solver(kind: str):
    from nekstab_next_tpu.config import SolverConfig

    if kind == "f32":
        # f32-reachable tolerances with the iteration caps of the f32 bench
        return SolverConfig(pressure_tol=1e-5, velocity_tol=1e-6,
                            pressure_maxiter=16, velocity_maxiter=10,
                            pressure_precond="block")
    if kind == "tight":
        # inner solves far below the bounds that compare two reduction
        # orders (GPU vs CPU, sharded vs one device): at 1e-8/1e-9 an early
        # CG exit that moves by one iteration shows as ~1e-8 in the matvec
        return SolverConfig(pressure_tol=1e-12, velocity_tol=1e-12,
                            pressure_maxiter=500, velocity_maxiter=200,
                            pressure_precond="block")
    # the reference's tolerance class (examples/cylinder/1cyl.par)
    return SolverConfig(pressure_tol=1e-8, velocity_tol=1e-9,
                        pressure_maxiter=500, velocity_maxiter=200,
                        pressure_precond="block")


def _rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _bound(name: str, value: float, bound: float) -> None:
    ok = bool(np.isfinite(value)) and value <= bound
    print(f"  {name} = {value:.3e} (bound {bound:.0e}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise SmokeError(f"{name} = {value:.3e} exceeds {bound:.0e}")


def _finite(name: str, x) -> None:
    if not np.isfinite(np.asarray(x)).all():
        raise SmokeError(f"{name} is not finite")


def _ready(x):
    return jax.block_until_ready(x)


class Pipeline:
    """Cases, steppers, jitted advances and matvec results shared by the
    phases, plus a clock of the time JAX spends tracing and compiling."""

    def __init__(self, sizes: Sizes):
        self.sizes = sizes
        self._ns = {}
        self._adv = {}
        self._mv = {}
        self.compile_s = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event: str, duration: float, **_):
        if event.startswith("/jax/core/compile/"):
            self.compile_s += duration

    def close(self) -> None:
        jax.monitoring.unregister_event_duration_listener(self._on_event)

    def get(self, kind: str):
        """(case, stepper) for kind 'f32' | 'f64' | 'mixed'."""
        from nekstab_next_tpu.cases.cylinder import CylinderCase

        if kind not in self._ns:
            case = CylinderCase(
                reynolds=REYNOLDS, **self.sizes.mesh,
                dtype=jnp.float32 if kind == "f32" else jnp.float64,
                solver=_solver(kind), mixed_precision=kind == "mixed",
            )
            self._ns[kind] = (case, case.make_ns())
        return self._ns[kind]

    def advance(self, kind: str):
        if kind not in self._adv:
            _, ns = self.get(kind)
            n = self.sizes.nsteps
            self._adv[kind] = jax.jit(lambda st: ns.advance(st, n))
        return self._adv[kind]

    def matvec(self, kind: str):
        """(M q, first-call seconds, steady seconds) of the tangent
        propagator around the uniform flow, with q the masked uniform flow
        (the f32 floor of ~2e-4 was taken on this input)."""
        from nekstab_next_tpu.stepper.linearized import LinearizedOperator

        if kind not in self._mv:
            case, ns = self.get(kind)
            base = case.uniform_flow()
            q = case.sem.vmask * base
            op = LinearizedOperator(ns, base, nsteps=self.sizes.nsteps)
            t0 = time.perf_counter()
            _ready(op.matvec(q))
            t1 = time.perf_counter()
            out = _ready(op.matvec(q))
            t2 = time.perf_counter()
            _finite(f"{kind} matvec", out)
            self._mv[kind] = (np.asarray(out, np.float64), t1 - t0, t2 - t1)
            print(f"  {kind} {self.sizes.nsteps}-step matvec: first call "
                  f"{t1 - t0:.2f} s, steady {t2 - t1:.4f} s", flush=True)
        return self._mv[kind]


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------
def phase_device(n_cards: int) -> dict:
    devs = jax.devices()
    d0 = devs[0]
    if d0.platform != "gpu":
        raise SmokeError(
            f"no GPU found: JAX's first device is {d0.platform} "
            f"({d0.device_kind})"
        )
    if len(devs) < n_cards:
        raise SmokeError(f"{n_cards} GPUs needed, {len(devs)} found")
    print(f"device: {d0.device_kind}, {len(devs)} device(s)", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    for line in smi.stdout.strip().splitlines():
        print(f"card: {line.strip()}", flush=True)
    import nekstab_next_tpu  # noqa: F401  (sets the package's precision)

    print(f"jax {jax.__version__}, x64 {jax.config.jax_enable_x64}, "
          f"default matmul precision {jax.config.jax_default_matmul_precision}",
          flush=True)
    return dict(platform=d0.platform, kind=d0.device_kind, count=len(devs))


def phase_step(pipe: Pipeline) -> None:
    u = {}
    for kind in ("f32", "f64"):
        case, ns = pipe.get(kind)
        st0 = ns.make_state(case.uniform_flow())
        t0 = time.perf_counter()
        st = _ready(pipe.advance(kind)(st0))
        print(f"  {kind} {pipe.sizes.nsteps} steps: first call "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        _finite(f"{kind} step", st.u)
        u[kind] = st.u
    _bound("step drift f32 vs f64", _rel(u["f32"], u["f64"]), BOUND_F32)


def phase_tangent(pipe: Pipeline) -> None:
    from nekstab_next_tpu.cases.cylinder import CylinderCase
    from nekstab_next_tpu.stepper.linearized import LinearizedOperator
    from nekstab_next_tpu.utils.noise import velocity_noise

    m32 = pipe.matvec("f32")[0]
    m64 = pipe.matvec("f64")[0]
    _bound("matvec drift f32 vs f64", _rel(m32, m64), BOUND_F32)

    sizes = pipe.sizes
    out = {}
    for dev in (jax.devices()[0], jax.devices("cpu")[0]):
        with jax.default_device(dev):
            case = CylinderCase(reynolds=REYNOLDS, **sizes.quick_mesh,
                                solver=_solver("tight"))
            op = LinearizedOperator(case.make_ns(), case.uniform_flow(),
                                    nsteps=sizes.quick_nsteps)
            q = velocity_noise(case.sem, seed=1)
            r = _ready(op.matvec(q))
            _finite(f"quick matvec on {dev.platform}", r)
            out[dev.platform] = np.asarray(r)
    plats = sorted(out)
    if len(plats) == 1:  # a CPU-only rehearsal compares the CPU with itself
        plats = plats * 2
    _bound(f"quick f64 matvec {plats[0]} vs {plats[1]}",
           _rel(out[plats[0]], out[plats[1]]), BOUND_BACKEND)


def phase_mixed(pipe: Pipeline) -> None:
    _, ns = pipe.get("mixed")
    if ns._sem32 is None:
        raise SmokeError("the mixed-precision refinement route did not engage")
    mm = pipe.matvec("mixed")[0]
    m64 = pipe.matvec("f64")[0]
    _bound("mixed vs f64 matvec", _rel(mm, m64), BOUND_MIXED)


def phase_analysis(pipe: Pipeline) -> None:
    from nekstab_next_tpu.algorithms import (
        linear_stability_analysis, newton_krylov,
    )
    from nekstab_next_tpu.config import NewtonConfig

    sizes = pipe.sizes
    case, ns = pipe.get("f64")
    t0 = time.perf_counter()
    c0 = pipe.compile_s
    st = ns.make_state(case.uniform_flow())
    for _ in range(max(sizes.settle // sizes.nsteps, 1)):
        st = pipe.advance("f64")(st)
    _finite("settled flow", _ready(st.u))
    horizon = sizes.nsteps * ns.dt
    newton = newton_krylov(
        ns, st.u, horizon=horizon, nsteps=sizes.nsteps,
        cfg=NewtonConfig(max_iter=2, gmres_restarts=1),
        k_dim=sizes.newton_kdim,
    )
    res = [h[1] for h in newton.history]
    print(f"  Newton residuals {', '.join(f'{r:.3e}' for r in res)}; "
          f"{newton.n_matvecs} matvecs", flush=True)
    if len(res) != 2 or not res[1] < res[0]:
        raise SmokeError(f"Newton residual did not fall: {res}")
    eig = linear_stability_analysis(
        ns, newton.u, horizon=horizon, nsteps=sizes.nsteps,
        k_dim=sizes.eig_kdim, max_restarts=1,
    )
    _finite("Ritz values", eig.lam)
    lam = eig.lam[0]
    print(f"  leading lambda {lam.real:+.6f} {lam.imag:+.6f}i, Ritz residual "
          f"{eig.residuals[0]:.3e}; {eig.n_matvecs} matvecs", flush=True)
    print(f"  analysis wall {time.perf_counter() - t0:.1f} s, of which "
          f"compile {pipe.compile_s - c0:.1f} s", flush=True)


def phase_multi(sizes: Sizes, n_cards: int = 4) -> None:
    """The flagship mesh sharded over ``n_cards`` devices against device 0."""
    from jax.sharding import PartitionSpec as P

    from nekstab_next_tpu.algorithms.stability import velocity_space
    from nekstab_next_tpu.cases.cylinder import CylinderCase
    from nekstab_next_tpu.krylov import Basis
    from nekstab_next_tpu.krylov.arnoldi import arnoldi_step
    from nekstab_next_tpu.parallel.sharded import (
        ShardedContext, make_device_mesh,
    )
    from nekstab_next_tpu.stepper.linearized import LinearizedOperator
    from nekstab_next_tpu.utils.noise import velocity_noise

    n = sizes.multi_nsteps
    case = CylinderCase(reynolds=REYNOLDS, **sizes.mesh,
                        solver=_solver("tight"))
    ns = case.make_ns()
    ctx = ShardedContext(
        case.mesh, jmesh=make_device_mesh(n_cards),
        u_bc=case.u_bc, sponge_strength=np.asarray(case.sem.sponge),
        sponge_ref=case.sponge_ref, viscosity=1.0 / REYNOLDS, dt=case.dt,
        solver=_solver("tight"),
    )
    print(f"  {case.mesh.nelem} elements over {n_cards} devices, "
          f"{n} steps", flush=True)
    u0 = case.uniform_flow()
    q = velocity_noise(case.sem, seed=1)

    # f64 steps
    t0 = time.perf_counter()
    adv_s = ctx.compile(lambda ns_l, st: ns_l.advance(st, n),
                        in_specs=(ctx.state_spec(),),
                        out_specs=ctx.state_spec())
    u_s = _ready(adv_s(ctx.shard_state(ctx.make_host_state(u0))).u)
    u_1 = _ready(jax.jit(lambda st: ns.advance(st, n))(ns.make_state(u0)).u)
    print(f"  steps: {time.perf_counter() - t0:.1f} s", flush=True)
    _bound("sharded vs device-0 steps", _rel(u_s, u_1), BOUND_SHARDED)

    # tangent matvec
    mv_s = ctx.compile(
        lambda ns_l, b, v: LinearizedOperator(ns_l, b, nsteps=n)._apply(v),
        in_specs=(P("e"), P("e")), out_specs=P("e"),
    )
    base_s = ctx.shard_field(u0)
    op = LinearizedOperator(ns, u0, nsteps=n)
    t0 = time.perf_counter()
    m_s = _ready(mv_s(base_s, ctx.shard_field(q)))
    m_1 = _ready(op.matvec(q))
    print(f"  matvec: {time.perf_counter() - t0:.1f} s", flush=True)
    _bound("sharded vs device-0 matvec", _rel(m_s, m_1), BOUND_SHARDED)

    # one Arnoldi step on the element-sharded Krylov basis
    cols = []
    for matvec, space, q_in in (
        (lambda v: mv_s(base_s, v), velocity_space(ctx._sem_host),
         ctx.shard_field(q)),
        (op.matvec, velocity_space(case.sem), q),
    ):
        basis = Basis(space, q_in, capacity=4)
        q0, _ = space.normalize(q_in)
        basis.set(0, q0)
        H = np.zeros((4, 3))
        beta = arnoldi_step(matvec, space, basis, H, 0)
        _finite("Arnoldi column", H[:, 0])
        cols.append((H[:2, 0].copy(), np.asarray(basis.get(1)), beta))
    _bound("sharded vs device-0 Hessenberg column",
           _rel(cols[0][0], cols[1][0]), BOUND_SHARDED)
    _bound("sharded vs device-0 Arnoldi vector",
           _rel(cols[0][1], cols[1][1]), BOUND_SHARDED)


PHASES = {
    "step": phase_step,
    "tangent": phase_tangent,
    "mixed": phase_mixed,
    "analysis": phase_analysis,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-card sharded phase")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    try:
        device = phase_device(4 if args.multi else 1)
        from nekstab_next_tpu.utils.compile_cache import enable_compile_cache

        print(f"compile cache: {enable_compile_cache()}", flush=True)
        if args.multi:
            print("phase multi", flush=True)
            phase_multi(FLAGSHIP, n_cards=4)
        else:
            pipe = Pipeline(FLAGSHIP)
            try:
                for name, phase in PHASES.items():
                    t0 = time.perf_counter()
                    c0 = pipe.compile_s
                    print(f"phase {name}", flush=True)
                    phase(pipe)
                    print(f"phase {name} ok: {time.perf_counter() - t0:.1f} s "
                          f"(compile {pipe.compile_s - c0:.1f} s)", flush=True)
            finally:
                pipe.close()
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
