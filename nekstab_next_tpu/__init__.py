"""nekstab_next_tpu — global linear stability / bifurcation analysis in JAX.

A from-scratch JAX/XLA re-design of the capabilities of nekStab_next
(reference: /root/reference, a Fortran-90 toolbox on Nek5000 + LightKrylov).

Architecture (accelerator-first, not a port):

* The spectral-element incompressible Navier-Stokes time-stepper is a jitted
  ``lax.scan``; one matrix-free "matvec" (the exponential propagator
  ``M = exp(T L)`` of the reference, core/matvec.f90:56-146) is one compiled
  executable call.
* The linearized operator is the *exact* Jacobian-vector product of the
  discrete step (``jax.jvp``), and the adjoint is its *exact* transpose
  (``jax.linear_transpose``) — replacing the reference's hand-coded
  perturbation/adjoint solvers (Nek5000 ``ifpert/ifadj``) while guaranteeing
  <Au,v> = <u,A'v> to machine precision.
* Inner linear solves (pressure Poisson, velocity Helmholtz) go through
  ``lax.custom_linear_solve`` so differentiation/transposition of a step is
  again a linear solve with the same operator — no differentiating through CG
  iterations.
* State is a pytree sharded along the spectral-element axis over a
  ``jax.sharding.Mesh``; gather-scatter (the reference's gslib ``dssum``) and
  inner products reduce with XLA collectives (psum).
* k_dim-sized dense algebra (Hessenberg eig / Schur / lstsq) stays on host
  LAPACK via scipy, mirroring the reference's split (core/lapack_wrapper.f90).

Precision: double (x64) by default — the reference is double precision
throughout and its 1e-6..1e-10 tolerances demand it. Set NEKSTAB_X32=1 before
import to experiment in float32.
"""

import os as _os

import jax as _jax

if not _os.environ.get("NEKSTAB_X32"):
    _jax.config.update("jax_enable_x64", True)

# At DEFAULT precision XLA:GPU may run f32 matmuls and einsums in TF32 (10
# mantissa bits, ~3 decimal digits), which corrupts the f32 compute path:
# the tensor-product derivative operators lose ~3 digits and the elliptic CG
# stalls near 1e-3.  The SEM operators are tiny, bandwidth-bound matmuls —
# full f32 costs little and is required for solver tolerances of 1e-5..1e-6.
# chip_smoke.py checks for the leak: f32-vs-f64 drift would read ~1e-2.
_jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"

from .config import Config, AnalysisMode  # noqa: E402
