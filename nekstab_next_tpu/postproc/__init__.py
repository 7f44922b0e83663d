"""Post-processing & diagnostics layer.

JAX-native rebuild of the reference's L4 postprocessing (core/postproc.f90,
core/sensitivity.f90): vortex-criterion library, running statistics,
perturbation kinetic-energy budgets, and the sensitivity/control maps
(wavemaker, base-flow sensitivity, steady-force sensitivity, delta forcing).
All element-local operations are batched over the (sharded) element axis —
embarrassingly parallel under the SPMD mesh."""

from .vortex import (
    velocity_gradient,
    vorticity,
    antisymmetric_criterion,
    q_criterion,
    symmetric_criterion,
    lambda2_criterion,
    delta_criterion,
    swirling_strength,
    omega_criterion,
)
from .stats import RunningStats
from .budget import energy_budget, EnergyBudget
from .sensitivity import (
    biorthogonalize,
    wave_maker,
    bf_sensitivity,
    delta_forcing,
    steady_force_sensitivity,
    forced_tangent_response,
)

__all__ = [
    "velocity_gradient",
    "vorticity",
    "antisymmetric_criterion",
    "q_criterion",
    "symmetric_criterion",
    "lambda2_criterion",
    "delta_criterion",
    "swirling_strength",
    "omega_criterion",
    "RunningStats",
    "energy_budget",
    "EnergyBudget",
    "biorthogonalize",
    "wave_maker",
    "bf_sensitivity",
    "delta_forcing",
    "steady_force_sensitivity",
    "forced_tangent_response",
]
