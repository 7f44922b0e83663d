"""Synthetic free-stream-turbulence (FST) inflow.

JAX-native equivalent of the reference's FST subsystem (core/fst.f90:4-386):
a time-harmonic superposition of inflow velocity modes whose amplitudes
follow a von Karman energy spectrum, imposed as a time-dependent Dirichlet
boundary condition at the inlet.

Reference behaviour reproduced (fst.f90):

* a mode library of ``numk`` wavenumber shells x ``nmodes`` modes per shell,
  each mode m carrying a frequency ``omega_m``, a spanwise wavenumber
  ``beta_m`` (fst.f90:22-36 ``initWavenumbers``) and a complex velocity
  profile ``(uRe, uIm)(y)`` per component (fst.f90:38-58 ``initModes``);
* profiles are interpolated onto the inlet GLL nodes with natural cubic
  splines (fst.f90:95-135 ``interpolateModes``, spline/splint :294-386);
* amplitudes from the von Karman spectrum
  ``E(k) = (2/3) L * a (kL)^4 / (b + (kL)^2)^(17/6)``, a=1.606, b=1.35,
  trapezoid-normalized over the shell grid and scaled so the total kinetic
  energy matches the target intensity Tu (fst.f90:160-200 ``computeTurbu``);
* the inlet signal of mode m at node j:
  ``ampli * [uRe_j * (cos(+w t + b z_j) + cos(-w t + b z_j))
           + uIm_j * (-sin(+w t + b z_j) - sin(-w t + b z_j))]``
  (fst.f90:200-224).

Design differences (accelerator-first): everything static (mode table, spline
interpolation, inlet registry) is precomputed host-side with numpy; the
time-dependent evaluation is a single batched einsum over modes inside jit,
so the BC field is re-generated every step at negligible cost and the whole
stepper stays one compiled scan.  No files are required: modes can be given
programmatically or synthesized (``isotropic_modes``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

VON_KARMAN_A = 1.606
VON_KARMAN_B = 1.350


def von_karman_spectrum(k: np.ndarray, length: float) -> np.ndarray:
    """Unnormalized von Karman energy spectrum E(k) (fst.f90:180-183)."""
    kl = k * length
    return (2.0 / 3.0) * length * (VON_KARMAN_A * kl**4) / (
        (VON_KARMAN_B + kl**2) ** (17.0 / 6.0)
    )


def von_karman_amplitudes(
    k_ini: float, k_fin: float, numk: int, nmodes: int, tu: float, length: float
) -> np.ndarray:
    """Per-mode amplitude of each of the numk x nmodes modes, matching the
    reference's shell-staggered trapezoid normalization (fst.f90:170-200).

    Returns shape (numk,) — every mode within a shell gets the same
    amplitude sqrt(E(k) dk / nmodes)."""
    dkk = (k_fin - k_ini) / (numk - 1) if numk > 1 else (k_fin - k_ini) or 1.0
    kk1 = k_ini - dkk / 2
    kk2 = k_fin + dkk / 2
    dkke = (kk2 - kk1) / numk
    edges = kk1 + dkke * np.arange(numk + 1)
    e_edges = von_karman_spectrum(edges, length)
    integral = np.sum((e_edges[:-1] + e_edges[1:]) * dkke / 2)
    shells = k_ini + dkk * np.arange(numk)
    enspect = (1.0 / integral) * tu**2 * von_karman_spectrum(shells, length) * (3.0 / 2.0)
    # reference: ampli = sqrt(enspect*dkk/(nmodes*2)*2); its 2/3 spectrum
    # prefactor and 3/2 energy factor cancel the same way here
    return np.sqrt(enspect * dkk / nmodes)


def natural_cubic_spline(x: np.ndarray, y: np.ndarray, xq: np.ndarray) -> np.ndarray:
    """Natural cubic spline interpolation (the reference's Numerical-Recipes
    spline/splint pair, fst.f90:294-386), vectorized over query points."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = len(x)
    if n < 3:
        return np.interp(xq, x, y)
    h = np.diff(x)
    # solve tridiagonal system for second derivatives, natural BCs
    a = np.zeros(n)
    b = np.ones(n)
    c = np.zeros(n)
    d = np.zeros(n)
    a[1:-1] = h[:-1] / 6
    b[1:-1] = (h[:-1] + h[1:]) / 3
    c[1:-1] = h[1:] / 6
    d[1:-1] = (y[2:] - y[1:-1]) / h[1:] - (y[1:-1] - y[:-2]) / h[:-1]
    # Thomas algorithm
    cp = np.zeros(n)
    dp = np.zeros(n)
    cp[0] = c[0] / b[0]
    dp[0] = d[0] / b[0]
    for i in range(1, n):
        m = b[i] - a[i] * cp[i - 1]
        cp[i] = c[i] / m
        dp[i] = (d[i] - a[i] * dp[i - 1]) / m
    y2 = np.zeros(n)
    y2[-1] = dp[-1]
    for i in range(n - 2, -1, -1):
        y2[i] = dp[i] - cp[i] * y2[i + 1]

    xq = np.asarray(xq, dtype=np.float64)
    j = np.clip(np.searchsorted(x, xq) - 1, 0, n - 2)
    hj = x[j + 1] - x[j]
    A = (x[j + 1] - xq) / hj
    B = (xq - x[j]) / hj
    return A * y[j] + B * y[j + 1] + (
        (A**3 - A) * y2[j] + (B**3 - B) * y2[j + 1]
    ) * hj**2 / 6


def isotropic_modes(
    numk: int,
    nmodes: int,
    k_ini: float,
    k_fin: float,
    y_profile: np.ndarray,
    seed: int = 7,
    ndim: int = 2,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Synthesize a mode library when no precomputed (e.g. Orr-Sommerfeld
    continuous-branch) modes are available: random-phase Fourier modes in y
    per wavenumber shell, with unit-RMS profiles.

    Returns (omega (M,), beta (M,), profiles (M, npts, ndim, 2)) with
    M = numk*nmodes and the trailing axis = (Re, Im)."""
    rng = np.random.default_rng(seed)
    dkk = (k_fin - k_ini) / (numk - 1) if numk > 1 else 1.0
    M = numk * nmodes
    omega = np.zeros(M)
    beta = np.zeros(M)
    prof = np.zeros((M, len(y_profile), ndim, 2))
    m = 0
    for s in range(numk):
        k = k_ini + s * dkk
        for _ in range(nmodes):
            # split |k| between a frequency (streamwise, via Taylor
            # hypothesis omega = kx*U with U=1) and a wall-normal wavenumber
            th = rng.uniform(0, np.pi / 2)
            kx, ky = k * np.cos(th), k * np.sin(th)
            phase = rng.uniform(0, 2 * np.pi)
            # divergence-free 2-D polarization: u ~ +ky, v ~ -kx
            pol = np.array([ky, -kx]) / max(k, 1e-30)
            if ndim == 3:
                pol = np.array([ky, -kx, rng.uniform(-1, 1)])
                pol /= np.linalg.norm(pol)
            carg = ky * y_profile + phase
            for d in range(ndim):
                prof[m, :, d, 0] = pol[d] * np.cos(carg) * np.sqrt(2.0)
                prof[m, :, d, 1] = pol[d] * np.sin(carg) * np.sqrt(2.0)
            omega[m] = kx  # U_inf = 1 convection
            beta[m] = 0.0 if ndim == 2 else rng.uniform(-k, k) * 0.5
            m += 1
    return omega, beta, prof


def load_fst_data(directory: str, numk: int, nmodes: int,
                  ndim: int = 3) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Read the reference's ``FST_data/`` mode library (core/fst.f90:22-58).

    File layout (1-indexed ``%3.3d`` over the numk*nmodes modes):

    * ``wavenumber{m:03d}.dat`` — three lines: omega, (ignored), beta
      (``initWavenumbers``, fst.f90:22-36);
    * ``velocity{m:03d}.dat`` — first line npoints, then npoints rows of 7
      columns ``y  uRe uIm  vRe vIm  wRe wIm`` (``initModes``,
      fst.f90:38-58).  As in the reference's ``interpolateModes``
      (fst.f90:106-121, which splines every file against ``umodes(1,1,1)``)
      the y-grid of the FIRST file is the shared abscissa.

    Returns (omega (M,), beta (M,), profile_y (npts,),
    profiles (M, npts, ndim, 2)) ready for :meth:`FSTInflow.from_modes`."""
    import os

    M = numk * nmodes
    omega = np.zeros(M)
    beta = np.zeros(M)
    prof_rows = []
    profile_y = None
    for m in range(M):
        wpath = os.path.join(directory, f"wavenumber{m + 1:03d}.dat")
        with open(wpath) as fh:
            lines = [ln for ln in fh.read().splitlines()]
        omega[m] = float(lines[0].split()[0])
        beta[m] = float(lines[2].split()[0])
        vpath = os.path.join(directory, f"velocity{m + 1:03d}.dat")
        data = np.loadtxt(vpath, skiprows=1)
        npts = int(np.loadtxt(vpath, max_rows=1))
        data = np.atleast_2d(data)[:npts]
        if profile_y is None:
            profile_y = data[:, 0].copy()
        else:
            # the reference splines every file against the first file's
            # y-grid and silently mis-locates profiles from a mis-built
            # library — fail loudly instead (round-4 ADVICE)
            if data.shape[0] != profile_y.shape[0]:
                raise ValueError(
                    f"FST mode file {vpath} has {data.shape[0]} points but "
                    f"the first file's shared y-grid has {profile_y.shape[0]}"
                )
            if not np.allclose(data[:, 0], profile_y, rtol=1e-8, atol=1e-10):
                raise ValueError(
                    f"FST mode file {vpath} has a y-grid differing from the "
                    "first file's shared abscissa"
                )
        prof_rows.append(data[:, 1:7])
    prof = np.stack(prof_rows)  # (M, npts, 6): uRe uIm vRe vIm wRe wIm
    profiles = np.zeros((M, prof.shape[1], ndim, 2))
    for d in range(min(ndim, 3)):
        profiles[:, :, d, 0] = prof[:, :, 2 * d]
        profiles[:, :, d, 1] = prof[:, :, 2 * d + 1]
    return omega, beta, profile_y, profiles


def fst_from_directory(
    mesh,
    directory: str,
    numk: int,
    nmodes: int,
    tu: float,
    length: float,
    k_ini: float,
    k_fin: float,
    u_mean=(1.0, 0.0),
    inlet: Optional[np.ndarray] = None,
) -> "FSTInflow":
    """Build an :class:`FSTInflow` from a reference ``FST_data/`` directory:
    file ingestion (fst.f90 ``initWavenumbers``/``initModes``) + spline
    interpolation onto the inlet + von Karman amplitudes, replaying
    reference FST cases bit-comparably."""
    ndim = len(u_mean)
    omega, beta, profile_y, profiles = load_fst_data(
        directory, numk, nmodes, ndim=ndim
    )
    amps = np.repeat(
        von_karman_amplitudes(k_ini, k_fin, numk, nmodes, tu, length), nmodes
    )
    return FSTInflow.from_modes(
        mesh, omega, beta, profile_y, profiles, amps,
        u_mean=u_mean, inlet=inlet,
    )


@dataclass
class FSTInflow:
    """Time-dependent inlet velocity field  u_in(t)  as a jit-safe callable.

    Build with :meth:`from_modes`; call with a traced time to get the full
    (nelem, n, .., ndim) Dirichlet lift field (zero away from the inlet)."""

    inlet_idx: np.ndarray          # flat node indices of inlet GLL points
    shape: Tuple[int, ...]         # (nelem, n, n[, n], ndim)
    omega: jnp.ndarray             # (M,)
    beta_z: jnp.ndarray            # (M, P)  beta_m * z_j   (0 in 2-D)
    modes_re: jnp.ndarray          # (M, P, ndim) amplitude-scaled
    modes_im: jnp.ndarray          # (M, P, ndim)
    u_mean: jnp.ndarray            # (P, ndim) mean inflow at inlet nodes

    @classmethod
    def from_modes(
        cls,
        mesh,
        omega: np.ndarray,
        beta: np.ndarray,
        profile_y: np.ndarray,
        profiles: np.ndarray,
        amplitudes: np.ndarray,
        u_mean=(1.0, 0.0),
        inlet: Optional[np.ndarray] = None,
    ) -> "FSTInflow":
        """``profiles``: (M, len(profile_y), ndim, 2) complex mode shapes on a
        1-D y-grid; spline-interpolated onto the inlet nodes (fst.f90
        ``interpolateModes``).  ``amplitudes``: per-mode scale (M,) — e.g.
        ``von_karman_amplitudes(...)`` repeated over the shell.  ``inlet``:
        boolean mask over flat mesh nodes; defaults to x == min(x) Dirichlet
        nodes (the 'v  ' inlet faces of the reference's defineBC)."""
        ndim = profiles.shape[2]
        x = mesh.x.reshape(-1)
        y = mesh.y.reshape(-1)
        z = mesh.z.reshape(-1) if hasattr(mesh, "z") and ndim == 3 else np.zeros_like(x)
        if inlet is None:
            vm = np.asarray(mesh.vmask[..., 0]).reshape(-1)
            inlet = (np.abs(x - x.min()) < 1e-10) & (vm == 0.0)
        idx = np.nonzero(inlet)[0]
        yq, zq = y[idx], z[idx]

        M = profiles.shape[0]
        P = len(idx)
        mre = np.zeros((M, P, ndim))
        mim = np.zeros((M, P, ndim))
        for m in range(M):
            for d in range(ndim):
                mre[m, :, d] = natural_cubic_spline(profile_y, profiles[m, :, d, 0], yq)
                mim[m, :, d] = natural_cubic_spline(profile_y, profiles[m, :, d, 1], yq)
        amp = np.asarray(amplitudes).reshape(M, 1, 1)
        u_mean_arr = np.tile(np.asarray(u_mean, dtype=np.float64), (P, 1))

        field_shape = mesh.vmask.shape
        return cls(
            inlet_idx=idx,
            shape=field_shape,
            omega=jnp.asarray(omega),
            beta_z=jnp.asarray(np.asarray(beta)[:, None] * zq[None, :]),
            modes_re=jnp.asarray(amp * mre),
            modes_im=jnp.asarray(amp * mim),
            u_mean=jnp.asarray(u_mean_arr),
        )

    def inlet_velocity(self, t) -> jnp.ndarray:
        """(P, ndim) velocity at the inlet nodes at (traced) time t."""
        wt = self.omega[:, None] * t  # (M, 1)
        # cos(+wt+bz) + cos(-wt+bz) = 2 cos(wt) cos(bz);
        # -sin(+wt+bz) - sin(-wt+bz) = -2 cos(wt) sin(bz)   (fst.f90:202-206)
        auxc = jnp.cos(wt + self.beta_z) + jnp.cos(-wt + self.beta_z)  # (M, P)
        auxs = -jnp.sin(wt + self.beta_z) - jnp.sin(-wt + self.beta_z)
        turb = jnp.einsum("mp,mpd->pd", auxc, self.modes_re) + jnp.einsum(
            "mp,mpd->pd", auxs, self.modes_im
        )
        return self.u_mean + turb

    def __call__(self, t) -> jnp.ndarray:
        """Full-mesh Dirichlet lift field at time t (zero off-inlet)."""
        flat = jnp.zeros((int(np.prod(self.shape[:-1])), self.shape[-1]))
        flat = flat.at[self.inlet_idx].set(self.inlet_velocity(t))
        return flat.reshape(self.shape)

    def turbulence_intensity(self, nt: int = 64, period: Optional[float] = None):
        """Diagnostic: RMS intensity at the inlet, time-averaged over nt
        samples (for validating the Tu calibration)."""
        if period is None:
            wmin = float(jnp.min(jnp.abs(self.omega))) or 1.0
            period = 2 * np.pi / wmin
        ts = np.linspace(0.0, period, nt, endpoint=False)
        acc = 0.0
        for t in ts:
            up = self.inlet_velocity(t) - self.u_mean
            acc = acc + np.asarray(jnp.mean(jnp.sum(up**2, axis=-1)))
        return float(np.sqrt(acc / nt / self.u_mean.shape[1]))
