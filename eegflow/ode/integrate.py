"""Fixed-step on-device integrators for the APF system.

Replaces ``scipy.integrate.odeint``/``solve_ivp`` (ref: 05_ode_model.py:137-196)
— which re-enter a Python RHS callback per step and force per-sample host
loops (ref 06:367-406, 08:264, 10:245) — with jitted integrators that
``vmap`` over initial states and rate vectors, so a whole batch (or a whole
DE population) integrates as one XLA computation:

* :func:`rk4_solve` — classic RK4 with ``substeps`` per output interval; the
  general path (works for the clamped/modulated field, differentiable).
* :func:`expm_solve` — exact propagator ``expm(Q^T dt)`` applied by a scan;
  machine-precision for the linear (simplex-interior) regime, and the
  fastest path because the whole trajectory is one tiny matmul chain.

Every 3x3 product here passes ``precision=HIGHEST``: at the default precision
a GPU may run f32 products in TF32 (about three decimal digits), which would
break the 1e-5 parity with ``scipy.integrate.solve_ivp``. The products are
3x3, so full f32 costs nothing measurable.
* :func:`solve` — reference-parity wrapper matching the semantics of
  ``CognitiveStateODE.solve`` (ref 05:137-169): linspace grid, initial-state
  normalization, final clip-to-[0,1] + simplex renormalization.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from eegflow.ode.field import apf_field, transition_matrix

_HIGHEST = lax.Precision.HIGHEST


def _rk4_step(y: jnp.ndarray, k: jnp.ndarray, dt) -> jnp.ndarray:
    f1 = apf_field(y, k)
    f2 = apf_field(y + 0.5 * dt * f1, k)
    f3 = apf_field(y + 0.5 * dt * f2, k)
    f4 = apf_field(y + dt * f3, k)
    return y + (dt / 6.0) * (f1 + 2.0 * f2 + 2.0 * f3 + f4)


@functools.partial(jax.jit, static_argnames=("n_points", "substeps"))
def rk4_solve(
    y0: jnp.ndarray,
    t0: float,
    t1: float,
    n_points: int,
    k: jnp.ndarray,
    substeps: int = 16,
) -> jnp.ndarray:
    """Integrate from ``t0`` to ``t1`` on a ``linspace(t0, t1, n_points)`` grid.

    ``y0 (..., 3)`` and ``k (..., 6)`` broadcast over leading axes. Returns the
    trajectory ``(n_points, ..., 3)`` including the initial point. Each output
    interval is integrated with ``substeps`` RK4 steps, keeping the global
    error well below 1e-5 against scipy for the reference's rate ranges.
    """
    k = jnp.asarray(k)
    y0 = jnp.asarray(y0)
    batch = jnp.broadcast_shapes(y0.shape[:-1], k.shape[:-1])
    y0 = jnp.broadcast_to(y0, batch + (3,))
    dt_out = (t1 - t0) / max(n_points - 1, 1)
    dt = dt_out / substeps

    def interval(y, _):
        y = lax.fori_loop(0, substeps, lambda i, yy: _rk4_step(yy, k, dt), y)
        return y, y

    _, traj = lax.scan(interval, y0, None, length=n_points - 1)
    return jnp.concatenate([y0[None], traj], axis=0)


def _expm_taylor(a: jnp.ndarray, order: int = 12, squarings: int = 4) -> jnp.ndarray:
    """Solve-free batched matrix exponential: scaling + Taylor + squaring.

    ``jax.scipy.linalg.expm`` runs Pade with batched LU solves — slow for
    many tiny (3x3) matrices. Here: scale by 2^-squarings (rate matrices
    in this model have norm <~ 2.5, so the scaled norm is <~ 0.16), Horner-sum
    the Taylor series (pure batched matmuls), square back. Truncation error
    ~ 0.16^13/13! — far below f32 resolution; parity vs scipy is tested.
    """
    a = a / (2.0**squarings)
    eye = jnp.broadcast_to(jnp.eye(a.shape[-1], dtype=a.dtype), a.shape)
    # Horner: E = I + A(I + A/2 (I + A/3 (...)))
    result = eye
    for n in range(order, 0, -1):
        # HIGHEST: no TF32 on the card (module docstring)
        result = eye + jnp.einsum("...ij,...jk->...ik", a / n, result,
                                  precision=_HIGHEST)
    for _ in range(squarings):
        result = jnp.einsum("...ij,...jk->...ik", result, result,
                            precision=_HIGHEST)
    return result


@functools.partial(jax.jit, static_argnames=("n_points",))
def expm_solve(
    y0: jnp.ndarray, t0: float, t1: float, n_points: int, k: jnp.ndarray
) -> jnp.ndarray:
    """Exact linear solve: one matrix exponential, then a propagator scan.

    Valid whenever the trajectory stays non-negative (always true starting on
    the simplex with non-negative rates, where the clamp in the RHS is inert).
    """
    dt = (t1 - t0) / max(n_points - 1, 1)
    q = transition_matrix(jnp.asarray(k))
    prop = _expm_taylor(jnp.swapaxes(q, -1, -2) * dt)  # (..., 3, 3)
    y0 = jnp.asarray(y0)

    def step(y, _):
        # HIGHEST: no TF32 on the card (module docstring)
        y_next = jnp.einsum("...ij,...j->...i", prop, y, precision=_HIGHEST)
        return y_next, y_next

    _, traj = lax.scan(step, jnp.broadcast_to(y0, q.shape[:-2] + (3,)), None,
                       length=n_points - 1)
    return jnp.concatenate([jnp.broadcast_to(y0, q.shape[:-2] + (3,))[None], traj], axis=0)


def _project_simplex(traj: jnp.ndarray) -> jnp.ndarray:
    """Clip to [0,1] then renormalize rows to sum 1 (ref 05:166-168)."""
    traj = jnp.clip(traj, 0.0, 1.0)
    return traj / jnp.sum(traj, axis=-1, keepdims=True)


def solve(
    initial_state,
    t_span: Tuple[float, float],
    n_points: int = 100,
    k: Optional[jnp.ndarray] = None,
    method: str = "rk4",
    substeps: int = 16,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Reference-parity solve (ref 05:137-169).

    Normalizes the initial state, integrates on ``linspace(*t_span, n_points)``,
    clips and renormalizes to the simplex. Returns ``(t, trajectory)`` with
    trajectory shape ``(n_points, ..., 3)``.
    """
    from eegflow.ode.field import DEFAULT_RATES, rates_to_array

    if k is None:
        k = rates_to_array(DEFAULT_RATES)
    k = jnp.asarray(k)
    y0 = jnp.asarray(initial_state, jnp.float32)
    y0 = y0 / jnp.sum(y0, axis=-1, keepdims=True)
    t = jnp.linspace(t_span[0], t_span[1], n_points)
    if method == "expm":
        traj = expm_solve(y0, t_span[0], t_span[1], n_points, k)
    else:
        traj = rk4_solve(y0, t_span[0], t_span[1], n_points, k, substeps=substeps)
    return t, _project_simplex(traj)


@functools.partial(jax.jit, static_argnames=("n_points", "substeps", "method"))
def solve_batch(
    y0: jnp.ndarray,
    t0: float,
    t1: float,
    n_points: int,
    k: jnp.ndarray,
    method: str = "expm",
    substeps: int = 16,
) -> jnp.ndarray:
    """Batched solve: ``y0 (B, 3)``, ``k (B, 6)`` -> ``(B, n_points, 3)``.

    This single call replaces the reference's per-sample Python ODE loops
    (ref 06:367-406, 08:264-276, 10:245-278) — the biggest structural win of
    the rebuild. Simplex projection applied as in the reference solve.
    """
    y0 = y0 / jnp.sum(y0, axis=-1, keepdims=True)
    if method == "expm":
        traj = expm_solve(y0, t0, t1, n_points, k)
    else:
        traj = rk4_solve(y0, t0, t1, n_points, k, substeps=substeps)
    return jnp.moveaxis(_project_simplex(traj), 0, 1)  # (B, n_points, 3)


@functools.partial(jax.jit, static_argnames=("n_points",))
def expm_solve_piecewise(
    y0: jnp.ndarray, t0: float, t1: float, n_points: int, ks: jnp.ndarray
) -> jnp.ndarray:
    """Piecewise-constant-rate solve: one exact propagator per output segment.

    ``ks (n_points-1, ..., 6)`` holds the (constant) rates of each segment of
    the ``linspace(t0, t1, n_points)`` grid. All segment propagators
    ``expm(Q_s^T dt)`` are built in ONE batched Taylor evaluation, then a
    scan applies them — machine-precision for genuinely piecewise-constant
    modulation, the on-device answer to the reference's time-varying-rate
    solve (ref 05_ode_model.py:171-196) without per-step host callbacks.
    """
    ks = jnp.asarray(ks)
    assert ks.shape[0] == n_points - 1, (
        f"ks must carry one rate vector per segment: {ks.shape[0]} != {n_points - 1}"
    )
    dt = (t1 - t0) / max(n_points - 1, 1)
    q = transition_matrix(ks)                         # (S, ..., 3, 3)
    props = _expm_taylor(jnp.swapaxes(q, -1, -2) * dt)
    y0 = jnp.broadcast_to(jnp.asarray(y0), q.shape[1:-2] + (3,))

    def step(y, p):
        # HIGHEST: no TF32 on the card (module docstring)
        y_next = jnp.einsum("...ij,...j->...i", p, y, precision=_HIGHEST)
        return y_next, y_next

    _, traj = lax.scan(step, y0, props)
    return jnp.concatenate([y0[None], traj], axis=0)


def solve_with_modulation(
    initial_state,
    t_span: Tuple[float, float],
    modulation_func,
    n_points: int = 100,
    k: Optional[jnp.ndarray] = None,
    method: str = "rk4",
    substeps: int = 16,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Reference-parity time-varying-rate solve (ref 05_ode_model.py:171-196).

    ``modulation_func(t, rates)`` receives the scalar time and the base rate
    dict (keys ``RATE_NAMES``) and returns the modified rate dict, exactly
    like the reference's ``modulation_func(t, params)``. It must be traceable
    (jnp ops on ``t``) for ``method="rk4"``.

    Methods:
      * ``"rk4"`` — non-autonomous RK4 with rates evaluated at the stage
        times; O(dt^4)-accurate for smooth modulation (the reference's LSODA
        use case).
      * ``"expm"`` — piecewise-constant rates sampled at segment midpoints,
        integrated exactly per segment (:func:`expm_solve_piecewise`);
        machine-precision when the modulation is itself piecewise-constant
        on the output grid.

    Returns ``(t, solution)`` with the solution clipped + renormalized to the
    simplex, matching ``CognitiveStateODE.solve_with_modulation``.
    """
    from eegflow.ode.field import DEFAULT_RATES, RATE_NAMES, rates_to_array

    if k is None:
        k = rates_to_array(DEFAULT_RATES)
    k = jnp.asarray(k)
    base = {name: k[..., i] for i, name in enumerate(RATE_NAMES)}
    y0 = jnp.asarray(initial_state, jnp.float32)
    y0 = y0 / jnp.sum(y0, axis=-1, keepdims=True)
    t = jnp.linspace(t_span[0], t_span[1], n_points)

    def rate_fn(tt):
        mod = modulation_func(tt, dict(base))
        return jnp.stack([jnp.asarray(mod[name], jnp.float32)
                          for name in RATE_NAMES], axis=-1)

    if method == "expm":
        # midpoints are CONCRETE here, so evaluate the user's modulation
        # per midpoint in Python (a reference-style `if t < 10:` body works,
        # matching the docstring's rk4-only traceability requirement) —
        # vmap would put tracers through arbitrary Python control flow
        mids = np.asarray(0.5 * (t[:-1] + t[1:]))
        ks = jnp.stack([rate_fn(float(tt)) for tt in mids])  # (S, 6)
        traj = expm_solve_piecewise(y0, t_span[0], t_span[1], n_points, ks)
        return t, _project_simplex(traj)
    traj = rk4_solve_modulated(y0, t_span[0], t_span[1], n_points, rate_fn,
                               substeps=substeps)
    return t, traj


def rk4_solve_modulated(
    y0: jnp.ndarray,
    t0: float,
    t1: float,
    n_points: int,
    rate_fn: Callable[[jnp.ndarray], jnp.ndarray],
    substeps: int = 16,
) -> jnp.ndarray:
    """RK4 with time-varying rates ``k = rate_fn(t)`` (ref 05:171-196).

    ``rate_fn`` must be traceable (jnp ops only). Rates are evaluated at the
    RK4 stage times, giving the classical non-autonomous RK4 scheme.
    """
    dt_out = (t1 - t0) / max(n_points - 1, 1)
    dt = dt_out / substeps
    y0 = jnp.asarray(y0)
    y0 = y0 / jnp.sum(y0, axis=-1, keepdims=True)

    def field_t(y, t):
        return apf_field(y, rate_fn(t))

    def interval(carry, _):
        y, t = carry

        def sub(i, yt):
            y, t = yt
            f1 = field_t(y, t)
            f2 = field_t(y + 0.5 * dt * f1, t + 0.5 * dt)
            f3 = field_t(y + 0.5 * dt * f2, t + 0.5 * dt)
            f4 = field_t(y + dt * f3, t + dt)
            return (y + (dt / 6.0) * (f1 + 2 * f2 + 2 * f3 + f4), t + dt)

        y, t = lax.fori_loop(0, substeps, sub, (y, t))
        return (y, t), y

    (_, _), traj = lax.scan(interval, (y0, jnp.asarray(t0, y0.dtype)), None,
                            length=n_points - 1)
    return _project_simplex(jnp.concatenate([y0[None], traj], axis=0))
