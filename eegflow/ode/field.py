"""Three-state Active/Passive/Fatigued compartmental vector field.

A functional re-design of the reference's ``CognitiveStateODE`` class
(ref: 05_ode_model.py:58-242): the model is a pure function of a rate *array*
(shape ``(..., 6)``) instead of a mutable parameter dict, so it composes with
``jit``/``vmap``/``grad`` — a whole differential-evolution population or a
batch of per-sample modulated rates is just a leading axis.

System (ref 05:63-70):
    dA/dt = -(k_ap + k_af) A + k_pa P + k_fa F
    dP/dt =  k_ap A - (k_pa + k_pf) P + k_fp F
    dF/dt =  k_af A + k_pf P - (k_fa + k_fp) F
with conservation A + P + F = 1.

Rate order everywhere: ``[k_ap, k_af, k_pa, k_pf, k_fa, k_fp]``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax.numpy as jnp
import numpy as np
from jax import lax

RATE_NAMES: Tuple[str, ...] = ("k_ap", "k_af", "k_pa", "k_pf", "k_fa", "k_fp")

#: default rates (ref 05:86-94)
DEFAULT_RATES: Dict[str, float] = {
    "k_ap": 0.1, "k_af": 0.02, "k_pa": 0.15, "k_pf": 0.08, "k_fa": 0.05, "k_fp": 0.1,
}

STATE_NAMES: Tuple[str, ...] = ("Active", "Passive", "Fatigued")


def rates_to_array(params: Dict[str, float]) -> jnp.ndarray:
    return jnp.asarray([params[name] for name in RATE_NAMES])


def rates_to_dict(k) -> Dict[str, float]:
    k = np.asarray(k)
    return {name: float(k[i]) for i, name in enumerate(RATE_NAMES)}


def transition_matrix(k: jnp.ndarray) -> jnp.ndarray:
    """Continuous-time rate matrix Q, rows = source state (ref 05:223-242).

    ``k`` has shape ``(..., 6)``; returns ``(..., 3, 3)``. The field is
    ``dy/dt = y @ Q`` for a row-vector state ``y``.
    """
    k_ap, k_af, k_pa, k_pf, k_fa, k_fp = (k[..., i] for i in range(6))
    row_a = jnp.stack([-(k_ap + k_af), k_ap, k_af], axis=-1)
    row_p = jnp.stack([k_pa, -(k_pa + k_pf), k_pf], axis=-1)
    row_f = jnp.stack([k_fa, k_fp, -(k_fa + k_fp)], axis=-1)
    return jnp.stack([row_a, row_p, row_f], axis=-2)


def apf_field(y: jnp.ndarray, k: jnp.ndarray) -> jnp.ndarray:
    """RHS of the APF system for state ``y (..., 3)`` and rates ``k (..., 6)``.

    Non-negativity clamp on the state matches the reference RHS
    (ref 05:113-116) — it makes the field piecewise-linear but identical in
    behavior for simplex-interior trajectories.
    """
    y_pos = jnp.maximum(y, 0.0)
    q = transition_matrix(k)
    # HIGHEST: at the default precision a GPU may run this f32 product in
    # TF32, which breaks the RK4 solve's 1e-5 parity with scipy and the DE
    # fit's loss; the product is 3x3 and costs nothing
    return jnp.einsum("...i,...ij->...j", y_pos, q,
                      precision=lax.Precision.HIGHEST)


def steady_state(k: jnp.ndarray) -> jnp.ndarray:
    """Analytical stationary distribution: solve ``p @ Q = 0`` with ``sum(p)=1``.

    The reference computes this by integrating to t=1000 (ref 05:198-221);
    here it is a 4x3 least-squares solve — exact, differentiable, vmappable.
    """
    q = transition_matrix(k)
    # Augmented system rows: Q^T p = 0 and 1^T p = 1; solved via normal
    # equations so it batches over any leading axes of ``k``.
    a = jnp.concatenate(
        [jnp.swapaxes(q, -1, -2), jnp.ones(q.shape[:-2] + (1, 3), q.dtype)], axis=-2
    )
    b = jnp.concatenate(
        [jnp.zeros(q.shape[:-2] + (3,), q.dtype), jnp.ones(q.shape[:-2] + (1,), q.dtype)],
        axis=-1,
    )
    # HIGHEST: normal equations square the condition number; TF32 inputs
    # would lose the stationary distribution's low digits
    ata = jnp.einsum("...ki,...kj->...ij", a, a, precision=lax.Precision.HIGHEST)
    atb = jnp.einsum("...ki,...k->...i", a, b, precision=lax.Precision.HIGHEST)
    return jnp.linalg.solve(ata, atb[..., None])[..., 0]


def steady_state_numeric(k: jnp.ndarray, t_end: float = 1000.0, n_points: int = 1000) -> jnp.ndarray:
    """Reference-parity steady state via long integration (ref 05:213-215)."""
    from eegflow.ode.integrate import solve

    y0 = jnp.asarray([0.33, 0.33, 0.34])
    _, traj = solve(y0, (0.0, t_end), n_points, k, method="expm")
    return traj[-1]


def stability_analysis(k) -> Dict[str, object]:
    """Eigenvalue stability of Q^T (ref 05:466-494).

    Host-side (numpy eig) — returns eigenvalues, stability flag Re(λ)<=0, and
    the dominant time constant -1/max(Re λ) over the non-conserved modes.
    """
    q = np.asarray(transition_matrix(jnp.asarray(k)), dtype=np.float64)
    eigvals = np.linalg.eigvals(q.T)
    # the conservation mode sits at exactly 0 analytically; allow float fuzz
    stable = bool(np.all(eigvals.real <= 1e-6))
    nonzero = eigvals[np.abs(eigvals.real) > 1e-6]
    if len(nonzero) > 0:
        dominant = float(-1.0 / np.max(nonzero.real))
    else:
        dominant = float("inf")
    return {
        "eigenvalues_real": eigvals.real.tolist(),
        "eigenvalues_imag": eigvals.imag.tolist(),
        "is_stable": stable,
        "dominant_time_constant": dominant,
    }


def validate_rates(params: Dict[str, float]) -> Dict[str, object]:
    """Physiological-plausibility checks (ref 05:324-345), returned not printed."""
    recovery = params["k_fa"] + params["k_fp"] + params["k_pa"]
    fatigue = params["k_af"] + params["k_pf"]
    balance = recovery / (fatigue + 1e-10)
    warnings = []
    if balance < 0.5:
        warnings.append("very high fatigue dominance (balance < 0.5)")
    elif balance > 5.0:
        warnings.append("very high recovery dominance (balance > 5.0)")
    for name, v in params.items():
        if v < 0.005:
            warnings.append(f"very slow transition {name}={v:.4f}")
        elif v > 0.4:
            warnings.append(f"very fast transition {name}={v:.4f}")
    return {"balance": balance, "warnings": warnings}
