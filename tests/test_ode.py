"""ODE kernel oracle tests: RK4/expm vs scipy.integrate.solve_ivp (<=1e-5),
steady state, stability, Q-matrix, mapping heuristic, sensitivity."""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.integrate import solve_ivp

from eegflow.ode import (
    apf_field,
    expm_solve,
    map_eye_state_to_cognitive,
    parameter_sensitivity,
    rates_to_array,
    rates_to_dict,
    rk4_solve,
    solve,
    solve_batch,
    stability_analysis,
    steady_state,
    steady_state_numeric,
    transition_matrix,
)
from eegflow.ode.field import DEFAULT_RATES
from eegflow.ode.integrate import rk4_solve_modulated, solve_with_modulation

RATES_CASES = [
    DEFAULT_RATES,
    # README-published fitted rates (BASELINE.md)
    {"k_ap": 0.020, "k_af": 0.095, "k_pa": 0.02, "k_pf": 0.626, "k_fa": 0.139, "k_fp": 0.02},
    # bound extremes
    {"k_ap": 0.5, "k_af": 0.2, "k_pa": 0.5, "k_pf": 0.3, "k_fa": 0.3, "k_fp": 0.4},
    # modulated extreme: alpha=1, p=1 doubles the fatigue rates
    {"k_ap": 0.1, "k_af": 0.4, "k_pa": 0.3, "k_pf": 0.6, "k_fa": 0.6, "k_fp": 0.1},
]


def scipy_reference(y0, t0, t1, n_points, rates):
    k = np.array([rates[n] for n in ("k_ap", "k_af", "k_pa", "k_pf", "k_fa", "k_fp")])

    def rhs(t, y):
        a, p, f = np.maximum(y, 0.0)
        return [
            -k[0] * a - k[1] * a + k[2] * p + k[4] * f,
            k[0] * a - k[2] * p - k[3] * p + k[5] * f,
            k[1] * a + k[3] * p - k[4] * f - k[5] * f,
        ]

    t = np.linspace(t0, t1, n_points)
    sol = solve_ivp(rhs, (t0, t1), y0, t_eval=t, method="RK45", rtol=1e-10, atol=1e-12)
    return sol.y.T


@pytest.mark.parametrize("rates", RATES_CASES)
@pytest.mark.parametrize("y0", [[0.33, 0.34, 0.33], [0.2, 0.2, 0.6], [0.6, 0.2, 0.2]])
def test_rk4_matches_scipy_below_1e5(rates, y0):
    k = rates_to_array(rates)
    traj = np.asarray(rk4_solve(jnp.asarray(y0), 0.0, 20.0, 20, k, substeps=16))
    ref = scipy_reference(y0, 0.0, 20.0, 20, rates)
    assert np.max(np.abs(traj - ref)) < 1e-5


@pytest.mark.parametrize("rates", RATES_CASES)
def test_expm_matches_scipy(rates):
    y0 = [0.33, 0.34, 0.33]
    k = rates_to_array(rates)
    traj = np.asarray(expm_solve(jnp.asarray(y0), 0.0, 20.0, 20, k))
    ref = scipy_reference(y0, 0.0, 20.0, 20, rates)
    assert np.max(np.abs(traj - ref)) < 1e-5


def test_expm_and_rk4_agree():
    k = rates_to_array(DEFAULT_RATES)
    y0 = jnp.asarray([0.5, 0.3, 0.2])
    a = np.asarray(rk4_solve(y0, 0.0, 50.0, 51, k, substeps=16))
    b = np.asarray(expm_solve(y0, 0.0, 50.0, 51, k))
    np.testing.assert_allclose(a, b, atol=2e-6)


def test_solve_reference_semantics_simplex():
    t, traj = solve([0.4, 0.4, 0.4], (0, 20), 20)  # unnormalized init
    traj = np.asarray(traj)
    assert traj.shape == (20, 3)
    np.testing.assert_allclose(traj.sum(axis=-1), 1.0, atol=1e-6)
    assert np.all(traj >= 0) and np.all(traj <= 1)
    np.testing.assert_allclose(np.asarray(t)[0], 0.0)


def test_solve_batch_matches_per_sample():
    rng = np.random.default_rng(0)
    y0 = rng.dirichlet(np.ones(3), size=32).astype(np.float32)
    k = np.stack(
        [np.array([v for v in DEFAULT_RATES.values()]) * (1 + 0.5 * rng.random(6))
         for _ in range(32)]
    ).astype(np.float32)
    batch = np.asarray(solve_batch(jnp.asarray(y0), 0.0, 20.0, 20, jnp.asarray(k)))
    assert batch.shape == (32, 20, 3)
    for i in [0, 7, 31]:
        _, single = solve(y0[i], (0, 20), 20, k=jnp.asarray(k[i]), method="expm")
        np.testing.assert_allclose(batch[i], np.asarray(single), atol=1e-6)


def test_steady_state_analytic_vs_numeric():
    k = rates_to_array(DEFAULT_RATES)
    analytic = np.asarray(steady_state(k))
    numeric = np.asarray(steady_state_numeric(k))
    np.testing.assert_allclose(analytic, numeric, atol=5e-4)
    np.testing.assert_allclose(analytic.sum(), 1.0, atol=1e-5)


def test_steady_state_batched():
    ks = jnp.stack([rates_to_array(r) for r in RATES_CASES])
    ss = np.asarray(steady_state(ks))
    assert ss.shape == (len(RATES_CASES), 3)
    np.testing.assert_allclose(ss.sum(axis=-1), 1.0, atol=1e-5)


def test_transition_matrix_rows_sum_zero():
    q = np.asarray(transition_matrix(rates_to_array(DEFAULT_RATES)))
    np.testing.assert_allclose(q.sum(axis=-1), 0.0, atol=1e-7)
    assert np.all(np.diag(q) <= 0)


def test_stability_always_stable():
    for rates in RATES_CASES:
        res = stability_analysis(rates_to_array(rates))
        assert res["is_stable"]
        assert res["dominant_time_constant"] > 0


def test_field_clamps_negative_states():
    k = rates_to_array(DEFAULT_RATES)
    y_neg = jnp.asarray([-0.1, 0.6, 0.5])
    y_clamped = jnp.asarray([0.0, 0.6, 0.5])
    np.testing.assert_allclose(
        np.asarray(apf_field(y_neg, k)), np.asarray(apf_field(y_clamped, k))
    )


def test_rates_roundtrip():
    k = rates_to_array(DEFAULT_RATES)
    assert rates_to_dict(k) == pytest.approx(DEFAULT_RATES)


def test_mapping_heuristic_matches_reference_loop():
    rng = np.random.default_rng(3)
    eye = (rng.random(500) > 0.5).astype(float)
    # the reference's sample-by-sample loop (ref 05:366-381), reproduced as oracle
    n, w = len(eye), 20
    expected = np.zeros(n)
    for i in range(n):
        win = eye[max(0, i - w // 2) : min(n, i + w // 2)]
        ratio, var = np.mean(win), np.var(win)
        if ratio < 0.3 and var < 0.15:
            expected[i] = 0
        elif ratio > 0.7:
            expected[i] = 2
        else:
            expected[i] = 1
    got, props = map_eye_state_to_cognitive(eye, 20)
    np.testing.assert_array_equal(got, expected)
    assert props.shape[1] == 3
    np.testing.assert_allclose(props.sum(axis=1), 1.0, atol=1e-9)


def _scipy_modulated_oracle(y0, t0, t1, n_points, base, mod_np):
    """Loop oracle replicating CognitiveStateODE.solve_with_modulation
    (ref 05_ode_model.py:188-196): odeint of the time-modulated system,
    then clip + simplex renormalization."""
    from scipy.integrate import odeint

    names = ("k_ap", "k_af", "k_pa", "k_pf", "k_fa", "k_fp")

    def rhs(y, t):
        rates = mod_np(t, dict(base))
        k = np.array([rates[n] for n in names])
        a, p, f = np.maximum(y, 0.0)
        return [
            -k[0] * a - k[1] * a + k[2] * p + k[4] * f,
            k[0] * a - k[2] * p - k[3] * p + k[5] * f,
            k[1] * a + k[3] * p - k[4] * f - k[5] * f,
        ]

    t = np.linspace(t0, t1, n_points)
    y0 = np.asarray(y0, np.float64)
    sol = odeint(rhs, y0 / y0.sum(), t, rtol=1e-10, atol=1e-12)
    sol = np.clip(sol, 0.0, 1.0)
    return sol / sol.sum(axis=1, keepdims=True)


def test_solve_with_modulation_smooth_scipy_oracle():
    """Genuinely time-varying rates (ref 05:171-196): non-autonomous RK4 vs
    the scipy odeint loop oracle at <=1e-5."""

    def mod_jnp(t, p):
        p["k_af"] = p["k_af"] * (1.0 + 0.8 * jnp.sin(0.4 * t))
        p["k_fa"] = p["k_fa"] * (1.0 + 0.5 * jnp.cos(0.3 * t))
        return p

    def mod_np(t, p):
        p["k_af"] = p["k_af"] * (1.0 + 0.8 * np.sin(0.4 * t))
        p["k_fa"] = p["k_fa"] * (1.0 + 0.5 * np.cos(0.3 * t))
        return p

    t, sol = solve_with_modulation(
        [0.33, 0.34, 0.33], (0.0, 20.0), mod_jnp, n_points=41,
        method="rk4", substeps=32)
    ref = _scipy_modulated_oracle(
        [0.33, 0.34, 0.33], 0.0, 20.0, 41, DEFAULT_RATES, mod_np)
    assert np.asarray(t).shape == (41,)
    assert np.max(np.abs(np.asarray(sol) - ref)) < 1e-5


def test_solve_with_modulation_expm_piecewise_exact():
    """Piecewise-constant modulation aligned with the output grid: the
    per-segment expm propagators are exact; oracle = scipy on each
    constant-rate phase."""

    def mod_jnp(t, p):
        s = jnp.where(t < 10.0, 1.5, 0.75)
        return {name: v * s for name, v in p.items()}

    t, sol = solve_with_modulation(
        [0.6, 0.2, 0.2], (0.0, 20.0), mod_jnp, n_points=41, method="expm")
    hi = {n: 1.5 * v for n, v in DEFAULT_RATES.items()}
    lo = {n: 0.75 * v for n, v in DEFAULT_RATES.items()}
    first = scipy_reference([0.6, 0.2, 0.2], 0.0, 10.0, 21, hi)
    second = scipy_reference(first[-1], 10.0, 20.0, 21, lo)
    ref = np.concatenate([first, second[1:]], axis=0)
    assert np.max(np.abs(np.asarray(sol) - ref)) < 1e-5


def test_solve_with_modulation_expm_python_control_flow():
    """The expm path evaluates modulation at CONCRETE midpoints, so a
    reference-style Python body (`if t < 10:`) — the documented parity
    target — must work without tracer errors."""

    def mod_py(t, p):
        if t < 10.0:  # plain Python branch, not jnp.where
            return {name: 1.5 * v for name, v in p.items()}
        return {name: 0.75 * v for name, v in p.items()}

    t, sol = solve_with_modulation(
        [0.6, 0.2, 0.2], (0.0, 20.0), mod_py, n_points=41, method="expm")
    hi = {n: 1.5 * v for n, v in DEFAULT_RATES.items()}
    lo = {n: 0.75 * v for n, v in DEFAULT_RATES.items()}
    first = scipy_reference([0.6, 0.2, 0.2], 0.0, 10.0, 21, hi)
    second = scipy_reference(first[-1], 10.0, 20.0, 21, lo)
    ref = np.concatenate([first, second[1:]], axis=0)
    assert np.max(np.abs(np.asarray(sol) - ref)) < 1e-5


def test_solve_with_modulation_constant_matches_solve():
    """Identity modulation reduces to the plain reference-parity solve."""
    t, sol = solve_with_modulation(
        [0.33, 0.34, 0.33], (0.0, 20.0), lambda t, p: p, n_points=20,
        method="expm")
    _, plain = solve([0.33, 0.34, 0.33], (0.0, 20.0), 20,
                     k=rates_to_array(DEFAULT_RATES), method="expm")
    np.testing.assert_allclose(np.asarray(sol), np.asarray(plain), atol=1e-6)


def test_modulated_solve_constant_rates_matches_plain():
    k = rates_to_array(DEFAULT_RATES)
    traj_mod = np.asarray(
        rk4_solve_modulated(jnp.asarray([0.33, 0.34, 0.33]), 0.0, 20.0, 20,
                            lambda t: k, substeps=16)
    )
    _, traj = solve([0.33, 0.34, 0.33], (0, 20), 20, k=k, method="rk4")
    np.testing.assert_allclose(traj_mod, np.asarray(traj), atol=1e-6)


def test_sensitivity_structure():
    res = parameter_sensitivity(rates_to_array(DEFAULT_RATES))
    assert set(res["sensitivities"].keys()) == {
        "k_ap", "k_af", "k_pa", "k_pf", "k_fa", "k_fp"
    }
    # increasing fatigue rate must increase steady-state Fatigued occupancy
    assert res["sensitivities"]["k_af"]["Fatigued"] > 0
    assert res["sensitivities"]["k_fa"]["Fatigued"] < 0


def _dot_precisions(fn, *args):
    """Precision of every dot_general in ``fn``'s jaxpr (nested included)."""
    import jax

    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return out


_K = rates_to_array(DEFAULT_RATES)
_Y0 = jnp.asarray([0.33, 0.34, 0.33])


@pytest.mark.parametrize("name,fn", [
    ("expm_solve", lambda: expm_solve(_Y0, 0.0, 20.0, 20, _K)),
    ("rk4_solve", lambda: rk4_solve(_Y0, 0.0, 20.0, 20, _K, substeps=4)),
    ("solve_batch", lambda: solve_batch(jnp.tile(_Y0, (3, 1)), 0.0, 20.0, 20,
                                        jnp.tile(_K, (3, 1)))),
    ("steady_state", lambda: steady_state(_K)),
])
def test_ode_products_request_highest_precision(name, fn):
    """Every 3x3 product of the integrators asks for HIGHEST: a GPU may run
    default-precision f32 products in TF32 (about 3 decimal digits)."""
    from jax import lax

    precisions = _dot_precisions(fn)
    assert precisions, f"{name}: no dot_general traced"
    for p in precisions:
        assert p == (lax.Precision.HIGHEST, lax.Precision.HIGHEST), (name, p)


@pytest.mark.parametrize("rates", RATES_CASES)
@pytest.mark.parametrize("method", ["expm", "rk4"])
def test_solve_matches_scipy_under_tf32_default_precision(rates, method):
    """With the process default set to TF32, the solves keep the 1e-5
    parity with scipy.integrate.solve_ivp (rtol 1e-10)."""
    import jax

    y0 = [0.2, 0.2, 0.6]
    with jax.default_matmul_precision("tensorfloat32"):
        _, traj = solve(jnp.asarray(y0), (0.0, 20.0), 20,
                        k=rates_to_array(rates), method=method)
    ref = scipy_reference(y0, 0.0, 20.0, 20, rates)
    ref = np.clip(ref, 0, 1)
    ref = ref / ref.sum(1, keepdims=True)
    assert np.max(np.abs(np.asarray(traj) - ref)) < 1e-5
