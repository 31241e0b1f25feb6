"""ODE parameter fitting: on-device differential evolution + L-BFGS-B polish.

An on-device redesign of the reference's fit (ref: 05_ode_model.py:244-322),
which drives ``scipy.optimize.differential_evolution`` through a Python loss
that re-enters scipy's LSODA integrator per candidate — thousands of host
round-trips. Here the *entire population* is evaluated as one batched RK4
rollout under ``jit`` (population axis = leading axis of the rate array), and
the generation loop is a ``lax.while_loop``, so the whole global search is a
single XLA computation.

Algorithm parity with scipy's defaults as used by the reference:
  * strategy best1bin: mutant = best + F (r1 - r2), F dithered U(0.5, 1)
  * binomial crossover, CR = 0.7, one guaranteed dimension
  * Latin-hypercube initialization within bounds
  * convergence when std(fitness) <= atol + tol |mean(fitness)| (tol 1e-7)
  * final polish: L-BFGS-B within bounds (scipy host-side, JAX gradients)

Loss parity (ref 05:259-283): MSE between the solved trajectory (from the
first observed state, clipped + simplex-renormalized) and the observed
proportions, plus ``reg_weight * sum(k^2)``.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from eegflow.core.config import ODEConfig
from eegflow.ode.field import rates_to_dict
from eegflow.ode.integrate import rk4_solve


def make_fit_loss(
    observed: jnp.ndarray,
    t0: float,
    t1: float,
    n_points: int,
    reg_weight: float = 1e-3,
    substeps: int = 16,
) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """Build the (vmappable, differentiable) fitting loss over rate vectors.

    ``observed`` is (n_points, 3); the candidate axis may be any leading shape
    of the rate argument ``k (..., 6)`` -> loss shape ``(...,)``.
    """
    observed = jnp.asarray(observed, jnp.float32)
    y0 = observed[0] / jnp.sum(observed[0])

    def loss(k: jnp.ndarray) -> jnp.ndarray:
        traj = rk4_solve(y0, t0, t1, n_points, k, substeps=substeps)
        traj = jnp.clip(traj, 0.0, 1.0)
        traj = traj / jnp.sum(traj, axis=-1, keepdims=True)
        # traj: (n_points, ..., 3); observed broadcast over candidate axes
        obs = observed.reshape((n_points,) + (1,) * (traj.ndim - 2) + (3,))
        mse = jnp.mean((traj - obs) ** 2, axis=(0, -1))
        reg = reg_weight * jnp.sum(k**2, axis=-1)
        return mse + reg

    return loss


def _latin_hypercube(key: jax.Array, n: int, lo: jnp.ndarray, hi: jnp.ndarray) -> jnp.ndarray:
    """LHS init: stratified uniform samples, independently permuted per dim."""
    d = lo.shape[0]
    k_u, k_p = jax.random.split(key)
    u = jax.random.uniform(k_u, (n, d))
    strata = (jnp.arange(n)[:, None] + u) / n
    perms = jax.vmap(lambda kk: jax.random.permutation(kk, n), out_axes=1)(
        jax.random.split(k_p, d)
    )  # (n, d) independent permutations per column
    samples = jnp.take_along_axis(strata, perms, axis=0)
    return lo + samples * (hi - lo)


@functools.partial(
    jax.jit, static_argnames=("loss_fn", "popsize", "maxiter")
)
def _de_minimize(
    loss_fn: Callable,
    key: jax.Array,
    lo: jnp.ndarray,
    hi: jnp.ndarray,
    popsize: int,
    maxiter: int,
    tol: float,
    atol: float = 0.0,
):
    d = lo.shape[0]
    n = popsize * d
    key, k_init = jax.random.split(key)
    pop = _latin_hypercube(k_init, n, lo, hi)
    fit = loss_fn(pop)

    def converged(fit):
        return jnp.std(fit) <= atol + tol * jnp.abs(jnp.mean(fit))

    def cond(state):
        pop, fit, key, gen = state
        return jnp.logical_and(gen < maxiter, jnp.logical_not(converged(fit)))

    def body(state):
        pop, fit, key, gen = state
        key, k_f, k_idx, k_cr, k_jrand = jax.random.split(key, 5)
        best = pop[jnp.argmin(fit)]
        f_scale = jax.random.uniform(k_f, (), minval=0.5, maxval=1.0)

        # two distinct partners != self per member: argsort of random matrix
        u = jax.random.uniform(k_idx, (n, n))
        u = u + jnp.eye(n) * 2.0  # exclude self
        order = jnp.argsort(u, axis=1)
        r1, r2 = order[:, 0], order[:, 1]

        mutant = best[None, :] + f_scale * (pop[r1] - pop[r2])
        mutant = jnp.clip(mutant, lo, hi)

        cross = jax.random.uniform(k_cr, (n, d)) < 0.7
        jrand = jax.random.randint(k_jrand, (n,), 0, d)
        cross = cross | (jnp.arange(d)[None, :] == jrand[:, None])
        trial = jnp.where(cross, mutant, pop)

        trial_fit = loss_fn(trial)
        improve = trial_fit < fit
        pop = jnp.where(improve[:, None], trial, pop)
        fit = jnp.where(improve, trial_fit, fit)
        return (pop, fit, key, gen + 1)

    pop, fit, key, gen = lax.while_loop(cond, body, (pop, fit, key, jnp.asarray(0)))
    i_best = jnp.argmin(fit)
    return pop[i_best], fit[i_best], gen


def differential_evolution_fit(
    loss_fn: Callable[[jnp.ndarray], jnp.ndarray],
    bounds: Tuple[Tuple[float, float], ...],
    seed: int = 42,
    popsize: int = 15,
    maxiter: int = 1000,
    tol: float = 1e-7,
    polish: bool = True,
) -> Tuple[np.ndarray, float, Dict[str, object]]:
    """Global minimize ``loss_fn`` within ``bounds``; returns (x, fx, info)."""
    lo = jnp.asarray([b[0] for b in bounds], jnp.float32)
    hi = jnp.asarray([b[1] for b in bounds], jnp.float32)
    key = jax.random.key(seed)
    x, fx, gens = _de_minimize(loss_fn, key, lo, hi, popsize, maxiter, tol)
    x = np.asarray(x, np.float64)
    fx = float(fx)
    info = {"generations": int(gens), "polished": False}

    if polish:
        from scipy.optimize import minimize

        scalar_loss = jax.jit(lambda xx: loss_fn(xx.astype(jnp.float32)))
        grad = jax.jit(jax.grad(lambda xx: loss_fn(xx.astype(jnp.float32))))

        def f_np(xx):
            return float(scalar_loss(jnp.asarray(xx, jnp.float32)))

        def g_np(xx):
            return np.asarray(grad(jnp.asarray(xx, jnp.float32)), np.float64)

        res = minimize(f_np, x, jac=g_np, bounds=list(bounds), method="L-BFGS-B")
        if res.fun <= fx:
            x, fx = np.asarray(res.x), float(res.fun)
            info["polished"] = True
    return x, fx, info


def fit_ode_rates(
    observed_proportions: np.ndarray,
    time_points: np.ndarray,
    config: Optional[ODEConfig] = None,
) -> Tuple[Dict[str, float], float, Dict[str, object]]:
    """Fit the six APF transition rates to observed [A,P,F] proportions.

    Mirrors ``CognitiveStateODE.fit_to_data`` (ref 05:244-322) end-to-end:
    same loss, bounds, DE hyperparameters, and L-BFGS polish — but the DE
    population evaluates as one vmapped rollout on-device.
    """
    config = config or ODEConfig()
    observed = jnp.asarray(observed_proportions, jnp.float32)
    t = np.asarray(time_points, np.float64)
    loss = make_fit_loss(
        observed, float(t[0]), float(t[-1]), len(t),
        reg_weight=config.reg_weight, substeps=config.rk4_substeps,
    )
    x, fx, info = differential_evolution_fit(
        loss, config.bounds, seed=config.de_seed, popsize=config.de_popsize,
        maxiter=config.de_maxiter, tol=config.de_tol,
    )
    return rates_to_dict(x), fx, info
