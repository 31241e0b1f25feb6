"""Coupled LSTM->ODE trajectory prediction, fully on device.

The reference's ``LSTMODEIntegration.predict_batch`` (ref 06:308-406) runs
batched GPU LSTM inference, then a *per-sample Python loop* of scipy ODE
solves on CPU. Here the classifier forward, softmax, rate modulation,
initial-state inference, the whole batch of ODE solves (exact expm
propagators, one per sample), and the final-state thresholding fuse into ONE
jitted program.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from eegflow.core.config import CouplingConfig, ModelConfig
from eegflow.couple.modulation import infer_initial_state, modulate_rates
from eegflow.nn.model import classifier_apply
from eegflow.ode.integrate import solve_batch


@dataclass
class CoupledModel:
    """Trained classifier params + fitted ODE rates + coupling config
    (the reference's LSTMODEIntegration state, ref 06:183-214)."""

    params: Any
    model_cfg: ModelConfig
    k_base: jnp.ndarray  # (6,)
    coupling: CouplingConfig
    lstm_impl: str = "auto"


def _rollout_core(
    params: Any,
    x: jnp.ndarray,
    k_base: jnp.ndarray,
    model_cfg: ModelConfig,
    forecast_steps: int,
    alpha: float,
    rate_floor: float,
    init_threshold: float,
    bf16: bool,
    lstm_impl: str,
) -> Dict[str, jnp.ndarray]:
    """Un-jitted rollout body — shared by the single-device jit
    (:func:`coupled_rollout`) and the per-device ``shard_map`` program
    (:func:`make_spmd_rollout`). Every op is per-sample, so sharding the
    batch axis is exact."""
    compute_dtype = jnp.bfloat16 if bf16 else None
    logits, attention = classifier_apply(
        params, x, model_cfg, train=False, return_attention=True,
        compute_dtype=compute_dtype, lstm_impl=lstm_impl,
    )
    probs = jax.nn.softmax(logits, axis=-1)
    p_open, p_closed = probs[:, 0], probs[:, 1]

    k_mod = modulate_rates(k_base, p_closed, p_open, alpha, rate_floor)  # (B, 6)
    y0 = infer_initial_state(p_closed, p_open, init_threshold)           # (B, 3)
    traj = solve_batch(y0, 0.0, float(forecast_steps), forecast_steps, k_mod,
                       method="expm")                                    # (B, S, 3)
    final = traj[:, -1, :]
    pred_binary = (final[:, 2] > 0.5).astype(jnp.int32)  # ref 06:396-401
    # three-way class (ref 10:281-289): F>0.5 -> 2 (closed), A>0.5 -> 0 (open), else 1
    pred_three = jnp.where(final[:, 2] > 0.5, 2, jnp.where(final[:, 0] > 0.5, 0, 1))
    return {
        "probs": probs,
        "attention": attention,
        "trajectories": traj,
        "final_state": final,
        "pred_binary": pred_binary,
        "pred_three": pred_three,
    }


@functools.partial(
    jax.jit,
    static_argnames=("model_cfg", "forecast_steps", "alpha", "rate_floor",
                     "init_threshold", "bf16", "lstm_impl"),
)
def coupled_rollout(
    params: Any,
    x: jnp.ndarray,
    k_base: jnp.ndarray,
    model_cfg: ModelConfig,
    forecast_steps: int = 20,
    alpha: float = 0.5,
    rate_floor: float = 1e-3,
    init_threshold: float = 0.6,
    bf16: bool = True,
    lstm_impl: str = "scan",
) -> Dict[str, jnp.ndarray]:
    """(B, T, C) windows -> dict with probs, attention, trajectories, finals.

    Semantics parity with ref 06:308-406 / 10:204-290: per-sample modulated
    rates, heuristic initial state, ``solve(init, (0, steps), steps)``,
    trajectory-end thresholding (F > 0.5 -> class 1).
    """
    return _rollout_core(params, x, k_base, model_cfg, forecast_steps, alpha,
                         rate_floor, init_threshold, bf16, lstm_impl)


def make_spmd_rollout(
    model_cfg: ModelConfig,
    mesh,
    forecast_steps: int = 20,
    alpha: float = 0.5,
    rate_floor: float = 1e-3,
    init_threshold: float = 0.6,
    bf16: bool = True,
    lstm_impl: str = "auto",
    axis_name: str = "data",
):
    """Explicit shard_map coupled rollout: ``roll(params, x, k_base) -> dict``.

    Each device runs the complete per-shard rollout program of the stage-06
    hot path (ref 06:308-406 phase 2). Inputs: params/k_base replicated,
    ``x`` sharded on ``axis_name``; every output is batch-leading and comes
    back sharded the same way.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis_name), P()),
        out_specs=P(axis_name),
        check_vma=False,
    )
    def spmd_rollout(params, x, k_base):
        return _rollout_core(params, x, k_base, model_cfg, forecast_steps,
                             alpha, rate_floor, init_threshold, bf16,
                             lstm_impl)

    return jax.jit(spmd_rollout)


def predict_batch(
    model: CoupledModel,
    x: np.ndarray,
    forecast_steps: Optional[int] = None,
    batch_size: int = 2048,
    mesh=None,
    rollout_step=None,
) -> Dict[str, np.ndarray]:
    """Host wrapper: pads to static batch buckets, concatenates results.

    Every chunk is padded up to a power-of-two bucket (capped at
    ``batch_size``) so novel request sizes reuse a small set of warmed
    compiles instead of triggering a fresh jit per distinct shape — critical
    for the HTTP server, where multi-second recompiles would stall requests.

    With ``mesh`` (a 1-D data mesh) the batch axis is sharded across the
    mesh's devices and the whole fused rollout runs as one implicit
    NamedSharding program — the reference's phase-2 per-sample CPU loop
    (ref 06:367-406) becomes a multi-device program. Every op is per-sample,
    so results match the single-device path. ``rollout_step`` injects a
    prebuilt :func:`make_spmd_rollout` (tests, or reuse across calls).
    """
    steps = forecast_steps or model.coupling.forecast_steps
    n = len(x)
    params, k_base = model.params, model.k_base
    lstm_impl = model.lstm_impl
    n_dev = 1
    if mesh is not None:
        from eegflow.train.mesh import replicate_to_mesh

        n_dev = int(np.prod(list(mesh.shape.values())))
        params = replicate_to_mesh(params, mesh)
        k_base = replicate_to_mesh(k_base, mesh)
    out: Dict[str, list] = {}
    for i in range(0, n, batch_size):
        xb = x[i : i + batch_size]
        k = len(xb)
        bucket = min(batch_size, max(8, n_dev, 1 << (k - 1).bit_length()))
        bucket += (-bucket) % n_dev
        if k < bucket:
            xb = np.concatenate(
                [xb, np.zeros((bucket - k,) + xb.shape[1:], xb.dtype)]
            )
        xb = jnp.asarray(xb)
        if mesh is not None:
            from eegflow.train.mesh import shard_batch

            xb = shard_batch(xb, mesh)
        if rollout_step is not None:
            res = rollout_step(params, xb, k_base)
        else:
            res = coupled_rollout(
                params, xb, k_base, model.model_cfg,
                forecast_steps=steps, alpha=model.coupling.coupling_strength,
                rate_floor=model.coupling.rate_floor,
                init_threshold=model.coupling.init_threshold,
                lstm_impl=lstm_impl,
            )
        for name, val in res.items():
            out.setdefault(name, []).append(np.asarray(val)[:k])
    return {name: np.concatenate(vals, axis=0) for name, vals in out.items()}


def predict_trajectory(
    model: CoupledModel,
    x: np.ndarray,
    initial_state: Optional[np.ndarray] = None,
    forecast_steps: int = 10,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Single-sample trajectory (ref 06:266-306). ``x (1, T, C)``.

    Returns (trajectory (steps, 3), probs (1, 2), attention (1, T)).
    """
    res = coupled_rollout(
        model.params, jnp.asarray(x), model.k_base, model.model_cfg,
        forecast_steps=forecast_steps, alpha=model.coupling.coupling_strength,
        rate_floor=model.coupling.rate_floor,
        init_threshold=model.coupling.init_threshold,
        lstm_impl=model.lstm_impl,
    )
    traj = np.asarray(res["trajectories"])[0]
    if initial_state is not None:
        # explicit initial state overrides the heuristic (ref 06:283)
        probs = np.asarray(res["probs"])
        k_mod = modulate_rates(
            model.k_base, probs[0, 1], probs[0, 0],
            model.coupling.coupling_strength, model.coupling.rate_floor,
        )
        traj = np.asarray(
            solve_batch(jnp.asarray(initial_state, jnp.float32)[None, :], 0.0,
                        float(forecast_steps), forecast_steps, k_mod[None, :])
        )[0]
    return traj, np.asarray(res["probs"]), np.asarray(res["attention"])
