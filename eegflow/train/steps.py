"""Jitted train/eval steps.

One ``train_step`` fuses forward, loss, backward, clip, AdamW update, and
(on a mesh) the gradient all-reduce into a single XLA program — the
replacement for the reference's autocast/GradScaler/accumulate/clip/step
sequence (ref 04_lstm_model.py:486-507). Gradient accumulation uses
``optax.MultiSteps`` (clip applies to the averaged accumulated gradient, same
as the reference's unscale-then-clip on summed grads).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax

from eegflow.core.config import ModelConfig, TrainConfig
from eegflow.nn.losses import cross_entropy_loss
from eegflow.nn.model import classifier_apply


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: jnp.ndarray


def make_optimizer(
    train_cfg: TrainConfig, updates_per_epoch: int
) -> optax.GradientTransformation:
    from eegflow.train.schedule import warmup_cosine_schedule

    schedule = warmup_cosine_schedule(
        train_cfg.learning_rate, train_cfg.epochs, train_cfg.warmup_epochs,
        updates_per_epoch,
    )
    tx = optax.chain(
        optax.clip_by_global_norm(train_cfg.grad_clip),
        optax.adamw(schedule, weight_decay=train_cfg.weight_decay),
    )
    if train_cfg.accumulation_steps > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=train_cfg.accumulation_steps)
    return tx


def make_loss_fn(
    model_cfg: ModelConfig,
    bf16: bool,
    class_weights: Optional[jnp.ndarray] = None,
    lstm_impl: str = "auto",
) -> Callable:
    """``loss_fn(params, x, y, dropout_key) -> (loss, logits)`` of a train
    step: the train-mode forward (dropout on) and the class-weighted CE."""
    compute_dtype = jnp.bfloat16 if bf16 else None
    cw = None if class_weights is None else jnp.asarray(class_weights)

    def loss_fn(params, x, y, key):
        logits = classifier_apply(
            params, x, model_cfg, train=True, dropout_key=key,
            compute_dtype=compute_dtype, lstm_impl=lstm_impl,
        )
        return cross_entropy_loss(logits, y, cw), logits

    return loss_fn


def make_train_step(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    tx: optax.GradientTransformation,
    class_weights: Optional[jnp.ndarray] = None,
    donate: bool = True,
    mesh=None,
) -> Callable:
    """Build ``step(state, x, y, dropout_key) -> (state, metrics)`` under jit.

    With ``mesh``, the step is compiled with explicit shardings — params/state
    replicated, batch sharded on the mesh's data axis — and XLA inserts the
    gradient all-reduce from sharding propagation.
    """
    loss_fn = make_loss_fn(model_cfg, train_cfg.bf16, class_weights,
                           train_cfg.lstm_impl)

    def step(state: TrainState, x, y, key):
        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, x, y, key
        )
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        correct = jnp.sum(jnp.argmax(logits, -1) == y)
        return (
            TrainState(params, opt_state, state.step + 1),
            {"loss": loss, "correct": correct, "count": y.shape[0]},
        )

    donate_argnums = (0,) if donate else ()
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        repl = NamedSharding(mesh, P())
        data = NamedSharding(mesh, P(mesh.axis_names[0]))
        return jax.jit(
            step,
            in_shardings=(repl, data, data, repl),
            out_shardings=(repl, repl),
            donate_argnums=donate_argnums,
        )
    return jax.jit(step, donate_argnums=donate_argnums)


def make_eval_step(
    model_cfg: ModelConfig,
    bf16: bool = True,
    return_attention: bool = False,
    lstm_impl: str = "auto",
) -> Callable:
    """Build ``eval(params, x) -> (probs[, attention])`` under jit (ref 06:334-365)."""
    compute_dtype = jnp.bfloat16 if bf16 else None

    @jax.jit
    def evaluate(params, x):
        out = classifier_apply(
            params, x, model_cfg, train=False,
            return_attention=return_attention, compute_dtype=compute_dtype,
            lstm_impl=lstm_impl,
        )
        if return_attention:
            logits, attn = out
            return jax.nn.softmax(logits, axis=-1), attn
        return jax.nn.softmax(out, axis=-1)

    return evaluate
