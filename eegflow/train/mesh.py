"""Device mesh + sharding helpers: the framework's entire "distributed backend".

The reference is single-GPU (SURVEY.md §2.11); here data parallelism is a
1-D data mesh over the visible devices. Two styles are provided:

* implicit: jit with ``NamedSharding`` — batch sharded on the 'data' axis,
  params replicated; XLA inserts the gradient all-reduce (psum) automatically
  from sharding propagation. This is the production path.
* explicit: ``shard_map`` with a hand-written ``lax.pmean`` — used by the
  multi-device dry run and sharding tests, and as the scaffold for pipeline /
  tensor axes if the model ever outgrows one device.

The mesh abstraction deliberately allows extra axes (e.g. ('data', 'model'))
even though this workload only needs DP at reference scale.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_data_mesh(
    n_devices: Optional[int] = None, axis_name: str = "data",
    devices: Optional[Sequence] = None,
) -> Mesh:
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def shard_batch(batch: Any, mesh: Mesh, axis_name: str = "data") -> Any:
    """Place array(s) with the leading axis sharded across the mesh."""
    sharding = NamedSharding(mesh, P(axis_name))
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), batch)


def replicate_to_mesh(tree: Any, mesh: Mesh) -> Any:
    """Replicate a pytree (params/opt state) across every device of the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), tree)


def make_spmd_train_step(
    model_cfg, train_cfg, tx, mesh: Mesh, class_weights=None,
    axis_name: str = "data", donate: bool = False,
) -> Callable:
    """Explicit-collective SPMD train step via shard_map + lax.pmean.

    Per-shard gradients are averaged with one pmean; the optimizer update
    runs replicated. Functionally identical to the implicit path —
    kept as the explicit skeleton (and what dryrun_multichip exercises).
    """
    import optax
    from jax import shard_map

    from eegflow.train.steps import TrainState, make_loss_fn

    loss_fn = make_loss_fn(model_cfg, train_cfg.bf16, class_weights,
                           train_cfg.lstm_impl)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis_name), P(axis_name), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def spmd_step(state: TrainState, x, y, key):
        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, x, y, key
        )
        grads = jax.lax.pmean(grads, axis_name)   # gradient all-reduce
        loss = jax.lax.pmean(loss, axis_name)
        correct = jax.lax.psum(jnp.sum(jnp.argmax(logits, -1) == y), axis_name)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        new_state = TrainState(params, opt_state, state.step + 1)
        return new_state, {"loss": loss, "correct": correct}

    return jax.jit(spmd_step, donate_argnums=(0,) if donate else ())


def make_spmd_eval_step(
    model_cfg, mesh: Mesh, bf16: bool = True, axis_name: str = "data",
) -> Callable:
    """Explicit-collective SPMD eval: ``eval(params, x) -> probs``.

    Each device runs a complete per-shard forward. Inputs: params replicated, ``x`` sharded on ``axis_name``; output probs
    sharded the same way.
    """
    from jax import shard_map

    from eegflow.nn.model import classifier_apply

    compute_dtype = jnp.bfloat16 if bf16 else None

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis_name)),
        out_specs=P(axis_name),
        check_vma=False,
    )
    def spmd_eval(params, x):
        logits = classifier_apply(params, x, model_cfg, train=False,
                                  compute_dtype=compute_dtype)
        return jax.nn.softmax(logits, axis=-1)

    return jax.jit(spmd_eval)
