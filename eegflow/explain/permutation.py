"""Permutation channel importance (ref 07_explainability.py:287-361).

Per channel: shuffle that channel's values across samples (n_permutations
repeats) and record the accuracy drop vs baseline.

Design: the evaluation windows go to the device ONCE; each
channel's permuted stack is constructed ON DEVICE inside the jitted
evaluation (a one-hot feature select — only the (R, N) permutation indices
cross the host boundary per channel), and a few channels stay in flight so
accelerator round-trip latency overlaps with compute. The reference tiles
and permutes on host per channel (07:300-330), which at (N=1000, T=256,
C=61) would ship ~19 GB through the interconnect.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import numpy as np

from eegflow.core.config import ModelConfig
from eegflow.train.loop import predict_probs
from eegflow.train.steps import make_eval_step


def permutation_channel_importance(
    params,
    model_cfg: ModelConfig,
    x: np.ndarray,
    y: np.ndarray,
    n_permutations: int = 5,
    n_samples: int = 1000,
    batch_size: int = 5120,
    seed: int = 42,
    channel_names: Optional[Sequence[str]] = None,
    mesh=None,
) -> Dict[str, object]:
    """``mesh`` shards every stacked-permutation batch over the mesh's data
    axis (61 channels x 5 repeats of jitted inference is an explainability
    cost center, SURVEY §2.6/§5)."""
    import jax
    import jax.numpy as jnp

    from eegflow.nn.model import classifier_apply

    rng = np.random.RandomState(seed)
    if len(x) > n_samples:
        idx = rng.choice(len(x), n_samples, replace=False)
        x, y = x[idx], y[idx]
    n = len(x)
    n_channels = x.shape[2]
    eval_step = make_eval_step(model_cfg)

    def predictions(data: np.ndarray) -> np.ndarray:
        probs = predict_probs(params, data, model_cfg, batch_size,
                              eval_step=eval_step, mesh=mesh)
        return probs.argmax(1)

    baseline_acc = float((predictions(x) == y).mean())

    @functools.partial(jax.jit, static_argnames=())
    def channel_accs(p, x_dev, y_dev, perms, ch):
        # build the permuted stack on device: replace feature ``ch`` of each
        # repeat with its permuted values via a one-hot select
        r = perms.shape[0]
        permuted = x_dev[perms.reshape(-1), :, :]          # (R*N, T, C)
        base = jnp.tile(x_dev, (r, 1, 1))
        onehot = (jnp.arange(x_dev.shape[-1]) == ch)
        stacked = jnp.where(onehot, permuted, base)
        logits = classifier_apply(p, stacked, model_cfg, train=False,
                                  compute_dtype=jnp.bfloat16)
        preds = jnp.argmax(logits, axis=-1).reshape(r, -1)
        return jnp.mean(preds == y_dev[None, :], axis=1)

    x_dev = jnp.asarray(x, jnp.float32)   # ships ONCE
    y_dev = jnp.asarray(y)
    if mesh is not None:
        # shard the sample axis; sharding propagates through the permuted
        # gather + forward, replicated params
        from eegflow.train.mesh import replicate_to_mesh, shard_batch

        n_dev = int(np.prod(list(mesh.shape.values())))
        if n % n_dev == 0:
            x_dev, y_dev = shard_batch((x_dev, y_dev), mesh)
            params = replicate_to_mesh(params, mesh)
    all_perms = np.stack(
        [[rng.permutation(n) for _ in range(n_permutations)]
         for _ in range(n_channels)])     # (C, R, N)

    importance = [0.0] * n_channels
    inflight = []

    def drain(limit: int) -> None:
        while len(inflight) > limit:
            ch0, accs = inflight.pop(0)
            importance[ch0] = float(np.mean(baseline_acc - np.asarray(accs)))

    for ch in range(n_channels):
        inflight.append((ch, channel_accs(
            params, x_dev, y_dev, jnp.asarray(all_perms[ch]),
            jnp.asarray(ch))))
        drain(3)
    drain(0)

    names = list(channel_names) if channel_names else [
        f"Ch{i+1}" for i in range(n_channels)
    ]
    order = np.argsort(-np.asarray(importance))
    return {
        "channels": names,
        "importance": importance,
        "baseline_accuracy": baseline_acc,
        "ranking": [names[i] for i in order],
        "method": "permutation",
    }
