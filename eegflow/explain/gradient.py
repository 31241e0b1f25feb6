"""Gradient-based channel attribution.

Reference (07_explainability.py:203-284): per-sample backward of
logit[predicted class] w.r.t. the input, |grad| averaged over time, summed
over ~100 samples, normalized to sum 1 — run as a Python loop of backwards
(with the cuDNN train-mode workaround at 07:218-219).

Here the *whole batch* of per-sample input gradients is one
``jax.grad`` of the sum of predicted-class logits (samples are independent,
so d(sum_i logit_i)/dx_i equals each per-sample gradient), under jit — no
loop, no mode workaround.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from eegflow.core.config import ModelConfig
from eegflow.nn.model import classifier_apply


@functools.partial(jax.jit, static_argnames=("model_cfg",))
def _batch_input_gradients(params, x: jnp.ndarray, model_cfg: ModelConfig) -> jnp.ndarray:
    # bf16 matmuls, like the train and eval steps. Attributions are |grad|
    # channel aggregates — AMP noise is far below ranking resolution.
    kw = dict(train=False, compute_dtype=jnp.bfloat16)
    logits = classifier_apply(params, x, model_cfg, **kw)
    pred = jnp.argmax(logits, axis=-1)

    def summed_pred_logit(x_in):
        lg = classifier_apply(params, x_in, model_cfg, **kw)
        return jnp.sum(jnp.take_along_axis(lg, pred[:, None], axis=-1))

    return jax.grad(summed_pred_logit)(x)  # (B, T, C)


def gradient_channel_importance(
    params,
    model_cfg: ModelConfig,
    x: np.ndarray,
    n_samples: int = 100,
    batch_size: int = 256,
    seed: int = 42,
    channel_names: Optional[Sequence[str]] = None,
) -> Dict[str, object]:
    """Per-channel attribution scores, normalized to sum 1 (ref 07:203-284)."""
    rng = np.random.RandomState(seed)
    n_samples = min(n_samples, len(x))
    idx = rng.choice(len(x), n_samples, replace=False)
    subset = x[idx]

    n_channels = x.shape[2]
    importance = np.zeros(n_channels)
    for start in range(0, n_samples, batch_size):
        xb = jnp.asarray(subset[start : start + batch_size], jnp.float32)
        grads = np.asarray(_batch_input_gradients(params, xb, model_cfg))
        importance += np.abs(grads).mean(axis=1).sum(axis=0)  # mean time, sum samples
    importance /= n_samples
    importance = importance / importance.sum()

    names = list(channel_names) if channel_names else [
        f"Ch{i+1}" for i in range(n_channels)
    ]
    order = np.argsort(-importance)
    return {
        "channels": names,
        "importance": importance.tolist(),
        "ranking": [names[i] for i in order],
        "method": "gradient",
    }
