"""Functional building blocks: dense, layer-norm, dropout.

Params are plain nested dicts of jnp arrays (a pytree), applied by pure
functions — the idiomatic JAX shape for a model this size, and what lets the
train step jit/shard cleanly. Initialization follows torch defaults so
numerics are comparable with the reference:
Linear: W, b ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)).
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp


def dense_init(key: jax.Array, in_dim: int, out_dim: int) -> Dict[str, jnp.ndarray]:
    k_w, k_b = jax.random.split(key)
    bound = 1.0 / jnp.sqrt(in_dim)
    return {
        "w": jax.random.uniform(k_w, (in_dim, out_dim), jnp.float32, -bound, bound),
        "b": jax.random.uniform(k_b, (out_dim,), jnp.float32, -bound, bound),
    }


def dense_apply(
    params: Dict[str, jnp.ndarray], x: jnp.ndarray, compute_dtype=None
) -> jnp.ndarray:
    """x @ W + b. With ``compute_dtype=bfloat16`` the matmul runs in bf16
    with float32 accumulation; params stay float32."""
    w, b = params["w"], params["b"]
    if compute_dtype is not None:
        y = jnp.dot(x.astype(compute_dtype), w.astype(compute_dtype),
                    preferred_element_type=jnp.float32)
    else:
        y = jnp.dot(x, w)
    return y + b


def layer_norm_init(dim: int) -> Dict[str, jnp.ndarray]:
    return {"scale": jnp.ones((dim,), jnp.float32), "bias": jnp.zeros((dim,), jnp.float32)}


def layer_norm_apply(
    params: Dict[str, jnp.ndarray], x: jnp.ndarray, eps: float = 1e-5
) -> jnp.ndarray:
    # stats always in f32: under the bf16 policy activations may arrive
    # bf16, and a 512-lane mean/var with a bf16 accumulator loses ~2 digits
    x = x.astype(jnp.float32)
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.var(x, axis=-1, keepdims=True)
    norm = (x - mean) * jax.lax.rsqrt(var + eps)
    return norm * params["scale"] + params["bias"]


def _rbg_key(key: jax.Array) -> jax.Array:
    """Re-seed ``key`` as an ``rbg`` PRNG key (same derivation tree, cheaper
    bits).

    Threefry bit generation is pure elementwise arithmetic in XLA, while
    ``rbg`` lowers to XLA's ``RngBitGenerator`` op. Key *derivation*
    (split/fold_in) stays threefry — only the final bit draw swaps — so mask
    streams remain deterministic per seed. rbg bit order is only guaranteed
    stable per backend+compiler, which is fine for dropout masks (any fixed
    Bernoulli stream is a valid mask) but not for anything that must be
    reproducible across platforms."""
    data = jax.random.key_data(key).astype(jnp.uint32).reshape(-1)
    return jax.random.wrap_key_data(jnp.concatenate([data, data])[:4],
                                    impl="rbg")


def dropout_mask(key: jax.Array, rate: float, shape) -> jnp.ndarray:
    """Boolean KEEP-mask for :func:`dropout`.

    The Bernoulli draw uses 8 random bits per element from an ``rbg`` key
    (:func:`_rbg_key`) instead of ``jax.random.bernoulli``'s 32 threefry
    bits. The keep probability quantizes to ``round(keep*256)/256`` (<=0.2%
    relative for the 0.2-0.5 rates used here); the ``1/keep`` rescale keeps
    the nominal value, so E[output] shifts by the same <=0.2% during
    training only. Mask streams stay deterministic per seed.
    """
    keep = 1.0 - rate
    thresh = jnp.uint8(max(1, min(255, int(round(keep * 256.0)))))
    return jax.random.bits(_rbg_key(key), shape, jnp.uint8) < thresh


def dropout(
    x: jnp.ndarray, rate: float, key: Optional[jax.Array], train: bool
) -> jnp.ndarray:
    """Inverted dropout; identity when not training or rate==0."""
    if not train or rate <= 0.0 or key is None:
        return x
    keep = 1.0 - rate
    mask = dropout_mask(key, rate, x.shape)
    return jnp.where(mask, x / keep, 0.0)


def gelu(x: jnp.ndarray) -> jnp.ndarray:
    """Exact (erf) GELU — torch nn.GELU default, unlike jax.nn.gelu's tanh approx."""
    return jax.nn.gelu(x, approximate=False)


def residual_block_init(key: jax.Array, hidden: int) -> Dict[str, object]:
    """FC-GELU-dropout-FC + post-add LayerNorm residual block
    (ref 04_lstm_model.py:131-150 — declared there but unused; provided here
    as a usable, tested head component)."""
    k1, k2 = jax.random.split(key)
    return {
        "fc1": dense_init(k1, hidden, hidden),
        "fc2": dense_init(k2, hidden, hidden),
        "norm": layer_norm_init(hidden),
    }


def residual_block_apply(
    params: Dict[str, object],
    x: jnp.ndarray,
    rate: float = 0.3,
    key: Optional[jax.Array] = None,
    train: bool = False,
    compute_dtype=None,
) -> jnp.ndarray:
    k1 = k2 = None
    if train and key is not None:
        k1, k2 = jax.random.split(key)
    out = gelu(dense_apply(params["fc1"], x, compute_dtype))
    out = dropout(out, rate, k1, train)
    out = dense_apply(params["fc2"], out, compute_dtype)
    out = dropout(out, rate, k2, train)
    return layer_norm_apply(params["norm"], out + x)
