"""Multi-layer bidirectional LSTM as ``lax.scan`` recurrences.

Replaces the reference's cuDNN ``nn.LSTM(hidden, 3 layers, bidirectional,
dropout=0.4)`` (ref 04_lstm_model.py:181-188):

* The input contribution ``x @ W_ih`` for ALL timesteps is hoisted out of the
  recurrence into one large (B*T, D) x (D, 4H) matmul, so the ``lax.scan``
  body only carries the (B, H) x (H, 4H) recurrent matmul plus elementwise
  gate math.
* Gate order i, f, g, o and fused bias match torch's convention so weights
  and unit tests are directly comparable.
* Optional bf16 compute: matmuls run in bfloat16 with float32 accumulation;
  the (h, c) state stays float32 for recurrence stability.
* Bidirectional = the same scan over the time-reversed sequence, concatenated
  feature-wise; layers stack with inter-layer dropout like torch (applied to
  every layer output except the last).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from eegflow.nn.layers import dropout


def lstm_layer_init(key: jax.Array, in_dim: int, hidden: int) -> Dict[str, jnp.ndarray]:
    """One direction's parameters; torch init U(-1/sqrt(H), 1/sqrt(H))."""
    bound = 1.0 / jnp.sqrt(hidden)
    k1, k2, k3 = jax.random.split(key, 3)
    return {
        "w_ih": jax.random.uniform(k1, (in_dim, 4 * hidden), jnp.float32, -bound, bound),
        "w_hh": jax.random.uniform(k2, (hidden, 4 * hidden), jnp.float32, -bound, bound),
        # torch keeps separate b_ih/b_hh; their sum is what enters the cell,
        # so a single fused bias is kept here (initialized as the sum of two
        # independent uniforms for distributional parity).
        "b": (
            jax.random.uniform(k3, (4 * hidden,), jnp.float32, -bound, bound)
            + jax.random.uniform(jax.random.fold_in(k3, 1), (4 * hidden,), jnp.float32,
                                 -bound, bound)
        ),
    }


def lstm_cell(
    gates: jnp.ndarray, h: jnp.ndarray, c: jnp.ndarray, w_hh: jnp.ndarray,
    compute_dtype=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One step given precomputed input gates (B, 4H); torch gate order i,f,g,o."""
    if compute_dtype is not None:
        rec = jnp.dot(h.astype(compute_dtype), w_hh.astype(compute_dtype),
                      preferred_element_type=jnp.float32)
    else:
        rec = jnp.dot(h, w_hh)
    z = gates + rec
    hidden = h.shape[-1]
    i = jax.nn.sigmoid(z[..., :hidden])
    f = jax.nn.sigmoid(z[..., hidden : 2 * hidden])
    g = jnp.tanh(z[..., 2 * hidden : 3 * hidden])
    o = jax.nn.sigmoid(z[..., 3 * hidden :])
    c_new = f * c + i * g
    h_new = o * jnp.tanh(c_new)
    return h_new, c_new


def lstm_layer_apply(
    params: Dict[str, jnp.ndarray],
    x: jnp.ndarray,
    reverse: bool = False,
    compute_dtype=None,
) -> jnp.ndarray:
    """One direction over (B, T, D) -> (B, T, H). Zero initial state (torch)."""
    w_ih, w_hh, b = params["w_ih"], params["w_hh"], params["b"]
    if compute_dtype is not None:
        gates_all = (
            jnp.einsum("btd,dg->btg", x.astype(compute_dtype),
                       w_ih.astype(compute_dtype),
                       preferred_element_type=jnp.float32)
            + b
        )
    else:
        gates_all = jnp.einsum("btd,dg->btg", x, w_ih) + b

    hidden = w_hh.shape[0]
    batch = x.shape[0]
    h0 = jnp.zeros((batch, hidden), jnp.float32)
    c0 = jnp.zeros((batch, hidden), jnp.float32)

    def step(carry, g_t):
        h, c = carry
        h, c = lstm_cell(g_t, h, c, w_hh, compute_dtype)
        return (h, c), h

    gates_t = jnp.swapaxes(gates_all, 0, 1)  # (T, B, 4H)
    (_, _), hs = lax.scan(step, (h0, c0), gates_t, reverse=reverse)
    return jnp.swapaxes(hs, 0, 1)  # (B, T, H)


LSTM_IMPLS = ("auto", "scan")


def resolve_lstm_impl(impl: Optional[str]) -> str:
    """Resolve ``TrainConfig.lstm_impl`` to the recurrence that runs.

    ``"auto"`` (or ``None``) and ``"scan"`` both mean the ``lax.scan`` layer
    above, which is the only LSTM implementation. ``"pallas"`` named a fused
    recurrence kernel that was removed; asking for it is an error rather
    than a silent fallback.
    """
    if impl is None or impl in LSTM_IMPLS:
        return "scan"
    if impl == "pallas":
        raise ValueError(
            "lstm_impl='pallas': the fused Pallas LSTM kernel was removed; "
            "use 'auto' or 'scan' (the lax.scan recurrence)")
    raise ValueError(f"unknown lstm_impl {impl!r}; expected one of {LSTM_IMPLS}")


def bilstm_stack_init(
    key: jax.Array, in_dim: int, hidden: int, num_layers: int, bidirectional: bool = True
) -> List[Dict[str, Dict[str, jnp.ndarray]]]:
    layers = []
    d = in_dim
    n_dir = 2 if bidirectional else 1
    for i in range(num_layers):
        key, k_f, k_b = jax.random.split(key, 3)
        layer = {"fwd": lstm_layer_init(k_f, d, hidden)}
        if bidirectional:
            layer["bwd"] = lstm_layer_init(k_b, d, hidden)
        layers.append(layer)
        d = hidden * n_dir
    return layers


def bilstm_stack_apply(
    layers: List[Dict[str, Dict[str, jnp.ndarray]]],
    x: jnp.ndarray,
    inter_dropout: float = 0.0,
    train: bool = False,
    dropout_key: Optional[jax.Array] = None,
    compute_dtype=None,
    input_dropout: float = 0.0,
    input_dropout_key: Optional[jax.Array] = None,
) -> jnp.ndarray:
    """(B, T, D) -> (B, T, H*n_dir); inter-layer dropout like torch nn.LSTM.

    ``input_dropout`` applies dropout to ``x`` itself before the first
    layer. Each layer direction runs under the named scope
    ``lstm_l{i}_{fwd|bwd}`` so a device trace can attribute its time.
    """
    if input_dropout > 0.0 and train:
        x = dropout(x, input_dropout, input_dropout_key, train)
    out = x
    n = len(layers)
    for idx, layer in enumerate(layers):
        with jax.named_scope(f"lstm_l{idx}_fwd"):
            fwd = lstm_layer_apply(layer["fwd"], out, reverse=False,
                                   compute_dtype=compute_dtype)
        if "bwd" in layer:
            with jax.named_scope(f"lstm_l{idx}_bwd"):
                bwd = lstm_layer_apply(layer["bwd"], out, reverse=True,
                                       compute_dtype=compute_dtype)
            out = jnp.concatenate([fwd, bwd], axis=-1)
        else:
            out = fwd
        if idx < n - 1 and inter_dropout > 0.0 and train:
            key = jax.random.fold_in(dropout_key, idx) if dropout_key is not None else None
            out = dropout(out, inter_dropout, key, train)
    return out
