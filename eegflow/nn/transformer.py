"""EEGFormer: an attention-only EEG window classifier.

A second model family beyond the reference's scope (the reference defines
``MultiHeadAttention`` but never wires it into a model —
ref 04_lstm_model.py:73-109, dead code). Where the BiLSTM's recurrence is a
serial chain no matrix unit can parallelize over time, a transformer encoder
is pure batched matmuls with no sequential dependence, so its attainable MFU
ceiling is far higher than any recurrent model's.

Architecture (pre-LN encoder):

    input proj Linear(C -> D) + LayerNorm + GELU
    + sinusoidal positions (static per trace; no params, any T)
    N x [ LN -> MHA -> dropout -> +residual ;
          LN -> MLP(D -> r*D -> D, GELU) -> dropout -> +residual ]
    final LN -> additive-attention pooling over time -> MLP head

It is a drop-in flagship alternative: ``classifier_init/apply`` dispatch on
the config type (``TransformerConfig``), so the training loop, mesh steps,
eval/explain paths, and checkpointing all work unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from eegflow.core.config import TransformerConfig
from eegflow.nn.attention import (
    additive_attention_apply,
    additive_attention_init,
    multihead_attention_apply,
    multihead_attention_init,
)
from eegflow.nn.layers import (
    dense_apply,
    dense_init,
    dropout,
    gelu,
    layer_norm_apply,
    layer_norm_init,
)


def sinusoidal_positions(t: int, d: int, dtype=jnp.float32) -> jnp.ndarray:
    """(T, D) fixed sinusoidal position encoding (Vaswani et al. 2017)."""
    pos = jnp.arange(t, dtype=jnp.float32)[:, None]
    i = jnp.arange(d // 2, dtype=jnp.float32)[None, :]
    angle = pos / jnp.power(10000.0, 2.0 * i / d)
    enc = jnp.concatenate([jnp.sin(angle), jnp.cos(angle)], axis=-1)
    if enc.shape[-1] < d:  # odd D: pad the last column
        enc = jnp.pad(enc, ((0, 0), (0, d - enc.shape[-1])))
    return enc.astype(dtype)


def transformer_init(key: jax.Array, config: TransformerConfig) -> Dict[str, Any]:
    d = config.resolved_d_model()
    ks = jax.random.split(key, 4 + config.num_layers)
    blocks = []
    for li in range(config.num_layers):
        bks = jax.random.split(ks[4 + li], 3)
        blocks.append({
            "ln1": layer_norm_init(d),
            "mha": multihead_attention_init(bks[0], d, config.num_heads),
            "ln2": layer_norm_init(d),
            "mlp1": dense_init(bks[1], d, config.mlp_ratio * d),
            "mlp2": dense_init(bks[2], config.mlp_ratio * d, d),
        })
    return {
        "input_proj": dense_init(ks[0], config.input_size, d),
        "input_norm": layer_norm_init(d),
        "blocks": blocks,
        "final_norm": layer_norm_init(d),
        "attention": additive_attention_init(ks[1], d),
        "head1": dense_init(ks[2], d, d // 2),
        "head2": dense_init(ks[3], d // 2, config.num_classes),
    }


def transformer_apply(
    params: Dict[str, Any],
    x: jnp.ndarray,
    config: TransformerConfig,
    train: bool = False,
    dropout_key: Optional[jax.Array] = None,
    return_attention: bool = False,
    compute_dtype=None,
) -> jnp.ndarray | Tuple[jnp.ndarray, jnp.ndarray]:
    """(B, T, C) windows -> (B, num_classes) logits (+ pooling attention (B, T)).

    Same contract as :func:`eegflow.nn.model.classifier_apply`; with
    ``compute_dtype=jnp.bfloat16`` every matmul runs in bf16 with f32
    accumulation.
    """
    d_rate = config.dropout
    t = x.shape[1]
    d = config.resolved_d_model()

    def key_for(i):
        if train and dropout_key is not None:
            return jax.random.fold_in(dropout_key, i)
        return None

    h = dense_apply(params["input_proj"], x, compute_dtype)
    h = layer_norm_apply(params["input_norm"], h)
    h = gelu(h)
    h = h + sinusoidal_positions(t, d, h.dtype)[None]
    h = dropout(h, d_rate / 2, key_for(0), train)

    for li, blk in enumerate(params["blocks"]):
        a, _ = multihead_attention_apply(
            blk["mha"], layer_norm_apply(blk["ln1"], h),
            num_heads=config.num_heads, compute_dtype=compute_dtype)
        h = h + dropout(a, d_rate, key_for(1 + 2 * li), train)
        m = gelu(dense_apply(blk["mlp1"], layer_norm_apply(blk["ln2"], h),
                             compute_dtype))
        m = dense_apply(blk["mlp2"], m, compute_dtype)
        h = h + dropout(m, d_rate, key_for(2 + 2 * li), train)

    h = layer_norm_apply(params["final_norm"], h)
    context, attn = additive_attention_apply(params["attention"], h,
                                             compute_dtype)

    z = gelu(dense_apply(params["head1"], context, compute_dtype))
    z = dropout(z, d_rate, key_for(1 + 2 * len(params["blocks"])), train)
    logits = dense_apply(params["head2"], z, compute_dtype)

    if return_attention:
        return logits, attn
    return logits


def transformer_flops_per_window(config: TransformerConfig,
                                 seq_len: int = 256) -> int:
    """Forward matmul FLOPs per window — for bench/MFU reporting."""
    d = config.resolved_d_model()
    t = seq_len
    c = config.input_size
    fl = 2 * t * c * d                       # input proj
    per_block = (4 * 2 * t * d * d           # Q, K, V, out projections
                 + 2 * 2 * t * t * d         # scores + context einsums
                 + 2 * 2 * t * d * (config.mlp_ratio * d))  # MLP
    fl += config.num_layers * per_block
    fl += 2 * t * d * (d // 2) + 2 * t * (d // 2)   # additive attention pool
    fl += 2 * d * (d // 2) + 2 * (d // 2) * config.num_classes
    return int(fl)
