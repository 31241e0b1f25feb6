"""The flagship EEG classifier: input projection -> BiLSTM stack -> layer norm
-> additive-attention pooling -> MLP head.

Architecture parity with the reference's ``EnhancedLSTMModel``
(ref 04_lstm_model.py:153-222), re-expressed as pure init/apply functions over
a params pytree. Supports the ablation switches of the reference's
``AblationLSTMModel`` (ref 09_sensitivity_analysis.py:176-240):
``use_attention`` (mean-pool fallback), ``use_layer_norm`` (identity),
``bidirectional``, ``num_layers``.

Hidden size resolves to 256 when input_size > 30 else 128 (ref 04:877).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from eegflow.core.config import ModelConfig, TransformerConfig
from eegflow.nn.attention import additive_attention_apply, additive_attention_init
from eegflow.nn.layers import (
    dense_apply,
    dense_init,
    dropout,
    gelu,
    layer_norm_apply,
    layer_norm_init,
)
from eegflow.nn.lstm import bilstm_stack_apply, bilstm_stack_init, resolve_lstm_impl


def classifier_init(key: jax.Array, config: ModelConfig) -> Dict[str, Any]:
    if isinstance(config, TransformerConfig):
        from eegflow.nn.transformer import transformer_init

        return transformer_init(key, config)
    hidden = config.resolved_hidden()
    n_dir = 2 if config.bidirectional else 1
    lstm_out = hidden * n_dir
    ks = jax.random.split(key, 8)

    params: Dict[str, Any] = {
        "input_proj": dense_init(ks[0], config.input_size, hidden),
        "input_norm": layer_norm_init(hidden),
        "lstm": bilstm_stack_init(ks[1], hidden, hidden, config.num_layers,
                                  config.bidirectional),
        "head1": dense_init(ks[4], lstm_out, hidden),
        "head2": dense_init(ks[5], hidden, hidden // 2),
        "head3": dense_init(ks[6], hidden // 2, config.num_classes),
    }
    if config.use_layer_norm:
        params["lstm_norm"] = layer_norm_init(lstm_out)
    if config.use_attention:
        params["attention"] = additive_attention_init(ks[3], lstm_out)
    return params


def classifier_apply(
    params: Dict[str, Any],
    x: jnp.ndarray,
    config: ModelConfig,
    train: bool = False,
    dropout_key: Optional[jax.Array] = None,
    return_attention: bool = False,
    compute_dtype=None,
    lstm_impl: str = "auto",
) -> jnp.ndarray | Tuple[jnp.ndarray, jnp.ndarray]:
    """(B, T, C) windows -> (B, num_classes) logits (+ attention (B, T)).

    ``compute_dtype=jnp.bfloat16`` runs all matmuls in bf16 with f32
    accumulation, the counterpart of the reference's FP16 autocast
    (ref 04:486-489). ``lstm_impl`` is checked by
    :func:`eegflow.nn.lstm.resolve_lstm_impl`; the recurrence is always the
    ``lax.scan`` layer. The input block, the LN + attention pool and the head
    run under named scopes so a device trace can attribute their time.
    """
    if isinstance(config, TransformerConfig):
        from eegflow.nn.transformer import transformer_apply

        return transformer_apply(
            params, x, config, train=train, dropout_key=dropout_key,
            return_attention=return_attention, compute_dtype=compute_dtype)

    resolve_lstm_impl(lstm_impl)
    d = config.dropout
    keys = {}
    if train and dropout_key is not None:
        names = ["inp", "lstm", "h1", "h2"]
        for i, n in enumerate(names):
            keys[n] = jax.random.fold_in(dropout_key, i)

    # input projection block (ref 04:173-178): Linear -> LN -> GELU -> Dropout(d/2)
    with jax.named_scope("input_block"):
        h = dense_apply(params["input_proj"], x, compute_dtype)
        h = layer_norm_apply(params["input_norm"], h)
        h = gelu(h)

    # BiLSTM stack with inter-layer dropout d (ref 04:181-188); the input
    # dropout (d/2) is applied by the stack
    h = bilstm_stack_apply(
        params["lstm"], h, inter_dropout=d if config.num_layers > 1 else 0.0,
        train=train, dropout_key=keys.get("lstm"), compute_dtype=compute_dtype,
        input_dropout=d / 2, input_dropout_key=keys.get("inp"),
    )

    with jax.named_scope("attention_pool"):
        if config.use_layer_norm:
            h = layer_norm_apply(params["lstm_norm"], h)

        if config.use_attention:
            context, attn = additive_attention_apply(params["attention"], h,
                                                     compute_dtype)
        else:
            context = jnp.mean(h, axis=1)  # ablation fallback (ref 09:236-237)
            attn = jnp.full(h.shape[:2], 1.0 / h.shape[1], h.dtype)

    # classifier head (ref 04:196-204)
    with jax.named_scope("head"):
        z = gelu(dense_apply(params["head1"], context, compute_dtype))
        z = dropout(z, d, keys.get("h1"), train)
        z = gelu(dense_apply(params["head2"], z, compute_dtype))
        z = dropout(z, d, keys.get("h2"), train)
        logits = dense_apply(params["head3"], z, compute_dtype)

    if return_attention:
        return logits, attn
    return logits


def model_flops_per_window(config: ModelConfig, seq_len: int = 256) -> int:
    """Forward-pass FLOPs per window (matmuls only) — for bench reporting."""
    if isinstance(config, TransformerConfig):
        from eegflow.nn.transformer import transformer_flops_per_window

        return transformer_flops_per_window(config, seq_len)
    h = config.resolved_hidden()
    n_dir = 2 if config.bidirectional else 1
    c = config.input_size
    fl = 2 * seq_len * c * h  # input proj
    d = h
    for _ in range(config.num_layers):
        per_dir = 2 * seq_len * d * 4 * h + 2 * seq_len * h * 4 * h
        fl += n_dir * per_dir
        d = h * n_dir
    lstm_out = h * n_dir
    fl += 2 * seq_len * lstm_out * (lstm_out // 2) + 2 * seq_len * (lstm_out // 2)
    fl += 2 * lstm_out * h + 2 * h * (h // 2) + 2 * (h // 2) * config.num_classes
    return int(fl)
