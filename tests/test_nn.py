"""NN-layer tests: LSTM vs torch oracle, attention properties, model shapes,
losses vs torch semantics, ablation switches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eegflow.core.config import ModelConfig
from eegflow.nn import (
    additive_attention_apply,
    additive_attention_init,
    bilstm_stack_apply,
    bilstm_stack_init,
    classifier_apply,
    classifier_init,
    cross_entropy_loss,
    dense_apply,
    dense_init,
    focal_loss,
    layer_norm_apply,
    layer_norm_init,
    lstm_layer_apply,
    lstm_layer_init,
    multihead_attention_apply,
    multihead_attention_init,
)

torch = pytest.importorskip("torch")


def _load_torch_lstm_weights(params, torch_lstm, layer=0, direction=0):
    """Copy our params into a torch.nn.LSTM for an apples-to-apples oracle."""
    suffix = "_reverse" if direction == 1 else ""
    w_ih = np.asarray(params["w_ih"]).T  # (4H, D)
    w_hh = np.asarray(params["w_hh"]).T
    b = np.asarray(params["b"])
    getattr(torch_lstm, f"weight_ih_l{layer}{suffix}").data = torch.tensor(w_ih)
    getattr(torch_lstm, f"weight_hh_l{layer}{suffix}").data = torch.tensor(w_hh)
    getattr(torch_lstm, f"bias_ih_l{layer}{suffix}").data = torch.tensor(b)
    getattr(torch_lstm, f"bias_hh_l{layer}{suffix}").data = torch.zeros(len(b))


def test_lstm_layer_matches_torch():
    key = jax.random.key(0)
    d, h, b_sz, t = 12, 16, 4, 32
    params = lstm_layer_init(key, d, h)
    x = np.random.default_rng(0).standard_normal((b_sz, t, d)).astype(np.float32)

    ours = np.asarray(lstm_layer_apply(params, jnp.asarray(x)))

    tl = torch.nn.LSTM(d, h, num_layers=1, batch_first=True)
    _load_torch_lstm_weights(params, tl)
    with torch.no_grad():
        ref, _ = tl(torch.tensor(x))
    np.testing.assert_allclose(ours, ref.numpy(), atol=1e-5)


def test_lstm_reverse_matches_torch_bidirectional():
    key = jax.random.key(1)
    d, h, b_sz, t = 8, 12, 3, 20
    stack = bilstm_stack_init(key, d, h, num_layers=1, bidirectional=True)
    x = np.random.default_rng(1).standard_normal((b_sz, t, d)).astype(np.float32)

    ours = np.asarray(bilstm_stack_apply(stack, jnp.asarray(x)))

    tl = torch.nn.LSTM(d, h, num_layers=1, batch_first=True, bidirectional=True)
    _load_torch_lstm_weights(stack[0]["fwd"], tl, 0, 0)
    _load_torch_lstm_weights(stack[0]["bwd"], tl, 0, 1)
    with torch.no_grad():
        ref, _ = tl(torch.tensor(x))
    np.testing.assert_allclose(ours, ref.numpy(), atol=1e-5)


def test_lstm_stack_3layer_bidirectional_matches_torch():
    key = jax.random.key(2)
    d, h, b_sz, t = 6, 8, 2, 16
    stack = bilstm_stack_init(key, d, h, num_layers=3, bidirectional=True)
    x = np.random.default_rng(2).standard_normal((b_sz, t, d)).astype(np.float32)

    ours = np.asarray(bilstm_stack_apply(stack, jnp.asarray(x)))  # eval: no dropout

    tl = torch.nn.LSTM(d, h, num_layers=3, batch_first=True, bidirectional=True,
                       dropout=0.0)
    for layer in range(3):
        _load_torch_lstm_weights(stack[layer]["fwd"], tl, layer, 0)
        _load_torch_lstm_weights(stack[layer]["bwd"], tl, layer, 1)
    with torch.no_grad():
        ref, _ = tl(torch.tensor(x))
    np.testing.assert_allclose(ours, ref.numpy(), atol=1e-4)


def test_lstm_bf16_close_to_f32():
    key = jax.random.key(3)
    params = lstm_layer_init(key, 16, 32)
    x = jnp.asarray(np.random.default_rng(3).standard_normal((4, 64, 16)), jnp.float32)
    f32 = np.asarray(lstm_layer_apply(params, x))
    bf16 = np.asarray(lstm_layer_apply(params, x, compute_dtype=jnp.bfloat16))
    assert np.max(np.abs(f32 - bf16)) < 0.05
    assert np.corrcoef(f32.ravel(), bf16.ravel())[0, 1] > 0.999


def test_additive_attention_properties():
    key = jax.random.key(4)
    params = additive_attention_init(key, 32)
    x = jnp.asarray(np.random.default_rng(4).standard_normal((5, 10, 32)), jnp.float32)
    ctx, w = additive_attention_apply(params, x)
    assert ctx.shape == (5, 32) and w.shape == (5, 10)
    np.testing.assert_allclose(np.asarray(w).sum(axis=1), 1.0, atol=1e-6)
    # context is inside the convex hull of inputs along each feature
    xn = np.asarray(x)
    assert np.all(np.asarray(ctx) <= xn.max(axis=1) + 1e-5)
    assert np.all(np.asarray(ctx) >= xn.min(axis=1) - 1e-5)


def test_multihead_attention_shapes_and_softmax():
    key = jax.random.key(5)
    params = multihead_attention_init(key, 32, num_heads=4)
    x = jnp.asarray(np.random.default_rng(5).standard_normal((3, 12, 32)), jnp.float32)
    out, w = multihead_attention_apply(params, x)
    assert out.shape == (3, 12, 32) and w.shape == (3, 12)
    np.testing.assert_allclose(np.asarray(w).sum(axis=1), 1.0, atol=1e-5)


def test_dense_matches_torch_linear():
    key = jax.random.key(6)
    p = dense_init(key, 10, 7)
    x = np.random.default_rng(6).standard_normal((4, 10)).astype(np.float32)
    ours = np.asarray(dense_apply(p, jnp.asarray(x)))
    lin = torch.nn.Linear(10, 7)
    lin.weight.data = torch.tensor(np.asarray(p["w"]).T)
    lin.bias.data = torch.tensor(np.asarray(p["b"]))
    with torch.no_grad():
        ref = lin(torch.tensor(x)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_layer_norm_matches_torch():
    p = layer_norm_init(16)
    x = np.random.default_rng(7).standard_normal((4, 16)).astype(np.float32)
    ours = np.asarray(layer_norm_apply(p, jnp.asarray(x)))
    ln = torch.nn.LayerNorm(16)
    with torch.no_grad():
        ref = ln(torch.tensor(x)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_cross_entropy_matches_torch_weighted():
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((32, 2)).astype(np.float32)
    labels = rng.integers(0, 2, 32)
    weights = np.array([0.3, 0.7], np.float32)
    ours = float(cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                    jnp.asarray(weights)))
    ref = torch.nn.functional.cross_entropy(
        torch.tensor(logits), torch.tensor(labels), weight=torch.tensor(weights)
    ).item()
    assert abs(ours - ref) < 1e-6


def test_focal_loss_matches_reference_formula():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((16, 2)).astype(np.float32)
    labels = rng.integers(0, 2, 16)
    ours = float(focal_loss(jnp.asarray(logits), jnp.asarray(labels), gamma=2.0))
    ce = torch.nn.functional.cross_entropy(
        torch.tensor(logits), torch.tensor(labels), reduction="none"
    )
    pt = torch.exp(-ce)
    ref = (((1 - pt) ** 2.0) * ce).mean().item()
    assert abs(ours - ref) < 1e-6


@pytest.mark.parametrize("cfg", [
    ModelConfig(input_size=61, hidden_size=32, num_layers=2),
    ModelConfig(input_size=61, hidden_size=32, num_layers=2, use_attention=False),
    ModelConfig(input_size=61, hidden_size=32, num_layers=1, bidirectional=False),
    ModelConfig(input_size=61, hidden_size=32, num_layers=2, use_layer_norm=False),
])
def test_classifier_forward_shapes(cfg):
    key = jax.random.key(10)
    params = classifier_init(key, cfg)
    x = jnp.asarray(np.random.default_rng(10).standard_normal((4, 64, 61)), jnp.float32)
    logits, attn = classifier_apply(params, x, cfg, return_attention=True)
    assert logits.shape == (4, cfg.num_classes)
    assert attn.shape == (4, 64)
    np.testing.assert_allclose(np.asarray(attn).sum(axis=1), 1.0, atol=1e-5)
    assert np.all(np.isfinite(np.asarray(logits)))


def test_classifier_hidden_autoresolution():
    assert ModelConfig(input_size=61).resolved_hidden() == 256
    assert ModelConfig(input_size=14).resolved_hidden() == 128


def test_classifier_dropout_changes_train_output_only():
    cfg = ModelConfig(input_size=8, hidden_size=16, num_layers=2)
    key = jax.random.key(11)
    params = classifier_init(key, cfg)
    x = jnp.asarray(np.random.default_rng(11).standard_normal((2, 32, 8)), jnp.float32)
    eval1 = np.asarray(classifier_apply(params, x, cfg, train=False))
    eval2 = np.asarray(classifier_apply(params, x, cfg, train=False))
    np.testing.assert_array_equal(eval1, eval2)
    tr1 = np.asarray(classifier_apply(params, x, cfg, train=True,
                                      dropout_key=jax.random.key(1)))
    tr2 = np.asarray(classifier_apply(params, x, cfg, train=True,
                                      dropout_key=jax.random.key(2)))
    assert not np.allclose(tr1, tr2)


def test_rbg_dropout_deterministic_and_correct_rate():
    # dropout draws its bits from the rbg generator (layers._rbg_key); the
    # mask stream must stay a deterministic Bernoulli(keep) — semantics
    # identical to threefry, bits cheaper
    from eegflow.nn.layers import _rbg_key, dropout

    key = jax.random.key(7)
    rkey = _rbg_key(key)
    assert str(jax.random.key_impl(rkey)) == "rbg"
    # derivation is a pure function of the source key
    assert jnp.array_equal(jax.random.key_data(_rbg_key(key)),
                           jax.random.key_data(rkey))
    x = jnp.ones((500, 200))
    a = jnp.where(jax.random.bernoulli(rkey, 0.6, x.shape), x / 0.6, 0.0)
    b = jnp.where(jax.random.bernoulli(rkey, 0.6, x.shape), x / 0.6, 0.0)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    keep_frac = float((np.asarray(a) > 0).mean())
    assert abs(keep_frac - 0.6) < 0.02
    # distinct source keys give distinct streams
    c = jnp.where(jax.random.bernoulli(_rbg_key(jax.random.key(8)), 0.6,
                                       x.shape), x / 0.6, 0.0)
    assert not np.array_equal(np.asarray(a), np.asarray(c))
    # dropout() itself is deterministic per key
    d1 = dropout(x, 0.4, key, True)
    d2 = dropout(x, 0.4, key, True)
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))


def test_classifier_is_jittable_and_grads_flow():
    cfg = ModelConfig(input_size=8, hidden_size=16, num_layers=2)
    params = classifier_init(jax.random.key(12), cfg)
    x = jnp.asarray(np.random.default_rng(12).standard_normal((4, 32, 8)), jnp.float32)
    y = jnp.asarray([0, 1, 0, 1])

    @jax.jit
    def loss_fn(p):
        return cross_entropy_loss(classifier_apply(p, x, cfg), y)

    g = jax.grad(loss_fn)(params)
    leaves = jax.tree_util.tree_leaves(g)
    assert all(np.all(np.isfinite(np.asarray(l))) for l in leaves)
    assert any(float(jnp.abs(l).max()) > 0 for l in leaves)


def test_resolve_lstm_impl_contract():
    """'auto' and 'scan' both resolve to the lax.scan recurrence; the removed
    'pallas' kernel and unknown names raise instead of falling back."""
    from eegflow.nn.lstm import resolve_lstm_impl

    assert resolve_lstm_impl("scan") == "scan"
    assert resolve_lstm_impl("auto") == "scan"
    assert resolve_lstm_impl(None) == "scan"
    with pytest.raises(ValueError, match="removed"):
        resolve_lstm_impl("pallas")
    with pytest.raises(ValueError, match="unknown"):
        resolve_lstm_impl("cudnn")
