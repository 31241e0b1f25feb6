"""The classifier's non-recurrent blocks, as XLA runs them, against torch.

* the pooling head: LayerNorm -> additive attention (Linear -> tanh ->
  Linear -> softmax over time -> weighted sum; ref 04_lstm_model.py:112-128,
  190-194), forward and every gradient;
* the input block: Linear -> LayerNorm -> exact GELU (ref 04:173-178),
  forward and every gradient, in f32 and under the bf16 policy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eegflow.nn.attention import additive_attention_apply, additive_attention_init
from eegflow.nn.layers import (dense_apply, dense_init, gelu, layer_norm_apply,
                               layer_norm_init)

torch = pytest.importorskip("torch")
F = torch.nn.functional


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float64), requires_grad=grad)


def _ln_params(d, rng):
    return {"scale": jnp.asarray(1.0 + 0.1 * rng.standard_normal(d), jnp.float32),
            "bias": jnp.asarray(0.1 * rng.standard_normal(d), jnp.float32)}


def _pool(ln, attn, x, use_ln):
    h = layer_norm_apply(ln, x) if use_ln else x
    return additive_attention_apply(attn, h)


def _torch_pool(ln, attn, x, use_ln):
    """float64 torch oracle of LN + additive attention pooling."""
    h = (F.layer_norm(x, (x.shape[-1],), ln["scale"], ln["bias"], eps=1e-5)
         if use_ln else x)
    s = torch.tanh(h @ attn["proj"]["w"] + attn["proj"]["b"])
    s = s @ attn["score"]["w"] + attn["score"]["b"]          # (B, T, 1)
    w = torch.softmax(s, dim=1)
    return (w * h).sum(1), w[..., 0]


@pytest.mark.parametrize("use_ln", [True, False], ids=["ln", "no_ln"])
@pytest.mark.parametrize("b,t,d", [(8, 32, 16), (5, 24, 32)])
def test_pool_head_matches_torch_with_grads(b, t, d, use_ln):
    rng = np.random.default_rng(b * t + d)
    attn = additive_attention_init(jax.random.key(d), d)
    ln = _ln_params(d, rng)
    x = jnp.asarray(rng.standard_normal((b, t, d)), jnp.float32)

    ctx, w = _pool(ln, attn, x, use_ln)

    def loss(ln_p, attn_p, xx):
        c, ww = _pool(ln_p, attn_p, xx, use_ln)
        return jnp.sum(jnp.tanh(c)) + jnp.sum(jnp.sin(3.0 * ww))

    g_ln, g_attn, g_x = jax.grad(loss, argnums=(0, 1, 2))(ln, attn, x)

    ln_t = {k: _t(v, True) for k, v in ln.items()}
    attn_t = {k: {kk: _t(vv, True) for kk, vv in v.items()}
              for k, v in attn.items()}
    x_t = _t(x, True)
    ctx_t, w_t = _torch_pool(ln_t, attn_t, x_t, use_ln)
    (torch.tanh(ctx_t).sum() + torch.sin(3.0 * w_t).sum()).backward()

    np.testing.assert_allclose(np.asarray(ctx), ctx_t.detach().numpy(),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(np.asarray(w), w_t.detach().numpy(), atol=2e-6)
    np.testing.assert_allclose(np.asarray(g_x), x_t.grad.numpy(),
                               atol=3e-5, rtol=1e-3)
    for k in ("proj", "score"):
        for kk in ("w", "b"):
            np.testing.assert_allclose(np.asarray(g_attn[k][kk]),
                                       attn_t[k][kk].grad.numpy(),
                                       atol=3e-5, rtol=1e-3)
    if use_ln:
        for k in ("scale", "bias"):
            np.testing.assert_allclose(np.asarray(g_ln[k]),
                                       ln_t[k].grad.numpy(),
                                       atol=3e-5, rtol=1e-3)


def test_pool_head_large_scores_stay_finite():
    """Softmax over large raw scores must not overflow."""
    d = 16
    attn = additive_attention_init(jax.random.key(1), d)
    attn["score"]["w"] = attn["score"]["w"] * 200.0
    x = jnp.asarray(50.0 * np.random.default_rng(1).standard_normal((4, 16, d)),
                    jnp.float32)
    ctx, w = additive_attention_apply(attn, x)
    assert np.isfinite(np.asarray(ctx)).all()
    np.testing.assert_allclose(np.asarray(w).sum(-1), 1.0, atol=1e-5)
    attn_t = {k: {kk: _t(vv) for kk, vv in v.items()} for k, v in attn.items()}
    ctx_t, _ = _torch_pool(None, attn_t, _t(x), use_ln=False)
    np.testing.assert_allclose(np.asarray(ctx), ctx_t.numpy(),
                               atol=1e-3, rtol=1e-4)


def _input_block(proj, norm, x, dtype=None):
    return gelu(layer_norm_apply(norm, dense_apply(proj, x, dtype)))


def _torch_input_block(proj, norm, x):
    z = x @ proj["w"] + proj["b"]
    z = F.layer_norm(z, (z.shape[-1],), norm["scale"], norm["bias"], eps=1e-5)
    return F.gelu(z)               # exact (erf) GELU, torch nn.GELU default


INPUT_SHAPES = [(8, 16, 13, 32), (5, 16, 61, 16)]


def _input_setup(b, t, c, h):
    rng = np.random.default_rng(b + c)
    proj = dense_init(jax.random.key(c), c, h)
    norm = _ln_params(h, rng)
    x = jnp.asarray(rng.standard_normal((b, t, c)), jnp.float32)
    return proj, norm, x


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,c,h", INPUT_SHAPES)
def test_input_block_matches_torch_with_grads(b, t, c, h, bf16):
    """f32 to 1e-5; the bf16 policy (bf16 matmul inputs, f32 accumulation
    and LN statistics) to 2e-2 forward and 3 % of the largest gradient."""
    proj, norm, x = _input_setup(b, t, c, h)
    dtype = jnp.bfloat16 if bf16 else None

    def loss(p, n, xx):
        return jnp.sum(jnp.tanh(_input_block(p, n, xx, dtype)))

    y = np.asarray(_input_block(proj, norm, x, dtype))
    g_p, g_n, g_x = jax.grad(loss, argnums=(0, 1, 2))(proj, norm, x)

    proj_t = {k: _t(v, True) for k, v in proj.items()}
    norm_t = {k: _t(v, True) for k, v in norm.items()}
    x_t = _t(x, True)
    y_t = _torch_input_block(proj_t, norm_t, x_t)
    torch.tanh(y_t).sum().backward()

    tol = 2e-2 if bf16 else 1e-5
    np.testing.assert_allclose(y, y_t.detach().numpy(), atol=tol, rtol=tol)
    pairs = [(g_x, x_t.grad), (g_p["w"], proj_t["w"].grad),
             (g_p["b"], proj_t["b"].grad), (g_n["scale"], norm_t["scale"].grad),
             (g_n["bias"], norm_t["bias"].grad)]
    for ours, theirs in pairs:
        ours, theirs = np.asarray(ours, np.float64), theirs.numpy()
        rel = np.max(np.abs(ours - theirs)) / (np.max(np.abs(theirs)) + 1e-12)
        assert rel < (0.03 if bf16 else 2e-4), rel


def test_classifier_eval_is_the_composition_of_its_blocks():
    """classifier_apply (eval) == input block -> BiLSTM stack -> pool head
    -> MLP head, composed by hand."""
    from eegflow.core.config import ModelConfig
    from eegflow.nn.lstm import bilstm_stack_apply
    from eegflow.nn.model import classifier_apply, classifier_init

    cfg = ModelConfig(input_size=7, hidden_size=8, num_layers=2)
    params = classifier_init(jax.random.key(2), cfg)
    x = jnp.asarray(np.random.default_rng(2).standard_normal((3, 12, 7)),
                    jnp.float32)
    logits, attn = classifier_apply(params, x, cfg, return_attention=True)

    h = _input_block(params["input_proj"], params["input_norm"], x)
    h = bilstm_stack_apply(params["lstm"], h)
    ctx, w = _pool(params["lstm_norm"], params["attention"], h, True)
    z = gelu(dense_apply(params["head1"], ctx))
    z = gelu(dense_apply(params["head2"], z))
    np.testing.assert_allclose(np.asarray(logits),
                               np.asarray(dense_apply(params["head3"], z)),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(attn), np.asarray(w), atol=1e-7)
