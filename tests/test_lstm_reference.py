"""The lax.scan LSTM against torch ``nn.LSTM`` and its autograd.

The scan layer is the only LSTM implementation, so it is checked directly
against the reference's own cuDNN-backed module (ref 04_lstm_model.py:181-188)
over the shapes that matter: odd batches, the reverse direction, the
3-layer bidirectional stack, larger batches; the bf16 policy at its stated
tolerance; and dropout's rate, determinism and placement.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eegflow.nn.layers import dropout
from eegflow.nn.lstm import (bilstm_stack_apply, bilstm_stack_init,
                             lstm_layer_apply, lstm_layer_init)

torch = pytest.importorskip("torch")

# (batch, time, input, hidden, layers, bidirectional)
CASES = [
    (8, 32, 12, 16, 1, False),
    (5, 24, 8, 8, 1, False),      # odd batch
    (7, 8, 4, 8, 1, False),       # odd batch, short sequence
    (4, 16, 8, 8, 1, True),       # forward + reverse direction
    (4, 16, 6, 8, 2, True),
    (2, 16, 6, 8, 3, True),       # the flagship's stack: 3 bidirectional layers
    (96, 8, 4, 8, 1, False),      # batch between power-of-two tiles
    (3, 12, 5, 16, 2, False),     # unidirectional stack
]
IDS = [f"b{b}_t{t}_d{d}_h{h}_l{n}_{'bi' if bi else 'uni'}"
       for b, t, d, h, n, bi in CASES]


def _torch_lstm(stack, d, h, n_layers, bidirectional):
    """A torch.nn.LSTM carrying the stack's weights (b_hh = 0, since the
    scan layer keeps the fused bias b = b_ih + b_hh)."""
    tl = torch.nn.LSTM(d, h, num_layers=n_layers, batch_first=True,
                       bidirectional=bidirectional, dropout=0.0)
    for layer, p in enumerate(stack):
        for direction, name in enumerate(("fwd", "bwd")):
            if name not in p:
                continue
            sfx = f"l{layer}" + ("_reverse" if direction else "")
            getattr(tl, f"weight_ih_{sfx}").data = torch.tensor(
                np.asarray(p[name]["w_ih"]).T.copy())
            getattr(tl, f"weight_hh_{sfx}").data = torch.tensor(
                np.asarray(p[name]["w_hh"]).T.copy())
            getattr(tl, f"bias_ih_{sfx}").data = torch.tensor(
                np.asarray(p[name]["b"]).copy())
            getattr(tl, f"bias_hh_{sfx}").data = torch.zeros(4 * h)
    return tl


def _setup(case, seed=0):
    b, t, d, h, n_layers, bi = case
    stack = bilstm_stack_init(jax.random.key(seed), d, h, n_layers, bi)
    x = np.random.default_rng(seed).standard_normal((b, t, d)).astype(np.float32)
    return stack, x, _torch_lstm(stack, d, h, n_layers, bi)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_stack_forward_matches_torch(case):
    stack, x, tl = _setup(case)
    ours = np.asarray(bilstm_stack_apply(stack, jnp.asarray(x)))
    with torch.no_grad():
        ref, _ = tl(torch.tensor(x))
    np.testing.assert_allclose(ours, ref.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_stack_grads_match_torch_autograd(case):
    """d/dx and d/d(every weight) of sum(tanh(out)) against torch autograd."""
    stack, x, tl = _setup(case, seed=1)

    def loss(s, xx):
        return jnp.sum(jnp.tanh(bilstm_stack_apply(s, xx)))

    g_stack, g_x = jax.grad(loss, argnums=(0, 1))(stack, jnp.asarray(x))

    xt = torch.tensor(x, requires_grad=True)
    out, _ = tl(xt)
    torch.tanh(out).sum().backward()
    np.testing.assert_allclose(np.asarray(g_x), xt.grad.numpy(),
                               atol=1e-5, rtol=1e-4)
    for layer, p in enumerate(g_stack):
        for direction, name in enumerate(("fwd", "bwd")):
            if name not in p:
                continue
            sfx = f"l{layer}" + ("_reverse" if direction else "")
            for ours, theirs in (
                    (p[name]["w_ih"].T, getattr(tl, f"weight_ih_{sfx}").grad),
                    (p[name]["w_hh"].T, getattr(tl, f"weight_hh_{sfx}").grad),
                    (p[name]["b"], getattr(tl, f"bias_ih_{sfx}").grad)):
                np.testing.assert_allclose(np.asarray(ours), theirs.numpy(),
                                           atol=2e-5, rtol=1e-4)


# bf16 policy: matmul inputs rounded to bf16 (8 bits of mantissa), f32
# accumulation and f32 state. Over these short sequences the hidden states
# stay within 0.05 of f32 and correlate above 0.999; gradients within 3 %
# of their largest entry.
BF16_CASES = [(4, 64, 16, 32), (7, 32, 8, 16)]


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("b,t,d,h", BF16_CASES)
def test_bf16_policy_forward_within_tolerance(b, t, d, h, reverse):
    params = lstm_layer_init(jax.random.key(3), d, h)
    x = jnp.asarray(np.random.default_rng(3).standard_normal((b, t, d)),
                    jnp.float32)
    f32 = np.asarray(lstm_layer_apply(params, x, reverse=reverse))
    bf16 = np.asarray(lstm_layer_apply(params, x, reverse=reverse,
                                       compute_dtype=jnp.bfloat16))
    assert bf16.dtype == np.float32          # state stays f32
    assert np.max(np.abs(f32 - bf16)) < 0.05
    assert np.corrcoef(f32.ravel(), bf16.ravel())[0, 1] > 0.999


@pytest.mark.parametrize("b,t,d,h", BF16_CASES)
def test_bf16_policy_grads_within_tolerance(b, t, d, h):
    stack = bilstm_stack_init(jax.random.key(4), d, h, 2, True)
    x = jnp.asarray(np.random.default_rng(4).standard_normal((b, t, d)),
                    jnp.float32)

    def loss(s, dtype):
        return jnp.sum(jnp.tanh(bilstm_stack_apply(s, x, compute_dtype=dtype)))

    g32 = jax.grad(loss)(stack, None)
    g16 = jax.grad(loss)(stack, jnp.bfloat16)
    for a, ref in zip(jax.tree.leaves(g16), jax.tree.leaves(g32)):
        a, ref = np.asarray(a), np.asarray(ref)
        assert np.max(np.abs(a - ref)) / (np.max(np.abs(ref)) + 1e-8) < 0.03


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
def test_dropout_rate_and_scaling(rate):
    """Kept share within 1 % of 1 - rate; kept values scaled by 1/keep."""
    x = jnp.ones((400, 250))
    out = np.asarray(dropout(x, rate, jax.random.key(5), True))
    kept = out != 0.0
    assert abs(kept.mean() - (1.0 - rate)) < 0.01
    np.testing.assert_allclose(out[kept], 1.0 / (1.0 - rate), rtol=1e-6)


def test_dropout_deterministic_per_key_and_off_in_eval():
    x = jnp.asarray(np.random.default_rng(6).standard_normal((64, 32)),
                    jnp.float32)
    a = dropout(x, 0.4, jax.random.key(1), True)
    b = dropout(x, 0.4, jax.random.key(1), True)
    c = dropout(x, 0.4, jax.random.key(2), True)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert not np.array_equal(np.asarray(a), np.asarray(c))
    np.testing.assert_array_equal(np.asarray(dropout(x, 0.4, None, True)), x)
    np.testing.assert_array_equal(
        np.asarray(dropout(x, 0.4, jax.random.key(1), False)), x)


def test_stack_dropout_placement_matches_manual_composition():
    """Train-mode stack == input dropout, then each layer, then inter-layer
    dropout on every output but the last (torch nn.LSTM's placement), with
    the stack's documented key derivation."""
    stack = bilstm_stack_init(jax.random.key(7), 6, 8, 3, True)
    x = jnp.asarray(np.random.default_rng(7).standard_normal((4, 16, 6)),
                    jnp.float32)
    key, in_key = jax.random.key(8), jax.random.key(9)
    got = bilstm_stack_apply(stack, x, inter_dropout=0.3, train=True,
                             dropout_key=key, input_dropout=0.2,
                             input_dropout_key=in_key)
    h = dropout(x, 0.2, in_key, True)
    for i, layer in enumerate(stack):
        h = jnp.concatenate([lstm_layer_apply(layer["fwd"], h),
                             lstm_layer_apply(layer["bwd"], h, reverse=True)],
                            axis=-1)
        if i < len(stack) - 1:
            h = dropout(h, 0.3, jax.random.fold_in(key, i), True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(h))


def test_stack_input_dropout_zeroes_input_gradient():
    stack = bilstm_stack_init(jax.random.key(10), 12, 8, 2, True)
    x = jnp.asarray(np.random.default_rng(10).standard_normal((8, 16, 12)),
                    jnp.float32)
    in_key = jax.random.key(11)

    def loss(xx):
        return jnp.sum(bilstm_stack_apply(
            stack, xx, inter_dropout=0.3, train=True,
            dropout_key=jax.random.key(12), input_dropout=0.25,
            input_dropout_key=in_key) ** 2)

    g = np.asarray(jax.grad(loss)(x))
    dropped = np.asarray(dropout(jnp.ones(x.shape), 0.25, in_key, True)) == 0
    assert dropped.any() and np.all(g[dropped] == 0.0)
    assert np.all(np.isfinite(g)) and np.any(g[~dropped] != 0.0)


def test_stack_eval_ignores_dropout_rates():
    stack = bilstm_stack_init(jax.random.key(13), 5, 8, 2, True)
    x = jnp.asarray(np.random.default_rng(13).standard_normal((3, 10, 5)),
                    jnp.float32)
    plain = bilstm_stack_apply(stack, x)
    ev = bilstm_stack_apply(stack, x, inter_dropout=0.5, train=False,
                            dropout_key=jax.random.key(1), input_dropout=0.5,
                            input_dropout_key=jax.random.key(2))
    np.testing.assert_array_equal(np.asarray(plain), np.asarray(ev))
