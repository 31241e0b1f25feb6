"""Mesh-sharded inference/analysis paths == single-device results.

SURVEY §2.11/§5 commits the forecasting, coupling-sweep, permutation, and
batch-prediction hot paths to shard their sample axis over a data mesh; these
tests pin sharded-vs-single equality on the 8-virtual-device CPU mesh
(semantics of ref 06:308-406, 06:525-575, 07:287-361, 08:252-289).
"""

import jax
import numpy as np
import pytest

from eegflow.core.config import CouplingConfig, ModelConfig
from eegflow.couple.rollout import CoupledModel, predict_batch
from eegflow.couple.sweep import coupling_strength_sweep
from eegflow.nn.model import classifier_init
from eegflow.ode import rates_to_array
from eegflow.ode.field import DEFAULT_RATES


@pytest.fixture(scope="module")
def coupled_model():
    cfg = ModelConfig(input_size=5, hidden_size=8, num_layers=1, dropout=0.0)
    params = classifier_init(jax.random.key(0), cfg)
    return CoupledModel(params, cfg, rates_to_array(DEFAULT_RATES),
                        CouplingConfig())


def test_predict_batch_sharded_matches_single(coupled_model, rng, eight_device_mesh):
    x = rng.standard_normal((52, 16, 5)).astype(np.float32)  # not /8-divisible
    single = predict_batch(coupled_model, x)
    sharded = predict_batch(coupled_model, x, mesh=eight_device_mesh)
    assert set(single) == set(sharded)
    for k in single:
        np.testing.assert_allclose(sharded[k], single[k], atol=1e-5,
                                   err_msg=k)


def test_spmd_rollout_matches_single(coupled_model, rng, eight_device_mesh):
    """The explicit shard_map coupled rollout (ref 06:308-406 phase 2)
    equals the single-device/implicit results."""
    from eegflow.couple.rollout import make_spmd_rollout

    x = rng.standard_normal((52, 16, 5)).astype(np.float32)
    model = coupled_model
    single = predict_batch(model, x)
    roll = make_spmd_rollout(
        model.model_cfg, eight_device_mesh,
        forecast_steps=model.coupling.forecast_steps,
        alpha=model.coupling.coupling_strength,
        rate_floor=model.coupling.rate_floor,
        init_threshold=model.coupling.init_threshold,
        lstm_impl=model.lstm_impl)
    sharded = predict_batch(model, x, mesh=eight_device_mesh,
                            rollout_step=roll)
    assert set(single) == set(sharded)
    for k in single:
        np.testing.assert_allclose(sharded[k], single[k], atol=1e-5,
                                   err_msg=k)


def test_coupling_sweep_sharded_matches_single(coupled_model, rng, eight_device_mesh):
    x = rng.standard_normal((52, 16, 5)).astype(np.float32)
    y = rng.integers(0, 2, 52)
    single = coupling_strength_sweep(coupled_model, x, y, alphas=(0.0, 0.5))
    sharded = coupling_strength_sweep(coupled_model, x, y, alphas=(0.0, 0.5),
                                      mesh=eight_device_mesh)
    assert single.keys() == sharded.keys()
    for a in single:
        for m in ("accuracy", "f1", "mcc"):
            assert sharded[a][m] == pytest.approx(single[a][m], abs=1e-9)


def test_permutation_importance_sharded_matches_single(rng, eight_device_mesh):
    from eegflow.explain.permutation import permutation_channel_importance

    cfg = ModelConfig(input_size=4, hidden_size=8, num_layers=1, dropout=0.0)
    params = classifier_init(jax.random.key(1), cfg)
    x = rng.standard_normal((40, 12, 4)).astype(np.float32)
    y = rng.integers(0, 2, 40)
    kw = dict(n_permutations=2, n_samples=40, batch_size=40, seed=7)
    single = permutation_channel_importance(params, cfg, x, y, **kw)
    sharded = permutation_channel_importance(params, cfg, x, y, **kw,
                                             mesh=eight_device_mesh)
    assert sharded["baseline_accuracy"] == pytest.approx(
        single["baseline_accuracy"], abs=1e-9)
    np.testing.assert_allclose(sharded["importance"], single["importance"],
                               atol=1e-6)


def test_multistep_forecast_sharded_matches_single(rng, eight_device_mesh):
    from eegflow.analyze.forecast import multistep_forecast

    probs = rng.uniform(0.05, 0.95, 75)
    k = rates_to_array(DEFAULT_RATES)
    single = multistep_forecast(probs, k, horizons=(5, 10))
    sharded = multistep_forecast(probs, k, horizons=(5, 10),
                                 mesh=eight_device_mesh)
    for h in (5, 10):
        np.testing.assert_allclose(sharded[h]["predictions"],
                                   single[h]["predictions"], atol=1e-6)
        np.testing.assert_allclose(sharded[h]["actuals"],
                                   single[h]["actuals"], atol=0)


def test_spmd_eval_step_matches_single(coupled_model, rng, eight_device_mesh):
    """The explicit shard_map eval equals the single-device forward."""
    from eegflow.train.loop import predict_probs
    from eegflow.train.mesh import (make_spmd_eval_step, replicate_to_mesh,
                                    shard_batch)

    x = rng.standard_normal((16, 16, 5)).astype(np.float32)
    model = coupled_model
    single = np.asarray(predict_probs(model.params, x, model.model_cfg,
                                      batch_size=16))
    step = make_spmd_eval_step(model.model_cfg, eight_device_mesh)
    params = replicate_to_mesh(model.params, eight_device_mesh)
    xb = shard_batch(np.asarray(x), eight_device_mesh)
    sharded = np.asarray(step(params, xb))
    np.testing.assert_allclose(sharded, single, atol=1e-5)
    # and through predict_probs' eval_step hook
    via_hook = np.asarray(predict_probs(model.params, x, model.model_cfg,
                                        batch_size=16, eval_step=step,
                                        mesh=eight_device_mesh))
    np.testing.assert_allclose(via_hook, single, atol=1e-5)
