"""Core-module tests: config tree round-trip, artifact store contracts,
PRNG streams, timing registry."""

import json

import jax
import numpy as np
import pytest

from eegflow.core.artifacts import (
    load_checkpoint,
    load_processed,
    save_checkpoint,
    save_processed,
    save_results,
    load_results,
)
from eegflow.core.config import ModelConfig, ODEConfig, PipelineConfig, TrainConfig
from eegflow.core.prng import KeyRing, key_chain, seed_everything
from eegflow.core.timing import Timer, timed


def test_config_roundtrip_json(tmp_path):
    cfg = PipelineConfig(
        model=ModelConfig(input_size=32, hidden_size=64),
        train=TrainConfig(epochs=7, lstm_impl="scan"),
        ode=ODEConfig(de_maxiter=5),
    )
    path = tmp_path / "cfg.json"
    cfg.to_json(path)
    restored = PipelineConfig.from_json(path)
    assert restored == cfg
    assert restored.ode.bounds == cfg.ode.bounds  # tuples survive round-trip
    assert restored.model.resolved_hidden() == 64


def test_config_defaults_match_reference():
    cfg = PipelineConfig()
    assert cfg.preprocess.sequence_length == 256
    assert cfg.preprocess.overlap == 0.5
    assert cfg.preprocess.lowcut == 1.0 and cfg.preprocess.highcut == 45.0
    assert cfg.train.batch_size == 512 and cfg.train.accumulation_steps == 4
    assert cfg.train.patience == 15 and cfg.train.warmup_epochs == 5
    assert cfg.ode.rates()["k_ap"] == 0.1
    assert cfg.coupling.coupling_strength == 0.5


def test_processed_archive_roundtrip(tmp_path, rng):
    arrays = {
        "X_train": rng.standard_normal((10, 16, 4)).astype(np.float32),
        "y_train": rng.integers(0, 2, 10),
    }
    meta = {"sampling_rate": 500.0, "note": np.float64(1.5)}
    npz = save_processed(tmp_path, arrays, meta)
    loaded, meta2 = load_processed(npz)
    np.testing.assert_array_equal(loaded["X_train"], arrays["X_train"])
    assert meta2["sampling_rate"] == 500.0
    assert isinstance(meta2["note"], float)  # numpy scalars JSON-ified


def test_checkpoint_roundtrip_nested_pytree(tmp_path):
    from eegflow.nn.model import classifier_init

    cfg = ModelConfig(input_size=4, hidden_size=8, num_layers=2)
    params = classifier_init(jax.random.key(0), cfg)
    save_checkpoint(tmp_path / "ckpt", params, cfg,
                    history={"val_f1": [0.5, 0.6]}, extra={"note": "x"})
    params2, cfg2, history, extra = load_checkpoint(tmp_path / "ckpt")
    assert cfg2 == cfg
    assert history["val_f1"] == [0.5, 0.6]
    assert extra["note"] == "x"
    # structure restored: lstm is a list of per-layer dicts
    assert isinstance(params2["lstm"], list) and len(params2["lstm"]) == 2
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(params2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_results_json(tmp_path):
    res = {"acc": np.float32(0.5), "cm": np.array([[1, 2], [3, 4]])}
    p = save_results(tmp_path / "r.json", res)
    loaded = load_results(p)
    assert loaded["acc"] == 0.5 and loaded["cm"] == [[1, 2], [3, 4]]


def test_prng_streams_deterministic():
    root = seed_everything(42)
    ring1 = KeyRing(root)
    ring2 = KeyRing(root)
    a1, a2 = ring1("dropout"), ring1("dropout")
    b1 = ring2("dropout")
    assert jax.random.bits(a1) == jax.random.bits(b1)  # same stream, same seq
    assert jax.random.bits(a1) != jax.random.bits(a2)  # advances within stream
    chain = key_chain(root)
    k1, k2 = next(chain), next(chain)
    assert jax.random.bits(k1) != jax.random.bits(k2)


def test_timer_registry():
    timer = Timer()

    @timed("work", timer)
    def work():
        return 1

    work()
    work()
    s = timer.summary()["work"]
    assert s["count"] == 2 and s["total_s"] >= 0


def test_train_periodic_checkpoint(tmp_path, rng):
    from eegflow.core.config import TrainConfig
    from eegflow.train import train_classifier

    cfg_m = ModelConfig(input_size=3, hidden_size=8, num_layers=1, dropout=0.0)
    cfg_t = TrainConfig(epochs=4, batch_size=16, eval_batch_size=32,
                        accumulation_steps=1, warmup_epochs=1, patience=10,
                        bf16=False, augment=False)
    x = rng.standard_normal((64, 16, 3)).astype(np.float32)
    y = rng.integers(0, 2, 64)
    res = train_classifier(x[:48], y[:48], x[48:], y[48:], cfg_m, cfg_t,
                           verbose=False, checkpoint_dir=tmp_path / "snap",
                           checkpoint_every=2)
    params2, _, hist, extra = load_checkpoint(tmp_path / "snap")
    assert extra["resumable"] is True
    assert extra["epoch"] in (2, 4)


def test_train_resume_matches_uninterrupted(tmp_path, rng):
    """Interrupt at epoch 2 of 4, resume, and match the uninterrupted run."""
    import dataclasses

    from eegflow.core.config import TrainConfig
    from eegflow.train import train_classifier

    cfg_m = ModelConfig(input_size=3, hidden_size=8, num_layers=1, dropout=0.0)
    base = TrainConfig(epochs=4, batch_size=16, eval_batch_size=32,
                       accumulation_steps=1, warmup_epochs=1, patience=10,
                       bf16=False, augment=False)
    x = rng.standard_normal((96, 16, 3)).astype(np.float32)
    y = (x[:, :, 0].mean(1) > 0).astype(np.int64)
    args = (x[:48], y[:48], x[48:], y[48:], cfg_m)

    full = train_classifier(*args, base, verbose=False)

    half_cfg = dataclasses.replace(base, epochs=2)
    train_classifier(*args, half_cfg, verbose=False,
                     checkpoint_dir=tmp_path / "snap", checkpoint_every=2)
    resumed = train_classifier(*args, base, verbose=False,
                               resume_from=tmp_path / "snap")

    assert resumed.epochs_run == 4
    assert len(resumed.history["val_f1"]) == 4
    np.testing.assert_allclose(resumed.history["val_f1"],
                               full.history["val_f1"], atol=1e-5)
    np.testing.assert_allclose(resumed.history["train_loss"],
                               full.history["train_loss"], atol=1e-4)


def test_metrics_registry():
    from eegflow.core.registry import available_metrics, compute_metrics, get_metric

    y_true = np.array([0, 1, 1, 0, 1])
    y_pred = np.array([0, 1, 0, 0, 1])
    y_prob = np.array([0.1, 0.9, 0.4, 0.2, 0.8])
    out = compute_metrics(["accuracy", "f1", "auc", "mcc"], y_true, y_pred, y_prob)
    assert out["accuracy"] == 0.8
    assert 0 < out["f1"] <= 1 and 0 <= out["auc"] <= 1
    assert "precision" in available_metrics()
    import pytest as _pytest
    with _pytest.raises(KeyError):
        get_metric("nope")


def test_restore_lists_only_converts_exact_ranges():
    from eegflow.core.artifacts import _restore_lists

    # exact {"0".."n-1"} -> list
    assert _restore_lists({"0": 1, "1": 2, "2": 3}) == [1, 2, 3]
    # sparse digit keys stay a dict (used to raise KeyError)
    assert _restore_lists({"0": 1, "2": 3}) == {"0": 1, "2": 3}
    # non-zero-based digit keys stay a dict (used to be silently converted)
    assert _restore_lists({"1": "a", "2": "b"}) == {"1": "a", "2": "b"}
    # nested inside history-like payloads
    out = _restore_lists({"hist": {"0": 1.0, "1": 2.0}, "epochs": {"3": "x"}})
    assert out == {"hist": [1.0, 2.0], "epochs": {"3": "x"}}


def test_compile_cache_honours_the_environment_variable(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX keeps using it: the helper
    sets no other directory."""
    from eegflow.core.compile_cache import enable_compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env_cache"))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == str(tmp_path / "env_cache")
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_the_checkouts_fixed_path(monkeypatch):
    from pathlib import Path

    from eegflow.core.compile_cache import REPO_CACHE_DIR, enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        first = enable_compile_cache()
        assert first == enable_compile_cache()          # same path every call
        assert jax.config.jax_compilation_cache_dir == first
        repo = Path(__file__).resolve().parents[1]
        assert Path(first) == REPO_CACHE_DIR == repo / ".jax_cache"
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_directory_is_git_ignored():
    from pathlib import Path

    ignore = (Path(__file__).resolve().parents[1] / ".gitignore").read_text()
    assert "/.jax_cache/" in ignore.split()


def _family(name):
    from eegflow.core.config import TransformerConfig

    if name == "lstm":
        return ModelConfig(input_size=4, hidden_size=8, num_layers=2)
    return TransformerConfig(input_size=4, d_model=8, num_layers=1,
                             num_heads=2, mlp_ratio=2)


@pytest.mark.parametrize("family", ["lstm", "transformer"])
def test_npz_checkpoint_roundtrip_both_families(tmp_path, family):
    """params.npz + checkpoint.json; without a template the init-time
    structure (nested dicts, lists of layers) comes back exactly."""
    from eegflow.nn.model import classifier_apply, classifier_init

    cfg = _family(family)
    params = classifier_init(jax.random.key(3), cfg)
    save_checkpoint(tmp_path / "ck", params, cfg, history={"loss": [1.0]})
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "checkpoint.json", "params.npz"]
    params2, cfg2, history, _ = load_checkpoint(tmp_path / "ck")
    assert type(cfg2) is type(cfg) and cfg2 == cfg and history["loss"] == [1.0]
    assert (jax.tree_util.tree_structure(params2)
            == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(params2)):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)
    x = np.random.default_rng(0).standard_normal((2, 6, 4)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(classifier_apply(params, x, cfg)),
                                  np.asarray(classifier_apply(params2, x, cfg2)))


@pytest.mark.parametrize("family", ["lstm", "transformer"])
def test_npz_checkpoint_restores_into_a_template(tmp_path, family):
    from eegflow.nn.model import classifier_init

    cfg = _family(family)
    params = classifier_init(jax.random.key(4), cfg)
    save_checkpoint(tmp_path / "ck", params, cfg)
    template = classifier_init(jax.random.key(99), cfg)
    restored, *_ = load_checkpoint(tmp_path / "ck", params_template=template)
    assert (jax.tree_util.tree_structure(restored)
            == jax.tree_util.tree_structure(template))
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_pytree_npz_roundtrip_of_a_train_state(tmp_path):
    """Optimizer states (tuples of NamedTuples, scalar counters, empty
    states) survive save_pytree/load_pytree into a template."""
    import jax.numpy as jnp

    from eegflow.core.artifacts import load_pytree, save_pytree
    from eegflow.nn.model import classifier_init
    from eegflow.train.steps import make_optimizer

    cfg = ModelConfig(input_size=3, hidden_size=8, num_layers=1)
    params = classifier_init(jax.random.key(5), cfg)
    tx = make_optimizer(TrainConfig(accumulation_steps=4), updates_per_epoch=3)
    opt_state = tx.init(params)
    grads = jax.tree_util.tree_map(jnp.ones_like, params)
    _, opt_state = tx.update(grads, opt_state, params)
    tree = {"params": params, "opt_state": opt_state}
    save_pytree(tmp_path / "state.npz", tree)
    template = {"params": params, "opt_state": tx.init(params)}
    restored = load_pytree(tmp_path / "state.npz", template)
    assert (jax.tree_util.tree_structure(restored)
            == jax.tree_util.tree_structure(tree))
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("entry", ["classifier_apply", "make_train_step",
                                   "make_eval_step", "coupled_rollout"])
def test_removed_pallas_impl_raises_at_every_entry_point(entry):
    """lstm_impl='pallas' named a removed kernel: every entry point that
    takes it raises instead of falling back."""
    import jax.numpy as jnp

    from eegflow.nn.model import classifier_apply, classifier_init
    from eegflow.train.steps import make_eval_step, make_optimizer, make_train_step

    cfg = ModelConfig(input_size=3, hidden_size=8, num_layers=1)
    params = classifier_init(jax.random.key(6), cfg)
    x = jnp.ones((2, 5, 3))
    with pytest.raises(ValueError, match="removed"):
        if entry == "classifier_apply":
            classifier_apply(params, x, cfg, lstm_impl="pallas")
        elif entry == "make_train_step":
            tc = TrainConfig(batch_size=2, accumulation_steps=1,
                             lstm_impl="pallas")
            tx = make_optimizer(tc, 1)
            from eegflow.train.steps import TrainState

            step = make_train_step(cfg, tc, tx, donate=False)
            step(TrainState(params, tx.init(params), jnp.asarray(0)), x,
                 jnp.asarray([0, 1]), jax.random.key(0))
        elif entry == "make_eval_step":
            make_eval_step(cfg, lstm_impl="pallas")(params, x)
        else:
            from eegflow.couple.rollout import coupled_rollout
            from eegflow.ode import rates_to_array
            from eegflow.ode.field import DEFAULT_RATES

            coupled_rollout(params, x, rates_to_array(DEFAULT_RATES), cfg,
                            lstm_impl="pallas")
