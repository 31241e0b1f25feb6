"""Golden end-to-end pipeline test: the full CLI chain (synth -> explore ->
preprocess -> baselines -> train -> fit-ode -> integrate -> explain ->
forecast -> ablate -> export) on a small synthetic ds004148-shaped dataset,
checking every stage's artifact contract."""

import json
from pathlib import Path

import numpy as np
import pytest

from eegflow.cli.main import main
from eegflow.core.config import (
    CouplingConfig, DataConfig, ModelConfig, ODEConfig, PipelineConfig,
    PreprocessConfig, TrainConfig,
)


@pytest.fixture(scope="module")
def pipeline_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    data_dir = root / "data"
    out_dir = root / "outputs"
    cfg = PipelineConfig(
        data=DataConfig(dataset_dir=str(data_dir), max_subjects=None),
        preprocess=PreprocessConfig(filter_method="fft"),
        model=ModelConfig(input_size=8, hidden_size=16, num_layers=2, dropout=0.1),
        train=TrainConfig(epochs=3, batch_size=64, eval_batch_size=128,
                          accumulation_steps=1, learning_rate=3e-3,
                          warmup_epochs=1, patience=10, bf16=False),
        ode=ODEConfig(de_maxiter=60),
        coupling=CouplingConfig(),
    )
    cfg_path = root / "config.json"
    cfg.to_json(cfg_path)
    base = ["--data-dir", str(data_dir), "--output-dir", str(out_dir),
            "--config", str(cfg_path)]
    return base, data_dir, out_dir


def run(base, *cmd):
    assert main(base + list(cmd)) == 0


def test_stage_synth(pipeline_dirs):
    base, data_dir, _ = pipeline_dirs
    # 15 s/recording keeps >50 train windows (4 recs x ~57) while holding the
    # whole module's train/explain/ablate stages ~25% cheaper on 1 CPU core
    run(base, "synth", "--subjects", "4", "--duration", "15", "--channels", "8")
    assert len(list(data_dir.glob("sub-*/ses-*/eeg/*.vhdr"))) == 8


def test_stage_explore(pipeline_dirs, capsys):
    base, _, out = pipeline_dirs
    run(base, "explore")
    report = (out / "results" / "eda_report.md").read_text()
    assert "alpha" in report.lower()
    summary = json.loads((out / "results" / "eda_summary.json").read_text())
    assert summary["census"]["n_recordings"] == 8
    assert summary["alpha_ratio"] > 2.0  # biomarker visible in EDA


def test_stage_preprocess(pipeline_dirs):
    base, _, out = pipeline_dirs
    run(base, "preprocess")
    npz = np.load(out / "processed_data" / "processed_sequences.npz")
    assert npz["X_train"].shape[1:] == (256, 8)
    assert npz["X_train"].shape[0] > 50
    assert set(np.concatenate([npz["y_train"], npz["y_test"]])) == {0, 1}
    meta = json.loads((out / "processed_data" / "preprocessing_metadata.json").read_text())
    assert meta["filter"]["lowcut"] == 1.0
    assert (out / "figures" / "fig04_preprocessing.png").exists()
    assert len(meta["channel_names"]) == 8
    # subject-wise split: no subject overlap
    splits = meta["splits"]
    tr = set(splits["train"]["subjects"])
    te = set(splits["test"]["subjects"])
    assert tr and te and not (tr & te)


def test_stage_baselines(pipeline_dirs):
    base, _, out = pipeline_dirs
    run(base, "baselines")
    res = json.loads((out / "results" / "baseline_results.json").read_text())
    assert set(res) == {"svm", "random_forest", "gradient_boosting"}
    # synthetic alpha signal is separable: best baseline well above chance
    best = max(r["accuracy"] for r in res.values())
    assert best > 0.8
    assert (out / "figures" / "fig05_baselines.png").exists()
    assert (out / "models" / "baseline_models.pkl").exists()


def test_stage_train(pipeline_dirs):
    base, _, out = pipeline_dirs
    run(base, "train")
    assert (out / "models" / "lstm_attention" / "params.npz").exists()
    res = json.loads((out / "results" / "lstm_results.json").read_text())
    assert res["accuracy"] > 0.6  # 3 epochs on separable synthetic data
    ckpt = json.loads((out / "models" / "lstm_attention" / "checkpoint.json").read_text())
    assert ckpt["model_config"]["input_size"] == 8
    assert len(ckpt["history"]["val_f1"]) >= 1
    attn = np.load(out / "models" / "attention_weights.npy")
    assert attn.shape[1] == 256


def test_stage_fit_ode(pipeline_dirs):
    base, _, out = pipeline_dirs
    run(base, "fit-ode")
    res = json.loads((out / "results" / "ode_results.json").read_text())
    bounds = ODEConfig().bounds
    for i, name in enumerate(("k_ap", "k_af", "k_pa", "k_pf", "k_fa", "k_fp")):
        assert bounds[i][0] - 1e-9 <= res["fitted_params"][name] <= bounds[i][1] + 1e-9
    assert res["stability"]["is_stable"]
    assert abs(sum(res["steady_state"]) - 1) < 1e-4
    assert (out / "figures" / "fig11_state_diagram.png").exists()
    assert (out / "figures" / "fig12_sensitivity_heatmap.png").exists()


def test_stage_integrate(pipeline_dirs):
    base, _, out = pipeline_dirs
    run(base, "integrate")
    res = json.loads((out / "results" / "integration_results.json").read_text())
    assert res["evaluation"]["accuracy"] > 0.4
    sweep = json.loads((out / "results" / "coupling_analysis.json").read_text())
    assert set(sweep) == {"0.0", "0.25", "0.5", "0.75", "1.0"}
    zoo = json.loads((out / "results" / "all_model_results.json").read_text())
    assert "lstm_ode_integration" in zoo and "svm" in zoo
    assert (out / "figures" / "fig15_model_zoo.png").exists()


def test_stage_explain(pipeline_dirs):
    base, _, out = pipeline_dirs
    run(base, "explain", "--skip-shap")
    res = json.loads((out / "results" / "explainability_summary.json").read_text())
    assert len(res["gradient"]["importance"]) == 8
    assert res["ode_dynamics"]["balance"] > 0
    assert len(res["top_channels"]) == 8
    # reference-parity summary fields (ref 07_explainability.py:1207-1273)
    gb = res["channel_importance"]["gradient_based"]
    assert set(gb) >= {"top_3_channels", "occipital_importance",
                       "frontal_importance", "parietal_importance"}
    assert len(gb["top_3_channels"]) == 3
    assert {"primary_indicators", "temporal_pattern",
            "state_dynamics"} <= set(res["clinical_insights"])
    assert res["explainability_methods"] == ["gradient", "permutation"]
    assert res["attention_patterns"]["entropy"] >= 0
    assert (out / "figures" / "fig19_importance_comparison.png").exists()
    assert (out / "figures" / "fig18_attention_explainability.png").exists()
    assert (out / "figures" / "fig20_ode_explainability.png").exists()


def test_stage_forecast(pipeline_dirs):
    base, _, out = pipeline_dirs
    run(base, "forecast")
    res = json.loads((out / "results" / "forecasting_results.json").read_text())
    assert set(res["metrics"]) == {"5", "10", "20"}
    for m in res["metrics"].values():
        assert 0 <= m["accuracy"] <= 1 and m["mae"] >= 0


def test_stage_ablate(pipeline_dirs):
    base, _, out = pipeline_dirs
    # 1 epoch: this test checks the stage's artifact contract (6 configs,
    # stats, tables); learning quality is test_ablation.py's job
    run(base, "ablate", "--epochs", "1", "--hidden", "8")
    res = json.loads((out / "results" / "sensitivity_analysis.json").read_text())
    assert len(res["ablation"]) == 6
    assert "No Attention" in res["statistical_comparison"]
    assert res["coupling_sensitivity"] is not None  # reloaded from stage 06
    tables = (out / "results" / "results_tables.txt").read_text()
    assert "Architecture ablation" in tables and "McNemar" in tables


def test_stage_export(pipeline_dirs):
    base, _, out = pipeline_dirs
    run(base, "export")
    import pandas as pd

    df = pd.read_csv(out / "results" / "test_sample_probabilities.csv")
    assert {"Prob_EyesOpen", "Prob_Drowsy", "Prob_EyesClosed",
            "Predicted_State", "Ground_Truth"} <= set(df.columns)
    probs = df[["Prob_EyesOpen", "Prob_Drowsy", "Prob_EyesClosed"]].to_numpy()
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-4)
    pdf = pd.read_csv(out / "results" / "participant_probabilities.csv")
    assert len(pdf) == 5
    summary = json.loads((out / "results" / "three_state_summary.json").read_text())
    assert "test" in summary


def test_stage_train_transformer_family_and_downstream(pipeline_dirs):
    """`train --model transformer` (EEGFormer) through the SAME stage, then a
    downstream stage consumes the transformer checkpoint — the pipeline is
    model-family agnostic. Runs LAST in the module: it overwrites the LSTM
    checkpoint the earlier stages already consumed."""
    base, _, out = pipeline_dirs
    # 1 epoch: this checks the stage/checkpoint/downstream CONTRACT for the
    # second model family; learning quality is test_transformer.py's job
    run(base, "train", "--epochs", "1", "--model", "transformer")
    ckpt = json.loads(
        (out / "models" / "lstm_attention" / "checkpoint.json").read_text())
    assert ckpt["model_type"] == "TransformerConfig"
    res = json.loads((out / "results" / "lstm_results.json").read_text())
    assert 0.0 <= res["accuracy"] <= 1.0
    # coupled LSTM->ODE stage reloads the checkpoint by type tag and runs
    # the full integration path on the transformer's probabilities
    run(base, "integrate")
    ires = json.loads((out / "results" / "integration_results.json").read_text())
    assert 0.0 <= ires["evaluation"]["accuracy"] <= 1.0


def test_download_requires_confirmation(tmp_path, capsys):
    """download without -y refuses before touching the network (ref -y flag)."""
    rc = main(["--data-dir", str(tmp_path), "download"])
    assert rc == 1
    assert "Pass -y to confirm" in capsys.readouterr().out


def test_parity_runner_synthetic(tmp_path):
    """The parity runner works end-to-end in mocked (synthetic) mode and
    documents non-comparability; on real data the same command prints the
    ±0.5 pp verdict (blocked here only by the download's network need)."""
    data_dir = tmp_path / "data"
    out = tmp_path / "outputs"
    cfg = PipelineConfig(
        data=DataConfig(dataset_dir=str(data_dir), max_subjects=None),
        model=ModelConfig(input_size=8, hidden_size=16, num_layers=1, dropout=0.1),
        train=TrainConfig(epochs=2, batch_size=64, eval_batch_size=128,
                          accumulation_steps=1, learning_rate=3e-3,
                          warmup_epochs=1, patience=10, bf16=False),
        ode=ODEConfig(de_maxiter=30),
    )
    cfg_path = tmp_path / "config.json"
    cfg.to_json(cfg_path)
    rc = main(["--data-dir", str(data_dir), "--output-dir", str(out),
               "--config", str(cfg_path), "parity", "--synthetic",
               "--subjects", "4", "--duration", "15", "--channels", "8",
               "--epochs", "2"])
    assert rc == 0
    report = json.loads((out / "results" / "parity_report.json").read_text())
    assert report["comparable"] is False
    assert "NOT COMPARABLE" in report["verdict"]
    assert {"svm", "random_forest", "lstm_attention",
            "lstm_ode_integration"} <= set(report["models"])
    for entry in report["models"].values():
        assert "accuracy" in entry and "delta" in entry["accuracy"]
    # preprocessing really used the bit-faithful filter
    pc = json.loads((out / "parity_config.json").read_text())
    assert pc["preprocess"]["filter_method"] == "filtfilt"


def test_parity_requires_confirmation_without_data(tmp_path, capsys):
    rc = main(["--data-dir", str(tmp_path / "none"), "--output-dir",
               str(tmp_path / "out"), "parity"])
    assert rc == 1
    assert "-y" in capsys.readouterr().out


def test_parity_expect_reference_fails_loudly(tmp_path, capsys):
    """`parity --expect-reference` audits the full ds004148 manifest and
    fails listing exactly which artifacts are absent — the one-command
    ±0.5 pp gate for when egress exists (ref README.md:220-224)."""
    data_dir = tmp_path / "data"
    out = tmp_path / "out"
    # a partial tree: one real synthetic recording + one annex placeholder
    from eegflow.data.synthetic import generate_synthetic_dataset

    generate_synthetic_dataset(data_dir, n_subjects=1, duration_s=2.0,
                               n_channels=4)
    stub = (data_dir / "sub-02" / "ses-session1" / "eeg"
            / "sub-02_ses-session1_task-eyesopen_eeg.vhdr")
    stub.parent.mkdir(parents=True)
    stub.write_text("annex stub")  # <=200 B placeholder
    rc = main(["--data-dir", str(data_dir), "--output-dir", str(out),
               "parity", "--expect-reference"])
    assert rc == 2
    msg = capsys.readouterr().out
    assert "INCOMPLETE" in msg
    audit = json.loads((out / "results" / "parity_audit.json").read_text())
    assert audit["ok"] is False
    assert any("sub-03" in m for m in audit["missing"])  # names every absence
    assert any("placeholder" in m or "not BrainVision" in m
               for m in audit["missing"])
    assert any("sub-01/ses-session2" in m for m in audit["missing"])
    # sub-01 ses-session1 files are real -> not in the missing list
    assert not any(m.startswith("sub-01/ses-session1") for m in audit["missing"])
    assert audit["present"] > 0
    assert audit["expected"] == 30 * 3 * 2 * 3  # MAX_SUBJECTS x ses x task x ext


def test_parity_expect_reference_excludes_synthetic(tmp_path, capsys):
    rc = main(["--data-dir", str(tmp_path / "d"), "--output-dir",
               str(tmp_path / "o"), "parity", "--expect-reference",
               "--synthetic"])
    assert rc == 2
    assert "mutually exclusive" in capsys.readouterr().out


def test_reference_dataset_audit_complete_tree(tmp_path):
    """A tree satisfying the full manifest audits ok=True (what the real
    download produces; synthetic stand-ins here)."""
    from eegflow.analyze.parity import reference_dataset_audit
    from eegflow.data.synthetic import generate_synthetic_dataset

    generate_synthetic_dataset(tmp_path, n_subjects=2, n_sessions=3,
                               duration_s=2.0, n_channels=4)
    audit = reference_dataset_audit(tmp_path, n_subjects=2)
    assert audit["ok"], audit["missing"][:5]
    assert audit["present"] == audit["expected"] == 2 * 3 * 2 * 3


def test_apply_small_subject_reg_thresholds():
    """Auto-reg tiers (cli.main.apply_small_subject_reg): <12 subjects adds
    mixup + channel-dropout, <20 adds x2 fresh phase surrogates (measured
    winner of the round-5 gap_variants sweep: test AUC 0.9954 vs 0.8093
    baseline, docs/accuracy/gap_variants.json), >=20 and reference scale
    (ds004148, 42 training subjects) stay at parity semantics."""
    from eegflow.cli.main import apply_small_subject_reg
    from eegflow.core.config import TrainConfig

    base = TrainConfig()
    tiny = apply_small_subject_reg(base, 8)
    assert tiny.aug_mixup and tiny.aug_channel_dropout == 0.1
    assert tiny.aug_phase_surrogates == 2 and tiny.aug_fresh_surrogates

    small = apply_small_subject_reg(base, 17)
    assert not small.aug_mixup and small.aug_channel_dropout == 0.0
    assert small.aug_phase_surrogates == 2 and small.aug_fresh_surrogates

    ref_scale = apply_small_subject_reg(base, 42)
    assert ref_scale == base

    # unknown subject count: no change
    assert apply_small_subject_reg(base, None) == base

    # deliberate ablations opt out wholesale
    import dataclasses
    opted_out = dataclasses.replace(base, auto_small_subject_reg=False)
    assert apply_small_subject_reg(opted_out, 8) == opted_out

    # an explicit surrogate setting is never overridden
    explicit = dataclasses.replace(base, aug_phase_surrogates=3)
    assert apply_small_subject_reg(explicit, 17).aug_phase_surrogates == 3
