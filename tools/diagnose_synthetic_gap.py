"""Diagnose the synthetic LSTM/trees gap (VERDICT r2 #4).

Round-2 evidence: on the 24-subject synthetic set the raw-waveform BiLSTM
reached AUC 0.8095 while every feature baseline hit 1.0000 — a ~30 pp gap on
a biomarker (posterior alpha power, 3x amplitude when eyes closed) that a
waveform model should capture nearly perfectly. The first-train-recording
normalization quirk (ref 02:300-311) keeps ABSOLUTE amplitude, so the
windows themselves are close to linearly separable in band power; the gap
must be optimization/regularization, not information.

This sweep holds the parity data fixed (24 subjects, 60 s, filtfilt — the
exact parity-runner artifacts) and varies ONLY the training recipe:

  base       parity hyperparameters untouched (TrainConfig defaults)
  lr1e-3     learning_rate 1e-3
  lr3e-3     learning_rate 3e-3
  long       patience 40 (rules out the early-stop trap)
  noaug      augment=False
  perwin     per-window per-channel z-score applied on top of the pipeline
             normalization (diagnostic only — NOT the parity semantics)
  lr1e-3+long

Each variant reports train/val/test AUC + MCC; train-set AUC separates
can't-fit (optimization) from can't-generalize (subject shift). Results are
appended to <out>/diagnosis.json after every variant so a watchdog kill
still leaves a usable record.

Usage: python tools/diagnose_synthetic_gap.py [--out /tmp/diag24]
       [--quick]  (4 subjects / 20 epochs, CI smoke)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

# runnable from anywhere: find eegflow at the root of this checkout
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def prepare_data(out: Path, n_subjects: int, duration_s: float):
    """Synthetic dataset -> parity preprocessing (filtfilt) -> artifacts."""
    from eegflow.core.artifacts import load_processed
    from eegflow.core.config import PipelineConfig
    from eegflow.data.bids import discover_recordings
    from eegflow.data.brainvision import read_brainvision
    from eegflow.data.synthetic import generate_synthetic_dataset
    from eegflow.signal.preprocess import process_recordings, split_subjects

    npz = out / "processed" / "processed_sequences.npz"
    if npz.exists():
        arrays, meta = load_processed(npz)
        cached_subjects = sum(
            len(s.get("subjects", [])) for s in meta.get("splits", {}).values())
        if cached_subjects == n_subjects:
            return {k: np.asarray(v) for k, v in arrays.items()}, meta
        # e.g. a --quick (4-subject) cache must not poison a 24-subject run
        print(f"cached artifacts have {cached_subjects} subjects, "
              f"need {n_subjects}: regenerating", flush=True)

    data_dir = out / "data"
    # require the LAST subject dir too: a smaller (--quick) dataset in the
    # same --out must not short-circuit a larger run
    if not (data_dir / f"sub-{n_subjects:02d}").exists():
        print(f"generating {n_subjects}-subject synthetic dataset...", flush=True)
        generate_synthetic_dataset(data_dir, n_subjects=n_subjects,
                                   duration_s=duration_s)

    cfg = PipelineConfig()
    pre = dataclasses.replace(cfg.preprocess, filter_method="filtfilt")
    recs = discover_recordings(data_dir, cfg.data.tasks, cfg.data.max_subjects)
    splits = split_subjects(recs, pre.train_frac, pre.val_frac, pre.seed)
    loaded = {s: [(r, read_brainvision(r["vhdr_path"])[0])
                  for r in splits.get(s, [])]
              for s in ("train", "val", "test")}
    t0 = time.perf_counter()
    arrays, meta = process_recordings(loaded, pre)
    print(f"preprocessed in {time.perf_counter() - t0:.0f}s: "
          + ", ".join(f"{s}={arrays[f'X_{s}'].shape}" for s in ("train", "val", "test")),
          flush=True)

    from eegflow.core.artifacts import save_processed
    save_processed(out / "processed", arrays, meta)
    return {k: np.asarray(v) for k, v in arrays.items()}, meta


def per_window_norm(x: np.ndarray) -> np.ndarray:
    m = x.mean(axis=1, keepdims=True)
    s = x.std(axis=1, keepdims=True)
    return (x - m) / np.maximum(s, 1e-8)


def auc_mcc(y_true, probs):
    from sklearn.metrics import matthews_corrcoef, roc_auc_score

    pred = (probs[:, 1] > 0.5).astype(int)
    return (float(roc_auc_score(y_true, probs[:, 1])),
            float(matthews_corrcoef(y_true, pred)))


def alpha_probe_oracle(xtr, ytr, xte, yte, fs: float = 500.0):
    """Logistic regression on log alpha-band power per channel, computed from
    the EXACT window tensors the LSTM consumes.

    This bounds the gap's cause: if a linear readout of one fixed spectral
    feature of the LSTM's own input separates the test subjects, the
    information is present and linearly decodable — the LSTM's shortfall is
    inductive (what SGD finds first), not informational.
    """
    from sklearn.linear_model import LogisticRegression
    from sklearn.metrics import roc_auc_score

    def feats(x):
        # x (N, T, C): alpha (8-13 Hz) log band power per channel via rFFT
        spec = np.abs(np.fft.rfft(x, axis=1)) ** 2
        freqs = np.fft.rfftfreq(x.shape[1], 1.0 / fs)
        band = (freqs >= 8.0) & (freqs <= 13.0)
        return np.log(spec[:, band, :].mean(axis=1) + 1e-12)

    clf = LogisticRegression(max_iter=2000)
    clf.fit(feats(xtr), ytr)
    p_tr = clf.predict_proba(feats(xtr))[:, 1]
    p_te = clf.predict_proba(feats(xte))[:, 1]
    return {
        "train_auc": round(float(roc_auc_score(ytr, p_tr)), 4),
        "test_auc": round(float(roc_auc_score(yte, p_te)), 4),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/diag24")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--variants", default=None,
                    help="comma list to restrict (e.g. base,perwin)")
    ap.add_argument("--oracle", action="store_true",
                    help="run the alpha-band linear-probe oracle only")
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    n_subjects = 4 if args.quick else 24
    epochs = 20 if args.quick else 100

    arrays, meta = prepare_data(out, n_subjects, 60.0)
    xtr, ytr = arrays["X_train"], arrays["y_train"]
    xva, yva = arrays["X_val"], arrays["y_val"]
    xte, yte = arrays["X_test"], arrays["y_test"]

    results_path = out / "diagnosis.json"
    if args.oracle:
        rec = alpha_probe_oracle(xtr, ytr, xte, yte,
                                 fs=float(meta["sampling_rate"]))
        results = (json.loads(results_path.read_text())
                   if results_path.exists() else {})
        results["oracle-alpha-probe"] = rec
        results_path.write_text(json.dumps(results, indent=2))
        print(f"[oracle-alpha-probe] {rec}", flush=True)
        return 0

    from eegflow.core.config import ModelConfig, TrainConfig
    from eegflow.train.data import augment_data
    from eegflow.train.loop import predict_probs, train_classifier

    model_cfg = ModelConfig(input_size=xtr.shape[2])
    base = TrainConfig(epochs=epochs)

    # cmd_train applies the reference's static 3x augmentation BEFORE the
    # loop (ref 04:290-312); replicate it so "base" IS the parity path
    aug_rng = np.random.default_rng(base.seed)
    xtr_aug, ytr_aug = augment_data(xtr, ytr, aug_rng,
                                    noise_std=base.noise_std,
                                    max_shift=base.max_shift)
    print(f"augmented train set: {xtr_aug.shape}", flush=True)

    variants = {
        # parity defaults (what `eegflow parity --synthetic` trains with)
        "base": {},
        # update-count hypothesis: accumulation x4 on ~22k windows leaves
        # ~10 optimizer updates/epoch vs the reference's real-data ~60+
        "accum1": {"accumulation_steps": 1},
        "lr1e-3": {"learning_rate": 1e-3},
        "lr3e-3": {"learning_rate": 3e-3},
        "long": {"patience": 40},
        # matched update COUNT at parity lr/accum: 4x the epochs+patience
        "updates-matched": {"epochs": epochs * 4, "patience": 60},
        "noaug": {"augment": False},
        "perwin": {},
        "lr1e-3+long": {"learning_rate": 1e-3, "patience": 40},
        # train AUC hit 1.0 in every first-pass variant — the gap is
        # subject generalization, not optimization. Second pass: the
        # regularizers that attack subject memorization directly.
        "mixreg": {"aug_mixup": True, "aug_channel_dropout": 0.1},
        "mixreg+long": {"aug_mixup": True, "aug_channel_dropout": 0.1,
                        "patience": 40},
        "wd1e-2": {"weight_decay": 1e-2},
        "perwin+mixreg": {"aug_mixup": True, "aug_channel_dropout": 0.1},
        # complete the lr sweep downward: both raises hurt, so test whether a
        # gentler descent finds the invariant feature before memorizing
        "lr1e-4+long": {"learning_rate": 1e-4, "patience": 40},
        # oracle-informed third pass: the alpha probe proves the amplitude
        # SPECTRUM of the exact input tensors separates test subjects at
        # AUC 1.0, so force the network onto spectral features with
        # spectrum-preserving augmentations (keys starting with "_" are
        # augment_data kwargs, not TrainConfig fields)
        "fullshift": {"_max_shift": 128, "patience": 40},
        "surrogate3": {"_phase_surrogates": 3, "patience": 40},
        "surrogate3+fullshift": {"_phase_surrogates": 3, "_max_shift": 128,
                                 "patience": 40},
        # per-epoch FRESH surrogate draws (device-side refresh): the network
        # can never memorize a fixed surrogate waveform
        "surrogate2-fresh": {"_phase_surrogates": 2, "_fresh": True,
                             "patience": 40},
    }
    if args.variants:
        keep = set(args.variants.split(","))
        variants = {k: v for k, v in variants.items() if k in keep}

    results_path = out / "diagnosis.json"
    results = (json.loads(results_path.read_text())
               if results_path.exists() else {})
    for name, overrides in variants.items():
        if name in results:
            print(f"[{name}] cached: {results[name]}", flush=True)
            continue
        aug_kw = {k[1:]: overrides.pop(k) for k in list(overrides)
                  if k.startswith("_")}
        fresh = aug_kw.pop("fresh", False)
        cfg = dataclasses.replace(base, **overrides)
        if cfg.aug_mixup or cfg.aug_channel_dropout > 0.0 or aug_kw:
            # mixup/channel-dropout/surrogates are extra augment_data copies
            # (like cmd_train applies them) — re-augment for this variant
            rng_v = np.random.default_rng(cfg.seed)
            x_aug_v, y_aug_v = augment_data(
                xtr, ytr, rng_v, noise_std=cfg.noise_std,
                max_shift=aug_kw.pop("max_shift", cfg.max_shift),
                mixup=cfg.aug_mixup,
                channel_dropout=cfg.aug_channel_dropout, **aug_kw)
        else:
            x_aug_v, y_aug_v = xtr_aug, ytr_aug
        if name.startswith("perwin"):
            xs = (per_window_norm(x_aug_v), per_window_norm(xva),
                  per_window_norm(xte))
            ys_tr = y_aug_v
        elif name == "noaug":
            xs, ys_tr = (xtr, xva, xte), ytr
        else:
            xs, ys_tr = (x_aug_v, xva, xte), y_aug_v
        epoch_transform = None
        if fresh:
            from eegflow.train.data import make_surrogate_refresher
            epoch_transform = make_surrogate_refresher(
                len(xtr), aug_kw["phase_surrogates"], cfg.seed)
        print(f"\n[{name}] training ({overrides or 'parity defaults'})...",
              flush=True)
        t0 = time.perf_counter()
        res = train_classifier(xs[0], ys_tr, xs[1], yva, model_cfg, cfg,
                               verbose=False, epoch_transform=epoch_transform)
        wall = time.perf_counter() - t0
        rec = {"epochs_run": res.epochs_run, "best_val_sel": res.best_val_f1,
               "train_wall_s": round(wall, 1),
               "windows_per_sec": round(res.windows_per_sec, 1)}
        x_tr_eval = per_window_norm(xtr) if name.startswith("perwin") else xtr
        for split, (xx, yy) in (("train", (x_tr_eval, ytr)),
                                ("val", (xs[1], yva)),
                                ("test", (xs[2], yte))):
            probs = np.asarray(predict_probs(res.params, xx, model_cfg))
            a, m = auc_mcc(yy, probs)
            rec[f"{split}_auc"], rec[f"{split}_mcc"] = round(a, 4), round(m, 4)
        results[name] = rec
        results_path.write_text(json.dumps(results, indent=2))
        print(f"[{name}] {rec}", flush=True)

    print("\n=== summary ===")
    for name, rec in results.items():
        if "val_auc" not in rec:  # e.g. the oracle record
            print(f"{name:14s} {rec}")
            continue
        print(f"{name:14s} train_auc={rec['train_auc']:.3f} "
              f"val_auc={rec['val_auc']:.3f} test_auc={rec['test_auc']:.3f} "
              f"test_mcc={rec['test_mcc']:.3f} epochs={rec['epochs_run']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
