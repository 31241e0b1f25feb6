"""BiLSTM vs EEGFormer: accuracy on the SAME 24-subject synthetic set.

VERDICT r4 weak #4: the EEGFormer family (eegflow/nn/transformer.py — the
productized version of the reference's dead-code MHA,
ref 04_lstm_model.py:73-109) shipped with unit/pipeline/sharding tests but
zero accuracy evidence vs the flagship BiLSTM. This job trains both families
on identical data, splits, augmentation, and budget (parity defaults) and
records test AUC/MCC side by side; its perf counterpart (device ms/step +
MFU at B=512) comes from the `transformer` config in tools/ab_configs_r5.json
via tools/profile_multi.py. Together they answer round-5 directive #3:
recommend the EEGFormer as the flagship, or demote it in ROADMAP.

Usage: python tools/model_compare.py [--out docs/accuracy/model_compare.json]
       [--data /tmp/diag24] [--quick]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "docs", "accuracy",
                                                  "model_compare.json"))
    ap.add_argument("--data", default="/tmp/diag24",
                    help="shared with tools/diagnose_synthetic_gap.py so the "
                         "24-subject artifacts are prepared once")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--platform", default=None,
                    help="jax platform override for CPU smoke runs")
    args = ap.parse_args()

    if args.quick and args.out.endswith("model_compare.json"):
        args.out = "/tmp/model_compare_quick.json"
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    from diagnose_synthetic_gap import auc_mcc, prepare_data

    from eegflow.core.config import ModelConfig, TrainConfig, TransformerConfig
    from eegflow.train.data import augment_data
    from eegflow.train.loop import predict_probs, train_classifier

    n_subjects = 4 if args.quick else 24
    epochs = 5 if args.quick else 100
    arrays, _meta = prepare_data(Path(args.data), n_subjects, 60.0)
    xtr, ytr = arrays["X_train"], arrays["y_train"]
    xva, yva = arrays["X_val"], arrays["y_val"]
    xte, yte = arrays["X_test"], arrays["y_test"]

    base = TrainConfig(epochs=epochs)
    # the reference's static 3x augmentation before the loop (ref 04:290-312)
    rng = np.random.default_rng(base.seed)
    xtr_aug, ytr_aug = augment_data(xtr, ytr, rng, noise_std=base.noise_std,
                                    max_shift=base.max_shift)

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = (json.loads(out_path.read_text()) if out_path.exists() else {})

    families = {
        "bilstm": ModelConfig(input_size=xtr.shape[2]),
        "eegformer": TransformerConfig(input_size=xtr.shape[2]),
    }
    for name, model_cfg in families.items():
        if name in results:
            print(f"[{name}] cached: {results[name]}", flush=True)
            continue
        cfg = base
        print(f"\n[{name}] training ({epochs} epochs, parity defaults)...",
              flush=True)
        t0 = time.perf_counter()
        res = train_classifier(xtr_aug, ytr_aug, xva, yva, model_cfg, cfg,
                               verbose=False)
        wall = time.perf_counter() - t0
        rec = {"epochs_run": res.epochs_run,
               "train_wall_s": round(wall, 1),
               "windows_per_sec": round(res.windows_per_sec, 1),
               "params_m": round(sum(
                   np.asarray(v).size
                   for v in __import__("jax").tree_util.tree_leaves(
                       res.params)) / 1e6, 3)}
        for split, (xx, yy) in (("train", (xtr, ytr)), ("val", (xva, yva)),
                                ("test", (xte, yte))):
            probs = np.asarray(predict_probs(res.params, xx, model_cfg))
            a, m = auc_mcc(yy, probs)
            rec[f"{split}_auc"], rec[f"{split}_mcc"] = round(a, 4), round(m, 4)
        results[name] = rec
        out_path.write_text(json.dumps(results, indent=1) + "\n")
        print(f"[{name}] {rec}", flush=True)

    print("\n=== model family comparison (same data/splits/budget) ===")
    for name, rec in results.items():
        print(f"{name:10s} test_auc={rec['test_auc']:.3f} "
              f"test_mcc={rec['test_mcc']:.3f} "
              f"epochs={rec['epochs_run']} wall={rec['train_wall_s']}s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
