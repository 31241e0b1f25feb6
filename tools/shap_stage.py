"""Measure the explainability stage's end-to-end wall time on device.

The reference publishes ~54 min for its SHAP/explainability stage
(ref 07_explainability.py:1280,1339: "~52 minutes" banner + measured run);
This job runs the stage under the round-2 measurement conditions —
8-subject synthetic set (≈1.9k test windows), reference sample counts
(gradient 100, permutation 5×1000, KernelSHAP 200 explained × 100 background
× 100 coalitions) — times the full stage (gradient + permutation + KernelSHAP
+ method comparison + summary) on the host clock, and writes the record
with the device it ran on to ``--out``.

Usage: python tools/shap_stage.py [--out chiprun_out/shap_stage.json]
       [--work chiprun_out/shapstage] [--epochs 3] [--smoke]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "shap_stage.json"))
    ap.add_argument("--work", default=os.path.join(REPO, "chiprun_out",
                                                   "shapstage"))
    ap.add_argument("--epochs", type=int, default=3,
                    help="training epochs (explain cost is independent of "
                         "model quality; a real trained model keeps the "
                         "activations representative)")
    ap.add_argument("--platform", default=None,
                    help="jax platform override for CPU smoke runs")
    ap.add_argument("--smoke", action="store_true",
                    help="4 subjects + tiny explain counts: validates the "
                         "job end-to-end on CPU before it spends chip time")
    args = ap.parse_args()

    from diagnose_synthetic_gap import prepare_data

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from eegflow.core.config import ModelConfig, TrainConfig
    from eegflow.explain import (build_summary, compare_importance_methods,
                                 gradient_channel_importance,
                                 kernel_shap_channel_importance,
                                 permutation_channel_importance)
    from eegflow.train.loop import train_classifier

    work = Path(args.work)
    work.mkdir(parents=True, exist_ok=True)
    # round-2 measurement conditions: 8 subjects, 60 s recordings
    n_subjects = 4 if args.smoke else 8
    arrays, meta = prepare_data(work, n_subjects=n_subjects, duration_s=60.0)
    xtr, ytr = arrays["X_train"], arrays["y_train"]
    xva, yva = arrays["X_val"], arrays["y_val"]
    xte, yte = arrays["X_test"], arrays["y_test"]
    channel_names = (meta or {}).get("channel_names") or None

    model_cfg = ModelConfig(input_size=xtr.shape[2])
    cfg = TrainConfig(epochs=args.epochs, patience=args.epochs)
    print(f"training {args.epochs} epochs on {xtr.shape} "
          f"({jax.default_backend()})...", flush=True)
    res = train_classifier(xtr, ytr, xva, yva, model_cfg, cfg, verbose=False)
    params = res.params

    shap_kw = (dict(n_explain=4, n_background=4, nsamples=8) if args.smoke
               else {})
    perm_kw = dict(n_permutations=1, n_samples=32) if args.smoke else {}
    print(f"explain stage on {len(xte)} test windows...", flush=True)
    t0 = time.perf_counter()
    grad = gradient_channel_importance(params, model_cfg, xte,
                                       channel_names=channel_names)
    t1 = time.perf_counter()
    perm = permutation_channel_importance(params, model_cfg, xte, yte,
                                          channel_names=channel_names,
                                          **perm_kw)
    t2 = time.perf_counter()
    shap_res = kernel_shap_channel_importance(params, model_cfg, xte,
                                              channel_names=channel_names,
                                              **shap_kw)
    t3 = time.perf_counter()
    shap_light = {k: v for k, v in shap_res.items()
                  if k not in ("shap_values", "x_explain")}
    comparison = compare_importance_methods([grad, perm, shap_light])
    summary = build_summary(
        grad, perm, {k: v for k, v in comparison.items() if k != "merged"},
        shap=shap_light)
    t4 = time.perf_counter()

    try:
        commit = subprocess.run(
            ["git", "-C", REPO, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10).stdout.strip() or None
    except Exception:
        commit = None
    rec = {
        "explain_stage_s": round(t4 - t0, 1),
        "gradient_s": round(t1 - t0, 1),
        "permutation_s": round(t2 - t1, 1),
        "kernelshap_s": round(t3 - t2, 1),
        "comparison_summary_s": round(t4 - t3, 1),
        "n_test": int(len(xte)),
        "n_explain": shap_kw.get("n_explain", 200),
        "n_background": shap_kw.get("n_background", 100),
        "n_coalitions": shap_kw.get("nsamples", 100),
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind},
        "date": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "commit": commit,
        "reference_stage_s": 3240,
        "reference_citation": "ref 07_explainability.py:1280,1339 (~54 min)",
        "top_channels": summary["top_channels"],
    }
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rec, indent=1) + "\n")
    print(json.dumps(rec, indent=1), flush=True)
    print(f"stage total {rec['explain_stage_s']}s "
          f"(reference ~{rec['reference_stage_s']}s -> "
          f"{rec['reference_stage_s'] / max(rec['explain_stage_s'], 1e-9):.1f}x)",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
