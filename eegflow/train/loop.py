"""Training loop: weighted sampling, bf16 jitted steps, F1 early stopping.

Mirrors ``train_model`` (ref 04_lstm_model.py:406-595) — same schedule, class
weights, accumulation semantics, early-stop-on-val-F1 with best-state restore,
and history dict — but each optimizer micro-step is one fused XLA program and
the batch can be sharded over a device mesh.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np

from eegflow.analyze.evaluate import f1_binary
from eegflow.core.config import ModelConfig, TrainConfig
from eegflow.nn.model import classifier_init
from eegflow.train.data import (
    class_weight_array,
    padded_eval_batches,
    weighted_epoch_indices,
)
from eegflow.train.mesh import replicate_to_mesh, shard_batch
from eegflow.train.steps import TrainState, make_eval_step, make_optimizer, make_train_step


@dataclass
class TrainResult:
    params: Any
    history: Dict[str, list]
    best_val_f1: float
    epochs_run: int
    wall_time_s: float
    windows_per_sec: float = 0.0


def predict_probs(
    params: Any,
    x: np.ndarray,
    model_cfg: ModelConfig,
    batch_size: int = 1024,
    bf16: bool = True,
    eval_step=None,
    lstm_impl: str = "auto",
    mesh=None,
    lazy: bool = False,
):
    """Batched inference -> (N, num_classes) probabilities.

    With ``mesh`` each padded batch is sharded over the mesh's data axis and
    the forward runs SPMD (params replicated) — per-sample results equal the
    single-device path's. With ``lazy`` the per-batch DEVICE arrays come back
    as ``[(device_probs, mask), ...]`` without forcing them to host — the
    caller can keep several calls in flight so host round-trip latency
    overlaps with compute (materialize via ``materialize_probs``).
    """
    step = eval_step or make_eval_step(model_cfg, bf16=bf16, lstm_impl=lstm_impl)
    if mesh is not None:
        from eegflow.train.mesh import replicate_to_mesh, shard_batch

        n_dev = int(np.prod(list(mesh.shape.values())))
        batch_size += (-batch_size) % n_dev
        params = replicate_to_mesh(params, mesh)
    out = []
    for xb, _, mask in padded_eval_batches(x, np.zeros(len(x), np.int64), batch_size):
        xb = jnp.asarray(xb)
        if mesh is not None:
            xb = shard_batch(xb, mesh)
        out.append((step(params, xb), mask))
    if lazy:
        return out
    return materialize_probs(out, model_cfg.num_classes)


def materialize_probs(lazy_out, num_classes: int) -> np.ndarray:
    """Force a ``predict_probs(..., lazy=True)`` result to a host array."""
    parts = [np.asarray(probs)[mask] for probs, mask in lazy_out]
    return (np.concatenate(parts, axis=0) if parts
            else np.empty((0, num_classes)))


def train_classifier(
    x_train: np.ndarray,
    y_train: np.ndarray,
    x_val: np.ndarray,
    y_val: np.ndarray,
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    mesh=None,
    verbose: bool = True,
    checkpoint_dir=None,
    checkpoint_every: int = 10,
    resume_from=None,
    epoch_transform=None,
) -> TrainResult:
    """Full training run; returns best params + history (ref 04:406-595).

    ``checkpoint_dir`` enables crash-recovery snapshots (best params + full
    optimizer state + history) every ``checkpoint_every`` epochs; pass that
    directory as ``resume_from`` to continue an interrupted run mid-training
    — finer granularity than the reference's whole-script resume. Epoch-level
    sampling is seeded per epoch, so a resumed run draws the same batches.

    ``epoch_transform`` — optional jitted ``(x_train, epoch) -> x_train``
    applied at the start of every epoch on the (HBM-resident) training
    array, e.g. ``make_surrogate_refresher`` regenerating phase-surrogate
    augmentation rows with fresh draws. Labels/row order must be preserved.
    """
    t_start = time.time()
    root_key = jax.random.key(train_cfg.seed)

    params = classifier_init(jax.random.fold_in(root_key, 0), model_cfg)

    batches_per_epoch = max(1, len(y_train) // train_cfg.batch_size)
    updates_per_epoch = max(1, batches_per_epoch // max(train_cfg.accumulation_steps, 1))
    tx = make_optimizer(train_cfg, updates_per_epoch)
    opt_state = tx.init(params)
    state = TrainState(params, opt_state, jnp.asarray(0))

    start_epoch = 0
    resume_payload = None
    if resume_from is not None:
        from pathlib import Path

        from eegflow.core.artifacts import load_checkpoint, load_pytree

        ckpt_best_params, _, resume_history, extra = load_checkpoint(resume_from)
        snap = Path(resume_from) / "train_state.npz"
        if snap.exists():
            restored = load_pytree(
                snap, {"params": params, "opt_state": opt_state})
            params, opt_state = restored["params"], restored["opt_state"]
            state = TrainState(params, opt_state,
                               jnp.asarray(int(extra.get("step", 0))))
            start_epoch = int(extra.get("epoch", 0))
            resume_payload = (resume_history, extra, ckpt_best_params)

    cw = class_weight_array(y_train, model_cfg.num_classes)
    step = make_train_step(model_cfg, train_cfg, tx, class_weights=cw,
                           mesh=mesh)
    eval_step = make_eval_step(model_cfg, bf16=train_cfg.bf16,
                               lstm_impl=train_cfg.lstm_impl)

    if mesh is not None:
        state = replicate_to_mesh(state, mesh)

    history: Dict[str, list] = {
        "train_loss": [], "val_loss": [], "train_acc": [], "val_acc": [],
        "val_f1": [], "learning_rates": [], "epoch_time_s": [],
    }
    from eegflow.train.schedule import lr_trace

    lrs = lr_trace(train_cfg.learning_rate, train_cfg.epochs, train_cfg.warmup_epochs)

    # -inf, not 0: MCC ranges to -1, and with a 0 floor a run whose val MCC
    # never exceeds 0 would return the untrained init weights after patience
    best_score = float("-inf")
    best_params = jax.tree_util.tree_map(lambda x: np.asarray(x), state.params)
    no_improve = 0
    epochs_run = 0
    total_windows = 0
    step_time = 0.0

    if resume_payload is not None:
        resume_history, extra, ckpt_best_params = resume_payload
        for k in history:
            history[k] = list(resume_history.get(k, []))[:start_epoch]
        # the stored best is only comparable if it was measured with the
        # same selection metric; on mismatch (or an old checkpoint without
        # the field) restart the comparison from -inf
        if extra.get("selection_metric") == train_cfg.selection_metric:
            best_score = float(extra.get("best_val_f1", float("-inf")))
        # the checkpoint stores the BEST params so far — restore them as the
        # early-stopping baseline (the train state holds the *current* params)
        best_params = jax.tree_util.tree_map(np.asarray, ckpt_best_params)
        epochs_run = start_epoch

    # Device-resident dataset (single-device path): the train/val arrays ship
    # to the device ONCE and every epoch's batches are device-side gathers —
    # the host loop sends only (batch,) int32 index arrays instead of
    # re-uploading ~1.4 GB/epoch for the augmented 24-subject set. The mesh
    # path keeps host batching (shard_batch needs the host array to lay out
    # per-device shards).
    x_train_dev = y_train_dev = None
    dataset_bytes = x_train.nbytes + x_val.nbytes
    if mesh is None and dataset_bytes < 8e9:
        x_train_dev = jnp.asarray(x_train)
        y_train_dev = jnp.asarray(y_train)
        x_val = jnp.asarray(x_val)
    if epoch_transform is not None and x_train_dev is None:
        # the device-side refresh assumes the HBM-resident path; falling back
        # to host batching would re-upload the whole set every epoch (the
        # exact cost the 8 GB guard above exists to avoid) — fail loudly
        raise ValueError(
            "epoch_transform requires the HBM-resident training path "
            "(mesh=None and train+val arrays < 8 GB); got "
            f"mesh={'set' if mesh is not None else 'None'}, "
            f"dataset_bytes={dataset_bytes:.2e}")

    for epoch in range(start_epoch, train_cfg.epochs):
        ep_start = time.time()
        if epoch_transform is not None:
            x_train_dev = epoch_transform(x_train_dev, jnp.asarray(epoch))
        # per-epoch seeded sampling: a resumed run draws the same batches
        rng = np.random.default_rng(train_cfg.seed * 1_000_003 + epoch)
        if train_cfg.weighted_sampling:
            indices = weighted_epoch_indices(y_train, rng)
        else:
            indices = rng.permutation(len(y_train))

        # metrics stay on device until epoch end: forcing float() per step
        # would sync the host every batch and kill dispatch pipelining
        batch_metrics = []
        ep_count = 0
        t_epoch_steps = time.time()
        bs = train_cfg.batch_size
        for b_idx in range(len(indices) // bs):
            sel = indices[b_idx * bs : (b_idx + 1) * bs]
            key = jax.random.fold_in(root_key, epoch * 100003 + b_idx + 1)
            if x_train_dev is not None:
                # HBM-resident training set: only the (batch,) index array
                # crosses the interconnect; the batch gather runs on device
                sel_j = jnp.asarray(sel)
                xb_j = jnp.take(x_train_dev, sel_j, axis=0)
                yb_j = jnp.take(y_train_dev, sel_j, axis=0)
            else:
                xb_j, yb_j = jnp.asarray(x_train[sel]), jnp.asarray(y_train[sel])
            if mesh is not None:
                xb_j, yb_j = shard_batch((xb_j, yb_j), mesh)
            state, metrics = step(state, xb_j, yb_j, key)
            batch_metrics.append((metrics, len(sel)))
            ep_count += len(sel)
            total_windows += len(sel)
        if batch_metrics:
            jax.block_until_ready(batch_metrics[-1][0]["loss"])
        step_time += time.time() - t_epoch_steps
        ep_loss = sum(float(m["loss"]) * n for m, n in batch_metrics)
        ep_correct = sum(int(m["correct"]) for m, n in batch_metrics)

        # validation (padded static-shape batches)
        val_probs = predict_probs(state.params, x_val, model_cfg,
                                  train_cfg.eval_batch_size, train_cfg.bf16,
                                  eval_step)
        val_pred = val_probs.argmax(axis=1)
        val_f1 = f1_binary(y_val, val_pred)
        val_acc = float((val_pred == y_val).mean()) if len(y_val) else 0.0
        eps = 1e-12
        val_loss = float(
            -np.log(np.clip(val_probs[np.arange(len(y_val)), y_val], eps, 1)).mean()
        ) if len(y_val) else 0.0

        epoch_time = time.time() - ep_start
        history["train_loss"].append(ep_loss / max(ep_count, 1))
        history["val_loss"].append(val_loss)
        history["train_acc"].append(ep_correct / max(ep_count, 1))
        history["val_acc"].append(val_acc)
        history["val_f1"].append(val_f1)
        history["learning_rates"].append(float(lrs[epoch]))
        history["epoch_time_s"].append(epoch_time)
        epochs_run = epoch + 1

        if verbose and ((epoch + 1) % 5 == 0 or epoch == 0
                        or epoch == train_cfg.warmup_epochs - 1):
            print(
                f"Epoch [{epoch+1:3d}/{train_cfg.epochs}] | "
                f"Loss: {history['train_loss'][-1]:.4f}/{val_loss:.4f} | "
                f"Acc: {history['train_acc'][-1]:.4f}/{val_acc:.4f} | "
                f"F1: {val_f1:.4f} | LR: {lrs[epoch]:.2e} | "
                f"Time: {epoch_time:.1f}s",
                flush=True,
            )

        if checkpoint_dir is not None and (epoch + 1) % checkpoint_every == 0:
            from pathlib import Path

            from eegflow.core.artifacts import save_checkpoint, save_pytree

            save_checkpoint(checkpoint_dir, best_params, model_cfg,
                            history=history,
                            extra={"epoch": epoch + 1, "best_val_f1": best_score,
                                   "selection_metric": train_cfg.selection_metric,
                                   "step": int(state.step),
                                   "resumable": True})
            save_pytree(Path(checkpoint_dir) / "train_state.npz",
                        {"params": state.params, "opt_state": state.opt_state})

        # early stopping on val F1 (ref 04:572-584); selection_metric="mcc"
        # monitors val MCC instead — F1 selection on balanced data can lock
        # onto an early all-positive epoch (F1 ~0.66 that nothing beats
        # within patience), which MCC scores at 0
        if train_cfg.selection_metric == "mcc":
            from eegflow.analyze.evaluate import matthews_corrcoef as _mcc

            val_sel = _mcc(y_val, val_pred) if len(y_val) else 0.0
        else:
            val_sel = val_f1
        if val_sel > best_score:
            best_score = val_sel
            best_params = jax.tree_util.tree_map(lambda x: np.asarray(x), state.params)
            no_improve = 0
        else:
            no_improve += 1
        if no_improve >= train_cfg.patience:
            if verbose and train_cfg.selection_metric != "f1":
                print(f"(model selection on val {train_cfg.selection_metric})",
                      flush=True)
            if verbose:
                print(f"Early stopping at epoch {epoch + 1} "
                      f"(no improvement for {train_cfg.patience} epochs)", flush=True)
            break

    wall = time.time() - t_start
    wps = total_windows / step_time if step_time > 0 else 0.0
    return TrainResult(
        params=best_params,
        history=history,
        best_val_f1=best_score if np.isfinite(best_score) else 0.0,
        epochs_run=epochs_run,
        wall_time_s=wall,
        windows_per_sec=wps,
    )
