"""Headline benchmark: flagship training throughput on one GPU.

Measures, at the flagship's full width (61-channel 256-sample windows,
hidden 256, 3 bidirectional LSTM layers + attention, bf16 matmuls):

* the fused training step (forward, weighted CE, backward, clip, AdamW) at
  the reference's train batch 512 (ref 04_lstm_model.py:866);
* the coupled LSTM->ODE inference at batch 512 (ref 06:308-406);
* the eval forward at the reference eval batch 1024, KernelSHAP's unit of
  work (ref 07:420-447).

Times are host-clock seconds around ``block_until_ready``; compile time is
reported apart from the steady time. MFU is model FLOPs (fwd+bwd ~= 3x the
forward matmul FLOPs) over the published bf16 peak of the device kind
(:data:`eegflow.core.profiling.PEAKS`); a device kind missing from that
table is an error. Without a GPU the benchmark exits non-zero and prints no
result.

Prints ONE JSON line:
  {"metric": "windows_per_sec_per_gpu", "value": N, "unit": "windows/s",
   "mfu": M, "device": {"platform", "kind", "count"}, "card": "<name, power
   limit>", "extras": {...}}

Usage: python bench.py [--steps N]
"""

import argparse
import json
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10,
                    help="steady-state calls timed per workload")
    args = ap.parse_args(argv)

    from eegflow.core.profiling import card_info

    card = card_info()  # before JAX opens the card

    import jax
    import jax.numpy as jnp

    from eegflow.core.compile_cache import enable_compile_cache
    from eegflow.core.config import ModelConfig, TrainConfig
    from eegflow.core.profiling import mfu, peak_for, time_calls
    from eegflow.couple.rollout import coupled_rollout
    from eegflow.nn.model import classifier_init, model_flops_per_window
    from eegflow.ode import rates_to_array
    from eegflow.ode.field import DEFAULT_RATES
    from eegflow.train.steps import (TrainState, make_eval_step,
                                     make_optimizer, make_train_step)

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py measures a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    if card is None:
        print("nvidia-smi gave no card name and power limit", file=sys.stderr)
        return 2
    peak_for(dev.device_kind)  # fail before any work if the kind is unknown

    model_cfg = ModelConfig(input_size=61)   # hidden resolves to 256
    train_cfg = TrainConfig(batch_size=512, bf16=True)
    seq_len, batch = 256, train_cfg.batch_size
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((batch, seq_len, model_cfg.input_size)),
                    jnp.float32)
    y = jnp.asarray(rng.integers(0, 2, batch))
    flops_step = 3 * model_flops_per_window(model_cfg, seq_len) * batch

    params = classifier_init(jax.random.key(0), model_cfg)
    tx = make_optimizer(train_cfg, updates_per_epoch=100)
    step = make_train_step(model_cfg, train_cfg, tx, donate=True)
    box = [TrainState(params, tx.init(params), jnp.asarray(0)), 0]

    def train_once():
        box[1] += 1
        box[0], metrics = step(box[0], x, y, jax.random.key(box[1]))
        return metrics["loss"]

    train_compile, train_s, _ = time_calls(train_once, args.steps)
    wps = batch / train_s
    # the train step donated the params above; inference gets its own
    params = classifier_init(jax.random.key(0), model_cfg)

    k = rates_to_array(DEFAULT_RATES)
    roll_compile, roll_s, _ = time_calls(
        lambda: coupled_rollout(params, x, k, model_cfg, forecast_steps=20),
        args.steps)

    xe = jnp.asarray(rng.standard_normal((1024, seq_len, model_cfg.input_size)),
                     jnp.float32)
    eval_step = make_eval_step(model_cfg, bf16=True)
    eval_compile, eval_s, _ = time_calls(lambda: eval_step(params, xe), args.steps)

    stats = dev.memory_stats() or {}
    payload = {
        "metric": "windows_per_sec_per_gpu",
        "value": wps,
        "unit": "windows/s",
        "mfu": mfu(flops_step, train_s, 1, dev.device_kind),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "extras": {
            "train_step_ms": train_s * 1e3,
            "train_compile_s": train_compile,
            "coupled_samples_per_sec": batch / roll_s,
            "coupled_ms": roll_s * 1e3,
            "coupled_compile_s": roll_compile,
            "eval_fwd_b1024_ms": eval_s * 1e3,
            "eval_compile_s": eval_compile,
            "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
            "steps": args.steps,
        },
    }
    print(json.dumps(payload), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
