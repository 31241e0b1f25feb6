"""Drive eegflow's main path once on one NVIDIA GPU and check it.

The flagship runs at its full width — ``ModelConfig(input_size=61)``: hidden
256, 3 bidirectional LSTM layers, attention, 256-sample windows — under
``TrainConfig(batch_size=512, bf16=True)``, with random weights from
``--seed``. The phases, in order, each print one line with its compile and
steady times (host clock around ``block_until_ready``):

1. preprocess — synthetic recordings (``data/synthetic.py``) through the FFT
   bandpass, z-score and windowing of ``signal/preprocess.py``;
2. train_step — the jitted train step at batch 512, and its first-step
   gradients against a plain float32 reference;
3. train_classifier — ``train.train_classifier`` for two short epochs;
4. checkpoint — save and reload the trained params;
5. forward — bf16 and default-precision float32 probabilities against the
   float32 reference;
6. rollout — ``couple.rollout.predict_batch`` on 512 windows, its ODE
   trajectories against ``scipy.integrate.solve_ivp``;
7. serve — ``cli.serve.serve`` in a thread of this process, three
   ``POST /predict`` requests against a direct ``predict_batch``.

Every reference runs on the card in float32 under
``jax.default_matmul_precision("highest")``: at the default precision a GPU
may run float32 products in TF32. ``--four-gpus`` runs only the four-card
path instead: one data-parallel train step over a 4-device mesh at global
batch 2048 against the same step on one card, and sharded ``predict_probs``
and ``predict_batch`` against one card.

Without a GPU, or when any phase fails, the script exits non-zero and prints
no result. Otherwise its last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Usage: python chip_smoke.py [--seed N] [--four-gpus]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from eegflow.core.compile_cache import enable_compile_cache
from eegflow.core.config import (CouplingConfig, ModelConfig, PreprocessConfig,
                                 TrainConfig)
from eegflow.core.profiling import card_info, time_calls


class SmokeFailure(RuntimeError):
    """A phase's result is outside its stated tolerance."""


@dataclass(frozen=True)
class Size:
    """How big each phase runs. :data:`FULL` is the flagship at full width;
    tests use smaller sizes on the CPU."""

    hidden: Optional[int] = None    # None: the flagship's 256 for 61 channels
    seq_len: int = 256
    batch: int = 512
    n_subjects: int = 8             # 6 train, 1 val, 1 test
    duration_s: float = 60.0        # per recording, at 500 Hz
    timed_steps: int = 5
    ode_check: int = 64             # rollout samples checked against scipy
    serve_windows: int = 4          # windows per POST /predict
    dp_batch: int = 2048            # --four-gpus global batch
    n_dp_devices: int = 4


FULL = Size()

# Tolerances. A result outside one fails the run; none is loosened to pass.
#: bf16 forward probabilities vs the f32 reference: bf16 keeps ~3 digits
#: per matmul input through 3 x 256 recurrent steps
BF16_PROB_ATOL = 2e-2
#: default-precision f32 (TF32 products allowed) vs the f32 reference
F32_PROB_ATOL = 5e-3
#: first-step gradients of the bf16 train step vs the f32 reference
GRAD_COSINE_MIN = 0.99
#: rollout trajectories vs scipy.integrate.solve_ivp (rtol 1e-10)
ODE_ATOL = 1e-5
#: /predict responses vs a direct predict_batch on the same windows
SERVE_ATOL = 1e-6
#: data-parallel vs one card: the same arithmetic in another reduction order
#: and GEMM tiling. Forward outputs within a tenth of the bf16 bound; the
#: loss to 1e-3 relative.
DP_OUT_ATOL = 2e-3
DP_LOSS_RTOL = 1e-3
#: AdamW's first step moves each parameter by about lr * sign(grad), so the
#: two updates can differ by up to 2 lr only where a gradient's sign differs.
#: Rounding flips the sign of near-zero gradients only; a wrong all-reduce
#: flips a large share. At most this share of parameters may differ by more
#: than lr.
DP_SIGN_FLIP_SHARE = 1e-3


def check(name: str, value: float, limit: float, upper: bool = True) -> str:
    """``name=value (<=|>= limit)``; raise SmokeFailure when outside."""
    op = "<=" if upper else ">="
    ok = value <= limit if upper else value >= limit
    if not ok or not np.isfinite(value):
        raise SmokeFailure(f"{name}={value:.6g} outside {op} {limit:g}")
    return f"{name}={value:.6g} ({op} {limit:g})"


def cosine(a, b) -> float:
    va = np.concatenate([np.ravel(np.asarray(x, np.float64))
                         for x in jax.tree_util.tree_leaves(a)])
    vb = np.concatenate([np.ravel(np.asarray(x, np.float64))
                         for x in jax.tree_util.tree_leaves(b)])
    return float(va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb)))


def max_abs_diff(a, b) -> float:
    return max(float(np.max(np.abs(np.asarray(x, np.float64)
                                   - np.asarray(y, np.float64))))
               for x, y in zip(jax.tree_util.tree_leaves(a),
                               jax.tree_util.tree_leaves(b)))


def model_config(size: Size) -> ModelConfig:
    return ModelConfig(input_size=61, hidden_size=size.hidden)


def train_config(size: Size, **kw) -> TrainConfig:
    return TrainConfig(batch_size=size.batch, bf16=True, **kw)


# ---------------------------------------------------------------------------
# one-card phases
# ---------------------------------------------------------------------------


def phase_preprocess(ctx: Dict, size: Size, seed: int) -> Dict:
    from eegflow.data.synthetic import generate_recording
    from eegflow.signal.preprocess import process_recordings

    splits = {"train": [], "val": [], "test": []}
    counter = 0
    for s in range(size.n_subjects):
        split = ("test" if s == size.n_subjects - 1 else
                 "val" if s == size.n_subjects - 2 else "train")
        for label, closed in ((0, False), (1, True)):
            raw = generate_recording(closed, size.duration_s, seed=seed + counter)
            counter += 1
            splits[split].append(({"label": label, "subject": f"{s:02d}"}, raw))
    cfg = PreprocessConfig(sequence_length=size.seq_len)
    first, steady, (arrays, _) = time_calls(
        lambda: process_recordings(splits, cfg), 1)
    x = arrays["X_train"]
    if x.shape[1:] != (size.seq_len, 61) or not np.all(np.isfinite(x)):
        raise SmokeFailure(f"windows of shape {x.shape} or non-finite")
    if len(x) < size.batch:
        raise SmokeFailure(f"{len(x)} training windows < batch {size.batch}")
    ctx["arrays"] = arrays
    return {"compile_s": first - steady, "steady_s": steady,
            "windows": {k: len(v) for k, v in arrays.items()
                        if k.startswith("y_")}}


def phase_train_step(ctx: Dict, size: Size, seed: int) -> Dict:
    from eegflow.train.data import class_weight_array
    from eegflow.nn.model import classifier_init
    from eegflow.train.steps import (TrainState, make_loss_fn, make_optimizer,
                                     make_train_step)

    model_cfg, train_cfg = model_config(size), train_config(size)
    arrays = ctx["arrays"]
    xb = jnp.asarray(arrays["X_train"][:size.batch])
    yb = jnp.asarray(arrays["y_train"][:size.batch])
    cw = class_weight_array(arrays["y_train"], model_cfg.num_classes)
    params = classifier_init(jax.random.key(seed), model_cfg)
    key = jax.random.key(seed + 1)

    # first-step gradients: the bf16 step's loss vs the f32 reference
    def grad_of(bf16):
        loss_fn = make_loss_fn(model_cfg, bf16, cw)
        return jax.jit(jax.grad(lambda p, x, y, k: loss_fn(p, x, y, k)[0]))

    g_bf16 = grad_of(True)(params, xb, yb, key)
    with jax.default_matmul_precision("highest"):
        g_ref = grad_of(False)(params, xb, yb, key)
    cos = cosine(g_bf16, g_ref)

    tx = make_optimizer(train_cfg, updates_per_epoch=100)
    step = make_train_step(model_cfg, train_cfg, tx, class_weights=cw)
    state = TrainState(params, tx.init(params), jnp.asarray(0))
    t0 = time.perf_counter()
    compiled = step.lower(state, xb, yb, key).compile()
    compile_s = time.perf_counter() - t0
    box = [state, 0]

    def once():
        box[1] += 1
        box[0], m = compiled(box[0], xb, yb, jax.random.fold_in(key, box[1]))
        return m["loss"]

    first, steady, loss = time_calls(once, size.timed_steps)
    if not np.isfinite(float(loss)):
        raise SmokeFailure(f"train loss {float(loss)}")
    mem = compiled.memory_analysis()
    return {"compile_s": compile_s, "steady_s": steady,
            "windows_per_s": size.batch / steady,
            "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
            "grad_cosine": check("grad_cosine", cos, GRAD_COSINE_MIN,
                                 upper=False)}


def phase_train_classifier(ctx: Dict, size: Size, seed: int) -> Dict:
    from eegflow.train import train_classifier

    arrays = ctx["arrays"]
    train_cfg = train_config(size, epochs=2, warmup_epochs=1,
                             accumulation_steps=1, augment=False, seed=seed)
    res = train_classifier(arrays["X_train"], arrays["y_train"],
                           arrays["X_val"], arrays["y_val"],
                           model_config(size), train_cfg, verbose=False)
    losses = res.history["train_loss"]
    if len(losses) != 2 or not np.all(np.isfinite(losses)):
        raise SmokeFailure(f"train losses {losses}")
    ctx["params"] = res.params
    ctx["history"] = res.history
    t0, t1 = res.history["epoch_time_s"]
    return {"compile_s": t0 - t1, "steady_s": t1,
            "steps_per_epoch": len(arrays["y_train"]) // size.batch,
            "train_loss": [float(v) for v in losses]}


def phase_checkpoint(ctx: Dict, size: Size, seed: int) -> Dict:
    from eegflow.core.artifacts import load_checkpoint, save_checkpoint

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        save_checkpoint(d, ctx["params"], model_config(size),
                        history=ctx["history"])
        params, cfg, history, _ = load_checkpoint(d)
        dt = time.perf_counter() - t0
    if (cfg != model_config(size)
            or history["train_loss"] != ctx["history"]["train_loss"]):
        raise SmokeFailure("checkpoint config or history changed")
    diff = max_abs_diff(ctx["params"], params)
    if diff != 0.0:
        raise SmokeFailure(f"reloaded params differ by {diff}")
    ctx["params"] = jax.device_put(params)
    return {"compile_s": 0.0, "steady_s": dt, "params_equal": True}


def phase_forward(ctx: Dict, size: Size, seed: int) -> Dict:
    from eegflow.train.steps import make_eval_step

    model_cfg, params = model_config(size), ctx["params"]
    x = jnp.asarray(ctx["arrays"]["X_test"][:size.batch])
    bf16_step = make_eval_step(model_cfg, bf16=True)
    first, steady, p_bf16 = time_calls(lambda: bf16_step(params, x),
                                       size.timed_steps)
    p_f32 = make_eval_step(model_cfg, bf16=False)(params, x)
    with jax.default_matmul_precision("highest"):
        p_ref = make_eval_step(model_cfg, bf16=False)(params, x)
    return {"compile_s": first - steady, "steady_s": steady,
            "bf16_max_abs": check("bf16_max_abs", max_abs_diff(p_bf16, p_ref),
                          BF16_PROB_ATOL),
            "f32_max_abs": check("f32_max_abs", max_abs_diff(p_f32, p_ref),
                                 F32_PROB_ATOL)}


def scipy_trajectories(probs: np.ndarray, k_base: np.ndarray,
                       coupling: CouplingConfig, steps: int) -> np.ndarray:
    """The reference's per-sample ODE solves (ref 06:367-406): modulated
    rates, heuristic initial state, ``solve_ivp`` at rtol 1e-10, clip and
    renormalize to the simplex. ``probs (N, 2)`` -> ``(N, steps, 3)``."""
    from scipy.integrate import solve_ivp

    a = coupling.coupling_strength
    out = []
    for p_open, p_closed in np.asarray(probs, np.float64):
        k = np.asarray(k_base, np.float64).copy()
        k[[1, 3]] *= 1.0 + a * p_closed          # k_af, k_pf
        k[[2, 4]] *= 1.0 + a * p_open            # k_pa, k_fa
        k = np.maximum(k, coupling.rate_floor)
        k_ap, k_af, k_pa, k_pf, k_fa, k_fp = k
        q = np.array([[-(k_ap + k_af), k_ap, k_af],
                      [k_pa, -(k_pa + k_pf), k_pf],
                      [k_fa, k_fp, -(k_fa + k_fp)]])
        thr = coupling.init_threshold
        y0 = ([0.2, 0.2, 0.6] if p_closed > thr else
              [0.6, 0.2, 0.2] if p_open > thr else [0.33, 0.34, 0.33])
        y0 = np.asarray(y0) / np.sum(y0)
        sol = solve_ivp(lambda t, y: np.maximum(y, 0.0) @ q, (0.0, steps), y0,
                        t_eval=np.linspace(0.0, steps, steps),
                        rtol=1e-10, atol=1e-12).y.T
        sol = np.clip(sol, 0.0, 1.0)
        out.append(sol / sol.sum(1, keepdims=True))
    return np.asarray(out)


def coupled_model(params, size: Size):
    from eegflow.couple.rollout import CoupledModel
    from eegflow.ode import rates_to_array
    from eegflow.ode.field import DEFAULT_RATES

    return CoupledModel(params, model_config(size),
                        rates_to_array(DEFAULT_RATES), CouplingConfig())


def phase_rollout(ctx: Dict, size: Size, seed: int) -> Dict:
    from eegflow.couple.rollout import predict_batch

    model = coupled_model(ctx["params"], size)
    x = ctx["arrays"]["X_test"][:size.batch]
    first, steady, res = time_calls(lambda: predict_batch(model, x),
                                    size.timed_steps)
    n = size.ode_check
    ref = scipy_trajectories(res["probs"][:n], np.asarray(model.k_base),
                             model.coupling, model.coupling.forecast_steps)
    return {"compile_s": first - steady, "steady_s": steady,
            "samples_per_s": len(x) / steady,
            "ode_max_abs": check("ode_max_abs",
                         max_abs_diff(res["trajectories"][:n], ref), ODE_ATOL)}


def phase_serve(ctx: Dict, size: Size, seed: int) -> Dict:
    from http.client import HTTPConnection

    from eegflow.cli.serve import serve
    from eegflow.couple.rollout import predict_batch

    model = coupled_model(ctx["params"], size)
    before = set(threading.enumerate())
    httpd = serve(model, host="127.0.0.1", port=0, warmup_seq_len=size.seq_len)
    warmup = [t for t in threading.enumerate() if t not in before]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    x = ctx["arrays"]["X_test"]
    times, diffs = [], []
    try:
        for r in range(3):
            windows = x[r * size.serve_windows:(r + 1) * size.serve_windows]
            body = json.dumps({"windows": windows.tolist()})
            conn = HTTPConnection(*httpd.server_address, timeout=600)
            t0 = time.perf_counter()
            conn.request("POST", "/predict", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            out = json.loads(resp.read())
            times.append(time.perf_counter() - t0)
            conn.close()
            if resp.status != 200:
                raise SmokeFailure(f"POST /predict -> {resp.status}: {out}")
            direct = predict_batch(model, windows)
            diffs.append(max(max_abs_diff(np.asarray(out[k]), direct[k])
                             for k in ("probs", "final_state")))
            if (out["pred_binary"] != direct["pred_binary"].tolist()
                    or out["pred_three"] != direct["pred_three"].tolist()):
                raise SmokeFailure("served predictions differ from direct ones")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
        for t in warmup:
            t.join(timeout=600)
    return {"compile_s": times[0] - float(np.mean(times[1:])),
            "steady_s": float(np.mean(times[1:])),
            "requests": len(times),
            "serve_max_abs": check("serve_max_abs", max(diffs), SERVE_ATOL)}


ONE_GPU_PHASES: List[Tuple[str, Callable]] = [
    ("preprocess", phase_preprocess),
    ("train_step", phase_train_step),
    ("train_classifier", phase_train_classifier),
    ("checkpoint", phase_checkpoint),
    ("forward", phase_forward),
    ("rollout", phase_rollout),
    ("serve", phase_serve),
]


# ---------------------------------------------------------------------------
# four-card phases
# ---------------------------------------------------------------------------


def _dp_data(ctx: Dict, size: Size, seed: int):
    if "dp_x" not in ctx:
        from eegflow.data.synthetic import synthetic_windows

        x, y = synthetic_windows(n_per_class=size.dp_batch // 2,
                                 seq_length=size.seq_len, seed=seed)
        ctx["dp_x"], ctx["dp_y"] = x, y
    return ctx["dp_x"], ctx["dp_y"]


def _dp_mesh(size: Size):
    from eegflow.train.mesh import make_data_mesh

    if len(jax.devices()) < size.n_dp_devices:
        raise SmokeFailure(f"{len(jax.devices())} devices < "
                           f"{size.n_dp_devices} for the data-parallel path")
    return make_data_mesh(size.n_dp_devices)


def phase_dp_train_step(ctx: Dict, size: Size, seed: int) -> Dict:
    from eegflow.nn.model import classifier_init
    from eegflow.train.data import class_weight_array
    from eegflow.train.mesh import replicate_to_mesh, shard_batch
    from eegflow.train.steps import TrainState, make_optimizer, make_train_step
    from eegflow.train.schedule import warmup_cosine_schedule

    mesh = _dp_mesh(size)
    x, y = _dp_data(ctx, size, seed)
    model_cfg = model_config(size)
    train_cfg = dataclasses.replace(train_config(size), batch_size=size.dp_batch)
    cw = class_weight_array(y, model_cfg.num_classes)
    params = classifier_init(jax.random.key(seed), model_cfg)
    tx = make_optimizer(train_cfg, updates_per_epoch=100)
    key = jax.random.key(seed + 1)
    xj, yj = jnp.asarray(x), jnp.asarray(y)

    one = make_train_step(model_cfg, train_cfg, tx, class_weights=cw, donate=False)
    state = TrainState(params, tx.init(params), jnp.asarray(0))
    first1, steady1, (s1, m1) = time_calls(lambda: one(state, xj, yj, key),
                                      size.timed_steps)

    dp = make_train_step(model_cfg, train_cfg, tx, class_weights=cw,
                         donate=False, mesh=mesh)
    state_dp = replicate_to_mesh(state, mesh)
    xs, ys = shard_batch((xj, yj), mesh)
    first4, steady4, (s4, m4) = time_calls(lambda: dp(state_dp, xs, ys, key),
                                      size.timed_steps)

    lr0 = float(warmup_cosine_schedule(train_cfg.learning_rate, train_cfg.epochs,
                                       train_cfg.warmup_epochs, 100)(0))
    apart = [np.abs(np.asarray(a) - np.asarray(b)) > lr0
             for a, b in zip(jax.tree_util.tree_leaves(s4.params),
                             jax.tree_util.tree_leaves(s1.params))]
    share = sum(int(a.sum()) for a in apart) / sum(a.size for a in apart)
    loss1, loss4 = float(m1["loss"]), float(m4["loss"])
    return {"compile_s": first4 - steady4, "steady_s": steady4,
            "one_card_steady_s": steady1,
            "windows_per_s": size.dp_batch / steady4,
            "loss_rel_diff": check("loss_rel_diff", abs(loss4 - loss1) / abs(loss1),
                          DP_LOSS_RTOL),
            "param_max_abs": max_abs_diff(s4.params, s1.params),
            "param_sign_flip_share": check("param_sign_flip_share", share,
                            DP_SIGN_FLIP_SHARE)}


def phase_dp_inference(ctx: Dict, size: Size, seed: int) -> Dict:
    from eegflow.couple.rollout import predict_batch
    from eegflow.nn.model import classifier_init
    from eegflow.train.loop import predict_probs

    mesh = _dp_mesh(size)
    x, _ = _dp_data(ctx, size, seed)
    model_cfg = model_config(size)
    params = classifier_init(jax.random.key(seed), model_cfg)
    p1 = predict_probs(params, x, model_cfg, batch_size=size.dp_batch)
    first, steady, p4 = time_calls(
        lambda: predict_probs(params, x, model_cfg, batch_size=size.dp_batch,
                              mesh=mesh), size.timed_steps)
    model = coupled_model(params, size)
    r1 = predict_batch(model, x, batch_size=size.dp_batch)
    r4 = predict_batch(model, x, batch_size=size.dp_batch, mesh=mesh)
    flips = int(np.sum(r1["pred_binary"] != r4["pred_binary"]))
    near = int(np.sum(np.abs(r1["final_state"][:, 2] - 0.5) <= DP_OUT_ATOL))
    if flips > near:
        raise SmokeFailure(f"{flips} binary predictions differ, only {near} "
                           "final states lie within the tolerance of 0.5")
    return {"compile_s": first - steady, "steady_s": steady,
            "probs_max_abs": check("probs_max_abs", max_abs_diff(p4, p1), DP_OUT_ATOL),
            "rollout_max_abs": check("rollout_max_abs", max(
                max_abs_diff(r4[k], r1[k])
                for k in ("probs", "trajectories", "final_state")), DP_OUT_ATOL),
            "pred_flips": flips}


FOUR_GPU_PHASES: List[Tuple[str, Callable]] = [
    ("dp_train_step", phase_dp_train_step),
    ("dp_inference", phase_dp_inference),
]


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def accelerator():
    """The device the smoke run measures (tests substitute a fake)."""
    return jax.devices()[0]


def run_phases(phases, size: Size, seed: int) -> None:
    """Run each phase in order and print its line; any exception propagates
    and ends the run."""
    ctx: Dict = {}
    for name, fn in phases:
        t0 = time.perf_counter()
        info = fn(ctx, size, seed)
        wall = time.perf_counter() - t0
        # a check() result already reads "name=value (<= limit)"
        extra = " | ".join(
            v if isinstance(v, str) and v.startswith(f"{k}=") else f"{k}={v}"
            for k, v in info.items() if k not in ("compile_s", "steady_s"))
        print(f"phase {name}: compile {info['compile_s']:.3f} s | steady "
              f"{info['steady_s'] * 1e3:.3f} ms | wall {wall:.1f} s | {extra}",
              flush=True)


def main(argv=None, size: Size = FULL) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-card data-parallel path")
    args = ap.parse_args(argv)
    if args.four_gpus:
        # the one-card reference step at global batch 2048 holds ~55 GB of
        # scan residuals: more than JAX's default 75 % share of an 80 GB card
        os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.92")

    card = card_info()  # before JAX opens the card
    enable_compile_cache()
    dev = accelerator()
    if dev.platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    if card is None:
        print("nvidia-smi gave no card name and power limit", file=sys.stderr)
        return 2
    smi = "; ".join(card.splitlines())
    print(f"card: {dev.device_kind} x {len(jax.devices())} | nvidia-smi: {smi} "
          f"| jax {jax.__version__}", flush=True)

    phases = FOUR_GPU_PHASES if args.four_gpus else ONE_GPU_PHASES
    run_phases(phases, size, args.seed)

    stats = jax.devices()[0].memory_stats() or {}
    print(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use', 'not available')}")
    print(json.dumps({"ok": True, "device": {"platform": dev.platform,
                                             "kind": dev.device_kind,
                                             "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
