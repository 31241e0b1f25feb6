"""Where the flagship train step spends its device time.

Compiles the full-width train step (ModelConfig(input_size=61): H=256, 3
bidirectional layers, attention, T=256) at batch 512 under the bf16 policy,
times it on the host clock around ``block_until_ready``, then traces a few
steps with ``jax.profiler`` and reduces the trace with
``eegflow.core.profiling.trace_breakdown``: device time in the ``lax.scan``
recurrences (while-loop bodies), the hoisted LSTM input projections, the
input block, the LN + attention pool, the head, and everything else
(optimizer update, loss, dropout bits).

Prints one JSON line and writes it, with the 40 largest ops, the device
events the breakdown cannot attribute, and a sample of raw trace events, to
``<out>/profile_train<tag>.json``.

Usage: python tools/profile_train.py [--batch 512] [--steps 10]
       [--trace-steps 3] [--out chiprun_out] [--tag T] [--plane /device:GPU:0]
       [--hidden N --seq-len T]   (smaller widths, for a CPU rehearsal)
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--trace-steps", type=int, default=3)
    ap.add_argument("--hidden", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--plane", default="/device:",
                    help="trace plane prefix holding the device ops "
                         "(/host:CPU for a CPU rehearsal)")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out"))
    ap.add_argument("--tag", default="",
                    help="suffix of the output file name")
    args = ap.parse_args(argv)

    from eegflow.core.profiling import card_info

    card = card_info()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from eegflow.core import profiling as pf
    from eegflow.core.compile_cache import enable_compile_cache
    from eegflow.core.config import ModelConfig, TrainConfig
    from eegflow.nn.model import classifier_init
    from eegflow.train.steps import TrainState, make_optimizer, make_train_step

    enable_compile_cache()
    dev = jax.devices()[0]
    model_cfg = ModelConfig(input_size=61, hidden_size=args.hidden)
    train_cfg = TrainConfig(batch_size=args.batch, bf16=True)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(
        (args.batch, args.seq_len, model_cfg.input_size)), jnp.float32)
    y = jnp.asarray(rng.integers(0, 2, args.batch))
    params = classifier_init(jax.random.key(0), model_cfg)
    tx = make_optimizer(train_cfg, updates_per_epoch=100)
    step = make_train_step(model_cfg, train_cfg, tx, donate=True)
    state = TrainState(params, tx.init(params), jnp.asarray(0))
    compiled = step.lower(state, x, y, jax.random.key(0)).compile()
    module = re.search(r"HloModule (\S+?),", compiled.as_text()).group(1)
    labels = pf.hlo_op_labels(compiled.as_text())

    box = [state, 0]

    def once():
        box[1] += 1
        box[0], m = compiled(box[0], x, y, jax.random.key(box[1]))
        return m["loss"]

    first_s, step_s, _ = pf.time_calls(once, args.steps)
    trace_dir = tempfile.mkdtemp(prefix="eegflow_trace_")
    with jax.profiler.trace(trace_dir):
        for _ in range(args.trace_steps):
            jax.block_until_ready(once())
    xplane = pf.newest_xplane(trace_dir)
    ops = pf.device_ops(xplane, plane_prefix=args.plane)
    br = pf.trace_breakdown(ops, labels, pf.TRAIN_STEP_CATEGORIES,
                            module=module)
    per_op = {}
    for op in ops:
        if op.module == module:
            name = op.kernel if op.op == "command_buffer" else op.op
            per_op[name] = per_op.get(name, 0.0) + op.duration_ns * 1e-9
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:40]

    result = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "batch": args.batch, "seq_len": args.seq_len,
        "hidden": model_cfg.resolved_hidden(),
        "first_step_s": first_s, "step_s": step_s,
        "trace_steps": args.trace_steps,
        "device_s_per_step": {k: v / args.trace_steps
                              for k, v in br.seconds.items()},
        "shares": br.shares(),
        "idle_share": br.idle_share,
        "traced_step_s": br.window_s / args.trace_steps,
        "n_ops": br.n_ops,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }
    print(json.dumps(result), flush=True)
    os.makedirs(args.out, exist_ok=True)
    from jax.profiler import ProfileData

    # a few raw events per trace line, and the device events with no hlo_op
    # stat summed by name: what the breakdown above cannot attribute
    sample, unlabeled = [], {}
    for plane in ProfileData.from_file(xplane).planes:
        if not plane.name.startswith(args.plane):
            continue
        for line in plane.lines:
            for i, ev in enumerate(line.events):
                stats = {k: str(v) for k, v in ev.stats}
                if i < 15:
                    sample.append({"plane": plane.name, "line": line.name,
                                   "name": ev.name,
                                   "duration_ns": ev.duration_ns,
                                   "stats": stats})
                if "hlo_op" not in stats:
                    unlabeled[ev.name] = (unlabeled.get(ev.name, 0.0)
                                          + ev.duration_ns * 1e-9)
    with open(os.path.join(args.out, f"profile_train{args.tag}.json"), "w") as f:
        json.dump({**result,
                   "command_buffer_in_hlo_text": "command_buffer" in compiled.as_text(),
                   "unlabeled_by_name": sorted(
                       ((k, v / args.trace_steps) for k, v in unlabeled.items()),
                       key=lambda kv: -kv[1])[:40],
                   "top_ops": [(op, s / args.trace_steps, pf.op_label(
                       pf.DeviceOp(module, op, 0, 0, op), labels) or "?")
                       for op, s in top],
                   "sample_events": sample[:200]}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
