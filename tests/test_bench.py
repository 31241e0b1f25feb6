"""bench.py and eegflow.core.profiling on the CPU: the peak table, MFU, the
refusal to measure without a GPU, host-clock timing, and the reduction of a
profiler trace to per-category device time (checked on a CPU trace)."""

import importlib
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eegflow.core import profiling as pf

REPO = Path(__file__).resolve().parents[1]


def test_peak_table_has_the_h100_data_sheet_rates():
    peak = pf.peak_for("NVIDIA H100 80GB HBM3")
    assert peak["bf16_flops"] == 989e12
    assert peak["hbm_bytes_per_s"] == 3.35e12
    assert "data sheet" in peak["source"]


def test_unknown_device_kind_is_an_error():
    with pytest.raises(KeyError, match="no published peak"):
        pf.peak_for("cpu")


def test_mfu_arithmetic():
    # 6.7 GFLOP/window fwd+bwd at 512 windows in 0.1 s on one H100
    flops = 6.7e9 * 512
    got = pf.mfu(flops, 0.1, 1, "NVIDIA H100 80GB HBM3")
    assert got == pytest.approx(flops / 0.1 / 989e12)
    assert pf.mfu(flops, 0.1, 4, "NVIDIA H100 80GB HBM3") == pytest.approx(got / 4)


def test_bench_refuses_the_cpu_and_prints_no_result(capsys):
    sys.path.insert(0, str(REPO))
    bench = importlib.import_module("bench")
    assert bench.main([]) != 0
    assert capsys.readouterr().out == ""


def test_card_info_is_none_without_nvidia_smi(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    assert pf.card_info() is None


def test_time_calls_counts_and_blocks():
    calls = []

    def fn():
        calls.append(1)
        return jnp.ones(4) * len(calls)

    first, steady, out = pf.time_calls(fn, 3)
    assert len(calls) == 4 and first >= 0 and steady >= 0
    np.testing.assert_array_equal(np.asarray(out), np.full(4, 4.0))


def _scan_program():
    w = jnp.asarray(np.random.default_rng(0).standard_normal((16, 16)) * 0.1,
                    jnp.float32)

    def body(c, x):
        with jax.named_scope("cell"):
            c = jnp.tanh(c @ w + x)
        return c, c

    def f(xs):
        with jax.named_scope("input_block"):
            xs = xs * 2.0
        c, ys = jax.lax.scan(body, jnp.zeros(16), xs)
        return ys.sum() + c.sum()

    return jax.jit(f).lower(jnp.ones((200, 16))).compile()


def test_hlo_op_labels_mark_while_bodies_and_scopes():
    labels = pf.hlo_op_labels(_scan_program().as_text())
    assert pf.WHILE_CONTAINER in labels.values()
    body = [v for v in labels.values() if v.startswith("while/")]
    assert body and any("cell" in v for v in body)
    assert any("input_block" in v and not v.startswith("while/")
               for v in labels.values())


def test_trace_breakdown_on_synthetic_ops():
    labels = {"a": "while/jit(f)/scan", "b": "jit(f)/input_block/mul",
              "c": "jit(f)/other", "w": pf.WHILE_CONTAINER}
    ops = [pf.DeviceOp("m", "w", 0, 100),        # container: skipped
           pf.DeviceOp("m", "a", 0, 10), pf.DeviceOp("m", "a", 20, 10),
           pf.DeviceOp("m", "b", 25, 10),        # overlaps the second "a"
           pf.DeviceOp("m", "c", 60, 10), pf.DeviceOp("m", "zz", 80, 20),
           pf.DeviceOp("other_module", "a", 500, 10)]
    br = pf.trace_breakdown(ops, labels, (("recurrence", r"^while/"),
                                          ("input_block", "input_block")),
                            module="m")
    assert br.seconds == pytest.approx({"recurrence": 20e-9,
                                        "input_block": 10e-9,
                                        "other": 10e-9,
                                        "unattributed": 20e-9})
    assert br.n_ops == 5
    assert br.window_s == pytest.approx(100e-9)
    assert br.busy_s == pytest.approx(55e-9)     # 10 + 15 + 10 + 20
    assert br.idle_share == pytest.approx(0.45)
    assert sum(br.shares().values()) == pytest.approx(1.0)


def test_command_buffer_kernels_resolve_by_kernel_name():
    """Kernels launched from a CUDA graph carry hlo_op="command_buffer";
    their kernel name maps back to the HLO instruction."""
    labels = {"loop_add_fusion.52": "while/jit(step)/jvp(lstm_l1_fwd)/add",
              "input_concatenate_fusion": "jit(step)/attention_pool/concat"}
    cb = [pf.DeviceOp("m", "command_buffer", 0, 10, "loop_add_fusion_52"),
          pf.DeviceOp("m", "command_buffer", 10, 5, "input_concatenate_fusion"),
          pf.DeviceOp("m", "command_buffer", 15, 5, "memcpy32_post")]
    assert pf.op_label(cb[0], labels).startswith("while/")
    br = pf.trace_breakdown(cb, labels, pf.TRAIN_STEP_CATEGORIES, module="m")
    assert br.seconds == pytest.approx({"recurrence": 10e-9,
                                        "attention_pool": 5e-9,
                                        "unattributed": 5e-9})


def test_trace_breakdown_on_a_cpu_trace(tmp_path):
    compiled = _scan_program()
    labels = pf.hlo_op_labels(compiled.as_text())
    module = re.search(r"HloModule (\S+?),", compiled.as_text()).group(1)
    x = jnp.ones((200, 16))
    jax.block_until_ready(compiled(x))
    with jax.profiler.trace(str(tmp_path)):
        for _ in range(2):
            jax.block_until_ready(compiled(x))
    ops = pf.device_ops(pf.newest_xplane(str(tmp_path)), plane_prefix="/host:CPU")
    assert ops and all(op.duration_ns >= 0 for op in ops)
    br = pf.trace_breakdown(ops, labels, (("recurrence", r"^while/"),),
                            module=module)
    assert br.seconds.get("recurrence", 0.0) > 0.0
    assert "unattributed" not in br.seconds
    assert 0.0 <= br.idle_share <= 1.0


def test_profile_train_tool_rehearsal(tmp_path):
    env = {k: os.environ[k] for k in ("PATH", "HOME", "TMPDIR") if k in os.environ}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, str(REPO / "tools" / "profile_train.py"), "--batch",
         "4", "--steps", "1", "--trace-steps", "1", "--hidden", "8",
         "--seq-len", "8", "--plane", "/host:CPU", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    out = (tmp_path / "profile_train.json").read_text()
    assert '"recurrence"' in out and '"idle_share"' in out
