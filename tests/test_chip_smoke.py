"""chip_smoke.py rehearsed on the CPU at tiny widths.

The phases run end to end with a stand-in accelerator that reports itself as
a GPU; the real script must refuse the CPU platform, a failing phase, and a
directory that holds nothing of the repo. The one test that needs the card
is marked ``gpu`` and skips here.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

TINY = cs.Size(hidden=8, seq_len=32, batch=16, n_subjects=4, duration_s=3.0,
               timed_steps=2, ode_check=4, serve_windows=2, dp_batch=32)


class _RehearsalDevice:
    platform = "gpu"
    device_kind = "cpu-rehearsal"


def _fake_gpu(monkeypatch):
    monkeypatch.setattr(cs, "accelerator", lambda: _RehearsalDevice())
    monkeypatch.setattr(cs, "card_info", lambda: "rehearsal card, 0.00 W")


def _last_json(out: str):
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def one_card_run():
    """One tiny rehearsal of the one-card phases: (rc, stdout lines)."""
    mp = pytest.MonkeyPatch()
    _fake_gpu(mp)
    import contextlib
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cs.main([], size=TINY)
    finally:
        mp.undo()
    return rc, buf.getvalue().splitlines()


def test_one_card_rehearsal_passes_with_ok_last_line(one_card_run):
    rc, lines = one_card_run
    assert rc == 0
    assert _last_json(lines[-1]) == {
        "ok": True, "device": {"platform": "gpu", "kind": "cpu-rehearsal",
                               "count": len(jax.devices())}}
    assert lines[0].startswith("card: cpu-rehearsal x ")
    assert "nvidia-smi: rehearsal card, 0.00 W" in lines[0]
    assert any(line.startswith("peak_bytes_in_use:") for line in lines)


@pytest.mark.parametrize("phase", [name for name, _ in cs.ONE_GPU_PHASES])
def test_each_phase_prints_times_and_checks(one_card_run, phase):
    _, lines = one_card_run
    line = next(ln for ln in lines if ln.startswith(f"phase {phase}:"))
    assert " compile " in line and " steady " in line
    expected_checks = {
        "train_step": ["grad_cosine="], "forward": ["bf16_max_abs=",
                                                    "f32_max_abs="],
        "rollout": ["ode_max_abs="], "serve": ["serve_max_abs="],
        "checkpoint": ["params_equal=True"],
    }.get(phase, [])
    for check in expected_checks:
        assert check in line, line


def test_four_gpu_path_on_virtual_devices(monkeypatch, capsys):
    """--four-gpus runs the data-parallel phases alone, over 4 of the
    virtual CPU devices, against one device."""
    _fake_gpu(monkeypatch)
    assert cs.main(["--four-gpus"], size=TINY) == 0
    out = capsys.readouterr().out
    phases = [ln.split(":")[0] for ln in out.splitlines()
              if ln.startswith("phase ")]
    assert phases == ["phase dp_train_step", "phase dp_inference"]
    assert "param_sign_flip_share=" in out and "probs_max_abs=" in out
    assert _last_json(out)["ok"] is True


def test_cpu_platform_exits_nonzero_without_result(monkeypatch, capsys):
    monkeypatch.setattr(cs, "card_info", lambda: None)
    assert cs.main([], size=TINY) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_failing_phase_ends_the_run_without_ok(monkeypatch, capsys):
    _fake_gpu(monkeypatch)

    def broken(ctx, size, seed):
        raise cs.SmokeFailure("forced failure")

    monkeypatch.setattr(cs, "ONE_GPU_PHASES",
                        [("preprocess", cs.phase_preprocess), ("broken", broken)])
    with pytest.raises(cs.SmokeFailure, match="forced"):
        cs.main([], size=TINY)
    out = capsys.readouterr().out
    assert "phase preprocess:" in out and '"ok"' not in out


def _run_script(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_script_on_cpu_exits_nonzero_without_result():
    r = _run_script(REPO, REPO / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_script_alone_in_a_directory_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_script(tmp_path, tmp_path / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("value,limit,upper,passes", [
    (1e-6, 1e-5, True, True),
    (2e-5, 1e-5, True, False),
    (0.995, 0.99, False, True),
    (0.98, 0.99, False, False),
    (float("nan"), 1.0, True, False),
])
def test_check_enforces_tolerance(value, limit, upper, passes):
    if passes:
        assert cs.check("x", value, limit, upper).startswith("x=")
    else:
        with pytest.raises(cs.SmokeFailure):
            cs.check("x", value, limit, upper)


def test_scipy_trajectories_match_the_library_rollout_ode():
    """The smoke's scipy reference reproduces the library's coupling law:
    modulated rates, initial state, expm solve, simplex projection."""
    import jax.numpy as jnp

    from eegflow.core.config import CouplingConfig
    from eegflow.couple.modulation import infer_initial_state, modulate_rates
    from eegflow.ode import rates_to_array, solve_batch
    from eegflow.ode.field import DEFAULT_RATES

    rng = np.random.default_rng(3)
    p_closed = rng.uniform(0, 1, 12)
    probs = np.stack([1 - p_closed, p_closed], axis=1).astype(np.float32)
    k = rates_to_array(DEFAULT_RATES)
    coupling = CouplingConfig()
    ref = cs.scipy_trajectories(probs, np.asarray(k), coupling, 20)
    k_mod = modulate_rates(k, probs[:, 1], probs[:, 0],
                           coupling.coupling_strength, coupling.rate_floor)
    y0 = infer_initial_state(probs[:, 1], probs[:, 0], coupling.init_threshold)
    ours = np.asarray(solve_batch(jnp.asarray(y0), 0.0, 20.0, 20, k_mod))
    assert ref.shape == ours.shape == (12, 20, 3)
    assert np.max(np.abs(ours - ref)) < 1e-5


def test_cosine_and_max_abs_diff_over_pytrees():
    a = {"w": np.array([1.0, 2.0]), "b": [np.array([3.0])]}
    b = {"w": np.array([1.0, 2.5]), "b": [np.array([3.0])]}
    assert cs.max_abs_diff(a, b) == pytest.approx(0.5)
    assert cs.cosine(a, a) == pytest.approx(1.0)
    assert cs.cosine(a, b) < 1.0


@pytest.mark.gpu
def test_one_card_phases_on_the_card(gpu_device, capsys):
    """On the card (JAX_PLATFORMS=cuda python -m pytest -m gpu tests/): the
    one-card phases at a small width, with the card's own platform check."""
    small = cs.Size(hidden=32, seq_len=64, batch=64, n_subjects=4,
                    duration_s=10.0, timed_steps=2, ode_check=8)
    assert cs.main([], size=small) == 0
    assert _last_json(capsys.readouterr().out)["device"]["platform"] == "gpu"
