"""The train / integrate / serve path needs only what the GPU machine is
sure to have (JAX, numpy, scipy, optax, chex, einops, pytest, hypothesis),
and the compile cache lands where the helper says.

Each check runs in a subprocess whose import system refuses the optional
packages, so a stray top-level import anywhere on the path fails the test.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

OPTIONAL = ["sklearn", "pandas", "matplotlib", "seaborn", "torch", "flax",
            "orbax", "xgboost", "mne", "shap", "openpyxl"]

BLOCKER = f'''
import importlib.abc, importlib.util, sys
BLOCK = set({OPTIONAL!r})

class _Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("not on the GPU machine: " + name)
        return None

sys.meta_path.insert(0, _Blocker())
_find_spec = importlib.util.find_spec
importlib.util.find_spec = (
    lambda name, *a, **k: None if name.split(".")[0] in BLOCK
    else _find_spec(name, *a, **k))
'''


def _run(code, cwd, env_extra=None, blocked=True, timeout=600):
    env = {k: os.environ[k] for k in ("PATH", "HOME", "TMPDIR") if k in os.environ}
    env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO)})
    env.update(env_extra or {})
    prelude = BLOCKER if blocked else ""
    return subprocess.run([sys.executable, "-c", prelude + code], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_train_integrate_and_serve_stages_need_no_optional_package(tmp_path):
    prep = _run(
        "from eegflow.cli.main import main\n"
        "main(['--data-dir', 'ds', '--output-dir', 'out', 'synth',"
        " '--subjects', '4', '--duration', '12'])\n"
        "main(['--data-dir', 'ds', '--output-dir', 'out', 'preprocess'])\n"
        "main(['--data-dir', 'ds', '--output-dir', 'out', 'fit-ode'])\n",
        tmp_path, blocked=False)
    assert prep.returncode == 0, prep.stderr[-3000:]
    (tmp_path / "cfg.json").write_text(json.dumps({
        "model": {"hidden_size": 8, "num_layers": 1},
        "train": {"batch_size": 32, "eval_batch_size": 64,
                  "accumulation_steps": 1, "augment": False},
        "ode": {"de_maxiter": 5}}))
    r = _run(
        "from eegflow.cli.main import main\n"
        "args = ['--data-dir', 'ds', '--output-dir', 'out', '--config', 'cfg.json']\n"
        "assert main(args + ['train', '--epochs', '1']) == 0\n"
        "assert main(args + ['integrate']) == 0\n"
        "from eegflow.cli.serve import serve\n"
        "import sys\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in BLOCK)\n"
        "assert not bad, bad\n",
        tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "figures are not written" in r.stdout
    assert (tmp_path / "out" / "models" / "lstm_attention" / "params.npz").exists()
    assert (tmp_path / "out" / "results" / "integration_results.json").exists()


COMPILE = ("import jax, jax.numpy as jnp\n"
           "from eegflow.core.compile_cache import enable_compile_cache\n"
           "print(enable_compile_cache())\n"
           "print(jax.config.jax_compilation_cache_dir)\n"
           "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
           "jax.config.update('jax_persistent_cache_min_entry_size_bytes', 0)\n"
           "f = jax.jit(lambda x: jnp.sin(x) * {c} + jnp.cos(x) ** 3)\n"
           "jax.block_until_ready(f(jnp.arange({n}.0)))\n")


def _entries(d):
    d = Path(d)
    return {p.name for p in d.rglob("*") if p.is_file()} if d.exists() else set()


@pytest.mark.parametrize("where", ["env_var", "checkout_default"])
def test_compile_cache_entries_land_where_configured(tmp_path, where):
    """Entries land in JAX_COMPILATION_CACHE_DIR when it is set, else in the
    checkout's .jax_cache."""
    from eegflow.core.compile_cache import REPO_CACHE_DIR

    env_dir = tmp_path / "env_cache"
    env = {"JAX_COMPILATION_CACHE_DIR": str(env_dir)} if where == "env_var" else {}
    before = _entries(REPO_CACHE_DIR)
    # a program no other test compiles, so its entry is new
    code = COMPILE.format(c=abs(hash(str(tmp_path))) % 9973 + 2,
                          n=abs(hash(where)) % 97 + 3)
    r = _run(code, tmp_path, env, blocked=False, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    reported, configured = r.stdout.strip().splitlines()[-2:]
    if where == "env_var":
        # JAX took the directory from the variable; the helper set none
        assert reported == configured == str(env_dir)
        assert _entries(env_dir)
    else:
        assert Path(reported) == Path(configured) == REPO_CACHE_DIR
        assert _entries(REPO_CACHE_DIR) - before
