"""Artifact store: processed-data archives, model checkpoints, result JSONs.

Mirrors the reference's on-disk contract — ``processed_sequences.npz`` +
``preprocessing_metadata.json`` (ref 02_preprocessing.py:393-414), a model
checkpoint embedding its architectural config and training history
(ref 04_lstm_model.py:921-933), and per-stage JSON result files — but stores
params as a JAX pytree (one ``.npz`` entry per leaf) instead of a torch
state dict. Every downstream stage reconstructs models from the embedded
config, which is the serialization contract.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

from eegflow.core.config import ModelConfig


# ---------------------------------------------------------------------------
# processed-data archive (stage 02 contract)
# ---------------------------------------------------------------------------

SPLIT_KEYS = ("X_train", "y_train", "X_val", "y_val", "X_test", "y_test")


def save_processed(
    out_dir: str | Path,
    arrays: Dict[str, np.ndarray],
    metadata: Dict[str, Any],
    name: str = "processed_sequences",
) -> Path:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    npz_path = out_dir / f"{name}.npz"
    np.savez_compressed(npz_path, **arrays)
    (out_dir / "preprocessing_metadata.json").write_text(
        json.dumps(_jsonable(metadata), indent=2)
    )
    return npz_path


def load_processed(
    path: str | Path, mmap: bool = True
) -> Tuple[Dict[str, np.ndarray], Optional[Dict[str, Any]]]:
    """Load the processed archive (+ metadata if present).

    ``mmap`` loads lazily like the reference's fast path (ref 03:71-104);
    compressed archives fall back to eager load.
    """
    path = Path(path)
    data = np.load(path, mmap_mode="r" if mmap else None, allow_pickle=False)
    arrays = {k: data[k] for k in data.files}
    meta_path = path.parent / "preprocessing_metadata.json"
    metadata = json.loads(meta_path.read_text()) if meta_path.exists() else None
    return arrays, metadata


# ---------------------------------------------------------------------------
# model checkpoint (stage 04 contract)
# ---------------------------------------------------------------------------


def save_checkpoint(
    path: str | Path,
    params: Any,
    model_config: ModelConfig,
    history: Optional[Dict[str, Any]] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> Path:
    """Save params pytree + config + history to a checkpoint directory:
    ``params.npz`` (:func:`save_pytree`) beside ``checkpoint.json``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    save_pytree(path / "params.npz", params)
    cfg = {f: getattr(model_config, f) for f in model_config.__dataclass_fields__}
    payload = {"model_config": cfg, "history": _jsonable(history or {}),
               "extra": _jsonable(extra or {}),
               # model-family tag: classifier_init/apply dispatch on the
               # config TYPE, so the checkpoint must round-trip it
               "model_type": type(model_config).__name__}
    (path / "checkpoint.json").write_text(json.dumps(payload, indent=2))
    return path


def load_checkpoint(path: str | Path, params_template: Any = None):
    """Load (params, ModelConfig, history, extra) from a checkpoint directory.

    If ``params_template`` is None the params come back as nested dicts and
    lists of arrays (the init-time structure); with a template the exact
    pytree structure is restored (:func:`load_pytree`).
    """
    path = Path(path)
    payload = json.loads((path / "checkpoint.json").read_text())
    from eegflow.core.config import TransformerConfig

    cfg_cls = {"ModelConfig": ModelConfig,
               "TransformerConfig": TransformerConfig}[
        payload.get("model_type", "ModelConfig")]
    cfg = cfg_cls(**payload["model_config"])
    params = load_pytree(path / "params.npz", params_template)
    return params, cfg, payload.get("history", {}), payload.get("extra", {})


def _leaf_key(key_path) -> str:
    """``/``-joined name of a pytree leaf: dict keys, sequence indices and
    attribute names in order (``lstm/0/fwd/w_ih``, ``1/0/mu/head1/b``)."""
    parts = []
    for k in key_path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                parts.append(str(getattr(k, attr)))
                break
        else:
            raise TypeError(f"unsupported pytree key {k!r}")
    return "/".join(parts)


def save_pytree(path: str | Path, tree: Any) -> None:
    """Write a pytree of arrays as one ``.npz``, one entry per leaf, named by
    the leaf's path (:func:`_leaf_key`)."""
    import jax

    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    arrays = {_leaf_key(p): np.asarray(v) for p, v in leaves}
    if len(arrays) != len(leaves):
        raise ValueError("pytree leaf paths collide; cannot save as .npz")
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_pytree(path: str | Path, template: Any = None) -> Any:
    """Read a :func:`save_pytree` file.

    With ``template`` (any pytree of the saved structure, e.g. freshly
    initialized params and optimizer state) the leaves are put back into
    that structure. Without one, the paths rebuild nested dicts, and dicts
    keyed exactly ``"0".."n-1"`` become lists.
    """
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    if template is not None:
        import jax

        leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
        return jax.tree_util.tree_unflatten(
            treedef, [arrays[_leaf_key(p)] for p, _ in leaves])
    tree: Dict[str, Any] = {}
    for name, value in arrays.items():
        *parents, leaf = name.split("/")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return _restore_lists(tree)


def _restore_lists(tree: Any) -> Any:
    """Leaf paths name list items by index, so a list comes back as a
    {"0": ..., "1": ...} dict; undo that so restored params match the
    init-time pytree structure."""
    if isinstance(tree, dict):
        restored = {k: _restore_lists(v) for k, v in tree.items()}
        keys = set(restored.keys())
        # only convert when the keys are exactly {"0"..."n-1"} — a user dict
        # that merely happens to have digit keys (or sparse ones) stays a dict
        if keys and keys == {str(i) for i in range(len(keys))}:
            return [restored[str(i)] for i in range(len(keys))]
        return restored
    return tree


# ---------------------------------------------------------------------------
# result JSONs (per-stage contract, ref outputs/results/*.json)
# ---------------------------------------------------------------------------


def save_results(path: str | Path, results: Dict[str, Any]) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(_jsonable(results), indent=2))
    return path


def load_results(path: str | Path) -> Dict[str, Any]:
    return json.loads(Path(path).read_text())


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    if hasattr(obj, "item") and not isinstance(obj, (str, bytes)):
        try:
            return obj.item()
        except Exception:
            return obj
    return obj
