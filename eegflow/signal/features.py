"""20-per-channel feature extractor for the classical baselines.

Reference: ``extract_features_gpu`` (03_baseline_models.py:151-275) — 13
time-domain + 7 spectral features per channel, computed per-channel in a
Python loop over 61 channels on CUDA. Here ALL channels are computed at once
on the (B, T, C) array under jit — the channel loop disappears into VPU
lanes, and the rfft batches over (B, C).

Exact-semantics notes (verified against the reference):
* std/var use ddof=1 (torch's unbiased default);
* skew/kurt use biased central moments (``.mean``-normalized) with +1e-10
  guards and excess kurtosis (-3);
* zero-crossing rate counts sign changes of the *mean-centered* signal,
  |diff(sign)|/2 summed over time, divided by seq_len;
* Hjorth mobility/complexity use ddof=1 stds with 1e-10 guards;
* band powers are sums of |rfft|^2 over [0.5,4), [4,8), [8,13), [13,30),
  [30,45) Hz masks, ratios over their sum + 1e-10;
* NaN/Inf are scrubbed to 0 afterwards (ref 03:257).

Feature order per channel (ref 03:243-251): mean, std, var, min, max, range,
skew, kurt, zcr, energy, activity, mobility, complexity, delta, theta, alpha,
beta, gamma, alpha_theta, alpha_beta. Output is channel-major: (B, C*20).
"""

from __future__ import annotations

import functools
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

N_FEATURES_PER_CHANNEL = 20

_BANDS = {
    "delta": (0.5, 4.0),
    "theta": (4.0, 8.0),
    "alpha": (8.0, 13.0),
    "beta": (13.0, 30.0),
    "gamma": (30.0, 45.0),
}


def _band_masks(seq_len: int, fs: float) -> np.ndarray:
    freqs = np.fft.rfftfreq(seq_len, 1.0 / fs)
    return np.stack(
        [(freqs >= lo) & (freqs < hi) for lo, hi in _BANDS.values()]
    ).astype(np.float32)  # (5, n_freqs)


@functools.partial(jax.jit, static_argnames=("fs",))
def _extract(x: jnp.ndarray, fs: float) -> jnp.ndarray:
    """(B, T, C) -> (B, C, 20) feature tensor."""
    b, t, c = x.shape
    eps = 1e-10

    mean = jnp.mean(x, axis=1)
    centered = x - mean[:, None, :]
    var_u = jnp.sum(centered**2, axis=1) / (t - 1)  # ddof=1 (torch default)
    std_u = jnp.sqrt(var_u)
    min_v = jnp.min(x, axis=1)
    max_v = jnp.max(x, axis=1)
    range_v = max_v - min_v

    m2 = jnp.mean(centered**2, axis=1)
    m3 = jnp.mean(centered**3, axis=1)
    m4 = jnp.mean(centered**4, axis=1)
    skew = m3 / (m2**1.5 + eps)
    kurt = m4 / (m2**2 + eps) - 3.0

    signs = jnp.sign(centered)
    zcr = jnp.sum(jnp.abs(jnp.diff(signs, axis=1)), axis=1) / 2.0 / t

    energy = jnp.mean(x**2, axis=1)

    diff1 = jnp.diff(x, axis=1)
    diff2 = jnp.diff(diff1, axis=1)
    d1_std = jnp.std(diff1, axis=1, ddof=1)
    d2_std = jnp.std(diff2, axis=1, ddof=1)
    activity = var_u
    mobility = d1_std / (std_u + eps)
    complexity = (d2_std / (d1_std + eps)) / (mobility + eps)

    power = jnp.abs(jnp.fft.rfft(x, axis=1)) ** 2  # (B, F, C)
    masks = jnp.asarray(_band_masks(t, fs))  # (5, F)
    band = jnp.einsum("bfc,kf->bkc", power, masks)  # (B, 5, C)
    delta_p, theta_p, alpha_p, beta_p, gamma_p = (band[:, i] for i in range(5))
    total = delta_p + theta_p + alpha_p + beta_p + gamma_p + eps

    feats = jnp.stack(
        [
            mean, std_u, var_u, min_v, max_v, range_v,
            skew, kurt, zcr, energy, activity, mobility, complexity,
            delta_p / total, theta_p / total, alpha_p / total,
            beta_p / total, gamma_p / total,
            alpha_p / (theta_p + eps), alpha_p / (beta_p + eps),
        ],
        axis=-1,
    )  # (B, C, 20)
    return feats


def extract_features(
    x: np.ndarray | jnp.ndarray, fs: float = 500.0, batch_size: int = 10000
) -> np.ndarray:
    """(N, T, C) windows -> (N, C*20) feature matrix, NaN/Inf scrubbed.

    Batched over ``batch_size`` windows to bound device memory like the
    reference (ref 03:178), though on an accelerator far larger batches fit.
    """
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    out: List[np.ndarray] = []
    for start in range(0, n, batch_size):
        chunk = jnp.asarray(x[start : start + batch_size])
        feats = _extract(chunk, float(fs))  # (b, C, 20)
        out.append(np.asarray(feats).reshape(feats.shape[0], -1))
    features = np.concatenate(out, axis=0) if out else np.empty((0, 0), np.float32)
    return np.nan_to_num(features, nan=0.0, posinf=0.0, neginf=0.0)


def feature_names(channel_names: Sequence[str]) -> List[str]:
    """Feature-name list matching the reference's order (ref 03:261-272)."""
    suffixes = [
        "mean", "std", "var", "min", "max", "range", "skew", "kurt", "zcr",
        "energy", "activity", "mobility", "complexity",
        "delta", "theta", "alpha", "beta", "gamma", "alpha_theta", "alpha_beta",
    ]
    names = []
    for ch in channel_names:
        names.extend(f"{ch}_{s}" for s in suffixes)
    return names
