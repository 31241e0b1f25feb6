"""Host-side data plumbing: class weighting, weighted sampling, augmentation,
static-shape batching.

The reference uses a ``WeightedRandomSampler`` + 8 DataLoader worker processes
(ref 04_lstm_model.py:336-403). Here the whole (augmented) dataset is a
single device-resident array; an epoch is one host-side index draw + jitted
steps over static-shape batches — no worker processes, no per-batch H2D copies
beyond the sharded device_put.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np


def class_weight_array(y: np.ndarray, num_classes: int = 2) -> np.ndarray:
    """Loss class weights: 1/count, normalized to sum 2 (ref 04:429-432)."""
    counts = np.bincount(y, minlength=num_classes).astype(np.float64)
    counts = np.maximum(counts, 1)
    w = 1.0 / counts
    return (w / w.sum() * num_classes).astype(np.float32)


def weighted_epoch_indices(
    y: np.ndarray, rng: np.random.Generator, num_samples: Optional[int] = None
) -> np.ndarray:
    """WeightedRandomSampler semantics (ref 04:355-368): sample with
    replacement, per-sample weight 1/count[class]."""
    counts = np.bincount(y).astype(np.float64)
    weights = 1.0 / counts[y]
    p = weights / weights.sum()
    n = num_samples if num_samples is not None else len(y)
    return rng.choice(len(y), size=n, replace=True, p=p)


def phase_surrogate(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Fourier phase surrogate per sample/channel: randomize every phase,
    keep the amplitude spectrum bit-exact (DC and Nyquist stay real).

    Any feature of the per-channel amplitude spectrum (band powers — the
    synthetic biomarker, and 16/20 of the reference's features,
    ref 03_feature_extraction.py:52-214) is invariant under this map, while
    the time-domain waveform the network could memorize is destroyed. Used
    as an anti-subject-memorization augmentation for small subject counts.
    """
    n, t, c = x.shape
    spec = np.fft.rfft(x, axis=1)
    phases = rng.uniform(0.0, 2.0 * np.pi, spec.shape)
    surro = np.abs(spec) * np.exp(1j * phases)
    # DC and Nyquist are real-SIGNED coefficients: keep them verbatim
    # (|DC| would flip negative-mean windows to positive mean — a
    # systematic artifact distinguishing surrogates from originals)
    surro[:, 0, :] = spec[:, 0, :]
    if t % 2 == 0:
        surro[:, -1, :] = spec[:, -1, :]
    return np.fft.irfft(surro, n=t, axis=1).astype(x.dtype)


def make_surrogate_refresher(n_original: int, n_surrogates: int, seed: int):
    """Jitted device-side per-epoch surrogate refresh: ``(x_dev, epoch) ->
    x_dev`` regenerating the LAST ``n_original * n_surrogates`` rows as
    fresh Fourier phase surrogates of the FIRST ``n_original`` rows.

    The training set is HBM-resident (see ``train_classifier``), so the
    refresh runs entirely on device (rFFT -> fresh phases -> irFFT): the
    host sends only the epoch number. Fresh draws each epoch make the
    surrogate set effectively infinite — the network cannot memorize any
    fixed waveform, only the (preserved) amplitude spectrum.
    """
    import jax
    import jax.numpy as jnp

    root = jax.random.key(seed)

    @jax.jit
    def refresh(x, epoch):
        base = x[:n_original]
        t = base.shape[1]
        spec = jnp.fft.rfft(base, axis=1)
        mag = jnp.abs(spec)
        copies = []
        for k in range(n_surrogates):
            key = jax.random.fold_in(root, epoch * 131 + k)
            ph = jax.random.uniform(key, spec.shape, minval=0.0,
                                    maxval=2.0 * jnp.pi)
            surro = mag * jnp.exp(1j * ph)
            # DC/Nyquist are real-SIGNED: keep them verbatim (see
            # phase_surrogate)
            surro = surro.at[:, 0, :].set(spec[:, 0, :])
            if t % 2 == 0:
                surro = surro.at[:, -1, :].set(spec[:, -1, :])
            copies.append(jnp.fft.irfft(surro, n=t, axis=1).astype(x.dtype))
        head = x[: x.shape[0] - n_original * n_surrogates]
        return jnp.concatenate([head] + copies, axis=0)

    return refresh


def augment_data(
    x: np.ndarray,
    y: np.ndarray,
    rng: np.random.Generator,
    noise_std: float = 0.05,
    max_shift: int = 5,
    mixup: bool = False,
    channel_dropout: float = 0.0,
    phase_surrogates: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """3x augmentation (ref 04:290-312): original + Gaussian noise + circular
    time shift (per-sample random shift in [-max_shift, max_shift]).

    Vectorized: the reference loops per sample; here the noise copy is one
    draw and the shift copy is one gather. Deviation (documented): the
    reference skips the shifted copy when shift==0 (~1/11 of samples); we keep
    it for static shapes, so augmented size is exactly 3N.

    Three optional regularizers beyond the reference (for small-subject-count
    generalization — the model memorizes subjects below ~20 of them):
    ``mixup`` adds a 4th copy of within-class convex mixes
    (lam ~ Beta(0.4, 0.4), partner drawn from the same class, hard labels
    kept so the weighted-CE loss is unchanged); ``channel_dropout`` adds a
    5th copy with each channel independently zeroed with this probability
    (forces the classifier off any single electrode); ``phase_surrogates``
    adds that many Fourier phase-surrogate copies (amplitude spectrum kept
    bit-exact, waveform randomized — forces spectral features; see
    :func:`phase_surrogate`).
    """
    n, t, c = x.shape
    noise = x + rng.normal(0.0, noise_std, x.shape).astype(x.dtype)
    shifts = rng.integers(-max_shift, max_shift + 1, size=n)
    time_idx = (np.arange(t)[None, :] - shifts[:, None]) % t  # roll(+s) == gather(t-s)
    shifted = np.take_along_axis(x, time_idx[:, :, None], axis=1)
    copies_x = [x, noise, shifted]
    copies_y = [y, y, y]
    if mixup:
        partner = np.empty(n, np.int64)
        for cls in np.unique(y):
            members = np.flatnonzero(y == cls)
            partner[members] = rng.choice(members, size=len(members))
        lam = rng.beta(0.4, 0.4, size=n).astype(x.dtype)[:, None, None]
        copies_x.append(lam * x + (1.0 - lam) * x[partner])
        copies_y.append(y)
    if channel_dropout > 0.0:
        keep = (rng.random((n, 1, c)) >= channel_dropout).astype(x.dtype)
        # rescale like inverted dropout so per-window power is preserved
        copies_x.append(x * keep / max(1.0 - channel_dropout, 1e-6))
        copies_y.append(y)
    for _ in range(phase_surrogates):
        copies_x.append(phase_surrogate(x, rng))
        copies_y.append(y)
    return np.concatenate(copies_x, axis=0), np.concatenate(copies_y, axis=0)


def batch_iterator(
    x: np.ndarray,
    y: np.ndarray,
    batch_size: int,
    indices: Optional[np.ndarray] = None,
    drop_last: bool = True,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield static-shape batches; optionally from a sampled index order."""
    idx = indices if indices is not None else np.arange(len(y))
    n_full = len(idx) // batch_size
    for i in range(n_full):
        sel = idx[i * batch_size : (i + 1) * batch_size]
        yield x[sel], y[sel]
    if not drop_last and len(idx) % batch_size:
        sel = idx[n_full * batch_size :]
        yield x[sel], y[sel]


def padded_eval_batches(
    x: np.ndarray, y: np.ndarray, batch_size: int
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Static-shape eval batches with a validity mask (last batch zero-padded),
    so jit sees one shape and metrics stay exact."""
    n = len(y)
    for i in range(0, n, batch_size):
        xb = x[i : i + batch_size]
        yb = y[i : i + batch_size]
        k = len(yb)
        if k < batch_size:
            pad = batch_size - k
            xb = np.concatenate([xb, np.zeros((pad,) + xb.shape[1:], xb.dtype)])
            yb = np.concatenate([yb, np.zeros(pad, yb.dtype)])
        mask = np.arange(batch_size) < k
        yield xb, yb, mask
