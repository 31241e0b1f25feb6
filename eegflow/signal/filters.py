"""Zero-phase bandpass filtering on device.

The reference uses ``scipy.signal.butter`` + ``filtfilt`` (4th-order
Butterworth, 1-45 Hz, zero phase; ref 02_preprocessing.py:114-131). Two
jit-able implementations are provided:

* :func:`fft_zero_phase` — the default: multiply the signal's rfft by
  the filter's squared magnitude response ``|H|^2``. filtfilt *is* a zero-phase
  filter with magnitude ``|H|^2``, so the two agree except within an edge
  transient that decays at the slowest-pole rate (~2 s at the 1 Hz band edge,
  fs=500) — negligible for minutes-long recordings, and one rfft/irfft pair is
  massively faster than a 2xT sequential IIR on an accelerator. Documented
  deviation.
* :func:`filtfilt_iir` — exact scipy ``filtfilt`` parity (odd-extension
  padding, ``lfilter_zi`` initial conditions, forward+backward pass) with the
  recursion as a ``lax.scan`` over time, channels vectorized across lanes.
  Used for oracle tests and bit-faithful reproduction runs.

Coefficient design (tiny, host-side, trace-time) uses scipy.signal.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def butter_bandpass(
    lowcut: float, highcut: float, fs: float, order: int = 4
) -> Tuple[np.ndarray, np.ndarray]:
    """Butterworth bandpass (b, a) coefficients (ref 02:125-130)."""
    from scipy.signal import butter

    nyq = 0.5 * fs
    b, a = butter(order, [lowcut / nyq, highcut / nyq], btype="band")
    return np.asarray(b), np.asarray(a)


# ---------------------------------------------------------------------------
# FFT-domain zero-phase filter (north star)
# ---------------------------------------------------------------------------


def _iir_magnitude_sq(b: np.ndarray, a: np.ndarray, n_freqs: int, n_fft: int) -> np.ndarray:
    """|H(e^{j w})|^2 of the IIR filter on the rfft grid of length ``n_fft``."""
    from scipy.signal import freqz

    w = 2.0 * np.pi * np.arange(n_freqs) / n_fft
    _, h = freqz(b, a, worN=w)
    return np.abs(h) ** 2


def _transient_padlen(b: np.ndarray, a: np.ndarray, decay: float = 1e-4) -> int:
    """Samples until the filter's impulse response decays to ``decay``.

    FFT filtering is circular; without padding, edge transients wrap around.
    The slowest pole of a 1 Hz highpass edge at fs=500 has |p| ~ 0.994, giving
    a ~1500-sample tail — so the pad must be pole-aware, not a fixed margin.
    """
    poles = np.roots(a)
    r = float(np.max(np.abs(poles)))
    r = min(r, 1.0 - 1e-9)
    return int(np.ceil(np.log(decay) / np.log(r)))


def fft_zero_phase(x: jnp.ndarray, b: np.ndarray, a: np.ndarray) -> jnp.ndarray:
    """Zero-phase filter along the last axis via rfft x |H|^2 x irfft.

    ``x (..., T)``. The signal is odd-extended (like filtfilt's padtype='odd')
    by the filter's transient length to suppress circular wrap-around, then
    filtered in the frequency domain with the squared magnitude response.
    The gain curve is computed host-side at trace time (static shapes), so
    under jit this is one rfft, one elementwise multiply, one irfft.
    """
    t = x.shape[-1]
    pad = min(t - 1, _transient_padlen(b, a))
    left = 2.0 * x[..., :1] - x[..., pad:0:-1]
    right = 2.0 * x[..., -1:] - x[..., -2 : -pad - 2 : -1]
    ext = jnp.concatenate([left, x, right], axis=-1)
    n = ext.shape[-1]
    gain = jnp.asarray(_iir_magnitude_sq(b, a, n // 2 + 1, n), x.dtype)
    spec = jnp.fft.rfft(ext, axis=-1)
    out = jnp.fft.irfft(spec * gain, n=n, axis=-1).astype(x.dtype)
    return out[..., pad : pad + t]


# ---------------------------------------------------------------------------
# Exact filtfilt (scipy parity)
# ---------------------------------------------------------------------------


def _sos_scan(sos: jnp.ndarray, x: jnp.ndarray, zi: jnp.ndarray) -> jnp.ndarray:
    """Cascaded-biquad IIR along the last axis via one lax.scan.

    ``sos (S, 6)`` second-order sections, ``x (..., T)``, ``zi (S, ..., 2)``
    per-section delay-line state. All S sections advance inside one scan step,
    so time is the only sequential axis; channels/batch ride the VPU lanes.
    Biquads keep the recursion well-conditioned in float32 (the order-8
    direct form is not, with 1 Hz poles at fs=500).
    """
    n_sections = sos.shape[0]

    def step(z, x_t):
        z_new = []
        v = x_t
        for s in range(n_sections):  # static unroll over sections
            b0, b1, b2, a1, a2 = sos[s, 0], sos[s, 1], sos[s, 2], sos[s, 4], sos[s, 5]
            y = b0 * v + z[s, ..., 0]
            z0 = b1 * v - a1 * y + z[s, ..., 1]
            z1 = b2 * v - a2 * y
            z_new.append(jnp.stack([z0, z1], axis=-1))
            v = y
        return jnp.stack(z_new, axis=0), v

    xT = jnp.moveaxis(x, -1, 0)  # (T, ...)
    _, yT = lax.scan(step, zi, xT)
    return jnp.moveaxis(yT, 0, -1)


@functools.partial(jax.jit, static_argnames=("padlen",))
def _filtfilt_core(x, sos, zi_unit, padlen: int):
    # odd extension (scipy padtype='odd')
    left = 2.0 * x[..., :1] - x[..., padlen:0:-1]
    right = 2.0 * x[..., -1:] - x[..., -2 : -padlen - 2 : -1]
    ext = jnp.concatenate([left, x, right], axis=-1)

    def zi_for(first_sample):
        # zi_unit: (S, 2) steady-state unit response; scale by first sample
        return zi_unit[:, None, :] * first_sample[None, ..., None]

    y = _sos_scan(sos, ext, zi_for(ext[..., 0]))
    y_rev = y[..., ::-1]
    y2 = _sos_scan(sos, y_rev, zi_for(y_rev[..., 0]))[..., ::-1]
    return y2[..., padlen : ext.shape[-1] - padlen]


def filtfilt_iir(x: jnp.ndarray, b: np.ndarray, a: np.ndarray) -> jnp.ndarray:
    """scipy.signal.filtfilt-parity zero-phase IIR along the last axis.

    Matches scipy's defaults — odd extension with ``padlen = 3*max(len(a),
    len(b))`` and steady-state (``lfilter_zi``-equivalent) initial conditions
    scaled by the first extended sample on each pass — but runs the recursion
    as a cascade of second-order sections for float32 stability.
    """
    from scipy.signal import sosfilt_zi, tf2sos

    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    padlen = 3 * max(len(a), len(b))
    if x.shape[-1] <= padlen:
        raise ValueError(f"signal length {x.shape[-1]} must exceed padlen {padlen}")
    sos = tf2sos(b, a)
    zi_unit = sosfilt_zi(sos)  # (S, 2)
    dtype = jnp.float32
    return _filtfilt_core(
        jnp.asarray(x, dtype), jnp.asarray(sos, dtype), jnp.asarray(zi_unit, dtype),
        padlen,
    )


def bandpass_filter(
    data: jnp.ndarray,
    lowcut: float,
    highcut: float,
    fs: float,
    order: int = 4,
    method: str = "fft",
) -> jnp.ndarray:
    """Bandpass along the last (time) axis; reference API (ref 02:114-131).

    ``method='fft'`` is the default path; ``method='filtfilt'`` reproduces scipy
    exactly (sequential scan — use for parity runs/tests).
    """
    b, a = butter_bandpass(lowcut, highcut, fs, order)
    if method == "fft":
        return fft_zero_phase(data, b, a)
    return filtfilt_iir(data, b, a)
