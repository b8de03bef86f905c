"""Synthetic ECG arrhythmia dataset — stand-in for the private Charité data.

A copy of ``repro/data/ecg.py`` (numpy only): the same seed gives the same
records, bit for bit.

Paper §VI: "16000 samples, with 2 channels and a length of 60000 each",
balanced binary classification (atrial fibrillation vs. normal sinus rhythm).

The generator plants the clinically relevant morphology differences:

* normal sinus rhythm (label 0): regular R-R intervals (small jitter),
  P-wave before each QRS complex, stable baseline.
* atrial fibrillation (label 1): irregularly-irregular R-R intervals
  (high variance), absent P-waves, fibrillatory baseline oscillation
  (4-9 Hz wavelets).

Channel 2 is a scaled, phase-shifted projection of channel 1 with independent
noise (two-lead recording).  All shapes match the paper; the *clinical*
numbers do not transfer (see DESIGN.md §7 honesty ledger).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

FS = 250.0  # Hz sampling rate; 60000 samples = 4 minutes


def _gaussian(t: np.ndarray, mu: float, sigma: float) -> np.ndarray:
    return np.exp(-0.5 * ((t - mu) / sigma) ** 2)


def _one_record(rng: np.random.Generator, length: int, af: bool) -> np.ndarray:
    """Generate one 2-channel record of `length` samples."""
    t = np.arange(length, dtype=np.float32)
    sig = np.zeros(length, dtype=np.float32)

    # --- beat train -------------------------------------------------------
    hr = rng.uniform(55.0, 95.0)  # bpm
    mean_rr = 60.0 / hr * FS      # samples per beat
    pos = rng.uniform(0, mean_rr)
    beat_positions = []
    while pos < length - 40:
        beat_positions.append(pos)
        if af:
            # irregularly irregular: heavy-tailed RR jitter
            rr = mean_rr * rng.uniform(0.55, 1.6)
        else:
            rr = mean_rr * (1.0 + rng.normal(0.0, 0.03))
        pos += max(rr, 0.25 * mean_rr)

    qrs_w = rng.uniform(8.0, 14.0)     # QRS width (samples)
    r_amp = rng.uniform(0.8, 1.3)
    for bp in beat_positions:
        # QRS complex: R spike with small Q/S deflections
        sig += r_amp * _gaussian(t, bp, qrs_w * 0.35)
        sig -= 0.25 * r_amp * _gaussian(t, bp - qrs_w * 0.8, qrs_w * 0.4)
        sig -= 0.3 * r_amp * _gaussian(t, bp + qrs_w * 0.9, qrs_w * 0.45)
        # T wave
        sig += 0.3 * r_amp * _gaussian(t, bp + qrs_w * 4.0, qrs_w * 1.6)
        if not af:
            # P wave precedes QRS only in sinus rhythm
            sig += 0.18 * r_amp * _gaussian(t, bp - qrs_w * 3.0, qrs_w * 1.1)

    # --- baseline ----------------------------------------------------------
    if af:
        # fibrillatory waves: 4-9 Hz narrowband oscillation, drifting phase
        f_fib = rng.uniform(4.0, 9.0) / FS
        phase = np.cumsum(rng.normal(0, 0.05, length)).astype(np.float32)
        sig += 0.12 * np.sin(2 * np.pi * f_fib * t + phase).astype(np.float32)
    # respiration drift + mains-like hum (both classes)
    sig += 0.05 * np.sin(2 * np.pi * 0.25 / FS * t + rng.uniform(0, 6.28))
    sig += rng.normal(0.0, 0.03, length).astype(np.float32)

    ch2 = (rng.uniform(0.5, 0.9) * np.roll(sig, int(rng.uniform(1, 5)))
           + rng.normal(0.0, 0.03, length)).astype(np.float32)
    return np.stack([sig.astype(np.float32), ch2], axis=-1)  # (L, 2)


def make_ecg_dataset(
    seed: int,
    n_samples: int = 16000,
    length: int = 60000,
    decimation: int = 32,
) -> Tuple[np.ndarray, np.ndarray]:
    """Balanced dataset. Returns (x: (N, length//decimation, 2), y: (N,)).

    ``decimation`` reproduces the paper's input downsampling (Fig. 4 shows
    NAS inputs of (1875, 2) = 60000/32 and (3750, 2) = 60000/16).
    Records are generated directly at the decimated length with an
    equivalently scaled sampling rate, which is numerically identical to
    decimating a full-rate record with an ideal low-pass.
    """
    rng = np.random.default_rng(seed)
    dec_len = length // decimation
    x = np.empty((n_samples, dec_len, 2), dtype=np.float32)
    y = np.empty((n_samples,), dtype=np.int32)
    # generate at the decimated rate: scale time constants by 1/decimation
    global FS
    fs_orig = FS
    FS = fs_orig / decimation
    try:
        for i in range(n_samples):
            af = i % 2 == 1  # balanced, deterministic interleave
            x[i] = _one_record(rng, dec_len, af)
            y[i] = int(af)
    finally:
        FS = fs_orig
    # per-record standardization (the usual ECG preprocessing)
    mu = x.mean(axis=1, keepdims=True)
    sd = x.std(axis=1, keepdims=True) + 1e-6
    return (x - mu) / sd, y


def train_val_split(x: np.ndarray, y: np.ndarray, val_frac: float = 0.2,
                    seed: int = 0):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(x))
    n_val = int(len(x) * val_frac)
    va, tr = idx[:n_val], idx[n_val:]
    return (x[tr], y[tr]), (x[va], y[va])
