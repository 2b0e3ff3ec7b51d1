"""Noise Quality Measure (Damera-Venkata et al. 2000).

Fresh implementation of the same algorithm the reference ports from MATLAB
(Utils/NQM.py:47-173): decompose reference and query images into 5 cosine-log
bandpass bands plus a lowpass, convert to local band contrast, apply
contrast-threshold masking against the CSF, then SNR over the reassembled
thresholded bands.
"""

from __future__ import annotations

import numpy as np
from numpy.fft import fft2, fftshift, ifft2


def _ctf(f_r):
    """Contrast threshold function: 1 / CSF(f), Mannos-Sakrison style fit."""
    f_r = np.asarray(f_r, dtype=np.float64)
    return 1.0 / (200 * (2.6 * (0.0192 + 0.114 * f_r)
                         * np.exp(-(0.114 * f_r) ** 1.1)))


def _cosine_log_band(r: np.ndarray, k: int) -> np.ndarray:
    """k-th cosine-log bandpass filter on radial frequency grid r.

    Band k spans [2^(k-1), 2^(k+1)] with a raised-cosine profile in log2
    frequency; the DC/lowpass band (k=0) uses the shifted (r+2) variant, as in
    the original NQM construction."""
    if k == 0:
        rr = r + 2
        inband = (rr >= 1) & (rr <= 4)
        val = np.where(inband, rr, 4.0)
        return 0.5 * (1 + np.cos(np.pi * np.log2(val) - np.pi))
    lo, hi = 2.0 ** (k - 1), 2.0 ** (k + 1)
    inband = (r >= lo) & (r <= hi)
    # odd bands use fill 4 with a −π phase, even bands fill 0.5 with no
    # phase; both evaluate to exactly 0 outside the band and peak 1 at 2^k
    val = np.where(inband, r, 4.0 if k % 2 == 1 else 0.5)
    phase = -np.pi if k % 2 == 1 else 0.0
    return 0.5 * (1 + np.cos(np.pi * np.log2(val) + phase))


def _masked(c_ref, c_q, a_ref, a_q, band_idx):
    """Contrast masking: where the query band contrast is within the masked
    detection threshold of the reference contrast, substitute the reference
    band (no visible difference)."""
    ci = c_q.copy()
    ci[np.abs(ci) > 1] = 1
    ct = _ctf(band_idx)
    T = ct * (0.86 * ((c_ref / ct) - 1) + 0.3)
    a_out = a_q.copy()
    sub = (np.abs(ci - c_ref) - T) < 0
    a_out[sub] = a_ref[sub]
    return a_out


def _threshold(contrast, thresh, band):
    out = band.copy()
    out[np.abs(contrast) < thresh] = 0.0
    return out


def nqm(image_origin: np.ndarray, image_query: np.ndarray,
        view_angle: float = 1.0) -> float:
    O = np.asarray(image_origin, np.float64)
    I = np.asarray(image_query, np.float64)
    x, y = O.shape
    xp, yp = np.meshgrid(np.arange(-y / 2, y / 2), np.arange(-x / 2, x / 2))
    r = np.abs(xp + 1j * yp)

    FO, FI = fft2(O), fft2(I)
    bands_O, bands_I = [], []
    for k in range(6):
        G = fftshift(_cosine_log_band(r, k))
        bands_O.append(np.real(ifft2(G * FO)))
        bands_I.append(np.real(ifft2(G * FI)))

    l0, lI0 = bands_O[0], bands_I[0]
    # local band contrasts: band / (lowpass + lower bands)
    c_ref, c_q = [], []
    accO, accI = l0.copy(), lI0.copy()
    for k in range(1, 6):
        c_ref.append(bands_O[k] / accO)
        c_q.append(bands_I[k] / accI)
        accO = accO + bands_O[k]
        accI = accI + bands_I[k]

    y1 = np.zeros_like(O)
    y2 = np.zeros_like(O)
    for k in range(1, 6):
        d = _ctf((2.0 ** k) / view_angle)
        ai = _masked(c_ref[k - 1], c_q[k - 1], bands_O[k], bands_I[k], k)
        A = _threshold(c_ref[k - 1], d, bands_O[k])
        AI = _threshold(c_q[k - 1], d, ai)
        y1 += A
        y2 += AI

    sq_err = ((y1 - y2) ** 2).sum()
    sp = (y1 ** 2).sum()
    return float(10 * np.log10(sp / sq_err))
