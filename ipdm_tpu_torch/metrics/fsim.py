"""FSIM — Feature Similarity Index (Zhang, Zhang, Mou & Zhang, 2011),
luminance-only (chromatic=False), matching the conventions of the
reference's piq.fsim call (Utils/train_test_utils.py:802).

Pipeline: [0,255] scaling → F×F non-overlapping average pooling
(F = max(1, round(min(H,W)/256)), piq's avg_pool2d — NOT the MATLAB
conv-'same'-then-[::F], whose window alignment differs by one pixel) →
phase congruency via Kovesi's phasecong2 (4 log-Gabor scales × 4
orientations, minWaveLength 6, mult 2, σ_f 0.55, ΔθOnσ 1.2, noise threshold
k=2 with the /1.7 fudge, lower-median Rayleigh estimate per torch.median) +
zero-padded Scharr gradient magnitude → similarity pooling weighted by max
phase congruency with T1 = 0.85, T2 = 160. Cross-validated against an
independent torch transliteration of the piq algorithm in
tests/piq_oracle.py (tests/test_metric_parity.py).
"""

from __future__ import annotations

import numpy as np
from numpy.fft import fft2, ifft2, ifftshift
from scipy.ndimage import convolve


def _freq_grid(n: int) -> np.ndarray:
    """Kovesi/piq frequency coordinates: odd sizes normalize by (n-1)."""
    if n % 2:
        return np.arange(-(n - 1) / 2, n / 2) / (n - 1)
    return np.arange(-n / 2, n / 2) / n


def _lowpass_filter(rows: int, cols: int, cutoff: float = 0.45,
                    n: int = 15) -> np.ndarray:
    x, y = np.meshgrid(_freq_grid(cols), _freq_grid(rows))
    radius = np.sqrt(x ** 2 + y ** 2)
    return ifftshift(1.0 / (1.0 + (radius / cutoff) ** (2 * n)))


def phase_congruency(im: np.ndarray, nscale: int = 4, norient: int = 4,
                     min_wavelength: float = 6.0, mult: float = 2.0,
                     sigma_onf: float = 0.55, d_theta_on_sigma: float = 1.2,
                     k: float = 2.0, epsilon: float = 1e-4) -> np.ndarray:
    """Kovesi phasecong2 PC map (the variant embedded in FSIM.m)."""
    rows, cols = im.shape
    imagefft = fft2(im)

    x, y = np.meshgrid(_freq_grid(cols), _freq_grid(rows))
    radius = ifftshift(np.sqrt(x ** 2 + y ** 2))
    theta = ifftshift(np.arctan2(-y, x))
    radius[0, 0] = 1.0

    sin_t, cos_t = np.sin(theta), np.cos(theta)
    lp = _lowpass_filter(rows, cols)
    log_gabor = []
    for s in range(nscale):
        wavelength = min_wavelength * mult ** s
        fo = 1.0 / wavelength
        g = np.exp(-(np.log(radius / fo)) ** 2
                   / (2 * np.log(sigma_onf) ** 2)) * lp
        g[0, 0] = 0.0
        log_gabor.append(g)

    theta_sigma = np.pi / norient / d_theta_on_sigma
    energy_all = np.zeros((rows, cols))
    an_all = np.zeros((rows, cols))

    for o in range(norient):
        angl = o * np.pi / norient
        ds = sin_t * np.cos(angl) - cos_t * np.sin(angl)
        dc = cos_t * np.cos(angl) + sin_t * np.sin(angl)
        dtheta = np.abs(np.arctan2(ds, dc))
        spread = np.exp(-dtheta ** 2 / (2 * theta_sigma ** 2))

        sumE = np.zeros((rows, cols))
        sumO = np.zeros((rows, cols))
        sumAn = np.zeros((rows, cols))
        eo = []
        ifft_filters = []
        em_n = 0.0
        for s in range(nscale):
            filt = log_gabor[s] * spread
            ifft_filt = np.real(ifft2(filt)) * np.sqrt(rows * cols)
            ifft_filters.append(ifft_filt)
            e = ifft2(imagefft * filt)
            eo.append(e)
            an = np.abs(e)
            sumAn += an
            sumE += np.real(e)
            sumO += np.imag(e)
            if s == 0:
                em_n = np.sum(filt ** 2)

        x_energy = np.sqrt(sumE ** 2 + sumO ** 2) + epsilon
        mean_e = sumE / x_energy
        mean_o = sumO / x_energy
        energy = np.zeros((rows, cols))
        for s in range(nscale):
            E, O = np.real(eo[s]), np.imag(eo[s])
            energy += E * mean_e + O * mean_o - np.abs(E * mean_o - O * mean_e)

        # noise threshold (Rayleigh model on the smallest-scale response);
        # LOWER median for even counts, matching torch.median in piq
        flat_e2n = np.abs(eo[0].reshape(-1)) ** 2
        median_e2n = np.partition(flat_e2n, (flat_e2n.size - 1) // 2)[
            (flat_e2n.size - 1) // 2]
        mean_e2n = -median_e2n / np.log(0.5)
        noise_power = mean_e2n / em_n
        est_sum_an2 = np.zeros((rows, cols))
        for s in range(nscale):
            est_sum_an2 += ifft_filters[s] ** 2
        est_sum_aiaj = np.zeros((rows, cols))
        for si in range(nscale - 1):
            for sj in range(si + 1, nscale):
                est_sum_aiaj += ifft_filters[si] * ifft_filters[sj]
        est_noise_energy2 = (2 * noise_power * np.sum(est_sum_an2)
                             + 4 * noise_power * np.sum(est_sum_aiaj))
        tau = np.sqrt(est_noise_energy2 / 2)
        est_noise_energy = tau * np.sqrt(np.pi / 2)
        est_noise_sigma = np.sqrt((2 - np.pi / 2) * tau ** 2)
        T = (est_noise_energy + k * est_noise_sigma) / 1.7
        energy = np.maximum(energy - T, 0.0)

        energy_all += energy
        an_all += sumAn

    return energy_all / an_all


_SCHARR_X = np.array([[3, 0, -3], [10, 0, -10], [3, 0, -3]],
                     dtype=np.float64) / 16.0


def _gradient_magnitude(im: np.ndarray) -> np.ndarray:
    # zero padding at the borders, matching piq's F.conv2d(padding=1)
    gx = convolve(im, _SCHARR_X, mode="constant", cval=0.0)
    gy = convolve(im, _SCHARR_X.T, mode="constant", cval=0.0)
    return np.sqrt(gx ** 2 + gy ** 2)


def fsim(x: np.ndarray, y: np.ndarray, data_range: float = 1.0,
         T1: float = 0.85, T2: float = 160.0) -> float:
    """FSIM of distorted y against reference x (grayscale)."""
    x = np.asarray(x, np.float64) / data_range * 255.0
    y = np.asarray(y, np.float64) / data_range * 255.0
    rows, cols = x.shape
    F = max(1, int(round(min(rows, cols) / 256)))
    if F > 1:
        # piq avg_pool2d: non-overlapping F×F block means, floor-truncated
        rt, ct = (rows // F) * F, (cols // F) * F
        x = x[:rt, :ct].reshape(rt // F, F, ct // F, F).mean(axis=(1, 3))
        y = y[:rt, :ct].reshape(rt // F, F, ct // F, F).mean(axis=(1, 3))

    pc1 = phase_congruency(x)
    pc2 = phase_congruency(y)
    g1 = _gradient_magnitude(x)
    g2 = _gradient_magnitude(y)

    pc_sim = (2 * pc1 * pc2 + T1) / (pc1 ** 2 + pc2 ** 2 + T1)
    g_sim = (2 * g1 * g2 + T2) / (g1 ** 2 + g2 ** 2 + T2)
    s = g_sim * pc_sim
    pcm = np.maximum(pc1, pc2)
    return float(np.sum(s * pcm) / np.sum(pcm))
