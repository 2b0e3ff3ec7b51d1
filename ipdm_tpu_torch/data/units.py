"""CT unit conversions: display pixel ∈ [0,1] ↔ HU ↔ attenuation μ (port
of ipdm_tpu/data/units.py:20-55).

Same conventions as the reference (Dataset/npz_data_loader.py:9-52):
μ_water = 0.183 cm⁻¹, a +24 HU scanner offset, and a fixed display window
of [-1024, 3072] HU mapped to [0, 1]. The functions take tensors or numpy
arrays (or floats, except ``HU2pixel``, which clips its array).
"""

from __future__ import annotations

MIU_WATER = 0.183
DEFAULT_WINDOW = (-1024.0, 3072.0)
HU_OFFSET = 24.0


def pixel2HU(img, window=None):
    lo, hi = window if window is not None else DEFAULT_WINDOW
    return img * (hi - lo) + lo


def HU2miu(HU):
    return MIU_WATER + ((HU + HU_OFFSET) * MIU_WATER / 1e3)


def miu2HU(miu):
    return (miu - MIU_WATER) * 1e3 / MIU_WATER - HU_OFFSET


def HU2pixel(HU, new_window=None):
    lo, hi = new_window if new_window is not None else DEFAULT_WINDOW
    return ((HU - lo) / (hi - lo)).clip(0.0, 1.0)


def miu2pixel(miu, HU_range=None):
    return HU2pixel(miu2HU(miu), HU_range)


def pixel2miu(pix):
    return HU2miu(pixel2HU(pix))


def reset_window_centre(img, new_window=None, origin_window=None):
    """Re-window a [0, 1] display image from ``origin_window`` (default
    the full display window) to ``new_window`` (default: the same)."""
    if origin_window is None:
        origin_window = DEFAULT_WINDOW
    if new_window is None:
        new_window = origin_window
    HU_ = img * (origin_window[1] - origin_window[0]) + origin_window[0]
    out = (HU_ - new_window[0]) / (new_window[1] - new_window[0])
    return out.clip(0.0, 1.0)
