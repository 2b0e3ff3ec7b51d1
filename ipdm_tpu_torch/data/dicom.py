"""DICOM → attenuation-map (μ) dataset preparation (port of
ipdm_tpu/data/dicom.py).

Equivalent of the reference offline tool (Utils/dicom2miu.py:43-51): read a
patient's DICOM series, shift by +24 HU (the reference's scanner calibration
offset, dicom2miu.py:30), convert to attenuation coefficients
(``data.units.HU2miu``), and write one .npy per slice under
<out>/<patient>/<index>.npy — the layout ``SiemensDatasetNpz`` reads.

Readers are pluggable and optional, both imported at call time:
SimpleITK first, then pydicom. IO runs in a thread pool (the work is
IO-bound decode and write). Host numpy throughout; no device.
"""

from __future__ import annotations

import os
import os.path as osp
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from ipdm_tpu_torch.data.units import HU2miu


def _read_series_sitk(dicom_dir: str) -> Optional[np.ndarray]:
    try:
        import SimpleITK as sitk
    except ImportError:
        return None
    reader = sitk.ImageSeriesReader()
    names = reader.GetGDCMSeriesFileNames(dicom_dir)
    if not names:
        return None
    reader.SetFileNames(names)
    img = reader.Execute()
    return sitk.GetArrayFromImage(img).astype(np.float32)  # [slices, H, W]


def _read_series_pydicom(dicom_dir: str) -> Optional[np.ndarray]:
    try:
        import pydicom
        from pydicom.errors import InvalidDicomError
    except ImportError:
        return None
    files = sorted(osp.join(dicom_dir, f) for f in os.listdir(dicom_dir)
                   if not f.startswith("."))
    slices = []
    for f in files:
        try:
            ds = pydicom.dcmread(f)
        except InvalidDicomError:
            continue  # a file of the directory that is not DICOM
        arr = ds.pixel_array.astype(np.float32)
        slope = float(getattr(ds, "RescaleSlope", 1.0))
        intercept = float(getattr(ds, "RescaleIntercept", 0.0))
        slices.append((float(getattr(ds, "InstanceNumber", len(slices))),
                       arr * slope + intercept))
    if not slices:
        return None
    slices.sort(key=lambda t: t[0])
    return np.stack([s for _, s in slices])


def dicom_series_to_miu(dicom_dir: str, hu_offset: float = 24.0
                        ) -> np.ndarray:
    """Read a DICOM series → μ volume [slices, H, W] float32."""
    vol = _read_series_sitk(dicom_dir)
    if vol is None:
        vol = _read_series_pydicom(dicom_dir)
    if vol is None:
        raise RuntimeError(
            f"no DICOM reader available or no series in {dicom_dir} "
            "(install SimpleITK or pydicom)")
    return HU2miu(vol + hu_offset).astype(np.float32)


def create_miu_dataset(data_dir: str, out_dir: str,
                       patients: Optional[List[str]] = None,
                       hu_offset: float = 24.0, n_workers: int = 4
                       ) -> List[Tuple[str, int]]:
    """<data_dir>/<patient>/(DICOM series) → <out_dir>/<patient>/<i>.npy μ
    slices (reference create_miu_binary, dicom2miu.py:43-51). Returns
    (patient, n_slices) pairs; a patient whose series cannot be read is
    reported and counted 0 (the reference's tolerant worker loop)."""
    if patients is None:
        patients = sorted(d for d in os.listdir(data_dir)
                          if osp.isdir(osp.join(data_dir, d)))

    def work(patient: str) -> Tuple[str, int]:
        try:
            vol = dicom_series_to_miu(osp.join(data_dir, patient), hu_offset)
        except Exception as e:  # one unreadable patient skips, not stops
            print(f"[dicom2miu] {patient}: {e}")
            return patient, 0
        pdir = osp.join(out_dir, patient)
        os.makedirs(pdir, exist_ok=True)
        for i, sl in enumerate(vol):
            np.save(osp.join(pdir, f"{i:06d}.npy"), sl)
        return patient, len(vol)

    with ThreadPoolExecutor(max_workers=n_workers) as ex:
        return list(ex.map(work, patients))
