"""Four-stream LDCT dataset (.npy/.npz) + patch extraction + collate (port
of ipdm_tpu/data/dataset.py).

Host-side numpy re-implementation of the reference Siemens_dataset_npz
(Dataset/npz_data_loader.py:55-201): streams (ld_img, fd_proj, fd_img,
ld_proj) sorted per patient/slice, optional /10 projection scaling when
proj_clip is set, per-image random-crop patches for training, and a collate
that stacks present streams and passes None through for absent ones.

Differences by design:
  * pathlib-based patient/slice parsing (the reference splits on "\\\\" —
    a Windows-only hazard, npz_data_loader.py:119-126);
  * arrays come back NHWC-ready as [H, W, 1] float32 numpy, which the
    engine copies to its device;
  * patch crops use a seeded numpy Generator for reproducibility.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np


def _load_array(file_path: str) -> np.ndarray:
    if file_path.endswith(".npz"):
        return np.load(file_path)["arr_0"]
    return np.load(file_path)


def _listing(root: str, assign=None) -> List[str]:
    files = sorted(glob.glob(os.path.join(root, "*", "*")))
    if assign is not None:
        files = [f for f in files if Path(f).parent.name in assign]
    return files


class SiemensDatasetNpz:
    """Indexable dataset mirroring the reference's stream/ordering semantics."""

    def __init__(self, ldproj_path=None, ldimg_path=None, fdproj_path=None,
                 fdimg_path=None, proj_clip=False, img_clip=True,
                 data_type="siemens", patch: Optional[Sequence[int]] = None,
                 patch_per_image: Optional[int] = None, assign=None,
                 seed: int = 0):
        self.patch = list(patch) if patch is not None else None
        self.patch_per_image = patch_per_image
        self.proj_clip = proj_clip
        self.img_clip = img_clip
        self.data_type = data_type
        self.patient_name: Optional[List[str]] = None
        self.slice_name: Optional[List[str]] = None
        self._rng = np.random.default_rng(seed)

        self.fdimg_file_name = _listing(fdimg_path, assign) if fdimg_path else None
        self.fdproj_file_name = _listing(fdproj_path, assign) if fdproj_path else None
        self.ldimg_file_name = _listing(ldimg_path) if ldimg_path else None
        self.ldproj_file_name = _listing(ldproj_path) if ldproj_path else None
        for files in (self.fdimg_file_name, self.fdproj_file_name,
                      self.ldimg_file_name, self.ldproj_file_name):
            if files is not None:
                self._set_names(files)
                # don't break: reference keeps first non-None (guarded by
                # patient_name None check) — same here via _set_names guard

    def _set_names(self, files: List[str]) -> None:
        if self.patient_name is not None:
            return
        self.patient_name = [Path(f).parent.name for f in files]
        if self.data_type == "siemens":
            self.slice_name = [Path(f).name.split(".")[0] for f in files]
        else:  # mayo: 4th dot-field from the end (npz_data_loader.py:126)
            self.slice_name = [Path(f).name.split(".")[-4]
                               if len(Path(f).name.split(".")) >= 4
                               else Path(f).name.split(".")[0]
                               for f in files]

    def __len__(self) -> int:
        for files in (self.fdimg_file_name, self.fdproj_file_name,
                      self.ldimg_file_name, self.ldproj_file_name):
            if files is not None:
                return len(files)
        return 0

    def _prep(self, arr: np.ndarray, is_proj: bool) -> np.ndarray:
        arr = np.asarray(arr, dtype=np.float32)
        if is_proj and self.proj_clip:
            arr = arr / 10.0
        return arr[..., None]  # [H, W, 1]

    def _maybe_patch(self, arr: np.ndarray) -> np.ndarray:
        """[H,W,1] → [patch_per_image, ph, pw, 1] random crops (training),
        else unchanged (npz_data_loader.py:170-177)."""
        if self.patch is None:
            return arr
        ph, pw = self.patch
        H, W = arr.shape[:2]
        out = np.zeros((self.patch_per_image, ph, pw, 1), np.float32)
        for i in range(self.patch_per_image):
            top = self._rng.integers(0, H - ph + 1) if H > ph else 0
            left = self._rng.integers(0, W - pw + 1) if W > pw else 0
            out[i] = arr[top:top + ph, left:left + pw]
        return out

    def __getitem__(self, idx: int):
        out = [None, None, None, None]
        if self.ldimg_file_name is not None:
            out[0] = self._maybe_patch(
                self._prep(_load_array(self.ldimg_file_name[idx]), False))
        if self.fdproj_file_name is not None:
            out[1] = self._maybe_patch(
                self._prep(_load_array(self.fdproj_file_name[idx]), True))
        if self.fdimg_file_name is not None:
            out[2] = self._maybe_patch(
                self._prep(_load_array(self.fdimg_file_name[idx]), False))
        if self.ldproj_file_name is not None:
            out[3] = self._maybe_patch(
                self._prep(_load_array(self.ldproj_file_name[idx]), True))
        return out

    def get_data_from_name(self, patient_name: str, slice_name: str):
        """Name-keyed lookup (npz_data_loader.py:146-168)."""
        def find(files):
            return next(f for f in files
                        if patient_name in f and slice_name in f)
        out = [None, None, None, None]
        if self.ldimg_file_name:
            out[0] = self._prep(_load_array(find(self.ldimg_file_name)), False)
        if self.fdproj_file_name:
            out[1] = self._prep(_load_array(find(self.fdproj_file_name)), True)
        if self.fdimg_file_name:
            out[2] = self._prep(_load_array(find(self.fdimg_file_name)), False)
        if self.ldproj_file_name:
            out[3] = self._prep(_load_array(find(self.ldproj_file_name)), True)
        return out

    @staticmethod
    def collate(batch):
        """Stack each present stream over the batch; None streams stay None
        (npz_data_loader.py:179-201)."""
        def stack(i):
            items = [b[i] for b in batch]
            if items[0] is None:
                return None
            return np.stack(items, axis=0)
        return tuple(stack(i) for i in range(4))
