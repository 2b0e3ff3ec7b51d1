"""The port's DICOM → μ dataset tool (ipdm_tpu_torch/data/dicom.py)
against the JAX package's (ipdm_tpu/data/dicom.py) with one stub reader
in both on the same arrays: the volumes and every written .npy equal
exactly. Neither SimpleITK nor pydicom is needed: the readers are
replaced."""

import os

import numpy as np
import pytest

from ipdm_tpu.data import dicom as jax_dicom
from ipdm_tpu_torch.data import dicom

RNG = np.random.default_rng(0)
# HU volumes a reader would return: [slices, H, W], one per patient
SERIES = {"P001": RNG.uniform(-1024, 2000, (3, 8, 6)).astype(np.float32),
          "P002": RNG.uniform(-1024, 2000, (2, 8, 6)).astype(np.float32)}


def _stub(dicom_dir):
    return SERIES.get(os.path.basename(dicom_dir))


@pytest.fixture(params=["sitk", "pydicom"])
def stub_readers(request, monkeypatch):
    """The stub as the first reader, or as the fallback behind a first
    reader that finds nothing, in both packages."""
    for mod in (dicom, jax_dicom):
        first, second = ((_stub, lambda d: None) if request.param == "sitk"
                         else (lambda d: None, _stub))
        monkeypatch.setattr(mod, "_read_series_sitk", first)
        monkeypatch.setattr(mod, "_read_series_pydicom", second)
    return request.param


def test_series_to_miu_matches_jax(stub_readers, tmp_path):
    for name, hu in SERIES.items():
        got = dicom.dicom_series_to_miu(str(tmp_path / name))
        want = jax_dicom.dicom_series_to_miu(str(tmp_path / name))
        assert got.dtype == np.float32 and got.shape == hu.shape
        np.testing.assert_array_equal(got, want)
        # +24 HU offset, then HU2miu's own scanner offset: μ_water·(1 +
        # (HU + 48)/1000)
        np.testing.assert_allclose(got, 0.183 * (1 + (hu + 48.0) / 1000),
                                   rtol=1e-6, atol=1e-7)  # f32 rounding


def test_create_miu_dataset_writes_what_jax_writes(stub_readers, tmp_path,
                                                   capsys):
    """Per-slice .npy files under <out>/<patient>/, equal byte for byte in
    content to the JAX tool's; a patient no reader can read is reported
    and counted 0."""
    data = tmp_path / "dicom"
    for name in (*SERIES, "P003"):
        (data / name).mkdir(parents=True)
    outs = {}
    for tag, mod in (("port", dicom), ("jax", jax_dicom)):
        res = mod.create_miu_dataset(str(data), str(tmp_path / tag),
                                     n_workers=2)
        assert res == [("P001", 3), ("P002", 2), ("P003", 0)]
        outs[tag] = tmp_path / tag
    assert "P003" in capsys.readouterr().out
    files = sorted(p.relative_to(outs["jax"])
                   for p in outs["jax"].rglob("*.npy"))
    assert files == sorted(p.relative_to(outs["port"])
                           for p in outs["port"].rglob("*.npy"))
    assert len(files) == 5 and str(files[0]) == "P001/000000.npy"
    for f in files:
        a, b = np.load(outs["port"] / f), np.load(outs["jax"] / f)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_no_reader_raises(monkeypatch, tmp_path):
    """With no reader that returns a series (here: neither library is
    installed, or both find nothing) the port raises as JAX does."""
    for mod in (dicom, jax_dicom):
        monkeypatch.setattr(mod, "_read_series_sitk", lambda d: None)
        monkeypatch.setattr(mod, "_read_series_pydicom", lambda d: None)
        with pytest.raises(RuntimeError, match="install SimpleITK or "
                                               "pydicom"):
            mod.dicom_series_to_miu(str(tmp_path))
