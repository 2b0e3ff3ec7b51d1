"""Native image-quality metrics: PSNR/SSIM/FSIM/VIF-p/NQM (no skimage/piq).

Dispatch surface matches the reference metric_calculate
(Utils/train_test_utils.py:789-806)."""

from ipdm_tpu_torch.metrics.fsim import fsim
from ipdm_tpu_torch.metrics.nqm import nqm
from ipdm_tpu_torch.metrics.psnr_ssim import psnr, ssim
from ipdm_tpu_torch.metrics.vif import vif_p

__all__ = ["psnr", "ssim", "fsim", "vif_p", "nqm"]
