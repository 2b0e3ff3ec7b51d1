"""Progressive dual-domain denoiser: the train/test engine (port of
ipdm_tpu/engine/denoiser.py).

``ProgressiveDomainDenoiser(opt).fit()`` with a test mode (``test_prog``,
``test_proj``, ``test_img``) builds the UNets and the convertor the config
names, loads the model checkpoints, and for each test slice runs the
denoisers, scores every kept iteration against the full-dose image on the
host, and writes the reference's artifact layout
(``save_models/option.json``,
``save_test_results/Save_Iter_N/<patient>/<slice>/{metric.json, *.npz}``
and the aggregate ``Save_Iter_N/metric.json``). With a train mode
(``train_img``, ``train_proj``) it trains that domain's UNet (Adam, remat,
``engine/trainer.py``) over the training stream for ``max_iter`` steps,
writes the loss to ``trainSummary/scalars.jsonl`` every 10 steps, and
every ``save_freq`` steps checkpoints the model and the optimizer and runs
``test`` on the trained module.

The stages are plain functions over the options (an ``IPDMConfig`` or a
dict with its key names; a key a dict lacks takes IPDMConfig's default):
:func:`proj_iterations` (guided partial diffusion with the proj UNet,
constant or per-pixel λ), :func:`convert_iterations` (one batched convert
of the kept iterations, FBP or OS-SART), :func:`img_iterations` (guided
partial diffusion with the img UNet, plus the ultra pass), composed by
:func:`progressive_denoiser` for a caller that holds models and a
sinogram. The class runs the same functions and adds the files, the
metrics and the result stores.

Tensors at the engine's boundary are NHWC like the JAX engine's
([B, na, nr, 1] sinograms, [B, n, n, 1] images); the UNets run NCHW
inside, and saved result arrays are NCHW [B, 1, H, W] like the
reference's. With ``display_result`` each test slice also gets the
reference's annotated PNG grid (matplotlib, Agg backend); a
``sample_method_*`` other than "dense" runs that domain's sparse (DDIM)
sampler.
"""

from __future__ import annotations

import copy
import json
import os
import os.path as osp
from datetime import datetime
from typing import List, Optional, Tuple

import numpy as np
import torch

from ipdm_tpu_torch import resolve_device
from ipdm_tpu_torch.config.config import IPDMConfig, cfg_load
from ipdm_tpu_torch.data.dataset import SiemensDatasetNpz
from ipdm_tpu_torch.data.sampler import DataLoader, RandomSampler
from ipdm_tpu_torch.data.units import miu2pixel
from ipdm_tpu_torch.diffusion.diffusion import GaussianDiffusion
from ipdm_tpu_torch.diffusion.guided import (guided_reverse_process,
                                             sparse_guided_reverse_process)
from ipdm_tpu_torch.diffusion.normalize import (yeo_johnson_inverse_transform,
                                                yeo_johnson_transform)
from ipdm_tpu_torch.engine.checkpoint import CheckpointManager
from ipdm_tpu_torch.engine.logging import LoggerX, ScalarWriter
from ipdm_tpu_torch.engine.trainer import (flatten_patches, make_optimizer,
                                           make_train_step, nhwc_to_nchw)
from ipdm_tpu_torch.models.unet import build_unet
from ipdm_tpu_torch.ops.lambda_curve import curve_init, proj_curve_init
from ipdm_tpu_torch.ops.sharpen import tensor_sharpen
from ipdm_tpu_torch.recon.convertor import Convertor
from ipdm_tpu_torch.recon.geometry import SIEMENS
from ipdm_tpu_torch.utils.profiling import PhaseTimer

_DEFAULTS = IPDMConfig()


def _opt(opt, key: str):
    """opt[key]; a dict that lacks the key takes IPDMConfig's default."""
    return opt.get(key, getattr(_DEFAULTS, key))


# the options make_convertor reads
CONVERTOR_KEYS = frozenset(("convertor", "geometry", "sart_nstart", "ntv",
                            "sart_subsets", "sart_sample_rate", "exact_fbp",
                            "exact_art"))


def make_convertor(opt, kind: Optional[str] = None) -> Convertor:
    """The convertor the options name (or ``kind``), on the scanner of
    their ``geometry`` overrides, with the OS-SART settings and the
    ``exact_fbp`` / ``exact_art`` switches (engine init_convertor,
    denoiser.py:284-293)."""
    overrides = _opt(opt, "geometry")
    geom = SIEMENS.replace(**overrides) if overrides else SIEMENS
    return Convertor(kind or opt["convertor"], geom=geom,
                     nstart=_opt(opt, "sart_nstart"), ntv=_opt(opt, "ntv"),
                     nsubsets=_opt(opt, "sart_subsets"),
                     sample_rate=_opt(opt, "sart_sample_rate"),
                     exact_fbp=_opt(opt, "exact_fbp"),
                     exact_art=_opt(opt, "exact_art"))


def diffusion_for(opt, domain: str, device=None) -> GaussianDiffusion:
    """The domain's cosine-schedule diffusion (engine init_*_model)."""
    return GaussianDiffusion(timesteps=opt[f"timesteps_{domain}"],
                             beta_schedule="cosine",
                             schedule_power=opt[f"schedule_power_{domain}"],
                             device=device)


# the sparse sampler's λ ramp (max, min) per domain (denoiser.py:655-660,
# :714-719)
_SPARSE_LAMBDA = {"proj": (0.49, 0.35), "img": (0.5, 0.3)}


def _guided(opt, domain, model, gd, x, generator, curve, **kw):
    """The domain's sampler: the dense guided process, or, for any other
    ``sample_method_*``, the sparse DDIM one (which clips only with
    ``clip_proj`` in the sinogram domain, always in the image domain, and
    leaves the noise class None)."""
    if opt[f"sample_method_{domain}"] != "dense":
        lam_max, lam_min = _SPARSE_LAMBDA[domain]
        return sparse_guided_reverse_process(
            model, gd, x, generator, t_start=opt[f"t_start_{domain}"],
            condition_lambda_max=lam_max, condition_lambda_min=lam_min,
            ddim_timesteps=opt[f"ddim_timesteps_{domain}"],
            eta=opt[f"eta_{domain}"],
            clip_denoised=opt["clip_proj"] if domain == "proj" else True), None
    return guided_reverse_process(
        model, gd, x, generator, t_start=opt[f"t_start_{domain}"],
        clip=opt[f"clip_{domain}"], mode=domain,
        eta=opt[f"eta_{domain}"],
        constant_guidance=opt[f"constant_guidance_{domain}"],
        lambda_ratio=_opt(opt, f"lambda_ratio_{domain}"),
        kernel_size=_opt(opt, f"kernel_size_{domain}"),
        amplitude=_opt(opt, f"amplitude_{domain}"), lambda_curve=curve,
        only_convertor=_opt(opt, "benchmark_test"), **kw)


def _denormalise(result: List[torch.Tensor], trans) -> List[torch.Tensor]:
    """The Yeo-Johnson inverse of every iteration, on the host (scipy)."""
    return [torch.as_tensor(
        yeo_johnson_inverse_transform(r.cpu().numpy(), trans),
        dtype=torch.float32, device=r.device) for r in result]


@torch.inference_mode()
def proj_iterations(opt, model, x, generator: Optional[torch.Generator],
                    device=None, trans=None, gd=None, curve=None
                    ) -> Tuple[List[torch.Tensor], Optional[str]]:
    """Sinogram stage (denoiser.py:637-663). x: NHWC [B, na, nr, 1].
    Returns every kept iteration, NCHW [B, 1, na, nr], and the noise class
    the adaptive schedule chose (None unless ``t_start_proj`` is None).
    ``trans`` is the Yeo-Johnson fit of the input when the options say
    ``normal``: the iterations come back de-normalised."""
    dev = resolve_device(device)
    result, noise_strength = _guided(
        opt, "proj", model, gd or diffusion_for(opt, "proj", dev),
        nhwc_to_nchw(x, dev), generator, curve or proj_curve_init())
    if _opt(opt, "normal") and trans is not None:
        result = _denormalise(result, trans)
    return result, noise_strength


@torch.inference_mode()
def convert_iterations(opt, result: List[torch.Tensor],
                       convertor: Optional[Convertor] = None
                       ) -> List[torch.Tensor]:
    """Kept sinogram iterations (NCHW) → their images, NHWC [B, n, n, 1],
    in one batched convert (denoiser.py:670-682): the convert acts per
    item, so stacking over the batch axis is exact and pays the
    convertor's fixed cost once."""
    if convertor is None:
        convertor = make_convertor(opt)
    G = 10.0 if opt["clip_proj"] else 1.0  # un-scale (/10 load convention)
    B = result[0].shape[0]
    conv = convertor(torch.cat([G * r[:, 0] for r in result], dim=0))
    return [conv[i * B:(i + 1) * B, :, :, None] for i in range(len(result))]


def proj_denoiser(opt, model, x, generator: Optional[torch.Generator],
                  convertor: Optional[Convertor] = None, device=None):
    """Sinogram stage and convert. Returns the image of every kept
    iteration (a list of NHWC [B, n, n, 1], the last one the stage's
    result) and the noise class."""
    result, noise_strength = proj_iterations(opt, model, x, generator,
                                             device=device)
    return convert_iterations(opt, result, convertor), noise_strength


@torch.inference_mode()
def img_iterations(opt, model, x, generator: Optional[torch.Generator],
                   noise_strength: Optional[str] = None, device=None,
                   trans=None, gd=None, curve=None) -> List[torch.Tensor]:
    """Image stage (denoiser.py:694-733), NHWC in, every kept iteration
    out as NCHW [B, 1, n, n]; the input is also the stage's ``ldct`` term,
    and ``noise_strength`` (the sinogram stage's noise class) picks the
    adaptive schedule when ``t_start_img`` is None. With
    ``ultra_img_denoise`` the ultra pass (3×5 steps at λ=0.6, η=0.6)
    follows and its iterations are appended."""
    dev = resolve_device(device)
    xc = nhwc_to_nchw(x, dev)
    gd = gd or diffusion_for(opt, "img", dev)
    result, _ = _guided(opt, "img", model, gd, xc, generator,
                        curve or curve_init(),
                        noise_strength=noise_strength, ldct=xc)
    if _opt(opt, "ultra_img_denoise"):
        ultra, _ = guided_reverse_process(
            model, gd, result[-1], generator, t_start=[5, 5, 5],
            clip=opt["clip_img"], eta=0.6, mode="img",
            constant_guidance=0.6, ldct=xc,
            only_convertor=_opt(opt, "benchmark_test"))
        result = result + ultra
    if _opt(opt, "normal") and trans is not None:
        result = _denormalise(result, trans)
    return result


def img_denoiser(opt, model, x, generator: Optional[torch.Generator],
                 noise_strength: Optional[str] = None,
                 device=None) -> torch.Tensor:
    """Image stage; returns its last iteration, NHWC."""
    return img_iterations(opt, model, x, generator, noise_strength,
                          device=device)[-1].permute(0, 2, 3, 1)


def _sharpen_and_normalise(opt, img: torch.Tensor, sharpen_num: int):
    """Between the stages (denoiser.py:754-760): the FBP sharpen, then
    with ``normal`` the Yeo-Johnson fit of the image stage's input.
    Returns (x NHWC, its fit or None)."""
    if not (opt["convertor"] == "FBP" and _opt(opt, "fbp_sharpen")):
        sharpen_num = -1
    x = tensor_sharpen(img, sharpen_num)
    if not _opt(opt, "normal"):
        return x, None
    x_np, trans = yeo_johnson_transform(x.cpu().numpy())
    return torch.as_tensor(x_np, dtype=torch.float32, device=x.device), trans


def progressive_denoiser(opt, proj_model, img_model, ldproj,
                         generator: Optional[torch.Generator],
                         convertor: Optional[Convertor] = None,
                         sharpen_num: int = 42, device=None) -> torch.Tensor:
    """proj stage → convert → (sharpen) → img stage (denoiser.py:744-765)
    for a caller that holds the models. ldproj: NHWC [B, na, nr, 1]. The
    convertor defaults to the one the options name
    (:func:`make_convertor`). With ``normal`` the sinogram is
    Gaussianised here, as the engine does when it loads a sample. Returns
    the denoised image NHWC [B, n, n, 1] in f32."""
    dev = resolve_device(device)
    trans = None
    if _opt(opt, "normal"):
        x = ldproj.cpu().numpy() if torch.is_tensor(ldproj) else ldproj
        ldproj, trans = yeo_johnson_transform(np.asarray(x, np.float32))
    result, noise_strength = proj_iterations(opt, proj_model, ldproj,
                                             generator, device=dev,
                                             trans=trans)
    img = convert_iterations(opt, result, convertor)[-1]
    x, trans_img = _sharpen_and_normalise(opt, img, sharpen_num)
    return img_iterations(opt, img_model, x, generator, noise_strength,
                          device=dev, trans=trans_img)[-1].permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# The engine class
# ---------------------------------------------------------------------------


class DotDict(dict):
    """Attr-access dict (reference train_test_utils.py:30-43)."""

    __setattr__ = dict.__setitem__
    __delattr__ = dict.__delitem__

    def __getattr__(self, item):
        try:
            value = self[item]
        except KeyError as e:
            raise AttributeError(item) from e
        if isinstance(value, dict) and not isinstance(value, DotDict):
            value = DotDict(value)
        return value


class ResultTempDict(DotDict):
    """Ordered iter_N result store with int indexing
    (reference train_test_utils.py:45-56)."""

    def __getitem__(self, item):
        if isinstance(item, int):
            if item == -1:
                return self[f"iter_{len(self)}"]
            return self[f"iter_{item}"]
        return super().__getitem__(item)


# -- recursive mean/std aggregation (reference train_test_utils.py:59-118) --

def dict_add(d1, d2, d):
    for key in d2.keys():
        if isinstance(d2[key], dict):
            if key not in d1:
                d1[key] = dict()
                d[key] = dict()
            dict_add(d1[key], d2[key], d[key])
        else:
            if key not in d1:
                d1[key] = 0
                d[key] = 0
            d1[key] += d2[key]
            d[key] += 1


def dict_mean(d1, d):
    for key in d1.keys():
        if isinstance(d1[key], dict):
            dict_mean(d1[key], d[key])
        else:
            d1[key] /= d[key]


def dict_value_minus_mean_square(d1, d_mean, d):
    for key in d1.keys():
        if isinstance(d1[key], dict):
            if key not in d:
                d[key] = dict()
            dict_value_minus_mean_square(d1[key], d_mean[key], d[key])
        else:
            if key + "_std" not in d_mean:
                d_mean[key + "_std"] = 0
                d[key + "_std"] = 0
            d_mean[key + "_std"] += (d1[key] - d_mean[key]) ** 2
            d[key + "_std"] += 1


def dict_std(d1, d):
    for key in d1.keys():
        if isinstance(d1[key], dict):
            dict_std(d1[key], d[key])
        else:
            if "std" in key:
                d1[key] = (d1[key] / d[key]) ** 0.5 if d[key] >= 1 else 0
    return d1


def _nchw_numpy(x: torch.Tensor, nhwc: bool = False) -> np.ndarray:
    """A device tensor → host NCHW [B, 1, H, W] numpy (artifact layout)."""
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    return x.float().cpu().numpy()


_MODES = ("train_proj", "train_img", "test_proj", "test_img", "test_prog")
# the result grids' fixed display window: (-160, 240) HU on the [0, 1]
# display scale of [-1024, 3072] HU (denoiser.py:141)
_WINDOW = ((-160 + 1024) / 4096, (240 + 1024) / 4096)


def _pyplot():
    """matplotlib's pyplot on the Agg backend, imported when a result grid
    is drawn; without matplotlib ``display_result`` cannot be honoured,
    so it raises."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "display_result (the PNG result grids) needs matplotlib, which "
            "is not installed: install matplotlib or set display_result "
            "false") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


class ProgressiveDomainDenoiser:
    """The train/test engine. Construct with an IPDMConfig; call .fit()."""

    def __init__(self, opt: IPDMConfig,
                 result_save_path: Optional[str] = None):
        if opt.mode not in _MODES:
            raise ValueError(f"mode {opt.mode!r}: one of {_MODES}")
        self.device = resolve_device(opt.device)
        self.trans_ldproj = None
        self.trans_ldimg = None
        self.opt = opt
        self.opt_temp = copy.deepcopy(opt)
        timestamp = "{0:%Y-%m-%dT%H-%M-%S}".format(datetime.now())
        if result_save_path is None:
            save_root = osp.join(os.getcwd(), "ModelTrainLog",
                                 f"{opt.model_name}_{opt.run_name}", timestamp)
        else:
            save_root = osp.join(result_save_path,
                                 f"{opt.model_name}_{opt.run_name}")
        self.save_root = save_root
        self.logger = LoggerX(save_root, opt)
        self.ckpt = CheckpointManager(self.logger.models_save_dir)
        self.logger.save_option(self.opt)
        self.summer = (ScalarWriter(osp.join(save_root, "trainSummary"))
                       if "train" in opt.mode else None)
        # the samplers' and the train step's noise; the models' initial
        # weights come from the same seed without touching the process's
        # default generators
        self.generator = torch.Generator(device=self.device).manual_seed(
            opt.seed)

        # Section: models per mode (train_test_utils.py:146-168)
        self.proj_model = None
        self.img_model = None
        self.optimizer = None
        self.train_step = None
        self._train_domain = None
        self.train_resume_epochs = 0
        if opt.mode in ("train_proj", "test_proj", "test_prog"):
            self.init_proj_model()
            if opt.mode == "train_proj":
                self._train_domain = "proj"
        self.init_convertor(opt.convertor)
        if opt.mode in ("train_img", "test_img", "test_prog"):
            self.init_img_model()
            if opt.mode == "train_img":
                self._train_domain = "img"
        if self._train_domain is not None:
            self._init_training()
        self.load_model()

        # Section: data
        self.init_data_loader()
        self.fdct = None
        self.fdproj = None
        self.ldct = None
        self.ldct_np = None
        self.ldproj = None
        self.ldproj_np = None

        # Section: result temps
        self.proj_denoise_result = ResultTempDict()
        self.proj_denoise_convert2img_result = ResultTempDict()
        self.img_denoise_result = ResultTempDict()
        self.progressive_denoise_result = ResultTempDict()
        self.noise_strength = None
        # Section: λ curves
        self.img_lambda_curve = curve_init()
        self.proj_lambda_curve = proj_curve_init()
        # Section: metrics
        self.metric_clear()
        self.metric_total = DotDict()
        self.metric_each_sample = []

        self.save_root_path = osp.join(save_root, "save_test_results")
        os.makedirs(self.save_root_path, exist_ok=True)
        # per-phase wall-clock profiling (absent upstream)
        self.timer = PhaseTimer()

    # -- config mutation (train_test_utils.py:202-211) ----------------------

    def update_opt(self, ultra_cfg=None):
        """Merge ``ultra_cfg`` into the options and write option.json
        anew. The convertor is built anew when the update names any
        option it is built from (:data:`CONVERTOR_KEYS`), so the running
        convertor never lags the options."""
        if ultra_cfg is not None:
            cfg_load(ultra_cfg, self.opt.__dict__)
            self.logger.save_option(self.opt)
            if CONVERTOR_KEYS & set(ultra_cfg):
                self.init_convertor(self.opt.convertor)

    def reset_opt(self):
        self.opt = copy.deepcopy(self.opt_temp)

    # -- model/convertor init ----------------------------------------------

    def _build_model(self, domain: str):
        cuda = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=cuda):
            torch.manual_seed(self.opt.seed + (domain == "proj"))
            return build_unet(self.opt, domain, device=self.device).eval()

    def init_img_model(self):
        self.img_model = self._build_model("img")
        self.img_gaussian_diffusion = diffusion_for(self.opt, "img",
                                                    self.device)

    def init_proj_model(self):
        self.proj_model = self._build_model("proj")
        self.proj_gaussian_diffusion = diffusion_for(self.opt, "proj",
                                                     self.device)

    def init_convertor(self, convertor: str):
        self.convertor = make_convertor(self.opt, convertor)

    def _init_training(self):
        """The trained domain's Adam and train step (denoiser.py:295-321).
        The JAX package trains a remat twin of the model with the same
        parameters; here the model itself turns remat on, which
        checkpoints its blocks only when grad is on, so the samplers of
        ``test`` run it as before."""
        opt = self.opt
        domain = self._train_domain
        model = self.proj_model if domain == "proj" else self.img_model
        gd = (self.proj_gaussian_diffusion if domain == "proj"
              else self.img_gaussian_diffusion)
        self.partial_timesteps = opt[f"partial_timesteps_{domain}"]
        self.train_resume_epochs = opt[f"resume_epochs_{domain}"]
        model.remat = True
        self.optimizer = make_optimizer(model.parameters(), opt.init_lr)
        self.train_step = make_train_step(model, gd, self.optimizer,
                                          self.partial_timesteps,
                                          self.generator)

    # -- checkpoints (train_test_utils.py:247-251; loggerx.py:62-80) --------

    def load_model(self):
        """Load ``{img,proj}_model-{resume_epochs}`` from the configured
        directories into the models this mode built; a checkpoint that is
        not there leaves the seeded initial weights. When training resumes,
        the optimizer's state (Adam's moments and step) is loaded from the
        trained domain's directory too (denoiser.py:354-373; the reference
        restores every registered module, loggerx.py:71-80)."""
        opt = self.opt
        if (opt.resume_epochs_img > 0 and opt.load_img_model_path is not None
                and self.img_model is not None):
            self.ckpt.load("img_model", opt.resume_epochs_img,
                           self.img_model, load_dir=opt.load_img_model_path)
        if (opt.resume_epochs_proj > 0
                and opt.load_proj_model_path is not None
                and self.proj_model is not None):
            self.ckpt.load("proj_model", opt.resume_epochs_proj,
                           self.proj_model,
                           load_dir=opt.load_proj_model_path)
        if self.optimizer is not None and self.train_resume_epochs > 0:
            load_dir = opt[f"load_{self._train_domain}_model_path"]
            self.ckpt.load_optimizer("optimizer", self.train_resume_epochs,
                                     self.optimizer, load_dir=load_dir)

    def checkpoints(self, epoch: int):
        """The models this mode holds, and the optimizer when training
        (denoiser.py:375-385)."""
        if self.proj_model is not None:
            self.ckpt.save("proj_model", epoch, self.proj_model)
        if self.img_model is not None:
            self.ckpt.save("img_model", epoch, self.img_model)
        if self.optimizer is not None:
            self.ckpt.save_optimizer("optimizer", epoch, self.optimizer)

    # -- data ---------------------------------------------------------------

    def init_data_loader(self):
        """The test set and, when training, the training stream
        (denoiser.py:438-470): ``max_iter`` = slices · max_epochs //
        batch_size, resumed at ``resume_iter`` = resume_epochs ·
        save_freq // batch_size, one replica."""
        opt = self.opt
        self.train_loader = None
        if "train" in opt.mode:
            train_dataset = SiemensDatasetNpz(
                ldimg_path=opt.train_dataset_path_LD_img,
                fdimg_path=opt.train_dataset_path_FD_img,
                ldproj_path=opt.train_dataset_path_LD_proj,
                fdproj_path=opt.train_dataset_path_FD_proj,
                proj_clip=opt.clip_proj, img_clip=opt.clip_img,
                data_type=opt.data_type, patch=opt.patch,
                patch_per_image=opt.patch_per_image, seed=opt.seed)
            opt.max_iter = len(train_dataset) * opt.max_epochs // opt.batch_size
            opt.resume_iter = (self.train_resume_epochs * opt.save_freq
                               // opt.batch_size)
            sampler = RandomSampler(len(train_dataset),
                                    batch_size=opt.batch_size,
                                    num_iter=opt.max_iter,
                                    restore_iter=opt.resume_iter,
                                    seed=opt.seed)
            self.train_len = len(train_dataset)
            self.train_loader = DataLoader(train_dataset, opt.batch_size,
                                           sampler=sampler,
                                           collate=train_dataset.collate)
        self.test_dataset = SiemensDatasetNpz(
            ldimg_path=opt.test_dataset_path_LD_img,
            fdimg_path=opt.test_dataset_path_FD_img,
            ldproj_path=opt.test_dataset_path_LD_proj,
            fdproj_path=opt.test_dataset_path_FD_proj,
            proj_clip=opt.clip_proj, img_clip=opt.clip_img,
            data_type=opt.data_type, patch=None, patch_per_image=None)

    # -- temp clears (train_test_utils.py:397-419) --------------------------

    def temp_clear(self):
        self.proj_temp_clear()
        self.img_temp_clear()
        self.metric_clear()
        self.noise_strength = None

    def metric_clear(self):
        self.metric_instance = DotDict(LDCT=DotDict(), deProj=DotDict(),
                                       deImg=DotDict(), deProg=DotDict(),
                                       deProj2img=DotDict())

    def proj_temp_clear(self):
        self.proj_denoise_convert2img_result = ResultTempDict()
        self.proj_denoise_result = ResultTempDict()

    def img_temp_clear(self):
        self.img_denoise_result = ResultTempDict()
        self.progressive_denoise_result = ResultTempDict()

    # -- training (train_test_utils.py:253-272, 326-348) --------------------

    def train(self, inputs, n_iter: int, loss_temp):
        """One step on a loader batch (denoiser.py:500-514): the trained
        domain's full-dose stream, patch-flattened, Gaussianised with
        ``normal``. Reads the loss back for the step's log line."""
        opt = self.opt
        images = inputs[1] if opt.mode == "train_proj" else inputs[2]
        images = flatten_patches(np.asarray(images, np.float32))
        if opt.normal:
            images, _ = yeo_johnson_transform(np.maximum(images, 0.0))
        loss = float(self.train_step(images))
        loss_temp[0] += loss
        self.logger.msg({"loss": loss, "lr": opt.init_lr}, n_iter)
        return loss

    def _native_train_iter(self):
        """The native prefetching loader over the training stream
        (denoiser.py:516-558): an iterator of the 4-stream tuples
        :meth:`train` takes, or None where it does not apply (no library,
        ``normal``, ``.npz`` files)."""
        opt = self.opt
        from ipdm_tpu_torch.utils import native
        if not (opt.native_loader and native.available()
                and not opt.normal):
            return None
        ds = self.train_loader.dataset
        files = (ds.fdproj_file_name if opt.mode == "train_proj"
                 else ds.fdimg_file_name)
        if files is None or any(f.endswith(".npz") for f in files[:1]):
            return None
        H, W = np.load(files[0], mmap_mode="r").shape[:2]
        indices = list(iter(self.train_loader.sampler))
        loader = native.NativeLoader(files, H, W, indices,
                                     batch=opt.batch_size)
        stream_idx = 1 if opt.mode == "train_proj" else 2
        scale = 0.1 if (opt.mode == "train_proj" and opt.clip_proj) else 1.0
        rng = np.random.default_rng(opt.seed)

        def gen():
            for arr in loader:            # [b, H, W]
                arr = arr * scale
                if opt.patch:
                    ph, pw = opt.patch
                    ppi = opt.patch_per_image
                    out = np.empty((arr.shape[0], ppi, ph, pw, 1),
                                   np.float32)
                    for b in range(arr.shape[0]):
                        for k in range(ppi):
                            top = rng.integers(0, max(H - ph, 0) + 1)
                            left = rng.integers(0, max(W - pw, 0) + 1)
                            out[b, k, :, :, 0] = arr[b, top:top + ph,
                                                     left:left + pw]
                else:
                    out = arr[..., None]
                item = [None, None, None, None]
                item[stream_idx] = out
                yield tuple(item)
            loader.close()

        return gen()

    # -- run ----------------------------------------------------------------

    def fit(self):
        """Train (steps resume_iter + 1 .. max_iter; the mean loss of
        every 10 steps to ``train/loss``; every ``save_freq`` steps the
        checkpoints of iteration n // save_freq and, with test_numbers > 0,
        :meth:`test` on the trained module; denoiser.py:561-580), or
        test."""
        opt = self.opt
        if "train" not in opt.mode:
            self.test(0)
            return
        loader = self._native_train_iter()
        if loader is None:
            loader = iter(self.train_loader)
        loss_temp = [0.0]
        for n_iter in range(opt.resume_iter + 1, opt.max_iter + 1):
            self.train(next(loader), n_iter, loss_temp)
            if n_iter % 10 == 0:
                self.summer.add_scalar("train/loss", loss_temp[0] / 10,
                                       n_iter // 10)
                loss_temp = [0.0]
            if n_iter % opt.save_freq == 0:
                it = n_iter // opt.save_freq
                self.checkpoints(it)
                if opt.test_numbers > 0:
                    self.test(it)

    # -- evaluation (train_test_utils.py:274-324) ----------------------------

    def test(self, epoch: int):
        """Denoise and score ``test_numbers`` seeded test slices (all of
        them at ≤ 0). After training the module under test is the trained
        one itself (the JAX engine copies its trained parameters over,
        denoiser.py:585-590). A train mode tests its own domain and writes
        the PSNR / SSIM means to the scalar stream."""
        opt = self.opt
        if opt.test_numbers <= 0:
            opt.test_numbers = len(self.test_dataset)
        np.random.seed(9527)  # the reference's fixed eval-sample seed
        random_test_id = np.sort(np.random.choice(
            len(self.test_dataset), opt.test_numbers, replace=False))
        self.metric_each_sample = []
        only_metric = not opt.display_result
        for idx in range(opt.test_numbers):
            tid = int(random_test_id[idx])
            with self.timer.phase("load"):
                ld_img, fd_proj, fd_img, ld_proj = self.test_dataset[tid]
                ld_img = None if ld_img is None else ld_img[None]
                fd_img = None if fd_img is None else fd_img[None]
                ld_proj = None if ld_proj is None else ld_proj[None]
                self.temp_clear()
                self.save_path_load(epoch,
                                    self.test_dataset.patient_name[tid],
                                    self.test_dataset.slice_name[tid])
                self.data_sample_load(ldct=ld_img, ldproj=ld_proj,
                                      fdproj=fd_proj, fdct=fd_img)
            if opt.mode in ("train_proj", "test_proj"):
                self.proj_denoiser(self.ldproj)
                figure_mode = "dproj2img"
            elif opt.mode in ("train_img", "test_img"):
                self.img_denoiser(self.ldct, mode="img_only")
                figure_mode = "dimg"
            else:
                self.progressive_denoiser()
                figure_mode = "progressive"
            with self.timer.phase("metrics"):
                self.result_figure_save(mode=figure_mode, display=False,
                                        only_metric=only_metric)
            with self.timer.phase("save"):
                self.result_data_save(data_save=opt.test_result_data_save)
            self.metric_update()
        self.metric_total_save(epoch)
        if self.timer.totals:
            print("[phases]", self.timer.report())
        if self.summer is not None:
            for key, vals in self.metric_total.items():
                if vals:
                    for name in ("psnr", "ssim"):
                        self.summer.add_scalars(
                            f"{key}/{name}",
                            {k: v for k, v in vals.items() if name in k},
                            epoch)

    # -- denoisers (train_test_utils.py:421-567) ----------------------------

    def proj_denoiser(self, x, convert=True, save_state=True,
                      save_proj_state=False, return_idx=-1):
        """x: NHWC [B, na, nr, 1]. Returns (image NHWC or proj NHWC,
        noise_strength) like the reference (train_test_utils.py:421-480);
        with ``save_state`` every kept iteration goes to the result
        stores, else only the returned one."""
        opt = self.opt
        result, self.noise_strength = proj_iterations(
            opt, self.proj_model, x, self.generator, device=self.device,
            trans=self.trans_ldproj, gd=self.proj_gaussian_diffusion,
            curve=self.proj_lambda_curve)
        self.proj_temp_clear()
        if save_proj_state:
            for i, r in enumerate(result):
                self.proj_denoise_result[f"iter_{i + 1}"] = _nchw_numpy(r)
        chosen = result[return_idx]
        if not save_state:
            result = [chosen]
        if convert:
            imgs = convert_iterations(opt, result, self.convertor)
            for i, img in enumerate(imgs):
                self.proj_denoise_convert2img_result[f"iter_{i + 1}"] = \
                    _nchw_numpy(img, nhwc=True)
            return imgs[-1], self.noise_strength
        for i, r in enumerate(result):
            self.proj_denoise_result[f"iter_{i + 1}"] = _nchw_numpy(r)
        return chosen.permute(0, 2, 3, 1), self.noise_strength

    def img_denoiser(self, x, return_idx=-1, noise_strength=None,
                     mode="progressive", save_state=True):
        """x: NHWC [B, H, W, 1] (train_test_utils.py:482-550). Returns the
        ``return_idx`` iteration, NHWC; the store is the progressive one
        or, for any other ``mode``, the image-only one."""
        result = img_iterations(
            self.opt, self.img_model, x, self.generator, noise_strength,
            device=self.device, trans=self.trans_ldimg,
            gd=self.img_gaussian_diffusion, curve=self.img_lambda_curve)
        self.img_temp_clear()
        store = (self.progressive_denoise_result if mode == "progressive"
                 else self.img_denoise_result)
        if save_state:
            for i, r in enumerate(result):
                store[f"iter_{i + 1}"] = _nchw_numpy(r)
        else:
            store["iter_1"] = _nchw_numpy(result[return_idx])
        return result[return_idx].permute(0, 2, 3, 1)

    def progressive_denoiser(self, save_proj_state=False, convert=True,
                             sharpen_num=42):
        """proj stage → (sharpen) → img stage
        (train_test_utils.py:552-567)."""
        opt = self.opt
        with self.timer.phase("proj_stage+convert"):
            result, n_s = self.proj_denoiser(
                self.ldproj, save_state=opt.save_it_state_proj,
                save_proj_state=save_proj_state, convert=convert)
        x, trans = _sharpen_and_normalise(opt, result, sharpen_num)
        if trans is not None:
            self.trans_ldimg = trans
        with self.timer.phase("img_stage"):
            return self.img_denoiser(x, noise_strength=n_s,
                                     save_state=opt.save_it_state_img)

    # -- sample staging (train_test_utils.py:569-594) ------------------------

    def _stage(self, arr: np.ndarray):
        """A host sample → (device tensor, its Yeo-Johnson fit or None)."""
        trans = None
        if self.opt.normal:
            arr, trans = yeo_johnson_transform(arr)
        return (torch.as_tensor(arr, dtype=torch.float32,
                                device=self.device), trans)

    def data_sample_load(self, ldct=None, ldproj=None, fdproj=None,
                         fdct=None):
        """All inputs host NHWC numpy: ldct/fdct [1,512,512,1] μ maps,
        ldproj/fdproj [1,2000,912,1] sinograms."""
        if ldct is not None:
            ldct = np.asarray(ldct, np.float32)
            self.ldct, self.trans_ldimg = self._stage(ldct)
            self.ldct_np = miu2pixel(np.squeeze(ldct))
        if ldproj is not None:
            ldproj = np.asarray(ldproj, np.float32)
            self.ldproj, self.trans_ldproj = self._stage(ldproj)
            self.ldproj_np = np.squeeze(ldproj)
        if fdct is not None:
            self.fdct = np.squeeze(miu2pixel(np.asarray(fdct, np.float32)))
        if fdproj is not None:
            self.fdproj = np.squeeze(np.asarray(fdproj, np.float32))

    # -- artifacts (train_test_utils.py:596-828) -----------------------------

    def save_path_load(self, epoch, patient_name, slice_name):
        self.save_path = osp.join(self.save_root_path, f"Save_Iter_{epoch}",
                                  str(patient_name), str(slice_name))
        os.makedirs(self.save_path, exist_ok=True)

    def result_figure_save(self, mode="progressive", display=True,
                           only_metric=False):
        """The metrics of every stored iteration against the full-dose
        image and, unless ``only_metric``, the reference's annotated PNG
        grid of the mode (denoiser.py:801-905): "progressive"
        (``progressive.png``: LDCT and the converted proj iterations over
        FDCT and the image iterations, last first), "dimg" / "dproj2img"
        (``deImg.png`` / ``deProj2img.png``: LDCT, FDCT, the iterations,
        last first), each shown in the fixed (-160, 240) HU window with
        its PSNR / SSIM; "dproj" (``dProj.png``, always drawn, no
        metrics): |FD − LD| and |iteration − FD| of the sinograms. The
        metrics do not depend on ``only_metric``."""
        if mode not in ("progressive", "dimg", "dproj", "dproj2img"):
            raise ValueError('mode should be one of: "progressive", '
                             '"dimg", "dproj", "dproj2img"')
        plt = None
        if not only_metric or mode == "dproj":
            plt = _pyplot()

        if mode == "dproj":
            delta_target = np.abs(self.fdproj - self.ldproj_np)
            n = len(self.proj_denoise_result)
            fig, ax = plt.subplots(1, 1 + n, figsize=(30, 30))
            vmin, vmax = delta_target.min(), delta_target.max()
            ax[0].set_title("res target", fontsize=35, y=1.02)
            ax[0].set_xticks([]), ax[0].set_yticks([])
            ax[0].imshow(delta_target, "inferno", vmin=vmin, vmax=vmax)
            for i in range(n):
                dp = np.abs(self.proj_denoise_result[f"iter_{i + 1}"][0, 0]
                            - self.fdproj)
                ax[i + 1].set_title(f"deProj iter{i + 1}", fontsize=35,
                                    y=1.02)
                ax[i + 1].set_xticks([]), ax[i + 1].set_yticks([])
                ax[i + 1].imshow(dp, "inferno", vmin=vmin, vmax=vmax)
            plt.savefig(self.save_path + "/dProj.png", dpi=100)
            if not display:
                plt.close(fig)
            return

        # the three image-grid modes share structure
        store, metric_mode, fname, title = {
            "dproj2img": (self.proj_denoise_convert2img_result, "deProj2img",
                          "deProj2img.png", "Proj"),
            "dimg": (self.img_denoise_result, "deImg", "deImg.png", "Img"),
            "progressive": (self.progressive_denoise_result, "deProg",
                            "progressive.png", "Img"),
        }[mode]
        self.metric_calculate(mode="LDCT", it=0, denoise_result=self.ldct_np)
        if mode == "progressive":
            for i in range(1, len(self.proj_denoise_convert2img_result) + 1):
                dr = miu2pixel(
                    self.proj_denoise_convert2img_result[f"iter_{i}"][0, 0])
                self.metric_calculate(mode="deProj", it=i, denoise_result=dr)
        img_its = len(store)
        results = {}
        for i in range(1, img_its + 1):
            dr = miu2pixel(store[f"iter_{i}"][0, 0])
            self.metric_calculate(mode=metric_mode, it=i, denoise_result=dr)
            results[i] = dr
        if only_metric:
            return
        w0, w1 = _WINDOW

        def show(a, img, ttl, s=None):
            a.set_title(ttl, fontsize=35, y=1.02)
            if s is not None:
                a.text(x=0.5, y=-0.12, s=s, fontsize=25,
                       horizontalalignment="center", transform=a.transAxes)
            a.set_xticks([]), a.set_yticks([])
            a.imshow(img, "gray", vmin=w0, vmax=w1)

        mi = self.metric_instance

        def scores(key, it):
            return "PSNR={:.2f} , SSIM={:.2f}".format(
                mi[key].get(f"psnr_iter_{it}", float("nan")),
                mi[key].get(f"ssim_iter_{it}", float("nan")))

        if mode == "progressive":
            n_proj = len(self.proj_denoise_convert2img_result)
            ncols = 1 + max(img_its, n_proj)
            fig, ax = plt.subplots(2, ncols, figsize=(7 * ncols, 16))
            show(ax[0, 0], self.ldct_np, "LDCT", scores("LDCT", 0))
            for i in range(1, n_proj + 1):
                dr = miu2pixel(
                    self.proj_denoise_convert2img_result[f"iter_{i}"][0, 0])
                show(ax[0, i], dr, f"Proj iter{i}", scores("deProj", i))
            for i in range(1, img_its + 1):
                r_it = img_its + 1 - i
                show(ax[1, i], results[r_it], f"Img iter{r_it}",
                     scores(metric_mode, r_it))
            show(ax[1, 0], self.fdct, "FDCT")
        else:
            fig, ax = plt.subplots(1, 2 + img_its,
                                   figsize=(7 * (2 + img_its), 7))
            show(ax[0], self.ldct_np, "LDCT", scores("LDCT", 0))
            show(ax[1], self.fdct, "FDCT")
            for i in range(1, img_its + 1):
                r_it = img_its + 1 - i
                show(ax[i + 1], results[r_it], f"{title} iter{r_it}",
                     scores(metric_mode, r_it))
        plt.savefig(osp.join(self.save_path, fname),
                    dpi=100 if mode == "progressive" else 200)
        if not display:
            plt.close(fig)

    def result_data_save(self, data_save=True):
        os.makedirs(self.save_path, exist_ok=True)
        if data_save:
            for ftype, fdata in zip(
                    ["prog_denoise_result", "proj_denoise_result",
                     "img_denoise_result", "proj_denoise_result_2img"],
                    [self.progressive_denoise_result,
                     self.proj_denoise_result, self.img_denoise_result,
                     self.proj_denoise_convert2img_result]):
                if len(fdata) > 0:
                    np.savez_compressed(
                        osp.join(self.save_path, f"{ftype}.npz"), **fdata)
        with open(osp.join(self.save_path, "metric.json"), "w") as f:
            f.write(json.dumps(self.metric_instance, sort_keys=False,
                               indent=4, separators=(",", ": ")))

    # -- metrics (train_test_utils.py:789-828) -------------------------------

    def metric_calculate(self, mode="LDCT", **kwargs):
        from ipdm_tpu_torch.metrics import fsim, nqm, psnr, ssim, vif_p
        i = kwargs["it"]
        ld = np.array(kwargs["denoise_result"], np.float64)
        ld[np.isnan(ld)] = 0.5  # NaN guard (train_test_utils.py:792)
        fd = np.asarray(self.fdct, np.float64)
        mi = self.metric_instance[mode]
        if "psnr" in self.opt.metrics:
            mi[f"psnr_iter_{i}"] = float(psnr(fd, ld, data_range=1))
        if "ssim" in self.opt.metrics:
            mi[f"ssim_iter_{i}"] = float(ssim(fd, ld, win_size=11,
                                              data_range=1))
        if "fsim" in self.opt.metrics:
            mi[f"fsim_iter_{i}"] = float(fsim(fd, ld, data_range=1))
        if "vif" in self.opt.metrics:
            mi[f"vif_iter_{i}"] = float(vif_p(fd, ld, data_range=1))
        if "nqm" in self.opt.metrics:
            mi[f"nqm_iter_{i}"] = float(nqm(fd, ld))

    def metric_update(self):
        self.metric_each_sample.append(self.metric_instance)

    def metric_total_save(self, epoch):
        d = DotDict()
        metric_mean = DotDict()
        for m in self.metric_each_sample:
            dict_add(metric_mean, m, d)
        dict_mean(metric_mean, d)
        d = DotDict()
        for m in self.metric_each_sample:
            dict_value_minus_mean_square(m, metric_mean, d)
        dict_std(metric_mean, d)
        self.metric_total = metric_mean
        print(self.metric_total)
        out_dir = osp.join(self.save_root_path, f"Save_Iter_{epoch}")
        os.makedirs(out_dir, exist_ok=True)
        with open(osp.join(out_dir, "metric.json"), "w") as f:
            f.write(json.dumps(self.metric_total, sort_keys=False, indent=4,
                               separators=(",", ": ")))


# reference-compatible alias (main.py uses the snake_case name)
progressive_domain_denoiser = ProgressiveDomainDenoiser
