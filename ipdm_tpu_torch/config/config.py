"""Config system (port of ipdm_tpu/config/config.py).

Reproduces the reference's flag surface (Config/default_config.py:7-172 in
the reference repo): ~80 flags in four sections, JSON preset overlay where
explicit CLI flags win over the JSON file, recursive merge that warns on
unknown keys, and a runtime mutation API with snapshot restore.

* The config is a plain mutable dataclass, like the argparse Namespace it
  replaces. Field names are identical to the reference flags, so the three
  shipped Mayo-Config JSON presets load unmodified. It reads like a dict
  too (``opt["key"]``, ``opt.get("key")``), which is how the samplers and
  the model builders of this package take their options.
* ``device`` is ``"cuda"`` or ``"cpu"``; a preset's ``"cuda:0"`` is taken
  as it is, and a preset's ``"tpu"`` (the JAX package's) is ignored with a
  warning.
* ``mesh_shape`` ([data, view]) runs the engine over a process group, one
  process per device: ``torchrun --nproc-per-node N main_torch.py
  --mesh_shape N 1 ...`` (``parallel/mesh.py``).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import sys
from dataclasses import dataclass, field
from typing import List, Optional


def _lst(*xs):
    return field(default_factory=lambda: list(xs))


@dataclass
class IPDMConfig:
    # section: train/test cfg  (reference default_config.py:9-57)
    save_freq: int = 10000
    batch_size: int = 4
    test_batch_size: int = 1
    max_epochs: int = 300
    init_lr: float = 2e-4
    test_numbers: int = 50
    mode: str = "train_img"  # train_img/test_img/train_proj/test_proj/test_prog
    run_name: str = "default"
    model_name: str = "IPDM"
    device: str = "cuda"  # 'cuda' | 'cuda:N' | 'cpu'
    convertor: str = "TV"  # FBP | ART | TV (TV == ART with ntv>0)
    load_option_path: Optional[str] = None
    load_img_model_path: Optional[str] = None
    load_proj_model_path: Optional[str] = None
    resume_epochs_proj: int = 0
    resume_epochs_img: int = 0
    display_result: bool = False
    test_result_data_save: bool = False
    benchmark_test: bool = False
    metrics: List[str] = _lst("psnr", "ssim", "fsim", "vif", "nqm")
    fbp_sharpen: bool = False
    ntv: int = 0
    normal: bool = False
    ultra_img_denoise: bool = True

    # section: img model cfg  (reference default_config.py:61-100)
    in_channels_img: int = 1
    out_channels_img: int = 1
    model_channels_img: int = 64
    attention_resolutions_img: List[int] = _lst(16)
    channel_mult_img: List[float] = _lst(1, 1, 2, 2, 4, 4)
    timesteps_img: int = 1000
    partial_timesteps_img: int = 50
    schedule_power_img: float = 1
    clip_img: bool = True
    save_states_img: bool = False
    lambda_ratio_img: float = 5
    t_start_img: Optional[List[int]] = None
    eta_img: float = 0.5
    constant_guidance_img: Optional[float] = None
    kernel_size_img: int = 4
    amplitude_img: float = 20
    ddim_timesteps_img: List[int] = _lst(1, 2, 2)
    sample_method_img: str = "dense"
    save_it_state_img: bool = False

    # section: projection model cfg  (reference default_config.py:103-138)
    in_channels_proj: int = 1
    out_channels_proj: int = 1
    model_channels_proj: int = 64
    attention_resolutions_proj: List[int] = _lst(32)
    channel_mult_proj: List[float] = _lst(1 / 64, 2 / 64, 4 / 64, 2, 2, 4, 4)
    timesteps_proj: int = 1000
    partial_timesteps_proj: int = 50
    schedule_power_proj: float = 1
    clip_proj: bool = False
    lambda_ratio_proj: float = 5
    t_start_proj: Optional[List[int]] = None
    eta_proj: float = 0.4
    constant_guidance_proj: Optional[float] = None
    kernel_size_proj: int = 4
    amplitude_proj: float = 5
    ddim_timesteps_proj: List[int] = _lst(1, 2, 2)
    sample_method_proj: str = "dense"
    save_it_state_proj: bool = False

    # section: dataset cfg  (reference default_config.py:141-157)
    data_type: str = "siemens"
    train_dataset_path_FD_img: Optional[str] = None
    train_dataset_path_LD_img: Optional[str] = None
    train_dataset_path_FD_proj: Optional[str] = None
    train_dataset_path_LD_proj: Optional[str] = None
    test_dataset_path_FD_img: Optional[str] = None
    test_dataset_path_LD_img: Optional[str] = None
    test_dataset_path_FD_proj: Optional[str] = None
    test_dataset_path_LD_proj: Optional[str] = None
    num_workers: int = 4
    patch: Optional[List[int]] = _lst(512, 512)
    patch_per_image: int = 4
    dose: float = 0.25

    # section: extensions (absent in reference)
    geometry: Optional[dict] = None  # FanBeamGeometry field overrides
    #   (nx, ny, dx, dy, nr, dr, offset_r, na, ta_dimx, ta_dimy, ...);
    #   None = the Siemens 512²/2000×912 geometry. The FBP geometry derives
    #   from the same overrides.
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16' UNet activations
    sart_subsets: int = 40  # ordered-subset count for OS-SART (2000 % subsets == 0)
    sart_nstart: int = 10  # outer SART sweeps (reference nstart=10)
    sart_sample_rate: int = 1  # sparse-view ART: keep every k-th view
    #   (recons_torch sample_rate, TASART2DNSL0_PyAPI.cpp:37)
    exact_fbp: bool = False  # force the reference-faithful direct fan BP
    #   instead of the rebinned fast path (recon/fbp.py::fbp_convert)
    exact_art: bool = False  # force the reference-faithful fan-beam
    #   footprint SART instead of the rebinned-parallel OS-SART fast path
    #   (recon/sart.py::sart_reconstruct)
    mesh_shape: Optional[List[int]] = None  # [data, view] process mesh
    #   (torchrun, one process per device); None = one process
    native_loader: bool = True  # C++ prefetching batch loader for training
    #   (native/libipdm_native.so); without the library, or with
    #   ``normal``, the engine reads through data.sampler.DataLoader
    seed: int = 0
    max_iter: int = 0  # derived at runtime (train)
    resume_iter: int = 0  # derived at runtime (train)

    # ---- reference-compatible helpers ------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __getitem__(self, key: str):
        try:
            return getattr(self, key)
        except AttributeError:
            raise KeyError(key) from None

    def get(self, key: str, default=None):
        return getattr(self, key, default)

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, sort_keys=False, indent=4,
                      separators=(",", ": "))

    def merge(self, new_cfg: dict) -> "IPDMConfig":
        """Recursive in-place overlay; warns on unknown keys.

        Mirrors reference cfg_load (default_config.py:176-185)."""
        cfg_load(new_cfg, self.__dict__)
        return self

    def copy(self) -> "IPDMConfig":
        return copy.deepcopy(self)


def cfg_load(new_cfg: dict, old_cfg: dict) -> None:
    """Overlay new_cfg onto old_cfg recursively; unknown keys warn, not
    fail (matches reference default_config.py:176-185 behaviour)."""
    for key, val in new_cfg.items():
        if isinstance(val, dict) and isinstance(old_cfg.get(key), dict):
            cfg_load(val, old_cfg[key])
        elif key == "device" and val == "tpu":
            # a preset written for the JAX package: keep this run's device
            print(f"device 'tpu' in config ignored, keeping "
                  f"{old_cfg.get(key)!r}\n")
        elif key in old_cfg:
            old_cfg[key] = val
        else:
            print(f"no key names {key} in config\n")


def load_option(opt: IPDMConfig, load_path: str, exception: List[str]) -> None:
    """JSON preset overlay with CLI-provided keys excluded (CLI wins).

    Mirrors reference load_option (default_config.py:188-194)."""
    with open(load_path, "r") as f:
        opt_load = json.load(f)
    for key in exception:
        opt_load.pop(key, None)
    cfg_load(opt_load, opt.__dict__)


def _add_field_arg(parser: argparse.ArgumentParser, f: dataclasses.Field) -> None:
    name = "--" + f.name
    default = (f.default_factory() if f.default_factory is not dataclasses.MISSING
               else f.default)
    if isinstance(default, bool):
        parser.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"),
                            default=default)
    elif isinstance(default, list) or f.name in (
            "t_start_img", "t_start_proj", "patch", "mesh_shape", "metrics"):
        elem = str if f.name == "metrics" else float
        if f.name in ("attention_resolutions_img", "attention_resolutions_proj",
                      "ddim_timesteps_img", "ddim_timesteps_proj",
                      "t_start_img", "t_start_proj", "patch", "mesh_shape"):
            elem = int
        parser.add_argument(name, nargs="+", type=elem, default=default)
    elif isinstance(default, int):
        parser.add_argument(name, type=int, default=default)
    elif isinstance(default, float):
        parser.add_argument(name, type=float, default=default)
    else:
        parser.add_argument(name, type=str, default=default)


def default_cfg(argv: Optional[List[str]] = None) -> IPDMConfig:
    """Build config from CLI args with optional JSON preset overlay.

    Precedence matches the reference (default_config.py:158-172): values from
    --load_option_path JSON override defaults, but flags explicitly passed on
    the command line override the JSON."""
    parser = argparse.ArgumentParser(
        "IPDM on CUDA: arguments for training and testing the dual-domain "
        "denoiser")
    for f in dataclasses.fields(IPDMConfig):
        _add_field_arg(parser, f)
    if argv is None:
        argv = sys.argv[1:]
    opt = IPDMConfig(**vars(parser.parse_args(argv)))

    args_input = [item[2:].split("=")[0] for item in argv if item.startswith("--")]
    if opt.load_option_path is not None:
        load_option(opt, opt.load_option_path, args_input)
    return opt
