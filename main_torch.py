"""Entry point of the PyTorch/CUDA port: build the config, run the engine.

    python main_torch.py --mode test_prog \\
        --load_option_path Config/Mayo-Config/test_progressive_option.json

Runs on ``cuda`` (``--device cpu`` for the plain PyTorch path at small
sizes). The twin of ``main.py``. Over N cards, one process per card:

    torchrun --nproc-per-node N main_torch.py --mesh_shape N 1 ...
"""

from ipdm_tpu_torch.config.config import default_cfg
from ipdm_tpu_torch.engine.denoiser import progressive_domain_denoiser

if __name__ == "__main__":
    opt = default_cfg()
    model = progressive_domain_denoiser(opt)
    model.fit()
