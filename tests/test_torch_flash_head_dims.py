"""The flash kernels' head dimensions against the UNets the repo ships.

* Every attention block that sends its tokens to the flash kernels
  (T >= FLASH_MIN_SEQ) in every architecture the repo ships, at 64², 128²,
  256² and 512² (the SIEMENS scanner's 2000×912 sinograms in the proj
  domain), has a head dimension the kernels are instantiated for
  (``ops/cuda/attention.py`` FLASH_HEAD_DIMS): the three Mayo presets,
  ``examples/synthetic_e2e_torch.py``'s FULL_ARCH and SMALL_ARCH (the
  ablation studies' UNets, ``examples/ablations.py:245-248``) and
  ``__graft_entry__.py``'s flagship-small UNet. The walk of
  ``UNetModel.plan()`` is held to the blocks a real forward reaches.
* The port's AttentionBlock at head dimensions 8 and 16 and T = 4096 and
  4097 (the flash route; on the CPU its plain formula) against the Flax
  block, weights carried across through ``state_dict_from_flax``."""

import json
import math
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples.synthetic_e2e_torch import FULL_ARCH, SMALL_ARCH, make_geom
from ipdm_tpu.models.unet import AttentionBlock as FlaxAttention
from ipdm_tpu.models.unet import UNetModel as FlaxUNet
from ipdm_tpu_torch.models import unet
from ipdm_tpu_torch.models.unet import AttentionBlock, UNetModel, build_unet
from ipdm_tpu_torch.ops.cuda import attention
from ipdm_tpu_torch.utils.torch_import import state_dict_from_flax

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
PRESETS = ("test_progressive_option", "train_img_option",
           "train_proj_option")
# __graft_entry__.py:21-23
FLAGSHIP_SMALL = dict(in_channels=1, model_channels=16, out_channels=1,
                      num_res_blocks=2, attention_resolutions=(16,),
                      channel_mult=(1, 1, 2, 2, 4, 4))
SIZES = (64, 128, 256, 512)


def _models():
    """(name, domain, UNetModel on the meta device) of every shipped
    architecture."""
    out = []
    for name in PRESETS:
        with open(osp.join(ROOT, "Config", "Mayo-Config",
                           f"{name}.json")) as f:
            opt = json.load(f)
        for domain in ("img", "proj"):
            out.append((name, domain, build_unet(opt, domain,
                                                 device="meta")))
    for name, arch in (("FULL_ARCH", FULL_ARCH), ("SMALL_ARCH", SMALL_ARCH)):
        opt = dict(arch, in_channels_img=1, out_channels_img=1,
                   in_channels_proj=1, out_channels_proj=1)
        for domain in ("img", "proj"):
            out.append((name, domain, build_unet(opt, domain,
                                                 device="meta")))
    # the flagship-small UNet on images and on full sinograms (head dim
    # 16 at ds 16: 125·57 = 7125 tokens)
    for domain in ("img", "proj"):
        out.append(("flagship-small", domain,
                    UNetModel(**FLAGSHIP_SMALL, device="meta")))
    return out


def _input_hw(domain, size):
    """The UNet's input rows and columns: the image, or the sinogram of
    make_geom(size) (views × detectors)."""
    if domain == "img":
        return size, size
    g = make_geom(size)
    return g.na, g.nr


def attention_blocks(model, H, W):
    """(ds, T, head dim) of every attention block of ``model`` on an
    H × W input, from its plan: each Downsample halves the rows and
    columns rounding up, down and up levels carry attention where their
    ds is in attention_resolutions, the middle block always."""
    down, middle, up, _ = model.plan()
    sizes = {1: (H, W)}
    ds, out = 1, []
    for e in down:
        if e[0] == "res" and e[3]:
            out.append((ds, e[2]))
        elif e[0] == "down":
            h, w = sizes[ds]
            ds *= 2
            sizes[ds] = (-(-h // 2), -(-w // 2))
    out.append((ds, middle))
    for e in up:
        if e[3]:
            out.append((ds, e[2]))
        if e[4]:
            ds //= 2
    return [(d, sizes[d][0] * sizes[d][1], ch // model.num_heads)
            for d, ch in out]


def test_every_flash_attention_block_has_a_kernel_head_dim():
    """The fault this guards: the kernels once took head dim 64 alone, and
    the ablation UNets' middle block (head dim 8) at 128² and 500×228
    tokens raised on the card. A kernel set without FLASH_HEAD_DIMS is
    the head-dim-64 set."""
    dims = getattr(attention, "FLASH_HEAD_DIMS", (attention.HEAD_DIM,))
    flash, missing = set(), []
    for name, domain, model in _models():
        for size in SIZES:
            for ds, T, hd in attention_blocks(model,
                                              *_input_hw(domain, size)):
                if T < attention.FLASH_MIN_SEQ:
                    continue
                flash.add(hd)
                if hd not in dims:
                    missing.append((name, domain, size, ds, T, hd))
    assert not missing, missing
    # the sweep reaches 64 (presets), 8 (SMALL_ARCH) and 16
    # (flagship-small on sinograms)
    assert {8, 16, 64} <= flash, flash


def test_plan_walk_matches_a_forward():
    """attention_blocks agrees with the (T, head dim) of each attention
    block a real CPU forward reaches, in order, on a small UNet with
    attention at two levels and an odd input size."""
    torch.manual_seed(0)
    model = UNetModel(in_channels=1, model_channels=8, out_channels=1,
                      num_res_blocks=1, attention_resolutions=(2, 4),
                      channel_mult=(1, 1, 2, 2), device="cpu").eval()
    seen = []
    fwd = AttentionBlock.forward

    def record(self, x):
        seen.append((x.shape[2] * x.shape[3],
                     x.shape[1] // self.num_heads))
        return fwd(self, x)

    AttentionBlock.forward = record
    try:
        with torch.no_grad():
            model(torch.zeros(1, 1, 13, 22), torch.zeros(1,
                                                         dtype=torch.long))
    finally:
        AttentionBlock.forward = fwd
    assert seen == [(T, hd) for _, T, hd in attention_blocks(model, 13, 22)]


def test_kernel_head_dims_are_one_set():
    """The C entry points' switches (csrc/hopper.cuh IPDM_FLASH_HEAD_DIMS)
    instantiate the set that _build.FLASH_HEAD_DIMS names, which
    attention.py checks against and whose every member has a launch
    counter for each flash kernel."""
    import re

    from ipdm_tpu_torch.ops.cuda import _build

    with open(osp.join(ROOT, "ipdm_tpu_torch", "csrc", "hopper.cuh")) as f:
        line = re.search(r"#define IPDM_FLASH_HEAD_DIMS\(X\)(.*)",
                         f.read()).group(1)
    assert tuple(int(h) for h in re.findall(r"X\((\d+)\)", line)) == \
        _build.FLASH_HEAD_DIMS
    assert attention.FLASH_HEAD_DIMS is _build.FLASH_HEAD_DIMS
    for name in _build.FLASH_KERNELS:
        for hd in _build.FLASH_HEAD_DIMS:
            assert _build.LAUNCHES[_build.flash_counter(name, hd)] >= 0


def test_head_dims_outside_the_set_raise_on_cuda_tensors():
    """A head dim the kernels lack raises before any launch, naming the
    set (checked on a CUDA-typed shape through _check_cuda's message:
    the CPU has no CUDA tensors, so the check is called with a stand-in
    that reports cuda)."""
    class Fake:
        device = torch.device("cuda")
        shape = (4, 4096, 12)

        def dim(self):
            return 3
    with pytest.raises(ValueError, match=r"\(8, 16, 32, 64\)"):
        attention._check_cuda("flash_attention", Fake())
    for hd in attention.FLASH_HEAD_DIMS:
        Fake.shape = (4, 4096, hd)
        attention._check_cuda("flash_attention", Fake())


def _block_vs_flax(hd, H, W, seed):
    """The middle AttentionBlock (4 heads of head dim ``hd``) of a
    one-level UNet in both packages on the same NHWC input (B = 1): the
    Flax UNet's parameters drawn N(0, 0.3) and carried to the port's UNet
    by state_dict_from_flax, then each package's block alone on the
    input."""
    C = 4 * hd
    cfg = dict(in_channels=1, model_channels=C // 2, out_channels=1,
               num_res_blocks=1, attention_resolutions=(),
               channel_mult=(1, 2), num_heads=4)
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(FlaxUNet(**cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 8, 1)),
                            jnp.zeros((1,), jnp.int32))
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 0.3, s.shape).astype(np.float32), shapes)
    model = UNetModel(**cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(model, params))
    blk = model.middle_block[1]
    assert isinstance(blk, AttentionBlock) and blk.num_heads == 4
    x = rng.normal(0, 1, (1, H, W, C)).astype(np.float32)
    want = np.asarray(FlaxAttention(C, 4).apply(
        {"params": params["params"]["mid_attn"]}, jnp.asarray(x)))
    with torch.no_grad():
        got = blk(torch.from_numpy(x).permute(0, 3, 1, 2))
    return got.permute(0, 2, 3, 1).numpy(), want


@pytest.mark.parametrize("hd", [8, 16])
@pytest.mark.parametrize("H,W", [(64, 64), (17, 241)],
                         ids=["T4096", "T4097"])
def test_attention_block_at_small_head_dims_matches_flax(hd, H, W):
    """4 heads of head dim ``hd`` at T = 4096 and 4097 (17·241: a ragged
    last 64-key tile): the flash route, on the CPU the plain formula,
    f32, against the Flax block (the einsum path of unet.py:655-662 off
    the TPU) to f32 rounding of sums over T keys: 1e-4 relative, 1e-5
    absolute."""
    assert H * W >= attention.FLASH_MIN_SEQ
    calls = []
    flash = unet.flash_attention

    def spy(q, k, v, scale):
        calls.append(tuple(q.shape))
        return flash(q, k, v, scale)

    unet.flash_attention = spy
    try:
        got, want = _block_vs_flax(hd, H, W, seed=hd + W)
    finally:
        unet.flash_attention = flash
    assert calls == [(4, H * W, hd)]
    assert math.isfinite(float(np.abs(got).max()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
