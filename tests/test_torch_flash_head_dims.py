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
* Every head dim from 1 to 128 maps to the kernel instance that runs it
  (``attention.flash_instance``: the next instance up, zero-padded by the
  wrappers), and above 128 the wrappers raise naming the limit. The
  presets at ``model_channels`` 8 to 128 (each attention block's head dim
  is the width) are served, 160 is flagged.
* Zero-padding q, k, v to an instance and cutting the outputs back is
  the function at the real head dim, forward and backward.
* The port's AttentionBlock at head dimensions 8, 16, 24, 48, 96 and 128
  and T = 4096 and 4097 (the flash route; on the CPU its plain formula)
  against the Flax block, weights carried across through
  ``state_dict_from_flax``."""

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
    assert _build.FLASH_HEAD_DIMS[-1] == 128
    for name in _build.FLASH_KERNELS:
        for hd in _build.FLASH_HEAD_DIMS:
            assert _build.LAUNCHES[_build.flash_counter(name, hd)] >= 0


def test_head_dims_outside_the_set_raise_on_cuda_tensors():
    """Every head dim from 1 to 128 reaches an instance (the next one up),
    and a head dim above 128 raises before any launch, naming the limit
    and the options that set it (checked on a CUDA-typed shape through
    _check_cuda: the CPU has no CUDA tensors, so the check is called with
    a stand-in that reports cuda). Written for the set (8, 16, 32, 64),
    where 12 raised; 12 now runs on 16."""
    class Fake:
        device = torch.device("cuda")
        shape = (4, 4096, 12)

        def dim(self):
            return 3
    for hd in range(1, 129):
        Fake.shape = (4, 4096, hd)
        inst = attention._check_cuda("flash_attention", Fake())
        assert inst in attention.FLASH_HEAD_DIMS and inst >= hd
        assert all(i < hd for i in attention.FLASH_HEAD_DIMS if i < inst)
    for hd in (129, 160, 256):
        Fake.shape = (4, 4096, hd)
        with pytest.raises(ValueError, match=r"1\.\.128.*model_channels_img"):
            attention._check_cuda("flash_attention", Fake())


@pytest.mark.parametrize("hd,inst", [
    (1, 8), (7, 8), (8, 8), (9, 16), (12, 16), (16, 16), (17, 32), (31, 32),
    (32, 32), (33, 64), (40, 64), (63, 64), (64, 64), (65, 128), (96, 128),
    (127, 128), (128, 128)])
def test_flash_instance(hd, inst):
    """Head dims 1-7 run on 8, 9-15 on 16, 17-31 on 32, 33-63 on 64 and
    65-127 on 128; the instances on themselves."""
    assert attention.flash_instance(hd) == inst


@pytest.mark.parametrize("hd", [0, 129, 160, 256])
def test_flash_instance_raises_outside_the_range(hd):
    with pytest.raises(ValueError, match="128"):
        attention.flash_instance(hd)


@pytest.mark.parametrize("mc", [8, 12, 24, 40, 48, 64, 80, 96, 128, 160])
def test_presets_at_other_widths(mc):
    """The three Mayo presets with model_channels_img and
    model_channels_proj set to ``mc``: every attention block at T >=
    FLASH_MIN_SEQ, at 64²-512², has head dim ``mc`` (4 heads over 4·mc
    channels), which an instance serves up to 128; at 160 the block is
    flagged: flash_instance raises naming 128."""
    dims = set()
    for name in PRESETS:
        with open(osp.join(ROOT, "Config", "Mayo-Config",
                           f"{name}.json")) as f:
            opt = dict(json.load(f), model_channels_img=mc,
                       model_channels_proj=mc)
        for domain in ("img", "proj"):
            model = build_unet(opt, domain, device="meta")
            for size in SIZES:
                dims |= {hd for _, T, hd in attention_blocks(
                    model, *_input_hw(domain, size))
                    if T >= attention.FLASH_MIN_SEQ}
    assert dims == {mc}, dims
    if mc <= 128:
        assert attention.flash_instance(mc) >= mc
    else:
        with pytest.raises(ValueError, match="128"):
            attention.flash_instance(mc)


@pytest.mark.parametrize("hd", [12, 40, 96])
def test_zero_padding_is_exact(hd):
    """What the wrappers do for a head dim between instances: q, k, v
    zero-padded to the instance, the function there, the outputs cut
    back. Against the function at the real head dim (attention_plain and
    its autograd; attention_bwd_plain, the kernels' formulas, on the
    padded tensors), f32, to 1e-6: zero columns add nothing to q·kᵀ, to
    rowsum(do ∘ out) or to do·vᵀ."""
    inst = attention.flash_instance(hd)
    rng = np.random.default_rng(hd)
    q, k, v, do = (torch.tensor(rng.normal(0, 1, (2, 300, hd)),
                                dtype=torch.float32) for _ in range(4))
    scale = 1.0 / math.sqrt(math.sqrt(hd))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = attention.attention_plain(*leaves, scale)
    want.backward(do)
    padded = [t.clone().requires_grad_() for t in (q, k, v)]
    got = attention._cut(hd, attention.attention_plain(
        *attention._pad(inst, *padded), scale))[0]
    got.backward(do)
    np.testing.assert_allclose(got.detach(), want.detach(), rtol=1e-6,
                               atol=1e-6)
    for a, b in zip(padded, leaves):
        np.testing.assert_allclose(a.grad, b.grad, rtol=1e-6, atol=1e-6)
    # the kernels' backward formulas on the padded tensors, cut back
    qp, kp, vp, dop = attention._pad(inst, q, k, v, do)
    outp, lsep = attention.attention_lse_plain(qp, kp, vp, scale)
    grads = attention._cut(hd, *attention.attention_bwd_plain(
        qp, kp, vp, outp, lsep, dop, scale))
    for a, b in zip(grads, leaves):
        np.testing.assert_allclose(a, b.grad, rtol=1e-6, atol=1e-6)


def _block_vs_flax(hd, H, W, seed):
    """The middle AttentionBlock (4 heads of head dim ``hd``) of a
    one-level UNet in both packages on the same NHWC input (B = 1): the
    Flax UNet's parameters drawn N(0, σ) and carried to the port's UNet
    by state_dict_from_flax, then each package's block alone on the
    input. σ = 0.3 up to C = 64 channels, then 0.3·√(64 / C), as a
    fan-in init scales it: the 1×1 convolutions sum over C channels, and
    N(0, 0.3) weights at C = 512 put the outputs at ~10, where f32
    rounding alone reaches 1e-4 absolute."""
    C = 4 * hd
    cfg = dict(in_channels=1, model_channels=C // 2, out_channels=1,
               num_res_blocks=1, attention_resolutions=(),
               channel_mult=(1, 2), num_heads=4)
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(FlaxUNet(**cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 8, 1)),
                            jnp.zeros((1,), jnp.int32))
    sd = 0.3 * min(1.0, math.sqrt(64 / C))
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(0, sd, s.shape).astype(np.float32), shapes)
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


@pytest.mark.parametrize("hd", [8, 16, 24, 48, 96, 128])
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
