"""DDPM ε-prediction UNet in NCHW (port of ipdm_tpu/models/unet.py).

Architecturally the reference UNetModel (Model/model.py:190-310): the same
block plan (``UNetModel.plan``), GroupNorm group rule and eps 1e-5,
cos-then-sin time embedding, nearest resize by floor(i·src/dst) over odd
pyramids (2000→1000→500→250→125→63), attention that scales q and k by
1/√√hd with an f32 softmax, and the up-path concat order [h, skip]. Its
submodule names give the original repo's state_dict keys, so an original
checkpoint loads with ``load_state_dict``.

Parameters stay f32; with ``dtype=torch.bfloat16`` the activations are bf16
and each layer casts its weights to bf16 at use, as the Flax module does.

Two kernels sit on the forward path, routed exactly where the JAX package
takes its Pallas kernels on a TPU:

* :func:`ipdm_tpu_torch.ops.cuda.planar.planar_unit` takes every
  (GN →) SiLU → 3×3 conv (+ bias / time embedding, + skip) unit of a
  block in planar layout (out channels ≤ ``PLANAR_MAX_C`` and no
  attention; on the up path also in channels ≤ 2·``PLANAR_MAX_C``) with
  stride 1 and C·O ≤ 160 (unet.py:257, :359-373, :795-796, :906-908);
* :func:`ipdm_tpu_torch.ops.cuda.attention.flash_attention` takes
  attention over ≥ ``FLASH_MIN_SEQ`` tokens (unet.py:590, :655-657).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ipdm_tpu_torch import resolve_device
from ipdm_tpu_torch.ops.cuda.attention import (FLASH_MIN_SEQ,
                                               attention_plain,
                                               flash_attention)
from ipdm_tpu_torch.ops.cuda.planar import MAX_CO, planar_unit

# widest block (out channels) that runs in the JAX package's planar layout,
# where its small-channel units take the Pallas kernel (unet.py:751, :795)
PLANAR_MAX_C = 32


def timestep_embedding(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embeddings in f32, cos-then-sin (reference
    model.py:14-32)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000)
                      * torch.arange(half, dtype=torch.float32,
                                     device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def group_count(channels: int) -> int:
    """GroupNorm group count of the reference (model.py:69-90): 32 if it
    divides C; C if C < 32; else the divisor of C nearest to 32."""
    if channels % 32 == 0:
        return 32
    if channels < 32:
        return channels
    divs = np.array([d for d in range(1, channels + 1) if channels % d == 0])
    return int(divs[np.argmin((divs - 32) ** 2)])


def nearest_resize(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest resize of [B,C,H,W] to ``size`` with the integer rule
    floor(i·src/dst) of torch F.interpolate(mode='nearest')."""
    H, W = x.shape[2], x.shape[3]
    dh, dw = int(size[0]), int(size[1])
    ih = torch.arange(dh, device=x.device) * H // dh
    iw = torch.arange(dw, device=x.device) * W // dw
    return x.index_select(2, ih).index_select(3, iw)


def _conv(conv: nn.Conv2d, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """conv in the activation dtype, padding from the module."""
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), b, stride=stride,
                    padding=conv.padding)


class GroupNorm(nn.Module):
    """GroupNorm with the reference group rule, eps 1e-5 and f32
    statistics E[x²]−E[x]² (unet.py:62-70, :126-147); parameters
    ``weight``/``bias`` as in torch's nn.GroupNorm."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.channels = channels
        self.groups = group_count(channels)
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def _stats(self, x):
        xg = x.float().reshape(x.shape[0], self.groups, -1)
        mean = xg.mean(dim=-1)
        m2 = (xg * xg).mean(dim=-1)
        rstd = torch.rsqrt(torch.clamp(m2 - mean * mean, min=0.0) + 1e-5)
        return xg, mean, rstd

    def coeffs(self, x):
        """Per-(batch, channel) f32 affine (a, b) with a·x + b == GN(x),
        the form :func:`planar_unit` consumes (unet.py:100-125)."""
        _, mean, rstd = self._stats(x)
        rep = self.channels // self.groups
        a = rstd.repeat_interleave(rep, dim=1) * self.weight.float()
        b = self.bias.float() - mean.repeat_interleave(rep, dim=1) * a
        return a.contiguous(), b.contiguous()

    def forward(self, x):
        xg, mean, rstd = self._stats(x)
        y = ((xg - mean[..., None]) * rstd[..., None]).reshape(x.shape)
        y = (y * self.weight.float()[None, :, None, None]
             + self.bias.float()[None, :, None, None])
        return y.to(x.dtype)


def conv_unit(conv: nn.Conv2d, x: torch.Tensor, planar: bool,
              gn: GroupNorm | None = None, extra_bias=None, skip=None):
    """conv3x3(silu(gn(x))) [+ extra_bias] [+ skip]; without ``gn`` the
    plain conv3x3(x). Goes through the planar_unit kernel where the JAX
    package's Conv3x3 takes its Pallas unit on a TPU: a planar block,
    stride 1, C·O ≤ MAX_CO (unet.py:359-373)."""
    cin, cout = conv.in_channels, conv.out_channels
    if planar and cin * cout <= MAX_CO:
        B = x.shape[0]
        if gn is None:
            a = torch.ones((B, cin), dtype=torch.float32, device=x.device)
            b = torch.zeros_like(a)
        else:
            a, b = gn.coeffs(x)
        bias = conv.bias.float()[None].expand(B, cout)
        if extra_bias is not None:
            bias = bias + extra_bias.float()
        w = conv.weight.float().permute(2, 3, 1, 0).contiguous()  # HWIO
        return planar_unit(x.contiguous(), a, b, w, bias.contiguous(),
                           None if skip is None else skip.contiguous(),
                           act=gn is not None)
    h = x if gn is None else F.silu(gn(x))
    y = _conv(conv, h)
    if extra_bias is not None:
        y = y + extra_bias[:, :, None, None]
    if skip is not None:
        y = y + skip
    return y


class ResidualBlock(nn.Module):
    """GN→SiLU→3×3 conv ×2 with the time embedding added after the first
    conv and a 1×1 shortcut when channels change (reference
    model.py:95-130). Keys conv1.{0,2}, time_emb.1, conv2.{0,2},
    shortcut."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int,
                 planar: bool, device=None):
        super().__init__()
        self.planar = planar
        self.conv1 = nn.Sequential(
            GroupNorm(in_channels, device), nn.SiLU(),
            nn.Conv2d(in_channels, out_channels, 3, padding=1, device=device))
        self.time_emb = nn.Sequential(
            nn.SiLU(), nn.Linear(emb_channels, out_channels, device=device))
        self.conv2 = nn.Sequential(
            GroupNorm(out_channels, device), nn.SiLU(),
            nn.Conv2d(out_channels, out_channels, 3, padding=1,
                      device=device))
        self.shortcut = (nn.Conv2d(in_channels, out_channels, 1,
                                   device=device)
                         if in_channels != out_channels else None)

    def forward(self, x, emb):
        lin = self.time_emb[1]
        t = F.linear(F.silu(emb), lin.weight.to(emb.dtype),
                     lin.bias.to(emb.dtype))
        h = conv_unit(self.conv1[2], x, self.planar, gn=self.conv1[0],
                      extra_bias=t)
        sc = x if self.shortcut is None else _conv(self.shortcut, x)
        return conv_unit(self.conv2[2], h, self.planar, gn=self.conv2[0],
                         skip=sc)


class AttentionBlock(nn.Module):
    """Self-attention over the H·W tokens with a residual (reference
    model.py:135-155): GN, bias-free 1×1 qkv (head-major, q|k|v within a
    head), scale 1/√√hd on q and k, f32 softmax, 1×1 proj."""

    def __init__(self, channels: int, num_heads: int = 1, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.norm = GroupNorm(channels, device)
        self.qkv = nn.Conv2d(channels, 3 * channels, 1, bias=False,
                             device=device)
        self.proj = nn.Conv2d(channels, channels, 1, device=device)

    def forward(self, x):
        B, C, H, W = x.shape
        nh = self.num_heads
        hd = C // nh
        T = H * W
        qkv = _conv(self.qkv, self.norm(x)).reshape(B * nh, 3 * hd, T)
        q, k, v = (t.transpose(1, 2).contiguous()
                   for t in qkv.chunk(3, dim=1))          # [BH, T, hd]
        scale = 1.0 / math.sqrt(math.sqrt(hd))
        if T >= FLASH_MIN_SEQ:
            out = flash_attention(q, k, v, scale)
        else:
            out = attention_plain(q, k, v, scale)
        out = out.reshape(B, nh, T, hd).permute(0, 1, 3, 2).reshape(
            B, C, H, W)
        return _conv(self.proj, out) + x


class Downsample(nn.Module):
    """3×3 stride-2 conv, pad 1 → ceil(n/2) (reference model.py:175-185)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.op = nn.Conv2d(channels, channels, 3, padding=1, device=device)

    def forward(self, x):
        return _conv(self.op, x, stride=2)


class Upsample(nn.Module):
    """Nearest resize to an explicit size, then a 3×3 conv (reference
    model.py:160-171)."""

    def __init__(self, channels: int, planar: bool, device=None):
        super().__init__()
        self.planar = planar
        self.conv = nn.Conv2d(channels, channels, 3, padding=1, device=device)

    def forward(self, x, size):
        return conv_unit(self.conv, nearest_resize(x, size), self.planar)


class UNetModel(nn.Module):
    """Full UNet (reference model.py:190-310), NCHW in and out; the output
    is f32. Keys: time_embed.{0,2}, down_blocks.i.j, middle_block.{0,1,2},
    up_blocks.i.j, out.{0,2} (see utils/torch_import.py)."""

    def __init__(self, in_channels: int = 3, model_channels: int = 128,
                 out_channels: int = 3, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (8, 16),
                 channel_mult: Sequence[float] = (1, 2, 2, 2),
                 num_heads: int = 4, dtype=torch.float32,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.in_channels = in_channels
        self.model_channels = model_channels
        self.out_channels = out_channels
        self.num_res_blocks = num_res_blocks
        self.attention_resolutions = tuple(attention_resolutions)
        self.channel_mult = tuple(channel_mult)
        self.num_heads = num_heads
        self.dtype = dtype
        down_plan, middle_ch, up_plan, final_ch = self.plan()
        ted = model_channels * 4
        self.time_embed = nn.Sequential(
            nn.Linear(model_channels, ted, device=device), nn.SiLU(),
            nn.Linear(ted, ted, device=device))

        def res(cin, cout, planar):
            return ResidualBlock(cin, cout, ted, planar, device)

        pm = PLANAR_MAX_C
        self.down_blocks = nn.ModuleList()
        self._down_planar = []
        for entry in down_plan:
            if entry[0] == "stem":
                planar = entry[1] <= pm
                mods = [nn.Conv2d(in_channels, entry[1], 3, padding=1,
                                  device=device)]
            elif entry[0] == "res":
                _, cin, cout, attn = entry
                planar = not attn and max(cin, cout) <= pm
                mods = [res(cin, cout, planar)]
                if attn:
                    mods.append(AttentionBlock(cout, num_heads, device))
            else:
                planar = False  # stride 2: never the planar unit
                mods = [Downsample(entry[1], device)]
            self.down_blocks.append(nn.ModuleList(mods))
            self._down_planar.append(planar)
        mid_planar = middle_ch <= pm
        self.middle_block = nn.ModuleList([
            res(middle_ch, middle_ch, mid_planar),
            AttentionBlock(middle_ch, num_heads, device),
            res(middle_ch, middle_ch, mid_planar)])
        self.up_blocks = nn.ModuleList()
        for entry in up_plan:
            _, cin, cout, attn, upsample = entry
            planar = not attn and cout <= pm and cin <= 2 * pm
            mods = [res(cin, cout, planar)]
            if attn:
                mods.append(AttentionBlock(cout, num_heads, device))
            if upsample:
                mods.append(Upsample(cout, planar, device))
            self.up_blocks.append(nn.ModuleList(mods))
        self._out_planar = final_ch <= pm
        self.out = nn.Sequential(
            GroupNorm(final_ch, device), nn.SiLU(),
            nn.Conv2d(final_ch, out_channels, 3, padding=1, device=device))

    def plan(self):
        """Static block plan (down_plan, middle_ch, up_plan, final_ch) of
        reference model.py:224-275: down entries ('stem', ch),
        ('res', in, out, attn), ('down', ch); up entries
        ('res', in, out, attn, upsample)."""
        mc = self.model_channels
        stem_ch = int(self.channel_mult[0] * mc)
        level_mults = list(self.channel_mult[1:])
        down = [("stem", stem_ch)]
        ch = stem_ch
        chans = [ch]
        ds = 1
        for level, mult in enumerate(level_mults):
            for _ in range(self.num_res_blocks):
                out_ch = int(mult * mc)
                down.append(("res", ch, out_ch,
                             ds in self.attention_resolutions))
                ch = out_ch
                chans.append(ch)
            if level != len(level_mults) - 1:
                down.append(("down", ch))
                chans.append(ch)
                ds *= 2
        middle_ch = ch
        up = []
        for level, mult in list(enumerate(level_mults))[::-1]:
            for i in range(self.num_res_blocks + 1):
                skip = chans.pop()
                out_ch = int(mult * mc)
                attn = ds in self.attention_resolutions
                upsample = bool(level and i == self.num_res_blocks)
                up.append(("res", ch + skip, out_ch, attn, upsample))
                ch = out_ch
                if upsample:
                    ds //= 2
        return down, middle_ch, up, ch

    def forward(self, x, timesteps):
        """x: [B, C_in, H, W]; timesteps: [B] integers. Returns
        [B, C_out, H, W] in f32."""
        emb = timestep_embedding(timesteps, self.model_channels)
        emb = self.time_embed[0](emb)
        emb = self.time_embed[2](F.silu(emb)).to(self.dtype)
        h = x.to(self.dtype)
        hs = []
        for mods, planar in zip(self.down_blocks, self._down_planar):
            first = mods[0]
            if isinstance(first, ResidualBlock):
                h = first(h, emb)
                if len(mods) > 1:
                    h = mods[1](h)
            elif isinstance(first, Downsample):
                h = first(h)
            else:  # stem
                h = conv_unit(first, h, planar)
            hs.append(h)
        h = self.middle_block[0](h, emb)
        h = self.middle_block[1](h)
        h = self.middle_block[2](h, emb)
        h_ = hs.pop()
        for mods in self.up_blocks:
            cat_in = torch.cat([h, h_], dim=1)
            if hs:
                h_ = hs.pop()
            h = mods[0](cat_in, emb)
            for m in mods[1:]:
                h = m(h, h_.shape[2:]) if isinstance(m, Upsample) else m(h)
        h = conv_unit(self.out[2], h, self._out_planar, gn=self.out[0])
        return h.float()


def build_unet(opt: dict, domain: str, device=None) -> UNetModel:
    """The img- or proj-domain UNet from options with IPDMConfig's key
    names (reference init_img_model/init_proj_model,
    Utils/train_test_utils.py:213-245)."""
    if domain not in ("img", "proj"):
        raise ValueError(f"domain {domain!r}: 'img' or 'proj'")
    g = lambda name: opt[f"{name}_{domain}"]
    dtype = (torch.bfloat16 if opt.get("compute_dtype") == "bfloat16"
             else torch.float32)
    return UNetModel(
        in_channels=g("in_channels"), model_channels=g("model_channels"),
        out_channels=g("out_channels"),
        attention_resolutions=tuple(int(a) for a in
                                    g("attention_resolutions")),
        channel_mult=tuple(g("channel_mult")), dtype=dtype, device=device)
