"""Fused GroupNorm-affine → SiLU → 3×3 conv unit: conv3x3(act(a·x + bb))
+ bias [+ skip] over NCHW tensors.

Port of the Pallas kernel ipdm_tpu/ops/pallas/planar.py:190 planar_unit.
The GroupNorm statistics stay outside (models/unet.py ``GroupNorm.coeffs``);
the unit takes the per-(batch, channel) affine a, bb with
silu(a·x + bb) == silu(GN(x)). On a CUDA tensor :func:`planar_unit`
launches the kernel of ``csrc/planar_unit.cu``; on a CPU tensor it runs
:func:`planar_unit_plain`.

Where grad mode is on and an input requires a gradient, the call goes
through an ``autograd.Function`` whose forward is that same dispatch and
whose backward recomputes :func:`planar_unit_plain` on the saved inputs
and takes its vector-Jacobian product (the TPU package has no backward
kernel either: JAX differentiates the Pallas unit's reference). Under
``no_grad`` nothing is saved and the call is the bare dispatch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ipdm_tpu_torch.ops.cuda import _build

# the caller's gate (models/unet.py) and the kernel's shared-memory weight
# table: 9·C·O f32 weights with C·O ≤ 160
MAX_CO = 160


def planar_unit_plain(x, a, bb, w, bias, skip=None, act=True):
    """The plain PyTorch version: the same function in f32, written in
    x.dtype. x [B,C,H,W]; a, bb [B,C] f32; w [3,3,C,O] f32 (HWIO); bias
    [B,O] f32; skip optional [B,O,H,W]. The conv's zero padding applies
    after the activation, as F.conv2d pads its (activated) input."""
    xh = x.float() * a[:, :, None, None] + bb[:, :, None, None]
    if act:
        xh = F.silu(xh)
    y = F.conv2d(xh, w.permute(3, 2, 0, 1), padding=1)
    y = y + bias[:, :, None, None]
    if skip is not None:
        y = y + skip.float()
    return y.to(x.dtype)


def _check(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"planar_unit: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"planar_unit: {name} is {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"planar_unit: {name} is on {t.device}, "
                         f"expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"planar_unit: {name} must be contiguous")


def planar_unit(x, a, bb, w, bias, skip=None, act=True):
    """conv3x3_pad1(act(a·x + bb)) + bias [+ skip], accumulated in f32 and
    returned in x.dtype (f32 or bf16). Shapes as in
    :func:`planar_unit_plain`; C·O ≤ :data:`MAX_CO`. Differentiable in
    every tensor input (backward by recomputing the plain version)."""
    inputs = (x, a, bb, w, bias, skip)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        return _PlanarUnit.apply(x, a, bb, w, bias, skip, act)
    return _forward(x, a, bb, w, bias, skip, act)


class _PlanarUnit(torch.autograd.Function):
    """The unit with a backward: forward is :func:`_forward` (the kernel
    on the card), backward the VJP of :func:`planar_unit_plain`
    recomputed on the saved inputs."""

    @staticmethod
    def forward(ctx, x, a, bb, w, bias, skip, act):
        ctx.act = act
        ctx.save_for_backward(x, a, bb, w, bias, skip)
        return _forward(x, a, bb, w, bias, skip, act)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:6]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(saved, need)]
            out = planar_unit_plain(*leaves, act=ctx.act)
            wrt = [t for t, n in zip(leaves, need) if n]
            got = iter(torch.autograd.grad(out, wrt, grad_out))
        return (*(next(got) if n else None for n in need), None)


def _forward(x, a, bb, w, bias, skip, act):
    """The unit's forward: :func:`planar_unit_plain` for CPU tensors, the
    kernel for CUDA tensors (or raise)."""
    if x.device.type == "cpu":
        return planar_unit_plain(x, a, bb, w, bias, skip, act)
    if x.device.type != "cuda":
        raise ValueError(f"planar_unit: unsupported device {x.device}")
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError("planar_unit: x must be [B,C,H,W] and w [3,3,C,O]")
    B, C, H, W = x.shape
    O = w.shape[3]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"planar_unit: x dtype {x.dtype} (f32 or bf16)")
    if C * O > MAX_CO:
        raise ValueError(f"planar_unit: C*O = {C * O} > {MAX_CO}")
    dev = x.device
    _check("x", x, (B, C, H, W), x.dtype, dev)
    _check("a", a, (B, C), torch.float32, dev)
    _check("bb", bb, (B, C), torch.float32, dev)
    _check("w", w, (3, 3, C, O), torch.float32, dev)
    _check("bias", bias, (B, O), torch.float32, dev)
    if skip is not None:
        _check("skip", skip, (B, O, H, W), x.dtype, dev)
    out = torch.empty((B, O, H, W), dtype=x.dtype, device=dev)
    lib = _build.library()
    code = lib.planar_unit_launch(
        x.data_ptr(), a.data_ptr(), bb.data_ptr(), w.data_ptr(),
        bias.data_ptr(), None if skip is None else skip.data_ptr(),
        out.data_ptr(), B, C, O, H, W, int(act),
        int(x.dtype == torch.bfloat16), _build.stream_ptr(x))
    _build.check(code, "planar_unit")
    _build.LAUNCHES["planar_unit"] += 1
    return out
