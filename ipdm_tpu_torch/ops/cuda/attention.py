"""Softmax self-attention over long sequences: the flash kernel and its
plain version.

Port of the TPU flash kernel that ipdm_tpu/models/unet.py:601
_flash_attention calls for sequences of at least ``FLASH_MIN_SEQ`` tokens.
On a CUDA tensor :func:`flash_attention` launches the kernel of
``csrc/flash_attn.cu``; on a CPU tensor it runs :func:`attention_plain`,
the einsum formula of unet.py:659-662. Shorter sequences take
:func:`attention_plain` on every device, as the JAX package does.

Where grad mode is on and q, k or v requires a gradient, the call goes
through an ``autograd.Function`` whose forward is that same dispatch and
whose backward recomputes :func:`attention_plain` on the saved q, k, v
and takes its vector-Jacobian product. Under ``no_grad`` nothing is saved
and the call is the bare dispatch.
"""

from __future__ import annotations

import math

import torch

from ipdm_tpu_torch.ops.cuda import _build

# sequence length from which attention runs the flash kernel (unet.py:590)
FLASH_MIN_SEQ = 4096
HEAD_DIM = 64  # the kernel's head dimension


def attention_plain(q, k, v, scale):
    """softmax((q·s)(k·s)ᵀ)·v for q, k, v [BH, T, hd] in the activation
    dtype: the scaled operands round to that dtype, the scores and the
    softmax are f32, the weights round back before the product with v."""
    s = torch.matmul((q * scale).float(), (k * scale).float().transpose(1, 2))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, v)


def flash_attention(q, k, v, scale):
    """The same function as :func:`attention_plain`. The kernel applies
    scale² once to the f32 score instead of scale to each operand, and
    takes bf16 [BH, T, 64] contiguous tensors. Differentiable in q, k
    and v (backward by recomputing the plain version)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, scale)
    return _forward(q, k, v, scale)


class _FlashAttention(torch.autograd.Function):
    """Attention with a backward: forward is :func:`_forward` (the kernel
    on the card), backward the VJP of :func:`attention_plain` recomputed
    on the saved q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, scale)

    @staticmethod
    def backward(ctx, grad_out):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            out = attention_plain(*leaves, ctx.scale)
            wrt = [t for t, n in zip(leaves, need) if n]
            got = iter(torch.autograd.grad(out, wrt, grad_out))
        return (*(next(got) if n else None for n in need), None)


def _forward(q, k, v, scale):
    """Attention's forward: :func:`attention_plain` for CPU tensors, the
    kernel for CUDA tensors (or raise)."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 3 or q.shape[2] != HEAD_DIM:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} must be "
                         f"[BH, T, {HEAD_DIM}]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"flash_attention: {name} is {tuple(t.shape)} "
                             f"on {t.device}, expected {tuple(q.shape)} on "
                             f"{q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: {name} is {t.dtype}; the "
                            "kernel takes bf16")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             "and 16-byte aligned")
    BH, T, _ = q.shape
    out = torch.empty_like(q)
    lib = _build.library()
    code = lib.flash_attn_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 out.data_ptr(), BH, T,
                                 scale * scale * math.log2(math.e),
                                 _build.stream_ptr(q))
    _build.check(code, "flash_attn")
    _build.LAUNCHES["flash_attn"] += 1
    return out
