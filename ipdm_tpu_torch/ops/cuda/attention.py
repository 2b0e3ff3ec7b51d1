"""Softmax self-attention over long sequences: the flash kernel and its
plain version.

Port of the TPU flash kernel that ipdm_tpu/models/unet.py:601
_flash_attention calls for sequences of at least ``FLASH_MIN_SEQ`` tokens.
On a CUDA tensor :func:`flash_attention` launches the kernel of
``csrc/flash_attn.cu``; on a CPU tensor it runs :func:`attention_plain`,
the einsum formula of unet.py:659-662. Shorter sequences take
:func:`attention_plain` on every device, as the JAX package does.
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
    takes bf16 [BH, T, 64] contiguous tensors."""
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
