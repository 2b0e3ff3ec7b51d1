"""Softmax self-attention over long sequences: the flash kernels (forward
and backward) and their plain versions.

Port of the TPU flash kernel that ipdm_tpu/models/unet.py:601
_flash_attention calls for sequences of at least ``FLASH_MIN_SEQ`` tokens,
and of the two Pallas kernels of its backward
(jax/experimental/pallas/ops/tpu/flash_attention.py:941
``_flash_attention_bwd_dkv`` and :1287 ``_flash_attention_bwd_dq``). On a
CUDA tensor :func:`flash_attention` launches the forward kernel of
``csrc/flash_attn.cu`` (wgmma: bf16 as it is, f32 as three bf16 passes of
split operands); on a CPU tensor it runs :func:`attention_plain`, the einsum
formula of unet.py:659-662. Shorter sequences take :func:`attention_plain`
on every device, as the JAX package does.

The kernels are instantiated at the head dims :data:`FLASH_HEAD_DIMS`; any
other head dim up to 128 runs on the next instance up, and every head dim
above 128 on each kernel's wide body at the next multiple of
:data:`FLASH_WIDE_CHUNK` columns (:func:`flash_instance`): the wrappers
zero-pad q, k, v (and out, do) to that width and cut the outputs back.
The f32 forward and the backward run their wide bodies from width 128
on, the bf16 forward above its hd-128 instance
(``_build.FLASH_FWD_WIDE_FROM``, ``FLASH_BWD_WIDE_FROM``): one CTA holds
up to 256 columns of the output and builds the scores once for them.
Zero columns add nothing to q·kᵀ, to rowsum(do ∘ out) or to do·vᵀ, and
the caller's scale is that of the real head dim, so the result is the
function at the real head dim. The f32 forward and backward at head dim 8
run their own narrow bodies (``csrc/flash_narrow.cu``,
``csrc/flash_narrow_bwd.cu``).

Where grad mode is on and q, k or v requires a gradient, the call goes
through an ``autograd.Function``. Its forward also returns the softmax's
log-normaliser per query row (lse, the counterpart of the TPU kernel's
saved l and m residuals) and saves q, k, v, out and lse; its backward
runs :func:`flash_bwd_dq` and :func:`flash_bwd_dkv`: the kernels of
``csrc/flash_bwd.cu`` on the card (every product on wgmma: bf16 as the
library rounds it, f32 as three bf16 passes of split operands), on the
CPU the two halves of
:func:`attention_bwd_plain`, the same formulas written out with the saved
lse. Under ``no_grad``
nothing is saved and the call is the bare forward.
"""

from __future__ import annotations

import math

import torch

from ipdm_tpu_torch.ops.cuda import _build

# sequence length from which attention runs the flash kernel (unet.py:590)
FLASH_MIN_SEQ = 4096
# the head dimensions the kernels are instantiated for
FLASH_HEAD_DIMS = _build.FLASH_HEAD_DIMS
# above them, the wide bodies' column chunk
FLASH_WIDE_CHUNK = _build.FLASH_WIDE_CHUNK
HEAD_DIM = 64  # the shipped presets' head dimension
# forward kernel of each activation dtype: (C entry, launch counter)
_FORWARD = {torch.bfloat16: ("flash_attn_launch", "flash_attn"),
            torch.float32: ("flash_attn_f32_launch", "flash_attn_f32")}


def _acc(t):
    """t in the plain versions' sum dtype: f32, or f64 for f64 inputs (a
    reference run in double)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _scores(q, k, scale):
    """The f32 scores (q·s)(k·s)ᵀ, each operand scaled and rounded in the
    activation dtype first (unet.py:659-662)."""
    return torch.matmul(_acc(q * scale), _acc(k * scale).transpose(1, 2))


def attention_plain(q, k, v, scale):
    """softmax((q·s)(k·s)ᵀ)·v for q, k, v [BH, T, hd] in the activation
    dtype: the scaled operands round to that dtype, the scores and the
    softmax are f32, the weights round back before the product with v."""
    p = torch.softmax(_scores(q, k, scale), dim=-1).to(q.dtype)
    return torch.matmul(p, v)


def attention_lse_plain(q, k, v, scale):
    """:func:`attention_plain` and the f32 log-normaliser of its softmax
    per query row, lse [BH, T] = log Σ_s exp(score)."""
    s = _scores(q, k, scale)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, v), torch.logsumexp(s, dim=-1)


def _rowsum(out, do):
    """D = rowsum(do ∘ out), the library's di."""
    return (_acc(out) * _acc(do)).sum(dim=-1)


def _probs_ds(q, k, v, lse, do, D, scale):
    """The backward's shared terms: the scaled operands q·s, k·s, do,
    P = exp(S − lse) and dS = P ∘ (do·vᵀ − D), all in :func:`_acc`'s
    dtype."""
    qs, ks, dof = _acc(q * scale), _acc(k * scale), _acc(do)
    p = torch.exp(torch.matmul(qs, ks.transpose(1, 2)) - lse[..., None])
    ds = p * (torch.matmul(dof, _acc(v).transpose(1, 2)) - D[..., None])
    return qs, ks, dof, p, ds


def attention_bwd_plain(q, k, v, out, lse, do, scale, D=None):
    """Gradients (dq, dk, dv) of :func:`attention_plain` with respect to
    the unscaled q, k and v, written out from the forward's saved ``out``
    and ``lse`` (the library's mha_reference_bwd formulas), in f32 (f64
    for f64 inputs) and returned in the activation dtype:

        P  = exp(S − lse),  S = (q·s)(k·s)ᵀ as in the forward
        D  = rowsum(do ∘ out)   (or the ``D`` given)
        dv = Pᵀ·do,  dS = P ∘ (do·vᵀ − D)
        dq = s·(dS·(k·s)),  dk = s·(dSᵀ·(q·s))

    The scale reaches each of q and k once through its rounded operand
    and once through the chain rule: s² in all, the kernels' one scale2."""
    if D is None:
        D = _rowsum(out, do)
    qs, ks, dof, p, ds = _probs_ds(q, k, v, lse, do, D, scale)
    dv = torch.matmul(p.transpose(1, 2), dof)
    dq = torch.matmul(ds, ks) * scale
    dk = torch.matmul(ds.transpose(1, 2), qs) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention(q, k, v, scale):
    """The same function as :func:`attention_plain`. The kernels apply
    scale² once to the f32 score instead of scale to each operand, and
    take contiguous [BH, T, hd] tensors in bf16 or f32, any hd
    (:func:`flash_instance`). Differentiable in
    q, k and v (backward by the flash backward kernels on the card)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, scale)
    return _forward(q, k, v, scale)


class _FlashAttention(torch.autograd.Function):
    """Attention with a backward: forward is :func:`_forward` with the
    lse; backward :func:`flash_bwd_dq` then :func:`flash_bwd_dkv` (the
    kernels on the card, the two halves of :func:`attention_bwd_plain` on
    the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = _forward(q, k, v, scale, with_lse=True)
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        do = grad_out.to(q.dtype).contiguous()
        split = _shared_split(q) if q.device.type == "cuda" else None
        dq, D = flash_bwd_dq(q, k, v, out, lse, do, ctx.scale, split=split)
        dk, dv = flash_bwd_dkv(q, k, v, lse, do, D, ctx.scale, split=split,
                               ready=split is not None)
        need = ctx.needs_input_grad
        return (dq if need[0] else None, dk if need[1] else None,
                dv if need[2] else None, None)


def _check(name, tensors, like):
    """Every (name, tensor) must be a contiguous, 16-byte aligned tensor
    of ``like``'s shape, device and dtype, bf16 or f32."""
    for tn, t in tensors:
        if t.shape != like.shape or t.device != like.device:
            raise ValueError(f"{name}: {tn} is {tuple(t.shape)} on "
                             f"{t.device}, expected {tuple(like.shape)} on "
                             f"{like.device}")
        if t.dtype not in _FORWARD or t.dtype != like.dtype:
            raise TypeError(f"{name}: {tn} is {t.dtype}; the kernels take "
                            "bf16 or f32, all of one dtype")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {tn} must be contiguous and 16-byte "
                             "aligned")


def flash_instance(hd: int) -> int:
    """The width the kernels run head dim ``hd`` at: the smallest of
    :data:`FLASH_HEAD_DIMS` not below it (1-7 on 8, 9-15 on 16, 17-31 on
    32, 33-63 on 64, 65-127 on 128), and above 128 the wide body at the
    next multiple of :data:`FLASH_WIDE_CHUNK` (129-192 on 192, 193-256 on
    256, 449-512 on 512, ...). Raises ValueError below 1."""
    if hd < 1:
        raise ValueError(f"flash attention: head dim {hd} is below 1")
    for inst in FLASH_HEAD_DIMS:
        if hd <= inst:
            return inst
    return -(-hd // FLASH_WIDE_CHUNK) * FLASH_WIDE_CHUNK


def _check_cuda(name, q):
    """q is a [BH, T, hd] CUDA tensor; returns the width that runs it."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dim() != 3:
        raise ValueError(f"{name}: q {tuple(q.shape)} must be [BH, T, hd]")
    return flash_instance(q.shape[2])


def _pad(inst, *tensors):
    """Each tensor zero-padded along its last dim to ``inst`` columns (a
    copy), or as it is where it has them."""
    return [t if t.shape[-1] == inst else
            torch.nn.functional.pad(t, (0, inst - t.shape[-1]))
            for t in tensors]


def _cut(hd, *tensors):
    """Each tensor's first ``hd`` columns, contiguous."""
    return [t if t.shape[-1] == hd else t[..., :hd].contiguous()
            for t in tensors]


def _check_rows(name, tensors, q):
    """[BH, T] f32 contiguous tensors on q's device."""
    for tn, t in tensors:
        if (tuple(t.shape) != tuple(q.shape[:2]) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name}: {tn} must be a contiguous f32 "
                             f"[{q.shape[0]}, {q.shape[1]}] tensor on "
                             f"{q.device}")


def _forward(q, k, v, scale, with_lse=False):
    """Attention's forward: :func:`attention_plain` (with the lse:
    :func:`attention_lse_plain`) for CPU tensors, the kernel of q's dtype
    for CUDA tensors (or raise). Returns out, or (out, lse)."""
    if q.device.type == "cpu":
        if with_lse:
            return attention_lse_plain(q, k, v, scale)
        return attention_plain(q, k, v, scale)
    inst = _check_cuda("flash_attention", q)
    hd = q.shape[2]
    q, k, v = _pad(inst, q, k, v)
    _check("flash_attention", (("q", q), ("k", k), ("v", v)), q)
    BH, T, _ = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((BH, T), dtype=torch.float32, device=q.device)
           if with_lse else None)
    entry, counter = _FORWARD[q.dtype]
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    if q.dtype == torch.float32:   # the kernel's bf16 hi and lo of q, k, v
        split = torch.empty(_fwd_split(BH, T, inst), dtype=torch.bfloat16,
                            device=q.device)
        ptrs.append(split.data_ptr())
    code = getattr(_build.library(), entry)(
        *ptrs, out.data_ptr(), None if lse is None else lse.data_ptr(), BH,
        T, inst, scale * scale * math.log2(math.e), _build.stream_ptr(q))
    _build.check(code, counter)
    _build.LAUNCHES[_build.flash_counter(counter, inst)] += 1
    out, = _cut(hd, out)
    return (out, lse) if with_lse else out


def _fwd_split(BH, T, inst):
    """The shape of the f32 forward's bf16 scratch: hi and lo of q, k and
    v, [6, BH, T, inst]; at head dim 8 the narrow body's five padded
    operands, [5, BH, T, 16] (csrc/flash_narrow.cu)."""
    return (5, BH, T, 16) if inst == 8 else (6, BH, T, inst)


def _bwd_wide(q, inst) -> bool:
    """Whether the backward kernels run width ``inst`` on their wide body
    (``_build.FLASH_BWD_WIDE_FROM``)."""
    return inst >= _build.FLASH_BWD_WIDE_FROM


def _bwd_split(q, inst):
    """The f32 backward kernels' bf16 scratch (else None, passed as null).

    * The wide body's widths (from 128): hi and lo of q, k, v and do,
      [8, BH, T, inst].
    * Head dim 8 (csrc/flash_narrow_bwd.cu): the ring side's packed rows
      [hi(u) | lo(u) | hi(u) | f], then w's ([2, BH, T, 32]; u, w = k, v
      in dq, q, do in dkv; f the lse and D terms), the same for both
      kernels."""
    if q.dtype != torch.float32 or (inst != 8 and not _bwd_wide(q, inst)):
        return None
    BH, T, _ = q.shape
    shape = (2, BH, T, 32) if inst == 8 else (8, BH, T, inst)
    return torch.empty(shape, dtype=torch.bfloat16, device=q.device)


def _shared_split(q):
    """The split scratch that the autograd backward hands to both kernels:
    the f32 wide body's (:func:`_bwd_split`, from width 128), which the dq
    kernel's pre-pass fills with hi and lo of q, k, v and do and the dkv
    kernel takes as it is; else None (each kernel makes its own, as the
    narrow body at head dim 8 does)."""
    inst = flash_instance(q.shape[2])
    return _bwd_split(q, inst) if _bwd_wide(q, inst) else None


def _given_split(name, split, q, inst):
    """``split`` (passed by the caller) checked to be the f32 wide body's
    [8, BH, T, inst] bf16 scratch on q's device; a new scratch where it is
    None (:func:`_bwd_split`)."""
    if split is None:
        return _bwd_split(q, inst)
    BH, T, _ = q.shape
    if (tuple(split.shape) != (8, BH, T, inst)
            or split.dtype != torch.bfloat16 or split.device != q.device
            or q.dtype != torch.float32 or not _bwd_wide(q, inst)
            or not split.is_contiguous()):
        raise ValueError(f"{name}: split {tuple(split.shape)} "
                         f"{split.dtype} is not the f32 wide body's "
                         f"[8, {BH}, {T}, {inst}] bf16 scratch")
    return split


def flash_bwd_dq(q, k, v, out, lse, do, scale, split=None):
    """dq of attention and D = rowsum(do ∘ out) (f32 [BH, T]), the
    counterpart of the library's _flash_attention_bwd_dq and its di. The
    kernel on CUDA tensors (its f32 D takes do as its products see it,
    hi + lo of the bf16 split: see csrc/flash_bwd.cu), its half of
    :func:`attention_bwd_plain` on CPU ones. ``split``: where the f32
    wide body runs (from head dim 128), a [8, BH, T, width] bf16 scratch
    (:func:`_bwd_split`) that its pre-pass fills with hi and lo of q, k,
    v and do, for :func:`flash_bwd_dkv` to take (``ready``); else a
    scratch of its own. Returns (dq, D)."""
    if q.device.type == "cpu":
        D = _rowsum(out, do)
        _, ks, _, _, ds = _probs_ds(q, k, v, lse, do, D, scale)
        return (torch.matmul(ds, ks) * scale).to(q.dtype), D
    inst = _check_cuda("flash_bwd_dq", q)
    hd = q.shape[2]
    q, k, v, out, do = _pad(inst, q, k, v, out, do)
    _check("flash_bwd_dq", (("q", q), ("k", k), ("v", v), ("out", out),
                            ("do", do)), q)
    _check_rows("flash_bwd_dq", (("lse", lse),), q)
    BH, T, _ = q.shape
    dq = torch.empty_like(q)
    D = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    split = _given_split("flash_bwd_dq", split, q, inst)
    code = _build.library().flash_bwd_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        do.data_ptr(), lse.data_ptr(), D.data_ptr(), dq.data_ptr(),
        None if split is None else split.data_ptr(), BH, T, inst,
        scale * scale * math.log2(math.e), scale * scale,
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q))
    _build.check(code, "flash_bwd_dq")
    _build.LAUNCHES[_build.flash_counter("flash_bwd_dq", inst)] += 1
    return _cut(hd, dq)[0], D


def flash_bwd_dkv(q, k, v, lse, do, D, scale, split=None, ready=False):
    """(dk, dv) of attention from the lse and the D of
    :func:`flash_bwd_dq`, the counterpart of the library's
    _flash_attention_bwd_dkv. The kernel on CUDA tensors,
    its half of :func:`attention_bwd_plain` on CPU ones. ``split``: as
    :func:`flash_bwd_dq`'s; with ``ready`` it holds what flash_bwd_dq's
    pre-pass wrote from these same q, k, v and do, and is taken as it is
    (the split runs once a backward); else the kernel splits for
    itself."""
    if q.device.type == "cpu":
        qs, _, dof, p, ds = _probs_ds(q, k, v, lse, do, D, scale)
        return ((torch.matmul(ds.transpose(1, 2), qs) * scale).to(k.dtype),
                torch.matmul(p.transpose(1, 2), dof).to(v.dtype))
    inst = _check_cuda("flash_bwd_dkv", q)
    hd = q.shape[2]
    q, k, v, do = _pad(inst, q, k, v, do)
    _check("flash_bwd_dkv", (("q", q), ("k", k), ("v", v), ("do", do)), q)
    _check_rows("flash_bwd_dkv", (("lse", lse), ("D", D)), q)
    BH, T, _ = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if ready and split is None:
        raise ValueError("flash_bwd_dkv: ready without a split")
    split = _given_split("flash_bwd_dkv", split, q, inst)
    code = _build.library().flash_bwd_dkv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), D.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if split is None else split.data_ptr(), int(ready), BH, T,
        inst, scale * scale * math.log2(math.e), scale * scale,
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q))
    _build.check(code, "flash_bwd_dkv")
    _build.LAUNCHES[_build.flash_counter("flash_bwd_dkv", inst)] += 1
    return tuple(_cut(hd, dk, dv))
