"""The gate of the f32 flash forward's body (csrc/flash_attn.cu, f32) on
the CPU: a write-out of what the kernel computes, held to the JAX
package's attention.

The kernel splits each f32 operand into bf16 hi + lo (hi = bf16(x),
lo = bf16(x − hi)) and runs each product as three bf16 passes
hi·hi + hi·lo + lo·hi into f32 sums (lo·lo dropped): S = Q·Kᵀ per 64-key
tile, the online softmax in the log2 domain with the scale folded into
the exponent, P split in registers, each tile's P·V (P's hi and lo)
summed from zero and added to the rescaled O in f32; the row sum l and
the lse come from the f32 P. :func:`fwd_body` writes that out
(vectorised over the query rows, key tiles in order), beside a planted
one-pass body (every lo dropped: the bf16 kernel's products on the f32
inputs). The CPU's f32 sums round to nearest; the tensor cores' do not,
which only the card's checks can see (chip_smoke.py: the out's error,
and the backward's ragged dq, which the out feeds through D).

The reference is the einsum path of ipdm_tpu/models/unet.py:659-663 in
f32 on the CPU (the JAX package's attention off the TPU). The rules are
the card's: out within 1e-4·max|plain| + 1e-3·|plain| (chip_smoke.py
FLASH_TOL), the lse within chip_smoke.py lse_check's per-row bound
2⁻¹⁶·R + T·2⁻²³. The one-pass control misses the out rule by ≥ 2× only
where the softmax is concentrated on few keys (T = 191, and the peaked
inputs): over thousands of keys of near-equal weight the bf16 roundings
of P and V average out below that rule, and there the lse bound is the
check that sees a dropped lo (:data:`CASES`)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipdm_tpu_torch.ops.cuda import attention

HD = attention.HEAD_DIM
SCALE = 1.0 / math.sqrt(math.sqrt(HD))
TILE = 64          # keys per tile (flash_attn.cu BK)
KSTEP = 16         # bf16 wgmma's K step: head dims below it are padded
RTOL, ATOL_SHARE = 1e-3, 1e-4   # the f32 rule (chip_smoke.py FLASH_TOL)
LSE_EPS = 2.0 ** -16            # chip_smoke.py LSE_EPS["float32"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file (the suite's workers share the
    machine; see tests/test_torch_flash_bwd.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(T, seed, BH, kind, hd=HD):
    """q, k, v as f32 numpy [BH, T, hd]. ``random``: standard normal q, k;
    ``ragged``: chip_smoke.py flash_ragged's (q ≈ +a, k ≈ −a, sd a/4, with
    a = √8 / hd^¼ (1 at hd 64), so every live score is ≈ −8 and an
    unmasked zero key past T would dominate); ``peaked``: q, k of sd 2
    (scores of sd 4 at hd 64: each row's softmax on a few keys). v of
    head h has mean h + 1."""
    rng = np.random.default_rng(seed)
    if kind == "ragged":
        a = math.sqrt(8) / hd ** 0.25
        q = a * (1.0 + 0.25 * rng.standard_normal((BH, T, hd)))
        k = a * (-1.0 + 0.25 * rng.standard_normal((BH, T, hd)))
        sd = 0.5
    else:
        sd_qk = 2.0 if kind == "peaked" else 1.0
        q, k = (sd_qk * rng.standard_normal((BH, T, hd)) for _ in range(2))
        sd = 1.0
    v = sd * rng.standard_normal((BH, T, hd)) + np.arange(
        1, BH + 1)[:, None, None]
    return [a.astype(np.float32) for a in (q, k, v)]


def _pad_hd(x):
    """x [..., hd] zero-padded to max(hd, 16) columns: the operands as the
    kernel's shared-memory tiles hold them (hopper.cuh Head<HD>)."""
    hd = x.shape[-1]
    if hd >= KSTEP:
        return x
    return torch.cat([x, x.new_zeros(*x.shape[:-1], KSTEP - hd)], -1)


def _split(x):
    """x ≈ hi + lo, both bf16 values (held in f32)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _mm(a, b, body):
    """a @ b as the body's tensor cores take it, f32 sums: ``split``,
    hi·hi + hi·lo + lo·hi; ``one_pass``, hi·hi; ``exact``, a @ b in f32
    (no split: the tiling alone)."""
    if body == "exact":
        return a @ b
    (ah, al), (bh, bl) = _split(a), _split(b)
    if body == "one_pass":
        return ah @ bh
    return ah @ bh + ah @ bl + al @ bh


def fwd_body(q, k, v, scale, body="split", rows=None):
    """flash_attn.cu's f32 body on f32 [BH, T, hd] tensors for the query
    rows ``rows`` (all by default): q, k and v zero-padded to 16 columns
    below hd 16 (:func:`_pad_hd`: the pad adds zeros to Q·Kᵀ, and the
    output's pad columns are dropped), key tiles of 64 in order, keys past
    T zero-filled and scored −inf; per tile S by :func:`_mm`, the row max
    m ← max(m, rowmax(S)·c) with c = scale²·log2(e), P = exp2(S·c − m),
    l ← l·exp2(m_old − m) + Σ P (f32 P), O ← O·exp2(m_old − m) + P·V by
    :func:`_mm` (P split). Returns out = O / l and lse = (m + log2 l)·ln 2."""
    BH, T, hd = q.shape
    q, k, v = _pad_hd(q), _pad_hd(k), _pad_hd(v)
    c = scale * scale * math.log2(math.e)
    Q = q if rows is None else q[:, rows]
    n = -(-T // TILE)
    pad = torch.zeros(BH, n * TILE - T, q.shape[-1])
    K, V = torch.cat([k, pad], 1), torch.cat([v, pad], 1)
    m = torch.full(Q.shape[:2], -math.inf)
    l = torch.zeros(Q.shape[:2])
    o = torch.zeros(Q.shape)
    for j in range(n):
        s = _mm(Q, K[:, j * TILE:(j + 1) * TILE].transpose(1, 2), body)
        keys = j * TILE + torch.arange(TILE)
        s = s.masked_fill(keys >= T, -math.inf)
        mn = torch.maximum(m, s.max(-1).values * c)
        corr = torch.exp2(m - mn)
        p = torch.exp2(s * c - mn[..., None])
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + _mm(p, V[:, j * TILE:(j + 1) * TILE], body)
        m = mn
    return (o / l[..., None])[..., :hd], (m + torch.log2(l)) * math.log(2)


def _jax_reference(q, k, v, scale):
    """unet.py:659-663 on [BH, t, hd] queries against [BH, T, hd] keys in
    f32: out, the f32 scores' lse, and R = Σ_s P·Σ_d |q·s|·|k·s| per row
    (chip_smoke.py lse_check's size of the scores)."""
    q, k, v = (jnp.asarray(a) for a in (q, k, v))
    s = jnp.einsum("btd,bsd->bts", q * scale, k * scale,
                   preferred_element_type=jnp.float32)
    p = jax.nn.softmax(s, axis=-1)
    out = jnp.einsum("bts,bsd->btd", p.astype(q.dtype), v)
    R = jnp.sum(jnp.abs(q * scale)
                * jnp.einsum("bts,bsd->btd", p, jnp.abs(k * scale)), -1)
    return (np.asarray(out), np.asarray(jax.nn.logsumexp(s, axis=-1)),
            np.asarray(R))


def _over(got, want):
    """max |got − want| over the f32 rule 1e-4·max|want| + 1e-3·|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = ATOL_SHARE * np.abs(want).max() + RTOL * np.abs(want)
    return float((np.abs(got - want) / tol).max())


def _lse_over(lse, want, R, T):
    """max |lse − want| over lse_check's bound 2⁻¹⁶·R + T·2⁻²³."""
    tol = LSE_EPS * np.asarray(R, np.float64) + T * 2.0 ** -23
    return float((np.abs(np.asarray(lse, np.float64) - want) / tol).max())


# (T, inputs, BH, query rows, the checks that see the one-pass body):
# T = 7125 (the proj UNet's count, 43 dead keys in the last tile) checks
# only its first and last 64-row query tiles, against every key. There,
# on random inputs, neither check sees the one-pass body (it reads 0.31 of
# the out rule and 0.88 of the lse bound: the bound's T·2⁻²³ term grows
# with T): the case holds the three-pass body only, and the ragged and
# peaked inputs carry the control at that T.
CASES = [(191, "random", 2, "all", ("out", "lse")),
         (4097, "random", 1, "all", ("lse",)),
         (4097, "ragged", 2, "all", ("lse",)),
         (4097, "peaked", 1, "all", ("out", "lse")),
         (7125, "random", 1, "ends", ()),
         (7125, "ragged", 1, "ends", ("lse",)),
         (7125, "peaked", 1, "ends", ("out", "lse"))]


@pytest.mark.parametrize("T,kind,BH,rows,control", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_f32_split_body_gate(T, kind, BH, rows, control):
    """The three-pass body meets the f32 rule in out and lse_check's bound
    in the lse against the JAX package's attention; the one-pass body
    misses by ≥ 2× each check in ``control`` (see the module's note)."""
    q, k, v = _inputs(T, 5, BH, kind)
    idx = None
    if rows == "ends":
        idx = torch.cat([torch.arange(TILE),
                         torch.arange(T - T % TILE or T - TILE, T)])
    qr = q if idx is None else q[:, idx.numpy()]
    want, want_lse, R = _jax_reference(qr, k, v, SCALE)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = fwd_body(tq, tk, tv, SCALE, "split", idx)
    assert _over(out, want) <= 1.0
    assert _lse_over(lse, want_lse, R, T) <= 1.0
    c_out, c_lse = fwd_body(tq, tk, tv, SCALE, "one_pass", idx)
    missed = {"out": _over(c_out, want),
              "lse": _lse_over(c_lse, want_lse, R, T)}
    for name in control:
        assert missed[name] >= 2.0, (name, missed)


def test_body_without_split_is_the_plain_forward():
    """The body's tiling with exact f32 products (no split) is the plain
    forward: on ragged inputs at T = 130 (two live keys in the last tile)
    its out and lse equal attention_lse_plain's to f32 rounding. So what
    the gate measures is the split, not the tiling."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(130, 2, 2, "ragged"))
    out, lse = fwd_body(q, k, v, SCALE, "exact")
    pout, plse = attention.attention_lse_plain(q, k, v, SCALE)
    torch.testing.assert_close(out, pout, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)


# the gate at the other head dims the kernels are instantiated for
# (FLASH_HEAD_DIMS; hd 8 on operands zero-padded to 16; hd 128 in two
# 64-column sub-tiles, the same sums per column): (T, inputs, BH,
# the checks that see the one-pass body at every one of them). With fewer
# products in each score the dropped lo halves move the out of the random
# inputs less (1.95× the rule at hd 32, T = 191): there the lse bound
# carries the control (≥ 23×), and the peaked inputs carry both (≥ 50×)
HD_CASES = [(191, "random", 2, ("lse",)),
            (4097, "ragged", 1, ("lse",)),
            (4097, "peaked", 1, ("out", "lse"))]


@pytest.mark.parametrize("T,kind,BH,control", HD_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in HD_CASES])
@pytest.mark.parametrize("hd", [8, 16, 32, 128])
def test_f32_split_body_gate_small_head_dims(hd, T, kind, BH, control):
    """test_f32_split_body_gate at head dim ``hd`` (the scale 1/√√hd): the
    three-pass body on the kernel's padded tiles meets the f32 rule and
    the lse bound against the JAX package's attention; the one-pass body
    misses each check in ``control`` by ≥ 2×."""
    scale = 1.0 / math.sqrt(math.sqrt(hd))
    q, k, v = _inputs(T, 7, BH, kind, hd)
    want, want_lse, R = _jax_reference(q, k, v, scale)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = fwd_body(tq, tk, tv, scale, "split")
    assert out.shape == tq.shape
    assert _over(out, want) <= 1.0
    assert _lse_over(lse, want_lse, R, T) <= 1.0
    c_out, c_lse = fwd_body(tq, tk, tv, scale, "one_pass")
    missed = {"out": _over(c_out, want),
              "lse": _lse_over(c_lse, want_lse, R, T)}
    for name in control:
        assert missed[name] >= 2.0, (name, missed)
