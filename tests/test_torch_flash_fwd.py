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
check that sees a dropped lo (:data:`CASES`).

At head dim 8 the f32 forward runs its own body (csrc/flash_narrow.cu):
the same three passes over key tiles of 128, with P split by truncation
(hi = the top 16 bits of p, lo = bf16(p − hi)) and the row sum l taken
from P·V's column of ones, Σ (P_hi + P_lo); ``fwd_body(..., "narrow")``
writes it out and
:func:`test_f32_narrow_body_gate` holds it to the same rules.

From head dim 128 up the f32 forward runs the wide body
(csrc/flash_attn.cu flash_wide_kernel): S summed over 64-column chunks of
the head dim, O held in slices of 256 columns (one CTA each; S built
once a slice), each chunk's P·V summed from zero; :func:`wide_body`
writes it out and :func:`test_f32_wide_body_gate` holds it to the same
rules beside two planted faults (the lo dropped; a slice whose S sums its
own chunks alone)."""

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
NARROW_TILE = 128  # keys per tile of the narrow body (flash_narrow.cu BK)
KSTEP = 16         # bf16 wgmma's K step: head dims below it are padded
CHUNK = 64         # the wide body's column chunk (hopper.cuh WIDE_CHUNK)
WIDE_SLICE = 4     # chunks of O a wide-body CTA holds (IPDM_WIDE_SLICE)
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


def _trunc_bf16(x):
    """x with its mantissa cut to bf16's (the top 16 bits of its f32
    bits kept), a bf16 value."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


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


def wide_body(q, k, v, scale, body="wide"):
    """flash_attn.cu's wide body (every head dim from 128 up, f32) on f32
    [BH, T, hd] tensors: hd zero-padded to a multiple of :data:`CHUNK`;
    O's columns in slices of :data:`WIDE_SLICE` chunks (one CTA each, the
    last one partial where the chunks do not divide), each slice running
    the key tiles of 64 in order on its own: S summed chunk by chunk over
    the head dim, S += Q_c·K_cᵀ by :func:`_mm` (split), the online softmax
    as :func:`fwd_body`'s, and for each of the slice's chunks the tile's
    P·V_c summed from zero (P split) and added to the rescaled O_c; the
    lse from the first slice. Planted faults: ``wide_one_pass``, every
    product hi·hi alone (the lo dropped); ``wide_own``, each slice's S
    summed over its own chunks alone. ``wide_exact``: exact f32 products
    (the slicing and chunking alone). Returns out and lse."""
    BH, T, hd = q.shape
    wide = -(-hd // CHUNK) * CHUNK
    q, k, v = (torch.cat([x, x.new_zeros(BH, T, wide - hd)], -1)
               for x in (q, k, v))
    nc = wide // CHUNK
    mm = {"wide_one_pass": "one_pass", "wide_exact": "exact"}.get(body,
                                                                  "split")
    c = scale * scale * math.log2(math.e)
    n = -(-T // TILE)
    pad = torch.zeros(BH, n * TILE - T, wide)
    K, V = torch.cat([k, pad], 1), torch.cat([v, pad], 1)
    outs, lse = [], None
    for c0 in range(0, nc, WIDE_SLICE):
        own = range(c0, min(nc, c0 + WIDE_SLICE))
        s_chunks = own if body == "wide_own" else range(nc)
        m = torch.full((BH, T), -math.inf)
        l = torch.zeros(BH, T)
        o = [torch.zeros(BH, T, CHUNK) for _ in own]
        for j in range(n):
            kt, vt = (x[:, j * TILE:(j + 1) * TILE] for x in (K, V))
            s = torch.zeros(BH, T, TILE)
            for ch in s_chunks:
                cols = slice(ch * CHUNK, (ch + 1) * CHUNK)
                s = s + _mm(q[..., cols], kt[..., cols].transpose(1, 2), mm)
            s = s.masked_fill(j * TILE + torch.arange(TILE) >= T, -math.inf)
            mn = torch.maximum(m, s.max(-1).values * c)
            corr = torch.exp2(m - mn)
            p = torch.exp2(s * c - mn[..., None])
            l = l * corr + p.sum(-1)
            for i, ch in enumerate(own):
                pv = _mm(p, vt[..., ch * CHUNK:(ch + 1) * CHUNK], mm)
                o[i] = o[i] * corr[..., None] + pv
            m = mn
        outs += [x / l[..., None] for x in o]
        if lse is None:
            lse = (m + torch.log2(l)) * math.log(2)
    return torch.cat(outs, -1)[..., :hd], lse


def fwd_body(q, k, v, scale, body="split", rows=None):
    """flash_attn.cu's f32 body on f32 [BH, T, hd] tensors for the query
    rows ``rows`` (all by default): q, k and v zero-padded to 16 columns
    below hd 16 (:func:`_pad_hd`: the pad adds zeros to Q·Kᵀ, and the
    output's pad columns are dropped), key tiles of 64 in order, keys past
    T zero-filled and scored −inf; per tile S by :func:`_mm`, the row max
    m ← max(m, rowmax(S)·c) with c = scale²·log2(e), P = exp2(S·c − m),
    l ← l·exp2(m_old − m) + Σ P (f32 P), O ← O·exp2(m_old − m) + P·V by
    :func:`_mm` (P split). ``narrow`` (csrc/flash_narrow.cu, head dim 8):
    key tiles of :data:`NARROW_TILE`, S as ``split``, P split by
    truncation (:func:`_trunc_bf16`, lo = bf16(P − hi)), P·V as
    P_hi·V_hi + P_hi·V_lo + P_lo·V_hi and l summed from P_hi + P_lo (V's
    column of ones). Returns out = O / l and lse = (m + log2 l)·ln 2."""
    BH, T, hd = q.shape
    q, k, v = _pad_hd(q), _pad_hd(k), _pad_hd(v)
    c = scale * scale * math.log2(math.e)
    Q = q if rows is None else q[:, rows]
    tile = NARROW_TILE if body == "narrow" else TILE
    n = -(-T // tile)
    pad = torch.zeros(BH, n * tile - T, q.shape[-1])
    K, V = torch.cat([k, pad], 1), torch.cat([v, pad], 1)
    m = torch.full(Q.shape[:2], -math.inf)
    l = torch.zeros(Q.shape[:2])
    o = torch.zeros(Q.shape)
    for j in range(n):
        s = _mm(Q, K[:, j * tile:(j + 1) * tile].transpose(1, 2),
                "split" if body == "narrow" else body)
        keys = j * tile + torch.arange(tile)
        s = s.masked_fill(keys >= T, -math.inf)
        mn = torch.maximum(m, s.max(-1).values * c)
        corr = torch.exp2(m - mn)
        p = torch.exp2(s * c - mn[..., None])
        vt = V[:, j * tile:(j + 1) * tile]
        if body == "narrow":
            ph = _trunc_bf16(p)
            pl = (p - ph).to(torch.bfloat16).float()
            vh, vl = _split(vt)
            l = l * corr + (ph + pl).sum(-1)
            o = o * corr[..., None] + (ph @ vh + ph @ vl + pl @ vh)
        else:
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + _mm(p, vt, body)
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


@pytest.mark.parametrize("T,kind,BH,control", HD_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in HD_CASES])
def test_f32_narrow_body_gate(T, kind, BH, control):
    """The head-dim-8 f32 body of csrc/flash_narrow.cu (``fwd_body(...,
    "narrow")``: P split by truncation, the row sums from P·V's column of
    ones) meets the f32 rule and the lse bound against the JAX package's
    attention, as the template's body does; the one-pass body misses each
    check in ``control`` by ≥ 2×; and the truncated split stays within
    2⁻¹⁶ of p (the rounded split's 2⁻¹⁷, twice as coarse)."""
    hd = 8
    scale = 1.0 / math.sqrt(math.sqrt(hd))
    q, k, v = _inputs(T, 7, BH, kind, hd)
    want, want_lse, R = _jax_reference(q, k, v, scale)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = fwd_body(tq, tk, tv, scale, "narrow")
    assert out.shape == tq.shape
    assert _over(out, want) <= 1.0
    assert _lse_over(lse, want_lse, R, T) <= 1.0
    c_out, c_lse = fwd_body(tq, tk, tv, scale, "one_pass")
    missed = {"out": _over(c_out, want),
              "lse": _lse_over(c_lse, want_lse, R, T)}
    for name in control:
        assert missed[name] >= 2.0, (name, missed)
    p = torch.rand(1 << 16) + 2.0 ** -30
    hi = _trunc_bf16(p)
    lo = (p - hi).to(torch.bfloat16).float()
    assert float(((hi + lo - p).abs() / p).max()) <= 2.0 ** -16


# the wide body (csrc/flash_attn.cu flash_wide_kernel: every head dim from
# 128 up in 64-column chunks, O in slices of 4 chunks) at head dims 128
# (one slice of 2 chunks), 192 (one of 3) and 320 (a slice of 4, then a
# partial one of 1), on random and ragged inputs at T = 191 and 385 (a
# last key tile of 63 and of 1 live keys). On these the dropped lo moves
# the lse by 4.3-27× its bound (the out by 0.49-4.3×: the lse carries that
# control), and a slice whose S sums its own chunks alone misses both
# checks by ≥ 6× at hd 320
WIDE_CASES = [(hd, T, kind) for hd in (128, 192, 320) for T in (191, 385)
              for kind in ("random", "ragged")]


@pytest.mark.parametrize("hd,T,kind", WIDE_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in WIDE_CASES])
def test_f32_wide_body_gate(hd, T, kind):
    """The wide body's sum order (:func:`wide_body`) meets the f32 rule in
    out and lse_check's bound in the lse against the JAX package's
    attention; the body with the lo dropped misses the lse bound by ≥ 2×,
    and at hd 320 the body whose second slice's S sums only its own
    chunk misses both by ≥ 2×."""
    scale = 1.0 / math.sqrt(math.sqrt(hd))
    q, k, v = _inputs(T, 11, 2, kind, hd)
    want, want_lse, R = _jax_reference(q, k, v, scale)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = wide_body(tq, tk, tv, scale)
    assert out.shape == tq.shape
    assert _over(out, want) <= 1.0
    assert _lse_over(lse, want_lse, R, T) <= 1.0
    _, c_lse = wide_body(tq, tk, tv, scale, "wide_one_pass")
    assert _lse_over(c_lse, want_lse, R, T) >= 2.0
    if hd > WIDE_SLICE * CHUNK:
        c_out, c_lse = wide_body(tq, tk, tv, scale, "wide_own")
        assert _over(c_out, want) >= 2.0
        assert _lse_over(c_lse, want_lse, R, T) >= 2.0


def test_wide_body_without_split_is_the_plain_forward():
    """The wide body's slices and chunks with exact f32 products are the
    plain forward: at hd 320 (two slices, the second partial) on ragged
    inputs at T = 130 its out and lse equal attention_lse_plain's to f32
    rounding, so the gate above measures the split, not the slicing."""
    hd = 320
    scale = 1.0 / math.sqrt(math.sqrt(hd))
    q, k, v = (torch.from_numpy(a) for a in _inputs(130, 2, 2, "ragged", hd))
    out, lse = wide_body(q, k, v, scale, "wide_exact")
    pout, plse = attention.attention_lse_plain(q, k, v, scale)
    torch.testing.assert_close(out, pout, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-5)
