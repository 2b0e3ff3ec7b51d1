"""The flash attention's backward of the port (ipdm_tpu_torch/ops/cuda/
attention.py) on the CPU.

* attention_bwd_plain, the formulas written out from the forward's saved
  output and lse, against jax.vjp of JAX's attention: the library's
  mha_reference (jax/experimental/pallas/ops/tpu/flash_attention.py,
  whose backward the two Pallas kernels _flash_attention_bwd_dkv :941 and
  _flash_attention_bwd_dq :1287 compute) and the einsum path of
  ipdm_tpu/models/unet.py:659-662, in f32 and bf16, at ragged T.
* A CPU write-out of the CUDA kernels' tiling (csrc/flash_attn.cu's
  tile order with f32 products, csrc/flash_bwd.cu): 64-row tiles, rows past T staged as zeros, the
  online softmax and lse over key tiles in order, D = rowsum(dO·O), dQ
  per query tile over key tiles in order, dK and dV per key tile over
  query tiles in order, keys past T masked in the forward and the dQ
  kernel and query rows past T in the dK/dV kernel; each product as the
  backward's bodies take it (bf16: P and dS rounded to bf16; f32: three
  bf16 passes of split operands); held to the plain functions and to
  jax.vjp of the library's reference, with planted faults (D dropped,
  the key mask dropped, the f32 body's lo halves dropped) that must miss
  the tolerance.
* The f32 body at head dim 8 (csrc/flash_narrow_bwd.cu), written out as
  ``bwd_tiles(..., body="narrow")``: 128-row ring tiles, the lse and D
  terms inside the score products, P and dS split by truncation, the
  n16 + n8 products; held to the f32 rules beside planted faults (every
  lo dropped; D from the unsplit dO).
* The wide body (csrc/flash_bwd.cu flash_bwd_wide_kernel: f32 from head
  dim 128, bf16 from 192), written out as ``bwd_tiles(..., body="wide")``
  (and ``"wide_bf16"``; ``split``, ``one_pass`` and ``bf16`` reach it at
  those widths): 64-row ring tiles in order, S and dP summed chunk by
  chunk over the whole head dim once per ring tile and output slice (dq
  256 columns, dkv 128 of dK and of dV), the slice's products per chunk;
  held to the plain backward, the f32 rule plus the f64 witness, and in
  bf16 to jax.vjp of the library's reference, beside planted faults (a
  partial slice's columns from the wrong chunk, D dropped, the lo halves
  dropped)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import \
    mha_reference_no_custom_vjp

from ipdm_tpu_torch.ops.cuda import _build, attention

TILE = 64      # rows per tile: flash_attn.cu BK, flash_bwd.cu BN
KSTEP = 16     # bf16 wgmma's K step: head dims below it are padded
HD = attention.HEAD_DIM
SCALE = 1.0 / math.sqrt(math.sqrt(HD))

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small tensors: with the suite's
    workers all on one machine, torch's default of a thread per core makes
    each small op wait on descheduled threads (a 3 s test took 500 s with
    six workers at eight threads each, 12 s at one)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)



def _inputs(T, seed, BH=2, ragged=False, hd=HD):
    """q, k, v, dO as f32 numpy [BH, T, hd]. ``ragged``: q ≈ +a and
    k ≈ −a plus noise (a = √8 / hd^¼, 1 at hd 64), so live scores are
    ≈ −8 and a zero key row past T that escaped a mask (score 0) would
    dominate the softmax."""
    rng = np.random.default_rng(seed)
    if ragged:
        a = math.sqrt(8) / hd ** 0.25
        q = a * (1.0 + 0.25 * rng.standard_normal((BH, T, hd)))
        k = a * (-1.0 + 0.25 * rng.standard_normal((BH, T, hd)))
    else:
        q, k = (rng.standard_normal((BH, T, hd)) for _ in range(2))
    v = rng.standard_normal((BH, T, hd)) + np.arange(1, BH + 1)[:, None,
                                                                None]
    do = rng.standard_normal((BH, T, hd))
    return [a.astype(np.float32) for a in (q, k, v, do)]


def _close(got, want, name, rel, absmax, extra=0.0):
    """|got − want| ≤ absmax·max|want| + rel·|want| (+ a per-entry
    allowance ``extra``) per tensor."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = (absmax * np.abs(want).max() + rel * np.abs(want)
           + np.asarray(extra, np.float64))
    over = float((np.abs(got - want) / tol).max())
    assert over <= 1.0, (name, over, float(np.abs(got - want).max()))
    return over


# f32: sums over T terms in another order (the grad phase's rule);
# bf16: the operands, P and the outputs round to bf16 at other points
TOL = {torch.float32: (1e-3, 1e-4), torch.bfloat16: (2e-2, 2e-2)}


def _einsum_attention(q, k, v, scale):
    """The JAX package's einsum path (unet.py:659-662) on [BH, T, hd]."""
    s = jnp.einsum("btd,bsd->bts", q * scale, k * scale,
                   preferred_element_type=jnp.float32)
    p = jax.nn.softmax(s, axis=-1).astype(q.dtype)
    return jnp.einsum("bts,bsd->btd", p, v)


def _library_attention(q, k, v, scale):
    """The library's mha_reference on [B=1, heads, T, hd] with its one
    sm_scale = scale², as _flash_attention calls the kernel."""
    return mha_reference_no_custom_vjp(q[None], k[None], v[None],
                                       sm_scale=scale * scale)[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("T", [70, 131])
@pytest.mark.parametrize("ref", ["einsum", "library"])
def test_bwd_plain_matches_jax_vjp(dtype, T, ref):
    """dq, dk, dv of attention_bwd_plain (from attention_lse_plain's out
    and lse) against jax.vjp of the JAX attention at T not a multiple of
    the kernels' 64-row tiles; the lse against the library's saved m and l
    (lse = m + log l). The library's reference in bf16 would take its
    logits and softmax in bf16, where its kernels (and the port's) sum in
    f32: in bf16 it is held on the bf16-rounded inputs in f32."""
    q, k, v, do = _inputs(T, seed=T)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    fn = _einsum_attention if ref == "einsum" else _library_attention
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jdt) for a in (q, k, v, do))
    if ref == "library":
        jq, jk, jv, jdo = (a.astype(jnp.float32) for a in (jq, jk, jv, jdo))
    jout, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, SCALE), jq, jk, jv)
    want = vjp(jdo)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(dtype) for a in (q, k, v, do))
    out, lse = attention.attention_lse_plain(tq, tk, tv, SCALE)
    got = attention.attention_bwd_plain(tq, tk, tv, out, lse, tdo, SCALE)
    rel, absmax = TOL[dtype]
    _close(out.float(), np.asarray(jout, np.float32), "out", rel, absmax)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g.float(), np.asarray(w, np.float32), name, rel, absmax)
    if ref == "library" and dtype == torch.float32:
        _, l, m = mha_reference_no_custom_vjp(
            jnp.asarray(q)[None], jnp.asarray(k)[None], jnp.asarray(v)[None],
            sm_scale=SCALE * SCALE, save_residuals=True)
        np.testing.assert_allclose(lse.numpy(), np.asarray(
            m[0] + jnp.log(l[0])), rtol=1e-5, atol=1e-5)


# -- the kernels' tiling, written out ----------------------------------------

def _tiles(x, T):
    """[BH, T, hd] → [BH, ntiles, 64, hdp], rows past T and, below hd 16,
    the columns past hd zeros (the tiles' zero fill by TMA; hdp =
    max(hd, 16), hopper.cuh Head<HD>)."""
    n = -(-T // TILE)
    hdp = max(x.shape[-1], KSTEP)
    out = torch.zeros(x.shape[0], n * TILE, hdp, dtype=torch.float32)
    out[:, :T, :x.shape[-1]] = x.float()
    return out.view(x.shape[0], n, TILE, hdp)


def fwd_tiles(q, k, v, scale, mask=True):
    """flash_attn.cu's order with f32 products (its three-pass body is
    tests/test_torch_flash_fwd.py's gate): per 64-row query tile, key
    tiles in order, the online softmax in the log2 domain; keys ≥ T score
    −inf (``mask``). Returns out [BH, T, 64] and lse [BH, T]."""
    BH, T, hd = q.shape
    c2 = scale * scale * math.log2(math.e)
    Q, K, V = _tiles(q, T), _tiles(k, T), _tiles(v, T)
    n, hdp = Q.shape[1], Q.shape[3]
    out = torch.zeros(BH, n * TILE, hdp)
    lse = torch.zeros(BH, n * TILE)
    for qt in range(n):
        m = torch.full((BH, TILE), -math.inf)
        l = torch.zeros(BH, TILE)
        o = torch.zeros(BH, TILE, hdp)
        for kt in range(n):
            s = Q[:, qt] @ K[:, kt].transpose(1, 2) * c2
            if mask:
                keys = kt * TILE + torch.arange(TILE)
                s = s.masked_fill(keys >= T, -math.inf)
            mn = torch.maximum(m, s.max(-1).values)
            corr = torch.exp2(m - mn)
            p = torch.exp2(s - mn[..., None])
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + p @ V[:, kt]
            m = mn
        out[:, qt * TILE:(qt + 1) * TILE] = o / l[..., None]
        lse[:, qt * TILE:(qt + 1) * TILE] = (m + torch.log2(l)) * math.log(2)
    return out[:, :T, :hd], lse[:, :T]


def _split(x):
    """x ≈ hi + lo, hi = bf16(x), lo = bf16(x − hi): an f32 operand as two
    bf16 operands (the f32 body's staging)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _mm(a, b, body):
    """a @ b as a body's tensor cores take it, f32 sums: ``bf16``, the
    operands as given (bf16 values); ``split``, three bf16 passes
    hi·hi + hi·lo + lo·hi of the split operands (lo·lo dropped);
    ``one_pass``, the planted fault of the split with every lo dropped."""
    if body == "bf16":
        return a @ b
    (ah, al), (bh, bl) = _split(a), _split(b)
    if body == "one_pass":
        return ah @ bh
    return ah @ bh + ah @ bl + al @ bh


def _weights(x, body):
    """P or dS as the A operand of a product: rounded to bf16 in the bf16
    body (flash_attention.py:900, :918, :1258), split in the f32 body."""
    return x.to(torch.bfloat16).float() if body == "bf16" else x


NARROW_TILE = 128  # ring rows a tile of csrc/flash_narrow_bwd.cu (BK)
NARROW_BODIES = ("narrow", "narrow_one_pass", "narrow_d_unsplit")


def _split3(x):
    """x (f32) as three bf16 values, hi + mid + lo: its 24 bits (the
    narrow backward's lse and D terms)."""
    hi = x.to(torch.bfloat16).float()
    r = x - hi
    mid = r.to(torch.bfloat16).float()
    return hi, mid, (r - mid).to(torch.bfloat16).float()


def _trunc_split(x):
    """P or dS as the narrow backward splits them: hi = the top 16 bits of
    x (truncated), lo = bf16(x − hi)."""
    hi = (x.view(torch.int32) & -65536).view(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).float()


def _narrow_bwd(q, k, v, out, lse, do, scale, body):
    """csrc/flash_narrow_bwd.cu at head dim 8 in f32: D = rowsum(dO·O)
    with the dO the products see (``narrow_d_unsplit``: the unsplit dO, a
    planted fault); ring tiles of :data:`NARROW_TILE` rows in order (keys
    in dq, queries in dkv), rows ≥ T at P = 0; S' = x_hi u_hi + x_hi u_lo
    + x_lo u_hi − (lse·log2 e as three bf16) with x = fl(c·log2 e·q) (the
    resident rows, c = scale²), dP − D = do_hi v_hi + do_hi v_lo + do_lo
    v_hi − (D as three bf16), P = exp2(S'), dS = P·(dP − D); P and dS split
    by truncation (:func:`_trunc_split`); each tile's N = 8 products hi·hi
    + lo·hi (the first 8 columns) and hi·lo (the next 8) summed from zero,
    the two halves added to the outputs in f32. ``narrow_one_pass`` (a
    planted fault) drops every lo. Returns dq, dk, dv in f32."""
    BH, T, hd = q.shape
    c, c2 = scale * scale * math.log2(math.e), scale * scale
    one_pass = body == "narrow_one_pass"

    def split(x):
        hi, lo = _split(x.float())
        return hi, torch.zeros_like(lo) if one_pass else lo

    def split_pd(x):
        hi, lo = _trunc_split(x)
        return hi, torch.zeros_like(lo) if one_pass else lo

    dof = do.float()
    seen = dof if body == "narrow_d_unsplit" else sum(_split(dof))
    D3 = sum(_split3((out.float() * seen).sum(-1)))
    L3 = sum(_split3(lse.float() * math.log2(math.e)))
    qs, ks, vs, ds_ = (split(x) for x in (q, k, v, do))
    cq, ck = split(q.float() * c), split(k.float() * c)

    def mm3(a, b):  # hi·hi + hi·lo + lo·hi over the last dims
        return a[0] @ b[0].mT + a[0] @ b[1].mT + a[1] @ b[0].mT

    def tile_sum(p, b):  # the N = 8 product of one tile, halves added
        ph, pl = split_pd(p)
        return (ph @ b[0] + pl @ b[0]) + ph @ b[1]

    dq = torch.zeros(BH, T, hd)
    dk = torch.zeros(BH, T, hd)
    dv = torch.zeros(BH, T, hd)
    for j0 in range(0, T, NARROW_TILE):
        j = slice(j0, min(T, j0 + NARROW_TILE))
        # dq: resident queries against the key tile j
        p = torch.exp2(mm3(cq, tuple(x[:, j] for x in ks)) - L3[..., None])
        dsm = p * (mm3(ds_, tuple(x[:, j] for x in vs)) - D3[..., None])
        dq += tile_sum(dsm, tuple(x[:, j] for x in ks))
        # dk, dv: resident keys against the query tile j
        pt = torch.exp2(mm3(ck, tuple(x[:, j] for x in qs))
                        - L3[:, None, j])
        dst = pt * (mm3(vs, tuple(x[:, j] for x in ds_)) - D3[:, None, j])
        dv += tile_sum(pt, tuple(x[:, j] for x in ds_))
        dk += tile_sum(dst, tuple(x[:, j] for x in qs))
    return dq * c2, dk * c2, dv


WIDE_CHUNK = _build.FLASH_WIDE_CHUNK   # the wide body's column chunk
# chunks of each output a wide-body CTA holds (csrc/flash_bwd.cu
# IPDM_WBWD_DQ_SLICE, IPDM_WBWD_DKV_SLICE); where dkv's paired slice does
# not cover the head dim, dK and dV are held dq's count at a time
WIDE_BWD_SLICE = {k[len("flash_bwd_"):]: c // WIDE_CHUNK
                  for k, c in _build.FLASH_BWD_WIDE_SLICE.items()}
# the wide body's bodies: (the products' body for _mm, P and dS rounded
# to bf16)
WIDE_BODIES = {"wide": ("split", False), "wide_one_pass": ("one_pass", False),
               "wide_bf16": ("bf16", True), "wide_exact": ("bf16", False),
               "wide_wrong_chunk": ("split", False)}


def _wide_bwd(q, k, v, out, lse, do, scale, body="wide", drop_d=False,
              mask=True):
    """csrc/flash_bwd.cu's wide body on [BH, T, hd] tensors: hd
    zero-padded to a multiple of :data:`WIDE_CHUNK`; D = rowsum(dO·O) with
    the dO the products see (``drop_d`` plants its loss); the resident
    rows (queries in dq, keys in dkv; 128 a CTA, 64 a warpgroup; where
    dkv's slice holds one output each, 64 keys a CTA, dV and S in one
    warpgroup, dK and dP in the other, P handed over: the rows are
    independent, so they run side by side here) against the 64-row
    ring tiles in order. Per output slice (dq :data:`WIDE_BWD_SLICE`
    ["dq"] chunks; dkv ["dkv"] chunks of dK and of dV, or where those do
    not cover the head dim ["dq"] chunks of each; the last partial where
    the chunks do not divide) and ring tile,
    S = Σ_c X_c·U_cᵀ and
    dP = Σ_c Y_c·W_cᵀ over the nc chunks in order (by :func:`_mm` of the
    body), P = exp2(c·S − lse₂) (ring rows ≥ T at 0: keys in dq with
    ``mask``, queries in dkv), dS = P·(dP − D), then for each of the
    slice's chunks h the tile's dQ_h += dS·U_{c0+h} (dK_h += dSᵀ·U_{c0+h},
    dV_h += Pᵀ·W_{c0+h}), chained over the ring tiles. Bodies
    (:data:`WIDE_BODIES`): ``wide`` (f32, three bf16 passes), ``wide_bf16``
    (P and dS rounded to bf16), the planted ``wide_one_pass`` (every lo
    dropped) and ``wide_wrong_chunk`` (a partial slice's products read
    chunk h, not c0 + h), and ``wide_exact`` (exact f32 products: the
    slicing and chunking alone). Returns dq, dk, dv in f32."""
    mm_body, rounds = WIDE_BODIES[body]
    BH, T, hd = q.shape
    wide = -(-hd // WIDE_CHUNK) * WIDE_CHUNK
    nc = wide // WIDE_CHUNK
    c2, c = scale * scale * math.log2(math.e), scale * scale
    dof = do.float()
    if mm_body != "bf16":   # D from the dO the products see
        dof = sum(_split(dof)) if mm_body == "split" else _split(dof)[0]
    D = (out.float() * dof).sum(-1)
    if drop_d:
        D = torch.zeros_like(D)
    n = -(-T // TILE)
    rows = n * TILE

    def pad(x):
        p = torch.zeros(BH, rows, wide)
        p[:, :T, :hd] = x.float()
        return p
    Q, K, V, dO = (pad(x) for x in (q, k, v, do))
    lse2 = torch.full((BH, rows), math.inf)
    lse2[:, :T] = lse * math.log2(math.e)
    Dp = torch.zeros(BH, rows)
    Dp[:, :T] = D
    live = torch.arange(rows) < T
    mm = lambda a, b: _mm(a, b, mm_body)
    weights = lambda x: x.to(torch.bfloat16).float() if rounds else x

    def chunk(x, ch):
        return x[..., ch * WIDE_CHUNK:(ch + 1) * WIDE_CHUNK]

    def slices(kind):
        sl = WIDE_BWD_SLICE[kind]
        if kind == "dkv" and nc > sl:
            sl = WIDE_BWD_SLICE["dq"]   # dK and dV each held apart
        for c0 in range(0, nc, sl):
            nz = min(sl, nc - c0)
            wrong = body == "wide_wrong_chunk" and nz < sl
            yield c0, [h if wrong else c0 + h for h in range(nz)]

    def scores(x, y, u, w):  # S and dP over the nc chunks in order
        s = torch.zeros(*x.shape[:2], u.shape[1])
        dp = torch.zeros_like(s)
        for ch in range(nc):
            s = s + mm(chunk(x, ch), chunk(u, ch).transpose(1, 2))
            dp = dp + mm(chunk(y, ch), chunk(w, ch).transpose(1, 2))
        return s, dp

    dq = torch.zeros(BH, rows, wide)
    for c0, src in slices("dq"):
        acc = [torch.zeros(BH, rows, WIDE_CHUNK) for _ in src]
        for j in range(n):
            t = slice(j * TILE, (j + 1) * TILE)
            s, dp = scores(Q, dO, K[:, t], V[:, t])
            p = torch.exp2(s * c2 - lse2[..., None])
            if mask:
                p = p * live[t]
            ds = weights(p * (dp - Dp[..., None]))
            for h, ch in enumerate(src):
                acc[h] = acc[h] + mm(ds, chunk(K[:, t], ch))
        dq[..., c0 * WIDE_CHUNK:(c0 + len(src)) * WIDE_CHUNK] = \
            torch.cat(acc, -1) * c
    dk = torch.zeros(BH, rows, wide)
    dv = torch.zeros(BH, rows, wide)
    for c0, src in slices("dkv"):
        ak = [torch.zeros(BH, rows, WIDE_CHUNK) for _ in src]
        av = [torch.zeros(BH, rows, WIDE_CHUNK) for _ in src]
        for j in range(n):
            t = slice(j * TILE, (j + 1) * TILE)
            st, dpt = scores(K, V, Q[:, t], dO[:, t])
            pt = torch.exp2(st * c2 - lse2[:, None, t]) * live[t]
            dst = pt * (dpt - Dp[:, None, t])
            pt, dst = weights(pt), weights(dst)
            for h, ch in enumerate(src):
                ak[h] = ak[h] + mm(dst, chunk(Q[:, t], ch))
                av[h] = av[h] + mm(pt, chunk(dO[:, t], ch))
        cols = slice(c0 * WIDE_CHUNK, (c0 + len(src)) * WIDE_CHUNK)
        dk[..., cols] = torch.cat(ak, -1) * c
        dv[..., cols] = torch.cat(av, -1)
    return tuple(x[:, :T, :hd] for x in (dq, dk, dv))


def _runs_wide(hd, body) -> bool:
    """Whether the card runs head dim ``hd`` (padded as the wrappers pad
    it) on the wide body (_build.FLASH_BWD_WIDE_FROM, both dtypes)."""
    return attention.flash_instance(hd) >= _build.FLASH_BWD_WIDE_FROM


def bwd_tiles(q, k, v, out, lse, do, scale, drop_d=False, mask=True,
              body="split"):
    """flash_bwd.cu: D = rowsum(dO·O) (flash_bwd_dot_kernel, with the dO
    the products see; ``drop_d`` plants its loss); dQ per query tile over
    key tiles in order, keys ≥ T masked (``mask``); dK and dV per key tile
    over query tiles in order, query rows ≥ T at P = 0. Every product runs
    as ``body`` takes it (:func:`_mm`): ``bf16`` (bf16 operands, P and dS
    rounded to bf16 before the products that read them) or ``split`` (f32
    operands, each product three bf16 passes), or the fault ``one_pass``;
    or ``narrow`` (head dim 8 in f32: csrc/flash_narrow_bwd.cu, written
    out by :func:`_narrow_bwd`, with its faults ``narrow_one_pass`` and
    ``narrow_d_unsplit``); or the wide body (:func:`_wide_bwd`), by name
    (:data:`WIDE_BODIES`) or where the card runs ``split``, ``one_pass``
    or ``bf16`` on it (:func:`_runs_wide`). Returns dq, dk, dv in f32
    (below hd 16 on the tiles' zero-padded columns, the pad dropped)."""
    if body in NARROW_BODIES:
        return _narrow_bwd(q, k, v, out, lse, do, scale, body)
    if body in ("split", "one_pass", "bf16") and _runs_wide(q.shape[-1],
                                                          body):
        body = {"split": "wide", "one_pass": "wide_one_pass",
                "bf16": "wide_bf16"}[body]
    if body in WIDE_BODIES:
        return _wide_bwd(q, k, v, out, lse, do, scale, body, drop_d, mask)
    BH, T, hd = q.shape
    c2, c = scale * scale * math.log2(math.e), scale * scale
    dof = do.float()
    if body != "bf16":   # D from the dO the products see
        dof = sum(_split(dof)) if body == "split" else _split(dof)[0]
    D = (out.float() * dof).sum(-1)
    if drop_d:
        D = torch.zeros_like(D)
    Q, K, V, dO = (_tiles(x, T) for x in (q, k, v, do))
    n, hdp = Q.shape[1], Q.shape[3]
    rows = torch.arange(n * TILE)
    lse2 = torch.full((BH, n * TILE), math.inf)
    lse2[:, :T] = lse * math.log2(math.e)
    Dp = torch.zeros(BH, n * TILE)
    Dp[:, :T] = D
    lse2, Dp = lse2.view(BH, n, TILE), Dp.view(BH, n, TILE)
    mm = lambda a, b: _mm(a, b, body)
    dq = torch.zeros(BH, n, TILE, hdp)
    for qt in range(n):
        acc = torch.zeros(BH, TILE, hdp)
        for kt in range(n):
            s = mm(Q[:, qt], K[:, kt].transpose(1, 2))
            dp = mm(dO[:, qt], V[:, kt].transpose(1, 2))
            p = torch.exp2(s * c2 - lse2[:, qt, :, None])
            if mask:
                p = p.masked_fill(rows[kt * TILE:(kt + 1) * TILE] >= T, 0.0)
            ds = p * (dp - Dp[:, qt, :, None])
            acc = acc + mm(_weights(ds, body), K[:, kt])
        dq[:, qt] = acc * c
    dk = torch.zeros(BH, n, TILE, hdp)
    dv = torch.zeros(BH, n, TILE, hdp)
    for kt in range(n):
        ak = torch.zeros(BH, TILE, hdp)
        av = torch.zeros(BH, TILE, hdp)
        for qt in range(n):
            st = mm(K[:, kt], Q[:, qt].transpose(1, 2))
            dpt = mm(V[:, kt], dO[:, qt].transpose(1, 2))
            live = rows[qt * TILE:(qt + 1) * TILE] < T
            pt = torch.exp2(st * c2 - lse2[:, qt, None, :]) * live
            dst = pt * (dpt - Dp[:, qt, None, :])
            av = av + mm(_weights(pt, body), dO[:, qt])
            ak = ak + mm(_weights(dst, body), Q[:, qt])
        dk[:, kt], dv[:, kt] = ak * c, av
    flat = lambda x: x.reshape(BH, n * TILE, hdp)[:, :T, :hd]
    return flat(dq), flat(dk), flat(dv)


@pytest.mark.parametrize("T", [64, 65, 130, 191])
def test_kernel_tiling_matches_the_plain_functions(T):
    """The write-out of the f32 forward (out, lse) and of the f32 backward
    (dq, dk, dv; each product three bf16 passes) against
    attention_lse_plain / attention_bwd_plain in f32 on ragged inputs (one
    live key in the last tile at T = 65)."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(T, 1, ragged=True))
    out, lse = fwd_tiles(q, k, v, SCALE)
    pout, plse = attention.attention_lse_plain(q, k, v, SCALE)
    rel, absmax = TOL[torch.float32]
    _close(out, pout, "out", rel, absmax)
    np.testing.assert_allclose(lse.numpy(), plse.numpy(), rtol=1e-5,
                               atol=1e-5)
    want = attention.attention_bwd_plain(q, k, v, pout, plse, do, SCALE)
    for name, g, w in zip(("dq", "dk", "dv"),
                          bwd_tiles(q, k, v, out, lse, do, SCALE), want):
        _close(g, w, name, rel, absmax)


def _missed(got, want, rel, absmax, extra=(0.0, 0.0, 0.0)):
    """Names of the gradients that :func:`_close` refuses."""
    missed = []
    for name, g, w, e in zip(("dq", "dk", "dv"), got, want, extra):
        try:
            _close(g, w, name, rel, absmax, e)
        except AssertionError:
            missed.append(name)
    return missed


@pytest.mark.parametrize("fault", ["drop_d", "no_mask", "one_pass"])
def test_planted_faults_miss_the_tolerance(fault):
    """The checks above see a missing D term, a missing key mask (the
    forward's and the dQ kernel's) and an f32 body that drops the lo
    halves (one bf16 pass): at T = 130 on the ragged inputs each moves a
    gradient past its tolerance."""
    T = 130
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(T, 1, ragged=True))
    pout, plse = attention.attention_lse_plain(q, k, v, SCALE)
    want = attention.attention_bwd_plain(q, k, v, pout, plse, do, SCALE)
    if fault == "drop_d":
        got = bwd_tiles(q, k, v, pout, plse, do, SCALE, drop_d=True)
    elif fault == "one_pass":
        got = bwd_tiles(q, k, v, pout, plse, do, SCALE, body="one_pass")
    else:
        out, lse = fwd_tiles(q, k, v, SCALE, mask=False)
        got = bwd_tiles(q, k, v, out, lse, do, SCALE, mask=False)
    rel, absmax = TOL[torch.float32]
    assert _missed(got, want, rel, absmax), fault


@pytest.mark.parametrize("T", [64, 65, 130, 191, 4097])
def test_bf16_body_matches_library_vjp(T):
    """The bf16 body (bf16 operands; P and dS rounded to bf16 before the
    products, as the library's kernels round them: flash_attention.py:900,
    :918, :1258) against jax.vjp of the library's mha_reference on the
    same bf16-rounded inputs in f32, at the bf16 rule, on ragged inputs
    (one live row in the last tile at T = 65 and 4097). Both take the f32
    forward's out and lse of those inputs: a bf16 out rounds D, and on
    these inputs dq is a cancellation that carries it (the bf16 plain
    backward on the bf16 out misses this rule by 21× at T = 4097), a
    property of the forward's output, held on the card by the bf16 check
    on the forward kernel's own out."""
    BH = 1 if T > 1000 else 2
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(T, 3, BH=BH, ragged=True))
    out, lse = attention.attention_lse_plain(q.float(), k.float(),
                                             v.float(), SCALE)
    got = bwd_tiles(q, k, v, out, lse, do, SCALE, body="bf16")
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()) for t in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b, c: _library_attention(a, b, c, SCALE),
                     jq, jk, jv)
    rel, absmax = TOL[torch.bfloat16]
    for name, g, w in zip(("dq", "dk", "dv"), got, vjp(jdo)):
        _close(g.to(torch.bfloat16).float(), np.asarray(w, np.float32),
               name, rel, absmax)


def _bwd_sizes(q, k, v, do, out, lse, scale):
    """Σ|terms| of each gradient entry with dS's terms taken before their
    cancellation, P·(|dO|·|v|ᵀ + Σ|O||dO|) (chip_smoke.py _bwd_sizes)."""
    acc = attention._acc
    qs, ks, dof = (acc(t) for t in (q * scale, k * scale, do))
    p = torch.exp(qs @ ks.transpose(1, 2) - lse[..., None])
    pre = p * (dof.abs() @ acc(v).abs().transpose(1, 2)
               + (acc(out) * dof).abs().sum(-1)[..., None])
    return ((pre @ ks.abs()) * scale, (pre.transpose(1, 2) @ qs.abs())
            * scale, p.transpose(1, 2) @ dof.abs())


# the f32 ragged backward's allowance per unit of Σ|terms| (chip_smoke.py
# RAGGED_F32_EPS)
RAGGED_F32_EPS = 2.0 ** -20


@pytest.mark.parametrize("T,inputs", [(191, "random"), (1025, "random"),
                                      (191, "ragged"), (4097, "ragged")])
def test_f32_split_body_gate(T, inputs):
    """The gate of the f32 body: each product as three bf16 passes of the
    split operands, and D from the dO the products see. At random inputs
    it meets the f32 rule (1e-3·|plain| + 1e-4·max|plain|) against the
    f32 plain backward; at the ragged inputs (dq a cancellation) the f64
    witness rule of the card's ragged check, the f32 rule against the
    plain backward in f64 + 2⁻²⁰·Σ|terms before the cancellation|. The
    planted one-pass body (every lo dropped) misses both."""
    BH = 1 if T > 1000 else 2
    q, k, v, do = (torch.from_numpy(a)
                   for a in _inputs(T, 5, BH=BH, ragged=inputs == "ragged"))
    out, lse = attention.attention_lse_plain(q, k, v, SCALE)
    rel, absmax = TOL[torch.float32]
    if inputs == "random":
        want = attention.attention_bwd_plain(q, k, v, out, lse, do, SCALE)
        extra = (0.0, 0.0, 0.0)
    else:
        ins = [t.double() for t in (q, k, v, do)]
        o64, l64 = attention.attention_lse_plain(*ins[:3], SCALE)
        want = attention.attention_bwd_plain(*ins[:3], o64, l64, ins[3],
                                             SCALE)
        extra = tuple(RAGGED_F32_EPS * z for z in _bwd_sizes(
            *ins, o64, l64, SCALE))
    got = bwd_tiles(q, k, v, out, lse, do, SCALE)
    assert not _missed(got, want, rel, absmax, extra)
    ctrl = bwd_tiles(q, k, v, out, lse, do, SCALE, body="one_pass")
    assert _missed(ctrl, want, rel, absmax, extra) == ["dq", "dk", "dv"]


def test_wrappers_on_cpu_are_the_plain_functions():
    """flash_bwd_dq / flash_bwd_dkv on CPU tensors return the plain
    backward's gradients and the D the dK/dV kernel reads."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(70, 2))
    out, lse = attention.attention_lse_plain(q, k, v, SCALE)
    want = attention.attention_bwd_plain(q, k, v, out, lse, do, SCALE)
    dq, D = attention.flash_bwd_dq(q, k, v, out, lse, do, SCALE)
    dk, dv = attention.flash_bwd_dkv(q, k, v, lse, do, D, SCALE)
    torch.testing.assert_close(D, (out * do).sum(-1), rtol=0, atol=0)
    for a, b in zip((dq, dk, dv), want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bwd_plain_in_f64_is_autograd_of_the_plain_forward():
    """On f64 inputs the plain forward and backward compute in f64 (the
    card's f32 checks use them as the exact reference): attention_bwd_plain
    from attention_lse_plain's out and lse equals autograd of
    attention_plain to f64 rounding, and the wrappers' CPU halves equal it
    bit for bit."""
    q, k, v, do = (torch.from_numpy(a).double()
                   for a in _inputs(70, 4, ragged=True))
    out, lse = attention.attention_lse_plain(q, k, v, SCALE)
    assert out.dtype == lse.dtype == torch.float64
    want = attention.attention_bwd_plain(q, k, v, out, lse, do, SCALE)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(attention.attention_plain(*leaves, SCALE),
                               leaves, do)
    for g, a in zip(want, auto):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, a, rtol=1e-10,
                                   atol=1e-12 * float(a.abs().max()))
    dq, D = attention.flash_bwd_dq(q, k, v, out, lse, do, SCALE)
    dk, dv = attention.flash_bwd_dkv(q, k, v, lse, do, D, SCALE)
    for a, b in zip((dq, dk, dv), want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- the other head dims the kernels are instantiated for --------------------
# (FLASH_HEAD_DIMS; below hd 16 every tile zero-padded to 16 columns, as
# hopper.cuh's Head<HD> lays them out; at 128 in f32 the wide body, in bf16
# two 64-column sub-tiles, the same sums per column), each with its scale
# 1/√√hd

@pytest.mark.parametrize("hd", [8, 16, 32, 128])
def test_kernel_tiling_matches_the_plain_functions_small_head_dims(hd):
    """test_kernel_tiling_matches_the_plain_functions at head dim ``hd``
    and T = 130 (two live keys in the last tile), ragged inputs."""
    scale = 1.0 / math.sqrt(math.sqrt(hd))
    q, k, v, do = (torch.from_numpy(a)
                   for a in _inputs(130, 1, ragged=True, hd=hd))
    out, lse = fwd_tiles(q, k, v, scale)
    pout, plse = attention.attention_lse_plain(q, k, v, scale)
    rel, absmax = TOL[torch.float32]
    assert out.shape == q.shape
    _close(out, pout, "out", rel, absmax)
    np.testing.assert_allclose(lse.numpy(), plse.numpy(), rtol=1e-5,
                               atol=1e-5)
    want = attention.attention_bwd_plain(q, k, v, pout, plse, do, scale)
    for name, g, w in zip(("dq", "dk", "dv"),
                          bwd_tiles(q, k, v, out, lse, do, scale), want):
        assert g.shape == w.shape
        _close(g, w, name, rel, absmax)


@pytest.mark.parametrize("fault", ["drop_d", "no_mask", "one_pass"])
@pytest.mark.parametrize("hd", [8, 16, 32, 128])
def test_planted_faults_miss_the_tolerance_small_head_dims(hd, fault):
    """test_planted_faults_miss_the_tolerance at head dim ``hd``: each
    fault moves a gradient past its tolerance at T = 130."""
    scale = 1.0 / math.sqrt(math.sqrt(hd))
    q, k, v, do = (torch.from_numpy(a)
                   for a in _inputs(130, 1, ragged=True, hd=hd))
    pout, plse = attention.attention_lse_plain(q, k, v, scale)
    want = attention.attention_bwd_plain(q, k, v, pout, plse, do, scale)
    if fault == "drop_d":
        got = bwd_tiles(q, k, v, pout, plse, do, scale, drop_d=True)
    elif fault == "one_pass":
        got = bwd_tiles(q, k, v, pout, plse, do, scale, body="one_pass")
    else:
        out, lse = fwd_tiles(q, k, v, scale, mask=False)
        got = bwd_tiles(q, k, v, out, lse, do, scale, mask=False)
    rel, absmax = TOL[torch.float32]
    assert _missed(got, want, rel, absmax), (hd, fault)


@pytest.mark.parametrize("hd", [8, 16, 32, 128])
def test_bf16_body_matches_library_vjp_small_head_dims(hd):
    """test_bf16_body_matches_library_vjp at head dim ``hd``, T = 130."""
    scale = 1.0 / math.sqrt(math.sqrt(hd))
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(130, 3, ragged=True, hd=hd))
    out, lse = attention.attention_lse_plain(q.float(), k.float(),
                                             v.float(), scale)
    got = bwd_tiles(q, k, v, out, lse, do, scale, body="bf16")
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()) for t in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b, c: _library_attention(a, b, c, scale),
                     jq, jk, jv)
    rel, absmax = TOL[torch.bfloat16]
    for name, g, w in zip(("dq", "dk", "dv"), got, vjp(jdo)):
        _close(g.to(torch.bfloat16).float(), np.asarray(w, np.float32),
               name, rel, absmax)


@pytest.mark.parametrize("inputs", ["random", "ragged"])
@pytest.mark.parametrize("hd", [8, 16, 32, 128])
def test_f32_split_body_gate_small_head_dims(hd, inputs):
    """test_f32_split_body_gate at head dim ``hd`` and T = 191: the
    three-pass body meets the f32 rule (random inputs) and the f64
    witness rule (ragged inputs, dq a cancellation); the one-pass body
    misses both in every gradient."""
    scale = 1.0 / math.sqrt(math.sqrt(hd))
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(
        191, 5, BH=2, ragged=inputs == "ragged", hd=hd))
    out, lse = attention.attention_lse_plain(q, k, v, scale)
    rel, absmax = TOL[torch.float32]
    if inputs == "random":
        want = attention.attention_bwd_plain(q, k, v, out, lse, do, scale)
        extra = (0.0, 0.0, 0.0)
    else:
        ins = [t.double() for t in (q, k, v, do)]
        o64, l64 = attention.attention_lse_plain(*ins[:3], scale)
        want = attention.attention_bwd_plain(*ins[:3], o64, l64, ins[3],
                                             scale)
        extra = tuple(RAGGED_F32_EPS * z for z in _bwd_sizes(
            *ins, o64, l64, scale))
    got = bwd_tiles(q, k, v, out, lse, do, scale)
    assert not _missed(got, want, rel, absmax, extra)
    ctrl = bwd_tiles(q, k, v, out, lse, do, scale, body="one_pass")
    assert _missed(ctrl, want, rel, absmax, extra) == ["dq", "dk", "dv"]


# the narrow body's gate cases (head dim 8, BH = 2): T = 385 puts one live
# row in the last 128-row ring tile
NARROW_CASES = [(191, "random"), (385, "random"), (191, "ragged"),
                (385, "ragged")]


@pytest.mark.parametrize("T,inputs", NARROW_CASES,
                         ids=[f"{t}-{i}" for t, i in NARROW_CASES])
def test_f32_narrow_bwd_body_gate(T, inputs):
    """The gate of csrc/flash_narrow_bwd.cu (the f32 backward at head dim
    8), written out by ``bwd_tiles(..., body="narrow")``: it meets the f32
    rule against the f32 plain backward on the random inputs and the f64
    witness rule (the f32 rule against the f64 plain backward + 2⁻²⁰·
    Σ|terms before the cancellation|) on the ragged ones, where dq is a
    cancellation. The planted fault beside it, every lo dropped
    (``narrow_one_pass``), misses in dq, dk and dv on both."""
    hd = 8
    scale = 1.0 / math.sqrt(math.sqrt(hd))
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(
        T, 7, BH=2, ragged=inputs == "ragged", hd=hd))
    out, lse = attention.attention_lse_plain(q, k, v, scale)
    rel, absmax = TOL[torch.float32]
    if inputs == "random":
        want = attention.attention_bwd_plain(q, k, v, out, lse, do, scale)
        extra = (0.0, 0.0, 0.0)
    else:
        ins = [t.double() for t in (q, k, v, do)]
        o64, l64 = attention.attention_lse_plain(*ins[:3], scale)
        want = attention.attention_bwd_plain(*ins[:3], o64, l64, ins[3],
                                             scale)
        extra = tuple(RAGGED_F32_EPS * z for z in _bwd_sizes(
            *ins, o64, l64, scale))
    got = bwd_tiles(q, k, v, out, lse, do, scale, body="narrow")
    assert not _missed(got, want, rel, absmax, extra)
    ctrl = bwd_tiles(q, k, v, out, lse, do, scale, body="narrow_one_pass")
    assert _missed(ctrl, want, rel, absmax, extra) == ["dq", "dk", "dv"]


@pytest.mark.parametrize("T", [191, 385])
def test_f32_narrow_bwd_d_from_the_split_do(T):
    """The narrow body takes D with the dO its products see (hi + lo), so
    that Σ_j dS_ij = 0 holds for the split operands and the ragged dq
    stays a clean cancellation. The planted fault, D from the unsplit dO
    (``narrow_d_unsplit``), is off by dO's split residual, at most ~2⁻¹⁸
    of each term: on random dO the terms' signs mix and the fault reads
    0.6-1.4 of the f64 witness rule. Here dO > 0 sits 2⁻¹⁸ (relative)
    past its hi + lo in every element (1 + 3·2⁻⁹ + 2⁻¹⁸ times a power of
    2), so the residuals add in D: on the ragged q, k, v the body meets
    the witness rule and the fault misses it in dq."""
    hd = 8
    scale = 1.0 / math.sqrt(math.sqrt(hd))
    q, k, v, _ = _inputs(T, 7, BH=2, ragged=True, hd=hd)
    rng = np.random.default_rng(T)
    do = ((1 + 3 * 2.0 ** -9 + 2.0 ** -18)
          * 2.0 ** rng.integers(-1, 2, q.shape)).astype(np.float32)
    q, k, v, do = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = attention.attention_lse_plain(q, k, v, scale)
    ins = [t.double() for t in (q, k, v, do)]
    o64, l64 = attention.attention_lse_plain(*ins[:3], scale)
    want = attention.attention_bwd_plain(*ins[:3], o64, l64, ins[3], scale)
    extra = tuple(RAGGED_F32_EPS * z for z in _bwd_sizes(
        *ins, o64, l64, scale))
    rel, absmax = TOL[torch.float32]
    got = bwd_tiles(q, k, v, out, lse, do, scale, body="narrow")
    assert not _missed(got, want, rel, absmax, extra)
    ctrl = bwd_tiles(q, k, v, out, lse, do, scale, body="narrow_d_unsplit")
    assert "dq" in _missed(ctrl, want, rel, absmax, extra)


# -- the wide body (csrc/flash_bwd.cu flash_bwd_wide_kernel) -----------------
# at head dims 128 (one dq slice of 2 chunks, one dkv slice), 192 (one of 3;
# dkv 2 + 1), 256 (one of 4; dkv 2 + 2) and 320 (dq 4 + a partial 1, dkv
# 2 + 2 + 1) on T = 65, 130 and 191 (one, two and 63 live rows in the last
# ring tile)
WIDE_CASES = [(hd, T) for hd in (128, 192, 256, 320) for T in (65, 130, 191)]


@pytest.mark.parametrize("inputs", ["random", "ragged"])
@pytest.mark.parametrize("hd,T", WIDE_CASES,
                         ids=[f"{h}-{t}" for h, t in WIDE_CASES])
def test_f32_wide_bwd_body_gate(hd, T, inputs):
    """The wide body's f32 sum order (``bwd_tiles(..., body="wide")``)
    meets the f32 rule against attention_bwd_plain in f32 on random
    inputs, and the f64 witness rule (the f32 rule against the f64 plain
    backward + 2⁻²⁰·Σ|terms before the cancellation|) on the ragged ones,
    where dq is a cancellation; the body with every lo dropped misses both
    in dq, dk and dv."""
    scale = 1.0 / math.sqrt(math.sqrt(hd))
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(
        T, 9, BH=2, ragged=inputs == "ragged", hd=hd))
    out, lse = attention.attention_lse_plain(q, k, v, scale)
    rel, absmax = TOL[torch.float32]
    if inputs == "random":
        want = attention.attention_bwd_plain(q, k, v, out, lse, do, scale)
        extra = (0.0, 0.0, 0.0)
    else:
        ins = [t.double() for t in (q, k, v, do)]
        o64, l64 = attention.attention_lse_plain(*ins[:3], scale)
        want = attention.attention_bwd_plain(*ins[:3], o64, l64, ins[3],
                                             scale)
        extra = tuple(RAGGED_F32_EPS * z for z in _bwd_sizes(
            *ins, o64, l64, scale))
    got = bwd_tiles(q, k, v, out, lse, do, scale, body="wide")
    assert all(g.shape == q.shape for g in got)
    assert not _missed(got, want, rel, absmax, extra)
    ctrl = bwd_tiles(q, k, v, out, lse, do, scale, body="wide_one_pass")
    assert _missed(ctrl, want, rel, absmax, extra) == ["dq", "dk", "dv"]


@pytest.mark.parametrize("hd,T", WIDE_CASES,
                         ids=[f"{h}-{t}" for h, t in WIDE_CASES])
def test_bf16_wide_bwd_body_matches_library_vjp(hd, T):
    """The wide body in bf16 (bf16 operands, P and dS rounded to bf16
    before the products, as the library rounds them) against jax.vjp of
    the library's mha_reference on the same bf16-rounded inputs in f32, at
    the bf16 rule, on ragged inputs, with the f32 forward's out and lse
    (test_bf16_body_matches_library_vjp's reason)."""
    scale = 1.0 / math.sqrt(math.sqrt(hd))
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in _inputs(T, 3, ragged=True, hd=hd))
    out, lse = attention.attention_lse_plain(q.float(), k.float(),
                                             v.float(), scale)
    got = bwd_tiles(q, k, v, out, lse, do, scale, body="wide_bf16")
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()) for t in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b, c: _library_attention(a, b, c, scale),
                     jq, jk, jv)
    rel, absmax = TOL[torch.bfloat16]
    for name, g, w in zip(("dq", "dk", "dv"), got, vjp(jdo)):
        _close(g.to(torch.bfloat16).float(), np.asarray(w, np.float32),
               name, rel, absmax)


@pytest.mark.parametrize("fault", ["wrong_chunk", "drop_d", "one_pass"])
def test_wide_bwd_planted_faults_miss(fault):
    """At head dim 320 (dq's slices of 4 and 1 chunks, dkv's of 2, 2 and
    1) on the ragged inputs at T = 130, each planted fault of the wide
    body moves gradients past the f32 rule against the plain backward:
    the partial slices' products reading chunk h in place of c0 + h (dq,
    dk and dv), D dropped, every lo dropped."""
    hd, T = 320, 130
    scale = 1.0 / math.sqrt(math.sqrt(hd))
    q, k, v, do = (torch.from_numpy(a)
                   for a in _inputs(T, 1, ragged=True, hd=hd))
    out, lse = attention.attention_lse_plain(q, k, v, scale)
    want = attention.attention_bwd_plain(q, k, v, out, lse, do, scale)
    rel, absmax = TOL[torch.float32]
    assert not _missed(bwd_tiles(q, k, v, out, lse, do, scale, body="wide"),
                       want, rel, absmax)
    if fault == "drop_d":
        got = bwd_tiles(q, k, v, out, lse, do, scale, drop_d=True,
                        body="wide")
    else:
        got = bwd_tiles(q, k, v, out, lse, do, scale, body=f"wide_{fault}")
    missed = _missed(got, want, rel, absmax)
    assert missed == (["dq", "dk", "dv"] if fault != "drop_d" else missed)
    assert missed, fault


def test_wide_bwd_without_split_is_the_plain_backward():
    """The wide body's slices and chunks with exact f32 products are the
    plain backward: at hd 320 on ragged inputs at T = 130, dq, dk and dv
    equal attention_bwd_plain's to f32 rounding, so the gate above
    measures the split, not the slicing."""
    hd = 320
    scale = 1.0 / math.sqrt(math.sqrt(hd))
    q, k, v, do = (torch.from_numpy(a)
                   for a in _inputs(130, 2, ragged=True, hd=hd))
    out, lse = attention.attention_lse_plain(q, k, v, scale)
    want = attention.attention_bwd_plain(q, k, v, out, lse, do, scale)
    got = bwd_tiles(q, k, v, out, lse, do, scale, body="wide_exact")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5,
                                   atol=1e-5 * float(w.abs().max()))
