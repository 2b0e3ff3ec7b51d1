"""The flash attention's backward of the port (ipdm_tpu_torch/ops/cuda/
attention.py) on the CPU.

* attention_bwd_plain, the formulas written out from the forward's saved
  output and lse, against jax.vjp of JAX's attention: the library's
  mha_reference (jax/experimental/pallas/ops/tpu/flash_attention.py,
  whose backward the two Pallas kernels _flash_attention_bwd_dkv :940 and
  _flash_attention_bwd_dq :1286 compute) and the einsum path of
  ipdm_tpu/models/unet.py:659-662, in f32 and bf16, at ragged T.
* A CPU write-out of the CUDA kernels' tiling (csrc/flash_attn_f32.cu,
  csrc/flash_bwd.cu): 64-row tiles, rows past T staged as zeros, the
  online softmax and lse over key tiles in order, D = rowsum(dO·O), dQ
  per query tile over key tiles in order, dK and dV per key tile over
  query tiles in order, keys past T masked in the forward and the dQ
  kernel and query rows past T in the dK/dV kernel; held to the plain
  functions, with planted faults (D dropped, the key mask dropped) that
  must miss the tolerance."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import \
    mha_reference_no_custom_vjp

from ipdm_tpu_torch.ops.cuda import attention

TILE = 64      # flash_simt.cuh TILE: rows per tile of both kernels
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



def _inputs(T, seed, BH=2, ragged=False):
    """q, k, v, dO as f32 numpy [BH, T, 64]. ``ragged``: q ≈ +1 and
    k ≈ −1 plus noise, so live scores are ≈ −8 and a zero key row past T
    that escaped a mask (score 0) would dominate the softmax."""
    rng = np.random.default_rng(seed)
    if ragged:
        q = 1.0 + 0.25 * rng.standard_normal((BH, T, HD))
        k = -1.0 + 0.25 * rng.standard_normal((BH, T, HD))
    else:
        q, k = (rng.standard_normal((BH, T, HD)) for _ in range(2))
    v = rng.standard_normal((BH, T, HD)) + np.arange(1, BH + 1)[:, None,
                                                                None]
    do = rng.standard_normal((BH, T, HD))
    return [a.astype(np.float32) for a in (q, k, v, do)]


def _close(got, want, name, rel, absmax):
    """|got − want| ≤ absmax·max|want| + rel·|want| per tensor."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = absmax * np.abs(want).max() + rel * np.abs(want)
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
    """[BH, T, 64] → [BH, ntiles, 64, 64], rows past T zeros (the tiles'
    staging in flash_simt.cuh load_tile)."""
    n = -(-T // TILE)
    pad = torch.zeros(x.shape[0], n * TILE - T, HD, dtype=torch.float32)
    return torch.cat([x.float(), pad], 1).view(x.shape[0], n, TILE, HD)


def fwd_tiles(q, k, v, scale, mask=True):
    """flash_attn_f32.cu: per 64-row query tile, key tiles in order, the
    online softmax in the log2 domain; keys ≥ T score −inf (``mask``).
    Returns out [BH, T, 64] and lse [BH, T]."""
    BH, T, _ = q.shape
    c2 = scale * scale * math.log2(math.e)
    Q, K, V = _tiles(q, T), _tiles(k, T), _tiles(v, T)
    n = Q.shape[1]
    out = torch.zeros(BH, n * TILE, HD)
    lse = torch.zeros(BH, n * TILE)
    for qt in range(n):
        m = torch.full((BH, TILE), -math.inf)
        l = torch.zeros(BH, TILE)
        o = torch.zeros(BH, TILE, HD)
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
    return out[:, :T], lse[:, :T]


def bwd_tiles(q, k, v, out, lse, do, scale, drop_d=False, mask=True):
    """flash_bwd.cu: D = rowsum(dO·O) (flash_bwd_dot_kernel; ``drop_d``
    plants its loss); dQ per query tile over key tiles in order, keys ≥ T
    masked (``mask``); dK and dV per key tile over query tiles in order,
    query rows ≥ T at lse = +inf and D = 0, so P = 0. Returns dq, dk, dv
    in f32."""
    BH, T, _ = q.shape
    c2, c = scale * scale * math.log2(math.e), scale * scale
    D = (out.float() * do.float()).sum(-1)
    if drop_d:
        D = torch.zeros_like(D)
    Q, K, V, dO = (_tiles(x, T) for x in (q, k, v, do))
    n = Q.shape[1]
    rows = torch.arange(n * TILE)
    lse2 = torch.full((BH, n * TILE), math.inf)
    lse2[:, :T] = lse * math.log2(math.e)
    Dp = torch.zeros(BH, n * TILE)
    Dp[:, :T] = D
    lse2, Dp = lse2.view(BH, n, TILE), Dp.view(BH, n, TILE)
    dq = torch.zeros(BH, n, TILE, HD)
    for qt in range(n):
        acc = torch.zeros(BH, TILE, HD)
        for kt in range(n):
            s = Q[:, qt] @ K[:, kt].transpose(1, 2)
            dp = dO[:, qt] @ V[:, kt].transpose(1, 2)
            p = torch.exp2(s * c2 - lse2[:, qt, :, None])
            if mask:
                p = p.masked_fill(rows[kt * TILE:(kt + 1) * TILE] >= T, 0.0)
            acc = acc + (p * (dp - Dp[:, qt, :, None])) @ K[:, kt]
        dq[:, qt] = acc * c
    dk = torch.zeros(BH, n, TILE, HD)
    dv = torch.zeros(BH, n, TILE, HD)
    for kt in range(n):
        ak = torch.zeros(BH, TILE, HD)
        av = torch.zeros(BH, TILE, HD)
        for qt in range(n):
            st = K[:, kt] @ Q[:, qt].transpose(1, 2)
            dpt = V[:, kt] @ dO[:, qt].transpose(1, 2)
            live = rows[qt * TILE:(qt + 1) * TILE] < T
            pt = torch.exp2(st * c2 - lse2[:, qt, None, :]) * live
            av = av + pt @ dO[:, qt]
            ak = ak + (pt * (dpt - Dp[:, qt, None, :])) @ Q[:, qt]
        dk[:, kt], dv[:, kt] = ak * c, av
    flat = lambda x: x.reshape(BH, n * TILE, HD)[:, :T]
    return flat(dq), flat(dk), flat(dv)


@pytest.mark.parametrize("T", [64, 65, 130, 191])
def test_kernel_tiling_matches_the_plain_functions(T):
    """The write-out of the f32 forward (out, lse) and of the backward
    (dq, dk, dv) against attention_lse_plain / attention_bwd_plain in
    f32 on ragged inputs (one live key in the last tile at T = 65)."""
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


@pytest.mark.parametrize("fault", ["drop_d", "no_mask"])
def test_planted_faults_miss_the_tolerance(fault):
    """The checks above see a missing D term and a missing key mask (the
    forward's and the dQ kernel's): at T = 130 on the ragged inputs each
    moves a gradient past its tolerance."""
    T = 130
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(T, 1, ragged=True))
    pout, plse = attention.attention_lse_plain(q, k, v, SCALE)
    want = attention.attention_bwd_plain(q, k, v, pout, plse, do, SCALE)
    if fault == "drop_d":
        got = bwd_tiles(q, k, v, pout, plse, do, SCALE, drop_d=True)
    else:
        out, lse = fwd_tiles(q, k, v, SCALE, mask=False)
        got = bwd_tiles(q, k, v, out, lse, do, SCALE, mask=False)
    rel, absmax = TOL[torch.float32]
    missed = []
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        try:
            _close(g, w, name, rel, absmax)
        except AssertionError:
            missed.append(name)
    assert missed, fault


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
