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
  the tolerance."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import \
    mha_reference_no_custom_vjp

from ipdm_tpu_torch.ops.cuda import attention

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


def bwd_tiles(q, k, v, out, lse, do, scale, drop_d=False, mask=True,
              body="split"):
    """flash_bwd.cu: D = rowsum(dO·O) (flash_bwd_dot_kernel, with the dO
    the products see; ``drop_d`` plants its loss); dQ per query tile over
    key tiles in order, keys ≥ T masked (``mask``); dK and dV per key tile
    over query tiles in order, query rows ≥ T at P = 0. Every product runs
    as ``body`` takes it (:func:`_mm`): ``bf16`` (bf16 operands, P and dS
    rounded to bf16 before the products that read them) or ``split`` (f32
    operands, each product three bf16 passes), or the fault ``one_pass``.
    Returns dq, dk, dv in f32 (below hd 16 on the tiles' zero-padded
    columns, the pad dropped)."""
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
# hopper.cuh's Head<HD> lays them out; at 128 two 64-column sub-tiles, the
# same sums per column), each with its scale 1/√√hd

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
