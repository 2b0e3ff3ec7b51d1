"""The port's compile check and multi-rank dry run
(``__graft_entry_torch__.py``) against the JAX package's
(``__graft_entry__.py``).

* ``entry(device="cpu")``: one guided reverse step on the flagship-small
  UNet against JAX ``entry()``'s step, with the JAX parameters carried
  across through ``state_dict_from_flax`` and zero sampler noise on both
  sides.
* ``dryrun_multichip(2, device="cpu")``: two gloo ranks run the
  data-parallel step, the view-sharded FBP, the H-sharded eval and the
  H-sharded sampler, each held to its unsharded run inside the ranks."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

import __graft_entry__ as jentry
import __graft_entry_torch__ as tentry
from ipdm_tpu_torch.diffusion import diffusion as port_diffusion
from ipdm_tpu_torch.utils.torch_import import state_dict_from_flax


def test_entry_step_matches_jax(monkeypatch):
    """The same weights and the port's example inputs (x_t = 0.5, a seeded
    x_cond, t = 10, λ = 0.45), zero noise: the posterior mean of one
    guided step, within 1e-5 + 1e-4·|JAX|. The two UNets' ε̂ on these
    weights (the JAX initialisers' scale, ten levels of f32 sums in
    another order) agree to 8e-4 of their largest entry; the guidance
    blend and the posterior take that down to 3.7e-5 relative at the
    worst of the 4096 pixels, 1.8e-5 absolute."""
    fn, (params, _, _, t, rng) = jentry.entry()
    tfn, (model, tx, txc, tt, gen) = tentry.entry(device="cpu")
    x, xc = (jnp.asarray(a.permute(0, 2, 3, 1).numpy()) for a in (tx, txc))
    model.load_state_dict(state_dict_from_flax(model, params))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32:
                        jnp.zeros(shape, dtype))
    monkeypatch.setattr(port_diffusion, "noise_like",
                        lambda x, generator: torch.zeros_like(x))
    want = np.asarray(fn(params, x, xc, t, rng))          # NHWC
    got = tfn(model, tx, txc, tt, gen).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 64, 64, 1)
    assert math.isfinite(float(np.abs(got).max()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_dryrun_multichip_two_ranks(capsys):
    """Two gloo ranks: a finite loss equal on both ranks, the sharded eval
    and sampler within __graft_entry__.py's tolerance of the unsharded
    ones (checked inside the ranks), and the OK line."""
    r = tentry.dryrun_multichip(2, device="cpu")
    assert r["mesh"] == {"data": 1, "view": 2}
    assert math.isfinite(r["loss"])
    assert r["eval_d"] <= 1e-3 and r["sampler_d"] <= 1e-3
    assert "dryrun_multichip OK: mesh={'data': 1, 'view': 2}" in \
        capsys.readouterr().out
