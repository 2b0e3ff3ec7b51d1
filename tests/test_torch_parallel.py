"""The port's mesh (ipdm_tpu_torch/parallel/mesh.py) on 2 ranks of gloo,
against the single-process port and the JAX package's mesh functions on
2 of conftest's 8 virtual CPU devices: the twins of
tests/test_parallel.py, the UNet on H-bands (levels banded, and bands
that go odd), and the engine under mesh_shape [2, 1].

The ranks are spawned processes (torch_mesh_ranks.py: torch and the port
only; a FileStore in tmp_path, not a TCP port, since test files run side
by side), one spawn per group of checks, each joined with a time limit;
this process runs JAX and the references."""

import os
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from ipdm_tpu.models.unet import UNetModel as FlaxUNet
from ipdm_tpu.parallel import make_mesh as jax_make_mesh
from ipdm_tpu.parallel import make_spatial_sharded_apply as jax_spatial
from ipdm_tpu.parallel import make_view_sharded_fbp as jax_vs_fbp
from ipdm_tpu.parallel import make_view_sharded_fp as jax_vs_fp
from ipdm_tpu.recon import geometry as JG
from ipdm_tpu.recon import projector as JP
from ipdm_tpu.recon.fbp import FBPGeometry as JaxFBPGeometry
from ipdm_tpu_torch.config.config import IPDMConfig
from ipdm_tpu_torch.diffusion.diffusion import GaussianDiffusion
from ipdm_tpu_torch.engine.denoiser import ProgressiveDomainDenoiser
from ipdm_tpu_torch.engine.trainer import make_optimizer, make_train_step
from ipdm_tpu_torch.models.unet import GroupNorm, UNetModel, conv_unit
from ipdm_tpu_torch.parallel.spawn import run_ranks
from ipdm_tpu_torch.recon import geometry as G
from ipdm_tpu_torch.recon.convertor import fbp_geom_from_fan
from ipdm_tpu_torch.recon.fbp import FBPGeometry, fbp_convert
from ipdm_tpu_torch.recon.phantom import random_ellipse_phantom, shepp_logan
from ipdm_tpu_torch.recon.projector import forward_project
from ipdm_tpu_torch.recon.sart_fast import project_fast
from ipdm_tpu_torch.recon.simulate import add_noise
from ipdm_tpu_torch.utils.torch_import import state_dict_from_flax

FBP_GEOM = dict(n_det=32, n_views=40, grid_n=16, grid_l=21.0)
FAN_GEOM = dict(nx=32, ny=32, dx=42 / 32, dy=42 / 32, nr=64,
                dr=0.0010125 * 912 / 64, na=60, ta_dimx=201, ta_dimy=91)
TRAIN_CFG = dict(in_channels=1, model_channels=8, out_channels=1,
                 num_res_blocks=1, attention_resolutions=(4,),
                 channel_mult=(1, 1, 2))
# the JAX test's UNet (one level: everything runs gathered), one whose
# first two levels stay banded at 48 rows, and one whose bands go odd
# (11 rows) at the second level at 44 rows, so the third is gathered
UNETS = (
    (dict(in_channels=1, model_channels=8, out_channels=1,
          num_res_blocks=1, attention_resolutions=(2,),
          channel_mult=(1, 2), num_heads=2), 48, 0),
    (dict(in_channels=1, model_channels=8, out_channels=1,
          num_res_blocks=1, attention_resolutions=(4,),
          channel_mult=(1, 1, 2, 2), num_heads=2), 48, 2),
    (dict(in_channels=1, model_channels=8, out_channels=1,
          num_res_blocks=2, attention_resolutions=(8,),
          channel_mult=(1, 1, 1, 2), num_heads=2), 44, 2),
)
RANK_TIMEOUT = 240  # s per spawn, under the suite's six workers


def _flax_params(cfg, seed):
    """Flax UNet params, every leaf N(0, 0.08) (test_torch_unet.py)."""
    model = FlaxUNet(**cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(seed),
                            jnp.zeros((1, 24, 16, 1)),
                            jnp.zeros((1,), jnp.int32))
    rng = np.random.default_rng(seed)
    return model, {"params": jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.08, a.shape).astype(np.float32),
        shapes["params"])}


def _jax_devices(n):
    return jax.devices()[:n]


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """One spawn of 2 ranks running every mesh function
    (torch_mesh_ranks.mesh_checks) on seeded inputs."""
    rng = np.random.default_rng(0)
    fan = G.FanBeamGeometry(**FAN_GEOM)
    conv = torch.nn.Conv2d(4, 4, 3, padding=1)
    gn_x = rng.standard_normal((1, 4, 64, 16))
    gn_x += np.linspace(-3, 3, 64)[None, None, :, None]  # a strong trend
    unets = []
    for i, (cfg, H, _) in enumerate(UNETS):
        if i == 0:
            fmodel, fparams = _flax_params(cfg, seed=0)
            model = UNetModel(**cfg, device="cpu")
            sd = state_dict_from_flax(model, fparams)
        else:
            torch.manual_seed(i)
            sd = UNetModel(**cfg, device="cpu").state_dict()
        x = rng.standard_normal((1, 1, H, 16)).astype(np.float32)
        unets.append((cfg, {k: v.numpy() for k, v in sd.items()}, x))
    inp = dict(
        train_cfg=TRAIN_CFG,
        images=rng.random((8, 16, 16, 1), np.float32),
        fbp_geom=FBP_GEOM,
        pj=rng.random((1, 40, 32), np.float32),
        fan_geom=FAN_GEOM, lut=G.area_lut(fan), betas=G.default_betas(fan),
        phantom=shepp_logan(32).astype(np.float32),
        conv_x=rng.standard_normal((1, 4, 64, 16)).astype(np.float32),
        conv_w={k: v.detach().numpy() for k, v in conv.state_dict().items()},
        gn_x=gn_x.astype(np.float32), unets=unets)
    res = run_ranks(R.mesh_checks, 2, tmp_path_factory.mktemp("mesh"),
                    (inp,), timeout=RANK_TIMEOUT, threads=1)
    return inp, res


def test_make_mesh_shapes(mesh_run):
    _, res = mesh_run
    for r in res:
        assert r["shapes"] == [(2, 1), (2, 1), (1, 2)]
        assert "mesh shape [4, 1] != world size 2" in r["bad_shape"]
        assert "does not divide over 2 ranks" in r["bad_batch"]


@pytest.mark.parametrize("name", ["convnet", "unet"])
def test_sharded_train_step_matches_single_process(mesh_run, name):
    """A data-parallel step (global batch 8, 4 rows a rank, t and noise
    drawn for the global batch) == make_train_step on the whole batch
    from the same init and generator, on both ranks: each of two steps'
    loss (rtol 1e-5) and the first step's all-reduced gradients (atol
    1e-6 of the largest gradient). The conv net (tests/test_parallel.py's
    quick model) also holds its parameters after the first Adam step to
    atol 1e-6 (:71-91). The UNet's biases that feed a GroupNorm have a
    zero gradient in exact arithmetic: theirs is f32 rounding noise, which
    Adam scales up to an update, so its parameters are held through the
    gradients and the losses."""
    inp, res = mesh_run
    model = R.train_model(name, TRAIN_CFG)
    gd = GaussianDiffusion(100, "cosine", device="cpu")
    step = make_train_step(model, gd, make_optimizer(model.parameters(),
                                                     1e-3), 50,
                           torch.Generator().manual_seed(1))
    losses = [float(step(inp["images"]))]
    grads = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    params = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    losses.append(float(step(inp["images"])))
    assert all(np.isfinite(losses))
    gmax = max(np.abs(g).max() for g in grads.values())
    for r in res:
        got = r["train"][name]
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        for k, g in grads.items():
            np.testing.assert_allclose(got["grads"][k], g, rtol=0,
                                       atol=1e-6 * gmax, err_msg=k)
        if name == "convnet":
            for k, v in params.items():
                np.testing.assert_allclose(got["params"][k], v, atol=1e-6,
                                           err_msg=k)


def test_view_sharded_fbp_matches_unsharded(mesh_run):
    """Each rank's 20-view wedge, one all_reduce == fbp_convert of all 40
    views and JAX's make_view_sharded_fbp on a [1, 2] mesh (rtol 1e-4,
    atol 1e-6, tests/test_parallel.py:131-140); the whole sinogram or
    the rank's wedge as input."""
    inp, res = mesh_run
    ref = fbp_convert(torch.from_numpy(inp["pj"]),
                      FBPGeometry(**FBP_GEOM), view_block=5).numpy()
    jmesh = jax_make_mesh([1, 2], ("data", "view"), devices=_jax_devices(2))
    jref = np.asarray(jax_vs_fbp(jmesh, JaxFBPGeometry(**FBP_GEOM),
                                 view_block=5)(jnp.asarray(inp["pj"])))
    for r in res:
        for got in (r["fbp"], r["fbp_wedge"]):
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(got, jref, rtol=1e-4, atol=1e-6)


def test_view_sharded_fp_matches_unsharded(mesh_run):
    """Each rank's 30-view wedge, all_gathered == forward_project of all
    60 views (views are independent: 1e-6 of the max), and JAX's
    forward_project and make_view_sharded_fp within
    test_torch_projector.py's 1e-5·max + 1e-4·|ref|."""
    inp, res = mesh_run
    fan = G.FanBeamGeometry(**FAN_GEOM)
    x = torch.from_numpy(inp["phantom"])
    ref = forward_project(x, fan, inp["lut"], inp["betas"]).numpy()
    jfan = JG.FanBeamGeometry(**FAN_GEOM)
    jlut = jnp.asarray(JG.area_lut(jfan))
    jbetas = jnp.asarray(JG.default_betas(jfan))
    jref = np.asarray(JP.forward_project(jnp.asarray(inp["phantom"]), jfan,
                                         jlut, jbetas))
    jmesh = jax_make_mesh([1, 2], ("data", "view"), devices=_jax_devices(2))
    jsharded = np.asarray(jax_vs_fp(jmesh, jfan, jlut, jbetas)(
        jnp.asarray(inp["phantom"])))
    tol = 1e-5 * np.abs(jref).max() + 1e-4 * np.abs(jref)
    for r in res:
        assert r["fp"].shape == (60, 64)
        np.testing.assert_allclose(r["fp"], ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())
        for want in (jref, jsharded):
            assert (np.abs(r["fp"] - want) <= tol).all()


def test_spatial_sharded_conv_halo_tight(mesh_run):
    """A 3×3 conv and a planar unit (GN → SiLU → conv through
    planar_unit's plain version) on 32-row bands with one halo row from
    the neighbour == the unsharded ones (atol 1e-6,
    tests/test_parallel.py:142-164)."""
    inp, res = mesh_run
    conv = torch.nn.Conv2d(4, 4, 3, padding=1)
    conv.load_state_dict({k: torch.from_numpy(v)
                          for k, v in inp["conv_w"].items()})
    x = torch.from_numpy(inp["conv_x"])
    with torch.no_grad():
        want = conv_unit(conv, x, False).numpy()
        want_planar = conv_unit(conv, x, True, gn=GroupNorm(4)).numpy()
    for r in res:
        np.testing.assert_allclose(r["conv"], want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["planar"], want_planar, rtol=1e-6,
                                   atol=1e-6)


def test_spatial_sharded_groupnorm_stats_tight(mesh_run):
    """GroupNorm on bands of rows with a strong trend: the statistics
    summed over both ranks == the whole slice's (atol 1e-5,
    tests/test_parallel.py:167-190; band-local statistics miss by O(1))."""
    inp, res = mesh_run
    x = torch.from_numpy(inp["gn_x"])
    with torch.no_grad():
        want = GroupNorm(4)(x).numpy()
        local = torch.cat([GroupNorm(4)(b) for b in x.chunk(2, dim=2)], 2)
    assert np.abs(local.numpy() - want).max() > 0.1
    for r in res:
        np.testing.assert_allclose(r["gn"], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("which", range(len(UNETS)),
                         ids=["jax-config", "banded-levels", "odd-bands"])
def test_spatial_sharded_apply_matches_single_process(mesh_run, which):
    """The UNet on two H-bands == the unsharded port (rtol 1e-4, atol
    1e-5, tests/test_parallel.py:193-211), with as many levels banded as
    the lead rule gives; the JAX test's config also == JAX's
    UNetModel.apply and its make_spatial_sharded_apply on 2 devices."""
    inp, res = mesh_run
    cfg, sd, x = inp["unets"][which]
    model = UNetModel(**cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    with torch.no_grad():
        want = model(torch.from_numpy(x), torch.zeros(1, dtype=torch.long))
    want = want.numpy()
    for r in res:
        got, banded = r["unet"][which]
        assert banded == UNETS[which][2]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    if which == 0:
        fmodel, fparams = _flax_params(cfg, seed=0)
        xj = jnp.asarray(x.transpose(0, 2, 3, 1))
        tj = jnp.zeros((1,), jnp.int32)
        jmesh = jax_make_mesh([2, 1], ("data", "view"),
                              devices=_jax_devices(2))
        for jout in (fmodel.apply(fparams, xj, tj),
                     jax_spatial(fmodel, jmesh)(fparams, xj, tj)):
            np.testing.assert_allclose(
                res[0]["unet"][0][0], np.asarray(jout).transpose(0, 3, 1, 2),
                rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# The engine under mesh_shape [2, 1]
# ---------------------------------------------------------------------------

GEO = dict(nx=32, ny=32, dx=42 / 32, dy=42 / 32, nr=64,
           dr=0.0010125 * 912 / 64, na=90, ta_dimx=101, ta_dimy=46)


def _corpus(root):
    """Two 32² slices in the four-stream layout
    (test_torch_train_engine.py's corpus)."""
    geom = G.FanBeamGeometry(**GEO)
    g = fbp_geom_from_fan(geom)
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    streams = ("fd_img", "ld_img", "fd_proj", "ld_proj")
    for s in streams:
        os.makedirs(osp.join(root, s, "P001"))
    for i in range(2):
        vol = torch.from_numpy(random_ellipse_phantom(32, rng)[None].astype(
            np.float32))
        fd_proj = project_fast(vol, g, geom.nr, float(g.nda[0]), float(g.da))
        ld_proj = add_noise(fd_proj, gen, 0.25)
        ld_img = vol + 0.002 * torch.randn(vol.shape, generator=gen)
        for s, arr in zip(streams, (vol.transpose(1, 2), ld_img.transpose(
                1, 2), fd_proj, ld_proj)):
            np.save(osp.join(root, s, "P001", f"{i:04d}.npy"), arr[0].numpy())
    paths = {}
    for kind in ("FD_img", "LD_img", "FD_proj", "LD_proj"):
        d = osp.join(root, kind.lower())
        paths[f"test_dataset_path_{kind}"] = d
        if kind.startswith("FD"):
            paths[f"train_dataset_path_{kind}"] = d
    return paths


def _engine_cfgs(paths):
    """train_img for 2 steps (batch 2 × 2 patches: 2 rows a rank; its
    checkpoints and test(1) at step 2), then one test_prog slice (FBP,
    seeded weights)."""
    common = dict(
        run_name="mesh", test_batch_size=1, convertor="FBP",
        fbp_sharpen=True, ultra_img_denoise=False, model_channels_img=8,
        channel_mult_img=[1, 1, 2], attention_resolutions_img=[4],
        timesteps_img=50, partial_timesteps_img=10, t_start_img=[3, 2],
        constant_guidance_img=0.45, model_channels_proj=8,
        channel_mult_proj=[1, 1, 2], attention_resolutions_proj=[4],
        timesteps_proj=50, t_start_proj=[3, 2], constant_guidance_proj=0.5,
        metrics=["psnr", "ssim"], geometry=GEO, **paths)
    return {
        "train": dict(common, mode="train_img", batch_size=2, max_epochs=2,
                      save_freq=2, test_numbers=1, init_lr=1e-3,
                      patch=[16, 16], patch_per_image=2),
        "test": dict(common, mode="test_prog", test_numbers=1,
                     save_it_state_proj=True, save_it_state_img=True),
    }


@pytest.fixture(scope="module")
def engine_runs(tmp_path_factory):
    """The 2-rank run (one spawn) and the same configs in this process
    without a mesh."""
    root = str(tmp_path_factory.mktemp("mesh_engine"))
    cfgs = _engine_cfgs(_corpus(osp.join(root, "corpus")))
    os.makedirs(osp.join(root, "ranks"))
    ranks = run_ranks(R.engine_run, 2, osp.join(root, "ranks"), (cfgs,),
                      timeout=RANK_TIMEOUT, threads=1)
    single = {"losses": []}
    for name, cfg in cfgs.items():
        eng = ProgressiveDomainDenoiser(
            IPDMConfig(device="cpu", **cfg),
            result_save_path=osp.join(root, "single"))
        train = eng.train
        eng.train = lambda *a: single["losses"].append(train(*a))
        if cfg["mode"] == "train_img":
            single["init"] = {k: v.numpy().copy()
                              for k, v in eng.img_model.state_dict().items()}
        eng.fit()
        single[name] = (
            {k: v.numpy() for k, v in eng.img_model.state_dict().items()}
            if cfg["mode"] == "train_img"
            else dict(eng.progressive_denoise_result,
                      **{f"proj_{k}": v for k, v in
                         eng.proj_denoise_convert2img_result.items()}))
    return ranks, single


def test_engine_mesh_train_img_matches_one_process(engine_runs):
    """train_img under mesh_shape [2, 1] (the sharded step, every rank
    reading the global batch) == the one-process run, on both ranks:
    both steps' losses (rtol 1e-5) and the trained model's output on a
    seeded input, within 1e-4 of the output's largest value and within
    1% of what the two steps moved it. (The parameters are not held
    elementwise: Adam scales the f32 rounding noise of gradients that are
    ~0 up to an update, see the step test.)"""
    ranks, single = engine_runs
    x = torch.from_numpy(np.random.default_rng(3).random(
        (2, 1, 32, 32), np.float32))
    t = torch.tensor([1, 7])

    def output(state):
        m = UNetModel(in_channels=1, model_channels=8, out_channels=1,
                      attention_resolutions=(4,), channel_mult=(1, 1, 2),
                      device="cpu")
        m.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
        with torch.no_grad():
            return m(x, t).numpy()

    want = output(single["train"])
    moved = np.abs(want - output(single["init"])).max()
    assert len(single["losses"]) == 2 and moved > 1e-3
    for r in ranks:
        np.testing.assert_allclose(r["losses"], single["losses"], rtol=1e-5)
        diff = np.abs(output(r["train"]) - want).max()
        assert diff <= min(1e-4 * np.abs(want).max(), 0.01 * moved), diff


def test_engine_mesh_test_prog_matches_unsharded(engine_runs):
    """One test_prog slice with both UNets' evals on H-bands == the
    unsharded engine's iterations (rtol 1e-4, atol 1e-5)."""
    ranks, single = engine_runs
    want = single["test"]
    assert len(want) == 6      # 2 iterations + the ensemble, each stage
    for r in ranks:
        assert sorted(r["test"]) == sorted(want)
        for k, v in want.items():
            np.testing.assert_allclose(r["test"][k], v, rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def test_engine_mesh_rank0_writes(engine_runs):
    """Only rank 0 writes: options, checkpoints, scalars, metrics; rank 1
    makes not even its result directory."""
    ranks, _ = engine_runs
    files = ranks[0]["files"]
    for name in ("save_models/option.json", "save_models/img_model-1",
                 "save_models/optimizer-1", "trainSummary/scalars.jsonl",
                 "save_test_results/Save_Iter_0/metric.json",
                 "save_test_results/Save_Iter_1/metric.json"):
        assert any(f.endswith(name) for f in files), (name, files)
    assert ranks[1]["files"] == [] and not ranks[1]["dirs"]


def test_engine_mesh_refuses_a_batch_that_does_not_divide(engine_runs):
    """train_img with a global batch of 1 row under mesh_shape [2, 1] is
    refused when the engine is built, with the fix named."""
    ranks, _ = engine_runs
    for r in ranks:
        assert "does not divide over the mesh's data axis of 2" in (
            r["bad_batch"])
        assert "--batch_size to a multiple of 2" in r["bad_batch"]


def test_run_ranks_fails_with_a_rank_traceback(tmp_path):
    """A rank that raises fails run_ranks with that rank's traceback."""
    with pytest.raises(RuntimeError, match="a planted fault on rank 1"):
        run_ranks(R.failing_rank, 2, tmp_path, timeout=RANK_TIMEOUT,
                  threads=1)


def test_engine_mesh_raises_without_torchrun(monkeypatch, tmp_path):
    """mesh_shape with no process group and no torchrun environment
    raises and names torchrun; it never runs on one process."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    opt = IPDMConfig(device="cpu", mode="test_img", mesh_shape=[2, 1])
    with pytest.raises(RuntimeError, match="torchrun"):
        ProgressiveDomainDenoiser(opt, result_save_path=str(tmp_path))
    assert not os.listdir(tmp_path)
