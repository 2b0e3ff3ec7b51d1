"""Process-group parallelism (port of ipdm_tpu/parallel/mesh.py):
data-parallel training, view-sharded CT physics and H-sharded UNet
evaluation over ``torch.distributed``.

One process per device: ``torchrun`` sets ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``, each rank runs on ``cuda:{LOCAL_RANK}``, and the caller
(or the engine, ``engine/denoiser.py``) initialises the process group:
NCCL on the card, gloo on the CPU. The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named axes; each axis
gives the sub-group its collectives run over.

  * **data axis** — :func:`make_sharded_train_step`: the global batch is
    drawn alike on every rank, each rank keeps its rows, and
    ``DistributedDataParallel`` averages the gradients over the axis (the
    JAX package's jit shardings insert the same all-reduce).
  * **view axis** — :func:`make_view_sharded_fbp` backprojects each rank's
    wedge of views and sums the partial images with one ``all_reduce``;
    :func:`make_view_sharded_fp` projects each rank's wedge and gathers
    the sinogram. Every gather is an exact ``all_reduce`` of zero-padded
    slots: gloo reduces CUDA tensors but does not gather them.
  * **H bands** — :func:`make_spatial_sharded_apply` evaluates the UNet on
    one band of rows per rank. XLA inserts the halo exchanges, GroupNorm
    sums and attention gathers for JAX; here :class:`_Bands` does them for
    ``models/unet.py``'s banded forward, with ``planar_unit`` kept on.

The JAX package's ``batch_sharding`` and ``replicated`` are XLA sharding
specs; a rank here holds plain tensors, so they have no counterpart.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ipdm_tpu_torch.diffusion.diffusion import GaussianDiffusion
from ipdm_tpu_torch.engine.trainer import train_inputs
from ipdm_tpu_torch.recon.fbp import FBPGeometry, SIEMENS_FBP, fbp_convert
from ipdm_tpu_torch.recon.geometry import FanBeamGeometry
from ipdm_tpu_torch.recon.projector import VIEW_BLOCK, forward_project

Axis = Union[str, Sequence[str]]


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Tuple[str, ...] = ("data", "view"),
              device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh over all ranks of the initialised process group.

    ``shape=None`` puts every rank on the first axis (pure data parallel),
    the other axes size 1; one entry may be -1. ``device_type`` defaults
    to "cuda" where CUDA is available, else "cpu". Raises without a
    process group, and when the shape's product is not the world size."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised process group: launch with "
            "torchrun and call torch.distributed.init_process_group first")
    n = dist.get_world_size()
    if shape is None:
        shape = [n] + [1] * (len(axis_names) - 1)
    shape = [int(s) for s in shape]
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        shape[shape.index(-1)] = n // known
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} != world size {n}")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names[:len(shape)]))


def _group(mesh: DeviceMesh, axis: Axis):
    """The process group of one mesh axis, or of all of them."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    if len(names) == 1:
        return mesh.get_group(names[0])
    if sorted(names) == sorted(mesh.mesh_dim_names):
        return dist.group.WORLD
    raise ValueError(f"axes {names}: one axis of {mesh.mesh_dim_names} "
                     "or all of them")


def _shard(x, mesh: DeviceMesh, axis: Axis, dim: int):
    """This rank's contiguous share of ``dim`` over ``axis``."""
    group = _group(mesh, axis)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"dim {dim} of size {size} does not divide over "
                         f"{n} ranks")
    per = size // n
    index = [slice(None)] * x.ndim
    index[dim] = slice(r * per, (r + 1) * per)
    return x[tuple(index)]


def shard_batch(x, mesh: DeviceMesh, axis: Axis = "data"):
    """This rank's contiguous rows of dim 0 (numpy or torch); raises when
    the batch does not divide over the axis."""
    return _shard(x, mesh, axis, 0)


def shard_rows(x: torch.Tensor, mesh: DeviceMesh,
               axis: Axis = "data") -> torch.Tensor:
    """This rank's H-band (dim 2) of an NCHW tensor that every rank
    holds: the input of :func:`make_spatial_sharded_apply`."""
    return _shard(x, mesh, axis, 2)


def gather_rows(y: torch.Tensor, mesh: DeviceMesh,
                axis: Axis = "data") -> torch.Tensor:
    """The whole NCHW tensor from every rank's H-band, on every rank."""
    return _all_gather_cat(y, _group(mesh, axis), 2)


def _all_gather(x: torch.Tensor, group) -> list:
    """Every rank's x (one shape on all), in rank order, on every rank:
    one ``all_reduce(SUM)`` of a buffer that is zero but for each rank's
    own slot, which is exact. gloo reduces CUDA tensors but does not
    gather them; NCCL takes the same call."""
    n = dist.get_world_size(group)
    if n == 1:
        return [x]
    buf = x.new_zeros((n,) + tuple(x.shape))
    buf[dist.get_rank(group)] = x
    dist.all_reduce(buf, group=group)
    return list(buf.unbind(0))


def _all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = _all_gather(x, group)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def make_sharded_train_step(model: torch.nn.Module, gd: GaussianDiffusion,
                            optimizer: torch.optim.Optimizer,
                            partial_timesteps: int, mesh: DeviceMesh,
                            generator: Optional[torch.Generator],
                            axis: Axis = "data"):
    """Data-parallel twin of ``engine.trainer.make_train_step``.

    ``step(images, t=None, noise=None)`` takes the **global** batch (NHWC,
    the same on every rank), draws t and then the noise for all of it from
    ``generator`` (seeded alike on every rank), keeps this rank's rows,
    and runs the loss through ``DistributedDataParallel`` over the axis,
    which averages the gradients before the optimizer's step. Returns the
    global mean loss, a 0-d tensor on every rank. With equal shards the
    step equals ``make_train_step`` on the whole batch, up to the order of
    f32 sums. The batch must divide over the axis."""
    from torch.nn.parallel import DistributedDataParallel

    group = _group(mesh, axis)
    n = dist.get_world_size(group)
    dev = gd.device
    if dev.type == "cuda":
        ids = [torch.cuda.current_device() if dev.index is None
               else dev.index]
    else:
        ids = None
    ddp = DistributedDataParallel(model, process_group=group,
                                  device_ids=ids)

    def train_step(images, t=None, noise=None) -> torch.Tensor:
        x, t, noise = train_inputs(images, t, noise, partial_timesteps,
                                   generator, dev)
        x, t, noise = (shard_batch(v, mesh, axis) for v in (x, t, noise))
        optimizer.zero_grad(set_to_none=True)
        loss = gd.train_loss(ddp, x, t, noise)
        loss.backward()
        optimizer.step()
        total = loss.detach().reshape(1).clone()
        dist.all_reduce(total, group=group)
        return total[0] / n

    return train_step


# ---------------------------------------------------------------------------
# View-sharded physics
# ---------------------------------------------------------------------------


def make_view_sharded_fbp(mesh: DeviceMesh, g: FBPGeometry = SIEMENS_FBP,
                          axis: Axis = "view", view_block: int = 50):
    """FBP with the ``g.M`` views split over ``axis``.

    Each rank weights, ramp-filters and backprojects its contiguous wedge
    of views (``recon/fbp.py::fbp_convert`` on those views: the filter acts
    per view, so it commutes with the split), then one ``all_reduce(SUM)``
    adds the partial images. Input [B, M, N] (the whole sinogram, or this
    rank's wedge); output [B, n, n] on every rank."""
    group = _group(mesh, axis)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if g.M % n:
        raise ValueError(f"{g.M} views do not divide over {n} ranks")
    per = g.M // n
    v0 = r * per
    theta = g.theta[v0:v0 + per]

    def fbp(pj: torch.Tensor) -> torch.Tensor:
        if pj.shape[1] == g.M:
            pj = pj[:, v0:v0 + per]
        elif pj.shape[1] != per:
            raise ValueError(f"sinogram of {pj.shape[1]} views: {g.M} or "
                             f"this rank's {per}")
        img = fbp_convert(pj, g, view_block=view_block, theta=theta)
        if n > 1:
            dist.all_reduce(img, group=group)
        return img

    return fbp


def make_view_sharded_fp(mesh: DeviceMesh, geom: FanBeamGeometry, lut,
                         betas, axis: Axis = "view",
                         block: int = VIEW_BLOCK):
    """Forward projection with the ``geom.na`` views split over ``axis``:
    the image [ny, nx] is the same on every rank, each rank projects its
    contiguous wedge of views (``recon/projector.py::forward_project``),
    and a gather assembles the [na, nr] sinogram on every rank."""
    group = _group(mesh, axis)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if geom.na % n:
        raise ValueError(f"{geom.na} views do not divide over {n} ranks")
    per = geom.na // n
    geom_local = geom.replace(na=per)
    betas_local = np.asarray(betas)[r * per:(r + 1) * per]

    def fp(x: torch.Tensor) -> torch.Tensor:
        part = forward_project(x, geom_local, lut, betas_local, block)
        return _all_gather_cat(part, group, 0)

    return fp


# ---------------------------------------------------------------------------
# H-sharded UNet evaluation
# ---------------------------------------------------------------------------


class _Bands:
    """One rank's H-band of a UNet eval: the collectives of
    ``UNetModel.forward(..., band=...)`` over ``group``.

    Level l (stride 2^l) stays banded while every band's height is even at
    each downsampling above it, no attention sits at or above it, and it
    is not the middle block's level (attention needs every token). The
    deepest banded level's downsampling input is gathered, the levels
    below run on the whole tensor on every rank, and the upsampling back
    into that level cuts it into bands again."""

    def __init__(self, group, model, rows: int):
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.rows0 = rows * self.n
        depth = len(model.channel_mult) - 2    # the middle block's level
        attn = set(model.attention_resolutions)
        banded = 0
        while (banded < depth and 2 ** banded not in attn
               and rows % 2 ** banded == 0):
            banded += 1
        self.banded = banded

    def at(self, level: int):
        return self if level < self.banded else None

    def rows(self, level: int) -> int:
        """The whole slice's height at a banded level."""
        return self.rows0 >> level

    def all_reduce_(self, t: torch.Tensor) -> None:
        if self.n > 1:
            dist.all_reduce(t, group=self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _all_gather_cat(x, self.group, 2)

    def halo(self, x: torch.Tensor):
        """(the band above's last row, the band below's first row), each
        [B, C, 1, W], None at the slice's global top / bottom."""
        if self.n == 1:
            return None, None
        parts = _all_gather(torch.stack([x[:, :, 0], x[:, :, -1]]),
                            self.group)
        top = parts[self.rank - 1][1, :, :, None] if self.rank else None
        bottom = (parts[self.rank + 1][0, :, :, None]
                  if self.rank + 1 < self.n else None)
        return top, bottom

    def cut(self, full: torch.Tensor):
        """(this rank's band, top halo row, bottom halo row) of a whole
        tensor that every rank holds."""
        h = full.shape[2] // self.n
        r0 = self.rank * h
        top = full[:, :, r0 - 1:r0] if self.rank else None
        bottom = (full[:, :, r0 + h:r0 + h + 1]
                  if self.rank + 1 < self.n else None)
        return full[:, :, r0:r0 + h], top, bottom


def make_spatial_sharded_apply(model: torch.nn.Module, mesh: DeviceMesh,
                               axis: Axis = "data"):
    """H-sharded evaluation of a ``models/unet.py`` UNet: parameters the
    same on every rank, each rank one contiguous band of rows
    (:func:`shard_rows`).

    Returns ``fn(x_band, t) -> y_band`` (NCHW; :func:`gather_rows`
    assembles the whole output). Every rank of the axis must call it
    together. Equals ``model(x, t)`` up to the order of the GroupNorm
    statistics' f32 sums and the convolutions' sums on bands."""
    group = _group(mesh, axis)

    def apply(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return model(x, t, band=_Bands(group, model, x.shape[2]))

    return apply
