"""Weights for the port's UNet: original-repo checkpoints and Flax params
(port of ipdm_tpu/utils/torch_import.py).

The port's :class:`~ipdm_tpu_torch.models.unet.UNetModel` names its
submodules so that its ``state_dict`` keys are the original repo's
(Model/model.py:190-281): an original checkpoint loads with
``load_state_dict`` after :func:`strip_module_prefix`. Params trained or
initialised by the JAX package's Flax UNet come across through
:func:`state_dict_from_flax`, which walks :func:`key_map` — derived from
the port's own block plan — and applies the layout transforms:

* conv kernels HWIO → OIHW (``transpose(3, 2, 0, 1)``);
* Dense kernels [in, out] → Linear weights [out, in];
* GroupNorm ``scale``/``bias`` → ``weight``/``bias``.

The attention qkv channel layout (head-major, q|k|v within a head) is the
same on both sides, so no channel permutation is needed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

# (flax leaf path suffix, torch key suffix, transform tag); tags: "conv"
# HWIO -> OIHW, "linear" [in,out] -> [out,in], "copy"
_RES_MAP = [
    (("GN_0", "scale"), "conv1.0.weight", "copy"),
    (("GN_0", "bias"), "conv1.0.bias", "copy"),
    (("conv1", "kernel"), "conv1.2.weight", "conv"),
    (("conv1", "bias"), "conv1.2.bias", "copy"),
    (("time_emb", "kernel"), "time_emb.1.weight", "linear"),
    (("time_emb", "bias"), "time_emb.1.bias", "copy"),
    (("GN_1", "scale"), "conv2.0.weight", "copy"),
    (("GN_1", "bias"), "conv2.0.bias", "copy"),
    (("conv2", "kernel"), "conv2.2.weight", "conv"),
    (("conv2", "bias"), "conv2.2.bias", "copy"),
]
_RES_SHORTCUT = [
    (("shortcut", "kernel"), "shortcut.weight", "conv"),
    (("shortcut", "bias"), "shortcut.bias", "copy"),
]
_ATTN_MAP = [
    (("GN_0", "scale"), "norm.weight", "copy"),
    (("GN_0", "bias"), "norm.bias", "copy"),
    (("qkv", "kernel"), "qkv.weight", "conv"),
    (("proj", "kernel"), "proj.weight", "conv"),
    (("proj", "bias"), "proj.bias", "copy"),
]


def key_map(model) -> List[Tuple[Tuple[str, ...], str, str]]:
    """[(flax_path, torch_key, transform)] for every parameter of the port's
    ``model``, from its static ``plan()``."""
    down_plan, middle_ch, up_plan, _final_ch = model.plan()
    out: List[Tuple[Tuple[str, ...], str, str]] = []

    def add(prefix, tkey, table):
        for fpath, tsuf, tf in table:
            out.append((prefix + fpath, f"{tkey}.{tsuf}", tf))

    def add_res(prefix, tkey, in_ch, out_ch):
        add(prefix, tkey, _RES_MAP)
        if in_ch != out_ch:
            add(prefix, tkey, _RES_SHORTCUT)

    out.append((("time_dense1", "kernel"), "time_embed.0.weight", "linear"))
    out.append((("time_dense1", "bias"), "time_embed.0.bias", "copy"))
    out.append((("time_dense2", "kernel"), "time_embed.2.weight", "linear"))
    out.append((("time_dense2", "bias"), "time_embed.2.bias", "copy"))
    for di, entry in enumerate(down_plan):
        if entry[0] == "stem":
            add((f"down{di}_stem",), f"down_blocks.{di}.0",
                [(("kernel",), "weight", "conv"), (("bias",), "bias", "copy")])
        elif entry[0] == "res":
            _, in_ch, out_ch, attn = entry
            add_res((f"down{di}_res",), f"down_blocks.{di}.0", in_ch, out_ch)
            if attn:
                add((f"down{di}_attn",), f"down_blocks.{di}.1", _ATTN_MAP)
        else:
            add((f"down{di}_ds", "op"), f"down_blocks.{di}.0.op",
                [(("kernel",), "weight", "conv"), (("bias",), "bias", "copy")])
    add_res(("mid_res1",), "middle_block.0", middle_ch, middle_ch)
    add(("mid_attn",), "middle_block.1", _ATTN_MAP)
    add_res(("mid_res2",), "middle_block.2", middle_ch, middle_ch)
    for ui, (_, in_ch, out_ch, attn, upsample) in enumerate(up_plan):
        add_res((f"up{ui}_res",), f"up_blocks.{ui}.0", in_ch, out_ch)
        j = 1
        if attn:
            add((f"up{ui}_attn",), f"up_blocks.{ui}.{j}", _ATTN_MAP)
            j += 1
        if upsample:
            add((f"up{ui}_us", "conv"), f"up_blocks.{ui}.{j}.conv",
                [(("kernel",), "weight", "conv"), (("bias",), "bias", "copy")])
    add((), "out", [(("GN_0", "scale"), "0.weight", "copy"),
                    (("GN_0", "bias"), "0.bias", "copy"),
                    (("out_conv", "kernel"), "2.weight", "conv"),
                    (("out_conv", "bias"), "2.bias", "copy")])
    return out


def _to_torch(arr: np.ndarray, tf: str) -> np.ndarray:
    if tf == "conv":
        return np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
    if tf == "linear":
        return np.ascontiguousarray(arr.T)
    return np.asarray(arr)


def state_dict_from_flax(model, flax_params: Dict[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for ``model.load_state_dict`` from the Flax tree
    ``{'params': ...}`` (nested dicts of numpy arrays) of the JAX package's
    UNet with the same configuration."""
    params = flax_params.get("params", flax_params)
    sd: Dict[str, torch.Tensor] = {}
    for fpath, tkey, tf in key_map(model):
        node = params
        for p in fpath:
            if p not in node:
                raise KeyError(f"flax params have no {'/'.join(fpath)} "
                               f"(for {tkey})")
            node = node[p]
        sd[tkey] = torch.from_numpy(
            _to_torch(np.asarray(node, dtype=np.float32), tf))
    return sd


def strip_module_prefix(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Drop the ``module.`` prefix that DDP checkpoints put on every key
    (reference Utils/loggerx.py:131-140)."""
    if sd and all(k.startswith("module.") for k in sd):
        return {k[len("module."):]: v for k, v in sd.items()}
    return sd
