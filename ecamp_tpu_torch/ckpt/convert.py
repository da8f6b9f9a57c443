"""Weights into the port: the JAX param tree and reference `.pth` files.

`state_dict_from_flax` maps a JAX `ViTClassifier` or `ECAMP` param tree
onto the port's state dict by the rules of `ecamp_tpu/ckpt/torch_import.py
::_default_key_fn` and `torch_export.py::_deconvert` and the namespace of
`export_ecamp_pretrain` (reimplemented here; the port imports nothing of
JAX): `blocks_i` -> `blocks.i` (so `decoder_blocks_i` ->
`decoder_blocks.i`), BERT `layer_i` -> `encoder.layer.i`, the MLM head's
`transform_*` / `decoder` -> `predictions.*`, `bert.*` ->
`bert_encoder.model.bert.*` and `bert.cls.*` -> `bert_encoder.model.cls.*`,
`kernel` / `embedding` / `scale` -> `weight` with 2-D (in, out) ->
(out, in) and 4-D HWIO -> OIHW, and the `trunk.` prefix dropped. The ECAMP
sin-cos tables are buffers in the port and constants in JAX, so neither
side has them as keys.

`load_reference_pth` reads a reference classifier checkpoint the way
`ckpt/torch_import.py:173-179` does: unwrap `model` and `state_dict`, strip
DDP `module.` prefixes.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..nn.pos_embed import interpolate_pos_embed

_LEAF_TO_TORCH = {"kernel": "weight", "scale": "weight",
                  "embedding": "weight"}
_MLM_HEAD = (("cls.transform_dense", "cls.predictions.transform.dense"),
             ("cls.transform_LayerNorm",
              "cls.predictions.transform.LayerNorm"),
             ("cls.decoder", "cls.predictions.decoder"))


def _flatten(tree: Mapping[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _key(path) -> str:
    *mods, leaf = path
    joined = re.sub(r"blocks_(\d+)", r"blocks.\1", ".".join(mods))
    joined = re.sub(r"layer_(\d+)", r"encoder.layer.\1", joined)
    for jax_name, torch_name in _MLM_HEAD:
        joined = joined.replace(jax_name, torch_name)
    if joined.startswith("trunk."):
        joined = joined[len("trunk."):]
    elif joined == "trunk":
        joined = ""
    elif joined.startswith("bert.cls."):
        joined = "bert_encoder.model." + joined[len("bert."):]
    elif joined.startswith("bert."):
        joined = "bert_encoder.model.bert." + joined[len("bert."):]
    leaf = _LEAF_TO_TORCH.get(leaf, leaf)
    return f"{joined}.{leaf}" if joined else leaf


def _value(leaf: str, v) -> np.ndarray:
    v = np.asarray(v, np.float32)
    if leaf == "kernel":
        if v.ndim == 2:
            v = v.T                      # in,out -> out,in
        elif v.ndim == 4:
            v = v.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    return np.ascontiguousarray(v)


def state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX `ViTClassifier` or `ECAMP` params (`variables["params"]`, a
    tree of arrays) -> the port's state dict of the same model (fp32 CPU
    tensors). A gradient tree maps the same way."""
    return {_key(path): torch.tensor(_value(path[-1], v))
            for path, v in _flatten(params)}


def _model_state(ckpt: Mapping[str, Any]) -> Dict[str, Any]:
    state = ckpt.get("model", ckpt)
    if "state_dict" in state:
        state = state["state_dict"]
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state.items()}


def load_reference_pth(path: str) -> Dict[str, torch.Tensor]:
    """A reference classifier `.pth` as a flat state dict (fp32)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return {k: torch.as_tensor(v).float()
            for k, v in _model_state(ckpt).items()}


def load_classifier_state(model: nn.Module,
                          state: Mapping[str, torch.Tensor]) -> nn.Module:
    """Strict-load `state` into a port `ViTClassifier`; a `pos_embed` from
    another patch grid is bicubic-resized to the model's grid first."""
    state = dict(state)
    pe = state.get("pos_embed")
    if pe is not None and pe.shape != model.pos_embed.shape:
        state["pos_embed"] = interpolate_pos_embed(pe,
                                                   model.cfg.grid_size)
    model.load_state_dict(state, strict=True)
    return model
