"""Weights into the port: the JAX param tree and reference `.pth` files.

`state_dict_from_flax` maps a JAX `ViTClassifier`, `ECAMP`, `SegViT`,
`SegViTDual` or `DetectionModel` param tree (and a `batch_stats` tree)
onto the port's state dict by the rules of `ecamp_tpu/ckpt/
torch_import.py::_default_key_fn` and `torch_export.py::_deconvert` and
the namespaces of `export_ecamp_pretrain`, `export_seg_vit` and
`export_detector` (reimplemented here; the port imports nothing of JAX):
`blocks_i` -> `blocks.i` (so `decoder_blocks_i` -> `decoder_blocks.i`),
BERT `layer_i` -> `encoder.layer.i`, the MLM head's `transform_*` /
`decoder` -> `predictions.*`, `bert.*` -> `bert_encoder.model.bert.*` and
`bert.cls.*` -> `bert_encoder.model.cls.*`, the seg decoders'
`decoder_i_conv` / `decoder_i_bn` -> `decoder_i.0` / `decoder_i.1`, the
YOLO head's `embeddingN/cbl_i` -> `embeddingN.i` with its `head.` prefix
dropped, the ResNet-50's `layerN_M` -> `layerN.M` and `downsample_conv` /
`downsample_bn` -> `downsample.0` / `downsample.1` (a `ResNetUNet`, or a
`DetectionModel` with the ResNet-50 backbone), `kernel` / `embedding` /
`scale` -> `weight` with 2-D (in, out) -> (out, in) and 4-D HWIO -> OIHW,
BatchNorm `mean` / `var` -> `running_mean` / `running_var`, and the
`trunk.` prefix dropped (a
`SegEncoder`'s `encoder.trunk.` becomes `encoder.`, a `DetEncoder`'s
`backbone.encoder.trunk.` `backbone.encoder.`). The ECAMP sin-cos tables
are buffers in the port and constants in JAX, so neither side has them as
keys.

`load_reference_pth` reads a reference checkpoint the way
`ckpt/torch_import.py:173-179` does: unwrap `model` and `state_dict`, strip
DDP `module.` prefixes; `load_reference_state` strict-loads it.
`import_vit_classifier`, `import_seg_vit` and `import_detector` initialise
a classifier, a segmenter or a detector from such a checkpoint, or from a
pretraining one, by the JAX package's partial-load rule (`_apply_state`),
`import_ecamp_pretrain` an ECAMP from a pretraining one;
`import_resnet_unet` and `import_detector(backbone="resnet50")` the
ResNet-50 baselines from a torchvision-layout one.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..nn.pos_embed import interpolate_pos_embed

_LEAF_TO_TORCH = {"kernel": "weight", "scale": "weight",
                  "embedding": "weight", "mean": "running_mean",
                  "var": "running_var"}
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
    joined = re.sub(r"decoder_(\d+)_conv", r"decoder_\1.0", joined)
    joined = re.sub(r"decoder_(\d+)_bn", r"decoder_\1.1", joined)
    joined = re.sub(r"embedding(\d+)\.cbl_(\d+)", r"embedding\1.\2", joined)
    joined = re.sub(r"layer(\d)_(\d+)", r"layer\1.\2", joined)  # ResNet-50
    joined = joined.replace("downsample_conv", "downsample.0")
    joined = joined.replace("downsample_bn", "downsample.1")
    joined = re.sub(r"^head\.", "", joined)  # the detector's YOLO head
    joined = re.sub(r"^((?:backbone\.)?encoder)\.trunk(\.|$)", r"\1\2",
                    joined)
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


def state_dict_from_flax(params: Mapping[str, Any],
                         batch_stats: Optional[Mapping[str, Any]] = None
                         ) -> Dict[str, torch.Tensor]:
    """JAX params (`variables["params"]`, a tree of arrays) -> the port's
    state dict of the same model (fp32 CPU tensors). A gradient tree maps
    the same way. With `batch_stats`, each BatchNorm's running mean and
    variance join it, and its `num_batches_tracked` (a torch buffer that
    flax does not keep) reads 0."""
    out = {_key(path): torch.tensor(_value(path[-1], v))
           for path, v in _flatten(params)}
    for path, v in _flatten(batch_stats or {}):
        key = _key(path)
        out[key] = torch.tensor(_value(path[-1], v))
        if path[-1] == "mean":
            out[key[:-len("running_mean")] + "num_batches_tracked"] = \
                torch.zeros((), dtype=torch.long)
    return out


def _model_state(ckpt: Mapping[str, Any]) -> Dict[str, Any]:
    state = ckpt.get("model", ckpt)
    if "state_dict" in state:
        state = state["state_dict"]
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state.items()}


def load_reference_pth(path: str) -> Dict[str, torch.Tensor]:
    """A reference `.pth` as a flat state dict (fp32)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return {k: torch.as_tensor(v).float()
            for k, v in _model_state(ckpt).items()}


def load_reference_state(model: nn.Module,
                         state: Mapping[str, torch.Tensor]) -> nn.Module:
    """Strict-load a reference-namespace `state` into a port model (a
    `ViTClassifier`, `SegViT` or `SegViTDual`): a `pos_embed` from another
    patch grid is bicubic-resized to the model's grid first, and a
    BatchNorm `num_batches_tracked` that the file lacks (the JAX package's
    `export_seg_vit` writes none) keeps the model's."""
    state = dict(state)
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            state.setdefault(k, v)
        elif (k.endswith("pos_embed") and k in state
              and state[k].shape != v.shape):
            state[k] = interpolate_pos_embed(state[k], model.cfg.grid_size)
    model.load_state_dict(state, strict=True)
    return model


def _load_matching(model: nn.Module, state: Mapping[str, torch.Tensor],
                   source: Callable[[str], Optional[str]]
                   ) -> Tuple[List[str], List[str]]:
    """The JAX package's partial load (`_apply_state`): each entry of the
    model's state dict is looked up in `state` under `source(name)` (None:
    left at init); an entry whose shape matches is copied, a 3-D
    `pos_embed` of the same width from another patch grid is
    bicubic-resized to the model's grid, any other mismatch keeps the
    init. BatchNorm `num_batches_tracked` counters, which flax does not
    keep, are neither loaded nor listed. Returns (loaded names, names left
    at init)."""
    loaded, missing = [], []
    with torch.no_grad():
        for name, p in model.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            key = source(name)
            src = None if key is None else state.get(key)
            if src is not None and tuple(src.shape) != tuple(p.shape):
                if (name.endswith("pos_embed") and src.ndim == 3
                        and p.ndim == 3 and src.shape[-1] == p.shape[-1]):
                    src = interpolate_pos_embed(
                        src, int(round((p.shape[1] - 1) ** 0.5)))
                if tuple(src.shape) != tuple(p.shape):
                    src = None
            if src is None:
                missing.append(name)
                continue
            p.copy_(src.to(p.dtype))
            loaded.append(name)
    return loaded, missing


def import_vit_classifier(model: nn.Module, path: str
                          ) -> Tuple[List[str], List[str]]:
    """Initialise a port `ViTClassifier` from a reference `.pth` (a
    fine-tuned classifier or a pretraining checkpoint), as the JAX package's
    `import_vit_classifier` does (`ecamp_tpu/ckpt/torch_import.py:130-170,
    205-215`): after unwrapping and stripping `module.`, each parameter of
    the model is looked up by its name (the JAX package maps its `trunk.`
    subtree to these top-level names) and loaded by `_load_matching`, so
    `head.*` of another width keeps the init. A pretraining checkpoint of
    the port holds no `pos_embed` (a buffer there), so the classifier's
    stays at init, as in the JAX package. Returns (loaded names, names
    left at init)."""
    return _load_matching(model, load_reference_pth(path), lambda n: n)


# entries of a reference pretraining `.pth` that the port holds otherwise:
# the two sin-cos tables (buffers here, constants in JAX) and HF's tied MLM
# bias (the decoder keeps its own)
PRETRAIN_UNUSED = ("pos_embed", "decoder_pos_embed",
                   "bert_encoder.model.cls.predictions.bias")


def pretrain_state(path: str) -> Dict[str, torch.Tensor]:
    """A pretraining `.pth` (the port's `checkpoint-<epoch>.pth` or a
    reference one) as the port's ECAMP state: `model` unwrapped, `module.`
    stripped, the visualizer's `cross_attn_layer` read as
    `context_fusion_layer` (as `ecamp_tpu/ckpt/torch_import.py::
    import_ecamp_pretrain` does) and `PRETRAIN_UNUSED` dropped."""
    state = {k.replace("cross_attn_layer", "context_fusion_layer"): v
             for k, v in load_reference_pth(path).items()}
    return {k: v for k, v in state.items() if k not in PRETRAIN_UNUSED}


def import_ecamp_pretrain(model: nn.Module, path: str
                          ) -> Tuple[List[str], List[str]]:
    """Initialise a port `ECAMP` from a pretraining `.pth` by the JAX
    package's partial-load rule (`import_ecamp_pretrain`, convention 1):
    every entry of `pretrain_state(path)` under the model's own name and of
    its shape is copied. Returns (loaded names, names left at init); a
    caller that needs some of them whole checks the second list."""
    state = pretrain_state(path)
    return _load_matching(model, state, lambda n: n)


def import_seg_vit(model: nn.Module, path: str, from_pretrain: bool = True,
                   flavor: str = "ecamp") -> Tuple[List[str], List[str]]:
    """Initialise a port `SegViT` or `SegViTDual` from a reference `.pth`,
    as the JAX package's `import_seg_vit` does (`ecamp_tpu/ckpt/
    torch_import.py:218-245`, convention 3): with `from_pretrain` only the
    trunk, found in a pretraining checkpoint without its `encoder.` prefix
    (`seg_head` and the decoders keep their init); otherwise a fine-tuned
    SegViT's every parameter and BatchNorm statistic under its own name;
    both by `_load_matching`. `flavor` is the RIGA baselines' convention
    (train_RIGA.py:110-138): 'ecamp', or 'gloria', whose keys carry a
    `gloria.img_encoder.model.` prefix that is stripped first ('random'
    loads nothing and never reaches here). Returns (loaded names, names
    left at init)."""
    state = load_reference_pth(path)
    if flavor == "gloria":
        pre = "gloria.img_encoder.model."
        state = {k[len(pre):]: v for k, v in state.items()
                 if k.startswith(pre)}
    elif flavor != "ecamp":
        raise ValueError(f"unknown checkpoint flavor {flavor!r}")

    def source(name: str) -> Optional[str]:
        if not from_pretrain:
            return name
        if name.startswith("encoder.") and not name.startswith(
                "encoder.seg_head."):
            return name[len("encoder."):]
        return None

    return _load_matching(model, state, source)


def _strip_prefixes(state: Mapping[str, torch.Tensor],
                    prefixes: Tuple[str, ...]) -> Dict[str, torch.Tensor]:
    """Each key without the first of `prefixes` it starts with."""
    out = {}
    for k, v in state.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
                break
        out[k] = v
    return out


def _first_present(state: Mapping[str, torch.Tensor],
                   candidates) -> Optional[str]:
    return next((c for c in candidates if c in state), None)


# the wrappers of the reference's baseline checkpoints (ResNetDetector's
# `img_encoder`, GLoRIA's), stripped before a ResNet-50 import
_RESNET_PREFIXES = ("module.img_encoder.", "img_encoder.",
                    "gloria.img_encoder.")


def import_detector(model: nn.Module, path: str, from_pretrain: bool = True,
                    backbone: str = "vit") -> Tuple[List[str], List[str]]:
    """Initialise a port `DetectionModel` from a reference `.pth`, as the
    JAX package's `import_detector` does (`ecamp_tpu/ckpt/
    torch_import.py:267-305`, convention 4), by `_load_matching`.

    ViT backbone: with `from_pretrain` only the trunk, found in a
    pretraining checkpoint without its `backbone.encoder.` prefix
    (`det_head`, the neck and the YOLO head keep their init); otherwise a
    fine-tuned detector's every parameter and BatchNorm statistic under
    its own name (the namespace of `export_detector`).

    `backbone="resnet50"` (Detection/train.py:99-131): the backbone reads
    torchvision-layout keys, bare or `model.`-prefixed (ResNetDetector's
    `model`), after the `module.img_encoder.` / `img_encoder.` /
    `gloria.img_encoder.` wrappers are stripped; torchvision's `fc.*` and
    `num_batches_tracked` are ignored. With `from_pretrain` the head
    keeps its init; otherwise it reads its own names, or the JAX tree's
    `head.`-prefixed ones. Returns (loaded names, names left at init)."""
    state = load_reference_pth(path)
    if backbone == "resnet50":
        state = _strip_prefixes(state, _RESNET_PREFIXES)

        def source(name: str) -> Optional[str]:
            if name.startswith("backbone."):
                bare = name[len("backbone."):]
                return _first_present(state, (bare, f"model.{bare}"))
            if from_pretrain:
                return None
            return _first_present(state, (f"head.{name}", name))

        return _load_matching(model, state, source)
    if backbone != "vit":
        raise ValueError(f"unknown detector backbone {backbone!r}")
    pre = "backbone.encoder."

    def source(name: str) -> Optional[str]:
        if not from_pretrain:
            return name
        if name.startswith(pre) and not name.startswith(pre + "det_head."):
            return name[len(pre):]
        return None

    return _load_matching(model, state, source)


def import_resnet_unet(model: nn.Module, path: str
                       ) -> Tuple[List[str], List[str]]:
    """Initialise a port `ResNetUNet`'s encoder from a torchvision-layout
    ResNet-50 `.pth`, as the JAX package's `import_resnet_unet` does
    (`ecamp_tpu/ckpt/torch_import.py:311-327`): after the
    `module.img_encoder.` / `img_encoder.` / `gloria.img_encoder.`
    wrappers are stripped, each encoder entry is read under its own name,
    then `encoder.<name>` (smp's), then `model.<name>`; the decoder blocks
    and `seg_head` keep their init, and torchvision's `fc.*` and
    `num_batches_tracked` are ignored. Returns (loaded names, names left
    at init)."""
    state = _strip_prefixes(load_reference_pth(path), _RESNET_PREFIXES)

    def source(name: str) -> Optional[str]:
        if name.startswith(("decoder_", "seg_head.")):
            return None
        return _first_present(state, (name, f"encoder.{name}",
                                      f"model.{name}"))

    return _load_matching(model, state, source)
