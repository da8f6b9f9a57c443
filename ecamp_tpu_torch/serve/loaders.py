"""Engine factories for the classifier, the segmenter, the detector and
the ECAMP image embedding (counterpart of `ecamp_tpu/serve/loaders.py`).

The classifier serves the `.pth` that `cli/finetune_cls.py` writes, the
segmenter the one `cli/finetune_seg.py` writes, the detector the one
`cli/finetune_det.py` writes, the embedding engine a pretraining `.pth`
(`cli/pretrain.py`'s `checkpoint-<epoch>.pth` or a reference one). Orbax
checkpoints are not read. `quantize="int8"` serves every engine with
weight-only int8 (`serve/quantize.py`), as in JAX.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..core.config import BertConfig, MAEDecoderConfig, ViTConfig
from ..core.dtypes import policy
from .engine import InferenceEngine, sigmoid_np, softmax_np


def _check_pth(checkpoint: str) -> None:
    if checkpoint and not checkpoint.endswith(".pth"):
        kind = "an orbax directory" if os.path.isdir(checkpoint) else "not a .pth"
        raise ValueError(
            f"checkpoint {checkpoint!r} is {kind}: the port loads reference "
            f".pth files only, as its fine-tune CLIs write them "
            f"(best/checkpoint-best.pth); orbax checkpoints are not read")


def _maybe_quantize(model, quantize: str) -> None:
    """quantize='int8': per-output-channel weight-only int8 of the weights
    the JAX package quantizes (serve/quantize.py), in place, before the
    model goes to its device."""
    if not quantize:
        return
    if quantize != "int8":
        raise ValueError(f"unknown quantize mode {quantize!r}")
    from .quantize import quantize_module_int8

    quantize_module_int8(model)


def classifier_engine(checkpoint: str = "", num_classes: int = 14,
                      img_size: int = 224, multilabel: bool = True,
                      vit: Optional[ViTConfig] = None,
                      buckets=(8, 32, 64), bf16: bool = True,
                      device="cuda", seed: int = 0,
                      quantize: str = "") -> InferenceEngine:
    """Serve ViTClassifier logits -> probabilities (sigmoid for multilabel
    BCE tasks, softmax for single-label CE tasks — Classification/
    train.py:199-202 semantics).

    Without a checkpoint the weights are a seeded random init (`seed`,
    through a `torch.Generator`). The served module is `engine.model`."""
    from ..ckpt import load_reference_pth, load_reference_state
    from ..nn import ViTClassifier

    _check_pth(checkpoint)
    vcfg = vit or ViTConfig(img_size=img_size)
    dtype = policy(bf16).compute_dtype
    model = ViTClassifier(vcfg, num_classes, dtype=dtype,
                          generator=torch.Generator().manual_seed(seed))
    if checkpoint:
        load_reference_state(model, load_reference_pth(checkpoint))
    _maybe_quantize(model, quantize)
    model = model.to(device).eval()

    def apply_fn(x):
        # fp32 on device before the host copy: bf16 logits would leave the
        # served probabilities with only ~2-3 significant digits
        return model(x).float()

    engine = InferenceEngine(apply_fn, buckets=buckets,
                             postprocess=sigmoid_np if multilabel else softmax_np,
                             input_dtype=dtype, device=device)
    engine.model = model
    return engine


def segmenter_engine(checkpoint: str = "", img_size: int = 224,
                     dual: bool = False, vit: Optional[ViTConfig] = None,
                     buckets=(8, 32), bf16: bool = True, device="cuda",
                     seed: int = 0, quantize: str = "") -> InferenceEngine:
    """Serve SegViT sigmoid masks (B, H, W, 1) in fp32; dual=True serves
    the RIGA disc/cup pair concatenated on the channel axis (B, H, W, 2).

    The checkpoint is a fine-tuned SegViT `.pth` in the reference
    namespace, strict-loaded (`ckpt/convert.py::load_reference_state`);
    without one the weights are a seeded random init. The BatchNorms use their
    running statistics. The served module is `engine.model`."""
    from ..ckpt import load_reference_pth, load_reference_state
    from ..nn import SegViT, SegViTDual

    _check_pth(checkpoint)
    vcfg = vit or ViTConfig(img_size=img_size)
    dtype = policy(bf16).compute_dtype
    model = (SegViTDual if dual else SegViT)(
        vcfg, dtype=dtype, generator=torch.Generator().manual_seed(seed))
    if checkpoint:
        load_reference_state(model, load_reference_pth(checkpoint))
    _maybe_quantize(model, quantize)
    model = model.to(device).eval()

    def apply_fn(x):
        out = model(x, train=False)
        if dual:
            out = torch.cat(out, dim=-1)
        return torch.sigmoid(out.float())

    engine = InferenceEngine(apply_fn, buckets=buckets, input_dtype=dtype,
                             device=device)
    engine.model = model
    return engine


def detector_engine(checkpoint: str = "", img_size: int = 224,
                    num_classes: int = 1, expansion: int = 4,
                    conf_threshold: float = 0.5, nms_threshold: float = 0.5,
                    vit: Optional[ViTConfig] = None, buckets=(8, 16),
                    bf16: bool = True, device="cuda",
                    seed: int = 0, quantize: str = "") -> InferenceEngine:
    """Serve YOLOv3 detections: the three scales decoded on the device to
    (B, N, 5 + C) candidates, NMS on the host in `postprocess`. Returns a
    list (len B) of (k_i, 7) arrays [x1 y1 x2 y2 conf cls_conf cls] or
    None, the reference's NMS output (detection_utils.py:76-135).

    The checkpoint is a fine-tuned detector `.pth` in the reference
    namespace, strict-loaded (`ckpt/convert.py::load_reference_state`);
    without one the weights are a seeded random init. The BatchNorms use
    their running statistics. The served module is `engine.model`."""
    from ..ckpt import load_reference_pth, load_reference_state
    from ..nn import YOLO_ANCHORS, DetectionModel
    from ..ops.boxes import decode_yolo, nms

    _check_pth(checkpoint)
    vcfg = vit or ViTConfig(img_size=img_size)
    dtype = policy(bf16).compute_dtype
    model = DetectionModel(vcfg, num_classes=num_classes,
                           expansion=expansion, dtype=dtype,
                           generator=torch.Generator().manual_seed(seed))
    if checkpoint:
        load_reference_state(model, load_reference_pth(checkpoint))
    _maybe_quantize(model, quantize)
    model = model.to(device).eval()

    def apply_fn(x):
        outs = model(x, train=False)
        return torch.cat([decode_yolo(o, YOLO_ANCHORS[i], img_size,
                                      num_classes)
                          for i, o in enumerate(outs)], dim=1)

    def post(preds):
        return nms(preds, num_classes, conf_thres=conf_threshold,
                   nms_thres=nms_threshold)

    engine = InferenceEngine(apply_fn, buckets=buckets, postprocess=post,
                             input_dtype=dtype, device=device)
    engine.model = model
    return engine


# what `embedding_engine` computes with: every parameter of the encoder and
# of the bridge to the report decoder must come from the checkpoint
FEATURE_PATH = ("patch_embed.", "cls_token", "blocks.", "norm.", "bert_mlp.")


def embedding_engine(checkpoint: str = "", img_size: int = 224,
                     buckets=(8, 32), bf16: bool = True, device="cuda",
                     seed: int = 0, quantize: str = "",
                     vit: Optional[ViTConfig] = None,
                     decoder: Optional[MAEDecoderConfig] = None,
                     bert: Optional[BertConfig] = None) -> InferenceEngine:
    """Serve L2-normalised ECAMP image embeddings (N, D) in fp32: the mean
    over the patch tokens of `bert_mlp` of the encoder's output at mask
    ratio 0, the latent that feeds the report decoder
    (model_ecamp.py:267-273), the retrieval feature of the pretrained model.

    The model is the full-width ECAMP at `img_size` unless `vit`,
    `decoder` and `bert` say otherwise (the JAX engine fixes them; the
    tests run it narrow). The checkpoint is a pretraining `.pth`, read by
    `ckpt/convert.py::import_ecamp_pretrain`; a parameter of the feature
    path (`FEATURE_PATH`) that it lacks, or holds at another shape, raises,
    as an embedding from half-loaded weights would be silent garbage.
    Without one the weights are a seeded random init. The served module is
    `engine.model`."""
    from ..ckpt import import_ecamp_pretrain
    from ..nn.mae import ECAMP

    _check_pth(checkpoint)
    dtype = policy(bf16).compute_dtype
    model = ECAMP(vit or ViTConfig(img_size=img_size),
                  decoder or MAEDecoderConfig(), bert or BertConfig(),
                  dtype=dtype, generator=torch.Generator().manual_seed(seed))
    if checkpoint:
        _, missing = import_ecamp_pretrain(model, checkpoint)
        absent = [n for n in missing if n.startswith(FEATURE_PATH)]
        if absent:
            raise ValueError(
                f"checkpoint {checkpoint!r} lacks {len(absent)} parameters "
                f"of the embedding's path (or holds them at another shape): "
                f"{', '.join(absent)}")
    _maybe_quantize(model, quantize)
    model = model.to(device).eval()

    def apply_fn(x):
        feat = model({"image": x}, mask_ratio=0.0,
                     features_only=True)["gap_feature"].float()
        return feat / torch.linalg.vector_norm(feat, dim=-1, keepdim=True)

    engine = InferenceEngine(apply_fn, buckets=buckets, input_dtype=dtype,
                             device=device)
    engine.model = model
    return engine
