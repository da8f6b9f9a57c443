"""The detection fine-tune: RSNA pneumonia / ObjectCXR, YOLOv3 on the ViT
(counterpart of `ecamp_tpu/train/detection.py`; reference
Detection/train.py).

The loss is the sum of the three scales' YOLO losses (:445-471) in fp32;
the encoder is frozen except `det_head` (:169-174); evaluation decodes
all three scales on the device, then runs NMS (conf / nms 0.5) and the
mAP over IoU .40:.05:.75 on the host (:214-250). The frozen trunk runs
under `torch.no_grad()`, so its backward never runs; `FusedAdamW` sees the
trainable leaves only (`Masked`). With `backbone="resnet50"` (the
ResNetDetector baseline, train.py:99-131) the whole ResNet-50 is frozen
(train.py:126-127) and runs under `torch.no_grad()`; its BatchNorm
statistics still update in train mode, as JAX's do under
`stop_gradient`.

The step draws no random numbers: the JAX step passes `train=True` but
not `deterministic`, so the trunk's dropout and drop-path stay off. The
model is kept in eval mode and only the BatchNorms take the batch
statistics (`train=True`), updating their running statistics every
micro-step, as `apply_gradients(batch_stats=...)` does.

Data parallelism (a process group from `core/distributed.py`, one rank a
card; the batch is per rank): the BatchNorms take the global batch's
statistics (`nn/layers.py::BatchNorm`, the frozen ResNet-50's too), the
trained leaves' gradients live in `DataParallel`'s flat buffers and are
averaged after the backward pass, and the logged losses are the ranks'
means. The YOLO targets are built per image, as in one process.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import distributed
from ..core.config import DetectionConfig
from ..core.dtypes import policy
from ..nn.det import YOLO_ANCHORS, DetectionModel
from ..nn.layers import set_plain
from ..ops.boxes import average_precision, decode_yolo, nms
from ..ops.image_ops import device_normalize_image
from ..ops.yolo import yolo_loss
from .optim import make_optimizer, make_schedule
from .state import TrainState


def det_freeze_mask(model: torch.nn.Module,
                    backbone: str = "vit") -> Dict[str, bool]:
    """True = trainable: everything but the trunk (`backbone.encoder.*`
    other than `backbone.encoder.det_head.*`); with the ResNet-50,
    everything but the whole `backbone.*`."""
    if backbone == "resnet50":
        return {k: not k.startswith("backbone.")
                for k, _ in model.named_parameters()}
    pre = "backbone.encoder."
    return {k: not k.startswith(pre) or k.startswith(pre + "det_head.")
            for k, _ in model.named_parameters()}


class DetectionTask:
    def __init__(self, cfg: DetectionConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DetectionTask on cuda needs a CUDA card")
        self.model = DetectionModel(
            cfg.vit, num_classes=cfg.num_classes, expansion=cfg.expansion,
            backbone=cfg.backbone, dtype=policy(cfg.bf16).compute_dtype,
            generator=torch.Generator().manual_seed(cfg.seed)).to(self.device)
        self.schedule = make_schedule(cfg.optimizer)
        self.tx = None
        self.plain = False  # see set_plain
        self.dp = None  # the ranks' DataParallel, made by init_state

    def freeze_mask(self) -> Optional[Dict[str, bool]]:
        c = self.cfg
        return det_freeze_mask(self.model, c.backbone) if c.freeze_encoder \
            else None

    def init_state(self, generator: Optional[torch.Generator] = None,
                   pretrained: str = "", from_pretrain: bool = True
                   ) -> TrainState:
        """A fresh train state at step 0: with `generator` the parameters
        are drawn anew from it, then `pretrained` (a reference `.pth`) is
        loaded over them (`ckpt/convert.py::import_detector`)."""
        if generator is not None:
            self.model.reset_parameters(generator)
        if pretrained:
            from ..ckpt import import_detector

            loaded, missing = import_detector(self.model, pretrained,
                                              from_pretrain,
                                              self.cfg.backbone)
            print(f"{pretrained}: loaded {len(loaded)} tensors, "
                  f"{len(missing)} left at init")
        if self.dp is None and distributed.is_distributed():
            self.dp = distributed.DataParallel(self.model, self.freeze_mask())
        self.tx = make_optimizer(self.cfg.optimizer,
                                 freeze_mask=self.freeze_mask())
        self.set_plain(self.plain)
        return TrainState.create(self.model, self.tx)

    def set_plain(self, plain: bool = True) -> None:
        """Route LayerNorm, attention and AdamW (inside its `Masked` and
        `MultiSteps` wrappers) to their plain versions, the on-card
        reference, or back; a later `init_state` keeps the route."""
        self.plain = plain
        set_plain(self.model, plain)
        tx = self.tx
        while tx is not None and not hasattr(tx, "plain"):
            tx = getattr(tx, "inner", None)
        if tx is not None:
            tx.plain = plain

    def put(self, x) -> torch.Tensor:
        """A numpy array or tensor on the task's device."""
        return torch.as_tensor(x).to(self.device)

    def loss(self, images: torch.Tensor, targets: torch.Tensor,
             train: bool = True
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The summed three-scale YOLO loss of a batch and each scale's
        (`scale0` coarse .. `scale2` fine): u8 or fp32 NHWC images
        normalised on the device, targets (B, T, 5) rows [cls, cx, cy, w,
        h] normalised, all-zero rows padding. `train` takes the BatchNorm
        batch statistics (and updates the running ones)."""
        c = self.cfg
        images = device_normalize_image(images, c.data.mean, c.data.std)
        outs = self.model(images, train=train,
                          stop_trunk_grad=c.freeze_encoder)
        total, parts = 0.0, {}
        for i, logits in enumerate(outs):
            li, _ = yolo_loss(logits, targets, YOLO_ANCHORS[i], c.img_size,
                              c.num_classes)
            total = total + li
            parts[f"scale{i}"] = li.detach()
        return total, parts

    def train_step(self, state: TrainState, images: torch.Tensor,
                   targets: torch.Tensor
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One micro-step (one update without accumulation) on a batch on
        the task's device; returns the new state and device-scalar metrics
        (loss, each scale's loss, and the lr of the current update); under
        data parallelism the losses are the ranks' means."""
        self.model.eval()  # the trunk deterministic; BatchNorm in train
        self.model.zero_grad(set_to_none=False)
        loss, parts = self.loss(images, targets, train=True)
        loss.backward()
        values = distributed.reduce_step(
            self.dp, torch.stack([loss.detach(), *parts.values()]))
        metrics = dict(zip(["loss", *parts], values.unbind()))
        accum = max(1, self.cfg.optimizer.accum_steps)
        lr = self.schedule(state.step // accum)
        return state.apply_gradients(self.tx), dict(metrics, lr=lr)

    def eval_step(self, state: TrainState, images: torch.Tensor
                  ) -> torch.Tensor:
        """The decoded candidates of all three scales, (B, N, 5 + C) fp32
        on the device (cxcywh in pixels, objectness, class scores), from
        the running statistics, with no autograd graph."""
        c = self.cfg
        self.model.eval()
        with torch.no_grad():
            images = device_normalize_image(images, c.data.mean, c.data.std)
            outs = self.model(images, train=False)
            return torch.cat([decode_yolo(o, YOLO_ANCHORS[i], c.img_size,
                                          c.num_classes)
                              for i, o in enumerate(outs)], dim=1)

    # -- host-side eval ---------------------------------------------------

    def detections(self, predictions) -> List[Optional[np.ndarray]]:
        """Per-image NMS of `eval_step`'s candidates (a tensor or an
        array): (k, 7) arrays [x1 y1 x2 y2 conf cls_conf cls] or None."""
        if isinstance(predictions, torch.Tensor):
            predictions = predictions.cpu().numpy()
        return nms(predictions, self.cfg.num_classes,
                   conf_thres=self.cfg.conf_threshold,
                   nms_thres=self.cfg.nms_threshold)

    def compute_map(self, all_dets: List[Optional[np.ndarray]],
                    all_gt_xyxy: List[np.ndarray]) -> float:
        pred_boxes, pred_scores = [], []
        for d in all_dets:
            if d is None or len(d) == 0:
                pred_boxes.append(np.zeros((0, 4)))
                pred_scores.append(np.zeros((0,)))
            else:
                pred_boxes.append(d[:, :4])
                pred_scores.append(d[:, 4])
        return average_precision(pred_boxes, pred_scores, all_gt_xyxy,
                                 self.cfg.map_iou_thresholds)
