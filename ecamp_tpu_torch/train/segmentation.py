"""The segmentation fine-tune: SIIM / RSNA on one decoder, RIGA on two
(counterpart of `ecamp_tpu/train/segmentation.py`; reference
Segmentation/train.py and train_RIGA.py).

AdamW with a step warmup-cosine schedule, MixedLoss = 10 * focal -
log(dice), the encoder frozen except `seg_head` (train.py:128-133), the
dice with the empty-mask convention (train.py:191-213), and for RIGA the
mean of the disc and cup losses (train_RIGA.py:243-276). The frozen trunk
runs under `torch.no_grad()`, so its backward never runs; `FusedAdamW`
sees the trainable leaves only (`Masked`).

`backbone="resnet50"` is the smp.Unet baseline (train.py:139-180):
`nn/unet.py::ResNetUNet`, trained end to end (no freeze mask: `FusedAdamW`
updates every leaf), from a torchvision-layout `.pth`
(`import_resnet_unet`) or from its init; RIGA's two decoders have no such
baseline and raise, as in JAX.

The step draws no random numbers: the JAX step passes `train=True` but
not `deterministic`, so the trunk's dropout and drop-path stay off. The
model is kept in eval mode and only the BatchNorms take the batch
statistics (`train=True`), updating their running statistics every
micro-step, as `apply_gradients(batch_stats=...)` does.

Data parallelism (a process group from `core/distributed.py`, one rank a
card; the batch is per rank) computes what one process computes at the
global batch, as JAX does under GSPMD: the BatchNorms' statistics and the
soft dice's sums are the global batch's (`nn/layers.py::BatchNorm`,
`ops/losses.py::dice_coefficient`; RIGA takes two such dice terms), the
trained leaves' gradients live in `DataParallel`'s flat buffers (the
frozen trunk stays out) and are averaged after the backward pass, and the
logged loss is the ranks' mean.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core import distributed
from ..core.config import SegmentationConfig
from ..core.dtypes import policy
from ..nn.layers import set_plain
from ..nn.seg import SegViT, SegViTDual
from ..nn.unet import ResNetUNet
from ..ops.image_ops import device_normalize_image
from ..ops.losses import mixed_loss
from .eval_metrics import dice_scores
from .optim import make_optimizer, make_schedule
from .state import TrainState


def seg_freeze_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """True = trainable: everything but the trunk (`encoder.*` other than
    `encoder.seg_head.*`)."""
    return {k: not k.startswith("encoder.") or k.startswith("encoder.seg_head.")
            for k, _ in model.named_parameters()}


class SegmentationTask:
    def __init__(self, cfg: SegmentationConfig, device="cuda"):
        if cfg.backbone not in ("vit", "resnet50"):
            raise ValueError(f"unknown segmentation backbone "
                             f"{cfg.backbone!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SegmentationTask on cuda needs a CUDA card")
        self.dual = cfg.task.upper() == "RIGA"
        self.resnet = cfg.backbone == "resnet50"
        dtype = policy(cfg.bf16).compute_dtype
        generator = torch.Generator().manual_seed(cfg.seed)
        if self.resnet:
            if self.dual:
                raise ValueError("resnet50 baseline supports single-decoder "
                                 "tasks only (SIIM/RSNA)")
            self.model = ResNetUNet(out_channels=cfg.out_channels,
                                    dtype=dtype, generator=generator)
        else:
            cls = SegViTDual if self.dual else SegViT
            self.model = cls(cfg.vit, out_channels=cfg.out_channels,
                             sample_rate=cfg.sample_rate,
                             features=tuple(cfg.decode_features),
                             dtype=dtype, generator=generator)
        self.model.to(self.device)
        self.schedule = make_schedule(cfg.optimizer)
        self.tx = None
        self.plain = False  # see set_plain
        self.dp = None  # the ranks' DataParallel, made by init_state

    def freeze_mask(self) -> Optional[Dict[str, bool]]:
        """The ViT's frozen trunk; the ResNet-50 UNet trains every leaf."""
        if self.resnet or not self.cfg.freeze_encoder:
            return None
        return seg_freeze_mask(self.model)

    def init_state(self, generator: Optional[torch.Generator] = None,
                   pretrained: str = "", from_pretrain: bool = True,
                   flavor: str = "ecamp") -> TrainState:
        """A fresh train state at step 0: with `generator` the parameters
        are drawn anew from it, then `pretrained` (a reference `.pth`) is
        loaded over them (`ckpt/convert.py::import_seg_vit`, or
        `import_resnet_unet` for the ResNet-50 UNet, which reads neither
        `from_pretrain` nor the flavor; flavor 'random' loads nothing)."""
        if generator is not None:
            self.model.reset_parameters(generator)
        if pretrained and flavor != "random":
            from ..ckpt import import_resnet_unet, import_seg_vit

            if self.resnet:
                loaded, missing = import_resnet_unet(self.model, pretrained)
            else:
                loaded, missing = import_seg_vit(self.model, pretrained,
                                                 from_pretrain, flavor)
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

    def loss(self, images: torch.Tensor, masks: torch.Tensor,
             train: bool = True) -> torch.Tensor:
        """The mixed loss of a batch: u8 or fp32 NHWC images normalized on
        the device, masks (B, H, W, 1), or (B, H, W, 2) disc/cup for RIGA.
        `train` takes the BatchNorm batch statistics (and updates the
        running ones)."""
        c = self.cfg
        images = device_normalize_image(images, c.data.mean, c.data.std)
        kwargs = {} if self.resnet else {"stop_trunk_grad": c.freeze_encoder}
        out = self.model(images, train=train, **kwargs)
        a, g = c.mixed_loss_alpha, c.focal_gamma
        if self.dual:
            disc, cup = out
            return 0.5 * (mixed_loss(disc[..., 0], masks[..., 0], a, g)
                          + mixed_loss(cup[..., 0], masks[..., 1], a, g))
        return mixed_loss(out[..., 0], masks[..., 0], a, g)

    def train_step(self, state: TrainState, images: torch.Tensor,
                   masks: torch.Tensor
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One micro-step (one update without accumulation) on a batch on
        the task's device; returns the new state and device-scalar metrics
        (loss, and the lr of the current update); under data parallelism
        the loss is the ranks' mean."""
        self.model.eval()  # the trunk deterministic; BatchNorm in train
        self.model.zero_grad(set_to_none=False)
        loss = self.loss(images, masks, train=True)
        loss.backward()
        loss = distributed.reduce_step(self.dp, loss.detach())
        accum = max(1, self.cfg.optimizer.accum_steps)
        lr = self.schedule(state.step // accum)
        return state.apply_gradients(self.tx), {"loss": loss, "lr": lr}

    def eval_step(self, state: TrainState, images: torch.Tensor):
        """fp32 sigmoid masks (B, H, W, 1), or the (disc, cup) pair, from
        the running statistics, with no autograd graph."""
        self.model.eval()
        with torch.no_grad():
            images = device_normalize_image(images, self.cfg.data.mean,
                                            self.cfg.data.std)
            out = self.model(images, train=False)
            if self.dual:
                return torch.sigmoid(out[0]), torch.sigmoid(out[1])
            return torch.sigmoid(out)

    def compute_dice(self, probs: np.ndarray, truth: np.ndarray) -> np.ndarray:
        return dice_scores(np.asarray(probs), np.asarray(truth))
