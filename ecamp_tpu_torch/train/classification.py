"""The classification fine-tune and linear probe (counterpart of
`ecamp_tpu/train/classification.py`; reference Classification/train.py).

SGD with momentum 0.9 and a step warmup-cosine or warmup-linear schedule
(train.py:377-384), BCE-with-logits for multilabel tasks and CE for
single-label ones (train.py:118-121, 442-447); the linear probe freezes
all but `head` (train.py:156-159) and stops the trunk's gradient. apex O2
fp16 becomes the bf16 policy: fp32 parameters, bf16 activations, an fp32
head.

PyTorch runs the step eagerly on one device. Dropout and drop-path draw
from `dropout_generator`, reseeded in place every micro-step from
(`cfg.seed`, step) (`train/pretrain.py::fold_seed`), as the JAX package
folds its key by `state.step`; the step is a host int
(`ClassificationTask.step`), so reading it never synchronises.

Data parallelism (a process group from `core/distributed.py`, one rank a
card; the batch is per rank): the trained leaves and their gradients live
in `DataParallel`'s flat buffers (the linear probe's frozen trunk stays
out), the gradients are averaged over the ranks after the backward pass,
so the clip and SGD read the global batch's, the logged loss is the
ranks' mean, and rank r > 0 folds its dropout and drop-path stream with
r (rank 0 draws what one process draws).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core import distributed
from ..core.config import ClassificationConfig
from ..core.dtypes import policy
from ..nn.layers import set_generator, set_plain
from ..nn.vit import ViTClassifier
from ..ops.image_ops import device_normalize_image
from ..ops.losses import sigmoid_bce, softmax_cross_entropy
from .eval_metrics import accuracy, multilabel_auc
from .optim import make_optimizer, make_schedule
from .pretrain import fold_seed
from .state import TrainState


class ClassificationTask:
    def __init__(self, cfg: ClassificationConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ClassificationTask on cuda needs a CUDA card")
        self.step = 0
        self.dropout_generator = torch.Generator(self.device)
        self.fold_rng(0)
        self.model = ViTClassifier(
            cfg.vit, cfg.num_classes, global_pool=cfg.global_pool,
            head_init_std=cfg.head_init_std,
            dtype=policy(cfg.bf16).compute_dtype,
            generator=torch.Generator().manual_seed(cfg.seed)
        ).to(self.device)
        set_generator(self.model, self.dropout_generator)
        self.schedule = make_schedule(cfg.optimizer)
        self.tx = None
        self.dp = None  # the ranks' DataParallel, made by init_state

    def fold_rng(self, step: int) -> None:
        """Reseed the dropout and drop-path generator from (seed, step) and
        the rank (stream 1 + rank)."""
        self.dropout_generator.manual_seed(
            fold_seed(self.cfg.seed, step, 1 + distributed.rank()))

    def freeze_mask(self) -> Optional[Dict[str, bool]]:
        """The linear probe's mask (True = trainable: `head.*` only), or
        None for the full fine-tune."""
        if not self.cfg.linear_probe:
            return None
        return {k: k.startswith("head.")
                for k, _ in self.model.named_parameters()}

    def init_state(self, generator: Optional[torch.Generator] = None,
                   pretrained: str = "") -> TrainState:
        """A fresh train state at step 0: with `generator` the parameters
        are drawn anew from it, then `pretrained` (a reference `.pth`) is
        loaded over them (`ckpt/convert.py::import_vit_classifier`)."""
        if generator is not None:
            self.model.reset_parameters(generator)
        if pretrained:
            from ..ckpt import import_vit_classifier

            loaded, missing = import_vit_classifier(self.model, pretrained)
            print(f"{pretrained}: loaded {len(loaded)} tensors, "
                  f"{len(missing)} left at init")
        if self.dp is None and distributed.is_distributed():
            self.dp = distributed.DataParallel(self.model, self.freeze_mask())
        self.tx = make_optimizer(self.cfg.optimizer,
                                 freeze_mask=self.freeze_mask())
        self.step = 0
        return TrainState.create(self.model, self.tx)

    def set_plain(self, plain: bool = True) -> None:
        """Route LayerNorm and attention to their plain versions (the
        on-card reference), or back."""
        set_plain(self.model, plain)

    def put(self, x) -> torch.Tensor:
        """A numpy array or tensor on the task's device."""
        return torch.as_tensor(x).to(self.device)

    def loss(self, images: torch.Tensor, labels: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss, logits) of a batch in the model's current mode: u8 or fp32
        images normalized on the device, BCE for a multilabel task, else
        the mean CE of integer labels."""
        c = self.cfg
        images = device_normalize_image(images, c.data.mean, c.data.std)
        logits = self.model(images, stop_trunk_grad=c.linear_probe)
        if c.is_multilabel:
            return sigmoid_bce(logits, labels), logits
        return softmax_cross_entropy(logits, labels).mean(), logits

    def train_step(self, state: TrainState, images: torch.Tensor,
                   labels: torch.Tensor
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One micro-step (one update without accumulation) on a batch on
        the task's device; returns the new state and device-scalar metrics
        (loss, and the lr of the current update); under data parallelism
        the loss is the ranks' mean."""
        self.fold_rng(self.step)
        self.model.train()
        self.model.zero_grad(set_to_none=False)
        loss, _ = self.loss(images, labels)
        loss.backward()
        loss = distributed.reduce_step(self.dp, loss.detach())
        # step schedules count optimizer updates; state.step counts
        # micro-steps under accumulation
        accum = max(1, self.cfg.optimizer.accum_steps)
        lr = self.schedule(state.step // accum)
        new_state = state.apply_gradients(self.tx)
        self.step += 1
        return new_state, {"loss": loss, "lr": lr}

    def eval_step(self, state: TrainState, images: torch.Tensor
                  ) -> torch.Tensor:
        """fp32 logits of a batch, dropout off, no autograd graph."""
        self.model.eval()
        with torch.no_grad():
            images = device_normalize_image(images, self.cfg.data.mean,
                                            self.cfg.data.std)
            return self.model(images)

    def compute_metrics(self, logits: np.ndarray, labels: np.ndarray) -> Dict:
        """Host-side metrics (train.py valid()/test()): per-class AUROC of
        the sigmoid and their nan-mean for a multilabel task, else the
        accuracy of the argmax."""
        if self.cfg.is_multilabel:
            probs = 1.0 / (1.0 + np.exp(-np.asarray(logits, np.float64)))
            aucs = multilabel_auc(probs, labels)
            return {"auc": float(np.nanmean(aucs)), "per_class_auc": aucs}
        preds = np.argmax(logits, axis=-1)
        return {"acc": accuracy(preds, labels)}
