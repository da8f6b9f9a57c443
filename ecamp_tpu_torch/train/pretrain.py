"""The ECAMP pretraining step (counterpart of `ecamp_tpu/train/pretrain.py`,
`PretrainTask._step_body`, reference main_pretrain.py:116-180).

One step: u8 normalize (if the batch is u8) -> 448 -> 224 bicubic ->
MAE encoder with 75% token drop -> decoder -> SR head -> MIM and SR losses
-> bert_mlp bridge -> multimodal BERT -> 30000-way MLM head and weighted
CE (materialised logits, or the fused CE kernels with
`PretrainConfig.fused_mlm_ce`) -> loss = mim + res + mlm -> backward ->
AdamW, with the lr the step applies reported beside the losses.
Parameters and optimizer state are fp32; activations and matmuls bf16
under the default policy (`core/dtypes.py`). PyTorch runs it eagerly on
one device: the JAX package's jit, mesh, ZeRO and scan-of-steps have no
counterpart here.

Randomness comes from explicit generators on the task's device:
`masking_generator` for the MAE noise (or noise injected by the caller)
and `dropout_generator` for every dropout site. Each step reseeds both in
place from (`cfg.seed`, step) (`fold_seed`), as the JAX package folds its
key by step, so a run resumed at a step draws what the uninterrupted run
drew there. The step is a host int (`PretrainTask.step`): reading the
device step would synchronise every step.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core.config import PretrainConfig
from ..core.dtypes import policy
from ..nn.layers import set_generator, set_plain
from ..nn.mae import ECAMP
from ..ops.image_ops import device_normalize_image
from .optim import make_optimizer, make_schedule
from .state import TrainState


def device_normalize(batch: Dict, mean: float, std: float) -> Dict:
    """The device half of the u8 image pipe: a u8 `image` becomes the
    normalized fp32 3-channel image (`device_normalize_image`); other
    batches pass through."""
    img = batch.get("image")
    if img is None or img.dtype != torch.uint8:
        return batch
    return dict(batch, image=device_normalize_image(img, mean, std))


def synthetic_batch(cfg: PretrainConfig, batch_size: int,
                    generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A seeded batch shaped like the data pipeline's, on the generator's
    device: gray images at the data size (one channel repeated to three),
    captions of L/2..L tokens padded to L, about 15% of the real tokens
    masked ([MASK], id 103) with the labels the original ids everywhere
    (`ecamp_tpu/data/entity_masking.py`), entity weights 2 at the masked
    positions scaled to mean 1, and an SR window inside the patch grid."""
    b, L, s = batch_size, cfg.max_caption_length, cfg.data.img_size
    dev = generator.device
    real = (torch.arange(L, device=dev)[None, :]
            < torch.randint(L // 2, L + 1, (b, 1), device=dev,
                            generator=generator))
    # word ids above BERT's special tokens ([MASK] = 103), in a small vocab
    # the upper half
    low = min(1000, cfg.bert.vocab_size // 2)
    labels = torch.randint(low, cfg.bert.vocab_size, (b, L), device=dev,
                           generator=generator) * real
    masked = real & (torch.rand(b, L, device=dev, generator=generator) < 0.15)
    weights = torch.where(masked, 2.0, 1.0)
    last = cfg.vit.grid_size - cfg.sr_window + 1
    return {
        "image": torch.randn(b, s, s, 1, device=dev,
                             generator=generator).expand(b, s, s, 3),
        "ids": torch.where(masked, min(103, low - 1), labels),
        "labels": labels,
        "attention_mask": real.long(),
        "type_ids": torch.zeros(b, L, dtype=torch.long, device=dev),
        "weights": weights / weights.mean(),
        "column": torch.randint(0, last, (b,), device=dev,
                                generator=generator),
        "row": torch.randint(0, last, (b,), device=dev, generator=generator)}


_MASK64 = (1 << 64) - 1


def fold_seed(seed: int, step: int, stream: int) -> int:
    """A 64-bit generator seed from (seed, step, stream): splitmix64's
    finaliser over one odd-multiplier mix of the three, so nearby steps and
    the two streams (0 masking, 1 dropout) give unrelated seeds."""
    z = (seed * 0x9E3779B97F4A7C15 + (step + 1) * 0xD1B54A32D192ED03
         + (stream + 1) * 0x8CB92BA72F3D8DD7) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


class PretrainTask:
    def __init__(self, cfg: PretrainConfig, device="cuda",
                 steps_per_epoch: int = 1):
        if cfg.data.img_size != cfg.vit.img_size * cfg.sr_scale:
            # the SR branch reconstructs the data-size input from the
            # encoder-size view (reference run.sh: 448 -> 224, sr_scale 2)
            raise ValueError(
                f"PretrainConfig: data.img_size ({cfg.data.img_size}) "
                f"must equal vit.img_size * sr_scale "
                f"({cfg.vit.img_size} * {cfg.sr_scale} = "
                f"{cfg.vit.img_size * cfg.sr_scale})")
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PretrainTask on cuda needs a CUDA card")
        self.steps_per_epoch = steps_per_epoch
        # reseeded in place every step (`fold_rng`): the dropout generator
        # stays the object `set_generator` hands to the model
        self.step = 0
        self.masking_generator = torch.Generator(self.device)
        self.dropout_generator = torch.Generator(self.device)
        self.fold_rng(0)
        with torch.device(self.device):
            self.model = ECAMP(
                cfg.vit, cfg.decoder, cfg.bert, sr_window=cfg.sr_window,
                sr_scale=cfg.sr_scale, dtype=policy(cfg.bf16).compute_dtype,
                fused_mlm_ce=cfg.fused_mlm_ce,
                generator=torch.Generator(self.device).manual_seed(cfg.seed)
            ).to(self.device)  # the sin-cos buffers are made on the host
        set_generator(self.model, self.dropout_generator)
        self.schedule = make_schedule(cfg.optimizer, steps_per_epoch,
                                      max_epoch=cfg.max_epoch)
        self.tx = make_optimizer(cfg.optimizer, steps_per_epoch,
                                 max_epoch=cfg.max_epoch)

    def fold_rng(self, step: int) -> None:
        """Reseed the masking and dropout generators from (seed, step)."""
        seed = self.cfg.seed
        self.masking_generator.manual_seed(fold_seed(seed, step, 0))
        self.dropout_generator.manual_seed(fold_seed(seed, step, 1))

    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> TrainState:
        """A fresh train state at step 0; with `generator`, the parameters
        are drawn anew from it first."""
        if generator is not None:
            self.model.reset_parameters(generator)
        self.step = 0
        return TrainState.create(self.model, self.tx)

    def set_plain(self, plain: bool = True) -> None:
        """Route every kernel of the step (LayerNorm, attention, SR, the
        fused CE, AdamW) to its plain version (the on-card reference), or
        back."""
        set_plain(self.model, plain)
        if hasattr(self.tx, "plain"):
            self.tx.plain = plain

    def fake_batch(self, batch_size: int) -> Dict[str, torch.Tensor]:
        c = self.cfg
        L, s, dev = c.max_caption_length, c.data.img_size, self.device

        def z(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return {"image": z(batch_size, s, s, 3, dtype=torch.float32),
                "ids": z(batch_size, L), "labels": z(batch_size, L),
                "attention_mask": z(batch_size, L) + 1,
                "type_ids": z(batch_size, L),
                "weights": z(batch_size, L, dtype=torch.float32) + 1,
                "column": z(batch_size) + 1, "row": z(batch_size) + 1}

    def put_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """numpy arrays or tensors -> tensors on the task's device."""
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   noise: Optional[torch.Tensor] = None,
                   deterministic: bool = False
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step on a batch on the task's device. `noise`
        (B, grid**2) injects the masking noise; `deterministic` turns
        dropout off. Returns the new state and device-scalar metrics
        (loss, mim_loss, res_loss, mlm_loss, lr)."""
        self.fold_rng(self.step)
        batch = device_normalize(batch, self.cfg.data.mean, self.cfg.data.std)
        self.model.train(not deterministic)
        # zero the grads in place: their addresses stay fixed, so the AdamW
        # kernel's leaf table is built once
        self.model.zero_grad(set_to_none=False)
        out = self.model(batch, mask_ratio=self.cfg.mask_ratio, noise=noise,
                         generator=self.masking_generator)
        loss = out["mim_loss"] + out["res_loss"] + out["mlm_loss"]
        loss.backward()
        # the lr this update applies: the schedule at the cycle-start step
        # (the step itself while the CLI refuses --accum_iter > 1)
        accum = max(1, self.cfg.optimizer.accum_steps)
        lr = self.schedule((state.step // accum) * accum)
        new_state = state.apply_gradients(self.tx)
        self.step += 1
        metrics = {"loss": loss.detach(), "lr": lr}
        for k in ("mim_loss", "res_loss", "mlm_loss"):
            metrics[k] = out[k].detach()
        return new_state, metrics
