"""The ECAMP pretraining step (counterpart of `ecamp_tpu/train/pretrain.py`,
`PretrainTask._step_body`, reference main_pretrain.py:116-180).

One step: u8 normalize (if the batch is u8) -> 448 -> 224 bicubic ->
MAE encoder with 75% token drop -> decoder -> SR head -> MIM and SR losses
-> bert_mlp bridge -> multimodal BERT -> 30000-way MLM head and weighted
CE (materialised logits, or the fused CE kernels with
`PretrainConfig.fused_mlm_ce`) -> loss = mim + res + mlm -> backward ->
AdamW, with the lr the step applies reported beside the losses.
Parameters and optimizer state are fp32; activations and matmuls bf16
under the default policy (`core/dtypes.py`). PyTorch runs it eagerly;
the JAX package's jit and tensor-parallel mesh axis have no counterpart
here. Its scan of K steps a dispatch (`make_train_step_scan`) is, on a
CUDA card, a CUDA graph of the step replayed K times a call
(`train/graphed.py`); on the CPU the K steps run in order.

Data parallelism (a process group from `core/distributed.py`, one rank a
card): each rank steps on its own rows of the global batch, the batch
size B is per rank, and N ranks x B compute the function that 1 process
at N * B does. The masking noise is drawn for the global batch from the
shared fold and each rank takes its rows; after the backward pass the
gradients are averaged over the ranks (`DataParallel.all_reduce_grads_`,
in place, so the AdamW kernel's pointer table holds), and so are the
metrics. `cfg.mesh.shard_optimizer` shards AdamW's moments (ZeRO-1,
`kernels/fused_adamw.py`). `make_train_step_scan` runs under a group too:
on NCCL ranks its CUDA graphs hold those collectives (`train/graphed.py`),
on gloo ranks on the CPU the K steps run in order, and gloo ranks on
cards (sharing them) are refused.

`cfg.mesh.shard_params` is FSDP (ZeRO-3, `core/distributed.py::Fsdp`),
in one process (one span) or under a group: each rank keeps its span of
every unit's parameters, gradients and AdamW moments (and `MultiSteps`'
running mean); a unit's call gathers its parameters and its backward
reduce-scatters its gradient, so there is no all-reduce after the
backward and no exchange after the update. The step is data parallelism's
bit for bit. AdamW stays the kernel, on the shards (JAX's FSDP falls back
to optax). `make_train_step_scan` graphs the FSDP step on a card as it
graphs the others: the unit gathers and reduce-scatters (the remat
recompute's gathers too), the clip's norm and the metrics' all-reduce are
captured on the graphs' communicator (`train/graphed.py`).

Randomness comes from explicit generators on the task's device:
`masking_generator` for the MAE noise (or noise injected by the caller)
and `dropout_generator` for every dropout site. Each step reseeds both in
place from (`cfg.seed`, step) (`fold_seed`), as the JAX package folds its
key by step, so a run resumed at a step draws what the uninterrupted run
drew there. The step is a host int (`PretrainTask.step`): reading the
device step would synchronise every step. Rank r > 0 of a data-parallel
run folds its dropout stream with r, so ranks draw different masks; rank
0's is the single process's.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..core import distributed
from ..core.config import PretrainConfig
from ..core.dtypes import policy
from ..nn.layers import call, set_generator, set_plain
from ..nn.mae import ECAMP
from ..ops.image_ops import device_normalize_image
from .graphed import GraphedSteps, PinnedStager
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
        self.plain = False  # see set_plain
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
        if cfg.mesh.shard_params and cfg.mesh.model > 1:
            raise ValueError("shard_params (FSDP) and a model axis > 1 (TP) "
                             "cannot be combined")
        if cfg.mesh.model != 1:
            raise NotImplementedError("tensor parallelism (MeshConfig.model "
                                      "> 1) is not ported to ecamp_tpu_torch")
        self.rank, self.world = distributed.rank(), distributed.world_size()
        if cfg.mesh.data not in (-1, self.world):
            raise ValueError(f"MeshConfig.data = {cfg.mesh.data}, but "
                             f"{self.world} ranks train")
        # the data axis: every rank of the process group, if there is one;
        # FSDP also in one process (one span)
        zero1 = None
        if cfg.mesh.shard_params:
            self.dp = distributed.Fsdp(self.model, self.model.fsdp_units())
            zero1 = distributed.Zero1(self.dp.layouts(), self.rank, self.dp)
        elif distributed.is_distributed():
            self.dp = distributed.DataParallel(self.model)
            if cfg.mesh.shard_optimizer:
                zero1 = distributed.Zero1(self.dp.layout, self.rank, self.dp)
        else:
            self.dp = None
        self.schedule = make_schedule(cfg.optimizer, steps_per_epoch,
                                      max_epoch=cfg.max_epoch)
        self.tx = make_optimizer(cfg.optimizer, steps_per_epoch,
                                 max_epoch=cfg.max_epoch, zero1=zero1)
        self._stager: Optional[PinnedStager] = None

    def fold_rng(self, step: int) -> None:
        """Reseed the masking and dropout generators from (seed, step), the
        dropout one also from the rank (stream 1 + rank)."""
        seed = self.cfg.seed
        self.masking_generator.manual_seed(fold_seed(seed, step, 0))
        self.dropout_generator.manual_seed(
            fold_seed(seed, step, 1 + distributed.rank()))

    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> TrainState:
        """A fresh train state at step 0; with `generator`, the parameters
        are drawn anew from it first."""
        if generator is not None:
            with distributed.whole_params(self.model):
                self.model.reset_parameters(generator)
        self.step = 0
        return TrainState.create(self.model, self.tx)

    def set_plain(self, plain: bool = True) -> None:
        """Route every kernel of the step (LayerNorm, attention, SR, the
        fused CE, AdamW) to its plain version (the on-card reference), or
        back."""
        self.plain = plain
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

    def put_superbatch(self, batches: Sequence[Dict]
                       ) -> Dict[str, torch.Tensor]:
        """K host batches -> one (K, B, ...) superbatch on the task's
        device, for `make_train_step_scan` (JAX `shard_superbatch`). On a
        card the batches are stacked into pinned host memory and copied
        without blocking on the current stream (`graphed.PinnedStager`)."""
        if self.device.type != "cuda":
            return {k: torch.stack([torch.as_tensor(b[k]) for b in batches])
                    for k in batches[0]}
        if self._stager is None:
            self._stager = PinnedStager(self.device)
        return self._stager.put(batches)

    def make_train_step_scan(self, state: TrainState, k: int):
        """K optimizer steps a call (JAX `make_train_step_scan`): returns
        `scan(state, superbatch, noise=None, deterministic=False) ->
        (state, metrics)`, the superbatch (K, B, ...) (`put_superbatch`),
        `noise` (K, B, grid**2) or None, the metrics stacked (K,) a key.
        The K steps equal K `train_step` calls. On a card they are CUDA
        graphs of the step (`graphed.GraphedSteps`), under a process group
        the data-parallel step with its NCCL collectives captured (the
        gradient all-reduce and ZeRO-1's exchange, or FSDP's unit gathers
        and reduce-scatters; a gloo group on cards raises: its collectives
        run on the host); a failed capture or replay raises; nothing falls
        back to eager steps. On the CPU, in one process or on gloo ranks,
        the K steps run in order. Under a group every rank makes the scan
        and calls it with the same K (a collective)."""
        if k < 1:
            raise ValueError(f"steps per call must be >= 1, not {k}")
        if self.device.type == "cuda":
            return GraphedSteps(self, state, k)

        def scan(state, superbatch, noise=None, deterministic=False):
            rows = []
            for i in range(k):
                state, m = self.train_step(
                    state, {key: v[i] for key, v in superbatch.items()},
                    None if noise is None else noise[i], deterministic)
                rows.append(m)
            return state, {key: torch.stack([m[key] for m in rows])
                           for key in rows[0]}

        return scan

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor],
                   noise: Optional[torch.Tensor] = None,
                   deterministic: bool = False
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step on a batch on the task's device. `noise`
        (B, grid**2) injects the masking noise (under data parallelism it
        may be the global batch's, world * B rows, of which the rank takes
        its own); `deterministic` turns dropout off. Returns the new state
        and device-scalar metrics (loss, mim_loss, res_loss, mlm_loss, lr),
        under data parallelism their means over the ranks."""
        self.fold_rng(self.step)
        state, metrics = self.step_body(state, batch, noise, deterministic)
        self.step += 1
        return state, metrics

    def step_body(self, state: TrainState, batch: Dict[str, torch.Tensor],
                  noise: Optional[torch.Tensor], deterministic: bool
                  ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """`train_step` without the host's part: no reseed of the
        generators and no count of `self.step`, so that a CUDA graph can
        capture it."""
        if self.dp is not None:
            noise = self._rank_noise(batch["ids"].shape[0], noise)
        batch = device_normalize(batch, self.cfg.data.mean, self.cfg.data.std)
        self.model.train(not deterministic)
        # zero the grads in place: their addresses stay fixed, so the AdamW
        # kernel's leaf table is built once
        self.model.zero_grad(set_to_none=False)
        if self.cfg.mesh.shard_params:
            self.dp.zero_grad_()
        out = call(self.model, batch, mask_ratio=self.cfg.mask_ratio,
                   noise=noise, generator=self.masking_generator)
        loss = out["mim_loss"] + out["res_loss"] + out["mlm_loss"]
        loss.backward()
        if self.dp is not None:
            self.dp.all_reduce_grads_()
        # the lr this update applies: the schedule at the cycle-start step
        # (the step itself while the CLI refuses --accum_iter > 1)
        accum = max(1, self.cfg.optimizer.accum_steps)
        lr = self.schedule((state.step // accum) * accum)
        new_state = state.apply_gradients(self.tx)
        names = ("loss", "mim_loss", "res_loss", "mlm_loss")
        values = [loss.detach()] + [out[k].detach() for k in names[1:]]
        if self.dp is not None:
            values = distributed.all_reduce_mean_(
                torch.stack(values), group=self.dp.group).unbind()
        metrics = {"loss": values[0], "lr": lr}
        metrics.update(zip(names[1:], values[1:]))
        return new_state, metrics

    def _rank_noise(self, b: int, noise: Optional[torch.Tensor]
                    ) -> Optional[torch.Tensor]:
        """This rank's rows of the global batch's masking noise: `noise`
        when it has B rows, its rows of world * B, or the global draw from
        the masking generator (the draw one process makes at world * B)."""
        if self.cfg.mask_ratio <= 0:
            return noise
        if noise is None:
            noise = torch.rand((b * self.world, self.cfg.vit.num_patches),
                               generator=self.masking_generator,
                               device=self.device)
        if noise.shape[0] == b:
            return noise
        if noise.shape[0] != b * self.world:
            raise ValueError(f"noise of {noise.shape[0]} rows for a batch of "
                             f"{b} a rank on {self.world} ranks")
        return noise[self.rank * b:(self.rank + 1) * b]
