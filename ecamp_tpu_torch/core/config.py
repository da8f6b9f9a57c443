"""Configuration tree, field for field the same as `ecamp_tpu.core.config`.

Ported: `ViTConfig` and its factories, `BertConfig`, `MAEDecoderConfig`,
`OptimizerConfig`, `DataConfig`, `MeshConfig` (the data axis over
torchrun's ranks, `core/distributed.py`, ZeRO-1's `shard_optimizer` and
FSDP's `shard_params`; the model axis must stay 1), `PretrainConfig`,
`ClassificationConfig`, `SegmentationConfig` and `DetectionConfig`. Left
out: the fine-tune configs' `mesh` fields. The fine-tunes train data
parallel under torchrun all the same (`DataParallel` over the ranks of the
launch); they take no ZeRO-1 and no FSDP, as JAX's place them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ViTConfig:
    """ViT trunk hyperparameters (ViT-B/16 default).

    Mirrors the shared encoder of the reference (model_ecamp.py:328-333,
    Classification/models_vit.py:124-128).
    """

    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    norm_eps: float = 1e-6
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    # stochastic depth, linspace-ramped 0 -> rate across blocks (timm)
    drop_path_rate: float = 0.0
    # activation checkpointing: each block runs under a recompute
    # (`nn/layers.py::remat`), as JAX wraps it in nn.remat
    remat: bool = False

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size


def vit_tiny(**kw) -> ViTConfig:
    return ViTConfig(embed_dim=192, depth=12, num_heads=12, **kw)


def vit_base(**kw) -> ViTConfig:
    return ViTConfig(embed_dim=768, depth=12, num_heads=12, **kw)


def vit_base_singlechannel(**kw) -> ViTConfig:
    """vit_base_patch16_singlechannel (models_vit.py:131-136): ViT-B with
    in_chans=1."""
    return ViTConfig(embed_dim=768, depth=12, num_heads=12, in_chans=1, **kw)


def vit_large(**kw) -> ViTConfig:
    return ViTConfig(embed_dim=1024, depth=24, num_heads=16, **kw)


def vit_huge(**kw) -> ViTConfig:
    return ViTConfig(patch_size=14, embed_dim=1280, depth=32, num_heads=16,
                     **kw)


@dataclass(frozen=True)
class BertConfig:
    """Multimodal BERT config (reference: module/bert_config.py:63-99)."""

    vocab_size: int = 30000
    hidden_size: int = 768
    num_hidden_layers: int = 6
    num_attention_heads: int = 6
    intermediate_size: int = 1536
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    # HF-exact attention dropout: drop the (B,H,Nq,Nk) probabilities, on
    # the plain attention. Default False drops the attention output at the
    # same rate, so the attention kernel stays on the path.
    exact_attn_dropout: bool = False
    max_position_embeddings: int = 256
    remat: bool = False
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0


@dataclass(frozen=True)
class MAEDecoderConfig:
    """MAE image decoder (reference: model_ecamp.py:328-333 factory args)."""

    embed_dim: int = 512
    depth: int = 4
    num_heads: int = 16
    mlp_ratio: float = 4.0
    norm_eps: float = 1e-6
    remat: bool = False


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # adamw | sgd
    lr: float = 1.5e-4
    min_lr: float = 0.0
    weight_decay: float = 0.05
    betas: Tuple[float, float] = (0.9, 0.95)
    momentum: float = 0.9
    grad_clip: Optional[float] = None
    # warmup_cosine_epoch (pretrain, util/lr_sched.py:9-21) |
    # warmup_cosine_step | warmup_linear_step (fine-tune,
    # utils/scheduler.py:8-41) | constant
    schedule: str = "warmup_cosine_epoch"
    warmup_epochs: float = 40.0
    warmup_steps: int = 500
    total_steps: int = 3000
    accum_steps: int = 1
    # kept for field parity: the port's adamw always runs the fused
    # kernel on CUDA parameters (train/optim.py)
    fused_adamw: bool = False


@dataclass(frozen=True)
class MeshConfig:
    """The data-parallel layout, field for field `ecamp_tpu.core.config.
    MeshConfig`. The data axis is torchrun's ranks, one card each; the
    model axis (tensor parallelism) is not ported and must stay 1."""

    data_axis: str = "data"
    model_axis: str = "model"
    data: int = -1  # -1 = all ranks
    model: int = 1
    # ZeRO-1: each rank keeps the AdamW moments (and accumulation buffers)
    # of its span of the parameters only and updates that span; the ranks
    # then exchange the spans (`core/distributed.py::Zero1`). Saves
    # 2 x params x 4 B x (1 - 1/N) a rank.
    shard_optimizer: bool = False
    # FSDP / ZeRO-3: the parameters and their gradients sharded too, a
    # span of each unit's flat layout a rank (`core/distributed.py::Fsdp`);
    # a unit's parameters are all-gathered at its call and its gradient
    # reduce-scattered after its backward. Implies sharded moments. Saves
    # 4 x params x 4 B x (1 - 1/N) a rank against plain data parallelism.
    shard_params: bool = False


@dataclass(frozen=True)
class DataConfig:
    root: str = ""
    batch_size: int = 256
    num_workers: int = 8
    img_size: int = 224
    # grayscale replicate-to-3ch normalization (pretrain_datasets.py:52)
    mean: float = 0.4721
    std: float = 0.3037
    data_volume: str = "100"
    prefetch: int = 2
    shuffle_seed: int = 0


@dataclass(frozen=True)
class PretrainConfig:
    """`ecamp_tpu.core.config.PretrainConfig`, with `fused_mlm_ce` in place
    of the JAX package's environment switch."""

    vit: ViTConfig = field(default_factory=vit_base)
    decoder: MAEDecoderConfig = field(default_factory=MAEDecoderConfig)
    bert: BertConfig = field(default_factory=BertConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    data: DataConfig = field(default_factory=lambda: DataConfig(img_size=448))
    mask_ratio: float = 0.75
    sr_scale: int = 2
    sr_window: int = 12  # 12x12-patch SR window (model_ecamp.py:208)
    max_caption_length: int = 256
    epochs: int = 120
    max_epoch: int = 200        # cosine horizon (run.sh:11 vs --epochs 120)
    norm_pix_loss: bool = False  # parsed but unused, as in the reference
    seed: int = 0
    bf16: bool = True
    ckpt_dir: str = "checkpoints"
    resume: str = ""
    ckpt_every_mid: int = 10
    ckpt_every_late: int = 5
    # the MLM loss through the fused vocab-projection + CE kernels, the
    # logits never stored (the JAX package's opt-in ECAMP_FUSED_CE=1)
    fused_mlm_ce: bool = False


@dataclass(frozen=True)
class ClassificationConfig:
    """Fine-tune / linear-probe classification (reference
    Classification/train.py + run_{ft,lp}.sh); `ecamp_tpu.core.config.
    ClassificationConfig` without `mesh`."""

    vit: ViTConfig = field(default_factory=vit_base)
    optimizer: OptimizerConfig = field(
        default_factory=lambda: OptimizerConfig(
            name="sgd", lr=3e-3, weight_decay=0.0,
            schedule="warmup_cosine_step"))
    data: DataConfig = field(
        default_factory=lambda: DataConfig(mean=0.4722, std=0.3028))
    task: str = "ChestX-ray14"
    num_classes: int = 14
    is_multilabel: bool = True   # BCE + AUC vs CE + ACC (train.py:118-121)
    linear_probe: bool = False   # freeze all but head (train.py:156-159)
    global_pool: bool = True
    eval_every: int = 0          # 0 = every len(train_loader) steps
    patience: int = 20
    head_init_std: float = 2e-5  # trunc_normal_ head re-init (train.py:147)
    pretrained: str = ""
    seed: int = 42
    bf16: bool = True
    ckpt_dir: str = "checkpoints"


@dataclass(frozen=True)
class SegmentationConfig:
    """SIIM/RSNA/RIGA segmentation (reference: Segmentation/train*.py)."""

    vit: ViTConfig = field(default_factory=vit_base)
    optimizer: OptimizerConfig = field(
        default_factory=lambda: OptimizerConfig(
            name="adamw", lr=2e-4, weight_decay=0.05, betas=(0.9, 0.999),
            schedule="warmup_cosine_step"))
    data: DataConfig = field(
        default_factory=lambda: DataConfig(mean=0.4722, std=0.3028))
    task: str = "SIIM"           # SIIM | RSNA | RIGA
    backbone: str = "vit"        # vit | resnet50 (smp.Unet baseline path,
                                 # Segmentation/train.py:139-180)
    out_channels: int = 1        # RIGA uses dual single-channel decoders
    sample_rate: int = 4         # seg_head token upsample exponent (models_vit.py:35)
    decode_features: Tuple[int, ...] = (512, 256, 128, 64)
    mixed_loss_alpha: float = 10.0
    focal_gamma: float = 2.0
    freeze_encoder: bool = True  # encoder frozen except seg_head (train.py:128-133)
    patience: int = 40
    pretrained: str = ""
    seed: int = 42
    bf16: bool = True
    ckpt_dir: str = "checkpoints"


@dataclass(frozen=True)
class DetectionConfig:
    """RSNA pneumonia / ObjectCXR detection (reference Detection/train.py);
    `ecamp_tpu.core.config.DetectionConfig` without `mesh`."""

    vit: ViTConfig = field(default_factory=vit_base)
    optimizer: OptimizerConfig = field(
        default_factory=lambda: OptimizerConfig(
            name="adamw", lr=5e-4, weight_decay=1e-6, betas=(0.9, 0.999),
            schedule="warmup_cosine_step"))
    data: DataConfig = field(
        default_factory=lambda: DataConfig(mean=0.4722, std=0.3028))
    task: str = "RSNA"
    backbone: str = "vit"        # vit | resnet50 (ResNetDetector baseline,
                                 # Detection/train.py:99-131)
    num_classes: int = 1
    img_size: int = 224
    max_objects: int = 10
    expansion: int = 4           # bottleneck expansion; 8 for 1/10% volume (train.py:136)
    conf_threshold: float = 0.5
    nms_threshold: float = 0.5
    # mAP over IoU .40:.05:.75 (train.py:214-215)
    map_iou_thresholds: Tuple[float, ...] = tuple(
        round(0.4 + 0.05 * i, 2) for i in range(8))
    freeze_encoder: bool = True
    patience: int = 20
    pretrained: str = ""
    seed: int = 42
    bf16: bool = True
    ckpt_dir: str = "checkpoints"
