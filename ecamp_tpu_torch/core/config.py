"""Configuration tree, field for field the same as `ecamp_tpu.core.config`.

Ported: `ViTConfig`, `BertConfig`, `MAEDecoderConfig`, `OptimizerConfig`,
`DataConfig` and `PretrainConfig`. Left out: `MeshConfig` (the GSPMD
data/model mesh, TPU-only; ROADMAP "Not ported"), and with it
`PretrainConfig.mesh`. The fine-tune configs follow with their tasks.
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
    # kept for field parity with the JAX config; activation checkpointing
    # is not ported, and a model built with remat=True raises
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
    """`ecamp_tpu.core.config.PretrainConfig` without `mesh`."""

    vit: ViTConfig = field(default_factory=vit_base)
    decoder: MAEDecoderConfig = field(default_factory=MAEDecoderConfig)
    bert: BertConfig = field(default_factory=BertConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
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
