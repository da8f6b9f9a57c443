"""ECAMP pretraining model: MAE ViT-B/16 + SR branch + multimodal BERT
(counterpart of `ecamp_tpu/nn/mae.py`; reference
Pre-training/module/model_ecamp.py:49-333).

  * encoder: patchify 224 -> + fixed sin-cos table -> 75% token drop ->
    cls -> 12 blocks -> LayerNorm (model_ecamp.py:218-237)
  * decoder: 512-d, 4 blocks, 16 heads; mask tokens re-inserted and
    unshuffled; pixel head (:240-264)
  * SR head: bilinear x2 + two 3x3 convs + residual (:28-46)
  * `ViTConfig.remat` / `MAEDecoderConfig.remat` run each encoder /
    decoder block under an activation checkpoint (`nn/layers.py::remat`),
    as the JAX package wraps them in `nn.remat`; `BertConfig.remat` does
    so for the BERT layers
  * losses: MIM + SR-window MSE (:276-300, quirks kept) and the
    entity-weighted MLM through the fusion BERT (:267-273), from
    materialised logits or, with `fused_mlm_ce`, through the fused
    vocab-projection + CE kernels (the JAX package's `ECAMP_FUSED_CE=1`)

The 448 -> 224 bicubic resize runs on the device at the head of the
forward, as in the reference (:318). The state dict has the names of the
reference `.pth` (what `ecamp_tpu/ckpt/torch_export.py::
export_ecamp_pretrain` writes): `patch_embed.*`, `cls_token`, `blocks.{i}`,
`norm`, `decoder_embed`, `mask_token`, `decoder_blocks.{i}`,
`decoder_norm`, `decoder_pred`, `super_res.conv{1,2}`, `bert_mlp`,
`bert_encoder.model.*`. The two fixed sin-cos tables `pos_embed` and
`decoder_pos_embed` are non-persistent buffers, not state-dict keys, as
the JAX package holds them as trace-time constants.

Only the direct layout is ported: the JAX package's TPU layout variants
(`ECAMP_SR_S2D`, its default, `ECAMP_SR_NCHW_PATH`, `ECAMP_PAD_VOCAB`,
`ECAMP_GATHER_PERMUTE`, `ECAMP_RESIZE_NHWC`) compute the same math
(tests/test_layout_variants.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ..core.config import BertConfig, MAEDecoderConfig, ViTConfig
from ..kernels.fused_mlm_loss import fused_mlm_loss_sum
from ..kernels.sr_head import _sr_reference, sr_conv_stack
from ..ops.image_ops import resize_bicubic, resize_bilinear
from ..ops.losses import masked_pixel_losses, weighted_mlm_loss
from ..ops.masking import (mask_to_pixel, permute_tokens, random_masking,
                           unpatchify)
from .bert import MultimodalBert
from .layers import (Block, Dense, LayerNorm, PatchEmbed, call,
                     compute_weight, lecun_normal_, remat)
from .pos_embed import get_2d_sincos_pos_embed


class Conv3x3(nn.Module):
    """A 3x3 conv's parameters: OIHW `weight` and `bias`, flax's
    lecun-normal / zeros init. The SR head computes with them in the
    parameters' dtype (`compute_weight` widens an int8-quantized weight)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator=None) -> None:
        lecun_normal_(self.weight, generator)
        nn.init.zeros_(self.bias)


class SuperResolutionHead(nn.Module):
    """InterpolateConvSuperResolution (model_ecamp.py:28-46) on the direct
    path: NHWC bilinear x2 -> NCHW -> conv stack -> NHWC. The conv stack
    is `sr_conv_stack`, the SR kernel for CUDA tensors."""

    def __init__(self, scale: int = 2, channels: int = 3):
        super().__init__()
        self.scale = scale
        self.plain = False  # see set_plain
        self.conv1 = Conv3x3(channels, channels)
        self.conv2 = Conv3x3(channels, channels)

    def forward(self, x):
        n, h, w, c = x.shape
        x = resize_bilinear(x, (h * self.scale, w * self.scale))
        x_chw = x.permute(0, 3, 1, 2).contiguous()
        fn = _sr_reference if self.plain else sr_conv_stack
        c1, c2 = self.conv1, self.conv2
        out = fn(x_chw, compute_weight(c1, c1.bias.dtype), c1.bias,
                 compute_weight(c2, c2.bias.dtype), c2.bias)
        return out.permute(0, 2, 3, 1)


class ECAMP(nn.Module):
    def __init__(self, vit: ViTConfig, decoder: MAEDecoderConfig,
                 bert: BertConfig, sr_window: int = 12, sr_scale: int = 2,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 fused_mlm_ce: bool = False):
        super().__init__()
        c, dc = vit, decoder
        self.vit, self.decoder_cfg = vit, decoder
        self.sr_window, self.sr_scale, self.dtype = sr_window, sr_scale, dtype
        self.fused_mlm_ce = fused_mlm_ce
        self.plain = False  # see set_plain; routes the fused CE
        self.patch_embed = PatchEmbed(c.patch_size, c.in_chans, c.embed_dim,
                                      dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, c.embed_dim))
        # the encoder's blocks run without dropout or drop-path, as the JAX
        # ECAMP builds them
        self.blocks = nn.ModuleList([
            Block(c.embed_dim, c.num_heads, c.mlp_ratio, c.qkv_bias,
                  norm_eps=c.norm_eps, dtype=dtype) for _ in range(c.depth)])
        self.norm = LayerNorm(c.embed_dim, c.norm_eps, dtype)
        self.decoder_embed = Dense(c.embed_dim, dc.embed_dim, dtype=dtype)
        self.mask_token = nn.Parameter(torch.empty(1, 1, dc.embed_dim))
        self.decoder_blocks = nn.ModuleList([
            Block(dc.embed_dim, dc.num_heads, dc.mlp_ratio, True,
                  norm_eps=dc.norm_eps, dtype=dtype)
            for _ in range(dc.depth)])
        self.decoder_norm = LayerNorm(dc.embed_dim, dc.norm_eps, dtype)
        self.decoder_pred = Dense(dc.embed_dim,
                                  c.patch_size ** 2 * c.in_chans, dtype=dtype)
        self.super_res = SuperResolutionHead(sr_scale, c.in_chans)
        self.bert_mlp = Dense(c.embed_dim, bert.hidden_size, dtype=dtype)
        self.bert_encoder = nn.Module()
        self.bert_encoder.model = MultimodalBert(bert, dtype)
        for name, dim in (("pos_embed", c.embed_dim),
                          ("decoder_pos_embed", dc.embed_dim)):
            table = get_2d_sincos_pos_embed(dim, c.grid_size, cls_token=True)
            self.register_buffer(name, torch.from_numpy(table)[None],
                                 persistent=False)
        self.reset_parameters(generator)

    def fsdp_units(self) -> List[str]:
        """The modules FSDP shards as units of their own
        (`core/distributed.py::Fsdp`): each encoder and decoder block and
        BERT's (`MultimodalBert.fsdp_units`); the rest (the patch
        embedding, the tokens, the norms, the decoder's embedding and
        pixel head, the SR head, `bert_mlp`) is the root unit, gathered
        for the whole forward (`nn/layers.py::call` of the model)."""
        bert = "bert_encoder.model."
        return ([f"blocks.{i}" for i in range(len(self.blocks))]
                + [f"decoder_blocks.{i}"
                   for i in range(len(self.decoder_blocks))]
                + [bert + u for u in self.bert_encoder.model.fsdp_units()])

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Initialise every parameter from `generator` (JAX init rules)."""
        with torch.no_grad():
            nn.init.normal_(self.cls_token, 0.0, 0.02, generator=generator)
            nn.init.normal_(self.mask_token, 0.0, 0.02, generator=generator)
            for m in self.modules():
                if m is not self and hasattr(m, "reset_parameters"):
                    m.reset_parameters(generator)

    def forward(self, batch: Dict[str, torch.Tensor], mask_ratio: float = 0.75,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                features_only: bool = False,
                return_cross_probs: bool = False) -> Dict[str, torch.Tensor]:
        """batch: image (N, H, W, 3) at the data size, ids, labels,
        attention_mask, type_ids, weights (N, L), column, row (N,).
        Masking noise (N, grid**2) uniform is `noise`, or drawn from
        `generator`. Returns mim_loss, res_loss (if mask_ratio > 0),
        mlm_logits and mlm_loss (if labels and weights are given); with
        `fused_mlm_ce` and a loss to compute, mlm_loss through the fused
        vocab-projection + CE and no mlm_logits; with features_only,
        gap_feature and patch_latent instead of the BERT outputs. With
        `return_cross_probs` (the visualizer) also cross_attention, the
        fusion layer's text-to-image probabilities (N, H, L_text, grid^2),
        from the plain attention; the MLM loss is then never fused."""
        c = self.vit
        big = batch["image"].to(self.dtype)
        if big.shape[1] == c.img_size and big.shape[2] == c.img_size:
            imgs = big  # already at the encoder's size (the visualizer's)
        else:
            imgs = resize_bicubic(big, (c.img_size, c.img_size))
        latent, mask, ids_restore, _ = self.image_encoder(
            imgs, mask_ratio, noise, generator)

        outputs: Dict[str, torch.Tensor] = {}
        if mask_ratio > 0:
            pred = self.image_decoder(latent, ids_restore)
            pred_img = unpatchify(pred.to(self.dtype), c.patch_size,
                                  c.in_chans)
            pixel_mask, super_mask = mask_to_pixel(
                mask, batch["column"], batch["row"], c.patch_size,
                self.sr_scale, self.sr_window)
            super_pred = self.super_res(pred_img)
            outputs["mim_loss"], outputs["res_loss"] = masked_pixel_losses(
                pred_img, imgs, super_pred, big, pixel_mask, super_mask)

        # report-decoder bridge (model_ecamp.py:267-273)
        lat = self.bert_mlp(latent)
        patch_latent = lat[:, 1:, :]
        gap_token = patch_latent.mean(dim=1, keepdim=True)
        if features_only:
            outputs["gap_feature"] = gap_token[:, 0]
            outputs["patch_latent"] = patch_latent
            return outputs
        has_loss = "labels" in batch and "weights" in batch
        use_fused = self.fused_mlm_ce and has_loss and not return_cross_probs
        bert_out = self.bert_encoder.model(
            patch_latent, gap_token, batch["ids"],
            attention_mask=batch.get("attention_mask"),
            token_type_ids=batch.get("type_ids"),
            return_mlm_features=use_fused,
            return_cross_probs=return_cross_probs)
        if return_cross_probs:
            bert_out, outputs["cross_attention"] = bert_out
        if use_fused:
            feats, kernel, bias = bert_out
            n, L, d = feats.shape
            outputs["mlm_loss"] = fused_mlm_loss_sum(
                feats.reshape(n * L, d), kernel, bias,
                batch["labels"].reshape(-1), batch["weights"].reshape(-1),
                plain=self.plain) / (n * L)
            return outputs
        outputs["mlm_logits"] = bert_out
        if has_loss:
            outputs["mlm_loss"] = weighted_mlm_loss(
                bert_out, batch["labels"], batch["weights"])
        return outputs

    def image_encoder(self, x, mask_ratio: float,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None):
        """model_ecamp.py:218-237. Returns (tokens, mask, ids_restore,
        ids_keep)."""
        x = self.patch_embed(x)
        b, L, d = x.shape
        pos = self.pos_embed.to(self.dtype)
        x = x + pos[:, 1:, :]
        if mask_ratio > 0:
            if noise is None:
                noise = torch.rand((b, L), generator=generator,
                                   device=x.device)
            x, mask, ids_restore, ids_keep = random_masking(x, mask_ratio,
                                                            noise)
        else:
            mask = torch.zeros((b, L), dtype=x.dtype, device=x.device)
            ids_restore = torch.arange(L, device=x.device).expand(b, L)
            ids_keep = ids_restore
        cls = (self.cls_token.to(self.dtype) + pos[:, :1, :]).expand(b, -1, -1)
        x = torch.cat([cls, x], dim=1)
        for blk in self.blocks:
            x = remat(blk, x) if self.vit.remat else call(blk, x)
        return self.norm(x), mask, ids_restore, ids_keep

    def image_decoder(self, x, ids_restore):
        """model_ecamp.py:240-264."""
        b, n_kept, _ = x.shape
        L = ids_restore.shape[1]
        x = self.decoder_embed(x)
        mask_tokens = self.mask_token.to(self.dtype).expand(
            b, L + 1 - n_kept, -1)
        x_ = permute_tokens(torch.cat([x[:, 1:, :], mask_tokens], dim=1),
                            ids_restore)
        x = torch.cat([x[:, :1, :], x_], dim=1)
        x = x + self.decoder_pos_embed.to(self.dtype)
        for blk in self.decoder_blocks:
            x = remat(blk, x) if self.decoder_cfg.remat else call(blk, x)
        x = self.decoder_pred(self.decoder_norm(x))
        return x[:, 1:, :]
