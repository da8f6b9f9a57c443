"""Multimodal BERT text branch (counterpart of `ecamp_tpu/nn/bert.py`).

HF-BERT numerics for the reference's 6-layer multimodal masked LM
(module/bert_modeling.py:10-227) and its entity-context fusion layer
(module/context_fusion.py:7-72):

  embeddings -> FusionLayer (text self-attention -> text-to-image cross
  attention + gap token -> FFN) -> 6 x BertLayer -> MLM head.

The state dict has the reference's names under `MultimodalBert`
(`bert.embeddings.*`, `bert.context_fusion_layer.*`,
`bert.encoder.layer.{i}.*`, `cls.predictions.*`), the names the JAX
package's `.pth` exporter writes under `bert_encoder.model.`. LayerNorm eps
is 1e-12; each residual is added before its LayerNorm; the cross attention
is a bare BertSelfAttention whose context output gets gap_mlp(gap_token)
added before `out_layer`. Every attention runs through
`dot_product_attention` (the attention kernel for CUDA tensors), and
attention dropout drops the context output at the same rate unless
`exact_attn_dropout` asks for HF's dropout of the probabilities. The one
exception: asked for its probabilities (`return_cross_probs`, the
visualizer), the fusion layer's cross attention runs the plain version,
which materialises them, as the JAX package's does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import BertConfig
from ..kernels import dot_product_attention
from ..kernels.flash_attention import _attention_reference
from .layers import Dense, Dropout, LayerNorm, compute_weight

_NEG_INF = float(torch.finfo(torch.float32).min)


def extend_attention_mask(mask: torch.Tensor) -> torch.Tensor:
    """(B, L) 1/0 mask -> additive fp32 (B, 1, 1, L) bias (HF
    get_extended_attention_mask): 0 where kept, finfo(fp32).min where
    padded."""
    return (1.0 - mask.float())[:, None, None, :] * _NEG_INF


class BertSelfAttention(nn.Module):
    """HF BertSelfAttention: separate q/k/v, the context output (no output
    dense). With kv_states it is the fusion layer's cross attention."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.plain = False  # see set_plain
        self.query = Dense(d, d, dtype=dtype)
        self.key = Dense(d, d, dtype=dtype)
        self.value = Dense(d, d, dtype=dtype)
        # the same rate on the probabilities (exact_attn_dropout) or on the
        # context output (default)
        self.dropout = Dropout(cfg.attention_probs_dropout_prob)

    def forward(self, hidden, bias=None, kv_states=None,
                return_probs: bool = False):
        """The context output (B, Nq, D); with `return_probs` also the fp32
        probabilities (B, H, Nq, Nk), from the plain attention."""
        h = self.cfg.num_attention_heads
        b, nq, d = hidden.shape
        hd = d // h
        kv = hidden if kv_states is None else kv_states
        nk = kv.shape[1]

        def split(x, n):  # (B, N, D) -> contiguous (B, H, N, hd)
            return x.reshape(b, n, h, hd).transpose(1, 2).contiguous()

        q = split(self.query(hidden), nq)
        k = split(self.key(kv), nk)
        v = split(self.value(kv), nk)
        if self.cfg.exact_attn_dropout and self.training:
            # HF order: fp32 softmax, dropout on the probabilities, then
            # the value product (no kernel: the probabilities are needed)
            logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
            logits = logits * hd ** -0.5
            if bias is not None:
                logits = logits + bias
            probs = self.dropout(torch.softmax(logits, dim=-1))
            out = torch.matmul(probs.to(v.dtype), v)
            out = out.transpose(1, 2).reshape(b, nq, d)
            return (out, probs) if return_probs else out
        fn = _attention_reference if self.plain else dot_product_attention
        out = fn(q, k, v, bias, hd ** -0.5, return_probs=return_probs)
        probs = None
        if return_probs:
            out, probs = out
        out = self.dropout(out.transpose(1, 2).reshape(b, nq, d))
        return (out, probs) if return_probs else out


class BertSelfOutput(nn.Module):
    """dense -> dropout -> LayerNorm(x + residual)."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.float32,
                 in_features: Optional[int] = None):
        super().__init__()
        self.dense = Dense(in_features or cfg.hidden_size, cfg.hidden_size,
                           dtype=dtype)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, hidden, residual):
        return self.LayerNorm(self.dropout(self.dense(hidden)) + residual)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        # `self` is the HF attribute name (state-dict key `attention.self.*`)
        self.add_module("self", BertSelfAttention(cfg, dtype))
        self.output = BertSelfOutput(cfg, dtype)

    def forward(self, hidden, bias=None):
        ctx = self._modules["self"](hidden, bias=bias)
        return self.output(ctx, hidden)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.intermediate_size, dtype=dtype)

    def forward(self, x):
        return F.gelu(self.dense(x))  # exact erf GELU


class BertOutput(BertSelfOutput):
    """dense (intermediate -> hidden) -> dropout -> LayerNorm(x + residual)."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__(cfg, dtype, in_features=cfg.intermediate_size)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attention = BertAttention(cfg, dtype)
        self.intermediate = BertIntermediate(cfg, dtype)
        self.output = BertOutput(cfg, dtype)

    def forward(self, hidden, bias=None):
        attn = self.attention(hidden, bias)
        return self.output(self.intermediate(attn), attn)


class FusionLayer(nn.Module):
    """ECAMPFusionLayer (context_fusion.py:7-72). The image side has no
    mask: the reference's is all ones (bert_modeling.py:79)."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attention = BertAttention(cfg, dtype)
        self.cross_self_attention = BertSelfAttention(cfg, dtype)
        self.gap_mlp = Dense(cfg.hidden_size, cfg.hidden_size, dtype=dtype)
        self.out_layer = BertSelfOutput(cfg, dtype)
        self.intermediate = BertIntermediate(cfg, dtype)
        self.output = BertOutput(cfg, dtype)

    def forward(self, hidden, latent, gap_token, text_bias=None,
                return_cross_probs: bool = False):
        """The fused text (B, L, D); with `return_cross_probs` also the
        cross attention's probabilities (B, H, L, N_image)."""
        attn = self.attention(hidden, text_bias)
        cross = self.cross_self_attention(attn, kv_states=latent,
                                          return_probs=return_cross_probs)
        probs = None
        if return_cross_probs:
            cross, probs = cross
        fused = self.out_layer(cross + self.gap_mlp(gap_token), attn)
        out = self.output(self.intermediate(fused), fused)
        return (out, probs) if return_cross_probs else out


class Embed(nn.Module):
    """An fp32 lookup table `weight` (num, dim), normal(0, std) init."""

    def __init__(self, num: int, dim: int, std: float):
        super().__init__()
        self.std = std
        self.weight = nn.Parameter(torch.empty(num, dim))

    def reset_parameters(self, generator=None) -> None:
        nn.init.normal_(self.weight, 0.0, self.std, generator=generator)

    def forward(self, ids):
        return F.embedding(ids, self.weight)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        h, std = cfg.hidden_size, cfg.initializer_range
        self.dtype = dtype
        self.word_embeddings = Embed(cfg.vocab_size, h, std)
        self.position_embeddings = Embed(cfg.max_position_embeddings, h, std)
        self.token_type_embeddings = Embed(cfg.type_vocab_size, h, std)
        self.LayerNorm = LayerNorm(h, cfg.layer_norm_eps, dtype)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None):
        L = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos_ids = torch.arange(L, device=input_ids.device)[None, :]
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(pos_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.LayerNorm(x.to(self.dtype)))


class MLMHead(nn.Module):
    """HF BertOnlyMLMHead: transform (dense + GELU + LayerNorm, eps 1e-12),
    then the vocab projection `predictions.decoder` as a plain matmul of
    the true vocab width (no lane padding). With `return_features`, the
    projection is left to the caller's fused CE: it returns the transform's
    output (compute dtype), the decoder weight (V, D) cast to the compute
    dtype and the decoder bias in fp32, which the kernel adds in fp32."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        h = cfg.hidden_size
        self.predictions = nn.Module()
        self.predictions.transform = nn.Module()
        self.predictions.transform.dense = Dense(h, h, dtype=dtype)
        self.predictions.transform.LayerNorm = LayerNorm(
            h, cfg.layer_norm_eps, dtype)
        self.predictions.decoder = Dense(h, cfg.vocab_size, dtype=dtype)

    def forward(self, x, return_features: bool = False):
        t = self.predictions.transform
        feats = t.LayerNorm(F.gelu(t.dense(x)))
        decoder = self.predictions.decoder
        if return_features:
            return feats, compute_weight(decoder, decoder.dtype), decoder.bias
        return decoder(feats)


class MultimodalBert(nn.Module):
    """Embeddings -> fusion -> encoder -> MLM logits
    (MultimodalBertMaskedLM, bert_modeling.py:160-227); the weighted CE is
    `ops.losses.weighted_mlm_loss`. With `return_mlm_features`, the MLM
    head's (features, decoder weight, decoder bias) for the fused CE
    instead of the logits. With `return_cross_probs`, the pair (that
    output, the fusion layer's cross-attention probabilities)."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.remat:
            raise NotImplementedError("BertConfig.remat: activation "
                                      "checkpointing is not ported")
        self.bert = nn.Module()
        self.bert.embeddings = BertEmbeddings(cfg, dtype)
        self.bert.context_fusion_layer = FusionLayer(cfg, dtype)
        self.bert.encoder = nn.Module()
        self.bert.encoder.layer = nn.ModuleList(
            [BertLayer(cfg, dtype) for _ in range(cfg.num_hidden_layers)])
        self.cls = MLMHead(cfg, dtype)

    def forward(self, latent, gap_token, input_ids,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                return_mlm_features: bool = False,
                return_cross_probs: bool = False):
        bias = None
        if attention_mask is not None:
            bias = extend_attention_mask(attention_mask)
        h = self.bert.embeddings(input_ids, token_type_ids)
        h = self.bert.context_fusion_layer(h, latent, gap_token, bias,
                                           return_cross_probs)
        probs = None
        if return_cross_probs:
            h, probs = h
        for layer in self.bert.encoder.layer:
            h = layer(h, bias)
        out = self.cls(h, return_features=return_mlm_features)
        return (out, probs) if return_cross_probs else out
