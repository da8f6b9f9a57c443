"""Text-to-image cross-attention heatmap of the pretrained ECAMP (counterpart
of `ecamp_tpu/cli/visualize.py`; reference
Visualization/main_visualization.py:106-178), on one CUDA card:

python -m ecamp_tpu_torch.cli.visualize --image x.png \\
  --text "small left pleural effusion" --checkpoint checkpoint-100.pth \\
  --tokenizer ecamp_tpu/assets/mimic_wordpiece.json --output vis.png

It tokenizes "[CLS] " + the text (padded to the BERT's 256 positions),
reads the image as RGB, resizes it bilinearly to 224 with PIL, makes it
gray in three channels and normalises it (0.4722, 0.3028); runs the fp32
ECAMP (ViT-B/16, 6-layer BERT) with mask_ratio 0 on the 224-px image,
which skips the model's 448 -> 224 resize, as the reference's
visualization forward does; takes the fusion layer's cross-attention row
of `--token_index` (H, 14^2), its max over the heads, to the power 0.25,
min-max normalised and bilinearly upsampled to 224 (half-pixel centres,
`align_corners=False`); colours it with jet and blends it 50/50 with the
gray image into `--output` (and the gray image into `--save_original`).

The checkpoint is a pretraining `.pth` (the reference's or the port's
`cli/pretrain.py`), loaded by `ckpt/checkpoint.py::load_model_state`,
which reads the visualization checkpoints' `cross_attn_layer` as
`context_fusion_layer`. On the card every LayerNorm and self-attention
launches its kernel; the cross attention that returns its probabilities
runs the plain version, as in the JAX package. `--device cpu` runs the
plain versions throughout.
"""

from __future__ import annotations

import argparse
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from ..ckpt.checkpoint import load_checkpoint, load_model_state
from ..core import config as cfg
from ..data.tokenizer import WordPieceTokenizer
from ..data.transforms import normalize, to_grayscale3
from ..nn.mae import ECAMP

IMG = 224


def jet_colormap(x: np.ndarray) -> np.ndarray:
    """matplotlib's 'jet' as piecewise-linear RGB in numpy (a copy of the
    JAX CLI's): [0, 1] -> (..., 3) in [0, 1]."""
    x = np.clip(x, 0.0, 1.0)

    def channel(v, lo_up, hi_up, lo_dn, hi_dn):
        up = np.clip((v - lo_up) / max(hi_up - lo_up, 1e-9), 0, 1)
        dn = 1.0 - np.clip((v - lo_dn) / max(hi_dn - lo_dn, 1e-9), 0, 1)
        return np.minimum(up, dn)

    r = channel(x, 0.375, 0.625, 0.875, 1.125)
    g = channel(x, 0.125, 0.375, 0.625, 0.875)
    b = channel(x, -0.125, 0.125, 0.375, 0.625)
    return np.stack([r, g, b], axis=-1)


def heatmap_from_row(attn_row: torch.Tensor, out_size: int = IMG
                     ) -> np.ndarray:
    """One text token's cross-attention row (H, grid^2), on any device ->
    the (out_size, out_size) map in [0, 1] (main_visualization.py:156-167):
    the patch grid, the max over heads, ^0.25, min-max, then a bilinear
    upsample with half-pixel centres (what `jax.image.resize` does)."""
    grid = int(round(attn_row.shape[-1] ** 0.5))
    attn = attn_row.float().reshape(attn_row.shape[0], grid, grid)
    amap = attn.amax(dim=0) ** 0.25
    amap = (amap - amap.min()) / (amap.max() - amap.min() + 1e-12)
    up = F.interpolate(amap[None, None], size=(out_size, out_size),
                       mode="bilinear", align_corners=False)
    return up[0, 0].cpu().numpy()


def load_model(checkpoint: str, device) -> ECAMP:
    """The fp32 ECAMP (ViT-B/16, decoder 512/4/16, 6-layer BERT) in eval
    mode on `device`, its weights from a pretraining `.pth`."""
    model = ECAMP(vit=cfg.ViTConfig(), decoder=cfg.MAEDecoderConfig(),
                  bert=cfg.BertConfig(), dtype=torch.float32,
                  generator=torch.Generator().manual_seed(0))
    loaded, _ = load_model_state(model, load_checkpoint(checkpoint)["model"])
    print(f"loaded {len(loaded)} tensors from {checkpoint}")
    return model.to(device).eval()


def prepare(image: str, text: str, tokenizer: str, max_len: int
            ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """The gray 224-px image (uint8, HWC) and the model's batch of one."""
    tok = WordPieceTokenizer.from_file(tokenizer)
    enc = tok.encode("[CLS] " + text, max_length=max_len, pad_to=max_len)
    with open(image, "rb") as f:
        pil = Image.open(f).convert("RGB")
    pil = to_grayscale3(pil.resize((IMG, IMG), Image.BILINEAR))
    origin = np.asarray(pil)
    batch = {"image": normalize(origin, 0.4722, 0.3028)[None],
             "ids": enc.ids[None].astype(np.int64),
             "attention_mask": enc.attention_mask[None],
             "type_ids": enc.type_ids[None].astype(np.int64)}
    return origin, batch


def cross_attention_map(model: ECAMP, batch: Dict[str, np.ndarray],
                        token_index: int) -> np.ndarray:
    """The heatmap of one text token: the model's cross-attention
    probabilities (1, H, L_text, grid^2) at mask_ratio 0, that token's
    row, `heatmap_from_row`."""
    device = next(model.parameters()).device
    with torch.no_grad():
        out = model({k: torch.from_numpy(v).to(device)
                     for k, v in batch.items()},
                    mask_ratio=0.0, return_cross_probs=True)
    return heatmap_from_row(out["cross_attention"][0, :, token_index])


def get_args(argv=None):
    p = argparse.ArgumentParser("ecamp_tpu_torch visualize")
    p.add_argument("--image", required=True)
    p.add_argument("--text", required=True)
    p.add_argument("--checkpoint", required=True, help=".pth pretrain ckpt")
    p.add_argument("--tokenizer", required=True, help="mimic_wordpiece.json")
    p.add_argument("--token_index", type=int, default=4,
                   help="text token row to visualize (reference uses 4)")
    p.add_argument("--output", default="vis_heatmap.png")
    p.add_argument("--save_original", default="vis_original.png")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; needs a card) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> np.ndarray:
    """Write the blended heatmap (and the gray image); returns the map."""
    args = get_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card (--device cpu "
                           "runs the kernels' plain versions)")
    origin, batch = prepare(args.image, args.text, args.tokenizer,
                            cfg.BertConfig().max_position_embeddings)
    if args.save_original:
        Image.fromarray(origin[:, :, 0], "L").save(args.save_original)
    model = load_model(args.checkpoint, device)
    amap = cross_attention_map(model, batch, args.token_index)
    color = (jet_colormap(amap) * 255).astype(np.uint8)
    blended = (0.5 * origin + 0.5 * color).astype(np.uint8)
    Image.fromarray(blended).save(args.output)
    print(f"wrote {args.output}")
    return amap


if __name__ == "__main__":
    main()
