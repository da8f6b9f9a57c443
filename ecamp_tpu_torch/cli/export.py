"""Export a checkpoint of the port to the reference PyTorch `.pth` layouts
(counterpart of `ecamp_tpu/cli/export.py`).

It builds the task's model, loads the checkpoint into it strictly and
writes the model's weights with `torch.save` in exactly the layout the
JAX package's exporters write (`ecamp_tpu/ckpt/torch_export.py`):
pretraining as `{'model': state, 'epoch': N}` (util/misc.py:295-312, the
optimizer dropped; the epoch is the checkpoint's unless `--epoch` is
given), the fine-tuned classifier, SegViT and detector as flat state dicts
in the reference namespaces (Classification/train.py:84-95). Every value
is an fp32 CPU tensor; BatchNorm `num_batches_tracked` counters, which the
JAX package keeps no copy of, are left out. The port's own fine-tune CLIs
wrap their `.pth` in `{"model": ...}`; the export unwraps it.

The export moves bytes and computes nothing, so it runs on the CPU on any
machine and needs no card. The port reads `.pth` files only: an orbax
directory raises. JAX exports no ResNet-50 model, so neither does the
port.

  python -m ecamp_tpu_torch.cli.export --task pretrain \\
      --checkpoint out/checkpoint-39.pth --output ECAMP_ViT_Base_16.pth
  python -m ecamp_tpu_torch.cli.export --task classification \\
      --num_classes 14 --checkpoint out/best/checkpoint-best.pth \\
      --output cls.pth
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import torch
from torch import nn

from ..core import config as cfg

_VIT_FACTORY = {"tiny": cfg.vit_tiny, "base": cfg.vit_base,
                "base_singlechannel": cfg.vit_base_singlechannel,
                "large": cfg.vit_large, "huge": cfg.vit_huge}


def get_args(argv=None):
    p = argparse.ArgumentParser("ecamp_tpu_torch export")
    p.add_argument("--task", required=True,
                   choices=["pretrain", "classification", "segmentation",
                            "detection"])
    p.add_argument("--checkpoint", required=True,
                   help="a .pth of the port (a pretraining "
                        "checkpoint-<epoch>.pth, or a fine-tune CLI's best "
                        ".pth)")
    p.add_argument("--output", required=True, help="target .pth path")
    p.add_argument("--num_classes", type=int, default=14)
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--expansion", type=int, default=4)
    p.add_argument("--epoch", type=int, default=None)
    p.add_argument("--model", default="base", choices=sorted(_VIT_FACTORY),
                   help="ViT trunk size; must match the checkpoint")
    return p.parse_args(argv)


def build_model(args) -> nn.Module:
    """The task's model at the sizes of `args` (the JAX CLI's template),
    on the CPU in fp32."""
    vit_factory = _VIT_FACTORY[args.model]
    if args.task == "pretrain":
        from ..nn.mae import ECAMP

        return ECAMP(vit=vit_factory(), decoder=cfg.MAEDecoderConfig(),
                     bert=cfg.BertConfig())
    vcfg = vit_factory(img_size=args.img_size)
    if args.task == "classification":
        from ..nn import ViTClassifier

        return ViTClassifier(vcfg, args.num_classes)
    if args.task == "segmentation":
        from ..nn import SegViT

        return SegViT(vcfg)
    from ..nn import DetectionModel

    return DetectionModel(vcfg, num_classes=args.num_classes,
                          expansion=args.expansion)


def export(args) -> Dict[str, Any]:
    """Load `args.checkpoint` into the task's model strictly and write
    `args.output`; returns what was written."""
    from ..ckpt import load_reference_pth, load_reference_state, pretrain_state
    from ..serve.loaders import _check_pth

    _check_pth(args.checkpoint)
    model = build_model(args)
    if args.task == "pretrain":
        load_reference_state(model, pretrain_state(args.checkpoint))
    else:
        load_reference_state(model, load_reference_pth(args.checkpoint))
    state = {k: v.detach().to("cpu", torch.float32).contiguous()
             for k, v in model.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    if args.task != "pretrain":
        torch.save(state, args.output)
        return state
    out: Dict[str, Any] = {"model": state}
    epoch = args.epoch
    if epoch is None:
        ckpt = torch.load(args.checkpoint, map_location="cpu",
                          weights_only=True)
        epoch = ckpt.get("epoch") if isinstance(ckpt, dict) else None
    if epoch is not None:
        out["epoch"] = int(epoch)
    torch.save(out, args.output)
    return out


def main(argv=None):
    args = get_args(argv)
    export(args)
    print(f"exported {args.task} weights to {args.output}")


if __name__ == "__main__":
    main()
