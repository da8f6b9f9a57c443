"""Inference entry point of the port: HTTP serving or offline batch
prediction of the ViT classifier, the SegViT segmenter, the YOLOv3
detector or the ECAMP image embedding on one CUDA card.

  # HTTP server (stdlib, JSON/base64)
  python -m ecamp_tpu_torch.cli.serve --task classification --num_classes 14 \\
      --checkpoint cls.pth --port 8000
  python -m ecamp_tpu_torch.cli.serve --task segmentation [--dual] \\
      --checkpoint seg.pth --port 8000
  python -m ecamp_tpu_torch.cli.serve --task detection [--expansion 8] \\
      --checkpoint det.pth --port 8000
  python -m ecamp_tpu_torch.cli.serve --task embedding \\
      --checkpoint checkpoint-N.pth --port 8000

  # offline batch: folder or list file -> JSONL of predictions
  python -m ecamp_tpu_torch.cli.serve --task classification --num_classes 14 \\
      --checkpoint cls.pth --images /data/imgs --output preds.jsonl

`--quantize int8` serves any task with weight-only int8 (per output
channel; `serve/quantize.py`). `--device cuda` (the default) needs a card
and refuses to start without one; `--device cpu` runs the kernels' plain
PyTorch versions.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def get_args(argv=None):
    p = argparse.ArgumentParser("ecamp_tpu_torch serve/infer")
    p.add_argument("--task", required=True,
                   choices=["classification", "segmentation", "detection",
                            "embedding"])
    p.add_argument("--checkpoint", default="",
                   help="reference classifier, SegViT or detector .pth, "
                        "or a pretraining .pth for the embedding (random "
                        "init if empty)")
    p.add_argument("--dual", action="store_true",
                   help="RIGA dual-decoder segmentation")
    p.add_argument("--num_classes", type=int, default=None,
                   help="14 for classification, 1 (RSNA pneumonia) for "
                        "detection when not given")
    p.add_argument("--expansion", type=int, default=4,
                   help="detection: the neck's Bottleneck expansion (8 for "
                        "a model fine-tuned on the 1%% or 10%% volume)")
    p.add_argument("--conf_threshold", type=float, default=0.5,
                   help="detection: NMS objectness threshold")
    p.add_argument("--nms_threshold", type=float, default=0.5,
                   help="detection: NMS IoU threshold")
    p.add_argument("--multilabel", action="store_true", default=True)
    p.add_argument("--singlelabel", dest="multilabel", action="store_false")
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--mean", type=float, default=0.4722)
    p.add_argument("--std", type=float, default=0.3028)
    p.add_argument("--buckets", type=int, nargs="+", default=None)
    p.add_argument("--quantize", default="", choices=["", "int8"],
                   help="int8: weight-only int8, one scale an output "
                        "channel")
    p.add_argument("--class_names", nargs="+", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; needs a card) or cpu")
    # serve mode
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    # batch mode
    p.add_argument("--images", default="",
                   help="dir of images or a text file of paths; presence "
                        "selects batch mode")
    p.add_argument("--output", default="predictions.jsonl")
    p.add_argument("--batch_size", type=int, default=32)
    return p.parse_args(argv)


def build_engine(args):
    from ..serve import (classifier_engine, detector_engine,
                         embedding_engine, segmenter_engine)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA card is visible; the port "
                         "does not fall back to the CPU (pass --device cpu "
                         "to run the plain PyTorch versions on purpose)")
    kw = {"checkpoint": args.checkpoint, "img_size": args.img_size,
          "device": device, "quantize": args.quantize}
    if args.buckets:
        kw["buckets"] = tuple(args.buckets)
    if args.task == "segmentation":
        return segmenter_engine(dual=args.dual, **kw)
    if args.task == "detection":
        return detector_engine(num_classes=args.num_classes or 1,
                               expansion=args.expansion,
                               conf_threshold=args.conf_threshold,
                               nms_threshold=args.nms_threshold, **kw)
    if args.task == "embedding":
        return embedding_engine(**kw)
    return classifier_engine(num_classes=args.num_classes or 14,
                             multilabel=args.multilabel, **kw)


def iter_paths(spec: str):
    if os.path.isdir(spec):
        exts = (".jpg", ".jpeg", ".png", ".bmp")
        for name in sorted(os.listdir(spec)):
            if name.lower().endswith(exts):
                yield os.path.join(spec, name)
    else:
        with open(spec) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                # reference-style list files append label columns — prefer
                # the full line when it exists on disk, else the first token
                yield line if os.path.exists(line) else line.split()[0]


def batch_predict(args, engine):
    from PIL import Image

    from ..data.transforms import EvalTransform
    from ..serve.http_server import _jsonable, _summarize_mask

    et = EvalTransform(args.img_size, args.mean, args.std)
    paths = list(iter_paths(args.images))
    with open(args.output, "w") as out:
        for i in range(0, len(paths), args.batch_size):
            chunk = paths[i:i + args.batch_size]
            xs = np.stack([et(Image.open(p).convert("RGB")) for p in chunk])
            for path, pred in zip(chunk, engine(xs)):
                if args.task == "segmentation":
                    out.write(json.dumps({"path": path,
                                          **_summarize_mask(pred)}) + "\n")
                    continue
                if args.task == "detection":
                    out.write(json.dumps({"path": path,
                                          "boxes": _jsonable(pred)}) + "\n")
                    continue
                if args.task == "embedding":
                    out.write(json.dumps({"path": path,
                                          "embedding": _jsonable(pred)})
                              + "\n")
                    continue
                rec = {"probs": pred.tolist()}
                if args.class_names:
                    rec["labels"] = {n: float(v) for n, v in
                                     zip(args.class_names, pred)}
                out.write(json.dumps({"path": path, **rec}) + "\n")
    print(f"wrote {len(paths)} predictions to {args.output}")
    print(json.dumps(engine.stats()))


def main(argv=None):
    args = get_args(argv)
    engine = build_engine(args)
    if args.images:
        return batch_predict(args, engine)
    # run every bucket before accepting traffic: the first call builds the
    # kernels and would otherwise stall a request
    print(f"warming {len(engine.buckets)} buckets ...")
    engine.warmup(np.zeros((1, args.img_size, args.img_size, 3), np.float32))
    from ..serve.http_server import PredictionService, serve

    service = PredictionService(engine, img_size=args.img_size,
                                mean=args.mean, std=args.std,
                                class_names=args.class_names, task=args.task)
    serve(service, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
