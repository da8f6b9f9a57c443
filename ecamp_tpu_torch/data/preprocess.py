"""One-time image preprocessing (counterpart of
`ecamp_tpu/data/preprocess.py`): re-encode the source tree at a bounded
resolution, so decoding full-resolution JPEGs does not hold the training
feeder back. The reference decodes full-resolution JPEGs in 16 DataLoader
workers per GPU (pretrain_datasets.py:27-31,113-115); pre-resizing is the
standard fix. PIL and a process pool only.

Fidelity: every RandomResizedCrop output is 448x448 from a crop of scale
>= 0.2 of the area; from a 1024-bounded source the smallest crop is
~458 px wide, so the resize never upsamples (>= 1 source px per output px).

Usage:
    python -m ecamp_tpu_torch.data.preprocess --src /data/mimic-cxr-jpg \
        --dst /data/mimic-cxr-1024 [--max_side 1024] [--quality 95] \
        [--workers N]
Then point --data_path at a CSV whose img_path entries live under dst
(paths are mirrored). Files already under dst are skipped, so a cut run
resumes where it stopped.
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Tuple

from PIL import Image

IMG_EXTS = (".jpg", ".jpeg", ".png")


def preprocess_one(args: Tuple[str, str, int, int]) -> bool:
    src, dst, max_side, quality = args
    try:
        with open(src, "rb") as f:
            img = Image.open(f)
            w, h = img.size
            if max(w, h) > max_side and img.format == "JPEG":
                # draft gets libjpeg to do most of the shrink in DCT space
                img.draft(img.mode, (max(1, w // 2), max(1, h // 2)))
            if img.mode not in ("L", "RGB"):
                img = img.convert("RGB")
            img.thumbnail((max_side, max_side), Image.BICUBIC)
            img.load()
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        img.save(dst, "JPEG", quality=quality)
        return True
    except Exception as e:  # unreadable file: report, keep going
        print(f"skip {src}: {e}")
        return False


def preprocess_tree(src_root: str, dst_root: str, max_side: int = 1024,
                    quality: int = 95, workers: int = 0) -> Tuple[int, int]:
    """Mirror src_root under dst_root with every image bounded to
    max_side. Returns (converted, failed)."""
    jobs = []
    for dirpath, _, files in os.walk(src_root):
        for fn in files:
            if not fn.lower().endswith(IMG_EXTS):
                continue
            src = os.path.join(dirpath, fn)
            rel = os.path.relpath(src, src_root)
            dst = os.path.join(dst_root, os.path.splitext(rel)[0] + ".jpg")
            if not os.path.exists(dst):
                jobs.append((src, dst, max_side, quality))
    workers = workers or os.cpu_count() or 1
    if workers == 1:
        results = [preprocess_one(j) for j in jobs]
    else:
        with ProcessPoolExecutor(workers) as pool:
            results = list(pool.map(preprocess_one, jobs, chunksize=16))
    ok = sum(results)
    return ok, len(results) - ok


def main(argv=None):
    p = argparse.ArgumentParser("ecamp_tpu_torch image preprocessing")
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--max_side", type=int, default=1024)
    p.add_argument("--quality", type=int, default=95)
    p.add_argument("--workers", type=int, default=0,
                   help="process pool size (0 = all cores)")
    args = p.parse_args(argv)
    ok, failed = preprocess_tree(args.src, args.dst, args.max_side,
                                 args.quality, args.workers)
    print(f"converted {ok} images ({failed} failed) -> {args.dst}")


if __name__ == "__main__":
    main()
