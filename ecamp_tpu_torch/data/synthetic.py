"""Seeded corpora on disk, for tests and smoke runs where no MIMIC-CXR or
ChestX-ray14 data are at hand.

`write_mimic_corpus` writes the layout `PretrainReportDataset` reads: gray
PNG images, the report CSV (img_path, report, llm_output), the SR-window
CSV (label_i, label_j) and a copy of the WordPiece vocabulary. Reports are
sentences of whole words of that vocabulary, with the reference's entity
words and its "there is no (evidence of)" templates among them, so entity
masking and template weighting both act.

`write_classification_corpus` writes the layout `ClassificationListDataset`
reads: gray JPEGs and `<task>/{train,val,test}_list.txt`, each line an
image path and its label columns.

`write_segmentation_corpus` writes what the SIIM, RSNA or RIGA
segmentation dataset reads, in the shipped lists' columns and path layout:
`<task>/{train,val,test}_list.csv` and the images (and RIGA's masks) they
name. Each lesion brightens the image where its mask lies, so a model can
learn the masks.

`write_detection_corpus` writes what the RSNA or ObjectCXR detection
dataset reads: RSNA gray PNGs with `image_path,bbox` lists (xyxy boxes in
image pixels, "[[0.0, 0.0, 0.0, 0.0]]" for a negative), ObjectCXR JPEGs
under `resize/` with one `<name>.npy` label array each and
`image_name` lists. Each box brightens the image inside it.

`detection_batch` makes the same kind of batch on the device, for step
profiles and smoke runs: u8 gray images with 1-3 seeded boxes each and
their zero-padded targets.
"""

from __future__ import annotations

import csv
import json
import os
import random
import shutil

import numpy as np
import torch
from PIL import Image

from .datasets import REPORTS_CSV, VOCAB_JSON, WINDOWS_CSV
from .entity_masking import ENTITIES

_TEMPLATES = ("there is no evidence of", "there is no")


def _sentence(rng: random.Random, words, entities) -> str:
    body = [rng.choice(words) for _ in range(rng.randint(4, 12))]
    if entities and rng.random() < 0.7:
        body.insert(rng.randint(0, len(body)), rng.choice(entities))
    if rng.random() < 0.3:
        body = rng.choice(_TEMPLATES).split() + body
    return " ".join(body)


def write_mimic_corpus(root: str, vocab_json: str, n_images: int,
                       img_size: int, max_window_start: int,
                       seed: int = 0) -> str:
    """Write `n_images` samples under `root` (created); returns `root`.
    SR-window starts are drawn from [0, max_window_start]."""
    os.makedirs(root, exist_ok=True)
    shutil.copyfile(vocab_json, os.path.join(root, VOCAB_JSON))
    with open(vocab_json, encoding="utf-8") as f:
        vocab = json.load(f)["model"]["vocab"]
    words = sorted(w for w in vocab if w.isalpha() and w.islower())
    entities = sorted(e for e in ENTITIES if e in vocab)
    rng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:img_size, 0:img_size] / img_size
    reports, windows = [], []
    for i in range(n_images):
        # a smooth gray field plus noise, a stand-in for a chest film
        fx, fy = nrng.uniform(2, 8, 2)
        img = 128 + 60 * np.sin(fx * xx + fy * yy) + nrng.normal(
            0, 20, (img_size, img_size))
        path = os.path.join(root, f"img_{i:05d}.png")
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8), "L").save(path)
        report = ". ".join(_sentence(rng, words, entities)
                           for _ in range(rng.randint(3, 10))) + "."
        llm = _sentence(rng, words, entities) + "."
        reports.append({"img_path": path, "report": report,
                        "llm_output": llm})
        windows.append({"label_i": rng.randint(0, max_window_start),
                        "label_j": rng.randint(0, max_window_start)})
    for name, rows in ((REPORTS_CSV, reports), (WINDOWS_CSV, windows)):
        with open(os.path.join(root, name), "w", newline="",
                  encoding="utf-8") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0]))
            writer.writeheader()
            writer.writerows(rows)
    return root


def write_classification_corpus(root: str, task: str, n_train: int,
                                n_val: int, n_test: int, seed: int = 0,
                                num_classes: int = 14,
                                multilabel: bool = True,
                                img_size: int = 256) -> str:
    """Write gray JPEGs under `root/images` and the three list files under
    `root/<task>`; returns `root`. A multilabel task gets `num_classes`
    0/1 columns (each finding present with probability 0.3), a single-label
    task a one-hot row. Each present class brightens a patch of its own,
    so a model can learn the labels."""
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, task), exist_ok=True)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:img_size, 0:img_size] / img_size
    side = int(np.ceil(np.sqrt(num_classes)))
    cell = img_size // side
    i = 0
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        lines = []
        for _ in range(n):
            if multilabel:
                label = (rng.random(num_classes) < 0.3).astype(np.int64)
            else:
                label = np.eye(num_classes, dtype=np.int64)[
                    rng.integers(num_classes)]
            fx, fy = rng.uniform(2, 8, 2)
            img = 110 + 40 * np.sin(fx * xx + fy * yy) + rng.normal(
                0, 15, (img_size, img_size))
            for c in np.flatnonzero(label):
                r, q = divmod(int(c), side)
                img[r * cell:(r + 1) * cell, q * cell:(q + 1) * cell] += 60
            name = f"images/{split}_{i:05d}.jpg"
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8), "L").save(
                os.path.join(root, name), "JPEG", quality=90)
            lines.append(" ".join([name] + [str(v) for v in label]))
            i += 1
        with open(os.path.join(root, task, f"{split}_list.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return root


def mask2rle(mask: np.ndarray) -> str:
    """SIIM run-length encoding of a (1024, 1024) binary mask, the inverse
    of `datasets.rle2mask`: runs over the column-major pixels, each start
    counted from the end of the previous run."""
    flat = np.concatenate([[0], mask.T.ravel().astype(np.int8), [0]])
    edges = np.flatnonzero(np.diff(flat))
    starts, ends = edges[0::2], edges[1::2]
    out, pos = [], 0
    for a, b in zip(starts, ends):
        out += [str(a - pos), str(b - a)]
        pos = b
    return " ".join(out)


def _ellipse(h: int, w: int, cy: float, cx: float, ry: float,
             rx: float) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    return ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0


def _film(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A smooth gray field plus noise, a stand-in for a chest film."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    fx, fy = rng.uniform(2, 8, 2)
    return 100 + 40 * np.sin(fx * xx + fy * yy) + rng.normal(0, 12, (h, w))


def _save_gray(path: str, img: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8), "L").save(path)


def write_segmentation_corpus(root: str, task: str, n_train: int,
                              n_val: int, n_test: int, seed: int = 0,
                              img_size: int = 512,
                              positive_rate: float = 0.5) -> str:
    """Write a seeded SIIM, RSNA or RIGA corpus under `root`; returns
    `root`. SIIM: `train/images/1024/dicom/<ImageId>.png` at `img_size`,
    masks as RLE at 1024 (`ImageId,EncodedPixels`, "-1" for none; one in
    four positives has a second lesion on a second row). RSNA:
    `train_images/<id>.png` and `bbox` lists of xyxy boxes at 1024
    ("[[0.0, 0.0, 0.0, 0.0]]" for none). RIGA: colour images under
    `Image/` and masks under `FinalLabel/` (0 background, 128 disc, 255
    cup) at `img_size` x 4/3 `img_size`. Each split holds at least one
    positive."""
    if task not in ("SIIM", "RSNA", "RIGA"):
        raise ValueError(f"unknown segmentation task {task!r}")
    os.makedirs(os.path.join(root, task), exist_ok=True)
    rng = np.random.default_rng(seed)
    k = img_size / 1024.0  # image pixels per mask pixel (SIIM, RSNA)
    i = 0
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        rows = []
        for j in range(n):
            positive = j == 0 or rng.random() < positive_rate
            if task == "SIIM":
                image_id = f"1.2.276.0.7230010.3.1.4.8323329.{seed}.{i}"
                img = _film(rng, img_size, img_size)
                blobs = []
                for _ in range((1 + (rng.random() < 0.25)) if positive
                               else 0):
                    cy, cx = rng.uniform(200, 824, 2)
                    ry, rx = rng.uniform(40, 160, 2)
                    blobs.append(_ellipse(1024, 1024, cy, cx, ry, rx))
                    img[_ellipse(img_size, img_size, cy * k, cx * k,
                                 ry * k, rx * k)] += 70
                _save_gray(os.path.join(root, "train/images/1024/dicom",
                                        image_id + ".png"), img)
                rows += ([{"ImageId": image_id,
                           "EncodedPixels": mask2rle(b)} for b in blobs]
                         or [{"ImageId": image_id, "EncodedPixels": "-1"}])
            elif task == "RSNA":
                name = f"train_images/{seed:04d}-{i:06d}.png"
                img = _film(rng, img_size, img_size)
                boxes = []
                for _ in range(int(rng.integers(1, 3)) if positive else 0):
                    x1, y1 = rng.uniform(100, 700, 2).round()
                    x2, y2 = x1 + rng.uniform(80, 300), y1 + rng.uniform(
                        80, 300)
                    x2, y2 = float(round(x2)), float(round(y2))
                    boxes.append([float(x1), float(y1), x2, y2])
                    img[int(y1 * k):int(y2 * k),
                        int(x1 * k):int(x2 * k)] += 70
                _save_gray(os.path.join(root, name), img)
                rows.append({"image_path": name,
                             "bbox": str(boxes or [[0.0, 0.0, 0.0, 0.0]])})
            else:
                h, w = img_size, img_size * 4 // 3
                sub = ("MESSIDOR", "BinRushed/BinRushed1", "Magrabia")[i % 3]
                img = np.stack([_film(rng, h, w) + off
                                for off in (40, 0, -30)], axis=-1)
                mask = np.zeros((h, w), np.float64)
                cy, cx = rng.uniform(0.3 * h, 0.7 * h), rng.uniform(
                    0.3 * w, 0.7 * w)
                r = rng.uniform(0.12, 0.2) * h
                disc = _ellipse(h, w, cy, cx, r, r * rng.uniform(0.8, 1.2))
                mask[disc] = 128
                if positive:
                    mask[_ellipse(h, w, cy, cx, 0.5 * r, 0.5 * r)] = 255
                img[..., 0] += mask * 0.3
                names = [f"{d}/{sub}/image{i}.tif"
                         for d in ("Image", "FinalLabel")]
                for name, arr, mode in ((names[0], img, "RGB"),
                                        (names[1], mask, "L")):
                    path = os.path.join(root, name)
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8),
                                    mode).save(path)
                rows.append({"img_path": names[0], "mask_path": names[1]})
            i += 1
        with open(os.path.join(root, task, f"{split}_list.csv"), "w",
                  newline="", encoding="utf-8") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0]))
            writer.writeheader()
            writer.writerows(rows)
    return root


def write_detection_corpus(root: str, task: str, n_train: int, n_val: int,
                           n_test: int, seed: int = 0,
                           img_size: int = 256) -> str:
    """Write a seeded RSNA or ObjectCXR detection corpus under `root`;
    returns `root`. About 60% of the images are positive; one holds 1-3 boxes whose sides are 12-40%
    of the image. RSNA: `train_images/<id>.png` and
    `RSNA/{train,val,test}_list.csv` (`image_path,bbox`; the dataset's val
    and test read `val_list.csv`). ObjectCXR: `resize/<id>.jpg` with
    `resize/<id>.jpg.npy` ((n, 5) rows [0, cx, cy, w, h] normalised; one
    zero row for a negative) and `ObjectCXR/{train,val,test}_list.csv`
    (`image_name`; the dataset's val and test read `test_list.csv`). Each
    split holds at least one positive."""
    if task not in ("RSNA", "ObjectCXR"):
        raise ValueError(f"unknown detection task {task!r}")
    os.makedirs(os.path.join(root, task), exist_ok=True)
    rng = np.random.default_rng(seed)
    s = img_size
    i = 0
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        rows = []
        for j in range(n):
            positive = j == 0 or rng.random() < 0.6
            img = _film(rng, s, s)
            boxes = []
            for _ in range(int(rng.integers(1, 4)) if positive else 0):
                bw, bh = rng.uniform(0.12, 0.4, 2) * s
                x1 = float(round(rng.uniform(0, s - bw)))
                y1 = float(round(rng.uniform(0, s - bh)))
                x2, y2 = float(round(x1 + bw)), float(round(y1 + bh))
                boxes.append([x1, y1, x2, y2])
                img[int(y1):int(y2), int(x1):int(x2)] += 60
            if task == "RSNA":
                name = f"train_images/{seed:04d}-{i:06d}.png"
                _save_gray(os.path.join(root, name), img)
                rows.append({"image_path": name,
                             "bbox": str(boxes or [[0.0, 0.0, 0.0, 0.0]])})
            else:
                name = f"{seed:04d}{i:06d}.jpg"
                path = os.path.join(root, "resize", name)
                _save_gray(path, img)
                b = np.asarray(boxes, np.float32).reshape(-1, 4)
                labels = np.stack([np.zeros(len(b), np.float32),
                                   (b[:, 0] + b[:, 2]) / 2 / s,
                                   (b[:, 1] + b[:, 3]) / 2 / s,
                                   (b[:, 2] - b[:, 0]) / s,
                                   (b[:, 3] - b[:, 1]) / s], axis=1)
                np.save(path + ".npy",
                        labels if len(b) else np.zeros((1, 5), np.float32))
                rows.append({"image_name": name})
            i += 1
        with open(os.path.join(root, task, f"{split}_list.csv"), "w",
                  newline="", encoding="utf-8") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0]))
            writer.writeheader()
            writer.writerows(rows)
    return root


def detection_batch(b: int, max_objects: int, gen: torch.Generator,
                    img_size: int = 224):
    """A seeded u8 gray batch (b, img_size, img_size, 1) on `gen`'s device,
    with 1-3 boxes an image (sides 10-40% of the image) that brighten the
    image inside them, so a loss can fall; and the targets (b, max_objects,
    5), rows [0, cx, cy, w, h] normalised, zero-padded."""
    dev = gen.device
    n = torch.randint(1, 4, (b, 1), device=dev, generator=gen)
    live = (torch.arange(max_objects, device=dev) < n).float()
    r = torch.rand(b, max_objects, 4, device=dev, generator=gen)
    wh = 0.1 + 0.3 * r[..., 2:]
    c = wh / 2 + (1 - wh) * r[..., :2]
    targets = torch.cat([torch.zeros(b, max_objects, 1, device=dev), c, wh],
                        dim=-1) * live[..., None]
    pix = torch.arange(img_size, device=dev) + 0.5
    yy, xx = torch.meshgrid(pix, pix, indexing="ij")
    img = 100 + 25 * torch.randn(b, img_size, img_size, device=dev,
                                 generator=gen)
    for i in range(3):
        x0, y0 = (c[:, i] - wh[:, i] / 2).mul(img_size).unbind(-1)
        x1, y1 = (c[:, i] + wh[:, i] / 2).mul(img_size).unbind(-1)
        inside = ((xx >= x0[:, None, None]) & (xx < x1[:, None, None])
                  & (yy >= y0[:, None, None]) & (yy < y1[:, None, None]))
        img += 60 * inside * live[:, i, None, None]
    return img.clamp(0, 255).to(torch.uint8)[..., None], targets
