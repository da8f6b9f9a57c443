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
"""

from __future__ import annotations

import csv
import json
import os
import random
import shutil

import numpy as np
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
