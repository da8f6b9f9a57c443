"""The pretraining and classification datasets (counterpart of
`ecamp_tpu/data/datasets.py::PretrainReportDataset` and
`ClassificationListDataset`; reference pretrain_datasets.py:34-239 and
Classification/utils/dataset.py), read with the stdlib. Samples are dicts
of numpy arrays."""

from __future__ import annotations

import csv
import os
import random
from typing import Dict, List, Tuple

import numpy as np
from PIL import Image

from .entity_masking import build_text_example
from .tokenizer import WordPieceTokenizer
from .transforms import TrainTransform

REPORTS_CSV = "mimic-cxr-2.0.0-entity-llm.csv"
WINDOWS_CSV = "mimic-cxr-2.0.0-attn-label.csv"
VOCAB_JSON = "mimic_wordpiece.json"


def _columns(path: str, names) -> List[List[str]]:
    with open(path, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    return [[row[n] for row in rows] for n in names]


class PretrainReportDataset:
    """MIMIC-CXR entity-LLM pretraining data.

    `data_root` holds `mimic-cxr-2.0.0-entity-llm.csv` (img_path, report,
    llm_output), `mimic-cxr-2.0.0-attn-label.csv` (label_i, label_j: the SR
    window's column and row) and `mimic_wordpiece.json`. A sample is the
    augmented image (fp32 (S, S, 3) normalized, or u8 (S, S, 1) with
    `output_u8`), the masked ids, labels, attention mask, type ids and
    entity weights of its report, and the window's column and row."""

    def __init__(self, data_root: str, img_size: int = 448,
                 max_caption_length: int = 256, seed: int = 0,
                 output_u8: bool = False):
        self.data_root = data_root
        self.max_caption_length = max_caption_length
        self.images, self.reports, self.llm_outputs = _columns(
            os.path.join(data_root, REPORTS_CSV),
            ("img_path", "report", "llm_output"))
        self.attn_i, self.attn_j = ([int(v) for v in col] for col in _columns(
            os.path.join(data_root, WINDOWS_CSV), ("label_i", "label_j")))
        self.tokenizer = WordPieceTokenizer.from_file(
            os.path.join(data_root, VOCAB_JSON))
        self.transform = TrainTransform(img_size, mean=0.4721, std=0.3037,
                                        scale=(0.2, 1.0),
                                        interpolation="bicubic", seed=seed,
                                        output_u8=output_u8)
        self.rng = random.Random(seed)
        self.seed = seed

    def reseed(self, epoch: int, worker_id: int) -> None:
        """DataLoader worker protocol: the masking and augmentation streams
        of this (epoch, worker), as torch workers reseed each epoch."""
        base = (self.seed * 1_000_003 + epoch) * 1_000_003 + worker_id
        self.rng = random.Random(base)
        self.transform.reseed(epoch, worker_id)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, i) -> Dict[str, np.ndarray]:
        image = self.transform.load(self.images[i])
        text = build_text_example(self.reports[i], self.llm_outputs[i],
                                  self.tokenizer, self.rng,
                                  self.max_caption_length)
        if image.dtype != np.uint8:
            image = image.astype(np.float32)
        return dict(text, image=image, column=np.int32(self.attn_i[i]),
                    row=np.int32(self.attn_j[i]))


class ClassificationListDataset:
    """XRAY list-file dataset. Split files live under
    <list_root>/<task>/{train_list[_1|_10],val_list,test_list}.txt, one
    sample a line: an image path relative to `image_root`, then its
    integer label columns (multi-hot, or one class id)."""

    def __init__(self, list_root: str, image_root: str, task: str,
                 split: str = "train", data_volume: str = "100",
                 transform=None):
        names = {"train": {"1": "train_list_1.txt", "10": "train_list_10.txt",
                           "100": "train_list.txt"}[data_volume],
                 "val": "val_list.txt", "test": "test_list.txt"}
        path = os.path.join(list_root, task, names[split])
        self.samples: List[Tuple[str, np.ndarray]] = []
        with open(path) as f:
            for line in f:
                items = line.split()
                if items:
                    self.samples.append(
                        (os.path.join(image_root, items[0]),
                         np.asarray([int(v) for v in items[1:]], np.float32)))
        self.transform = transform

    def reseed(self, epoch: int, worker_id: int) -> None:
        """DataLoader worker protocol: the only stateful RNG here is the
        train transform's crop/flip stream."""
        if hasattr(self.transform, "reseed"):
            self.transform.reseed(epoch, worker_id)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i) -> Dict[str, np.ndarray]:
        path, label = self.samples[i]
        with open(path, "rb") as f:
            img = Image.open(f).convert("RGB")
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = np.asarray(img, np.float32) / 255.0
        if img.dtype != np.uint8:  # the u8 pipe keeps its wire dtype
            img = img.astype(np.float32)
        return {"image": img, "label": label}
