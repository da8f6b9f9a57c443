"""The pretraining, classification, segmentation and detection datasets
(counterpart of `ecamp_tpu/data/datasets.py`; reference
pretrain_datasets.py:34-239, Classification/utils/dataset.py,
Segmentation/utils/my_dataset.py and Detection/utils/my_dataset.py), read
with the stdlib `csv` module. Samples are dicts of numpy arrays.

The segmentation geometry is the JAX package's, without OpenCV: its
INTER_AREA and INTER_LINEAR resizes of float32 arrays are written here in
numpy as separable taps with OpenCV's coefficients (`_resize_taps`), and
the augmentation is the same PIL affine warp."""

from __future__ import annotations

import ast
import csv
import math
import os
import random
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from .entity_masking import build_text_example
from .tokenizer import WordPieceTokenizer
from .transforms import TrainTransform, normalize

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


# ---------------------------------------------------------------------------
# segmentation geometry (ecamp_tpu/data/datasets.py:44-170)


def _pil_load_rgb(path: str) -> Image.Image:
    with open(path, "rb") as f:
        return Image.open(f).convert("RGB")


def _resize_taps(src: int, dst: int, method: str, shrink: bool
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's 1-D resize coefficients for float32 images as (dst, K) tap
    indices and float32 weights. 'linear' is INTER_LINEAR: the
    half-pixel-centre source coordinate, clamped at both edges, two taps.
    'area' is INTER_AREA: when the image shrinks along both axes
    (`shrink`), each output averages the source cells it covers, partial
    cells by their covered fraction (`computeResizeAreaTab`); otherwise
    OpenCV's area-mode two-tap coefficients on both axes."""
    scale = src / dst
    taps: List[List[Tuple[int, float]]] = []
    for d in range(dst):
        if method == "area" and shrink:
            f1 = d * scale
            f2 = f1 + scale
            cell = min(scale, src - f1)
            s2 = min(int(math.floor(f2)), src - 1)
            s1 = min(int(math.ceil(f1)), s2)
            row = []
            if s1 - f1 > 1e-3:
                row.append((s1 - 1, (s1 - f1) / cell))
            row += [(i, 1.0 / cell) for i in range(s1, s2)]
            if f2 - s2 > 1e-3:
                row.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        else:
            if method == "area":
                sx = int(math.floor(d * scale))
                fx = (d + 1) - (sx + 1) / scale
                fx = 0.0 if fx <= 0 else fx - math.floor(fx)
            elif method == "linear":
                fx = (d + 0.5) * scale - 0.5
                sx = int(math.floor(fx))
                fx -= sx
            else:
                raise ValueError(f"unknown resize method {method}")
            if sx < 0:
                fx, sx = 0.0, 0
            if sx >= src - 1:
                fx, sx = 0.0, src - 1
            row = [(sx, 1.0 - fx), (min(sx + 1, src - 1), fx)]
        taps.append(row)
    k = max(len(r) for r in taps)
    idx = np.zeros((dst, k), np.int64)
    wts = np.zeros((dst, k), np.float32)
    for d, row in enumerate(taps):
        for j, (i, w) in enumerate(row):
            idx[d, j], wts[d, j] = i, w
    return idx, wts


def _resize_axis(arr: np.ndarray, axis: int, dst: int, method: str,
                 shrink: bool) -> np.ndarray:
    idx, wts = _resize_taps(arr.shape[axis], dst, method, shrink)
    g = np.take(arr, idx, axis=axis)  # axis -> (dst, K)
    shape = [1] * g.ndim
    shape[axis], shape[axis + 1] = wts.shape
    return (g * wts.reshape(shape)).sum(axis=axis + 1, dtype=np.float32)


def _cv_resize(arr: np.ndarray, width: int, height: int,
               method: str) -> np.ndarray:
    """cv2.resize(arr.astype(float32), (width, height), INTER_AREA or
    INTER_LINEAR) of an (H, W) or (H, W, C) array: columns first, then
    rows, in float32."""
    h, w = arr.shape[:2]
    shrink = h >= height and w >= width
    out = _resize_axis(arr.astype(np.float32), 1, width, method, shrink)
    return _resize_axis(out, 0, height, method, shrink)


def resize_pad_square(arr: np.ndarray, scale: int) -> np.ndarray:
    """Aspect-preserving resize (area interpolation) + zero-pad to square
    (Segmentation/utils/my_dataset.py:16-62)."""
    h, w = arr.shape[:2]
    if h >= w:
        nh, nw = scale, int(w * scale / float(h))
    else:
        nw, nh = scale, int(h * scale / float(w))
    resized = _cv_resize(arr, nw, nh, "area")
    pad_h = scale - nh
    pad_w = scale - nw
    return np.pad(resized,
                  [(pad_h // 2, pad_h - pad_h // 2),
                   (pad_w // 2, pad_w - pad_w // 2)] +
                  [(0, 0)] * (arr.ndim - 2), constant_values=0)


def _resize_img_linear(arr: np.ndarray, size: int) -> np.ndarray:
    return _cv_resize(arr, size, size, "linear")


def _reseed_rng(self, epoch: int, worker_id: int) -> None:
    """DataLoader worker protocol: rebind `self.rng` to a per-(epoch,
    worker)-deterministic stream, so augmentation draws do not depend on
    worker scheduling (the derivation of `PretrainReportDataset.reseed`)."""
    base = (self.seed * 1_000_003 + epoch) * 1_000_003 + worker_id
    self.rng = random.Random(base)


def shift_scale_rotate(img: np.ndarray, mask: Optional[np.ndarray],
                       rng: random.Random, scale_limit: float = 0.1,
                       rotate_limit: float = 10.0, p: float = 0.5
                       ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """albumentations ShiftScaleRotate(shift=0) equivalent: random scale in
    [1-s, 1+s] + rotation about center, constant border."""
    if rng.random() >= p:
        return img, mask
    angle = rng.uniform(-rotate_limit, rotate_limit)
    scale = 1.0 + rng.uniform(-scale_limit, scale_limit)
    theta = math.radians(angle)

    def apply(arr, is_mask):
        h, w = arr.shape[:2]
        cx, cy = w / 2.0, h / 2.0
        cos_t, sin_t = math.cos(theta), math.sin(theta)
        # output->input affine (inverse of scale+rotate about center)
        a = cos_t / scale
        b = sin_t / scale
        c = cx - a * cx - b * cy
        d = -sin_t / scale
        e = cos_t / scale
        f = cy - d * cx - e * cy
        mode = Image.NEAREST if is_mask else Image.BILINEAR
        if arr.ndim == 2:
            pil = Image.fromarray(arr.astype(np.float32), mode="F")
            out = pil.transform((w, h), Image.AFFINE, (a, b, c, d, e, f), mode)
            return np.asarray(out)
        chans = [Image.fromarray(arr[..., i].astype(np.float32), mode="F")
                 .transform((w, h), Image.AFFINE, (a, b, c, d, e, f), mode)
                 for i in range(arr.shape[-1])]
        return np.stack([np.asarray(ch) for ch in chans], axis=-1)

    img = apply(img, False)
    if mask is not None:
        mask = apply(mask, True)
    return img, mask


def _finish_image(img: np.ndarray, mean: float, std: float,
                  output_u8: bool, gray: bool = True) -> np.ndarray:
    """The last host step of the segmentation and detection pipelines:
    normalize
    (albumentations semantics), or with `output_u8` quantize the
    interpolated f32 image to u8 for the device to normalize
    (`ops/image_ops.py::device_normalize_image`): a <= 0.5/255 rounding
    before normalization. gray=True ships one channel of the x-ray's three
    identical ones; RIGA's colour fundus photographs keep three."""
    if not output_u8:
        return normalize(img, mean, std).astype(np.float32)
    q = np.clip(np.rint(img), 0.0, 255.0).astype(np.uint8)
    return q[..., :1] if gray else q


def rle2mask(rle: str, width: int, height: int) -> np.ndarray:
    """SIIM run-length decode (my_dataset.py:151-164, incl. its
    transpose/orientation convention)."""
    mask = np.zeros(width * height)
    array = np.asarray([int(x) for x in rle.split()])
    starts = array[0::2]
    lengths = array[1::2]
    pos = 0
    for start, length in zip(starts, lengths):
        pos += start
        mask[pos:pos + length] = 1
        pos += length
    return mask.reshape(width, height).T


def _seg_list(list_root: str, task: str, split: str,
              data_volume: str) -> List[Dict[str, str]]:
    names = {"train": {"1": "train_list_1.csv", "10": "train_list_10.csv",
                       "100": "train_list.csv"}[data_volume],
             "val": "val_list.csv", "test": "test_list.csv"}
    with open(os.path.join(list_root, task, names[split]), newline="",
              encoding="utf-8") as f:
        return list(csv.DictReader(f))


class _SegDataset:
    """Shared state of the three segmentation datasets."""

    def __init__(self, split: str, img_size: int, mean: float, std: float,
                 seed: int, output_u8: bool):
        self.split = split
        self.img_size = img_size
        self.mean, self.std = mean, std
        self.output_u8 = output_u8
        self.seed = seed
        self.rng = random.Random(seed)

    reseed = _reseed_rng


class SIIMSegmentationDataset(_SegDataset):
    """SIIM-ACR pneumothorax (my_dataset.py:65-194): RLE masks at 1024,
    positive/negative balancing for train, ShiftScaleRotate of the image
    only, resize + normalize.

    The training split keeps every positive image and as many negatives,
    drawn by `np.random.default_rng(seed).choice` from the unique negative
    ids in file order; `img_ids` lists the positives in file order, then
    the chosen negatives in file order, as the JAX package's pandas
    frames do. A row is positive when its EncodedPixels is not "-1"."""

    def __init__(self, list_root: str, image_root: str, split: str,
                 img_size: int = 224, data_volume: str = "100",
                 mean: float = 0.4722, std: float = 0.3028, seed: int = 0,
                 output_u8: bool = False):
        super().__init__(split, img_size, mean, std, seed, output_u8)
        rows = [(r["ImageId"], r["EncodedPixels"])
                for r in _seg_list(list_root, "SIIM", split, data_volume)]
        if split == "train":
            pos = [r for r in rows if r[1] != "-1"]
            neg = [r for r in rows if r[1] == "-1"]
            n_pos = len(dict.fromkeys(i for i, _ in pos))
            neg_ids = list(dict.fromkeys(i for i, _ in neg))
            chosen = set(np.random.default_rng(seed).choice(
                np.asarray(neg_ids, dtype=object),
                size=min(n_pos, len(neg_ids)), replace=False).tolist())
            rows = pos + [r for r in neg if r[0] in chosen]
        self.groups: Dict[str, List[str]] = OrderedDict()
        for image_id, rle in rows:
            self.groups.setdefault(image_id, []).append(rle)
        self.img_ids = list(self.groups)
        self.image_root = image_root

    def image_path(self, image_id: str) -> str:
        return os.path.join(self.image_root,
                            "train/images/1024/dicom/" + image_id + ".png")

    def __len__(self) -> int:
        return len(self.img_ids)

    def __getitem__(self, i) -> Dict[str, np.ndarray]:
        image_id = self.img_ids[i]
        img = np.asarray(_pil_load_rgb(self.image_path(image_id)),
                         np.float32)
        rles = self.groups[image_id]
        mask = np.zeros([1024, 1024], np.float32)
        if rles[0] != "-1":
            for rle in rles:
                mask += rle2mask(rle, 1024, 1024)
        mask = (mask >= 1).astype(np.float32)
        mask = resize_pad_square(mask, self.img_size)
        if self.split == "train":
            img, _ = shift_scale_rotate(img, None, self.rng)
        img = _resize_img_linear(img, self.img_size)
        img = _finish_image(img, self.mean, self.std, self.output_u8)
        return {"image": img, "mask": mask[..., None].astype(np.float32)}


class RSNASegmentationDataset(_SegDataset):
    """RSNA pneumonia as segmentation (my_dataset.py:196-292): boxes
    rasterized at 1024, the mask bilinear-resized with the image (unlike
    SIIM: albumentations Resize gives fractional edge values, kept)."""

    def __init__(self, list_root: str, image_root: str, split: str,
                 img_size: int = 224, data_volume: str = "100",
                 mean: float = 0.4722, std: float = 0.3028, seed: int = 0,
                 output_u8: bool = False):
        super().__init__(split, img_size, mean, std, seed, output_u8)
        rows = _seg_list(list_root, "RSNA", split, data_volume)
        self.img_paths = [os.path.join(image_root, r["image_path"])
                          for r in rows]
        self.bboxes = [r["bbox"] for r in rows]

    def __len__(self) -> int:
        return len(self.img_paths)

    def __getitem__(self, i) -> Dict[str, np.ndarray]:
        img = np.asarray(_pil_load_rgb(self.img_paths[i]), np.float32)
        mask = np.zeros((1024, 1024), np.float32)
        bbox = np.asarray(ast.literal_eval(self.bboxes[i]))
        valid = bbox[bbox[:, 3] > 0].astype(np.int64)
        for b in valid:
            mask[b[1]:b[3], b[0]:b[2]] += 1
        mask = (mask >= 1).astype(np.float32)
        if self.split == "train":
            img, mask = shift_scale_rotate(img, mask, self.rng)
        img = _resize_img_linear(img, self.img_size)
        mask = _resize_img_linear(mask, self.img_size)
        img = _finish_image(img, self.mean, self.std, self.output_u8)
        return {"image": img, "mask": mask[..., None].astype(np.float32)}


class RIGASegmentationDataset(_SegDataset):
    """RIGA disc/cup (my_dataset.py:294-397): mask png -> disc = (m != 0),
    cup = (m == 1) channels; pad-resize mask; image bilinear resize; the
    colour image keeps its three channels."""

    def __init__(self, list_root: str, image_root: str, split: str,
                 img_size: int = 224, data_volume: str = "100",
                 mean: float = 0.4722, std: float = 0.3028, seed: int = 0,
                 output_u8: bool = False):
        super().__init__(split, img_size, mean, std, seed, output_u8)
        rows = _seg_list(list_root, "RIGA", split, data_volume)
        self.img_paths = [os.path.join(image_root, r["img_path"])
                          for r in rows]
        self.mask_paths = [os.path.join(image_root, r["mask_path"])
                           for r in rows]

    def __len__(self) -> int:
        return len(self.img_paths)

    def __getitem__(self, i) -> Dict[str, np.ndarray]:
        img = np.asarray(_pil_load_rgb(self.img_paths[i]), np.float32)
        with open(self.mask_paths[i], "rb") as f:
            mask = np.asarray(Image.open(f).convert("L"), np.float32)
        mask = resize_pad_square(mask, self.img_size)
        if mask.max() > 1:
            mask = mask / 255.0
        disc = (mask != 0).astype(np.float32)
        cup = np.where(mask == 1, mask, 0).astype(np.float32)
        stacked = np.stack([disc, cup], axis=-1)  # (H, W, 2)
        if self.split == "train":
            img, stacked = shift_scale_rotate(img, stacked, self.rng)
        img = _resize_img_linear(img, self.img_size)
        img = _finish_image(img, self.mean, self.std, self.output_u8,
                            gray=False)
        return {"image": img, "mask": stacked.astype(np.float32)}


# ---------------------------------------------------------------------------
# detection


def _det_list(list_root: str, task: str, names: Dict[str, str], split: str,
              data_volume: str) -> str:
    name = (names["train"][data_volume] if split == "train"
            else names[split])
    return os.path.join(list_root, task, name)


class ObjectCXRDetectionDataset:
    """Object-CXR foreign-object detection
    (Detection/utils/my_dataset.py:106-209): a CSV of image names under
    `<image_root>/resize/`, sorted by name, with a precomputed label array
    `<name>.npy` per image (rows [cls, cx, cy, w, h] normalised), padded
    to `max_objects` rows; the image bilinear-resized and normalised.
    Validation and test both read `test_list.csv`."""

    LISTS = {"train": {"1": "train_list_1.csv", "10": "train_list_10.csv",
                       "100": "train_list.csv"},
             "val": "test_list.csv", "test": "test_list.csv"}

    def __init__(self, list_root: str, image_root: str, split: str,
                 img_size: int = 224, data_volume: str = "100",
                 max_objects: int = 20, mean: float = 0.4722,
                 std: float = 0.3028, output_u8: bool = False):
        (names,) = _columns(_det_list(list_root, "ObjectCXR", self.LISTS,
                                      split, data_volume), ("image_name",))
        self.image_dir = os.path.join(image_root, "resize")
        self.names = sorted(names)
        self.img_size = img_size
        self.max_objects = max_objects
        self.mean, self.std = mean, std
        self.output_u8 = output_u8

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, i) -> Dict[str, np.ndarray]:
        name = self.names[i]
        img = np.asarray(_pil_load_rgb(os.path.join(self.image_dir, name)),
                         np.float32)
        img = _resize_img_linear(img, self.img_size)
        img = _finish_image(img, self.mean, self.std, self.output_u8)
        y = np.load(os.path.join(self.image_dir, name + ".npy"))
        out = np.zeros((self.max_objects, 5), np.float32)
        n = min(len(y), self.max_objects)
        out[:n] = y[:n, :5]
        return {"image": img, "target": out}


class RSNADetectionDataset:
    """RSNA pneumonia detection (Detection/utils/my_dataset.py:18-102):
    the CSV's xyxy boxes in image pixels -> normalised [cls = 0, cx, cy,
    w, h] rows padded to `max_objects` (a negative's "[[0.0, 0.0, 0.0,
    0.0]]" becomes a padding row); the image bilinear-resized and
    normalised. Validation and test both read `val_list.csv`."""

    LISTS = {"train": {"1": "train_list_1.csv", "10": "train_list_10.csv",
                       "100": "train_list.csv"},
             "val": "val_list.csv", "test": "val_list.csv"}

    def __init__(self, list_root: str, image_root: str, split: str,
                 img_size: int = 224, data_volume: str = "100",
                 max_objects: int = 10, mean: float = 0.4722,
                 std: float = 0.3028, output_u8: bool = False):
        paths, self.raw_bboxes = _columns(
            _det_list(list_root, "RSNA", self.LISTS, split, data_volume),
            ("image_path", "bbox"))
        self.img_paths = [os.path.join(image_root, p) for p in paths]
        self.img_size = img_size
        self.max_objects = max_objects
        self.mean, self.std = mean, std
        self.output_u8 = output_u8

    def __len__(self) -> int:
        return len(self.img_paths)

    def __getitem__(self, i) -> Dict[str, np.ndarray]:
        img = np.asarray(_pil_load_rgb(self.img_paths[i]), np.float32)
        h, w = img.shape[:2]
        img = _resize_img_linear(img, self.img_size)
        img = _finish_image(img, self.mean, self.std, self.output_u8)

        bbox = np.asarray(ast.literal_eval(self.raw_bboxes[i]), np.float32)
        out = np.zeros((self.max_objects, 5), np.float32)
        n = min(len(bbox), self.max_objects)
        if n > 0:
            cx = (bbox[:n, 0] + bbox[:n, 2]) / 2.0 / w
            cy = (bbox[:n, 1] + bbox[:n, 3]) / 2.0 / h
            bw = (bbox[:n, 2] - bbox[:n, 0]) / w
            bh = (bbox[:n, 3] - bbox[:n, 1]) / h
            out[:n, 1], out[:n, 2], out[:n, 3], out[:n, 4] = cx, cy, bw, bh
        return {"image": img, "target": out}
