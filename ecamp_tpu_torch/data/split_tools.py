"""Dataset split tooling (counterpart of `ecamp_tpu/data/split_tools.py`):
k-fold 1% / 10% subsets and the regeneration of the four full-volume lists
absent from the reference mirror.

Equivalent of Detection/utils/dataset_split.py:26-83: train_list_1.csv /
train_list_10.csv style subsets of a full CSV or list file, random folds
with a fixed seed.

The JAX package reads and writes the CSVs with pandas, which the port does
not import. `read_csv` / `write_csv` here give the same bytes as pandas'
`read_csv` + `to_csv(index=False)` for these files: each column is typed
as pandas types it (int, float with its own decimal parser, bool, text),
its default NA tokens come out blank, blank lines are skipped, and the
output is minimally quoted with `\\n` line ends. Not reproduced: ints
beyond int64 mixed with negative ones (pandas makes such a column an odd
mix of ints and text; this keeps the text).
"""

from __future__ import annotations

import csv
import glob
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# pandas' default NA tokens (pandas._libs.parsers.STR_NA_VALUES)
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})
_TRUE = frozenset({"True", "TRUE", "true"})
_FALSE = frozenset({"False", "FALSE", "false"})
_INT = re.compile(r"[ \t\n\v\f\r]*[+-]?\d+[ \t\n\v\f\r]*")
_SPACE = " \t\n\v\f\r"
_POW10 = [float(f"1e{i}") for i in range(309)]
_INT64 = (-2 ** 63, 2 ** 63 - 1)


def _parse_float(s: str) -> Optional[float]:
    """pandas' default float parser (`precise_xstrtod`): at most 17
    significant digits (leading zeros count), accumulated in a double and
    scaled by a power of ten once; None where it does not read `s` whole.
    It is not correctly rounded: "0.30000000000000004" reads as 0.3."""
    n, p = len(s), 0
    while p < n and s[p] in _SPACE:
        p += 1
    negative = p < n and s[p] == "-"
    if p < n and s[p] in "+-":
        p += 1
    number, exponent, digits, decimals = 0.0, 0, 0, 0
    while p < n and s[p].isascii() and s[p].isdigit():
        if digits < 17:
            number = number * 10.0 + (ord(s[p]) - 48)
            digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and s[p] == ".":
        p += 1
        while digits < 17 and p < n and s[p].isascii() and s[p].isdigit():
            number = number * 10.0 + (ord(s[p]) - 48)
            digits += 1
            decimals += 1
            p += 1
        while p < n and s[p].isascii() and s[p].isdigit():
            p += 1
        exponent -= decimals
    if digits == 0:
        return None
    if negative:
        number = -number
    if p < n and s[p] in "eE":
        q = p + 1
        neg_exp = q < n and s[q] == "-"
        if q < n and s[q] in "+-":
            q += 1
        e, k = 0, 0
        while k < 17 and q < n and s[q].isascii() and s[q].isdigit():
            e = e * 10 + (ord(s[q]) - 48)
            k += 1
            q += 1
        if k:
            exponent += -e if neg_exp else e
            p = q
    if exponent > 308:
        number = number * float("inf") if number else 0.0
    elif exponent > 0:
        number *= _POW10[exponent]
    elif exponent < -616:
        number = 0.0 * number
    elif exponent < -308:
        number = number / _POW10[-308 - exponent] / _POW10[308]
    else:
        number /= _POW10[-exponent]
    while p < n and s[p] in _SPACE:
        p += 1
    return number if p == n else None


def _to_float(s: str) -> Optional[float]:
    v = _parse_float(s)
    if v is not None:
        return v
    low = s.lower()
    if low in ("inf", "+inf", "infinity", "+infinity"):
        return float("inf")
    if low in ("-inf", "-infinity"):
        return float("-inf")
    return None


def _column(raw: Sequence[str]) -> list:
    """One column's values as pandas types them: ints (no NA, all in int64,
    or all in uint64 and none negative), else floats (NA as None), else
    bools, else the text (NA as None)."""
    na = [v in NA_VALUES for v in raw]
    vals = [v for v, m in zip(raw, na) if not m]
    if not vals:
        return [None] * len(raw)
    if not any(na) and all(_INT.fullmatch(v) for v in vals):
        ints = [int(v) for v in raw]
        if (all(_INT64[0] <= i <= _INT64[1] for i in ints)
                or all(0 <= i < 2 ** 64 for i in ints)):
            return ints
        return list(raw)
    floats = [None if m else _to_float(v) for v, m in zip(raw, na)]
    if all(f is not None for f, m in zip(floats, na) if not m):
        return floats
    if all(v in _TRUE or v in _FALSE for v in vals):
        return [None if m else v in _TRUE for v, m in zip(raw, na)]
    return [None if m else v for v, m in zip(raw, na)]


def _header(names: List[str]) -> List[str]:
    """pandas' column names: a blank one is `Unnamed: <i>`, a repeat gets
    `.1`, `.2`, ..."""
    out, seen = [], {}
    for i, name in enumerate(names):
        name = name or f"Unnamed: {i}"
        if name in seen:
            seen[name] += 1
            name = f"{name}.{seen[name]}"
        else:
            seen[name] = 0
        out.append(name)
    return out


def read_csv(path: str) -> Tuple[List[str], Dict[str, list]]:
    """(column names, {name: typed values}) of a CSV with a header, as
    pandas' `read_csv` reads it (blank lines skipped, short rows padded
    with NA)."""
    with open(path, newline="", encoding="utf-8") as f:
        # a line of nothing or of blanks is skipped; `""` is an NA field
        rows = [r for r in csv.reader(f) if r and not (
            len(r) == 1 and r[0] and not r[0].strip(_SPACE))]
    names = _header(rows[0]) if rows else []
    body = rows[1:]
    for r in body:
        if len(r) > len(names):
            raise ValueError(f"{path}: a row of {len(r)} fields under "
                             f"{len(names)} column names")
    cols = {name: _column([r[i] if i < len(r) else "" for r in body])
            for i, name in enumerate(names)}
    return names, cols


def _cell(v) -> str:
    if v is None:
        return ""
    if isinstance(v, bool):
        return "True" if v else "False"
    if isinstance(v, float):
        return repr(v)
    return str(v)


def write_csv(path: str, names: Sequence[str], cols: Dict[str, list],
              rows: Optional[Sequence[int]] = None) -> None:
    """Write the columns (the rows `rows` of them, all by default) as
    pandas' `to_csv(index=False)` writes them."""
    n = len(cols[names[0]]) if names else 0
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(names)
        for i in (range(n) if rows is None else rows):
            w.writerow([_cell(cols[name][i]) for name in names])


def _fold(n: int, fraction: float, seed: int, fold: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    k = max(1, int(round(n * fraction)))
    start = (fold * k) % n
    return np.sort(perm[start:start + k])


def subset_csv(full_csv: str, out_path: str, fraction: float,
               seed: int = 42, fold: int = 0) -> int:
    """Write a random `fraction` subset of a CSV (header preserved).
    fold selects which of the 1/fraction disjoint folds to take."""
    names, cols = read_csv(full_csv)
    idx = _fold(len(cols[names[0]]), fraction, seed, fold)
    write_csv(out_path, names, cols, idx)
    return len(idx)


def subset_list_file(full_list: str, out_path: str, fraction: float,
                     seed: int = 42, fold: int = 0) -> int:
    """Same for whitespace list files (classification splits)."""
    with open(full_list) as f:
        lines = [ln for ln in f if ln.strip()]
    idx = _fold(len(lines), fraction, seed, fold)
    with open(out_path, "w") as f:
        for i in idx:
            f.write(lines[i])
    return len(idx)


def make_volume_splits(path: str, seed: int = 42) -> List[str]:
    """Generate the _1 / _10 volume variants next to a full split file."""
    base, ext = os.path.splitext(path)
    written = []
    for frac, tag in ((0.01, "_1"), (0.10, "_10")):
        out = f"{base}{tag}{ext}"
        if ext == ".csv":
            subset_csv(path, out, frac, seed)
        else:
            subset_list_file(path, out, frac, seed)
        written.append(out)
    return written


# ---------------------------------------------------------------------------
# Regeneration of the four full-volume lists absent from the reference
# mirror (.MISSING_LARGE_BLOBS). Each builds from the dataset's OFFICIAL
# label files and the shipped val/test registries, so the result is the
# deterministic complement of the published splits.

CHESTXRAY14_CLASSES = [
    "Atelectasis", "Cardiomegaly", "Effusion", "Infiltration", "Mass",
    "Nodule", "Pneumonia", "Pneumothorax", "Consolidation", "Edema",
    "Emphysema", "Fibrosis", "Pleural_Thickening", "Hernia",
]  # column order of the shipped lists (Classification/train.py:37-40)

CHEXPERT_CLASSES = [
    "Atelectasis", "Cardiomegaly", "Consolidation", "Edema",
    "Pleural Effusion",
]  # competition tasks (Classification/train.py:41-42)


def _read_list_names(path: str) -> set:
    with open(path) as f:
        return {ln.split()[0] for ln in f if ln.strip()}


def _text(v) -> str:
    """`str()` of a value as pandas holds it (NA reads `nan`)."""
    return "nan" if v is None else _cell(v)


def make_chestxray14_train_list(data_entry_csv: str, train_val_list: str,
                                val_list: str, out_path: str,
                                image_root: str = "") -> int:
    """Regenerate Classification/datasets/ChestX-ray14/train_list.txt.

    Inputs: the NIH release's Data_Entry_2017.csv ('Image Index',
    'Finding Labels' pipe-joined) and official train_val_list.txt, plus the
    SHIPPED val_list.txt; train = train_val minus val. Rows are
    '<subdir>/<name>.png l1 .. l14' with the class order above. The NIH
    archive shards images into images_001..images_012/ — when image_root is
    given, subdirs are resolved by scanning it; otherwise 'images/'."""
    _, cols = read_csv(data_entry_csv)
    labels = {}
    for name, finding in zip(cols["Image Index"], cols["Finding Labels"]):
        present = set(_text(finding).split("|"))
        labels[name] = [int(c in present) for c in CHESTXRAY14_CLASSES]

    subdir_of = {}
    if image_root:
        for p in glob.glob(os.path.join(image_root, "images_*", "images",
                                        "*.png")) + \
                glob.glob(os.path.join(image_root, "images_*", "*.png")):
            rel = os.path.relpath(p, image_root)
            subdir_of[os.path.basename(p)] = os.path.dirname(rel)

    with open(train_val_list) as f:
        train_val = [ln.strip() for ln in f if ln.strip()]
    val = _read_list_names(val_list)
    val_names = {os.path.basename(v) for v in val}

    n = 0
    with open(out_path, "w") as f:
        for name in train_val:
            base = os.path.basename(name)
            if base in val_names or base not in labels:
                continue
            sub = subdir_of.get(base, "images")
            f.write(f"{sub}/{base} " +
                    " ".join(str(v) for v in labels[base]) + "\n")
            n += 1
    return n


def make_chexpert_train_list(chexpert_train_csv: str, out_path: str,
                             uncertain: str = "ones") -> int:
    """Regenerate Classification/datasets/CheXpert/train_list.txt from the
    official CheXpert-v1.0 train.csv.

    Label policy for the uncertain (-1) entries is configurable
    ('ones' | 'zeros') and documented rather than guessed: the reference
    ships only its derived lists, not the policy. Blank -> 0. Paths are
    rewritten 'CheXpert-v1.0*/train/...' -> 'train/...' to match the
    shipped val/test lists."""
    u = 1 if uncertain == "ones" else 0
    names, cols = read_csv(chexpert_train_csv)
    n = 0
    with open(out_path, "w") as f:
        for i in range(len(cols["Path"])):
            path = _text(cols["Path"][i])
            parts = path.split("/")
            if parts and parts[0].startswith("CheXpert"):
                path = "/".join(parts[1:])
            vals = []
            for c in CHEXPERT_CLASSES:
                v = cols[c][i] if c in cols else None
                v = 0.0 if v is None else float(v)
                vals.append(u if v == -1.0 else int(v))
            f.write(path + " " + " ".join(str(v) for v in vals) + " \n")
            n += 1
    return n


def make_siim_lists(train_rle_csv: str, out_dir: str, val_list_csv: str,
                    test_list_csv: str) -> int:
    """Regenerate Segmentation/datasets/SIIM/{siim.csv,train_list.csv} from
    the official SIIM-ACR 'train-rle.csv' ('ImageId',' EncodedPixels' —
    note the leading space upstream). siim.csv is the normalized full
    registry; train_list.csv is its exact complement of the SHIPPED
    val_list.csv + test_list.csv ImageIds. A blank EncodedPixels stays
    blank (pandas 3's `astype(str)` keeps NA)."""
    names, cols = read_csv(train_rle_csv)
    names = [c.strip() for c in names]
    cols = dict(zip(names, cols.values()))
    cols["EncodedPixels"] = [None if v is None else _cell(v).strip()
                             for v in cols["EncodedPixels"]]
    write_csv(os.path.join(out_dir, "siim.csv"), names, cols)
    held = set(read_csv(val_list_csv)[1]["ImageId"]) | \
        set(read_csv(test_list_csv)[1]["ImageId"])
    keep = [i for i, v in enumerate(cols["ImageId"]) if v not in held]
    write_csv(os.path.join(out_dir, "train_list.csv"), names, cols, keep)
    return len(keep)


def regenerate_missing_splits(chestxray14_data_entry: str = "",
                              chestxray14_train_val: str = "",
                              chexpert_train_csv: str = "",
                              siim_train_rle: str = "",
                              splits_root: str = "",
                              image_root: str = "") -> dict:
    """One-call regeneration of every .MISSING_LARGE_BLOBS entry into the
    shipped registry tree (defaults to the repository's, `data/assets.py`).
    Pass only the official files you have; each group is independent."""
    from .assets import splits_root as shipped

    root = splits_root or os.path.dirname(shipped("Classification"))
    done = {}
    if chestxray14_data_entry and chestxray14_train_val:
        d = os.path.join(root, "Classification", "ChestX-ray14")
        done["chestxray14_train"] = make_chestxray14_train_list(
            chestxray14_data_entry, chestxray14_train_val,
            os.path.join(d, "val_list.txt"),
            os.path.join(d, "train_list.txt"), image_root)
    if chexpert_train_csv:
        d = os.path.join(root, "Classification", "CheXpert")
        done["chexpert_train"] = make_chexpert_train_list(
            chexpert_train_csv, os.path.join(d, "train_list.txt"))
    if siim_train_rle:
        d = os.path.join(root, "Segmentation", "SIIM")
        done["siim_train"] = make_siim_lists(
            siim_train_rle, d, os.path.join(d, "val_list.csv"),
            os.path.join(d, "test_list.csv"))
    return done
