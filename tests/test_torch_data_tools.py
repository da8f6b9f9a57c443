"""The port's host data tools (`ecamp_tpu_torch/data/preprocess.py` and the
pandas-free `data/split_tools.py`) against the JAX package's, byte for
byte: `preprocess_tree` on a seeded tree, each split tool on the shipped
lists and on seeded synthetic files in the official column layouts, all
written under `tmp_path` (the shipped lists are only read).
"""

import os
import shutil

import numpy as np
import pytest

from ecamp_tpu.data import preprocess as jprep  # noqa: E402
from ecamp_tpu.data import split_tools as jst  # noqa: E402
from ecamp_tpu_torch.data import preprocess, split_tools  # noqa: E402
from ecamp_tpu_torch.data.assets import splits_root  # noqa: E402

SPLITS = os.path.dirname(splits_root("Classification"))


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


# ---------------------------------------------------------------------------
# preprocess


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    """Seeded images: RGB JPEGs above and below max_side (64), a PNG, an L
    and an RGBA image, an unreadable file, and a file preprocess ignores."""
    from PIL import Image

    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("src")
    (root / "a" / "b").mkdir(parents=True)

    def img(shape, mode):
        return Image.fromarray(rng.integers(0, 256, shape, np.uint8), mode)

    img((150, 100, 3), "RGB").save(root / "big.jpg", quality=90)
    img((40, 30, 3), "RGB").save(root / "a" / "small.JPEG", quality=90)
    img((90, 120, 3), "RGB").save(root / "a" / "b" / "wide.png")
    img((80, 70), "L").save(root / "a" / "gray.jpg", quality=90)
    img((70, 90, 4), "RGBA").save(root / "a" / "b" / "alpha.png")
    (root / "broken.jpg").write_bytes(b"not an image")
    (root / "notes.txt").write_text("skipped")
    return str(root)


@pytest.mark.parametrize("workers", [1, 2])
def test_preprocess_tree_matches_jax(tmp_path, image_tree, workers):
    """(converted, failed), the mirrored tree and every JPEG's bytes equal
    JAX's; a file already done is skipped, and a second run does nothing."""
    got, want = str(tmp_path / "port"), str(tmp_path / "jax")
    for dst in (got, want):  # one image already done
        os.makedirs(os.path.join(dst, "a"))
        with open(os.path.join(dst, "a", "small.jpg"), "wb") as f:
            f.write(b"done")
    counts = preprocess.preprocess_tree(image_tree, got, max_side=64,
                                        quality=90, workers=workers)
    assert counts == jprep.preprocess_tree(image_tree, want, max_side=64,
                                           quality=90, workers=workers)
    assert counts == (4, 1)
    assert _tree(got) == _tree(want) == sorted(
        ["a/b/alpha.jpg", "a/b/wide.jpg", "a/gray.jpg", "a/small.jpg",
         "big.jpg"])
    for rel in _tree(got):
        assert _bytes(os.path.join(got, rel)) == _bytes(
            os.path.join(want, rel)), rel
    assert _bytes(os.path.join(got, "a", "small.jpg")) == b"done"
    from PIL import Image

    with Image.open(os.path.join(got, "big.jpg")) as im:
        assert max(im.size) == 64 and im.mode == "RGB"
    with Image.open(os.path.join(got, "a", "gray.jpg")) as im:
        assert im.mode == "L"
    assert preprocess.preprocess_tree(image_tree, got, max_side=64,
                                      workers=1) == (0, 1)


def test_preprocess_cli(tmp_path, image_tree, capsys):
    preprocess.main(["--src", image_tree, "--dst", str(tmp_path / "o"),
                     "--max_side", "64", "--workers", "1"])
    assert f"converted 5 images (1 failed) -> {tmp_path / 'o'}" in \
        capsys.readouterr().out


# ---------------------------------------------------------------------------
# split_tools: subsets of the shipped lists


SHIPPED = ["Detection/RSNA/train_list.csv", "Segmentation/SIIM/val_list.csv",
           "Classification/Aptos/train_list.txt"]


@pytest.mark.parametrize("rel", SHIPPED)
@pytest.mark.parametrize("fold", [0, 1])
@pytest.mark.parametrize("fraction", [0.01, 0.10])
def test_subsets_of_shipped_lists_match_jax(tmp_path, rel, fold, fraction):
    src = os.path.join(SPLITS, rel)
    ext = os.path.splitext(rel)[1]
    fn, jfn = ((split_tools.subset_csv, jst.subset_csv) if ext == ".csv"
               else (split_tools.subset_list_file, jst.subset_list_file))
    got, want = str(tmp_path / f"got{ext}"), str(tmp_path / f"want{ext}")
    n = fn(src, got, fraction, seed=42, fold=fold)
    assert n == jfn(src, want, fraction, seed=42, fold=fold) > 0
    assert _bytes(got) == _bytes(want)
    if rel.startswith("Detection"):  # the bbox lists come out quoted
        assert b',"[[' in _bytes(got)


SYNTHETIC = (
    "id,count,score,label,flag,note,bbox\n"
    "a1,001,1.50,3,True,plain,\"[[0.0, 0.0, 0.0, 0.0]]\"\n"
    "a2,2,,NA,false,\"with, comma\",\"[[1.5, 2.0, 3.0, 4.0]]\"\n"
    "\n"
    "a3,+3,0.30000000000000004,null,TRUE,\"say \"\"hi\"\"\",[]\n"
    "a4,4,1e-3,7,False,NaN,\n"
    "a5, 5 ,-2.5E+2,,true,\"two\nlines\",x\r\n"
    "a6,6,inf,8,False,#N/A,\"[[9.0, 9.0, 9.0, 9.0]]\"\n"
)


@pytest.mark.parametrize("fraction,fold", [(0.5, 0), (0.5, 1), (1.0, 0)])
def test_subset_csv_types_fields_as_pandas(tmp_path, fraction, fold):
    """Ints, floats (pandas' own decimal parser), NA tokens, bools, quoted
    commas, quotes and newlines, a blank line and a CRLF row."""
    src = tmp_path / "full.csv"
    src.write_bytes(SYNTHETIC.encode())
    got, want = str(tmp_path / "got.csv"), str(tmp_path / "want.csv")
    assert (split_tools.subset_csv(str(src), got, fraction, 7, fold)
            == jst.subset_csv(str(src), want, fraction, 7, fold))
    assert _bytes(got) == _bytes(want)
    if fraction == 1.0:
        text = _bytes(got).decode()
        assert "a1,1,1.5,3.0,True,plain" in text and ",0.3," in text


def test_make_volume_splits_match_jax(tmp_path):
    for rel in SHIPPED:
        name = os.path.basename(rel)
        for side in ("port", "jax"):
            os.makedirs(tmp_path / side, exist_ok=True)
            shutil.copy(os.path.join(SPLITS, rel), tmp_path / side / name)
        got = split_tools.make_volume_splits(str(tmp_path / "port" / name))
        want = jst.make_volume_splits(str(tmp_path / "jax" / name))
        assert [os.path.basename(p) for p in got] == [
            os.path.basename(p) for p in want]
        for a, b in zip(got, want):
            assert _bytes(a) == _bytes(b), a


# ---------------------------------------------------------------------------
# split_tools: the regenerators, on seeded files in the official layouts


def _nih_files(root, rng):
    """Data_Entry_2017.csv (NIH's columns), train_val_list.txt,
    val_list.txt in the shipped '<dir>/<name> l1..l14' layout, and an
    image root sharded as images_00N[/images]/."""
    names = [f"{i:08d}_{j:03d}.png" for i in range(1, 13) for j in range(2)]
    findings = jst.CHESTXRAY14_CLASSES + ["No Finding"]
    rows = ["Image Index,Finding Labels,Follow-up #,Patient ID,Patient Age,"
            "Patient Gender,View Position,OriginalImage[Width,Height],"
            "OriginalImagePixelSpacing[x,y],"]
    for k, n in enumerate(names):
        pick = rng.choice(findings, size=rng.integers(1, 4), replace=False)
        label = "" if k == 5 else "|".join(pick)
        rows.append(f"{n},{label},{k % 3},{k // 2},{40 + k},M,PA,2500,2048,"
                    f"0.143,0.143,")
    (root / "Data_Entry_2017.csv").write_text("\n".join(rows) + "\n")
    (root / "train_val_list.txt").write_text(
        "\n".join(names[:20] + ["99999999_000.png"]) + "\n")
    val = root / "val_list.txt"
    val.write_text("".join(f"images/{n} " + " ".join(["0"] * 14) + "\n"
                           for n in names[3:8]))
    img = root / "images"
    for i, n in enumerate(names[:12]):
        d = img / f"images_{1 + i % 3:03d}" / ("images" if i % 2 else "")
        d.mkdir(parents=True, exist_ok=True)
        (d / n).write_bytes(b"")
    return str(val)


def test_make_chestxray14_train_list_matches_jax(tmp_path):
    val = _nih_files(tmp_path, np.random.default_rng(3))
    for image_root in ("", str(tmp_path / "images")):
        got, want = str(tmp_path / "got.txt"), str(tmp_path / "want.txt")
        args = (str(tmp_path / "Data_Entry_2017.csv"),
                str(tmp_path / "train_val_list.txt"), val)
        assert (split_tools.make_chestxray14_train_list(*args, got,
                                                        image_root)
                == jst.make_chestxray14_train_list(*args, want, image_root)
                == 15)
        assert _bytes(got) == _bytes(want)


def _chexpert_csv(path, rng):
    cols = ["Path", "Sex", "Age", "Frontal/Lateral", "AP/PA", "No Finding",
            "Enlarged Cardiomediastinum", "Cardiomegaly", "Lung Opacity",
            "Lung Lesion", "Edema", "Consolidation", "Pneumonia",
            "Atelectasis", "Pneumothorax", "Pleural Effusion",
            "Pleural Other", "Fracture", "Support Devices"]
    lines = [",".join(cols)]
    for i in range(30):
        vals = [rng.choice(["1.0", "0.0", "-1.0", ""]) for _ in cols[5:]]
        lines.append(f"CheXpert-v1.0-small/train/patient{i:05d}/study1/"
                     f"view1_frontal.jpg,{'Female' if i % 2 else 'Male'},"
                     f"{50 + i},Frontal,{'AP' if i % 3 else 'PA'},"
                     + ",".join(vals))
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("uncertain", ["ones", "zeros"])
def test_make_chexpert_train_list_matches_jax(tmp_path, uncertain):
    """Blank is 0, -1.0 follows `uncertain`, the `CheXpert-v1.0*/` prefix
    is dropped."""
    src = tmp_path / "train.csv"
    _chexpert_csv(src, np.random.default_rng(5))
    got, want = str(tmp_path / "got.txt"), str(tmp_path / "want.txt")
    assert (split_tools.make_chexpert_train_list(str(src), got, uncertain)
            == jst.make_chexpert_train_list(str(src), want, uncertain)
            == 30)
    assert _bytes(got) == _bytes(want)
    assert _bytes(got).startswith(b"train/patient00000/")


def _siim_files(root, rng, kind):
    """train-rle.csv ('ImageId', ' EncodedPixels') and the val/test lists.
    kind: 'mixed' (RLE strings, ' -1', blanks), 'ints' (every row ' -1')
    or 'floats' ('-1' and blanks)."""
    ids = [f"1.2.276.0.7230010.3.1.4.8323329.{1000 + i}.1517875{i:03d}.1"
           for i in range(24)]
    rows = ["ImageId, EncodedPixels"]
    for i, n in enumerate(ids):
        if kind == "ints":
            v = " -1"
        elif kind == "floats":
            v = "" if i % 5 == 0 else "-1"
        else:
            v = ("" if i % 7 == 0 else " -1" if i % 3 else
                 " " + " ".join(str(x) for x in rng.integers(1, 900, 6)))
        rows.append(f"{n},{v}")
    if kind == "mixed":
        rows.append(f"{ids[2]}, 5 6 7 8")  # an image with a second mask
    (root / "train-rle.csv").write_text("\n".join(rows) + "\n")
    for name, part in (("val_list.csv", ids[:4]), ("test_list.csv",
                                                     ids[4:9])):
        (root / name).write_text("ImageId,EncodedPixels\n" + "".join(
            f"{n},-1\n" for n in part))


@pytest.mark.parametrize("kind", ["mixed", "ints", "floats"])
def test_make_siim_lists_matches_jax(tmp_path, kind):
    """The header's leading space goes, EncodedPixels is stripped text, a
    blank one stays blank (pandas 3.0.3), the held-out ImageIds are left
    out."""
    _siim_files(tmp_path, np.random.default_rng(7), kind)
    counts = []
    for side, fn in (("port", split_tools.make_siim_lists),
                     ("jax", jst.make_siim_lists)):
        os.makedirs(tmp_path / side)
        counts.append(fn(str(tmp_path / "train-rle.csv"),
                         str(tmp_path / side), str(tmp_path / "val_list.csv"),
                         str(tmp_path / "test_list.csv")))
    assert counts[0] == counts[1] == 15  # 24 images, 9 held out
    for name in ("siim.csv", "train_list.csv"):
        assert _bytes(tmp_path / "port" / name) == _bytes(
            tmp_path / "jax" / name), name
    assert _bytes(tmp_path / "port" / "siim.csv").startswith(
        b"ImageId,EncodedPixels\n")


def test_regenerate_missing_splits_matches_jax(tmp_path):
    """All three groups into a copy of the shipped tree under tmp_path (the
    shipped tree itself is never written)."""
    rng = np.random.default_rng(11)
    _nih_files(tmp_path, rng)
    _chexpert_csv(tmp_path / "train.csv", rng)
    _siim_files(tmp_path, rng, "mixed")
    trees = {}
    for side in ("port", "jax"):
        trees[side] = tmp_path / side
        for rel in ("Classification/ChestX-ray14", "Classification/CheXpert",
                    "Segmentation/SIIM"):
            shutil.copytree(os.path.join(SPLITS, rel), trees[side] / rel)
    kw = dict(chestxray14_data_entry=str(tmp_path / "Data_Entry_2017.csv"),
              chestxray14_train_val=str(tmp_path / "train_val_list.txt"),
              chexpert_train_csv=str(tmp_path / "train.csv"),
              siim_train_rle=str(tmp_path / "train-rle.csv"),
              image_root=str(tmp_path / "images"))
    got = split_tools.regenerate_missing_splits(
        splits_root=str(trees["port"]), **kw)
    want = jst.regenerate_missing_splits(splits_root=str(trees["jax"]), **kw)
    assert got == want and set(got) == {"chestxray14_train",
                                        "chexpert_train", "siim_train"}
    assert _tree(trees["port"]) == _tree(trees["jax"])
    for rel in _tree(trees["port"]):
        assert _bytes(trees["port"] / rel) == _bytes(trees["jax"] / rel), rel
    assert split_tools.regenerate_missing_splits(
        splits_root=str(trees["port"])) == {}
