"""The port's `DataLoader(mp_workers=K)` (ecamp_tpu_torch.data.loader,
worker processes) on the CPU:

  * its batches equal the thread mode's at num_workers = K and
    `ecamp_tpu.data.loader.DataLoader`'s, bit for bit, across epochs,
    shuffled or not, the last batch dropped or ragged, under spawn and
    fork, on a plain index dataset and on both packages'
    `PretrainReportDataset`; one epoch read twice repeats, two epochs
    differ (`reseed` reaches the child);
  * with one worker slowed down, the samples fetched and not yet taken
    stay within K * (QUEUE_SIZE + 1) batches;
  * a worker's exception is raised in batch order with its message, a
    worker killed with SIGKILL is raised within seconds, and an abandoned
    iterator leaves no child process and no batch file in SHM_DIR;
  * a missing or full SHM_DIR is raised, naming it, and the pickled
    dataset's file there is the user's alone (0600);
  * the child imports neither torch nor JAX, and every dataset class the
    CLIs build pickles.

The test datasets live in `tests/torch_loader_datasets.py`, which a
spawned worker imports: numpy only.
"""

import errno
import glob
import mmap
import multiprocessing
import os
import pickle
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from ecamp_tpu_torch.data import loader as loader_mod  # noqa: E402
from ecamp_tpu_torch.data.loader import DataLoader  # noqa: E402
from torch_loader_datasets import Numbers  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(REPO, "ecamp_tpu", "assets", "mimic_wordpiece.json")
K = 3


def _workers():
    return [p for p in multiprocessing.active_children()
            if p.name.startswith("DataLoader-")]


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert set(a) == set(b)
        for k in a:
            assert b[k].dtype == a[k].dtype, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def _left_files():
    return glob.glob(os.path.join(loader_mod.SHM_DIR,
                                  f"ecamp-loader-{os.getpid()}-*"))


@pytest.mark.parametrize("shuffle,drop_last,context", [
    (True, True, "spawn"), (True, False, "spawn"), (False, True, "spawn"),
    (False, False, "spawn"), (True, False, "fork")])
def test_processes_match_threads_and_jax(shuffle, drop_last, context):
    """Each process batch's arrays lie on a mapping of its file in
    SHM_DIR."""
    from ecamp_tpu.data.loader import DataLoader as JaxLoader

    kw = dict(shuffle=shuffle, seed=3, drop_last=drop_last)
    procs = DataLoader(Numbers(23), 5, mp_workers=K, mp_context=context,
                       **kw)
    threads = DataLoader(Numbers(23), 5, num_workers=K, **kw)
    jax_threads = JaxLoader(Numbers(23), 5, num_workers=K, **kw)
    assert len(procs) == (4 if drop_last else 5)
    for epoch in (0, 1):
        for ld in (procs, threads, jax_threads):
            ld.set_epoch(epoch)
        got = list(procs)
        _equal(got, list(threads))
        _equal(got, list(jax_threads))
        assert got[-1]["x"].shape[0] == (5 if drop_last else 3)
        assert all(isinstance(b["x"].base, mmap.mmap) for b in got)
    assert not _workers()
    assert not _left_files()


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8_pipe"])
def test_pretrain_dataset_processes_match_threads_and_jax(tmp_path,
                                                          monkeypatch, u8):
    """Both packages' `PretrainReportDataset` at 32 px on a seeded corpus:
    process batches equal the port's thread batches and JAX's loader's
    bit for bit; epoch 1 read twice repeats and differs from epoch 0."""
    from ecamp_tpu.data import native
    from ecamp_tpu.data.datasets import PretrainReportDataset as JaxDataset
    from ecamp_tpu.data.loader import DataLoader as JaxLoader
    from ecamp_tpu_torch.data.datasets import PretrainReportDataset
    from ecamp_tpu_torch.data.synthetic import write_mimic_corpus

    monkeypatch.setattr(native, "_LIB", None)  # JAX's PIL / Python path
    monkeypatch.setattr(native, "_TRIED", True)
    root = write_mimic_corpus(str(tmp_path / "mimic"), VOCAB, n_images=8,
                              img_size=48, max_window_start=2, seed=5)
    ds = PretrainReportDataset(root, img_size=32, max_caption_length=32,
                               seed=7, output_u8=u8)
    jds = JaxDataset(root, img_size=32, max_caption_length=32, seed=7,
                     image_dtype=np.uint8 if u8 else np.float32)
    kw = dict(batch_size=3, seed=7, drop_last=False)
    procs = DataLoader(ds, mp_workers=2, **kw)
    threads = DataLoader(ds, num_workers=2, **kw)
    jax_threads = JaxLoader(jds, num_workers=2, **kw)
    epochs = []
    for epoch in (0, 1):
        for ld in (procs, threads, jax_threads):
            ld.set_epoch(epoch)
        got = list(procs)
        assert len(got) == 3
        _equal(got, list(threads))
        _equal(got, list(jax_threads))
        epochs.append(got)
    _equal(list(procs), epochs[1])  # epoch 1 again
    assert not all(np.array_equal(a["image"], b["image"])
                   for a, b in zip(*epochs))


def test_process_queues_are_bounded_with_a_slow_worker(tmp_path):
    """Worker 0 of 3 takes 20 ms a sample, the others none: the samples
    fetched and not yet taken stay within K * (QUEUE_SIZE + 1) batches of
    one, where JAX's shared queue and reorder dict would let the fast
    workers run to the end of the epoch."""
    log = str(tmp_path / "fetched.txt")
    loader = DataLoader(Numbers(60, slow=0.02, log=log), batch_size=1,
                        shuffle=False, mp_workers=K)
    seen, peak = [], 0
    for taken, batch in enumerate(loader, 1):
        seen.append(int(batch["x"][0, 0]))
        with open(log) as f:
            peak = max(peak, sum(1 for _ in f) - taken)
    assert seen == list(range(60))
    assert peak <= K * (loader_mod.QUEUE_SIZE + 1), peak


def test_process_failure_is_raised_in_order():
    """Index 7 fails in its worker: batches 0-2 arrive, then batch 3
    raises with the worker's message (as JAX's test matches `boom7`)."""
    seen = []
    with pytest.raises(RuntimeError, match="worker failed") as info:
        for batch in DataLoader(Numbers(12, fail_at=7), batch_size=2,
                                shuffle=False, mp_workers=K):
            seen.append(int(batch["x"][0, 0]))
    assert seen == [0, 2, 4]
    assert "ValueError: boom7" in str(info.value)
    assert "batch 3" in str(info.value)
    assert not _workers()


def test_killed_process_is_raised_within_seconds():
    it = iter(DataLoader(Numbers(60, slow=0.05, slow_worker=None),
                         batch_size=2, shuffle=False, mp_workers=K))
    next(it)
    victim = next(p for p in _workers() if p.name == "DataLoader-1")
    os.kill(victim.pid, signal.SIGKILL)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="worker process 1 ended"):
        for _ in it:
            pass
    assert time.monotonic() - t0 < 5
    assert not _workers()
    assert not _left_files()


def test_abandoned_process_iterator_stops_its_workers():
    it = iter(DataLoader(Numbers(200, slow=0.01, slow_worker=None),
                         batch_size=2, mp_workers=K))
    next(it)
    next(it)
    assert len(_workers()) == K
    it.close()  # the generator's finally: terminate and join the workers
    deadline = time.monotonic() + 5
    while _workers() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _workers()
    assert not _left_files()  # the batches made and not taken


def test_missing_shm_dir_is_raised(tmp_path, monkeypatch):
    """No SHM_DIR: the iterator raises naming it before any worker
    starts, rather than hand batches over some slower way."""
    missing = str(tmp_path / "no-shm")
    monkeypatch.setattr(loader_mod, "SHM_DIR", missing)
    with pytest.raises(RuntimeError, match="SHM_DIR .*no-shm \\(missing"):
        next(iter(DataLoader(Numbers(6), 2, mp_workers=2)))
    assert not _workers()


def test_full_shm_dir_is_raised_with_the_batch_size(monkeypatch):
    """A worker that finds no room for its batch (its `posix_fallocate`
    fails, inherited through fork) fails that batch: the consumer raises
    the worker's message, which names SHM_DIR, its free bytes and the
    batch's, and no file is left."""
    def full(fd, offset, size):
        raise OSError(errno.ENOSPC, "No space left on device")

    monkeypatch.setattr(loader_mod.os, "posix_fallocate", full)
    with pytest.raises(RuntimeError, match="worker failed on batch 0") as e:
        next(iter(DataLoader(Numbers(6), 2, shuffle=False, mp_workers=2,
                             mp_context="fork")))
    msg = str(e.value)
    assert "no room for a batch of 64 bytes in SHM_DIR" in msg, msg
    assert "bytes free" in msg and "No space left" in msg, msg
    assert not _workers()
    assert not _left_files()


def test_job_file_is_private_while_the_iterator_runs():
    """The pickled dataset (MIMIC-CXR's reports, in the CLI) lies in
    SHM_DIR while the workers run: mode 0600, the user's alone."""
    it = iter(DataLoader(Numbers(40, slow=0.01, slow_worker=None), 2,
                         mp_workers=2))
    next(it)
    jobs = [f for f in _left_files() if f.endswith("-job")]
    assert len(jobs) == 1, _left_files()
    assert os.stat(jobs[0]).st_mode & 0o777 == 0o600
    it.close()
    assert not _left_files()


def test_worker_process_imports_no_torch():
    """The modules a spawned worker imports (the loader's and the
    datasets') import no torch, in a fresh interpreter; and the workers of
    this torch-importing test process report neither torch nor JAX."""
    mods = ["ecamp_tpu_torch.data." + m for m in (
        "loader", "datasets", "transforms", "tokenizer", "entity_masking")]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('torch', 'jax', 'ecamp_tpu'))\nprint(bad)\n"
              "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stdout + r.stderr
    batches = list(DataLoader(Numbers(6, probe=True), batch_size=2,
                              shuffle=False, mp_workers=2))
    imported = np.concatenate([b["imported"] for b in batches])
    assert not imported[:, :2].any(), imported
    assert len(set(imported[:, 2])) == 2  # two worker processes
    assert os.getpid() not in set(imported[:, 2])


def test_every_cli_dataset_pickles(tmp_path):
    """Each dataset class the CLIs build survives pickling (the spawn
    context ships it so) with its samples: the same sample from the
    original and the copy after the same `reseed`."""
    from ecamp_tpu_torch.cli.common import Subset
    from ecamp_tpu_torch.data import datasets as D
    from ecamp_tpu_torch.data import synthetic as S
    from ecamp_tpu_torch.data.transforms import EvalTransform, TrainTransform

    t = str(tmp_path)
    mimic = S.write_mimic_corpus(os.path.join(t, "mimic"), VOCAB, 2, 48, 2)
    cls = S.write_classification_corpus(os.path.join(t, "cls"),
                                        "ChestX-ray14", 2, 1, 1,
                                        img_size=48)
    seg = {task: S.write_segmentation_corpus(os.path.join(t, task), task,
                                             4, 2, 2, img_size=48)
           for task in ("SIIM", "RSNA", "RIGA")}
    det = {task: S.write_detection_corpus(os.path.join(t, "det" + task),
                                          task, 4, 2, 2, img_size=48)
           for task in ("RSNA", "ObjectCXR")}
    train_tf = TrainTransform(32, 0.5, 0.25, seed=3)
    built = [
        D.PretrainReportDataset(mimic, img_size=32, max_caption_length=32),
        D.PretrainReportDataset(mimic, img_size=32, max_caption_length=32,
                                output_u8=True),
        D.ClassificationListDataset(cls, cls, "ChestX-ray14",
                                    transform=train_tf),
        Subset(D.ClassificationListDataset(
            cls, cls, "ChestX-ray14", split="val",
            transform=EvalTransform(32, 0.5, 0.25)), [0]),
        D.SIIMSegmentationDataset(seg["SIIM"], seg["SIIM"], "train",
                                  img_size=32),
        D.RSNASegmentationDataset(seg["RSNA"], seg["RSNA"], "train",
                                  img_size=32),
        D.RIGASegmentationDataset(seg["RIGA"], seg["RIGA"], "train",
                                  img_size=32),
        D.RSNADetectionDataset(det["RSNA"], det["RSNA"], "train",
                               img_size=32),
        D.ObjectCXRDetectionDataset(det["ObjectCXR"], det["ObjectCXR"],
                                    "train", img_size=32)]
    for ds in built:
        copy = pickle.loads(pickle.dumps(ds))
        for d in (ds, copy):
            if hasattr(d, "reseed"):
                d.reseed(2, 1)
        assert len(copy) == len(ds) > 0
        _equal([copy[0]], [ds[0]])
