#!/usr/bin/env python3
"""The pretraining feeder's steady rate on the host of this machine:

    python3 tools/feeder_phase.py [--window S] [--repeats N] [--images D]
                                  [--rows R] [--batch B] [OUT.json]

Writes a seeded MIMIC-style corpus of D gray PNGs at `chip_smoke.CLI_IMG`
px (2048 by default, written by all cores at once) into a temporary
directory, and R rows over them taken in turn (48,000: more than any
window reads, so a window never meets an epoch's end). Then, for the
pretraining `PretrainReportDataset` at 448 px, fp32 and `output_u8`, and
`DataLoader` at B = 32, threads against worker processes at K = 1, 4 and
min(16, cores): images a second over a window of S seconds (20) after an
iterator's first batch, N times (3), the repeats interleaved so that a
drift of the host touches every setting alike. Prints each reading, and
per setting the median, the least and the most, their spread over the
median and the first batch's seconds; one JSON line (`feeder_steady`),
also written to OUT.json if given. The files are read warm: they were
just written. Builds no kernel and needs no card; the card's `nvidia-smi`
name and power limit are printed where there is one.
"""

import argparse
import csv
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

RECIPE_IMAGES_PER_S = (571, 636)  # the pretraining recipe's step rates


def _write_shard(root: str, n: int, seed: int) -> str:
    from ecamp_tpu_torch.core.config import PretrainConfig
    from ecamp_tpu_torch.data.synthetic import write_mimic_corpus

    cfg = PretrainConfig()
    return write_mimic_corpus(
        root, os.path.join(REPO, "ecamp_tpu", "assets", "mimic_wordpiece.json"),
        n, cs.CLI_IMG, cfg.vit.grid_size - cfg.sr_window, seed=seed)


def write_corpus(work: str, images: int, rows: int) -> str:
    """`images` distinct PNGs in shards written in parallel, and `rows`
    rows over them in `work`/mimic; returns its path."""
    import multiprocessing

    from ecamp_tpu_torch.data.datasets import (REPORTS_CSV, VOCAB_JSON,
                                               WINDOWS_CSV)

    shards = max(1, min(os.cpu_count(), images))
    sizes = [images // shards + (s < images % shards) for s in range(shards)]
    with ProcessPoolExecutor(shards, multiprocessing.get_context(
            "spawn")) as ex:
        roots = list(ex.map(_write_shard,
                            [os.path.join(work, f"shard{s}")
                             for s in range(shards)],
                            sizes, [cs.SEED + s for s in range(shards)]))
    data = os.path.join(work, "mimic")
    os.makedirs(data)
    shutil.copyfile(os.path.join(roots[0], VOCAB_JSON),
                    os.path.join(data, VOCAB_JSON))
    for name in (REPORTS_CSV, WINDOWS_CSV):
        table = []
        for root in roots:
            with open(os.path.join(root, name), newline="",
                      encoding="utf-8") as f:
                table += list(csv.DictReader(f))
        with open(os.path.join(data, name), "w", newline="",
                  encoding="utf-8") as f:
            w = csv.DictWriter(f, fieldnames=list(table[0]))
            w.writeheader()
            w.writerows(table[i % len(table)] for i in range(rows))
    return data


def window(loader, seconds: float) -> dict:
    """Images a second over `seconds` after the iterator's first batch,
    then the iterator abandoned (its workers stopped)."""
    it = iter(loader)
    t0 = time.perf_counter()
    next(it)
    t1 = t = time.perf_counter()
    n = 0
    try:
        while t - t1 < seconds:
            next(it)
            n += 1
            t = time.perf_counter()
    except StopIteration:
        raise SystemExit("the corpus ran out inside a window: give more "
                         "--rows") from None
    finally:
        it.close()
    return {"images_per_s": n * loader.batch_size / (t - t1),
            "first_batch_s": t1 - t0}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--window", type=float, default=20.0)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--images", type=int, default=2048)
    ap.add_argument("--rows", type=int, default=48_000)
    ap.add_argument("--batch", type=int, default=cs.FEEDER_B)
    ap.add_argument("out", nargs="?")
    a = ap.parse_args(argv)

    from ecamp_tpu_torch.data.datasets import PretrainReportDataset
    from ecamp_tpu_torch.data.loader import DataLoader

    try:
        card = cs.card_line()
    except (OSError, subprocess.SubprocessError):
        card = "no card (nvidia-smi absent or failed)"
    print(card)
    cores = os.cpu_count()
    ks = sorted({1, 4, min(16, cores)})
    out = {"card": card, "cpu_count": cores,
           "cpus_usable": len(os.sched_getaffinity(0)),
           "img_size": cs.FEEDER_IMG, "batch": a.batch, "ks": ks,
           "window_s": a.window, "repeats": a.repeats,
           "images": a.images, "rows": a.rows, "read": "warm"}
    work = tempfile.mkdtemp(prefix="ecamp_feeder_")
    try:
        t0 = time.perf_counter()
        data = write_corpus(work, a.images, a.rows)
        out["corpus_s"] = time.perf_counter() - t0
        print(f"feeder on {card}: {cores} cores ({out['cpus_usable']} "
              f"usable), {a.images} PNGs at {cs.CLI_IMG} px and {a.rows} "
              f"rows written in {out['corpus_s']:.1f} s; windows of "
              f"{a.window} s, {a.repeats} repeats, K = {ks}", flush=True)
        sets = {dtype: PretrainReportDataset(
            data, img_size=cs.FEEDER_IMG, seed=cs.SEED,
            output_u8=dtype == "u8") for dtype in ("fp32", "u8")}
        runs = {}
        for rep in range(a.repeats):
            for dtype, ds in sets.items():
                for k in ks:
                    for mode, kw in (("threads", {"num_workers": k}),
                                     ("processes", {"mp_workers": k})):
                        loader = DataLoader(ds, a.batch, seed=cs.SEED, **kw)
                        loader.set_epoch(rep)
                        r = window(loader, a.window)
                        runs.setdefault((dtype, mode, k), []).append(r)
                        print(f"  {rep} {dtype:4s} {mode:9s} K={k:2d}: "
                              f"{r['images_per_s']:8.1f} images/s (first "
                              f"batch {r['first_batch_s']:.2f} s)",
                              flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"per setting: median [least, most] images/s, spread over the "
          f"median; the recipe takes {RECIPE_IMAGES_PER_S} images/s")
    for (dtype, mode, k), rs in runs.items():
        rates = [r["images_per_s"] for r in rs]
        med = statistics.median(rates)
        s = {"images_per_s": rates, "median": med, "least": min(rates),
             "most": max(rates), "spread": (max(rates) - min(rates)) / med,
             "first_batch_s": [r["first_batch_s"] for r in rs]}
        out.setdefault(dtype, {}).setdefault(mode, {})[str(k)] = s
        print(f"  {dtype:4s} {mode:9s} K={k:2d}: {med:8.1f} [{s['least']:.1f}"
              f", {s['most']:.1f}] spread {s['spread']:.3f}")
    print(json.dumps({"feeder_steady": out}))
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
