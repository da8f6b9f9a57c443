"""The shipped split registries (counterpart of `ecamp_tpu/data/assets.py`).

The reference's downstream split lists are data files shipped under
`ecamp_tpu/assets/splits/<workload>/` in this repository. The port reads
them there as files, found by their path relative to the repository, and
imports no module of the JAX package.
"""

from __future__ import annotations

import os

_SPLITS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "ecamp_tpu", "assets", "splits")

WORKLOADS = ("Classification", "Segmentation", "Detection")


def splits_root(workload: str) -> str:
    """Directory containing the shipped split lists for one workload
    ('Classification' | 'Segmentation' | 'Detection')."""
    if workload not in WORKLOADS:
        raise ValueError(f"unknown workload {workload!r}; one of {WORKLOADS}")
    return os.path.join(_SPLITS, workload)


def resolve_list_root(explicit: str, dataset_path: str, workload: str,
                      probe: str) -> str:
    """Pick the split-list root for a fine-tune CLI: an explicit
    --list_path wins; else a dataset_path that already holds the probe file
    (e.g. '<task>/test_list.txt'); else the shipped registries."""
    if explicit:
        return explicit
    if dataset_path and os.path.exists(os.path.join(dataset_path, probe)):
        return dataset_path
    return splits_root(workload)
