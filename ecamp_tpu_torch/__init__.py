"""ecamp_tpu_torch — the PyTorch + CUDA port of ecamp_tpu for NVIDIA Hopper.

Mirrors the layout and names of `ecamp_tpu`, which stays the reference each
module is tested against. Plain tensor code is eager PyTorch on one card;
every Pallas kernel on a ported path is a hand-written Hopper kernel
(`kernels/`, CUDA sources in `csrc/`) with a plain PyTorch version of the
same function beside it. The plain version runs for CPU tensors and is the
kernels' test oracle; it is never a fallback for a CUDA tensor.

Every entry point of the JAX package has its counterpart here: the
pretraining, fine-tuning, serving, export and visualizer CLIs (`cli/`),
with data parallelism under torchrun (`core/distributed.py`), the data
pipeline with thread or process workers (`data/`) and the TensorBoard
writer and profiler hooks (`core/observability.py`). What is not ported
is listed in ROADMAP.md (Queue 1). This package never imports JAX.
"""

__version__ = "0.1.0"
