"""ecamp_tpu_torch — the PyTorch + CUDA port of ecamp_tpu for NVIDIA Hopper.

Mirrors the layout and names of `ecamp_tpu`, which stays the reference each
module is tested against. Plain tensor code is eager PyTorch on one card;
every Pallas kernel on a ported path is a hand-written Hopper kernel
(`kernels/`, CUDA sources in `csrc/`) with a plain PyTorch version of the
same function beside it. The plain version runs for CPU tensors and is the
kernels' test oracle; it is never a fallback for a CUDA tensor.

Ported so far: the classification serving path (`serve.classifier_engine`,
`cli/serve.py`), the ECAMP pretraining step (`train.pretrain.PretrainTask`,
`cli/pretrain.py`) and the classification fine-tune
(`train.classification.ClassificationTask`, `cli/finetune_cls.py`). This
package never imports JAX.
"""

__version__ = "0.1.0"
