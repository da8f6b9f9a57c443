"""Image ops, MAE masking and losses of the pretraining step (counterpart
of `ecamp_tpu/ops/`). Plain PyTorch: none of them has a kernel."""
