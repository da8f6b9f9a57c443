"""Image ops, MAE masking, the losses of the pretraining and fine-tune
steps, the YOLO loss and the box utilities (counterpart of
`ecamp_tpu/ops/`). Plain PyTorch and numpy: none of them has a kernel."""
