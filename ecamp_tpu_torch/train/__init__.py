"""The pretraining step (counterpart of `ecamp_tpu/train/`): optimizer,
schedules, train state and `PretrainTask`."""
