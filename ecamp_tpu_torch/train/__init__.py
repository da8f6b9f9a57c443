"""The training steps (counterpart of `ecamp_tpu/train/`): optimizer,
schedules, train state, `PretrainTask`, `ClassificationTask` and the
evaluation metrics."""
