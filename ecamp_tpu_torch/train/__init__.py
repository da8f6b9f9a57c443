"""The training steps (counterpart of `ecamp_tpu/train/`): optimizer,
schedules, train state, `PretrainTask`, `ClassificationTask`,
`SegmentationTask`, `DetectionTask` and the evaluation metrics."""
