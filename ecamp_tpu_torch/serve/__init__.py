from .engine import InferenceEngine, MicroBatcher, sigmoid_np, softmax_np
from .loaders import (classifier_engine, detector_engine, embedding_engine,
                      segmenter_engine)

__all__ = ["InferenceEngine", "MicroBatcher", "classifier_engine",
           "detector_engine", "embedding_engine", "segmenter_engine",
           "sigmoid_np", "softmax_np"]
