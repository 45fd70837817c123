from .tasks import MLPTask, SoftmaxRegressionTask, SyntheticHighDimTask
from .trainer import FLTrainer
from .engine import FLEngine, TrainLog

__all__ = ["MLPTask", "SoftmaxRegressionTask", "SyntheticHighDimTask",
           "FLTrainer", "FLEngine", "TrainLog"]
