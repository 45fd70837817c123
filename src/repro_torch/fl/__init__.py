from .tasks import MLPTask, SoftmaxRegressionTask
from .trainer import FLTrainer
from .engine import FLEngine, TrainLog

__all__ = ["MLPTask", "SoftmaxRegressionTask", "FLTrainer", "FLEngine",
           "TrainLog"]
