from .tasks import SoftmaxRegressionTask
from .trainer import FLTrainer
from .engine import FLEngine, TrainLog

__all__ = ["SoftmaxRegressionTask", "FLTrainer", "FLEngine", "TrainLog"]
