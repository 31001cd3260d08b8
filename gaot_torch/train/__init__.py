from .sequential_trainer import SequentialTrainer, predict_mode_indices
from .static_trainer import StaticTrainer, eval_step, masked_mse, train_step

__all__ = ["SequentialTrainer", "StaticTrainer", "eval_step", "masked_mse",
           "predict_mode_indices", "train_step"]
