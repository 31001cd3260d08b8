from .static_trainer import StaticTrainer, eval_step, masked_mse, train_step

__all__ = ["StaticTrainer", "eval_step", "masked_mse", "train_step"]
