"""Training (counterpart of ``src/repro/training/``): AdamW and the cosine
schedule, the train and eval steps, checkpoints."""
from repro_torch.training.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.training.optimizer import AdamW, AdamWState, cosine_schedule
from repro_torch.training.train_loop import make_eval_step, make_train_step

__all__ = [
    "AdamW", "AdamWState", "cosine_schedule", "make_train_step",
    "make_eval_step", "save_checkpoint", "restore_checkpoint",
]
