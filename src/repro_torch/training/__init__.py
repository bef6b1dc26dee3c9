"""LM training (the reference's ``repro.training``): the loss, AdamW and
Adafactor updated in place, and the microbatched train step."""
from repro_torch.training.optimizer import adafactor, adamw  # noqa: F401
from repro_torch.training.train_loop import make_train_step  # noqa: F401
