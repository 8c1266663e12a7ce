from .optimizers import (  # noqa: F401
    Optimizer,
    adam,
    adamw,
    clip_by_global_norm,
    global_norm,
    momentum,
    sgd,
)
from .schedules import constant, cosine_decay, linear_warmup_cosine  # noqa: F401
