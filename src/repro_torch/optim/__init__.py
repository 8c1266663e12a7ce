from .optimizers import (  # noqa: F401
    Optimizer,
    adam,
    clip_by_global_norm,
    global_norm,
)
from .schedules import cosine_decay, linear_warmup_cosine  # noqa: F401
