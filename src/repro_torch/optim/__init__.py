from .optimizers import Optimizer, adam  # noqa: F401
from .schedules import cosine_decay, linear_warmup_cosine  # noqa: F401
