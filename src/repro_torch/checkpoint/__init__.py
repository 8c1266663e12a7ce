from .checkpointer import Checkpointer, latest_step  # noqa: F401
