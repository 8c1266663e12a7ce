"""Peak device memory in GB (1e9 bytes): ``torch.cuda.max_memory_allocated``
from before the train state is made through the window's end, the
reference's work excluded."""


def read(run: dict) -> float | None:
    return run["peak_bytes"] / 1e9 if run["peak_bytes"] else None
