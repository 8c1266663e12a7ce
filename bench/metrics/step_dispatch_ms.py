"""The host's side of the step: the median milliseconds from calling the
train step to its return, before its loss and gradient norm are read back
(the host's enqueue of the step's work)."""

import statistics


def read(run: dict) -> float | None:
    d = run["window"]["dispatch_s"]
    return 1e3 * statistics.median(d) if d else None
