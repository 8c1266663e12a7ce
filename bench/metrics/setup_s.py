"""Set-up seconds: from the process's start to the window's start (imports,
loading or building the kernels, the parameters and batches, the checked
first steps)."""


def read(run: dict) -> float | None:
    return run["setup_s"]
