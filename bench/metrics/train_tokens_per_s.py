"""Training tokens per second: the tokens of every step completed in the
window over the window's seconds (host clock; the window ends on the last
step's read-back and a synchronize)."""


def read(run: dict) -> float | None:
    w = run["window"]
    return w["tokens"] / w["seconds"] if w["steps"] else None
