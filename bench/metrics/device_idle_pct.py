"""The share of the traced window in which no operation ran on the card:
one minus the union of the device intervals over the window, in percent."""


def read(run: dict) -> float | None:
    t = run["trace"]
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
