"""The whole step's share of the card's bf16 peak: model FLOPs of the
window's steps (``roofline.train_step_flops``: 6 x active parameters x
tokens plus the causal attention products, no recompute) over the window's
seconds times 989 TFLOP/s, in percent.  Read in the traced run."""

from bench import roofline


def read(run: dict) -> float | None:
    w = run["window"]
    if not w["steps"]:
        return None
    flops = w["steps"] * roofline.train_step_flops(run["config"],
                                                   run["traffic"])
    return 100.0 * flops / (w["seconds"] * roofline.PEAK["bfloat16"])
