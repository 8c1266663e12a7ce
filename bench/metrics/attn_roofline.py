"""K6 and its backward (``kernels/flash_attention``) against their roofline:
the summed bound of their launches over their summed device time, in
percent.

Launches are counted from the trace by kernel name: a forward call is one
``flash_fwd`` kernel, a backward call one fused ``flash_bwd_wgmma`` (bf16)
or ``flash_bwd_tf32`` (fp32) kernel beside its prep and dQ kernels, whose
time counts too.  Each call's bound is ``roofline.flash_attention`` or
``flash_attention_bwd`` at the step's attention shape: a microbatch's
sequences, every query head, causal."""

from bench import roofline

FWD = ("flash_fwd",)
BWD = ("flash_bwd_wgmma", "flash_bwd_tf32")
ALL = ("flash_fwd", "flash_bwd")


def _count(ops: dict, tags) -> tuple[int, float]:
    n, s = 0, 0.0
    for name, (count, seconds) in ops.items():
        if any(t in name for t in tags):
            n, s = n + count, s + seconds
    return n, s


def read(run: dict) -> float | None:
    t = run["trace"]
    if t is None:
        return None
    ops = t["device_ops"]
    n_fwd, _ = _count(ops, FWD)
    n_bwd, _ = _count(ops, BWD)
    _, seconds = _count(ops, ALL)
    if seconds <= 0:
        return None
    cfg, tr = run["config"], run["traffic"]
    size = 2 if cfg["run"]["compute_dtype"] == "bfloat16" else 4
    shape = (tr["batch"] // tr["microbatches"], cfg["num_attention_heads"],
             cfg["num_key_value_heads"], tr["seq"], tr["seq"],
             cfg["head_dim"], size, True)
    bound = (n_fwd * roofline.flash_attention(*shape).bound_s()
             + n_bwd * roofline.flash_attention_bwd(*shape).bound_s())
    return 100.0 * bound / seconds
