"""K4 and K5 (``kernels/softmax_xent``) against their roofline: the summed
bound of their launches over their summed device time, in percent.

Launches are counted from the trace by kernel name: a forward call is one
``xent_fwd`` kernel (rows or lane) and its ``xent_mean`` kernel, whose time
counts too; a backward call one ``xent_dlogits`` kernel.  Each call's bound
is ``roofline.xent_fwd`` or ``xent_dlogits`` at the loss's shape: a
microbatch's tokens by the padded vocabulary, fp32 logits."""

from bench import roofline


def read(run: dict) -> float | None:
    t = run["trace"]
    if t is None:
        return None
    n_fwd = n_bwd = 0
    seconds = 0.0
    for name, (count, s) in t["device_ops"].items():
        if "xent_fwd" in name:
            n_fwd += count
        elif "xent_dlogits" in name:
            n_bwd += count
        elif "xent_mean" not in name:
            continue
        seconds += s
    if seconds <= 0:
        return None
    cfg, tr = run["config"], run["traffic"]
    rows = tr["batch"] // tr["microbatches"] * tr["seq"]
    m = cfg["run"]["vocab_pad_multiple"]
    vocab = -(-cfg["vocab_size"] // m) * m
    bound = (n_fwd * roofline.xent_fwd(rows, vocab, 4).bound_s()
             + n_bwd * roofline.xent_dlogits(rows, vocab, 4).bound_s())
    return 100.0 * bound / seconds
