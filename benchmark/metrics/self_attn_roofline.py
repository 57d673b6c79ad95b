"""self_attn_roofline: the least time of the self-attention decoder's
cache reads (the `SELF_ATTENTION` count of the configuration's
architecture file) over the device time of the valid-length
decode-attention kernel, found by its name in the device trace, in %.
Nothing to read where the architecture has no such count or the trace
holds no such kernel (a program without it)."""

from benchmark import readers

KERNEL = "decode_self_attention"


def kernel_ns(ctx) -> int:
    """The device time of the valid-length kernel (either of its grids)."""
    return sum(ns for name, ns in ctx.trace.by_name().items() if KERNEL in name)


def read(ctx):
    count = getattr(ctx.architecture, "SELF_ATTENTION", None)
    if count is None or ctx.trace is None or ctx.peaks is None or not ctx.forwards:
        return None
    ns = kernel_ns(ctx)
    if ns <= 0:
        return None
    least = readers.least_time(count(ctx.config, ctx.forwards), ctx.peaks)["least_s"]
    return 100.0 * least / (ns / 1e9)
