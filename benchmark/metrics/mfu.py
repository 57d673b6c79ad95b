"""mfu: the whole step's share of the chip's peak: the least compute time of
every phase's work in the window (int8 products at the int8 peak,
attention at the float32 peak) over the window's wall time, in %."""

from benchmark import readers


def read(ctx):
    if ctx.peaks is None or not ctx.forwards or ctx.window_s <= 0:
        return None
    compute = sum(readers.least_time(ctx.work(phase), ctx.peaks)["compute_s"]
                  for phase in ctx.phases)
    return 100.0 * compute / ctx.window_s
