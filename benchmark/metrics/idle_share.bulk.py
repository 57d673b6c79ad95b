"""idle_share.bulk: the share of the traced window in which no operation
ran on the card (the union of kernel, copy and memset intervals), in %."""

from benchmark import readers


def read(ctx):
    return readers.idle_share(ctx)
