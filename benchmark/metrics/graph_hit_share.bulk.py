"""graph_hit_share.bulk: the decode loop's graph-cache lookups over the
window that found their graph: hits / (hits + misses), in %."""

from benchmark import readers


def read(ctx):
    return readers.graph_hit_share(ctx)
