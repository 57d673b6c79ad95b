"""rows_per_forward.bulk: sentences per device batch, averaged over the
forwards called in the window (the harness's wrapper on the Model)."""

from benchmark import readers


def read(ctx):
    return readers.rows_per_forward(ctx)
