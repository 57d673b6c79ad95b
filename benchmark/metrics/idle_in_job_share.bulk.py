"""idle_in_job_share.bulk: the share of the traced window in which the
card ran nothing while the program's dispatch worker was inside a
`model.job` span (its own host work between launches), in %."""

from benchmark import spans


def read(ctx):
    split = spans.idle_split(ctx)
    return None if split is None else spans.window_share(split[1], ctx)
