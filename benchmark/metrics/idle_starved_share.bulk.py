"""idle_starved_share.bulk: the share of the traced window in which the
card ran nothing and the program's dispatch worker was outside every
`model.job` span (its callers had not fed it), in %. With
idle_in_job_share.bulk it sums to idle_share.bulk."""

from benchmark import spans


def read(ctx):
    split = spans.idle_split(ctx)
    return None if split is None else spans.window_share(split[0], ctx)
