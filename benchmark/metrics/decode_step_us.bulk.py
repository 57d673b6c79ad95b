"""decode_step_us.bulk: the decode loop's device time (CUDA events from
the loop's start, its binding included, to its end) over the steps it
ran, summed over the window's `model.job` spans, in microseconds."""

from benchmark import spans


def read(ctx):
    found = spans.job_fields(ctx, "device_decode_ns", "steps")
    if found is None:
        return None
    steps = sum(s for _, s in found)
    return None if steps <= 0 else sum(ns for ns, _ in found) / steps / 1e3
