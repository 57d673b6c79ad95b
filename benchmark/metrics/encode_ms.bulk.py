"""encode_ms.bulk: the device time from a job's start to its decode
loop's start (the inputs' copies, the embedding, the encoder and the
cross-K/V; CUDA events), averaged over the window's `model.job` spans,
in milliseconds."""

import statistics

from benchmark import spans


def read(ctx):
    found = spans.job_fields(ctx, "device_encode_ns")
    return None if found is None else statistics.fmean(ns for ns, in found) / 1e6
