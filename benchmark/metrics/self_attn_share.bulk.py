"""self_attn_share.bulk: the device time of the valid-length
decode-attention kernel (self_attn_roofline's kernel_ns, which finds it
by its name in the device trace) over the decode loops' device time (Σ
`device_decode_ns` of the window's `model.job` spans), in %. Nothing to
read without that kernel in the trace or without the spans."""

from benchmark import spans
from benchmark.metrics.self_attn_roofline import kernel_ns


def read(ctx):
    if ctx.trace is None:
        return None
    found = spans.job_fields(ctx, "device_decode_ns")
    ns = kernel_ns(ctx)
    if found is None or ns <= 0:
        return None
    decode = sum(d for d, in found)
    return None if decode <= 0 else 100.0 * ns / decode
