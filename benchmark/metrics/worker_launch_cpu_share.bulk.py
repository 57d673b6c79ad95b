"""worker_launch_cpu_share.bulk: the dispatch worker's thread CPU time
over its wall time, summed over its `model.h2d`, `decode.encoder`,
`decode.cross_kv` and `decode.bind` spans in the window, in %. Low: the
worker waited (for the interpreter lock, not for the card) while it
launched."""

from benchmark import spans


def read(ctx):
    found = [s for s in spans.window_spans(ctx) or () if s.name in spans.WORKER_LAUNCH]
    wall = sum(s.end_ns - s.start_ns for s in found)
    if wall <= 0:
        return None
    return 100.0 * sum(s.cpu_ns for s in found) / wall
