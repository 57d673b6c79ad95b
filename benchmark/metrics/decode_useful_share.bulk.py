"""decode_useful_share.bulk: the target tokens served (EOS included) over
the decode's row-steps (B bucket x the steps its loop ran), summed over
the window's `model.job` spans, in %."""

from benchmark import spans


def read(ctx):
    found = spans.job_fields(ctx, "target_tokens", "rows_padded", "steps")
    if found is None:
        return None
    row_steps = sum(rows * steps for _, rows, steps in found)
    return None if row_steps <= 0 else 100.0 * sum(t for t, _, _ in found) / row_steps
