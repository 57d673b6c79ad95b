"""tokens_per_s: target tokens served (EOS included) over the whole
window, first timed call's start to last timed call's end."""


def read(ctx):
    if ctx.window_s <= 0:
        return None
    return sum(int(f.steps.sum()) for f in ctx.forwards) / ctx.window_s
