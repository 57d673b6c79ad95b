"""setup_s: seconds from the process start to the window's start (loading,
weights, warm-up and, in a checkout's first run, the kernel build)."""


def read(ctx):
    return ctx.setup_s
