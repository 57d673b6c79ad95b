"""encoder_roofline: the least time of the encoder phase's work (work/encoder.py)
over the device time of the operations not launched by graph replays."""

from benchmark import readers


def read(ctx):
    return readers.roofline(ctx, "encoder", graph=False)
