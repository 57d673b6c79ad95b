"""decode_roofline: the least time of every decode step's work (work/decode.py)
over the device time of the operations launched by graph replays."""

from benchmark import readers


def read(ctx):
    return readers.roofline(ctx, "decode", graph=True)
