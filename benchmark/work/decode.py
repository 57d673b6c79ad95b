"""Every decode step's work in a set of forwards, as the configuration's
architecture counts it: `WORK["decode"]` of the file its "reference" key
names."""

from benchmark import readers


def count(cfg: dict, forwards, shortlist_width=None, architecture=None) -> dict:
    architecture = architecture or readers.architecture(cfg)
    return architecture.WORK["decode"](cfg, forwards, shortlist_width)
