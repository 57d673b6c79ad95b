"""The encoder phase's work in a set of forwards (the embedding, the
encoder layers and whatever the decoder caches from them), as the
configuration's architecture counts it: `WORK["encoder"]` of the file its
"reference" key names."""

from benchmark import readers


def count(cfg: dict, forwards, shortlist_width=None, architecture=None) -> dict:
    architecture = architecture or readers.architecture(cfg)
    return architecture.WORK["encoder"](cfg, forwards, shortlist_width)
