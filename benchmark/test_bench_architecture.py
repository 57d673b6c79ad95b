"""Everything that depends on a model's architecture lives in the file that
a configuration's "reference" key names: the shared harness names none,
and moving Bergamot's pieces there left its planted weights byte for byte
as they were."""

import glob
import hashlib
import json
import os
import re

import pytest

from benchmark import inputs, readers

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 2**31 + 3
# SHA-256 of inputs.marian_bytes(inputs.make_weights(cfg, SEED, "cpu")) for each
# configuration, computed at commit e6a25c8 (before the layout and the planted
# settings moved out of inputs.py into reference/bergamot.py) with torch 2.13 on the CPU.
DIGESTS = {
    "bergamot-tiny11": "4554733df90007db8fa31ddd4ca0bfea3f2c491aff571c19f0d42f6975d0428f",
    "bergamot-base": "54412ddede32688dc68ecfb410f1e01adcb2b729f66413d557945f0e86f30d59",
}
SHARED = ["harness.py", "inputs.py", "control.py", "readers.py", "reference/check.py",
          *sorted(os.path.relpath(p, HERE) for p in glob.glob(os.path.join(HERE, "work", "*.py")))]


def config(name: str) -> dict:
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_planted_weights_are_the_same_bytes(name):
    weights = inputs.make_weights(config(name), SEED, "cpu")
    assert hashlib.sha256(inputs.marian_bytes(weights)).hexdigest() == DIGESTS[name]


def architecture_names() -> set:
    """What an architecture file names, over every configuration: its
    reference class, each array of its layout and each activation
    multiplier, and each array's name after its layer number."""
    names = {"Bergamot"}
    for path in glob.glob(os.path.join(HERE, "configs", "*.json")):
        cfg = config(os.path.basename(path)[:-5])
        architecture = readers.architecture(cfg)
        names.add(architecture.Reference.__name__)
        matrices, vectors = architecture.layout(cfg)
        for name in [m[0] for m in matrices] + [v[0] for v in vectors]:
            names |= {name, architecture.activation_name(name), re.sub(r"^.*_l\d+", "", name)}
    return names


@pytest.mark.parametrize("path", SHARED)
def test_shared_code_names_no_architecture(path):
    with open(os.path.join(HERE, path)) as f:
        text = f.read()
    assert sorted(name for name in architecture_names() if name in text) == []
