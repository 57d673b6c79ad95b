"""Each traffic mix is deterministic from the seed."""

import glob
import json
import os

import numpy as np
import pytest

from benchmark import harness, inputs, traffic

HERE = os.path.dirname(os.path.abspath(__file__))
MIXES = sorted(os.path.basename(p)[:-5] for p in glob.glob(os.path.join(HERE, "traffic", "*.json")))
SEED = 2**31 + 99


@pytest.fixture(scope="module")
def lexicon():
    return inputs.make_lexicon(SEED, 500, 1.1)


FINDER = harness.Finder([HERE])


def small(name: str) -> dict:
    return dict(traffic.load(HERE, name), call_lines=16, pool_lines_per_s=64)


def make(spec, lexicon, seed, seconds):
    return traffic.make(FINDER, spec, lexicon, seed, seconds)


@pytest.mark.parametrize("mix", MIXES)
def test_mix_is_deterministic_from_the_seed(mix, lexicon):
    spec = small(mix)
    first = make(spec, lexicon, SEED, 2.0).calls
    again = make(spec, lexicon, SEED, 2.0).calls
    other = make(spec, lexicon, SEED + 1, 2.0).calls
    assert first == again
    assert first != other


def test_bulk_lines_never_repeat_and_keep_their_lengths(lexicon):
    spec = small("bulk-docs")
    lane = make(spec, lexicon, SEED, 4.0)
    lines = [line for call in lane.calls for line in call]
    assert len(set(lines)) == len(lines)
    words = np.array([len(line.split()) for line in lines])
    clip = spec["line_words"]
    assert words.min() >= clip["min"] and words.max() <= clip["max"]
    assert len(lane.calls) == -(-spec["pool_lines_per_s"] * 4 // spec["call_lines"]) + spec["clients"]
    # calls past the pool are made on demand, in order, from the same stream
    extra = lane._call(len(lane.calls) + 1)
    assert len(extra) == spec["call_lines"] and lane.generated_in_window == 2


@pytest.mark.parametrize("seed", [SEED, SEED + 3])
def test_repeat_share_repeats_earlier_lines(lexicon, seed):
    spec = dict(small("bulk-docs"), repeat_share=0.08)
    lane = make(spec, lexicon, seed, 8.0)
    lines = [line for call in lane.calls for line in call]
    first, repeats = set(), 0
    for line in lines:
        repeats += line in first
        first.add(line)
    assert 0.04 < repeats / len(lines) < 0.12
    assert make(spec, lexicon, seed, 8.0).calls == lane.calls
    unique = make(dict(spec, repeat_share=0.0), lexicon, seed, 8.0)
    assert len({line for call in unique.calls for line in call}) == len(lines)


def test_every_mix_names_its_lane_and_service():
    for mix in MIXES:
        spec = traffic.load(HERE, mix)
        assert os.path.exists(os.path.join(HERE, "lanes", spec["lane"] + ".py"))
        assert "wrap_length" in spec["service"]
        json.dumps(spec)
