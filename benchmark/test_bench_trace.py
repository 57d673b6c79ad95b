"""The trace's reduction: interval union, idle gaps, clipping to the
window, graph attribution, and the breakdown's shape."""

import numpy as np
import torch

from benchmark import trace


def synthetic():
    # ns: [0,10) graph, [5,20) eager, [30,40) graph, [50,55) eager
    return trace.DeviceTrace(["a", "b", "a", "c"], np.array([0, 5, 30, 50]),
                             np.array([10, 20, 40, 55]), np.array([True, False, True, False]), 0)


def test_busy_gaps_and_attribution():
    t = synthetic()
    assert t.busy_ns() == 20 + 10 + 5
    assert t.gaps(0.0, 60e-9) == [(20, 30), (40, 50), (55, 60)]
    assert t.op_ns(graph=True) == 20 and t.op_ns(graph=False) == 20 and t.op_ns() == 40
    assert t.by_name() == {"a": 20, "b": 15, "c": 5}


def test_within_clips_to_the_window():
    clipped = synthetic().within(8e-9, 35e-9)
    assert clipped.names == ["a", "b", "a"]
    assert clipped.start.tolist() == [8, 8, 30] and clipped.end.tolist() == [10, 20, 35]
    assert clipped.busy_ns() == 12 + 5


def test_breakdown_names_gaps_by_the_host():
    out = trace.breakdown(synthetic(), 0.0, 60e-9, lambda at: "x" if at < 45e-9 else "y")
    assert out["device_ops"][0] == ["a", 20e-9]
    assert out["idle_gaps"] == [["x", 10e-9], ["y", 10e-9], ["y", 5e-9]]


def test_reduce_events_of_a_profile_without_a_card():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(8) @ torch.ones(8)
    reduced = trace.reduce_events(prof.profiler.kineto_results.events(), 0)
    assert reduced.names == [] and reduced.busy_ns() == 0
