"""The readers of the program's spans (metrics/*.py over spans.py) on
synthetic spans and a synthetic device trace: each reader's arithmetic,
starved + in-job idle = idle_share, the phase table, and None where the
program records no spans or the run was not traced."""

import types

import numpy as np
import pytest

import slimt_tpu_torch.utils as program_utils
from benchmark import harness, readers, spans, trace

WORKER = "slimt-dispatch-0"


def record(name, start, end, thread=WORKER, cpu=0, **fields):
    out = program_utils.SpanRecord()
    out.name, out.start_ns, out.end_ns, out.cpu_ns = name, start, end, cpu
    out.thread, out.tid, out.id, out.parent, out.batch = thread, 1, 0, None, None
    out.fields = fields
    return out


# ns on both clocks (offset 0): the card busy [0,10) [30,40) [60,70) of a
# [0,100] window; jobs [5,45] and [65,80]; so idle 70, in-job 20+5+10.
SPANS = [
    record("model.job", 5, 45, rows_padded=4, steps=8, target_tokens=16,
           device_encode_ns=2_000_000, device_decode_ns=8_000),
    record("model.job", 65, 80, rows_padded=8, steps=16, target_tokens=64,
           device_encode_ns=4_000_000, device_decode_ns=24_000),
    record("model.h2d", 5, 15, cpu=5),
    record("decode.encoder", 15, 45, cpu=30),
    record("decode.loop", 65, 80, cpu=0),
    record("bulk.assemble", 50, 58, thread="bench-client-0"),
]


def context(with_trace=True):
    device = trace.DeviceTrace(["a", "b", "c"], np.array([0, 30, 60]), np.array([10, 40, 70]),
                               np.array([False, True, True]), 0)
    return types.SimpleNamespace(window=types.SimpleNamespace(start=0.0, end=100e-9),
                                 window_s=100e-9, trace=device if with_trace else None)


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(program_utils, "spans_between", lambda t0, t1: list(SPANS))


def read(name, ctx):
    return harness.Finder([spans.__file__.rsplit("/", 1)[0]]).module("metrics", name).read(ctx)


@pytest.mark.parametrize("name,want", [
    ("idle_starved_share.bulk", 35.0),
    ("idle_in_job_share.bulk", 35.0),
    ("worker_launch_cpu_share.bulk", 100.0 * 35 / 40),
    ("decode_useful_share.bulk", 100.0 * 80 / (4 * 8 + 8 * 16)),
    ("decode_step_us.bulk", 32_000 / 24 / 1e3),
    ("encode_ms.bulk", 3.0),
])
def test_readers_on_synthetic_spans(recorded, name, want):
    assert read(name, context()) == pytest.approx(want)


def test_starved_and_in_job_sum_to_the_idle_share(recorded):
    ctx = context()
    total = read("idle_starved_share.bulk", ctx) + read("idle_in_job_share.bulk", ctx)
    assert total == pytest.approx(readers.idle_share(ctx)) and total == pytest.approx(70.0)


def test_phase_table_splits_the_idle_time(recorded):
    table = spans.phase_table(context())
    assert table["idle_s"] == pytest.approx(70e-9) and table["in_job_s"] == pytest.approx(35e-9)
    assert table["in_job_by_worker_span"]["model.h2d"] == pytest.approx(5e-9)
    assert table["in_job_by_worker_span"]["decode.encoder"] == pytest.approx(20e-9)
    assert table["in_job_by_worker_span"]["decode.loop"] == pytest.approx(10e-9)
    assert sum(table["in_job_by_worker_span"].values()) == pytest.approx(table["in_job_s"])
    assert table["starved_by_caller_span"]["bulk.assemble"] == pytest.approx(8e-9)
    assert table["starved_by_caller_span"]["none"] == pytest.approx(27e-9)
    assert table["starved_s"] == pytest.approx(35e-9)


def test_interval_arithmetic():
    first = spans.union([(0, 10), (20, 30), (5, 12)])
    second = spans.union([(8, 22), (25, 26)])
    assert first.tolist() == [[0, 12], [20, 30]]
    assert spans.intersect(first, second).tolist() == [[8, 12], [20, 22], [25, 26]]
    assert spans.subtract(first, second).tolist() == [[0, 8], [22, 25], [26, 30]]
    assert spans.length(first) == spans.length(spans.intersect(first, second)) + \
        spans.length(spans.subtract(first, second))


@pytest.mark.parametrize("name", ["idle_starved_share.bulk", "idle_in_job_share.bulk"])
def test_idle_readers_need_the_trace(recorded, name):
    assert read(name, context(with_trace=False)) is None


@pytest.mark.parametrize("name", ["idle_starved_share.bulk", "idle_in_job_share.bulk",
                                  "worker_launch_cpu_share.bulk", "decode_useful_share.bulk",
                                  "decode_step_us.bulk", "encode_ms.bulk"])
def test_a_program_without_spans_reads_none(monkeypatch, name):
    monkeypatch.delattr(program_utils, "spans_between")
    assert read(name, context()) is None
    monkeypatch.setattr(program_utils, "spans_between", lambda t0, t1: [], raising=False)
    assert read(name, context()) is None
