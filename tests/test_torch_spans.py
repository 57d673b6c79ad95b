"""The port's span recorder (utils.span) and its counters: nothing recorded
while off, nesting, parents, threads and shared batch ids, the bounded
deque, the span tree of a Model forward with the arithmetic of its
`model.job` fields, Model.counters(), tokens bit-equal with recording on
and off, one shortlist generation a batch, the repaired words-per-second
meter, and utils.trace writing the spans into its Chrome trace. The last
test runs on the card only: a kernel launched inside a span lands, on the
device trace's clock, inside it. This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_spans.py -q
"""

import concurrent.futures
import glob
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from slimt_tpu_torch import Model, ModelConfig, Package, utils  # noqa: E402
from slimt_tpu_torch.io.shortlist import ShortlistGenerator, build_synthetic_shortlist  # noqa: E402
from slimt_tpu_torch.io.synthetic import synthetic_model_bytes  # noqa: E402
from slimt_tpu_torch.models import decode  # noqa: E402
from slimt_tpu_torch.text import spm_proto  # noqa: E402
from slimt_tpu_torch.text.synthetic_vocab import DEFAULT_WORDS, build_spm_model  # noqa: E402

CONFIG = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=4)
VOCAB = 256
WORKER = {"model.job", "model.h2d", "decode.encoder", "decode.cross_kv", "decode.bind",
          "decode.loop", "decode.flag_wait", "model.d2h"}


def make_model(shortlist: bool, device="cpu") -> Model:
    spm = spm_proto.serialize_model(build_spm_model(DEFAULT_WORDS, target_size=VOCAB))
    weights = synthetic_model_bytes(config=CONFIG, vocab_size=VOCAB, emb_dim=64, ffn_dim=128,
                                    seed=3)
    listed = build_synthetic_shortlist(VOCAB, seed=3) if shortlist else None
    return Model(CONFIG, Package(weights, spm, listed), device=device)


@pytest.fixture(scope="module", params=[False, True], ids=["full", "shortlist"])
def model(request):
    return make_model(request.param)


def segments(model, rows: int, shift: int = 0):
    return [[3 + (i * 7 + j + shift) % 200 for j in range(4 + 3 * i)] + [model.vocabulary.eos_id]
            for i in range(rows)]


def recorded(t0: float):
    return sorted(utils.spans_between(t0, time.perf_counter()), key=lambda r: r.start_ns)


def test_nothing_records_while_off():
    assert not utils.recording_on()
    first = utils.span("a", batch=1, rows=2)
    assert first is utils.span("b") and not first.on
    t0 = time.perf_counter()
    with first as s:
        s.set(x=1)
    assert recorded(t0) == []


def test_nothing_records_in_a_forward_while_off(model, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function or a CUDA event on the off path")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    t0 = time.perf_counter()
    model.forward(segments(model, 3), need_alignment=False)
    assert recorded(t0) == []


def test_nesting_parents_threads_and_batches():
    t0 = time.perf_counter()
    with utils.recording():
        with utils.span("outer", batch=7, n=1):
            with utils.span("inner") as inner:
                inner.set(m=2)
            with utils.span("other", batch=8):
                pass

        def on_thread():
            with utils.span("alone"):
                pass

        thread = threading.Thread(target=on_thread, name="span-test-thread")
        thread.start()
        thread.join(timeout=30)
        assert not thread.is_alive()
    spans = {r.name: r for r in recorded(t0)}
    outer, inner, other, alone = (spans[n] for n in ("outer", "inner", "other", "alone"))
    assert outer.parent is None and inner.parent == outer.id and other.parent == outer.id
    assert (outer.batch, inner.batch, other.batch, alone.batch) == (7, 7, 8, None)
    assert outer.fields == {"n": 1} and inner.fields == {"m": 2}
    assert alone.parent is None and alone.thread == "span-test-thread"
    assert outer.thread == inner.thread == threading.current_thread().name
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= other.start_ns <= outer.end_ns
    assert 0 <= outer.cpu_ns


def test_the_deque_is_bounded_and_counts_its_drops(monkeypatch):
    small = utils.SpanRecorder(capacity=3)
    monkeypatch.setattr(utils, "RECORDER", small)
    with utils.recording():
        for i in range(5):
            with utils.span(f"s{i}"):
                pass
    assert [r.name for r in small.between(0.0, time.perf_counter())] == ["s2", "s3", "s4"]
    assert small.dropped == 2


def expected_steps(valid_rows: np.ndarray, limit: int) -> int:
    """chunks x k of a loop whose flag is read at once every check_every
    steps, rounded up to whole chunks (decode.run_loops)."""
    def ceil(a, b):
        return -(-a // b)

    k = decode.resolve_unroll(None)
    every = ceil(decode.CHECK_EVERY, k)
    # The chunk in which the last row completed, read at the next read.
    done = ceil(ceil(int(valid_rows.max()), k), every) * every
    return min(ceil(limit, k), done) * k


def test_a_forward_records_the_span_tree(model):
    rows = 3
    segs = segments(model, rows)
    t0 = time.perf_counter()
    with utils.recording():
        finish = model.forward_async(segs, need_alignment=False, raw=True)
        with concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="span-pool") as pool:
            tokens, steps, _ = pool.submit(finish).result(timeout=120)
    spans = recorded(t0)
    names = [r.name for r in spans]
    by_name = {r.name: r for r in spans}
    caller = {"model.prepare"} | ({"model.shortlist"} if model.shortlist_generator else set())
    assert set(names) == caller | WORKER | {"model.finish"}
    assert len({r.batch for r in spans}) == 1 and spans[0].batch is not None
    job = by_name["model.job"]
    prepare = by_name["model.prepare"]
    assert prepare.thread == threading.current_thread().name and prepare.parent is None
    assert job.thread.startswith("slimt-dispatch-") and job.parent is None
    assert by_name["model.finish"].thread.startswith("span-pool")
    for name in WORKER - {"model.job", "decode.flag_wait"}:
        assert by_name[name].parent == job.id and by_name[name].thread == job.thread, name
    assert {r.parent for r in spans if r.name == "decode.flag_wait"} == {by_name["decode.loop"].id}
    if model.shortlist_generator:
        assert by_name["model.shortlist"].parent == prepare.id
    t_pad = 16
    limit = int(1.5 * max(len(s) for s in segs))
    fields = job.fields
    assert (fields["rows"], fields["rows_padded"], fields["t_pad"]) == (rows, 4, t_pad)
    assert fields["target_tokens"] == int(steps.sum())
    assert fields["steps"] == expected_steps(steps, limit) and tokens.shape[1] == int(1.5 * t_pad)
    assert prepare.start_ns <= fields["submitted_ns"] <= job.start_ns
    assert "device_encode_ns" not in fields  # CUDA events only on the card


def test_counters_add_each_forward(model):
    before = model.counters()
    shapes = []
    for rows, shift in ((3, 0), (5, 11)):
        segs = segments(model, rows, shift)
        _, steps, _ = model.forward_async(segs, need_alignment=False, raw=True)()
        t_pad = 16 if max(map(len, segs)) <= 16 else 32
        b_pad = 4 if rows <= 4 else 8
        shapes.append((rows, b_pad, sum(map(len, segs)), b_pad * t_pad,
                       b_pad * expected_steps(steps, int(1.5 * max(map(len, segs)))),
                       int(steps.sum())))
    after = model.counters()
    delta = {k: after[k] - before[k] for k in after}
    want = dict(zip(("rows", "rows_padded", "source_tokens", "source_slots", "row_steps",
                     "target_tokens"), map(sum, zip(*shapes))))
    assert delta == dict(want, forwards=2, hits=0, misses=0, evictions=0, capture_s=0.0)


def test_graph_cache_counts_the_seconds_of_evicted_captures():
    from types import SimpleNamespace

    from slimt_tpu_torch.models.loop_graph import GraphCache

    cache = GraphCache(capacity=1)
    cpu = torch.device("cpu")
    for key, ms in ((1, 30.0), (2, 12.5)):
        cache.bucket(key, lambda: SimpleNamespace(run_chunk=lambda: None), cpu).graph \
            .capture_ms = ms
    cache.bucket(3, lambda: SimpleNamespace(run_chunk=lambda: None), cpu)  # not captured yet
    assert cache.counts == {"hits": 0, "misses": 3, "evictions": 2}
    assert cache.capture_s == pytest.approx(0.0425)


def test_tokens_are_bit_equal_with_recording_on_and_off(model):
    segs = segments(model, 6, 5)
    off = model.forward_async(segs, need_alignment=False, raw=True)()
    with utils.recording():
        on = model.forward_async(segs, need_alignment=False, raw=True)()
    np.testing.assert_array_equal(on[0], off[0])
    np.testing.assert_array_equal(on[1], off[1])


def test_one_shortlist_generation_a_batch(monkeypatch):
    model = make_model(True)
    generator = model.shortlist_generator
    calls = []
    generate = generator.generate

    def counted(words):
        calls.append(len(words))
        return generate(words)

    monkeypatch.setattr(generator, "generate", counted)
    segs = segments(model, 4)
    model.forward(segs, need_alignment=False)
    assert calls == [sum(map(len, segs))]
    words = [w for s in segs for w in s]
    snap = model.shortlist_meter.snapshot()
    assert snap["avg_generated_width"] == len(generate(words))
    assert snap["avg_padded_width"] == len(generator.generate_padded(words, 1024))


@pytest.mark.parametrize("bucket", [8, 64, 1024])
def test_pad_of_generate_is_generate_padded(bucket):
    generator = ShortlistGenerator(build_synthetic_shortlist(500, best=10, frequent=30, seed=2),
                                   vocab_size=500)
    for seed in range(3):
        words = np.random.default_rng(seed).integers(0, 500, 40).tolist()
        np.testing.assert_array_equal(generator.pad(generator.generate(words), bucket),
                                      generator.generate_padded(words, bucket))


def test_wps_is_a_ratio_of_sums():
    meters = utils.ServiceMeters()
    assert meters.wps() == 0.0
    meters.record_batch(words=100, elapsed=1.0, used=100, capacity=200)
    meters.record_batch(words=10, elapsed=0.001, used=10, capacity=10)
    assert meters.batches == 2
    assert meters.wps() == pytest.approx(110 / 1.001)
    assert meters.occupancy.average() == pytest.approx(0.75)


def test_trace_writes_the_spans_into_its_chrome_trace(tmp_path):
    with utils.trace("spans_scope", str(tmp_path)):
        assert utils.recording_on()
        with utils.span("phase", batch=3, rows=4):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = glob.glob(str(tmp_path / "spans_scope.*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    scope = next(e for e in events if e.get("name") == "spans_scope")
    phase = next(e for e in events if e.get("name") == "phase")
    assert phase["ph"] == "X" and phase["args"]["batch"] == 3 and phase["args"]["rows"] == 4
    # On the trace's own clock: inside the profiler's scope event.
    assert scope["ts"] - 500 <= phase["ts"] and phase["ts"] + phase["dur"] <= scope["ts"] + \
        scope["dur"] + 500


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_a_kernel_in_a_span_lands_inside_it_on_the_device_clock(card):
    """Under the harness's capture (CUDA activity alone), which must turn
    the spans on by itself, a sleeping kernel launched in a span starts
    no earlier than 0.5 ms before the span and ends before the span's end
    plus its length; a Model's job carries its device times."""
    from benchmark import trace as tracing

    model = make_model(False, device=card)
    model.forward(segments(model, 3), need_alignment=False)  # capture its graph
    with tracing.Capture(card) as capture:
        start = time.perf_counter()
        assert utils.recording_on()
        with utils.span("sleep"):
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize(card)
        model.forward(segments(model, 3), need_alignment=False)
        end = time.perf_counter()
    spans = {r.name: r for r in utils.spans_between(start, end)}
    sleep = spans["sleep"]
    longest = int(np.argmax(capture.trace.end - capture.trace.start))
    kernel = (int(capture.trace.start[longest]), int(capture.trace.end[longest]))
    lo, hi = (capture.trace.to_ns(ns / 1e9) for ns in (sleep.start_ns, sleep.end_ns))
    assert kernel[0] >= lo - 500_000 and kernel[1] <= hi + (hi - lo), (kernel, lo, hi)
    job = spans["model.job"].fields
    wall = spans["model.job"].end_ns - spans["model.job"].start_ns
    assert 0 < job["device_encode_ns"] and 0 < job["device_decode_ns"]
    assert job["device_encode_ns"] + job["device_decode_ns"] <= wall
    assert job["steps"] > 0 and job["target_tokens"] > 0
