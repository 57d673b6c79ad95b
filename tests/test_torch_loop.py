"""The port's chunked decode loop (slimt_tpu_torch/models/decode.py) against
slimt_tpu.models.decode.translate_batch: `loop_unroll` steps a chunk with
JAX's meaning, tokens and valid equal for k in {1, 2, 3} with odd
max_steps and a cap that is not a multiple of k, on the declared and
fused_step providers; the per-step position signal from the device step;
how often the host reads the all-complete flag (check_every rounded up
to whole chunks, read at once or one chunk behind); the unroll default
and its environment variable; the graph cache's LRU.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from slimt_tpu.config import ModelConfig  # noqa: E402
from slimt_tpu.io import load_items  # noqa: E402
from slimt_tpu.io.loader import load_weights  # noqa: E402
from slimt_tpu.io.synthetic import synthetic_model_bytes  # noqa: E402
from slimt_tpu.models import decode as jdecode  # noqa: E402
from slimt_tpu_torch.io.params import params_from_numpy  # noqa: E402
from slimt_tpu_torch.models import decode, loop_graph  # noqa: E402
from slimt_tpu_torch.models import transformer as tfm  # noqa: E402

# The sizes of tests/test_continuous.py.
CONFIG = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=4)
VOCAB, EMB, FFN = 96, 32, 64
EOS = 2


@pytest.fixture(scope="module")
def weights():
    host = load_weights(load_items(synthetic_model_bytes(
        config=CONFIG, vocab_size=VOCAB, emb_dim=EMB, ffn_dim=FFN, seed=11)), CONFIG)
    return host, params_from_numpy(host, "cpu")


def _batch(seed=21):
    rng = np.random.default_rng(seed)
    b, t = 4, 12
    ids = rng.integers(3, VOCAB, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.float32)
    mask[1, 7:] = 0
    mask[3, :] = 0  # a padding row: starts complete
    ids[mask == 0] = 0
    return ids, mask


def _both(weights, provider, unroll, max_steps, cap, with_alignment=True,
          position_zero=True):
    host, tp = weights
    ids, mask = _batch()
    kwargs = dict(eos_id=EOS, max_steps=max_steps, num_heads=CONFIG.num_heads,
                  provider=provider, decoder_position_zero=position_zero,
                  with_alignment=with_alignment, kv_dtype="int16",
                  argmax_method="packed_int")
    want = jdecode.translate_batch(
        host, jnp.asarray(ids), jnp.asarray(mask), **kwargs, loop_unroll=unroll,
        steps_cap=None if cap is None else jnp.int32(cap))
    got = decode.translate_batch(
        tp, torch.from_numpy(ids), torch.from_numpy(mask), **kwargs,
        loop_unroll=unroll, steps_cap=cap)
    return want, got


@pytest.mark.parametrize("max_steps,cap", [(8, None), (9, None), (9, 7)])
@pytest.mark.parametrize("unroll", [1, 2, 3])
@pytest.mark.parametrize("provider", [None, "fused_step"], ids=["declared", "fused_step"])
def test_loop_unroll_matches_jax(weights, provider, unroll, max_steps, cap):
    want, got = _both(weights, provider, unroll, max_steps, cap)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert tuple(got.tokens.shape) == (4, max_steps)
    # The tolerance tests/test_torch_decode.py holds the alignment to.
    np.testing.assert_allclose(got.alignment.numpy(), np.asarray(want.alignment),
                               atol=1e-5, rtol=0)
    assert not got.valid[3].any()  # the padding row records nothing
    if cap is not None:
        assert not got.valid[:, cap:].any()


@pytest.mark.parametrize("unroll", [1, 3])
@pytest.mark.parametrize("provider", [None, "fused_step"], ids=["declared", "fused_step"])
def test_per_position_signal_from_the_device_step_matches_jax(weights, provider, unroll):
    """decoder_position_zero=False: each step's position comes from the
    loop's device step."""
    want, got = _both(weights, provider, unroll, 9, None, with_alignment=False,
                      position_zero=False)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


def _loop(weights, rows, unroll, max_steps=12, eos=EOS):
    """A DecodeLoop over `rows` of the batch, reset to its limit."""
    _, tp = weights
    ids, mask = (torch.from_numpy(a[rows]) for a in _batch())
    mask_add = tfm.make_additive_mask(mask)
    enc = tfm.encoder_forward(tp, tfm.transform_embedding(tfm.embed(tp, ids)),
                              mask_add, CONFIG.num_heads)
    kv = tfm.precompute_cross_kv(tp, enc, CONFIG.num_heads, "int16")
    loop = decode.DecodeLoop(
        tp, kv, mask_add, tfm.prepare_output_projection(tp), None, eos_id=eos,
        num_heads=CONFIG.num_heads, max_steps=max_steps, unroll=unroll, provider=None,
        argmax_method="packed_int", attn_kernel=False, with_alignment=False,
        decoder_position_zero=True)
    loop.reset(max_steps)
    return loop


@pytest.mark.parametrize("check_every,unroll,chunks", [
    (1, 2, 1), (2, 2, 1), (3, 2, 2), (5, 2, 3), (8, 3, 3), (100, 4, 3)])
def test_flag_read_every_check_every_steps_rounded_up_to_chunks(
        weights, check_every, unroll, chunks):
    # Only the padding row: complete from the start, so the first read
    # stops the loop; `chunks` chunks run before it (12 steps at most).
    loop = _loop(weights, [3], unroll)
    with torch.inference_mode():
        assert decode.run_loop(loop, 12, check_every) == chunks
    assert int(loop.step_at) == chunks * unroll


def test_a_flag_read_one_chunk_behind_runs_one_chunk_more(weights):
    """The graph loop's reads (lag 1) stop one chunk after the eager
    loop's (lag 0), with the same tokens: the extra steps are masked."""
    ran = {}
    out = {}
    for lag in (0, 1):
        # Rows 0 and 2 emit 31 at step 1; row 3 is padding.
        loop = _loop(weights, [0, 2, 3], 2, max_steps=40, eos=31)
        with torch.inference_mode():
            chunk = loop.run_chunk if lag else None
            ran[lag] = decode.run_loop(loop, 40, 1, chunk)
        out[lag] = loop.result()
    assert ran == {0: 1, 1: 2}
    assert out[0].valid.sum(1).tolist() == [2, 2, 0]
    assert torch.equal(out[0].tokens, out[1].tokens)
    assert torch.equal(out[0].valid, out[1].valid)


def test_unroll_default_and_bounds(monkeypatch):
    monkeypatch.setattr(decode, "_ENV_DECODE_UNROLL", 5)
    assert decode.resolve_unroll(None) == 5
    assert decode.resolve_unroll(3) == 3
    assert decode.resolve_unroll(0) == 1


def test_unroll_environment_variable_is_read_at_import():
    code = ("from slimt_tpu_torch.models import decode; "
            "print(decode.resolve_unroll(None), decode.DEFAULT_UNROLL)")
    env = dict(os.environ, SLIMT_TPU_DECODE_UNROLL="3")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, check=True, cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    got, default = map(int, out.stdout.split())
    assert got == 3 and default >= 1


class _State:
    def run_chunk(self):
        pass

    def buffer_bytes(self):
        return 0


def test_graph_cache_keeps_the_most_recent_buckets():
    cache = loop_graph.GraphCache(capacity=2)
    made = []

    def make(name):
        def build():
            made.append(name)
            return _State()
        return build

    cpu = torch.device("cpu")
    a = cache.bucket(("a",), make("a"), cpu)
    cache.bucket(("b",), make("b"), cpu)
    assert cache.bucket(("a",), make("a"), cpu) is a  # a hit, now the newest
    cache.bucket(("c",), make("c"), cpu)  # drops b, the least recent
    assert [key for key, _ in cache.items()] == [("a",), ("c",)]
    cache.bucket(("b",), make("b"), cpu)
    assert made == ["a", "b", "c", "b"] and len(cache) == 2
    assert a.stats() == {"capture_ms": None, "pool_mb": None, "buffers_mb": 0.0}


def test_loop_key_separates_what_a_capture_fixes(weights):
    _, tp = weights
    loop = _loop(weights, [0, 1], 2)
    args = dict(unroll=2, eos_id=EOS)
    key = decode.loop_key(tp, args, loop.kv, loop.mask_add, loop.projection, None)
    assert key == decode.loop_key(tp, dict(args), loop.kv, loop.mask_add,
                                  loop.projection, None)
    for other in (dict(args, unroll=3), dict(args, eos_id=1)):
        assert key != decode.loop_key(tp, other, loop.kv, loop.mask_add,
                                      loop.projection, None)
    shortlisted = tfm.prepare_output_projection(tp, torch.arange(16, dtype=torch.int32))
    assert key != decode.loop_key(tp, args, loop.kv, loop.mask_add, shortlisted,
                                  torch.arange(16))
    assert key != decode.loop_key(tp, args, loop.kv, loop.mask_add[:1],
                                  loop.projection, None)


def test_graph_cache_under_threads():
    """Threads share the process's cache: under a short switch interval,
    16 threads taking buckets never see it past its bound, and it ends
    holding one bucket per key it kept."""
    import threading

    cache = loop_graph.GraphCache(capacity=3)
    cpu = torch.device("cpu")
    errors = []

    def work(i):
        try:
            for j in range(300):
                bucket = cache.bucket(((i + j) % 5,), _State, cpu)
                assert isinstance(bucket.state, _State)
                assert len(cache) <= 3
        except Exception as exc:  # noqa: BLE001 -- reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    assert not any(thread.is_alive() for thread in threads)
    keys = [key for key, _ in cache.items()]
    assert len(keys) == len(set(keys)) == 3


def test_graph_cache_counts_hits_misses_and_evictions():
    cache = loop_graph.GraphCache(capacity=2)
    cpu = torch.device("cpu")
    for key in ("a", "b", "a", "c", "b", "b"):
        cache.bucket((key,), _State, cpu)
    # a, b: misses; a: a hit; c: a miss that drops b; b: a miss that
    # drops a; b: a hit.
    assert cache.counts == {"hits": 2, "misses": 4, "evictions": 2}


def test_a_capture_tally_keeps_other_threads_counts():
    """While one thread tallies (a capture), its counts go to its tally
    only, and another thread's, counting meanwhile, go to the counters
    whole; `add` then adds the tally (a replay)."""
    import threading

    from slimt_tpu_torch.ops import launches

    def wrapper():
        pass

    wrapper.launches = 0
    ready, tallies = threading.Barrier(2), []

    def capture():
        with launches.tallied() as tally:
            ready.wait()
            for _ in range(3000):
                launches.count(wrapper)
            tallies.append(dict(tally))

    def launch():
        ready.wait()
        for _ in range(5000):
            launches.count(wrapper)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=capture), threading.Thread(target=launch)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert tallies == [{wrapper: 3000}]
    assert wrapper.launches == 5000
    launches.add(tallies[0])
    assert wrapper.launches == 8000
    launches.count(wrapper)  # the tally closed with its block
    assert wrapper.launches == 8001
    with launches.tallied(), pytest.raises(RuntimeError):
        with launches.tallied():
            pass
