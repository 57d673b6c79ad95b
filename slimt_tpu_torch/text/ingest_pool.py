"""Process-parallel corpus ingest.

The GIL caps in-process ingest (sentence split → tokenize → wrap →
annotate) at roughly one core of Python glue; the reference sidesteps
this with C++ worker threads (slimt/Frontend.cc:212-227). Here the
equivalent is a small pool of worker *processes*, each holding its own
TextProcessor rebuilt from the parent's spec: chunks of lines fan out,
(AnnotatedText, Segments) results pickle back, at a round trip that
is small against a chunk's processing.

Workers are spawned (never forked: the parent holds live device
state) and never touch the device — they only run text code, so the
device stays exclusively with the parent process.
"""

from __future__ import annotations

import threading
from concurrent.futures import ProcessPoolExecutor
from typing import Optional

# -- worker side (runs in the spawned interpreter) ---------------------

_WORKER_PROCESSORS = {}
_WORKER_CACHE_CAP = 4  # full vocab+tokenizer each: bound worker memory


def _worker_process(spec_key, spec, texts, wrap_length):
    """Build (once) the processor described by `spec` and run
    process_batch. Module-level for spawn picklability. The cache is
    a tiny LRU: model ids are monotonic, so an unbounded dict would
    leak one full vocabulary per model (re)load per worker."""
    processor = _WORKER_PROCESSORS.pop(spec_key, None)
    if processor is None:
        from slimt_tpu_torch.text.processor import TextProcessor
        from slimt_tpu_torch.text.vocabulary import Vocabulary

        mode, vocab_bytes, splitter_data, backend = spec
        processor = TextProcessor(
            mode, Vocabulary(vocab_bytes, backend=backend), splitter_data
        )
    _WORKER_PROCESSORS[spec_key] = processor  # re-insert: LRU order
    while len(_WORKER_PROCESSORS) > _WORKER_CACHE_CAP:
        _WORKER_PROCESSORS.pop(next(iter(_WORKER_PROCESSORS)))
    return processor.process_batch(texts, wrap_length)


# -- parent side -------------------------------------------------------


class IngestPool:
    """Lazily-started spawn pool for process_batch fan-out.

    The pool costs a few seconds to start (each worker imports the
    text stack), so it starts on first use and is shared for the
    service's lifetime. Specs are keyed by the owning model's id; the
    full spec rides along with every task (bytes pickle at memcpy
    speed) so workers self-register on first sight of a model.
    """

    def __init__(self, workers: int):
        self.workers = workers
        self._pool: Optional[ProcessPoolExecutor] = None
        self._lock = threading.Lock()
        self._broken = False

    def _ensure(self) -> Optional[ProcessPoolExecutor]:
        with self._lock:
            if self._broken:
                return None
            if self._pool is None:
                import multiprocessing

                try:
                    self._pool = ProcessPoolExecutor(
                        max_workers=self.workers,
                        mp_context=multiprocessing.get_context("spawn"),
                    )
                except Exception:  # no /dev/shm, sandboxed, …
                    self._broken = True
                    return None
            return self._pool

    def submit(self, model, texts, wrap_length):
        """Returns a future of process_batch(texts), or None if the
        pool is unavailable (caller falls back to in-process)."""
        pool = self._ensure()
        if pool is None:
            return None
        processor = model.processor
        try:
            return pool.submit(
                _worker_process,
                model.id,
                processor.spec(),
                texts,
                wrap_length,
            )
        except Exception:  # pool broke (worker died, shutdown race)
            self._broken = True
            return None

    def close(self) -> None:
        with self._lock:
            if self._pool is not None:
                self._pool.shutdown(wait=False, cancel_futures=True)
                self._pool = None
            self._broken = True
