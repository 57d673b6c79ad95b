"""TextProcessor: input string → sentences → tokens → wrapped segments.

Reproduces the reference pipeline (slimt/TextProcessor.cc:96-199):

  - sentence-stream the input in the configured split mode;
  - sentencepiece-encode each sentence with byte-range views;
  - hard-wrap long sentences at `wrap_length` tokens, reserving one
    slot for the EOS appended to every wrapped segment
    (wrap step = wrap_length - 1);
  - record each wrapped segment as a sentence in the source
    AnnotatedText (with a zero-width trailing token range standing in
    for EOS).

The second entry point re-tokenizes an existing AnnotatedText
preserving its sentence boundaries — used for the second leg of pivot
translation (slimt/TextProcessor.cc:159-199).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from slimt_tpu_torch.text.annotation import AnnotatedText
from slimt_tpu_torch.text.splitter import SentenceStream, Splitter, SplitMode
from slimt_tpu_torch.text.vocabulary import Vocabulary

Segment = List[int]
Segments = List[Segment]


class TextProcessor:
    def __init__(
        self,
        mode: str,
        vocabulary: Vocabulary,
        splitter_data: Optional[str] = None,
    ):
        self.mode = SplitMode(mode)
        self.vocabulary = vocabulary
        self.splitter_data = splitter_data  # kept for worker respawn
        if splitter_data is None:
            # Fallback English prefix set; a package-provided ssplit
            # file always wins (reference warns when absent,
            # slimt/TextProcessor.cc:41-51).
            from slimt_tpu_torch.text.prefixes import ENGLISH

            splitter_data = ENGLISH
        self.splitter = Splitter(splitter_data)

    def spec(self) -> tuple:
        """Serializable recipe for rebuilding an equivalent processor
        in an ingest worker process (same vocab bytes, same splitter
        data, same batch tokenizer backend)."""
        return (
            self.mode.value,
            self.vocabulary.serialized,
            self.splitter_data,
            self.vocabulary.resolved_batch_backend,
        )

    def process(
        self, text: str, wrap_length: int
    ) -> Tuple[AnnotatedText, Segments]:
        """(AnnotatedText, Segments) — segments carry EOS; annotation
        records one sentence per wrapped segment."""
        return self.process_batch([text], wrap_length)[0]

    def process_batch(
        self, texts: Sequence[str], wrap_length: int
    ) -> List[Tuple[AnnotatedText, Segments]]:
        """Batch variant: all sentences across all inputs are encoded
        in one vocabulary.encode_batch call (parallel in the Rust
        tokenizers backend) — the host-throughput path the serving
        loops use. Output identical to per-text process()."""
        if self.vocabulary.resolved_batch_backend == "native":
            return self._process_batch_native(texts, wrap_length)
        plans = []  # per text: (source, [(sentence, byte_offset)])
        all_sentences: List[str] = []
        from slimt_tpu_torch.text.vocabulary import byte_prefix

        for text in texts:
            source = AnnotatedText(text)
            if len(text.encode("utf-8")) == len(text):
                prefix_bytes = None  # ASCII: char offset == byte offset
            else:
                prefix_bytes = byte_prefix(text)
            spans = []
            for sentence, begin, _ in SentenceStream(
                text, self.splitter, self.mode
            ):
                if not sentence:
                    continue  # paragraph-boundary marker
                byte_begin = begin if prefix_bytes is None else prefix_bytes[begin]
                spans.append((sentence, byte_begin))
                all_sentences.append(sentence)
            plans.append((source, spans))

        encoded = self.vocabulary.encode_batch_begins(all_sentences)

        results = []
        cursor = 0
        for source, spans in plans:
            segments: Segments = []
            for _, byte_offset in spans:
                ids, begins, end = encoded[cursor]
                cursor += 1
                if not ids:
                    continue
                if byte_offset:  # 0 for the first sentence of a line
                    begins = [byte_offset + b for b in begins]
                    end += byte_offset
                self._wrap(ids, begins, end, segments, source, wrap_length)
            results.append((source, segments))
        return results

    def _process_batch_native(
        self, texts: Sequence[str], wrap_length: int
    ) -> List[Tuple[AnnotatedText, Segments]]:
        """process_batch via ONE native slimt_ingest_lines call:
        splitting stays here (cheap), but tokenization, wrap-at-128 and
        the AnnotatedText token_begin/gap construction all run in
        multithreaded C++ — output identical to the generic path
        (differential-tested in tests/test_processor.py)."""
        from slimt_tpu_torch.text.vocabulary import byte_prefix

        sources = []
        sent_begin: List[int] = []
        sent_end: List[int] = []
        sent_counts: List[int] = []
        line_datas: List[bytes] = []
        for text in texts:
            source = AnnotatedText(text)
            sources.append(source)
            line_datas.append(source.data)
            count = 0
            prefix = (
                None
                if len(line_datas[-1]) == len(text)  # ASCII: char == byte
                else byte_prefix(text)
            )
            for sentence, begin, end in SentenceStream(
                text, self.splitter, self.mode
            ):
                if not sentence:
                    continue  # paragraph-boundary marker
                if prefix is None:
                    sent_begin.append(begin)
                    sent_end.append(end)
                else:
                    sent_begin.append(prefix[begin])
                    sent_end.append(prefix[end])
                count += 1
            sent_counts.append(count)

        ingested = self.vocabulary._native.ingest_lines(
            line_datas, sent_begin, sent_end, sent_counts,
            wrap_length, self.vocabulary.eos_id,
        )
        results = []
        for source, (segments, token_begin, gap) in zip(sources, ingested):
            source.token_begin = token_begin
            source.gap = gap
            results.append((source, segments))
        return results

    def _wrap(
        self,
        ids: Segment,
        begins: List[int],
        end: int,
        segments: Segments,
        source: AnnotatedText,
        wrap_length: int,
    ) -> None:
        """Wrap at wrap_length-1 tokens + EOS
        (slimt/TextProcessor.cc:123-157). `begins`/`end` describe the
        contiguous token byte ranges (encode_batch_begins contract); a
        zero-width EOS range is recorded at each chunk's end."""
        eos = self.vocabulary.eos_id
        step = wrap_length - 1
        n = len(ids)
        if n <= step:  # common case: sentence fits in one segment
            segments.append(ids + [eos])
            source.record_contiguous_sentence(begins, end)
            return
        for offset in range(0, n, step):
            hi = offset + step
            segments.append(ids[offset:hi] + [eos])
            # contiguity: a non-final chunk ends where the next begins
            chunk_end = begins[hi] if hi < n else end
            source.record_contiguous_sentence(begins[offset:hi], chunk_end)

    def process_annotated(
        self, source: AnnotatedText
    ) -> Tuple[AnnotatedText, Segments]:
        """Re-tokenize an AnnotatedText keeping sentence boundaries
        (pivot leg 2; slimt/TextProcessor.cc:159-199).

        Deliberately NOT implemented via process_annotated_batch: the
        two are an independent pair whose equality is the differential
        oracle (tests/test_processor.py
        test_process_annotated_batch_matches_single) — edits to either
        must keep that test green."""
        segments: Segments = []
        replacement = AnnotatedText(source.text)
        eos = self.vocabulary.eos_id
        data = source.data
        for s in range(source.sentence_count()):
            srange = source.sentence_as_range(s)
            sentence = data[srange.begin : srange.end].decode(
                "utf-8", errors="replace"
            )
            ids, ranges = self.vocabulary.encode(sentence, add_eos=False)
            ids = ids + [eos]
            abs_ranges = [
                (srange.begin + b, srange.begin + e) for b, e in ranges
            ]
            if abs_ranges:
                end = abs_ranges[-1][1]
            else:
                end = srange.end
            abs_ranges.append((end, end))
            segments.append(ids)
            replacement.record_existing_sentence(
                abs_ranges, abs_ranges[0][0]
            )
        return replacement, segments

    def process_annotated_batch(
        self, sources: Sequence[AnnotatedText]
    ) -> List[Tuple[AnnotatedText, Segments]]:
        """Batch variant of process_annotated (pivot leg 2 at corpus
        scale): every sentence of every source re-tokenizes in ONE
        parallel encode_batch_begins call instead of one encode per
        sentence. Output identical to per-source process_annotated
        (differential-tested; encode ranges tile — the _tile contract
        — so begins + final end reconstruct them exactly)."""
        sentences: List[str] = []
        counts: List[int] = []
        sranges = []
        for source in sources:
            data = source.data
            n = source.sentence_count()
            counts.append(n)
            for s in range(n):
                r = source.sentence_as_range(s)
                sranges.append(r)
                sentences.append(
                    data[r.begin : r.end].decode("utf-8", errors="replace")
                )
        encoded = self.vocabulary.encode_batch_begins(sentences)
        eos = self.vocabulary.eos_id
        out: List[Tuple[AnnotatedText, Segments]] = []
        cursor = 0
        for source, n in zip(sources, counts):
            replacement = AnnotatedText(source.text)
            segments: Segments = []
            for _ in range(n):
                srange = sranges[cursor]
                ids, begins, end = encoded[cursor]
                cursor += 1
                abs_ranges = []
                if begins:
                    base = srange.begin
                    prev = begins[0]
                    for b in begins[1:]:
                        abs_ranges.append((base + prev, base + b))
                        prev = b
                    abs_ranges.append((base + prev, base + end))
                    last_end = base + end
                else:
                    last_end = srange.end
                abs_ranges.append((last_end, last_end))
                segments.append(ids + [eos])
                replacement.record_existing_sentence(
                    abs_ranges, abs_ranges[0][0]
                )
            out.append((replacement, segments))
        return out
