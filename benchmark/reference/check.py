"""The comparison that decides `correct`.

After the window, a sample of the requests answered in it, drawn from
the seed and holding the longest, is judged against the plain reference:

- each request's text is tokenized and wrapped again here, and every
  segment must be found among the rows the program's forwards took;
- each segment's served tokens must end at EOS or at the length limit
  (the limit factor times the longest source of its batch), and the
  request's answer must be those tokens detokenized;
- the reference runs once over each segment's source and served tokens
  (teacher-forced), and the widest gap by which a served token's logit
  lies below the reference's best over the batch's columns is compared
  with the cell's limit.

`control_gap` reads the same gap for the token that the int4 control
puts first at each of those positions.

The reference and the control are the configuration's architecture's
`Reference` (see `Model`), so nothing here depends on the architecture.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference import shortlist as shortlist_columns
from benchmark.reference.batch import pad


class Model(Protocol):
    """What the comparison uses of an architecture's plain reference (the
    `Reference` of its file), built as `Reference(weights, cfg, device,
    precision="float32" | "int4")`."""

    device: torch.device
    vocab_size: int

    def encode(self, src: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """src [B, T] ids, mask [B, T] bool → (encoder output, mask_add)."""

    def decode(self, memory: torch.Tensor, mask_add: torch.Tensor,
               tgt: torch.Tensor) -> torch.Tensor:
        """The last decoder layer's output [B, S, E], teacher-forced over the
        served tokens tgt [B, S]."""

    def logits(self, y: torch.Tensor, columns: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The output projection of y over `columns` (all if None)."""


@dataclasses.dataclass
class Segment:
    """One segment as the program served it: its source ids, the tokens
    it served, and the columns its batch could choose from (None: all)."""

    source: np.ndarray
    served: np.ndarray
    columns: Optional[np.ndarray]
    generated: Optional[np.ndarray] = None  # the shortlist before the bucket padding


@dataclasses.dataclass
class Shortlist:
    candidates: np.ndarray  # [vocab, best] target ids
    frequent: int
    bucket: int


class RowIndex:
    """The rows of the program's forwards, by their source ids: a segment
    sent again (a repeated text, a cache entry made in another batch) may
    have several, each a sound answer of its batch."""

    def __init__(self, forwards: Sequence, wanted: set):
        self.rows: Dict[tuple, List[Tuple[int, int]]] = {}
        self.forwards = forwards
        for f, forward in enumerate(forwards):
            for r, source in enumerate(forward.sources):
                key = tuple(source.tolist())
                if key in wanted:
                    self.rows.setdefault(key, []).append((f, r))

    def find(self, ids: Sequence[int]) -> List[Tuple[int, int]]:
        return self.rows.get(tuple(ids), [])


def sample_requests(texts: Sequence[str], answered: Sequence[bool], n: int,
                    generator: np.random.Generator) -> List[int]:
    """n answered requests drawn by `generator`, the longest always among
    them."""
    pool = np.flatnonzero(np.asarray(answered, bool))
    if len(pool) == 0:
        return []
    longest = int(pool[np.argmax([len(texts[i].split()) for i in pool])])
    rest = np.setdiff1d(pool, [longest])
    picked = generator.choice(rest, size=min(n - 1, len(rest)), replace=False)
    return [longest] + sorted(int(i) for i in picked)


def judge_answers(texts, answers, picked, forwards, text, wrap_length: int,
                  factor: float, shortlist: Optional[Shortlist],
                  ) -> Tuple[List[str], List[Segment]]:
    """(faults, segments): a line for each picked request whose answer is
    not the detokenized tokens of rows holding its segments (joined with
    nothing: the wrapped pieces of one line are contiguous), or whose row
    stopped short of EOS and of its batch's length limit; and those rows'
    segments, to compare with the reference."""
    wanted_segments = {i: text.segments(texts[i], wrap_length) for i in picked}
    index = RowIndex(forwards, {tuple(s) for segs in wanted_segments.values() for s in segs})
    faults, segments = [], []
    for i in picked:
        rest = answers[i]
        for k, ids in enumerate(wanted_segments[i]):
            rows = index.find(ids)
            if not rows:
                faults.append(f"request {i}: no forward row holds segment {k}'s source ids")
                break
            last = k == len(wanted_segments[i]) - 1
            match = None
            for f, r in rows:
                decoded = text.decode(index.forwards[f].served[r].tolist())
                if rest == decoded if last else rest.startswith(decoded):
                    match = (f, r, decoded)
                    break
            if match is None:
                faults.append(f"request {i}: answer {rest[:80]!r} is none of the {len(rows)} "
                              f"rows served for segment {k}")
                break
            forward = index.forwards[match[0]]
            served = forward.served[match[1]]
            rest = rest[len(match[2]):]
            limit = max(1, int(factor * max(len(s) for s in forward.sources)))
            eos = np.flatnonzero(served == text.eos_id)
            ends_right = (len(eos) and eos[0] == len(served) - 1) or len(served) == limit
            if not ends_right or len(served) > limit or len(served) == 0:
                faults.append(f"request {i}: {len(served)} tokens served, limit {limit}")
            columns = generated = None
            if shortlist is not None:
                if forward.columns is None:
                    words = np.concatenate(forward.sources)
                    forward.columns = shortlist_columns.columns(
                        shortlist.candidates, shortlist.frequent, words, shortlist.bucket)
                    forward.generated = shortlist_columns.columns(
                        shortlist.candidates, shortlist.frequent, words, 1)
                columns, generated = forward.columns, forward.generated
            if len(served):
                segments.append(Segment(np.asarray(ids), served, columns, generated))
    return faults, segments


def _blocks(segments: Sequence[Segment], vocab: int, budget: int):
    """Segments in blocks whose logits take about `budget` floats."""
    block: List[Segment] = []
    for segment in sorted(segments, key=lambda s: len(s.served)):
        width = vocab if segment.columns is None else len(segment.columns)
        if block and (len(block) + 1) * len(segment.served) * width > budget:
            yield block
            block = []
        block.append(segment)
    if block:
        yield block


def _logits(model: Model, block: Sequence[Segment]):
    """Per segment, the logits [steps, columns] at each served position."""
    src, src_mask = pad([s.source for s in block], model.device)
    tgt, _ = pad([s.served for s in block], model.device)
    memory, mask_add = model.encode(src, src_mask)
    y = model.decode(memory, mask_add, tgt)
    out = []
    for r, segment in enumerate(block):
        columns = None
        if segment.columns is not None:
            columns = torch.from_numpy(segment.columns.astype(np.int64)).to(model.device)
        out.append(model.logits(y[r, :len(segment.served)], columns))
    return out


def _positions(segment: Segment, model: Model) -> torch.Tensor:
    """The served tokens as column positions (-1 where outside the columns)."""
    served = torch.from_numpy(segment.served.astype(np.int64)).to(model.device)
    if segment.columns is None:
        return served
    columns = torch.from_numpy(segment.columns.astype(np.int64)).to(model.device)
    at = torch.searchsorted(columns, served).clamp(max=len(columns) - 1)
    return torch.where(columns[at] == served, at, -1)


@torch.inference_mode()
def logit_gaps(reference: Model, segments: Sequence[Segment],
               control: Optional[Model] = None, budget: int = 1 << 28) -> dict:
    """The widest gap of a served token below the reference's best, the
    tokens compared, the served tokens outside the batch's columns (an
    infinite gap), those in the columns that only pad the shortlist to its
    bucket and, with a control, the widest gap of the token the control
    puts first."""
    vocab = reference.vocab_size
    worst, worst_control, tokens, outside, padding = 0.0, 0.0, 0, 0, 0
    for block in _blocks(segments, vocab, budget):
        logits = _logits(reference, block)
        control_logits = _logits(control, block) if control is not None else None
        for k, segment in enumerate(block):
            best = logits[k].amax(-1)
            at = _positions(segment, reference)
            outside += int((at < 0).sum())
            picked = logits[k].gather(1, at.clamp(min=0)[:, None])[:, 0]
            gap = torch.where(at < 0, torch.inf, best - picked)
            worst = max(worst, float(gap.max()))
            tokens += len(segment.served)
            if segment.generated is not None:
                padding += int((~np.isin(segment.served, segment.generated)).sum())
            if control_logits is not None:
                choice = control_logits[k].argmax(-1)
                control_gap = best - logits[k].gather(1, choice[:, None])[:, 0]
                worst_control = max(worst_control, float(control_gap.max()))
    out = {"max_logit_gap": worst, "tokens_compared": tokens, "tokens_outside_columns": outside,
           "tokens_in_bucket_padding": padding}
    if control is not None:
        out["control_max_logit_gap"] = worst_control
    return out
