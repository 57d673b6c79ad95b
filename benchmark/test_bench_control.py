"""`correct` comes out false for the int4 control and for a run whose timed
path is broken underneath (the harness's look for a card skipped: the
run drives the port's CPU path, at test widths and at bergamot-tiny11's
own, whose limits it is held to)."""

import pytest

from benchmark import harness, probe, testing


@pytest.mark.parametrize("cell", testing.CELLS)
def test_a_sound_run_is_correct(tmp_path, cell):
    result = testing.run(str(tmp_path), cell)
    checks = result["checks"]
    assert result["correct"], checks
    assert checks["answers_wrong"]["value"] == 0 and checks["requests_failed"]["value"] == 0
    assert 0 <= checks["max_logit_gap"]["value"] <= checks["max_logit_gap"]["limit"]


@pytest.mark.parametrize("cell", testing.CELLS)
def test_the_int4_control_is_not_correct(tmp_path, cell):
    result = testing.run(str(tmp_path), cell, control=True)
    assert not result["correct"], result["checks"]
    readings = result["readings"]
    assert result["checks"]["max_logit_gap"]["value"] == readings["control_max_logit_gap"]
    assert readings["program_max_logit_gap"] <= result["checks"]["max_logit_gap"]["limit"]


def test_served_tokens_follow_the_recurrence(tmp_path, monkeypatch):
    """At bergamot-tiny11's widths the seed's weights decode rows whose
    tokens change along the row (at gain 1 every row repeats one token)."""
    probes = []

    class Kept(probe.ForwardProbe):
        def __init__(self, model):
            super().__init__(model)
            probes.append(self)

    monkeypatch.setattr(harness, "ForwardProbe", Kept)
    testing.run(str(tmp_path), "tiny11-small")
    served = [row for forward in probes[0].forwards for row in forward.served]
    assert served and sum(len(set(row.tolist())) > 1 for row in served) > len(served) // 2


def alter_tokens(monkeypatch):
    """Every row's first token is another id where the decode produces it."""
    from slimt_tpu_torch.models import model

    unpack = model.unpack_compact

    def altered(packed, max_steps):
        tokens, valid = unpack(packed, max_steps)
        tokens = tokens.copy()
        tokens[:, 0] = (tokens[:, 0] + 7) % 600
        return tokens, valid

    monkeypatch.setattr(model, "unpack_compact", altered)


def leave_out_half(monkeypatch):
    """The second half of every batch's rows comes back with no tokens."""
    from slimt_tpu_torch.models import model

    unpack = model.unpack_compact

    def halved(packed, max_steps):
        tokens, valid = unpack(packed, max_steps)
        valid = valid.copy()
        valid[valid.shape[0] // 2:] = False
        return tokens, valid

    monkeypatch.setattr(model, "unpack_compact", halved)


def keep_ssru_state(monkeypatch):
    """Every SSRU step returns its state unchanged (the cell stays zero)."""
    from slimt_tpu_torch.models import transformer

    step = transformer.ssru_forward

    def kept(rnn, state, x, provider=None):
        h, _ = step(rnn, state, x, provider)
        return h, state.clone()

    monkeypatch.setattr(transformer, "ssru_forward", kept)


def stale_chunk_state(monkeypatch):
    """Each chunk of the decode loop starts from the states the batch
    started with: the chunk's states are not written back to the buffer
    that the next chunk (a replay, on the card) reads."""
    from slimt_tpu_torch.models import decode

    def run_chunk(self):
        step, prev, complete = self.step_at, self.prev, self.complete
        states = tuple(self.states.unbind(0))
        for _ in range(self.unroll):
            step, prev, states, complete = self._one_step(step, prev, states, complete)
        self.step_at.copy_(step)
        self.prev.copy_(prev)
        self.complete.copy_(complete)
        self.done.copy_(complete.all().reshape(1))

    monkeypatch.setattr(decode.DecodeLoop, "run_chunk", run_chunk)


@pytest.mark.parametrize("fault", [alter_tokens, leave_out_half, keep_ssru_state,
                                   stale_chunk_state],
                         ids=["token_altered", "half_batch_left_out", "ssru_state_unchanged",
                              "stale_chunk_state"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    result = testing.run(str(tmp_path), "tiny11-small")
    assert not result["correct"], result["checks"]
