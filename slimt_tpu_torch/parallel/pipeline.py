"""Two-stage pipeline: the encoder on one device, the greedy decode on
another. The counterpart of slimt_tpu/parallel/pipeline.py.

Each stage runs on its own device and, on CUDA, its own stream. Every
batch's encode is queued on the encoder stage first; the hop to the
decoder stage is a non-blocking copy on the decoder's stream, ordered
after the encode by an event; the decodes then run in order on the
decoder's stream, so batch i's encode overlaps batch i - 1's decode. With
both stages on one card (cuda:0, cuda:0) the overlap comes from the two
streams. On the CPU the stages run in order. As in the JAX pipeline the
decode takes translate_batch's exact numerics (the split f32 cache, the
exact argmax); the encoder stage runs the whole-layer kernel (#2) on a
card. On a card the decoder stage replays its loop's CUDA graphs from
its own cache (models/loop_graph.GraphCache), on its stream; the private
`_eager_loop` runs the chunks eagerly instead, for the checks that
compare the two.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from slimt_tpu_torch.device import resolve_device
from slimt_tpu_torch.io.params import params_from_numpy
from slimt_tpu_torch.models import loop_graph
from slimt_tpu_torch.models import transformer as tfm
from slimt_tpu_torch.models.decode import GreedyResult, greedy_decode, on_stream


class _Stage:
    def __init__(self, host_params: dict, device):
        self.device = resolve_device(device)
        self.params = params_from_numpy(host_params, self.device)
        on_card = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if on_card else None
        self.graphs = loop_graph.GraphCache() if on_card else None

    def running(self):
        return on_stream(self.stream)


class TwoStagePipeline:
    """`host_params`: the loader's numpy params (io/loader.load_weights);
    each stage holds its own copy on its device."""

    def __init__(self, host_params: dict, num_heads: int, encoder_device,
                 decoder_device, provider: Optional[str] = None):
        self.num_heads = num_heads
        self.provider = provider
        self.encoder = _Stage(host_params, encoder_device)
        self.decoder = _Stage(host_params, decoder_device)
        self._eager_loop = False

    def _encode(self, indices, mask):
        enc = self.encoder
        with enc.running():
            indices = torch.as_tensor(indices).to(enc.device, non_blocking=True)
            mask = torch.as_tensor(mask).to(enc.device, non_blocking=True)
            x = tfm.transform_embedding(tfm.embed(enc.params, indices))
            mask_add = tfm.make_additive_mask(mask)
            out = tfm.encoder_forward(enc.params, x, mask_add, self.num_heads,
                                      None if self.provider == "fused_step" else self.provider,
                                      fused_layer=enc.device.type == "cuda")
            done = torch.cuda.Event() if enc.stream is not None else None
            if done is not None:
                done.record(enc.stream)
        return out, mask_add, done

    def _hop(self, out, mask_add, done):
        """The stage hop: a non-blocking copy on the decoder's stream after
        the encode's event."""
        dec = self.decoder
        with dec.running():
            if done is not None and dec.stream is not None:
                dec.stream.wait_event(done)
            moved = (out.to(dec.device, non_blocking=True),
                     mask_add.to(dec.device, non_blocking=True))
            if dec.stream is not None:
                # The encoder stream's memory is read on the decoder's stream.
                for tensor in (out, mask_add):
                    if tensor.is_cuda:
                        tensor.record_stream(dec.stream)
            return moved

    @torch.inference_mode()
    def translate_batches(
        self,
        batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
        eos_id: int,
        max_steps: int,
    ) -> List[GreedyResult]:
        """[(indices [B, T], mask [B, T]), ...] through both stages; every
        encode is queued before the first decode. Results live on the
        decoder's device."""
        encoded = [self._encode(indices, mask) for indices, mask in batches]
        results = []
        for out, mask_add, done in encoded:
            out, mask_add = self._hop(out, mask_add, done)
            with self.decoder.running():
                results.append(greedy_decode(
                    self.decoder.params, out, mask_add, eos_id, max_steps, self.num_heads,
                    provider=self.provider, kv_dtype=None, argmax_method="exact",
                    graphs=self.decoder.graphs, _eager=self._eager_loop))
        if self.decoder.stream is not None:
            self.decoder.stream.synchronize()
        return results
