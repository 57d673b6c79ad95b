"""Every decode step's work in a set of forwards, counted for the steps
each row served (a row that is done needs no further step).

- int8 products: per row and step, each decoder layer's SSRU (W and Wf,
  2 E^2), the cross-attention's Q and O (2 E^2) and the FFN (2 E F), and
  the output projection over the batch's columns (E x the vocabulary, or
  x the shortlist's width); two operations a multiply-add.
- float32 attention: per row and step, 4 L E a decoder layer over the
  row's source length L.
- bytes: each step of a batch reads the decoder layers' weights and the
  projection's columns once (int8), and each row's int16 cross K/V.
"""


def count(cfg: dict, forwards, shortlist_width=None) -> dict:
    e, f, vocab = cfg["emb_dim"], cfg["ffn_dim"], cfg["vocab_size"]
    dec = cfg["decoder_layers"]
    layer_macs = dec * (4 * e * e + 2 * e * f)
    int8_ops = f32_ops = n_bytes = 0
    for forward in forwards:
        steps = forward.steps
        width = vocab if shortlist_width is None else shortlist_width(forward)
        row_steps = int(steps.sum())
        int8_ops += 2 * (layer_macs + e * width) * row_steps
        f32_ops += dec * 4 * e * int((forward.lengths * steps).sum())
        n_bytes += int(steps.max(initial=0)) * (layer_macs + e * width)
        n_bytes += dec * 2 * e * 2 * int((forward.lengths * steps).sum())
    return {"int8_ops": int8_ops, "f32_ops": f32_ops, "bytes": n_bytes}
