"""The encoder phase's work in a set of forwards: the embedding, every
encoder layer and the decoder layers' cross-attention K/V cache, counted
for the tokens each row really holds (padding is waste, not work).

- int8 products: per token, Q, K, V, O (4 E^2) and the FFN (2 E F) of each
  encoder layer and the cross K and V (2 E^2) of each decoder layer; two
  operations a multiply-add.
- float32 attention: per row of length L, Q K^T and the weighted sum of V,
  4 L^2 E operations a layer.
- bytes: each weight once a forward, the embedding row of each token
  (int8), and the int16 cross K/V cache written.
"""


def count(cfg: dict, forwards, shortlist_width=None) -> dict:
    e, f = cfg["emb_dim"], cfg["ffn_dim"]
    enc, dec = cfg["encoder_layers"], cfg["decoder_layers"]
    per_token_macs = enc * (4 * e * e + 2 * e * f) + dec * 2 * e * e
    weight_bytes = enc * (4 * e * e + 2 * e * f) + dec * 2 * e * e
    int8_ops = f32_ops = n_bytes = 0
    for forward in forwards:
        tokens = forward.real_tokens
        int8_ops += 2 * per_token_macs * tokens
        f32_ops += enc * 4 * e * int((forward.lengths ** 2).sum())
        n_bytes += weight_bytes + tokens * e + dec * 2 * tokens * e * 2
    return {"int8_ops": int8_ops, "f32_ops": f32_ops, "bytes": n_bytes}
