"""The decoder's SSRU and FFN blocks: the counterpart of
slimt_tpu/ops/fused_blocks.py (`ssru_block`, `ffn_block`), the blocks
of the `fused` provider.

    ssru: f = sigmoid(q8(x) Wf inv + bf);  c' = f c + (1 - f) q8(x) W inv
          h = LN(x + relu(c'))                                -> (h, c')
    ffn:  y = LN((q8(relu(q8(x) W1 inv1 + b1)) W2 inv2 + b2) + x)

Both take [..., E] activations and flatten the leading dims, as the JAX
functions do. On a CUDA tensor `ssru_block` and `ffn_block` launch
csrc/fused_blocks.cu or raise; on a CPU tensor they run the plain
versions below, which call `qmm.affine_plain` directly, so that on the
card they share no kernel with what they are compared against.

Both blocks (and the whole decode step's layers kernel) run a tile of
rows on a thread-block cluster of `cs` blocks that split their products;
`cluster_layout` picks cs and the rows of a tile from the batch, and
`fit_cluster` halves cs until the card holds every tile's cluster at once.

E and F may be any width, as the JAX kernels' full-width blocks take: the
kernels split and multiply over the widths rounded up to 16 (`pad16`) and
mask what lies past the true ones. A row tile wider than a block's
shared memory holds raises ValueError (`fit_cluster`); nothing is sent
to the plain version instead.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from slimt_tpu_torch.ops import _build, launches, qmm
from slimt_tpu_torch.ops.encoder_layer import layer_norm


def _affine(p: dict, x: torch.Tensor, mode=qmm.AFFINE) -> torch.Tensor:
    return qmm.affine_plain(x, p["q"], p.get("b"), p["aq"], p["inv"], mode)


def ssru_plain(x, state, rnn):
    """Plain PyTorch version of the SSRU block on [M, E] rows."""
    f = torch.sigmoid(_affine(rnn["wf"], x))
    wx = _affine(rnn["w"], x)
    c_t = f * state + (1.0 - f) * wx
    h = layer_norm(x + torch.relu(c_t), rnn["ln"]["scale"], rnn["ln"]["bias"])
    return h, c_t


def ffn_plain(x, ffn):
    """Plain PyTorch version of the FFN block on [M, E] rows."""
    hidden = _affine(ffn["w1"], x, qmm.AFFINE_RELU)
    y = _affine(ffn["w2"], hidden)
    return layer_norm(y + x, ffn["ln"]["scale"], ffn["ln"]["bias"])


def rows_per_block(m: int) -> int:
    """Rows a tile of these kernels (and of the whole step's layers
    kernel) takes: one spreads a small batch over the SMs, four cut the
    weight reads at large M."""
    return 1 if m <= 64 else 4


# Blocks a row tile's cluster may take.
CLUSTER_SIZES = (1, 2, 4, 8, 16)


def pad16(n: int) -> int:
    """n rounded up to a multiple of 16: the width the kernels' products
    and cluster split run over (zeros past n)."""
    return -(-n // 16) * 16


def cluster_layout(b: int, e: int, f: int) -> tuple:
    """(cs, rows) for B rows of width E and hidden width F: rows a tile
    (`rows_per_block`) and the largest cluster size whose blocks split E
    and F, each rounded up to 16 (`pad16`), in multiples of 16 columns (16
    at tiny and base widths, 2 at E=32, 1 at E=40). What
    the card holds at once decides the rest (`fit_cluster`): at B=512 on
    the H100, one block a tile for the layers kernel, clusters of 2 for
    the FFN block, which holds several blocks an SM there."""
    ep, fp = pad16(e), pad16(f)
    sizes = [cs for cs in CLUSTER_SIZES if not (ep % (16 * cs) or fp % (16 * cs))]
    return max(sizes), rows_per_block(b)


def check_cluster(cs: int, e: int, f: int) -> None:
    """ValueError on a cluster size the kernels do not take at these widths."""
    if cs not in CLUSTER_SIZES or pad16(e) % (16 * cs) or pad16(f) % (16 * cs):
        raise ValueError(f"a cluster of {cs} blocks: sizes {CLUSTER_SIZES} whose "
                         f"blocks take multiples of 16 of E={e} and F={f}, each "
                         "rounded up to 16")


def fit_cluster(capacity, cs: int, tiles: int, what: str, forced: bool = False) -> int:
    """The largest cluster size from cs down (halving) whose clusters, one
    a row tile, the card holds at once: capacity(cs) >= tiles, where
    capacity is what the C entry reports (a second wave of clusters would
    double the time). One block (cs = 1) and a forced size need only fit
    once; where they do not, raise instead of shrinking. A negative
    capacity is minus the shared memory a block of such a cluster would
    need, more than a block may hold: smaller clusters need more, so the
    widths are past the kernel's limit (ValueError)."""
    while True:
        have = capacity(cs)
        if have < 0:
            raise ValueError(
                f"{what}: a row tile on a cluster of {cs} blocks needs {-have} bytes of "
                "shared memory a block, more than a block of this card holds: the "
                "widths are past the kernel's limit")
        if have >= 1 and (forced or cs == 1 or have >= tiles):
            return cs
        if forced or cs == 1:
            raise RuntimeError(f"{what}: the card cannot schedule a cluster of {cs} blocks")
        cs //= 2


@functools.lru_cache(maxsize=256)
def card_query(device: int, entry: str, *args: int) -> int:
    """What the C entry `entry` reports for `args` on card `device` (the
    entries ask the current device): the rows or clusters a shape takes,
    which depend on the card and the shape alone."""
    with torch.cuda.device(device):
        return getattr(_build.library(), entry)(*args)


def ssru_layout(m: int, e: int, device: int, _cluster=None) -> tuple:
    """(cs, rows) of the SSRU block on card `device`: `cluster_layout`'s
    for its two [E, E] products, or a cluster of `_cluster` blocks, fitted
    to the card (`fit_cluster`)."""
    cs, rows = cluster_layout(m, e, e)
    if _cluster is not None:
        check_cluster(_cluster, e, e)
        cs = _cluster
    cs = fit_cluster(lambda size: card_query(device, "slimt_ssru_clusters", rows, size, e),
                     cs, -(-m // rows), "SSRU block", _cluster is not None)
    return cs, rows


def ffn_layout(m: int, e: int, f: int, device: int, _cluster=None) -> tuple:
    """(cs, rows) of the FFN block on card `device`: `cluster_layout`'s,
    or a cluster of `_cluster` blocks, fitted to the card (`fit_cluster`)."""
    cs, rows = cluster_layout(m, e, f)
    if _cluster is not None:
        check_cluster(_cluster, e, f)
        cs = _cluster
    cs = fit_cluster(lambda size: card_query(device, "slimt_ffn_clusters", rows, size, e, f),
                     cs, -(-m // rows), "FFN block", _cluster is not None)
    return cs, rows


def _check_shape(name: str, tensor, want: tuple, e: int, f=None) -> None:
    if tuple(tensor.shape) != want:
        widths = f"E={e}" + ("" if f is None else f", F={f}")
        raise ValueError(f"{name} must be {want} at {widths}, got {tuple(tensor.shape)}")


def _check(x, tensors, e: int, f=None) -> None:
    if not x.is_cuda:
        raise ValueError(f"the kernel takes CUDA tensors, got {x.device}")
    for t in (x,) + tuple(tensors):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("block tensors must be contiguous on one CUDA device")
        if t.data_ptr() % 16:
            raise ValueError("block tensors must be 16-byte aligned")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")


def _scale(value) -> ctypes.c_float:
    return ctypes.c_float(np.float32(value))


def ssru_kernel(x, state, rnn, _cluster=None):
    """Launch csrc/fused_blocks.cu's SSRU block on CUDA [M, E] rows, a tile
    on a cluster of `ssru_layout` blocks (`_cluster` forces a size, for the
    card checks that compare them; one the card cannot schedule raises).
    `launches` counts the launches."""
    m, e = x.shape
    wf, w, ln = rnn["wf"], rnn["w"], rnn["ln"]
    if _cluster is not None:
        check_cluster(_cluster, e, e)
    for name, tensor, want in (("Wf", wf["q"], (e, e)), ("W", w["q"], (e, e)),
                               ("bf", wf["b"], (e,)), ("the LN scale", ln["scale"], (e,)),
                               ("the LN bias", ln["bias"], (e,))):
        _check_shape(name, tensor, want, e)
    _check(x, (state, wf["q"], wf["b"], w["q"], ln["scale"], ln["bias"]), e)
    if tuple(state.shape) != (m, e) or state.dtype != torch.float32:
        raise ValueError(f"state must be float32 [{m}, {e}]")
    cs, rows = ssru_layout(m, e, x.device.index, _cluster)
    h = torch.empty_like(x)
    c_t = torch.empty_like(x)
    lib = _build.library()
    code = lib.slimt_ssru_block(
        x.data_ptr(), state.data_ptr(), wf["q"].data_ptr(), wf["b"].data_ptr(),
        w["q"].data_ptr(), ln["scale"].data_ptr(), ln["bias"].data_ptr(),
        h.data_ptr(), c_t.data_ptr(), m, e, rows, cs,
        _scale(wf["aq"]), _scale(wf["inv"]), _scale(w["aq"]), _scale(w["inv"]),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, code, "slimt_ssru_block")
    launches.count(ssru_kernel)
    return h, c_t


ssru_kernel.launches = 0


def ffn_kernel(x, ffn, _cluster=None):
    """Launch csrc/fused_blocks.cu's FFN block on CUDA [M, E] rows, a tile
    on a cluster of `ffn_layout` blocks (`_cluster` forces a size, for the
    card checks that compare them; one the card cannot schedule raises).
    `launches` counts the launches."""
    m, e = x.shape
    w1, w2, ln = ffn["w1"], ffn["w2"], ffn["ln"]
    f = w1["q"].shape[1]
    if _cluster is not None:
        check_cluster(_cluster, e, f)
    for name, tensor, want in (("W1", w1["q"], (e, f)), ("W2", w2["q"], (f, e)),
                               ("b1", w1["b"], (f,)), ("b2", w2["b"], (e,)),
                               ("the LN scale", ln["scale"], (e,)),
                               ("the LN bias", ln["bias"], (e,))):
        _check_shape(name, tensor, want, e, f)
    _check(x, (w1["q"], w1["b"], w2["q"], w2["b"], ln["scale"], ln["bias"]), e, f)
    cs, rows = ffn_layout(m, e, f, x.device.index, _cluster)
    out = torch.empty_like(x)
    lib = _build.library()
    code = lib.slimt_ffn_block(
        x.data_ptr(), w1["q"].data_ptr(), w1["b"].data_ptr(), w2["q"].data_ptr(),
        w2["b"].data_ptr(), ln["scale"].data_ptr(), ln["bias"].data_ptr(),
        out.data_ptr(), m, e, f, rows, cs,
        _scale(w1["aq"]), _scale(w1["inv"]), _scale(w2["aq"]), _scale(w2["inv"]),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, code, "slimt_ffn_block")
    launches.count(ffn_kernel)
    return out


ffn_kernel.launches = 0


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).to(torch.float32)


def ssru_block(x: torch.Tensor, state: torch.Tensor, rnn: dict):
    """x, state: [..., E]; rnn = {"wf": affine, "w": linear, "ln"}.
    Returns (h, new_state), each shaped like x."""
    x2, c2 = _flat(x), _flat(state)
    if x.is_cuda:
        h, c_t = ssru_kernel(x2.contiguous(), c2.contiguous(), rnn)
    elif x.device.type == "cpu":
        h, c_t = ssru_plain(x2, c2, rnn)
    else:
        raise ValueError(f"unsupported device {x.device}")
    return h.reshape(x.shape), c_t.reshape(x.shape)


def ffn_block(x: torch.Tensor, ffn: dict) -> torch.Tensor:
    """x: [..., E]; ffn = {"w1", "w2", "ln"}. Returns LN(FFN(x) + x)."""
    x2 = _flat(x)
    if x.is_cuda:
        out = ffn_kernel(x2.contiguous(), ffn)
    elif x.device.type == "cpu":
        out = ffn_plain(x2, ffn)
    else:
        raise ValueError(f"unsupported device {x.device}")
    return out.reshape(x.shape)
