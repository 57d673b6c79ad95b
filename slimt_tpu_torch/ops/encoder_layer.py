"""Whole encoder layer: the counterpart of
slimt_tpu/ops/encoder_layer_pallas.py (with the fused_blocks helpers
`_quant`, `_int8_mm` and `_layer_norm`).

One post-LN layer: Q/K/V affines, multi-head SDPA, O affine, residual
+ LN, FFN1 + relu, FFN2, residual + LN. On a CUDA tensor
`encoder_layer_fused` launches csrc/encoder_layer.cu (it replaces
encoder_layer_pallas._layer_kernel) or raises; on a CPU tensor it runs
the plain version below, built from the same formulas.

The kernel is three launches a layer: the QKV products, the SDPA, and
the O product with both LayerNorms and the FFN, whose hidden stays on
chip. `layer_plan` lays them out (rows a tile, cluster size, scratch);
it is plain Python, so the CPU tests reach it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from slimt_tpu_torch.ops import _build, launches, qmm

LN_EPS = 1e-6
MAX_T = 256  # the gate of the TPU kernel (transformer.py:500-509)
# Head dims of the attention kernel (csrc/slimt_device.cuh) that the SDPA
# of the layer kernel and the split encoder's kernels launch.
HEAD_DIMS = (8, 16, 32, 64)
# Rows a tile of the QKV and post-attention kernels may take; its f32
# rows fill at most TILE_FLOATS (64 KB of shared memory), so E is at most
# MAX_E. E is a multiple of CHUNK (the kernels' weight chunks); where a
# cluster splits F, F is a multiple of 16 times its size.
TILE_ROWS = (64, 32, 16)
TILE_FLOATS = 64 * 256
CHUNK = 128
MAX_E = TILE_FLOATS // TILE_ROWS[-1]
# The int8 matrices of a layer, read K-major by the kernel.
MATRICES = (("att", "q"), ("att", "k"), ("att", "v"), ("att", "o"),
            ("ffn", "w1"), ("ffn", "w2"))


def layer_norm(x, scale, bias) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) * scale + bias, biased variance."""
    mean = x.mean(-1, keepdim=True)
    centered = x - mean
    var = (centered * centered).mean(-1, keepdim=True)
    inv = torch.rsqrt(var + qmm._f32(LN_EPS))
    return centered * inv * scale + bias


def softmax(scores) -> torch.Tensor:
    """jax.nn.softmax's formula: exp(x - max) / sum."""
    unnormalized = torch.exp(scores - scores.amax(-1, keepdim=True))
    return unnormalized / unnormalized.sum(-1, keepdim=True)


def sdpa_heads(q, k, v, mask_add):
    """SDPA on split heads: [B,H,Tq,D] x [B,H,Tk,D], additive mask
    [B,1,1,Tk] -> (out [B,H,Tq,D], attn [B,H,Tq,Tk]), with the scale on
    the QK^T product and the mask added after it."""
    scale = qmm._f32(1.0 / math.sqrt(q.shape[-1]))
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    attn = softmax(scores + mask_add)
    return torch.matmul(attn, v), attn


def sdpa_plain(q, k, v, mask_add, num_heads) -> torch.Tensor:
    """Multi-head SDPA on joined [B, T, E] operands; mask [B,1,1,T]."""
    b, t, e = q.shape
    d = e // num_heads

    def split(a):
        return a.reshape(b, t, num_heads, d).transpose(1, 2)

    out = sdpa_heads(split(q), split(k), split(v), mask_add)[0]
    return out.transpose(1, 2).reshape(b, t, e)


def layer_plain(x, layer, mask_add, num_heads) -> torch.Tensor:
    """Plain PyTorch version of the layer kernel."""
    b, t, e = x.shape
    att, ffn = layer["att"], layer["ffn"]

    def affine(p, a, mode=qmm.AFFINE):
        return qmm.affine_plain(a, p["q"], p["b"], p["aq"], p["inv"], mode)

    x2 = x.reshape(b * t, e)
    q, k, v = (affine(att[n], x2).reshape(b, t, e) for n in ("q", "k", "v"))
    heads = sdpa_plain(q, k, v, mask_add, num_heads).reshape(b * t, e)
    x1 = layer_norm(
        x2 + affine(att["o"], heads), att["ln"]["scale"], att["ln"]["bias"]
    )
    h = affine(ffn["w1"], x1, qmm.AFFINE_RELU)
    y = affine(ffn["w2"], h)
    out = layer_norm(y + x1, ffn["ln"]["scale"], ffn["ln"]["bias"])
    return out.reshape(b, t, e)


def width_ok(e: int) -> bool:
    """E the kernels' tiles hold: a multiple of CHUNK up to MAX_E. The
    model's gate (transformer.encoder_layer_forward) and check_layer_shape
    both ask it."""
    return e % CHUNK == 0 and CHUNK <= e <= MAX_E


def check_layer_shape(t: int, e: int, f: int, num_heads: int) -> None:
    """Raise ValueError on a shape the layer kernel does not take."""
    if not 1 <= t <= MAX_T:
        raise ValueError(f"encoder layer kernel: T={t} not in [1, {MAX_T}]")
    if not width_ok(e):
        raise ValueError(f"encoder layer kernel: E={e} must be a multiple of {CHUNK} "
                         f"up to {MAX_E}")
    d = e // num_heads if num_heads > 0 else 0
    if num_heads < 1 or e % num_heads or d not in HEAD_DIMS:
        raise ValueError(f"encoder layer kernel: head dim {d} not in {HEAD_DIMS}")
    if f < 1:
        raise ValueError(f"encoder layer kernel: F={f} must be at least 1")


def tile_rows(e: int) -> int:
    """The most rows a tile of the layer's kernels takes at width E."""
    return next(rows for rows in TILE_ROWS if rows * e <= TILE_FLOATS)


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """The launches of one layer: the QKV kernel's row tile and grid, the
    post-attention kernel's row tile, tiles and cluster size (its grid is
    tiles x cs blocks), and the floats of scratch (q, k, v and att)."""

    qkv_rows: int
    qkv_blocks: int
    post_rows: int
    tiles: int
    cs: int
    scratch: int

    @property
    def post_blocks(self) -> int:
        return self.tiles * self.cs


def layer_plan(b, t, e, f, num_heads, capacity, sms, _cluster=None) -> LayerPlan:
    """The plan on a card of `sms` SMs: the QKV kernel takes tile_rows(E)
    rows a block, halved (to 16) while twice its blocks still run in one
    wave (a block an SM); the post-attention kernel takes tile_rows(E)
    rows a tile on a cluster of the largest size whose blocks split F in
    multiples of 16 (one block where none does), fitted by fused_blocks.fit_cluster to capacity(rows,
    cs, E), the clusters the card holds at once (the C entry
    slimt_encoder_clusters). `_cluster` forces a size (the card checks
    compare them)."""
    from slimt_tpu_torch.ops.fused_blocks import CLUSTER_SIZES, fit_cluster

    check_layer_shape(t, e, f, num_heads)
    m = b * t
    if m < 1:
        raise ValueError(f"encoder layer kernel: empty batch B={b}, T={t}")
    sizes = [cs for cs in CLUSTER_SIZES if cs == 1 or f % (16 * cs) == 0]
    if _cluster is not None and _cluster not in sizes:
        raise ValueError(f"encoder layer kernel: a cluster of {_cluster} blocks: sizes "
                         f"{CLUSTER_SIZES} whose blocks take multiples of 16 of F={f}")
    rows = tile_rows(e)
    qkv_rows = rows
    while qkv_rows > TILE_ROWS[-1] and -(-m // (qkv_rows // 2)) <= sms:
        qkv_rows //= 2
    tiles = -(-m // rows)
    cs = fit_cluster(lambda size: capacity(rows, size, e),
                     max(sizes) if _cluster is None else _cluster, tiles,
                     "encoder layer", _cluster is not None)
    return LayerPlan(qkv_rows, -(-m // qkv_rows), rows, tiles, cs, 4 * m * e)


def add_k_major(layer: dict) -> None:
    """Give each int8 matrix dict p of an encoder layer p["qt"]: p["q"]
    [K, N] as [N, K] with K contiguous and zero-padded to a multiple of 16
    (16-byte rows), the tensor cores' B operand, which the layer kernel
    reads straight from L2. io.params.params_from_numpy calls it where it
    places the params on the card."""
    for group, name in MATRICES:
        p = layer[group][name]
        k, n = p["q"].shape
        qt = p["q"].new_zeros((n, -(-k // 16) * 16))
        qt[:, :k] = p["q"].t()
        p["qt"] = qt


@functools.lru_cache(maxsize=16)
def sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def layer_kernel(x, layer, mask_add, num_heads, _cluster=None) -> torch.Tensor:
    """Launch csrc/encoder_layer.cu on CUDA tensors (`layer_plan`'s
    layout; `_cluster` forces the post-attention kernel's cluster size).
    `launches` counts the layer launches."""
    from slimt_tpu_torch.ops.fused_blocks import card_query

    b, t, e = x.shape
    att, ffn = layer["att"], layer["ffn"]
    f = ffn["w1"]["q"].shape[1]
    check_layer_shape(t, e, f, num_heads)
    if any("qt" not in layer[group][name] for group, name in MATRICES):
        raise ValueError("the layer's int8 matrices have no K-major copies: "
                         "params_from_numpy makes them on the card (add_k_major)")
    if not x.is_cuda:
        raise ValueError(f"the kernel takes CUDA tensors, got {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be a contiguous, 16-byte aligned float32 tensor")
    mask = mask_add.reshape(b, t).to(x.device, torch.float32).contiguous()
    tensors = [
        att["q"]["qt"], att["q"]["b"], att["k"]["qt"], att["k"]["b"],
        att["v"]["qt"], att["v"]["b"], att["o"]["qt"], att["o"]["b"],
        att["ln"]["scale"], att["ln"]["bias"],
        ffn["w1"]["qt"], ffn["w1"]["b"], ffn["w2"]["qt"], ffn["w2"]["b"],
        ffn["ln"]["scale"], ffn["ln"]["bias"],
    ]
    for tensor in tensors:
        if (tensor.device != x.device or not tensor.is_contiguous()
                or tensor.data_ptr() % 16):
            raise ValueError("layer weights must be contiguous and 16-byte aligned "
                             "on x's device")
    dev = x.device.index
    plan = layer_plan(b, t, e, f, num_heads,
                      lambda rows, cs, width: card_query(
                          dev, "slimt_encoder_clusters", rows, cs, width),
                      sm_count(dev), _cluster)
    scales = []
    for group, name in MATRICES:
        scales += [layer[group][name]["aq"], layer[group][name]["inv"]]
    weights = (ctypes.c_void_p * 16)(*[t_.data_ptr() for t_ in tensors])
    scale_arr = (ctypes.c_float * 12)(*[float(np.float32(s)) for s in scales])
    out = torch.empty_like(x)
    q, k, v, heads = torch.empty(
        plan.scratch, dtype=torch.float32, device=x.device).view(4, -1)
    lib = _build.library()
    code = lib.slimt_encoder_layer(
        x.data_ptr(), mask.data_ptr(), out.data_ptr(), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), heads.data_ptr(),
        ctypes.cast(weights, ctypes.c_void_p),
        ctypes.cast(scale_arr, ctypes.c_void_p),
        b, t, e, f, num_heads,
        ctypes.c_float(np.float32(1.0 / math.sqrt(e // num_heads))),
        plan.qkv_rows, plan.post_rows, plan.cs,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, code, "slimt_encoder_layer")
    launches.count(layer_kernel)
    return out


layer_kernel.launches = 0


def encoder_layer_fused(x, layer, mask_add, num_heads) -> torch.Tensor:
    """x: [B, T, E] f32; layer: {"att", "ffn"} (loader layout, torch);
    mask_add: [B, 1, 1, T] additive. Returns the layer's output."""
    t, e = x.shape[-2], x.shape[-1]
    if t > MAX_T or e % num_heads:
        raise ValueError(
            f"encoder layer needs T <= {MAX_T} and E % heads == 0, "
            f"got T={t}, E={e}, heads={num_heads}"
        )
    if x.is_cuda:
        return layer_kernel(x.contiguous(), layer, mask_add, num_heads)
    if x.device.type == "cpu":
        return layer_plain(x, layer, mask_add, num_heads)
    raise ValueError(f"unsupported device {x.device}")
