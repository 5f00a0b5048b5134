"""Sparse convolutions over precomputed kernel maps (counterpart of
lidiff_tpu/ops/sparse_conv.py:92-460).

`feats` of a grouped conv is [V, G*C], group-major: G independent feature
sets over the same geometry, convolved with the same weights. The sampler
runs the classifier-free cond and uncond streams as G=2.

The 27-tap column conv is kernel A1 (`csrc/conv3_columns.cu`) for CUDA
tensors and its plain PyTorch version, `conv3_columns_plain`, for CPU
tensors. Both accumulate all 27 taps in float32 and cast once, as the TPU
kernel does (lidiff_tpu/ops/pallas_conv.py:800-832). In bf16 the kernel
runs over the map's tile plan (`grid.tile_plan`): only the taps some row
of a 64-row tile hits are computed, which changes no result. The down
and transpose convs are one dense GEMM each plus a gather or scatter, in
plain PyTorch, and differentiate through autograd.

Training differentiates the column conv through `Conv3ColumnsFunction`
(kernel A2, counterpart of conv_columns_pallas_ad,
lidiff_tpu/ops/pallas_conv.py:667-719): the feats gradient is kernel A1 on
the masked cotangent with tap-reversed, transposed weights over the same
map, and the weight gradient is kernel A3 (`csrc/conv3_columns_dw.cu`),
with `conv3_columns_dw_plain` as its plain version. Both backward kernels
run over the forward's tile plan in bf16; A3's blocks follow
`dw_schedule`, kept on the plan.

The int8 eval conv is kernel A4 (`csrc/conv3_columns_q.cu`, counterpart of
conv_columns_pallas_v2(quant=True), lidiff_tpu/ops/pallas_conv.py:840):
`sparse_conv_columns(..., quant=True)` quantizes the input of every column
conv with the eval epilogue and Cin >= 32 per channel to int8, folds the
scales into the weights (`quantize_feats`) and runs A4 on CUDA tensors,
`conv3_columns_q_plain` on CPU tensors. The JAX package selects this path
with the process flag LIDIFF_CONV_QUANT=int8; here the flag is the models'
`conv_quant` argument, which only the command-line entry points read from
that variable.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import torch

from lidiff_tpu_torch.ops import native
from lidiff_tpu_torch.ops.grid import (TILE_ROWS, ColumnKernelMap,
                                       TilePlan, tile_plan)

# Kernel A1 takes these (input, output) dtype pairs; the codes match
# csrc/conv3_columns.cu.
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.bfloat16, torch.float32)}
MAX_CIN = 384

_conv3_kernel = native.Kernel(
    "conv3_columns", "conv3_columns",
    [ctypes.c_int, ctypes.c_int,                       # dtype codes
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # feats, col, hit
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # w, bias, mask
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # nvalid, plan
     ctypes.c_void_p,                                    # out
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # V C Co G
     ctypes.c_int, ctypes.c_void_p])                     # relu, stream

_conv3_q_kernel = native.Kernel(
    "conv3_columns_q", "conv3_columns_q",
    [ctypes.c_int, ctypes.c_int,                       # dtype codes
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, col, hit
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # w', bias, mask
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # nvalid, plan
     ctypes.c_void_p,                                    # out
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # V C Co G
     ctypes.c_int, ctypes.c_void_p])                     # relu, stream

# the int8 path quantizes activation convs only: the stem's input carries
# raw coordinates that 8 bits cannot represent (pallas_conv.py:1018-1031)
QUANT_MIN_CIN = 32

_conv3_dw_kernel = native.Kernel(
    "conv3_columns_dw", "conv3_columns_dw",
    [ctypes.c_int,                                       # dtype code
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # feats, g, col
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # hit, mask, nvalid
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # order, act, tap
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # lo, len, launch
     ctypes.c_void_p, ctypes.c_int,                      # tap_first, n
     ctypes.c_void_p, ctypes.c_void_p,                   # partial, dw
     ctypes.c_int, ctypes.c_int, ctypes.c_int,           # V C ldf
     ctypes.c_int, ctypes.c_int, ctypes.c_int,           # Co ldg G
     ctypes.c_void_p])                                   # stream

# The bf16 weight gradient's blocks: (chunk of a tap's active tiles, 128
# channels of C); chunks are sized for about DW_BLOCKS blocks (four waves
# at one block per SM of an H100), and hold at least DW_MIN_TILES tiles.
DW_BLOCKS = 528
DW_MIN_TILES = 4
DW_CB = 128       # channels of C per block
DW_MAX_CO = 256   # output channels per launch; wider Co splits


def _column_slabs(f, col_idx, hit):
    """For each of the 9 columns, the slab [V, 3, G, C] of float32 feats
    `f` [V, G, C]: the rows p, p+m0, p+m0+m1 of the column's three z-taps,
    zeroed where the tap's hit is 0."""
    V = f.shape[0]
    m0 = hit[:, 0::3].long()
    m1 = hit[:, 1::3].long()
    p = col_idx.long()
    for col in range(9):
        rows = torch.stack([p[:, col], p[:, col] + m0[:, col],
                            p[:, col] + m0[:, col] + m1[:, col]], 1)
        rows = rows.clamp(max=V - 1)
        yield f[rows] * hit[:, 3 * col:3 * col + 3, None, None]


def conv3_columns_plain(feats, col_idx, hit, weights, out_mask, groups,
                        bias=None, relu=False, out_dtype=None):
    """Plain PyTorch version of kernel A1; the same function as the XLA
    path lidiff_tpu/ops/sparse_conv.py:170-232 with no window, but with
    float32 accumulation over all 27 taps and one final cast.

    feats [V, G*C] and weights [27, C, Co] in the compute dtype; bias [Co]
    float32 or None; out_mask [V] bool. Returns [V, G*Co] in out_dtype."""
    V = feats.shape[0]
    _, C, Co = weights.shape
    G = groups
    w3 = weights.float().reshape(9, 3 * C, Co)
    acc = torch.zeros(V * G, Co, dtype=torch.float32, device=feats.device)
    slabs = _column_slabs(feats.float().reshape(V, G, C), col_idx, hit)
    for col, slab in enumerate(slabs):
        slab = slab.permute(0, 2, 1, 3).reshape(V * G, 3 * C)
        acc += slab @ w3[col]
    out = acc.reshape(V, G, Co)
    if bias is not None:
        out = out + bias.float()
    if relu:
        out = out.clamp(min=0)
    out = torch.where(out_mask[:, None, None], out, 0.0)
    return out.reshape(V, G * Co).to(out_dtype or feats.dtype)


def conv3_columns(feats, col_idx, hit, weights, out_mask, groups, *,
                  bias=None, relu=False, out_dtype=None, nvalid=None,
                  plan: TilePlan | None = None):
    """Kernel A1 on CUDA tensors, its plain version on CPU tensors.

    `nvalid` ([] int32 on the device) lets the float32 kernel write whole
    tiles of rows at or past it as zeros without reading anything; those
    rows must be masked out by `out_mask` (valid voxels come first). `plan`
    is the map's tile plan for the bf16 kernel (`ColumnKernelMap.plan()`);
    without it the wrapper builds one from `hit` and `out_mask`.

    With autograd enabled and feats or weights requiring a gradient, the
    call goes through `Conv3ColumnsFunction`; the bias/ReLU epilogue is the
    eval-only BN fold and raises there."""
    out_dtype = out_dtype or feats.dtype
    if torch.is_grad_enabled() and (feats.requires_grad
                                    or weights.requires_grad):
        if bias is not None or relu:
            raise ValueError("conv3_columns: the bias/ReLU epilogue is "
                             "eval-only and has no gradient")
        return Conv3ColumnsFunction.apply(feats, weights, col_idx, hit,
                                          out_mask, nvalid, groups, out_dtype,
                                          plan)
    return _conv3_run(feats, col_idx, hit, weights, out_mask, groups, bias,
                      relu, out_dtype, nvalid, plan)


def _padded(feats, groups, mult):
    """feats [V, G*C] with each group's channels zero-padded to a multiple
    of `mult` (the kernel's 16-byte copies); itself where C is one."""
    V, GC = feats.shape
    C = GC // groups
    Cp = -(-C // mult) * mult
    if Cp == C:
        return feats
    out = feats.new_zeros(V, groups, Cp)
    out[:, :, :C] = feats.reshape(V, groups, C)
    return out.reshape(V, groups * Cp)


def _k_major(weights, mult):
    """weights [27, C, Co] as the bf16 kernel's B operand: [27, Co, Cp],
    input channels contiguous and zero-padded to a multiple of `mult`."""
    Kt, C, Co = weights.shape
    Cp = -(-C // mult) * mult
    wt = weights.new_zeros(Kt, Co, Cp)
    wt[:, :, :C] = weights.transpose(1, 2)
    return wt


def _plan_args(plan, hit, out_mask):
    plan = plan if plan is not None else tile_plan(hit, out_mask)
    if plan.order.shape != (hit.shape[0],) \
            or plan.tile_taps.shape != (-(-hit.shape[0] // TILE_ROWS),) \
            or plan.order.dtype != torch.int32 \
            or plan.tile_taps.dtype != torch.int32:
        raise ValueError("conv3_columns: tile plan of another map")
    return plan.order, plan.tile_taps


def _conv3_run(feats, col_idx, hit, weights, out_mask, groups, bias, relu,
               out_dtype, nvalid, plan=None):
    """One launch of kernel A1 (CUDA) or one plain conv (CPU); no autograd."""
    if feats.device.type == "cpu":
        return conv3_columns_plain(feats, col_idx, hit, weights, out_mask,
                                   groups, bias, relu, out_dtype)
    if feats.device.type != "cuda":
        raise ValueError(f"conv3_columns: unsupported device {feats.device}")
    V = feats.shape[0]
    Kt, C, Co = weights.shape
    G = groups
    if (feats.dtype, out_dtype) not in _PAIRS or weights.dtype != feats.dtype:
        raise ValueError(f"conv3_columns: dtypes {feats.dtype}->{out_dtype}, "
                         f"weights {weights.dtype}")
    if Kt != 27 or feats.shape != (V, G * C) or col_idx.shape != (V, 9) \
            or hit.shape != (V, 27) or out_mask.shape != (V,) or V == 0:
        raise ValueError("conv3_columns: shape mismatch")
    if C > MAX_CIN or G not in (1, 2):
        raise ValueError(f"conv3_columns: C={C} > {MAX_CIN} or G={G}")
    if col_idx.dtype != torch.int32 or hit.dtype != torch.bool \
            or out_mask.dtype != torch.bool:
        raise ValueError("conv3_columns: want int32 col_idx, bool hit/mask")
    if (feats.data_ptr() | weights.data_ptr()) % 16:
        raise ValueError("conv3_columns: feats and weights must start on a "
                         "16-byte boundary (the kernel's vector loads)")
    if nvalid is None:
        nvalid = torch.full((), V, dtype=torch.int32, device=feats.device)
    if bias is not None:
        bias = bias.float().contiguous()
        if bias.shape != (Co,):
            raise ValueError("conv3_columns: bias shape")
    nvalid = nvalid.to(torch.int32)
    native.check_cuda("conv3_columns", feats, col_idx, hit, weights,
                      out_mask, nvalid, *([bias] if bias is not None else []))
    order = tile_taps = None
    if feats.dtype == torch.bfloat16:
        order, tile_taps = _plan_args(plan, hit, out_mask)
        native.check_cuda("conv3_columns", feats, order, tile_taps)
        feats, weights = _padded(feats, G, 8), _k_major(weights, 8)
    out = torch.empty(V, G * Co, dtype=out_dtype, device=feats.device)
    _conv3_kernel(_DTYPE_CODE[feats.dtype], _DTYPE_CODE[out_dtype],
                  native.ptr(feats), native.ptr(col_idx), native.ptr(hit),
                  native.ptr(weights), native.ptr(bias), native.ptr(out_mask),
                  native.ptr(nvalid), native.ptr(order),
                  native.ptr(tile_taps), native.ptr(out), V,
                  feats.shape[1] // G, Co, G, int(relu),
                  native.stream(feats.device))
    return out


def quantize_feats(feats, weights, groups):
    """The prologue of kernel A4, the Pallas kernel's formula
    (lidiff_tpu/ops/pallas_conv.py:911-927): per-channel symmetric int8 with
    one scale per channel over all V rows and all groups (the cond and
    uncond streams share it), the scale folded into the weights.

    feats [V, G*C] and weights [27, C, Co] in the compute dtype. Returns
    (q [V, G*C] int8, w' [27, C, Co] in the weights' dtype); a bf16 w' is
    rounded twice (weights, then w * scale), as in the JAX package."""
    V = feats.shape[0]
    C = weights.shape[1]
    f3 = feats.float().reshape(V, groups, C)
    amax = f3.abs().amax((0, 1))
    # times the float32 reciprocal, as :917 does; not a division by 127
    scale = amax.clamp(min=1e-12) * (1.0 / 127.0)
    q = (f3 / scale).round().clamp(-127, 127).to(torch.int8)
    w_q = (weights.float() * scale[None, :, None]).to(weights.dtype)
    return q.reshape(V, groups * C), w_q


def conv3_columns_q_plain(q, col_idx, hit, w_q, out_mask, groups, bias=None,
                          relu=False, out_dtype=None):
    """Plain PyTorch version of kernel A4: kernel A1's plain version on the
    int8 feats as float (exact) and the scale-folded weights; float32
    accumulation, one final cast (default: the weights' dtype)."""
    return conv3_columns_plain(q, col_idx, hit, w_q, out_mask, groups, bias,
                               relu, out_dtype or w_q.dtype)


def conv3_columns_q(feats, col_idx, hit, weights, out_mask, groups, *,
                    bias=None, relu=False, out_dtype=None, nvalid=None,
                    plan: TilePlan | None = None):
    """The int8 eval conv: `quantize_feats`, then kernel A4 on CUDA tensors
    or its plain version on CPU tensors. Eval-only: no autograd. `nvalid`
    and `plan` as for `conv3_columns`."""
    q, w_q = quantize_feats(feats, weights, groups)
    return _conv3_q_run(q, col_idx, hit, w_q, out_mask, groups, bias, relu,
                        out_dtype or feats.dtype, nvalid, plan)


def _conv3_q_run(q, col_idx, hit, w_q, out_mask, groups, bias, relu,
                 out_dtype, nvalid, plan=None):
    """One launch of kernel A4 (CUDA) or one plain int8 conv (CPU)."""
    if q.device.type == "cpu":
        return conv3_columns_q_plain(q, col_idx, hit, w_q, out_mask, groups,
                                     bias, relu, out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"conv3_columns_q: unsupported device {q.device}")
    V = q.shape[0]
    Kt, C, Co = w_q.shape
    G = groups
    if q.dtype != torch.int8 or (w_q.dtype, out_dtype) not in _PAIRS:
        raise ValueError(f"conv3_columns_q: feats {q.dtype}, weights "
                         f"{w_q.dtype} -> {out_dtype}")
    if Kt != 27 or q.shape != (V, G * C) or col_idx.shape != (V, 9) \
            or hit.shape != (V, 27) or out_mask.shape != (V,) or V == 0:
        raise ValueError("conv3_columns_q: shape mismatch")
    if C > MAX_CIN or G not in (1, 2):
        raise ValueError(f"conv3_columns_q: C={C} > {MAX_CIN} or G={G}")
    if col_idx.dtype != torch.int32 or hit.dtype != torch.bool \
            or out_mask.dtype != torch.bool:
        raise ValueError("conv3_columns_q: want int32 col_idx, bool hit/mask")
    if (q.data_ptr() | w_q.data_ptr()) % 16:
        raise ValueError("conv3_columns_q: feats and weights must start on "
                         "a 16-byte boundary (the kernel's vector loads)")
    if nvalid is None:
        nvalid = torch.full((), V, dtype=torch.int32, device=q.device)
    if bias is not None:
        bias = bias.float().contiguous()
        if bias.shape != (Co,):
            raise ValueError("conv3_columns_q: bias shape")
    nvalid = nvalid.to(torch.int32)
    native.check_cuda("conv3_columns_q", q, col_idx, hit, w_q, out_mask,
                      nvalid, *([bias] if bias is not None else []))
    order = tile_taps = None
    if w_q.dtype == torch.bfloat16:
        order, tile_taps = _plan_args(plan, hit, out_mask)
        native.check_cuda("conv3_columns_q", q, order, tile_taps)
        q, w_q = _padded(q, G, 16), _k_major(w_q, 16)
    out = torch.empty(V, G * Co, dtype=out_dtype, device=q.device)
    _conv3_q_kernel(_DTYPE_CODE[w_q.dtype], _DTYPE_CODE[out_dtype],
                    native.ptr(q), native.ptr(col_idx), native.ptr(hit),
                    native.ptr(w_q), native.ptr(bias), native.ptr(out_mask),
                    native.ptr(nvalid), native.ptr(order),
                    native.ptr(tile_taps), native.ptr(out), V,
                    q.shape[1] // G, Co, G, int(relu),
                    native.stream(q.device))
    return out


def conv3_columns_dw_plain(feats, g, col_idx, hit, out_mask, groups):
    """Plain PyTorch version of kernel A3, the column conv's weight
    gradient (the math of conv_columns_pallas_dw_v2,
    lidiff_tpu/ops/pallas_conv.py:568):

        dW[k, c, co] = sum_o sum_g hit(o, k) feats_g[idx(o, k), c] g_g[o, co]

    with the cotangent `g` [V, G*Co] masked by `out_mask`: per column and
    group one slab^T @ g product, float32 throughout. Returns [27, C, Co]
    float32."""
    V = feats.shape[0]
    G = groups
    C = feats.shape[1] // G
    Co = g.shape[1] // G
    gm = torch.where(out_mask[:, None], g.float(), 0.0).reshape(V, G, Co)
    dw = torch.zeros(9, 3 * C, Co, dtype=torch.float32, device=feats.device)
    slabs = _column_slabs(feats.float().reshape(V, G, C), col_idx, hit)
    for col, slab in enumerate(slabs):
        for gi in range(G):
            dw[col] += slab[:, :, gi].reshape(V, 3 * C).T @ gm[:, gi]
    return dw.reshape(27, C, Co)


@dataclass
class DwSchedule:
    """The bf16 weight gradient's work over a tile plan: for each tap, its
    active tiles (`tile_taps` bit k) in plan order, cut into chunks of at
    most `tiles` tiles. Chunk i covers act[tap[i], lo[i] : lo[i] + len[i]];
    chunks are numbered tap by tap, so tap k's are tap_first[k] ..
    tap_first[k + 1] - 1; `launch` orders them by their first tile, so
    that the blocks in flight share tiles across taps."""
    act: torch.Tensor        # [27, ceil(V / 64)] int32
    tap: torch.Tensor        # [n] int32
    lo: torch.Tensor         # [n] int32
    len: torch.Tensor        # [n] int32
    launch: torch.Tensor     # [n] int32, chunk ids
    tap_first: torch.Tensor  # [28] int32
    tiles: int


@dataclass
class DwPlan:
    """What kernel A3 derives from a tile plan, kept on it (`TilePlan.dw`):
    per tap its active tiles first, in plan order; the 27 tap counts on
    the host, ready once `counted` has passed (None: already there); and
    the schedules made so far, by chunk size."""
    act: torch.Tensor              # [27, ceil(V / 64)] int32
    counts: torch.Tensor           # [27] on the host
    counted: torch.cuda.Event | None
    schedules: dict = field(default_factory=dict)   # tiles -> DwSchedule


def dw_prepare(plan: TilePlan) -> DwPlan:
    """`plan`'s `DwPlan`, made on first use. On the card the tap counts are
    copied to pinned memory behind an event when the forward first runs
    over the plan (`Conv3ColumnsFunction.forward`), so the backward reads
    them without waiting for the queue."""
    if plan.dw is None:
        bits = (plan.tile_taps[None, :] >> torch.arange(
            27, dtype=torch.int32, device=plan.tile_taps.device)[:, None]) & 1
        act = torch.sort(1 - bits, dim=1, stable=True).indices \
            .to(torch.int32).contiguous()
        counts, counted = bits.sum(1), None
        if counts.is_cuda:
            counts = counts.to("cpu", non_blocking=True)
            counted = torch.cuda.Event()
            counted.record()
        plan.dw = DwPlan(act=act, counts=counts, counted=counted)
    return plan.dw


def dw_schedule(plan: TilePlan, n_cblocks: int) -> DwSchedule:
    """The schedule of kernel A3's bf16 blocks over `plan` for `n_cblocks`
    blocks of DW_CB channels per chunk; kept on the plan, so a map's convs
    share it. The host waits only for the copy of the counts that
    `dw_prepare` started; the chunk table goes to the card in one copy from
    pinned memory that the host does not wait for, and the rest is tensor
    ops on the plan's device."""
    dw = dw_prepare(plan)
    if dw.counted is not None:
        dw.counted.synchronize()
        dw.counted = None
    counts = dw.counts.tolist()
    tiles = max(DW_MIN_TILES,
                -(-sum(counts) * n_cblocks // DW_BLOCKS))
    if tiles not in dw.schedules:
        chunks = [(k, lo, min(tiles, c - lo)) for k, c in enumerate(counts)
                  for lo in range(0, c, tiles)]
        first = [0] * 28
        for k, _, _ in chunks:
            first[k + 1] += 1
        for k in range(27):
            first[k + 1] += first[k]
        n = len(chunks)
        table = torch.tensor([ch[i] for i in range(3) for ch in chunks]
                             + first, dtype=torch.int32)
        dev = dw.act.device
        if dev.type == "cuda":
            table = table.pin_memory().to(dev, non_blocking=True)
        tap, lo, ln, first = table.split([n, n, n, 28])
        start = dw.act[tap.long(), lo.long()].long()
        launch = torch.sort(start * 27 + tap.long(), stable=True).indices
        dw.schedules[tiles] = DwSchedule(
            act=dw.act, tap=tap, lo=lo, len=ln,
            launch=launch.to(torch.int32).contiguous(), tap_first=first,
            tiles=tiles)
    return dw.schedules[tiles]


def conv3_columns_dw(feats, g, col_idx, hit, out_mask, groups, *,
                     nvalid=None, plan: TilePlan | None = None):
    """Kernel A3 on CUDA tensors, its plain version on CPU tensors.

    feats [V, G*C] in the compute dtype; the cotangent `g` [V, G*Co] is
    cast to feats' dtype first, as the TPU kernel does
    (lidiff_tpu/ops/pallas_conv.py:604). Returns dW [27, C, Co] float32.
    bf16 runs over the map's tile plan (`plan`, the forward's; built from
    `hit` and `out_mask` if None) and sums each tap's chunk partials in a
    fixed order: deterministic. float32 (rows at or past `nvalid` must be
    masked out by `out_mask`) adds block partials with float32 atomics, so
    the order of its sum over rows changes from run to run."""
    g = g.to(feats.dtype).contiguous()
    if feats.device.type == "cpu":
        return conv3_columns_dw_plain(feats, g, col_idx, hit, out_mask,
                                      groups)
    if feats.device.type != "cuda":
        raise ValueError(f"conv3_columns_dw: unsupported device "
                         f"{feats.device}")
    V, G = feats.shape[0], groups
    if feats.dtype not in _DTYPE_CODE:
        raise ValueError(f"conv3_columns_dw: dtype {feats.dtype}")
    if G not in (1, 2) or feats.shape[1] % G or g.shape[1] % G:
        raise ValueError(f"conv3_columns_dw: G={G} does not split the "
                         "channels")
    C, Co = feats.shape[1] // G, g.shape[1] // G
    if g.shape[0] != V or col_idx.shape != (V, 9) or hit.shape != (V, 27) \
            or out_mask.shape != (V,) or V == 0:
        raise ValueError("conv3_columns_dw: shape mismatch")
    if C > MAX_CIN or Co > MAX_CIN:
        raise ValueError(f"conv3_columns_dw: C={C} or Co={Co} > {MAX_CIN}")
    if col_idx.dtype != torch.int32 or hit.dtype != torch.bool \
            or out_mask.dtype != torch.bool:
        raise ValueError("conv3_columns_dw: want int32 col_idx, bool "
                         "hit/mask")
    if nvalid is None:
        nvalid = torch.full((), V, dtype=torch.int32, device=feats.device)
    nvalid = nvalid.to(torch.int32)
    native.check_cuda("conv3_columns_dw", feats, g, col_idx, hit, out_mask,
                      nvalid)
    if feats.dtype == torch.float32:
        dw = torch.zeros(27, C, Co, dtype=torch.float32, device=feats.device)
        _conv3_dw_kernel(0, native.ptr(feats), native.ptr(g),
                         native.ptr(col_idx), native.ptr(hit),
                         native.ptr(out_mask), native.ptr(nvalid),
                         *[native.ptr(None)] * 7, 0, native.ptr(None),
                         native.ptr(dw), V, C, C, Co, Co, G,
                         native.stream(feats.device))
        return dw
    plan = plan if plan is not None else tile_plan(hit, out_mask)
    order, _ = _plan_args(plan, hit, out_mask)
    if Co > DW_MAX_CO:   # one launch per DW_MAX_CO output channels
        g3 = g.reshape(V, G, Co)
        return torch.cat([conv3_columns_dw(
            feats, g3[:, :, a:a + DW_MAX_CO].reshape(V, -1), col_idx, hit,
            out_mask, G, nvalid=nvalid, plan=plan)
            for a in range(0, Co, DW_MAX_CO)], dim=2)
    fp, gp = _padded(feats, G, 8), _padded(g, G, 8)
    if (fp.data_ptr() | gp.data_ptr()) % 16:
        raise ValueError("conv3_columns_dw: feats and g must start on a "
                         "16-byte boundary (the kernel's vector loads)")
    sched = dw_schedule(plan, -(-C // DW_CB))
    n = sched.tap.shape[0]
    partial = torch.empty(n, C, Co, dtype=torch.float32, device=feats.device)
    dw = torch.empty(27, C, Co, dtype=torch.float32, device=feats.device)
    _conv3_dw_kernel(1, native.ptr(fp), native.ptr(gp), native.ptr(col_idx),
                     native.ptr(hit), native.ptr(out_mask), native.ptr(nvalid),
                     native.ptr(order), native.ptr(sched.act),
                     native.ptr(sched.tap), native.ptr(sched.lo),
                     native.ptr(sched.len), native.ptr(sched.launch),
                     native.ptr(sched.tap_first), n, native.ptr(partial),
                     native.ptr(dw), V, C, fp.shape[1] // G, Co,
                     gp.shape[1] // G, G, native.stream(feats.device))
    return dw


class Conv3ColumnsFunction(torch.autograd.Function):
    """Kernel A2: the differentiable column conv, no epilogue (BN runs
    separately in training).

    The backward rule is the TPU package's (_ad_bwd,
    lidiff_tpu/ops/pallas_conv.py:691-716), not autograd of the plain conv:
    the cotangent is masked by `out_mask` and cast to feats' dtype; the
    feats gradient is the same conv on it with the weights tap-reversed and
    transposed, over the same map, in feats' dtype; the weight gradient is
    kernel A3, cast to the weights' dtype. The flipped conv is the exact
    gradient where the map is symmetric (voxel i is o's tap k exactly when
    o is i's tap 26 - k), which holds for a level's own 27-tap map with
    `out_mask` the level's mask. The feats gradient runs over the forward's
    tile plan: its rows and taps are the forward's. CPU tensors take the
    plain versions of both kernels under the same rule."""

    # feats-gradient launches of kernel A1 made by `backward` (they also
    # count as launches of A1)
    launches = 0

    @staticmethod
    def forward(ctx, feats, weights, col_idx, hit, out_mask, nvalid, groups,
                out_dtype, plan):
        if plan is None and feats.is_cuda and feats.dtype == torch.bfloat16:
            plan = tile_plan(hit, out_mask)
        if plan is not None and ctx.needs_input_grad[1]:
            dw_prepare(plan)
        ctx.save_for_backward(feats, weights, col_idx, hit, out_mask, nvalid)
        ctx.groups, ctx.plan = groups, plan
        return _conv3_run(feats, col_idx, hit, weights, out_mask, groups,
                          None, False, out_dtype, nvalid, plan)

    @staticmethod
    def backward(ctx, g):
        feats, weights, col_idx, hit, out_mask, nvalid = ctx.saved_tensors
        g = torch.where(out_mask[:, None], g, 0.0).to(feats.dtype)
        g = g.contiguous()
        df = dw = None
        if ctx.needs_input_grad[0]:
            w_rev = weights.flip(0).transpose(1, 2).contiguous()
            before = _conv3_kernel.launches
            df = _conv3_run(g, col_idx, hit, w_rev, out_mask, ctx.groups,
                            None, False, feats.dtype, nvalid, ctx.plan)
            Conv3ColumnsFunction.launches += _conv3_kernel.launches - before
        if ctx.needs_input_grad[1]:
            dw = conv3_columns_dw(feats, g, col_idx, hit, out_mask,
                                  ctx.groups, nvalid=nvalid, plan=ctx.plan)
            dw = dw.to(weights.dtype)
        return df, dw, None, None, None, None, None, None, None


def sparse_conv_columns(feats, kmap: ColumnKernelMap, weights, out_mask, *,
                        groups: int = 1, bias=None, relu: bool = False,
                        compute_dtype=torch.float32, quant: bool = False):
    """27-tap sparse conv over a column kernel map with the fused
    bias/ReLU/mask epilogue. Inputs and weights are cast to
    `compute_dtype`; the output keeps feats' dtype.

    `quant` selects the int8 eval conv (kernel A4) under the JAX package's
    gate (lidiff_tpu/ops/sparse_conv.py:139-167): only a conv with the eval
    epilogue (bias or ReLU: the folded BN) and Cin >= QUANT_MIN_CIN, and
    never one under autograd. Every other conv is kernel A1. On the card
    both run over the map's tile plan, built by the first conv over the
    map and shared by the rest (and by the feats gradient)."""
    cf = feats.to(compute_dtype).contiguous()
    cw = weights.to(compute_dtype).contiguous()
    run = conv3_columns
    if quant and (bias is not None or relu) \
            and weights.shape[1] >= QUANT_MIN_CIN \
            and not (torch.is_grad_enabled()
                     and (cf.requires_grad or cw.requires_grad)):
        run = conv3_columns_q
    plan = kmap.plan() if cf.is_cuda and cw.dtype == torch.bfloat16 else None
    return run(cf, kmap.col_idx, kmap.hit, cw, out_mask, groups, bias=bias,
               relu=relu, out_dtype=feats.dtype, nvalid=kmap.nvalid,
               plan=plan)


def sparse_conv_down(feats, parent_idx, tap, weights, out_mask, *,
                     groups: int = 1, bias=None, relu: bool = False,
                     compute_dtype=torch.float32):
    """ks=2 / stride-2 down conv in child form: one GEMM against all 8 tap
    weights, a tap select, and a scatter-add into the parents.

    As in the JAX package (sparse_conv.py:363-369) the selected products
    are cast to the compute dtype BEFORE the scatter-add, so in bf16 a
    parent's n <= 8 children sum in bf16. On CUDA `index_add_` adds them in
    atomic order, so two runs, or the card and the CPU, may differ. With
    A = the sum over the parent's children and input channels of
    |feat| * |weight|, each child's GEMM output is within one bf16 ulp
    (2^-7 A) and each of the n - 1 bf16 adds within half an ulp of its
    partial sum, so a bf16 result is within n * 2^-7 * A of any other
    order, plus one ulp of the output when it is bf16 as well."""
    Kt, Cin, Cout = weights.shape
    G = groups
    Vf = feats.shape[0]
    Vc = out_mask.shape[0]
    out_dtype = feats.dtype
    cf = feats.to(compute_dtype)
    w_all = weights.to(compute_dtype).permute(1, 0, 2).reshape(Cin, Kt * Cout)
    ok = parent_idx < Vc
    y = torch.matmul(cf.reshape(Vf * G, Cin), w_all).float()
    y = y.reshape(Vf, G, Kt, Cout)
    sel = tap.long().clamp(0, Kt - 1)[:, None, None, None].expand(Vf, G, 1,
                                                                  Cout)
    ysel = torch.gather(y, 2, sel)[:, :, 0] * ok[:, None, None]
    ysel = ysel.reshape(Vf, G * Cout).to(compute_dtype)
    out = torch.zeros(Vc + 1, G * Cout, dtype=compute_dtype,
                      device=feats.device)
    out.index_add_(0, parent_idx.long().clamp(max=Vc), ysel)
    out = out[:Vc].float()
    if bias is not None:
        out = out + bias.float().repeat(G)
    if relu:
        out = out.clamp(min=0)
    return (out * out_mask[:, None]).to(out_dtype)


def sparse_conv_transpose(coarse_feats, parent_idx, tap, weights, fine_mask,
                          *, groups: int = 1, compute_dtype=torch.float32):
    """ks=2 / stride-2 transpose conv: out[v] = coarse[parent(v)] @
    W[tap(v)], as one GEMM of all 8 taps per coarse voxel and a row gather.
    G > 1 runs each group through the same GEMM as extra rows, which
    computes what the JAX package's block-diagonal GEMM does
    (sparse_conv.py:413-429)."""
    Kt, Cin, Cout = weights.shape
    G = groups
    Vc = coarse_feats.shape[0]
    out_dtype = coarse_feats.dtype
    cf = coarse_feats.to(compute_dtype).reshape(Vc * G, Cin)
    w_all = weights.to(compute_dtype).permute(1, 0, 2).reshape(Cin, Kt * Cout)
    y = torch.matmul(cf, w_all).to(out_dtype).reshape(Vc, G, Kt, Cout)
    pidx = parent_idx.long().clamp(max=Vc - 1)
    o = y[pidx, :, tap.long()]                        # [V_f, G, Cout]
    ok = (parent_idx < Vc) & fine_mask
    return (o * ok[:, None, None]).reshape(-1, G * Cout)


def masked_moments(feats, mask):
    """Per-channel mean and biased variance over the valid voxels, and
    their count (counterpart of lidiff_tpu/ops/sparse_conv.py:434-460,
    one device). The sums are float32 whatever feats' dtype;
    var = max(s2 / cnt - mean^2, 0) and cnt = max(sum(mask), 1)."""
    mv = mask.to(feats.dtype)
    fm = feats * mv[:, None]
    s1 = fm.float().sum(0)
    s2 = (fm * feats).float().sum(0)
    cnt = mv.float().sum().clamp(min=1.0)
    mean = s1 / cnt
    var = (s2 / cnt - mean * mean).clamp(min=0.0)
    return mean, var, cnt
