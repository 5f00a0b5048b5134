"""Point Transformer V3 (Wu et al., "Point Transformer V3: Simpler, Faster,
Stronger", CVPR 2024, arXiv:2312.10035; Pointcept's
`point_transformer_v3m1_base.py`, PT-v3m1) for semantic segmentation,
over the port's voxel pyramid, and `SegTask`, its training loss.

The network, as Pointcept's:
- `Embedding`: a 5x5x5 submanifold conv with no bias, BatchNorm(eps 1e-3,
  momentum 0.01), GELU.
- `Block`: xCPE (27-tap submanifold conv with bias, Linear, LayerNorm)
  added to the residual; pre-norm serialized attention (qkv with bias,
  heads of 16, scale 16^-0.5, no RPE) and DropPath; pre-norm MLP (4C,
  GELU) and DropPath. DropPath drops whole rows (Pointcept applies timm's
  DropPath to the [N, C] features).
- `Pooling` (SerializedPooling): Linear, the max over each parent's
  children, BatchNorm, GELU. `Unpooling`: Linear + BatchNorm + GELU on the
  coarse level and on the skip, then each fine row adds its parent's row.
- Encoder depths (2, 2, 2, 6, 2), widths (32, 64, 128, 256, 512), heads
  (2, 4, 8, 16, 32); decoder depths (2, 2, 2, 2), widths (64, 64, 128,
  256), heads (4, 4, 8, 16); DropPath rates linear from 0 to 0.3 over the
  encoder's blocks and over the decoder's (each decoder stage's reversed).
- Block i of a level takes the level's serialized order i % 4 (z,
  z-trans, hilbert, hilbert-trans, shuffled once a level in training:
  `ops/serialize.py`).

The levels are the port's pyramid over Pointcept's grid coordinates
(`grid.build_pyramid_grid`), whose pooling is PTv3's `code >> 3`. Every
level's valid rows come first; after the step's one host sync
(`serialize.level_counts`) the network runs on exactly those rows. The
27-tap convs are kernel A1 (A2 and A3 in the backward pass) over the
level's column map, the stem the gather-form conv over a 125-tap map.
Activations are float32; the Linears, convs and attention compute in the
compute dtype. Attention gathers the qkv rows of each order's padded
patches into [patches, heads, K, 16] and runs
`torch.nn.functional.scaled_dot_product_attention`, on the card
restricted to its flash backend, so that a fallback raises.

Departures from Pointcept: bfloat16 compute with no loss scaler in place
of fp16 AMP; the orders are not shuffled in eval; the pooled coordinate
mean is not computed (nothing reads it without RPE); a voxel that both
items of a Mix3D pair occupy holds one row (the data's collation keeps the
first item's point).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from lidiff_tpu_torch import resolve_device
from lidiff_tpu_torch.config import compute_dtype_from_env
from lidiff_tpu_torch.models.blocks import (MaskedBatchNorm, he_uniform_,
                                           set_bn_group)
from lidiff_tpu_torch.models.diffusion import eval_no_grad
from lidiff_tpu_torch.ops import grid as grid_ops
from lidiff_tpu_torch.ops import serialize
from lidiff_tpu_torch.ops.sparse_conv import conv3_columns, sparse_conv
from lidiff_tpu_torch.utils import prof

ENC_DEPTHS = (2, 2, 2, 6, 2)
ENC_CHANNELS = (32, 64, 128, 256, 512)
ENC_HEADS = (2, 4, 8, 16, 32)
DEC_DEPTHS = (2, 2, 2, 2)
DEC_CHANNELS = (64, 64, 128, 256)
DEC_HEADS = (4, 4, 8, 16)
BN_EPS, BN_MOMENTUM = 1e-3, 0.01


def _bn(c: int) -> MaskedBatchNorm:
    return MaskedBatchNorm(c, eps=BN_EPS, momentum=BN_MOMENTUM)


def _ones(n: int, device) -> torch.Tensor:
    return torch.ones(n, dtype=torch.bool, device=device)


def linear(x, layer: nn.Linear, dtype) -> torch.Tensor:
    """`layer` with its GEMM in `dtype`; the output stays in `dtype`."""
    b = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), b)


@contextlib.contextmanager
def _flash_only(device):
    """On the card, SDPA's flash backend alone: a fallback raises."""
    if device.type != "cuda":
        yield
        return
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        yield


class Level:
    """What the blocks of one level share in a step: its geometry, its
    valid row count `n`, its column map cut to those rows (`kmap`) and
    its serialization."""

    def __init__(self, geom: grid_ops.LevelGeom, n: int,
                 orders: serialize.LevelOrders | None):
        self.geom, self.n, self.orders = geom, n, orders
        km = geom.kmap3
        # valid rows come first and their neighbours are valid rows: the
        # map's first n rows are the map of those rows alone
        self.kmap = grid_ops.ColumnKernelMap(
            col_idx=km.col_idx[:n], hit=km.hit[:n], nvalid=km.nvalid,
            plan_key=km.plan_key[:n])
        self.mask = geom.geom.mask[:n]


class CPE(nn.Module):
    """xCPE: 27-tap submanifold conv with bias, Linear, LayerNorm."""

    def __init__(self, c: int, compute_dtype):
        super().__init__()
        self.conv_kernel = nn.Parameter(torch.empty(27, c, c))
        self.conv_bias = nn.Parameter(torch.zeros(c))
        self.linear = nn.Linear(c, c)
        self.norm = nn.LayerNorm(c)
        self.compute_dtype = compute_dtype

    def forward(self, x, lvl: Level):
        cd = self.compute_dtype
        km = lvl.kmap
        with prof.annotate("lidiff.ptv3.cpe"):
            xc = x.to(cd).contiguous()
            y = conv3_columns(xc, km.col_idx, km.hit,
                              self.conv_kernel.to(cd).contiguous(),
                              lvl.mask, 1, bias=self.conv_bias,
                              out_dtype=torch.float32, nvalid=km.nvalid,
                              plan=km.plan() if xc.is_cuda
                              and cd == torch.bfloat16 else None)
            y = self.norm(linear(y, self.linear, cd).float())
        return prof.annotate_backward_region(xc, y, "lidiff.ptv3.cpe")


class Attention(nn.Module):
    """Serialized patch attention over one of the level's orders."""

    def __init__(self, c: int, heads: int, compute_dtype):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(c, 3 * c, bias=True)
        self.proj = nn.Linear(c, c)
        self.compute_dtype = compute_dtype

    def forward(self, x, lvl: Level, order: int):
        cd = self.compute_dtype
        n, C = x.shape
        H = self.heads
        D = C // H
        o = lvl.orders
        K = o.maps.patch
        qkv = linear(x, self.qkv, cd)
        with prof.annotate("lidiff.ptv3.attn"):
            rows = qkv.index_select(0, o.gather[order])
            n_pad = rows.shape[0]
            q, k, v = rows.view(n_pad // K, K, 3, H, D).permute(
                2, 0, 3, 1, 4).unbind(0)
            with _flash_only(x.device):
                out = F.scaled_dot_product_attention(q, k, v,
                                                     scale=D ** -0.5)
            out = out.transpose(1, 2).reshape(n_pad, C)
            out = out.index_select(0, o.scatter[order])
        serialize.counters["attn_rows"] += n_pad
        serialize.counters["attn_filler"] += n_pad - n
        out = prof.annotate_backward_region(rows, out, "lidiff.ptv3.attn")
        return linear(out, self.proj, cd).float()


class MLP(nn.Module):
    def __init__(self, c: int, hidden: int, compute_dtype):
        super().__init__()
        self.fc1 = nn.Linear(c, hidden)
        self.fc2 = nn.Linear(hidden, c)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        cd = self.compute_dtype
        h = F.gelu(linear(x, self.fc1, cd).float())
        return linear(h, self.fc2, cd).float()


class Block(nn.Module):
    def __init__(self, c: int, heads: int, drop_path: float, order: int,
                 compute_dtype):
        super().__init__()
        self.cpe = CPE(c, compute_dtype)
        self.norm1 = nn.LayerNorm(c)
        self.attn = Attention(c, heads, compute_dtype)
        self.norm2 = nn.LayerNorm(c)
        self.mlp = MLP(c, 4 * c, compute_dtype)
        self.drop_path = drop_path
        self.order = order

    def forward(self, x, lvl: Level, masks):
        """masks: the DropPath row masks of the attention and the MLP
        branch ([n] float, already over the keep rate), or None."""
        x = x + self.cpe(x, lvl)
        h = self.attn(self.norm1(x), lvl, self.order)
        if masks is not None:
            h = h * masks[0][:, None]
        x = x + h
        h = self.mlp(self.norm2(x))
        if masks is not None:
            h = h * masks[1][:, None]
        return x + h


class Embedding(nn.Module):
    """5x5x5 submanifold conv, no bias, BatchNorm, GELU."""

    def __init__(self, cin: int, cout: int, compute_dtype):
        super().__init__()
        self.conv_kernel = nn.Parameter(torch.empty(125, cin, cout))
        self.norm = _bn(cout)
        self.compute_dtype = compute_dtype

    def forward(self, feats, kmap: grid_ops.KernelMap, n: int):
        x = sparse_conv(feats, kmap, self.conv_kernel, _ones(n, feats.device),
                        fused=True, compute_dtype=self.compute_dtype)
        return F.gelu(self.norm(x, _ones(n, x.device), 1))


class Pooling(nn.Module):
    """SerializedPooling: Linear, max over children, BatchNorm, GELU."""

    def __init__(self, cin: int, cout: int, compute_dtype):
        super().__init__()
        self.proj = nn.Linear(cin, cout)
        self.norm = _bn(cout)
        self.compute_dtype = compute_dtype

    def forward(self, x, parent, n_coarse: int):
        with prof.annotate("lidiff.ptv3.pool"):
            y = linear(x, self.proj, self.compute_dtype).float()
            idx = parent[:, None].expand(-1, y.shape[1])
            out = y.new_zeros(n_coarse, y.shape[1]).scatter_reduce(
                0, idx, y, "amax", include_self=False)
            out = F.gelu(self.norm(out, _ones(n_coarse, x.device), 1))
        return prof.annotate_backward_region(y, out, "lidiff.ptv3.pool")


class Unpooling(nn.Module):
    """SerializedUnpooling: Linear + BatchNorm + GELU on the coarse rows and
    on the skip, then each fine row adds its parent's."""

    def __init__(self, cin: int, cskip: int, cout: int, compute_dtype):
        super().__init__()
        self.proj = nn.Linear(cin, cout)
        self.proj_norm = _bn(cout)
        self.skip = nn.Linear(cskip, cout)
        self.skip_norm = _bn(cout)
        self.compute_dtype = compute_dtype

    def forward(self, coarse, skip, parent):
        cd = self.compute_dtype
        with prof.annotate("lidiff.ptv3.unpool"):
            y = linear(coarse, self.proj, cd).float()
            yc = F.gelu(self.proj_norm(y, _ones(y.shape[0], y.device), 1))
            s = linear(skip, self.skip, cd).float()
            s = F.gelu(self.skip_norm(s, _ones(s.shape[0], s.device), 1))
            out = s + yc.index_select(0, parent)
        return prof.annotate_backward_region(y, out, "lidiff.ptv3.unpool")


def drop_path_rates(total: float = 0.3):
    """(encoder rates per stage, decoder rates per stage), Pointcept's."""
    enc = torch.linspace(0, total, sum(ENC_DEPTHS)).tolist()
    dec = torch.linspace(0, total, sum(DEC_DEPTHS)).tolist()
    e = [enc[sum(ENC_DEPTHS[:s]):sum(ENC_DEPTHS[:s + 1])]
         for s in range(len(ENC_DEPTHS))]
    d = [dec[sum(DEC_DEPTHS[:s]):sum(DEC_DEPTHS[:s + 1])][::-1]
         for s in range(len(DEC_DEPTHS))]
    return e, d


class PointTransformerV3(nn.Module):
    """PT-v3m1 with its segmentation head: per level-0 voxel, the logits of
    `num_classes`. Parameters inside blocks carry "block" in their names
    (the optimizer's lower-lr group), as in Pointcept."""

    def __init__(self, in_channels: int = 4, num_classes: int = 19,
                 drop_path: float = 0.3, enc_channels=ENC_CHANNELS,
                 dec_channels=DEC_CHANNELS, enc_heads=ENC_HEADS,
                 dec_heads=DEC_HEADS, compute_dtype=torch.float32):
        super().__init__()
        cd = compute_dtype
        self.compute_dtype = cd
        self.num_classes = num_classes
        self.embedding = Embedding(in_channels, enc_channels[0], cd)
        e_dpr, d_dpr = drop_path_rates(drop_path)
        self.enc = nn.ModuleDict()
        for s, depth in enumerate(ENC_DEPTHS):
            m = nn.ModuleDict()
            if s > 0:
                m["down"] = Pooling(enc_channels[s - 1], enc_channels[s], cd)
            for i in range(depth):
                m[f"block{i}"] = Block(enc_channels[s], enc_heads[s],
                                       e_dpr[s][i], i % 4, cd)
            self.enc[f"enc{s}"] = m
        self.dec = nn.ModuleDict()
        up_in = list(dec_channels) + [enc_channels[-1]]
        for s in reversed(range(len(DEC_DEPTHS))):
            m = nn.ModuleDict()
            m["up"] = Unpooling(up_in[s + 1], enc_channels[s],
                                dec_channels[s], cd)
            for i in range(DEC_DEPTHS[s]):
                m[f"block{i}"] = Block(dec_channels[s], dec_heads[s],
                                       d_dpr[s][i], i % 4, cd)
            self.dec[f"dec{s}"] = m
        self.seg_head = nn.Linear(dec_channels[0], num_classes)

    def blocks(self):
        """Every Block in the order the forward runs them."""
        out = [b for m in self.enc.values() for k, b in m.items()
               if k.startswith("block")]
        for s in reversed(range(len(DEC_DEPTHS))):
            out += [b for k, b in self.dec[f"dec{s}"].items()
                    if k.startswith("block")]
        return out

    def forward(self, pyr: grid_ops.Pyramid, levels: list, stem_map,
                masks=None):
        """levels: a `Level` per pyramid level; stem_map the 125-tap map of
        level 0's rows; masks: the DropPath masks of each block in
        `blocks()` order (None: no DropPath)."""
        masks = iter(masks) if masks is not None else None

        def run(stage, x, lvl):
            for k, b in stage.items():
                if k.startswith("block"):
                    x = b(x, lvl, next(masks) if masks is not None
                          and b.drop_path > 0 else None)
            return x

        x = self.embedding(pyr.vox_feats, stem_map, levels[0].n)
        skips = []
        for s, stage in enumerate(self.enc.values()):
            if s > 0:
                fine = levels[s - 1]
                x = stage["down"](x, fine.geom.parent_idx[:fine.n].long(),
                                  levels[s].n)
            x = run(stage, x, levels[s])
            skips.append(x)
        for s in reversed(range(len(DEC_DEPTHS))):
            stage = self.dec[f"dec{s}"]
            fine = levels[s]
            x = stage["up"](x, skips[s],
                            fine.geom.parent_idx[:fine.n].long())
            x = run(stage, x, fine)
        return linear(x, self.seg_head, self.compute_dtype).float()


def init_weights(model: nn.Module, gen: torch.Generator) -> None:
    """Seeded random init: Linears trunc-normal(0.02) with zero bias,
    LayerNorm and BatchNorm at identity, conv kernels He-uniform over the
    fan-in (taps x Cin) with zero bias. Draws on the CPU generator."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                w = torch.randn(m.weight.shape, generator=gen) * 0.02
                m.weight.copy_(w.clamp(-0.04, 0.04))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, MaskedBatchNorm):
                m.scale.fill_(1.0)
                m.bias.zero_()
                m.mean.zero_()
                m.var.fill_(1.0)
            elif isinstance(m, (CPE, Embedding)):
                taps, cin, _ = m.conv_kernel.shape
                he_uniform_(m.conv_kernel, taps * cin, gen)
                if isinstance(m, CPE):
                    m.conv_bias.zero_()


_keeps: dict = {}


def _keep_rates(rates: tuple, device) -> torch.Tensor:
    """[2 k, 1] the keep rate of each of k blocks' two masks, made once a
    device: a copy from the host each step would make it wait for the
    card."""
    key = (rates, torch.device(device))
    if key not in _keeps:
        _keeps[key] = torch.tensor([1.0 - p for p in rates for _ in (0, 1)],
                                   device=device)[:, None]
    return _keeps[key]


def draw(generator: torch.Generator, counts: list, rates: list,
         device) -> dict:
    """A training step's random draws: a permutation of the four orders
    per level (`perms`), then, for each block with a DropPath rate in
    `blocks()` order, the row masks of its two branches (`masks`: [n]
    float, 1 / keep where kept, 0 where dropped), drawn a run of blocks
    on one level at a time. `counts`: rows per level; `rates`: (level,
    rate) of each block."""
    perms = [torch.randperm(4, generator=generator, device=device)
             for _ in counts]
    masks, i = [], 0
    while i < len(rates):
        lvl = rates[i][0]
        j = i
        while j < len(rates) and rates[j][0] == lvl:
            j += 1
        ps = tuple(p for _, p in rates[i:j] if p > 0)
        i = j
        if not ps:
            continue
        keep = _keep_rates(ps, device)
        u = torch.rand(2 * len(ps), counts[lvl], generator=generator,
                       device=device)
        m = (u < keep).float() / keep
        masks += [(m[2 * k], m[2 * k + 1]) for k in range(len(ps))]
    return {"perms": perms, "masks": masks}


def lovasz_softmax(probs: torch.Tensor, labels: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Lovász-softmax (Berman et al. 2018) over the classes present among
    the valid rows: per class, the errors |fg - p| sorted in descending
    order dotted with the Lovász extension's gradient of the Jaccard
    loss, then the mean over the present classes. Rows outside `valid`
    carry error 0 and take no part (they add 0 wherever they sort)."""
    C = probs.shape[1]
    cls = torch.arange(C, device=probs.device)
    fg = ((labels[None, :] == cls[:, None]) & valid[None, :]).float()
    err = torch.where(valid[None, :], (fg - probs.T).abs(), 0.0)
    err_s, perm = torch.sort(err, dim=1, descending=True)
    fg_s = torch.gather(fg, 1, perm)
    gts = fg_s.sum(1, keepdim=True)
    inter = gts - fg_s.cumsum(1)
    union = gts + (1.0 - fg_s).cumsum(1)
    jac = 1.0 - inter / union
    grad = torch.cat([jac[:, :1], jac[:, 1:] - jac[:, :-1]], 1)
    per_class = (err_s * grad).sum(1)
    present = (gts[:, 0] > 0).float()
    return (per_class * present).sum() / present.sum().clamp(min=1.0)


class SegTask:
    """Config, model, the training loss and the eval forward of PTv3
    semantic segmentation.

    Runs on `device` (default: the card) with `compute_dtype` (default: the
    one LIDIFF_COMPUTE_DTYPE names). Weights are a seeded random init
    (`seed`). `group` syncs the BatchNorm moments over its ranks, as the
    other tasks. The config's `model` section gives the network's
    `in_channels`, `num_classes`, `drop_path` and its widths and heads
    (`enc_channels`, `dec_channels`, `enc_num_head`, `dec_num_head`;
    default Pointcept's); `data.ignore_index` the
    label the loss ignores; `tpu.full_capacities` the pyramid's levels.

    A batch (`data/seg.py` `collate`): 'grid_coord' [N, 3] int, 'feat'
    [N, in_channels] float32, 'segment' [N] int64 (ignore_index to
    ignore) and 'offset' [B] int64, the end of each element's points."""

    # the model section's keys the network fixes as Pointcept publishes
    # them: a config that sets one otherwise is refused, not ignored
    FIXED = {"enc_depths": list(ENC_DEPTHS), "dec_depths": list(DEC_DEPTHS),
             "order": list(serialize.ORDERS), "stride": [2, 2, 2, 2],
             "enc_patch_size": [serialize.MAX_PATCH] * 5,
             "dec_patch_size": [serialize.MAX_PATCH] * 4, "mlp_ratio": 4,
             "qkv_bias": True, "pre_norm": True, "shuffle_orders": True,
             "enable_rpe": False}

    def __init__(self, cfg, device=None, compute_dtype=None, seed: int = 0,
                 group=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if compute_dtype is None:
            compute_dtype = compute_dtype_from_env()
        self.compute_dtype = compute_dtype
        m = cfg["model"]
        bad = {k: m[k] for k, v in self.FIXED.items() if k in m and m[k] != v}
        if bad:
            raise ValueError(f"SegTask: PT-v3m1 fixes {bad}: the network "
                             "runs Pointcept's published values")
        self.model = PointTransformerV3(
            in_channels=int(m.get("in_channels", 4)),
            num_classes=int(m.get("num_classes", 19)),
            drop_path=float(m.get("drop_path", 0.3)),
            enc_channels=tuple(m.get("enc_channels", ENC_CHANNELS)),
            dec_channels=tuple(m.get("dec_channels", DEC_CHANNELS)),
            enc_heads=tuple(m.get("enc_num_head", ENC_HEADS)),
            dec_heads=tuple(m.get("dec_num_head", DEC_HEADS)),
            compute_dtype=compute_dtype)
        init_weights(self.model, torch.Generator().manual_seed(seed))
        set_bn_group(self.model, group)
        self.model.to(self.device).eval()
        self.caps = list(cfg["tpu"]["full_capacities"])
        self.num_levels = len(ENC_DEPTHS)
        self.ignore = int(cfg["data"].get("ignore_index", -1))
        blocks = self.model.blocks()
        lv = [s for s, d in enumerate(ENC_DEPTHS) for _ in range(d)]
        lv += [s for s in reversed(range(len(DEC_DEPTHS)))
               for _ in range(DEC_DEPTHS[s])]
        self.rates = [(l, b.drop_path) for l, b in zip(lv, blocks)]
        # the stem's 125 offsets, on the device once: a copy from the host
        # each step would make the host wait for the card
        self.stem_offsets = grid_ops.cube_offsets(5, 1).to(
            device=self.device, dtype=torch.int32)

    def pyramid(self, batch) -> grid_ops.Pyramid:
        n = batch["grid_coord"].shape[0]
        off = batch["offset"]
        counts = torch.diff(off, prepend=off.new_zeros(1))
        element = torch.repeat_interleave(
            torch.arange(off.shape[0], device=off.device), counts,
            output_size=n)
        return grid_ops.build_pyramid_grid(batch["grid_coord"], element,
                                           batch["feat"], self.caps,
                                           self.num_levels)

    def counts(self, pyr: grid_ops.Pyramid, n_elements: int) -> list:
        """Each level's rows per element and depth: the step's one host
        sync (`serialize.level_counts`)."""
        lv = pyr.levels
        return serialize.level_counts(
            [l.geom.coords[:, 0] for l in lv], [l.geom.mask for l in lv],
            n_elements, lv[0].geom.coords[:, 1:]
            + grid_ops.grid_shift(lv[0].geom.coords.device), lv[0].geom.mask)

    def levels(self, pyr: grid_ops.Pyramid, lcs: list, perms=None):
        """(Level per level, the 125-tap stem map of level 0's rows): each
        level's orders, shuffled by `perms` (one [4] tensor a level; None:
        in order)."""
        # the stem's map first: its search keeps the card busy while the
        # host issues the serialization's small kernels
        g0 = pyr.levels[0].geom
        n0 = lcs[0].total
        with prof.annotate("lidiff.geom.pyramid"):
            rows = grid_ops.VoxelGeom(key=g0.key[:n0], coords=g0.coords[:n0],
                                      mask=g0.mask[:n0], num=g0.num,
                                      num_raw=g0.num_raw, stride=1)
            stem = grid_ops.build_kernel_map(g0, rows, self.stem_offsets)
        out = []
        with prof.annotate("lidiff.ptv3.serialize"):
            for li, (l, lc) in enumerate(zip(pyr.levels, lcs)):
                if li == 0:
                    codes = serialize.level_codes(
                        l.geom.coords[:lc.total], grid_ops.GRID_SHIFT,
                        lc.depth)
                else:
                    fine = pyr.levels[li - 1]
                    codes = serialize.parent_codes(
                        codes, fine.parent_idx[:lcs[li - 1].total].long(),
                        lc.total)
                perm = perms[li] if perms is not None else torch.arange(
                    4, device=codes.device)
                out.append(Level(l, lc.total, serialize.serialize_level(
                    codes, lc, perm)))
        return out, stem

    def _point_logits(self, batch, generator=None, draws=None):
        """(logits of each point [N, classes], whether its voxel was kept
        [N], the pyramid, the draws)."""
        pyr = self.pyramid(batch)
        lcs = self.counts(pyr, batch["offset"].shape[0])
        if self.model.training and draws is None:
            draws = draw(generator, [lc.total for lc in lcs], self.rates,
                         self.device)
        levels, stem = self.levels(pyr, lcs,
                                   None if draws is None else draws["perms"])
        out = self.model(pyr, levels, stem,
                         None if draws is None else draws["masks"])
        n0 = levels[0].n
        p2v = pyr.point2voxel[0].long()
        return (out.index_select(0, p2v.clamp(max=n0 - 1)), p2v < n0, pyr,
                draws)

    def loss_fn(self, batch: dict, generator=None, *, draws=None):
        """Cross-entropy plus Lovász-softmax of the points' logits, both
        over the points whose label is not `ignore_index` (Pointcept's
        loss weights 1 and 1); puts the model in train mode, so the
        BatchNorm running statistics move. The order shuffles and the
        DropPath masks come from `generator` (on the task's device), or
        from `draws` (`draw`'s dict). Returns (loss, metrics), the metrics
        detached."""
        if generator is None and draws is None:
            raise ValueError("pass a torch.Generator, or draws")
        self.model.train()
        logits, kept, pyr, _ = self._point_logits(batch, generator, draws)
        seg = batch["segment"]
        valid = (seg != self.ignore) & kept
        target = torch.where(valid, seg, -100)
        ce = F.cross_entropy(logits, target, ignore_index=-100)
        lov = lovasz_softmax(logits.softmax(1), seg, valid)
        loss = ce + lov
        return loss, {"loss": loss.detach(), "ce": ce.detach(),
                      "lovasz": lov.detach(),
                      "overflow_vox": pyr.overflows().sum().float()}

    @eval_no_grad
    def forward(self, batch: dict) -> torch.Tensor:
        """Per-point logits [N, classes] in eval mode (BatchNorm running
        statistics, no DropPath, the orders unshuffled), without
        autograd."""
        return self._point_logits(batch)[0]
