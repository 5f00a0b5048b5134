"""Plain float32 PyTorch reference of Point Transformer V3 segmentation
training (Wu et al., CVPR 2024, arXiv:2312.10035; Pointcept
`point_transformer_v3m1_base.py`, PT-v3m1, and
`configs/semantic_kitti/semseg-pt-v3m1-0-base.py`): its own voxel hash and
pooling, serialization codes, patch maps, the network, the loss
(cross-entropy + Lovász-softmax) and AdamW under OneCycleLR.

- Levels: level 0 is one row per distinct (element, grid coordinate) with
  the mean of its points' features; level l + 1 groups level l's rows by
  coordinate >> 1 (PTv3's pooling by code >> 3). Rows are in (element, x,
  y, z) order.
- Codes: Morton by bit loops; Hilbert as Pointcept computes it, on bit
  tensors: Skilling's transform over the coordinates' bits from the most
  significant, the bits interleaved (x first), then read as a Gray code.
  The element sits above the 3 d bits; a level's depth d is the bit
  length of level 0's largest grid coordinate, minus the level.
- Patch maps: Pointcept's `get_padding_and_inverse` with patch
  K = min(1024, the level's smallest element), element by element.
- Attention: softmax(q k^T / 4) v over each padded patch, explicitly, in
  blocks of patches; the backward pass recomputes each block, so a step
  at the benchmark's size fits.
- Convs: a sum over taps of the neighbour rows times W[tap] (27 taps, and
  125 for the stem), over the hash's neighbour maps.
- The network takes the weights by the port's parameter names, its
  DropPath masks and order permutations as given (`draws`); BatchNorm in
  train mode over the batch (eps 1e-3).

Inside `nets.lower_precision(dtype)` every product (Linears, convs and
both attention products, forward and backward) takes operands rounded to
`dtype`: the lower-precision control of the check.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from benchmark.reference import nets

ENC_DEPTHS = (2, 2, 2, 6, 2)
DEC_DEPTHS = (2, 2, 2, 2)
ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")
HEAD_DIM = 16
MAX_PATCH = 1024
BN_EPS = 1e-3
LN_EPS = 1e-5


# ---------------------------------------------------------------- geometry

def _key(element, g):
    return (((element.long() << 13) | g[:, 0]) << 13 | g[:, 1]) << 13 \
        | g[:, 2]


@dataclass
class Level:
    grid: torch.Tensor      # [V, 3] int64, this level's grid coordinates
    element: torch.Tensor   # [V] int64
    key: torch.Tensor       # [V] ascending
    parent: torch.Tensor | None = None   # [V] row of the parent level

    @property
    def size(self) -> int:
        return self.key.shape[0]

    def lookup(self, element, g):
        q = _key(element, g)
        ok = (g >= 0).all(1)
        idx = torch.searchsorted(self.key, q).clamp(max=self.size - 1)
        return torch.where(ok & (self.key[idx] == q), idx, -1)

    def neighbours(self, radius: int) -> torch.Tensor:
        """[V, (2r+1)^3] rows at offset o (x slowest), -1 for none."""
        r = range(-radius, radius + 1)
        offs = torch.tensor([(a, b, c) for a in r for b in r for c in r],
                            device=self.grid.device)
        out = torch.empty(self.size, offs.shape[0], dtype=torch.int64,
                          device=self.grid.device)
        for k, o in enumerate(offs):
            out[:, k] = self.lookup(self.element, self.grid + o)
        return out


def _unique_level(element, g):
    key, inv = torch.unique(_key(element, g), sorted=True,
                            return_inverse=True)
    ge = torch.zeros(key.shape[0], 3, dtype=torch.int64, device=g.device)
    el = torch.zeros(key.shape[0], dtype=torch.int64, device=g.device)
    ge[inv], el[inv] = g.long(), element.long()
    return Level(ge, el, key), inv


@dataclass
class Pyramid:
    levels: list        # Level, finest first
    feats: torch.Tensor  # [V0, C] mean features of each level-0 row
    p2v: torch.Tensor   # [N] level-0 row of each point
    counts: list        # rows of each element, per level
    depth: int          # level 0's depth


def pyramid(grid, offset, feats, num_levels: int = 5) -> Pyramid:
    """The levels of points on the grid `grid` [N, 3] (non-negative) whose
    elements end at `offset` [B], with features `feats` [N, C]."""
    n = grid.shape[0]
    ends = offset.tolist()
    element = torch.zeros(n, dtype=torch.int64, device=grid.device)
    for e, (a, b) in enumerate(zip([0] + ends[:-1], ends)):
        element[a:b] = e
    lvl, inv = _unique_level(element, grid.long())
    sums = torch.zeros(lvl.size, feats.shape[1], device=feats.device)
    sums.index_add_(0, inv, feats.float())
    cnt = torch.bincount(inv, minlength=lvl.size).float()
    levels = [lvl]
    for _ in range(num_levels - 1):
        fine = levels[-1]
        coarse, par = _unique_level(fine.element, fine.grid >> 1)
        fine.parent = par
        levels.append(coarse)
    B = len(ends)
    counts = [torch.bincount(l.element, minlength=B).tolist()
              for l in levels]
    depth = max(int(levels[0].grid.max()).bit_length(), 1)
    return Pyramid(levels, sums / cnt[:, None], inv, counts, depth)


# ----------------------------------------------------------- serialization

def z_order(x, y, z, depth: int):
    code = torch.zeros_like(x)
    for i in range(depth):
        code = code | (((x >> i) & 1) << (3 * i + 2)) \
            | (((y >> i) & 1) << (3 * i + 1)) | (((z >> i) & 1) << (3 * i))
    return code


def hilbert(x, y, z, depth: int):
    """Pointcept's Hilbert encoder on bit tensors: bits [V, 3, depth],
    most significant first."""
    locs = torch.stack([x, y, z], 1)
    shifts = torch.arange(depth - 1, -1, -1, device=x.device)
    bits = ((locs[:, :, None] >> shifts) & 1).bool()
    for b in range(depth):
        for d in range(3):
            m = bits[:, d, b][:, None]
            bits[:, 0, b + 1:] ^= m
            flip = ~m & (bits[:, 0, b + 1:] ^ bits[:, d, b + 1:])
            bits[:, d, b + 1:] ^= flip
            bits[:, 0, b + 1:] ^= flip
    gray = bits.transpose(1, 2).reshape(-1, 3 * depth)
    binary = torch.cumsum(gray.long(), 1) % 2        # Gray -> binary
    weights = 1 << torch.arange(3 * depth - 1, -1, -1, device=x.device)
    return (binary * weights).sum(1)


def code(lvl: Level, depth: int, order: str):
    g = lvl.grid
    x, y, z = g[:, 0], g[:, 1], g[:, 2]
    if order.endswith("-trans"):
        x, y = y, x
    fn = z_order if order.startswith("z") else hilbert
    return (lvl.element << (3 * depth)) | fn(x, y, z, depth)


def pad_maps(counts: list, device):
    """(pad [n_pad], unpad [n], K): Pointcept's get_padding_and_inverse
    with K = min(1024, smallest count), element by element."""
    K = min(MAX_PATCH, min(counts))
    pad, unpad = [], []
    start = start_pad = 0
    for c in counts:
        cp = -(-c // K) * K
        p = torch.arange(start_pad, start_pad + cp, device=device)
        if c % K:
            r = c % K
            p[cp - K + r:] = p[cp - 2 * K + r:cp - K]
        pad.append(p - start_pad + start)
        unpad.append(torch.arange(start, start + c, device=device)
                     + start_pad - start)
        start += c
        start_pad += cp
    return torch.cat(pad), torch.cat(unpad), K


@dataclass
class Serial:
    gather: list    # per order slot (shuffled): [n_pad] rows
    scatter: list   # per order slot: [n] padded row of each row
    pad: torch.Tensor
    K: int


def serialize(pyr: Pyramid, perms) -> list:
    """Per level, the four orders in the order `perms[level]` gives."""
    out = []
    for li, lvl in enumerate(pyr.levels):
        pad, unpad, K = pad_maps(pyr.counts[li], lvl.grid.device)
        gather, scatter = [], []
        perm = [int(v) for v in perms[li]]
        for o in perm:
            order = torch.argsort(code(lvl, pyr.depth - li, ORDERS[o]))
            inverse = torch.argsort(order)
            gather.append(order[pad])
            scatter.append(unpad[inverse])
        out.append(Serial(gather, scatter, pad, K))
    return out


# ----------------------------------------------------------------- network

def _mm(a, b):
    return nets._round(a) @ nets._round(b)


class _PatchAttention(torch.autograd.Function):
    """softmax(q k^T * scale) v over [P, H, K, D], `block` patches at a
    time; saves only q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, scale, block):
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.block = scale, block
        out = torch.empty_like(q)
        for s in range(0, q.shape[0], block):
            a = torch.softmax(_mm(q[s:s + block] * scale,
                                  k[s:s + block].transpose(-1, -2)), -1)
            out[s:s + block] = _mm(a, v[s:s + block])
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        sc, block = ctx.scale, ctx.block
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        for s in range(0, q.shape[0], block):
            sl = slice(s, s + block)
            a = torch.softmax(_mm(q[sl] * sc, k[sl].transpose(-1, -2)), -1)
            dv[sl] = _mm(a.transpose(-1, -2), g[sl])
            da = _mm(g[sl], v[sl].transpose(-1, -2))
            ds = a * (da - (da * a).sum(-1, keepdim=True))
            dq[sl] = _mm(ds, k[sl]) * sc
            dk[sl] = _mm(ds.transpose(-1, -2), q[sl]) * sc
        return dq, dk, dv, None, None


def linear(x, W, name):
    y = nets.matmul(x, W[name + ".weight"].T)
    return y + W[name + ".bias"] if name + ".bias" in W else y


def batch_norm(x, W, name, train: bool = True):
    if train:
        mean = x.mean(0)
        var = ((x - mean) ** 2).mean(0)
    else:
        mean, var = W[name + ".mean"], W[name + ".var"]
    return (x - mean) * torch.rsqrt(var + BN_EPS) * W[name + ".scale"] \
        + W[name + ".bias"]


def layer_norm(x, W, name):
    return F.layer_norm(x, (x.shape[1],), W[name + ".weight"],
                        W[name + ".bias"], LN_EPS)


def attention(x, W, name, serial: Serial, slot: int):
    n, C = x.shape
    H = C // HEAD_DIM
    qkv = linear(x, W, name + ".qkv")
    rows = qkv[serial.gather[slot]]
    K = serial.K
    q, k, v = rows.view(-1, K, 3, H, HEAD_DIM).permute(2, 0, 3, 1,
                                                      4).unbind(0)
    out = _PatchAttention.apply(q, k, v, HEAD_DIM ** -0.5,
                                max(1, 256 // H))
    out = out.transpose(1, 2).reshape(-1, C)[serial.scatter[slot]]
    return linear(out, W, name + ".proj")


def block(x, W, name, nbr, serial, slot, masks):
    y = nets.conv27(x, W[name + ".cpe.conv_kernel"], nbr) \
        + W[name + ".cpe.conv_bias"]
    y = layer_norm(linear(y, W, name + ".cpe.linear"), W, name + ".cpe.norm")
    x = x + y
    h = attention(layer_norm(x, W, name + ".norm1"), W, name + ".attn",
                  serial, slot)
    if masks is not None:
        h = h * masks[0][:, None]
    x = x + h
    h = layer_norm(x, W, name + ".norm2")
    h = linear(F.gelu(linear(h, W, name + ".mlp.fc1")), W, name + ".mlp.fc2")
    if masks is not None:
        h = h * masks[1][:, None]
    return x + h


def drop_rates(total: float = 0.3):
    enc = torch.linspace(0, total, sum(ENC_DEPTHS)).tolist()
    dec = torch.linspace(0, total, sum(DEC_DEPTHS)).tolist()
    rates = [(s, enc[sum(ENC_DEPTHS[:s]) + i])
             for s in range(5) for i in range(ENC_DEPTHS[s])]
    for s in reversed(range(4)):
        part = dec[sum(DEC_DEPTHS[:s]):sum(DEC_DEPTHS[:s + 1])][::-1]
        rates += [(s, r) for r in part]
    return rates


def forward(W, pyr: Pyramid, serials: list, masks: list | None,
            drop_path: float = 0.3, train: bool = True):
    """Logits of every level-0 row; `masks`: DropPath masks of the blocks
    with a rate, in the forward's order (None: no DropPath); `train`:
    BatchNorm over the batch, else by its running statistics."""
    L = pyr.levels
    nbrs = [l.neighbours(1) for l in L]
    todo = iter(masks) if masks is not None else None
    rates = iter(drop_rates(drop_path))

    def stage(x, prefix, depth, lvl):
        for i in range(depth):
            _, rate = next(rates)
            m = next(todo) if todo is not None and rate > 0 else None
            x = block(x, W, f"{prefix}.block{i}", nbrs[lvl], serials[lvl],
                      i % 4, m)
        return x

    x = nets.conv27(pyr.feats, W["embedding.conv_kernel"], L[0].neighbours(2))
    x = F.gelu(batch_norm(x, W, "embedding.norm", train))
    skips = []
    for s in range(5):
        if s > 0:
            y = linear(x, W, f"enc.enc{s}.down.proj")
            idx = L[s - 1].parent[:, None].expand(-1, y.shape[1])
            y = y.new_zeros(L[s].size, y.shape[1]).scatter_reduce(
                0, idx, y, "amax", include_self=False)
            x = F.gelu(batch_norm(y, W, f"enc.enc{s}.down.norm", train))
        x = stage(x, f"enc.enc{s}", ENC_DEPTHS[s], s)
        skips.append(x)
    for s in reversed(range(4)):
        p = f"dec.dec{s}.up"
        c = F.gelu(batch_norm(linear(x, W, p + ".proj"), W,
                              p + ".proj_norm", train))
        k = F.gelu(batch_norm(linear(skips[s], W, p + ".skip"), W,
                              p + ".skip_norm", train))
        x = stage(k + c[L[s].parent], f"dec.dec{s}", DEC_DEPTHS[s], s)
    return linear(x, W, "seg_head")


# -------------------------------------------------------------------- loss

def lovasz(probs, labels):
    """Lovász-softmax over the classes present in `labels` (Berman et al.
    2018, as Pointcept's LovaszLoss in multiclass mode)."""
    losses = []
    for c in torch.unique(labels).tolist():
        fg = (labels == c).float()
        err = (fg - probs[:, c]).abs()
        err_s, perm = torch.sort(err, descending=True)
        fg_s = fg[perm]
        gts = fg_s.sum()
        inter = gts - fg_s.cumsum(0)
        union = gts + (1.0 - fg_s).cumsum(0)
        jac = 1.0 - inter / union
        jac = torch.cat([jac[:1], jac[1:] - jac[:-1]])
        losses.append(torch.dot(err_s, jac))
    return torch.stack(losses).mean()


def loss(logits, segment, ignore: int = -1):
    keep = segment != ignore
    lg, sg = logits[keep], segment[keep]
    return F.cross_entropy(lg, sg) + lovasz(torch.softmax(lg, 1), sg)


# --------------------------------------------------------------- optimizer

class OneCycle:
    """torch's OneCycleLR (cos, cycle_momentum on Adam's beta1 between
    0.85 and 0.95) as formulas: (lr of each group, beta1) at step k."""

    def __init__(self, max_lr, total, pct, div, final_div):
        self.max_lr, self.total = list(max_lr), total
        self.up = pct * total - 1
        self.div, self.final_div = div, final_div

    @staticmethod
    def _cos(a, b, pct):
        return b + (a - b) / 2.0 * (math.cos(math.pi * pct) + 1)

    def at(self, k: int):
        if k <= self.up:
            pct = k / self.up
            lrs = [self._cos(m / self.div, m, pct) for m in self.max_lr]
            return lrs, self._cos(0.95, 0.85, pct)
        pct = (k - self.up) / (self.total - 1 - self.up)
        lrs = [self._cos(m, m / self.div / self.final_div, pct)
               for m in self.max_lr]
        return lrs, self._cos(0.85, 0.95, pct)


class AdamW:
    """AdamW (Loshchilov and Hutter 2019) as torch computes it: decoupled
    decay p *= 1 - lr * wd, then Adam with bias correction and eps added
    to the corrected root; beta1 and each leaf's lr given every step."""

    def __init__(self, wd: float, b2: float = 0.999, eps: float = 1e-8):
        self.wd, self.b2, self.eps = wd, b2, eps
        self.m, self.v, self.t = {}, {}, 0
        self.c1 = 1.0

    def step(self, params: dict, grads: dict, lrs: dict, b1: float):
        self.t += 1
        c2 = 1 - self.b2 ** self.t
        with torch.no_grad():
            for k, g in grads.items():
                lr = lrs[k]
                params[k].mul_(1 - lr * self.wd)
                m = self.m.get(k, torch.zeros_like(g))
                v = self.v.get(k, torch.zeros_like(g))
                self.m[k] = m = b1 * m + (1 - b1) * g
                self.v[k] = v = self.b2 * v + (1 - self.b2) * g * g
                c1 = 1 - b1 ** self.t
                params[k] -= lr * (m / c1) / ((v / c2).sqrt() + self.eps)


# ------------------------------------------------------------------ weights

def shapes(in_channels=4, num_classes=19, enc=(32, 64, 128, 256, 512),
           dec=(64, 64, 128, 256)) -> dict:
    """{name: shape} of every parameter and BatchNorm statistic, by the
    port's names."""
    out: dict = {}

    def bn(name, c):
        for s in ("scale", "bias", "mean", "var"):
            out[f"{name}.{s}"] = (c,)

    def lin(name, cin, cout):
        out[name + ".weight"] = (cout, cin)
        out[name + ".bias"] = (cout,)

    def ln(name, c):
        out[name + ".weight"] = (c,)
        out[name + ".bias"] = (c,)

    def blk(p, c):
        out[p + ".cpe.conv_kernel"] = (27, c, c)
        out[p + ".cpe.conv_bias"] = (c,)
        lin(p + ".cpe.linear", c, c)
        ln(p + ".cpe.norm", c)
        ln(p + ".norm1", c)
        lin(p + ".attn.qkv", c, 3 * c)
        lin(p + ".attn.proj", c, c)
        ln(p + ".norm2", c)
        lin(p + ".mlp.fc1", c, 4 * c)
        lin(p + ".mlp.fc2", 4 * c, c)

    out["embedding.conv_kernel"] = (125, in_channels, enc[0])
    bn("embedding.norm", enc[0])
    for s in range(5):
        if s > 0:
            lin(f"enc.enc{s}.down.proj", enc[s - 1], enc[s])
            bn(f"enc.enc{s}.down.norm", enc[s])
        for i in range(ENC_DEPTHS[s]):
            blk(f"enc.enc{s}.block{i}", enc[s])
    up_in = list(dec) + [enc[-1]]
    for s in reversed(range(4)):
        p = f"dec.dec{s}"
        lin(p + ".up.proj", up_in[s + 1], dec[s])
        bn(p + ".up.proj_norm", dec[s])
        lin(p + ".up.skip", enc[s], dec[s])
        bn(p + ".up.skip_norm", dec[s])
        for i in range(DEC_DEPTHS[s]):
            blk(f"{p}.block{i}", dec[s])
    lin("seg_head", dec[0], num_classes)
    return out


def make_weights(shp: dict, gen: torch.Generator, device) -> dict:
    """Seeded weights, in one uniform and one normal draw: Linears
    trunc-normal(0.02) (cut at 2 sigma) with zero bias, conv kernels
    He-uniform over taps x Cin with zero bias, LayerNorm and BatchNorm at
    identity."""
    names = list(shp)
    conv = [n for n in names if n.endswith("conv_kernel")]
    lin = [n for n in names if n.endswith(".weight") and len(shp[n]) == 2]
    n_u = sum(math.prod(shp[n]) for n in conv)
    n_g = sum(math.prod(shp[n]) for n in lin)
    u = torch.rand(n_u, generator=gen, device=device)
    g = torch.randn(n_g, generator=gen, device=device)
    out, iu, ig = {}, 0, 0
    for n in names:
        s, m = shp[n], math.prod(shp[n])
        if n in conv:
            b = math.sqrt(6.0 / (s[0] * s[1]))
            out[n] = (u[iu:iu + m] * (2 * b) - b).reshape(s)
            iu += m
        elif n in lin:
            out[n] = (g[ig:ig + m] * 0.02).clamp(-0.04, 0.04).reshape(s)
            ig += m
        elif n.endswith((".scale", ".var")) or (
                n.endswith(".weight") and len(s) == 1):
            out[n] = torch.ones(s, device=device)
        else:
            out[n] = torch.zeros(s, device=device)
    return out


def is_block(name: str) -> bool:
    """The optimizer's lower-lr group: parameters of the blocks."""
    return "block" in name


def train_steps(W0: dict, batches: list, draws: list, opt: dict,
                sched: dict, total_steps: int, ignore: int = -1,
                drop_path: float = 0.3, lowp=None):
    """Steps of AdamW under OneCycle from the weights W0 on `batches`
    (dicts of 'grid_coord', 'offset', 'feat', 'segment') with each step's
    `draws` ({'perms', 'masks'}): (losses, gradient norms of the first
    step by leaf, the parameters' change norms by leaf)."""
    W = {k: v.clone() for k, v in W0.items()}
    leaves = {k: v for k, v in W.items()
              if not k.endswith((".mean", ".var"))}
    start = {k: v.clone() for k, v in leaves.items()}
    base = float(opt["lr"])
    kw = {g["keyword"]: float(g["lr"]) for g in opt.get("param_groups", [])}
    cyc = OneCycle(sched["max_lr"], total_steps, float(sched["pct_start"]),
                   float(sched["div_factor"]),
                   float(sched["final_div_factor"]))
    adamw = AdamW(float(opt["weight_decay"]))
    losses, first = [], None
    for step, (b, d) in enumerate(zip(batches, draws)):
        pyr = pyramid(b["grid_coord"], b["offset"], b["feat"])
        serials = serialize(pyr, d["perms"])
        for v in leaves.values():
            v.requires_grad_(True)
        with torch.enable_grad():
            ctx = nets.lower_precision(lowp) if lowp else _null()
            with ctx:
                logits = forward(W, pyr, serials, d["masks"], drop_path)
                lv = loss(logits[pyr.p2v], b["segment"], ignore)
                grads = torch.autograd.grad(lv, list(leaves.values()))
        for v in leaves.values():
            v.requires_grad_(False)
        grads = dict(zip(leaves, grads))
        losses.append(float(lv.detach()))
        if first is None:
            first = {k: float(g.norm()) for k, g in grads.items()}
        lrs_g, b1 = cyc.at(step)
        scale = {None: lrs_g[0]}
        for i, key in enumerate(kw):
            scale[key] = lrs_g[1 + i]
        lrs = {k: scale[next((key for key in kw if key in k), None)]
               for k in leaves}
        adamw.step(leaves, grads, lrs, b1)
        del logits, lv, grads, serials, pyr
    change = {k: float((leaves[k] - start[k]).norm()) for k in leaves}
    return losses, first, change


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False
