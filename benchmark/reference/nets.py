"""Plain float32 PyTorch forward passes of LiDiff's three networks, over a
`voxel.Pyramid` and a dict of weights named as the published model's
parameter tree (`partial_enc.Stem_0.ConvBNReLU_0.SparseConv_0.kernel`, ...).

- `MinkGlobalEnc` (the partial-scan encoder), `MinkUNetDiff` (the
  conditional denoiser, one conditioning bank a call) and `MinkUNet` (the
  refiner), after PRBonn/LiDiff `lidiff/models/minkunet.py`.
- A 27-tap conv sums, over the taps that hit, the neighbour's features
  times W[tap]; the ks=2 stride-2 down conv adds each child's features
  times W[its tap] into its parent; the transpose conv gives each child its
  parent's features times W[its tap]. BatchNorm is eval (running
  statistics) or train (the batch's mean and biased variance) by `train`.
- The conditioning gates match each voxel to the nearest voxel of the
  encoder's coarsest level (squared distance of integer coordinates, ties
  to the lowest row) and scale the features by an MLP of that voxel's
  features and the timestep embedding.

Departures from the published code: none in the mathematics. The two
streams of classifier-free guidance run as two calls here.

`lower_precision(dtype)` computes every product of the networks (forward
and backward) from operands rounded to `dtype` with one float32 scale per
tensor: the lower-precision control of a correctness check.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F

from benchmark.reference.voxel import Pyramid

CS = (32, 32, 64, 128, 256, 256, 128, 96, 96)
EPS = 1e-5
_LOWP = contextvars.ContextVar("reference_lower_precision", default=None)


@contextlib.contextmanager
def lower_precision(dtype):
    token = _LOWP.set(dtype)
    try:
        yield
    finally:
        _LOWP.reset(token)


def _round(x):
    dtype = _LOWP.get()
    if dtype is None or x.numel() == 0:
        return x
    top = torch.finfo(dtype).max
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).float() * scale


def _mm(a, b):
    return _round(a) @ _round(b)


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        return _mm(g, b.T), _mm(a.T, g)


def matmul(a, b):
    """a @ b, in the control's precision inside `lower_precision`."""
    if _LOWP.get() is None:
        return a @ b
    return _Matmul.apply(a.reshape(-1, a.shape[-1]), b).reshape(
        *a.shape[:-1], b.shape[-1])


def channels(cr: float = 1.0) -> list[int]:
    return [int(cr * c) for c in CS]


class _Conv27(torch.autograd.Function):
    """sum_k x[nbr[:, k]] @ w[k] (0 where nbr is -1); saves only its
    inputs, so a training step fits."""

    @staticmethod
    def forward(ctx, x, w, nbr):
        ctx.save_for_backward(x, w, nbr)
        out = x.new_zeros(nbr.shape[0], w.shape[2])
        for k in range(w.shape[0]):
            idx = nbr[:, k]
            hit = idx >= 0
            out += _mm(x[idx.clamp(min=0)] * hit[:, None], w[k])
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, nbr = ctx.saved_tensors
        dx = torch.zeros_like(x)
        dw = torch.zeros_like(w)
        for k in range(w.shape[0]):
            idx = nbr[:, k]
            rows = torch.nonzero(idx >= 0).squeeze(1)
            src = idx[rows]
            gk = g[rows]
            dw[k] = _mm(x[src].T, gk)
            dx.index_add_(0, src, _mm(gk, w[k].T))
        return dx, dw, None


def conv27(x, w, nbr):
    return _Conv27.apply(x, w, nbr)


def down_conv(x, w, parent, tap, n_out: int):
    y = matmul(x, w.permute(1, 0, 2).reshape(w.shape[1], -1)).reshape(
        x.shape[0], 8, w.shape[2])
    sel = y[torch.arange(x.shape[0], device=x.device), tap]
    return torch.zeros(n_out, w.shape[2], dtype=x.dtype,
                       device=x.device).index_add(0, parent, sel)


def up_conv(x, w, parent, tap):
    y = matmul(x, w.permute(1, 0, 2).reshape(w.shape[1], -1)).reshape(
        x.shape[0], 8, w.shape[2])
    return y[parent, tap]


def batch_norm(x, W, name: str, train: bool):
    if train:
        mean = x.mean(0)
        var = ((x - mean) ** 2).mean(0)
    else:
        mean, var = W[name + ".mean"], W[name + ".var"]
    return (x - mean) * torch.rsqrt(var + EPS) * W[name + ".scale"] \
        + W[name + ".bias"]


def mlp(x, W, name: str):
    x = matmul(x, W[name + ".Dense_0.weight"].T) + W[name + ".Dense_0.bias"]
    x = F.leaky_relu(x, 0.1)
    return matmul(x, W[name + ".Dense_1.weight"].T) \
        + W[name + ".Dense_1.bias"]


def conv_bn_relu(x, W, name, nbr, train):
    x = conv27(x, W[name + ".SparseConv_0.kernel"], nbr)
    return F.relu(batch_norm(x, W, name + ".MaskedBatchNorm_0", train))


def residual(x, W, name, nbr, train):
    y = conv27(x, W[name + ".SparseConv_0.kernel"], nbr)
    y = F.relu(batch_norm(y, W, name + ".MaskedBatchNorm_0", train))
    y = conv27(y, W[name + ".SparseConv_1.kernel"], nbr)
    y = batch_norm(y, W, name + ".MaskedBatchNorm_1", train)
    if name + ".Dense_0.weight" in W:
        s = batch_norm(matmul(x, W[name + ".Dense_0.weight"].T), W,
                       name + ".MaskedBatchNorm_2", train)
    else:
        s = x
    return F.relu(y + s)


def stem(x, W, name, pyr: Pyramid, train):
    x = conv_bn_relu(x, W, name + ".ConvBNReLU_0", pyr.nbrs[0], train)
    return conv_bn_relu(x, W, name + ".ConvBNReLU_1", pyr.nbrs[0], train)


def down_stage(x, W, name, pyr: Pyramid, fine: int, train):
    """Level `fine` -> fine + 1."""
    k = W[name + ".ConvBNReLU_0.SparseConv_0.kernel"]
    x = down_conv(x, k, pyr.parents[fine], pyr.taps[fine],
                  pyr.levels[fine + 1].size)
    x = F.relu(batch_norm(x, W, name + ".ConvBNReLU_0.MaskedBatchNorm_0",
                          train))
    nbr = pyr.nbrs[fine + 1]
    x = residual(x, W, name + ".ResidualBlock_0", nbr, train)
    return residual(x, W, name + ".ResidualBlock_1", nbr, train)


def up_stage(x, skip, W, name, pyr: Pyramid, fine: int, train):
    """Level fine + 1 -> `fine`, concatenated with the skip."""
    k = W[name + ".DeconvBNReLU_0.SparseConvTranspose_0.kernel"]
    y = up_conv(x, k, pyr.parents[fine], pyr.taps[fine])
    y = F.relu(batch_norm(y, W, name + ".DeconvBNReLU_0.MaskedBatchNorm_0",
                          train))
    y = torch.cat([y, skip], 1)
    nbr = pyr.nbrs[fine]
    y = residual(y, W, name + ".ResidualBlock_0", nbr, train)
    return residual(y, W, name + ".ResidualBlock_1", nbr, train)


def encoder(W, pyr: Pyramid, prefix: str = "partial_enc."):
    """MinkGlobalEnc in eval mode: the coarsest level's features."""
    x = stem(pyr.feats, W, prefix + "Stem_0", pyr, False)
    for i in range(4):
        x = down_stage(x, W, f"{prefix}DownStage_{i}", pyr, i, False)
    return x


def timestep_embedding(t: int, dim: int, device) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(math.log(10000.0) / (half - 1)
                      * -torch.arange(half, dtype=torch.float64,
                                      device=device))
    args = float(t) * freqs
    return torch.cat([torch.sin(args), torch.cos(args)]).float()[None]


def nearest(q_coords, bank_coords, block: int = 2048) -> torch.Tensor:
    """Row of the nearest bank voxel of the same batch item for each query
    (squared distance of the integer coordinates, ties to the lowest
    row)."""
    out = torch.empty(q_coords.shape[0], dtype=torch.int64,
                      device=q_coords.device)
    r = bank_coords.double()
    for s in range(0, q_coords.shape[0], block):
        q = q_coords[s:s + block].double()
        d = ((q[:, None, 1:] - r[None, :, 1:]) ** 2).sum(2)
        d = torch.where(q[:, None, 0] == r[None, :, 0], d, math.inf)
        out[s:s + block] = torch.argmin(d, dim=1)
    return out


def gate(x, W, name, lvl, match, temb, swap: bool = False):
    """x times the gate of its voxels; `match` is the bank's features at
    each voxel's nearest bank voxel."""
    p = mlp(match, W, name + ".latent")
    t_vox = mlp(temb, W, name + ".temp")[lvl.coords[:, 0]]
    w = mlp(torch.cat([t_vox, p] if swap else [p, t_vox], 1), W,
            name + ".latemp")
    return x * w


def denoiser(W, pyr: Pyramid, bank, t: int, out_dim: int = 96,
             prefix: str = "denoiser."):
    """MinkUNetDiff in eval mode against one bank (coords [Vb, 4], feats
    [Vb, c4]): the noise prediction of every point, [B, N, 3]."""
    P = prefix
    L = pyr.levels
    bank_coords, bank_feats = bank
    match = [bank_feats[nearest(l.coords, bank_coords)] for l in L]
    temb = timestep_embedding(t, out_dim, pyr.feats.device)
    x0 = stem(pyr.feats, W, P + "Stem_0", pyr, False)
    xs, x = [x0], x0
    for i, g in enumerate(("gate_s1", "gate_s2", "gate_s3", "gate_s4")):
        x = gate(x, W, P + g, L[i], match[i], temb)
        x = down_stage(x, W, f"{P}DownStage_{i}", pyr, i, False)
        xs.append(x)
    y = xs[4]
    for i, g in enumerate(("gate_u1", "gate_u2", "gate_u3", "gate_u4")):
        y = gate(y, W, P + g, L[4 - i], match[4 - i], temb, swap=(i == 0))
        y = up_stage(y, xs[3 - i], W, f"{P}UpStage_{i}", pyr, 3 - i, False)
    return mlp(y[pyr.p2v], W, P + "head")


def refiner(W, pyr: Pyramid, train: bool = False, prefix: str = ""):
    """MinkUNet of the refiner: tanh of the head, [B, N, out]."""
    P = prefix
    x0 = stem(pyr.feats, W, P + "Stem_0", pyr, train)
    xs, x = [x0], x0
    for i in range(4):
        x = down_stage(x, W, f"{P}DownStage_{i}", pyr, i, train)
        xs.append(x)
    y = xs[4]
    for i in range(4):
        y = up_stage(y, xs[3 - i], W, f"{P}UpStage_{i}", pyr, 3 - i, train)
    return torch.tanh(mlp(y[pyr.p2v], W, P + "head"))
