"""Training-mode masked BatchNorm with its epilogue (`ops/batchnorm.py`),
float32 on the CPU, where `masked_bn_train` takes the plain path.

  * `masked_bn_backward_plain`, the closed form that the card's kernels
    compute, against autograd of the eager forward for each epilogue (none,
    ReLU, residual + ReLU), with no, some and all rows valid, and on a
    channel where the variance clamp is active (the last term dropped)
    and one whose variance is exactly 0: within 1e-5 of the largest
    gradient, since both sum the same float32 values in other orders;
  * `MaskedBatchNorm` with each epilogue against the flax module followed
    by the same epilogue in JAX: output, the gradients of x, scale, bias
    and the residual, and the running statistics, at the tolerances of
    tests/test_torch_conv_grad.py's `test_masked_batchnorm_train_mode`;
  * eval mode bit for bit as the normalization was written before;
  * `ResidualBlock` in train mode against the eager composition, and the
    calls: CPU calls count as `plain`, and a refiner step with remat makes
    one for each BatchNorm site of the forward and one more for each site
    inside a stage (the recompute), launching no kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lidiff_tpu.models import blocks as jblocks
from lidiff_tpu_torch.config import finalize_config
from lidiff_tpu_torch.models import blocks as tblocks
from lidiff_tpu_torch.models.refine import RefineTask
from lidiff_tpu_torch.ops import batchnorm as bn
from lidiff_tpu_torch.ops import sparse_conv as tsc

EPILOGUES = {"none": (False, False), "relu": (True, False),
             "residual_relu": (True, True)}
GRAD_TOL = 1e-5     # x the largest |gradient|: float32 sums in other orders


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, V, C, n_valid):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(V, C, generator=g) * 2.0 + 0.5
    mask = torch.zeros(V, dtype=torch.bool)
    mask[torch.randperm(V, generator=g)[:n_valid]] = True
    scale = 1.0 + 0.1 * torch.randn(C, generator=g)
    bias = 0.1 * torch.randn(C, generator=g)
    res = torch.randn(V, C, generator=g)
    cot = torch.randn(V, C, generator=g)
    return x, mask, scale, bias, res, cot


def _clamp_channels(x, mask):
    """Channel 0: seven valid rows, four of 1 + 2^-11 and three of 1. Their
    sums are exact in float32 in any order, and the one-pass variance
    s2 / 7 - mean^2 rounds to -2^-23: the clamp is active. Channel 1: the
    constant 1.5, whose variance is exactly 0 (the clamp passes)."""
    rows = torch.nonzero(mask).flatten()
    assert rows.numel() == 7
    x[:, 0] = 1.0
    x[rows[:4], 0] = 1.0 + 2.0 ** -11
    x[:, 1] = 1.5
    return x


def _check_closed_form(x, mask, scale, bias, res, cot, relu, residual, eps):
    xt = x.clone().requires_grad_()
    st, bt = scale.clone().requires_grad_(), bias.clone().requires_grad_()
    rt = res.clone().requires_grad_() if residual else None
    out, _, _, _ = bn.masked_bn_train(xt, mask, st, bt, eps, relu=relu,
                                      residual=rt)
    out.backward(cot)
    mean, var, rstd, vok, cnt = bn.moments_plain(x, mask, eps)
    dx, dscale, dbias, dres = bn.masked_bn_backward_plain(
        cot, x, mask, out.detach(), mean, rstd, vok, cnt, scale, relu,
        residual)
    top = max(float(t.abs().max()) for t in (xt.grad, st.grad, bt.grad))
    for got, want in ((dx, xt.grad), (dscale, st.grad), (dbias, bt.grad)):
        torch.testing.assert_close(got, want, rtol=0, atol=GRAD_TOL * top)
    assert torch.equal(dx[~mask], torch.zeros_like(dx[~mask]))
    if residual:
        assert torch.equal(dres, rt.grad)
    else:
        assert dres is None
    return vok, var


@pytest.mark.parametrize("n_valid", [0, 23, 60])
@pytest.mark.parametrize("epilogue", list(EPILOGUES))
def test_closed_form_backward_matches_autograd(epilogue, n_valid):
    relu, residual = EPILOGUES[epilogue]
    x, mask, scale, bias, res, cot = _inputs(n_valid, 60, 5, n_valid)
    _check_closed_form(x, mask, scale, bias, res, cot, relu, residual, 1e-5)


@pytest.mark.parametrize("epilogue", list(EPILOGUES))
def test_closed_form_backward_variance_clamp(epilogue):
    relu, residual = EPILOGUES[epilogue]
    x, mask, scale, bias, res, cot = _inputs(7, 20, 4, 7)
    x = _clamp_channels(x, mask)
    vok, var = _check_closed_form(x, mask, scale, bias, res, cot, relu,
                                  residual, 1e-3)
    assert vok.tolist()[:2] == [0.0, 1.0]
    assert var.tolist()[:2] == [0.0, 0.0]


def test_cpu_calls_count_plain():
    x, mask, scale, bias, res, _ = _inputs(1, 30, 3, 12)
    kernels = (bn._stats_kernel, bn._moments_kernel, bn._apply_kernel,
               bn._grad_kernel, bn._dx_kernel)
    before = dict(bn.counters), [k.launches for k in kernels]
    out, mean, var, cnt = bn.masked_bn_train(x, mask, scale, bias, 1e-5,
                                             relu=True, residual=res)
    assert bn.counters == {"fused": before[0]["fused"],
                           "plain": before[0]["plain"] + 1}
    assert [k.launches for k in kernels] == before[1]
    assert float(cnt) == 12.0
    ref_mean, ref_var, _ = tsc.masked_moments(x, mask)
    assert torch.equal(mean, ref_mean) and torch.equal(var, ref_var)
    want = F.relu(bn.normalize_plain(x, mask, mean, var, scale, bias, 1e-5)
                  + res)
    assert torch.equal(out, want)
    with pytest.raises(ValueError):
        bn.masked_bn_train(x, mask, scale, bias, 1e-5, residual=res[:, :2])


@pytest.mark.parametrize("epilogue", list(EPILOGUES))
def test_masked_batchnorm_epilogue_matches_jax(epilogue):
    """Two train-mode calls of `MaskedBatchNorm(..., relu=, residual=)`
    against the flax module with the epilogue written out in JAX."""
    relu, residual = EPILOGUES[epilogue]
    rng = np.random.default_rng(4)
    C = 12
    scale = (1.0 + 0.1 * rng.normal(size=C)).astype(np.float32)
    bias = (0.1 * rng.normal(size=C)).astype(np.float32)
    jbn = jblocks.MaskedBatchNorm()
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = {"mean": jnp.zeros(C), "var": jnp.ones(C)}
    tbn = tblocks.MaskedBatchNorm(C)
    with torch.no_grad():
        tbn.scale.copy_(torch.from_numpy(scale))
        tbn.bias.copy_(torch.from_numpy(bias))
    tbn.train()
    for call in range(2):
        V = 300
        x = rng.normal(0.5, 2.0, (V, C)).astype(np.float32)
        mask = np.arange(V) < 190 + 40 * call
        x[~mask] = 0.0
        res = rng.normal(size=(V, C)).astype(np.float32)
        cot = rng.normal(size=(V, C)).astype(np.float32)

        def loss(p, xx, rr):
            y, mut = jbn.apply({"params": p, "batch_stats": stats}, xx,
                               jnp.asarray(mask), True,
                               mutable=["batch_stats"])
            if residual:
                y = y + rr
            if relu:
                y = jax.nn.relu(y)
            return jnp.sum(y * cot), (y, mut["batch_stats"])

        (_, (jy, stats)), (jgp, jgx, jgr) = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(
                params, jnp.asarray(x), jnp.asarray(res))
        tx = torch.from_numpy(x).requires_grad_(True)
        tr = torch.from_numpy(res).requires_grad_(True) if residual \
            else None
        ty = tbn(tx, torch.from_numpy(mask), 1, relu=relu, residual=tr)
        tbn.zero_grad()
        ty.backward(torch.from_numpy(cot))
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=0,
                                   atol=1e-4)
        if residual:
            np.testing.assert_allclose(tr.grad.numpy(), np.asarray(jgr),
                                       rtol=0, atol=1e-6)
        for name, t in (("scale", tbn.scale), ("bias", tbn.bias)):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgp[name]),
                                       rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(tbn.mean.numpy(), np.asarray(stats["mean"]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(tbn.var.numpy(), np.asarray(stats["var"]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_batchnorm_eval_unchanged(dtype):
    """Eval mode (G = 2, the running statistics) gives the bits of the
    normalization as written before the epilogue was added to it."""
    g = torch.Generator().manual_seed(5)
    C = 6
    m = tblocks.MaskedBatchNorm(C)
    with torch.no_grad():
        for t in (m.scale, m.bias, m.mean):
            t.copy_(0.3 * torch.randn(C, generator=g) + 1.0)
        m.var.copy_(torch.rand(C, generator=g) + 0.5)
    m.eval()
    x = torch.randn(50, 2 * C, generator=g).to(dtype)
    mask = torch.rand(50, generator=g) < 0.7
    mean, var = m.mean.repeat(2), m.var.repeat(2)
    scale, bias = m.scale.repeat(2), m.bias.repeat(2)
    if dtype == torch.float32:
        y = (x - mean) * torch.rsqrt(var + m.eps) * scale + bias
    else:
        k = scale * torch.rsqrt(var + m.eps)
        c = bias - mean * k
        y = x * k.to(x.dtype) + c.to(x.dtype)
    want = torch.where(mask[:, None], y, 0.0)
    assert torch.equal(m(x, mask, 2), want)
    assert torch.equal(m(x, mask, 2, relu=True), F.relu(want))


@pytest.mark.parametrize("cin", [6, 8])
def test_residual_block_train_epilogue(cin):
    """`ResidualBlock` in train mode (the ReLUs and the shortcut's add in
    the BatchNorms' epilogues) against the eager composition."""
    from lidiff_tpu_torch.ops import grid
    rng = np.random.default_rng(cin)
    pts = torch.from_numpy(rng.normal(0, 2.0, (1, 300, 3)).astype(np.float32))
    lvl = grid.build_pyramid(pts, 0.5, [512], 1).levels[0]
    mask = lvl.geom.mask
    blk = tblocks.ResidualBlock(cin, 8)
    tblocks.init_weights(blk, torch.Generator().manual_seed(cin))
    blk.train()
    feats = torch.randn(512, cin, generator=torch.Generator().manual_seed(1))
    out = blk(feats, lvl.kmap3, mask, 1)

    def bnorm(m, x):
        mean, var, _ = tsc.masked_moments(x, mask)
        return bn.normalize_plain(x, mask, mean, var, m.scale, m.bias, m.eps)
    x = blk.SparseConv_0(feats, lvl.kmap3, mask, 1)
    x = F.relu(bnorm(blk.MaskedBatchNorm_0, x))
    x = blk.SparseConv_1(x, lvl.kmap3, mask, 1)
    short = feats if cin == 8 else bnorm(
        blk.MaskedBatchNorm_2, F.linear(feats, blk.Dense_0.weight))
    assert torch.equal(out, F.relu(bnorm(blk.MaskedBatchNorm_1, x) + short))


def test_refiner_step_bn_calls():
    """One loss and backward pass of a small refiner with remat: every
    BatchNorm site of the forward once, those inside a stage once more in
    the recompute, all on the plain path (CPU), as many as on the card's
    fused path (49 and 47 at the published widths)."""
    cfg = finalize_config({
        "experiment": {"id": "torch-bn-calls"},
        "data": {"data_dir": "", "resolution": 0.25, "num_points": 96},
        "train": {"up_factor": 2, "lr": 1e-3, "n_gpus": 1, "batch_size": 1},
        "model": {"out_dim": 96, "cr": 0.25},
        "tpu": {"full_capacities": [256] * 3 + [128, 96]}})
    task = RefineTask(cfg, device="cpu", seed=3, remat=True)
    sites = [m for m in task.model.modules()
             if isinstance(m, tblocks.MaskedBatchNorm)]
    staged = {id(m) for st in task.model.modules()
              if isinstance(st, (tblocks.DownStage, tblocks.UpStage))
              for m in st.modules() if isinstance(m, tblocks.MaskedBatchNorm)}
    assert (len(sites), len(staged)) == (49, 47)
    rng = np.random.default_rng(0)
    pts = rng.normal(0, 3.0, (1, 96, 3)).astype(np.float32)
    batch = {"pcd_noise": torch.from_numpy(pts),
             "pcd_full": torch.from_numpy(np.concatenate([pts, pts], 1))}
    before = dict(bn.counters)
    loss, _ = task.loss_fn(batch)
    loss.backward()
    assert bn.counters["plain"] - before["plain"] == 49 + 47
    assert bn.counters["fused"] == before["fused"]
