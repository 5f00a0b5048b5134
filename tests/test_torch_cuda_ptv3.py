"""Point Transformer V3 on the card. These skip without a CUDA device; run
them on a machine with one:

    python -m pytest tests/test_torch_cuda_ptv3.py -q -m cuda

- The column conv with a bias at xCPE's widest pairs (512, 512) and
  (256, 256): kernel A1 forward, A2 (the feats gradient) and A3 (the
  weight gradient) through `Conv3ColumnsFunction`, against the plain
  versions on the same bf16 operands; tolerances as tests/test_torch_cuda.py
  (A1 and A2 one bf16 ulp plus 1e-4 of max|ref|, A3 5e-4 of max|ref|),
  the bias gradient (the masked cotangent's column sums, float32) to 1e-5.
- Kernel `serial_codes` (level 0's four codes in one launch) against the
  bit loops of `ops/serialize.py`, bit for bit.
- One training step of a small PTv3 (published heads of 16, cut widths)
  with attention on SDPA's flash backend alone, against the same step on
  the CPU in float32: the loss within 2e-2 relative (bf16 products).
- The eval forward on the card against the CPU's float32 forward: the
  logits within 5e-2 in norm (bf16 rounds each product's operands at
  about 4e-3; some forty roundings on the way through 22 blocks, with no
  batch statistics to renormalize in eval).
"""

import pytest
import torch

from lidiff_tpu_torch.ops import grid as G
from lidiff_tpu_torch.ops import serialize as SZ
from lidiff_tpu_torch.ops import sparse_conv as sc
from ptv3_helpers import batch, task

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _level(dev, n=3000, seed=0):
    g = torch.Generator().manual_seed(seed)
    grid = torch.randint(0, 24, (n, 3), generator=g)
    el = torch.randint(0, 2, (n,), generator=g)
    pyr = G.build_pyramid_grid(grid.to(dev), el.to(dev),
                               torch.zeros(n, 1, device=dev), [n] * 2, 2)
    return pyr.levels[0]


@pytest.mark.parametrize("C", [512, 256])
def test_column_conv_with_bias_at_xcpe_widths(dev, C):
    lvl = _level(dev)
    km, mask = lvl.kmap3, lvl.geom.mask
    V = mask.shape[0]
    g = torch.Generator(device=dev).manual_seed(C)
    x = torch.randn(V, C, generator=g, device=dev).bfloat16()
    w = (torch.randn(27, C, C, generator=g, device=dev) / C).bfloat16()
    b = torch.randn(C, generator=g, device=dev)
    xg, wg, bg = (t.clone().requires_grad_(True) for t in (x, w, b))
    out = sc.conv3_columns(xg, km.col_idx, km.hit, wg, mask, 1, bias=bg,
                           out_dtype=torch.float32, nvalid=km.nvalid,
                           plan=km.plan())
    ref = sc.conv3_columns_plain(x, km.col_idx, km.hit, w, mask, 1, bias=b,
                                 out_dtype=torch.float32)
    tol = 2 ** -8 * ref.abs() + 1e-4 * ref.abs().max()
    assert ((out - ref).abs() <= tol).all()
    gy = torch.randn(V, C, generator=g, device=dev)
    out.backward(gy)
    gm = torch.where(mask[:, None], gy, 0.0)
    assert torch.allclose(bg.grad, gm.sum(0), rtol=1e-5, atol=1e-5
                          * gm.abs().sum(0).max())
    gb = gm.bfloat16()
    df = sc.conv3_columns_plain(gb, km.col_idx, km.hit,
                                w.flip(0).transpose(1, 2), mask, 1,
                                out_dtype=torch.float32)
    tol = 2 ** -8 * df.abs() + 1e-4 * df.abs().max()
    assert ((xg.grad.float() - df).abs() <= tol).all()
    dw = sc.conv3_columns_dw_plain(x, gb, km.col_idx, km.hit, mask, 1)
    assert (wg.grad.float() - dw).abs().max() <= 5e-4 * dw.abs().max() \
        + 2 ** -8 * dw.abs().max()


@pytest.mark.parametrize("depth", [1, 7, 13])
def test_serial_codes_kernel_matches_the_bit_loops(dev, depth):
    """Kernel `serial_codes` against `encode`'s bit loops on the CPU, bit
    for bit, rows of several elements, coordinates below and at the
    top of the depth's range."""
    g = torch.Generator().manual_seed(depth)
    shift = (3, 5, 1)
    hi = 1 << depth
    xyz = torch.randint(0, hi, (5000, 3), generator=g)
    xyz[0] = hi - 1
    el = torch.randint(0, 4, (5000, 1), generator=g)
    coords = torch.cat([el, xyz - torch.tensor(shift)], 1).int()
    want = SZ.level_codes(coords, shift, depth)
    got = SZ.level_codes(coords.to(dev), shift, depth)
    assert torch.equal(got.cpu(), want)


def test_ptv3_step_on_flash_matches_the_cpu(dev):
    b = batch(seed=2)
    cpu = task()
    from lidiff_tpu_torch.models import ptv3 as P
    from ptv3_helpers import CFG, weights
    gpu = P.SegTask(CFG, device=dev, compute_dtype=torch.bfloat16)
    gpu.model.load_state_dict({k: v.to(dev) for k, v in weights().items()})
    bd = {k: v.to(dev) for k, v in b.items()}
    draws = {"perms": [torch.arange(4, device=dev)] * 5, "masks": None}
    # the same draws on both sides: no DropPath, orders in turn
    loss_c, _ = cpu.loss_fn(b, draws={"perms": [torch.arange(4)] * 5,
                                      "masks": None})
    loss_g, _ = gpu.loss_fn(bd, draws=draws)
    loss_g.backward()
    assert torch.isfinite(loss_g)
    assert float(loss_g) == pytest.approx(float(loss_c), rel=2e-2)
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in gpu.model.parameters())


def test_ptv3_eval_forward_on_the_card(dev):
    b = batch(seed=5)
    cpu = task()
    from lidiff_tpu_torch.models import ptv3 as P
    from ptv3_helpers import CFG, weights
    gpu = P.SegTask(CFG, device=dev, compute_dtype=torch.bfloat16)
    gpu.model.load_state_dict({k: v.to(dev) for k, v in weights().items()})
    want = cpu.forward(b)
    got = gpu.forward({k: v.to(dev) for k, v in b.items()}).cpu()
    rel = float((got - want).norm() / want.norm())
    assert rel <= 5e-2, rel
