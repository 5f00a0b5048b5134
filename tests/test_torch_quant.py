"""The port's int8 eval conv (kernel A4's plain version and its prologue,
`lidiff_tpu_torch.ops.sparse_conv.conv3_columns_q`) against the JAX
package on the CPU: the Pallas int8 kernel in interpret mode, the XLA
fake-quant mirror, the gate, and the int8 denoiser and refiner with the
same weights.

Tolerances:
  * against the Pallas kernel, float32: 1e-5 of max|ref| (the same
    quantized values; float32 sums in other orders);
  * bf16: one bf16 ulp of each value plus 1e-4 of max|ref| (the same
    values; the final cast may round the other way);
  * against the XLA mirror: atol 2e-4, the JAX package's own
    (tests/test_pallas_conv.py:464-490): the mirror multiplies q * scale
    into the feats, the kernel folds the scale into the weights;
  * the models: atol 1e-4, as tests/test_torch_models.py, on every output
    but those moved by a value that rounds to another int8 step in one
    package (`_flips` counts them); none does on these seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lidiff_tpu.config import finalize_config as jax_finalize
from lidiff_tpu.models.diffusion import DiffusionModel as JaxModel
from lidiff_tpu.models.diffusion import DiffusionTask as JaxTask
from lidiff_tpu.models.minkunet import MinkUNet as JaxMinkUNet
from lidiff_tpu.models.refine import RefineTask as JaxRefineTask
from lidiff_tpu.ops import sparse_conv as jsc
from lidiff_tpu.ops.grid import build_pyramid as jax_build_pyramid
from lidiff_tpu.ops.pallas_conv import conv_columns_pallas_v2
from lidiff_tpu_torch.config import finalize_config
from lidiff_tpu_torch.convert import load_jax_variables
from lidiff_tpu_torch.models.diffusion import DiffusionTask
from lidiff_tpu_torch.models.refine import RefineTask
from lidiff_tpu_torch.ops import sparse_conv as sc
from lidiff_tpu_torch.ops.grid import ColumnKernelMap, plan_keys
from tests.torch_parity_helpers import (B, CFG, NP, SMALL_CAPS, SMALL_RES,
                                        TILE, jax_conv_quant,
                                        random_variables, ring_scan,
                                        small_pyramid_points, to_jax)

F32_TOL = 1e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-4
MIRROR_ATOL = 2e-4
MODEL_ATOL = 1e-4


@pytest.fixture(scope="module")
def pyramid():
    return jax.jit(lambda p: jax_build_pyramid(p, SMALL_RES, SMALL_CAPS, 5))(
        jnp.asarray(small_pyramid_points()))


def _level(pyramid, lv):
    """(JAX level, the port's kernel map and mask of the same level)."""
    L = pyramid.levels[lv]
    mask = torch.from_numpy(np.array(L.geom.mask))
    hit = torch.from_numpy(np.array(L.kmap3.hit, bool))
    km = ColumnKernelMap(
        torch.from_numpy(np.array(L.kmap3.col_idx, np.int32)), hit,
        mask.sum().to(torch.int32), plan_keys(hit))
    return L, km, mask


def _feats(L, G, C, seed):
    """Masked feats with per-channel ranges from 0.05 to 8."""
    rng = np.random.default_rng(seed)
    V = L.geom.capacity
    f = (rng.normal(0, 1, (V, G * C))
         * rng.uniform(0.05, 8.0, (1, G * C))).astype(np.float32)
    f[~np.asarray(L.geom.mask)] = 0.0
    return f, rng


@pytest.mark.parametrize("C,Co,G,dtype", [
    (32, 24, 1, "float32"), (32, 24, 2, "float32"), (48, 16, 1, "float32"),
    (48, 16, 2, "float32"), (32, 24, 2, "bfloat16"), (48, 16, 1, "bfloat16")])
def test_plain_matches_pallas_int8_interpret(pyramid, C, Co, G, dtype):
    """Prologue + plain version against the Pallas int8 kernel, bias and
    ReLU on."""
    L, km, mask = _level(pyramid, 2)
    f, rng = _feats(L, G, C, 100 + C + G)
    w = rng.normal(0, 0.1, (27, C, Co)).astype(np.float32)
    b = rng.normal(0, 0.5, (Co,)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref, ov = conv_columns_pallas_v2(
        jnp.asarray(f, jdt), L.kmap3.col_idx, L.kmap3.hit,
        jnp.asarray(w, jdt), L.geom.mask, groups=G, interpret=True,
        quant=True, bias=jnp.asarray(b), relu=True)
    assert int(ov) == 0
    ref = np.asarray(ref.astype(jnp.float32))
    got = sc.conv3_columns_q(torch.from_numpy(f).to(tdt), km.col_idx, km.hit,
                             torch.from_numpy(w).to(tdt), mask, G,
                             bias=torch.from_numpy(b), relu=True)
    assert got.dtype == tdt and got.shape == (L.geom.capacity, G * Co)
    got = got.float().numpy()
    scale = np.abs(ref).max()
    assert scale > 1.0
    err = np.abs(got - ref)
    if dtype == "float32":
        assert err.max() <= F32_TOL * scale
    else:
        assert (err <= BF16_RTOL * np.abs(ref) + BF16_ATOL * scale).all()


def test_integer_feats_equal_the_unquantized_conv(pyramid):
    """Integer feats with every channel's amax at 127 quantize to
    themselves with scale 1 (tests/test_pallas_conv.py:392-413): the int8
    conv equals kernel A1's plain version bit for bit."""
    L, km, mask = _level(pyramid, 1)
    rng = np.random.default_rng(90)
    C, Co, G = 32, 24, 2
    f = rng.integers(-127, 128, (L.geom.capacity, G * C)).astype(np.float32)
    f[:1] = 127.0
    f[~np.asarray(L.geom.mask)] = 0.0
    w = torch.from_numpy(rng.normal(0, 0.1, (27, C, Co)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.5, (Co,)).astype(np.float32))
    ft = torch.from_numpy(f)
    q, w_q = sc.quantize_feats(ft, w, G)
    assert q.dtype == torch.int8 and torch.equal(q.float(), ft)
    assert torch.equal(w_q, w)
    args = (ft, km.col_idx, km.hit, w, mask, G)
    got = sc.conv3_columns_q(*args, bias=b, relu=True)
    assert torch.equal(got, sc.conv3_columns(*args, bias=b, relu=True))


def test_prologue_scale_is_shared_by_the_groups(pyramid):
    """One scale per channel over all rows and both groups: a group with
    ten times the range sets the other group's scale too."""
    L, _, _ = _level(pyramid, 1)
    f, _ = _feats(L, 2, 32, 7)
    f[:, 32:] = 10.0 * f[:, :32]
    ft = torch.from_numpy(f)
    q, w_q = sc.quantize_feats(ft, torch.ones(27, 32, 4), 2)
    amax = np.abs(f.reshape(-1, 2, 32)).max((0, 1))
    np.testing.assert_array_equal(w_q[0, :, 0].numpy(),
                                  (amax * np.float32(1 / 127)).astype(
                                      np.float32))
    # the quiet group uses a tenth of the int8 range at most
    assert int(q[:, :32].abs().max()) <= 13
    assert int(q[:, 32:].abs().max()) == 127


@pytest.mark.parametrize("case", ["narrow", "no_epilogue", "autograd"])
def test_gate_leaves_other_convs_exact(pyramid, case):
    """Cin < 32, a conv without the eval epilogue and a conv under
    autograd take kernel A1, bit for bit, with `quant` on."""
    L, km, mask = _level(pyramid, 1)
    C = 16 if case == "narrow" else 32
    f, rng = _feats(L, 1, C, 11)
    w = torch.from_numpy(rng.normal(0, 0.1, (27, C, 8)).astype(np.float32))
    ft = torch.from_numpy(f)
    kw = {"bias": torch.ones(8), "relu": True} if case == "narrow" else {}
    if case == "autograd":
        w.requires_grad_(True)
    got = sc.sparse_conv_columns(ft, km, w, mask, quant=True, **kw)
    ref = sc.sparse_conv_columns(ft, km, w, mask, **kw)
    assert torch.equal(got, ref)
    if case == "autograd":
        assert got.grad_fn is not None
        # with the eval epilogue the call raises as without `quant`: it
        # never returns a quantized output that carries no gradient
        with pytest.raises(ValueError, match="eval-only"):
            sc.sparse_conv_columns(ft, km, w, mask, quant=True, relu=True)


def test_gate_quantizes_eval_convs(pyramid):
    """Cin >= 32 with the epilogue runs the int8 conv."""
    L, km, mask = _level(pyramid, 1)
    f, rng = _feats(L, 2, 32, 12)
    w = torch.from_numpy(rng.normal(0, 0.1, (27, 32, 8)).astype(np.float32))
    ft, b = torch.from_numpy(f), torch.full((8,), 0.1)
    got = sc.sparse_conv_columns(ft, km, w, mask, groups=2, bias=b,
                                 relu=True, quant=True)
    q_ref = sc.conv3_columns_q(ft, km.col_idx, km.hit, w, mask, 2, bias=b,
                               relu=True)
    assert torch.equal(got, q_ref)
    assert not torch.equal(got, sc.sparse_conv_columns(
        ft, km, w, mask, groups=2, bias=b, relu=True))


@pytest.mark.parametrize("C,Co,G", [(32, 16, 1), (48, 16, 2)])
def test_matches_jax_fake_quant_mirror(pyramid, C, Co, G):
    """Against sparse_conv_columns' CONV_QUANT mirror of the JAX package
    (allow_pallas=False), as tests/test_pallas_conv.py:464-490 holds the
    Pallas kernel to it."""
    L, km, mask = _level(pyramid, 1)
    f, rng = _feats(L, G, C, 95 + C)
    w = rng.normal(0, 0.1, (27, C, Co)).astype(np.float32)
    b = rng.normal(0, 0.5, (Co,)).astype(np.float32)
    with jax_conv_quant():
        ref = jsc.sparse_conv_columns(jnp.asarray(f), L.kmap3,
                                      jnp.asarray(w), L.geom.mask, groups=G,
                                      bias=jnp.asarray(b), relu=True,
                                      allow_pallas=False)
    got = sc.sparse_conv_columns(torch.from_numpy(f), km,
                                 torch.from_numpy(w), mask, groups=G,
                                 bias=torch.from_numpy(b), relu=True,
                                 quant=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=MIRROR_ATOL)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def _flips(got, ref, atol):
    """Outputs off by more than `atol`: a value that rounds to the other
    int8 step in one package moves its voxel's outputs by a whole step."""
    return int((np.abs(got - ref) > atol).sum())


@pytest.fixture(scope="module")
def diffusion():
    jt = JaxTask(jax_finalize(CFG))
    variables = random_variables(jt, seed=3)
    tt = DiffusionTask(finalize_config(CFG), device="cpu", conv_quant=True)
    load_jax_variables(tt.model, variables)
    rng = np.random.default_rng(7)
    part = ring_scan(rng, NP)
    x = np.tile(part, (1, TILE, 1)) + rng.normal(0, 0.3, (B, NP * TILE, 3))
    return jt, to_jax(variables), tt, variables, part, x.astype(np.float32)


def test_int8_denoiser_matches_jax(diffusion):
    """Both banks through the int8 encoder, then one int8 G=2 denoise,
    against the JAX models under LIDIFF_CONV_QUANT=int8."""
    jt, jv, tt, variables, part, x = diffusion
    t = np.array([55, 55], np.int32)
    with jax_conv_quant():
        pyr_c = jax.jit(jt.pyramid_part)(jnp.asarray(part))
        pyr_u = jax.jit(jt.pyramid_part_tiny)(jnp.zeros(part.shape))
        enc = jax.jit(lambda v, p: jt.model.apply(
            v, p, False, method=JaxModel.encode_partial))
        jf_c, jf_u = enc(jv, pyr_c), enc(jv, pyr_u)
        pyr = jax.jit(jt.pyramid_full)(jnp.asarray(x))
        ref = np.asarray(jax.jit(lambda v, p, f, g, t: jt.model.apply(
            v, p, f, g, t, False, method=JaxModel.denoise))(
                jv, pyr, (jf_c, jf_u),
                (pyr_c.levels[-1].geom, pyr_u.levels[-1].geom),
                jnp.asarray(t)))
    tf_c, tg_c, tf_u, tg_u = tt.encode_banks(torch.from_numpy(part))
    assert _flips(tf_c.numpy(), np.asarray(jf_c), MODEL_ATOL) == 0
    with torch.no_grad():
        got = tt.model.denoise(tt.pyramid_full(torch.from_numpy(x)),
                               [(tf_c, tg_c), (tf_u, tg_u)],
                               torch.from_numpy(t)).numpy()
    assert got.shape == ref.shape == (B, NP * TILE, 2, 3)
    assert _flips(got, ref, MODEL_ATOL) == 0
    # the int8 path really ran: the float32 model gives another eps
    plain = DiffusionTask(finalize_config(CFG), device="cpu")
    load_jax_variables(plain.model, variables)
    banks = plain.encode_banks(torch.from_numpy(part))
    with torch.no_grad():
        f32 = plain.model.denoise(plain.pyramid_full(torch.from_numpy(x)),
                                  [banks[:2], banks[2:]],
                                  torch.from_numpy(t)).numpy()
    assert np.abs(f32 - got).max() > 10 * MODEL_ATOL


def test_int8_refiner_matches_jax():
    """`RefineTask.forward` with the int8 convs against the JAX refiner
    under LIDIFF_CONV_QUANT=int8 (cr 0.25, up_factor 2)."""
    cfg = {"experiment": {"id": "torch-quant-refine"},
           "data": {"data_dir": "", "resolution": 0.25, "num_points": 384},
           "train": {"up_factor": 2, "lr": 1e-3, "n_gpus": 1,
                     "batch_size": B},
           "model": {"out_dim": 96, "cr": 0.25},
           "tpu": {"full_capacities": [512, 512, 512, 384, 256]}}
    jt = JaxRefineTask(jax_finalize(cfg))
    jt.model = JaxMinkUNet(out_channels=6, cr=0.25, remat=False)
    variables = random_variables(jt, seed=7, n_points=256)
    tt = RefineTask(finalize_config(cfg), device="cpu", conv_quant=True)
    load_jax_variables(tt.model, variables)
    pts = ring_scan(np.random.default_rng(3), 384, batch=B)
    with jax_conv_quant():
        ref = np.asarray(jax.jit(jt.forward)(to_jax(variables),
                                             jnp.asarray(pts)))
    got = tt.forward(torch.from_numpy(pts)).numpy()
    assert got.shape == ref.shape == (B, 384, 2, 3)
    assert _flips(got, ref, MODEL_ATOL) == 0


def test_training_never_quantizes(diffusion, monkeypatch):
    """A training loss with `conv_quant` on never reaches the int8 conv
    (train-mode convs have no epilogue and run under autograd) and equals
    the loss without it bit for bit; the same task's eval encoder does
    reach it."""
    _, _, tt, variables, part, x = diffusion
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return int8_conv(*a, **kw)
    int8_conv = sc.conv3_columns_q
    monkeypatch.setattr(sc, "conv3_columns_q", counted)
    rng = np.random.default_rng(5)
    batch = {"pcd_full": torch.from_numpy(x),
             "pcd_part": torch.from_numpy(part)}
    draws = {"noise": torch.from_numpy(
                 rng.normal(size=x.shape).astype(np.float32)),
             "t": torch.tensor([30, 70]), "drop": False}
    plain = DiffusionTask(finalize_config(CFG), device="cpu")
    losses = []
    for task in (tt, plain):
        load_jax_variables(task.model, variables)
        loss, _ = task.loss_fn(batch, **draws)
        loss.backward()
        losses.append(loss.detach())
        task.model.eval()
    assert not calls
    assert torch.equal(losses[0], losses[1])
    load_jax_variables(tt.model, variables)
    tt.encode_banks(torch.from_numpy(part))
    assert calls
