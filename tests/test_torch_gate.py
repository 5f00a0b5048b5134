"""The eval-mode conditioning gate (`StageGate.apply_table`, `ops/gate.py`)
against the per-voxel formula, on the CPU.

In eval mode `MinkUNetDiff` gates through one table per gate over (item,
bank row) pairs and `gate_apply`; training keeps the per-voxel MLPs. The
two compute the same operations on the same values, the table's GEMMs over
fewer rows: float32 within 1e-6 of the largest |output| (the GEMMs may sum
a row in another order for another row count), bf16 within one bf16 ulp
of it (a rounding that falls the other way). `gate_apply_plain` is held to
the index-`where`-multiply definition bit for bit, and the train-mode gate
and denoiser to the code before the table path, bit for bit, outputs and
gradients."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from lidiff_tpu_torch.config import finalize_config
from lidiff_tpu_torch.models import minkunet
from lidiff_tpu_torch.models.diffusion import DiffusionTask
from lidiff_tpu_torch.models.minkunet import StageGate, timestep_embedding
from lidiff_tpu_torch.ops import gate, grid, knn
from lidiff_tpu_torch.ops.knn import match_features
from tests.torch_parity_helpers import CFG, NP, TILE, one_thread, ring_scan

F32_TOL = 1e-6          # x max|ref|
BF16_TOL = 2.0 ** -7    # x max|ref|: one bf16 ulp


def _close(got, ref, dtype):
    assert got.dtype == ref.dtype == dtype
    tol = (F32_TOL if dtype == torch.float32 else BF16_TOL) \
        * float(ref.float().abs().max())
    err = float((got.float() - ref.float()).abs().max())
    assert err <= tol, (err, tol)


def per_voxel(module, feats, geom, rows, bank, temp_emb):
    """The gate as training computes it, on match = bank[rows] (zeros off
    the mask, as `match_features` gives it)."""
    G = rows.shape[1]
    match = torch.where(geom.mask[:, None, None], bank[rows.long()], 0)
    return module(feats, geom, match[:, 0] if G == 1 else match, temp_emb,
                  G)


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 \
        else t.view(torch.int32)


# ---------------------------------------------------------------------------
# gate_apply_plain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 2])
def test_gate_apply_plain_is_index_where_multiply(dtype, G):
    """Row by row: the valid rows take table row item * n_bank + rows[v, g],
    the masked rows (whose item and rows are garbage here) are feats * 0."""
    rng = torch.Generator().manual_seed(3)
    V, C, B, n_bank = 37, 24, 3, 5
    feats = torch.randn(V, G * C, generator=rng).to(dtype)
    table = torch.randn(B * n_bank, C, generator=rng).to(dtype)
    mask = torch.rand(V, generator=rng) < 0.7
    coords = torch.randint(0, B, (V, 4), generator=rng, dtype=torch.int32)
    rows = torch.randint(0, n_bank, (V, G), generator=rng,
                         dtype=torch.int32)
    coords[~mask, 0] = -7
    rows[~mask] = 1 << 20
    got = gate.gate_apply_plain(feats, table, rows, coords, mask, n_bank)
    ref = torch.empty_like(feats)
    for v in range(V):
        for g in range(G):
            f = feats[v, g * C:(g + 1) * C]
            w = table[int(coords[v, 0]) * n_bank + int(rows[v, g])] \
                if mask[v] else torch.zeros(C, dtype=dtype)
            ref[v, g * C:(g + 1) * C] = f * w
    assert torch.equal(_bits(got), _bits(ref))
    n = gate.counters["gated_rows"]
    cpu = gate.gate_apply(feats, table, rows, coords, mask, n_bank)
    assert torch.equal(_bits(cpu), _bits(ref))
    assert gate.counters["gated_rows"] == n + V * G


def test_gate_apply_rejects_other_devices():
    x = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError):
        gate.gate_apply(x, torch.zeros(4, 8, device="meta"),
                        torch.zeros(2, 1, dtype=torch.int32, device="meta"),
                        torch.zeros(2, 4, dtype=torch.int32, device="meta"),
                        torch.zeros(2, dtype=torch.bool, device="meta"), 4)


# ---------------------------------------------------------------------------
# StageGate: the table path against the per-voxel formula
# ---------------------------------------------------------------------------

def _gate_inputs(dtype, G, B, no_bank_item, seed=0):
    """A level of V voxels (some masked) over B items, G banks of random
    features with C1's matches (`nn_match`) into them; with
    `no_bank_item`, item B - 1 has no valid row in any bank (C1 gives it
    row 0)."""
    rng = np.random.default_rng(seed)
    V, c4 = 90, 16
    coords = torch.from_numpy(np.concatenate(
        [rng.integers(0, B, (V, 1)), rng.integers(-20, 20, (V, 3))], 1)
        .astype(np.int32))
    mask = torch.from_numpy(rng.random(V) < 0.8)
    banks, rows, start = [], [], 0
    for g in range(G):
        nr = 23 + 9 * g
        rc = torch.from_numpy(np.concatenate(
            [rng.integers(0, B, (nr, 1)), rng.integers(-20, 20, (nr, 3))], 1)
            .astype(np.int32))
        rm = torch.from_numpy(rng.random(nr) < 0.85)
        if no_bank_item:
            rm &= rc[:, 0] != B - 1
        banks.append(torch.from_numpy(rng.normal(size=(nr, c4))
                                      .astype(np.float32)).to(dtype))
        rows.append(knn.nn_match(coords, rc, rm, B, mask) + start)
        start += nr
    geom = grid.VoxelGeom(key=torch.zeros(V, dtype=torch.int64),
                          coords=coords, mask=mask,
                          num=mask.sum().int(), num_raw=mask.sum().int())
    t = torch.tensor([70, 15][:B])
    return geom, torch.stack(rows, 1), torch.cat(banks), t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("B,no_bank_item", [(1, False), (2, False),
                                            (2, True)])
@pytest.mark.parametrize("swap", [False, True])
def test_apply_table_matches_per_voxel(dtype, G, B, no_bank_item, swap):
    """`apply_table` against the train-mode formula on the same inputs:
    G = 1 and 2, one item or two with different t, masked voxels, an item
    with no valid bank row, up1's (t, p) order."""
    torch.manual_seed(1)
    temb, C = 12, 8
    module = StageGate(C, 20, 16, temb, swap=swap, compute_dtype=dtype)
    module.eval()
    geom, rows, bank, t = _gate_inputs(dtype, G, B, no_bank_item)
    temp = timestep_embedding(t, temb)
    feats = torch.randn(geom.coords.shape[0], G * C).to(dtype)
    before = dict(gate.counters)
    with torch.no_grad():
        got = module.apply_table(feats, geom, rows, bank, temp)
        ref = per_voxel(module, feats, geom, rows, bank, temp)
    _close(got, ref, dtype)
    assert float(ref.float().abs().max()) > 0
    assert torch.equal(got[~geom.mask], ref[~geom.mask])
    assert gate.counters["table_calls"] == before["table_calls"] + 1
    assert gate.counters["table_rows"] == before["table_rows"] \
        + B * bank.shape[0]
    assert gate.counters["gated_rows"] == before["gated_rows"] \
        + geom.coords.shape[0] * G


# ---------------------------------------------------------------------------
# MinkUNetDiff in eval: the table path against per-voxel gates
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(11)
    part = ring_scan(rng, NP)
    x = np.tile(part, (1, TILE, 1)) + rng.normal(0, 0.3, part.shape[:1]
                                                 + (NP * TILE, 3))
    return torch.from_numpy(part), torch.from_numpy(x.astype(np.float32))


def _no_item(geom, item):
    """The bank level with every row of `item` masked out (a fresh index)."""
    return dataclasses.replace(geom, mask=geom.mask & (geom.coords[:, 0]
                                                       != item), _nn={})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("no_bank_item", [False, True])
def test_denoiser_eval_matches_per_voxel_gates(scene, one_thread,
                                               monkeypatch, dtype, G,
                                               no_bank_item):
    """One eval denoiser forward at two items with different t, through the
    gate tables and through per-voxel gates on the same weights: within
    the tolerance of one gate (the eps passes through about 40 layers
    after the gates, each in the same operations on both sides). With
    `no_bank_item` the second item has no valid row in the cond bank. The
    counters: 8 tables a forward of B * Nb rows each, the gated rows V * G
    a gate, under a tenth of them."""
    part, x = scene
    task = DiffusionTask(finalize_config(CFG), device="cpu",
                         compute_dtype=dtype, seed=4)
    fc, gc, fu, gu = task.encode_banks(part)
    if no_bank_item:
        gc = _no_item(gc, 1)
    banks = [(fc, gc), (fu, gu)][:G]
    t = torch.tensor([37, 80])
    pyr = task.pyramid_full(x)
    before = dict(gate.counters)
    with torch.no_grad():
        got = task.model.denoise(pyr, banks, t)
    nb = sum(f.shape[0] for f, _ in banks)
    lv = [0, 1, 2, 3, 4, 3, 2, 1]
    gated = sum(pyr.levels[i].geom.capacity for i in lv) * G
    assert gate.counters["table_calls"] - before["table_calls"] == 8
    assert gate.counters["table_rows"] - before["table_rows"] == 8 * 2 * nb
    assert gate.counters["gated_rows"] - before["gated_rows"] == gated
    monkeypatch.setattr(StageGate, "apply_table", per_voxel)
    with torch.no_grad():
        ref = task.model.denoise(pyr, banks, t)
    assert got.shape == ref.shape == (2, x.shape[1]) + ((G,) if G > 1
                                                         else ()) + (3,)
    tol = (1e-5 if dtype == torch.float32 else 2.0 ** -6) \
        * float(ref.float().abs().max())
    err = float((got - ref).abs().max())
    assert err <= tol, (err, tol)
    assert float(ref.abs().max()) > 0.1


# ---------------------------------------------------------------------------
# training: bit for bit as before the table path
# ---------------------------------------------------------------------------

def _gate_before(self, feats, geom, match, temp_emb, groups):
    """`StageGate.forward` before the table path existed."""
    p = self.latent(match)
    t_emb = self.temp(temp_emb)
    items = torch.arange(t_emb.shape[0], device=t_emb.device)
    onehot = (geom.coords[:, :1] == items).to(t_emb.dtype)
    t_vox = onehot @ t_emb
    if groups > 1:
        t_vox = t_vox[:, None, :].expand(p.shape)
    w = self.latemp(torch.cat([t_vox, p] if self.swap else [p, t_vox],
                              dim=-1)).to(feats.dtype)
    V = feats.shape[0]
    w = torch.where(geom.mask.reshape((V,) + (1,) * (w.dim() - 1)), w, 0.0)
    return (feats.reshape(V, groups, -1)
            * w.reshape(V, groups, -1)).reshape(V, -1)


def _denoise_before(self, pyr, banks, t):
    """`MinkUNetDiff.forward` before the table path existed."""
    G = len(banks)
    cd = self.compute_dtype
    vox_feats = pyr.vox_feats
    if not self.training:
        banks = [(pf.to(cd), pg) for pf, pg in banks]
        vox_feats = vox_feats.to(cd)
    lv = pyr.levels
    temp = timestep_embedding(t, self.out_dim)
    nb = pyr.point2voxel.shape[0]

    def level_match(l):
        ms = [match_features(l.geom.coords, l.geom.mask, pg.coords,
                             pg.mask, pf, n_batch=nb, compute_dtype=cd,
                             index=pg.nn_index(nb))
              for pf, pg in banks]
        return ms[0] if G == 1 else torch.stack(ms, dim=1)
    match = [level_match(l) for l in lv]

    def g(m, x, i):
        return _gate_before(m, x, lv[i].geom, match[i], temp, G)
    x0 = self.Stem_0(vox_feats, lv[0]).repeat(1, G)
    g0 = g(self.gate_s1, x0, 0)
    x1 = self.stage(self.DownStage_0, g0, lv[0], lv[1], G)
    g1 = g(self.gate_s2, x1, 1)
    x2 = self.stage(self.DownStage_1, g1, lv[1], lv[2], G)
    g2 = g(self.gate_s3, x2, 2)
    x3 = self.stage(self.DownStage_2, g2, lv[2], lv[3], G)
    g3 = g(self.gate_s4, x3, 3)
    x4 = self.stage(self.DownStage_3, g3, lv[3], lv[4], G)
    g4 = g(self.gate_u1, x4, 4)
    y1 = self.stage(self.UpStage_0, g4, x3, lv[3], G)
    g5 = g(self.gate_u2, y1, 3)
    y2 = self.stage(self.UpStage_1, g5, x2, lv[2], G)
    g6 = g(self.gate_u3, y2, 2)
    y3 = self.stage(self.UpStage_2, g6, x1, lv[1], G)
    g7 = g(self.gate_u4, y3, 1)
    y4 = self.stage(self.UpStage_3, g7, x0, lv[0], G)
    pt = minkunet.slice_to_points(y4, pyr.point2voxel)
    if G > 1:
        pt = pt.reshape(pt.shape[0], pt.shape[1], G, -1)
    return self.head(pt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("swap", [False, True])
def test_train_gate_is_unchanged(dtype, swap):
    """The train-mode gate's output and gradients (feats, match, every
    parameter) equal the code's before the table path, bit for bit."""
    torch.manual_seed(2)
    module = StageGate(8, 20, 16, 12, swap=swap, compute_dtype=dtype)
    geom, rows, bank, t = _gate_inputs(torch.float32, 2, 2, False, seed=5)
    match = torch.where(geom.mask[:, None, None], bank[rows.long()], 0)
    temp = timestep_embedding(t, 12)
    feats = torch.randn(geom.coords.shape[0], 16)
    cot = torch.randn(feats.shape)
    res = []
    for fn in (type(module).forward, _gate_before):
        f, m = feats.clone().requires_grad_(), match.clone().requires_grad_()
        module.zero_grad()
        out = fn(module, f, geom, m, temp, 2)
        out.backward(cot)
        res.append([out.detach(), f.grad, m.grad]
                   + [p.grad.clone() for p in module.parameters()])
    for a, b in zip(*res):
        assert torch.equal(a, b)


@pytest.mark.parametrize("remat", [True, False])
def test_train_denoiser_is_unchanged(scene, one_thread, remat):
    """One train-mode denoiser forward and backward (G = 1, as training
    runs it; BatchNorm on the batch): its output and every parameter's
    gradient equal those of the forward before the table path, bit for
    bit, with remat and without."""
    part, x = scene
    task = DiffusionTask(finalize_config(CFG), device="cpu", seed=6)
    fc, gc, _, _ = task.encode_banks(part)
    pyr = task.pyramid_full(x)
    t = torch.tensor([37, 80])
    res = []
    for before in (False, True):
        model = copy.deepcopy(task.model.denoiser).train()
        model.remat = remat
        out = _denoise_before(model, pyr, [(fc, gc)], t) if before \
            else model(pyr, [(fc, gc)], t)
        out.backward(torch.ones_like(out))
        res.append([out.detach()] + [p.grad for p in model.parameters()])
    for a, b in zip(*res):
        assert torch.equal(a, b)
