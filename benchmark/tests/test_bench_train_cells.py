"""The training cell `ptv3.train` (Point Transformer V3) on the CPU at a
tiny size, through the same driver as on the card: a sound run comes out
correct, its control (the reference one precision below, in the
program's place) does not, and each fault planted under the timed path or
in the data it trains on makes `correct` come out false. Also its entries
in BENCHMARK.json, and the traffic repeating by seed."""

import copy
import json
import os
import time

import pytest
import torch
import torch.nn.functional as F

from benchmark import harness, train_scenes
from benchmark.tests.conftest import SENSOR

TINY = {
    "ptv3.train": {
        "config": {"model": {"enc_channels": [16, 16, 32, 32, 32],
                             "dec_channels": [16, 16, 32, 32],
                             "enc_num_head": [1, 1, 2, 2, 2],
                             "dec_num_head": [1, 1, 2, 2]},
                   "train": {"batch_size": 2},
                   "tpu": {"full_capacities": [4096] * 5}},
        "traffic": {"pool": 6, "sensor": SENSOR}, "patch": 256,
        "env": {"LIDIFF_COMPUTE_DTYPE": "float32"}},
}


@pytest.fixture
def run_cell():
    def run(cell, seed=2 ** 31 + 13, **kw):
        r = harness.make_run(cell, seed, 0.0, False, time.perf_counter(),
                             device="cpu", overrides=TINY[cell], **kw)
        return harness.run_cell(r)
    return run


@pytest.mark.parametrize("cell,fails", [
    ("ptv3.train", ("grad_median_gap", "grad_gap"))])
def test_sound_run_is_correct_and_its_control_is_not(run_cell, cell, fails):
    """The limits the control fails by here (PERF.md §2: on the card
    `ptv3.train`'s control fails by the gradient gaps)."""
    out = run_cell(cell)
    assert out.correct, out.checks
    assert dict((n, v) for n, v, _ in out.checks)["batch_differ"] == 0
    assert {"train_step_ms", "train_peak_gib", "setup_s"} <= set(out.e2e)
    ctl = run_cell(cell, control="lower")
    assert not ctl.correct
    read = {n: (v, lim) for n, v, lim in ctl.checks}
    for name in fails:
        assert read[name][0] > read[name][1], (name, read[name])


def _unshuffled(mp):
    from lidiff_tpu_torch.ops import serialize
    orig = serialize.serialize_level
    mp.setattr(serialize, "serialize_level",
               lambda codes, lc, perm: orig(
                   codes, lc, torch.arange(4, device=codes.device)))


def _filler_masked(mp):
    """Filler rows masked out of the keys instead of duplicated."""
    from lidiff_tpu_torch.models import ptv3 as P
    orig = P.Attention.forward

    def forward(self, x, lvl, order):
        maps = lvl.orders.maps
        real = torch.zeros(maps.rows, dtype=torch.bool, device=x.device)
        real[maps.unpad] = True
        sdpa = F.scaled_dot_product_attention

        def masked(q, k, v, scale=None):
            mask = real.view(q.shape[0], 1, 1, q.shape[2])
            return sdpa(q, k, v, attn_mask=mask, scale=scale)
        mp.setattr(F, "scaled_dot_product_attention", masked)
        try:
            return orig(self, x, lvl, order)
        finally:
            mp.setattr(F, "scaled_dot_product_attention", sdpa)
    mp.setattr(P.Attention, "forward", forward)


def _drop_path_ignored(mp):
    from lidiff_tpu_torch.models import ptv3 as P
    orig = P.Block.forward
    mp.setattr(P.Block, "forward",
               lambda self, x, lvl, masks: orig(self, x, lvl, None))


def _flip_ignored(mp):
    """The augmentation's flips drawn but not applied."""
    from lidiff_tpu_torch.data import seg
    orig = seg.random_flip

    def flip(d, rng, p=0.5, draws=None):
        orig({"coord": d["coord"].copy()}, rng, p, draws)
        return d
    mp.setattr(seg, "random_flip", flip)


@pytest.mark.parametrize("plant", [_unshuffled, _filler_masked,
                                   _drop_path_ignored, _flip_ignored],
                         ids=lambda f: f.__name__[1:])
def test_ptv3_fault_is_caught(run_cell, monkeypatch, plant):
    plant(monkeypatch)
    out = run_cell("ptv3.train")
    assert not out.correct, out.checks


def test_entries_of_the_training_cells():
    bench = harness.spec()
    cells = {w["name"]: w for w in bench["workloads"]}
    assert cells["ptv3.train"]["config"] == "ptv3_semkitti"
    assert cells["ptv3.train"]["chips"] == 1
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for name in ("train_step_ms", "train_peak_gib"):
        assert "ptv3.train" in e2e[name]["workloads"]
    layer = {m["name"]: m for m in bench["per_layer"]}
    for name in ("attn_ms.ptv3", "attn_roofline.ptv3", "serialize_ms.ptv3",
                 "pad_share.ptv3", "mfu.ptv3"):
        assert layer[name]["workloads"] == ["ptv3.train"]
        assert layer[name]["moves"] == "train_step_ms"
    assert "ptv3.train" in layer["idle.train"]["workloads"]
    conf = harness.config_file(bench, "ptv3_semkitti")
    assert conf["reduced"] == [] and conf["config"]["train"]["batch_size"] \
        == 12
    m = conf["config"]["model"]
    assert m["enc_channels"] == [32, 64, 128, 256, 512]
    assert all(c // h == 16 for c, h in zip(m["enc_channels"] + m[
        "dec_channels"], m["enc_num_head"] + m["dec_num_head"]))
    w = json.load(open(os.path.join(harness.HERE, "workloads",
                                    "ptv3.train.json")))
    # the loss gap does not separate bf16 from the control: no limit
    assert set(w["limits"]) == {"batch_differ", "pad_differ",
                                "orders_differ", "grad_gap",
                                "grad_median_gap", "update_gap"}


def test_training_traffic_repeats_by_seed():
    p = json.load(open(os.path.join(harness.HERE, "traffic",
                                    "labeled_scans.json")))
    p.update(copy.deepcopy(TINY["ptv3.train"]["traffic"]))
    a, b = (train_scenes.labeled_scans(p, 2 ** 31 + 5, "cpu")
            for _ in range(2))
    c = train_scenes.labeled_scans(p, 2 ** 31 + 6, "cpu")
    assert all(torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
               and torch.equal(x[2], y[2]) for x, y in zip(a, b))
    # another seed: the mix's scans, other strengths
    assert all(torch.equal(x[0], z[0]) and not torch.equal(x[2], z[2])
               for x, z in zip(a, c))
    kinds = set(torch.cat([x[1] for x in a]).tolist())
    assert {train_scenes.ROAD, train_scenes.BUILDING} <= kinds
