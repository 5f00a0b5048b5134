"""PTv3 segmentation training through the port's normal path against the
plain reference (`benchmark/reference/ptv3.py`) on the CPU at a tiny size:
`SegTask.loss_fn`'s loss and every gradient, the eval forward,
`Trainer.train_step` under AdamW/OneCycleLR with the "block" group, a pin
of the Adam path of the LiDiff tasks, the data's transforms and Mix3D
collation, and the `train_seg` CLI.

Tolerances: float32 throughout; the loss agrees to 1e-5 and each leaf's
gradient to 1e-4 of the larger of that leaf's and the median leaf's
largest entry, where that leaf's is above a thousandth of the median's
(below, as for a bias before a BatchNorm, it is zero but for rounding;
both sides stay below that): the port's BatchNorm variance E[x^2] -
E[x]^2 and its column conv's sum by column round differently from the
reference's;
parameter changes after three AdamW steps to 2e-3 of the change's norm,
over the leaves whose first gradient is above a thousandth of the median
leaf's: Adam moves each entry by about lr whatever its gradient's size,
so the entries whose gradient is near its own rounding move by +-lr on
either side."""

import json
import os
import statistics

import numpy as np
import pytest
import torch

from benchmark.reference import ptv3 as R
from lidiff_tpu_torch.data import seg as S
from lidiff_tpu_torch.models import ptv3 as P
from lidiff_tpu_torch.training.trainer import Trainer
from tests.ptv3_helpers import (CFG, batch, one_thread,  # noqa: F401
                                small_patch, task, weights)


def _recording(monkeypatch):
    seen = []
    orig = P.draw

    def draw(*a, **k):
        d = orig(*a, **k)
        seen.append(d)
        return d
    monkeypatch.setattr(P, "draw", draw)
    return seen


def _ref_grads(W, b, d, train=True):
    ref = R.pyramid(b["grid_coord"], b["offset"], b["feat"])
    W = {k: v.clone().requires_grad_(not k.endswith((".mean", ".var")))
         for k, v in W.items()}
    logits = R.forward(W, ref, R.serialize(ref, d["perms"]), d["masks"])
    loss = R.loss(logits[ref.p2v], b["segment"])
    loss.backward()
    return loss, {k: v.grad for k, v in W.items() if v.grad is not None}


@pytest.mark.parametrize("mix", [0.0, 1.0], ids=["items", "mix3d"])
def test_loss_and_every_gradient_match_the_reference(
        monkeypatch, small_patch, mix):  # noqa: F811
    seen = _recording(monkeypatch)
    b = batch(seed=3, mix_prob=mix, items=4 if mix else 2)
    assert b["offset"].shape[0] == (2 if mix else 2)
    W = weights()
    t = task(W)
    loss, metrics = t.loss_fn(b, torch.Generator().manual_seed(7))
    loss.backward()
    assert t.model.training and float(metrics["overflow_vox"]) == 0
    d = seen[0]
    assert len(d["masks"]) == sum(1 for _, r in t.rates if r > 0) == 20
    r_loss, r_grads = _ref_grads(W, b, d)
    assert float(loss) == pytest.approx(float(r_loss), rel=1e-5)
    grads = dict(t.model.named_parameters())
    assert set(grads) == set(r_grads)
    med = statistics.median(float(g.abs().max()) for g in r_grads.values())
    for k, g in r_grads.items():
        top = float(g.abs().max())
        if top < 1e-3 * med:
            # a bias before a BatchNorm: zero but for rounding, both ways
            assert float(grads[k].grad.abs().max()) < 1e-3 * med, k
            continue
        err = float((grads[k].grad - g).abs().max())
        assert err <= 1e-4 * max(top, med), (k, err)


def test_draws_from_the_generator_repeat(small_patch):  # noqa: F811
    b = batch()
    t = task()
    a = t.loss_fn(b, torch.Generator().manual_seed(9))[0]
    c = t.loss_fn(b, torch.Generator().manual_seed(9))[0]
    e = t.loss_fn(b, torch.Generator().manual_seed(10))[0]
    assert float(a) == float(c) != float(e)


def test_eval_forward_matches_the_reference(small_patch):  # noqa: F811
    """BatchNorm by its running statistics (moved off identity here), no
    DropPath, the orders unshuffled."""
    W = weights()
    g = torch.Generator().manual_seed(11)
    for k in W:
        if k.endswith(".mean"):
            W[k] = 0.1 * torch.randn(W[k].shape, generator=g)
        elif k.endswith(".var"):
            W[k] = 0.8 + 0.4 * torch.rand(W[k].shape, generator=g)
    b = batch(seed=4)
    t = task(W)
    got = t.forward(b)
    assert not t.model.training and got.shape == (b["feat"].shape[0], 19)
    ref = R.pyramid(b["grid_coord"], b["offset"], b["feat"])
    want = R.forward(W, ref, R.serialize(ref, [torch.arange(4)] * 5), None,
                     train=False)[ref.p2v]
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_adamw_onecycle_steps_match_the_reference(
        monkeypatch, small_patch, tmp_path):  # noqa: F811
    """Three Trainer steps: AdamW with the "block" group at its own lr,
    OneCycleLR and its beta1 cycle, against the reference's."""
    seen = _recording(monkeypatch)
    W = weights()
    t = task(W)
    trainer = Trainer(t, CFG, str(tmp_path), steps_per_epoch=20)
    groups = trainer.optimizer.param_groups
    names = {id(p): n for n, p in t.model.named_parameters()}
    assert all("block" in names[id(p)] for p in groups[1]["params"])
    assert not any("block" in names[id(p)] for p in groups[0]["params"])
    assert groups[0]["lr"] == pytest.approx(0.0002)
    assert groups[1]["lr"] == pytest.approx(0.00002)
    assert groups[0]["betas"][0] == pytest.approx(0.95)
    batches = [batch(seed=s) for s in (1, 2, 3)]
    gen = torch.Generator().manual_seed(12)
    losses = [float(trainer.train_step(b, gen)["loss"]) for b in batches]
    r_loss, r_grad, r_change = R.train_steps(
        W, batches, seen, CFG["train"]["optimizer"],
        CFG["train"]["scheduler"], 50 * 20)
    assert losses == pytest.approx(r_loss, rel=1e-5)
    med = statistics.median(r_grad.values())
    for n, p in t.model.named_parameters():
        if r_grad[n] < 1e-3 * med:
            continue    # Adam scales a rounding-only gradient up to lr
        got = float((p.detach() - W[n]).norm())
        assert got == pytest.approx(r_change[n], rel=2e-3), n
    assert trainer.schedule(3) == pytest.approx(groups[0]["lr"])


def test_adam_path_of_the_lidiff_tasks_is_unchanged(tmp_path):
    """A config with no `optimizer` keeps Adam(0.9, 0.999, 1e-8) with the
    stepped decay, stepping as torch's Adam does."""

    class Tiny:
        def __init__(self):
            self.model = torch.nn.Linear(3, 2)
            self.device = torch.device("cpu")

        def loss_fn(self, batch, generator=None):
            loss = (self.model(batch["x"]) ** 2).mean()
            return loss, {"loss": loss.detach()}

    torch.manual_seed(0)
    tiny = Tiny()
    start = {k: v.clone() for k, v in tiny.model.state_dict().items()}
    cfg = {"train": {"lr": 1e-3}}
    trainer = Trainer(tiny, cfg, str(tmp_path), steps_per_epoch=10)
    assert type(trainer.optimizer) is torch.optim.Adam
    assert trainer.optimizer.defaults["betas"] == (0.9, 0.999)
    assert trainer.optimizer.defaults["eps"] == 1e-8
    x = torch.randn(5, 3)
    for _ in range(2):
        trainer.train_step({"x": x})
    ref = torch.nn.Linear(3, 2)
    ref.load_state_dict(start)
    opt = torch.optim.Adam(ref.parameters(), lr=1e-3, betas=(0.9, 0.999),
                           eps=1e-8)
    for _ in range(2):
        opt.zero_grad()
        (ref(x) ** 2).mean().backward()
        opt.step()
    for a, b in zip(tiny.model.parameters(), ref.parameters()):
        assert torch.equal(a, b)
    assert trainer.schedule(49) == pytest.approx(1e-3)
    assert trainer.schedule(50) == pytest.approx(5e-4)


def test_train_transforms_and_mix3d_collation():
    rng = np.random.default_rng(0)
    from tests.ptv3_helpers import item
    items = []
    for i in range(2):
        d = S.train_transforms(item(rng, 900), rng)
        g = d["grid_coord"]
        assert g.min() == 0 and len(np.unique(g, axis=0)) == len(g)
        assert len(g) <= int(0.8 * 900) + 1
        assert np.all(np.abs(d["coord"][:, :2]) <= 51.2)
        d["index"] = i
        items.append(d)
    one = S.collate(items, 0.0, np.random.default_rng(1))
    assert one["offset"].tolist() == [len(items[0]["segment"]),
                                      len(items[0]["segment"])
                                      + len(items[1]["segment"])]
    mixed = S.collate(items, 1.0, np.random.default_rng(1))
    assert mixed["offset"].shape == (1,)
    n0 = len(items[0]["segment"])
    # the pair's first item is whole; a voxel both hold keeps its point
    assert np.array_equal(mixed["grid_coord"][:n0], items[0]["grid_coord"])
    assert len(np.unique(mixed["grid_coord"], axis=0)) \
        == len(mixed["grid_coord"])
    assert mixed["feat"].shape[1] == 4


def test_learning_map():
    raw = np.array([0, 10, 40, 50, 70, 71, 80, 252, 99, 81 | (7 << 16)],
                   dtype=np.uint32)
    assert S.learning_map(raw).tolist() == [-1, 0, 8, 12, 14, 15, 17, 0,
                                            -1, 18]


def _tree(root, rng, n_scans=2):
    for seq in ("00", "08"):
        d = os.path.join(root, "dataset", "sequences", seq)
        os.makedirs(os.path.join(d, "velodyne"))
        os.makedirs(os.path.join(d, "labels"))
        for i in range(n_scans):
            from tests.ptv3_helpers import item
            it = item(rng, 700)
            scan = np.c_[it["coord"], it["strength"]].astype(np.float32)
            scan.tofile(os.path.join(d, "velodyne", f"{i:06d}.bin"))
            raw = np.where(it["segment"] == 8, 40,
                           np.where(it["segment"] == 12, 50, 80))
            raw.astype(np.uint32).tofile(
                os.path.join(d, "labels", f"{i:06d}.label"))


def test_train_seg_cli(tmp_path, monkeypatch, small_patch,  # noqa: F811
                       capsys):
    """Two steps of the CLI on a tiny tree, a checkpoint, the validation's
    mean IoU; then a resume from the experiment dir that restores step 2
    (epoch 0) and trains one more step in epoch 1."""
    from lidiff_tpu_torch import train_seg
    # four scans at batch 2: two steps an epoch
    _tree(str(tmp_path / "data"), np.random.default_rng(1), n_scans=4)
    cfg = json.loads(json.dumps(CFG))
    cfg["experiment"] = {"id": "tiny"}
    cfg["data"].update(data_dir=str(tmp_path / "data"), train=["00"],
                       validation=["08"], mix_prob=0.8)
    cfg["train"].update(batch_size=2, num_workers=1, n_gpus=1, max_epoch=2)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    monkeypatch.chdir(tmp_path)
    train_seg.main(["-c", str(path), "--device", "cpu", "--max_steps", "2"])
    exp = tmp_path / "experiments" / "tiny"
    ck = exp / "checkpoints"
    assert sorted(os.listdir(ck)) == ["hparams.json", "step_00000002.pt"]
    assert "TRAINING MODE (cpu)" in capsys.readouterr().out
    task = P.SegTask(cfg, device="cpu", compute_dtype=torch.float32)
    miou = train_seg.run_validation(task, S.SegDataModule(cfg))
    assert 0.0 <= miou <= 1.0

    train_seg.main(["-c", str(path), "-ckpt", str(exp), "--max_steps", "3",
                    "--device", "cpu"])
    state = torch.load(ck / "step_00000003.pt", weights_only=True)
    assert state["step"] == 3 and state["epoch"] == 1
    assert "epoch 1: val mIoU" in capsys.readouterr().out


def test_the_shipped_config_builds_and_fixed_values_are_checked():
    """config/config_ptv3.json builds the published 46M-parameter network;
    a structural value the network fixes, set otherwise, is refused."""
    from lidiff_tpu_torch import train_seg
    cfg = train_seg.load_config(os.path.join(
        os.path.dirname(P.__file__), "..", "config", "config_ptv3.json"))
    t = P.SegTask(cfg, device="cpu", compute_dtype=torch.float32)
    n = sum(p.numel() for p in t.model.parameters())
    assert 46_000_000 < n < 46_300_000
    assert sum(1 for _, r in t.rates if r > 0) == 20
    bad = json.loads(json.dumps(cfg))
    bad["model"]["enc_depths"] = [2, 2, 2, 2, 2]
    with pytest.raises(ValueError, match="enc_depths"):
        P.SegTask(bad, device="cpu")
