"""A tiny PTv3 set-up shared by the PTv3 CPU tests: two street-like items
of about 600 points through Pointcept's train transforms, the published
layer pattern at cut widths (tests only), patches of 64, and the plain
reference's weights."""

import numpy as np
import pytest
import torch

from benchmark.reference import ptv3 as R
from lidiff_tpu_torch.data import seg as S
from lidiff_tpu_torch.models import ptv3 as P
from lidiff_tpu_torch.ops import serialize

ENC = [16, 16, 32, 32, 32]
DEC = [16, 16, 32, 32]
CFG = {"model": {"enc_channels": ENC, "dec_channels": DEC,
                 "enc_num_head": [1, 1, 2, 2, 2],
                 "dec_num_head": [1, 1, 2, 2]},
       "data": {"ignore_index": -1},
       "tpu": {"full_capacities": [2048] * 5},
       "train": {"max_epoch": 50,
                 "optimizer": {"type": "AdamW", "lr": 0.002,
                               "weight_decay": 0.005,
                               "param_groups": [{"keyword": "block",
                                                 "lr": 0.0002}]},
                 "scheduler": {"type": "OneCycleLR",
                               "max_lr": [0.002, 0.0002],
                               "pct_start": 0.04, "anneal_strategy": "cos",
                               "div_factor": 10.0,
                               "final_div_factor": 100.0}}}
PATCH = 64


def item(rng, n=620):
    """Ground, a wall and a post, with labels road/building/pole."""
    g = np.c_[rng.uniform(-4, 4, (n // 2, 2)), rng.normal(-1.7, 0.01,
                                                         n // 2)]
    w = np.c_[rng.uniform(-4, 4, n // 3), rng.normal(3.0, 0.01, n // 3),
              rng.uniform(-1.7, 1.0, n // 3)]
    k = n - len(g) - len(w)
    p = np.c_[rng.normal(1.0, 0.05, (k, 2)), rng.uniform(-1.7, 1.5, k)]
    coord = np.concatenate([g, w, p]).astype(np.float32)
    seg = np.r_[np.full(len(g), 8), np.full(len(w), 12), np.full(k, 17)]
    seg[rng.random(n) < 0.05] = -1
    return {"coord": coord, "strength": rng.random((n, 1)).astype(
        np.float32), "segment": seg.astype(np.int64)}


def batch(seed=0, mix_prob=0.0, items=2):
    rng = np.random.default_rng(seed)
    its = []
    for i in range(items):
        d = S.train_transforms(item(rng), rng)
        d["index"] = i
        its.append(d)
    b = S.collate(its, mix_prob, np.random.default_rng(seed + 1))
    return {k: torch.from_numpy(v) for k, v in b.items()}


def weights(seed=5):
    return R.make_weights(R.shapes(enc=ENC, dec=DEC),
                          torch.Generator().manual_seed(seed), "cpu")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: a tiny model's thread-pool hand-offs cost more
    than its work when the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def small_patch(monkeypatch):
    monkeypatch.setattr(serialize, "MAX_PATCH", PATCH)
    monkeypatch.setattr(R, "MAX_PATCH", PATCH)


def task(W=None):
    t = P.SegTask(CFG, device="cpu", compute_dtype=torch.float32)
    t.model.load_state_dict(W if W is not None else weights())
    return t
