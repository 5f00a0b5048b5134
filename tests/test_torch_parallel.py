"""Data parallelism of the port on the CPU: two gloo ranks, started once for
the module by `mesh.launch` with an explicit world of two, each with one
thread. Every rank runs, in this order:

  * `masked_moments` over the group, with one rank whose mask is all
    False: it must equal the one-process moments of the joined rows and
    JAX's `masked_moments` (no axis) on them, and its gradient through the
    group's all-reduce the one-process gradient of the joined rows;
  * one diffusion training step through `Trainer.train_step` on its two
    rows of a batch of four, with the JAX package's draws for its replica
    and the classifier-free coin set on rank 0 alone: loss, metrics, every
    gradient and the BN running statistics must equal those of
    `lidiff_tpu.parallel.mesh.build_train_step` on two host devices with
    the same weights and rows (each replica's loss, coin and mean/std
    regularizer its own, BN synced, gradients averaged);
  * the same step with `tpu.remat` on (each recomputed stage all-reduces
    its BN moments again in the backward pass, on every rank in the same
    order), against the same JAX step: remat changes no value in either
    package (tests/test_torch_remat.py holds the port's remat against
    JAX's), so one JAX compile serves both;
  * one step of the `train` CLI's rank function on a KITTI tree with a
    batch of two: rank 0 alone writes the hparams and the checkpoint.

`DiffCompletion.complete_scans(devices=["cpu", "cpu"])` on three scans (the
second group padded) must equal `complete_scan` with each replica's
generator, and the pipeline CLI over two devices must write what
`complete_scans` returns.

Tolerances: the moments rtol 1e-5 (float32 sums over other splits); the
training step's loss and metrics rtol 1e-4, each gradient within 2e-3 of
that leaf's max|grad| plus 1e-4 of the largest, the running statistics
atol 1e-4 (tests/test_torch_train_model.py: about 100 float32 layers
forward and backward, summed in other orders); complete_scans exactly (the
same code on the same device and generator).

The rank function imports nothing of JAX, so a spawned rank starts with
torch and the port alone.
"""

import json
import os

import numpy as np
import pytest
import torch

from lidiff_tpu_torch.parallel import mesh

WORLD = 2
ROWS = 2                                 # each rank's rows of the batch
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-4
# the JAX step's key; replica r draws from fold_in(KEY, r). A ReLU input
# within float32 rounding of zero would take the other side of the kink in
# one package (tests/test_torch_train_model.py); this key gives none.
KEY = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many small tensor ops, which a
    thread pool slows down many times over when the test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moments(rank, world, group, feats, mask, weights):
    from lidiff_tpu_torch.ops.sparse_conv import masked_moments
    f = torch.from_numpy(feats[rank]).requires_grad_(True)
    mean, var, cnt = masked_moments(f, torch.from_numpy(mask[rank]), group)
    w1, w2 = torch.from_numpy(weights[0]), torch.from_numpy(weights[1])
    # each rank's share of one objective of the global moments: its rows'
    # gradient is then that objective's, as for a loss averaged over ranks
    (((mean * w1).sum() + (var * w2).sum()) / world).backward()
    return mean.detach(), var.detach(), cnt.detach(), f.grad


def _train_step(rank, world, group, exp_dir, cfg, state, full, part,
                draws):
    """One Trainer step on this rank's rows with its replica's draws;
    returns the metrics, every gradient and the BN running statistics
    after the step."""
    from lidiff_tpu_torch.config import finalize_config
    from lidiff_tpu_torch.models.diffusion import DiffusionTask
    from lidiff_tpu_torch.training.trainer import Trainer
    cfg = finalize_config(cfg)
    task = DiffusionTask(cfg, device="cpu", group=group)
    task.model.load_state_dict(state, strict=True)
    trainer = Trainer(task, cfg, exp_dir, group=group)
    rows = mesh.rank_slice(len(full), rank, world)
    noise, t, drop = draws[rank]
    batch = {"pcd_full": torch.from_numpy(full[rows]),
             "pcd_part": torch.from_numpy(part[rows])}
    metrics = trainer.train_step(batch, noise=torch.from_numpy(noise),
                                 t=torch.from_numpy(t), drop=drop)
    grads = {n: p.grad.clone() for n, p in task.model.named_parameters()}
    stats = {n: b.clone() for n, b in task.model.named_buffers()}
    return {k: float(v) for k, v in metrics.items()}, grads, stats


def _train_cli(rank, world, group, device, cli_dir, cfg_path):
    """One step of the `train` CLI's rank function, as `main` runs it on
    each card; returns what its experiment directory holds."""
    from lidiff_tpu_torch import train as train_mod
    from lidiff_tpu_torch.config import load_config
    args = train_mod._parser().parse_args(
        ["-c", cfg_path, "--max_steps", "1", "--device", "cpu"])
    os.chdir(cli_dir)
    train_mod._run(rank, world, group, device, args, load_config(cfg_path))


def _rank_main(rank, world, group, device, out_dir, inputs):
    torch.set_num_threads(1)
    cfg, *rest = inputs["step"]
    remat_cfg = {**cfg, "tpu": {**cfg["tpu"], "remat": True}}
    result = {"moments": _moments(rank, world, group, *inputs["moments"]),
              "step": _train_step(rank, world, group,
                                  os.path.join(out_dir, f"exp{rank}"),
                                  *inputs["step"]),
              "remat_step": _train_step(
                  rank, world, group,
                  os.path.join(out_dir, f"exp_remat{rank}"), remat_cfg,
                  *rest)}
    _train_cli(rank, world, group, device, *inputs["cli"])
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


# --------------------------------------------------------------- inputs

def _moments_inputs():
    rng = np.random.default_rng(0)
    C = 5
    feats = rng.normal(2, 3, (WORLD, 48, C)).astype(np.float32)
    mask = rng.random((WORLD, 48)) > 0.3
    mask[1] = False                          # a rank with no valid row
    weights = rng.normal(size=(2, C)).astype(np.float32)
    return feats, mask, weights


def _cli_inputs(root):
    """A KITTI tree and the `train` CLI's config (a batch of two) under
    `root`; returns the CLI's working directory and the config's path."""
    from tests.helpers import make_kitti_tree
    tree = str(root / "kitti")
    make_kitti_tree(tree, "00", n_scans=4, n_points=1500)
    cfg = {
        "experiment": {"id": "two_ranks"},
        "data": {"data_dir": tree, "resolution": 0.1, "dataloader": "KITTI",
                 "split": "train", "train": ["00"], "validation": ["00"],
                 "test": [], "num_points": 512, "max_range": 50.0,
                 "dataset_norm": False, "std_axis_norm": False},
        "train": {"uncond_prob": 0.1, "uncond_w": 6.0, "n_gpus": WORLD,
                  "num_workers": 1, "max_epoch": 2, "lr": 1e-3,
                  "batch_size": WORLD, "decay_lr": 1e-4},
        "diff": {"beta_start": 3.5e-5, "beta_end": 0.007,
                 "beta_func": "linear", "t_steps": 50, "s_steps": 2,
                 "reg_weight": 5.0},
        "model": {"out_dim": 96, "cr": 0.25},
        "tpu": {"full_capacities": [512, 256, 256, 256, 256],
                "part_capacities": [64] * 5}}
    cfg_path = str(root / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    cli_dir = root / "cli"
    cli_dir.mkdir()
    return str(cli_dir), cfg_path


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results of `_rank_main`, the CLI's directory, the draws
    of the training step and the JAX package's step on the same inputs.

    The JAX step runs on two host devices with an 'optimizer' that leaves
    the parameters as they are and keeps the averaged gradients as its
    state; it compiles here while the two ranks run. The coin's threshold
    lies between the two replicas' draws, so replica 0 drops the
    conditioning and replica 1 keeps it."""
    import threading

    import jax
    import jax.numpy as jnp
    import optax

    from lidiff_tpu.config import finalize_config as jax_finalize
    from lidiff_tpu.models.diffusion import DiffusionTask as JaxTask
    from lidiff_tpu.parallel import mesh as pmesh
    from lidiff_tpu_torch.convert import flax_to_state_dict
    from tests.torch_parity_helpers import CFG, NP, TILE, random_variables, \
        ring_scan, to_jax

    cfg = {**CFG, "tpu": {**CFG["tpu"], "remat": False},
           "train": {**CFG["train"], "lr": 1e-4, "n_gpus": WORLD,
                     "batch_size": WORLD * ROWS}}
    variables = random_variables(JaxTask(jax_finalize(cfg)), seed=5)
    rng = np.random.default_rng(8)
    part = ring_scan(rng, NP, batch=WORLD * ROWS)
    full = (np.tile(part, (1, TILE, 1))
            + rng.normal(0, 0.05, (WORLD * ROWS, NP * TILE, 3))
            ).astype(np.float32)

    jt = JaxTask(jax_finalize(cfg), axis_name=pmesh.DATA_AXIS)
    key = jax.random.PRNGKey(KEY)
    draws, coins = [], []
    for r in range(WORLD):                 # replica_step's own draws
        k_noise, k_t, k_drop = jax.random.split(jax.random.fold_in(key, r),
                                                3)
        draws.append((np.array(jax.random.normal(k_noise, (ROWS,) +
                                                 full.shape[1:])),
                      np.array(jax.random.randint(k_t, (ROWS,), 0,
                                                  jt.coeffs.t_steps))))
        coins.append(float(jax.random.uniform(k_drop, ())))
    assert coins[0] < coins[1]
    jt.uncond_prob = (coins[0] + coins[1]) / 2
    draws = [(n, t, coins[r] < jt.uncond_prob)
             for r, (n, t) in enumerate(draws)]
    state = {k: torch.as_tensor(np.asarray(v))
             for k, v in flax_to_state_dict(variables).items()}

    root = tmp_path_factory.mktemp("ranks")
    inputs = {"moments": _moments_inputs(),
              "step": (cfg, state, full, part, draws),
              "cli": _cli_inputs(root)}
    failed = []

    def run_ranks():
        try:
            mesh.launch(_rank_main, WORLD, "cpu", str(root), inputs)
        except BaseException as e:          # re-raised below
            failed.append(e)

    thread = threading.Thread(target=run_ranks)
    thread.start()
    try:
        keep_grads = optax.GradientTransformation(
            lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
            lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g),
                                  g))
        m = pmesh.make_mesh(WORLD)
        step = pmesh.build_train_step(jt.loss_fn, keep_grads, m,
                                      donate=False)
        jv = to_jax(variables)
        _, grads, stats, metrics = step(
            pmesh.replicate(m, jv["params"]),
            pmesh.replicate(m, keep_grads.init(jv["params"])),
            pmesh.replicate(m, jv["batch_stats"]),
            pmesh.shard_batch(m, {"pcd_full": jnp.asarray(full),
                                  "pcd_part": jnp.asarray(part)}), key)
        ref = (jax.tree_util.tree_map(np.asarray, grads),
               jax.tree_util.tree_map(np.asarray, stats),
               {k: float(v) for k, v in metrics.items()})
    finally:
        thread.join()
    if failed:
        raise failed[0]
    res = [torch.load(root / f"rank{r}.pt", weights_only=False)
           for r in range(WORLD)]
    return {"ranks": res, "cli_dir": root / "cli", "draws": draws,
            "jax": ref}


# ---------------------------------------------------------------- moments

def test_masked_moments_over_ranks(ranks):
    import jax.numpy as jnp

    from lidiff_tpu.ops.sparse_conv import masked_moments as jax_moments
    from lidiff_tpu_torch.ops.sparse_conv import masked_moments
    feats, mask, weights = _moments_inputs()
    C = feats.shape[-1]
    joined = torch.from_numpy(feats.reshape(-1, C)).requires_grad_(True)
    jmask = torch.from_numpy(mask.reshape(-1))
    mean, var, cnt = masked_moments(joined, jmask)
    w1, w2 = torch.from_numpy(weights[0]), torch.from_numpy(weights[1])
    ((mean * w1).sum() + (var * w2).sum()).backward()
    j_mean, j_var, j_cnt = jax_moments(jnp.asarray(feats.reshape(-1, C)),
                                       jnp.asarray(mask.reshape(-1)))
    assert float(cnt) == float(j_cnt) == mask.sum()
    res = [r["moments"] for r in ranks["ranks"]]
    for r, (m, v, c, g) in enumerate(res):
        assert float(c) == float(cnt)
        np.testing.assert_allclose(m, mean.detach(), rtol=1e-5)
        np.testing.assert_allclose(v, var.detach(), rtol=1e-5)
        np.testing.assert_allclose(m, np.asarray(j_mean), rtol=1e-5)
        np.testing.assert_allclose(v, np.asarray(j_var), rtol=1e-5)
        np.testing.assert_allclose(g, joined.grad[r * 48:(r + 1) * 48],
                                   rtol=1e-5, atol=1e-7)
    assert not res[1][3].any()               # masked rows get no gradient


# ---------------------------------------------------------- training step

def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_train_step_over_ranks(ranks):
    _check_step_over_ranks(ranks, "step")


def test_remat_train_step_over_ranks(ranks):
    """The step with remat on (synced BN recomputed in the backward pass)
    against JAX's `build_train_step`."""
    _check_step_over_ranks(ranks, "remat_step")
    # the same running statistics as without remat: the recompute leaves
    # them alone
    for r in ranks["ranks"]:
        for n, b in r["step"][2].items():
            assert torch.equal(r["remat_step"][2][n], b), n


def _check_step_over_ranks(ranks, which):
    from lidiff_tpu_torch.convert import state_dict_to_flax
    j_grads, j_stats, j_metrics = ranks["jax"]
    assert [d[2] for d in ranks["draws"]] == [True, False]
    res = [r[which] for r in ranks["ranks"]]
    ref = dict(_leaves(j_grads))
    top = max(np.abs(r).max() for r in ref.values())
    assert top > 1e-2
    for rank, (metrics, grads, stats) in enumerate(res):
        assert set(metrics) == set(j_metrics)
        for k, v in j_metrics.items():
            np.testing.assert_allclose(metrics[k], v, rtol=1e-4, atol=1e-6,
                                       err_msg=k)
        got = dict(_leaves(state_dict_to_flax(grads)["params"]))
        assert set(got) == set(ref)
        worst = max((np.abs(got[n] - r).max()
                     / (GRAD_RTOL * np.abs(r).max() + GRAD_ATOL * top), n)
                    for n, r in ref.items())
        print(f"{which}, rank {rank}: worst gradient leaf at {worst[0]:.3f} "
              f"of its tolerance ({worst[1]}), max|grad| {top:.3g}")
        assert worst[0] <= 1.0, worst
        got_s = dict(_leaves(state_dict_to_flax(stats)["batch_stats"]))
        ref_s = dict(_leaves(j_stats))
        assert set(got_s) == set(ref_s)
        for n, r in ref_s.items():
            np.testing.assert_allclose(got_s[n], r, rtol=1e-4, atol=1e-4,
                                       err_msg=n)
    for n in res[0][1]:                     # every rank the same gradient
        assert torch.equal(res[0][1][n], res[1][1][n])


def test_train_cli_two_ranks(ranks):
    """The `train` CLI's rank function on two gloo ranks (each on its row
    of a batch of two) takes a step; rank 0 alone writes the hparams and
    the checkpoint."""
    exp = ranks["cli_dir"] / "experiments" / "two_ranks"
    assert sorted(os.listdir(exp)) == ["checkpoints", "hparams.json", "tb"]
    ckpts = exp / "checkpoints"
    assert sorted(os.listdir(ckpts)) == ["hparams.json", "step_00000001.pt"]
    state = torch.load(ckpts / "step_00000001.pt", weights_only=True)
    assert state["step"] == 1 and state["epoch"] == 0


# ---------------------------------------------------- sharded completion

NUM_POINTS, UP = 640, 2
CAPS = [NUM_POINTS, 512, 384, 256, 256]


def _scan(seed, n=2000):
    rng = np.random.default_rng(seed)
    az, r = rng.uniform(0, 2 * np.pi, n), rng.uniform(1.5, 30.0, n)
    el = rng.choice(np.linspace(-0.4, 0.05, 16), n)
    return np.stack([r * np.cos(az) * np.cos(el), r * np.sin(az) * np.cos(el),
                     r * np.sin(el)], -1).astype(np.float32)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Random-init diffusion and refine experiments as the trainers save
    them (tests/test_torch_pipeline.py's configuration)."""
    from lidiff_tpu_torch.config import finalize_config
    from lidiff_tpu_torch.models.diffusion import DiffusionTask
    from lidiff_tpu_torch.models.refine import RefineTask
    from lidiff_tpu_torch.training.trainer import CheckpointManager
    root = tmp_path_factory.mktemp("shard")
    dcfg = finalize_config({
        "experiment": {"id": "shard-diff"},
        "data": {"data_dir": "", "resolution": 0.25,
                 "num_points": NUM_POINTS, "max_range": 50.0},
        "train": {"uncond_prob": 0.1, "uncond_w": 6.0},
        "diff": {"beta_start": 3.5e-5, "beta_end": 0.007,
                 "beta_func": "linear", "t_steps": 20, "s_steps": 2,
                 "reg_weight": 5.0},
        "model": {"out_dim": 96, "cr": 0.25},
        "tpu": {"full_capacities": CAPS, "part_capacities": [128] * 5}})
    rcfg = finalize_config({
        "experiment": {"id": "shard-refine"},
        "data": {"data_dir": "", "resolution": 0.25,
                 "num_points": NUM_POINTS},
        "train": {"up_factor": UP, "lr": 1e-3, "n_gpus": 1, "batch_size": 1},
        "model": {"out_dim": 96, "cr": 0.25},
        "tpu": {"full_capacities": CAPS}})
    exps = {}
    for name, task in (("diff_net", DiffusionTask(dcfg, device="cpu",
                                                  seed=1)),
                       ("refine_net", RefineTask(rcfg, device="cpu",
                                                 seed=2))):
        exps[name] = str(root / name)
        CheckpointManager(os.path.join(exps[name], "checkpoints")).save(
            0, {"model": task.model.state_dict(), "step": 0},
            hparams=task.cfg)
    return exps


def test_complete_scans_over_two_devices(checkpoints):
    """Three scans over two replicas: scans 0 and 2 on replica 0, scan 1
    and the padding (scan 2 again) on replica 1, at once; each output
    equals `complete_scan` of a pipeline with that replica's generator."""
    from lidiff_tpu_torch.tools.diff_completion_pipeline import DiffCompletion

    def pipeline():
        return DiffCompletion(checkpoints["diff_net"],
                              checkpoints["refine_net"], 2, 6.0, seed=7,
                              device="cpu")

    scans = [_scan(s) for s in (3, 4, 5)]
    got = pipeline().complete_scans(scans, devices=["cpu", "cpu"])
    assert len(got) == 3
    refs = []
    for j in range(2):
        ref = pipeline()
        ref.generator = mesh.rank_generator(7, j, "cpu")
        refs.append(ref)
    want = [refs[0].complete_scan(scans[0]), refs[1].complete_scan(scans[1]),
            refs[0].complete_scan(scans[2])]
    for i, ((r_got, d_got), (r_want, d_want)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(d_got, d_want, err_msg=f"scan {i}")
        np.testing.assert_array_equal(r_got, r_want, err_msg=f"scan {i}")
        assert len(r_got) == UP * len(d_got) > 0
    # replica 0 draws what a fresh pipeline draws: its first scan is the
    # one-device loop's first
    np.testing.assert_array_equal(pipeline().complete_scans(scans[:1])[0][1],
                                  want[0][1])


def test_pipeline_cli_over_two_devices(checkpoints, tmp_path, monkeypatch,
                                       capsys):
    """The pipeline CLI with two devices (`_devices` patched to two CPU
    replicas) on three scans: one "s/scan" line per scan, and .ply outputs
    equal to those of `complete_scans(devices=["cpu", "cpu"])` called on
    each group of two, as lidiff_tpu's main calls it (the last group, one
    scan, is the pipeline's own `complete_scan`, as in lidiff_tpu's
    `complete_scans`)."""
    from lidiff_tpu_torch.tools import diff_completion_pipeline as tpipe
    from lidiff_tpu_torch.utils.ply import read_ply
    scans = [_scan(s) for s in (3, 4, 5)]
    scan_dir = tmp_path / "scans"
    scan_dir.mkdir()
    names = [f"{i:06d}.bin" for i in range(3)]
    for name, s in zip(names, scans):
        np.concatenate([s, np.ones((len(s), 1), np.float32)], 1).tofile(
            str(scan_dir / name))
    monkeypatch.setattr(tpipe, "_devices", lambda dc: ["cpu", "cpu"])
    out = tmp_path / "out"
    tpipe.main(["-d", checkpoints["diff_net"], "-r",
                checkpoints["refine_net"], "-T", "2", "-s", "6.0", "-p",
                str(scan_dir), "-o", str(out), "--device", "cpu"])
    lines = [l for l in capsys.readouterr().out.splitlines()
             if "s/scan" in l]
    assert [l.split(":")[0] for l in lines] == names
    ref = tpipe.DiffCompletion(checkpoints["diff_net"],
                               checkpoints["refine_net"], 2, 6.0,
                               device="cpu")
    want = [r for i0 in (0, 2)
            for r in ref.complete_scans(scans[i0:i0 + 2], ["cpu", "cpu"])]
    exp = out / "diff_net_T2_s6.0"
    for name, line, (r_want, d_want) in zip(names, lines, want):
        stem = name.split(".")[0]
        diff = read_ply(str(exp / "diff" / f"{stem}.ply"))["points"]
        refined = read_ply(str(exp / "refine" / f"{stem}.ply"))["points"]
        np.testing.assert_array_equal(diff, d_want, err_msg=name)
        np.testing.assert_array_equal(refined, r_want, err_msg=name)
        assert len(refined) == UP * len(diff) > 0
        assert f"({len(diff)} diff pts, {len(refined)} refined pts)" in line


def test_init_ranks_defaults_to_the_card(tmp_path):
    """`init_ranks` with no device means the card, as every entry point
    does, and raises without one; "cpu" still joins a gloo group."""
    import torch.distributed as dist
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.init_ranks(0, 1, mesh.file_init_method(str(tmp_path)))
    assert not dist.is_initialized()
    group = mesh.init_ranks(0, 1, mesh.file_init_method(str(tmp_path)), "cpu")
    try:
        assert dist.get_backend(group) == "gloo"
        assert mesh.world_of(group) == 1 and mesh.rank_of(group) == 0
    finally:
        mesh.shutdown()
    assert not dist.is_initialized()
