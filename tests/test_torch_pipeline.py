"""The port's completion pipeline and evaluation on the CPU: the host stages
of `DiffCompletion` and the refine tiling against the JAX package's, the
pipeline CLI on tiny random-init checkpoints, `map_from_scans` and
`eval_path` on a synthetic KITTI tree against the JAX package's, the
test-mode helpers of the train CLI, and the reference-checkpoint converter.

Tolerances: the host stages, helpers, the map and each scan's ground
truth exactly (the same numpy code); the evaluation's IoU exactly and its
other metrics within 1e-6 relative (scipy in both); the refined cloud atol
2e-4, as tests/test_torch_refine.py (offsets are tanh outputs of about 60
float32 layers summed in other orders); the converter exactly."""

import functools
import json
import os
import shutil
import types

import jax
import numpy as np
import pytest
import torch

from lidiff_tpu import train as jtrain
from lidiff_tpu.config import finalize_config as jax_finalize
from lidiff_tpu.data import preprocess as jpreprocess
from lidiff_tpu.models.minkunet import MinkUNet as JaxMinkUNet
from lidiff_tpu.models.refine import RefineTask as JaxRefineTask
from lidiff_tpu.tools import convert_checkpoint as jconvert
from lidiff_tpu.tools import diff_completion_pipeline as jpipe
from lidiff_tpu.tools import eval_path as jeval
from lidiff_tpu.tools import map_from_scans as jmap
from lidiff_tpu_torch import train as ttrain
from lidiff_tpu_torch import train_refine as ttrain_refine
from lidiff_tpu_torch.config import finalize_config
from lidiff_tpu_torch.convert import flax_to_state_dict, load_jax_variables
from lidiff_tpu_torch.models.diffusion import DiffusionTask
from lidiff_tpu_torch.models.refine import RefineTask
from lidiff_tpu_torch.tools import convert_checkpoint as tconvert
from lidiff_tpu_torch.tools import diff_completion_pipeline as tpipe
from lidiff_tpu_torch.tools import eval_path, map_from_scans
from lidiff_tpu_torch.training.trainer import CheckpointManager
from lidiff_tpu_torch.utils.ply import read_ply, write_ply
from tests.helpers import make_kitti_tree
from tests.torch_parity_helpers import (one_thread, random_variables,
                                        ring_scan, to_jax)

NUM_POINTS, UP = 640, 2
CAPS = [NUM_POINTS, 512, 384, 256, 256]
# the JAX package's res_log.yaml keys (lidiff_tpu/tools/eval_path.py:114-124)
RES_KEYS = {"jsd", "jsd_noclip_3d", "rmse_mean", "rmse_std", "ious",
            "cd_mean", "cd_std", "pr", "re", "f1"}


def _scan(seed, n=3000):
    """One synthetic LiDAR scan, ranges 1.5 m to 60 m: inside and outside
    the pipeline's (3.5 m, 50 m) crop."""
    return ring_scan(np.random.default_rng(seed), n, batch=1, r_max=60.0)[0]


def test_host_stages_match_jax():
    """`preprocess_scan` (crop, FPS, tile) and `postprocess_scan` (range
    and z crop) called unbound on the same attributes, exactly (the port's
    FPS on the CPU: its host C++ copy)."""
    ns = types.SimpleNamespace(max_range=50.0, n_part=NUM_POINTS // 10,
                               device=torch.device("cpu"))
    scan = _scan(0)
    x_t = tpipe.DiffCompletion.preprocess_scan(ns, scan)
    x_j = jpipe.DiffCompletion.preprocess_scan(ns, scan)
    np.testing.assert_array_equal(x_t, x_j)
    assert x_t.shape == (1, NUM_POINTS, 3)
    completed = x_t[0] + np.random.default_rng(1).normal(
        0, 3.0, x_t[0].shape).astype(np.float32)
    post = tpipe.DiffCompletion.postprocess_scan(ns, completed, x_t)
    np.testing.assert_array_equal(
        post, jpipe.DiffCompletion.postprocess_scan(ns, completed, x_t))
    assert 0 < len(post) < NUM_POINTS


def _refine_cfg():
    return {"experiment": {"id": "pipe-refine"},
            "data": {"data_dir": "", "resolution": 0.25,
                     "num_points": NUM_POINTS},
            "train": {"up_factor": UP, "lr": 1e-3, "n_gpus": 1,
                      "batch_size": 1},
            "model": {"out_dim": 96, "cr": 0.25},
            "tpu": {"full_capacities": CAPS}}


def test_refine_tiling_matches_jax():
    """`refine`: tile the diff cloud to num_points, predict offsets, keep
    the first M rows, upsample; the same refiner weights in both."""
    cfg = _refine_cfg()
    jt = JaxRefineTask(jax_finalize(cfg))
    jt.model = JaxMinkUNet(out_channels=3 * UP, cr=0.25, remat=False)
    variables = random_variables(jt, seed=4, n_points=256)
    tt = RefineTask(finalize_config(cfg), device="cpu")
    load_jax_variables(tt.model, variables)
    points = (_scan(2, 700)[:250] * 0.2).astype(np.float32)
    jv = to_jax(variables)
    j_ns = types.SimpleNamespace(
        num_points=NUM_POINTS, refine_vars=jv,
        _refine_jit=jax.jit(lambda v, p: jt.forward(v, p)))
    t_ns = types.SimpleNamespace(num_points=NUM_POINTS, refine_task=tt,
                                 device=tt.device)
    ref = jpipe.DiffCompletion.refine(j_ns, points)
    got = tpipe.DiffCompletion.refine(t_ns, points)
    assert got.shape == ref.shape == (250 * UP, 3)
    np.testing.assert_allclose(got, ref, atol=2e-4)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Random-init diffusion and refine experiments saved by the port's
    CheckpointManager, a scans directory and a synthetic KITTI tree."""
    root = tmp_path_factory.mktemp("pipe")
    dcfg = finalize_config({
        "experiment": {"id": "pipe-diff"},
        "data": {"data_dir": "", "resolution": 0.25,
                 "num_points": NUM_POINTS, "max_range": 50.0},
        "train": {"uncond_prob": 0.1, "uncond_w": 6.0},
        "diff": {"beta_start": 3.5e-5, "beta_end": 0.007,
                 "beta_func": "linear", "t_steps": 20, "s_steps": 2,
                 "reg_weight": 5.0},
        "model": {"out_dim": 96, "cr": 0.25},
        "tpu": {"full_capacities": CAPS, "part_capacities": [128] * 5}})
    rcfg = finalize_config(_refine_cfg())
    exps = {}
    for name, task in (("diff_net", DiffusionTask(dcfg, device="cpu")),
                       ("refine_net", RefineTask(rcfg, device="cpu"))):
        exps[name] = str(root / name)
        CheckpointManager(os.path.join(exps[name], "checkpoints")).save(
            0, {"model": task.model.state_dict(), "step": 0},
            hparams=task.cfg)
    scans = root / "scans"
    scans.mkdir()
    s0 = _scan(3)
    np.concatenate([s0, np.ones((len(s0), 1), np.float32)], 1).tofile(
        str(scans / "000000.bin"))
    write_ply(str(scans / "000001.ply"), _scan(4))
    (scans / "notes.txt").write_text("not a scan")
    tree = str(root / "kitti")
    seq_dir = make_kitti_tree(tree, "00", n_scans=3, n_points=1500)
    return exps, str(scans), seq_dir, root


def test_pipeline_cli(checkpoints, capsys):
    exps, scans, _, root = checkpoints
    out = str(root / "out")
    tpipe.main(["-d", exps["diff_net"], "-r", exps["refine_net"], "-T", "2",
                "-s", "6.0", "-p", scans, "-o", out, "--device", "cpu"])
    exp = os.path.join(out, "diff_net_T2_s6.0")
    for stem in ("000000", "000001"):
        diff = read_ply(os.path.join(exp, "diff", stem + ".ply"))
        refined = read_ply(os.path.join(exp, "refine", stem + ".ply"))
        n = len(diff["points"])
        assert 0 < n <= NUM_POINTS
        assert len(refined["points"]) == UP * n
        assert np.isfinite(refined["points"]).all()
        assert refined["normals"].shape == (UP * n, 3)
    with open(os.path.join(exp, "exp_config.yaml")) as f:
        saved = json.load(f)
    assert saved["diff"]["s_steps"] == 2 and saved["train"]["uncond_w"] == 6
    said = capsys.readouterr().out
    assert said.count("refined pts") == 2 and "notes.txt" not in said


def test_pipeline_refuses_bad_arguments(checkpoints, tmp_path):
    exps, _, _, _ = checkpoints
    with pytest.raises(FileNotFoundError, match="no_such_dir"):
        tpipe.DiffCompletion(str(tmp_path / "no_such_dir"), None, 2, 6.0,
                             device="cpu")
    with pytest.raises(ValueError, match="T=20"):
        tpipe.DiffCompletion(exps["diff_net"], None, 50, 6.0, device="cpu")


def test_map_and_eval_path(checkpoints, tmp_path, monkeypatch):
    """`map_from_scans` rebuilds the JAX package's map_clean.npy exactly.
    `eval_path -p` reads the saved .ply files and rebuilds each scan's
    ground truth exactly as the JAX eval_path does, and scores them as it
    does: IoU exactly, the other metrics within 1e-6 relative (both use
    scipy), at a 10 m range where the JAX class's dense IoU histograms fit
    (200^3 bins). `eval_path -d -r` scores a live completion; both write a
    res_log.yaml with the JAX package's keys and finite values."""
    exps, _, seq_dir, _ = checkpoints
    os.remove(os.path.join(seq_dir, "map_clean.npy"))
    map_from_scans.main(["-p", os.path.dirname(seq_dir), "-s", "00"])
    seq_map = np.load(os.path.join(seq_dir, "map_clean.npy"))
    np.testing.assert_array_equal(
        seq_map, jmap.build_map(seq_dir, 0.1, progress=False))
    assert len(seq_map) and np.isfinite(seq_map).all()
    cells = np.floor(seq_map / 0.1).astype(np.int64)
    assert len(np.unique(cells, axis=0)) == len(seq_map)

    saved = tmp_path / "saved"
    saved.mkdir()
    for name in sorted(os.listdir(os.path.join(seq_dir, "velodyne"))):
        pts = np.fromfile(os.path.join(seq_dir, "velodyne", name),
                          np.float32).reshape(-1, 4)[:, :3]
        write_ply(str(saved / name.replace(".bin", ".ply")), pts[::2])
    scan0 = os.path.join(seq_dir, "velodyne", "000000.bin")
    pose0 = jpreprocess.load_poses(os.path.join(seq_dir, "calib.txt"),
                                   os.path.join(seq_dir, "poses.txt"))[0]
    for r in (50.0, 10.0):
        pred, cur = eval_path.get_scan_completion(scan0, str(saved), None, r)
        pred_j, cur_j = jeval.get_scan_completion(scan0, str(saved), None, r)
        np.testing.assert_array_equal(pred, pred_j)
        np.testing.assert_array_equal(cur, cur_j)
        gt = eval_path.get_ground_truth(pose0, cur, seq_map, r)
        np.testing.assert_array_equal(
            gt, jeval.get_ground_truth(pose0, cur_j, seq_map, r))
        assert 0 < len(gt) < len(seq_map)

    res = eval_path.main(["-p", str(saved), "--data", seq_dir])
    with open(saved / "res_log.yaml") as f:
        assert json.load(f) == res
    _check_res(res)
    assert res["ious"]["0.5"] > 0

    m = "10.0"
    monkeypatch.setattr(jeval, "CompletionIoU", functools.partial(
        jeval.CompletionIoU, max_range=float(m)))
    monkeypatch.setattr(eval_path, "CompletionIoU", functools.partial(
        eval_path.CompletionIoU, max_range=float(m)))
    jeval.main.main(["-p", str(saved), "--data", seq_dir, "-m", m],
                    standalone_mode=False)
    with open(saved / "res_log.yaml") as f:
        ref = json.load(f)
    got = eval_path.main(["-p", str(saved), "--data", seq_dir, "-m", m])
    assert got["ious"] == ref["ious"]
    assert set(got) == set(ref) == RES_KEYS
    for k in RES_KEYS - {"ious"}:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)
    assert ref["ious"]["0.5"] > 0 and ref["cd_mean"] > 0

    monkeypatch.chdir(tmp_path)
    live = eval_path.main(["-d", exps["diff_net"], "-r", exps["refine_net"],
                           "-t", "2", "--data", seq_dir, "--max_scans", "1",
                           "--device", "cpu"])
    _check_res(live)
    assert (tmp_path / "res_log.yaml").is_file()


def _check_res(res):
    assert set(res) == RES_KEYS
    assert set(res["ious"]) == {"0.5", "0.2", "0.1"}
    vals = [v for k, v in res.items() if k != "ious"] + list(
        res["ious"].values())
    assert all(np.isfinite(v) for v in vals)


def test_test_mode_helpers_match_jax(tmp_path):
    names = ["seqs/00/velodyne/000007.bin", "a/08/velodyne/000123.bin",
             "flat.bin"]
    got = ttrain._test_output_paths(str(tmp_path / "t"), names)
    ref = jtrain._test_output_paths(str(tmp_path / "j"), names)
    assert got[0] == ref[0] is False
    assert [os.path.relpath(p, tmp_path / "t") for p in got[1]] == \
        [os.path.relpath(p, tmp_path / "j") for p in ref[1]]
    for p in got[1]:
        write_ply(p, np.zeros((1, 3), np.float32))
    assert ttrain._test_output_paths(str(tmp_path / "t"), names)[0] is True

    rng = np.random.default_rng(6)
    x_init = rng.normal(0, 2, (NUM_POINTS, 3)).astype(np.float32)
    pred = rng.normal(0, 30, (NUM_POINTS, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        ttrain.postprocess_test_pred(pred, x_init, 50.0),
        jtrain.postprocess_test_pred(pred, x_init, 50.0))


def _reference_state_dict(convert_fn, model_sd, seed):
    """A synthetic reference state_dict for `convert_fn`: a first pass tags
    every key the converter reads and finds the port key its value lands
    in; the second gives each key a seeded array of that key's shape (the
    1x1 shortcut kernels are stored [in, out], the port's Linear weights
    [out, in])."""
    read = []

    class Tags(dict):
        def __getitem__(self, k):
            read.append(k)
            return np.full((27, 1, 1), float(len(read) - 1), np.float32)

        def __contains__(self, k):
            return True

        def __iter__(self):
            return iter(())

    params, stats = convert_fn(Tags())
    port_key = {}
    for k, v in flax_to_state_dict({"params": params,
                                    "batch_stats": stats}).items():
        port_key[read[int(v.reshape(-1)[0])]] = k
    assert len(port_key) == len(read) == len(model_sd)
    rng = np.random.default_rng(seed)
    sd = {}
    for ref, k in port_key.items():
        shape = tuple(model_sd[k].shape)
        if ref.endswith("downsample.0.kernel"):
            shape = shape[::-1]
        sd[ref] = rng.normal(size=shape).astype(np.float32)
    return sd


@pytest.mark.parametrize("kind", ["diffusion", "refine"])
def test_convert_checkpoint_matches_jax(kind, tmp_path):
    """The port's converter gives exactly the JAX converter's tree, in the
    port's layout, and its state_dict loads strictly into the port's
    model; the CLI writes a checkpoint the pipeline loads."""
    cfg = _refine_cfg()
    if kind == "diffusion":
        model = DiffusionTask(finalize_config({
            **cfg, "train": {"uncond_prob": 0.1, "uncond_w": 6.0},
            "diff": {"beta_start": 3.5e-5, "beta_end": 0.007,
                     "beta_func": "linear", "t_steps": 20, "s_steps": 2,
                     "reg_weight": 5.0},
            "tpu": {"full_capacities": CAPS,
                    "part_capacities": [128] * 5}}), device="cpu").model
        jfn, tfn = jconvert.convert_diffusion, tconvert.convert_diffusion
    else:
        model = RefineTask(finalize_config(cfg), device="cpu").model
        jfn, tfn = jconvert.convert_refine, tconvert.convert_refine
    sd = _reference_state_dict(tfn, model.state_dict(), seed=8)
    jp, js = jfn(sd)
    tp, ts = tfn(sd)
    jl = jax.tree_util.tree_leaves_with_path((jp, js))
    tl = jax.tree_util.tree_leaves_with_path((tp, ts))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        np.testing.assert_array_equal(a, b)
    port_sd = tconvert.convert(sd, kind)
    model.load_state_dict(port_sd, strict=True)
    # the 27-tap kernels are re-ordered, not copied
    k = next(k for k in port_sd if k.endswith("SparseConv_1.kernel"))
    assert not np.array_equal(port_sd[k].numpy(),
                              next(sd[r] for r in sd if r.endswith(
                                  "net.3.kernel")))

    ckpt = str(tmp_path / "ref.ckpt")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in
                               sd.items()}, "hyper_parameters": cfg}, ckpt)
    tconvert.main(["--ckpt", ckpt, "--out", str(tmp_path / "exp"),
                   "--kind", kind])
    state, step = CheckpointManager(
        str(tmp_path / "exp" / "checkpoints")).restore()
    assert step == 0
    model.load_state_dict(state["model"], strict=True)


class _Built(Exception):
    """Raised once an entry point has built its task or pipeline."""


def _stop_when_built(monkeypatch, module, name: str, built: list) -> None:
    """Replace `module.name` by a subclass that records the built object in
    `built` and stops the entry point there."""
    cls = getattr(module, name)

    class Stop(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)
            raise _Built

    monkeypatch.setattr(module, name, Stop)


def _with_dtype(exps: dict, root, dtype: str) -> dict:
    """Copies of the experiments whose hparams say `tpu.compute_dtype:
    dtype`."""
    out = {}
    for name, src in exps.items():
        out[name] = str(root / name)
        shutil.copytree(src, out[name])
        path = os.path.join(out[name], "checkpoints", "hparams.json")
        with open(path) as f:
            hp = json.load(f)
        hp["tpu"]["compute_dtype"] = dtype
        with open(path, "w") as f:
            json.dump(hp, f)
    return out


@pytest.mark.parametrize("entry", ["train", "train_refine", "pipeline",
                                   "eval_path"])
@pytest.mark.parametrize("env, in_config, want", [
    ("bf16", "float32", torch.bfloat16), (None, "bfloat16", torch.float32)],
    ids=["variable-bf16", "config-bf16"])
def test_entry_points_take_the_compute_dtype_from_env(
        entry, env, in_config, want, checkpoints, tmp_path, monkeypatch,
        one_thread):
    """Every entry point computes in the dtype LIDIFF_COMPUTE_DTYPE names,
    as the JAX package does (lidiff_tpu/ops/sparse_conv.py:35-37), whatever
    the config's (or the checkpoint's) `tpu.compute_dtype` says: the
    shipped float32 config with the variable set to bf16 gives bfloat16,
    and a config saying bfloat16 without the variable float32. The entry
    point stops once its task is built."""
    if env is None:
        monkeypatch.delenv("LIDIFF_COMPUTE_DTYPE", raising=False)
    else:
        monkeypatch.setenv("LIDIFF_COMPUTE_DTYPE", env)
    built = []
    if entry in ("train", "train_refine"):
        module, task_cls, shipped = {
            "train": (ttrain, "DiffusionTask", "config.json"),
            "train_refine": (ttrain_refine, "RefineTask",
                             "config_refine.json")}[entry]
        with open(os.path.join(os.path.dirname(ttrain.__file__), "config",
                               shipped)) as f:
            cfg = json.load(f)
        assert cfg["tpu"]["compute_dtype"] == "float32"
        cfg["tpu"]["compute_dtype"] = in_config
        path = str(tmp_path / "cfg.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        _stop_when_built(monkeypatch, module, task_cls, built)
        with pytest.raises(_Built):
            module.main(["-c", path, "--device", "cpu"])
        assert built[0].compute_dtype is want
        return
    exps = _with_dtype(checkpoints[0], tmp_path, in_config)
    module = tpipe if entry == "pipeline" else eval_path
    _stop_when_built(monkeypatch, module, "DiffCompletion", built)
    argv = (["-d", exps["diff_net"], "-r", exps["refine_net"], "-T", "2",
             "-p", checkpoints[1], "-o", str(tmp_path / "out")]
            if entry == "pipeline" else
            ["-d", exps["diff_net"], "-r", exps["refine_net"], "-t", "2",
             "--data", checkpoints[2]])
    with pytest.raises(_Built):
        module.main(argv + ["--device", "cpu"])
    dc = built[0]
    assert dc.task.compute_dtype is want
    assert dc.refine_task.compute_dtype is want


def test_sample_chunk_from_env(checkpoints, monkeypatch, one_thread):
    """`complete_scan` samples through `sample_chunked` with the chunk that
    LIDIFF_SAMPLE_CHUNK names (default 10, as in lidiff_tpu's pipeline):
    chunks of 1 give the same clouds as the default's one chunk of 10 (2
    steps and 8 past the end)."""
    exps, scans, _, _ = checkpoints
    scan = tpipe.load_pcd(os.path.join(scans, "000000.bin"))
    out, chunks = {}, {}
    for env in ("1", None):
        if env is None:
            monkeypatch.delenv("LIDIFF_SAMPLE_CHUNK", raising=False)
        else:
            monkeypatch.setenv("LIDIFF_SAMPLE_CHUNK", env)
        dc = tpipe.DiffCompletion(exps["diff_net"], exps["refine_net"], 2,
                                  6.0, device="cpu")

        def spy(*args, _env=env, _fn=dc.task.sample_chunked, **kwargs):
            chunks[_env] = kwargs["chunk"]
            return _fn(*args, **kwargs)
        dc.task.sample_chunked = spy
        out[env] = dc.complete_scan(scan)
    assert chunks == {"1": 1, None: 10}
    for got, want in zip(out["1"], out[None]):
        np.testing.assert_array_equal(got, want)
    assert len(out[None][1]) > 0
