"""The LiDiff diffusion task (counterpart of
lidiff_tpu/models/diffusion.py:35-354).

Training: `loss_fn` noises the offsets around the anchor points at a random
timestep per item, drops the conditioning for the whole batch with
probability `uncond_prob`, runs the train-mode model and returns the noise
prediction's MSE plus the mean/std regularizer.

Classifier-free completion sampling: the partial-scan encoder runs once per
completion for the conditioned bank and for the unconditioned (zeros) bank,
then every solver step re-voxelizes the moving cloud into one pyramid and
runs the cond and uncond denoiser streams over it: fused as G=2 groups in
one forward, or with the config's `tpu.fuse_classfree: false` as two G=1
forwards (lidiff_tpu/models/diffusion.py:106,207-218).
`sample` runs the solver loop of `make_chunked_sampler` in one chunk.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from lidiff_tpu_torch import resolve_device
from lidiff_tpu_torch.config import compute_dtype_from_env
from lidiff_tpu_torch.diffusion.ddpm import make_ddpm, q_sample
from lidiff_tpu_torch.diffusion.dpm_solver import (DPMSolver, init_state,
                                                   make_dpm_solver,
                                                   solver_step)
from lidiff_tpu_torch.models.blocks import init_weights, set_bn_group
from lidiff_tpu_torch.models.minkunet import MinkGlobalEnc, MinkUNetDiff
from lidiff_tpu_torch.ops.grid import Pyramid, build_pyramid
from lidiff_tpu_torch.utils import prof


class DiffusionModel(nn.Module):
    """Partial-scan encoder + conditional denoiser; parameter names follow
    the JAX tree (`partial_enc`, `denoiser`). `remat`: both recompute their
    stages' activations in the backward pass (`blocks.remat`)."""

    def __init__(self, out_dim: int = 96, cr: float = 1.0,
                 compute_dtype=torch.float32, conv_quant: bool = False,
                 remat: bool = True):
        super().__init__()
        self.partial_enc = MinkGlobalEnc(cr, compute_dtype, conv_quant,
                                         remat)
        self.denoiser = MinkUNetDiff(out_dim, cr, compute_dtype, conv_quant,
                                     remat)

    def encode_partial(self, pyr_part: Pyramid):
        return self.partial_enc(pyr_part)

    def denoise(self, pyr_full: Pyramid, banks, t):
        return self.denoiser(pyr_full, banks, t)

    def forward(self, pyr_full: Pyramid, pyr_part: Pyramid, t):
        """Encode the partial scan and denoise against it (G=1)."""
        part_feats = self.encode_partial(pyr_part)
        return self.denoise(pyr_full,
                            [(part_feats, pyr_part.levels[-1].geom)], t)


def eval_no_grad(method):
    """Run a task's method with the model in eval mode and autograd
    off, and restore the model's mode afterwards: sampling after training
    must not update the BatchNorm running statistics."""
    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                return method(self, *args, **kwargs)
        finally:
            self.model.train(was_training)
    return wrapper


class DiffusionTask:
    """Config, model, the training loss and the sampling entry points.

    Runs on `device` (default: the card) with `compute_dtype` (default: the
    one LIDIFF_COMPUTE_DTYPE names, `config.compute_dtype_from_env`; the
    config's `tpu.compute_dtype` is not read). The weights are a seeded
    random init (`seed`); `lidiff_tpu_torch.convert.load_jax_variables`
    replaces them with a JAX checkpoint's. `group`, a torch.distributed
    process group, syncs the training BatchNorm moments over its ranks
    (None: this process alone); the rest of the loss, the classifier-free
    coin and the mean/std regularizer included, is each rank's own on its
    rows, as each replica's is in lidiff_tpu/parallel/mesh.py. `conv_quant`
    selects the int8 eval conv (kernel A4) for sampling; training never
    quantizes. The config's `tpu.remat` (default True, as
    lidiff_tpu/models/diffusion.py:93 reads it) recomputes the stages'
    activations in the backward pass of training. Its `tpu.fuse_classfree`
    (default True) runs the guided pair of `denoise_pair` as one G=2
    forward; False runs two G=1 forwards."""

    def __init__(self, cfg, device=None, compute_dtype=None, seed: int = 0,
                 conv_quant: bool = False, group=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if compute_dtype is None:
            compute_dtype = compute_dtype_from_env()
        self.compute_dtype = compute_dtype
        d = cfg["diff"]
        self.coeffs = make_ddpm(d["beta_func"], d["t_steps"],
                                d.get("beta_start"), d.get("beta_end"),
                                device=self.device)
        self.solver = make_dpm_solver(d["beta_func"], d["t_steps"],
                                      d["s_steps"], d.get("beta_start"),
                                      d.get("beta_end"),
                                      algorithm=d.get("solver",
                                                      "sde-dpmsolver++"),
                                      device=self.device)
        self.model = DiffusionModel(out_dim=cfg["model"]["out_dim"],
                                    cr=float(cfg["model"].get("cr", 1.0)),
                                    compute_dtype=compute_dtype,
                                    conv_quant=conv_quant,
                                    remat=bool(cfg["tpu"].get("remat",
                                                              True)))
        init_weights(self.model, torch.Generator().manual_seed(seed))
        set_bn_group(self.model, group)
        self.model.to(self.device).eval()
        self.resolution = float(cfg["data"]["resolution"])
        self.full_caps = list(cfg["tpu"]["full_capacities"])
        self.part_caps = list(cfg["tpu"]["part_capacities"])
        self.num_levels = int(cfg["tpu"]["num_levels"])
        self.w_uncond = float(cfg["train"]["uncond_w"])
        self.uncond_prob = float(cfg["train"]["uncond_prob"])
        self.reg_weight = float(cfg["diff"]["reg_weight"])
        self.fuse_classfree = bool(cfg["tpu"].get("fuse_classfree", True))

    # ---------------- geometry ----------------

    def pyramid_full(self, points) -> Pyramid:
        return build_pyramid(points, self.resolution, self.full_caps,
                             self.num_levels)

    def pyramid_part(self, points) -> Pyramid:
        return build_pyramid(points, self.resolution, self.part_caps,
                             self.num_levels)

    def pyramid_part_tiny(self, points) -> Pyramid:
        """Minimal-capacity pyramid for the unconditioned (zeros) bank: one
        voxel per batch item, so its matches cost next to nothing."""
        tiny = [max(8, points.shape[0] * 2)] * self.num_levels
        return build_pyramid(points, self.resolution, tiny, self.num_levels)

    # ---------------- training ----------------

    def loss_fn(self, batch: dict, generator: torch.Generator | None = None,
                *, noise=None, t=None, drop=None):
        """One training loss evaluation; puts the model in train mode, so
        the BatchNorm running statistics move.

        batch: {'pcd_full': [B, N, 3], 'pcd_part': [B, Np, 3]} on the
        task's device. Random draws come from `generator` (on that device);
        `noise` ([B, N, 3]), `t` ([B] int timesteps) and `drop` (bool, the
        classifier-free coin) replace them, so tests can feed both packages
        the same numbers. Returns (loss, metrics); the metrics are detached
        0-d tensors."""
        x0, part = batch["pcd_full"], batch["pcd_part"]
        B = x0.shape[0]
        dev = x0.device
        if generator is None and (noise is None or t is None
                                  or drop is None):
            raise ValueError("pass a torch.Generator, or noise, t and drop")
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator, device=dev,
                                dtype=x0.dtype)
        if t is None:
            t = torch.randint(0, self.coeffs.t_steps, (B,),
                              generator=generator, device=dev)
        # point-local q-sample: noise the offsets around the anchors
        x_t = x0 + q_sample(self.coeffs, torch.zeros_like(x0), t, noise)
        # classifier-free dropout: one coin for the whole batch; a
        # single-item batch never drops
        if drop is None:
            drop = (torch.rand((), generator=generator, device=dev)
                    < self.uncond_prob) & (B > 1)
        keep = ~torch.as_tensor(drop, dtype=torch.bool, device=dev)
        pyr_full = self.pyramid_full(x_t)
        pyr_part = self.pyramid_part(part * keep.to(part.dtype))

        self.model.train()
        eps = self.model(pyr_full, pyr_part, t)

        loss_mse = ((eps - noise) ** 2).mean()
        loss_mean = eps.mean() ** 2
        # the population std, as jnp.std; torch.std defaults to the sample's
        loss_std = (eps.std(correction=0) - 1.0) ** 2
        loss = loss_mse + self.reg_weight * (loss_mean + loss_std)
        ovf = (pyr_full.overflows().sum() + pyr_part.overflows().sum())
        wovf = (pyr_full.window_overflows().sum()
                + pyr_part.window_overflows().sum())
        metrics = {"loss": loss, "loss_mse": loss_mse,
                   "loss_mean": loss_mean, "loss_std": loss_std,
                   "overflow_vox": ovf.float(),
                   "overflow_window": wovf.float()}
        return loss, {k: v.detach() for k, v in metrics.items()}

    # ---------------- sampling ----------------

    @eval_no_grad
    def encode_banks(self, part):
        """Conditioning banks of one completion, computed once:
        (feats_c, geom_c, feats_u, geom_u); each geom keeps its 1-NN index,
        built here, for every solver step."""
        pyr_c = self.pyramid_part(part)
        pyr_u = self.pyramid_part_tiny(torch.zeros_like(part))
        feats_c = self.model.encode_partial(pyr_c)
        feats_u = self.model.encode_partial(pyr_u)
        geom_c, geom_u = pyr_c.levels[-1].geom, pyr_u.levels[-1].geom
        for g in (geom_c, geom_u):
            g.nn_index(part.shape[0])
        return feats_c, geom_c, feats_u, geom_u

    @eval_no_grad
    def denoise_pair(self, points, feats_c, geom_c, feats_u, geom_u, t: int,
                     w_uncond: float | None = None):
        """Classifier-free guided noise prediction at the current cloud:
        the cond and uncond streams over one pyramid, as one fused G=2
        forward, or as two G=1 forwards when `fuse_classfree` is off."""
        w = self.w_uncond if w_uncond is None else w_uncond
        # tvec before the pyramid: a trace credits each kernel on the card
        # to the innermost open span alone, so a span around this call
        # covers the pyramid's kernels only if one of its own comes first
        tvec = torch.full((points.shape[0],), t, dtype=torch.int32,
                          device=points.device)
        pyr = self.pyramid_full(points)
        if self.fuse_classfree:
            eps = self.model.denoise(
                pyr, [(feats_c, geom_c), (feats_u, geom_u)], tvec)
            eps_c, eps_u = eps[..., 0, :], eps[..., 1, :]
        else:
            eps_c = self.model.denoise(pyr, [(feats_c, geom_c)], tvec)
            eps_u = self.model.denoise(pyr, [(feats_u, geom_u)], tvec)
        return eps_u + w * (eps_c - eps_u)

    def make_chunked_sampler(self, w_uncond: float | None = None,
                             solver: DPMSolver | None = None,
                             chunk: int = 10):
        """The sampling loop in chunks of `chunk` solver steps
        (counterpart of lidiff_tpu/models/diffusion.py:268-332). Returns
        (prepare, run_chunk, finish, num_steps):

            ctx = prepare(x_init, part, generator, offset0=None, noise=None)
            for i0 in range(0, num_steps, chunk):
                ctx = run_chunk(ctx, i0)
            points = finish(ctx)

        `prepare` encodes the conditioning banks and draws the initial
        offset; `run_chunk` runs steps i0 .. i0 + chunk - 1. A step past
        the last one still draws its noise and leaves the state as it was
        (the JAX package's `live` mask), so the generator's draws line up
        whatever the chunk. The arguments of `prepare` are those of
        `sample`."""
        if chunk < 1:
            raise ValueError(f"chunk must be at least 1, not {chunk}")
        solver = solver or self.solver
        w = self.w_uncond if w_uncond is None else w_uncond
        num_steps = solver.num_steps

        def randn(ctx):
            if ctx["generator"] is None:
                raise ValueError("pass a torch.Generator, or offset0 and "
                                 "noise")
            x = ctx["x_init"]
            return torch.randn(x.shape, generator=ctx["generator"],
                               device=x.device, dtype=x.dtype)

        def prepare(x_init, part, generator, *, offset0=None, noise=None):
            ctx = dict(x_init=x_init, generator=generator, noise=noise,
                       banks=self.encode_banks(part))
            ctx["state"] = init_state(randn(ctx) if offset0 is None
                                      else offset0)
            return ctx

        def run_chunk(ctx, i0: int):
            state, noise = ctx["state"], ctx["noise"]
            for i in range(i0, i0 + chunk):
                if i >= num_steps:
                    if noise is None:
                        randn(ctx)
                    continue
                t = int(solver.timesteps[i])
                with prof.annotate("lidiff.sample.step", f"i={i} t={t}"):
                    with prof.annotate("lidiff.sample.denoise"):
                        eps = self.denoise_pair(
                            ctx["x_init"] + state.sample, *ctx["banks"], t,
                            w)
                    z = randn(ctx) if noise is None else noise[i]
                    with prof.annotate("lidiff.sample.solver"):
                        state = solver_step(solver, state, eps, z)
            return {**ctx, "state": state}

        def finish(ctx):
            return ctx["x_init"] + ctx["state"].sample

        return prepare, run_chunk, finish, num_steps

    @eval_no_grad
    def sample_chunked(self, x_init, part, generator: torch.Generator | None,
                       *, offset0=None, noise=None,
                       w_uncond: float | None = None,
                       solver: DPMSolver | None = None, chunk: int = 10):
        """`sample` through `make_chunked_sampler`: the same result bit for
        bit, whatever the chunk."""
        prepare, run_chunk, finish, num_steps = self.make_chunked_sampler(
            w_uncond, solver, chunk)
        ctx = prepare(x_init, part, generator, offset0=offset0, noise=noise)
        for i0 in range(0, num_steps, chunk):
            ctx = run_chunk(ctx, i0)
        return finish(ctx)

    def sample(self, x_init, part, generator: torch.Generator | None, *,
               offset0=None, noise=None, w_uncond: float | None = None,
               solver: DPMSolver | None = None):
        """Completion sampling loop.

        x_init [B, N, 3] anchors (the partial scan tiled 10x), part
        [B, Np, 3] the partial scan. Random draws come from `generator`
        (on the device); `offset0` ([B, N, 3]) and `noise` ([S, B, N, 3])
        replace them, so tests can feed the same noise to both packages.
        Returns [B, N, 3] completed points."""
        return self.sample_chunked(
            x_init, part, generator, offset0=offset0, noise=noise,
            w_uncond=w_uncond, solver=solver,
            chunk=(solver or self.solver).num_steps)
