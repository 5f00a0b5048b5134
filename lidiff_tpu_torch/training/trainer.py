"""Training harness: optimizer, LR schedule, checkpointing, logging and
data parallelism (counterpart of lidiff_tpu/training/trainer.py).

Adam(0.9, 0.999, eps 1e-8) with the stepped exponential decay of the
reference (gamma 0.5 every 5 epochs), or, where the config's `train`
section has an `optimizer` (the PTv3 config), AdamW over parameter groups
with OneCycleLR (`make_adamw_onecycle`); one `torch.save` file per checkpoint
(every epoch, all kept), tensorboardX metric logging where it is installed.
The training state lives in the task's model, the optimizer and the
scheduler, as is PyTorch's habit; the JAX trainer passes it around as a
dict. With a process group (`parallel/mesh.py`) each rank steps on its
rows of the batch, the gradients, BN running statistics and metrics are
averaged over the ranks, and only rank 0 writes checkpoints and logs.
"""

from __future__ import annotations

import json
import math
import os
import re
import signal

import torch

from lidiff_tpu_torch.parallel import mesh


def make_optimizer(params, lr: float, decay_every_epochs: int = 5,
                   gamma: float = 0.5, steps_per_epoch: int = 1):
    """Adam(0.9, 0.999) with lr * gamma^(epoch // decay_every), the
    scheduler stepped once per optimizer step. Returns (optimizer,
    scheduler, schedule) with schedule(step) the learning rate of the
    0-based optimizer step `step`."""
    def factor(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return gamma ** (epoch // decay_every_epochs)

    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, factor)
    return opt, sched, lambda step: lr * factor(step)


def make_adamw_onecycle(named_params, opt: dict, sched: dict,
                        total_steps: int):
    """AdamW over parameter groups, with torch's OneCycleLR stepped once
    per optimizer step (Pointcept's `AdamW` + `OneCycleLR`, the PTv3
    configs). `opt`: {"lr", "weight_decay", "param_groups": [{"keyword",
    "lr"}, ...]}: a parameter whose name contains a group's keyword goes
    to that group (the first that matches), the rest to the default one,
    listed first. `sched`: OneCycleLR's "max_lr" (one per group, in that
    order), "pct_start", "anneal_strategy", "div_factor" and
    "final_div_factor"; it cycles Adam's beta1 between 0.85 and 0.95, as
    its default does. Returns (optimizer, scheduler, schedule) with
    schedule(step) the default group's learning rate of step `step`."""
    if opt.get("type", "AdamW") != "AdamW" \
            or sched.get("type", "OneCycleLR") != "OneCycleLR":
        raise ValueError("the config's optimizer and scheduler must be "
                         "AdamW and OneCycleLR")
    groups = [dict(keyword=None, params=[], lr=float(opt["lr"]))]
    groups += [dict(keyword=g["keyword"], params=[], lr=float(g["lr"]))
               for g in opt.get("param_groups", [])]
    for name, p in named_params:
        g = next((g for g in groups[1:] if g["keyword"] in name), groups[0])
        g["params"].append(p)
    optimizer = torch.optim.AdamW(
        [{"params": g["params"], "lr": g["lr"]} for g in groups],
        lr=float(opt["lr"]), weight_decay=float(opt["weight_decay"]))
    scheduler = torch.optim.lr_scheduler.OneCycleLR(
        optimizer, max_lr=list(sched["max_lr"]), total_steps=total_steps,
        pct_start=float(sched["pct_start"]),
        anneal_strategy=sched.get("anneal_strategy", "cos"),
        div_factor=float(sched["div_factor"]),
        final_div_factor=float(sched["final_div_factor"]))
    top, lo = float(sched["max_lr"][0]), float(sched["pct_start"])
    start = top / float(sched["div_factor"])
    end = start / float(sched["final_div_factor"])
    up = lo * total_steps - 1

    def schedule(step: int) -> float:
        if step <= up:
            a, b, pct = start, top, step / up
        else:
            a, b, pct = top, end, (step - up) / (total_steps - 1 - up)
        return b + (a - b) / 2.0 * (math.cos(math.pi * pct) + 1)

    return optimizer, scheduler, schedule


class CheckpointManager:
    """`torch.save` checkpoints `step_<n>.pt` in one directory, all kept,
    plus the run's `hparams.json`."""

    _NAME = re.compile(r"step_(\d+)\.pt$")

    def __init__(self, ckpt_dir: str):
        self.dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}.pt")

    def latest_step(self) -> int | None:
        steps = [int(m.group(1)) for m in map(self._NAME.match,
                                              os.listdir(self.dir)) if m]
        return max(steps) if steps else None

    def save(self, step: int, state: dict, hparams: dict | None = None):
        tmp = self._path(step) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        if hparams is not None:
            with open(os.path.join(self.dir, "hparams.json"), "w") as f:
                json.dump(hparams, f, indent=2)

    def restore(self, step: int | None = None, map_location=None):
        """(state, step) of checkpoint `step` (default: the latest), or
        (None, None) when the directory holds none."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        state = torch.load(self._path(step), map_location=map_location,
                           weights_only=True)
        return state, step

    def load_hparams(self) -> dict | None:
        p = os.path.join(self.dir, "hparams.json")
        if os.path.isfile(p):
            with open(p) as f:
                return json.load(f)
        return None


class MetricLogger:
    """TensorBoard metric writer (tensorboardX) with stdout fallback; a
    logger that is not `enabled` (a data-parallel rank other than 0) writes
    nothing."""

    def __init__(self, log_dir: str, enabled: bool = True):
        self.enabled = enabled
        self.writer = None
        self.log_dir = log_dir
        if not enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        try:
            from tensorboardX import SummaryWriter
            self.writer = SummaryWriter(log_dir)
        except ImportError:
            pass

    def log(self, step: int, metrics: dict):
        if not self.enabled:
            return
        if self.writer is not None:
            for k, v in metrics.items():
                self.writer.add_scalar(k, float(v), step)
        else:
            # metrics must never be silently dropped when tensorboardX is
            # absent
            line = " ".join(f"{k}={float(v):.6g}"
                            for k, v in metrics.items())
            print(f"[metrics step {step}] {line}", flush=True)

    def flush(self):
        if self.writer is not None:
            self.writer.flush()


class Trainer:
    """Training loop over a task exposing `model` and `loss_fn`, on the
    task's device. `group` is the process group of data-parallel training
    (None: one process); the task's BatchNorm should sync over the same
    group."""

    def __init__(self, task, cfg, exp_dir: str, steps_per_epoch: int = 1,
                 group=None):
        self.group = group
        self.is_main = mesh.rank_of(group) == 0
        self.task = task
        self.cfg = cfg
        self.exp_dir = exp_dir
        self.steps_per_epoch = steps_per_epoch
        tr = cfg["train"]
        if "optimizer" in tr:
            self.optimizer, self.scheduler, self.schedule = \
                make_adamw_onecycle(
                    task.model.named_parameters(), tr["optimizer"],
                    tr["scheduler"],
                    int(tr["max_epoch"]) * max(steps_per_epoch, 1))
        else:
            self.optimizer, self.scheduler, self.schedule = make_optimizer(
                task.model.parameters(), float(tr["lr"]),
                steps_per_epoch=steps_per_epoch)
        self.ckpt = CheckpointManager(os.path.join(exp_dir, "checkpoints"))
        self.logger = MetricLogger(os.path.join(exp_dir, "tb"),
                                   enabled=self.is_main)
        self.global_step = 0
        self.last_epoch = -1   # epoch of the restored checkpoint, if any

    def state_dict(self) -> dict:
        return {"model": self.task.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "step": self.global_step}

    def maybe_restore(self) -> bool:
        """Load the latest checkpoint of `self.ckpt`, if there is one:
        model, optimizer, scheduler, step and epoch."""
        state, step = self.ckpt.restore(map_location=self.task.device)
        if state is None:
            return False
        self.task.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.global_step = int(state.get("step", step))
        self.last_epoch = int(state.get("epoch", -1))
        return True

    def train_step(self, batch: dict, generator=None, **draws):
        """One optimizer step on `batch` (this rank's rows of the global
        batch); `draws` (noise, t, drop) go to the task's `loss_fn`. With a
        group the gradients are averaged over the ranks before the
        optimizer, then the BN running statistics and the metrics. Returns
        the step's metrics."""
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.task.loss_fn(batch, generator, **draws)
        loss.backward()
        if self.group is not None:
            mesh.all_reduce_grads(self.task.model.parameters(), self.group)
        self.optimizer.step()
        self.scheduler.step()
        self.global_step += 1
        if self.group is not None:
            mesh.average_buffers(self.task.model, self.group)
            metrics = mesh.average_metrics(metrics, self.group)
        return metrics

    def save(self, epoch: int):
        """Checkpoint keyed by global step (unique even for mid-epoch
        signal saves), with the epoch recorded in the payload: reference
        checkpoints are named by epoch and resume is epoch-aware. Only rank
        0 writes."""
        if not self.is_main:
            return
        self.ckpt.save(self.global_step,
                       {**self.state_dict(), "epoch": int(epoch)},
                       hparams=self.cfg)

    def install_signal_checkpointing(self):
        """Checkpoint on SIGTERM/SIGINT before exiting; the epoch is
        recorded as -1, so a resume falls back to step arithmetic."""

        def handler(signum, frame):
            try:
                self.save(-1)
                print(f"checkpoint saved on signal {signum}")
            finally:
                signal.default_int_handler(signum, frame) \
                    if signum == signal.SIGINT else os._exit(1)

        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)
