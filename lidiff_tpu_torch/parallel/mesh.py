"""Data parallelism over torch.distributed (counterpart of
lidiff_tpu/parallel/mesh.py).

One process per device, ranks 0 .. world-1: NCCL between cards, gloo on the
CPU. The parameters are replicated (every rank builds the task from the same
seed or checkpoint); rank r takes rows [r*B/n, (r+1)*B/n) of the global batch
(`rank_slice`, which the data loader applies); BatchNorm takes its moments over
every rank (`ops/batchnorm.py` `masked_bn_train` with the group); after the
backward pass `all_reduce_grads` averages the gradients in one flattened buffer
(JAX `pmean`), and the BN running statistics and the step's metrics are
averaged the same way. The rest of the loss is each rank's own on its rows, as
each replica's is in JAX's shard_map step. Random draws come from a per-rank
generator seeded from (seed, rank) (`rank_seed`, the counterpart of
`fold_in(key, idx)`).
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist

from lidiff_tpu_torch import resolve_device

# odd 64-bit constant (the golden ratio's): rank r's seed is
# seed + r * _SEED_STRIDE mod 2^63, so rank 0 keeps the one-process seed
_SEED_STRIDE = 0x9E3779B97F4A7C15


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank (or replica) `rank`: (seed + rank * 0x9E3779B97F4A7C15)
    mod 2^63. Rank 0 gets `seed` itself, so a one-rank run draws what the
    one-process path draws."""
    return (int(seed) + int(rank) * _SEED_STRIDE) % (1 << 63)


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(rank_seed(seed, rank))


def file_init_method(directory: str | None = None) -> str:
    """A `file://` store in a new file under `directory` (a temporary
    directory by default); the ranks of one group share it."""
    fd, path = tempfile.mkstemp(prefix="lidiff_store_", dir=directory)
    os.close(fd)
    os.remove(path)           # the store creates it; a stale one would hang
    return f"file://{path}"


def init_ranks(rank: int, world: int, init_method: str,
               device=None):
    """Join the default process group as `rank` of `world`: NCCL when
    `device` is a card (set as this process's current device; None means
    the card, as for every entry point, and raises without one), gloo for
    "cpu". Returns the group (`dist.group.WORLD`)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, **kwargs)
    return dist.group.WORLD


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def world_of(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank_of(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def rank_slice(n: int, rank: int, world: int) -> slice:
    """Rank `rank`'s rows [rank*n/world, (rank+1)*n/world) of a batch of n
    (lidiff_tpu's `shard_batch` splits the leading axis so): the ranks'
    rows together are the one-process batch. Raises unless world divides
    n."""
    if n % world:
        raise ValueError(f"batch size {n} is not a multiple of the world "
                         f"size {world}")
    m = n // world
    return slice(rank * m, (rank + 1) * m)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group's ranks whose backward sums the gradient the same
    way: JAX's psum, which transposes to a psum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the group's ranks, differentiably: the gradient of
    each rank's input is the sum of the ranks' output gradients."""
    return _AllReduceSum.apply(x, group)


def _average(tensors: list, group) -> None:
    """Average `tensors` (float, one device) over the group's ranks in
    place, through one flattened buffer."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= world_of(group)
    i = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[i:i + n].view_as(t))
        i += n


def all_reduce_grads(params, group) -> None:
    """Average every parameter's gradient over the ranks (JAX `pmean` of
    the grads) in one all-reduce of a flattened buffer. A missing gradient
    counts as zeros, so every rank sends a buffer of one layout."""
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    _average([p.grad for p in params], group)


def average_buffers(model: torch.nn.Module, group) -> None:
    """Average the model's float buffers (the BN running statistics) over
    the ranks. Synced BN gives every rank the same moments already; this
    keeps them equal to the last bit, as mesh.py:63-67 does."""
    _average([b for b in model.buffers() if b.is_floating_point()], group)


def average_metrics(metrics: dict, group) -> dict:
    """The step's metrics (0-d tensors) averaged over the ranks."""
    vals = [v.detach().float().reshape(1).clone() for v in metrics.values()]
    _average(vals, group)
    return {k: v[0] for k, v in zip(metrics, vals)}


def world_size(cfg: dict, device=None) -> int:
    """The number of training processes: train.n_gpus capped at the cards
    present (lidiff_tpu/train.py:65-68 caps it at jax.devices()). The CPU
    is one device, so `device` "cpu" gives 1."""
    if device is not None and torch.device(device).type == "cpu":
        return 1
    n = max(1, int(cfg["train"].get("n_gpus", 1)))
    return max(1, min(n, torch.cuda.device_count()))


def launch(fn, world: int, device, *args) -> None:
    """Run fn(rank, world, group, device, *args) on every rank. At world 1
    it runs in this process with no group and `device` as given (the
    one-process path); above, `world` processes are spawned, rank r on
    `cuda:r` (or the CPU when `device` is the CPU), joined in one group
    through a file store."""
    if world == 1:
        fn(0, 1, None, device, *args)
        return
    init = file_init_method()
    try:
        torch.multiprocessing.spawn(_worker, nprocs=world, join=True,
                                    args=(fn, world, device, init, args))
    finally:
        path = init[len("file://"):]
        if os.path.exists(path):
            os.remove(path)


def _worker(rank: int, fn, world: int, device, init_method: str,
            args: tuple) -> None:
    cpu = device is not None and torch.device(device).type == "cpu"
    dev = "cpu" if cpu else f"cuda:{rank}"
    if cpu:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    group = init_ranks(rank, world, init_method, dev)
    try:
        fn(rank, world, group, dev, *args)
    finally:
        shutdown()
