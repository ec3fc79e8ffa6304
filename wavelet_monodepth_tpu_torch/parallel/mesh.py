"""Data-parallel training over torch.distributed: start-up, the feed's
shards, and the reductions over the global batch.

Counterpart of `wavelet_monodepth_tpu/parallel/mesh.py`. JAX trains one
program over a 1-D data mesh: GSPMD shards the batch axis, so every mean
over the batch (BN's statistics, the loss terms) is a mean over the
global batch, and the gradient psum follows from it. The port runs one
process per rank. Each rank holds its rows of the global batch (the
global batch is the ranks' rows in rank order) and the same parameters,
and three pieces give JAX's results:

  * `global_sum`, a differentiable all-reduce whose backward is an
    all-reduce too. BN's statistics (`models/resnet.BatchNorm2d`) and
    every ratio and mean of the losses go through it (`global_sums`,
    `global_mean`), so every rank computes the global-batch loss L, and
    its local gradient is R * dL/d(its rows) for R ranks;
  * `allreduce_gradients`: one bucketed all-reduce of the gradients
    after backward, divided by R, which is exactly dL/dtheta on every
    rank, so the parameters and Adam's state stay equal across ranks.
    DDP's per-parameter hooks would fire twice for the pose encoder,
    which runs once per temporal pair; one all-reduce after backward has
    no such trap;
  * `randn_rows`: a draw inside the step (the automask noise) is taken
    for the global batch from a generator seeded alike on every rank, and
    each rank keeps its rows.

With one rank each of these is the plain local operation, so a
single-process run is unchanged.

Start-up. JAX runs one process per host; the port runs one per rank,
one rank per card. `--data_axis N` on one host starts N local ranks;
with `--coordinator_address/--num_processes/--process_id` each host
starts one rank per visible card (one on the CPU), global rank =
process_id * local count + local rank (`local_rank_count`,
`launch_local_ranks`). Each rank is the training CLI again, pinned to
one card, with the multi-host flags of its rank. The backend is NCCL
when every rank has a card of its own, else gloo (the CPU, or ranks
sharing a card, which NCCL refuses); each rank prints its choice.

Spatial inference (`mesh.py:197-242`). `make_mesh(data, spatial)` lays
the ranks out as JAX lays its devices (rank = d * spatial + s) and
builds each data row's spatial group with `dist.new_group`;
`shard_spatial` gives a rank its band of an image (under a data axis,
of its data row's images); `spatial_forward` is
`jit_spatial_forward`: the forward runs on the band under
`spatial_hints.active` (the halo exchanges, gathers and cross-band
reductions GSPMD inserted are there) and every output comes back in full
height on every rank of the group. Inference only, as in JAX.

Left out, with no PyTorch counterpart: the NamedSharding helpers
(`batch_sharding`, `stacked_batch_sharding`, `replicated`,
`spatial_sharding`), `put_global`, `shard_batch` and `replicate`: a
rank's tensors are its rows, and the parameters start from one seed on
every rank and move by the same all-reduced gradient.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Iterable, Sequence

import torch
import torch.distributed as dist

from . import spatial_hints

# how long a rank waits for the others, at start-up and in a collective
TIMEOUT = datetime.timedelta(minutes=30)
# the file a launched rank writes its training summary to
RESULT_ENV = "WMD_RANK_RESULT"


def world_size() -> int:
    """The number of ranks; 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """Rank 0: the one that logs, prints and writes checkpoints."""
    return rank() == 0


def _comm_device() -> torch.device:
    """Where small control tensors live: NCCL takes only the card's."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _multihost_flags(coordinator_address, num_processes, process_id):
    """The three multi-host flags, all given or none (then None)."""
    flags = (coordinator_address, num_processes, process_id)
    if all(f is None for f in flags):
        return None
    if any(f is None for f in flags):
        raise SystemExit(
            "--coordinator_address, --num_processes and --process_id go "
            "together: every host needs the coordinator's host:port, the "
            "number of hosts and its own index")
    if not 0 <= int(process_id) < int(num_processes):
        raise SystemExit(f"--process_id {process_id} must lie in "
                         f"[0, {num_processes})")
    return str(coordinator_address), int(num_processes), int(process_id)


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, device="cpu") -> bool:
    """Join the process group of `num_processes` ranks as rank
    `process_id`, the store at `coordinator_address` (host:port, served
    by rank 0). Call once per rank before any collective. A no-op when no
    flag is given. Returns True when it created the group (the caller
    closes it with `shutdown`), False when none is configured or this
    rank's group exists already."""
    flags = _multihost_flags(coordinator_address, num_processes, process_id)
    if flags is None:
        return False
    address, world, me = flags
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (world, me):
            raise SystemExit(
                f"rank {me} of {world} asked for, but this process is "
                f"already rank {dist.get_rank()} of {dist.get_world_size()}")
        return False
    device = torch.device(device)
    host, port = address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), world, is_master=me == 0,
                          timeout=TIMEOUT)
    backend, why = "gloo", "the CPU"
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        props = torch.cuda.get_device_properties(device)
        store.set(f"wmd_card/{me}", f"{socket.gethostname()}/{props.uuid}")
        cards = {store.get(f"wmd_card/{r}").decode() for r in range(world)}
        if len(cards) == world:
            backend, why = "nccl", "a card per rank"
        else:
            why = "ranks share a card"
    dist.init_process_group(backend, store=store, world_size=world, rank=me,
                            timeout=TIMEOUT)
    print(f"rank {me} of {world}: {backend} ({why})", flush=True)
    return True


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def multihost_setup(batch_size: int, data_axis: int, nproc=None, ndev=None):
    """JAX's bring-up policy (`mesh.py:43-73`): the global batch must
    divide across the processes that feed it and across the data mesh;
    with more than one process the data axis spans every device. Explicit
    raises, not asserts: they guard CLI input. `nproc` (JAX's process
    count) and `ndev` (its global device count) default to the ranks; the
    launcher passes JAX's counts for a command's hosts before it starts
    any rank, so a bad command gets JAX's message. Returns
    (local_batch, data_axis)."""
    nproc = world_size() if nproc is None else nproc
    ndev = world_size() if ndev is None else ndev
    if batch_size % nproc:
        raise SystemExit(
            f"--batch_size {batch_size} must divide by {nproc} "
            "processes (each host feeds an equal local slice)")
    local_batch = batch_size // nproc
    if nproc > 1:
        if data_axis > 1 and data_axis != ndev:
            raise SystemExit(
                f"--data_axis {data_axis} with {nproc} processes: a "
                f"multi-host data mesh must span all {ndev} global "
                "devices (processes owning none of the mesh's devices "
                "cannot feed it)")
        data_axis = ndev
    if data_axis > 1 and batch_size % data_axis:
        raise SystemExit(
            f"--batch_size {batch_size} must divide across the "
            f"{data_axis}-device data mesh (each device takes an equal "
            "slice of the global batch) — fail here, not deep inside "
            "the prefetch thread's device_put")
    return local_batch, data_axis


def require_ranks(data_axis: int) -> None:
    """A training setup runs in each of `data_axis` ranks: refuse one
    built where the process group says otherwise."""
    if int(data_axis) != world_size():
        raise ValueError(
            f"data_axis={data_axis} in a process group of {world_size()} "
            "rank(s): data-parallel training runs one process per rank "
            "(tools/train_kitti.py and tools/train_nyu.py --data_axis N "
            "start them; a rank of its own joins with "
            "initialize_distributed and multihost_setup)")


def agree_across_processes(value: int, what: str) -> int:
    """The integer decision (e.g. the auto-resume epoch), checked equal
    on every rank: divergence means per-host state differs (typically a
    log_dir that is not shared), so fail now, not later inside a
    collective."""
    if world_size() == 1:
        return value
    mine = torch.tensor([int(value)], dtype=torch.int64,
                        device=_comm_device())
    got = [torch.empty_like(mine) for _ in range(world_size())]
    dist.all_gather(got, mine)
    vals = [int(v.item()) for v in got]
    if any(v != vals[0] for v in vals):
        raise SystemExit(
            f"{what} disagrees across processes: {vals} — "
            "multi-host runs need a shared log_dir (every host must "
            "see the same checkpoints)")
    return vals[0]


def warmup_collectives() -> None:
    """A one-element all-reduce right after start-up, so every rank has
    joined the group before the first step's collectives."""
    if world_size() > 1:
        dist.all_reduce(torch.ones(1, device=_comm_device()))


def barrier() -> None:
    if world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def broadcast_flag(flag: bool) -> bool:
    """Rank 0's `flag` on every rank (a decision only rank 0 can make,
    such as whether it logs visuals, taken by all in lockstep)."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], device=_comm_device())
    dist.broadcast(t, 0)
    return bool(t.item())


def process_shard(items: list) -> list:
    """This rank's shard of a split list, interleaved as JAX's
    (`mesh.py:114-120`): equal counts within +-1, the union exact."""
    return list(items[rank()::world_size()])


def local_rows(a):
    """This rank's rows: the tensor itself (a rank holds only its own)."""
    return a


def local_tree(tree):
    return tree


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The elementwise sum of `t` over the ranks, differentiable: its
    backward all-reduces the incoming gradient. The identity with one
    rank. Every rank must call it, in the same order."""
    if world_size() == 1:
        return t
    return _GlobalSum.apply(t)


def _acc_dtype(*ts: torch.Tensor) -> torch.dtype:
    return functools.reduce(torch.promote_types, [t.dtype for t in ts],
                            torch.float32)


def global_sums(*ts: torch.Tensor):
    """(sum of each tensor over the global batch), one all-reduce for
    all of them, accumulated in float32 or wider and returned in each
    tensor's dtype. With one rank: torch.sum of each."""
    if world_size() == 1:
        return tuple(torch.sum(t) for t in ts)
    acc = _acc_dtype(*ts)
    s = global_sum(torch.stack([t.sum(dtype=acc) for t in ts]))
    return tuple(s[i].to(t.dtype) for i, t in enumerate(ts))


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of every element of `t` over the global batch (the ranks
    hold equal local batches). With one rank: t.mean()."""
    if world_size() == 1:
        return t.mean()
    s = global_sum(t.sum(dtype=_acc_dtype(t)))
    return (s / (t.numel() * world_size())).to(t.dtype)


class _GlobalMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.MAX)
        holds = (t == out).to(t.dtype)
        ties = holds.clone()
        dist.all_reduce(ties)
        ctx.save_for_backward(holds / ties)
        return out

    @staticmethod
    def backward(ctx, grad):
        share, = ctx.saved_tensors
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad * share


def global_max(t: torch.Tensor) -> torch.Tensor:
    """The largest of a scalar `t` over the ranks, differentiable: the
    gradient, summed over the ranks, goes to the rank(s) holding it
    (split evenly on ties, as torch.max splits among tied elements)."""
    if world_size() == 1:
        return t
    return _GlobalMax.apply(t)


def randn_rows(shape, generator: torch.Generator, dtype, device):
    """This rank's rows of torch.randn((R * shape[0], ...)) drawn from
    `generator`: with the generator seeded alike on every rank, the ranks'
    rows are one draw for the global batch, as a single process draws it.
    With one rank: torch.randn(shape)."""
    n, r = shape[0], world_size()
    if r == 1:
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device)
    full = torch.randn((n * r, *shape[1:]), generator=generator,
                       dtype=dtype, device=device)
    return full[rank() * n:(rank() + 1) * n]


def allreduce_gradients(params: Iterable[torch.Tensor]) -> None:
    """Average the gradients of `params` over the ranks in place: one
    all-reduce per dtype over a flat copy of them all, then / R."""
    r = world_size()
    if r == 1:
        return
    buckets: dict = {}
    for p in params:
        if p.grad is not None:
            buckets.setdefault((p.grad.dtype, p.grad.device),
                               []).append(p.grad)
    for grads in buckets.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat.div_(r)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view(g.shape))
            offset += g.numel()


# ---------------------------------------------------------------------------
# launching a host's ranks

def local_rank_count(opts, device) -> int:
    """How many ranks this process starts on its host: under the
    multi-host flags one per visible card (one on the CPU), else
    `opts.data_axis`. 1 means this process is the one rank."""
    flags = _multihost_flags(opts.coordinator_address, opts.num_processes,
                             opts.process_id)
    if flags is not None:
        if torch.device(device).type == "cuda":
            return max(torch.cuda.device_count(), 1)
        return 1
    return max(int(opts.data_axis), 1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _visible_cards() -> list:
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env:
        return [c.strip() for c in env.split(",") if c.strip()]
    return [str(i) for i in range(torch.cuda.device_count())]


def launch_local_ranks(module: str, argv: Sequence[str], opts, device,
                       count: int) -> dict:
    """Start this host's `count` ranks, each `python -m module argv` with
    its rank's multi-host flags and --data_axis set to the global count,
    pinned to one card (local rank j on visible card j mod cards: ranks
    share cards when there are fewer, and then run on gloo), and wait for
    all. The command's flags are first checked with JAX's counts
    (`multihost_setup`). A rank that fails stops the others and raises
    SystemExit. Returns the training summary of the host's first rank."""
    device = torch.device(device)
    hosts = 1 if opts.num_processes is None else int(opts.num_processes)
    host = 0 if opts.process_id is None else int(opts.process_id)
    world = hosts * count
    multihost_setup(opts.batch_size, opts.data_axis, nproc=hosts, ndev=world)
    address = opts.coordinator_address or f"127.0.0.1:{_free_port()}"
    cards = _visible_cards() if device.type == "cuda" else []
    if cards and count > len(cards):
        print(f"{count} local ranks on {len(cards)} card(s): ranks share "
              "cards", flush=True)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH"))
                           if p)
    procs = []
    with tempfile.TemporaryDirectory(prefix="wmd_ranks_") as tmp:
        try:
            for j in range(count):
                env = dict(os.environ, PYTHONPATH=path)
                env[RESULT_ENV] = os.path.join(tmp, f"rank{j}.json")
                if cards:
                    env["CUDA_VISIBLE_DEVICES"] = cards[j % len(cards)]
                cmd = [sys.executable, "-m", module, *argv,
                       "--device", device.type, "--data_axis", str(world),
                       "--coordinator_address", address,
                       "--num_processes", str(world),
                       "--process_id", str(host * count + j)]
                procs.append(subprocess.Popen(cmd, env=env,
                                              stdin=subprocess.DEVNULL))
            while True:
                codes = [p.poll() for p in procs]
                failed = [(j, c) for j, c in enumerate(codes)
                          if c not in (None, 0)]
                if failed:
                    raise SystemExit(
                        f"local rank {failed[0][0]} exited with code "
                        f"{failed[0][1]}; the other ranks are stopped")
                if all(c == 0 for c in codes):
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        with open(os.path.join(tmp, "rank0.json")) as f:
            return json.load(f)


def write_rank_result(summary: dict) -> None:
    """In a rank that `launch_local_ranks` started: leave the training
    summary for the launcher. Elsewhere a no-op."""
    path = os.environ.get(RESULT_ENV)
    if path:
        with open(path, "w") as f:
            json.dump(summary, f)


# ---------------------------------------------------------------------------
# spatial (image-height) inference

@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data x spatial layout of the ranks (JAX's `Mesh(("data",
    "spatial"))`): this rank is row `data_index` (its images) and column
    `layout.index` (its band) of a `data` x `spatial` grid."""

    data: int
    spatial: int
    data_index: int
    layout: spatial_hints.Layout


def make_mesh(data: int | None = None, spatial: int = 1) -> Mesh:
    """Lay the world's ranks out as data x spatial, rank = d * spatial + s
    (JAX's reshape of its devices), and build every data row's spatial
    group. Every rank must call it, with the same arguments and in the
    same order as every other group it builds."""
    world = world_size()
    if data is None:
        data = world // spatial
    if data * spatial != world:
        raise ValueError(f"mesh {data}x{spatial} needs {data * spatial} "
                         f"ranks, the process group has {world}")
    me = rank()
    mine = None
    if dist.is_initialized():
        for d in range(data):
            group = dist.new_group(list(range(d * spatial,
                                              (d + 1) * spatial)))
            if d == me // spatial:
                mine = group
    return Mesh(data, spatial, me // spatial,
                spatial_hints.Layout(spatial, me % spatial, mine))


def shard_spatial(mesh: Mesh, x):
    """This rank's band of an NHWC image (or of each in a dict, list or
    tuple), tagged with its global height. Under a data axis each data
    row passes its own images (JAX's P("data", "spatial"))."""
    if isinstance(x, dict):
        return {k: shard_spatial(mesh, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(shard_spatial(mesh, v) for v in x)
    with spatial_hints.active(mesh.layout):
        return spatial_hints.hint(x, x.shape[1])


def _gathered(layout: spatial_hints.Layout, out):
    """Every tagged band in `out` (a tensor, dict, list or tuple) in full
    height; everything else as it is."""
    if isinstance(out, dict):
        return {k: _gathered(layout, v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(_gathered(layout, v) for v in out)
    if isinstance(out, torch.Tensor) and out.dim() == 4:
        return spatial_hints.gather(out, spatial_hints.rows_of(out))
    return out


def spatial_forward(mesh: Mesh, forward):
    """`forward(*args)` on this rank's bands (`shard_spatial`), returning
    its outputs in full height on every rank of the spatial group: JAX's
    `jit_spatial_forward` with replicated outputs. Runs without autograd
    (inference only: a train-mode BN raises under it). Outputs are
    gathered as the modules return them (tagged); every rank of the group
    must call it alike."""

    def call(*args, **kwargs):
        with torch.no_grad(), spatial_hints.active(mesh.layout):
            return _gathered(mesh.layout, forward(*args, **kwargs))
    return call
