"""Rank processes for tests/test_torch_port_parallel.py.

:class:`Ranks` starts ``world`` processes (the spawn method) that join one
gloo group on localhost and then run tasks, the functions of this module
named in :data:`TASKS`, until they are told to stop; each call of a task
runs on every rank and returns every rank's result.  Besides the world of
``world`` ranks each rank has a group of its own (a world of one).  The
module imports neither JAX nor the test module, so a rank starts with
torch and the port alone.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import traceback

import numpy as np
import torch
import torch.distributed as dist

from vaegam_tpu_torch.data import DeviceResidentLoader, FMRIDataset, PrefetchLoader
from vaegam_tpu_torch.models import forward
from vaegam_tpu_torch.models.networks import batch_stat_norm
from vaegam_tpu_torch.models.vaegam import d_floor
from vaegam_tpu_torch.parallel import (all_reduce_grads, batch_rows, init_multihost,
                                       leave, make_data_mesh, replica_digests)
from vaegam_tpu_torch.parallel.mesh import free_port
from vaegam_tpu_torch.train import Trainer
from vaegam_tpu_torch.utils.tree import tree_items, tree_map


def _t(a, dtype):
    return None if a is None else torch.tensor(np.asarray(a), dtype=dtype)


def _tensors(tree, dtype):
    """A dict tree or a tuple of arrays as tensors of ``dtype``."""
    if isinstance(tree, dict):
        return tree_map(lambda a: _t(a, dtype), tree)
    return tuple(_t(a, dtype) for a in tree)


def _np(tree):
    return tree_map(lambda t: t.detach().numpy(), tree)


# ---------------------------------------------------------------------------
# tasks: task(meshes, world, **kwargs) -> a picklable result, where world
# (default: all the ranks) picks the mesh the task runs over
# ---------------------------------------------------------------------------

def step(meshes, world, config, params, consts, covs, x, noise, dtype, trainer_step):
    """Loss and summed gradients of one forward over this rank's rows of the
    batch; with ``trainer_step`` also a Trainer step through Adam from the
    same parameters: (loss, grads, params after, first moment, digests)."""
    mesh = meshes[world]
    dt = getattr(torch, dtype)
    p, c = _tensors(params, dt), _tensors(consts, dt)
    covs, x = _tensors((covs, x), dt)
    noise = _tensors(noise, dt)
    lo, hi = batch_rows(len(covs), mesh, uneven=True)
    leaves = [t.requires_grad_(True) for _, t in tree_items(p)]
    loss, aux = forward(p, c, covs, x[lo:hi], config, noise=noise, mesh=mesh)
    grads = all_reduce_grads(torch.autograd.grad(loss, leaves), mesh)
    out = {"loss": float(loss.detach()), "grads": [g.numpy() for g in grads],
           "aux": {k: v.detach().numpy() for k, v in aux.items()}}
    if trainer_step:
        t = Trainer(config, device="cpu", params=p, consts=c, mesh=mesh)
        out["trainer_loss"] = float(t.train_step(covs, x[lo:hi], noise=noise)[0])
        out["params"] = _np(t.params)
        out["mu"] = _np(t.opt_state["mu"])
        out["digests"] = replica_digests(t._leaves + t._mu + t._nu, mesh)
    return out


def maps(meshes, world, config, params, consts, covs, x, noise):
    """One forward with maps over this rank's rows: (loss, aux, rows)."""
    mesh = meshes[world]
    p, c = _tensors(params, torch.float32), _tensors(consts, torch.float32)
    covs, x = _tensors((covs, x), torch.float32)
    noise = _tensors(noise, torch.float32)
    lo, hi = batch_rows(len(covs), mesh, uneven=True)
    with torch.no_grad():
        loss, aux = forward(p, c, covs, x[lo:hi], config, noise=noise,
                            return_maps=True, mesh=mesh)
    return {"loss": float(loss.detach()), "rows": (lo, hi),
            "maps": {k: v.numpy() for k, v in aux.pop("maps").items()},
            "aux": {k: v.numpy() for k, v in aux.items()}}


def norm(meshes, world, x, p, groups, cotangent):
    """batch_stat_norm over this rank's rows of each group: (out, dx, dp)."""
    mesh = meshes[world]
    n = len(x) // groups
    lo, hi = batch_rows(n, mesh, uneven=True)

    def local(a):  # this rank's rows of every group
        a = torch.tensor(a)
        return a.reshape(groups, n, *a.shape[1:])[:, lo:hi].reshape(-1, *a.shape[1:])

    xl = local(x).requires_grad_(True)
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    out = batch_stat_norm(xl, pt, groups, mesh=mesh, global_rows=len(x))
    gx, gs, gb = torch.autograd.grad(out, [xl, pt["scale"], pt["shift"]], local(cotangent))
    gs, gb = all_reduce_grads([gs, gb], mesh)
    return out.detach().numpy(), gx.numpy(), gs.numpy(), gb.numpy(), (lo, hi)


def floor(meshes, world, d):
    """The d-floor of this rank's rows: (rows, floored rows)."""
    mesh = meshes[world]
    lo, hi = batch_rows(len(d), mesh, uneven=True)
    return (lo, hi), d_floor(torch.tensor(d)[lo:hi], mesh).numpy()


def skip(meshes, world, config, params, consts, covs, x, noise):
    """A Trainer step whose batch holds a NaN volume on the last rank:
    (loss, total_notfinite, count, params unchanged, digests)."""
    mesh = meshes[world]
    p, c = _tensors(params, torch.float32), _tensors(consts, torch.float32)
    covs, x = _tensors((covs, x), torch.float32)
    noise = _tensors(noise, torch.float32)
    t = Trainer(config, device="cpu", params=p, consts=c, mesh=mesh)
    before = [v.detach().clone() for v in t._leaves]
    loss, _ = t.train_step(covs, t._put_batch({"covariates": covs, "volume": x})[1],
                           noise=noise)
    return (float(loss), int(t.opt_state["total_notfinite"]), int(t.opt_state["count"]),
            all(torch.equal(a, b) for a, b in zip(before, t._leaves)),
            replica_digests(t._leaves, mesh))


def uneven(meshes, world, config, params, consts, vols, covs, noise):
    """The device cache's last batch (which the ranks do not divide) through
    forward and summed gradients, and a host batch of the same rows through
    the Trainer: (rows, loss, grads, the host batch's error)."""
    mesh = meshes[world]
    p, c = _tensors(params, torch.float32), _tensors(consts, torch.float32)
    loader = DeviceResidentLoader.from_arrays(vols, covs, batch_size=4, mesh=mesh,
                                              device="cpu")
    sel = list(loader.iter_index_batches())[-1]
    bcovs, bx = loader.gather(sel)
    leaves = [t.requires_grad_(True) for _, t in tree_items(p)]
    loss, _ = forward(p, c, bcovs, bx, config, noise=_tensors(noise, torch.float32), mesh=mesh)
    grads = all_reduce_grads(torch.autograd.grad(loss, leaves), mesh)
    t = Trainer(config, device="cpu", params=p, consts=c, mesh=mesh)
    try:
        t._put_batch({"covariates": covs[sel], "volume": vols[sel]})
        err = None
    except ValueError as e:
        err = str(e)
    return (batch_rows(len(sel), mesh, uneven=True), float(loss.detach()),
            [g.numpy() for g in grads], err)


def loaders(meshes, world, csv, batch):
    """Two epochs of the device cache and the prefetch loader at seed 3:
    every batch's (vol_num, covariates, volumes) and, for the prefetch
    loader, the rows each rank decoded."""
    mesh = meshes[world]
    out = {}
    cache = DeviceResidentLoader(FMRIDataset(csv), batch, shuffle=True, seed=3,
                                 mesh=mesh)
    dataset = FMRIDataset(csv)
    decoded = []
    gather = dataset.gather

    def counting_gather(idxs, **kw):
        decoded.extend(int(i) for i in idxs)
        return gather(idxs, **kw)

    dataset.gather = counting_gather
    stream = PrefetchLoader(dataset, batch, shuffle=True, seed=3, mesh=mesh)
    for name, loader in (("cache", cache), ("prefetch", stream)):
        batches = []
        for epoch in (0, 1):
            loader.set_epoch(epoch)
            batches += [(np.asarray(b["vol_num"]), b["covariates"].numpy(),
                         b["volume"].numpy()) for b in loader]
        out[name] = batches
    out["decoded"] = decoded
    return out


def cli(meshes, world, argv):
    """The train CLI with --multihost in this group: (train losses, test
    losses, what the output stage recorded)."""
    from vaegam_tpu_torch.cli.train import main

    trainer, _ = main(list(argv) + ["--multihost"])
    return (dict(trainer.loss["train"]), dict(trainer.loss["test"]),
            sorted(trainer.output_stats))


TASKS = {f.__name__: f for f in (step, maps, norm, floor, skip, uneven, loaders, cli)}


# ---------------------------------------------------------------------------
# the rank processes
# ---------------------------------------------------------------------------

def _serve(rank, world, coordinator, tasks, results):
    torch.set_num_threads(2)
    os.environ.update(VAEGAM_COORDINATOR=coordinator, VAEGAM_NUM_PROCESSES=str(world),
                      VAEGAM_PROCESS_ID=str(rank))
    mesh = init_multihost(device="cpu")
    singles = [dist.new_group([r]) for r in range(world)]
    meshes = {world: mesh, 1: make_data_mesh("cpu", singles[rank])}
    try:
        while True:
            task = tasks.get()
            if task is None:
                return
            name, kwargs = task
            try:
                kwargs.setdefault("world", world)
                results.put((rank, True, TASKS[name](meshes, **kwargs)))
            except Exception:
                results.put((rank, False, traceback.format_exc()))
    finally:
        leave(mesh)


class Ranks:
    """``world`` rank processes in one gloo group; ``run(task, **kwargs)``
    runs a task on every rank and returns the results in rank order."""

    def __init__(self, world: int = 2, timeout: float = 300.0):
        ctx = multiprocessing.get_context("spawn")
        self.world, self.timeout = world, timeout
        self.results = ctx.Queue()
        self.tasks = [ctx.Queue() for _ in range(world)]
        coordinator = f"localhost:{free_port()}"
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, world, coordinator, self.tasks[r], self.results))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, task: str, **kwargs):
        for q in self.tasks:
            q.put((task, kwargs))
        out = [None] * self.world
        for _ in range(self.world):  # the first failure raises at once
            try:
                rank, ok, result = self.results.get(timeout=self.timeout)
            except queue.Empty:
                raise RuntimeError(f"task {task}: no result in {self.timeout} s") from None
            if not ok:
                raise RuntimeError(f"task {task} failed on rank {rank}:\n{result}")
            out[rank] = result
        return out

    def close(self) -> None:
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
