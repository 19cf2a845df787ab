"""Training runtime: train step, epoch loops, checkpoints, in torch.

Counterpart of ``vaegam_tpu.train.loop.Trainer`` (reference
vae_reg_GP.py:415-450,691-715):
  * Adam at lr 1e-3 with optax's defaults, optax's ``apply_if_finite`` skip
    semantics (``notfinite_count``, ``last_finite``, ``total_notfinite``),
    optional ``clip_by_global_norm`` with optax's formula;
  * per-epoch train loss = sum of batch losses / sample count, printed as
    "Epoch: N Average loss: ..." / "Test loss: ...";
  * test every ``test_freq`` epochs, ``checkpoint_{epoch:03d}.tar`` every
    ``save_freq`` (skipping epoch 0); resume restores params, optimizer
    state, epoch, loss history and the generator's state;
  * TensorBoard under ``save_dir/run/<MM_DD_YYYY>``: ``Loss/Train`` and the
    q(u)/q(k) figures per epoch, and every ``log_figs_every`` batches the
    beta and map figures of one maps forward.

The optimizer is written out in optax's shape rather than taken from
``torch.optim.Adam`` (``ops/adam.py``: on the card one hand-written kernel
in two launches a step, on the CPU its plain torch version): the skip of a
non-finite step is decided on the device, so a step needs no host sync.
On a non-finite gradient no parameter, Adam moment or step count changes.
Device-resident loaders feed gather-fused steps (``iter_index_batches`` +
``gather``); host loaders' numpy batches go to the card from pinned memory,
and the prefetch loader's device tensors pass through.  A float64 model
trains from host batches only (the cache's gather is float32, as in the JAX
package).

``epoch_scan`` is the counterpart of the JAX Trainer's one-dispatch scan
over a run of gather-fused steps (``_build_gather_train_scan``): on the
card each batch width's gather-fused step is captured once as a CUDA graph
and replayed for every non-figure step at that width (see
:class:`_StepGraph`); figure steps run eagerly.  The schedule, the noise
and the arithmetic are the eager path's, so on the CPU, where the "replay"
is the eager step itself, both settings give the same bits.

Data parallel (``mesh``, a ``parallel.DataMesh``), as the JAX Trainer's
``mesh``: every rank holds the same parameters, moments, counters and
generator state (rank 0's are broadcast at the start and after a load),
walks the same global batch order and draws the same global noise; its
step runs :func:`forward` on its own rows with the batch-coupled terms
reduced over the ranks, and the gradients are summed over the ranks (one
flat buffer per dtype) before the skip rule, the clip and Adam read them,
so every rank makes the same update, and the epoch loss is the global one
on every rank.  Maps forwards (figures, the output stage) gather the
global batch's maps on every rank.  TensorBoard, the qu_S diagnostics and
checkpoints are written by rank 0 alone.  Under ``epoch_scan`` the step's
collectives are captured into the CUDA graph, which NCCL allows and gloo
does not: ``epoch_scan`` with a gloo mesh is refused.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
from typing import Dict, Optional

import numpy as np
import torch

from .._device import configure_cuda_backends, resolve_device
from ..models.vaegam import (COVARIATE_KEYS, VAEGAMConfig, draw_noise, forward,
                             init_model, resolve_qu_S)
from ..ops.adam import adam, workspace
from ..parallel.mesh import (all_gather_rows, all_reduce_grads, barrier, batch_rows,
                             is_main_process, put_replicated)
from ..utils import prng, spans, tb
from ..utils.jax_params import params_from_jax, params_to_jax
from ..utils.tree import tree_items, tree_map
from .checkpoint import (checkpoint_filename, flatten, load_checkpoint,
                         save_checkpoint)


class Trainer:
    """Owns params, optimizer state and epoch counter; drives training.

    ``params``/``consts`` may be handed in (e.g. carried over from the JAX
    package with ``utils.jax_params.params_from_jax``); otherwise they are
    initialized from ``seed`` as the JAX Trainer initializes them (the same
    weights); the forward's noise comes from a torch generator seeded
    with ``seed``.  Runs on the CUDA device unless
    ``device="cpu"``; on the card it turns TF32 off for the fp32 path and
    cuDNN's algorithm search on.

    ``epoch_scan`` replays a CUDA graph of the gather-fused step on
    device-cache epochs (module docstring); ``replays`` and ``captures``
    count, by batch width, the graph replays and captures so far.  Host and
    prefetch loaders train as without it, as in the JAX package.

    ``recon_wire_dtype`` "float16" casts the output stage's maps to float16
    on the device before their copy to the host (half the bytes; the files
    stay float32); training-time figures always use fp32 maps.
    ``epoch_seconds`` (from each ``train.epoch`` span's clock reads) and
    ``output_stats`` (filled by the ``outputs`` functions) record where a
    run's time went; ``utils.spans``, when on, records the layers inside
    each epoch and step (``train.step``, ``step.gather``, ``step.forward``,
    ``step.backward``, ``step.all_reduce``, ``step.adam``, ``step.noise``,
    ``step.replay``, ``step.capture``, ``train.epoch_sync``) and around it
    (``train.test_epoch``, ``train.tb``, ``train.figures``,
    ``train.checkpoint``).
    """

    def __init__(
        self,
        config: VAEGAMConfig,
        xu_ranges=None,
        glm_maps: Optional[np.ndarray] = None,
        save_dir: str = "",
        lr: float = 1e-3,
        seed: int = 1,
        log_figs_every: int = 0,
        enable_tb: bool = True,
        skip_nonfinite_updates: bool = True,
        grad_clip: float = 0.0,
        recon_wire_dtype: str = "float32",
        epoch_scan: bool = False,
        device=None,
        params=None,
        consts=None,
        mesh=None,
    ):
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's {mesh.device}")
            device = mesh.device
            if epoch_scan and mesh.backend != "nccl":
                raise ValueError(
                    f"epoch_scan captures the step's collectives into a CUDA graph, "
                    f"which {mesh.backend} cannot: it needs NCCL, one card a rank")
        self.mesh = mesh
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            configure_cuda_backends()
        self.config = config
        self.save_dir = save_dir
        self.lr = lr
        self.log_figs_every = log_figs_every
        self.skip_nonfinite_updates = skip_nonfinite_updates
        self.grad_clip = grad_clip
        self.epoch_scan = epoch_scan
        self._graphs: Dict[int, _StepGraph] = {}   # batch width -> its graph
        self._graph_pool = None                    # one memory pool for all widths
        self.replays: Dict[int, int] = {}
        self.captures: Dict[int, int] = {}
        if recon_wire_dtype not in ("float32", "float16"):
            raise ValueError(f"recon_wire_dtype {recon_wire_dtype!r}")
        self._maps_wire = torch.float16 if recon_wire_dtype == "float16" else None
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        if params is None:
            # the JAX Trainer's init key: the second half of PRNGKey(seed)'s
            # split, so a seed gives both packages the same initial weights
            params, consts = init_model(config, xu_ranges, glm_maps,
                                        key=prng.split(prng.prng_key(seed))[1],
                                        device=self.device)
        self.consts = consts
        self._set_params(params)
        self._reset_opt_state()
        self._replicate()
        self.epoch = 0
        self.loss: Dict[str, Dict[int, float]] = {"train": {}, "test": {}}
        self.mvn_fallbacks = 0
        self._skips_warned = 0
        self.epoch_seconds: Dict[int, float] = {}
        self.output_stats: Dict[str, object] = {}

        # the figures' maps forward runs whenever figures are on, as in the
        # JAX Trainer; only the rendering needs the writer
        self._figs_enabled = bool(enable_tb and save_dir and log_figs_every)
        self._figures_missing: set = set()
        self.writer = None
        if enable_tb and save_dir and is_main_process(mesh):
            log_dir = os.path.join(save_dir, "run",
                                   datetime.datetime.now().date().strftime("%m_%d_%Y"))
            try:
                self.writer = tb.make_writer(log_dir)
            except ImportError as e:
                print(f"[tensorboard] no event file under {log_dir}: {e}")

    def _drop_graphs(self) -> None:
        """Forget the captured steps: they hold the addresses of the
        current parameters, moments and counters and the config, lr and
        consts they were captured with (the JAX Trainer rebuilds its scan
        at the same points)."""
        self._graphs = {}
        self._graph_pool = None

    def _set_params(self, params) -> None:
        self._drop_graphs()
        self.params = tree_map(
            lambda t: t.detach().to(self.device).clone().requires_grad_(True),
            params)
        self._leaves = [t for _, t in tree_items(self.params)]

    def _reset_opt_state(self, mu=None, nu=None, counters=None) -> None:
        """Fresh Adam moments and counters, or the given ones (port layout),
        and on the card a fresh workspace for the Adam kernel."""
        self._drop_graphs()

        def moment(m):
            if m is None:
                return tree_map(torch.zeros_like, self.params)
            return tree_map(lambda t, p: t.to(p), m, self.params)

        counters = counters or {}

        def scalar(name, dtype, default):
            return torch.tensor(counters.get(name, default), dtype=dtype,
                                device=self.device)

        self.opt_state = {
            "mu": moment(mu),
            "nu": moment(nu),
            "count": scalar("count", torch.int32, 0),
            "notfinite_count": scalar("notfinite_count", torch.int32, 0),
            "last_finite": scalar("last_finite", torch.bool, True),
            "total_notfinite": scalar("total_notfinite", torch.int32, 0),
        }
        self._mu = [t for _, t in tree_items(self.opt_state["mu"])]
        self._nu = [t for _, t in tree_items(self.opt_state["nu"])]
        self._adam_work = workspace(self.device) if self.device.type == "cuda" else None

    def _replicate(self) -> None:
        """Rank 0's parameters and Adam moments on every rank."""
        put_replicated(self._leaves + self._mu + self._nu, self.mesh)

    def set_conv_dtype(self, conv_dtype) -> None:
        """Switch the conv precision mid-training (e.g. an fp32 warm start
        before bf16 convs); params and optimizer state are untouched."""
        self.config = dataclasses.replace(self.config, conv_dtype=conv_dtype)
        self._drop_graphs()

    # ------------------------------------------------------------ optimizer
    def _apply_gradients(self, grads) -> None:
        """apply_if_finite(chain(clip_by_global_norm?, adam(lr))) in place
        (``ops.adam``: the CUDA kernel on the card, the plain version on
        the CPU).

        Every parameter, moment and counter keeps its storage: a captured
        step (``epoch_scan``) reads and writes them at fixed addresses."""
        adam(self._leaves, grads, self._mu, self._nu, self.opt_state, self._adam_work,
             self.lr, self.grad_clip, self.skip_nonfinite_updates)

    # ----------------------------------------------------------------- step
    def train_step(self, covariates, x, noise=None):
        """One step: forward, backward, guarded Adam update.

        noise=(eps_w, eps_d, eps_beta) injects the draws; otherwise they come
        from the Trainer's generator.  Returns (loss, aux) as device tensors.
        """
        with spans.span("step.forward"):
            loss, aux = forward(self.params, self.consts, covariates, x,
                                self.config, noise=noise, generator=self.generator,
                                mesh=self.mesh)
        with spans.span("step.backward"):
            grads = torch.autograd.grad(loss, self._leaves)
        if self.mesh is not None:
            with spans.span("step.all_reduce"):
                grads = all_reduce_grads(grads, self.mesh)
        with spans.span("step.adam"):
            self._apply_gradients(grads)
        aux = {k: v.detach() for k, v in aux.items() if torch.is_tensor(v)}
        return loss.detach(), aux

    def _put_batch(self, sample):
        """A loader's batch -> (covariates, volume) on the device in the
        model's dtype, as the JAX Trainer's ``_put_batch``: numpy batches
        are cast on the host and copied from pinned memory without blocking
        it; tensors in the model's dtype pass through untouched and narrower
        ones are cast on the device (a wider one is never narrowed).

        Under a mesh the covariates stay the global batch's; a volume batch
        of the global batch's rows (a host loader's) is cut to this rank's
        rows before its copy, refused when the ranks do not divide it, as
        JAX's placement refuses it; a loader that already cut it (the
        device cache, the prefetch loader) passes it as it is."""
        vols = sample["volume"]
        if self.mesh is not None and self.mesh.world > 1 and \
                len(vols) == len(sample["covariates"]):
            lo, hi = batch_rows(len(vols), self.mesh)
            vols = vols[lo:hi]

        def put(a):
            if torch.is_tensor(a):
                return a.to(self.device, torch.promote_types(a.dtype, self.config.dtype))
            t = torch.from_numpy(np.asarray(a, self.config.np_dtype))
            if self.device.type == "cuda":
                return t.pin_memory().to(self.device, non_blocking=True)
            return t.to(self.device)

        return put(sample["covariates"]), put(vols)

    # --------------------------------------------------------------- epochs
    def train_epoch(self, loader) -> float:
        """One epoch: gather-fused steps on a device-resident loader (graph
        replays under ``epoch_scan``), host batches otherwise.  Losses and
        fallback counts stay on the device until one sync at the end of the
        epoch."""
        with spans.timed("train.epoch", (self.epoch, None)) as epoch_span:
            # epoch-addressed shuffle: a resume continues the unbroken order
            if hasattr(loader, "set_epoch"):
                loader.set_epoch(self.epoch)
            if hasattr(loader, "iter_index_batches"):
                if loader.mesh != self.mesh:
                    raise ValueError("a device cache gathers the rows of its own mesh: "
                                     "build it with the Trainer's")
                if self.config.dtype != torch.float32:
                    raise ValueError(
                        f"a {self.config.dtype} model trains from host batches "
                        "(setup_data_loaders or setup_prefetch_loaders): the device "
                        "cache's gather restores float32, as the JAX package's does")
                if self.epoch_scan:
                    losses, fbs, last_covs = self._train_epoch_replayed(loader)
                else:
                    losses, fbs, last_covs = self._run_steps(loader.iter_index_batches(),
                                                             loader.gather)
            else:
                losses, fbs, last_covs = self._run_steps(loader, self._put_batch)
            with spans.span("train.epoch_sync"):
                train_loss = float(losses.sum()) if losses is not None else 0.0
                self._account_mvn_fallbacks(fbs)
                if not np.isfinite(train_loss):
                    # a non-PSD qu_S turns the loss NaN through the KL Cholesky
                    self.check_gp_stability(last_covs)
                if self.skip_nonfinite_updates:
                    skipped = int(self.opt_state["total_notfinite"])
                    if skipped and skipped != self._skips_warned:
                        self._skips_warned = skipped
                        print(f"  [warn] {skipped} non-finite gradient step(s) "
                              "skipped so far (reference would have crashed here)")
            train_loss /= loader.num_samples
            print(f"Epoch: {self.epoch} Average loss: {train_loss:.4f}")
        self.epoch_seconds[self.epoch] = epoch_span.seconds
        self.epoch += 1
        return train_loss

    def _is_figure_step(self, batch_idx) -> bool:
        return self._figs_enabled and batch_idx % self.log_figs_every == 0

    def _step_figures(self, covs, x) -> None:
        """A figure step's figures, from the step's own gathered batch: on
        the device cache this is the JAX Trainer's re-gather of the sampled
        batch alone."""
        with spans.span("train.figures"):
            self._log_batch_figures(covs, x, "train")

    def _run_steps(self, batches, put):
        """Eager steps over a loader's batches (a device cache's index
        arrays, or host samples), each made (covariates, volume) on the
        device by `put`; returns the losses and fallback counts stacked on
        the device (None for no batch) and the last batch's covariates."""
        losses, fbs, last_covs = [], [], None
        for batch_idx, batch in enumerate(batches):
            with spans.step(self.epoch, batch_idx, _width(batch), "eager"):
                with spans.span("step.gather"):
                    covs, x = put(batch)
                loss, aux = self.train_step(covs, x)
                losses.append(loss)
                fbs.append(aux["mvn_fallbacks"])
                last_covs = covs
                if self._is_figure_step(batch_idx):
                    self._step_figures(covs, x)
        if not losses:
            return None, None, None
        return torch.stack(losses), torch.stack(fbs), last_covs

    def _train_epoch_replayed(self, loader):
        """The device-cache epoch under ``epoch_scan``, in the loader's
        order: figure steps eagerly with their figures, as without it;
        every other step through :meth:`_replay_step`.  The epoch's indices
        go to the device in one copy; losses and fallback counts collect in
        per-epoch device buffers.  Returns what :meth:`_run_steps` does."""
        sels = list(loader.iter_index_batches())
        if not sels:
            return None, None, None
        order = loader.upload_indices(sels)
        losses = fbs = None
        start = 0
        for i, sel in enumerate(sels):
            figure = self._is_figure_step(i)
            with spans.step(self.epoch, i, len(sel), "eager" if figure else "replay"):
                if figure:
                    with spans.span("step.gather"):
                        covs, x = loader.gather(sel)
                    loss, aux = self.train_step(covs, x)
                    fb = aux["mvn_fallbacks"]
                    self._step_figures(covs, x)
                else:
                    loss, fb = self._replay_step(loader, order[start:start + len(sel)])
                if losses is None:
                    losses, fbs = loss.new_empty(len(sels)), fb.new_empty(len(sels))
                # read a graph's outputs before the next replay: the graphs
                # share one memory pool
                losses[i].copy_(loss)
                fbs[i].copy_(fb)
            start += len(sel)
        return losses, fbs, loader.covs.index_select(0, order[-len(sels[-1]):])

    def _replay_step(self, loader, idx):
        """One non-figure gather-fused step of an ``epoch_scan`` epoch on
        the rows ``idx`` (a device tensor); returns (loss, fallback count)
        as device tensors.

        The noise is drawn here, eagerly, from the Trainer's generator in
        ``draw_noise``'s order, so the generator advances as in an eager
        step.  On the CPU the step then runs eagerly.  On the card the
        first step at a width runs eagerly through :class:`_StepGraph`'s
        static buffers (on a side stream; it is a real step of the
        schedule, and it runs cuDNN's algorithm search for the width), the
        width's graph is captured after it, and every later step at that
        width is a replay.  A capture or replay that fails raises."""
        width = idx.shape[0]
        with spans.span("step.noise"):
            noise = draw_noise(self.generator, width, self.config, self.device)
        if self.device.type != "cuda":
            spans.annotate(kind="eager")
            with spans.span("step.gather"):
                covs, x = loader.gather_index(idx)
            loss, aux = self.train_step(covs, x, noise=noise)
            return loss, aux["mvn_fallbacks"]
        g = self._graphs.get(width)
        if g is None or not g.reads(loader):
            spans.annotate(kind="capture")
            with spans.span("step.capture"):
                g = _StepGraph(loader, idx, noise)
                out = g.warm_up(self.train_step)
                if self._graph_pool is None:
                    self._graph_pool = torch.cuda.graph_pool_handle()
                # NCCL's watchdog thread queries events while a capture runs
                g.capture(self.train_step, self._graph_pool,
                          "global" if self.mesh is None else "thread_local")
            self._graphs[width] = g
            self.captures[width] = self.captures.get(width, 0) + 1
            return out
        with spans.span("step.replay"):
            g.load(idx, noise)
            g.graph.replay()
        self.replays[width] = self.replays.get(width, 0) + 1
        return g.loss, g.fallbacks

    def _account_mvn_fallbacks(self, fbs) -> None:
        n = int(fbs.sum()) if fbs is not None else 0
        if n:
            self.mvn_fallbacks += n
            print(f"  [warn] {n} gain-covariance Cholesky fallback(s) this "
                  f"epoch (escalating jitter engaged; {self.mvn_fallbacks} "
                  "total — reference would have crashed at the first)")

    @torch.no_grad()
    def test_epoch(self, loader) -> float:
        """Forward with generator-drawn noise over every batch, no gradient;
        the loss normalized like the train loss."""
        with spans.span("train.test_epoch"):
            losses = []
            for sample in loader:
                covs, x = self._put_batch(sample)
                loss, _ = forward(self.params, self.consts, covs, x, self.config,
                                  generator=self.generator, mesh=self.mesh)
                losses.append(loss)
            test_loss = float(torch.stack(losses).sum()) if losses else 0.0
        test_loss /= loader.num_samples
        print(f"Test loss: {test_loss:.4f}")
        return test_loss

    def train_loop(self, loaders, epochs=100, test_freq=2, save_freq=10,
                   save_dir: str = ""):
        print("=" * 40)
        print("Training: epochs", self.epoch, "to", self.epoch + epochs - 1)
        print("Training set:", loaders["Shuffled_train"].num_samples)
        print("Test set:", loaders["test"].num_samples)
        print("=" * 40)
        for epoch in range(self.epoch, self.epoch + epochs):
            loss = self.train_epoch(loaders["Shuffled_train"])
            self.loss["train"][epoch] = loss
            if self.writer is not None:
                with spans.span("train.tb", (epoch, None)):
                    self.writer.add_scalar("Loss/Train", loss, self.epoch)
                    gp_np = {k: v.detach().cpu().numpy()
                             for k, v in self.params["gp"].items()}
                    gp_np["qu_S"] = resolve_qu_S(self.params["gp"]).detach().cpu().numpy()
                    xu_np = self.consts["xu"].cpu().numpy()
                    self._figure("q(u)_train", tb.log_qu_plots, self.epoch, gp_np,
                                 xu_np, self.writer, "train")
                    self._figure("q(k)_train", tb.log_qkappa_plots, gp_np,
                                 self.writer, "train")
                    self.writer.flush()
            if test_freq is not None and epoch % test_freq == 0:
                self.loss["test"][epoch] = self.test_epoch(loaders["test"])
            if save_freq is not None and epoch % save_freq == 0 and epoch > 0:
                self.save_state(os.path.join(save_dir or self.save_dir,
                                             checkpoint_filename(epoch)))
        if self.writer is not None:
            self.writer.flush()

    # ------------------------------------------------------------ maps steps
    @torch.no_grad()
    def maps_step(self, covs, x, wire=None):
        """Forward with maps and generator-drawn noise; with ``wire`` the
        maps are cast to it on the device.  Returns (loss, aux).  Under a
        mesh every rank runs it and receives the global batch's maps and z
        (on the wire when given)."""
        loss, aux = forward(self.params, self.consts, covs, x, self.config,
                            generator=self.generator, return_maps=True, mesh=self.mesh)
        if wire is not None:
            aux["maps"] = {k: v.to(wire) for k, v in aux["maps"].items()}
        if self.mesh is not None:
            n = len(covs)
            aux["maps"] = {k: all_gather_rows(v, self.mesh, n)
                           for k, v in aux["maps"].items()}
            aux["z"] = all_gather_rows(aux["z"], self.mesh, n)
        return loss, aux

    def recon_maps_step(self, covs, x):
        """The output stage's maps step: :meth:`maps_step` on the
        ``recon_wire_dtype`` wire."""
        return self.maps_step(covs, x, self._maps_wire)

    # -------------------------------------------------------- observability
    def _figure(self, tag, fn, *args) -> None:
        """Render one TensorBoard figure; without its plotting library, say
        once which figure is not written and why."""
        try:
            fn(*args)
        except ImportError as e:
            if tag not in self._figures_missing:
                self._figures_missing.add(tag)
                print(f"[tensorboard] figure {tag} not written: {e}")

    def _log_batch_figures(self, covs, x, log_type):
        """Per-batch beta and map figures from one fp32 maps forward (the
        reference logs these every batch)."""
        _, aux = self.maps_step(covs, x)
        if self.writer is None:
            return
        maps = {k: v.cpu().numpy() for k, v in aux["maps"].items()}
        b = maps["base"].shape[0]
        for slc in (12, 15, 18):
            for key, name in (("base", "base_map"), ("task", "task_map"),
                              ("full_rec", "full_reconstruction")):
                self._figure(f"{name}_{log_type}", tb.log_map, self.writer,
                             self.config.img_shape, maps[key], slc, name, b,
                             log_type)
        beta_mean = aux["beta_mean"].cpu().numpy()
        beta_var = aux["beta_cov_diag"].cpu().numpy()
        covs_np = covs.cpu().numpy()
        for j, name in enumerate(COVARIATE_KEYS):
            self._figure(f"Beta/{name}_{log_type}", tb.log_beta, self.writer,
                         covs_np[:, j], beta_mean[j], beta_var[j], name, log_type)

    def check_gp_stability(self, covariates=None) -> bool:
        """Dump qu_S diagnostics if any GP posterior cov went non-PSD
        (the reference's qu_S_diagnostics.tar, gp.py:47-63; rank 0 writes
        it).  Returns True if healthy."""
        gp_np = {k: v.detach().cpu().numpy() for k, v in self.params["gp"].items()}
        gp_np["qu_S"] = resolve_qu_S(self.params["gp"]).detach().cpu().numpy()
        if torch.is_tensor(covariates):
            covariates = covariates.cpu().numpy()
        healthy = True
        for j in range(gp_np["qu_S"].shape[0]):
            try:
                if not np.isfinite(gp_np["qu_S"][j]).all():
                    raise np.linalg.LinAlgError("non-finite qu_S")
                np.linalg.cholesky(gp_np["qu_S"][j].astype(np.float64))
            except np.linalg.LinAlgError:
                healthy = False
                print("Oops, something went wrong with qu_S!!")
                if not is_main_process(self.mesh):
                    continue
                diag = {
                    "qu_m": gp_np["qu_m"][j],
                    "qu_S": gp_np["qu_S"][j],
                    "ls": gp_np["log_ls"][j],
                    "k_var": gp_np["logkvar"][j],
                    "Xu": self.consts["xu"][j].cpu().numpy(),
                    "cov_id": j + 1,
                    "batch_vals": covariates,
                }
                fname = os.path.join(self.save_dir, "qu_S_diagnostics.tar")
                with open(fname, "wb") as f:
                    pickle.dump(diag, f)
        return healthy

    # ---------------------------------------------------------- checkpoints
    def _opt_state_to_jax(self):
        """The optimizer state as the JAX Trainer's optax tree, in plain
        tuples: apply_if_finite(chain(clip?, adam)) with adam itself
        chain(scale_by_adam, scale_by_learning_rate)."""
        st = self.opt_state
        mu, _ = params_to_jax(st["mu"], None, self.config)
        nu, _ = params_to_jax(st["nu"], None, self.config)
        inner = ((st["count"], mu, nu), ())
        if self.grad_clip and self.grad_clip > 0:
            inner = ((), inner)
        if not self.skip_nonfinite_updates:
            return inner
        return (st["notfinite_count"], st["last_finite"], st["total_notfinite"], inner)

    def save_state(self, filename: str):
        """Write a checkpoint (rank 0; every rank waits until it exists)."""
        with spans.span("train.checkpoint"):
            if not is_main_process(self.mesh):
                barrier(self.mesh)
                return
            params, consts = params_to_jax(self.params, self.consts, self.config)
            save_checkpoint(
                filename,
                params,
                self._opt_state_to_jax(),
                epoch=self.epoch,
                loss=self.loss,
                z_dim=self.config.z_dim,
                lr=self.lr,
                save_dir=self.save_dir,
                glm_reg_scale=self.config.glm_reg_scale,
                gp_kl_scale=self.config.gp_kl_scale,
                inducing_pts=self.config.num_inducing_pts,
                consts=consts,
                torch_rng_state={"device": self.device.type,
                                 "state": self.generator.get_state().numpy()},
            )
            barrier(self.mesh)

    def _load_opt_state(self, opt_state, jax_params) -> None:
        """Optimizer leaves in optax's order -> the port's state; a structure
        mismatch restarts Adam, as the JAX Trainer does."""
        flat = flatten(opt_state)
        paths = [p for p, _ in tree_items(jax_params)]
        n = len(paths)
        heads = ("notfinite_count", "last_finite", "total_notfinite", "count") \
            if self.skip_nonfinite_updates else ("count",)
        shapes = [np.shape(a) for _, a in tree_items(jax_params)]
        ok = (len(flat) == len(heads) + 2 * n and
              [np.shape(a) for a in flat[len(heads):]] == shapes * 2)
        if not ok:
            print("[load_state] optimizer-state structure mismatch — "
                  "reinitializing optimizer moments")
            self._reset_opt_state()
            return
        moments = flat[len(heads):]

        def as_tree(leaves):
            tree: dict = {}
            for path, leaf in zip(paths, leaves):
                *parents, last = path.split("/")
                node = tree
                for k in parents:
                    node = node.setdefault(k, {})
                node[last] = leaf
            return params_from_jax(tree, None, self.config, self.device)[0]

        self._reset_opt_state(
            as_tree(moments[:n]), as_tree(moments[n:]),
            {k: np.asarray(v).item() for k, v in zip(heads, flat)})

    def load_state(self, filename: str):
        state = load_checkpoint(filename, expect_z_dim=self.config.z_dim)
        # adopt the checkpoint's hyperparameter scalars, like the reference
        # (vae_reg_GP.py:477-487); any adoption is printed
        cfg_changes = {}
        for ckpt_key, cfg_key in (
            ("gp_kl_scale", "gp_kl_scale"),
            ("glm_reg_scale", "glm_reg_scale"),
            ("inducing_pts", "num_inducing_pts"),
        ):
            val = state.get(ckpt_key)
            if val is not None and val != getattr(self.config, cfg_key):
                cfg_changes[cfg_key] = val
        if cfg_changes:
            print(f"[load_state] adopting checkpoint scalars over CLI/config "
                  f"values: {cfg_changes}")
            self.config = dataclasses.replace(self.config, **cfg_changes)
        ckpt_lr = state.get("lr")
        if ckpt_lr is not None and float(ckpt_lr) != self.lr:
            print(f"[load_state] adopting checkpoint lr {ckpt_lr} "
                  f"(was {self.lr})")
            self.lr = float(ckpt_lr)
        params, consts = params_from_jax(state["params"], state.get("consts"),
                                         self.config, self.device)
        self._set_params(params)   # drops the captured steps too
        if consts is not None:
            self.consts = consts
        self._load_opt_state(state["optimizer_state"], state["params"])
        self._replicate()
        self.loss = state["loss"]
        self.epoch = state["epoch"]
        rng = state.get("torch_rng_state")
        if rng is not None and rng["device"] == self.device.type:
            self.generator.set_state(torch.from_numpy(np.asarray(rng["state"])))
        else:
            print("[load_state] the checkpoint holds no torch generator state "
                  f"for {self.device.type} (a JAX checkpoint keeps a JAX PRNG "
                  "key): the PRNG chain restarts from this Trainer's seed")


def _width(batch) -> int:
    """A batch's rows: an index array's length, a host sample's covariates'."""
    return len(batch["covariates"]) if isinstance(batch, dict) else len(batch)


class _StepGraph:
    """One batch width's gather-fused train step as a CUDA graph.

    Static inputs: the batch's rows of the device cache (``idx``) and the
    forward's three noise tensors, refilled before each replay.  The
    parameters, Adam moments and counters are updated in place at their own
    addresses (:meth:`Trainer._apply_gradients`); the cache's volumes and
    covariates are read where they lie.  Static outputs: the step's loss
    and gain-Cholesky fallback count, to be read before the next replay of
    any graph of the Trainer (they share one memory pool).  conv5's wrapper
    counts a launch recorded into the graph in ``conv5.captured``, not in
    ``conv5.launches``; each replay runs it once more (``Trainer.replays``).
    It holds no reference to its Trainer (the Trainer's train step is
    passed in), so dropping a Trainer frees its graphs and their pool.
    """

    def __init__(self, loader, idx, noise):
        self.vols, self.covs = loader.vols, loader.covs
        self.gather_index = loader.gather_index
        self.idx = idx.clone()
        self.noise = tuple(n.clone() for n in noise)
        self.graph = None

    def reads(self, loader) -> bool:
        """Whether this graph gathers from `loader`'s cache."""
        return loader.vols is self.vols and loader.covs is self.covs

    def load(self, idx, noise) -> None:
        self.idx.copy_(idx)
        for buf, n in zip(self.noise, noise):
            buf.copy_(n)

    def _step(self, train_step):
        with spans.span("step.gather"):
            covs, x = self.gather_index(self.idx)
        loss, aux = train_step(covs, x, noise=self.noise)
        return loss, aux["mvn_fallbacks"]

    def warm_up(self, train_step):
        """The step, eagerly, on a side stream (as ``torch.cuda.graph``
        asks of the work before a capture); returns its outputs."""
        main = torch.cuda.current_stream(self.idx.device)
        side = torch.cuda.Stream(self.idx.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self._step(train_step)
        main.wait_stream(side)
        return out

    def capture(self, train_step, pool, error_mode="global") -> None:
        """Record the step; nothing runs until :meth:`graph.replay`."""
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, capture_error_mode=error_mode):
            self.loss, self.fallbacks = self._step(train_step)
