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
``torch.optim.Adam``: the skip of a non-finite step is a ``torch.where`` on
the device, so a step needs no host sync.  On a non-finite gradient no
parameter, Adam moment or step count changes.  Device-resident loaders feed
gather-fused steps (``iter_index_batches`` + ``gather``); host loaders'
numpy batches go to the card from pinned memory.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import time
from typing import Dict, Optional

import numpy as np
import torch

from .._device import configure_cuda_backends, resolve_device
from ..models.vaegam import (COVARIATE_KEYS, VAEGAMConfig, forward, init_model,
                             resolve_qu_S)
from ..utils import tb
from ..utils.jax_params import params_from_jax, params_to_jax
from ..utils.tree import tree_items, tree_map
from .checkpoint import (checkpoint_filename, flatten, load_checkpoint,
                         save_checkpoint)

_B1, _B2, _EPS = 0.9, 0.999, 1e-8  # optax.adam defaults (eps_root 0)
MAX_CONSECUTIVE_ERRORS = 100000    # as the JAX Trainer's apply_if_finite


class Trainer:
    """Owns params, optimizer state and epoch counter; drives training.

    ``params``/``consts`` may be handed in (e.g. carried over from the JAX
    package with ``utils.jax_params.params_from_jax``); otherwise they are
    initialized from ``seed``.  Runs on the CUDA device unless
    ``device="cpu"``; on the card it turns TF32 off for the fp32 path and
    cuDNN's algorithm search on.

    ``recon_wire_dtype`` "float16" casts the output stage's maps to float16
    on the device before their copy to the host (half the bytes; the files
    stay float32); training-time figures always use fp32 maps.
    ``epoch_seconds``, ``tb_seconds`` (the per-epoch TensorBoard logging),
    ``figure_seconds`` (the per-batch figures of an epoch, their maps
    forward included) and ``output_stats`` (filled by the ``outputs``
    functions) record where a run's time went.
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
        device=None,
        params=None,
        consts=None,
    ):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            configure_cuda_backends()
        self.config = config
        self.save_dir = save_dir
        self.lr = lr
        self.log_figs_every = log_figs_every
        self.skip_nonfinite_updates = skip_nonfinite_updates
        self.grad_clip = grad_clip
        if recon_wire_dtype not in ("float32", "float16"):
            raise ValueError(f"recon_wire_dtype {recon_wire_dtype!r}")
        self._maps_wire = torch.float16 if recon_wire_dtype == "float16" else None
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        if params is None:
            params, consts = init_model(config, xu_ranges, glm_maps,
                                        generator=self.generator,
                                        device=self.device)
        self.consts = consts
        self._set_params(params)
        self._reset_opt_state()
        self.epoch = 0
        self.loss: Dict[str, Dict[int, float]] = {"train": {}, "test": {}}
        self.mvn_fallbacks = 0
        self._skips_warned = 0
        self.epoch_seconds: Dict[int, float] = {}
        self.tb_seconds: Dict[int, float] = {}
        self.figure_seconds: Dict[int, float] = {}
        self.output_stats: Dict[str, object] = {}

        # the figures' maps forward runs whenever figures are on, as in the
        # JAX Trainer; only the rendering needs the writer
        self._figs_enabled = bool(enable_tb and save_dir and log_figs_every)
        self._figures_missing: set = set()
        self.writer = None
        if enable_tb and save_dir:
            log_dir = os.path.join(save_dir, "run",
                                   datetime.datetime.now().date().strftime("%m_%d_%Y"))
            try:
                self.writer = tb.make_writer(log_dir)
            except ImportError as e:
                print(f"[tensorboard] no event file under {log_dir}: {e}")

    def _set_params(self, params) -> None:
        self.params = tree_map(
            lambda t: t.detach().to(self.device).clone().requires_grad_(True),
            params)
        self._leaves = [t for _, t in tree_items(self.params)]

    def _reset_opt_state(self, mu=None, nu=None, counters=None) -> None:
        """Fresh Adam moments and counters, or the given ones (port layout)."""
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

    def set_conv_dtype(self, conv_dtype) -> None:
        """Switch the conv precision mid-training (e.g. an fp32 warm start
        before bf16 convs); params and optimizer state are untouched."""
        self.config = dataclasses.replace(self.config, conv_dtype=conv_dtype)

    # ------------------------------------------------------------ optimizer
    @torch.no_grad()
    def _apply_gradients(self, grads) -> None:
        """apply_if_finite(chain(clip_by_global_norm?, adam(lr))) in place."""
        st = self.opt_state
        if self.skip_nonfinite_updates:
            finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        else:
            finite = torch.ones((), dtype=torch.bool, device=self.device)
        notfinite_count = torch.where(finite, torch.zeros_like(st["notfinite_count"]),
                                      st["notfinite_count"] + 1)
        apply = finite | (notfinite_count > MAX_CONSECUTIVE_ERRORS)
        if self.grad_clip and self.grad_clip > 0:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            trigger = g_norm < self.grad_clip
            grads = [torch.where(trigger, g, (g / g_norm) * self.grad_clip)
                     for g in grads]
        count_inc = st["count"] + 1
        # bias corrections in the parameters' precision, as optax computes them
        c = count_inc.to(self._leaves[0].dtype)
        bc1 = 1.0 - torch.pow(torch.full_like(c, _B1), c)
        bc2 = 1.0 - torch.pow(torch.full_like(c, _B2), c)
        for p, g, m, v in zip(self._leaves, grads, self._mu, self._nu):
            m_new = (1 - _B1) * g + _B1 * m
            v_new = (1 - _B2) * (g * g) + _B2 * v
            upd = -self.lr * ((m_new / bc1) / (torch.sqrt(v_new / bc2) + _EPS))
            p.copy_(torch.where(apply, p + upd, p))
            m.copy_(torch.where(apply, m_new, m))
            v.copy_(torch.where(apply, v_new, v))
        st["count"] = torch.where(apply, count_inc, st["count"])
        st["notfinite_count"] = notfinite_count
        st["last_finite"] = finite
        st["total_notfinite"] = st["total_notfinite"] + (~finite).to(torch.int32)

    # ----------------------------------------------------------------- step
    def train_step(self, covariates, x, noise=None):
        """One step: forward, backward, guarded Adam update.

        noise=(eps_w, eps_d, eps_beta) injects the draws; otherwise they come
        from the Trainer's generator.  Returns (loss, aux) as device tensors.
        """
        loss, aux = forward(self.params, self.consts, covariates, x,
                            self.config, noise=noise, generator=self.generator)
        grads = torch.autograd.grad(loss, self._leaves)
        self._apply_gradients(grads)
        aux = {k: v.detach() for k, v in aux.items() if torch.is_tensor(v)}
        return loss.detach(), aux

    def _put_batch(self, sample):
        """A loader's batch -> (covariates, volume) float32 on the device.
        Device tensors pass through; numpy batches are copied from pinned
        memory without blocking the host."""
        def put(a):
            if torch.is_tensor(a):
                return a.to(self.device)
            t = torch.from_numpy(np.asarray(a, np.float32))
            if self.device.type == "cuda":
                return t.pin_memory().to(self.device, non_blocking=True)
            return t.to(self.device)

        return put(sample["covariates"]), put(sample["volume"])

    # --------------------------------------------------------------- epochs
    def train_epoch(self, loader) -> float:
        """One epoch: gather-fused steps on a device-resident loader, host
        batches otherwise.  Losses and fallback counts stay on the device
        until one sync at the end of the epoch."""
        t0 = time.perf_counter()
        # epoch-addressed shuffle: a resume continues the unbroken order
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(self.epoch)
        if hasattr(loader, "iter_index_batches"):
            batches = (loader.gather(sel) for sel in loader.iter_index_batches())
        else:
            batches = (self._put_batch(s) for s in loader)
        losses, fbs, last_covs = [], [], None
        for batch_idx, (covs, x) in enumerate(batches):
            loss, aux = self.train_step(covs, x)
            losses.append(loss)
            fbs.append(aux["mvn_fallbacks"])
            last_covs = covs
            if self._figs_enabled and batch_idx % self.log_figs_every == 0:
                # the step's own gathered batch: on the device cache this is
                # the JAX Trainer's re-gather of the sampled batch alone
                t_fig = time.perf_counter()
                self._log_batch_figures(covs, x, "train")
                self.figure_seconds[self.epoch] = (
                    self.figure_seconds.get(self.epoch, 0.0)
                    + time.perf_counter() - t_fig)
        train_loss = float(torch.stack(losses).sum()) if losses else 0.0
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
        self.epoch_seconds[self.epoch] = time.perf_counter() - t0
        self.epoch += 1
        return train_loss

    def _account_mvn_fallbacks(self, fbs) -> None:
        n = int(torch.stack(fbs).sum()) if fbs else 0
        if n:
            self.mvn_fallbacks += n
            print(f"  [warn] {n} gain-covariance Cholesky fallback(s) this "
                  f"epoch (escalating jitter engaged; {self.mvn_fallbacks} "
                  "total — reference would have crashed at the first)")

    @torch.no_grad()
    def test_epoch(self, loader) -> float:
        """Forward with generator-drawn noise over every batch, no gradient;
        the loss normalized like the train loss."""
        losses = []
        for sample in loader:
            covs, x = self._put_batch(sample)
            loss, _ = forward(self.params, self.consts, covs, x, self.config,
                              generator=self.generator)
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
                t0 = time.perf_counter()
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
                self.tb_seconds[epoch] = time.perf_counter() - t0
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
        maps are cast to it on the device.  Returns (loss, aux)."""
        loss, aux = forward(self.params, self.consts, covs, x, self.config,
                            generator=self.generator, return_maps=True)
        if wire is not None:
            aux["maps"] = {k: v.to(wire) for k, v in aux["maps"].items()}
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
        (the reference's qu_S_diagnostics.tar, gp.py:47-63).  Returns True
        if healthy."""
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
        self._set_params(params)
        if consts is not None:
            self.consts = consts
        self._load_opt_state(state["optimizer_state"], state["params"])
        self.loss = state["loss"]
        self.epoch = state["epoch"]
        rng = state.get("torch_rng_state")
        if rng is not None and rng["device"] == self.device.type:
            self.generator.set_state(torch.from_numpy(np.asarray(rng["state"])))
        else:
            print("[load_state] the checkpoint holds no torch generator state "
                  f"for {self.device.type} (a JAX checkpoint keeps a JAX PRNG "
                  "key): the PRNG chain restarts from this Trainer's seed")
