"""Training step and device-resident epoch loop, in torch.

Counterpart of the part of ``vaegam_tpu.train.loop.Trainer`` that the train
step needs: Adam at lr 1e-3 with optax's defaults, optax's
``apply_if_finite`` skip semantics, optional ``clip_by_global_norm`` with
optax's formula, the gather-fused step and the device-resident epoch.

The optimizer is written out here in optax's shape rather than taken from
``torch.optim.Adam``: the skip of a non-finite step is a ``torch.where`` on
the device, so a step needs no host sync.  On a non-finite gradient no
parameter, Adam moment or step count changes, and ``total_notfinite``
increments, exactly as under ``optax.apply_if_finite``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from .._device import configure_cuda_backends, resolve_device
from ..models.vaegam import VAEGAMConfig, forward, init_model
from ..utils.tree import tree_items, tree_map

_B1, _B2, _EPS = 0.9, 0.999, 1e-8  # optax.adam defaults (eps_root 0)


class Trainer:
    """Owns params, optimizer state and epoch counter; drives training.

    ``params``/``consts`` may be handed in (e.g. carried over from the JAX
    package with ``utils.jax_params.params_from_jax``); otherwise they are
    initialized from ``seed``.  Runs on the CUDA device unless
    ``device="cpu"``; on the card it turns TF32 off for the fp32 path and
    cuDNN's algorithm search on.
    """

    def __init__(
        self,
        config: VAEGAMConfig,
        xu_ranges=None,
        glm_maps: Optional[np.ndarray] = None,
        lr: float = 1e-3,
        seed: int = 1,
        skip_nonfinite_updates: bool = True,
        grad_clip: float = 0.0,
        device=None,
        params=None,
        consts=None,
    ):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            configure_cuda_backends()
        self.config = config
        self.lr = lr
        self.skip_nonfinite_updates = skip_nonfinite_updates
        self.grad_clip = grad_clip
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        if params is None:
            params, consts = init_model(config, xu_ranges, glm_maps,
                                        generator=self.generator,
                                        device=self.device)
        self.params = tree_map(
            lambda t: t.detach().to(self.device).clone().requires_grad_(True),
            params)
        self.consts = consts
        self._leaves = [t for _, t in tree_items(self.params)]
        zeros = lambda t: torch.zeros_like(t, requires_grad=False)  # noqa: E731
        i32 = lambda: torch.zeros((), dtype=torch.int32, device=self.device)  # noqa: E731
        self.opt_state = {
            "mu": tree_map(zeros, self.params),
            "nu": tree_map(zeros, self.params),
            "count": i32(),
            "total_notfinite": i32(),
        }
        self._mu = [t for _, t in tree_items(self.opt_state["mu"])]
        self._nu = [t for _, t in tree_items(self.opt_state["nu"])]
        self.epoch = 0
        self.mvn_fallbacks = 0
        self._skips_warned = 0
        self.epoch_seconds: Dict[int, float] = {}

    # ------------------------------------------------------------ optimizer
    @torch.no_grad()
    def _apply_gradients(self, grads) -> None:
        """apply_if_finite(chain(clip_by_global_norm?, adam(lr))) in place."""
        st = self.opt_state
        if self.skip_nonfinite_updates:
            finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        else:
            finite = torch.ones((), dtype=torch.bool, device=self.device)
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
            p.copy_(torch.where(finite, p + upd, p))
            m.copy_(torch.where(finite, m_new, m))
            v.copy_(torch.where(finite, v_new, v))
        st["count"] = torch.where(finite, count_inc, st["count"])
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

    # --------------------------------------------------------------- epochs
    def train_epoch(self, loader) -> float:
        """One epoch over a device-resident loader (on-device batch gather).

        Losses and fallback counts stay on the device until one sync at the
        end of the epoch.
        """
        t0 = time.perf_counter()
        loader.set_epoch(self.epoch)
        losses, fbs = [], []
        for sel in loader.iter_index_batches():
            covs, x = loader.gather(sel)
            loss, aux = self.train_step(covs, x)
            losses.append(loss)
            fbs.append(aux["mvn_fallbacks"])
        train_loss = float(torch.stack(losses).sum()) if losses else 0.0
        n_fb = int(torch.stack(fbs).sum()) if fbs else 0
        if n_fb:
            self.mvn_fallbacks += n_fb
            print(f"  [warn] {n_fb} gain-covariance Cholesky fallback(s) this "
                  f"epoch ({self.mvn_fallbacks} total)")
        skipped = int(self.opt_state["total_notfinite"])
        if skipped and skipped != self._skips_warned:
            self._skips_warned = skipped
            print(f"  [warn] {skipped} non-finite gradient step(s) skipped so far")
        train_loss /= loader.num_samples
        print(f"Epoch: {self.epoch} Average loss: {train_loss:.4f}")
        self.epoch_seconds[self.epoch] = time.perf_counter() - t0
        self.epoch += 1
        return train_loss
