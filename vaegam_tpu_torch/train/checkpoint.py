"""Checkpoint save/resume in the JAX package's format (reference vae_reg_GP.py:452-539).

One pickle of host numpy trees, as ``vaegam_tpu.train.checkpoint`` writes
it: ``format_version``, ``params`` in JAX layout, ``optimizer_state``,
``loss``, ``z_dim``, ``epoch``, ``lr``, ``save_dir``, ``glm_reg_scale``,
``gp_kl_scale``, ``inducing_pts``, ``consts`` and ``rng_key``, written
atomically through a ``.tmp`` file.  A checkpoint written by either package
loads in the other:
  * the port writes ``optimizer_state`` as plain tuples whose leaves come in
    optax's order, which is all the JAX ``load_state`` reads (it flattens
    the tree and unflattens the leaves into its own structure);
  * a JAX checkpoint pickles optax's state classes; the port reads them with
    an unpickler that maps every ``optax.*`` class to a positional tuple, so
    loading needs neither optax nor JAX.
``rng_key`` (a JAX PRNG key) cannot continue a torch generator: the port
writes None there and keeps its generator's state under ``torch_rng_state``.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import numpy as np
import torch

_FORMAT_VERSION = 1


def checkpoint_filename(epoch: int) -> str:
    return f"checkpoint_{str(epoch).zfill(3)}.tar"


def _to_numpy(tree):
    """Dicts and tuples of tensors/arrays -> the same structure of numpy."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_numpy(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return None if tree is None else np.asarray(tree)


def save_checkpoint(
    path: str,
    params: Any,
    opt_state: Any,
    *,
    epoch: int,
    loss: Dict[str, Dict[int, float]],
    z_dim: int,
    lr: float,
    save_dir: str,
    glm_reg_scale: float,
    gp_kl_scale: float,
    inducing_pts: int,
    consts: Any = None,
    rng_key: Any = None,
    torch_rng_state: Any = None,
) -> None:
    """``params``/``opt_state``/``consts`` are trees in the JAX layout."""
    state = {
        "format_version": _FORMAT_VERSION,
        "params": _to_numpy(params),
        "optimizer_state": _to_numpy(opt_state),
        "loss": loss,
        "z_dim": z_dim,
        "epoch": epoch,
        "lr": lr,
        "save_dir": save_dir,
        "glm_reg_scale": glm_reg_scale,
        "gp_kl_scale": gp_kl_scale,
        "inducing_pts": inducing_pts,
        "consts": None if consts is None else _to_numpy(consts),
        "rng_key": None if rng_key is None else np.asarray(rng_key),
    }
    if torch_rng_state is not None:
        state["torch_rng_state"] = torch_rng_state
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)  # atomic — a crash mid-save never corrupts the ckpt


class _OptaxState(tuple):
    """Positional stand-in for an optax state class read from a JAX checkpoint."""

    def __new__(cls, *fields):
        return tuple.__new__(cls, fields)


class _Unpickler(pickle.Unpickler):
    """Reads checkpoints of either package: numpy classes as themselves,
    optax's state classes as :class:`_OptaxState`, anything else refused."""

    def find_class(self, module, name):
        root = module.split(".")[0]
        if root == "optax":
            return type(name, (_OptaxState,), {})
        if root == "numpy":
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"checkpoint references {module}.{name}")


def load_checkpoint(path: str, expect_z_dim: int | None = None) -> Dict[str, Any]:
    with open(path, "rb") as f:
        state = _Unpickler(f).load()
    if expect_z_dim is not None and state["z_dim"] != expect_z_dim:
        raise ValueError(f"checkpoint z_dim {state['z_dim']} != model z_dim "
                         f"{expect_z_dim}")
    return state


def flatten(tree) -> list:
    """Leaves of a checkpoint tree in JAX's order: tuples in order, dicts by
    sorted key, None and empty tuples holding no leaf."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in flatten(v)]
    return [] if tree is None else [tree]
