"""Carry JAX parameter trees (as numpy arrays) into the port's layout and back.

Its own copy of the layout logic of ``vaegam_tpu/utils/torch_export.py``
(that module imports the JAX model):
  * Conv3d weight DHWIO                     -> (O, I, kD, kH, kW)
  * ConvTranspose3d weight (flipped DHWIO)  -> unflip + (I, O, kD, kH, kW)
  * Linear weight (in, out)                 -> (out, in)
  * encoder fc1 / decoder fc8: JAX flattens conv features channel-minor,
    torch channel-major; permute fc1's input columns and fc8's output rows
  * BatchNorm scale/shift, epsilon and the stacked GP bank carry over as is
    (``qu_S`` or the Cholesky parameterization's ``qu_S_raw``, whichever
    the tree holds); a float64 leaf (a float64 model, an ``x64_epsilon``)
    stays float64, every other leaf is float32.
Every mapping is a permutation or a flip, so the same function also maps a
JAX GRADIENT tree (or Adam moment tree) onto the port's layout, and
``params_to_jax`` inverts it exactly (checkpoints are written in JAX layout).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models.vaegam import VAEGAMConfig
from .tree import tree_map

_CONVS = ("conv1", "conv2", "conv3", "conv4", "conv5")
_CONVTS = ("convt1", "convt2", "convt3", "convt4", "convt5")


def _np(a) -> np.ndarray:
    """A leaf as numpy: float64 stays float64, anything else is float32."""
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    return np.asarray(a, np.float64 if a.dtype == np.float64 else np.float32)


def _conv_w(w) -> np.ndarray:
    """(kD, kH, kW, I, O) -> (O, I, kD, kH, kW)."""
    return np.transpose(_np(w), (4, 3, 0, 1, 2))


def _convt_w(w) -> np.ndarray:
    """Flipped (kD, kH, kW, I, O) -> (I, O, kD, kH, kW)."""
    return np.transpose(_np(w)[::-1, ::-1, ::-1], (3, 4, 0, 1, 2))


def _conv_w_inv(w) -> np.ndarray:
    return np.transpose(_np(w), (2, 3, 4, 1, 0))


def _convt_w_inv(w) -> np.ndarray:
    return np.transpose(_np(w), (2, 3, 4, 0, 1))[::-1, ::-1, ::-1]


def _fc1_w(w, c: int) -> np.ndarray:
    """(in, out) with channel-minor input -> (out, in) channel-major."""
    w = _np(w)
    spatial = w.shape[0] // c
    return w.reshape(spatial, c, -1).transpose(1, 0, 2).reshape(c * spatial, -1).T


def _fc8(p, c: int):
    """(in, out) with channel-minor output -> (out, in) channel-major."""
    w, b = _np(p["w"]), _np(p["b"])
    spatial = w.shape[1] // c
    w = w.reshape(w.shape[0], spatial, c).transpose(0, 2, 1).reshape(w.shape[0], -1)
    return w.T, b.reshape(spatial, c).T.reshape(-1)


def _fc1_w_inv(w, c: int) -> np.ndarray:
    """(out, in) channel-major -> (in, out) with channel-minor input."""
    w = _np(w).T
    spatial = w.shape[0] // c
    return w.reshape(c, spatial, -1).transpose(1, 0, 2).reshape(c * spatial, -1)


def _fc8_inv(p, c: int):
    """(out, in) channel-major output -> (in, out) channel-minor output."""
    w, b = _np(p["w"]).T, _np(p["b"])
    spatial = w.shape[1] // c
    w = w.reshape(w.shape[0], c, spatial).transpose(0, 2, 1).reshape(w.shape[0], -1)
    return w, b.reshape(c, spatial).T.reshape(-1)


def convert_net(net: Dict[str, Any], c: int) -> Dict[str, Dict[str, np.ndarray]]:
    """One network's layers, JAX layout -> the port's (torch) layout; c is
    the channel count of the flattened conv features (2 nf)."""
    out = {}
    for name, p in net.items():
        if name in _CONVS:
            out[name] = {"w": _conv_w(p["w"]), "b": _np(p["b"])}
        elif name in _CONVTS:
            out[name] = {"w": _convt_w(p["w"]), "b": _np(p["b"])}
        elif name.startswith("bn"):
            out[name] = {"scale": _np(p["scale"]), "shift": _np(p["shift"])}
        elif name == "fc1":
            out[name] = {"w": _fc1_w(p["w"], c), "b": _np(p["b"])}
        elif name == "fc8":
            w, b = _fc8(p, c)
            out[name] = {"w": w, "b": b}
        elif name.startswith("fc"):
            out[name] = {"w": _np(p["w"]).T, "b": _np(p["b"])}
        else:
            raise KeyError(f"unknown layer {name!r}")
    return out


def params_from_jax(params_np: Dict[str, Any], consts_np: Optional[Dict[str, Any]],
                    config: VAEGAMConfig, device="cpu"):
    """JAX (params, consts) trees -> the port's (params, consts) on `device`.

    ``consts_np`` may be None (then None is returned in its place), which is
    how a JAX gradient tree is mapped.
    """
    c = 2 * config.nf
    tree = {
        "enc": convert_net(params_np["enc"], c),
        "dec": convert_net(params_np["dec"], c),
        "epsilon": _np(params_np["epsilon"]),
        "gp": {k: _np(v) for k, v in params_np["gp"].items()},
    }

    def to_t(a):
        return torch.tensor(np.ascontiguousarray(a), device=device)

    params = tree_map(to_t, tree)
    consts = None
    if consts_np is not None:
        glm = consts_np.get("glm_maps")
        consts = {
            "xu": to_t(_np(consts_np["xu"])),
            "hrf": to_t(_np(consts_np["hrf"])),
            "glm_maps": None if glm is None else to_t(_np(glm)),
        }
    return params, consts


def convert_net_inv(net: Dict[str, Any], c: int) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse of :func:`convert_net`: the port's layout -> JAX's."""
    out = {}
    for name, p in net.items():
        if name in _CONVS:
            out[name] = {"w": _conv_w_inv(p["w"]), "b": _np(p["b"])}
        elif name in _CONVTS:
            out[name] = {"w": _convt_w_inv(p["w"]), "b": _np(p["b"])}
        elif name.startswith("bn"):
            out[name] = {"scale": _np(p["scale"]), "shift": _np(p["shift"])}
        elif name == "fc1":
            out[name] = {"w": _fc1_w_inv(p["w"], c), "b": _np(p["b"])}
        elif name == "fc8":
            w, b = _fc8_inv(p, c)
            out[name] = {"w": w, "b": b}
        elif name.startswith("fc"):
            out[name] = {"w": _np(p["w"]).T, "b": _np(p["b"])}
        else:
            raise KeyError(f"unknown layer {name!r}")
    return out


def params_to_jax(params: Dict[str, Any], consts: Optional[Dict[str, Any]],
                  config: VAEGAMConfig):
    """The port's (params, consts) -> the JAX package's numpy trees; the
    exact inverse of :func:`params_from_jax`.  ``consts`` may be None, which
    is how an Adam moment tree is mapped."""
    def host(t):
        return None if t is None else np.ascontiguousarray(_np(t))

    c = 2 * config.nf
    p = tree_map(host, params)
    tree = {
        "enc": convert_net_inv(p["enc"], c),
        "dec": convert_net_inv(p["dec"], c),
        "epsilon": p["epsilon"],
        "gp": dict(p["gp"]),
    }
    tree = tree_map(np.ascontiguousarray, tree)
    return tree, (None if consts is None else
                  {k: host(v) for k, v in consts.items()})
