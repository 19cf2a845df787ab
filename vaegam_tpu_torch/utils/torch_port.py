"""Reference (PyTorch VAE-GAM) checkpoints into the JAX package's layout, and back.

The port's own, host-only copy of ``vaegam_tpu/utils/torch_port.py`` and
``vaegam_tpu/utils/torch_export.py`` (numpy and torch; those modules import
JAX).  The reference stores per-layer ``state_dict``s in ``nn.Conv3d`` /
``nn.ConvTranspose3d`` / ``nn.Linear`` layouts, which are the port's own
layouts, so the permutations and flips are the ones ``utils.jax_params``
already owns:
  * port: the reference's layers -> JAX-layout {enc, dec} trees
    (``jax_params``' port -> JAX direction), and its per-covariate
    ``gp_params`` -> the stacked GP bank and ``xu``;
  * export: the exact inverse, with a Cholesky bank (``qu_S_raw``) written
    as the dense ``qu_S = L L^T`` the reference stores.
Every array is float32, as the JAX copies give them.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..models.vaegam import COVARIATE_KEYS, MOTION_SLICE, resolve_qu_S
from .jax_params import convert_net, convert_net_inv

MOTION_KEYS = COVARIATE_KEYS[MOTION_SLICE]
ENC_LAYERS = ("conv1", "conv2", "conv3", "conv4", "conv5", "bn1", "bn3", "bn5",
              "fc1", "fc2", "fc31", "fc32", "fc33", "fc41", "fc42", "fc43")
DEC_LAYERS = ("fc5", "fc6", "fc7", "fc8", "convt1", "convt2", "convt3", "convt4",
              "convt5", "bnt1", "bnt3", "bnt5")


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _from_state_dict(name: str, sd) -> Dict[str, np.ndarray]:
    """A reference layer's weight/bias under the port's key names."""
    keys = ("scale", "shift") if name.startswith("bn") else ("w", "b")
    return dict(zip(keys, (_f32(sd["weight"]), _f32(sd["bias"]))))


def _to_state_dict(p) -> Dict[str, np.ndarray]:
    w, b = (p["scale"], p["shift"]) if "scale" in p else (p["w"], p["b"])
    return {"weight": np.ascontiguousarray(w), "bias": np.ascontiguousarray(b)}


def port_layer_state(layers: Dict[str, Dict[str, Any]], nf: int) -> Dict[str, Any]:
    """The reference's per-layer state dicts (numpy) -> JAX-layout enc/dec
    trees (reference vae_reg_GP.py:452-456)."""
    out = {}
    for part, names in (("enc", ENC_LAYERS), ("dec", DEC_LAYERS)):
        net = convert_net_inv({n: _from_state_dict(n, layers[n]) for n in names}, 2 * nf)
        out[part] = {n: {k: np.ascontiguousarray(a) for k, a in p.items()}
                     for n, p in net.items()}
    return out


def export_layer_state(params: Dict[str, Any], nf: int) -> Dict[str, Dict[str, np.ndarray]]:
    """JAX-layout {enc, dec} trees -> the reference's per-layer state dicts
    (keys and shapes of ``VAE._get_layers()[name].state_dict()``)."""
    c = 2 * nf
    out = {}
    for part in ("enc", "dec"):
        net = {n: {k: _f32(v) for k, v in p.items()} for n, p in params[part].items()}
        out.update({n: _to_state_dict(p) for n, p in convert_net(net, c).items()})
    return out


def port_gp_params(gp_params: Dict[str, Dict[str, Any]]):
    """The reference's gp_params dict (vae_reg_GP.py:68-172) -> (the stacked
    GP bank, xu (6, P)), float32."""
    def stack(keys, name, shape):
        return _f32(np.stack([np.asarray(gp_params[k][name]).reshape(shape) for k in keys]))

    gp = {"sa": stack(COVARIATE_KEYS, "sa", ()),
          "logstd": stack(COVARIATE_KEYS, "logstd", ()),
          "qu_m": stack(MOTION_KEYS, "qu_m", -1),
          "qu_S": stack(MOTION_KEYS, "qu_S", None),
          "logkvar": stack(MOTION_KEYS, "logkvar", ()),
          "log_ls": stack(MOTION_KEYS, "log_ls", ())}
    return gp, stack(MOTION_KEYS, "xu", None)


def export_gp_params(gp: Dict[str, Any], xu) -> Dict[str, Dict[str, np.ndarray]]:
    """The stacked GP bank and xu -> the reference's per-covariate gp_params
    with its shapes: sa/logstd (1, 1), qu_m (1, P), qu_S (P, P), logkvar and
    log_ls 0-d, xu (P,).  A Cholesky bank is written as L L^T."""
    bank = {k: torch.tensor(_f32(v)) for k, v in gp.items()}
    qu_S = resolve_qu_S(bank).numpy()
    sa, logstd, qu_m, logkvar, log_ls, xu = (_f32(a) for a in (
        gp["sa"], gp["logstd"], gp["qu_m"], gp["logkvar"], gp["log_ls"], xu))
    out = {cov: {"sa": sa[i].reshape(1, 1), "logstd": logstd[i].reshape(1, 1)}
           for i, cov in enumerate(COVARIATE_KEYS)}
    for j, cov in enumerate(MOTION_KEYS):
        out[cov].update(xu=xu[j], qu_m=qu_m[j].reshape(1, -1), qu_S=qu_S[j],
                        logkvar=logkvar[j].reshape(()), log_ls=log_ls[j].reshape(()))
    return out
