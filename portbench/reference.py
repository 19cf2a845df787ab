"""The plain reference: one VAE-GAM train step in plain PyTorch, float32.

An independent statement of what ``vaegam_tpu_torch`` trains (the
reference implementation's composite ELBO, vae_reg_GP.py:35-413, with the
JAX package's implementation choices: one (9*B)-row decode of the base and
covariate maps with per-one-hot norm statistics, one batched evaluation
of the six motion-covariate GPs, one batched Cholesky of the gain
covariances with an escalating-jitter fallback, the GLM regulariser in
closed form) and of its optimizer (optax's Adam at lr 1e-3 behind
``apply_if_finite``).  It is written with stock operations only
(``F.conv3d``, ``F.conv_transpose3d``, ``F.linear``, ``torch.linalg``) and
imports nothing of the port, the JAX package or JAX.

Parameters live in the port's layout (conv weights (O, I, k...),
transposed-conv weights (I, O, k...), linear (out, in), features flattened
channel-major), so the same tensors can be handed to both sides.
``make_params`` draws them on the device from a seed, in a few large calls.

Precision: that of the tensors handed in, float32 in a run.  ``tf32``
switches cuBLAS's and cuDNN's TF32 products on, which is the control (one
precision step below the configuration's float32 with TF32 off); float64
tensors give the float64 reading of the calibration's look.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F
from scipy.stats import gamma

BN_EPS = 1e-5
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
GP_PRIOR_VAR = 10.0
MOTION = slice(1, 7)            # the six motion covariates among the eight
TR_SECONDS, HRF_WINDOW_SECONDS = 1.4, 20.0
JITTERS = (1e-4, 1e-3, 1e-2)
SUPPORTED = {"nf", "num_covariates", "num_latents", "num_inducing_pts", "gp_kl_scale",
             "glm_reg_scale", "neural_covariates", "max_ls", "img_shape",
             "fused_norm_stats"}


def model_fields(cfg: dict) -> dict:
    """The configuration's model fields that this reference computes."""
    return {k: cfg[k] for k in SUPPORTED}


# --------------------------------------------------------------- shapes

def conv5_input_shape(img_shape):
    """Spatial shape of conv5's input: after conv1 to conv4 (k3; s1, s2, s1, s2)."""
    out = []
    for i in img_shape:
        a = ((i - 2 - 3) // 2 + 1) - 2
        out.append((a - 3) // 2 + 1)
    return tuple(out)


def encoder_out_shape(img_shape):
    """Spatial shape after the encoder's five convs (conv5: k3, s1)."""
    return tuple(a - 2 for a in conv5_input_shape(img_shape))


def decoder_seed_shape(img_shape):
    """(seed, crop): the decoder's (D, H, W) seed and the surplus cropped
    from the tail of its output (D, H grow to 4s+17, W to 4s+15)."""
    seed, crop = [], []
    for i, c in zip(img_shape, (17, 17, 15)):
        s = -(-(i - c) // 4)
        seed.append(s)
        crop.append(4 * s + c - i)
    return tuple(seed), tuple(crop)


def param_spec(cfg: dict):
    """[(path, shape, init)] in the port's layout; init is ("uniform", bound),
    ("normal", mean), ("const", value) or ("eye", value)."""
    nf, c, L = cfg["nf"], 2 * cfg["nf"], cfg["num_latents"]
    n_cov, p = cfg["num_covariates"], cfg["num_inducing_pts"]
    z_dim = L + n_cov + 1
    eo = encoder_out_shape(cfg["img_shape"])
    flat = c * eo[0] * eo[1] * eo[2]
    seed, _ = decoder_seed_shape(cfg["img_shape"])
    seed_flat = c * seed[0] * seed[1] * seed[2]
    spec = []

    def conv(path, w_shape, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        spec.append((f"{path}/w", w_shape, ("uniform", bound)))
        # a transposed conv's bias has O entries: its weight is (I, O, k...)
        o = w_shape[1] if "convt" in path else w_shape[0]
        spec.append((f"{path}/b", (o,), ("uniform", bound)))

    def linear(path, n_in, n_out):
        conv(path, (n_out, n_in), n_in)

    def bn(path, ch):
        spec.append((f"{path}/scale", (ch,), ("const", 1.0)))
        spec.append((f"{path}/shift", (ch,), ("const", 0.0)))

    k3 = (3, 3, 3)
    conv("enc/conv1", (nf, 1, *k3), 27)
    conv("enc/conv2", (nf, nf, *k3), nf * 27)
    conv("enc/conv3", (c, nf, *k3), nf * 27)
    conv("enc/conv4", (c, c, *k3), c * 27)
    conv("enc/conv5", (c, c, *k3), c * 27)
    bn("enc/bn1", 1)
    bn("enc/bn3", nf)
    bn("enc/bn5", c)
    linear("enc/fc1", flat, 200)
    linear("enc/fc2", 200, 100)
    for k in ("1", "2", "3"):
        linear(f"enc/fc3{k}", 100, 50)
        linear(f"enc/fc4{k}", 50, L)
    linear("dec/fc5", z_dim, 50)
    linear("dec/fc6", 50, 100)
    linear("dec/fc7", 100, 200)
    linear("dec/fc8", 200, seed_flat)
    conv("dec/convt1", (c, c, *k3), c * 27)
    conv("dec/convt2", (c, c, *k3), c * 27)
    conv("dec/convt3", (c, nf, *k3), nf * 27)
    conv("dec/convt4", (nf, nf, 5, 3, 3), nf * 45)
    conv("dec/convt5", (nf, 1, *k3), 27)
    bn("dec/bnt1", c)
    bn("dec/bnt3", c)
    bn("dec/bnt5", nf)
    spec.append(("epsilon", tuple(cfg["img_shape"]), ("const", -math.log(10.0))))
    spec.append(("gp/sa", (n_cov,), ("normal", 1.0)))
    spec.append(("gp/logstd", (n_cov,), ("normal", 0.0)))
    spec.append(("gp/qu_m", (6, p), ("normal", 0.0)))
    spec.append(("gp/logkvar", (6,), ("const", 0.0)))
    spec.append(("gp/log_ls", (6,), ("const", 0.0)))
    spec.append(("gp/qu_S", (6, p, p), ("eye", 2.0)))
    return sorted(spec)


def make_params(cfg: dict, seed: int, device) -> dict:
    """Initial parameters from `seed`, drawn on `device` in two calls: the
    torch default bounds U(+-1/sqrt(fan_in)) for every weight and bias, and
    the gain bank's normals (sa ~ N(1, 1), logstd, qu_m ~ N(0, 1)); norm
    scales 1, shifts 0, epsilon -log 10, qu_S 2 I, as the model's init."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    spec = param_spec(cfg)
    sizes = {kind: sum(math.prod(s) for _, s, (k, _) in spec if k == kind)
             for kind in ("uniform", "normal")}
    uni = torch.rand(sizes["uniform"], generator=gen, device=device)
    nrm = torch.randn(sizes["normal"], generator=gen, device=device)
    flat, used = {}, {"uniform": 0, "normal": 0}
    for path, shape, (kind, v) in spec:
        n = math.prod(shape)
        if kind == "uniform":
            u = uni[used[kind]:used[kind] + n]
            t = (2.0 * u - 1.0) * v
        elif kind == "normal":
            t = nrm[used[kind]:used[kind] + n] + v
        elif kind == "eye":
            t = v * torch.eye(shape[-1], device=device).expand(shape)
        else:
            t = torch.full(shape, v, device=device)
        used[kind] = used.get(kind, 0) + n
        flat[path] = t.reshape(shape).contiguous()
    return unflatten(flat)


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        *parents, last = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree


def flatten(tree: dict, prefix: str = "") -> dict:
    """{path: leaf} in sorted key order, paths joined with '/'."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def hrf_taps() -> np.ndarray:
    """Double-gamma HRF (peak Gamma(6), undershoot 0.35 Gamma(12), max 0.6)
    at TR resolution over a 20 s window: 15 taps."""
    t = np.arange(0.0, HRF_WINDOW_SECONDS, TR_SECONDS)
    v = gamma.pdf(t, 6) - 0.35 * gamma.pdf(t, 12)
    return v / np.max(v) * 0.6


def make_consts(cfg: dict, xu_ranges, glm_maps, device, dtype=torch.float32) -> dict:
    """The model's constants: inducing grids, HRF taps, GLM maps."""
    p = cfg["num_inducing_pts"]
    xu = torch.stack([torch.linspace(float(lo), float(hi), p, device=device, dtype=dtype)
                      for lo, hi in xu_ranges])
    return {"xu": xu,
            "hrf": torch.tensor(hrf_taps(), dtype=dtype, device=device),
            "glm_maps": None if glm_maps is None else
            torch.as_tensor(np.asarray(glm_maps), device=device).to(dtype)}


def draw_noise(gen, batch: int, cfg: dict, device):
    """A step's draws in the model's order: eps_w (B, 1), eps_d (B, L),
    eps_beta (C, B)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    return (randn(batch, 1), randn(batch, cfg["num_latents"]),
            randn(cfg["num_covariates"], batch))


def epoch_order(n: int, seed: int, epoch: int) -> np.ndarray:
    """The device cache's shuffle: numpy's default_rng((seed, epoch))."""
    order = np.arange(n)
    np.random.default_rng((seed, epoch)).shuffle(order)
    return order


# ---------------------------------------------------------------- model

def stat_norm(x, p, groups=1):
    """Batch-statistics norm over (N, D, H, W) per channel, per contiguous
    group of rows; biased variance, eps 1e-5."""
    n, c = x.shape[:2]
    xg = x.reshape(groups, n // groups, *x.shape[1:])
    axes = (1, 3, 4, 5)
    mean = xg.mean(dim=axes, keepdim=True)
    var = (xg - mean).square().mean(dim=axes, keepdim=True)
    xn = (xg - mean) * torch.rsqrt(var + BN_EPS)
    shape = (1, 1, c, 1, 1, 1)
    return (xn * p["scale"].reshape(shape) + p["shift"].reshape(shape)).reshape(x.shape)


def encode(P, x):
    h = x[:, None]
    h = F.relu(F.conv3d(stat_norm(h, P["bn1"]), P["conv1"]["w"], P["conv1"]["b"]))
    h = F.relu(F.conv3d(h, P["conv2"]["w"], P["conv2"]["b"], stride=2))
    h = F.relu(F.conv3d(stat_norm(h, P["bn3"]), P["conv3"]["w"], P["conv3"]["b"]))
    h = F.relu(F.conv3d(h, P["conv4"]["w"], P["conv4"]["b"], stride=2))
    h = F.relu(F.conv3d(stat_norm(h, P["bn5"]), P["conv5"]["w"], P["conv5"]["b"]))
    h = h.reshape(h.shape[0], -1)

    def fc(h, name):
        return F.linear(h, P[name]["w"], P[name]["b"])

    h = F.relu(fc(F.relu(fc(h, "fc1")), "fc2"))
    mu = fc(F.relu(fc(h, "fc31")), "fc41")
    u = fc(F.relu(fc(h, "fc32")), "fc42")
    d = torch.exp(fc(F.relu(fc(h, "fc33")), "fc43"))
    return mu, u, d


def decode(P, z, img_shape, groups):
    seed, crop = decoder_seed_shape(img_shape)
    c = P["convt1"]["w"].shape[0]
    h = z
    for name in ("fc5", "fc6", "fc7", "fc8"):
        h = F.relu(F.linear(h, P[name]["w"], P[name]["b"]))
    h = h.reshape(-1, c, *seed)

    def ct(h, name, **kw):
        return F.conv_transpose3d(h, P[name]["w"], P[name]["b"], **kw)

    h = F.relu(ct(stat_norm(h, P["bnt1"], groups), "convt1"))
    h = F.relu(ct(h, "convt2", stride=2, padding=(1, 0, 1), output_padding=(1, 0, 1)))
    h = F.relu(ct(stat_norm(h, P["bnt3"], groups), "convt3"))
    h = F.relu(ct(h, "convt4", stride=2))
    h = ct(stat_norm(h, P["bnt5"], groups), "convt5")
    h = h[:, :, :h.shape[2] - crop[0], :h.shape[3] - crop[1], :h.shape[4] - crop[2]]
    return torch.sigmoid(h).reshape(h.shape[0], -1)


class CholeskyNaN(torch.autograd.Function):
    """Lower Cholesky factor with JAX's failure semantics: a matrix that is
    not positive definite gives an all-NaN lower triangle, and a NaN
    gradient (the Cholesky VJP, Murray 2016, on that factor)."""

    @staticmethod
    def forward(ctx, a):
        chol, info = torch.linalg.cholesky_ex(a)
        bad = (info != 0)[..., None, None]
        chol = torch.where(bad, torch.full_like(chol, float("nan")).tril(), chol)
        ctx.save_for_backward(chol)
        return chol

    @staticmethod
    def backward(ctx, g):
        (chol,) = ctx.saved_tensors
        ga = (chol.mH @ g).tril()
        ga = 0.5 * (ga + ga.tril(-1).mH)
        ga = torch.linalg.solve_triangular(chol.mH, ga, upper=True, left=True)
        return torch.linalg.solve_triangular(chol, ga, upper=False, left=False)


def cholesky(a):
    return CholeskyNaN.apply(0.5 * (a + a.mT))


def mvn_kl(mu, cov, prior_var):
    n = mu.shape[-1]
    chol = cholesky(cov)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    tr = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1) / prior_var
    quad = (mu * mu).sum(-1) / prior_var
    return 0.5 * (tr + quad - n + n * math.log(prior_var) - logdet)


def rbf(x1, x2, kvar, ls):
    scaled = (x1[:, :, None] - x2[:, None, :]) / (math.sqrt(2.0) * ls[:, None, None])
    return kvar[:, None, None] * torch.exp(-scaled.square())


def gp_posterior(xu, kvar, ls, qu_m, qu_S, xq):
    kuq, kqq, kuu = rbf(xu, xq, kvar, ls), rbf(xq, xq, kvar, ls), rbf(xu, xu, kvar, ls)
    a_t = torch.linalg.solve_ex(kuu, kuq).result
    a = a_t.mT
    return (a @ qu_m[:, :, None])[..., 0], kqq + (a @ (qu_S - kuu)) @ a_t


def step_loss(params, consts, covs, x, noise, cfg):
    """The composite objective of one batch: returns (loss, fallbacks)."""
    b, n_cov = x.shape[0], cfg["num_covariates"]
    eps_w, eps_d, eps_beta = noise
    mu, u, d = encode(params["enc"], x)
    d = torch.where((d < 1e-6).any(), d + 1e-6, d)          # the global d-floor
    z = mu + u * eps_w + torch.sqrt(d) * eps_d

    onehots = torch.eye(n_cov + 1, device=x.device, dtype=x.dtype)
    zcat = torch.cat([z[None].expand(n_cov + 1, b, z.shape[-1]),
                      onehots[:, None, :].expand(n_cov + 1, b, n_cov + 1)], dim=-1)
    groups = 1 if cfg["fused_norm_stats"] else n_cov + 1
    decoded = decode(params["dec"], zcat.reshape((n_cov + 1) * b, -1),
                     cfg["img_shape"], groups).reshape(n_cov + 1, b, -1)
    base, diffs = decoded[0], decoded[1:]

    gp = params["gp"]
    xq = covs.T
    sa, std = gp["sa"], torch.exp(gp["logstd"])
    var_ratio = (std / 0.5) ** 2
    lin_kl = (0.5 * (var_ratio + ((sa - 1.0) / 0.5) ** 2 - 1.0 - torch.log(var_ratio))).sum()
    beta_mean = sa[:, None] * xq
    eye_b = torch.eye(b, device=x.device, dtype=x.dtype)
    beta_cov = eye_b[None] * (std[:, None] ** 2 * xq ** 2)[:, None, :]
    kvar = torch.exp(gp["logkvar"]) + 0.1
    ls = cfg["max_ls"] * torch.sigmoid(torch.exp(gp["log_ls"]) + 0.5)
    f_bar, sigma = gp_posterior(consts["xu"], kvar, ls, gp["qu_m"], gp["qu_S"], xq[MOTION])
    beta_mean = torch.cat([beta_mean[:1], beta_mean[MOTION] + f_bar, beta_mean[7:]])
    beta_cov = torch.cat([beta_cov[:1], beta_cov[MOTION] + sigma, beta_cov[7:]])
    gp_kl = lin_kl + mvn_kl(gp["qu_m"], gp["qu_S"], GP_PRIOR_VAR).sum()

    cov = beta_cov + 1e-5 * eye_b[None]
    cov = 0.5 * (cov + cov.mT)
    chol = cholesky(cov)
    first_bad = torch.isnan(chol).any(-1).any(-1)
    for j in JITTERS:
        bad = torch.isnan(chol).any(-1, keepdim=True).any(-2, keepdim=True)
        chol = torch.where(bad, cholesky(cov + j * eye_b), chol)
    gains = beta_mean + torch.einsum("...ij,...j->...i", chol, eps_beta)

    n_neural = max(0, n_cov - 7)
    if cfg["neural_covariates"] and n_neural:
        k = consts["hrf"].shape[0]
        padded = F.pad(gains[:n_neural, None, :], (k - 1, 0))
        conv = F.conv1d(padded, consts["hrf"].flip(0)[None, None, :])[:, 0, :]
        gains = torch.cat([conv, gains[n_neural:]])

    x_rec = base + torch.einsum("cb,cbd->bd", gains, diffs)
    glm_reg = torch.zeros((), device=x.device, dtype=x.dtype)
    if consts["glm_maps"] is not None:
        glm = consts["glm_maps"][:, 1:n_cov + 1].T
        d2 = (diffs * diffs).sum(-1)
        dg = torch.einsum("cbd,cd->cb", diffs, glm)
        sq = gains ** 2 * d2 - 2.0 * gains * dg + (glm * glm).sum(-1)[:, None]
        glm_reg = b * torch.sqrt(torch.clamp(sq, min=0.0)).sum()

    tr = d.sum(-1) + (u * u).sum(-1)
    logdet = torch.log(d).sum(-1) + torch.log1p((u * u / d).sum(-1))
    kl_z = 0.5 * (tr + (mu * mu).sum(-1) - mu.shape[-1] - logdet)
    scale = torch.exp(-params["epsilon"]).reshape(-1)
    zz = (x.reshape(b, -1) - x_rec) / scale
    log_prob = (-0.5 * zz * zz - torch.log(scale) - 0.5 * math.log(2.0 * math.pi)).sum(-1)
    elbo = (-kl_z + log_prob).mean()
    loss = -elbo + cfg["gp_kl_scale"] * gp_kl + cfg["glm_reg_scale"] * glm_reg
    return loss, int(first_bad.sum())


@contextmanager
def products_in(tf32: bool, deterministic: bool = False):
    """cuBLAS's and cuDNN's float32 products in TF32 or in full float32;
    ``deterministic`` takes cuDNN's deterministic algorithms (another
    summation order)."""
    b = torch.backends
    old = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.deterministic,
           b.cudnn.benchmark)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = tf32
    if deterministic:
        b.cudnn.deterministic, b.cudnn.benchmark = True, False
    try:
        yield
    finally:
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.deterministic,
         b.cudnn.benchmark) = old


def adam_step(start: dict, consts: dict, batch, noise, cfg: dict, lr: float,
              fault=None) -> dict:
    """One step of the guarded Adam (optax's ``adam`` behind
    ``apply_if_finite``) from ``start`` = {"params", "mu", "nu" (leaves by
    path), "count" (the steps applied so far)} on (covariates, volumes) with
    their noise.  Returns the step's loss, gradient, whether it was applied,
    its gain-Cholesky fallbacks, and the state after it, as ``start``.
    ``fault`` (planted by the calibration) maps the loss to the one
    returned and differentiated."""
    flat = {k: v.detach().clone().requires_grad_(True) for k, v in start["params"].items()}
    paths = list(flat)
    covs, x = batch
    loss, fb = step_loss(unflatten(flat), consts, covs, x, noise, cfg)
    if fault is not None:
        loss = fault(loss)
    grads = dict(zip(paths, torch.autograd.grad(loss, [flat[k] for k in paths])))
    applied = all(bool(torch.isfinite(g).all()) for g in grads.values())
    params, mu, nu, count = ({k: v.detach() for k, v in flat.items()}, dict(start["mu"]),
                             dict(start["nu"]), start["count"])
    if applied:
        count += 1
        # bias corrections in float32, as optax computes them
        t = np.float32(count)
        bc1 = float(np.float32(1) - np.float32(ADAM_B1) ** t)
        bc2 = float(np.float32(1) - np.float32(ADAM_B2) ** t)
        with torch.no_grad():
            for k, g in grads.items():
                mu[k] = (1 - ADAM_B1) * g + ADAM_B1 * mu[k]
                nu[k] = (1 - ADAM_B2) * (g * g) + ADAM_B2 * nu[k]
                params[k] = params[k] - lr * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2)
                                                               + ADAM_EPS))
    return {"loss": loss.item(), "grad": grads, "applied": applied, "fallbacks": fb,
            "params": params, "mu": mu, "nu": nu, "count": count}


def fresh_state(params0: dict) -> dict:
    """The optimizer's start: the initial parameters (by path), zero moments."""
    return {"params": dict(params0), "mu": {k: torch.zeros_like(v) for k, v in params0.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params0.items()}, "count": 0}


def to(state: dict, device, dtype=None) -> dict:
    """A step's record with its tensors on `device` (and in `dtype`)."""
    def move(t):
        return t.detach().to(device, dtype if dtype is not None and t.is_floating_point()
                             else t.dtype)
    return {k: {p: move(t) for p, t in v.items()} if isinstance(v, dict) else v
            for k, v in state.items()}


def trajectory(params0: dict, consts: dict, batches, noises, cfg: dict, lr: float,
               tf32: bool = False, deterministic: bool = False, fault=None,
               keep="cpu") -> list:
    """The reference's own steps from ``params0`` (leaves by path): one
    ``adam_step`` record a step, each moved to `keep`."""
    state, out = fresh_state(params0), []
    with products_in(tf32, deterministic):
        for batch, noise in zip(batches, noises):
            rec = adam_step(state, consts, batch, noise, cfg, lr, fault=fault)
            state = {k: rec[k] for k in ("params", "mu", "nu", "count")}
            out.append(to(rec, keep))
    return out


def follow(starts: list, consts: dict, batches, noises, cfg: dict, lr: float,
           device, keep="cpu") -> list:
    """Step k of the reference from ``starts[k]``, the parameters and
    moments that the side being judged held before its step k (the first:
    ``fresh_state``); the step count is the reference's own."""
    out, count = [], 0
    with products_in(False):
        for start, batch, noise in zip(starts, batches, noises):
            s = {k: start[k] for k in ("params", "mu", "nu")}
            rec = adam_step(dict(to(s, device), count=count), consts, batch, noise, cfg, lr)
            count = rec["count"]
            out.append(to(rec, keep))
    return out
