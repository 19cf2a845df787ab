"""The port's lane-packed convs (``conv_pack``) and polyphase transposed convs
against the JAX package (vaegam_tpu/ops/packed_conv.py, vaegam_tpu/ops/convt.py).

Inputs are numpy draws from a seed; JAX runs on the CPU, channels-last,
and the port NCDHW with torch's weight layouts.  The ops are held to JAX's
and to the stock conv at the bounds of tests/test_ops.py; the model's
stacks and forward with a pack to JAX's in float64 (tests/torch_port_common.py
says why float64) and to the port's own unpacked stacks at the JAX test's
bounds (tests/test_ops.py:157-205).  Thin model (nf=2, 8 latents, 21x25x21).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from vaegam_tpu.models import forward as jax_forward
from vaegam_tpu.models.networks import decode as jax_decode, encode as jax_encode
from vaegam_tpu.ops import convt as jax_convt
from vaegam_tpu.ops import packed_conv as jax_pc

from vaegam_tpu_torch.data import DeviceResidentLoader
from vaegam_tpu_torch.models import MAP_KEYS, VAEGAMConfig, forward
from vaegam_tpu_torch.models.networks import decode, encode
from vaegam_tpu_torch.ops import convt, packed_conv
from vaegam_tpu_torch.train import Trainer
from vaegam_tpu_torch.utils.jax_params import convert_net, params_from_jax
from vaegam_tpu_torch.utils.tree import tree_items, tree_map

from torch_port_common import (
    THIN, XU_RANGES, f64_jax, jax_float64, jax_noise, make_batch, make_model, to_np,
    torch_tensors,
)

# tests/test_ops.py:104-110: (dims, ic, oc, ksize, pad, pack)
PACKED_CASES = [
    ((8, 10, 7), 6, 5, (3, 3, 3), ((2, 2), (2, 2), (2, 2)), (4, 4)),
    ((9, 11, 13), 4, 5, (3, 3, 3), ((0, 0), (0, 0), (0, 0)), (2, 3)),
    ((7, 9, 8), 3, 2, (5, 3, 3), ((1, 0), (0, 1), (2, 2)), (3, 5)),
    ((5, 6, 7), 2, 3, (1, 1, 1), ((0, 0), (0, 0), (0, 0)), (4, 2)),
    ((6, 12, 12), 2, 1, (3, 3, 3), ((2, 2), (2, 2), (2, 2)), (4, 8)),
]
# tests/test_ops.py:24-31: (in_dims, ksize, pad, outpad)
CONVT_CASES = [
    ((8, 10, 7), (3, 3, 3), (1, 0, 1), (1, 0, 1)),
    ((18, 23, 16), (5, 3, 3), (0, 0, 0), (0, 0, 0)),
    ((4, 5, 6), (3, 3, 3), (0, 0, 0), (0, 0, 0)),
    ((5, 4, 3), (4, 3, 2), (1, 1, 0), (0, 1, 1)),
    ((6, 6, 6), (5, 5, 5), (2, 2, 2), (1, 0, 1)),
]
# (forward rtol, forward atol, gradient rtol, gradient atol).  fp32: the
# bounds of tests/test_ops.py:128-153; float64: rtol 1e-10 and 1e-9, with an
# atol of 1e-12 for the entries that cancel to ~0 (the inputs are O(1))
PACKED_TOL = {"float32": (1e-4, 1e-5, 1e-3, 1e-4), "float64": (1e-10, 1e-12, 1e-9, 1e-12)}


def _ndhwc(t):
    return t.detach().permute(0, 2, 3, 4, 1).numpy()


def _sin_sum_grads(y, inputs):
    return torch.autograd.grad(torch.sin(y).sum(), inputs)


@pytest.mark.parametrize("dtype", sorted(PACKED_TOL))
@pytest.mark.parametrize("dims,ic,oc,ksize,pad,pack", PACKED_CASES)
def test_packed_conv3d_matches_jax_and_conv3d(dims, ic, oc, ksize, pad, pack, dtype):
    """Forward and the gradients of sum(sin(y)) wrt x and w against JAX's
    packed_conv3d and against F.conv3d on the padded input."""
    f_rtol, f_atol, g_rtol, g_atol = PACKED_TOL[dtype]
    rng = np.random.default_rng(abs(hash((dims, ksize, pack))) % 2**31)
    x = rng.normal(size=(2, *dims, ic)).astype(dtype)
    w = rng.normal(size=(*ksize, ic, oc)).astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        def loss(x, w):
            y = jax_pc.packed_conv3d(x, w, pad, pack)
            return jnp.sum(jnp.sin(y)), y
        (_, jy), (jgx, jgw) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(x), jnp.asarray(w))
        jy, jgx, jgw = np.asarray(jy), np.asarray(jgx), np.asarray(jgw)
    tx = torch.tensor(x.transpose(0, 4, 1, 2, 3).copy(), requires_grad=True)
    tw = torch.tensor(w.transpose(4, 3, 0, 1, 2).copy(), requires_grad=True)
    got = packed_conv.packed_conv3d(tx, tw, pad, pack)
    (lo_d, hi_d), (lo_h, hi_h), (lo_w, hi_w) = pad
    ref = F.conv3d(F.pad(tx, (lo_w, hi_w, lo_h, hi_h, lo_d, hi_d)), tw)
    assert got.shape == ref.shape and got.dtype == tx.dtype
    for want in (jy, _ndhwc(ref)):
        np.testing.assert_allclose(_ndhwc(got), want, rtol=f_rtol, atol=f_atol)
    gx, gw = _sin_sum_grads(got, (tx, tw))
    rgx, rgw = _sin_sum_grads(ref, (tx, tw))
    for want in (jgx, _ndhwc(rgx)):
        np.testing.assert_allclose(_ndhwc(gx), want, rtol=g_rtol, atol=g_atol)
    for want in (jgw, rgw.permute(2, 3, 4, 1, 0).numpy()):
        np.testing.assert_allclose(gw.permute(2, 3, 4, 1, 0).numpy(), want,
                                   rtol=g_rtol, atol=g_atol)


@pytest.mark.parametrize("pack", [(2, 2), (4, 4), (3, 5)])
def test_pack_weights_is_jaxs_band_bit_for_bit(pack):
    """The packed weight holds JAX's pack_weights entries bit for bit, in the
    port's channel order (input (ci, jh, jw), output (o, sh, sw)); the FLOP
    multiplier is JAX's."""
    rng = np.random.default_rng(4)
    w = rng.normal(size=(3, 3, 3, 4, 5)).astype(np.float32)   # DHWIO
    s_h, s_w = pack
    want = np.asarray(jax_pc.pack_weights(jnp.asarray(w), s_h, s_w))
    got = packed_conv.pack_weights(torch.tensor(w.transpose(4, 3, 0, 1, 2).copy()),
                                   s_h, s_w).numpy()
    wh, ww = s_h + 2, s_w + 2
    # JAX: (kd, 1, 1, (jh, jw, ci), (sh, sw, o)); the port: ((o, sh, sw), (ci, jh, jw), kd, 1, 1)
    want = want.reshape(3, wh, ww, 4, s_h, s_w, 5).transpose(6, 4, 5, 3, 1, 2, 0)
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    assert packed_conv.flop_inflation(3, 3, pack) == jax_pc.flop_inflation(3, 3, pack)


@pytest.mark.parametrize("fused", [False, True], ids=["classes", "fused"])
@pytest.mark.parametrize("dims,ksize,pad,outpad", CONVT_CASES)
def test_convt_matches_jax_and_conv_transpose3d(dims, ksize, pad, outpad, fused):
    """conv_transpose_2x / conv_transpose_2x_fused on torch's (I, O, k...)
    weight against JAX's on the equivalent DHWIO kernel (flipped, I and O in
    place) and against F.conv_transpose3d: forward rtol 1e-5 / atol 1e-5,
    the gradients of sum(sin(y)) wrt x and w rtol 1e-4 / atol 1e-5
    (tests/test_ops.py:33-97).  The forward also in fp32 against JAX's
    fp32; the gradients in float64 on all three sides: in fp32 a weight
    gradient sums ~1e4 products of a tap, and the three backends' orders
    leave 2e-5..4e-4 between them at |g| ~ 30 (measured on these cases)."""
    name = "conv_transpose_2x_fused" if fused else "conv_transpose_2x"
    rng = np.random.default_rng(abs(hash((dims, ksize, fused))) % 2**31)
    x = rng.normal(size=(2, 3, *dims))
    w = rng.normal(size=(3, 4, *ksize))                       # (I, O, k...)
    jw = np.ascontiguousarray(w[:, :, ::-1, ::-1, ::-1].transpose(2, 3, 4, 0, 1))
    jx = x.transpose(0, 2, 3, 4, 1)
    fn = getattr(jax_convt, name)

    def loss(x, w):
        y = fn(x, w, pad, outpad)
        return jnp.sum(jnp.sin(y)), y

    jy32 = np.asarray(fn(jnp.asarray(jx, jnp.float32), jnp.asarray(jw, jnp.float32),
                         pad, outpad))
    got32 = getattr(convt, name)(*torch_tensors(x, w), pad, outpad)
    np.testing.assert_allclose(_ndhwc(got32), jy32, rtol=1e-5, atol=1e-5)

    with jax.enable_x64(True):
        (_, jy), (jgx, jgw) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(jx), jnp.asarray(jw))
        jy, jgx, jgw = np.asarray(jy), np.asarray(jgx), np.asarray(jgw)
    tx, tw = (torch.tensor(a, requires_grad=True) for a in (x, w))
    got = getattr(convt, name)(tx, tw, pad, outpad)
    ref = F.conv_transpose3d(tx, tw, stride=2, padding=pad, output_padding=outpad)
    assert got.shape == ref.shape and got.dtype == torch.float64
    for want in (jy, _ndhwc(ref)):
        np.testing.assert_allclose(_ndhwc(got), want, rtol=1e-5, atol=1e-5)
    gx, gw = _sin_sum_grads(got, (tx, tw))
    rgx, rgw = _sin_sum_grads(ref, (tx, tw))
    for a, want in ((_ndhwc(gx), jgx), (gw.numpy(), jgw[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2)),
                    (gx.numpy(), rgx.numpy()), (gw.numpy(), rgw.numpy())):
        np.testing.assert_allclose(a, want, rtol=1e-4, atol=1e-5)


def test_an_invalid_pack_raises():
    """(1, 1) for a 3x3 kernel breaks the k-1 <= s rule (JAX asserts it,
    packed_conv.py:119-121): the op and the config refuse it."""
    x, w = torch.zeros(1, 2, 5, 5, 5), torch.zeros(3, 2, 3, 3, 3)
    with pytest.raises(ValueError, match="kernel-1 per axis"):
        packed_conv.packed_conv3d(x, w, pack=(1, 1))
    with pytest.raises(ValueError, match="kernel-1 per axis"):
        VAEGAMConfig(**THIN, conv_pack=(1, 1))
    assert VAEGAMConfig(**THIN, conv_pack=[4, 4]).conv_pack == (4, 4)


# ---------------------------------------------------------------------------
# the model's stacks
# ---------------------------------------------------------------------------

def _stack_inputs(cfg):
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, size=(4,) + cfg.img_shape)
    z = rng.normal(size=(9 * 4, cfg.z_dim))
    return x, z


def _port_stack(which, net, x, z, cfg, pack, dtype, conv5_kernel=True):
    """(output, gradient leaves by name) of the JAX test's stack losses."""
    prm = tree_map(lambda t: t.to(dtype, copy=True).requires_grad_(True), net)
    if which == "enc":
        mu, u, d = encode(prm, torch.tensor(x, dtype=dtype), conv5_kernel,
                          conv_pack=pack)
        loss, out = (torch.sin(mu) + torch.cos(u) + d).sum(), mu
    else:
        out = decode(prm, torch.tensor(z, dtype=dtype), cfg.img_shape, 9,
                     conv_pack=pack)
        loss = torch.sin(out * 3.0).sum()
    loss.backward()
    return out.detach(), {p: t.grad for p, t in tree_items(prm)}


@pytest.mark.parametrize("which", ["enc", "dec"])
def test_packed_stacks_match_jax_in_float64(which):
    """encode / decode with conv_pack=(2, 2) against JAX's with the same
    pack, both in float64, the weights through params_from_jax: outputs atol
    1e-5, gradients rtol 1e-3 / atol 1e-5 (the port's float64 bounds,
    tests/test_torch_port_models.py::test_forward_parity)."""
    jc, pc, params, _, tp, _ = make_model(THIN, glm=False)
    x, z = _stack_inputs(pc)
    with jax_float64():
        p = f64_jax(params[which])
        if which == "enc":
            def loss(p):
                mu, u, d = jax_encode(p, jnp.asarray(x), jc.nf, conv_pack=(2, 2))
                return jnp.sum(jnp.sin(mu) + jnp.cos(u) + d), mu
        else:
            def loss(p):
                out = jax_decode(p, jnp.asarray(z), jc.nf, img_shape=jc.img_shape,
                                 stat_groups=9, conv_pack=(2, 2))
                return jnp.sum(jnp.sin(out * 3.0)), out
        (_, jout), jg = jax.value_and_grad(loss, has_aux=True)(p)
        jout, jg = np.asarray(jout), to_np(jg)
    out, grads = _port_stack(which, tp[which], x, z, pc, (2, 2), torch.float64,
                             conv5_kernel=False)
    np.testing.assert_allclose(out.numpy(), jout, atol=1e-5)
    want = dict(tree_items(convert_net(jg, 2 * pc.nf)))
    assert set(want) == set(grads)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[path], rtol=1e-3, atol=1e-5,
                                   err_msg=path)


@pytest.mark.parametrize("pack", [(2, 2), (4, 4)])
@pytest.mark.parametrize("which", ["enc", "dec"])
def test_packed_stacks_match_unpacked(which, pack):
    """fp32 stacks with a pack against the same stacks without, the JAX
    test's losses and bounds (tests/test_ops.py:157-195): outputs rtol 1e-4
    / atol 1e-5, gradients rtol 1e-3 / atol 2e-3.  The encoder keeps the
    conv5 op (its plain version here), which takes precedence over the pack."""
    _, pc, _, _, tp, _ = make_model(THIN, glm=False)
    x, z = _stack_inputs(pc)
    o0, g0 = _port_stack(which, tp[which], x, z, pc, None, torch.float32)
    o1, g1 = _port_stack(which, tp[which], x, z, pc, pack, torch.float32)
    np.testing.assert_allclose(o1.numpy(), o0.numpy(), rtol=1e-4, atol=1e-5)
    for path in g0:
        np.testing.assert_allclose(g1[path].numpy(), g0[path].numpy(), rtol=1e-3,
                                   atol=2e-3, err_msg=path)


@pytest.mark.parametrize("deterministic", [True, False], ids=["det", "noise"])
def test_packed_forward_matches_jax_in_float64(deterministic):
    """forward with conv_pack=(2, 2) against JAX's forward with the same
    pack, both in float64 with JAX's noise (B=4): tot_loss and the scalars
    rtol 1e-4, the 10 maps atol 1e-5, every gradient leaf rtol 1e-3 /
    atol 1e-5 (test_forward_parity's float64 bounds)."""
    cfg_kw = dict(THIN, conv_pack=(2, 2))
    jc, pc, params, consts, tp, tc = make_model(cfg_kw)
    pc = dataclasses.replace(pc, conv5_kernel=False)
    covs, x = make_batch(jc.img_shape, 4)
    key = jax.random.PRNGKey(11)
    with jax_float64():
        noise = None if deterministic else jax_noise(key, 4, jc.num_latents)
        (jl, ja), jg = jax.value_and_grad(jax_forward, has_aux=True)(
            f64_jax(params), f64_jax(consts), key, jnp.asarray(covs, jnp.float64),
            jnp.asarray(x, jnp.float64), jc, return_maps=True,
            deterministic=deterministic)
        jl, ja, jg = float(jl), to_np(ja), to_np(jg)
    prm = tree_map(lambda t: t.to(torch.float64, copy=True).requires_grad_(True), tp)
    cst = {k: None if v is None else v.double() for k, v in tc.items()}
    tl, ta = forward(prm, cst, *torch_tensors(covs, x, dtype=torch.float64), pc,
                     noise=None if noise is None else torch_tensors(*noise, dtype=torch.float64),
                     return_maps=True, deterministic=deterministic)
    tl.backward()
    np.testing.assert_allclose(tl.item(), jl, rtol=1e-4)
    for k in ("elbo", "gp_kl", "glm_reg"):
        np.testing.assert_allclose(ta[k].item(), float(ja[k]), rtol=1e-4, err_msg=k)
    for k in MAP_KEYS:
        np.testing.assert_allclose(ta["maps"][k].detach().numpy(), ja["maps"][k],
                                   atol=1e-5, err_msg=k)
    jgrads, _ = params_from_jax(jg, None, pc, "cpu")
    for (path, w), (_, p) in zip(tree_items(jgrads), tree_items(prm)):
        np.testing.assert_allclose(p.grad.numpy(), w.numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=path)


def test_packed_trainer_epoch_scan_step():
    """A Trainer with conv_pack=(2, 2) and epoch_scan=True trains an epoch
    of 10 volumes at batch 4 through its replay entry (on the CPU the
    eager step): every step runs once, the loss is finite, and it agrees
    with the unpacked Trainer's from the same seed within rtol 1e-4 (fp32
    reassociation of the packed convs), every parameter within 1e-3 of its
    leaf's largest entry."""
    cfg = VAEGAMConfig(**THIN)
    rng = np.random.default_rng(5)
    vols = rng.uniform(0, 1, size=(10,) + cfg.img_shape).astype(np.float32)
    covs = rng.normal(size=(10, cfg.num_covariates)).astype(np.float32)
    covs[:, 0] = rng.uniform(size=10) > 0.5
    glm = rng.normal(size=(cfg.img_dim, cfg.num_covariates + 1)).astype(np.float32)
    runs = {}
    for pack in (None, (2, 2)):
        t = Trainer(dataclasses.replace(cfg, conv_pack=pack), XU_RANGES, glm, seed=3,
                    enable_tb=False, device="cpu", epoch_scan=True)
        loader = DeviceResidentLoader.from_arrays(vols, covs, batch_size=4, shuffle=True,
                                                  seed=1, device="cpu")
        runs[pack] = (t.train_epoch(loader), t)
    (l0, t0), (l1, t1) = runs[None], runs[(2, 2)]
    assert np.isfinite(l1) and int(t1.opt_state["count"]) == 3
    np.testing.assert_allclose(l1, l0, rtol=1e-4)
    for (path, a), (_, b) in zip(tree_items(t1.params), tree_items(t0.params)):
        b = b.detach().numpy()
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=0,
                                   atol=1e-3 * max(np.abs(b).max(), 1e-12), err_msg=path)
