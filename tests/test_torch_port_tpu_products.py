"""The TPU's product arithmetic: ``vaegam_tpu_torch.ops.products`` and
``VAEGAMConfig(tpu_products=True)`` against the JAX package, on the CPU.

The JAX package sets no matmul precision, so on the TPU that made its
records every ``dot_general`` and ``conv_general_dilated`` of the step ran
at DEFAULT precision: both operands rounded to bfloat16, the sums in
float32, forward and backward.  The reference here is JAX's own jaxpr of
the step, evaluated by :class:`RoundingInterpreter`, which rounds both
operands of every DEFAULT-precision product with JAX's
``astype(bfloat16)`` and binds every other equation as it is (the
Cholesky and solve rules' own products carry ``Precision.HIGHEST`` and
stay full precision, as the TPU computes them).  Both sides run in
float64 (tests/torch_port_common.py), so that only the rounding sites and
the sums' order can part them.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.extend import core as jcore
from jax._src.interpreters import partial_eval as pe

from vaegam_tpu.models import VAEGAMConfig as JaxConfig, forward as jax_forward

from vaegam_tpu_torch.models import VAEGAMConfig, forward
from vaegam_tpu_torch.ops import products
from vaegam_tpu_torch.ops.conv5 import conv5
from vaegam_tpu_torch.utils.jax_params import params_from_jax
from vaegam_tpu_torch.utils.tree import tree_items, tree_map

from torch_port_common import (THIN, f64_jax, f64_port, jax_float64, jax_noise, make_batch,
                               make_model, to_np)

ORACLE_FLAGS = dict(glm_reg_scale=1.0, qu_s_cholesky=True, fused_norm_stats=True,
                    neural_covariates=False)
BATCH = 4


def _jax_round(v):
    return v.astype(jnp.bfloat16).astype(v.dtype)


# ---------------------------------------------------------------------------
# 1. round_bf16 against JAX's astype(bfloat16), bit for bit
# ---------------------------------------------------------------------------

def _special_values(dtype):
    """Exact ties (a bfloat16 value plus half its ulp, even and odd last
    bits, both signs), subnormals, the largest finite values, +-0, +-inf
    and NaN."""
    rng = np.random.default_rng(5)
    b16 = rng.integers(0, 2**16, 4000, dtype=np.uint32) << 16
    base = b16.view(np.float32)
    base = base[np.isfinite(base)]
    half_ulp = (np.abs(base).view(np.uint32) & 0x7F800000).view(np.float32) * 2.0**-8
    ties = np.concatenate([base + half_ulp, base - half_ulp]).astype(np.float32)
    sub = (rng.integers(1, 2**23, 2000, dtype=np.uint32)
           | (rng.integers(0, 2, 2000, dtype=np.uint32) << 31)).view(np.float32)
    f32 = np.finfo(np.float32)
    edge = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, f32.max, -f32.max, f32.tiny,
                     f32.smallest_subnormal, 1.0 + 2**-8, 1.0 + 3 * 2**-8], np.float32)
    vals = np.concatenate([ties, sub, edge]).astype(dtype)
    if dtype == np.float64:   # float64 ties that double rounding decides
        fine = (1.0 + 2.0**-8 + np.array([2.0**-30, -2.0**-30, 2.0**-40, 2.0**-25]))
        tiny = float(np.finfo(np.float32).tiny)   # flushed below it, as XLA does
        near = tiny * (1 + np.array([0.0, -2.0**-30, -2.0**-25, -2.0**-24, -0.5, 2.0**-30]))
        vals = np.concatenate([vals, fine, -fine, near, -near,
                               rng.normal(size=4000) * 1e-300])
    return vals


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["float32", "float64"])
def test_round_bf16_matches_jax_bit_for_bit(dtype):
    rng = np.random.default_rng(0)
    wide = (rng.normal(size=20000) * np.exp(rng.uniform(-80, 80, 20000))).astype(dtype)
    vals = np.concatenate([wide, _special_values(dtype)])
    with jax.enable_x64(True):
        want = np.asarray(_jax_round(jnp.asarray(vals)))
    got = products.round_bf16(torch.from_numpy(vals)).numpy()
    assert got.dtype == want.dtype == dtype
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    uint = np.uint32 if dtype == np.float32 else np.uint64
    np.testing.assert_array_equal(got[~nan].view(uint), want[~nan].view(uint))
    assert (got[~nan] != vals[~nan]).any()          # it does round
    for half in (torch.bfloat16, torch.float16):
        t = torch.from_numpy(wide[:100].astype(np.float32)).to(half)
        assert products.round_bf16(t) is t


# ---------------------------------------------------------------------------
# 2. each contraction, forward and both gradients, against float64 on the
#    rounded operands
# ---------------------------------------------------------------------------

def _r64(t):
    return products.round_bf16(t).double()


def _cases():
    g = torch.Generator().manual_seed(3)

    def rnd(*shape):
        return torch.randn(shape, generator=g)

    return {
        "conv3d": (lambda a, b: products.conv3d(a, b, None, stride=2, padding=1),
                   lambda a, b: F.conv3d(a, b, None, stride=2, padding=1),
                   rnd(2, 3, 7, 6, 5), rnd(4, 3, 3, 3, 3)),
        "conv_transpose3d": (
            lambda a, b: products.conv_transpose3d(a, b, None, 2, (1, 0, 1), (1, 0, 1)),
            lambda a, b: F.conv_transpose3d(a, b, None, 2, (1, 0, 1), (1, 0, 1)),
            rnd(2, 4, 3, 4, 3), rnd(4, 2, 3, 3, 3)),
        "conv1d": (products.conv1d, F.conv1d, rnd(3, 1, 20), rnd(1, 1, 15)),
        "linear": (products.linear, F.linear, rnd(5, 17), rnd(9, 17)),
        "matmul": (products.matmul, torch.matmul, rnd(6, 4, 6), rnd(6, 6, 3)),
        "einsum": (lambda a, b: products.einsum("cb,cbd->bd", a, b),
                   lambda a, b: torch.einsum("cb,cbd->bd", a, b),
                   rnd(8, 4), rnd(8, 4, 50)),
    }


@pytest.mark.parametrize("op", sorted(_cases()))
def test_product_matches_float64_on_rounded_operands(op):
    """The product of two bfloat16 values is exact in float32, so each
    result differs from the float64 product of the rounded operands by the
    float32 sums alone (~1e-7 relative; bound 1e-6 of the largest entry),
    and from the unrounded product by ~1e-3.  One site of each kind."""
    fn, ref, a, b = _cases()[op]
    ga = a.clone().requires_grad_(True)
    gb = b.clone().requires_grad_(True)
    products.reset_sites()
    y = fn(ga, gb)
    cot = torch.randn(y.shape, generator=torch.Generator().manual_seed(4))
    da, db = torch.autograd.grad(y, (ga, gb), cot)
    assert products.site_counts() == {"forward": 1, "input_grad": 1, "weight_grad": 1}

    ra, rb = _r64(a).requires_grad_(True), _r64(b).requires_grad_(True)
    want = ref(ra, rb)
    wa, wb = torch.autograd.grad(want, (ra, rb), _r64(cot))
    for got, w in ((y, want), (da, wa), (db, wb)):
        assert got.dtype == torch.float32
        scale = float(w.detach().abs().max())
        np.testing.assert_allclose(got.detach().double().numpy(), w.detach().numpy(),
                                   rtol=0, atol=1e-6 * scale)
    unrounded, want = ref(a.double(), b.double()), want.detach()
    assert float((unrounded - want).abs().max()) > 1e-4 * float(want.abs().max())


def test_conv5_one_pass_plain_version_and_backward():
    """conv5's one-pass path on the CPU (its plain version) against
    products.conv3d: forward and both gradients in float64, the bias
    gradient from the unrounded cotangent; one site of each kind."""
    g = torch.Generator().manual_seed(6)
    x, w, b = (torch.randn(s, generator=g, dtype=torch.float64)
               for s in ((2, 4, 5, 6, 5), (4, 4, 3, 3, 3), (4,)))
    got_in = [t.clone().requires_grad_(True) for t in (x, w, b)]
    want_in = [t.clone().requires_grad_(True) for t in (x, w, b)]
    products.reset_sites()
    y = conv5(*got_in, one_pass=True)
    cot = torch.randn(y.shape, generator=g, dtype=torch.float64)
    got = (y, *torch.autograd.grad(y, got_in, cot))
    assert products.site_counts() == {"forward": 1, "input_grad": 1, "weight_grad": 1}
    yw = products.conv3d(*want_in)
    want = (yw, *torch.autograd.grad(yw, want_in, cot))
    for a, c in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), c.detach().numpy(), rtol=0,
                                   atol=1e-12 * float(c.detach().abs().max()))
    products.reset_sites()
    conv5(x, w, b)
    assert products.site_counts()["forward"] == 0


# ---------------------------------------------------------------------------
# 3. the step against JAX's jaxpr, evaluated with the TPU's rounding
# ---------------------------------------------------------------------------

PRODUCTS = ("dot_general", "conv_general_dilated")
CALLS = ("jit", "pjit", "closed_call", "core_call")


def _default_precision(eqn) -> bool:
    prec = eqn.params.get("precision")
    if prec is None:
        return True
    prec = prec if isinstance(prec, tuple) else (prec, prec)
    return all(p in (None, jax.lax.Precision.DEFAULT) for p in prec)


def _sub_jaxprs(params):
    for v in params.values():
        for item in (v if isinstance(v, (tuple, list)) else (v,)):
            if isinstance(item, jcore.ClosedJaxpr):
                yield item.jaxpr
            elif isinstance(item, jcore.Jaxpr):
                yield item
            elif hasattr(item, "_fields"):      # linear_solve's jaxprs tuple
                yield from _sub_jaxprs(item._asdict())


def _rounded_products_inside(eqn) -> int:
    n = 0
    for sub in _sub_jaxprs(eqn.params):
        for e in sub.eqns:
            n += int(e.primitive.name in PRODUCTS and _default_precision(e))
            n += _rounded_products_inside(e)
    return n


class RoundingInterpreter:
    """Evaluates a closed jaxpr with both operands of every DEFAULT-precision
    ``dot_general`` and ``conv_general_dilated`` rounded by JAX's
    ``astype(bfloat16)``, recursing into ``jit`` sub-jaxprs and binding
    every other equation as it is (a bound equation must hold no such
    product).

    It counts the rounded sites by kind.  A product with no operand that
    depends on the cotangent (the ``tainted`` inputs) is a forward site; a
    backward site's other operand is the saved primal operand (or its
    ``rev``, for a conv's input gradient) of a forward site P: when that
    is P's second operand, the site forms the gradient of P's first
    (``input_grad``), else of its second (``weight_grad``), as JAX's
    transpose rules build them; the result's size must equal the operand
    it is the gradient of, which settles an operand shared by two sites."""

    def __init__(self):
        self.counts = Counter()
        self.highest = 0
        self.roles = {}     # id(forward operand) -> [(role, size of the other operand)]
        self.keep = []      # the forward operands, alive while their ids are used
        self.rev_of = {}    # id(rev output) -> its input
        self.symmetric = {}  # site -> the kind its second backward product takes

    def run(self, closed, args, tainted):
        outs, _ = self._eval(closed.jaxpr, closed.consts, args, tainted)
        return outs

    def _eval(self, jaxpr, consts, args, tainted):
        env, taint = {}, set()

        def read(v):
            return v.val if isinstance(v, jcore.Literal) else env[v]

        def is_tainted(v):
            return not isinstance(v, jcore.Literal) and v in taint

        for v, x in zip(jaxpr.constvars, consts):
            env[v] = x
        for v, x, t in zip(jaxpr.invars, args, tainted):
            env[v] = x
            if t:
                taint.add(v)
        for eqn in jaxpr.eqns:
            vals = [read(v) for v in eqn.invars]
            flags = [is_tainted(v) for v in eqn.invars]
            name = eqn.primitive.name
            if name in CALLS:
                sub = eqn.params["jaxpr"]
                outs, out_t = self._eval(sub.jaxpr, sub.consts, vals, flags)
            elif name in PRODUCTS and _default_precision(eqn):
                outs = [self._product(eqn, vals, flags)]
                out_t = [any(flags)] * 1
            else:
                if name in PRODUCTS:
                    self.highest += 1
                if _rounded_products_inside(eqn):
                    raise NotImplementedError(f"{name} holds DEFAULT-precision products")
                subfuns, params = eqn.primitive.get_bind_params(eqn.params)
                outs = eqn.primitive.bind(*subfuns, *vals, **params)
                outs = list(outs) if eqn.primitive.multiple_results else [outs]
                out_t = [any(flags)] * len(outs)
                if name == "rev":
                    self.rev_of[id(outs[0])] = vals[0]
                    self.keep.append(outs[0])
            for v, x, t in zip(eqn.outvars, outs, out_t):
                env[v] = x
                if t:
                    taint.add(v)
        return [read(v) for v in jaxpr.outvars], [is_tainted(v) for v in jaxpr.outvars]

    def _product(self, eqn, vals, flags):
        a, b = vals
        out = eqn.primitive.bind(_jax_round(a), _jax_round(b), **eqn.params)
        if not any(flags):
            site = self.counts["forward"]
            self.counts["forward"] += 1
            self.keep += [a, b]
            self.roles.setdefault(id(a), []).append((site, "weight_grad", int(np.size(b))))
            self.roles.setdefault(id(b), []).append((site, "input_grad", int(np.size(a))))
            return out
        if all(flags):
            raise AssertionError("a product of two cotangent-dependent operands")
        saved = b if flags[0] else a
        cands = self.roles.get(id(saved)) or self.roles.get(id(self.rev_of.get(id(saved))), [])
        cands = [c for c in cands if c[2] == int(np.size(out))]
        kinds = {kind for _, kind, _ in cands}
        if len(kinds) == 1:
            self.counts[kinds.pop()] += 1
        elif len({site for site, _, _ in cands}) == 1:
            # both operands of one site are this object (L L^T): its two
            # backward products are one of each kind
            self.counts[self.symmetric.pop(cands[0][0], "input_grad")] += 1
            self.symmetric.setdefault(cands[0][0], "weight_grad")
        else:
            raise AssertionError(f"backward {eqn.primitive.name} of shape {np.shape(out)}: "
                                 f"kind not settled by {cands}")
        return out


def _jax_step(flags):
    """(jax params, jax consts, inputs, the DCE'd jaxpr of (loss, grads) as a
    function of (params, cotangent), its tree of outputs) in float64."""
    jc, pc, params, consts, _, _ = make_model(dict(THIN, **flags))
    covs, x = make_batch(jc.img_shape, BATCH)
    key = jax.random.PRNGKey(11)
    jp, jcs = f64_jax(to_np(params)), f64_jax(to_np(consts))
    covs64, x64 = jnp.asarray(covs, jnp.float64), jnp.asarray(x, jnp.float64)

    def step(p, ct):
        loss, vjp = jax.vjp(lambda q: jax_forward(q, jcs, key, covs64, x64, jc)[0], p)
        return loss, vjp(ct)[0]

    closed = jax.make_jaxpr(step)(jp, jnp.float64(1.0))
    jaxpr, _ = pe.dce_jaxpr(closed.jaxpr, [True] * len(closed.jaxpr.outvars))
    out_tree = jax.tree_util.tree_structure(jax.eval_shape(step, jp, jnp.float64(1.0)))
    return jc, jp, jcs, covs, x, key, jcore.ClosedJaxpr(jaxpr, closed.consts), out_tree


@pytest.fixture(scope="module")
def jax_side():
    """For each flag set: JAX's rounded step (loss, gradients, site counts)
    and what the port needs to take the same step."""
    out = {}
    with jax_float64():
        for fid, flags in FLAG_SETS.items():
            jc, jp, jcs, covs, x, key, closed, tree = _jax_step(flags)
            interp = RoundingInterpreter()
            leaves = jax.tree_util.tree_leaves(jp)
            flat = interp.run(closed, [*leaves, jnp.float64(1.0)],
                              [False] * len(leaves) + [True])
            loss, grads = jax.tree_util.tree_unflatten(tree, flat)
            out[fid] = dict(loss=float(loss), grads=to_np(grads), counts=dict(interp.counts),
                            highest=interp.highest, params=to_np(jp), consts=to_np(jcs),
                            covs=covs, x=x,
                            noise=jax_noise(key, BATCH, jc.num_latents))
    return out


FLAG_SETS = {"oracle_flags": ORACLE_FLAGS, "defaults": {}}
# product sites by kind in one step (chip_smoke.py's TPU_ORACLE_SITES holds
# the oracle's at full width to the same counts)
SITES = {"oracle_flags": {"forward": 29, "input_grad": 29, "weight_grad": 27},
         "defaults": {"forward": 29, "input_grad": 28, "weight_grad": 27}}


def _port_step(js, flags, tpu):
    pc = VAEGAMConfig(**THIN, tpu_products=tpu, **flags)
    tp, tc = params_from_jax(js["params"], js["consts"], pc, "cpu")
    prm = tree_map(lambda t: t.double().requires_grad_(True), f64_port(tp))
    products.reset_sites()
    loss, _ = forward(prm, f64_port(tc), torch.tensor(js["covs"], dtype=torch.float64),
                      torch.tensor(js["x"], dtype=torch.float64), pc,
                      noise=tuple(torch.from_numpy(np.array(n)) for n in js["noise"]))
    loss.backward()
    return pc, float(loss.detach()), prm, products.site_counts()


@pytest.mark.parametrize("fid", sorted(FLAG_SETS))
def test_step_matches_jax_jaxpr_with_tpu_rounding(jax_side, fid):
    """The thin model (nf=2, 8 latents, 21x25x21) at B=4, at the oracle's
    flags and at the defaults (the HRF's convolution on): the port's
    ``tpu_products=True`` step against JAX's jaxpr of the same step (the
    value and the VJP at cotangent 1) evaluated with both operands of every
    DEFAULT-precision product rounded; JAX's ``pallas_conv5`` off, the
    port's conv5 on its one-pass plain version.  Both in float64 from the
    same weights and noise.

    Loss rtol 1e-9, gradients 1e-7 of each leaf's largest entry, the
    existing float64 bounds: the rounded operands are the same numbers on
    both sides unless a value sits within its float64 sum-order difference
    (~1e-16 relative, ~1e-11 downstream of the GP solve) of a bfloat16
    rounding boundary, whose spacing is 2^-8 relative: with ~1e6 rounded
    values a step, about 1e-8 flips are expected.  ``logkvar`` is bounded
    as tests/test_torch_port_oracle.py::test_oracle_training_tracks_jax
    bounds it (its gradient cancels to rounding through Kqq - A Kuu A^T):
    1e-7 of the largest gradient entry of the GP bank.  The site counts by
    kind equal the interpreter's, and the step without the flag routes no
    product through ``ops.products`` and differs from the rounded one.

    The arm's relu is JAX's ``jnp.maximum(x, 0.0)`` (``products.relu``:
    gradient 1/2 at an exact zero, where ``F.relu``'s is 0).  Rounded
    operands have few bits, so a sum cancels to an exact zero far more often
    than in float32 (once in the defaults' thin step: one element of
    convt4's output), and the other tie rule would part the gradients there
    by ~1e-4."""
    js = jax_side[fid]
    pc, loss, prm, sites = _port_step(js, FLAG_SETS[fid], True)
    np.testing.assert_allclose(loss, js["loss"], rtol=1e-9)
    assert sites == {k: js["counts"].get(k, 0) for k in products.KINDS} == SITES[fid]
    assert js["highest"] > 0
    want, _ = params_from_jax(js["grads"], None, pc)
    gp_scale = max(float(np.abs(v).max()) for k, v in js["grads"]["gp"].items())
    for (path, p), (_, w) in zip(tree_items(prm), tree_items(want)):
        scale = gp_scale if path == "gp/logkvar" else float(w.abs().max())
        np.testing.assert_allclose(p.grad.numpy(), w.double().numpy(), rtol=0,
                                   atol=1e-7 * scale, err_msg=path)
    _, off, _, off_sites = _port_step(js, FLAG_SETS[fid], False)
    assert not any(off_sites.values())
    assert abs(off - loss) >= 1e-5 * abs(loss), (off, loss)


def test_flag_off_routes_nothing_through_the_rounded_products():
    """The default config's forward, backward, recon forward and the GP
    plots' posterior leave the site counter at 0."""
    from vaegam_tpu_torch.models import init_model
    from vaegam_tpu_torch.models.gp import evaluate_posterior_diag
    from vaegam_tpu_torch.models.vaegam import gp_transforms, resolve_qu_S

    cfg = VAEGAMConfig(**THIN)
    assert cfg.tpu_products is False
    rng = np.random.default_rng(0)
    glm = rng.normal(size=(cfg.img_dim, 9)).astype(np.float32)
    params, consts = init_model(cfg, [[-2.0, 2.0]] * 6, glm, device="cpu")
    params = tree_map(lambda t: t.requires_grad_(True), params)
    covs, x = make_batch(cfg.img_shape, BATCH)
    products.reset_sites()
    loss, _ = forward(params, consts, torch.tensor(covs), torch.tensor(x), cfg,
                      generator=torch.Generator().manual_seed(0))
    loss.backward()
    with torch.no_grad():
        forward(params, consts, torch.tensor(covs), torch.tensor(x), cfg,
                deterministic=True, return_maps=True)
        kvar, ls = gp_transforms(params["gp"], cfg)
        evaluate_posterior_diag(consts["xu"], kvar, ls, params["gp"]["qu_m"],
                                resolve_qu_S(params["gp"]), torch.tensor(covs[:, 1:7].T))
    assert products.site_counts() == {"forward": 0, "input_grad": 0, "weight_grad": 0}


def test_gp_diag_follows_jax_contraction_path():
    """The GP plots' marginal variance in the arm: JAX's three-operand
    einsum contracts (qu_S - Kuu) with a_t first; the port's pairwise
    contractions on rounded operands equal JAX's jaxpr evaluated with the
    rounding, in float64, per covariate."""
    import vaegam_tpu.models.gp as jax_gp
    from vaegam_tpu_torch.models.gp import evaluate_posterior_diag

    rng = np.random.default_rng(2)
    g, p, n = 6, 6, 40
    xu = np.tile(np.linspace(-20.0, 20.0, p), (g, 1))
    kvar, ls = rng.uniform(0.5, 1.5, g), rng.uniform(1.0, 3.0, g)
    qu_m = rng.normal(size=(g, p))
    low = np.tril(rng.normal(size=(g, p, p)) * 0.3) + 2 * np.eye(p)
    qu_s = low @ np.swapaxes(low, -1, -2)
    xq = rng.normal(size=(g, n)) * 5
    got = evaluate_posterior_diag(*(torch.tensor(a) for a in (xu, kvar, ls, qu_m, qu_s, xq)),
                                  tpu_products=True)
    with jax.enable_x64(True):
        for j in range(g):
            args = [jnp.asarray(a[j]) for a in (xu, kvar, ls, qu_m, qu_s, xq)]
            closed = jax.make_jaxpr(jax_gp.evaluate_posterior_diag)(*args)
            interp = RoundingInterpreter()
            want = interp.run(closed, args, [False] * len(args))
            assert interp.counts["forward"] == 3
            for k in range(2):
                np.testing.assert_allclose(got[k][j].numpy(), np.asarray(want[k]),
                                           rtol=1e-12, atol=1e-12)


def test_conv_pack_in_the_arm_matches_unpacked(jax_side):
    """``conv_pack=(2, 2)`` in the arm: packing only moves values and inserts
    zeros, so the packed convs round the same operands and form the same
    products; the float64 step (loss rtol 1e-9, gradients 1e-7 of each
    leaf's largest entry, the same sites) equals the unpacked one."""
    js = jax_side["oracle_flags"]
    _, want, want_prm, want_sites = _port_step(js, ORACLE_FLAGS, True)
    _, got, prm, sites = _port_step(js, dict(ORACLE_FLAGS, conv_pack=(2, 2)), True)
    np.testing.assert_allclose(got, want, rtol=1e-9)
    assert sites == want_sites
    for (path, p), (_, w) in zip(tree_items(prm), tree_items(want_prm)):
        np.testing.assert_allclose(p.grad.numpy(), w.grad.numpy(), rtol=0,
                                   atol=1e-7 * float(w.grad.abs().max()), err_msg=path)
