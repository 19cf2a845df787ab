"""ops/convt5.py: the decoder's output layer convt5 (the stride-1,
padding-0, 3x3x3 transposed conv from Ci channels to 1, fp32) as
hand-written CUDA kernels, and their plain version.

On the CPU: the plain forward and gradients against F.conv_transpose3d and
its autograd in float64, a gradcheck of the autograd Function, the
decoder's routing (fp32 through convt5; float64, the TPU arm and a half
precision convt5 through the stock op), the wrapper's refusals and the
kernels' tiling plan.  On the card (marked ``cuda``, skipped without one):
the kernels against the plain version in float64 at the cells' shapes
(ROADMAP F4: within 1e-3 of each output's largest entry and at most 3x
the stock op's worst), two runs bit for bit, and a Trainer's launches,
eager and captured.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vaegam_tpu_torch.data import DeviceResidentLoader
from vaegam_tpu_torch.models import VAEGAMConfig, networks
from vaegam_tpu_torch.models.vaegam import init_model
from vaegam_tpu_torch.ops import convt5 as mod
from vaegam_tpu_torch.ops.convt5 import (MAX_SMEM_BYTES, MAX_THREADS, STAGES, WIDTHS, convt5,
                                         convt5_cuda, convt5_grads_cuda, convt5_plain,
                                         convt5_plain_grads, plan)
from vaegam_tpu_torch.train import Trainer
from vaegam_tpu_torch.utils.tree import tree_map

THIN = dict(nf=2, num_latents=8, img_shape=(21, 25, 21))
MNI_ROUNDING = (23, 21, 23)   # the smallest grid that rounds as 91x109x91
XU_RANGES = [[-20.0, 20.0]] * 6


def _convt5_input(img_shape, nf, rows):
    """convt5's input shape for a decode of `rows` rows on `img_shape`: the
    decoder's output before the crop, less the 3x3x3 kernel's 2."""
    seed, _ = networks.decoder_seed_shape(img_shape)
    out = (4 * seed[0] + 17, 4 * seed[1] + 17, 4 * seed[2] + 15)
    return (rows, nf, *(o - 2 for o in out))


# the thin model, a ref41-like decode of 2 rows, the MNI rounding grid's
CPU_SHAPES = {"thin": _convt5_input(THIN["img_shape"], 2, 3),
              "ref41": _convt5_input((41, 49, 35), 8, 2),
              "mni-rounding": _convt5_input(MNI_ROUNDING, 8, 2)}


def _operands(shape, dtype=torch.float64, device="cpu", seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=g, dtype=dtype, device=device)
    w = (torch.rand((shape[1], 1, 3, 3, 3), generator=g, dtype=dtype, device=device) - 0.5)
    b = torch.rand((1,), generator=g, dtype=dtype, device=device) - 0.5
    gy = torch.randn((shape[0], 1, *(s + 2 for s in shape[2:])), generator=g, dtype=dtype,
                     device=device)
    return x, w, b, gy


@pytest.mark.parametrize("name", list(CPU_SHAPES))
def test_plain_matches_conv_transpose3d(name):
    """y, gx, gw and gb of the plain version against F.conv_transpose3d and
    its autograd, float64: equal to float64 rounding."""
    shape = CPU_SHAPES[name]
    assert shape == {"thin": (3, 2, 19, 23, 21), "ref41": (2, 8, 39, 47, 33),
                     "mni-rounding": (2, 8, 23, 19, 21)}[name]
    x, w, b, gy = _operands(shape)
    xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, b))
    ys = F.conv_transpose3d(xs, ws, bs)
    want = (ys.detach(), *torch.autograd.grad(ys, (xs, ws, bs), gy))
    got = (convt5_plain(x, w, b), *convt5_plain_grads(x, w, gy))
    for key, a, c in zip(("y", "gx", "gw", "gb"), got, want):
        assert a.shape == c.shape and a.dtype == torch.float64, key
        torch.testing.assert_close(a, c, rtol=1e-12, atol=1e-12 * float(c.abs().max()),
                                   msg=key)


def test_function_gradcheck():
    """The autograd Function on CPU tensors (the plain version and its
    gradients) passes torch's gradcheck in float64."""
    x, w, b, _ = _operands((2, 3, 3, 4, 5))
    assert torch.autograd.gradcheck(convt5, tuple(t.requires_grad_(True) for t in (x, w, b)))


def test_function_matches_the_stock_op_in_float32():
    """On the CPU in float32 the op (the plain version) tracks the stock op
    to float32's rounding, forward and backward."""
    x, w, b, gy = _operands(CPU_SHAPES["ref41"], torch.float32)
    xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, b))
    xk, wk, bk = (t.clone().requires_grad_(True) for t in (x, w, b))
    ys, yk = F.conv_transpose3d(xs, ws, bs), convt5(xk, wk, bk)
    for a, c in zip((yk, *torch.autograd.grad(yk, (xk, wk, bk), gy)),
                    (ys, *torch.autograd.grad(ys, (xs, ws, bs), gy))):
        assert float((a - c).detach().abs().max()) <= 1e-5 * float(c.detach().abs().max())


# ---------------------------------------------------------------- routing

ROUTES = {  # name: (decode keywords, params' dtype, through convt5)
    "fp32": (dict(), torch.float32, True),
    "fp32-conv-pack": (dict(conv_pack=(2, 2)), torch.float32, True),
    "bf16-fp32-final": (dict(conv_dtype=torch.bfloat16, fp32_final=True), torch.float32, True),
    "float64": (dict(), torch.float64, False),
    "tpu-products": (dict(tpu_products=True), torch.float32, False),
    "bf16": (dict(conv_dtype=torch.bfloat16), torch.float32, False),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_decoder_routes_convt5(route, monkeypatch):
    """An fp32 convt5 (an fp32 stack, or under fp32_final) goes through the
    convt5 op, under conv_pack too (the kernel keeps precedence); float64,
    the TPU arm and a half precision convt5 take the stock op."""
    kw, dtype, through = ROUTES[route]
    cfg = VAEGAMConfig(**THIN)
    params, _ = init_model(cfg, XU_RANGES, seed=1, device="cpu")
    dec = tree_map(lambda t: t.detach().to(dtype), params["dec"])
    op_calls, stock_calls = [], []
    monkeypatch.setattr(networks, "convt5",
                        lambda x, w, b: op_calls.append(x.dtype) or convt5(x, w, b))
    conv_t = networks._conv_t

    def recorded(x, p, *a, **k):
        if p is dec["convt5"]:
            stock_calls.append(x.dtype)
        return conv_t(x, p, *a, **k)

    monkeypatch.setattr(networks, "_conv_t", recorded)
    z = torch.randn(4, dec["fc5"]["w"].shape[1], dtype=dtype,
                    generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        out = networks.decode(dec, z, cfg.img_shape, **kw)
    assert out.shape == (4, int(np.prod(cfg.img_shape))) and torch.isfinite(out).all()
    if through:
        assert op_calls == [torch.float32] and stock_calls == []
    else:
        assert op_calls == [] and len(stock_calls) == 1


# ---------------------------------------------------- the wrapper's refusals

def _refused(fn, *args, err=ValueError, match=None):
    launches, captured = convt5.launches, convt5.captured
    with pytest.raises(err, match=match):
        fn(*args)
    assert (convt5.launches, convt5.captured) == (launches, captured)


def test_kernels_refuse_cpu_tensors_without_launching(monkeypatch):
    monkeypatch.setattr(mod, "_library", pytest.fail)   # nothing is built or called
    x, w, b, gy = _operands((2, 8, 5, 6, 7), torch.float32)
    _refused(convt5_cuda, x, w, b, match="CUDA tensors")
    _refused(convt5_grads_cuda, x, w, gy, match="CUDA tensors")


@pytest.mark.parametrize("bad", ["float64", "weight-shape", "bias-shape", "non-contiguous",
                                 "four-dims", "too-wide", "gy-shape"])
def test_kernels_refuse_unsupported_shapes(bad, monkeypatch):
    monkeypatch.setattr(mod, "_library", pytest.fail)
    x, w, b, gy = _operands((2, 8, 5, 6, 7), torch.float32)
    if bad == "float64":
        _refused(convt5_cuda, x.double(), w, b, err=TypeError)
    elif bad == "weight-shape":
        _refused(convt5_cuda, x, w[:4], b, match="do not fit")
    elif bad == "bias-shape":
        _refused(convt5_cuda, x, w, torch.zeros(2), match="do not fit")
    elif bad == "non-contiguous":
        _refused(convt5_cuda, x.transpose(3, 4), w, b, match="contiguous")
    elif bad == "four-dims":
        _refused(convt5_cuda, x[0], w, b, match="B, Ci, D, H, W")
    elif bad == "too-wide":   # 32 channels of 300 columns: more threads than a block
        x = torch.zeros((1, 32, 3, 3, 300))
        _refused(convt5_cuda, x, torch.zeros((32, 1, 3, 3, 3)), b, match="threads")
    else:
        _refused(convt5_grads_cuda, x, w, gy[..., 1:], match="gy")


# ------------------------------------------------------------ the plan

PLAN_SHAPES = [(288, 8, 39, 47, 33), (180, 8, 39, 47, 33), (288, 8, 91, 107, 89),
               (18, 8, 91, 107, 89), (72, 2, 19, 23, 21), (3, 4, 5, 6, 6), (3, 3, 4, 7, 8),
               (1, 1, 1, 1, 1)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_covers_the_shape_within_a_block(shape):
    """What csrc/convt5.cu trusts: the chunks cover each row, the bands the
    rows, the padded rows hold a chunk's reads, buffers are 16-byte
    multiples, and each kernel fits one block's threads and shared memory."""
    b, ci, d, h, w = shape
    p = plan(*shape)
    assert p.fx in WIDTHS and p.bx in WIDTHS
    assert p.fnch * p.fx >= w + 2 > (p.fnch - 1) * p.fx
    assert p.bnch * p.bx >= w > (p.bnch - 1) * p.bx
    assert p.fnty * p.fty >= h + 2 > (p.fnty - 1) * p.fty
    assert p.bnty * p.bty >= h > (p.bnty - 1) * p.bty
    # forward: a chunk reads words xo .. xo + X + 1 of fty + 2 rows
    assert p.frs >= p.fnch * p.fx + 2 and p.frs % 2 == 1 and p.fcs >= (p.fty + 2) * p.frs
    assert p.fos >= p.fty * (w + 2)
    # backward: gy rows of W + 2 and reads to xo + X + 1; x reads to xo + X - 1
    assert p.brsg >= max(p.bnch * p.bx + 2, w + 2) and p.brsx >= p.bnch * p.bx
    assert p.bgsz >= (p.bty + 2) * p.brsg and p.bxs >= p.bty * p.brsx and p.bxs % 32 == 4
    assert p.bgxs >= p.bty * w
    assert all(v % 4 == 0 for v in (p.fcs, p.fos, p.bgsz, p.bxs, p.bgxs))
    assert p.fthreads == p.fty * p.fnch and p.bthreads == ci * p.bty * p.bnch
    assert max(p.fthreads, p.bthreads) <= MAX_THREADS
    assert ci % p.fcg == 0
    assert p.fsmem == 4 * (STAGES * p.fcg * p.fcs + 28 * ci + 2 * p.fos) + 12 * p.fcg * (p.fty + 2)
    assert p.fsmem <= MAX_SMEM_BYTES
    assert p.bsmem >= max(4 * (STAGES * (p.bgsz + ci * p.bxs) + 2 * ci * p.bgxs + 28 * ci)
                          + 16 * ci * p.bty, 4 * 30 * p.bthreads)
    assert p.bsmem <= MAX_SMEM_BYTES
    assert (p.fblocks, p.bblocks, p.nparts) == (b * p.fnty, b * p.bnty, 27 * ci + 1)


def test_plan_of_the_cells():
    """The cells' tilings: 35 and 91 output columns split exactly into 7s;
    33 input columns into 7s, and 89 into 8s, whose 12 chunks of 8
    channels fill three warps (9s would leave half a warp idle)."""
    ref, mni = plan(288, 8, 39, 47, 33), plan(288, 8, 91, 107, 89)
    assert (ref.fx, ref.fnch, ref.bx, ref.bnch, ref.bthreads) == (7, 5, 7, 5, 120)
    assert (mni.fx, mni.fnch, mni.bx, mni.bnch, mni.bthreads) == (7, 13, 8, 12, 96)
    # the forward stages a plane in groups of channels: 4 at ref41, 2 at MNI
    assert (ref.fcg, mni.fcg) == (4, 2) and max(ref.fsmem, mni.fsmem) <= mod.FWD_SMEM
    # the widest forward block that still gives four blocks an SM
    assert (ref.fthreads, ref.fblocks, mni.fthreads, mni.fblocks) == (125, 576, 247, 1728)


def test_layout_matches_the_kernel_source():
    """The plan's fields and the chunk widths are csrc/convt5.cu's."""
    import re
    from pathlib import Path

    src = (Path(mod.__file__).parent / "csrc" / "convt5.cu").read_text()
    body = re.search(r"struct Plan \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = [f.strip() for f in body.replace("int ", "").replace(";", ",").split(",")
              if f.strip()]
    assert fields == list(mod.Convt5Plan._fields)
    widths = re.search(r"kXs\[kNumX\] = \{([^}]*)\}", src).group(1)
    assert tuple(int(v) for v in widths.split(",")) == WIDTHS
    assert f"kMaxThreads = {MAX_THREADS};" in src
    assert f"kStages = {STAGES};" in src


def test_cpu_trainer_takes_the_plain_version(monkeypatch):
    """A CPU Trainer's step goes through the plain version: nothing built,
    launched or counted."""
    monkeypatch.setattr(mod, "_library", pytest.fail)
    calls = []
    monkeypatch.setattr(mod, "convt5_plain_grads",
                        lambda *a: calls.append(1) or convt5_plain_grads(*a))
    rng = np.random.default_rng(5)
    cfg = VAEGAMConfig(**THIN)
    glm = rng.normal(size=(cfg.img_dim, cfg.num_covariates + 1)).astype(np.float32)
    t = Trainer(cfg, XU_RANGES, glm, seed=3, enable_tb=False, device="cpu")
    launches, captured = convt5.launches, convt5.captured
    x = torch.tensor(rng.uniform(0, 1, size=(2,) + cfg.img_shape).astype(np.float32))
    covs = torch.tensor(rng.normal(size=(2, cfg.num_covariates)).astype(np.float32))
    t.train_step(covs, x)
    assert calls == [1]
    assert (convt5.launches, convt5.captured) == (launches, captured)


# ------------------------------------------------------------------ the card

CARD_SHAPES = [(288, 8, 39, 47, 33), (180, 8, 39, 47, 33), (288, 8, 91, 107, 89),
               (18, 8, 91, 107, 89)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vaegam_tpu_torch._device import configure_cuda_backends

    configure_cuda_backends()


def _share(got, want, chunk=8):
    """max |got - want| over max |want|, float64, `chunk` rows at a time."""
    err = big = 0.0
    for i in range(0, want.shape[0], chunk):
        w = want[i:i + chunk].double()
        err = max(err, float((got[i:i + chunk].double() - w).abs().max()))
        big = max(big, float(w.abs().max()))
    return err / big


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=["ref41", "ref41-tail", "mni", "mni-tail"])
def test_kernels_match_plain_on_the_card(shape):
    """y, gx, gw and gb of the kernels against the plain version in float64
    (ROADMAP F4: within 1e-3 of each output's largest entry, and the worst
    at most 3x the stock op's worst); two runs bit for bit; three launches."""
    _card()
    x, w, b, gy = _operands(shape, torch.float32, "cuda", seed=7)
    launches = convt5.launches
    kern = (convt5_cuda(x, w, b), *convt5_grads_cuda(x, w, gy))
    again = (convt5_cuda(x, w, b), *convt5_grads_cuda(x, w, gy))
    torch.cuda.synchronize()
    assert convt5.launches - launches == 6
    assert all(torch.equal(a, c) for a, c in zip(kern, again))
    del again
    xs, ws, bs = (t.clone().requires_grad_(True) for t in (x, w, b))
    ys = F.conv_transpose3d(xs, ws, bs)
    stock = (ys.detach(), *torch.autograd.grad(ys, (xs, ws, bs), gy))
    del xs, ws, bs, ys
    x64, w64, gy64 = x.double(), w.double(), gy.double()
    ref = convt5_plain(x64, w64, b.double())
    shares = [(_share(kern[0], ref), _share(stock[0], ref))]
    del ref
    for k, s, r in zip(kern[1:], stock[1:], convt5_plain_grads(x64, w64, gy64)):
        shares.append((_share(k, r), _share(s, r)))
    worst, stock_worst = max(a for a, _ in shares), max(c for _, c in shares)
    assert worst <= 1e-3 and worst <= 3 * stock_worst, shares


def _card_trainer(epoch_scan):
    rng = np.random.default_rng(5)
    cfg = VAEGAMConfig(**THIN)
    glm = rng.normal(size=(cfg.img_dim, cfg.num_covariates + 1)).astype(np.float32)
    t = Trainer(cfg, XU_RANGES, glm, seed=3, enable_tb=False, device="cuda",
                epoch_scan=epoch_scan)
    vols = rng.uniform(0, 1, size=(10,) + cfg.img_shape).astype(np.float32)
    covs = rng.normal(size=(10, cfg.num_covariates)).astype(np.float32)
    loader = DeviceResidentLoader.from_arrays(vols, covs, batch_size=4, shuffle=True, seed=3,
                                              device="cuda")
    return t, loader


@pytest.mark.cuda
@pytest.mark.parametrize("epoch_scan", [False, True], ids=["eager", "replayed"])
def test_card_trainer_runs_three_kernels_a_step(epoch_scan, monkeypatch):
    """A Trainer on the card runs convt5's three kernels a step (forward,
    fused gradients, reduction), never the plain version: eager launches,
    or three captured a graph and three a replay."""
    _card()
    monkeypatch.setattr(mod, "convt5_plain", pytest.fail)
    monkeypatch.setattr(mod, "convt5_plain_grads", pytest.fail)
    t, loader = _card_trainer(epoch_scan)
    convt5.launches = convt5.captured = 0
    for _ in range(3):
        t.train_epoch(loader)
    torch.cuda.synchronize()
    assert convt5.launches + 3 * sum(t.replays.values()) == 3 * 3 * len(loader)
    assert convt5.captured == 3 * sum(t.captures.values())
    assert (convt5.captured > 0) == epoch_scan
