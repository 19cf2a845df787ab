"""The port's conv5 op (vaegam_tpu_torch/ops) and the port's import rules.

On the CPU the op takes its plain PyTorch version; the CUDA kernel itself is
held against that plain version by test_conv5_kernel_matches_plain_on_card
(marked ``cuda``, skipped without a card) and by chip_smoke.py.  The JAX side
is ``conv3d_s1_pallas`` in Pallas interpret mode, patched exactly as
tests/test_ops.py does.
"""

import contextlib
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vaegam_tpu_torch.ops import build
from vaegam_tpu_torch.ops.conv5 import (MAX_SMEM_BYTES, MAX_TILES, SLICE_STEPS,
                                        check_kernel_inputs, conv5, conv5_cuda, conv5_plain,
                                        plan, vector_staging)

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def pallas_interpret():
    import vaegam_tpu.ops.pallas_conv as pc

    orig = pc.pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    pc.pl.pallas_call = interp_call
    try:
        yield pc
    finally:
        pc.pl.pallas_call = orig


def _to_port(x, w, b):
    """NDHWC / DHWIO (JAX) -> NCDHW / OIDHW (port) tensors with grad."""
    xt = torch.tensor(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3)), requires_grad=True)
    wt = torch.tensor(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)), requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    return xt, wt, bt


@pytest.mark.parametrize("shape", [(2, 8, 10, 6, 16, 16), (3, 8, 10, 6, 16, 16),
                                   (2, 5, 6, 5, 4, 4)],
                         ids=["main", "odd-batch", "ci4"])
def test_conv5_matches_pallas_interpret(shape):
    """Forward atol 2e-5 and gradients of sum(sin(y)) atol 2e-4, as
    tests/test_ops.py holds the Pallas kernel to lax (fp32 sums of 432
    products in another order)."""
    bsz, d, h, wd, ci, co = shape
    rng = np.random.default_rng(0)
    x = rng.normal(size=(bsz, d, h, wd, ci)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, ci, co)) * 0.1).astype(np.float32)
    b = rng.normal(size=(co,)).astype(np.float32)
    with pallas_interpret() as pc:
        want = np.asarray(pc.conv3d_s1_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
        gj = jax.grad(lambda *a: jnp.sum(jnp.sin(pc.conv3d_s1_pallas(*a))),
                      argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    xt, wt, bt = _to_port(x, w, b)
    y = conv5(xt, wt, bt)
    assert tuple(y.shape) == (bsz, co, d - 2, h - 2, wd - 2)
    np.testing.assert_allclose(y.detach().numpy().transpose(0, 2, 3, 4, 1), want, atol=2e-5)
    torch.sum(torch.sin(y)).backward()
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 4, 1), np.asarray(gj[0]),
                               atol=2e-4)
    np.testing.assert_allclose(wt.grad.numpy().transpose(2, 3, 4, 1, 0), np.asarray(gj[1]),
                               atol=2e-4)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gj[2]), atol=2e-4)


def test_conv5_backward_matches_autograd_of_plain():
    """The autograd Function's backward (torch.nn.grad convs + a sum) equals
    autograd through the plain version; fp32, atol 1e-5."""
    rng = np.random.default_rng(1)
    args = [torch.tensor(rng.normal(size=s).astype(np.float32), requires_grad=True)
            for s in ((3, 4, 5, 6, 5), (6, 4, 3, 3, 3), (6,))]
    g = torch.tensor(rng.normal(size=(3, 6, 3, 4, 3)).astype(np.float32))
    fn_grads = torch.autograd.grad(conv5(*args), args, g)
    plain_grads = torch.autograd.grad(conv5_plain(*args), args, g)
    for a, c in zip(fn_grads, plain_grads):
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-5)


@pytest.mark.parametrize("conv5_kernel", [True, False], ids=["conv5-op", "conv3d"])
def test_encoder_matches_jax(conv5_kernel):
    """Port encoder with conv5_kernel on (the conv5 op) or off (F.conv3d)
    vs JAX encode(pallas_conv5=...) with the same switch, interpret mode,
    reference grid, rtol 2e-4 (tests/test_ops.py:252-275)."""
    from vaegam_tpu.models.networks import encode as jax_encode
    from vaegam_tpu_torch.models.networks import encode
    from torch_port_common import FULL, make_model

    _, _, params, _, tp, _ = make_model(FULL, glm=False)
    x = np.random.default_rng(1).uniform(0, 1, size=(2, 41, 49, 35)).astype(np.float32)
    with pallas_interpret():
        want = jax_encode(params["enc"], jnp.asarray(x), 8, pallas_conv5=conv5_kernel)
    got = encode(tp["enc"], torch.tensor(x), conv5_kernel=conv5_kernel)
    for a, c in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=2e-4, atol=2e-5)


def test_conv5_kernel_input_checks():
    ok = (torch.zeros(2, 4, 5, 5, 5), torch.zeros(4, 4, 3, 3, 3), torch.zeros(4))
    with pytest.raises(TypeError, match="float32"):
        check_kernel_inputs(ok[0].double(), *ok[1:])
    with pytest.raises(ValueError, match="contiguous"):
        check_kernel_inputs(ok[0].transpose(3, 4), *ok[1:])
    with pytest.raises(ValueError, match="do not fit"):
        check_kernel_inputs(ok[0], torch.zeros(4, 2, 3, 3, 3), ok[2])
    with pytest.raises(ValueError, match="too small"):
        check_kernel_inputs(torch.zeros(2, 4, 2, 5, 5), *ok[1:])
    with pytest.raises(ValueError, match="shared memory"):
        check_kernel_inputs(torch.zeros(1, 256, 5, 10, 10), torch.zeros(16, 256, 3, 3, 3),
                            torch.zeros(16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        check_kernel_inputs(*ok)


def test_conv5_cuda_refuses_cpu_tensors_without_launching():
    before = conv5.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        conv5_cuda(torch.zeros(2, 4, 5, 5, 5), torch.zeros(4, 4, 3, 3, 3), torch.zeros(4))
    assert conv5.launches == before


def test_kernel_library_is_keyed_by_source_hash():
    lib = build.library_path("conv5")
    assert lib.parent == build.BUILD_DIR
    assert re.fullmatch(r"libconv5_[0-9a-f]{16}\.so", lib.name)
    assert build.library_path("conv5") == lib
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


# chip_smoke.py's CONV5_SHAPES, (B, Ci, D, H, W, Co)
CHIP_SHAPES = {"main": (32, 16, 8, 10, 6, 16), "odd-batch": (3, 16, 8, 10, 6, 16),
               "mni": (4, 16, 20, 25, 20, 16), "thin": (4, 4, 3, 4, 3, 4),
               "hw30": (4, 4, 5, 6, 5, 4)}


def _tf32(a):
    """fp32 -> TF32 as cvt.rna.tf32.f32 rounds: to nearest, ties away from 0."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _im2col(x):
    """x (B, Ci, D, H, W) -> (B*Do*Ho*Wo, 27*Ci), K ordered (ci, dz, dy, dx) as OIDHW."""
    bsz, ci, d, h, w = x.shape
    do, ho, wo = d - 2, h - 2, w - 2
    cols = [x[:, :, dz:dz + do, dy:dy + ho, dx:dx + wo]
            for dz in range(3) for dy in range(3) for dx in range(3)]
    return np.stack(cols, axis=2).transpose(0, 3, 4, 5, 1, 2).reshape(-1, 27 * ci)


def test_split_tf32_product_meets_fp32_tolerance():
    """The kernel's arithmetic at the main shape: hi*hi + hi*lo + lo*hi in
    fp32 is within 2e-5 of a float64 conv; one TF32 product (hi*hi) is not,
    which is why the kernel splits."""
    bsz, ci, d, h, wd, co = CHIP_SHAPES["main"]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(bsz, ci, d, h, wd)).astype(np.float32)
    bound = 1.0 / np.sqrt(27 * ci)  # torch-default init
    w = rng.uniform(-bound, bound, size=(co, ci * 27)).astype(np.float32)
    a = _im2col(x)
    want = a.astype(np.float64) @ w.T.astype(np.float64)
    ah, bh = _tf32(a), _tf32(w.T)
    al, bl = _tf32(a - ah), _tf32(w.T - bh)
    hh = ah @ bh
    split = (al @ bh + ah @ bl) + hh
    tol = 2e-5 * max(1.0, float(np.abs(want).max()))
    assert split.dtype == np.float32
    assert np.abs(split - want).max() <= tol
    assert np.abs(hh - want).max() > tol


@pytest.mark.parametrize("name", list(CHIP_SHAPES))
def test_conv5_plan_at_chip_smoke_shapes(name):
    """Shared memory fits one block, the grid fills the 132 SMs at main and
    MNI, the chunks cover the plane's rows and the slices cover K, the
    regions do not overlap, and the 16-byte staging path is taken exactly
    when H*W % 4 == 0 and x is 16-byte aligned."""
    bsz, ci, d, h, wd, co = CHIP_SHAPES[name]
    p = plan(bsz, ci, co, d, h, wd)
    plane = (h - 2) * (wd - 2)
    assert p.smem <= MAX_SMEM_BYTES
    assert p.cs % 4 == 0 and p.ds % 4 == 0 and 3 * p.ds <= p.cs
    assert p.rows * p.nchunks >= plane > (p.nchunks - 1) * p.rows
    assert p.rows <= 16 * p.mt and p.mt <= MAX_TILES and p.koff_off % 2 == 0
    assert p.nslices * SLICE_STEPS * 8 >= 27 * ci and p.ngroups * 16 >= co
    assert p.blocks == bsz * (d - 2) * p.nchunks
    offs = (0, p.red_off, p.koff_off, p.rowoff_off, p.bias_off, p.smem // 4)
    assert list(offs) == sorted(offs) and p.red_off % 4 == 0
    if name in ("main", "mni"):
        assert p.blocks >= 132
    x = torch.zeros(bsz, ci, d, h, wd)
    assert vector_staging(x) == (name != "hw30")
    assert not vector_staging(torch.zeros(bsz * ci * d * h * wd + 1)[1:].view(x.shape))


def _emulate_plan(x, w, bias, p, vec):
    """numpy walk of csrc/conv5.cu's addressing for every block: stage the
    input runs into a NaN-filled shared-memory image as the kernel does,
    read A through its rowoff/koff tables, and store the valid rows.  A
    read of anything unstaged comes out NaN."""
    bsz, ci, d, h, wd = x.shape
    co = w.shape[0]
    do, ho, wo, hw = d - 2, h - 2, wd - 2, h * wd
    kdim = 27 * ci
    y = np.full((bsz, co, do, ho * wo), np.nan)
    k = np.arange(p.nslices * SLICE_STEPS * 8)
    kc, tap = k // 27, k % 27
    koff = np.where(k < kdim, kc * p.cs + tap // 9 * p.ds + tap // 3 % 3 * wd + tap % 3,
                    ci * p.cs)
    wmat = np.zeros((k.size, p.ngroups * 16))
    wmat[:kdim, :co] = w.reshape(co, kdim).T
    for blk in range(p.blocks):
        chunk, bz = blk % p.nchunks, blk // p.nchunks
        z, b = bz % do, bz // do
        r0 = chunk * p.rows
        nrows = min(ho * wo, r0 + p.rows) - r0
        s0, s1 = r0 // wo * wd, ((r0 + nrows - 1) // wo + 3) * wd
        if vec:
            s0, s1 = s0 & ~3, min(hw, (s1 + 3) & ~3)
        assert s1 - s0 <= p.ds
        smem = np.full(p.smem // 4, np.nan)
        for c in range(ci):
            for dz in range(3):
                at = c * p.cs + dz * p.ds
                smem[at:at + s1 - s0] = x[b, c, z + dz].reshape(-1)[s0:s1]
        smem[ci * p.cs:ci * p.cs + p.ds] = 0.0
        rr = r0 + np.minimum(np.arange(p.mt * 16), nrows - 1)
        rowoff = rr // wo * wd + rr % wo - s0
        addr = rowoff[:, None] + koff[None, :]
        assert addr.max() < p.red_off
        rows = smem[addr] @ wmat
        y[b, :, z, r0:r0 + nrows] = rows[:nrows, :co].T + bias[:, None]
    return y.reshape(bsz, co, do, ho, wo)


@pytest.mark.parametrize("shape", [CHIP_SHAPES["thin"], CHIP_SHAPES["hw30"],
                                   (2, 3, 4, 30, 7, 5), (1, 5, 3, 5, 90, 20)],
                         ids=["thin", "hw30", "chunked", "wide-rows"])
def test_conv5_plan_addressing_reproduces_the_conv(shape):
    """The plan and the kernel's tables address exactly the conv's inputs,
    on both staging paths, with chunked planes, K padding (Ci not a
    multiple of 8), Co padding and a ragged last m16 tile; float64."""
    bsz, ci, d, h, wd, co = shape
    rng = np.random.default_rng(4)
    x = rng.normal(size=(bsz, ci, d, h, wd))
    w = rng.normal(size=(co, ci, 3, 3, 3))
    bias = rng.normal(size=co)
    want = conv5_plain(*(torch.tensor(t) for t in (x, w, bias))).numpy()
    p = plan(bsz, ci, co, d, h, wd)
    for vec in {False, (h * wd) % 4 == 0}:
        np.testing.assert_allclose(_emulate_plan(x, w, bias, p, vec), want, rtol=0, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CHIP_SHAPES))
def test_conv5_kernel_matches_plain_on_card(name):
    """Forward within 2e-5 scaled to the output, on both staging paths
    (hw30 takes the 4-byte one), and gradients through the autograd
    Function within 2e-4 of autograd through the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from vaegam_tpu_torch._device import configure_cuda_backends

    configure_cuda_backends()  # TF32 off: the backward's cuDNN convs in fp32
    bsz, ci, d, h, wd, co = CHIP_SHAPES[name]
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.normal(size=(bsz, ci, d, h, wd)).astype(np.float32), device="cuda")
    w = torch.tensor(rng.normal(size=(co, ci, 3, 3, 3)).astype(np.float32) * 0.1,
                     device="cuda")
    b = torch.tensor(rng.normal(size=co).astype(np.float32), device="cuda")
    got = conv5_cuda(x, w, b)
    torch.cuda.synchronize()
    want = conv5_plain(x, w, b)
    torch.testing.assert_close(got, want, atol=2e-5 * max(1.0, float(want.abs().max())), rtol=0)
    xs = [t.clone().requires_grad_(True) for t in (x, w, b)]
    xp = [t.clone().requires_grad_(True) for t in (x, w, b)]
    g = torch.tensor(rng.normal(size=tuple(want.shape)).astype(np.float32), device="cuda")
    for a, c in zip(torch.autograd.grad(conv5(*xs), xs, g),
                    torch.autograd.grad(conv5_plain(*xp), xp, g)):
        torch.testing.assert_close(a, c, atol=2e-4 * max(1.0, float(c.abs().max())), rtol=0)


# ---------------------------------------------------------------------------
# import and device rules
# ---------------------------------------------------------------------------

def _port_sources():
    return sorted((ROOT / "vaegam_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_sources_import_neither_jax_nor_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|optax|vaegam_tpu)(\.|\s|$)", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in _port_sources()
                 if pat.search(p.read_text())]
    assert offenders == []
    assert (ROOT / "chip_smoke.py").exists()


def test_port_imports_with_jax_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = sys.modules['optax'] = sys.modules['vaegam_tpu'] = None\n"
            "import vaegam_tpu_torch, vaegam_tpu_torch.ops.conv5, "
            "vaegam_tpu_torch.ops.build, vaegam_tpu_torch.data, "
            "vaegam_tpu_torch.data.dataset, vaegam_tpu_torch.data.device_cache, "
            "vaegam_tpu_torch.utils.jax_params, vaegam_tpu_torch.utils.nifti, "
            "vaegam_tpu_torch.utils.nifti_native, vaegam_tpu_torch.utils.stats, "
            "vaegam_tpu_torch.train.checkpoint, vaegam_tpu_torch.cli.train, "
            "vaegam_tpu_torch.outputs, vaegam_tpu_torch.outputs.recons, "
            "vaegam_tpu_torch.outputs.latents, vaegam_tpu_torch.outputs.gp_plots, "
            "vaegam_tpu_torch.outputs.umap_native, vaegam_tpu_torch.utils.tb\n"
            "assert 'triton' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

