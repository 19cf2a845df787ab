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
from vaegam_tpu_torch.ops.conv5 import check_kernel_inputs, conv5, conv5_cuda, conv5_plain

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
        check_kernel_inputs(torch.zeros(1, 16, 5, 60, 60), torch.zeros(16, 16, 3, 3, 3),
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


@pytest.mark.cuda
def test_conv5_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(2)
    for shape in ((32, 16, 8, 10, 6, 16), (3, 16, 8, 10, 6, 16), (4, 16, 20, 25, 20, 16),
                  (4, 4, 5, 6, 5, 4)):
        bsz, ci, d, h, wd, co = shape
        x = torch.tensor(rng.normal(size=(bsz, ci, d, h, wd)).astype(np.float32), device="cuda")
        w = torch.tensor(rng.normal(size=(co, ci, 3, 3, 3)).astype(np.float32) * 0.1,
                         device="cuda")
        b = torch.tensor(rng.normal(size=co).astype(np.float32), device="cuda")
        got = conv5_cuda(x, w, b)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, conv5_plain(x, w, b), atol=2e-5, rtol=0)


# ---------------------------------------------------------------------------
# import and device rules
# ---------------------------------------------------------------------------

def _port_sources():
    return sorted((ROOT / "vaegam_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_sources_import_neither_jax_nor_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|vaegam_tpu)(\.|\s|$)", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in _port_sources()
                 if pat.search(p.read_text())]
    assert offenders == []
    assert (ROOT / "chip_smoke.py").exists()


def test_port_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['vaegam_tpu'] = None\n"
            "import vaegam_tpu_torch, vaegam_tpu_torch.ops.conv5, "
            "vaegam_tpu_torch.ops.build, vaegam_tpu_torch.data, "
            "vaegam_tpu_torch.utils.jax_params\n"
            "assert 'triton' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

