"""The port's Adam op (``vaegam_tpu_torch/ops/adam.py``): its kernel's leaf
table on the CPU, and on the card (marked ``cuda``, skipped without one)
the kernel against its plain version, bit for bit.

On the CPU: the table covers every element of every leaf exactly once (the
ref41 and MNI models' leaves, a float64 epsilon, 1-element leaves), its
pointers are the tensors' own (again
after ``load_state`` and ``_reset_opt_state``), it refuses what the kernel
does not take, its layout is the kernel source's, and a CPU Trainer takes
the plain version and launches nothing.  The update's arithmetic against
optax is tests/test_torch_port_train.py's.  The module imports no JAX, so
the card's test run collects it.
"""

import hashlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vaegam_tpu_torch.models import VAEGAMConfig
from vaegam_tpu_torch.models.vaegam import init_model
from vaegam_tpu_torch.ops import adam as adam_mod
from vaegam_tpu_torch.ops.adam import (COUNTERS, MAX_LEAVES, STEP, TILE, WORK_BYTES, adam,
                                       adam_cuda, adam_plain, pack, workspace)
from vaegam_tpu_torch.train import Trainer
from vaegam_tpu_torch.utils import prng
from vaegam_tpu_torch.utils.tree import tree_items

THIN = dict(nf=2, num_latents=8, img_shape=(21, 25, 21))
XU_RANGES = [[-20.0, 20.0]] * 6
MNI = dict(img_shape=(91, 109, 91), num_inducing_pts=16)


def _leaf_sizes(monkeypatch, **config):
    """(numel, dtype) of a configuration's leaves, in the Trainer's order,
    without drawing the weights (zero draws, meta tensors)."""
    def zeros(key, shape, *args, dtype=np.float32, **kw):
        return np.broadcast_to(np.zeros((), dtype), shape)

    with monkeypatch.context() as m:
        m.setattr(prng, "uniform", lambda key, shape, minval=0.0, maxval=1.0,
                  dtype=np.float32: zeros(key, shape, dtype=dtype))
        m.setattr(prng, "normal", zeros)
        params, _ = init_model(VAEGAMConfig(**config), XU_RANGES, None, device="meta")
    return [(t.numel(), t.dtype) for _, t in tree_items(params)]


def _counters():
    return {k: torch.zeros((), dtype=d) for k, d in zip(COUNTERS, adam_mod._COUNTER_DTYPES)}


def _covered(step):
    """Each leaf's element ranges, as the kernel walks the table: tile t
    falls in the last leaf whose first tile is at most t."""
    out = {}
    first = step["leaf"]["first_tile"][:step["nleaves"]]
    for t in range(step["ntiles"]):
        i = int(np.searchsorted(first, t, side="right")) - 1
        leaf = step["leaf"][i]
        lo = (t - int(leaf["first_tile"])) * TILE
        out.setdefault(i, []).append((lo, min(int(leaf["n"]), lo + TILE)))
    return out


LEAF_SETS = {
    "ref41": dict(),
    "mni91": MNI,
    "ref41-x64-epsilon": dict(x64_epsilon=True),
    "ones-and-ragged": None,   # 1-element leaves and every tile edge, a full table
}


@pytest.mark.parametrize("which", list(LEAF_SETS))
def test_leaf_table_covers_every_element_once(which, monkeypatch):
    """Every element of every leaf lies in exactly one tile, every tile in
    a leaf, and each leaf's dtype and alignment flags are its own: the
    ref41 model's 63 leaves (1 to 768,000 elements), the MNI
    configuration's (to 26.6 M, past MAX_BLOCKS tiles), a float64 epsilon
    among float32 leaves, and MAX_LEAVES leaves of 1 element and of sizes
    at each side of a tile edge."""
    if LEAF_SETS[which] is None:
        sizes = [(n, torch.float32) for n in
                 [1] * 70 + [TILE - 1, TILE, TILE + 1, 2 * TILE, 3, 5, 0, 7]] + \
                [(1, torch.float64), (TILE + 2, torch.float64)]
    else:
        sizes = _leaf_sizes(monkeypatch, **LEAF_SETS[which])
    leaves = [torch.empty(n, dtype=dt) for n, dt in sizes]
    work = torch.zeros(WORK_BYTES, dtype=torch.uint8)
    aligned = pack(leaves, leaves, leaves, leaves, _counters(), work, 1e-3)
    # v as views one element in: no leaf is 16-byte aligned in all four
    shifted = [torch.empty(n + 1, dtype=dt)[1:] for n, dt in sizes]
    steps = pack(leaves, leaves, leaves, shifted, _counters(), work, 1e-3)
    assert int(steps["nleaves"]) == len(sizes) <= MAX_LEAVES
    if which == "ref41":
        assert len(sizes) == 63
        assert min(n for n, _ in sizes) == 1 and max(n for n, _ in sizes) == 768000
    covered = _covered(steps)
    for j, (n, dt) in enumerate(sizes):
        ranges = sorted(covered.get(j, []))
        assert sum(hi - lo for lo, hi in ranges) == n, j
        assert all(lo < hi for lo, hi in ranges), j
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:])), j
        if n:
            assert ranges[0][0] == 0 and ranges[-1][1] == n, j
        leaf = steps["leaf"][j]
        assert leaf["flags"] & adam_mod.DOUBLE == (dt == torch.float64), j
        if n:
            assert leaf["flags"] & adam_mod.VEC == 0, j
            vec = aligned["leaf"][j]["flags"] & adam_mod.VEC
            assert vec == adam_mod.VEC, j
    want_doubles = sum(dt == torch.float64 for _, dt in sizes)
    assert steps["any_double"] == (want_doubles > 0)
    if which == "ref41-x64-epsilon":
        assert want_doubles == 1
    assert int(steps["ntiles"]) == sum(-(-n // TILE) for n, _ in sizes)


def _trainer_pointers(t):
    """What the Trainer's table must point at: (p, m, v) per leaf, the
    counters and the workspace."""
    return ([(p.data_ptr(), m.data_ptr(), v.data_ptr())
             for p, m, v in zip(t._leaves, t._mu, t._nu)],
            [t.opt_state[k].data_ptr() for k in COUNTERS])


def _table_pointers(step):
    leaf = step["leaf"][:step["nleaves"]]
    return ([(int(a), int(b), int(c)) for a, b, c in zip(leaf["p"], leaf["m"], leaf["v"])],
            [int(step[k]) for k in COUNTERS], [int(g) for g in leaf["g"]])


def test_packed_pointers_are_the_tensors_own(tmp_path):
    """The table points at the Trainer's parameters, moments, counters and
    workspace and at the call's gradients, and follows them when
    ``load_state`` and ``_reset_opt_state`` allocate new ones."""
    rng = np.random.default_rng(5)
    glm = rng.normal(size=(int(np.prod(THIN["img_shape"])), 9)).astype(np.float32)
    t = Trainer(VAEGAMConfig(**THIN), XU_RANGES, glm, seed=3, enable_tb=False,
                device="cpu")
    t.save_state(str(tmp_path / "checkpoint_000.tar"))
    seen = set()
    for how in ("init", "load_state", "_reset_opt_state"):
        if how == "load_state":
            t.load_state(str(tmp_path / "checkpoint_000.tar"))
        elif how == "_reset_opt_state":
            t._reset_opt_state()
        grads = [torch.randn_like(p) for p in t._leaves]
        work = torch.zeros(WORK_BYTES, dtype=torch.uint8)
        step = pack(t._leaves, grads, t._mu, t._nu, t.opt_state, work, t.lr)
        pmv, counters, g = _table_pointers(step)
        assert (pmv, counters) == _trainer_pointers(t), how
        assert g == [x.data_ptr() for x in grads], how
        assert int(step["work"]) == work.data_ptr()
        assert step["neg_lr"] == -t.lr and step["skip_nonfinite"] == 1
        seen.add(tuple(pmv[0]))
    assert len(seen) == 3   # each point allocated anew


@pytest.mark.parametrize("bad", ["float16", "size", "dtype", "strided", "lengths",
                                 "too-many"])
def test_pack_refuses_what_the_kernel_does_not_take(bad):
    p = [torch.zeros(6), torch.zeros(2, 3)]
    g, m, v = ([torch.zeros_like(x) for x in p] for _ in range(3))
    if bad == "float16":
        p[0], g[0], m[0], v[0] = (torch.zeros(6, dtype=torch.float16) for _ in range(4))
    elif bad == "size":
        g[1] = torch.zeros(5)
    elif bad == "dtype":
        v[1] = torch.zeros(2, 3, dtype=torch.float64)
    elif bad == "strided":
        m[1] = torch.zeros(3, 2).t()
    elif bad == "lengths":
        g = g[:1]
    else:
        p, g, m, v = ([torch.zeros(1) for _ in range(MAX_LEAVES + 1)] for _ in range(4))
    with pytest.raises((TypeError, ValueError)):
        pack(p, g, m, v, _counters(), torch.zeros(WORK_BYTES, dtype=torch.uint8), 1e-3)


def test_kernel_refuses_cpu_tensors_without_launching():
    p = [torch.zeros(4)]
    with pytest.raises(ValueError, match="CUDA"):
        adam_cuda(p, [torch.zeros(4)], [torch.zeros(4)], [torch.zeros(4)], _counters(),
                  torch.zeros(WORK_BYTES, dtype=torch.uint8), 1e-3)


def test_layout_matches_the_kernel_source():
    """ops/adam.py's constants and record layout are csrc/adam.cu's (the
    library checks the sizes again when it loads on the card)."""
    src = (Path(adam_mod.__file__).parent / "csrc" / "adam.cu").read_text()
    for name, want in (("kTile", TILE), ("kMaxLeaves", MAX_LEAVES),
                       ("kMaxBlocks", adam_mod.MAX_BLOCKS)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == want
    leaf_bytes = 4 * 8 + 4 * 4
    assert adam_mod.LEAF.itemsize == leaf_bytes
    assert STEP.itemsize == MAX_LEAVES * leaf_bytes + 6 * 4 + 7 * 8 + 5 * 8 <= 4096
    assert STEP.fields["one_minus_b1"][1] % 8 == 0 and STEP.fields["work"][1] % 8 == 0
    assert WORK_BYTES == 4 * 4 + 4 * 4 + 3 * 8 + 2 * 8 * adam_mod.MAX_BLOCKS
    work = re.search(r"struct Work \{(.*?)\};", src, re.S).group(1)
    fields = re.findall(r"(?:unsigned int|int|float|double) ([\w, ]+);", work)
    names = [n.strip() for group in fields for n in group.split(",")]
    assert names[:11] == ["ticket", "apply", "trigger", "pad", "bc1f", "bc2f", "normf",
                          "pad_f", "bc1d", "bc2d", "normd"]
    assert (WORK_TRIGGER, WORK_NORMF, WORK_NORMD) == (2 * 4, 6 * 4, 8 * 4 + 2 * 8)


def test_cpu_trainer_takes_the_plain_version(monkeypatch):
    """A CPU Trainer's step goes through adam_plain once and launches
    nothing: no workspace, no launch counted, the kernel never called."""
    calls = []
    monkeypatch.setattr(adam_mod, "adam_plain",
                        lambda *a, **kw: calls.append(1) or adam_plain(*a, **kw))
    monkeypatch.setattr(adam_mod, "adam_cuda", pytest.fail)
    rng = np.random.default_rng(5)
    cfg = VAEGAMConfig(**THIN)
    glm = rng.normal(size=(cfg.img_dim, cfg.num_covariates + 1)).astype(np.float32)
    t = Trainer(cfg, XU_RANGES, glm, seed=3, enable_tb=False, device="cpu")
    assert t._adam_work is None
    launches, captured = adam.launches, adam.captured
    x = torch.tensor(rng.uniform(0, 1, size=(2,) + cfg.img_shape).astype(np.float32))
    covs = torch.tensor(rng.normal(size=(2, cfg.num_covariates)).astype(np.float32))
    for _ in range(2):
        t.train_step(covs, x)
    assert calls == [1, 1] and int(t.opt_state["count"]) == 2
    assert (adam.launches, adam.captured) == (launches, captured)


# ------------------------------------------------------------------ the card

STEPS = 6
NAN_STEP = 3          # this step's gradient holds a NaN: skipped and counted
SCALES = (1.0, 0.01, 1.0, 1.0, 3.0, 0.5)   # the clip triggers at 0.01 only


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vaegam_tpu_torch._device import configure_cuda_backends

    configure_cuda_backends()


def _state(params, mu, nu, counters):
    return [*params, *mu, *nu, *(counters[k] for k in COUNTERS)]


def _sha(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _card_sides(x64_epsilon):
    """Two copies of the ref41 model's leaves on the card (the kernel's
    side and the plain version's), zero moments and fresh counters each."""
    config = VAEGAMConfig(x64_epsilon=x64_epsilon)
    params, _ = init_model(config, XU_RANGES, None, key=prng.split(prng.prng_key(7))[1],
                           device="cuda")
    leaves = [t.detach() for _, t in tree_items(params)]
    sides = []
    for _ in range(2):
        p = [t.clone() for t in leaves]
        counters = {k: torch.zeros((), dtype=d, device="cuda")
                    for k, d in zip(COUNTERS, adam_mod._COUNTER_DTYPES)}
        counters["last_finite"].fill_(True)
        sides.append((p, [torch.zeros_like(t) for t in p], [torch.zeros_like(t) for t in p],
                      counters))
    return sides


def _grads(params, step, rng):
    out = []
    for i, p in enumerate(params):
        g = rng.normal(size=tuple(p.shape)) * SCALES[step] * (1 + i % 5)
        if step == NAN_STEP and i == 7:
            g.flat[3] = np.nan
        out.append(torch.tensor(g, dtype=p.dtype, device="cuda"))
    return out


# csrc/adam.cu's Work: the byte offsets of trigger, normf and normd
WORK_TRIGGER, WORK_NORMF, WORK_NORMD = 8, 24, 48
F32_ULP = 2.0 ** -23


def _assert_norm_agrees(work, grads, clip, what):
    """The clip's norm the kernel left in its workspace against torch's
    (adam_plain's expression) within 4 float32 ulps, the float64 one against
    the exact norm of the same gradients within 1e-10, and the trigger
    against torch's: a fault in the clip's scaling cannot hide inside the
    state's per-tensor bound."""
    g_norm = float(torch.sqrt(sum(torch.sum(g * g) for g in grads)))
    exact = float(torch.sqrt(sum(torch.sum(g.double() * g.double()) for g in grads)))
    normf = float(work[WORK_NORMF:WORK_NORMF + 4].view(torch.float32))
    normd = float(work[WORK_NORMD:WORK_NORMD + 8].view(torch.float64))
    trigger = int(work[WORK_TRIGGER:WORK_TRIGGER + 4].view(torch.int32))
    if np.isnan(exact):
        assert np.isnan([g_norm, normf, normd]).all(), what
        return
    norm = normd if any(g.dtype == torch.float64 for g in grads) else normf
    assert abs(norm - g_norm) <= 4 * F32_ULP * g_norm, (what, norm, g_norm)
    assert abs(normd - exact) <= 1e-10 * exact, (what, normd, exact)
    assert trigger == (g_norm < clip), (what, trigger, g_norm)


def _assert_sides_agree(kernel, plain, clip, what):
    """Bit for bit; with the clip, within 1e-6 of each tensor's largest
    entry.  The two norms part in their last bits (the plain version sums
    float32 leaves in float32 before a float64 one, the kernel in double),
    and an entry whose terms cancel (p + update, or (1 - b1) g + b1 m) keeps
    that gap at its terms' scale, so a gap relative to the entry itself can
    be any size."""
    got, want = _state(*kernel), _state(*plain)
    if clip:
        for i, (a, b) in enumerate(zip(got, want)):
            atol = 1e-6 * float(b.abs().max()) if b.is_floating_point() else 0
            torch.testing.assert_close(a, b, rtol=1e-6, atol=atol,
                                       msg=lambda m: f"{what}, tensor {i}: {m}")
    else:
        assert _sha(got) == _sha(want), what
    assert [int(kernel[3][k]) for k in COUNTERS] == [int(plain[3][k]) for k in COUNTERS]


@pytest.mark.cuda
@pytest.mark.parametrize("x64_epsilon", [False, True], ids=["fp32", "x64-epsilon"])
@pytest.mark.parametrize("clip", [0.0, 100.0], ids=["adam", "clip"])
def test_kernel_matches_plain_on_the_card(x64_epsilon, clip):
    """Six steps on the ref41 leaves, the fourth with a NaN gradient: the
    kernel's parameters, moments and counters equal the plain version's on
    the card bit for bit (SHA-256) with the clip off, within 1e-6 of each
    tensor's largest entry with it on (the norm's sum in another order;
    ``_assert_sides_agree``), the norm itself within 4 float32 ulps of
    torch's (``_assert_norm_agrees``); two launches a step."""
    _card()
    kernel, plain = _card_sides(x64_epsilon)
    work = workspace("cuda")
    rng = np.random.default_rng(11)
    launches = adam.launches
    for step in range(STEPS):
        grads = _grads(kernel[0], step, rng)
        adam(kernel[0], grads, kernel[1], kernel[2], kernel[3], work, 1e-3, clip)
        adam_plain(plain[0], grads, plain[1], plain[2], plain[3], 1e-3, clip)
        torch.cuda.synchronize()
        _assert_sides_agree(kernel, plain, clip, f"step {step}")
        if clip:
            _assert_norm_agrees(work, grads, clip, f"step {step}")
    assert adam.launches - launches == 2 * STEPS
    assert int(kernel[3]["count"]) == STEPS - 1 and int(kernel[3]["total_notfinite"]) == 1


@pytest.mark.cuda
def test_kernel_under_graph_replay_matches_plain_on_the_card():
    """The update captured into a CUDA graph (after one eager call) and
    replayed three times on new gradients, one with a NaN: after each
    replay the state equals the plain version's bit for bit; the capture
    counts two launches in ``adam.captured`` and none in ``adam.launches``."""
    _card()
    kernel, plain = _card_sides(False)
    work = workspace("cuda")
    rng = np.random.default_rng(13)
    static = [torch.zeros_like(p) for p in kernel[0]]
    steps = [_grads(kernel[0], s, rng) for s in (0, 1, NAN_STEP, 4)]
    for s, grads in enumerate(steps):
        if s == 1:   # capture once the eager step has run
            launches, captured = adam.launches, adam.captured
            graph = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), torch.cuda.graph(graph):
                adam(kernel[0], static, kernel[1], kernel[2], kernel[3], work, 1e-3)
            torch.cuda.current_stream().wait_stream(side)
            assert (adam.launches, adam.captured) == (launches, captured + 2)
        for buf, g in zip(static, grads):
            buf.copy_(g)
        if s == 0:
            adam(kernel[0], static, kernel[1], kernel[2], kernel[3], work, 1e-3)
        else:
            graph.replay()
        adam_plain(plain[0], grads, plain[1], plain[2], plain[3], 1e-3)
        torch.cuda.synchronize()
        _assert_sides_agree(kernel, plain, 0.0, f"step {s}")
    assert int(kernel[3]["count"]) == 3 and int(kernel[3]["total_notfinite"]) == 1


@pytest.mark.cuda
def test_card_trainer_takes_the_kernel(monkeypatch):
    """A Trainer on the card updates through the kernel: two launches a
    step, the plain version never called."""
    _card()
    monkeypatch.setattr(adam_mod, "adam_plain", pytest.fail)
    rng = np.random.default_rng(5)
    cfg = VAEGAMConfig(**THIN)
    glm = rng.normal(size=(cfg.img_dim, cfg.num_covariates + 1)).astype(np.float32)
    t = Trainer(cfg, XU_RANGES, glm, seed=3, enable_tb=False, device="cuda")
    x = torch.tensor(rng.uniform(0, 1, size=(2,) + cfg.img_shape).astype(np.float32),
                     device="cuda")
    covs = torch.tensor(rng.normal(size=(2, cfg.num_covariates)).astype(np.float32),
                        device="cuda")
    launches = adam.launches
    for _ in range(3):
        t.train_step(covs, x)
    torch.cuda.synchronize()
    assert adam.launches - launches == 6 and int(t.opt_state["count"]) == 3
