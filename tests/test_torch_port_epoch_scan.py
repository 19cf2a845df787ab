"""The port's ``epoch_scan`` against the JAX Trainer's, and its own rules.

The JAX Trainer's ``epoch_scan`` runs each maximal run of same-width,
non-figure gather-fused steps as one ``lax.scan`` dispatch
(vaegam_tpu/train/loop.py:217-258,425-502).  The port's counterpart replays
a CUDA graph of each width's step on the card; on the CPU the "replay" is
the eager step itself.  These tests hold, on the CPU: the trajectory to the
JAX Trainer's under ``epoch_scan=True`` (float64, JAX's scan key chain fed
step by step), the schedule (every step once and in order, figure steps
eager), on and off bit for bit, a resume bit for bit, the storage the
captured step relies on, the points that drop captured graphs, and the two
entry points' flag.  The capture itself runs only on the card (``cuda``);
the module imports the JAX package only inside the test that needs it, so
the card's test run (which has no JAX) collects it.
"""

import json

import numpy as np
import pytest
import torch

from vaegam_tpu_torch.data import DeviceResidentLoader
from vaegam_tpu_torch.models import VAEGAMConfig
from vaegam_tpu_torch.train import Trainer
from vaegam_tpu_torch.utils.jax_params import params_from_jax, params_to_jax
from vaegam_tpu_torch.utils.tree import tree_items

# tests/torch_port_common.py's THIN and XU_RANGES (that module imports JAX)
THIN = dict(nf=2, num_latents=8, img_shape=(21, 25, 21))
XU_RANGES = [[-20.0, 20.0]] * 6
N_VOLS, BATCH = 10, 4          # steps of 4, 4 and a tail of 2


def _data(n=N_VOLS, seed=5):
    rng = np.random.default_rng(seed)
    cfg = VAEGAMConfig(**THIN)
    vols = rng.uniform(0, 1, size=(n,) + cfg.img_shape).astype(np.float32)
    covs = rng.normal(size=(n, cfg.num_covariates)).astype(np.float32)
    covs[:, 0] = rng.uniform(size=n) > 0.5
    glm = rng.normal(size=(cfg.img_dim, cfg.num_covariates + 1)).astype(np.float32)
    return vols, covs, glm


def _trainer(epoch_scan, seed=3, **kw):
    vols, covs, glm = _data()
    t = Trainer(VAEGAMConfig(**THIN), XU_RANGES, glm, seed=seed, enable_tb=False,
                device="cpu", epoch_scan=epoch_scan, **kw)
    loader = DeviceResidentLoader.from_arrays(vols, covs, batch_size=BATCH, shuffle=True,
                                              seed=1, device="cpu")
    return t, loader


def _state(t):
    """Every tensor the Trainer carries from step to step, by name."""
    out = {f"params/{p}": v for p, v in tree_items(t.params)}
    out.update({f"mu/{p}": v for p, v in tree_items(t.opt_state["mu"])})
    out.update({f"nu/{p}": v for p, v in tree_items(t.opt_state["nu"])})
    out.update({k: t.opt_state[k] for k in ("count", "notfinite_count", "last_finite",
                                            "total_notfinite")})
    return out


def _assert_same_state(a, b):
    sa, sb = _state(a), _state(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k].detach(), sb[k].detach()), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_epoch_scan_tracks_jax_scan_in_float64(monkeypatch):
    """JAX's Trainer(epoch_scan=True) and the port's, from the same weights,
    2 epochs of 10 volumes at batch 4 through their own device loaders
    (JAX: a 2-step scan and the tail step; the port: three steps through
    its replay entry), JAX's scan key chain (split inside the scan body,
    loop.py:236-238) fed to the port step by step.  Both in float64, as
    tests/torch_port_common.py lifts JAX (the gather's float32 cast too),
    on well-separated inducing grids: every step's loss within rtol 1e-9,
    every parameter within 1e-6 of its leaf's largest entry."""
    import jax

    import vaegam_tpu.train.loop as jax_loop
    from vaegam_tpu.data.device_cache import DeviceResidentLoader as JaxLoader
    from vaegam_tpu.models import VAEGAMConfig as JaxConfig
    from vaegam_tpu.train import Trainer as JaxTrainer

    import torch_port_common as common
    from torch_port_common import (_JnpFloat32AsFloat64, f64_jax, f64_port, jax_float64,
                                   jax_noise, to_np)

    assert (common.THIN, common.XU_RANGES) == (THIN, XU_RANGES)
    vols, covs, glm = _data()
    jcfg, pcfg = JaxConfig(**THIN), VAEGAMConfig(**THIN)
    monkeypatch.setattr(jax_loop, "jnp", _JnpFloat32AsFloat64())   # the gather's cast
    with jax_float64():
        jt = JaxTrainer(jcfg, XU_RANGES, glm_maps=glm, seed=3, enable_tb=False,
                        epoch_scan=True)
        jt.params, jt.consts = f64_jax(to_np(jt.params)), f64_jax(to_np(jt.consts))
        jt.opt_state = jt._tx_init(jt.params)
        scan, step = jt._build_gather_train_scan(), jt._build_gather_train_step()
        params, consts = params_from_jax(to_np(jt.params), to_np(jt.consts), pcfg, "cpu")
        pt = Trainer(pcfg, seed=3, enable_tb=False, device="cpu", epoch_scan=True,
                     params=f64_port(params), consts=f64_port(consts))
        jl = JaxLoader.from_arrays(vols, covs, batch_size=BATCH, shuffle=True, seed=1)
        jl._covs = jax.numpy.asarray(covs, jax.numpy.float64)
        pl = DeviceResidentLoader.from_arrays(vols, covs, batch_size=BATCH, shuffle=True,
                                              seed=1, device="cpu")
        calls, jax_losses, noises, port_losses = [], [], [], []

        def spy_scan(p, o, k, v, c, idx_mat):
            calls.append(("scan", idx_mat.shape))
            out = scan(p, o, k, v, c, idx_mat)
            jax_losses.extend(np.asarray(out[3]).tolist())
            return out

        def spy_step(p, o, k, v, c, sel):
            calls.append(("step", len(sel)))
            out = step(p, o, k, v, c, sel)
            jax_losses.append(float(out[3]))
            return out

        gather_index, train_step = pl.gather_index, pt.train_step

        def port_step(c, x, noise=None):
            loss, aux = train_step(c, x, noise=noises[len(port_losses)])
            port_losses.append(float(loss))
            return loss, aux

        jt._gather_train_scan, jt._gather_train_step = spy_scan, spy_step
        pl.gather_index = lambda idx: tuple(t.double() for t in gather_index(idx))
        pt.train_step = port_step
        for epoch in range(2):
            # the epoch's key (Trainer._next_key), split once a step
            _, key = jax.random.split(jt._key)
            jl.set_epoch(epoch)
            for sel in jl.iter_index_batches():
                key, sub = jax.random.split(key)
                noises.append(tuple(torch.from_numpy(np.array(d))
                                    for d in jax_noise(sub, len(sel), jcfg.num_latents)))
            want = jt.train_epoch(jl)
            got = pt.train_epoch(pl)
            np.testing.assert_allclose(got, want, rtol=1e-9)
        assert calls == [("scan", (2, BATCH)), ("step", 2)] * 2
        np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-9)
        mine, _ = params_to_jax(pt.params, None, pcfg)
        for path, want_leaf in jax.tree_util.tree_leaves_with_path(to_np(jt.params)):
            got_leaf = mine
            for k in path:
                got_leaf = got_leaf[k.key]
            np.testing.assert_allclose(
                np.asarray(got_leaf, np.float64), want_leaf, rtol=0,
                atol=1e-6 * max(1.0, float(np.abs(want_leaf).max())),
                err_msg=jax.tree_util.keystr(path))
    assert len(port_losses) == 6
    assert int(jt.opt_state.total_notfinite) == int(pt.opt_state["total_notfinite"]) == 0


def test_epoch_scan_dispatch_structure():
    """tests/test_train.py::test_epoch_scan_dispatch_structure for the port:
    10 samples at batch 4 give steps of 4, 4 and 2, each run exactly once
    and in order, every one through the replay entry; with figures every
    2nd batch, batches 0 and 2 run eagerly with their figures and batch 1
    is replayed.  On the CPU nothing is captured or replayed."""
    t, loader = _trainer(True)
    calls = []
    replay, step = t._replay_step, t.train_step

    def spy_replay(ld, idx):
        calls.append(("replay", len(idx)))
        return replay(ld, idx)

    def spy_step(c, x, noise=None):
        calls.append(("step", len(x)))
        return step(c, x, noise=noise)

    t._replay_step, t.train_step = spy_replay, spy_step
    loss = t.train_epoch(loader)
    assert calls == [("replay", 4), ("step", 4), ("replay", 4), ("step", 4),
                     ("replay", 2), ("step", 2)]
    assert np.isfinite(loss) and t.epoch == 1 and int(t.opt_state["count"]) == 3

    calls.clear()
    t.log_figs_every, t._figs_enabled = 2, True
    t._log_batch_figures = lambda c, x, kind: calls.append(("figures", len(x)))
    t.train_epoch(loader)
    assert calls == [("step", 4), ("figures", 4), ("replay", 4), ("step", 4),
                     ("step", 2), ("figures", 2)]
    assert t.epoch == 2 and int(t.opt_state["count"]) == 6
    assert t._graphs == {} and t.replays == {} and t.captures == {}


def test_epoch_scan_on_and_off_agree_bit_for_bit_on_the_cpu():
    """Two Trainers from one seed, one with epoch_scan, 3 epochs with
    figure forwards every 2nd batch (they draw from the generator too):
    every epoch loss, every parameter, moment and counter and the
    generator's state equal."""
    runs = []
    for scan in (False, True):
        t, loader = _trainer(scan)
        t.log_figs_every, t._figs_enabled = 2, True
        runs.append((t, [t.train_epoch(loader) for _ in range(3)]))
    (off, off_losses), (on, on_losses) = runs
    assert off_losses == on_losses and np.isfinite(off_losses).all()
    _assert_same_state(off, on)


def test_epoch_scan_resume_is_bitwise(tmp_path):
    """3 epochs straight against 2 epochs, a checkpoint, a new Trainer that
    loads it and a third epoch, all under epoch_scan: the same third-epoch
    loss, state and generator, bit for bit."""
    straight, loader = _trainer(True)
    losses = [straight.train_epoch(loader) for _ in range(3)]
    first, loader = _trainer(True)
    first.train_epoch(loader)
    first.train_epoch(loader)
    first.save_state(str(tmp_path / "checkpoint_002.tar"))
    resumed, loader = _trainer(True, seed=11)
    resumed.load_state(str(tmp_path / "checkpoint_002.tar"))
    assert resumed.epoch == 2
    assert resumed.train_epoch(loader) == losses[2]
    _assert_same_state(straight, resumed)


@pytest.mark.parametrize("epoch_scan", [False, True], ids=["eager", "epoch_scan"])
def test_optimizer_state_keeps_its_storage(epoch_scan):
    """A captured step reads and writes the parameters, both Adam moments
    and the four counters at the addresses it was captured with: one step
    and one epoch leave every one of them in its storage, and the step
    count advances once a step."""
    t, loader = _trainer(epoch_scan)
    ptrs = {k: v.data_ptr() for k, v in _state(t).items()}
    c, x = loader.gather(np.arange(BATCH))
    t.train_step(c, x)
    assert int(t.opt_state["count"]) == 1
    t.train_epoch(loader)
    assert int(t.opt_state["count"]) == 4 and int(t.opt_state["total_notfinite"]) == 0
    assert bool(t.opt_state["last_finite"])
    assert {k: v.data_ptr() for k, v in _state(t).items()} == ptrs


@pytest.mark.parametrize("how", ["load_state", "set_conv_dtype", "_set_params",
                                 "_reset_opt_state"])
def test_captured_graphs_are_dropped(how, tmp_path):
    """Reallocating the parameters or the optimizer state, switching the
    conv precision or loading a checkpoint (which may change the config,
    lr and consts as well) drops every captured step, as the JAX Trainer
    rebuilds its scan at the same points (loop.py:313,711)."""
    t, _ = _trainer(True)
    t.save_state(str(tmp_path / "checkpoint_000.tar"))
    t._graphs, t._graph_pool = {BATCH: object(), 2: object()}, object()
    {"load_state": lambda: t.load_state(str(tmp_path / "checkpoint_000.tar")),
     "set_conv_dtype": lambda: t.set_conv_dtype(torch.bfloat16),
     "_set_params": lambda: t._set_params(t.params),
     "_reset_opt_state": lambda: t._reset_opt_state()}[how]()
    assert t._graphs == {} and t._graph_pool is None


def test_train_cli_epoch_scan_on_the_cpu(tmp_path, monkeypatch):
    """The train CLI takes --epoch_scan with --device cpu, hands it to the
    Trainer, and gives the run without it bit for bit: every loss and
    parameter (TensorBoard off: no writer)."""
    from e2e_helpers import SMALL_SHAPE, make_design_csv, make_subject_tree
    from vaegam_tpu_torch.cli.train import main
    from vaegam_tpu_torch.utils import tb

    def no_writer(log_dir):
        raise ImportError("not in this test")

    monkeypatch.setattr(tb, "make_writer", no_writer)

    root = str(tmp_path / "subjects")
    make_subject_tree(root, n_subjs=1, n_vols=10, img_shape=SMALL_SHAPE)
    csv = make_design_csv(root, str(tmp_path / "design.csv"))
    runs = []
    for extra in ([], ["--epoch_scan"]):
        t, loaders = main(["--train_csv", csv, "--test_csv", csv, "--save_dir",
                           str(tmp_path / f"run{len(runs)}"), "--batch-size", "4",
                           "--nf", "2", "--num_latents", "8", "--img_shape",
                           *map(str, SMALL_SHAPE), "--device", "cpu", "--no_outputs",
                           "--epochs", "2", "--test_freq", "1", "--save_freq", "5", "--log_figs_every", "0",
                           *extra])
        assert isinstance(loaders["Shuffled_train"], DeviceResidentLoader)
        runs.append(t)
    off, on = runs
    assert not off.epoch_scan and on.epoch_scan
    assert on.loss == off.loss and np.isfinite(on.loss["train"][1])
    _assert_same_state(off, on)


def test_oracle_tool_epoch_scan_on_the_cpu(tmp_path):
    """The oracle tool takes --epoch_scan with --device cpu (12 volumes at
    batch 8, one epoch, no gate), keeps it in its JSON line as the JAX tool
    does, and reads out the same maps as the run without it."""
    import contextlib
    import io

    from vaegam_tpu_torch.tools import control_experiment as ce

    results = []
    for extra in ([], ["--epoch_scan"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = ce.main(["--work_dir", str(tmp_path / f"w{len(results)}"), "--device",
                          "cpu", "--img_shape", "21", "25", "21", "--n_vols", "12",
                          "--batch_size", "8", "--epochs", "1", "--no_gate"] + extra)
        assert rc == 0
        results.append(json.loads(buf.getvalue().strip().splitlines()[-1]))
    off, on = results
    assert off["epoch_scan"] is False and on["epoch_scan"] is True
    for key in ("task_map_mean_inside", "abs_inside", "abs_outside", "contrast_ratio",
                "nonfinite_skips", "mvn_fallbacks"):
        assert on[key] == off[key], key


@pytest.mark.cuda
def test_epoch_scan_replays_match_eager_on_the_card(monkeypatch):
    """On the card, under deterministic algorithms: an eager Trainer and an
    epoch_scan one from one seed, 2 epochs at batch 4 on 10 volumes: one
    capture at widths 4 and 2 after their first (eager) steps, every later
    non-first step a replay, every loss and the whole state bit for bit,
    and conv5 counted once a captured graph, never as a launch there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vaegam_tpu_torch.ops import conv5 as conv5_mod

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")   # cuBLAS's deterministic mode
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        vols, covs, glm = _data()
        runs = []
        for scan in (False, True):
            t = Trainer(VAEGAMConfig(**THIN), XU_RANGES, glm, seed=3, enable_tb=False,
                        device="cuda", epoch_scan=scan)
            loader = DeviceResidentLoader.from_arrays(vols, covs, batch_size=BATCH,
                                                      shuffle=True, seed=1, device="cuda")
            conv5_mod.conv5.launches = conv5_mod.conv5.captured = 0
            losses = [t.train_epoch(loader) for _ in range(2)]
            torch.cuda.synchronize()
            runs.append((t, losses, conv5_mod.conv5.launches, conv5_mod.conv5.captured))
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    (off, off_losses, off_launches, _), (on, on_losses, on_launches, captured) = runs
    assert on.captures == {BATCH: 1, 2: 1} and on.replays == {BATCH: 3, 2: 1}
    assert off_launches == 6 and on_launches == 2 and captured == 2
    assert on_losses == off_losses
    _assert_same_state(off, on)

