"""The port's training substrate (``repro_torch.train``: optimizer,
checkpoint, loop; ``repro_torch.launch.train``) against the reference's,
on the CPU.

The first six tests are ``tests/test_train.py``'s that need no mesh, on
``tiny_setup``'s config.  Then: the pure step; ``optimizer.update``
against the reference's (each leaf within 4e-7 of its largest value,
about 3 ulp: XLA on the CPU contracts some of AdamW's products into FMAs
and has its own ``cos``, ``pow`` and reduction order, so the two are not
bit-equal, and a param near zero is the difference of larger terms; the
schedules' learning rates within 1e-6); a whole train step against the
reference's jitted one (f32, rel-to-max 1e-4 a leaf); checkpoints
crossing between the packages to the bit, both ways; the tree order and
treedef string of JAX; the launcher in process on ``--device cpu``, one
arch of each family.
"""
import os
import shutil
import tempfile
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import transformer as rtfm  # noqa: E402
from repro.train import checkpoint as rckpt  # noqa: E402
from repro.train import data as rdata  # noqa: E402
from repro.train import optimizer as ropt  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.train import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.train import data as data_lib  # noqa: E402
from repro_torch.train import loop as loop_lib  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.core import tree  # noqa: E402

CFG = dict(name="t", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
           head_dim=16, d_ff=64, vocab=128, chunk_q=8, loss_chunk=8)


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def tiny_setup():
    cfg = ttfm.TransformerConfig(**CFG)
    params = ttfm.init_params(0, cfg, device="cpu")
    ocfg = opt_lib.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=40)
    step = opt_lib.make_train_step(lambda p, b: ttfm.loss_fn(p, cfg, b),
                                   ocfg)
    mk = lambda s: _t(data_lib.lm_batch(0, s, 4, 16, 128))  # noqa: E731
    return params, opt_lib.init(params), step, mk


def test_loss_descends():
    params, state, step, mk = tiny_setup()
    first = last = None
    for i in range(12):
        params, state, m = step(params, state, mk(0))
        if first is None:
            first = float(m["loss"])
        last = float(m["loss"])
    assert last < first


def test_grad_clipping_reported():
    params, state, step, mk = tiny_setup()
    _, _, m = step(params, state, mk(0))
    assert float(m["grad_norm"]) > 0
    assert float(m["lr"]) > 0


def test_checkpoint_atomic_and_restartable():
    params, state, step, mk = tiny_setup()
    with tempfile.TemporaryDirectory() as d:
        cfg = loop_lib.LoopConfig(total_steps=10, ckpt_dir=d, ckpt_every=4,
                                  log_every=0)
        res = loop_lib.fit(step, params, state, mk, cfg)
        # steps list only contains COMMITTED checkpoints
        steps = ckpt_lib.list_steps(d)
        assert steps[-1] == 10
        # simulate a crash after step 8: drop the final checkpoint, then
        # restart: the loop resumes from 8 and REPLAYS steps 9-10 with
        # identical batches, landing on the identical loss
        shutil.rmtree(ckpt_lib._step_dir(d, 10))
        res2 = loop_lib.fit(step, params, state, mk, cfg)
        np.testing.assert_allclose(float(res.metrics["loss"]),
                                   float(res2.metrics["loss"]), rtol=1e-6)
        assert float(res.metrics["loss"]) == float(res2.metrics["loss"])
        # corrupt an in-progress write -> ignored
        os.makedirs(os.path.join(d, ".tmp_garbage"), exist_ok=True)
        ckpt_lib.save(d, 11, (res.params, res.opt_state))
        assert not os.path.exists(os.path.join(d, ".tmp_garbage"))


def test_loop_retries_transient_failures():
    params, state, step, mk = tiny_setup()
    calls = {"n": 0}

    def flaky(p, s, b):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated preemption")
        return step(p, s, b)

    cfg = loop_lib.LoopConfig(total_steps=3, log_every=0, max_retries=2)
    res = loop_lib.fit(flaky, params, state, mk, cfg)
    assert res.retries == 1
    assert res.step == 3


def test_loop_raises_after_max_retries():
    params, state, step, mk = tiny_setup()

    def dead(p, s, b):
        raise RuntimeError("hard failure")

    cfg = loop_lib.LoopConfig(total_steps=1, log_every=0, max_retries=1)
    with pytest.raises(RuntimeError):
        loop_lib.fit(dead, params, state, mk, cfg)


def test_straggler_detection():
    params, state, step, mk = tiny_setup()

    def slow(p, s, b):
        time.sleep(0.05)
        return step(p, s, b)

    cfg = loop_lib.LoopConfig(total_steps=2, log_every=0,
                              step_deadline_s=0.01)
    res = loop_lib.fit(slow, params, state, mk, cfg)
    assert res.stragglers == 2


def test_step_is_pure_and_repeats():
    """The step leaves its inputs' bits untouched (so a retry sees the
    same inputs) and gives the same bits twice; micro-batches accumulate
    to the full batch's gradient."""
    params, state, step, mk = tiny_setup()
    before = [x.clone() for x in tree.leaves((params, state))]
    a = step(params, state, mk(0))
    b = step(params, state, mk(0))
    for x, y in zip(before, tree.leaves((params, state))):
        assert torch.equal(x, y)
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        assert torch.equal(x, y)
    cfg = ttfm.TransformerConfig(**CFG, dtype=torch.float32)
    loss = lambda p, bt: ttfm.loss_fn(p, cfg, bt)             # noqa: E731
    l1, g1 = opt_lib.value_and_grad(loss, params, mk(0))
    ocfg = opt_lib.AdamWConfig(clip_norm=0.0)
    _, _, m2 = opt_lib.make_train_step(loss, ocfg, microbatches=2)(
        params, state, mk(0))
    np.testing.assert_allclose(float(m2["loss"]), float(l1), rtol=1e-6)


def _tree_of(rng, shapes):
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("schedule,clip", [("cosine", 1.0), ("linear", 0.5),
                                           ("constant", 0.0)])
def test_update_matches_reference(schedule, clip):
    """Five AdamW steps on a random tree, each from the reference's
    previous state, against the reference's jitted ``update``."""
    rng = np.random.default_rng(0)
    shapes = {"w": (33, 17), "b": (17,), "z": (4, 2, 3)}
    p = _tree_of(rng, shapes)
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=8, schedule=schedule,
                clip_norm=clip)
    rupd = jax.jit(lambda g, s, p: ropt.update(ropt.AdamWConfig(**ocfg),
                                              g, s, p))
    rstate = ropt.init(p)
    for i in range(5):
        g = _tree_of(rng, shapes)
        tp = ttfm.params_from_numpy(p, "cpu")
        tstate = opt_lib.AdamWState(
            step=torch.tensor(int(rstate.step), dtype=torch.int32),
            m=ttfm.params_from_numpy(jax.tree.map(np.asarray, rstate.m),
                                     "cpu"),
            v=ttfm.params_from_numpy(jax.tree.map(np.asarray, rstate.v),
                                     "cpu"))
        np_, ns, nm = opt_lib.update(opt_lib.AdamWConfig(**ocfg),
                                     ttfm.params_from_numpy(g, "cpu"),
                                     tstate, tp)
        rp, rstate, rm = rupd(g, rstate, p)
        assert int(ns.step) == int(rstate.step)
        np.testing.assert_allclose(float(nm["lr"]), float(rm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(nm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=4e-7)
        for got, want in zip(tree.leaves((np_, ns.m, ns.v)),
                             jax.tree.leaves((rp, rstate.m, rstate.v))):
            want = np.asarray(want)
            assert np.abs(got.numpy() - want).max() <= \
                4e-7 * np.abs(want).max()
        p = jax.tree.map(np.asarray, rp)


def test_train_step_matches_reference():
    """Two train steps of ``tiny_setup``'s model in f32 against the
    reference's jitted step from the same params: loss, grad norm and
    every param leaf."""
    rcfg = rtfm.TransformerConfig(**CFG, dtype=jnp.float32)
    tcfg = ttfm.TransformerConfig(**CFG, dtype=torch.float32)
    rp = rtfm.init_params(jax.random.PRNGKey(0), rcfg)
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=40)
    rstep = jax.jit(ropt.make_train_step(
        lambda p, b: rtfm.loss_fn(p, rcfg, b), ropt.AdamWConfig(**ocfg)))
    tstep = opt_lib.make_train_step(lambda p, b: ttfm.loss_fn(p, tcfg, b),
                                    opt_lib.AdamWConfig(**ocfg))
    rs, tp = ropt.init(rp), ttfm.params_from_numpy(rp, "cpu")
    ts = opt_lib.init(tp)
    for i in range(2):
        batch = rdata.lm_batch(0, i, 4, 16, 128)
        rp, rs, rm = rstep(rp, rs, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tp, ts, tm = tstep(tp, ts, _t(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-4)
    for got, want in zip(tree.leaves(tp), jax.tree.leaves(rp)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= \
            1e-4 * np.abs(want).max()


def _state_tree(rng):
    p = {"layers": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                    "g": rng.standard_normal((4,)).astype(np.float32)},
         "cin": [rng.standard_normal((2, 2)).astype(np.float32)],
         "bias": np.float32(rng.standard_normal())}
    s = ropt.init(p)
    s = ropt.AdamWState(step=jnp.asarray(7, jnp.int32),
                        m=jax.tree.map(lambda x: x + 1.5, s.m),
                        v=jax.tree.map(lambda x: x + 0.25, s.v))
    return p, s


def test_tree_order_and_treedef_are_jaxs():
    """``core.tree`` flattens in ``jax.tree.flatten``'s order and prints
    its treedef as JAX does; unflatten inverts flatten."""
    p, s = _state_tree(np.random.default_rng(0))
    rleaves, rdef = jax.tree.flatten((p, s))
    tp = ttfm.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    ts = opt_lib.AdamWState(
        step=torch.tensor(7, dtype=torch.int32),
        m=ttfm.params_from_numpy(jax.tree.map(np.asarray, s.m), "cpu"),
        v=ttfm.params_from_numpy(jax.tree.map(np.asarray, s.v), "cpu"))
    leaves, td = tree.flatten((tp, ts, None, (1,)))
    assert str(td) == str(jax.tree.flatten((p, s, None, (1,)))[1])
    for got, want in zip(leaves, rleaves):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    back = tree.unflatten(td, leaves)
    assert isinstance(back[1], opt_lib.AdamWState)
    assert tree.leaves(back) == leaves


def test_checkpoints_cross_between_packages():
    """A reference checkpoint of (params, AdamWState) restores in the port
    to the bit, and the port's in the reference; the files are the same
    layout (leaf names, shapes, dtypes, treedef string, marker)."""
    p, s = _state_tree(np.random.default_rng(1))
    like = (ttfm.params_from_numpy(jax.tree.map(np.asarray, p), "cpu"),
            opt_lib.init(ttfm.params_from_numpy(
                jax.tree.map(np.asarray, p), "cpu")))
    with tempfile.TemporaryDirectory() as d:
        rckpt.save(os.path.join(d, "ref"), 3, (p, s), metadata={"x": 1})
        got, step = ckpt_lib.restore(os.path.join(d, "ref"), like)
        assert step == 3 and ckpt_lib.read_metadata(
            os.path.join(d, "ref"), 3) == {"x": 1}
        for g, w in zip(tree.leaves(got), jax.tree.leaves((p, s))):
            assert g.dtype == like_dtype(w)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        ckpt_lib.save(os.path.join(d, "port"), 3, got, metadata={"x": 1})
        back, step = rckpt.restore(os.path.join(d, "port"), (p, s))
        assert step == 3
        for g, w in zip(jax.tree.leaves(back), jax.tree.leaves((p, s))):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        man = [__import__("json").load(open(os.path.join(
            d, k, "step_00000003", "manifest.json"))) for k in ("ref",
                                                                "port")]
        assert man[0] == man[1]
        assert sorted(os.listdir(os.path.join(d, "port", "step_00000003"))
                      ) == [".complete", "arrays.npz", "manifest.json"]
        # keep_last trims the oldest
        for i in range(4):
            ckpt_lib.save(os.path.join(d, "keep"), i, got, keep_last=2)
        assert ckpt_lib.list_steps(os.path.join(d, "keep")) == [2, 3]


def like_dtype(w):
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.int32): torch.int32}[np.asarray(w).dtype]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "pna", "sasrec"])
def test_launcher_trains_on_cpu(arch, capsys):
    """``launch.train.main`` in process at smoke scale on ``--device
    cpu``, one arch of each family, with a checkpoint and a restart
    that replays to the same loss."""
    with tempfile.TemporaryDirectory() as d:
        argv = ["--arch", arch, "--steps", "3", "--device", "cpu",
                "--ckpt-dir", d, "--ckpt-every", "2", "--log-every", "0"]
        assert tlaunch.main(argv) == 0
        first = capsys.readouterr().out.splitlines()[-1]
        assert first.startswith("done: step=3 loss=")
        shutil.rmtree(ckpt_lib._step_dir(d, 3))
        res = tlaunch.run(argv)
        assert capsys.readouterr().out.splitlines()[-1] == first
        assert np.isfinite(float(res.metrics["loss"]))
