"""Port vs reference for int8 gradient compression
(``repro_torch.distributed.compress``) and the elastic restore
(``repro_torch.train.elastic``), on the CPU.

The reference runs in one subprocess with four host devices
(``XLA_FLAGS`` is read when jax starts), which writes its answers to an
``.npz``:
  * ``quantize_int8`` and ``quantized_psum_mean`` inside ``shard_map``
    at 2 and 4 shards, run as the reference's ``make_compressed_grad_fn``
    runs them (eagerly, one op at a time; the five cases of a shard
    count in one call, through ``jax.vmap``), on normal, all-zero, tiny
    (1e-30), signed-zero and 1e-10-scaled inputs: the port's equal them
    to the bit;
  * ``make_compressed_grad_fn`` at 2 and 4 shards on a linear loss over
    a power-of-two batch of small integers, whose gradient both
    frameworks compute exactly: over three steps that carry the error
    buffer, every shard's loss, mean and residual (the reference's
    ``addressable_shards``) equal the port's shard pieces to the bit;
  * the smoke Qwen3 loss's per-shard gradients and their compressed
    mean: each element lies within half of each of the two
    quantisations' scales of the plain mean, for both packages;
  * ``elastic.recover`` of a checkpoint the port wrote, onto a (2, 2)
    mesh with ``lm_small_param_spec``: the port's pieces equal the
    reference's ``addressable_shards``, slot by slot, bit for bit.
"""
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.distributed import compress, shmap  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.train import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.train import data as data_lib  # noqa: E402
from repro_torch.train import elastic  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SHARDS = (2, 4)
N = 4096
CASES = ("normal", "zero", "tiny", "signed_zero", "small")
STEPS = 3
LIN_N, LIN_B = 1030, 8           # w pads by 2 at 4 shards; batch 2^3
# a config whose big leaves cross MIN_SHARD_SIZE and split over 4 slots
REC_CFG = dict(name="rec", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
               head_dim=32, d_ff=256, vocab=512, chunk_q=8, loss_chunk=8)
QWEN_BATCH, QWEN_SEQ = 8, 16


def _case(name, s, rng):
    x = rng.normal(size=(s, N)).astype(np.float32)
    if name == "normal":
        return x * rng.uniform(0.01, 100, size=(s, 1)).astype(np.float32)
    if name == "zero":
        return np.zeros((s, N), np.float32)
    if name == "tiny":
        return (x * np.float32(1e-30)).astype(np.float32)
    if name == "small":          # max|x| / 127 near 1e-12
        return (x * np.float32(1e-10)).astype(np.float32)
    return np.where(x > 0, np.float32(0.0), np.float32(-0.0))


def _inputs():
    rng = np.random.default_rng(3)
    z = {f"{c}_{s}": _case(c, s, rng) for c in CASES for s in SHARDS}
    z["w"] = (rng.integers(-64, 65, size=LIN_N) / 64).astype(np.float32)
    for i in range(STEPS):
        z[f"x{i}"] = rng.integers(-8, 9, size=(LIN_B, LIN_N)).astype(
            np.float32)
    lm = data_lib.lm_batch(0, 0, QWEN_BATCH, QWEN_SEQ, 512)
    z["tokens"], z["labels"] = lm["tokens"], lm["labels"]
    return z


_REFERENCE = '''
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro import configs
from repro.distributed import compress
from repro.distributed.shmap import shard_map
from repro.launch import sharding as rsh
from repro.models import transformer as rtfm
from repro.train import elastic, optimizer as ropt

d = sys.argv[1]
z = dict(np.load(d + "/in.npz"))
out = {{}}

def by_slot(arr, mesh):
    data = {{sh.device: np.asarray(sh.data) for sh in arr.addressable_shards}}
    return np.stack([data[dv] for dv in mesh.devices.flat])

for name in {cases}:
    for s in {shards}:
        for i, x in enumerate(z[f"{{name}}_{{s}}"]):
            q, sc = compress.quantize_int8(x)
            out[f"q_{{name}}_{{s}}_{{i}}"] = np.asarray(q)
            out[f"sc_{{name}}_{{s}}_{{i}}"] = np.asarray(sc)
for s in {shards}:
    mesh = Mesh(np.array(jax.devices()[:s]), ("data",))
    f = shard_map(lambda v: jax.vmap(
        lambda u: compress.quantized_psum_mean(u, "data", s))(v[0])[None],
        mesh=mesh, in_specs=P("data"), out_specs=P("data"), check_vma=False)
    got = np.asarray(f(np.stack([z[f"{{n}}_{{s}}"] for n in {cases}], 1)))
    for c, name in enumerate({cases}):
        out[f"psum_{{name}}_{{s}}"] = got[:, c]

def lin_loss(p, b):
    return jnp.mean(b["x"] @ p["w"])

for s in {shards}:
    mesh = Mesh(np.array(jax.devices()[:s]), ("data",))
    fn = compress.make_compressed_grad_fn(lin_loss, mesh, "data")
    params = {{"w": z["w"]}}
    err = compress.zeros_like_error(params)
    for step in range({steps}):
        loss, g, err = fn(params, {{"x": z[f"x{{step}}"]}}, err)
        out[f"lin_{{s}}_{{step}}_loss"] = by_slot(loss, mesh)
        out[f"lin_{{s}}_{{step}}_g_w"] = by_slot(g["w"], mesh)
        out[f"lin_{{s}}_{{step}}_e_w"] = by_slot(err["w"], mesh)

cfg = configs.get_arch("qwen3-0.6b").make_config("smoke")
params = rtfm.init_params(jax.random.PRNGKey(0), cfg)
mesh4 = Mesh(np.array(jax.devices()[:4]), ("data",))

def prog(p, b):
    _, g = jax.value_and_grad(lambda pp, bb: rtfm.loss_fn(pp, cfg, bb))(p, b)
    leaves = jax.tree.leaves(g)
    means = [compress.quantized_psum_mean(
        jnp.pad(x.reshape(-1), (0, (-x.size) % 4)), "data", 4)[None]
        for x in leaves]
    return [x[None] for x in leaves], means

f = jax.jit(shard_map(prog, mesh=mesh4, in_specs=(P(), P("data")),
                      out_specs=P("data"), check_vma=False))
gs, ms = f(params, {{"tokens": z["tokens"], "labels": z["labels"]}})
for i, (g, m) in enumerate(zip(gs, ms)):
    out[f"qwen_g_{{i}}"] = np.asarray(g).reshape(4, -1)
    out[f"qwen_m_{{i}}"] = np.asarray(m)

rcfg = rtfm.TransformerConfig(**{rec_cfg})
rp = rtfm.init_params(jax.random.PRNGKey(1), rcfg)
mesh22 = jax.make_mesh((2, 2), ("data", "model"))
restored, step = elastic.recover(
    d + "/ckpt", (rp, ropt.init(rp)), mesh22,
    lambda path, leaf: rsh.lm_small_param_spec(path, leaf, mesh22))
out["rec_step"] = np.asarray(step)
for i, leaf in enumerate(jax.tree.leaves(restored)):
    out[f"rec_{{i}}"] = by_slot(leaf, mesh22)
np.savez(d + "/out.npz", **out)
'''


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """(inputs, the reference's answers, the port's saved state)."""
    d = tmp_path_factory.mktemp("compress")
    z = _inputs()
    np.savez(d / "in.npz", **z)
    p = ttfm.init_params(5, ttfm.TransformerConfig(**REC_CFG), device="cpu")
    state = (p, opt_lib.init(p))
    ckpt_lib.save(str(d / "ckpt"), 7, state)
    code = _REFERENCE.format(cases=CASES, shards=SHARDS, steps=STEPS,
                             rec_cfg=REC_CFG)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", code, str(d)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(d / "out.npz") as ref:
        return z, dict(ref), str(d / "ckpt"), state


def _bits(x):
    x = x.detach().numpy() if isinstance(x, torch.Tensor) else x
    return np.ascontiguousarray(x).view(np.uint8)


def _same_bits(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, got.dtype, want.shape, want.dtype)
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("name", CASES)
def test_quantize_int8_matches_reference(case, name, s):
    z, ref, *_ = case
    for i in range(s):
        q, sc = compress.quantize_int8(torch.from_numpy(z[f"{name}_{s}"][i]))
        _same_bits(q, ref[f"q_{name}_{s}_{i}"])
        _same_bits(sc, ref[f"sc_{name}_{s}_{i}"])
        back = compress.dequantize(q, sc)
        assert back.dtype == torch.float32
        assert torch.equal(back, q.float() * sc)


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("name", CASES)
def test_quantized_psum_mean_matches_reference(case, name, s):
    """Every shard's mean equals the reference shard's, to the bit."""
    z, ref, *_ = case
    mesh = shmap.make_mesh(s, "data", device="cpu")
    got = compress.quantized_psum_mean(
        mesh, [torch.from_numpy(x) for x in z[f"{name}_{s}"]])
    for i in range(s):
        _same_bits(got[i], ref[f"psum_{name}_{s}"][i])


def test_all_to_all_sends_chunk_s_to_shard_s():
    mesh = shmap.make_mesh(3, "data", device="cpu")
    parts = [torch.arange(6).reshape(3, 2) + 10 * s for s in range(3)]
    got = shmap.all_to_all(mesh, parts)
    for s in range(3):
        assert torch.equal(got[s], torch.stack([p[s] for p in parts]))


def _lin_loss(p, b):
    return (b["x"] @ p["w"]).mean()


@pytest.mark.parametrize("s", SHARDS)
def test_compressed_grad_fn_per_shard_matches_reference(case, s):
    """Three steps carrying the error buffer: each shard's loss, mean
    and residual equal the reference's addressable shards, to the bit;
    ``gather()`` gives shard 0's, what the reference's host reads."""
    z, ref, *_ = case
    mesh = tmesh.make_host_mesh(n_slots=s, device="cpu")
    fn = compress.make_compressed_grad_fn(_lin_loss, mesh, "data")
    params = {"w": torch.from_numpy(z["w"])}
    err = compress.zeros_like_error(params)
    for step in range(STEPS):
        batch = {"x": torch.from_numpy(z[f"x{step}"])}
        loss, g, err = fn(params, batch, err)
        got = {"loss": loss, **{f"g_{k}": g[k] for k in g},
               **{f"e_{k}": err[k] for k in err}}
        for name, x in got.items():
            want = ref[f"lin_{s}_{step}_{name}"]
            assert len(x.pieces) == s
            for i in range(s):
                _same_bits(x.pieces[i], want[i])
            _same_bits(x.gather(), want[0])


def _bound_ok(flats, mean):
    """Each element of the compressed ``mean`` within half of each of
    the two quantisations' scales of the plain mean of ``flats`` [S, n]
    (the first: the shards' scales, averaged; the second: the chunk's
    scale, max|chunk| / 127), with a few ulps of f32 slack."""
    s, n = flats.shape
    plain = flats.astype(np.float64).mean(0)
    s1 = np.mean([np.abs(x).max() / 127 for x in flats])
    chunks = mean.reshape(s, n // s)
    s2 = np.repeat(np.abs(chunks).max(1) / 127, n // s)
    slack = 1e-6 * max(np.abs(plain).max(), 1e-30)
    return bool((np.abs(mean - plain) <= 0.5 * s1 + 0.5 * s2 + slack).all())


def test_compressed_mean_within_quantisation_bound(case):
    """On the smoke Qwen3 loss at 4 shards, the compressed mean of the
    shards' gradients lies within the two quantisations' half scales of
    their plain mean: the port's (through ``make_compressed_grad_fn``,
    whose first step equals ``quantized_psum_mean`` of the same
    gradients to the bit) and the reference's alike."""
    z, ref, *_ = case
    i = 0
    while f"qwen_g_{i}" in ref:
        g, m = ref[f"qwen_g_{i}"], ref[f"qwen_m_{i}"]
        pad = (-g.shape[1]) % 4
        assert _bound_ok(np.pad(g, ((0, 0), (0, pad))), m[0])
        i += 1
    cfg = tconfigs.get_arch("qwen3-0.6b").make_config("smoke")
    params = ttfm.init_params(0, cfg, device="cpu")

    def loss_fn(p, b):
        return ttfm.loss_fn(p, cfg, b)
    batch = {k: torch.from_numpy(z[k]) for k in ("tokens", "labels")}
    mesh = tmesh.make_host_mesh(n_slots=4, device="cpu")
    _, mean, _ = compress.make_compressed_grad_fn(loss_fn, mesh, "data")(
        params, batch, compress.zeros_like_error(params))
    line = mesh.along("data")
    per = [tree.leaves(opt_lib.value_and_grad(
        loss_fn, params, {k: v[2 * s:2 * s + 2] for k, v in batch.items()}
    )[1]) for s in range(4)]
    for j, m in enumerate(tree.leaves(mean)):
        flats = [p[j].reshape(-1) for p in per]
        pad = (-flats[0].shape[0]) % 4
        flats = [torch.nn.functional.pad(f, (0, pad)) for f in flats]
        want = compress.quantized_psum_mean(line, flats)[0]
        _same_bits(m.gather().reshape(-1),
                   want[:int(np.prod(m.shape))].numpy())
        assert _bound_ok(torch.stack(flats).numpy(), want.numpy())
    assert i == len(tree.leaves(mean))


def test_restore_onto_mesh():
    """``tests/test_train.py::test_restore_onto_mesh``'s contract on a
    (1,) mesh: step 1, every leaf back bit for bit."""
    params = ttfm.init_params(0, ttfm.TransformerConfig(**REC_CFG),
                              device="cpu")
    mesh = shmap.make_named_mesh((1,), ("data",), "cpu")
    with tempfile.TemporaryDirectory() as d:
        ckpt_lib.save(d, 1, params)
        restored, step = elastic.recover(
            d, params, mesh, lambda path, leaf: sharding.P())
        assert step == 1
        for a, b in zip(tree.leaves(params), tree.leaves(restored)):
            assert torch.equal(a, b.gather())


def test_recover_onto_2x2_matches_reference_pieces(case):
    """``recover`` onto a (2, 2) CPU mesh with ``lm_small_param_spec``:
    each slot's piece equals the reference's addressable shard on the
    same mesh position, and ``gather()`` the saved leaf, bit for bit."""
    _, ref, ckpt, state = case
    mesh = elastic.largest_mesh(model_parallelism=2, n_slots=4,
                                device="cpu")
    assert mesh.shape == {"data": 2, "model": 2}
    restored, step = elastic.recover(
        ckpt, state, mesh,
        lambda path, leaf: sharding.lm_small_param_spec(path, leaf, mesh))
    assert step == int(ref["rec_step"]) == 7
    leaves = tree.leaves(restored)
    assert len(leaves) == len([k for k in ref if k.startswith("rec_")]) - 1
    split = 0
    for i, (leaf, saved) in enumerate(zip(leaves, tree.leaves(state))):
        for j in range(4):
            _same_bits(leaf.pieces[j], ref[f"rec_{i}"][j])
        _same_bits(leaf.gather(), saved.numpy())
        split += leaf.pieces[0].numel() < saved.numel()
    assert split >= 4                      # the big leaves were cut
