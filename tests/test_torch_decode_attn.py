"""Port vs reference for split-K decode attention:
``repro_torch.distributed.decode_attn`` (S shard programs in turn over
``shmap``, joined by ``pmax`` and ``psum`` on the mesh's first device)
against ``repro.distributed.decode_attn`` under ``shard_map``.

The reference runs at 1, 2 and 4 shards in one subprocess with four
host devices (``XLA_FLAGS`` is read when jax starts), which writes its
answers to an ``.npz``; the port runs the same inputs on CPU meshes of
the same sizes.  Both are also held to the single-device
``decode_attention``.  Tolerance: the reference's own, rtol 2e-4, atol
1e-5 (``tests/test_distributed.py``).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import attention as rattn  # noqa: E402
from repro_torch.distributed import decode_attn, shmap  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SHARDS = (1, 2, 4)
WINDOWS = (0, 16)
TOL = dict(rtol=2e-4, atol=1e-5)


def _inputs():
    """GQA (4 query heads on 2 kv heads), 64 cache slots, cache lengths
    that end inside a shard, at a shard's edge and at the last slot."""
    rng = np.random.default_rng(1)
    q = rng.normal(size=(3, 4, 1, 16)).astype(np.float32)
    kc = rng.normal(size=(3, 2, 64, 16)).astype(np.float32)
    vc = rng.normal(size=(3, 2, 64, 16)).astype(np.float32)
    return q, kc, vc, np.array([50, 31, 63], np.int32)


_REFERENCE = '''
import jax, numpy as np
from repro.distributed import decode_attn
with np.load({inputs!r}) as z:
    args = [z[k] for k in ("q", "kc", "vc", "cl")]
out = {{}}
for n in {shards}:
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("data",))
    fn = decode_attn.splitk_decode_attention(mesh, "data")
    for w in {windows}:
        run = jax.jit(lambda q, k, v, c: fn(q, k, v, c, window=w))
        out[f"{{n}}_{{w}}"] = np.asarray(run(*args))
np.savez({path!r}, **out)
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's split-K answers at 1, 2 and 4 shards, from one
    subprocess with four host devices."""
    tmp = tmp_path_factory.mktemp("splitk")
    inputs, path = str(tmp / "inputs.npz"), str(tmp / "ref.npz")
    np.savez(inputs, **dict(zip(("q", "kc", "vc", "cl"), _inputs())))
    code = _REFERENCE.format(inputs=inputs, shards=SHARDS, windows=WINDOWS,
                             path=path)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(path) as z:
        return dict(z)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("n", SHARDS)
def test_splitk_matches_reference(reference, n, window):
    q, kc, vc, cl = _inputs()
    mesh = shmap.make_mesh(n, "data", device="cpu")
    fn = decode_attn.splitk_decode_attention(mesh, "data")
    got = fn(*(torch.from_numpy(x) for x in (q, kc, vc, cl)),
             window=window)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), reference[f"{n}_{window}"],
                               **TOL)
    # and the single-device decode attention, in both packages
    want = rattn.decode_attention(*(jnp.asarray(x) for x in (q, kc, vc)),
                                  jnp.asarray(cl), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = tattn.decode_attention(*(torch.from_numpy(x)
                                     for x in (q, kc, vc)),
                                   torch.from_numpy(cl), window=window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


def test_splitk_shard_with_no_valid_key():
    """A shard whose slots all lie past every cache length (or before
    every window) adds nothing: its max is NEG_INF and its rescale 0."""
    q, kc, vc, _ = _inputs()
    cl = np.array([10, 3, 15], np.int32)      # every key in shard 0 of 4
    mesh = shmap.make_mesh(4, device="cpu")
    fn = decode_attn.splitk_decode_attention(mesh, "shards")
    args = [torch.from_numpy(x) for x in (q, kc, vc, cl)]
    for w in WINDOWS:
        got = fn(*args, window=w)
        want = tattn.decode_attention(*args, window=w)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_splitk_refuses_a_wrong_mesh():
    mesh = shmap.make_mesh(4, "data", device="cpu")
    with pytest.raises(ValueError, match="no axis"):
        decode_attn.splitk_decode_attention(mesh, "model")
    fn = decode_attn.splitk_decode_attention(mesh, "data")
    q, kc, vc, cl = (torch.from_numpy(x) for x in _inputs())
    with pytest.raises(ValueError, match="does not split over 4 shards"):
        fn(q, kc[:, :, :62], vc[:, :, :62], cl)


def test_pmax_is_the_elementwise_maximum_on_the_first_device():
    mesh = shmap.make_mesh(3, device="cpu")
    parts = [torch.tensor([1.0, -5.0, 2.0]), torch.tensor([0.0, -1.0, 7.0]),
             torch.tensor([3.0, -1e30, 2.0])]
    got = shmap.pmax(mesh, parts)
    assert got.tolist() == [3.0, -1.0, 7.0]
    assert got.device == mesh.devices[0]
