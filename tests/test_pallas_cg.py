"""The batched CG Pallas kernel (ops/pallas_cg.py) in interpret mode.

The kernel itself compiles only for a GPU (Triton route); here it runs in
Pallas interpret mode against a float64 ``np.linalg.solve`` and against
the XLA CG it replaces.  The choice between the two, the padding and the
nested-vmap wiring are plain Python and are tested as such.  The one
check of the compiled kernel is marked ``gpu`` and skips without a card;
on one, run ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tinyopt_tpu.ops.pallas_cg as pc
from tinyopt_tpu.ops.linalg import solve_psd_cg


def _spd(B, d, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, d, d))
    H = A @ A.transpose(0, 2, 1) / d + np.eye(d)
    return H, rng.normal(size=(B, d))


# d = 1 and 64 need no padding, 6 / 50 / 100 do; batch 37 is no multiple
# of any program's instance count.
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("d", [1, 6, 50, 64, 100])
def test_kernel_matches_f64_solve(d, dtype):
    H, b = _spd(37, d, seed=d)
    x = pc.batched_cg_triton(jnp.asarray(H, dtype), jnp.asarray(b, dtype),
                             d, interpret=True)
    assert x.shape == (37, d) and x.dtype == dtype
    exact = np.linalg.solve(H, b[..., None])[..., 0]
    # d iterations of CG solve a d-dim SPD system up to rounding; cond(H)
    # here is ~5, so the error is a few ulps times the iteration count
    tol = 1e-4 if dtype == jnp.float32 else 1e-10
    np.testing.assert_allclose(np.asarray(x), exact, rtol=tol, atol=tol)
    # same iterates as the XLA CG, up to summation order
    xr = solve_psd_cg(jnp.asarray(H, dtype), jnp.asarray(b, dtype), d)
    np.testing.assert_allclose(np.asarray(x), np.asarray(xr),
                               rtol=tol, atol=tol)


def test_padded_width():
    assert [pc.padded_width(d) for d in (1, 2, 3, 6, 8, 50, 64, 100)] == \
        [1, 2, 4, 8, 8, 64, 64, 128]


def test_use_triton_cg_choice():
    # only on a GPU
    assert not pc.use_triton_cg("cpu", 50, 10_000)
    assert pc.use_triton_cg("gpu", 50, 10_000)
    # padded width within [MIN_PADDED_D, MAX_PADDED_D]
    assert pc.use_triton_cg("gpu", pc.MIN_PADDED_D, 10)
    assert not pc.use_triton_cg("gpu", pc.MIN_PADDED_D // 2, 10)
    assert pc.use_triton_cg("gpu", pc.MAX_PADDED_D, 10)
    assert not pc.use_triton_cg("gpu", pc.MAX_PADDED_D + 1, 10)
    # 32-bit element offsets into the flattened H
    assert not pc.use_triton_cg("gpu", 64, 2 ** 31 // (64 * 64))


def test_vmap_rule_uses_kernel_when_chosen(monkeypatch):
    """Under nested vmap the rule sees the inner batch and the outer
    vmap batches the kernel call."""
    calls = []
    triton_cg = pc.batched_cg_triton

    def kernel(H, b, iters):
        calls.append(H.shape)
        return triton_cg(H, b, iters, interpret=True)

    monkeypatch.setattr(pc, "use_triton_cg", lambda *a: True)
    monkeypatch.setattr(pc, "batched_cg_triton", kernel)
    H, b = _spd(6, 5, seed=3)
    cg = pc.make_cg_solver(5)
    x = jax.vmap(jax.vmap(cg))(jnp.asarray(H).reshape(2, 3, 5, 5),
                               jnp.asarray(b).reshape(2, 3, 5))
    assert calls == [(3, 5, 5)]
    exact = np.linalg.solve(H, b[..., None])[..., 0]
    np.testing.assert_allclose(np.asarray(x).reshape(6, 5), exact,
                               rtol=1e-10, atol=1e-10)


def test_vmap_rule_unbatched_operand(monkeypatch):
    """A shared (unbatched) H is broadcast over the batch of b."""
    monkeypatch.setattr(pc, "use_triton_cg", lambda *a: True)
    monkeypatch.setattr(pc, "batched_cg_triton",
                        functools.partial(pc.batched_cg_triton,
                                          interpret=True))
    H, b = _spd(4, 6, seed=5)
    cg = pc.make_cg_solver(6)
    x = jax.vmap(cg, in_axes=(None, 0))(jnp.asarray(H[0]), jnp.asarray(b))
    exact = np.linalg.solve(H[0], b.T).T
    np.testing.assert_allclose(np.asarray(x), exact, rtol=1e-10,
                               atol=1e-10)


@pytest.fixture
def gpu_device():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: the Triton kernel compiles only there")
    return jax.devices()[0]


@pytest.mark.gpu
def test_kernel_on_card(gpu_device):
    """The compiled kernel at 10k × 50 in f32 against the XLA CG (same
    iterations, HIGHEST precision) and a float64 solve (chip_smoke's
    check)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    same, exact, _, _ = chip_smoke.cg_kernel_check(10_000, 50)
    assert same <= 1e-4 and exact <= 1e-4
