"""CPU tests of the choices the GPU path makes without a card.

The compile-cache helper, ``chip_smoke.py``'s refusal of any platform but
a GPU, the rejected ``"fused"`` solver, and the per-platform defaults of
the chain solve and the windowed reduce, each written as a function of
the platform name so that both sides are testable here.
"""

import importlib.util
import os

import jax
import pytest

import tinyopt_tpu as to
from tinyopt_tpu.chain import default_chain_method
from tinyopt_tpu.ops.schur_obs import window_default
from tinyopt_tpu.utils import use_compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_dir_restored():
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_compile_cache_env_set(monkeypatch, tmp_path, cache_dir_restored):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    before = jax.config.jax_compilation_cache_dir
    assert use_compile_cache(str(tmp_path)) == str(tmp_path / "env")
    # JAX reads the variable itself: nothing is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_env_unset(monkeypatch, tmp_path, cache_dir_restored):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(str(tmp_path), ".jax_cache")
    assert use_compile_cache(str(tmp_path)) == want
    assert jax.config.jax_compilation_cache_dir == want
    # fixed: a second call (a later run) names the same directory
    assert use_compile_cache(str(tmp_path)) == want


def test_chip_smoke_refuses_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert "needs a GPU" in str(e.value.code)
    assert capsys.readouterr().out == ""       # no phase, no result line


def test_fused_solver_rejected():
    with pytest.raises(ValueError, match='"cg"'):
        to.HessianOptions(solver="fused")
    assert to.HessianOptions(solver="cg").solver == "cg"


def test_default_chain_method_by_platform():
    assert default_chain_method("cpu") == "scan"
    assert default_chain_method("gpu") == "cr"


def test_window_default_by_platform():
    assert window_default("cpu") is False
    assert window_default("gpu") is False
