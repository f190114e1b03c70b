"""The platform selector and the compile-cache helper (core/platform.py)."""

import os

import jax
import pytest

from spleeterrt_tpu.core import platform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_test_backend_is_cpu():
    assert platform.backend() == "cpu"


@pytest.mark.parametrize("name", ["cpu", "gpu"])
def test_supported_backend(monkeypatch, name):
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    assert platform.backend() == name


@pytest.mark.parametrize("name", ["rocm", "METAL", "neuron"])
def test_unsupported_backend_raises(monkeypatch, name):
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    with pytest.raises(RuntimeError, match=f"unsupported JAX backend '{name}'"):
        platform.backend()


def test_compile_cache_env_set_sets_nothing(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert platform.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_env_unset_uses_checkout(monkeypatch):
    calls, made = [], []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setattr(os, "makedirs", lambda d, exist_ok: made.append(d))
    path = platform.enable_compile_cache()
    assert path == os.path.join(REPO, ".cache", "jaxcache")
    assert made == [path]
    assert calls == [("jax_compilation_cache_dir", path)]
