"""The port's backend registry against ``tests/test_registry.py``:
``register_backend`` (unique, immutable names in registration order) and
``ops.fused_filter_default`` (a predicate over the unpinned dispatch),
each held to the reference's answer under the same environment."""

import pytest

from repro.kernels import ops as ref_ops
from repro.kernels import registry as ref_registry
from repro_torch.core.session import DiscoveryConfig
from repro_torch.kernels import ops, registry
from repro_torch.kernels.registry import BackendSpec

ENV = registry.ENV_VAR


def test_builtin_backends_in_the_reference_order():
    assert registry.ENV_VAR == ref_registry.ENV_VAR
    assert registry.backend_names() == ref_registry.backend_names()
    for name in registry.backend_names():
        spec, ref = registry._REGISTRY[name], ref_registry._REGISTRY[name]
        assert (spec.fused, spec.device, spec.gather) == (ref.fused, ref.device, ref.gather)


@pytest.mark.parametrize("name", ref_registry.backend_names())
def test_register_backend_rejects_duplicates(name):
    with pytest.raises(ValueError, match="already registered"):
        registry.register_backend(BackendSpec(name, "dup"))
    with pytest.raises(ValueError, match="already registered"):
        ref_registry.register_backend(ref_registry.BackendSpec(name, "dup"))


def test_register_backend_appends_a_resolvable_name(monkeypatch):
    monkeypatch.setattr(registry, "_REGISTRY", dict(registry._REGISTRY))
    spec = registry.register_backend(BackendSpec("probe", "a test backend", fused=True))
    assert registry.backend_names()[-1] == "probe"
    assert registry.backend_names()[:-1] == ref_registry.backend_names()
    bk = registry.resolve_backend("probe")
    assert bk.spec is spec and bk.source == "config" and bk.fused
    with pytest.raises(ValueError, match="already registered"):
        registry.register_backend(BackendSpec("probe", "again"))


@pytest.mark.parametrize("env", ["fused", "fused-gather", "xla", "pallas", "numpy", "auto"])
def test_fused_filter_default_follows_registry(monkeypatch, env):
    monkeypatch.setenv(ENV, env)
    assert ops.fused_filter_default() == ref_ops.fused_filter_default()
    assert ops.fused_filter_default() == (env in ("fused", "fused-gather"))


def test_fused_filter_default_on_the_platform(monkeypatch):
    """Unset (or unknown): the platform default decides — 'auto' on this
    CPU in both packages, so neither is fused."""
    monkeypatch.delenv(ENV, raising=False)
    assert not ops.fused_filter_default() and not ref_ops.fused_filter_default()
    monkeypatch.setenv(ENV, "no-such-backend")
    assert not ops.fused_filter_default() and not ref_ops.fused_filter_default()


@pytest.mark.parametrize("pin,env", [("numpy", "fused"), ("fused", "xla")])
def test_config_pin_outranks_fused_filter_default(monkeypatch, pin, env):
    """A config pin wins over the variable; the predicate keeps reporting
    the unpinned dispatch, as the reference's does."""
    monkeypatch.setenv(ENV, env)
    pinned = DiscoveryConfig(backend=pin).resolve_backend("cpu")
    assert pinned.name == pin and pinned.source == "config"
    assert pinned.fused == (pin == "fused")
    assert ops.fused_filter_default() == (env == "fused") == ref_ops.fused_filter_default()
