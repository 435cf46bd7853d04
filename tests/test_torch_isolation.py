"""Guards of the port's boundaries.

* Importing every module of ``repro_torch`` and every example twin
  (``examples/torch_*.py``), in a fresh interpreter, leaves ``jax``,
  ``repro``, ``triton`` and ``ml_dtypes`` out of ``sys.modules``, and
  neither the package, the twins nor ``chip_smoke.py`` has an import
  statement naming them (the card's machine has no ``ml_dtypes``: bf16
  checkpoint leaves are read as bytes).
* ``MATE_FILTER_BACKEND`` has one reader in the port: ``kernels/registry.py``.
* No module builds or imports a kernel toolchain at import time.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    for p in PKG.rglob("*.py")
)
TWINS = sorted((ROOT / "examples").glob("torch_*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro", "triton", "ml_dtypes")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_importing_the_port_pulls_in_no_reference_or_toolchain():
    code = (
        "import importlib, importlib.util, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m.replace('.__init__', ''))\n"
        f"for i, path in enumerate({[str(p) for p in TWINS]!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'twin{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r})\n"
        "print('BAD', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        timeout=120, check=True,
    ).stdout
    assert "BAD []" in out, out


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + TWINS + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_import_statement_names_reference_or_jax(path):
    assert not _imported_roots(path) & set(FORBIDDEN)


def test_every_reference_example_has_a_twin():
    assert [p.name for p in TWINS] == sorted(
        f"torch_{name}.py" for name in
        ("quickstart", "async_serving", "distributed_discovery", "serve_batched",
         "enrich_and_train")
    )


def test_filter_backend_env_var_has_one_reader():
    readers = sorted(
        str(p.relative_to(PKG)) for p in PKG.rglob("*.py")
        if "MATE_FILTER_BACKEND" in p.read_text()
    )
    assert readers == ["kernels/registry.py"]


def test_every_kernel_source_is_built():
    from repro_torch.kernels import _build

    for name, (src, entries) in _build.LIBRARIES.items():
        text = (PKG / "kernels" / "csrc" / src).read_text()
        for entry in entries:
            assert f"REPRO_API int {entry}(" in text, (name, entry)
        assert "Replaces: src/repro/kernels/" in text or "replaces src/repro/kernels/" in text
    assert sorted(p.name for p in (PKG / "kernels" / "csrc").glob("*.cu")) == sorted(
        src for src, _ in _build.LIBRARIES.values()
    )


def test_every_reference_model_module_has_a_port():
    """Each module of the reference's ``models`` package has its port,
    among the modules the guards above import and scan."""
    ref = sorted(p.stem for p in (ROOT / "src" / "repro" / "models").glob("*.py"))
    assert [m for m in ref if f"repro_torch.models.{m}" not in MODULES] == []
    assert {"repro_torch.models.moe", "repro_torch.models.ssm", "repro_torch.models.mla"} <= set(MODULES)
