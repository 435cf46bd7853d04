"""The discovery driver: ``python -m repro_torch.launch.discovery`` against
``python -m repro.launch.discovery``.

Both drivers run with the same argv in this process, at 80 tables, 2
queries and 10 rows; their ``[mate]`` lines must be equal line by line,
with the times and the speedup masked.  The reference runs its 'numpy'
backend (its Pallas backends are interpret mode on the CPU: ROADMAP C.2);
the port runs 'numpy' — where nothing else is masked — and 'fused-gather',
the CUDA default, on CPU tensors, where the fields that name or depend on
the backend's class are masked too: backend names, the session's repr,
the match-matrix readback (a fused backend never builds the matrix) and
the mesh filter's shard impl.  The process-group paths (``--build-mesh
2``, ``--route-shards 2``, ``--mesh 2x1``) spawn gloo ranks, so they run
once, as subprocesses of both drivers side by side; so does ``--mesh
2x2`` (4 gloo ranks, the rows over 'data' and replicated over 'model';
the reference on 4 forced host devices), whose counts equal ``--mesh
1x1``'s.
"""

import argparse
import contextlib
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro.launch import discovery as ref_driver
from repro_torch.launch import discovery as driver

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--n-tables", "80", "--queries", "2", "--rows", "10"]
CASES = {
    "rank-quality": ["--rank", "quality"],
    "rank-count-no-gate": ["--rank", "count", "--no-profile-gate"],
    "bits-256": ["--bits", "256"],
    "hash-bf": ["--hash", "bf"],
    "fds-signals": ["--fds", "--fd-signals"],
    "caches": ["--result-cache", "4", "--bound-cache", "4"],
}
PORT_BACKENDS = ("numpy", "fused-gather")
SPAWN_TIMEOUT_S = 300

_TIME = re.compile(r"\d+\.\d+s\b")
_SPEEDUP = re.compile(r"speedup=\d+\.\d+x")
_BACKEND_FIELDS = [
    (re.compile(r"backend=[\w-]+\[\w+\]"), "backend=<backend>"),
    (re.compile(r"session: .*"), "session: <session>"),
    (re.compile(r"match_readback=.*"), "match_readback=<readback>"),
    (re.compile(r"impl=[\w-]+"), "impl=<impl>"),
]


def _mask(lines, backend_fields: bool):
    out = []
    for line in lines:
        line = _SPEEDUP.sub("speedup=<x>", _TIME.sub("<t>s", line))
        if backend_fields:
            for pattern, repl in _BACKEND_FIELDS:
                line = pattern.sub(repl, line)
        out.append(line)
    return out


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return [ln for ln in buf.getvalue().splitlines() if ln.startswith("[mate]")]


_REF: dict = {}


def _reference(case):
    if case not in _REF:
        _REF[case] = _run(ref_driver.main, SMALL + CASES[case] + ["--backend", "numpy"])
    return _REF[case]


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("case", list(CASES))
def test_driver_prints_the_reference_lines(case, backend):
    want = _reference(case)
    got = _run(driver.main, SMALL + CASES[case] + ["--backend", backend, "--device", "cpu"])
    masked = backend != "numpy"
    assert _mask(got, masked) == _mask(want, masked)
    # the reference's own verdicts, so equal-but-wrong output cannot pass
    label = "engines_bit_identical" if "count" in CASES[case] else "engines_set_identical"
    assert sum(f"{label}=True" in ln for ln in got) == 2
    assert any("all_served=True" in ln for ln in got)
    assert got[-1].startswith("[mate] distributed filter on mesh 1x1")
    if "--fds" in CASES[case]:
        assert any("FD workload" in ln and "signals=on" in ln for ln in got)
    if "--result-cache" in CASES[case]:
        assert any("all_from_cache=True" in ln for ln in got)
    if backend == "fused-gather":
        assert any("(fused, matrix_bytes=0)" in ln for ln in got)


def _parser(main):
    """The argparse parser a driver's ``main`` builds."""
    class Captured(Exception):
        pass

    def capture(self, *args, **kwargs):
        raise Captured(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(Captured) as info:
            main([])
    return info.value.args[0]


def _flags(parser):
    return {
        a.option_strings[0]: (a.dest, a.default, a.choices, a.type, a.nargs, type(a).__name__)
        for a in parser._actions if a.option_strings and a.dest != "help"
    }


def test_driver_takes_every_reference_flag():
    ref, port = _flags(_parser(ref_driver.main)), _flags(_parser(driver.main))
    assert {k: v for k, v in port.items() if k != "--device"} == ref
    assert port["--device"][1] is None  # the card unless asked for the CPU


def test_a_malformed_mesh_raises():
    with pytest.raises(ValueError, match="DxM"):
        driver.main(SMALL + ["--mesh", "two", "--device", "cpu"])
    with pytest.raises(ValueError, match=">= 1"):
        driver.main(SMALL + ["--mesh", "0x2", "--device", "cpu"])


def _drivers(argv: list, ref_env: dict | None = None) -> dict:
    """The ``[mate]`` lines of both drivers run with ``argv`` as
    subprocesses side by side (the reference on 'numpy', the port on
    'fused-gather' on the CPU); ``ref_env``: the reference's extra
    environment."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = {
        "ref": subprocess.Popen(
            [sys.executable, "-m", "repro.launch.discovery", *argv, "--backend", "numpy"],
            cwd=ROOT, env=dict(env, **(ref_env or {})), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True),
        "port": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.discovery", *argv,
             "--backend", "fused-gather", "--device", "cpu"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
    }
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=SPAWN_TIMEOUT_S)
            assert p.returncode == 0, (name, stderr[-3000:])
            out[name] = [ln for ln in stdout.splitlines() if ln.startswith("[mate]")]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return out


def test_process_group_paths_match_the_reference():
    """--build-mesh 2 (the build across 2 gloo ranks, byte-identical to the
    single-host build), --route-shards 2 and --mesh 2x1 (the row filter over
    2 ranks), one subprocess per driver, run side by side."""
    argv = SMALL + ["--build-mesh", "2", "--route-shards", "2", "--mesh", "2x1"]
    out = _drivers(argv)
    got = out["port"]
    assert _mask(got, True) == _mask(out["ref"], True)
    assert "[mate] build stats: shards=2 mesh={'data': 2} " in "\n".join(got)
    assert any("bit_identical=True" in ln for ln in got)
    assert got[-1].startswith("[mate] distributed filter on mesh 2x1 (impl=fused)")


def test_mesh_with_a_model_axis_matches_the_reference():
    """--mesh 2x2: the row filter on 4 gloo ranks, the rows over 'data'
    and replicated over 'model', beside the reference's on 4 forced host
    devices; the counts in its line equal --mesh 1x1's."""
    out = _drivers(SMALL + ["--mesh", "2x2"], {"XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    got = out["port"]
    assert _mask(got, True) == _mask(out["ref"], True)
    assert got[-1].startswith("[mate] distributed filter on mesh 2x2 (impl=fused)")
    one = _run(driver.main, SMALL + ["--backend", "fused-gather", "--device", "cpu"])
    counts = lambda line: line.split("): ", 1)[1].rsplit(" in ", 1)[0]  # noqa: E731
    assert one[-1].startswith("[mate] distributed filter on mesh 1x1")
    assert counts(got[-1]) == counts(one[-1]), (got[-1], one[-1])
