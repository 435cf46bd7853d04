"""The example twins (``examples/torch_*.py``) against the reference's
examples.

Each pair runs in this process at a small size (where the example has
flags), the twin with ``--device cpu``.  Their printed lines must be equal
except where a line reports a time, a rate or sampled tokens: those parts
are masked, and the rest of the line is still compared.  The LM tokens of
``torch_serve_batched.py`` are not compared: the port samples from a
``torch.Generator``, not ``jax.random``; its prompts, token counts and
discovery side are.  Nor are ``torch_enrich_and_train.py``'s losses (its
weights are the port's own draw); its lake, enrichment, provenance,
records and step lines are, and the twin itself asserts that its loss
fell.
"""

import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import pytest

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"

# example -> (argv of both, masks applied to both outputs)
_TIME = (re.compile(r"\d+\.\d+s\b"), "<t>s")
CASES = {
    "quickstart": ([], []),
    "distributed_discovery": ([], [_TIME]),
    "async_serving": (
        ["--requests", "24", "--n-tables", "60"],
        [(re.compile(r"^latency: .*"), "latency: <masked>")],
    ),
    "serve_batched": (
        ["--requests", "2", "--max-new", "4", "--disc-requests", "3"],
        [(re.compile(r"\d+\.\d+ tok/s"), "<rate> tok/s"),
         (re.compile(r"\.\.\. -> \[.*\]$"), "... -> <sampled tokens>")],
    ),
    "enrich_and_train": (
        ["--steps", "11", "--seq-len", "32", "--batch", "4"],
        [(re.compile(r"loss \d+\.\d+( -> \d+\.\d+)?"), "loss <l>"),
         (re.compile(r"\(\d+\.\d+ steps/s\)"), "(<rate> steps/s)")],
    ),
}


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _lines(fn) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


def _mask(lines, masks):
    out = []
    for line in lines:
        for pattern, repl in masks:
            line = pattern.sub(repl, line)
        out.append(line)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_twin_prints_the_reference_lines(name, monkeypatch):
    argv, masks = CASES[name]
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    want = _lines(_load(name).main)  # the reference examples read sys.argv
    got = _lines(lambda: _load(f"torch_{name}").main([*argv, "--device", "cpu"]))
    assert _mask(got, masks) == _mask(want, masks)
    assert len(got) >= 3


def test_serve_batched_twin_served_every_submitted_request():
    """With enough decode ticks every discovery request is submitted and
    served, and the LM side produced its tokens."""
    got = _lines(lambda: _load("torch_serve_batched").main(
        ["--requests", "2", "--max-new", "12", "--disc-requests", "3", "--device", "cpu"]))
    assert any(ln.startswith("qwen1.5-0.5b-smoke: 2 requests, 24 new tokens") for ln in got)
    assert any(ln.startswith("discovery: 3/3 requests served") for ln in got)


@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-11b"])
def test_serve_batched_twin_runs_the_encoder_families(arch, monkeypatch):
    """The serve-batched pair with an encoder-decoder and a VLM arch: the
    twin passes the stub frontends' inputs to its engine as the reference
    example does, and prints the same lines (LM tokens masked)."""
    argv, masks = CASES["serve_batched"]
    argv = [*argv, "--arch", arch]
    monkeypatch.setattr(sys, "argv", ["serve_batched.py", *argv])
    want = _lines(_load("serve_batched").main)
    got = _lines(lambda: _load("torch_serve_batched").main([*argv, "--device", "cpu"]))
    assert _mask(got, masks) == _mask(want, masks)
    assert any(ln.startswith(f"{arch}-smoke: 2 requests, 8 new tokens") for ln in got)
