"""Slot-batched LM serving (port of the ``ServeEngine`` half of
``repro.serve.engine``).

The reference's behaviour is kept as it is: prompts are left-padded with
token 0 to the group's longest prompt, positions are ``arange(plen)`` with
no pad mask, and each decode step first appends the current token, then
computes the next one (so the last step's token is never appended).
Greedy decoding is ``argmax``; temperature sampling draws from a
``torch.Generator`` seeded with 0 at each ``generate`` (the reference
starts from ``PRNGKey(0)``) and does not reproduce ``jax.random``'s bits.  The
reference's ``extra_inputs`` (encoder frames, vision patches) wait for those
families (ROADMAP A.10); the ``DiscoveryEngine`` half waits for the
serving-tier port (ROADMAP A.8).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.models.transformer import TransformerLM


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new: int = 32
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


def make_serve_step(model: TransformerLM, temperature: float = 0.0):
    """Returns serve_step(cache, token[B], generator) -> (next_token[B], cache)."""

    def serve_step(cache, token, generator):
        logits, cache = model.decode_step(token, cache)
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        return nxt.to(torch.int32), cache

    return serve_step


class ServeEngine:
    """Host-side loop around prefill / serve_step.

    ``on_tick`` (optional, ``callable(step)``) runs between decode steps —
    the interleave point for another host-side scheduler while the freshly
    launched decode step is in flight.  ``timings`` holds, after
    ``generate``, the host seconds of each group's prefill (through the
    first token's readback) and of each decode step (through its token's
    readback).
    """

    def __init__(self, model: TransformerLM, batch: int, max_seq: int, temperature: float = 0.0):
        self.model = model
        self.batch, self.max_seq = batch, max_seq
        self.on_tick = None
        self.step_fn = make_serve_step(model, temperature)
        self.timings: dict[str, list[float]] = {"prefill_s": [], "decode_s": []}

    def generate(self, requests: list[Request]) -> list[Request]:
        """Serve requests in slot batches of ``self.batch``."""
        gen = torch.Generator(device=self.model.device).manual_seed(0)
        self.timings = {"prefill_s": [], "decode_s": []}
        for start in range(0, len(requests), self.batch):
            group = requests[start : start + self.batch]
            plen = max(len(r.prompt) for r in group)
            toks = np.zeros((self.batch, plen), np.int64)
            for i, r in enumerate(group):
                toks[i, plen - len(r.prompt):] = r.prompt  # left-pad
            t0 = time.perf_counter()
            logits, cache = self.model.prefill(toks, self.max_seq)
            token = torch.argmax(logits, dim=-1).to(torch.int32)
            host = token.tolist()
            self.timings["prefill_s"].append(time.perf_counter() - t0)
            max_new = max(r.max_new for r in group)
            for step in range(max_new):
                t0 = time.perf_counter()
                for i, r in enumerate(group):
                    if not r.done and step < r.max_new:
                        r.out.append(host[i])
                token, cache = self.step_fn(cache, token, gen)
                if self.on_tick is not None:
                    self.on_tick(step)
                host = token.tolist()
                self.timings["decode_s"].append(time.perf_counter() - t0)
            for r in group:
                r.done = True
        return requests
