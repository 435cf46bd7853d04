"""Training data pipeline and model-input stubs (port of
``repro.data.pipeline``).

``TokenPipeline`` is a deterministic, restart-safe synthetic LM token
stream: batch ``i`` is a pure function of (seed, step), so a resumed run
continues mid-epoch with no state.  Numpy only, with the reference's
generator calls in the reference's order: its batches are the reference's,
bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0


class TokenPipeline:
    """Zipfian token stream with injected n-gram structure (so tiny models
    have something learnable)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # fixed bigram transition "grammar" for learnability
        self.next_tok = rng.integers(0, cfg.vocab_size, size=cfg.vocab_size)

    def batch(self, step: int) -> dict:
        """{'tokens', 'labels'}: int32 [global_batch, seq_len] numpy arrays;
        labels are the tokens shifted by one, -1 at the last position."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s = cfg.global_batch, cfg.seq_len
        toks = np.empty((b, s), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, size=b)
        flip = rng.random((b, s)) < 0.3  # 70% deterministic bigram
        rand = rng.integers(0, cfg.vocab_size, size=(b, s))
        for t in range(1, s):
            det = self.next_tok[toks[:, t - 1]]
            toks[:, t] = np.where(flip[:, t], rand[:, t], det)
        labels = np.concatenate([toks[:, 1:], np.full((b, 1), -1, np.int32)], axis=1)
        return {"tokens": toks, "labels": labels}


def stub_inputs(cfg: ModelConfig, batch: int, rng_seed: int = 0, device=None) -> dict:
    """Modality-frontend stubs: precomputed frame/patch embeddings, bf16 on
    ``device`` (None: the CUDA device), drawn from the reference's numpy
    stream (float32 normals rounded to float16, then to bf16)."""
    dev = resolve_device(device)
    out = {}
    rng = np.random.default_rng(rng_seed)
    if cfg.encoder is not None:
        out["frames"] = rng.standard_normal(
            (batch, cfg.encoder.n_frames, cfg.d_model), dtype=np.float32
        ).astype(np.float16)
    if cfg.vision is not None:
        out["patches"] = rng.standard_normal(
            (batch, cfg.vision.n_tokens, cfg.d_model), dtype=np.float32
        ).astype(np.float16)
    return {k: torch.from_numpy(v).to(dev, torch.bfloat16) for k, v in out.items()}
