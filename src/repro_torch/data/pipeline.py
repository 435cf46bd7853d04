"""Model-input stubs (the ``stub_inputs`` part of ``repro.data.pipeline``).

The token pipeline (``TokenPipeline``) waits for the training port (ROADMAP
A.10).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


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
