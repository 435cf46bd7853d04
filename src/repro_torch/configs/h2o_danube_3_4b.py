"""h2o-danube-3-4b [dense] — arXiv:2401.16818 (llama+mistral mix, SWA).

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, sliding-window
attention (mistral-style, window 4096) → sub-quadratic: runs long_500k.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=10_000.0,
)
