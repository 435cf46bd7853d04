"""qwen1.5-0.5b [dense] — hf:Qwen/Qwen1.5-0.5B.

24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936, QKV bias, tied
embeddings (0.5B ties lm_head to embed).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    attn_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
