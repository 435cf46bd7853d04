"""qwen3-32b [dense] — hf:Qwen/Qwen3-32B family (qk_norm, GQA).

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936, head_dim=128
(explicit in the Qwen3 family), qk_norm, no attention bias.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
