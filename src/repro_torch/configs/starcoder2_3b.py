"""starcoder2-3b [dense] — arXiv:2402.19173 (GQA, RoPE).

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152, LayerNorm + bias,
plain (non-gated) GELU MLP, attention bias.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    norm_type="ln",
    act="gelu",
    glu=False,
    attn_bias=True,
    rope_theta=100_000.0,
)
