"""qwen2-moe-a2.7b [moe] — hf:Qwen/Qwen1.5-MoE-A2.7B.

24L d_model=2048 16H (kv=16) vocab=151936, MoE: 60 routed experts top-4
(d_ff_expert=1408) + 4 shared experts (fused shared MLP width 5632),
QKV bias (qwen1.5 family).  60 experts pad to 64 on a 16-way EP axis.
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    attn_bias=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(
        n_routed=60,
        top_k=4,
        d_ff_expert=1408,
        n_shared=4,
        d_ff_shared=5632,
    ),
)
