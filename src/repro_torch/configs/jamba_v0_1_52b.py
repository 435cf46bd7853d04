"""jamba-v0.1-52b [hybrid] — arXiv:2403.19887 (Mamba+attn 1:7, MoE).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, blocks of 8 layers
with 1 attention : 7 mamba, MoE (16 experts top-2) every other layer.
Mamba sublayers use the SSD formulation with d_state=16 (subsumes the
Mamba-1 block — DESIGN.md §2).  Hybrid → runs long_500k.
"""

from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    layer_pattern="jamba",
    attn_every=8,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=256),
    moe=MoEConfig(n_routed=16, top_k=2, d_ff_expert=14336, every=2),
)
