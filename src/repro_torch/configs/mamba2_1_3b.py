"""mamba2-1.3b [ssm] — arXiv:2405.21060 (SSD, attention-free).

48L d_model=2048 vocab=50280, ssm_state=128, expand=2 (d_inner 4096),
head_dim 64 → 64 SSD heads, no attention, no MLP (the Mamba block IS the
layer).  O(1) state → runs long_500k.
"""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    n_layers=48,
    d_model=2048,
    n_heads=1,  # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=256),
)
