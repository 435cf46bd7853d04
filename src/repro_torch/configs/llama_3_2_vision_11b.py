"""llama-3.2-vision-11b [vlm] — hf:meta-llama/Llama-3.2-11B-Vision.

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; cross-attention to
image embeddings every 5th layer.  The vision tower is a STUB:
``input_specs()`` provides precomputed patch/tile embeddings
[batch, 1601, 4096].
"""

from repro_torch.models.config import ModelConfig, VisionConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    vision=VisionConfig(n_tokens=1601, cross_attn_every=5),
)
