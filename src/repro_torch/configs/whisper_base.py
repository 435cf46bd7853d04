"""whisper-base [audio] — arXiv:2212.04356 (enc-dec).

6L d_model=512 8H d_ff=2048 vocab=51865, encoder-decoder; the conv/mel
frontend is a STUB: ``input_specs()`` provides precomputed frame embeddings
[batch, 1500, 512].  Decoder self-attention uses RoPE here (adaptation from
Whisper's learned positions, noted in DESIGN.md) so 32k decode shapes are
well-defined for the backbone.
"""

from repro_torch.models.config import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    norm_type="ln",
    act="gelu",
    glu=False,
    encoder=EncoderConfig(n_layers=6, n_frames=1500),
)
