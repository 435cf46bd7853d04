"""deepseek-v3-671b [moe] — arXiv:2412.19437 (MLA, 1 shared + 256 routed
top-8, MTP).

61L d_model=7168 128H, MLA (q_lora 1536, kv_lora 512, qk_nope 128, qk_rope 64,
v_head 128), MoE 256 routed experts top-8 + 1 shared (d_ff_expert 2048),
first 3 layers dense (d_ff 18432), vocab=129280, 1 MTP module.
"""

from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,  # dense layers
    vocab_size=129280,
    rope_theta=10_000.0,
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_routed=256,
        top_k=8,
        d_ff_expert=2048,
        n_shared=1,
        d_ff_shared=2048,
        first_dense=3,
    ),
    mtp_depth=1,
)
