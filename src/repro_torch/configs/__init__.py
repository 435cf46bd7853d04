"""Architecture registry + reduced smoke configs.

``--arch <id>`` everywhere resolves through ``get_config``.  ``reduce_config``
shrinks any config to a CPU-smoke scale of the SAME family (pattern, MoE,
MLA, SSM structure preserved; widths/depths/vocab tiny).

Copy of ``repro.configs`` (data only): ``get_config`` and ``reduce_config``
are unchanged, so the port's reduced configs equal the reference's field
for field.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    deepseek_v3_671b,
    h2o_danube_3_4b,
    jamba_v0_1_52b,
    llama_3_2_vision_11b,
    mamba2_1_3b,
    qwen1_5_0_5b,
    qwen2_moe_a2_7b,
    qwen3_32b,
    starcoder2_3b,
    whisper_base,
)
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable  # noqa: F401
from repro_torch.models.config import (
    EncoderConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    VisionConfig,
)

ARCHS: dict[str, ModelConfig] = {
    "qwen1.5-0.5b": qwen1_5_0_5b.CONFIG,
    "qwen3-32b": qwen3_32b.CONFIG,
    "h2o-danube-3-4b": h2o_danube_3_4b.CONFIG,
    "starcoder2-3b": starcoder2_3b.CONFIG,
    "whisper-base": whisper_base.CONFIG,
    "deepseek-v3-671b": deepseek_v3_671b.CONFIG,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b.CONFIG,
    "llama-3.2-vision-11b": llama_3_2_vision_11b.CONFIG,
    "jamba-v0.1-52b": jamba_v0_1_52b.CONFIG,
    "mamba2-1.3b": mamba2_1_3b.CONFIG,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    kw: dict = {}
    d_model = 64
    n_heads, n_kv = 4, max(1, min(cfg.n_kv_heads * 4 // max(cfg.n_heads, 1), 4))
    if cfg.layer_pattern == "jamba":
        n_layers = cfg.attn_every  # one block
    elif cfg.vision is not None:
        n_layers = cfg.vision.cross_attn_every
        kw["vision"] = VisionConfig(n_tokens=8, cross_attn_every=cfg.vision.cross_attn_every)
    elif cfg.moe is not None and cfg.moe.first_dense:
        n_layers = 3  # 1 dense + 2 moe (first_dense reduced to 1 below)
    else:
        n_layers = 2
    if cfg.encoder is not None:
        kw["encoder"] = EncoderConfig(n_layers=2, n_frames=16)
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            n_routed=4,
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=96,
            n_shared=min(cfg.moe.n_shared, 1),
            d_ff_shared=96 if cfg.moe.n_shared else 0,
            first_dense=1 if cfg.moe.first_dense else 0,
            every=cfg.moe.every,
        )
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(
            q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16,
        )
        kw["d_head"] = 0
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(
            d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1, chunk=16
        )
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=kw.pop("d_head", 16),
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256,
        sliding_window=min(cfg.sliding_window, 8) if cfg.sliding_window else 0,
        max_seq_len=128,
        **kw,
    )
