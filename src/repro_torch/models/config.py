"""Model configuration covering the ten assigned architectures.

One composable ``ModelConfig`` describes every family: dense decoder
(GQA/bias/qk_norm/SWA), MoE (shared+routed), MLA (+MTP), enc-dec (Whisper),
cross-attention VLM, hybrid Mamba+attention (Jamba), and attention-free SSM
(Mamba2).  Configs for the assigned archs live in ``repro_torch.configs.<id>``.

Copy of ``repro.models.config`` (pure Python): the port keeps its own so
that it imports nothing of the reference package.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0  # shared experts, always active
    d_ff_shared: int = 0  # width of the fused shared-expert MLP (0 → none)
    first_dense: int = 0  # leading dense layers (DeepSeek: 3)
    every: int = 1  # MoE every k-th layer (Jamba: 2)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.001


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style encoder; the conv/mel frontend is a STUB — inputs are
    precomputed frame embeddings [batch, n_frames, d_model]."""

    n_layers: int
    n_frames: int = 1500


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """Llama-3.2-Vision-style stub: precomputed patch/tile embeddings
    [batch, n_tokens, d_model]; decoder gets cross-attn every k layers."""

    n_tokens: int = 1601
    cross_attn_every: int = 5


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 → d_model // n_heads
    # attention details
    attn_bias: bool = False  # qwen1.5: QKV bias
    qk_norm: bool = False  # qwen3
    rope_theta: float = 10_000.0
    sliding_window: int = 0  # 0 → full attention (danube: SWA)
    # norms / act
    norm_type: str = "rms"  # 'rms' | 'ln' (starcoder2, whisper: ln)
    norm_eps: float = 1e-6
    act: str = "silu"  # 'silu' | 'gelu'
    glu: bool = True  # gated MLP (llama-style); False → fc-gelu-fc
    tie_embeddings: bool = False
    # families
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    mla_absorb: bool = True  # decode in latent space (False = naive baseline)
    mtp_depth: int = 0  # DeepSeek multi-token prediction modules
    ssm: SSMConfig | None = None
    layer_pattern: str = "uniform"  # 'uniform' | 'jamba'
    attn_every: int = 8  # jamba: 1 attn per 8 layers
    encoder: EncoderConfig | None = None
    vision: VisionConfig | None = None
    # numerics
    dtype: str = "bfloat16"
    # training-time upper bound for learned/rope position handling
    max_seq_len: int = 524_288

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.ssm is not None and self.layer_pattern == "uniform"

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context decode (long_500k) is admissible: SSM,
        hybrid, or sliding-window attention."""
        return self.ssm is not None or self.sliding_window > 0

    def moe_layer_ids(self) -> list[int]:
        if self.moe is None:
            return []
        return [
            i
            for i in range(self.n_layers)
            if i >= self.moe.first_dense and (i % self.moe.every == self.moe.every - 1 if self.moe.every > 1 else True)
        ]

    def params_count(self) -> dict[str, float]:
        """Approximate parameter counts (total and active) for roofline's
        MODEL_FLOPS = 6·N·D."""
        d, h = self.d_model, self.head_dim
        v = self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.mla is not None:
            m = self.mla
            attn = d * m.q_lora_rank + m.q_lora_rank * self.n_heads * (
                m.qk_nope_head_dim + m.qk_rope_head_dim
            )
            attn += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            attn += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            attn += self.n_heads * m.v_head_dim * d
        else:
            attn = d * self.n_heads * h + 2 * d * self.n_kv_heads * h + self.n_heads * h * d
        mlp_dense = d * self.d_ff * (3 if self.glu else 2)
        n_attn_layers = (
            self.n_layers
            if self.ssm is None
            else (self.n_layers // self.attn_every if self.layer_pattern == "jamba" else 0)
        )
        n_ssm_layers = 0
        if self.ssm is not None:
            n_ssm_layers = (
                self.n_layers - n_attn_layers
                if self.layer_pattern == "jamba"
                else self.n_layers
            )
        s = self.ssm
        ssm_l = 0
        if s is not None:
            d_in = s.expand * d
            ssm_l = d * 2 * d_in + d * (2 * s.n_groups * s.d_state) + d_in * d + d_in * d // s.head_dim
        total = emb + n_attn_layers * attn + n_ssm_layers * ssm_l
        active = total
        if self.moe is not None:
            mo = self.moe
            moe_ids = self.moe_layer_ids()
            n_moe = len(moe_ids)
            n_dense_mlp = self.n_layers - n_moe if self.ssm is None else (
                self.n_layers - n_moe
            )
            expert = d * mo.d_ff_expert * 3
            shared = d * (mo.d_ff_shared or mo.d_ff_expert * mo.n_shared) * 3 if mo.n_shared else 0
            router = d * mo.n_routed
            total += n_moe * (mo.n_routed * expert + shared + router)
            total += n_dense_mlp * mlp_dense
            active += n_moe * (mo.top_k * expert + shared + router)
            active += n_dense_mlp * mlp_dense
        else:
            mlp_layers = self.n_layers if self.ssm is None or self.layer_pattern == "jamba" else 0
            total += mlp_layers * mlp_dense
            active += mlp_layers * mlp_dense
        if self.encoder is not None:
            enc_l = attn + mlp_dense + attn  # self+cross handled roughly
            total += self.encoder.n_layers * enc_l
            active += self.encoder.n_layers * enc_l
        return {"total": float(total), "active": float(active)}
