"""Model configuration — one dataclass covering every assigned family.

The 10 assigned architectures span dense transformers (GQA / sliding-window /
local-global alternation / logit softcaps), MoE (GShard top-k, shared experts,
DeepSeek MLA), pure SSM (Mamba2 SSD), hybrid (Zamba2: Mamba2 backbone with a
*shared* attention block), and modality backbones (MusicGen audio codes,
LLaVA vision-prefix).  One config type keeps the runtime/launcher generic:
every feature is off by default and enabled per-arch in repro/configs/.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

BlockKind = Literal["attn", "mamba"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # -- identity ------------------------------------------------------------
    name: str = "model"
    family: str = "dense"          # dense | moe | ssm | hybrid | audio | vlm
    # -- trunk ----------------------------------------------------------------
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2               # query heads (0 for attention-free archs)
    n_kv_heads: int = 2            # GQA kv heads
    d_ff: int = 256                # MLP hidden (per-expert hidden when MoE)
    vocab_size: int = 256
    head_dim: int = 0              # 0 -> d_model // n_heads
    max_seq_len: int = 4096
    # -- attention flavour -----------------------------------------------------
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0         # stablelm2: partial rotary (0.25)
    sliding_window: int = 0            # >0 -> SWA on every attn layer (danube3)
    local_global: bool = False         # gemma2: alternate local/global layers
    local_window: int = 4096           # window of the local layers
    attn_logit_softcap: float = 0.0    # gemma2: tanh softcap on attn logits
    final_logit_softcap: float = 0.0   # gemma2: tanh softcap on LM logits
    query_scale: float = 0.0           # 0 -> 1/sqrt(head_dim)
    # TP compute padding (beyond-paper perf lever): run attention with the
    # head axes padded up to a multiple of the model-axis size so q/o
    # projections shard 16-way.  Padded heads are MASKED after attention, so
    # the math is exactly the published n_heads model (their params receive
    # zero gradient and stay at init).  0 = off.
    pad_q_heads_to: int = 0
    pad_kv_heads_to: int = 0
    # -- MLA (DeepSeek-V2) ------------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0               # 0 -> no query compression
    rope_head_dim: int = 64            # decoupled RoPE key/query dims
    nope_head_dim: int = 128           # per-head non-rotary qk dim
    v_head_dim: int = 128
    # -- MoE ---------------------------------------------------------------------
    n_experts: int = 0                 # routed experts (0 -> dense MLP)
    n_shared_experts: int = 0
    experts_per_token: int = 0         # top-k
    moe_d_ff: int = 0                  # routed-expert hidden (0 -> d_ff)
    shared_d_ff: int = 0               # shared-expert hidden (0 -> moe_d_ff)
    first_dense_layers: int = 0        # DeepSeek: leading dense layers
    dense_d_ff: int = 0                # hidden of those dense layers (0 -> d_ff)
    router_noise: float = 0.0
    route_group_limit: int = 0         # DeepSeek-V2 device-limited routing:
                                       # experts from <= M device groups
    capacity_factor: float = 1.25      # expert capacity = cf * tokens/expert
    aux_loss_weight: float = 0.001     # load-balance loss
    # -- SSM (Mamba2 SSD) ----------------------------------------------------------
    ssm_state: int = 0                 # N (state size per head); 0 -> no ssm
    ssm_heads: int = 0                 # 0 -> d_inner // ssm_head_dim
    ssm_head_dim: int = 64             # P
    ssm_expand: int = 2                # d_inner = expand * d_model
    ssm_groups: int = 1                # B/C groups (like kv heads)
    ssm_chunk: int = 128               # SSD chunk length Q
    conv_width: int = 4
    # -- hybrid (Zamba2) --------------------------------------------------------
    hybrid_attn_every: int = 0         # shared attn block after every k mamba layers
    # -- modality backbones --------------------------------------------------------
    n_codebooks: int = 0               # musicgen: parallel EnCodec streams
    vision_tokens: int = 0             # llava: prefix patch-embedding slots
    # -- numerics / misc ---------------------------------------------------------
    act: str = "silu"                  # silu | gelu
    gated_mlp: bool = True             # False: classic 2-matrix MLP (musicgen)
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # gemma-style extras
    post_norms: bool = False           # gemma2: post-attn/post-mlp RMSNorms
    embed_scale: bool = False          # gemma2: scale embeddings by sqrt(d_model)

    # ------------------------------------------------------------------------
    def __post_init__(self):
        if self.family not in ("dense", "moe", "ssm", "hybrid", "audio", "vlm"):
            raise ValueError(f"unknown family {self.family!r}")
        if self.n_heads and self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.pad_q_heads_to or self.pad_kv_heads_to:
            hq = self.pad_q_heads_to or self.n_heads
            hkv = self.pad_kv_heads_to or self.n_kv_heads
            if hq % hkv:
                raise ValueError("padded q heads must be multiple of kv")
            g = hq // hkv
            # real q heads must only read REAL kv heads
            if (self.n_heads - 1) // g >= self.n_kv_heads:
                raise ValueError("padding maps real q heads to padded kv")
        if self.n_experts and not self.experts_per_token:
            raise ValueError("MoE needs experts_per_token")
        if self.family in ("ssm", "hybrid") and not self.ssm_state:
            raise ValueError("SSM family needs ssm_state > 0")

    # -- derived sizes ---------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_q_heads(self) -> int:
        return self.pad_q_heads_to or self.n_heads

    @property
    def padded_kv_heads(self) -> int:
        return self.pad_kv_heads_to or self.n_kv_heads

    @property
    def heads_padded(self) -> bool:
        return (self.padded_q_heads != self.n_heads
                or self.padded_kv_heads != self.n_kv_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def resolved_ssm_heads(self) -> int:
        return self.ssm_heads or (self.d_inner // self.ssm_head_dim)

    @property
    def resolved_moe_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def resolved_shared_d_ff(self) -> int:
        return self.shared_d_ff or self.resolved_moe_d_ff

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def uses_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def uses_moe(self) -> bool:
        return self.n_experts > 0

    def layer_is_local(self, layer: int) -> bool:
        """gemma2 pattern: even layers local (sliding window), odd global."""
        return self.local_global and layer % 2 == 0

    def window_for_layer(self, layer: int) -> int:
        """Effective attention window for ``layer`` (0 = full causal)."""
        if self.local_global:
            return self.local_window if self.layer_is_local(layer) else 0
        return self.sliding_window

    @property
    def sub_quadratic(self) -> bool:
        """True when decode state does NOT grow with context without bound:
        SSM/hybrid (constant state) or SWA on every layer (window-clipped)."""
        if self.family == "ssm":
            return True
        if self.family == "hybrid":
            # shared attn layers still attend globally unless windowed
            return self.sliding_window > 0 or self.hybrid_attn_every == 0 or True
        return self.sliding_window > 0 and not self.local_global

    # -- parameter counting (for 6ND roofline + powermodel) --------------------
    def param_count(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        d, h = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        per_layer = 0
        attn_layers = 0
        mamba_layers = 0
        total = 0

        def attn_params() -> int:
            if self.use_mla:
                q_in = self.q_lora_rank or d
                p = 0
                if self.q_lora_rank:
                    p += d * self.q_lora_rank
                p += q_in * n_q * (self.nope_head_dim + self.rope_head_dim)
                p += d * (self.kv_lora_rank + self.rope_head_dim)
                p += self.kv_lora_rank * n_q * (self.nope_head_dim + self.v_head_dim)
                p += n_q * self.v_head_dim * d
                return p
            return d * n_q * h + 2 * d * n_kv * h + n_q * h * d

        def mlp_params(hidden: int) -> int:
            per = 3 if self.gated_mlp else 2   # (gate,) up, down
            return per * d * hidden

        def moe_params() -> int:
            p = d * self.n_experts                      # router
            p += self.n_experts * mlp_params(self.resolved_moe_d_ff)
            p += self.n_shared_experts * mlp_params(self.resolved_shared_d_ff)
            return p

        def mamba_params() -> int:
            di, nh, ns = self.d_inner, self.resolved_ssm_heads, self.ssm_state
            g = self.ssm_groups
            p = d * (2 * di + 2 * g * ns + nh)          # in_proj: z, x, B, C, dt
            p += self.conv_width * (di + 2 * g * ns)    # conv over x, B, C
            p += 2 * nh + di                            # A_log, D, gated-norm scale
            p += di * d                                 # out_proj
            return p

        for layer in range(self.n_layers):
            if self.family == "ssm":
                total += mamba_params()
                mamba_layers += 1
                continue
            if self.family == "hybrid":
                total += mamba_params()
                mamba_layers += 1
                continue
            # transformer families
            total += attn_params()
            if self.uses_moe and layer >= self.first_dense_layers:
                total += moe_params()
            else:
                total += mlp_params(self.d_ff)
            total += 2 * d                               # pre-norms
            if self.post_norms:
                total += 2 * d
            attn_layers += 1

        if self.family == "hybrid" and self.hybrid_attn_every:
            # one SHARED attention+MLP block (params counted once)
            total += attn_params() + mlp_params(self.d_ff) + 2 * d
            total += 2 * d * d                           # fused-input projections

        total += d                                       # final norm
        n_emb_vocab = self.vocab_size * d
        if self.n_codebooks:
            total += self.n_codebooks * n_emb_vocab      # per-codebook embeds
            total += self.n_codebooks * n_emb_vocab      # per-codebook heads
        else:
            total += n_emb_vocab
            if not self.tie_embeddings:
                total += n_emb_vocab
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k + shared experts only)."""
        if not self.uses_moe:
            return self.param_count()
        full = self.param_count()
        moe_layers = self.n_layers - self.first_dense_layers
        inactive = (self.n_experts - self.experts_per_token)
        per_expert = 3 * self.d_model * self.resolved_moe_d_ff
        return int(full - moe_layers * inactive * per_expert)
