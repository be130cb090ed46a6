"""Configuration dataclasses of the port (the serving, SFT and GRPO subset
of bioreason_tpu/config.py, with the same field names and presets).

Presets mirror the reference model zoo: the Qwen3 0.6B / 1.7B / 4B
decoders and the Qwen3-30B-A3B mixture of experts, and the DNA towers,
NT-v2 50M / 250M / 500M and Evo2-1B, at their published widths, plus
`tiny` test sizes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class DecoderConfig:
    """Qwen3-style causal LLM tower."""
    vocab_size: int = 300            # ByteTextTokenizer default; Qwen3 real: 151936
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_layers: int = 28
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    attention_impl: str = "auto"     # 'auto' | 'xla' (plain) | 'pallas' (kernel)
    remat: bool = True               # per-layer activation checkpointing in training
    remat_policy: str = "full"       # 'full' | 'dots' (save the dense matmuls' outputs)
    dtype: str = "bfloat16"          # compute dtype (frozen weights are stored in it)
    # W8A8 serving mode: denses whose weights are int8 (train/quant.py)
    # also quantize their activations per token and take an int8 x int8 ->
    # int32 product (layers._w8a8_dot); float weights ignore it. Serving
    # only; the grouped and the continuous decode steps turn it off
    act_int8: bool = False
    # Mixture-of-Experts FFN (Qwen3-MoE family, e.g. 30B-A3B). 0 keeps the
    # dense SwiGLU; above 0 EVERY layer is sparse (the HF family's
    # decoder_sparse_step=1, mlp_only_layers=[]): `layers.moe_apply`
    num_experts: int = 0
    num_experts_per_tok: int = 8
    moe_intermediate_size: int = 0
    norm_topk_prob: bool = True
    # tokens per expert C = max(k, ceil(capacity_factor * k * N / E)), N the
    # rows of the call; tokens past C drop. >= E / k routes losslessly
    moe_capacity_factor: float = 1.25

    @classmethod
    def tiny(cls, vocab_size: int = 300) -> "DecoderConfig":
        return cls(vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
                   num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                   remat=False, attention_impl="xla", dtype="float32")

    @classmethod
    def qwen3_0_6b(cls, vocab_size: int = 151936) -> "DecoderConfig":
        return cls(vocab_size=vocab_size, hidden_size=1024, intermediate_size=3072,
                   num_layers=28, num_heads=16, num_kv_heads=8, head_dim=128)

    @classmethod
    def qwen3_1_7b(cls, vocab_size: int = 151936) -> "DecoderConfig":
        return cls(vocab_size=vocab_size, hidden_size=2048, intermediate_size=6144,
                   num_layers=28, num_heads=16, num_kv_heads=8, head_dim=128)

    @classmethod
    def qwen3_4b(cls, vocab_size: int = 151936) -> "DecoderConfig":
        return cls(vocab_size=vocab_size, hidden_size=2560, intermediate_size=9728,
                   num_layers=36, num_heads=32, num_kv_heads=8, head_dim=128)

    @classmethod
    def tiny_moe(cls, vocab_size: int = 300) -> "DecoderConfig":
        return cls(vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
                   num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                   num_experts=4, num_experts_per_tok=2,
                   moe_intermediate_size=64, remat=False,
                   attention_impl="xla", dtype="float32")

    @classmethod
    def qwen3_30b_a3b(cls, vocab_size: int = 151936) -> "DecoderConfig":
        """Qwen3-30B-A3B (MoE): 128 experts, 8 active, 3B active params."""
        return cls(vocab_size=vocab_size, hidden_size=2048,
                   intermediate_size=0, num_layers=48, num_heads=32,
                   num_kv_heads=4, head_dim=128, tie_word_embeddings=False,
                   num_experts=128, num_experts_per_tok=8,
                   moe_intermediate_size=768, norm_topk_prob=True)


@dataclass(frozen=True)
class EncoderConfig:
    """NT-v2-style bidirectional DNA encoder (ESM architecture family)."""
    vocab_size: int = 4107           # KmerTokenizer default vocab
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-12
    use_swiglu: bool = True          # NT-v2 uses SwiGLU (gated MLP); ESM2: gelu
    attn_bias: bool = True           # ESM q/k/v/o denses carry biases
    mlp_bias: bool = False           # NT-v2 add_bias_fnn=False; plain ESM2: True
    token_dropout: bool = False      # ESM-style inference-time embed rescale
    mask_token_id: int = 2           # <mask> id (KmerTokenizer layout)
    # 'auto' | 'xla' | 'pallas' as the decoder's, or 'local:<W>': banded
    # attention, |i - j| <= W, O(T * W) for long DNA (ops/local_attention.py)
    attention_impl: str = "auto"
    remat: bool = True
    remat_policy: str = "full"       # see DecoderConfig
    dtype: str = "bfloat16"
    act_int8: bool = False           # W8A8 serving mode (see DecoderConfig)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def tiny(cls, vocab_size: int = 4107) -> "EncoderConfig":
        return cls(vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
                   num_layers=2, num_heads=4, remat=False, attention_impl="xla",
                   dtype="float32")

    @classmethod
    def nt_v2_50m(cls) -> "EncoderConfig":
        return cls(hidden_size=512, intermediate_size=2048, num_layers=22, num_heads=16)

    @classmethod
    def nt_v2_250m(cls) -> "EncoderConfig":
        return cls(hidden_size=768, intermediate_size=3072, num_layers=29, num_heads=12)

    @classmethod
    def nt_v2_500m(cls) -> "EncoderConfig":
        return cls(hidden_size=1024, intermediate_size=4096, num_layers=29, num_heads=16)


@dataclass(frozen=True)
class HyenaConfig:
    """Evo2/StripedHyena-2-style hybrid DNA tower (models/evo2.py).

    Non-attention layers cycle through the three hyena flavors (short
    explicit / medium regularized / long implicit); an attention block
    replaces every `attn_every`-th layer (the striped pattern).
    `layer_flavors` pins the per-layer operators of a real checkpoint (the
    importer derives them from the weight keys)."""
    vocab_size: int = 512
    hidden_size: int = 1920
    intermediate_size: int = 5120
    num_layers: int = 25
    num_heads: int = 15
    short_filter_len: int = 3        # depthwise conv on the fused projection
    se_filter_len: int = 7           # hyena_se explicit filter
    medium_filter_len: int = 128     # hyena_mr explicit filter (decay-modulated)
    li_order: int = 16               # hyena_li modal order (poles/residues)
    attn_every: int = 7              # attention block every Nth layer
    flavor_cycle: Tuple[str, ...] = ("se", "mr", "li")
    layer_flavors: Optional[Tuple[str, ...]] = None   # explicit per-layer override
    mlp_activation: str = "gelu"     # vortex ParallelGatedMLP default
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    attention_impl: str = "auto"     # 'auto' | 'xla' | 'pallas'; causal, so no 'local:'
    remat: bool = True
    dtype: str = "bfloat16"
    embedding_tap_layer: int = -1    # named-layer embedding tap (dna_llm.py:127-146)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def flavor(self, layer_idx: int) -> str:
        """Operator of layer `layer_idx`: 'attn' | 'se' | 'mr' | 'li'."""
        if self.layer_flavors is not None:
            return self.layer_flavors[layer_idx]
        if (layer_idx + 1) % self.attn_every == 0:
            return "attn"
        n_prior_attn = layer_idx // self.attn_every
        return self.flavor_cycle[(layer_idx - n_prior_attn) % len(self.flavor_cycle)]

    @classmethod
    def tiny(cls) -> "HyenaConfig":
        return cls(hidden_size=64, intermediate_size=128, num_layers=4, num_heads=4,
                   attn_every=4, li_order=4, medium_filter_len=16,
                   remat=False, attention_impl="xla", dtype="float32")

    @classmethod
    def evo2_1b(cls) -> "HyenaConfig":
        return cls(hidden_size=1920, intermediate_size=5120, num_layers=25, num_heads=15)


@dataclass(frozen=True)
class FusionConfig:
    """DNA-LLM fusion model (reference DNALLMModel, dna_llm.py:18-101)."""
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    dna_pad_token_id: int = 260       # ByteTextTokenizer's <|dna_pad|>
    max_length_dna: int = 2048
    max_length_text: int = 512
    encoder_kind: str = "nt"          # 'nt' | 'evo2': which DNA tower runs
    hyena: Optional[HyenaConfig] = None   # the Evo2 tower's config ('evo2')
    ce_save_logits: bool = False      # keep bf16 chunk logits for the CE backward
                                      # (ops/fused_ce.py) instead of recomputing

    @property
    def dna_tower(self):
        """The config of the DNA tower that runs: `hyena` for 'evo2', else
        `encoder` (an Evo2 config still carries an unused `encoder`)."""
        return self.hyena if self.encoder_kind == "evo2" else self.encoder

    @classmethod
    def tiny(cls, text_vocab: int = 300, dna_pad_token_id: int = 260) -> "FusionConfig":
        return cls(decoder=DecoderConfig.tiny(text_vocab), encoder=EncoderConfig.tiny(),
                   dna_pad_token_id=dna_pad_token_id)


@dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.6         # grpo_config.py:192-209 / train_dna_qwen.py:284-289
    top_p: float = 0.95
    top_k: int = 20
    max_new_tokens: int = 800



@dataclass(frozen=True)
class LoRAConfig:
    r: int = 32
    alpha: int = 64
    dropout: float = 0.05
    # exclude embeddings, lm_head and the DNA tower (reference
    # train_dna_qwen.py:103-134, grpo_trainer.py:262-279)
    exclude_patterns: Tuple[str, ...] = ("embed", "lm_head", "encoder", "dna_projection")


@dataclass(frozen=True)
class OptimConfig:
    learning_rate: float = 2e-5
    weight_decay: float = 0.01
    warmup_ratio: float = 0.1        # cosine with 10% warmup (train_dna_qwen.py:393-411)
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    grad_clip: float = 1.0
    total_steps: int = 1000
    # skip steps whose grads contain non-finite values (bad-batch guard;
    # gives up after this many consecutive bad steps). 0 disables.
    skip_nonfinite_after: int = 100


@dataclass(frozen=True)
class SFTConfig:
    batch_size: int = 4
    grad_accum_steps: int = 1        # reference pl.Trainer accumulate_grad_batches
    max_length_text: int = 512
    max_length_dna: int = 2048
    bucket: int = 128
    optim: OptimConfig = field(default_factory=OptimConfig)
    lora: Optional[LoRAConfig] = field(default_factory=LoRAConfig)
    train_projection: bool = True    # projection always trainable (dna_llm quirk list)
    freeze_encoder: bool = True      # reference de-facto freezes DNA tower
    # frozen >=2-D leaves need no fp32 master copy; "int8" (QLoRA) stores the
    # frozen towers' denses int8 (train/quant.py) and the other frozen float
    # leaves bf16; it needs LoRA and a frozen encoder (the trainer checks)
    frozen_dtype: str = "bfloat16"
    pp_micro: int = 0                # pipeline parallelism: not ported (raises)
    # detached focal CE weighting on the TRAIN loss only (eval stays plain CE)
    focal_gamma: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.pp_micro > 0:
            raise NotImplementedError(
                "SFTConfig.pp_micro > 0: pipeline parallelism is not ported yet "
                "(ROADMAP.md, queue 1: multi-device)")


@dataclass(frozen=True)
class GRPOConfig:
    num_generations: int = 8         # G (grpo_config.py:170)
    max_prompt_length: Optional[int] = None  # keep LAST N prompt tokens
                                     # (grpo_config.py:174-177; TRL slices
                                     # prompt_ids[:, -N:]). Raises if it would
                                     # cut <|dna_pad|> tokens (splice check).
    max_completion_length: int = 800
    num_iterations: int = 1          # mu (grpo_config.py:298)
    beta: float = 0.04               # KL coeff (grpo_config.py:291)
    epsilon: float = 0.2             # clip (grpo_config.py:302)
    epsilon_high: Optional[float] = None  # DAPO asymmetric clip (grpo_config.py:304-312)
    reward_weights: Optional[Tuple[float, ...]] = None
    # regex every completion must match (vLLM guided decoding,
    # grpo_config.py:278-280), compiled once by the trainer (generate/guided.py)
    guided_decoding_regex: Optional[str] = None
    rollout_int8: bool = False       # rollouts on int8 weights, embedding and head
    rollout_kv_int8: bool = False    # rollouts on an int8 KV cache
    sampling: SamplingConfig = field(default_factory=SamplingConfig)
    batch_size: int = 8              # prompts*G per step (must be divisible by G)
    # each step() is a micro-step of batch_size rollouts; the optimizer
    # applies once every grad_accum_steps calls with the running-mean
    # gradient, and each accumulation slot keeps its own rollout buffer
    # (grpo_trainer.py:399-403)
    grad_accum_steps: int = 1
    frozen_dtype: str = "bfloat16"   # "int8": QLoRA, as SFTConfig's (needs LoRA)
    optim: OptimConfig = field(default_factory=lambda: OptimConfig(learning_rate=5e-6))
    lora: Optional[LoRAConfig] = field(default_factory=LoRAConfig)
    # TR-DPO-style ref sync (grpo_config.py:320-341)
    sync_ref_model: bool = False
    ref_model_mixup_alpha: float = 0.6
    ref_model_sync_steps: int = 512
    seed: int = 0
