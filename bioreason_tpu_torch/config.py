"""Configuration dataclasses of the port (the serving subset of
bioreason_tpu/config.py, with the same field names and presets).

Presets mirror the reference model zoo: the Qwen3-0.6B decoder and the
NT-v2-500M encoder at their published widths, plus `tiny` test sizes.
"""

from __future__ import annotations

from dataclasses import dataclass, field


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
    dtype: str = "bfloat16"          # storage and compute dtype of the weights

    @classmethod
    def tiny(cls, vocab_size: int = 300) -> "DecoderConfig":
        return cls(vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
                   num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                   attention_impl="xla", dtype="float32")

    @classmethod
    def qwen3_0_6b(cls, vocab_size: int = 151936) -> "DecoderConfig":
        return cls(vocab_size=vocab_size, hidden_size=1024, intermediate_size=3072,
                   num_layers=28, num_heads=16, num_kv_heads=8, head_dim=128)


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
    attention_impl: str = "auto"
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def tiny(cls, vocab_size: int = 4107) -> "EncoderConfig":
        return cls(vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
                   num_layers=2, num_heads=4, attention_impl="xla",
                   dtype="float32")

    @classmethod
    def nt_v2_500m(cls) -> "EncoderConfig":
        return cls(hidden_size=1024, intermediate_size=4096, num_layers=29, num_heads=16)


@dataclass(frozen=True)
class FusionConfig:
    """DNA-LLM fusion model (reference DNALLMModel, dna_llm.py:18-101)."""
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    dna_pad_token_id: int = 260       # ByteTextTokenizer's <|dna_pad|>
    max_length_dna: int = 2048
    max_length_text: int = 512

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

