"""bioreason_tpu_torch: the PyTorch/CUDA port of bioreason_tpu for NVIDIA Hopper.

The JAX package `bioreason_tpu` stays the reference; this package mirrors its
module names so every counterpart is easy to find, and imports neither JAX
nor anything of `bioreason_tpu`. Every Pallas kernel on a ported path becomes
a kernel written by hand for `sm_90a` (sources under `csrc/`, built with
`nvcc` at first use); everything else is plain PyTorch.

Layering (bottom-up):
  data/      byte text tokenizer, k-mer and char (Evo2) DNA tokenizers, chat
             template, bi-modal processor, KEGG formatting and loading, SFT
             collation
  ops/       flash attention forward and backward (CUDA kernels + plain
             versions), vocab-chunked cross-entropy, sampling
  models/    layers (with LoRA), attention dispatch, NT-v2 encoder, Evo2
             (StripedHyena-2) tower, Qwen3 decoder, fusion (with the
             training forward)
  generate/  prefill + decode generation engine
  train/     LoRA, trainable selection, AdamW + schedule, SFT trainer,
             checkpoints, batching
  serve.py   micro-batching HTTP inference server
  cli/       train_sft (SFT) and reason (GRPO) entry points
  utils/     devices, the Evo2 checkpoint importer

Entry points run on `cuda` unless the caller passes `device="cpu"`; asking
for CUDA where there is none raises.
"""

__version__ = "0.1.0"
