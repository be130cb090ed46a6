"""The port's GRPO learning check (slow; enable with BIOREASON_SLOW=1): the
counterpart of tests/test_grpo_learning_slow.py.

A rigged reward (the count of the letter 'a' in a completion) must rise
under the port's GRPO: the clipped-surrogate loss end to end through
rollout -> reward -> group-normalized advantage -> update. Same tiny
`FusionConfig`, reward, `GRPOConfig` and 30 steps as the JAX test, on the
CPU in fp32; the assertion is the JAX test's own."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(not os.environ.get("BIOREASON_SLOW"),
                                reason="slow: set BIOREASON_SLOW=1")


def letter_reward(prompts, completions, answer=None, **kw):
    return [min(c.count("a"), 8) / 4.0 for c in completions]


def test_rigged_reward_increases():
    from bioreason_tpu_torch.config import FusionConfig, GRPOConfig, OptimConfig, \
        SamplingConfig
    from bioreason_tpu_torch.data import BioProcessor, ByteTextTokenizer, KmerTokenizer
    from bioreason_tpu_torch.data.kegg import format_kegg_prompt_only, synthetic_kegg_items
    from bioreason_tpu_torch.train.grpo import GRPOTrainer

    tok = ByteTextTokenizer()
    proc = BioProcessor(tok, KmerTokenizer())
    fusion = FusionConfig.tiny(text_vocab=tok.vocab_size, dna_pad_token_id=tok.dna_pad_id)
    cfg = GRPOConfig(num_generations=4, batch_size=8, beta=0.0, num_iterations=1,
                     max_completion_length=16,
                     sampling=SamplingConfig(temperature=1.0, top_k=40, top_p=1.0,
                                             max_new_tokens=16),
                     optim=OptimConfig(learning_rate=3e-3, total_steps=40, warmup_ratio=0.0),
                     lora=None, seed=0)
    trainer = GRPOTrainer(fusion, cfg, proc, [letter_reward], device="cpu")
    prompts = [format_kegg_prompt_only(it) for it in synthetic_kegg_items(2, seq_len=24)]
    items = [p for p in prompts for _ in range(4)]
    rewards = [trainer.step(items)["reward"] for _ in range(30)]
    early, late = np.mean(rewards[:5]), np.mean(rewards[-5:])
    print(f"rigged reward: early {early} late {late}")
    assert late > early * 1.5, f"reward did not improve: {early} -> {late}"
