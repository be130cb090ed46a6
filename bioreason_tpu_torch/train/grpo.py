"""GRPO trainer: grouped rollouts + the group-normalized clipped-surrogate
loss (the port of bioreason_tpu/train/grpo.py, on one device: no mesh).

One `step` is:
  rollout   - the prompts of `items` (each repeated G times contiguously,
              dataflow.repeat_random_indices) prefilled once per group, G
              completions sampled from the shared prompt cache by the LoRA
              policy as it is (generate/engine.py, `group_size`), constrained
              to `guided_decoding_regex` when it is set (generate/guided.py:
              the spec is compiled once, at construction);
  logps     - the reference policy's and, with num_iterations > 1, the
              current policy's per-token log-probs of the completions
              (`per_token_logps` under no_grad), queued on the card before
              the host decodes and scores;
  rewards   - host-side rule functions on the decoded strings
              (train/rewards.py), weighted sum; advantages
              (r - mean_g) / (std_g + 1e-4) per group, population std;
  update    - PPO-style clipped surrogate with the optional DAPO
              `epsilon_high`, the k3 KL against the reference log-probs,
              completion-masked per-sequence mean; AdamW (train/optim.py),
              with a mean gradient over `grad_accum_steps` micro-steps.

The reference policy is the model with its adapters off and its other
trainable parameters (in LoRA mode the DNA projection) as they were at the
start, as the JAX trainer's LoRA-stripped copy of the initial trainable
leaves is. `_make_ref` builds it as a second module tree that holds the
policy's frozen tensors themselves (no copy of the frozen weights, int8 or
float) and copies of the trainable ones without the adapters. With
`sync_ref_model` (TR-DPO) the mixup is arithmetic on every weight, so each
sync gives the reference weights of its own, as the reference does.

QLoRA (`frozen_dtype="int8"`, JAX train/grpo.py:123-166) stores the frozen
towers' denses int8 under fp32 adapters; `rollout_int8` rolls out on int8
weights, embedding and head (`rollout_model`), sharing the training
model's int8 tensors where it has them; `rollout_kv_int8` gives the engine
an int8 KV cache (the grouped decode reads it with its scales).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from bioreason_tpu_torch.config import FusionConfig, GRPOConfig
from bioreason_tpu_torch.data.chat_template import apply_chat_template
from bioreason_tpu_torch.data.processor import BioProcessor, ProcessorOutput
from bioreason_tpu_torch.generate.engine import GenerationEngine
from bioreason_tpu_torch.models.fusion import (FusionModel, fused_input_embeddings,
                                               init_fusion, validate_splice)
from bioreason_tpu_torch.models.layers import has_adapter, is_int8
from bioreason_tpu_torch.models.qwen3 import decoder_forward
from bioreason_tpu_torch.ops.fused_ce import chunked_token_logps
from bioreason_tpu_torch.train import trainable as T
from bioreason_tpu_torch.train.checkpoint import AsyncSaver, load_checkpoint, save_checkpoint
from bioreason_tpu_torch.train.lora import attach_lora, has_lora, merged_weight, strip_lora
from bioreason_tpu_torch.train.optim import AdamW
from bioreason_tpu_torch.train.quant import (quantize_frozen_int8, quantize_kernel_int8,
                                             store_int8)
from bioreason_tpu_torch.train.trainable import shared_copy
from bioreason_tpu_torch.utils.devices import resolve_device, torch_dtype


def _repeat_prompt_batch(out: ProcessorOutput, g: int) -> ProcessorOutput:
    """Repeat a ProcessorOutput G times with group-contiguous rows. DNA rows
    are regrouped so that the k-th valid DNA token still matches the k-th
    <|dna_pad|> placeholder of the repeated text batch."""
    input_ids = np.repeat(out.input_ids, g, axis=0)
    attention_mask = np.repeat(out.attention_mask, g, axis=0)
    if out.dna_input_ids is None:
        return ProcessorOutput(input_ids, attention_mask, None, None, [])
    bmap = np.asarray(out.batch_idx_map)
    order, new_map = [], []
    for b in range(out.input_ids.shape[0]):
        rows = np.nonzero(bmap == b)[0]
        for rep in range(g):
            order.extend(rows.tolist())
            new_map.extend([b * g + rep] * len(rows))
    order = np.asarray(order, np.int64)
    return ProcessorOutput(input_ids, attention_mask, out.dna_input_ids[order],
                           out.dna_attention_mask[order], new_map)


def per_token_logps(model: FusionModel, cfg: FusionConfig, input_ids, attention_mask,
                    dna_input_ids, dna_attention_mask, completion_len: int) -> torch.Tensor:
    """log p(token) [B, completion_len] of the last `completion_len` tokens,
    vocab-chunked (ops/fused_ce.py: the [B, T, V] logits never exist): the
    hidden state at t predicts token t + 1."""
    embeds = fused_input_embeddings(model, cfg, input_ids, dna_input_ids, dna_attention_mask)
    hidden, _ = decoder_forward(model.decoder, cfg.decoder, inputs_embeds=embeds,
                                attention_mask=attention_mask, return_hidden=True)
    b = hidden.shape[0]
    h = hidden[:, -(completion_len + 1):-1]
    targets = input_ids[:, -completion_len:]
    dec = model.decoder
    head = dec.lm_head.weight if dec.lm_head is not None else dec.embed.weight   # [V, H]
    dtype = torch_dtype(cfg.decoder.dtype)
    logps = chunked_token_logps(h.reshape(-1, h.shape[-1]).to(dtype), head.to(dtype),
                                targets.reshape(-1).long(),
                                need_embedding_grad=head.requires_grad)
    return logps.reshape(b, completion_len)


def _set_parameter(module: torch.nn.Module, name: str, param: torch.nn.Parameter) -> None:
    *path, leaf = name.split(".")
    for part in path:
        module = getattr(module, part)
    setattr(module, leaf, param)


class GRPOTrainer:
    def __init__(self, fusion_cfg: FusionConfig, cfg: GRPOConfig, processor: BioProcessor,
                 reward_funcs: Sequence[Callable], model: Optional[FusionModel] = None,
                 device=None):
        """`model`: the policy to train (e.g. `checkpoint.load_sft_for_grpo`
        or `weights.from_jax_params`); default: drawn from `cfg.seed`.
        Adapters are attached unless the model carries some already. Runs
        on `device` (CUDA unless "cpu"); sampling draws come from a
        generator seeded with `cfg.seed`."""
        T.refuse_moe(fusion_cfg.decoder, "GRPOTrainer")
        if cfg.batch_size % cfg.num_generations:
            raise ValueError(f"batch {cfg.batch_size} not divisible by G={cfg.num_generations}"
                             " (reference grpo_trainer.py:429-446)")
        self.fusion_cfg, self.cfg = fusion_cfg, cfg
        self.processor = processor
        self.reward_funcs = list(reward_funcs)
        self.reward_weights = (np.asarray(cfg.reward_weights, np.float32)
                               if cfg.reward_weights is not None
                               else np.ones(len(self.reward_funcs), np.float32))
        if len(self.reward_weights) != len(self.reward_funcs):
            raise ValueError(f"{len(self.reward_weights)} reward weights for "
                             f"{len(self.reward_funcs)} reward functions")
        self.device = resolve_device(device)
        if model is None:
            model = init_fusion(fusion_cfg, seed=cfg.seed, device=self.device)
        self.model = model.to(self.device)
        if cfg.lora is not None:
            if not has_lora(model):
                attach_lora(model, cfg.lora,
                            torch.Generator(device=self.device).manual_seed(cfg.seed + 1))
            regex = T.LORA_TRAINABLE
        else:
            regex = T.FULL_FINETUNE
        if cfg.frozen_dtype == "int8":
            # QLoRA (JAX train/grpo.py:139-156): the adapters attached above
            # stay fp32, the frozen towers' denses become int8; the rollout
            # and reference models share those int8 tensors
            if cfg.lora is None:
                raise ValueError("frozen_dtype='int8' requires LoRA (quantized weights "
                                 "don't train)")
            if cfg.sync_ref_model:
                raise ValueError("frozen_dtype='int8' is incompatible with sync_ref_model "
                                 "(TR-DPO mixup is arithmetic on the weights; int8 weights "
                                 "don't support it)")
            quantize_frozen_int8(model)
        # frozen >= 2-D float weights (and int8 scales) in bf16: no optimizer
        # state, no fp32 master
        self.params = T.set_trainable(model, regex, cfg.frozen_dtype)
        self.names = T.trainable_names(model)
        self.opt = AdamW(self.params, cfg.optim)
        self.ref_model = self._make_ref() if cfg.beta > 0.0 else None
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.engine = GenerationEngine(fusion_cfg, processor.text_tokenizer.eos_token_id,
                                       device=self.device, kv_int8=cfg.rollout_kv_int8)
        # the int8 rollout policy (`rollout_model`), built at the first rollout
        self._rollout: Optional[FusionModel] = None
        # the vLLM guided-decoding knob (grpo_config.py:278-280): compiled once,
        # its tables as wide as the decoder's head (JAX train/grpo.py:193-200)
        self.guided = None
        if cfg.guided_decoding_regex:
            from bioreason_tpu_torch.generate.guided import guided_spec_for
            self.guided = guided_spec_for(processor.text_tokenizer, cfg.guided_decoding_regex,
                                          vocab_size=fusion_cfg.decoder.vocab_size,
                                          device=self.device)
        self.step_count = 0
        self._saver = AsyncSaver()
        # one rollout buffer per accumulation slot (reference
        # _buffered_inputs[step % accum], grpo_trainer.py:399-403): slot s
        # regenerates on the first micro-step of each mu-cycle and is reused
        # for num_iterations effective batches
        self._buffers: List[Optional[Dict[str, Any]]] = [None] * cfg.grad_accum_steps
        self.metrics_history: List[Dict[str, float]] = []
        # optional host-side phase timers (a dict enables them): prep /
        # rollout / logps_dispatch / rewards / update seconds and steps. The
        # rollout ends in the completions' copy to the host; the ref and old
        # logp passes are only queued in logps_dispatch, so their device time
        # lands in `update`, which ends at the metrics' host copy
        self.timers: Optional[Dict[str, float]] = None

    # ------------------------------------------------------------------

    @torch.no_grad()
    def _make_ref(self) -> FusionModel:
        """The adapter-off policy with its trainable parameters as they are
        now: a module tree that holds the policy's frozen tensors themselves
        (parameters and buffers: int8 weights and their scales are buffers)
        and copies of the trainable ones, without adapters."""
        return strip_lora(shared_copy(self.model, lambda p: torch.nn.Parameter(
            p.detach().clone(), requires_grad=False) if p.requires_grad else p))

    @torch.no_grad()
    def rollout_model(self) -> FusionModel:
        """The sampling policy the engine rolls out (JAX `_rollout_params`,
        train/grpo.py:334-351): the model itself, or with `rollout_int8` a
        module tree that holds the model's own tensors, its live adapters
        among them, with the frozen base int8:
          * on int8 frozen towers (`frozen_dtype="int8"`) it shares the
            model's int8 weights, and only the float embedding (the tied
            head) and an untied `lm_head` are quantized for it;
          * on a float tree, every dense of both towers, the embedding and
            the head are quantized for it (`include_embed=True`).
        JAX quantizes again for every rollout; the base is frozen under
        LoRA, so the quantized tensors are built once and reused. Weights
        that train (no LoRA) are quantized again for every rollout."""
        if not self.cfg.rollout_int8:
            return self.model
        if self._rollout is not None:
            return self._rollout
        rollout = shared_copy(self.model)
        if self.cfg.frozen_dtype == "int8":
            dec = rollout.decoder
            for mod in (dec.embed, dec.lm_head):
                if mod is not None and not is_int8(mod):
                    store_int8(mod, *quantize_kernel_int8(mod.weight))
        else:
            quantize_frozen_int8(rollout, include_embed=True)
        self._rollout = rollout if self.cfg.lora is not None else None
        return rollout

    @torch.no_grad()
    def _sync_ref(self) -> None:
        """TR-DPO mixup (grpo_config.py:320-341): ref <- a * merged policy +
        (1 - a) * ref, weight by weight, in each weight's dtype with the
        factors rounded to it, as the JAX trainer's tree map computes it."""
        a = self.cfg.ref_model_mixup_alpha
        policy = dict(self.model.named_modules())
        for name, r in list(self.ref_model.named_parameters()):
            mod_name, leaf = name.rsplit(".", 1)
            mod = policy[mod_name]
            p = (merged_weight(mod) if leaf == "weight" and has_adapter(mod)
                 else getattr(mod, leaf))
            fa = torch.tensor(a, dtype=r.dtype, device=r.device)
            fb = torch.tensor(1 - a, dtype=r.dtype, device=r.device)
            _set_parameter(self.ref_model, name, torch.nn.Parameter(
                (fa * p.to(r.dtype) + fb * r).to(r.dtype), requires_grad=False))

    def _prepare_prompts(self, items: Sequence[Dict[str, Any]]):
        """Chat rendering and the processor, left-padded; `max_prompt_length`
        keeps the LAST N tokens (TRL prompt_ids[:, -N:])."""
        rendered = [apply_chat_template(ex)["prompt"] for ex in items]
        out = self.processor(
            text=rendered, batch_dna_sequences=[ex["dna_sequences"] for ex in items],
            max_length_text=self.fusion_cfg.max_length_text,
            max_length_dna=self.fusion_cfg.max_length_dna, padding_side="left")
        n = self.cfg.max_prompt_length
        if n is not None and out.input_ids.shape[1] > n:
            out.input_ids = out.input_ids[:, -n:]
            out.attention_mask = out.attention_mask[:, -n:]
        validate_splice(out.input_ids, out.dna_input_ids, self.fusion_cfg.dna_pad_token_id)
        return out, rendered

    def _compute_rewards(self, rendered_prompts: List[str], completions: List[str],
                         items: Sequence[Dict[str, Any]]):
        extra = {key: [it[key] for it in items] for key in items[0]
                 if key not in ("prompt", "dna_sequences")}
        per_func = np.stack([np.asarray(fn(rendered_prompts, completions, **extra), np.float32)
                             for fn in self.reward_funcs], axis=1)      # [B, F]
        return per_func @ self.reward_weights, per_func

    # ------------------------------------------------------------------

    def _loss(self, batch: Dict[str, torch.Tensor], completion_len: int):
        cfg = self.cfg
        logps = per_token_logps(self.model, self.fusion_cfg, batch["full_ids"],
                                batch["full_mask"], batch.get("dna_input_ids"),
                                batch.get("dna_attention_mask"), completion_len)
        mask = batch["completion_mask"].float()
        old = batch.get("old_logps")
        ratio = torch.exp(logps - (logps.detach() if old is None else old))
        adv = batch["advantages"][:, None]
        eps_low = cfg.epsilon
        eps_high = cfg.epsilon_high if cfg.epsilon_high is not None else cfg.epsilon
        clipped = ratio.clamp(1.0 - eps_low, 1.0 + eps_high)
        per_token_loss = -torch.minimum(ratio * adv, clipped * adv)
        per_seq = mask.sum(-1).clamp(min=1)
        kl = torch.zeros((), device=logps.device)
        if cfg.beta > 0.0:
            diff = batch["ref_logps"] - logps
            per_token_kl = torch.exp(diff) - diff - 1.0
            per_token_loss = per_token_loss + cfg.beta * per_token_kl
            kl = ((per_token_kl * mask).sum(-1) / per_seq).mean()
        loss = ((per_token_loss * mask).sum(-1) / per_seq).mean()
        clip_frac = (((ratio > 1.0 + eps_high) | (ratio < 1.0 - eps_low)) * mask
                     ).sum() / mask.sum().clamp(min=1)
        return loss, kl, clip_frac

    def _update(self, batch: Dict[str, torch.Tensor], completion_len: int) -> Dict[str, float]:
        """One micro-step on a rollout buffer; the optimizer applies the mean
        gradient of every `grad_accum_steps` micro-steps. grad_norm is that
        of this micro-step's raw gradients."""
        loss, kl, clip_frac = self._loss(batch, completion_len)
        grads = torch.autograd.grad(loss, self.params, allow_unused=True)
        grad_norm = self.opt.accumulate(grads, self.cfg.grad_accum_steps)
        return {"loss": float(loss.detach()), "kl": float(kl.detach()),
                "clip_ratio": float(clip_frac.detach()),
                "grad_norm": grad_norm}

    # ------------------------------------------------------------------

    def _generate_and_score(self, items: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
        """Rollout, the queued logp passes, rewards and advantages
        (grpo_trainer.py:535-749). `items` holds each prompt G times
        contiguously."""
        cfg = self.cfg
        tm = self.timers
        clk = time.perf_counter
        t0 = clk() if tm is not None else 0.0
        g = cfg.num_generations
        unique_items = list(items[::g])
        if len(unique_items) * g != len(items):
            raise ValueError(f"{len(items)} items are not prompts repeated G={g} times")
        out, rendered_unique = self._prepare_prompts(unique_items)
        rendered = [r for r in rendered_unique for _ in range(g)]
        if tm is not None:
            t1 = clk()
            tm["prep"] = tm.get("prep", 0.0) + (t1 - t0)
            t0 = t1
        completion_ids, completion_mask = self.engine.generate(
            self.rollout_model(), out.input_ids, out.attention_mask, out.dna_input_ids,
            out.dna_attention_mask, sampling=cfg.sampling,
            max_new_tokens=cfg.max_completion_length, generator=self.generator, group_size=g,
            guided=self.guided)
        nonfinite = self.engine.last_stats["nonfinite_rows"]
        if tm is not None:
            t1 = clk()
            tm["rollout"] = tm.get("rollout", 0.0) + (t1 - t0)
            t0 = t1

        out = _repeat_prompt_batch(out, g)
        put = lambda a: None if a is None else torch.as_tensor(np.asarray(a), device=self.device)
        batch = {"full_ids": put(np.concatenate([out.input_ids, completion_ids], axis=1)),
                 "full_mask": put(np.concatenate([out.attention_mask, completion_mask], axis=1)),
                 "completion_mask": put(completion_mask),
                 "dna_input_ids": put(out.dna_input_ids),
                 "dna_attention_mask": put(out.dna_attention_mask)}
        clen = completion_ids.shape[1]

        # queue the ref / old logp passes before the host decodes and
        # scores: the card runs them while the host works (JAX grpo.py:409-423)
        args = (self.fusion_cfg, batch["full_ids"], batch["full_mask"],
                batch["dna_input_ids"], batch["dna_attention_mask"], clen)
        with torch.no_grad():
            if cfg.beta > 0.0:
                batch["ref_logps"] = per_token_logps(self.ref_model, *args)
            if cfg.num_iterations > 1:
                batch["old_logps"] = per_token_logps(self.model, *args)
        if tm is not None:
            t1 = clk()
            tm["logps_dispatch"] = tm.get("logps_dispatch", 0.0) + (t1 - t0)
            t0 = t1

        completions = self.processor.text_tokenizer.batch_decode(
            [row[m.astype(bool)] for row, m in zip(completion_ids, completion_mask)],
            skip_special_tokens=True)
        total_reward, rewards_per_func = self._compute_rewards(rendered, completions, items)
        grouped = total_reward.reshape(-1, g)
        mean_g = grouped.mean(axis=1, keepdims=True)
        std_g = grouped.std(axis=1, keepdims=True)            # population std (ddof 0)
        advantages = ((grouped - mean_g) / (std_g + 1e-4)).reshape(-1)
        batch["advantages"] = put(advantages)

        metrics = {"reward": float(total_reward.mean()), "reward_std": float(std_g.mean()),
                   "completion_length": float(completion_mask.sum(-1).mean()),
                   "nonfinite_rows": float(nonfinite)}
        for i, fn in enumerate(self.reward_funcs):
            metrics[f"rewards/{getattr(fn, '__name__', f'fn{i}')}"] = float(
                rewards_per_func[:, i].mean())
        if tm is not None:
            tm["rewards"] = tm.get("rewards", 0.0) + (clk() - t0)
        return {"batch": batch, "completion_len": clen, "metrics": metrics,
                "completions": completions, "prompts": rendered,
                "rewards": total_reward.tolist()}

    def step(self, items: Sequence[Dict[str, Any]]) -> Dict[str, float]:
        """One GRPO micro-step over `items` (each prompt repeated G times
        contiguously). With grad_accum_steps=N, N consecutive calls form one
        effective batch; each accumulation slot keeps its own rollout buffer
        for mu-iteration reuse."""
        cfg = self.cfg
        slot = self.step_count % cfg.grad_accum_steps
        eff_step = self.step_count // cfg.grad_accum_steps
        if eff_step % cfg.num_iterations == 0 or self._buffers[slot] is None:
            self._buffers[slot] = self._generate_and_score(items)
        buf = self._buffers[slot]

        tm = self.timers
        t0 = time.perf_counter() if tm is not None else 0.0
        out = self._update(buf["batch"], buf["completion_len"])
        self.step_count += 1
        # TR-DPO sync every ref_model_sync_steps OPTIMIZER steps
        if (cfg.sync_ref_model and cfg.beta > 0.0
                and self.step_count % cfg.grad_accum_steps == 0
                and (self.step_count // cfg.grad_accum_steps) % cfg.ref_model_sync_steps == 0):
            self._sync_ref()
        if tm is not None:
            tm["update"] = tm.get("update", 0.0) + (time.perf_counter() - t0)
            tm["steps"] = tm.get("steps", 0) + 1
        out.update(buf["metrics"])
        self.last_completions = buf["completions"]
        self.last_prompts = buf["prompts"]
        self.last_rewards = buf["rewards"]
        self.metrics_history.append(out)
        return out

    def trainable_state(self) -> Dict[str, torch.Tensor]:
        return dict(zip(self.names, self.params))

    def save(self, path: str, extra_metadata: Optional[Dict] = None,
             block: bool = True) -> str:
        """Trainable parameters, optimizer state and step to `path`;
        `block=False` hands the write to an `AsyncSaver` after a device copy
        (JAX grpo.py:511-519; `finish_saves` joins it)."""
        meta = {"stage": "grpo", **(extra_metadata or {})}
        if block:
            return save_checkpoint(path, self.trainable_state(), self.opt.state_dict(),
                                   self.step_count, meta)
        return self._saver.save(path, self.trainable_state(), self.opt.state_dict(),
                                self.step_count, meta)

    def finish_saves(self) -> None:
        """Join the write in flight; re-raises its failure."""
        self._saver.wait()

    @torch.no_grad()
    def restore(self, path: str) -> "GRPOTrainer":
        """Load `save`'s state; the reference policy is rebuilt from it as
        `__init__` builds it (JAX grpo.py:527-540)."""
        state = load_checkpoint(path)
        if sorted(state["trainable"]) != sorted(self.names):
            raise ValueError(f"checkpoint {path} holds other trainable parameters")
        for name, p in zip(self.names, self.params):
            p.copy_(state["trainable"][name])
        self.opt.load_state_dict(state["opt_state"])
        self.step_count = int(state["step"])
        if self.cfg.beta > 0.0:
            self.ref_model = self._make_ref()
        return self
