"""Rule-based reward functions for GRPO (the port's copy of
bioreason_tpu/train/rewards.py; reference reason.py:193-230,312-320).

Rewards run on the host on decoded strings. Signature:
    fn(prompts: list[str], completions: list[str], answer: list[str], **cols)
      -> list[float]
where **cols carries extra dataset columns forwarded as keyword arguments
(grpo_trainer.py:669-675).

The reference `correctness_reward_func` zips against `answer[0]`
(reason.py:199), iterating the characters of the first answer, a bug the
reference quirk list says not to reproduce: here each completion is matched
against its own answer.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List


def extract_answer(text: str) -> str:
    """Text after the last </think> (reference reason.py:117-121)."""
    return text.split("</think>")[-1].strip()


def correctness_reward(prompts, completions, answer, **kw) -> List[float]:
    extracted = [extract_answer(c) for c in completions]
    return [2.0 if a.lower() in r.lower() else 0.0 for r, a in zip(extracted, answer)]


def less_than_4_reward(prompts, completions, answer=None, **kw) -> List[float]:
    extracted = [extract_answer(c) for c in completions]
    return [0.5 if len(r.split(" ")) <= 4 else 0.0 for r in extracted]


def strict_format_reward(prompts, completions, answer=None, **kw) -> List[float]:
    # the reference matches WITHOUT re.DOTALL (reason.py:213-216)
    pattern = r"^<think>\n.*?\n</think>\n.*?\n$"
    return [0.5 if re.match(pattern, c) else 0.0 for c in completions]


def soft_format_reward(prompts, completions, answer=None, **kw) -> List[float]:
    pattern = r"<think>.*?</think>\s*.*?"
    return [0.5 if re.match(pattern, c, re.DOTALL) else 0.0 for c in completions]


def _count_xml(text: str) -> float:
    count = 0.0
    if text.count("<think>\n") == 1:
        count += 0.125
    if text.count("\n</think>\n") == 1:
        count += 0.125
    return count


def xmlcount_reward(prompts, completions, answer=None, **kw) -> List[float]:
    return [_count_xml(c) for c in completions]


REWARD_REGISTRY: Dict[str, Callable] = {
    "xmlcount": xmlcount_reward,
    "soft_format": soft_format_reward,
    "strict_format": strict_format_reward,
    "less_than_4": less_than_4_reward,
    "correctness": correctness_reward,
}


def get_reward_funcs(names) -> List[Callable]:
    return [REWARD_REGISTRY[n] for n in names]
