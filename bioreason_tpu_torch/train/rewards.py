"""Answer extraction for served completions (the port's copy of
bioreason_tpu/train/rewards.py:22; the GRPO reward functions come with the
training slice)."""

from __future__ import annotations


def extract_answer(text: str) -> str:
    """Text after the last </think> (reference reason.py:117-121)."""
    return text.split("</think>")[-1].strip()
