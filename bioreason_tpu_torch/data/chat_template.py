"""Qwen3-style chat rendering with DNA content parts (the port's copy of
`render_chat` and `apply_chat_template`, bioreason_tpu/data/chat_template.py:100-183).

Rendering rules (as exercised by the reference's datasets):
  - leading system turn:  <|im_start|>system\\n{content}<|im_end|>\\n
  - user turn with list content: <|im_start|>user\\n then per part:
      dna  -> [optional 'DNA Sequence{n}:'] <|dna_start|><|dna_pad|><|dna_end|>
      text -> the text verbatim
    then <|im_end|>\\n
  - assistant turn AFTER the last user turn, when it is the final message or
    has reasoning: <|im_start|>assistant\\n<think>\\n{reasoning}\\n</think>\\n\\n
    {content}<|im_end|>\\n ; otherwise <|im_start|>assistant\\n{content}<|im_end|>\\n
  - add_generation_prompt appends <|im_start|>assistant\\n
    (+ '<think>\\n\\n</think>\\n\\n' when enable_thinking is False)
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


def _part_text(content: Any) -> str:
    """First text of a list-of-parts content, or the string itself."""
    if isinstance(content, str):
        return content
    return content[0]["text"]


def render_chat(
    messages: List[Dict[str, Any]],
    add_generation_prompt: bool = False,
    enable_thinking: Optional[bool] = None,
    add_dna_id: bool = False,
) -> str:
    out: List[str] = []
    n = len(messages)

    # last user-turn index (the reference template's ns.last_query_index)
    last_query_index = n - 1
    for i in range(n - 1, -1, -1):
        if messages[i]["role"] == "user":
            last_query_index = i
            break

    dna_count = 0
    for i, msg in enumerate(messages):
        role = msg["role"]
        content = msg.get("content")
        if role == "system" and i == 0:
            out.append(f"<|im_start|>system\n{content}<|im_end|>\n")
        elif role == "user" or role == "system":
            out.append(f"<|im_start|>{role}\n")
            if isinstance(content, str):
                out.append(f"{content}<|im_end|>\n")
            else:
                rendered, dna_count = _render_user_content(content, add_dna_id, dna_count)
                out.append(rendered)
                out.append("<|im_end|>\n")
        elif role == "assistant":
            text = _part_text(content)
            reasoning = msg.get("reasoning_content")
            reasoning = reasoning if reasoning is not None else ""
            if i > last_query_index and (i == n - 1 or reasoning):
                out.append(
                    f"<|im_start|>{role}\n<think>\n{reasoning.strip(chr(10))}\n</think>\n\n{text.lstrip(chr(10))}"
                )
            else:
                out.append(f"<|im_start|>{role}\n{text}")
            out.append("<|im_end|>\n")

    if add_generation_prompt:
        out.append("<|im_start|>assistant\n")
        if enable_thinking is False:
            out.append("<think>\n\n</think>\n\n")
    return "".join(out)


def _render_user_content(parts: List[Dict[str, Any]], add_dna_id: bool, dna_count: int):
    chunks: List[str] = []
    for part in parts:
        if part.get("type") == "dna" or "dna" in part:
            dna_count += 1
            if add_dna_id:
                chunks.append(f"DNA Sequence{dna_count}:")
            chunks.append("<|dna_start|><|dna_pad|><|dna_end|>")
        elif "text" in part:
            chunks.append(part["text"])
    return "".join(chunks), dna_count


def apply_chat_template(example: Dict[str, Any], **kw) -> Dict[str, Any]:
    """trl-style maybe_apply_chat_template over a {'prompt': messages} example.

    - last turn 'user'      -> rendered with add_generation_prompt=True
    - last turn 'assistant' -> rendered fully, then cut right after the final
      assistant text (continue_final_message): the trailing '<|im_end|>\\n'
      is dropped, as the reference SFT collator feeds the model."""
    messages = example["prompt"]
    last_role = messages[-1]["role"]
    if last_role == "user":
        rendered = render_chat(messages, add_generation_prompt=True, **kw)
    elif last_role == "assistant":
        rendered = render_chat(messages, add_generation_prompt=False, **kw)
        final_text = _part_text(messages[-1]["content"]).strip()
        idx = rendered.rindex(final_text)
        rendered = rendered[: idx + len(final_text)]
    else:
        raise ValueError(f"Unsupported final role: {last_role}")
    return {**example, "prompt": rendered}
