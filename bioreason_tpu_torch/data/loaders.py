"""Local KEGG-style dataset loading (the port's copy of the JSON layouts of
bioreason_tpu/data/loaders.py): a directory of per-variant .json files, a
.jsonl file, or a .json file holding a list. Every record is normalized to
{question, answer, reasoning, reference_sequence, variant_sequence}, with
the record's "ID" where it has one (`cli/curate.py`'s eQTL and OMIM items).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

from bioreason_tpu_torch.data.kegg import process_kegg_item


def _normalize(item: Dict[str, Any]) -> Dict[str, Any]:
    if isinstance(item.get("reasoning"), dict):
        return process_kegg_item(item)
    out = {
        "question": item.get("question", ""),
        "answer": str(item.get("answer", "")).strip(),
        "reasoning": item.get("reasoning", "") or "",
        "reference_sequence": item.get("reference_sequence", "").upper().strip(),
        "variant_sequence": item.get("variant_sequence", "").upper().strip(),
    }
    if "ID" in item:       # the record ids of the curated eQTL / OMIM tasks
        out["ID"] = item["ID"]
    return out


def load_local_dataset(path: str) -> List[Dict[str, Any]]:
    if os.path.isdir(path):
        items: List[Dict[str, Any]] = []
        for f in sorted(os.listdir(path)):
            if f.endswith((".json", ".jsonl")):
                items.extend(load_local_dataset(os.path.join(path, f)))
        return items
    with open(path, encoding="utf-8") as fh:
        if path.endswith(".jsonl"):
            return [_normalize(json.loads(line)) for line in fh if line.strip()]
        if path.endswith(".json"):
            data = json.load(fh)
            return [_normalize(x) for x in (data if isinstance(data, list) else [data])]
    raise ValueError(f"unsupported dataset path: {path}")
