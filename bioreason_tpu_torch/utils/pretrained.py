"""Local pretrained checkpoints as (config, module) pairs (the Evo2 part of
bioreason_tpu/utils/pretrained.py; it reads `json` and `torch` only).

The reference loads the Evo2 tower through `evo2.Evo2(dna_model_name)`
(dna_llm.py:86-90), with the `--dna_embedding_layer blocks.N.mlp.l3` tap.
"""

from __future__ import annotations

import json
import os

from bioreason_tpu_torch.config import HyenaConfig
from bioreason_tpu_torch.utils.evo2_import import config_sizes, import_evo2, load_state_dict


def load_pretrained_evo2(path: str, embedding_tap_layer: int = -1, device=None,
                         **overrides):
    """A local Evo2 / StripedHyena-2 checkpoint directory (vortex `.pt`
    weights) -> (HyenaConfig, HyenaTower on `device`, CUDA unless "cpu").

    Width, inner size, depth, operators and filter sizes come from the
    weights' shapes; heads from a head_dim of 128 where it divides the width
    (Evo2's 1920 / 128 = 15), else 8. An optional config.json's
    `num_attention_heads` and `rotary_emb_base` override them, and
    `overrides` (HyenaConfig fields) override everything."""
    state = load_state_dict(path)
    kw = config_sizes(state)
    head_dim = 128 if kw["hidden_size"] % 128 == 0 else 8
    kw.update(num_heads=kw["hidden_size"] // head_dim, embedding_tap_layer=embedding_tap_layer)
    cfg_path = os.path.join(path, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            c = json.load(f)
        if "num_attention_heads" in c:
            kw["num_heads"] = c["num_attention_heads"]
        if "rotary_emb_base" in c:
            kw["rope_theta"] = float(c["rotary_emb_base"])
    kw.update(overrides)
    cfg = HyenaConfig(**kw)
    return cfg, import_evo2(state, cfg, device)
