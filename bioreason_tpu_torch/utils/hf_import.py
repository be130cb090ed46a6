"""Import HuggingFace checkpoints into the port's modules (the port of
bioreason_tpu/utils/hf_import.py:27-197,332-361).

The reference loads its towers from the HF hub (dna_llm.py:64-90); here a
LOCAL directory as `save_pretrained` leaves it is read: every `*.safetensors`
file in sorted order (`utils/safetensors_io`, memory-mapped, no
dependency), else `pytorch_model*.bin` / `*.pt` through
`torch.load(weights_only=True)`. Tensors keep their stored dtype until they
are copied into a parameter, which casts them (round to nearest even) to
the parameter's dtype, as `weights.from_jax_params` does.

HF stores a linear weight `[out, in]`, which is `nn.Linear`'s layout: nothing
is transposed (the JAX package transposes to `[in, out]` and stacks layers;
the port keeps one module per layer). Qwen3 ties its `lm_head` to
`embed_tokens` unless the config says otherwise. NT-v2's remote code fuses
its gated MLP into one `intermediate.dense` of width 2·I (silu of the first
half times the second), split here into `gate` and `up`; whether the MLP
is gated and which projections carry biases is read from the keys.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Iterable, List, Tuple

import torch
from torch import nn

from bioreason_tpu_torch.utils.safetensors_io import load_file

Rule = Tuple[str, str]   # (regex over HF names, with (?P<i>..) for a layer; port name template)


def weight_files(path: str) -> List[str]:
    """The weights files `load_hf_state_dict` reads, in its order."""
    names = sorted(os.listdir(path))
    st = [f for f in names if f.endswith(".safetensors")]
    if st:
        return [os.path.join(path, f) for f in st]
    other = [f for f in names if (f.startswith("pytorch_model") and f.endswith(".bin"))
             or f.endswith(".pt")]
    if not other:
        raise FileNotFoundError(f"no safetensors/bin/pt weights in {path}")
    return [os.path.join(path, f) for f in other]


def load_hf_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the checkpoint directory `path`, on the CPU, in its
    stored dtype (a `{"state_dict": ...}` wrapper of a torch file
    unwrapped)."""
    tensors: Dict[str, torch.Tensor] = {}
    for f in weight_files(path):
        if f.endswith(".safetensors"):
            tensors.update(load_file(f))
            continue
        sd = torch.load(f, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        tensors.update(sd)
    return tensors


def import_with_map(state: Dict[str, torch.Tensor], rules: Iterable[Rule]
                    ) -> Dict[str, torch.Tensor]:
    """HF names -> port parameter names by the first rule whose regex
    matches the whole name; a template's `{i}` takes the layer index the
    regex captured. Unmatched names are dropped (heads, rotary buffers);
    `load_into` then refuses a state that leaves a parameter unfilled."""
    compiled = [(re.compile(rx), dst) for rx, dst in rules]
    out: Dict[str, torch.Tensor] = {}
    for key, t in state.items():
        for rx, dst in compiled:
            m = rx.fullmatch(key)
            if m:
                out[dst.format(**m.groupdict())] = t
                break
    return out


@torch.no_grad()
def load_into(module: nn.Module, named: Dict[str, torch.Tensor], what: str) -> nn.Module:
    """Copy `named` (port parameter names of `module`) into its parameters,
    each cast to the parameter's dtype and device. Raises unless the names
    cover every parameter exactly and every shape fits."""
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(named))
    extra = sorted(set(named) - set(params))
    if missing or extra:
        raise ValueError(f"{what}: the checkpoint lacks {missing[:6]} and has no place for "
                         f"{extra[:6]}")
    for name, p in params.items():
        t = named[name]
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{what}: {name} is {tuple(t.shape)} in the checkpoint, "
                             f"{tuple(p.shape)} in the model")
        p.copy_(t)
    return module


# -- Qwen3 --------------------------------------------------------------------

QWEN3_LAYER = {
    "self_attn.q_proj.weight": "attn.q.weight",
    "self_attn.k_proj.weight": "attn.k.weight",
    "self_attn.v_proj.weight": "attn.v.weight",
    "self_attn.o_proj.weight": "attn.o.weight",
    "self_attn.q_norm.weight": "attn.q_norm.scale",
    "self_attn.k_norm.weight": "attn.k_norm.scale",
    "input_layernorm.weight": "ln1.scale",
    "post_attention_layernorm.weight": "ln2.scale",
    "mlp.gate_proj.weight": "mlp.gate.weight",
    "mlp.up_proj.weight": "mlp.up.weight",
    "mlp.down_proj.weight": "mlp.down.weight",
    "mlp.gate.weight": "mlp.router.weight",         # Qwen3-MoE's router [E, H]
}
QWEN3_TOP = {"model.embed_tokens.weight": "embed.weight", "model.norm.weight": "final_norm.scale",
             "lm_head.weight": "lm_head.weight"}
QWEN3_RULES: List[Rule] = (
    [(re.escape(k), v) for k, v in QWEN3_TOP.items()]
    + [(r"model\.layers\.(?P<i>\d+)\." + re.escape(k), "layers.{i}." + v)
       for k, v in QWEN3_LAYER.items()])
# Qwen3-MoE (Qwen3MoeForCausalLM): each expert's [out, in] projections,
# transposed and stacked onto a leading E, fill the [E, in, out] banks
QWEN3_EXPERT = re.compile(
    r"model\.layers\.(\d+)\.mlp\.experts\.(\d+)\.(gate|up|down)_proj\.weight")


def _stack_experts(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The stacked expert banks of an HF Qwen3-MoE state (JAX
    hf_import.py:100-128), under the port's names."""
    out: Dict[str, torch.Tensor] = {}
    banks: Dict[Tuple[str, str], Dict[int, torch.Tensor]] = {}
    for key, t in state.items():
        m = QWEN3_EXPERT.fullmatch(key)
        if m:
            banks.setdefault((m.group(1), m.group(3)), {})[int(m.group(2))] = t.t()
    for (i, proj), per_expert in banks.items():
        if sorted(per_expert) != list(range(len(per_expert))):
            raise ValueError(f"layer {i} {proj}_proj: experts {sorted(per_expert)[:6]}.. "
                             f"are not 0..E-1")
        out[f"layers.{i}.mlp.experts.{proj}.weight"] = torch.stack(
            [per_expert[j] for j in range(len(per_expert))])
    return out


def import_qwen3(state: Dict[str, torch.Tensor], decoder: nn.Module) -> nn.Module:
    """An HF Qwen3 or Qwen3-MoE state dict into a `Qwen3Decoder`. A tied
    decoder (`lm_head` None) ignores an `lm_head.weight` in the file, as HF
    does."""
    named = import_with_map(state, QWEN3_RULES)
    named.update(_stack_experts(state))
    if decoder.lm_head is None:
        named.pop("lm_head.weight", None)
    return load_into(decoder, named, "Qwen3 decoder")


def export_decoder_to_hf(decoder: nn.Module) -> Dict[str, torch.Tensor]:
    """Inverse of `import_qwen3`: HF Qwen3 names -> the decoder's tensors
    (detached, as stored)."""
    inv_layer = {v: k for k, v in QWEN3_LAYER.items()}
    inv_top = {v: k for k, v in QWEN3_TOP.items()}
    out = {}
    for name, p in decoder.named_parameters():
        if name.rsplit(".", 1)[-1].startswith("lora_"):
            raise ValueError(f"{name}: merge or strip the adapters before exporting")
        m = re.fullmatch(r"layers\.(\d+)\.(.+)", name)
        key = f"model.layers.{m.group(1)}.{inv_layer[m.group(2)]}" if m else inv_top[name]
        out[key] = p.detach()
    return out


# -- ESM / NT-v2 --------------------------------------------------------------

_P = r"(?:esm\.)?"
_L = _P + r"encoder\.layer\.(?P<i>\d+)\."
ESM_LAYER = {
    "attention.self.query": "attn.q", "attention.self.key": "attn.k",
    "attention.self.value": "attn.v", "attention.output.dense": "attn.o",
    "intermediate.dense": "mlp.up", "gate.dense": "mlp.gate", "output.dense": "mlp.down",
}
ESM_NORMS = {"attention.LayerNorm": "ln1", "LayerNorm": "ln2"}
ESM_RULES: List[Rule] = (
    [(_P + r"embeddings\.word_embeddings\.weight", "embed.weight"),
     (_P + r"encoder\.emb_layer_norm_after\.weight", "final_norm.scale"),
     (_P + r"encoder\.emb_layer_norm_after\.bias", "final_norm.bias")]
    + [(_L + re.escape(k) + r"\.(?P<leaf>weight|bias)", "layers.{i}." + v + ".{leaf}")
       for k, v in ESM_LAYER.items()]
    + [(_L + re.escape(k) + r"\.weight", "layers.{i}." + v + ".scale")
       for k, v in ESM_NORMS.items()]
    + [(_L + re.escape(k) + r"\.bias", "layers.{i}." + v + ".bias")
       for k, v in ESM_NORMS.items()])


def esm_layout(state: Dict[str, torch.Tensor]) -> Dict[str, bool]:
    """What the keys say of the encoder's layers (`pretrained.py:112-126`):
    a gated MLP (a `gate.dense`, or NT-v2's fused `intermediate.dense` of
    twice the down projection's input), MLP biases and attention biases."""
    named = import_with_map(state, ESM_RULES)
    if "embed.weight" not in named or "layers.0.mlp.up.weight" not in named:
        raise KeyError(f"state dict does not look like an ESM checkpoint "
                       f"(keys: {list(state)[:5]}...)")
    inter = named["layers.0.mlp.up.weight"].shape[0]
    down_in = named["layers.0.mlp.down.weight"].shape[1]
    gated = "layers.0.mlp.gate.weight" in named or inter == 2 * down_in
    if not gated and inter != down_in:
        raise ValueError(f"cannot infer the MLP layout: intermediate width {inter} vs "
                         f"down-projection input {down_in}")
    return {"use_swiglu": gated, "mlp_bias": "layers.0.mlp.up.bias" in named,
            "attn_bias": "layers.0.attn.q.bias" in named}


def import_esm(state: Dict[str, torch.Tensor], encoder: nn.Module) -> nn.Module:
    """An HF ESM / NT-v2 state dict into an `NTEncoder` whose config has
    the layout `esm_layout` reads; a fused gated `intermediate.dense`
    [2I, H] is split into `gate` (first half) and `up` (second half)."""
    named = import_with_map(state, ESM_RULES)
    for i in range(len(encoder.layers)):
        up = f"layers.{i}.mlp.up."
        if f"layers.{i}.mlp.gate.weight" in named or not hasattr(encoder.layers[i].mlp, "gate"):
            continue
        for leaf in ("weight", "bias"):
            if up + leaf in named:
                named[f"layers.{i}.mlp.gate.{leaf}"], named[up + leaf] = \
                    named[up + leaf].chunk(2, dim=0)
    return load_into(encoder, named, "ESM encoder")


def export_encoder_to_hf(encoder: nn.Module) -> Dict[str, torch.Tensor]:
    """Inverse of `import_esm`: HF `EsmForMaskedLM` names with NT-v2's fused
    layout (gate and up concatenated into one `intermediate.dense`)."""
    inv = {v: k for k, v in ESM_LAYER.items()}
    inv_norm = {v: k for k, v in ESM_NORMS.items()}
    out: Dict[str, torch.Tensor] = {
        "esm.embeddings.word_embeddings.weight": encoder.embed.weight.detach(),
        "esm.encoder.emb_layer_norm_after.weight": encoder.final_norm.scale.detach(),
        "esm.encoder.emb_layer_norm_after.bias": encoder.final_norm.bias.detach()}
    for i, layer in enumerate(encoder.layers):
        pre = f"esm.encoder.layer.{i}."
        params = dict(layer.named_parameters())
        for name, p in params.items():
            mod, leaf = name.rsplit(".", 1)
            if mod in inv_norm:
                out[pre + inv_norm[mod] + (".weight" if leaf == "scale" else ".bias")] = p.detach()
            elif mod == "mlp.gate":
                continue
            elif mod == "mlp.up" and "mlp.gate." + leaf in params:
                out[pre + "intermediate.dense." + leaf] = torch.cat(
                    [params["mlp.gate." + leaf].detach(), p.detach()], dim=0)
            else:
                out[pre + inv[mod] + "." + leaf] = p.detach()
    return out

