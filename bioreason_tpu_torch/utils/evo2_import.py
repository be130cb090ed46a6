"""Import vortex-format Evo2 / StripedHyena-2 checkpoints into the port's
`HyenaTower` (the port of bioreason_tpu/utils/hf_import.py's `import_evo2`,
:233-320; `utils/hf_import.load_hf_state_dict` reads the `.pt` files).

The reference binds to the `evo2` package (dna_llm.py:86-90), whose
inference stack (vortex) names weights `blocks.N.{pre_norm, projections,
filter, out_filter_dense, post_norm, mlp.l1/l2/l3}`, with attention blocks
as `blocks.N.inner_mha_cls.{Wqkv, out_proj}`, optionally under a
`backbone.` prefix. Each block's operator comes from the keys that exist:
poles/residues -> 'li', a decay tensor -> 'mr', a plain `h` -> 'se', `Wqkv`
-> 'attn'. Vortex stores the li poles and residues as COMPLEX tensors; the
tower keeps poles as (logit |p|, phase), exact for |p| in (0, 1), and
residues as (re, im) pairs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from bioreason_tpu_torch.config import HyenaConfig
from bioreason_tpu_torch.models.evo2 import HyenaTower
from bioreason_tpu_torch.utils.devices import resolve_device, torch_dtype


def _key(state: Dict[str, torch.Tensor], k: str):
    for cand in (k, "backbone." + k):
        if cand in state:
            return cand
    return None


def _get(state, k: str) -> torch.Tensor:
    cand = _key(state, k)
    if cand is None:
        raise KeyError(k)
    return state[cand]


def evo2_flavors(state: Dict[str, torch.Tensor]) -> Tuple[str, ...]:
    """Per-block operators, derived from the keys."""
    n = 0
    while _key(state, f"blocks.{n}.pre_norm.scale") is not None:
        n += 1
    if n == 0:
        raise KeyError("no blocks.N.pre_norm.scale keys found")
    out = []
    for i in range(n):
        p = f"blocks.{i}"
        if _key(state, f"{p}.inner_mha_cls.Wqkv.weight") is not None:
            out.append("attn")
        elif _key(state, f"{p}.filter.poles") is not None:
            out.append("li")
        elif _key(state, f"{p}.filter.decay") is not None:
            out.append("mr")
        else:
            out.append("se")
    return tuple(out)


def config_sizes(state: Dict[str, torch.Tensor]) -> Dict:
    """The HyenaConfig fields that the weights' shapes fix: vocabulary,
    width, MLP inner size, depth and operators, and the filter lengths and
    modal order (each from the first block of its flavor)."""
    flavors = evo2_flavors(state)
    vocab, hidden = _get(state, "embedding_layer.weight").shape
    kw = dict(vocab_size=vocab, hidden_size=hidden,
              intermediate_size=_get(state, "blocks.0.mlp.l1.weight").shape[0],
              num_layers=len(flavors), layer_flavors=flavors)
    for field, flavor, key, axis in (
            ("short_filter_len", None, "filter.short_filter_weight", -1),
            ("se_filter_len", "se", "filter.h", -1),
            ("medium_filter_len", "mr", "filter.h", -1),
            ("li_order", "li", "filter.poles", 1)):
        i = next((i for i, f in enumerate(flavors) if f != "attn" and flavor in (None, f)),
                 None)
        if i is not None:
            kw[field] = _get(state, f"blocks.{i}.{key}").shape[axis]
    return kw


def _pairs(a: torch.Tensor) -> torch.Tensor:
    """A complex [D, K] / [D, K, 1] tensor, or a real one whose trailing
    axis holds (re, im) ([D, K, 2] / [D, K, 1, 2]), as fp32 [D, K, 2]."""
    if a.is_complex():
        a = a.reshape(a.shape[0], -1)
        return torch.stack([a.real, a.imag], -1).float()
    return a.float().reshape(a.shape[0], a.shape[1], 2)


def _put(param: torch.Tensor, value: torch.Tensor, name: str) -> None:
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"{name}: shape {tuple(value.shape)} does not fit "
                         f"{tuple(param.shape)}")
    param.copy_(value)


@torch.no_grad()
def import_evo2(state: Dict[str, torch.Tensor], cfg: HyenaConfig, device=None) -> HyenaTower:
    """A `HyenaTower` of `cfg` on `device` (CUDA unless "cpu") filled from
    the vortex state dict `state`. Raises when the keys' operators or any
    shape disagree with `cfg`. Dense weights are `nn.Linear`'s [out, in] as
    vortex stores them; the fused `Wqkv` [3D, D] splits into q, k, v; a
    missing `filter.D` gives a zero skip; an mr `decay` [C, L] (the envelope
    vortex stores) replaces the [C] rate the config builds."""
    flavors = evo2_flavors(state)
    want = tuple(cfg.flavor(i) for i in range(cfg.num_layers))
    if flavors != want:
        raise ValueError(f"the checkpoint's operators {flavors} are not the config's {want}")
    tower = HyenaTower(cfg, resolve_device(device), torch_dtype(cfg.dtype))
    _put(tower.embed.weight, _get(state, "embedding_layer.weight"), "embedding_layer.weight")
    _put(tower.final_norm.scale, _get(state, "norm.scale"), "norm.scale")
    for i, bm in enumerate(tower.blocks):
        p = f"blocks.{i}"

        def put(param, key, value=None):
            _put(param, _get(state, f"{p}.{key}") if value is None else value, f"{p}.{key}")
        put(bm.ln1.scale, "pre_norm.scale")
        put(bm.ln2.scale, "post_norm.scale")
        for name, key in (("gate", "l1"), ("up", "l2"), ("down", "l3")):
            put(getattr(bm.mlp, name).weight, f"mlp.{key}.weight")
        if bm.flavor == "attn":
            wqkv = _get(state, f"{p}.inner_mha_cls.Wqkv.weight")
            for name, w in zip(("q", "k", "v"), wqkv.chunk(3, dim=0)):
                put(getattr(bm.attn, name).weight, "inner_mha_cls.Wqkv.weight", w)
            put(bm.attn.o.weight, "inner_mha_cls.out_proj.weight")
            continue
        mix, filt = bm.hyena, bm.hyena.filter
        put(mix.in_proj.weight, "projections.weight")
        put(mix.out_proj.weight, "out_filter_dense.weight")
        short = _get(state, f"{p}.filter.short_filter_weight")
        put(mix.short_filter, "filter.short_filter_weight",
            short.reshape(short.shape[0], short.shape[-1]))
        if _key(state, f"{p}.filter.D") is not None:
            put(mix.filter_bias, "filter.D")
        else:
            mix.filter_bias.zero_()
        if bm.flavor == "li":
            # in fp64, rounded once: the li filter raises each pole to powers
            # up to T, which magnifies a rounding error of its magnitude
            poles = _pairs(_get(state, f"{p}.filter.poles")).double()
            mag = torch.sqrt(poles[..., 0] ** 2 + poles[..., 1] ** 2).clamp(1e-6, 1 - 1e-6)
            phase = torch.atan2(poles[..., 1], poles[..., 0])
            put(filt.poles, "filter.poles",
                torch.stack([torch.log(mag / (1 - mag)), phase], -1).float())
            put(filt.residues, "filter.residues", _pairs(_get(state, f"{p}.filter.residues")))
            continue
        put(filt.h, "filter.h")
        if bm.flavor == "mr":
            filt.fit_decay_(_get(state, f"{p}.filter.decay").shape)
            put(filt.decay, "filter.decay")
    return tower
