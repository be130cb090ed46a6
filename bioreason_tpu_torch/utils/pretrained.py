"""Local pretrained checkpoints as (config, module) pairs (the port of
bioreason_tpu/utils/pretrained.py; it reads `json`, `torch` and the port's
own safetensors reader only).

The reference builds its towers from the HF hub (dna_llm.py:64-90:
`AutoModelForCausalLM` Qwen3 with its tokenizer and the DNA special
tokens, `AutoModelForMaskedLM` NT-v2 with its tokenizer, or `evo2.Evo2`).
Here LOCAL directories as `save_pretrained` leaves them are read:
`config.json`, weights (`utils/hf_import`) and tokenizer files.
`load_pretrained_fusion` is the one-call counterpart of the reference
constructor: configs from the `config.json` files, the weights into the
port's modules, both tokenizers (the DNA tokens appended as dna_llm.py:72-74
does, never resizing the embedding: Qwen3's vocab is padded to 151,936 rows
for 151,669 tokens, so the three new ids must land in the slack, which is
checked), and a fresh DNA projection as the reference's `nn.Linear`
(dna_llm.py:97), drawn from a `torch.Generator` seeded with `seed`.

`base_record` / `check_base` describe a pretrained base so that a
checkpoint trained on it can be paired with it again: the directories and a
fingerprint of each weights file and `config.json`.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional, Tuple

import torch

from bioreason_tpu_torch.config import DecoderConfig, EncoderConfig, FusionConfig, HyenaConfig
from bioreason_tpu_torch.utils.devices import resolve_device


def _read_config(path: str) -> Dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def decoder_config_from_hf(path: str, **overrides) -> DecoderConfig:
    """A DecoderConfig from a local HF Qwen3 or Qwen3-MoE directory's
    config.json; a MoE whose layers are not all sparse is refused (JAX
    pretrained.py:61-70)."""
    c = _read_config(path)
    arch = (c.get("architectures") or [""])[0]
    if "Qwen3" not in arch and c.get("model_type", "") not in ("qwen3", "qwen3_moe"):
        raise ValueError(f"{path}: expected a Qwen3-family checkpoint, got "
                         f"architectures={c.get('architectures')}")
    kw = dict(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        intermediate_size=c["intermediate_size"], num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"],
        num_kv_heads=c.get("num_key_value_heads", c["num_attention_heads"]),
        head_dim=c.get("head_dim", c["hidden_size"] // c["num_attention_heads"]),
        rope_theta=float(c.get("rope_theta", 1_000_000.0)),
        rms_norm_eps=float(c.get("rms_norm_eps", 1e-6)),
        tie_word_embeddings=bool(c.get("tie_word_embeddings", True)))
    if c.get("num_experts"):                         # Qwen3-MoE (e.g. 30B-A3B)
        if c.get("mlp_only_layers") or c.get("decoder_sparse_step", 1) != 1:
            raise ValueError(f"{path}: mixed dense/sparse Qwen3-MoE layouts "
                             "(mlp_only_layers/decoder_sparse_step) are not "
                             "supported — all layers must be sparse")
        kw.update(num_experts=c["num_experts"],
                  num_experts_per_tok=c.get("num_experts_per_tok", 8),
                  moe_intermediate_size=c["moe_intermediate_size"],
                  norm_topk_prob=bool(c.get("norm_topk_prob", True)))
    kw.update(overrides)
    return DecoderConfig(**kw)


def encoder_config_from_hf(path: str, use_swiglu: Optional[bool] = None,
                           **overrides) -> EncoderConfig:
    """An EncoderConfig from a local HF ESM / NT-v2 directory's config.json
    (rotary only). `use_swiglu` normally comes from the weights
    (`hf_import.esm_layout`)."""
    c = _read_config(path)
    pe = c.get("position_embedding_type", "absolute")
    if pe != "rotary":
        raise ValueError(f"{path}: only rotary ESM encoders are supported (NT-v2 family); "
                         f"got position_embedding_type={pe!r}")
    kw = dict(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        intermediate_size=c["intermediate_size"], num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"], rope_theta=10_000.0,
        norm_eps=float(c.get("layer_norm_eps", 1e-12)),
        use_swiglu=True if use_swiglu is None else bool(use_swiglu), attn_bias=True,
        mlp_bias=bool(c.get("add_bias_fnn", True)),      # NT-v2: add_bias_fnn=False
        token_dropout=bool(c.get("token_dropout", False)),
        mask_token_id=int(c.get("mask_token_id", 2)))
    kw.update(overrides)
    return EncoderConfig(**kw)


def load_pretrained_decoder(path: str, device=None, **overrides):
    """(DecoderConfig, Qwen3Decoder on `device`, CUDA unless "cpu")."""
    from bioreason_tpu_torch.models.qwen3 import Qwen3Decoder
    from bioreason_tpu_torch.utils.devices import torch_dtype
    from bioreason_tpu_torch.utils.hf_import import import_qwen3, load_hf_state_dict
    cfg = decoder_config_from_hf(path, **overrides)
    dec = Qwen3Decoder(cfg, resolve_device(device), torch_dtype(cfg.dtype))
    return cfg, import_qwen3(load_hf_state_dict(path), dec)


def load_pretrained_encoder(path: str, device=None, **overrides):
    """(EncoderConfig, NTEncoder on `device`), its MLP and bias layout read
    from the keys."""
    from bioreason_tpu_torch.models.nt_encoder import NTEncoder
    from bioreason_tpu_torch.utils.devices import torch_dtype
    from bioreason_tpu_torch.utils.hf_import import esm_layout, import_esm, load_hf_state_dict
    state = load_hf_state_dict(path)
    layout = esm_layout(state)
    cfg = encoder_config_from_hf(path, **{**layout, **overrides})
    rows = state.get("esm.embeddings.word_embeddings.weight",
                     state.get("embeddings.word_embeddings.weight"))
    if rows is not None and rows.shape[0] != cfg.vocab_size:
        raise ValueError(f"{path}: config vocab_size {cfg.vocab_size} != embedding rows "
                         f"{rows.shape[0]}")
    enc = NTEncoder(cfg, resolve_device(device), torch_dtype(cfg.dtype))
    return cfg, import_esm(state, enc)


def load_pretrained_evo2(path: str, embedding_tap_layer: int = -1, device=None,
                         **overrides):
    """A local Evo2 / StripedHyena-2 checkpoint directory (vortex `.pt`
    weights) -> (HyenaConfig, HyenaTower on `device`, CUDA unless "cpu").

    Width, inner size, depth, operators and filter sizes come from the
    weights' shapes; heads from a head_dim of 128 where it divides the width
    (Evo2's 1920 / 128 = 15), else 8. An optional config.json's
    `num_attention_heads` and `rotary_emb_base` override them, and
    `overrides` (HyenaConfig fields) override everything."""
    from bioreason_tpu_torch.utils.evo2_import import config_sizes, import_evo2
    from bioreason_tpu_torch.utils.hf_import import load_hf_state_dict
    state = load_hf_state_dict(path)
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


def load_dna_tokenizer(path: str):
    """The k-mer tokenizer of the checkpoint's vocab.txt (the ids of the
    downloaded NT checkpoint); the default layout where there is none."""
    from bioreason_tpu_torch.data.nt_tokenizer import KmerTokenizer
    vocab_file = os.path.join(path, "vocab.txt")
    if os.path.exists(vocab_file):
        return KmerTokenizer.from_vocab_file(vocab_file)
    return KmerTokenizer()


@torch.no_grad()
def load_pretrained_fusion(llm_dir: str, dna_dir: Optional[str] = None,
                           max_length_text: int = 512, max_length_dna: int = 2048,
                           seed: int = 0, dtype: str = "bfloat16",
                           evo2_dir: Optional[str] = None, dna_embedding_layer: int = -1,
                           device=None) -> Tuple[FusionConfig, object, object, object]:
    """The fusion model from local checkpoints: (FusionConfig, FusionModel
    on `device` (CUDA unless "cpu"), text tokenizer, DNA tokenizer).

    Every weight but the DNA projection is the checkpoint's, in the towers'
    `dtype`; the projection is drawn fresh, N(0, 1/d_dna) with a zero bias
    (pretrained.py:218-227), from a generator seeded with `seed`.
    `dna_dir=None` and no `evo2_dir` gives an LLM-only model: a tiny NT
    encoder drawn from `seed + 1` that the pasted-text prompts never feed
    (the DNA tokenizer is then None); `evo2_dir` selects the Evo2 tower
    with the char tokenizer and the tap `dna_embedding_layer`."""
    from bioreason_tpu_torch.data.text_tokenizer import load_hf_tokenizer
    from bioreason_tpu_torch.models import layers as L
    from bioreason_tpu_torch.models.fusion import FusionModel
    from bioreason_tpu_torch.models.nt_encoder import NTEncoder
    from bioreason_tpu_torch.utils.devices import torch_dtype
    device = resolve_device(device)
    tok = load_hf_tokenizer(llm_dir)
    dec_cfg, decoder = load_pretrained_decoder(llm_dir, device, dtype=dtype)
    for name, tid in (("<|dna_start|>", tok.dna_start_id), ("<|dna_pad|>", tok.dna_pad_id),
                      ("<|dna_end|>", tok.dna_end_id)):
        if tid is None or tid < 0 or tid >= dec_cfg.vocab_size:
            raise ValueError(
                f"special token {name} id {tid} does not fit in the model vocab "
                f"({dec_cfg.vocab_size}); the reference relies on the Qwen3 embedding being "
                f"padded past len(tokenizer) (dna_llm.py:72-74 adds tokens without resizing)")

    hyena_cfg, enc_cfg, dna_tok = None, EncoderConfig.tiny(), None
    if evo2_dir is not None:
        from bioreason_tpu_torch.data.char_tokenizer import CharDNATokenizer
        hyena_cfg, encoder = load_pretrained_evo2(evo2_dir, dna_embedding_layer, device,
                                                  dtype=dtype)
        dna_tok = CharDNATokenizer()
    elif dna_dir is None:
        encoder = L.init_normal_(NTEncoder(enc_cfg, device, torch_dtype(enc_cfg.dtype)),
                                 torch.Generator(device=device).manual_seed(seed + 1))
    else:
        enc_cfg, encoder = load_pretrained_encoder(dna_dir, device, dtype=dtype)
        dna_tok = load_dna_tokenizer(dna_dir)
        if dna_tok.vocab_size != enc_cfg.vocab_size:
            raise ValueError(f"DNA tokenizer vocab {dna_tok.vocab_size} != encoder vocab "
                             f"{enc_cfg.vocab_size}; supply the checkpoint's vocab.txt in "
                             f"{dna_dir}")

    cfg = FusionConfig(decoder=dec_cfg, encoder=enc_cfg,
                       encoder_kind="evo2" if evo2_dir is not None else "nt", hyena=hyena_cfg,
                       dna_pad_token_id=tok.dna_pad_id, max_length_text=max_length_text,
                       max_length_dna=max_length_dna)
    model = FusionModel(cfg, device="meta")
    model.decoder, model.encoder = decoder, encoder
    d_dna = cfg.dna_tower.hidden_size
    proj = L.linear(d_dna, dec_cfg.hidden_size, True, device, torch.float32)
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn((d_dna, dec_cfg.hidden_size), generator=gen, device=device)
    proj.weight.copy_(draw.t() * d_dna ** -0.5)
    proj.bias.zero_()
    model.dna_projection = proj
    return cfg, model, tok, dna_tok


# -- provenance of a pretrained base -----------------------------------------

def _fingerprint(path: str) -> Dict[str, object]:
    """A safetensors file: its size and the sha256 of its header; another
    file: its size and the sha256 of its first MiB."""
    if path.endswith(".safetensors"):
        from bioreason_tpu_torch.utils.safetensors_io import header_fingerprint
        return header_fingerprint(path)
    with open(path, "rb") as f:
        head = f.read(1 << 20)
    return {"size": os.path.getsize(path), "head_sha256": hashlib.sha256(head).hexdigest()}


def base_record(llm_dir: str, dna_dir: Optional[str] = None,
                evo2_dir: Optional[str] = None) -> Dict[str, object]:
    """What names a pretrained base: its directories (absolute) and a
    fingerprint of each weights file and config.json in them."""
    from bioreason_tpu_torch.utils.hf_import import weight_files
    dirs = {"hf_llm_dir": llm_dir, "hf_dna_dir": dna_dir, "evo2_dir": evo2_dir}
    dirs = {k: (os.path.abspath(v) if v else None) for k, v in dirs.items()}
    files = {}
    for d in dirs.values():
        if d is None:
            continue
        names = list(weight_files(d))
        if os.path.exists(os.path.join(d, "config.json")):
            names.append(os.path.join(d, "config.json"))
        files.update({f: _fingerprint(f) for f in names})
    return {**dirs, "base_files": files}


def check_base(record: Dict[str, object]) -> None:
    """Raise unless every directory and file of `record` (`base_record`) is
    there with the fingerprint it had: a missing or changed base is
    refused, never replaced by another."""
    for key in ("hf_llm_dir", "hf_dna_dir", "evo2_dir"):
        d = record.get(key)
        if d is not None and not os.path.isdir(d):
            raise FileNotFoundError(f"the pretrained base's {key} {d} is gone")
    for f, want in record["base_files"].items():
        if not os.path.isfile(f):
            raise FileNotFoundError(f"the pretrained base's file {f} is gone")
        got = _fingerprint(f)
        if got != want:
            raise ValueError(f"the pretrained base's file {f} changed: {want} when the "
                             f"checkpoint was written, {got} now")
