"""Evo2/StripedHyena-2-style hybrid DNA tower (the port of
bioreason_tpu/models/evo2.py; reference `evo2.Evo2`, dna_llm.py:86-90).

A causal byte-level DNA LM that mixes hyena gated-convolution blocks with
periodic rotary-attention blocks (the "striped" pattern). A hyena block:

    x  = pre_norm(u) * mask                 # RMSNorm; pads zeroed for the convs
    z  = short_conv(projections(x))         # dense D -> 3D, depthwise causal conv
    x2, x1, v = split(z, 3)
    g  = x1 * v
    y  = x2 * (filter_conv(g) + D_skip * g)   # flavor-specific causal conv
    u  = u + out_filter_dense(y)
    u  = u + mlp.l3(gelu(mlp.l1(post_norm(u))) * mlp.l2(post_norm(u)))

Filter flavors: se (short explicit depthwise filter), mr (explicit filter
times an exponential decay envelope, applied by FFT), li (long implicit
filter in modal form, h[c, t] = Re(sum_k r_ck p_ck^t), materialized to the
sequence length and applied by FFT). The convolutions and FFTs run in fp32
(`F.conv1d`, `torch.fft`), as the JAX package runs them through XLA; the
attention blocks go through `models.attention.attention`, so `flash_fwd`
(and `flash_bwd` when the tower trains) on the card.

Parameters live in `HyenaTower` (an `nn.ModuleList` of blocks, each built
for its flavor); dense weights and the embedding are stored in the tower's
dtype, norm scales and every filter leaf in fp32 (the JAX masters; the
filter math reads them in fp32). `hyena_forward` runs the tower and returns
the final norm's output, or the tap: the pre-residual MLP output of block
`tap_layer` (the reference's forward hook on `blocks.N.mlp.l3`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from bioreason_tpu_torch.config import HyenaConfig
from bioreason_tpu_torch.models import layers as L
from bioreason_tpu_torch.models.attention import attention
from bioreason_tpu_torch.parallel import sp as SP
from bioreason_tpu_torch.utils.devices import resolve_device, torch_dtype


# ---------------------------------------------------------------------------
# filter primitives (fp32 in, the input's dtype out)
# ---------------------------------------------------------------------------

def depthwise_causal_conv(x: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """x [B, T, C], filt [C, K] -> the causal depthwise TRUE convolution
    y[t] = sum_tau filt[tau] * x[t - tau], same length, computed in fp32.
    `F.conv1d` computes a cross-correlation (as `conv_general_dilated`
    does), so the filter is flipped."""
    c, k = filt.shape
    xp = F.pad(x.float().transpose(1, 2), (k - 1, 0))              # [B, C, T + K - 1]
    out = F.conv1d(xp, filt.float().flip(-1)[:, None, :], groups=c)
    return out.transpose(1, 2).to(x.dtype)


def fft_causal_conv(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """x [B, T, C], h [C, L] -> the causal convolution through an fp32 FFT
    of length the least power of two >= T + L, so the circular convolution
    never wraps into the causal window; same length as x."""
    t, l = x.shape[1], h.shape[-1]
    n = 1 << max(t + l - 1, 0).bit_length()
    xf = torch.fft.rfft(x.float(), n=n, dim=1)                      # [B, F, C]
    hf = torch.fft.rfft(h.float(), n=n, dim=-1)                     # [C, F]
    y = torch.fft.irfft(xf * hf.t()[None], n=n, dim=1)[:, :t]
    return y.to(x.dtype)


def materialize_mr_filter(h: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """The medium filter: explicit taps h [C, L] times a decay envelope.
    A per-channel rate decay [C] gives exp(-softplus(decay) * t); a 2-D
    decay [C, L] is the envelope itself (imported checkpoints)."""
    h = h.float()
    decay = decay.float()
    if decay.dim() == 1:
        t = torch.arange(h.shape[-1], dtype=torch.float32, device=h.device)
        decay = torch.exp(-F.softplus(decay)[:, None] * t[None, :])
    return h * decay


def materialize_li_filter(poles: torch.Tensor, residues: torch.Tensor,
                          length: int) -> torch.Tensor:
    """The long implicit filter in modal form, h[c, t] = Re(sum_k r_ck p_ck^t),
    [C, length] fp32. poles [C, K, 2] hold (logit |p|, phase): the
    magnitude is sigmoid(logit) in (0, 1) for any value (training-safe);
    residues [C, K, 2] hold (re, im). The [C, K, length] terms are summed
    over K."""
    poles, residues = poles.float(), residues.float()
    mag = torch.sigmoid(poles[..., 0])
    phase = poles[..., 1]
    t = torch.arange(length, dtype=torch.float32, device=poles.device)
    mag_t = torch.exp(torch.log(mag + 1e-12)[..., None] * t)     # [C, K, T]
    ang = phase[..., None] * t                                   # [C, K, T]
    rr, ri = residues[..., 0, None], residues[..., 1, None]
    return (mag_t * (rr * torch.cos(ang) - ri * torch.sin(ang))).sum(1)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class HyenaFilter(nn.Module):
    """The flavor's filter leaves, fp32: se `h` [C, se_len]; mr `h`
    [C, medium_len] and `decay` [C] (or an imported [C, medium_len]
    envelope); li `poles` and `residues` [C, li_order, 2]."""

    def __init__(self, cfg: HyenaConfig, flavor: str, device=None):
        super().__init__()
        d = cfg.hidden_size

        def leaf(*shape):
            return nn.Parameter(torch.zeros(shape, device=device, dtype=torch.float32))
        if flavor == "se":
            self.h = leaf(d, cfg.se_filter_len)
        elif flavor == "mr":
            self.h = leaf(d, cfg.medium_filter_len)
            self.decay = leaf(d)
        elif flavor == "li":
            self.poles = leaf(d, cfg.li_order, 2)
            self.residues = leaf(d, cfg.li_order, 2)
        else:
            raise ValueError(f"unknown hyena flavor {flavor!r}")

    def fit_decay_(self, shape) -> None:
        """Make `decay` an [C, L] envelope when `shape` is the taps' [C, L]:
        imported checkpoints store the mr envelope itself in place of the
        [C] rate the config builds. Any other shape is left to the copy's
        shape check."""
        if tuple(shape) == tuple(self.h.shape) != tuple(self.decay.shape):
            self.decay = nn.Parameter(torch.empty(tuple(shape), device=self.decay.device,
                                                  dtype=torch.float32))


class HyenaMixer(nn.Module):
    def __init__(self, cfg: HyenaConfig, flavor: str, device=None, dtype=torch.float32):
        super().__init__()
        d = cfg.hidden_size
        self.in_proj = L.linear(d, 3 * d, False, device, dtype)
        self.short_filter = nn.Parameter(torch.zeros(3 * d, cfg.short_filter_len,
                                                     device=device, dtype=torch.float32))
        self.filter = HyenaFilter(cfg, flavor, device)
        self.filter_bias = nn.Parameter(torch.zeros(d, device=device, dtype=torch.float32))
        self.out_proj = L.linear(d, d, False, device, dtype)


class HyenaAttention(nn.Module):
    def __init__(self, d: int, device=None, dtype=torch.float32):
        super().__init__()
        self.q = L.linear(d, d, False, device, dtype)
        self.k = L.linear(d, d, False, device, dtype)
        self.v = L.linear(d, d, False, device, dtype)
        self.o = L.linear(d, d, False, device, dtype)


class HyenaBlock(nn.Module):
    """One block: `flavor` 'attn' holds `attn`, the others `hyena`."""

    def __init__(self, cfg: HyenaConfig, flavor: str, device=None, dtype=torch.float32):
        super().__init__()
        d = cfg.hidden_size
        self.flavor = flavor
        self.ln1 = L.RMSNorm(d, device)
        self.ln2 = L.RMSNorm(d, device)
        self.mlp = L.SwiGLU(d, cfg.intermediate_size, False, device, dtype)
        if flavor == "attn":
            self.attn = HyenaAttention(d, device, dtype)
        else:
            self.hyena = HyenaMixer(cfg, flavor, device, dtype)


class HyenaTower(nn.Module):
    """Parameters of the tower; `hyena_forward` runs it."""

    def __init__(self, cfg: HyenaConfig, device=None, dtype=torch.float32):
        super().__init__()
        self.embed = L.Embedding(cfg.vocab_size, cfg.hidden_size, device, dtype)
        self.blocks = nn.ModuleList(HyenaBlock(cfg, cfg.flavor(i), device, dtype)
                                    for i in range(cfg.num_layers))
        self.final_norm = L.RMSNorm(cfg.hidden_size, device)


def _normal(shape, generator, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


@torch.no_grad()
def init_filters_(tower: HyenaTower, generator: Optional[torch.Generator]) -> HyenaTower:
    """The filter leaves' random init with the JAX distributions
    (evo2.py:64-69,146-195): conv filters N(0, 0.02^2) times the envelope
    exp(-t / max(K / 4, 1)); mr decay 0; li poles (N(0, 1), 0.1 N(0, 1)) as
    (logit |p|, phase) and residues 0.1 / li_order N(0, 1); the D skip 0."""
    def conv_init(p):
        k = p.shape[-1]
        env = torch.exp(-torch.arange(k, dtype=torch.float32, device=p.device) / max(k / 4, 1.0))
        p.copy_(_normal(p.shape, generator, p.device) * 0.02 * env)

    for block in tower.blocks:
        if block.flavor == "attn":
            continue
        mix = block.hyena
        conv_init(mix.short_filter)
        mix.filter_bias.zero_()
        f = mix.filter
        if block.flavor in ("se", "mr"):
            conv_init(f.h)
        if block.flavor == "mr":
            f.decay.zero_()
        if block.flavor == "li":
            f.poles[..., 0].copy_(_normal(f.poles.shape[:2], generator, f.poles.device))
            f.poles[..., 1].copy_(_normal(f.poles.shape[:2], generator, f.poles.device) * 0.1)
            f.residues.copy_(_normal(f.residues.shape, generator, f.residues.device)
                             * (0.1 / f.residues.shape[1]))
    return tower


def init_hyena(cfg: HyenaConfig, seed: int = 0, device=None) -> HyenaTower:
    """A tower with random weights drawn from a `torch.Generator` seeded
    with `seed`: dense kernels and the embedding as `layers.init_normal_`
    draws them, the filters by `init_filters_`."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    tower = L.init_normal_(HyenaTower(cfg, device, torch_dtype(cfg.dtype)), gen)
    return init_filters_(tower, gen)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _hyena_mixer(block: HyenaBlock, h: torch.Tensor, cfg: HyenaConfig,
                 mask: torch.Tensor) -> torch.Tensor:
    dtype = h.dtype
    mix, fp = block.hyena, block.hyena.filter
    # sequence-sharded (parallel/sp_hyena.py, JAX evo2.py:198-231): the
    # convs cross chunk boundaries by halos and modal states
    sp = SP.sequence_sharding_enabled() and str(cfg.attention_impl).startswith("sp")
    if sp:
        from bioreason_tpu_torch.parallel.sp_hyena import sp_causal_conv, sp_li_conv
    conv = sp_causal_conv if sp else depthwise_causal_conv
    x = L.rmsnorm(block.ln1, h, cfg.norm_eps)
    x = x * mask[..., None].to(dtype)                 # pads zeroed for the convs
    z = conv(L.dense(mix.in_proj, x, dtype), mix.short_filter)
    x2, x1, v = z.chunk(3, dim=-1)
    g = x1 * v
    if block.flavor == "se":
        inner = conv(g, fp.h)
    elif block.flavor == "mr":
        inner = (sp_causal_conv(g, materialize_mr_filter(fp.h, fp.decay)) if sp
                 else fft_causal_conv(g, materialize_mr_filter(fp.h, fp.decay)))
    elif sp:
        inner = sp_li_conv(g, fp.poles, fp.residues)
    else:
        inner = fft_causal_conv(g, materialize_li_filter(fp.poles, fp.residues, g.shape[1]))
    inner = inner + g * mix.filter_bias.to(dtype)
    return h + L.dense(mix.out_proj, x2 * inner, dtype)     # gated conv: no activation


def _attn_mixer(block: HyenaBlock, h: torch.Tensor, cfg: HyenaConfig,
                mask: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    dtype = h.dtype
    b, t, _ = h.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    x = L.rmsnorm(block.ln1, h, cfg.norm_eps)
    q, k, v = L.qkv_proj(block.attn, x, dtype)
    q = L.apply_rope(q.reshape(b, t, nh, hd), positions, cfg.rope_theta)
    k = L.apply_rope(k.reshape(b, t, nh, hd), positions, cfg.rope_theta)
    a = attention(q, k, v.reshape(b, t, nh, hd), kv_mask=mask, causal=True,
                  impl=cfg.attention_impl)
    return h + L.dense(block.attn.o, a.reshape(b, t, -1), dtype)


def _gated_mlp(block: HyenaBlock, h: torch.Tensor,
               cfg: HyenaConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """ParallelGatedMLP l3(act(l1(x)) * l2(x)): returns (residual out, the
    pre-residual l3 output, which the tap reads). The gelu is exact (erf),
    as vortex's F.gelu."""
    dtype = h.dtype
    x = L.rmsnorm(block.ln2, h, cfg.norm_eps)
    g = L.dense(block.mlp.gate, x, dtype)
    g = F.gelu(g, approximate="none") if cfg.mlp_activation == "gelu" else F.silu(g)
    out = L.dense(block.mlp.down, g * L.dense(block.mlp.up, x, dtype), dtype)
    return h + out, out


def _block_forward(block: HyenaBlock, h, cfg: HyenaConfig, mask, positions):
    if block.flavor == "attn":
        h = _attn_mixer(block, h, cfg, mask, positions)
    else:
        h = _hyena_mixer(block, h, cfg, mask)
    return _gated_mlp(block, h, cfg)


def hyena_forward(tower: HyenaTower, cfg: HyenaConfig, input_ids: torch.Tensor,
                  attention_mask: Optional[torch.Tensor] = None,
                  tap_layer: Optional[int] = None) -> torch.Tensor:
    """Hidden states [B, T, H] in the compute dtype: the `blocks.<tap>.mlp.l3`
    output when `tap_layer` (default `cfg.embedding_tap_layer`) is >= 0 (no
    block after it runs, since none can change it), else the final norm's
    output. Each block is recomputed in backward when `cfg.remat` and
    autograd records."""
    b, t = input_ids.shape
    if attention_mask is None:
        attention_mask = torch.ones((b, t), dtype=torch.int32, device=input_ids.device)
    positions = L.positions_from_mask(attention_mask)
    sp = SP.tower_sharded(cfg.attention_impl)
    if sp:
        # sequence parallelism: this rank's chunk of the right-padded
        # sequence (causal ops never see the pads of later steps)
        input_ids, attention_mask, positions = (
            SP.shard_sequence(x) for x in (input_ids, attention_mask, positions))
    h = L.embed(tower.embed, input_ids, torch_dtype(cfg.dtype))
    tap = cfg.embedding_tap_layer if tap_layer is None else tap_layer
    out = None
    for i, block in enumerate(tower.blocks):
        if cfg.remat and torch.is_grad_enabled():
            h, mlp_out = checkpoint(_block_forward, block, h, cfg, attention_mask, positions,
                                    use_reentrant=False)
        else:
            h, mlp_out = _block_forward(block, h, cfg, attention_mask, positions)
        if i == tap:
            out = mlp_out
            break
    if out is None:
        out = L.rmsnorm(tower.final_norm, h, cfg.norm_eps)
    return SP.unshard_sequence(out, t) if sp else out
