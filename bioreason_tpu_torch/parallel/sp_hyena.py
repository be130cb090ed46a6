"""Sequence parallelism for the Evo2 / StripedHyena tower (the port of
bioreason_tpu/parallel/sp_hyena.py). Both ops are exact, on the local
chunk of a sequence split by `parallel/sp.py`'s scope:

* `sp_causal_conv`: a causal depthwise filter of K taps needs the previous
  K-1 steps, so each rank receives its left neighbour's tail (one
  `comm.ppermute`; rank 0 receives zeros, the causal zero pad) and convolves
  locally. Long filters (K > 16, the materialized hyena_mr) take the FFT
  conv, short ones the direct one. A chunk shorter than K-1 falls back to
  gathering the whole sequence.
* `sp_li_conv`: the modal filter h[c,t] = Re(sum_k r_ck p_ck^t) is a
  diagonal recurrence, so the state crossing a chunk boundary is K complex
  numbers per channel: each rank FFT-convolves its chunk, computes its end
  state E_k = sum_t p_k^(C-1-t) g[t], all-gathers the [B, D, K] end states,
  forms its prefix state S_k = sum_(j<rank) p_k^(C(rank-1-j)) E_k^(j) and adds
  the closed-form tail Re(sum_k r_k p_k^(t+1) S_k). Real and imaginary parts
  travel as separate real tensors (gloo carries no complex ones).
* the tower's causal attention goes through `sp.sp_attention(causal=True)`.
"""

from __future__ import annotations

import torch

from bioreason_tpu_torch.parallel import comm
from bioreason_tpu_torch.parallel import sp as _sp


def sp_causal_conv(x: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """x [B, C, Ch] (this rank's chunk), filt [Ch, K] -> the chunk of
    `evo2.depthwise_causal_conv` of the whole sequence."""
    from bioreason_tpu_torch.models.evo2 import depthwise_causal_conv, fft_causal_conv
    ax = _sp._axis()
    k, c = filt.shape[-1], x.shape[1]
    conv = fft_causal_conv if k > 16 else depthwise_causal_conv
    halo = k - 1
    if halo == 0:
        return conv(x, filt)
    if c >= halo:
        recv = comm.ppermute(x[:, c - halo:], ax, [(i, i + 1) for i in range(ax.size - 1)])
        return conv(torch.cat([recv, x], 1), filt)[:, halo:]
    full = comm.all_gather_sum(x, ax, 1)
    return conv(full, filt)[:, ax.index * c:(ax.index + 1) * c]


def sp_li_conv(g: torch.Tensor, poles: torch.Tensor, residues: torch.Tensor) -> torch.Tensor:
    """g [B, C, D] (this rank's chunk), poles / residues [D, K, 2] -> the
    chunk of the whole sequence's hyena_li convolution, in g's dtype."""
    from bioreason_tpu_torch.models.evo2 import fft_causal_conv, materialize_li_filter
    ax = _sp._axis()
    n, c = ax.size, g.shape[1]
    gf = g.float()
    y = fft_causal_conv(gf, materialize_li_filter(poles, residues, c))
    mag = torch.sigmoid(poles[..., 0].float())                      # [D, K]
    phase = poles[..., 1].float()
    log_mag = torch.log(mag + 1e-12)

    def cpow(expo):
        m = torch.exp(log_mag * expo)
        a = phase * expo
        return m * torch.cos(a), m * torch.sin(a)

    tloc = torch.arange(c, dtype=torch.float32, device=g.device)
    w_re, w_im = cpow((c - 1.0 - tloc)[:, None, None])              # [C, D, K]
    e_re = torch.einsum("btd,tdk->bdk", gf, w_re)
    e_im = torch.einsum("btd,tdk->bdk", gf, w_im)
    eg_re = comm.all_gather_sum(e_re[None], ax, 0)                  # [n, B, D, K]
    eg_im = comm.all_gather_sum(e_im[None], ax, 0)
    j = torch.arange(n, dtype=torch.float32, device=g.device)
    d_exp = c * (float(ax.index) - 1.0 - j)
    valid = (j < ax.index).float()
    f_re, f_im = cpow(torch.clamp(d_exp, min=0.0)[:, None, None])   # [n, D, K]
    f_re = f_re * valid[:, None, None]
    f_im = f_im * valid[:, None, None]
    s_re = (torch.einsum("ndk,nbdk->bdk", f_re, eg_re)
            - torch.einsum("ndk,nbdk->bdk", f_im, eg_im))
    s_im = (torch.einsum("ndk,nbdk->bdk", f_re, eg_im)
            + torch.einsum("ndk,nbdk->bdk", f_im, eg_re))
    rr, ri = residues[..., 0].float(), residues[..., 1].float()
    a_re = rr * s_re - ri * s_im
    a_im = rr * s_im + ri * s_re
    q_re, q_im = cpow((tloc + 1.0)[:, None, None])
    y_cross = (torch.einsum("bdk,tdk->btd", a_re, q_re)
               - torch.einsum("bdk,tdk->btd", a_im, q_im))
    return (y + y_cross).to(g.dtype)
