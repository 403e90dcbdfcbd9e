"""Mamba-1 (selective SSM) mixer: ``repro.models.mamba``.

A whole sequence runs the recurrence  h_t = exp(dt_t A) h_{t-1} + dt_t
B_t u_t one of two ways, chosen by ``cfg.ssm_impl`` and ``training`` as
in the reference:

  * ``"pallas"`` and not training (the serving configs' prefill): the
    hand-written scan K7 (``kernels.selective_scan``) on CUDA tensors,
    its plain version on CPU tensors;
  * otherwise (``"assoc"``, and every training forward, since K7 has
    no gradient): the sequence cut into chunks, each solved by a
    log-depth inclusive scan with the reference's combine, chunk
    boundary states carried by an outer loop; plain tensor ops, so
    autograd takes its gradient.

Decode is the O(1) state update ``mamba_step``.  Parameters keep the
reference's names and layout, so ``bridge.params_from_numpy`` carries a
``repro.models.lm.init`` tree over unchanged.  Under a mesh the mixer
runs on whole weights: exact serving replicates every Mamba parameter
(``dist.sharding.SERVE_PARAM_RULES``), and a sharded train step gathers
them whole a layer group at a time (``dist.fsdp``).  The reference's
``shard_act`` hints, which place activations for GSPMD, have no
counterpart: no rank splits the mixer's d_inner compute.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.selective_scan import selective_scan
from .common import dense, dense_init
from .config import SSMConfig, ssm_dims


def mamba_init(gen: torch.Generator, cfg, dtype, device, lead=()):
    """The reference's layout and scales: S4D-real ``A_log`` = log(1..N)
    per channel, ``dt_bias`` the inverse softplus of dt drawn log-uniform
    in [1e-3, 1e-1], ``D`` ones; ``dt_proj``, ``dt_bias``, ``A_log`` and
    ``D`` in float32, the rest in ``dtype``.  ``lead`` is the stacked
    layer-group axis."""
    s: SSMConfig = cfg.ssm
    d_inner, dt_rank = ssm_dims(cfg)
    f32 = torch.float32
    A = torch.arange(1, s.d_state + 1, dtype=f32, device=device).expand(*lead, d_inner, -1)
    dt = torch.exp(torch.rand((*lead, d_inner), generator=gen, device=device, dtype=f32)
                   * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    conv_w = torch.randn((*lead, d_inner, s.d_conv), generator=gen, device=device, dtype=f32)
    return {
        "in_proj": dense_init(gen, cfg.d_model, 2 * d_inner, dtype, device, lead=lead),
        "conv_w": (conv_w / math.sqrt(s.d_conv)).to(dtype),
        "conv_b": torch.zeros((*lead, d_inner), dtype=dtype, device=device),
        "x_proj": dense_init(gen, d_inner, dt_rank + 2 * s.d_state, dtype, device, lead=lead),
        "dt_proj": dense_init(gen, dt_rank, d_inner, f32, device, lead=lead),
        "dt_bias": dt_bias,
        "A_log": torch.log(A),
        "D": torch.ones((*lead, d_inner), dtype=f32, device=device),
        "out_proj": dense_init(gen, d_inner, cfg.d_model, dtype, device, lead=lead),
    }


def _ssm_raw(p, u, cfg):
    """u (B, S, Di) post-conv -> the recurrence inputs (dt, B_c, C_c, A),
    float32."""
    s: SSMConfig = cfg.ssm
    _, dt_rank = ssm_dims(cfg)
    xp = dense(p["x_proj"], u)
    dt_in, Bc, Cc = torch.split(xp, [dt_rank, s.d_state, s.d_state], dim=-1)
    dt = F.softplus(dense(p["dt_proj"], dt_in.to(torch.float32)) + p["dt_bias"])
    A = -torch.exp(p["A_log"])                                   # (Di, N)
    return dt, Bc.to(torch.float32), Cc.to(torch.float32), A


def _ssm_coeffs(p, u, cfg):
    """u (B, S, Di) post-conv -> the scan coefficients (dA, dBu, C_c)."""
    dt, Bc, Cc, A = _ssm_raw(p, u, cfg)
    dA = torch.exp(dt[..., None] * A)                            # (B, S, Di, N)
    dBu = (dt * u.to(torch.float32))[..., None] * Bc[..., None, :]
    return dA, dBu, Cc


def _scan_chunk(h0, dA, dBu):
    """Every h_t of one chunk of h_t = dA_t h_{t-1} + dBu_t: h0 (B, Di, N),
    dA / dBu (B, C, Di, N).  A log-depth inclusive scan (Hillis-Steele)
    over the reference's combine (a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2)."""
    aa, bb = dA, dBu
    C = dA.shape[1]
    shift = 1
    while shift < C:
        aa, bb = (torch.cat([aa[:, :shift], aa[:, :-shift] * aa[:, shift:]], dim=1),
                  torch.cat([bb[:, :shift], bb[:, :-shift] * aa[:, shift:] + bb[:, shift:]], dim=1))
        shift *= 2
    return aa * h0[:, None] + bb                                 # (B, C, Di, N)


def _valid_lengths(valid_len, B: int, device) -> torch.Tensor:
    """``valid_len`` as a (B,) int64 tensor: an int or a 0-d tensor is one
    length for every row; a (B,) tensor is per-row (burst prefill)."""
    if isinstance(valid_len, int):
        # A fill, not a host-to-device copy (which would sync the stream).
        return torch.full((B,), valid_len, dtype=torch.int64, device=device)
    vl = valid_len.to(device=device, dtype=torch.int64)
    return vl.expand(B) if vl.dim() == 0 else vl


def _valid_mask(S: int, valid_len, B: int, device) -> torch.Tensor:
    """(B, S) bool mask of the real (not right-pad) positions."""
    vl = _valid_lengths(valid_len, B, device)
    return torch.arange(S, device=device)[None, :] < vl[:, None]


def _kernel_scan(p, u, cfg, valid_len=None):
    """The recurrence through K7: y (B, S, Di) with the D skip applied,
    and h_last (B, Di, N).  dt is zeroed at padded steps, where the
    kernel then carries the state unchanged (exp(0) = 1, dt u = 0)."""
    dt, Bc, Cc, A = _ssm_raw(p, u, cfg)
    if valid_len is not None:
        keep = _valid_mask(u.shape[1], valid_len, u.shape[0], u.device)
        dt = torch.where(keep[..., None], dt, 0.0)
    return selective_scan(u, dt, Bc.contiguous(), Cc.contiguous(), A, p["D"])


def mamba_mix(p, x, cfg, chunk: int, return_state: bool = False, training: bool = True,
              valid_len=None):
    """x (B, S, D) -> (B, S, D), the whole sequence at once.  With
    ``return_state`` also returns the decode cache {"h", "conv"}: the
    post-prompt state and the last d_conv - 1 pre-conv inputs.  The
    recurrence runs in K7 when ``cfg.ssm_impl == "pallas"`` and not
    ``training`` (the reference's rule: its kernel has no gradient),
    else in the chunked associative scan.

    ``valid_len`` (an int, a 0-d tensor, or a (B,) tensor of per-row
    lengths) marks positions >= valid_len as right-padding: their step
    is the identity (dt = 0), so the returned state is the state after
    the real tokens, and the conv tail ends at valid_len.  Outputs at
    padded positions are unspecified."""
    s: SSMConfig = cfg.ssm
    d_inner, _ = ssm_dims(cfg)
    B, S, _ = x.shape
    K = s.d_conv
    xz = dense(p["in_proj"], x)
    u, z = torch.chunk(xz, 2, dim=-1)                            # (B, S, Di) each
    u_raw = u                                                     # pre-conv (cache tail)

    # Depthwise causal conv of width d_conv, summed in the reference's order.
    w = p["conv_w"].to(u.dtype)                                   # (Di, K)
    upad = F.pad(u, (0, 0, K - 1, 0))
    conv = 0
    for i in range(K):
        conv = conv + upad[:, i:i + S] * w[:, i]
    u = F.silu(conv + p["conv_b"].to(u.dtype))

    if cfg.ssm_impl == "pallas" and not training:
        y, h_last = _kernel_scan(p, u, cfg, valid_len)
    else:
        dA, dBu, Cc = _ssm_coeffs(p, u, cfg)
        if valid_len is not None:
            keep = _valid_mask(S, valid_len, B, x.device)[..., None, None]
            dA = torch.where(keep, dA, 1.0)
            dBu = torch.where(keep, dBu, 0.0)
        chunk = min(chunk, S)
        while S % chunk:
            chunk -= 1
        h = torch.zeros((B, d_inner, s.d_state), dtype=torch.float32, device=x.device)
        hs = []
        for c0 in range(0, S, chunk):
            hc = _scan_chunk(h, dA[:, c0:c0 + chunk], dBu[:, c0:c0 + chunk])
            h = hc[:, -1]
            hs.append(hc)
        h_last = h
        hs = torch.cat(hs, dim=1)
        y = torch.einsum("bsdn,bsn->bsd", hs, Cc) + p["D"] * u.to(torch.float32)
    # (K7 applies the D skip itself.)
    y = (y * F.silu(z.to(torch.float32))).to(x.dtype)
    out = dense(p["out_proj"], y)
    if not return_state:
        return out
    if valid_len is None:
        tail = u_raw[:, S - (K - 1):] if S >= K - 1 else F.pad(u_raw, (0, 0, K - 1 - S, 0))
    else:
        # The window of d_conv - 1 pre-conv inputs ending at each row's
        # valid_len; the left zero-pad makes valid_len < d_conv - 1 match
        # the short-prompt branch above.
        upad_l = F.pad(u_raw, (0, 0, K - 1, 0))
        vl = _valid_lengths(valid_len, B, x.device)
        idx = vl[:, None] + torch.arange(K - 1, device=x.device)[None, :]
        tail = torch.gather(upad_l, 1, idx[..., None].expand(B, K - 1, d_inner))
    return out, {"h": h_last, "conv": tail}


def mamba_cache_init(cfg, batch: int, dtype, device, lead=()):
    """The decode cache of ``batch`` rows: h (*lead, batch, Di, N) float32
    and the conv tail (*lead, batch, d_conv - 1, Di) in ``dtype``, zeros."""
    s: SSMConfig = cfg.ssm
    d_inner, _ = ssm_dims(cfg)
    return {
        "h": torch.zeros((*lead, batch, d_inner, s.d_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((*lead, batch, s.d_conv - 1, d_inner), dtype=dtype, device=device),
    }


def mamba_step(p, x, cfg, cache):
    """One decode token: x (B, 1, D) and the cache {"h", "conv"} ->
    ((B, 1, D), the new cache).  The cache passed in is not written."""
    xz = dense(p["in_proj"], x[:, 0])
    u, z = torch.chunk(xz, 2, dim=-1)                            # (B, Di)

    hist = torch.cat([cache["conv"], u[:, None].to(cache["conv"].dtype)], dim=1)
    w = p["conv_w"].to(u.dtype)                                   # (Di, K)
    conv = torch.einsum("bkd,dk->bd", hist.to(u.dtype), w) + p["conv_b"].to(u.dtype)
    uc = F.silu(conv)

    dA, dBu, Cc = _ssm_coeffs(p, uc[:, None], cfg)                # (B, 1, Di, N), ...
    h = cache["h"] * dA[:, 0] + dBu[:, 0]
    y = torch.einsum("bdn,bn->bd", h, Cc[:, 0]) + p["D"] * uc.to(torch.float32)
    y = (y * F.silu(z.to(torch.float32))).to(x.dtype)
    out = dense(p["out_proj"], y[:, None])
    return out, {"h": h, "conv": hist[:, 1:]}
