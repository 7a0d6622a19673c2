"""Mixture-of-Experts layer (qwen2-moe / mixtral families), the port of
:mod:`repro.models.moe`.

Two compute paths, chosen by sequence length, as in the reference:

  * **train / prefill** (S > 1): per-sequence capacity-based dispatch
    (GShard-style, group = sequence).  Tokens are routed top-k, sorted by
    expert id within their sequence (a stable sort), and placed into a
    (B, E, C, d) buffer with C = ceil(S·k/E · capacity_factor) rounded up to
    a multiple of 8.  Overflow assignments are dropped into a sentinel slot.
  * **decode** (S == 1): per-token gather of the k selected experts'
    weights, or, with ``cfg.moe_decode_groups``, the capacity dispatch over
    groups of the batch.

The outputs are combined without atomics: each token's k contributions are
added in a fixed order (ascending expert id, the order in which the
reference's scatter-add visits them), so a rerun gives the same bits.
Shared experts (qwen2-moe) are a dense SwiGLU gated by a learned sigmoid.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import Init, dtype_of

__all__ = ["init_moe", "moe", "capacity"]


def capacity(cfg, s: int) -> int:
    c = int(math.ceil(s * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    return max(8, -(-c // 8) * 8)        # sublane-aligned, as the reference


def init_moe(init: Init, cfg) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_expert_ff
    dt = dtype_of(cfg)
    si, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {
        "router": init.normal((d, e), si, torch.float32),    # always f32
        "we_gate": init.normal((e, d, f), si, dt),
        "we_up": init.normal((e, d, f), si, dt),
        "we_down": init.normal((e, f, d), so, dt),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        p["ws_gate"] = init.normal((d, fs), si, dt)
        p["ws_up"] = init.normal((d, fs), si, dt)
        p["ws_down"] = init.normal((fs, d), 1.0 / math.sqrt(fs), dt)
        p["w_shared_gate"] = init.normal((d, 1), si, dt)
    return p


def _route(p, x, cfg):
    """x (..., d) → (weights (..., k) f32, ids (..., k) int64)."""
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    # lax.top_k breaks ties toward the lower index; so does a stable
    # descending sort
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[..., :cfg.top_k], ids[..., :cfg.top_k]
    return w / w.sum(-1, keepdim=True).clamp_min(1e-9), ids   # renormalized top-k


def _dispatch_slots(ids, n_experts: int, cap: int):
    """ids (B, S, k) → the buffer slot of each assignment (B, S·k), in token
    order: expert·cap + its rank among that expert's assignments of the
    sequence (by token), or the sentinel n_experts·cap when past ``cap``."""
    b = ids.shape[0]
    flat_e = ids.reshape(b, -1)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(1, order)
    counts = F.one_hot(flat_e, n_experts).sum(1)                  # (B, E)
    starts = counts.cumsum(-1) - counts                           # exclusive
    pos = torch.arange(flat_e.shape[1], device=ids.device)[None] - starts.gather(1, se)
    slot_sorted = torch.where(pos < cap, se * cap + pos, n_experts * cap)
    return torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)


def _ffn(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def _expert_ffn(h, p, cfg):
    """h (..., E, C, d) → (..., E, C, d).

    With ``cfg.moe_scan_experts`` the experts run one at a time (the
    reference's FSDP layout gathers one expert's weights a step)."""
    if not cfg.moe_scan_experts:
        g = torch.einsum("becd,edf->becf", h, p["we_gate"])
        u = torch.einsum("becd,edf->becf", h, p["we_up"])
        return torch.einsum("becf,efd->becd", F.silu(g) * u, p["we_down"])
    return torch.stack([
        _ffn(h[..., e, :, :], p["we_gate"][e], p["we_up"][e], p["we_down"][e])
        for e in range(h.shape[-3])
    ], dim=-3)


def _shared(p, x, cfg):
    if "ws_gate" not in p:
        return 0.0
    y = _ffn(x, p["ws_gate"], p["ws_up"], p["ws_down"])
    gate = torch.sigmoid((x @ p["w_shared_gate"]).float())
    return y * gate.to(y.dtype)


def _moe_dispatch(p, x, cfg):
    """Capacity-based per-sequence dispatch.  x (B, S, d)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    c = capacity(cfg, s)
    w, ids = _route(p, x, cfg)                                    # (B, S, k)
    slot = _dispatch_slots(ids, e, c)                             # (B, S·k)
    bidx = torch.arange(b, device=x.device)[:, None]
    # kept slots are distinct; every dropped copy lands in the sentinel row,
    # which is cut before the experts run
    buf = x.new_zeros(b, e * c + 1, d).index_put((bidx, slot), x.repeat_interleave(k, dim=1))
    out = _expert_ffn(buf[:, :e * c].reshape(b, e, c, d), p, cfg).reshape(b, e * c, d)
    out = torch.cat([out, out.new_zeros(b, 1, d)], dim=1)
    contrib = out[bidx, slot] * w.reshape(b, s * k, 1).to(out.dtype)
    # add each token's contributions in ascending expert id, into zeros of
    # x's dtype, as the reference's scatter-add does
    by_expert = ids.argsort(dim=-1)[..., None].expand(b, s, k, d)
    contrib = contrib.reshape(b, s, k, d).gather(2, by_expert)
    y = torch.zeros_like(x)
    for j in range(k):
        y = y + contrib[:, :, j]
    return y


def _moe_gather(p, x, cfg):
    """Per-token expert-weight gather — the decode (S == 1) path."""
    w, ids = _route(p, x, cfg)                                    # (B, 1, k)
    wg = p["we_gate"][ids[:, 0]]                                  # (B, k, d, f)
    wu = p["we_up"][ids[:, 0]]
    wd = p["we_down"][ids[:, 0]]                                  # (B, k, f, d)
    xt = x[:, 0]                                                  # (B, d)
    g = torch.einsum("bd,bkdf->bkf", xt, wg)
    u = torch.einsum("bd,bkdf->bkf", xt, wu)
    yk = torch.einsum("bkf,bkfd->bkd", F.silu(g) * u, wd)
    y = torch.einsum("bkd,bk->bd", yk, w[:, 0].to(yk.dtype))
    return y[:, None, :]


def moe(p, x, cfg):
    if x.shape[1] == 1:
        b, _, d = x.shape
        g = cfg.moe_decode_groups
        if g and b % g == 0:
            # grouped capacity dispatch for decode: one group per data shard
            y = _moe_dispatch(p, x.reshape(g, b // g, d), cfg).reshape(b, 1, d)
        else:
            y = _moe_gather(p, x, cfg)
    else:
        y = _moe_dispatch(p, x, cfg)
    return y + _shared(p, x, cfg)
