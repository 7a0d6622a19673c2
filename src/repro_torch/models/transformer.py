"""Decoder-only transformer LM covering the dense / MoE / VLM families, the
port of :mod:`repro.models.transformer`.

Layers are stacked: the parameters of each sublayer position of the
repeating *unit* (gemma2's local/global pair, or one layer) hold a leading
(n_units,) axis, as in the reference, whose ``lax.scan`` over the units is
one Python loop here (``scan_layers`` and ``unroll`` run the same loop).
``remat`` recomputes each unit in the backward pass
(``torch.utils.checkpoint``); it changes no value.

Decode caches are stacked along the unit axis: ``cache = {"kv":
tuple_per_position({"k", "v"}), "len": ()}`` with k/v of shape (n_units, B,
KH, T, hd) and ``len`` a 0-d int32 tensor on the CPU.  Sliding-window
sublayers use a ring buffer of T = window slots (RoPE is applied at write
time with absolute positions, so ring rotation is transparent).

Entry points: :func:`init`, :func:`forward`, :func:`loss_fn`,
:func:`prefill`, :func:`decode_step`, :func:`init_decode_cache`.  The
reference's ``param_shardings`` (a mesh layout) waits for ROADMAP A.3e.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.collective.comm import resolve_device

from . import layers as L
from . import moe as M

__all__ = [
    "SubKind", "unit_pattern", "init", "forward", "loss_fn",
    "prefill", "decode_step", "init_decode_cache",
]


@dataclasses.dataclass(frozen=True)
class SubKind:
    """Static description of one sublayer in the repeating unit."""

    window: int | None
    moe: bool


def unit_pattern(cfg) -> list[SubKind]:
    """The repeating sublayer pattern (period divides n_layers)."""
    if cfg.local_global:
        # gemma2: sliding-window layer followed by a global layer
        return [SubKind(cfg.sliding_window, cfg.n_experts > 0),
                SubKind(None, cfg.n_experts > 0)]
    return [SubKind(cfg.sliding_window, cfg.n_experts > 0)]


def _n_units(cfg) -> int:
    period = len(unit_pattern(cfg))
    if cfg.n_layers % period:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole units of {period}")
    return cfg.n_layers // period


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_sublayer(init: L.Init, cfg, kind: SubKind) -> dict:
    p = {
        "attn_norm": L.init_norm(init, cfg, cfg.d_model),
        "attn": L.init_attention(init, cfg),
        "mlp_norm": L.init_norm(init, cfg, cfg.d_model),
    }
    if kind.moe:
        p["moe"] = M.init_moe(init, cfg)
    else:
        p["mlp"] = L.init_mlp(init, cfg)
    if cfg.post_norms:
        p["post_attn_norm"] = L.init_norm(init, cfg, cfg.d_model)
        p["post_mlp_norm"] = L.init_norm(init, cfg, cfg.d_model)
    return p


def init(generator, cfg, device=None) -> dict:
    """Params with per-sublayer-position stacks of shape (n_units, ...), on
    ``device`` (None: the card; "meta": shapes and dtypes only), drawn from
    ``generator`` (a ``torch.Generator`` on that device, or an int seed)."""
    init_ = L.Init.on(generator, device)
    stacked = init_.stacked(_n_units(cfg))
    return {
        "embed": L.init_embedding(init_, cfg),
        "units": tuple(_init_sublayer(stacked, cfg, kind) for kind in unit_pattern(cfg)),
        "final_norm": L.init_norm(init_, cfg, cfg.d_model),
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _positions_default(cfg, b, s, offset=0, device=None):
    pos = (torch.arange(s, dtype=torch.int32, device=device) + offset)[None].expand(b, s)
    if cfg.mrope_sections:
        return pos[None].expand(3, b, s)
    return pos


def _cos_sin(cfg, positions):
    return L.rope_cos_sin(positions, cfg.d_head, cfg.rope_theta, cfg.mrope_sections)


def _sublayer(p, x, cfg, kind: SubKind, cos_sin, cache):
    """One attention+MLP sublayer. Returns (x, aux) — aux per L.attention."""
    h = L.apply_norm(p["attn_norm"], x, cfg)
    h, aux = L.attention(p["attn"], h, cfg, cos_sin=cos_sin, causal=True,
                         window=kind.window, cache=cache)
    if cfg.post_norms:
        h = L.apply_norm(p["post_attn_norm"], h, cfg)
    x = x + h
    h = L.apply_norm(p["mlp_norm"], x, cfg)
    h = M.moe(p["moe"], h, cfg) if kind.moe else L.mlp(p["mlp"], h, cfg)
    if cfg.post_norms:
        h = L.apply_norm(p["post_mlp_norm"], h, cfg)
    return x + h, aux


def forward(params, tokens, cfg, positions=None):
    """tokens (B, S) → logits (B, S, V) f32.  Training/eval forward."""
    b, s = tokens.shape
    x = L.embed(params["embed"], tokens, cfg)
    pos = positions if positions is not None else _positions_default(cfg, b, s,
                                                                      device=tokens.device)
    cos_sin = _cos_sin(cfg, pos)
    pattern = unit_pattern(cfg)

    def body(h, unit_params):
        for i, kind in enumerate(pattern):
            h, _ = _sublayer(unit_params[i], h, cfg, kind, cos_sin, None)
        return h

    step = L.remat(body, cfg)
    for u in range(_n_units(cfg)):
        x = step(x, L.unit(params["units"], u))
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.unembed(params["embed"], x, cfg)


def loss_fn(params, batch, cfg):
    logits = forward(params, batch["tokens"], cfg, batch.get("positions"))
    return L.cross_entropy(logits, batch["labels"])


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode with stacked caches
# ---------------------------------------------------------------------------

def _cache_sizes(cfg, s_max):
    """Per-sublayer-position cache length (ring = window for local layers)."""
    return [min(k.window, s_max) if k.window is not None else s_max for k in unit_pattern(cfg)]


def init_decode_cache(cfg, batch: int, s_max: int, dtype=None, device=None) -> dict:
    """Zero caches for ``s_max`` positions on ``device`` (None: the card), in
    ``dtype`` (a torch dtype or its name; default ``cfg.dtype``)."""
    device = resolve_device(device)
    dt = dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype or cfg.dtype)
    n_units, kh, hd = _n_units(cfg), cfg.n_kv_heads, cfg.d_head
    kv = tuple(
        {"k": torch.zeros((n_units, batch, kh, t, hd), dtype=dt, device=device),
         "v": torch.zeros((n_units, batch, kh, t, hd), dtype=dt, device=device)}
        for t in _cache_sizes(cfg, s_max)
    )
    return {"kv": kv, "len": torch.zeros((), dtype=torch.int32)}


def prefill(params, tokens, cfg, positions=None, s_max: int | None = None):
    """Full forward that also materializes the KV caches (inference-prefill).

    Returns (last-token logits (B, V), cache).  KV tensors come straight out
    of the layer loop (no recompute, no per-token loop).
    """
    b, s = tokens.shape
    s_max = s_max or s
    x = L.embed(params["embed"], tokens, cfg)
    pos = positions if positions is not None else _positions_default(cfg, b, s,
                                                                      device=tokens.device)
    cos_sin = _cos_sin(cfg, pos)
    pattern = unit_pattern(cfg)
    sizes = _cache_sizes(cfg, s_max)

    def body(h, unit_params):
        kvs = []
        for i, kind in enumerate(pattern):
            h, (k, v) = _sublayer(unit_params[i], h, cfg, kind, cos_sin, None)
            t = min(sizes[i], s)
            pad = sizes[i] - t
            k = k[:, s - t:].movedim(1, 2)                         # (B, KH, t, hd)
            v = v[:, s - t:].movedim(1, 2)
            if pad:
                k = F.pad(k, (0, 0, 0, pad))
                v = F.pad(v, (0, 0, 0, pad))
            elif kind.window is not None and t == sizes[i]:
                # ring alignment: decode writes token p at slot p % window,
                # so position s-t+j must sit at slot (s-t+j) % t
                k = torch.roll(k, (s - t) % t, dims=2)
                v = torch.roll(v, (s - t) % t, dims=2)
            kvs.append((k, v))
        return h, tuple(kvs)

    step = L.remat(body, cfg)
    per_unit = []
    for u in range(_n_units(cfg)):
        x, kvs = step(x, L.unit(params["units"], u))
        per_unit.append(kvs)
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x[:, -1:], cfg)[:, 0]
    cache = {
        "kv": tuple({"k": torch.stack([kvs[i][0] for kvs in per_unit]),
                     "v": torch.stack([kvs[i][1] for kvs in per_unit])}
                    for i in range(len(pattern))),
        "len": torch.tensor(s, dtype=torch.int32),
    }
    return logits, cache


def decode_step(params, cache, token, cfg):
    """One new token (B, 1) against the cache → (logits (B, V), cache).

    Ring caches: slots are written at ``len % window`` with RoPE already
    applied at absolute positions, so no rotation is needed.  After prefill
    at s == window the ring restarts at slot ``len % window``, overwriting
    the oldest in-window entry — exact sliding-window semantics.  The given
    cache is not written.
    """
    b = token.shape[0]
    x = L.embed(params["embed"], token, cfg)
    pos_len = int(cache["len"])
    cos_sin = _cos_sin(cfg, _positions_default(cfg, b, 1, offset=pos_len, device=token.device))
    pattern = unit_pattern(cfg)
    new = [([], []) for _ in pattern]
    for u in range(_n_units(cfg)):
        unit_params = L.unit(params["units"], u)
        for i, kind in enumerate(pattern):
            sub = {"k": cache["kv"][i]["k"][u], "v": cache["kv"][i]["v"][u], "len": pos_len}
            x, nc = _sublayer(unit_params[i], x, cfg, kind, cos_sin, sub)
            new[i][0].append(nc["k"])
            new[i][1].append(nc["v"])
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg)[:, 0]
    kv = tuple({"k": torch.stack(ks), "v": torch.stack(vs)} for ks, vs in new)
    return logits, {"kv": kv, "len": torch.tensor(pos_len + 1, dtype=torch.int32)}
