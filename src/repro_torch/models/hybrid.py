"""Zamba2-style hybrid: a Mamba2 backbone and one *shared* attention block
applied after every ``cfg.attn_every`` Mamba layers (arXiv:2411.15242), the
port of :mod:`repro.models.hybrid`.

The shared block's parameters exist once; each of its ``n_units``
applications keeps its own KV cache, and its gradient is the sum over every
application.  As in the reference, the shared block attends over the hidden
state x rather than concat(x, x_embed).

Structure: n_units = n_layers // attn_every units of (attn_every Mamba
layers → the shared block), then a tail of n_layers % attn_every Mamba
layers; ``tail`` is None when there are none (``smoke()``: 2 layers at
``attn_every`` 2).  Parameters: ``{"embed", "units": stacked (n_units,
attn_every, ...), "tail": stacked (n_tail, ...) or None, "shared",
"final_norm"}``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.collective.comm import resolve_device

from . import layers as L
from . import ssm as S

__all__ = [
    "init", "forward", "loss_fn", "prefill", "decode_step", "init_decode_cache",
]


def _unit_counts(cfg):
    n_units = cfg.n_layers // cfg.attn_every
    return n_units, cfg.n_layers - n_units * cfg.attn_every


def init(generator, cfg, device=None) -> dict:
    """Params on ``device`` (None: the card; "meta": shapes and dtypes
    only), drawn from ``generator`` (a ``torch.Generator`` on that device,
    or an int seed)."""
    init_ = L.Init.on(generator, device)
    n_units, n_tail = _unit_counts(cfg)
    return {
        "embed": L.init_embedding(init_, cfg),
        "units": S.init_layer(init_.stacked(n_units).stacked(cfg.attn_every), cfg),
        "tail": S.init_layer(init_.stacked(n_tail), cfg) if n_tail else None,
        "shared": {
            "attn_norm": L.init_norm(init_, cfg, cfg.d_model),
            "attn": L.init_attention(init_, cfg),
            "mlp_norm": L.init_norm(init_, cfg, cfg.d_model),
            "mlp": L.init_mlp(init_, cfg),
        },
        "final_norm": L.init_norm(init_, cfg, cfg.d_model),
    }


def _shared_block(sp, h, cfg, cos_sin, cache):
    a = L.apply_norm(sp["attn_norm"], h, cfg)
    a, aux = L.attention(sp["attn"], a, cfg, cos_sin=cos_sin, causal=True, cache=cache)
    h = h + a
    h = h + L.mlp(sp["mlp"], L.apply_norm(sp["mlp_norm"], h, cfg), cfg)
    return h, aux


def _cos_sin(cfg, b, s, offset, device):
    pos = (torch.arange(s, dtype=torch.int32, device=device) + offset)[None].expand(b, s)
    return L.rope_cos_sin(pos, cfg.d_head, cfg.rope_theta)


def _mamba_train(stacked, h, cfg, n: int):
    for i in range(n):
        h = S.layer(L.unit(stacked, i), h, cfg)[0]
    return h


def forward(params, tokens, cfg, positions=None):
    """tokens (B, S) → logits (B, S, V) f32.  ``positions`` (B, S) replace
    the default 0..S-1."""
    b, s = tokens.shape
    n_units, n_tail = _unit_counts(cfg)
    x = L.embed(params["embed"], tokens, cfg)
    if positions is None:
        cos_sin = _cos_sin(cfg, b, s, 0, tokens.device)
    else:
        cos_sin = L.rope_cos_sin(positions, cfg.d_head, cfg.rope_theta)
    shared = params["shared"]

    def body(h, unit_params):
        h = _mamba_train(unit_params, h, cfg, cfg.attn_every)
        return _shared_block(shared, h, cfg, cos_sin, None)[0]

    step = L.remat(body, cfg)
    for u in range(n_units):
        x = step(x, L.unit(params["units"], u))
    if params["tail"] is not None:
        x = _mamba_train(params["tail"], x, cfg, n_tail)
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.unembed(params["embed"], x, cfg)


def loss_fn(params, batch, cfg):
    return L.cross_entropy(forward(params, batch["tokens"], cfg), batch["labels"])


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_decode_cache(cfg, batch: int, s_max: int, dtype=None, device=None) -> dict:
    """Zero caches for ``s_max`` positions on ``device`` (None: the card):
    the Mamba states flat over the units' layers, one KV cache (n_units, B,
    KH, s_max, hd) for the shared block's applications."""
    device = resolve_device(device)
    n_units, n_tail = _unit_counts(cfg)
    dt = dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype or cfg.dtype)
    shape = (n_units, batch, cfg.n_kv_heads, s_max, cfg.d_head)
    return {
        "unit_states": (S.init_ssm_state(cfg, batch, n_units * cfg.attn_every, device=device)
                        if n_units else None),
        "tail_states": S.init_ssm_state(cfg, batch, n_tail, device=device) if n_tail else None,
        "kv": {"k": torch.zeros(shape, dtype=dt, device=device),
               "v": torch.zeros(shape, dtype=dt, device=device)},
        "len": torch.zeros((), dtype=torch.int32),
    }


def _flat(states: list) -> dict:
    """Per-unit states stacked (attn_every, ...) as one (n_units·attn_every, ...)."""
    return {k: torch.cat([st[k] for st in states]) for k in ("ssm", "conv_x", "conv_bc")}


def prefill(params, tokens, cfg, positions=None, s_max: int | None = None):
    """Forward that also materializes the Mamba states and the shared
    block's KV caches: (last-token logits (B, V), cache)."""
    del positions
    b, s = tokens.shape
    s_max = s_max or s
    n_units, n_tail = _unit_counts(cfg)
    x = L.embed(params["embed"], tokens, cfg)
    cos_sin = _cos_sin(cfg, b, s, 0, tokens.device)
    shared = params["shared"]

    def body(h, unit_params):
        h, states = S.prefill_states(unit_params, h, cfg, cfg.attn_every)
        h, (k, v) = _shared_block(shared, h, cfg, cos_sin, None)
        k = F.pad(k.movedim(1, 2), (0, 0, 0, s_max - s))
        v = F.pad(v.movedim(1, 2), (0, 0, 0, s_max - s))
        return h, states, k, v

    step = L.remat(body, cfg)
    unit_states, ks, vs = [], [], []
    for u in range(n_units):
        x, states, k, v = step(x, L.unit(params["units"], u))
        unit_states.append(states)
        ks.append(k)
        vs.append(v)
    tail_states = None
    if params["tail"] is not None:
        x, tail_states = S.prefill_states(params["tail"], x, cfg, n_tail)
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x[:, -1:], cfg)[:, 0]
    return logits, {
        "unit_states": _flat(unit_states),
        "tail_states": tail_states,
        "kv": {"k": torch.stack(ks), "v": torch.stack(vs)},
        "len": torch.tensor(s, dtype=torch.int32),
    }


def decode_step(params, cache, token, cfg):
    """One new token (B, 1) → (logits (B, V), cache); the shared block's
    application u reads and writes KV cache u at position ``len``.  The
    given cache is not written."""
    b = token.shape[0]
    n_units, n_tail = _unit_counts(cfg)
    x = L.embed(params["embed"], token, cfg)
    pos_len = int(cache["len"])
    cos_sin = _cos_sin(cfg, b, 1, pos_len, token.device)
    shared = params["shared"]
    every = cfg.attn_every
    new_states, ks, vs = [], [], []
    for u in range(n_units):
        states = {k: t[u * every:(u + 1) * every] for k, t in cache["unit_states"].items()}
        x, st = S.decode_states(L.unit(params["units"], u), states, x, cfg, every)
        sub = {"k": cache["kv"]["k"][u], "v": cache["kv"]["v"][u], "len": pos_len}
        x, nc = _shared_block(shared, x, cfg, cos_sin, sub)
        new_states.append(st)
        ks.append(nc["k"])
        vs.append(nc["v"])
    new_tail = None
    if params["tail"] is not None:
        x, new_tail = S.decode_states(params["tail"], cache["tail_states"], x, cfg, n_tail)
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg)[:, 0]
    return logits, {
        "unit_states": _flat(new_states),
        "tail_states": new_tail,
        "kv": {"k": torch.stack(ks), "v": torch.stack(vs)},
        "len": torch.tensor(pos_len + 1, dtype=torch.int32),
    }
