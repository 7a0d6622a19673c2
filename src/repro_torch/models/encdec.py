"""Whisper-style encoder-decoder backbone (arXiv:2212.04356), the port of
:mod:`repro.models.encdec`.

The conv audio frontend is a stub, as in the reference: the inputs are
precomputed frame embeddings (B, F, d) (:mod:`repro_torch.models.frontends`).
The backbone: a bidirectional encoder, a causal decoder with
cross-attention, GELU MLPs, LayerNorm with biases, sinusoidal positions (the
published model's learned decoder positions are replaced by sinusoids, as in
the reference).

Parameters: ``{"embed", "enc": stacked (n_enc_layers, ...), "enc_norm",
"dec": stacked (n_layers, ...), "final_norm"}``.  A decode cache holds the
decoder's self-attention KV (n_layers, B, KH, s_max, hd), the cross
attention's K/V of the encoder states (n_layers, B, F, KH, hd), and
``len``, a 0-d int32 tensor on the CPU.  The encoder has no decode step.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.collective.comm import resolve_device

from . import layers as L

__all__ = [
    "sinusoid", "init", "forward", "loss_fn", "prefill", "decode_step",
    "init_decode_cache", "encode",
]


def sinusoid(s: int, d: int, offset: int = 0, dtype=torch.float32, device=None):
    """(s, d) sinusoidal positions ``offset`` … ``offset + s - 1``: sines
    in the first half of the columns, cosines in the second."""
    pos = (torch.arange(s, device=device) + offset)[:, None].float()
    half = d // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=device)
                     / max(half - 1, 1))
    ang = pos * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _init_block(init: L.Init, cfg, cross: bool) -> dict:
    p = {
        "attn_norm": L.init_norm(init, cfg, cfg.d_model),
        "attn": L.init_attention(init, cfg),
        "mlp_norm": L.init_norm(init, cfg, cfg.d_model),
        "mlp": L.init_mlp(init, cfg),
    }
    if cross:
        p["cross_norm"] = L.init_norm(init, cfg, cfg.d_model)
        p["cross"] = L.init_attention(init, cfg)
    return p


def init(generator, cfg, device=None) -> dict:
    """Params on ``device`` (None: the card; "meta": shapes and dtypes
    only), drawn from ``generator`` (a ``torch.Generator`` on that device,
    or an int seed)."""
    init_ = L.Init.on(generator, device)
    return {
        "embed": L.init_embedding(init_, cfg),
        "enc": _init_block(init_.stacked(cfg.n_enc_layers), cfg, cross=False),
        "enc_norm": L.init_norm(init_, cfg, cfg.d_model),
        "dec": _init_block(init_.stacked(cfg.n_layers), cfg, cross=True),
        "final_norm": L.init_norm(init_, cfg, cfg.d_model),
    }


def encode(params, frames, cfg):
    """frames (B, F, d) — the stubbed conv-frontend output — → encoder
    states (B, F, d)."""
    _, f, d = frames.shape
    x = frames + sinusoid(f, d, dtype=frames.dtype, device=frames.device)[None]

    def body(h, lp):
        a = L.apply_norm(lp["attn_norm"], h, cfg)
        h = h + L.attention(lp["attn"], a, cfg, causal=False)[0]
        return h + L.mlp(lp["mlp"], L.apply_norm(lp["mlp_norm"], h, cfg), cfg)

    step = L.remat(body, cfg)
    for i in range(cfg.n_enc_layers):
        x = step(x, L.unit(params["enc"], i))
    return L.apply_norm(params["enc_norm"], x, cfg)


def _cross_kv(lp, enc_out, cfg):
    """One decoder layer's cross-attention K/V of the encoder states, each
    (B, F, KH, hd)."""
    kh, hd = cfg.n_kv_heads, cfg.d_head
    b, f, _ = enc_out.shape
    k = L.dot(enc_out, lp["cross"]["wk"])
    v = L.dot(enc_out, lp["cross"]["wv"])
    if cfg.attn_bias:
        k = k + lp["cross"]["bk"]
        v = v + lp["cross"]["bv"]
    return k.reshape(b, f, kh, hd), v.reshape(b, f, kh, hd)


def _dec_block(lp, h, cfg, enc_kv, cache):
    a = L.apply_norm(lp["attn_norm"], h, cfg)
    a, aux = L.attention(lp["attn"], a, cfg, causal=True, cache=cache)
    h = h + a
    c = L.apply_norm(lp["cross_norm"], h, cfg)
    h = h + L.attention(lp["cross"], c, cfg, causal=False, kv=enc_kv)[0]
    h = h + L.mlp(lp["mlp"], L.apply_norm(lp["mlp_norm"], h, cfg), cfg)
    return h, aux


def _embed(params, tokens, cfg, offset: int = 0):
    x = L.embed(params["embed"], tokens, cfg)
    return x + sinusoid(tokens.shape[1], cfg.d_model, offset, x.dtype, x.device)[None]


def forward(params, tokens, cfg, frames=None, enc_out=None, positions=None):
    """Teacher-forced decoder over the encoder states of ``frames`` (or the
    given ``enc_out``: exactly one of the two) → logits (B, S, V) f32."""
    del positions
    if (frames is None) == (enc_out is None):
        raise ValueError("give exactly one of frames and enc_out")
    if enc_out is None:
        enc_out = encode(params, frames, cfg)
    x = _embed(params, tokens, cfg)

    def body(h, lp):
        return _dec_block(lp, h, cfg, _cross_kv(lp, enc_out, cfg), None)[0]

    step = L.remat(body, cfg)
    for i in range(cfg.n_layers):
        x = step(x, L.unit(params["dec"], i))
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.unembed(params["embed"], x, cfg)


def loss_fn(params, batch, cfg):
    logits = forward(params, batch["tokens"], cfg, frames=batch["frames"])
    return L.cross_entropy(logits, batch["labels"])


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_decode_cache(cfg, batch: int, s_max: int, dtype=None, device=None) -> dict:
    """Zero caches on ``device`` (None: the card): self-attention KV for
    ``s_max`` positions, cross-attention K/V for ``enc_frames`` frames."""
    device = resolve_device(device)
    dt = dtype if isinstance(dtype, torch.dtype) else getattr(torch, dtype or cfg.dtype)
    kh, hd, nl = cfg.n_kv_heads, cfg.d_head, cfg.n_layers

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    return {
        "kv": {"k": zeros(nl, batch, kh, s_max, hd), "v": zeros(nl, batch, kh, s_max, hd)},
        "cross_kv": {"k": zeros(nl, batch, cfg.enc_frames, kh, hd),
                     "v": zeros(nl, batch, cfg.enc_frames, kh, hd)},
        "len": torch.zeros((), dtype=torch.int32),
    }


def prefill(params, tokens, cfg, frames=None, s_max=None, positions=None):
    """Encode ``frames``, run the decoder over ``tokens`` and keep its
    caches: (last-token logits (B, V), cache)."""
    del positions
    s = tokens.shape[1]
    s_max = s_max or s
    enc_out = encode(params, frames, cfg)
    x = _embed(params, tokens, cfg)

    def body(h, lp):
        ck, cv = _cross_kv(lp, enc_out, cfg)
        h, (k, v) = _dec_block(lp, h, cfg, (ck, cv), None)
        k = F.pad(k.movedim(1, 2), (0, 0, 0, s_max - s))
        v = F.pad(v.movedim(1, 2), (0, 0, 0, s_max - s))
        return h, k, v, ck, cv

    step = L.remat(body, cfg)
    outs = []
    for i in range(cfg.n_layers):
        x, *kv = step(x, L.unit(params["dec"], i))
        outs.append(kv)
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x[:, -1:], cfg)[:, 0]
    k, v, ck, cv = (torch.stack(t) for t in zip(*outs))
    return logits, {"kv": {"k": k, "v": v}, "cross_kv": {"k": ck, "v": cv},
                    "len": torch.tensor(s, dtype=torch.int32)}


def decode_step(params, cache, token, cfg):
    """One new token (B, 1) → (logits (B, V), cache), at position ``len``
    against the cached self-attention KV and the cross K/V.  The given
    cache is not written."""
    pos_len = int(cache["len"])
    x = _embed(params, token, cfg, pos_len)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        sub = {"k": cache["kv"]["k"][i], "v": cache["kv"]["v"][i], "len": pos_len}
        enc_kv = (cache["cross_kv"]["k"][i], cache["cross_kv"]["v"][i])
        x, nc = _dec_block(L.unit(params["dec"], i), x, cfg, enc_kv, sub)
        ks.append(nc["k"])
        vs.append(nc["v"])
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg)[:, 0]
    return logits, {"kv": {"k": torch.stack(ks), "v": torch.stack(vs)},
                    "cross_kv": cache["cross_kv"],
                    "len": torch.tensor(pos_len + 1, dtype=torch.int32)}
