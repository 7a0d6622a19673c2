"""Shared layers of the model zoo (pure functions over tensor trees), the
port of :mod:`repro.models.layers`.

Conventions, as in the reference:
  * params are nested dicts of tensors; the ``init_*`` functions draw them
    through an :class:`Init`, which allocates nothing on the meta device,
    so the same code gives the shapes and dtypes (``api.param_specs``);
  * activations x are (B, S, d_model); a decode cache of one layer is
    ``{"k": (B, KH, T, hd), "v": ..., "len": position}``, ``len`` a 0-d
    int32 tensor on the CPU (host control flow: the slot to write and the
    mask are known without reading the card);
  * products of bf16 tensors keep the reference's f32 scores: operands are
    up-cast where the reference asks for ``preferred_element_type=f32``;
  * a product of an activation and a weight of different dtypes runs in
    their promoted dtype (:func:`dot`), as ``jnp``'s ``@`` does: Whisper's
    f32 frames against bf16 weights keep its encoder, and the decoder's
    residual once the cross-attention joins it, in f32.

The reference's mesh layouts (``constrain``, ``_expand_kv``,
``residual_axes``) have no meaning on one card without a mesh, where the
reference returns early; they wait for ROADMAP A.3e.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.collective.comm import resolve_device

__all__ = [
    "Init", "dtype_of", "generator_on", "dot",
    "init_norm", "apply_norm",
    "rope_cos_sin", "apply_rope",
    "init_attention", "attention", "init_cache",
    "init_mlp", "mlp",
    "init_embedding", "embed", "unembed",
    "softcap", "cross_entropy", "resolve_q_chunk",
    "unit", "remat",
]


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in ``torch.result_type`` of the two (a no-op cast when the
    dtypes agree)."""
    dt = torch.result_type(x, w)
    return x.to(dt) @ w.to(dt)


def generator_on(generator, device: torch.device) -> torch.Generator:
    """``generator`` if it is a ``torch.Generator`` on ``device``, a new
    one seeded with it if it is an int."""
    if isinstance(generator, int):
        return torch.Generator(device=device).manual_seed(generator)
    gd = torch.device(generator.device)
    if gd.type != device.type or (gd.index or 0) != (device.index or 0):
        raise ValueError(f"generator on {gd} draws for {device}; give one on that device")
    return generator


class Init:
    """Draws parameters from one ``torch.Generator`` on ``device``.

    Shapes, dtypes, distributions and scales are the reference's; the bits
    cannot be ``jax.random``'s (tests carry the reference's parameters
    across instead).  Every draw has a ``lead`` prefix, the stacked unit
    axis.  On the meta device nothing is drawn or allocated.
    """

    def __init__(self, generator: torch.Generator | None, device: torch.device,
                 lead: tuple[int, ...] = ()):
        self.generator, self.device, self.lead = generator, device, tuple(lead)

    @classmethod
    def on(cls, generator, device=None) -> "Init":
        """An ``Init`` on ``device`` (None: the card) drawing from
        ``generator``: a ``torch.Generator`` on that device, or an int seed
        for a new one.  On the meta device the generator is not used."""
        device = resolve_device(device)
        if device.type == "meta":
            return cls(None, device)
        return cls(generator_on(generator, device), device)

    def stacked(self, n: int) -> "Init":
        return Init(self.generator, self.device, self.lead + (n,))

    def normal(self, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
        """N(0, scale²) in f32, cast to ``dtype``; a stacked leaf is drawn
        one unit at a time, so the f32 draw never holds more than a unit."""
        shape = tuple(shape)
        out = torch.empty(self.lead + shape, dtype=dtype, device=self.device)
        if self.device.type != "meta":
            for part in (out.view(-1, *shape) if self.lead else [out]):
                x = torch.randn(shape, generator=self.generator, device=self.device)
                part.copy_(x.mul_(scale))
        return out

    def full(self, shape, value: float, dtype: torch.dtype) -> torch.Tensor:
        return torch.full(self.lead + tuple(shape), value, dtype=dtype, device=self.device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(init: Init, cfg, d: int) -> dict:
    if cfg.norm == "ln_nonparam":
        return {}
    if cfg.norm in ("rmsnorm", "rmsnorm_offset"):
        return {"scale": init.full((d,), 0.0 if cfg.norm == "rmsnorm_offset" else 1.0,
                                   torch.float32)}
    if cfg.norm == "ln":
        return {"scale": init.full((d,), 1.0, torch.float32),
                "bias": init.full((d,), 0.0, torch.float32)}
    raise ValueError(cfg.norm)


def apply_norm(p, x, cfg, eps: float = 1e-6):
    xf = x.float()
    if cfg.norm in ("ln_nonparam", "ln"):
        # population variance, as jnp.var (OLMo: LayerNorm without scale/bias)
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if cfg.norm == "ln":
            y = y * p["scale"] + p["bias"]
        return y.to(x.dtype)
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    scale = p["scale"]
    if cfg.norm == "rmsnorm_offset":      # gemma: (1 + w)
        scale = 1.0 + scale
    return (y * scale).to(x.dtype)


def _rms_head_norm(scale, x, eps: float = 1e-6):
    """Per-head q/k RMSNorm (qwen3)."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


def softcap(x, cap):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# Rotary embeddings (standard + M-RoPE)
# ---------------------------------------------------------------------------

def rope_cos_sin(positions, head_dim: int, theta: float, sections=()):
    """cos/sin tables, each (B, S, head_dim/2), f32.

    ``positions``: (B, S) — standard RoPE — or (3, B, S) for M-RoPE, in which
    case ``sections`` (summing to head_dim/2) assigns frequency bands to the
    temporal/height/width position streams (Qwen2-VL §2.1).
    """
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    inv = 1.0 / torch.pow(theta, exps)
    if positions.dim() == 2:
        ang = positions[..., None].float() * inv                  # (B, S, half)
    else:
        if not sections or sum(sections) != half:
            raise ValueError(f"M-RoPE sections {sections} must sum to head_dim/2 = {half}")
        sec_id = torch.repeat_interleave(
            torch.arange(len(sections), device=positions.device),
            torch.tensor(sections, device=positions.device))
        pos = positions[sec_id]                                   # (half, B, S)
        ang = pos.movedim(0, -1).float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, hd); rotate-half convention (NeoX/Llama), in f32."""
    half = x.shape[-1] // 2
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, optional sliding window / softcap / qk_norm / cross-attn)
# ---------------------------------------------------------------------------

def eff_heads(cfg) -> int:
    """Query-head count including ``pad_heads_to`` (the reference pads head
    counts that do not divide its model axis)."""
    return cfg.pad_heads_to or cfg.n_heads


def init_attention(init: Init, cfg, d_model: int | None = None) -> dict:
    d = d_model or cfg.d_model
    h, kh, hd = eff_heads(cfg), cfg.n_kv_heads, cfg.d_head
    scale = 1.0 / math.sqrt(d)
    dt = dtype_of(cfg)
    p = {
        "wq": init.normal((d, h * hd), scale, dt),
        "wk": init.normal((d, kh * hd), scale, dt),
        "wv": init.normal((d, kh * hd), scale, dt),
        "wo": init.normal((h * hd, d), scale, dt),
    }
    if cfg.attn_bias:
        p["bq"] = init.full((h * hd,), 0.0, dt)
        p["bk"] = init.full((kh * hd,), 0.0, dt)
        p["bv"] = init.full((kh * hd,), 0.0, dt)
    if cfg.qk_norm:
        p["q_norm"] = init.full((hd,), 1.0, torch.float32)
        p["k_norm"] = init.full((hd,), 1.0, torch.float32)
    return p


def init_cache(cfg, batch: int, s_cache: int, dtype, n_layers: int | None = None,
               device=None) -> dict:
    """Stacked (L, B, KH, S, hd) KV cache for a decoder of L layers, on
    ``device`` (None: the card)."""
    device = resolve_device(device)
    layers = cfg.n_layers if n_layers is None else n_layers
    shape = (layers, batch, cfg.n_kv_heads, s_cache, cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": torch.zeros((), dtype=torch.int32),
    }


def _qkv(p, x, cfg):
    h, kh, hd = eff_heads(cfg), cfg.n_kv_heads, cfg.d_head
    b, s, _ = x.shape
    q, k, v = dot(x, p["wq"]), dot(x, p["wk"]), dot(x, p["wv"])
    if cfg.attn_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kh, hd)
    v = v.reshape(b, s, kh, hd)
    if cfg.qk_norm:
        q = _rms_head_norm(p["q_norm"], q)
        k = _rms_head_norm(p["k_norm"], k)
    return q, k, v


def _gqa_scores(q, k, cfg):
    """q (B,S,H,hd), k (B,T,KH,hd) → scores (B,KH,G,S,T), f32 (bf16
    operands up-cast: their products are exact in f32)."""
    kh = cfg.n_kv_heads
    b, s, h, hd = q.shape
    qg = q.reshape(b, s, kh, h // kh, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float())
    return scores / math.sqrt(hd)


def _gqa_out(probs, v):
    """probs (B,KH,G,S,T) cast to v's dtype, then an f32 product → (B,S,H,hd)."""
    b, kh, g, s, _ = probs.shape
    out = torch.einsum("bkgst,btkh->bskgh", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, s, kh * g, v.shape[-1]).to(v.dtype)


def _mask_bias(s, t, *, causal, window, offset, device):
    """(S, T) additive mask.  ``offset``: absolute position of query 0 minus
    that of key 0 (0 for self-attn over the same span)."""
    iq = torch.arange(s, device=device)[:, None] + offset
    jk = torch.arange(t, device=device)[None, :]
    ok = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (jk <= iq)
    if window is not None:
        ok = ok & ((iq - jk) < window)
    return _bias(ok)


def _bias(ok):
    return torch.where(ok, 0.0, -1e30).to(torch.float32)


def resolve_q_chunk(cfg, s: int) -> int:
    """Query-chunk size for flash-style attention (0 = unchunked): the
    reference's rule (unchunked S×S scores up to 8192)."""
    if cfg.q_chunk:
        return cfg.q_chunk if s > cfg.q_chunk else 0
    if s <= 8192:
        return 0
    return 1024


def _attend_full(q, k, v, cfg, bias):
    # the mask is added before the softcap, as in the reference: under a
    # softcap a masked score becomes -cap, not -inf
    scores = softcap(_gqa_scores(q, k, cfg) + bias, cfg.attn_logit_softcap)
    return _gqa_out(torch.softmax(scores, dim=-1), v)


def _attend_chunked(q, k, v, cfg, *, causal, window, qc: int):
    """Flash-style query chunking: softmax rows are exact per chunk (keys are
    never split), memory is O(qc·T) instead of O(S·T)."""
    s, t = q.shape[1], k.shape[1]
    if s % qc:
        raise ValueError(f"sequence {s} is not a multiple of the query chunk {qc}")
    outs = []
    for i in range(s // qc):
        bias = _mask_bias(qc, t, causal=causal, window=window, offset=i * qc, device=q.device)
        outs.append(_attend_full(q[:, i * qc:(i + 1) * qc], k, v, cfg, bias))
    return torch.cat(outs, dim=1)


def attention(p, x, cfg, *, cos_sin=None, causal=True, window=None, cache=None, kv=None):
    """Returns (y, aux).

    * train/prefill: ``cache=None``, x (B,S,d); aux = (k_roped, v) so prefill
      can materialize caches without recomputing projections.
    * decode: ``cache`` holds T_max keys, x is (B,1,d) at position
      ``cache['len']``; aux = the updated cache (a new one: the given cache
      is not written).
    * cross-attention: ``kv = (k, v)`` precomputed encoder states; aux = None.
    """
    b, s, _ = x.shape
    q, k_new, v_new = _qkv(p, x, cfg)
    qc = 0
    if kv is not None:
        k, v = kv
        if cos_sin is not None:
            q = apply_rope(q, *cos_sin)
        bias = torch.zeros((s, k.shape[1]), dtype=torch.float32, device=x.device)
        new_cache = None
    elif cache is None:
        if cos_sin is not None:
            q = apply_rope(q, *cos_sin)
            k_new = apply_rope(k_new, *cos_sin)
        k, v = k_new, v_new
        qc = resolve_q_chunk(cfg, s)
        if not qc:
            bias = _mask_bias(s, s, causal=causal, window=window, offset=0, device=x.device)
        new_cache = (k, v)
    else:
        # single-token decode against a ring/linear cache
        pos = int(cache["len"])
        if cos_sin is not None:
            q = apply_rope(q, *cos_sin)
            k_new = apply_rope(k_new, *cos_sin)
        t_max = cache["k"].shape[2]
        slot = pos % t_max if window is not None else pos
        if not 0 <= slot < t_max:
            raise ValueError(f"decode position {pos} past the cache's {t_max} slots")
        k_cache, v_cache = cache["k"].clone(), cache["v"].clone()
        k_cache[:, :, slot] = k_new[:, 0]
        v_cache[:, :, slot] = v_new[:, 0]
        k, v = k_cache.movedim(2, 1), v_cache.movedim(2, 1)      # (B, T, KH, hd)
        jk = torch.arange(t_max, device=x.device)
        if window is not None and pos >= t_max:
            ok = torch.ones_like(jk, dtype=torch.bool)            # ring: all slots live once full
        else:
            ok = jk <= pos
        bias = _bias(ok).expand(s, t_max)
        new_cache = {"k": k_cache, "v": v_cache, "len": torch.tensor(pos + 1, dtype=torch.int32)}

    if qc:
        y = _attend_chunked(q, k, v, cfg, causal=causal, window=window, qc=qc)
    else:
        y = _attend_full(q, k, v, cfg, bias)
    return dot(y.reshape(b, s, -1), p["wo"]), new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(init: Init, cfg, d_ff: int | None = None, d_model: int | None = None) -> dict:
    d = d_model or cfg.d_model
    ff = d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    scale_in, scale_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(ff)
    if cfg.act in ("swiglu", "geglu"):
        return {
            "wg": init.normal((d, ff), scale_in, dt),
            "wu": init.normal((d, ff), scale_in, dt),
            "wd": init.normal((ff, d), scale_out, dt),
        }
    return {
        "w1": init.normal((d, ff), scale_in, dt),
        "w2": init.normal((ff, d), scale_out, dt),
    }


def mlp(p, x, cfg):
    if cfg.act in ("swiglu", "geglu"):
        g, u = dot(x, p["wg"]), dot(x, p["wu"])
        act = F.silu(g) if cfg.act == "swiglu" else F.gelu(g, approximate="tanh")
        return dot(act * u, p["wd"])
    h = dot(x, p["w1"])
    if cfg.act == "gelu":
        h = F.gelu(h)
    elif cfg.act == "relu2":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(cfg.act)
    return dot(h, p["w2"])


# ---------------------------------------------------------------------------
# Embedding / unembedding / loss
# ---------------------------------------------------------------------------

def init_embedding(init: Init, cfg) -> dict:
    dt = dtype_of(cfg)
    p = {"tok": init.normal((cfg.vocab, cfg.d_model), 0.02, dt)}
    if not cfg.tie_embeddings:
        p["out"] = init.normal((cfg.d_model, cfg.vocab), 1.0 / math.sqrt(cfg.d_model), dt)
    return p


def embed(p, tokens, cfg):
    x = p["tok"][tokens]
    if cfg.norm == "rmsnorm_offset":       # gemma scales embeddings by sqrt(d), cast first
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    return x


def unembed(p, x, cfg):
    w = p["tok"].T if cfg.tie_embeddings else p["out"]
    logits = (x @ w.to(x.dtype)).float()
    return softcap(logits, cfg.final_logit_softcap)


def cross_entropy(logits, labels, z_loss: float = 1e-4):
    """Mean token NLL (+ z-loss for logit drift).  logits f32 (B,S,V)."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels[..., None].long())[..., 0]
    loss = (lse - ll).mean()
    if z_loss:
        loss = loss + z_loss * torch.square(lse).mean()
    return loss


# ---------------------------------------------------------------------------
# Layer stacks
# ---------------------------------------------------------------------------

def unit(tree, u: int):
    """The ``u``-th slice of a tree of stacked tensors (one step of the
    reference's ``lax.scan`` over the stack)."""
    if isinstance(tree, dict):
        return {k: unit(v, u) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(unit(v, u) for v in tree)
    return tree[u]


def remat(body, cfg):
    """``body`` recomputed in the backward pass (only its inputs, the
    residual stream and the unit's parameters, are kept), when gradients
    are being recorded."""
    if not cfg.remat or not torch.is_grad_enabled():
        return body
    return lambda *args: checkpoint(body, *args, use_reentrant=False)
