"""Mamba2 (SSD — state-space duality) blocks and LM (arXiv:2405.21060), the
port of :mod:`repro.models.ssm`.

Training and prefill use the chunked SSD form: an intra-chunk quadratic
("attention-like") term plus the inter-chunk state recurrence, a loop over
the S/chunk chunks with a (B, nh, hp, N) running state (the reference's
``lax.scan``).  Decode is the O(1)-per-token recurrence.  Heads nh =
d_inner / head_dim; the B/C projections are shared by G groups.  No
attention, no RoPE.

The casts are the reference's one for one, which only a bf16 config shows:
``dt·A`` and the chunk-end states in f32, the C·B scores as an f32 product,
the decayed scores and the inter-chunk term cast back to the inputs' dtype,
the gate's silu in f32.

Parameters are the reference's tree: ``{"embed", "layers": {"norm",
"block"} stacked (n_layers, ...), "final_norm"}``.  A decode cache is
``{"state": {"ssm", "conv_x", "conv_bc"} stacked (n_layers, ...), "len"}``,
``len`` a 0-d int32 tensor on the CPU.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.collective.comm import resolve_device

from . import layers as L

__all__ = [
    "init_mamba_block", "mamba_chunked", "mamba_block", "mamba_step", "init_ssm_state",
    "init", "forward", "loss_fn", "prefill", "decode_step", "init_decode_cache",
]


# ---------------------------------------------------------------------------
# Block params
# ---------------------------------------------------------------------------

def init_mamba_block(init: L.Init, cfg, d_model: int | None = None) -> dict:
    d = d_model or cfg.d_model
    di = cfg.ssm_expand * d
    nh = di // cfg.ssm_head_dim
    gn = cfg.ssm_groups * cfg.ssm_state
    dt = L.dtype_of(cfg)
    s = 1.0 / math.sqrt(d)
    f32 = torch.float32
    return {
        "w_z": init.normal((d, di), s, dt),
        "w_x": init.normal((d, di), s, dt),
        "w_bc": init.normal((d, 2 * gn), s, dt),
        "w_dt": init.normal((d, nh), s, dt),
        "conv_x": init.normal((cfg.ssm_conv, di), 0.1, dt),
        "conv_bc": init.normal((cfg.ssm_conv, 2 * gn), 0.1, dt),
        "conv_x_b": init.full((di,), 0.0, dt),
        "conv_bc_b": init.full((2 * gn,), 0.0, dt),
        "A_log": init.full((nh,), 0.0, f32),           # A = -exp(A_log) = -1
        "D": init.full((nh,), 1.0, f32),
        "dt_bias": init.full((nh,), 0.0, f32),
        "gate_norm": init.full((di,), 1.0, f32),
        "w_out": init.normal((di, d), 1.0 / math.sqrt(di), dt),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv: x (B, S, ch), w (K, ch)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return out + b


def _gated_norm(y, z, scale, eps: float = 1e-6):
    """Mamba2 RMSNormGated: norm(y · silu(z)) · scale."""
    y = y * F.silu(z.float()).to(y.dtype)
    yf = y.float()
    y = yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + eps)
    return (y * scale).to(z.dtype)


# ---------------------------------------------------------------------------
# Chunked SSD (training / prefill)
# ---------------------------------------------------------------------------

def _segsum(a):
    """a (..., Q) → lower-triangular pairwise sums Σ_{j<i≤q} (..., Q, Q);
    -inf above the diagonal, so ``exp`` of it is 0 there and its gradient
    is 0, not NaN."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]         # cs[i] - cs[j]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -math.inf)


def _chunk_len(s: int, chunk: int) -> int:
    """The largest divisor of ``s`` that is at most ``chunk`` (a ragged
    sequence gets shorter chunks)."""
    q = min(chunk, s)
    while s % q:
        q -= 1
    return q


def mamba_chunked(xh, da, b_mat, c_mat, cfg, state0=None):
    """SSD over the full sequence, chunk-parallel.

    xh (B,S,nh,hp) — dt-scaled inputs; da (B,S,nh) = dt·A (negative);
    b_mat/c_mat (B,S,G,N).  Returns (y (B,S,nh,hp), final state (B,nh,hp,N) f32).
    """
    bsz, s, nh, hp = xh.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    q = _chunk_len(s, cfg.ssm_chunk)
    nc = s // q
    rep = nh // g
    f32 = torch.float32

    xh = xh.reshape(bsz, nc, q, nh, hp)
    da = da.reshape(bsz, nc, q, nh).to(f32)
    bm = b_mat.reshape(bsz, nc, q, g, n)
    cm = c_mat.reshape(bsz, nc, q, g, n)

    cs = torch.cumsum(da, dim=2)                              # inclusive
    # ---- intra-chunk (diagonal blocks) ---------------------------------
    lmat = torch.exp(_segsum(da.movedim(3, 2)))               # (B,nc,nh,Q,Q)
    scores = torch.einsum("bcqgn,bckgn->bcgqk", cm.to(f32), bm.to(f32))
    scores = torch.repeat_interleave(scores, rep, dim=2)      # (B,nc,nh,Q,K)
    att = (scores * lmat).to(xh.dtype)
    del scores, lmat
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", att, xh)
    # ---- chunk-final states ---------------------------------------------
    # (the reference's three-operand einsums, as two-operand products: the
    # decays scale the inputs first, so no (q, g, n, h, p) intermediate)
    decay_end = torch.exp(cs[:, :, -1:, :] - cs)              # (B,nc,Q,nh)
    states = torch.einsum("bcqgn,bcqhp->bchpn", bm.to(f32), xh.to(f32) * decay_end[..., None])
    total = torch.exp(cs[:, :, -1, :])                        # (B,nc,nh)
    # ---- inter-chunk recurrence: the state before each chunk ------------
    prev = (torch.zeros((bsz, nh, hp, n), dtype=f32, device=xh.device)
            if state0 is None else state0.to(f32))
    prevs = []
    for c in range(nc):
        prevs.append(prev)
        prev = prev * total[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prevs, dim=1)                   # (B,nc,nh,hp,n)
    # ---- inter-chunk contribution ----------------------------------------
    y_off = (torch.einsum("bcqgn,bchpn->bcqhp", cm.to(f32), prev_states)
             * torch.exp(cs)[..., None]).to(xh.dtype)
    y = (y_diag + y_off).reshape(bsz, s, nh, hp)
    return y, prev


def _split_bc(bcc, g: int, n: int):
    """The conv'd B/C projection (..., 2·G·N) as B and C (..., G, N)."""
    lead = bcc.shape[:-1]
    return bcc[..., :g * n].reshape(*lead, g, n), bcc[..., g * n:].reshape(*lead, g, n)


def mamba_block(p, x, cfg, state=None):
    """Full block: projections + conv + SSD + gated norm.  x (B,S,d).

    Returns (y (B,S,d), carry) with carry = (ssm_state, conv tail inputs)
    so prefill can hand off to decode.  A prompt shorter than
    ``ssm_conv - 1`` gives a shorter tail, as the reference's slice does.
    """
    bsz, s, _ = x.shape
    di = p["w_x"].shape[1]
    nh = p["A_log"].shape[0]
    hp = di // nh

    z = x @ p["w_z"]
    xin = x @ p["w_x"]
    bc = x @ p["w_bc"]
    dt_raw = (x @ p["w_dt"]).float()

    xc = F.silu(_causal_conv(xin, p["conv_x"], p["conv_x_b"]))
    bcc = F.silu(_causal_conv(bc, p["conv_bc"], p["conv_bc_b"]))
    b_mat, c_mat = _split_bc(bcc, cfg.ssm_groups, cfg.ssm_state)

    dt = F.softplus(dt_raw + p["dt_bias"])                    # (B,S,nh)
    a = -torch.exp(p["A_log"])                                # (nh,)
    da = dt * a
    xh = xc.reshape(bsz, s, nh, hp)
    xdt = xh * dt[..., None].to(xh.dtype)

    y, final_state = mamba_chunked(xdt, da, b_mat, c_mat, cfg, state)
    y = y + xh * p["D"][None, None, :, None].to(xh.dtype)
    y = _gated_norm(y.reshape(bsz, s, di), z, p["gate_norm"])
    out = y @ p["w_out"]
    start = s - (cfg.ssm_conv - 1)
    conv_tail = (xin[:, start:], bc[:, start:])
    return out, (final_state, conv_tail)


# ---------------------------------------------------------------------------
# Single-token decode recurrence
# ---------------------------------------------------------------------------

def init_ssm_state(cfg, batch: int, n_layers: int, d_model: int | None = None,
                   device=None) -> dict:
    """Zero recurrent states of ``n_layers`` layers on ``device`` (None:
    the card)."""
    device = resolve_device(device)
    d = d_model or cfg.d_model
    di = cfg.ssm_expand * d
    nh = di // cfg.ssm_head_dim
    gn = cfg.ssm_groups * cfg.ssm_state
    kc = cfg.ssm_conv - 1
    dt = L.dtype_of(cfg)
    return {
        "ssm": torch.zeros((n_layers, batch, nh, cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
        "conv_x": torch.zeros((n_layers, batch, kc, di), dtype=dt, device=device),
        "conv_bc": torch.zeros((n_layers, batch, kc, 2 * gn), dtype=dt, device=device),
    }


def mamba_step(p, x, cfg, state):
    """One-token step.  x (B,1,d); state {"ssm","conv_x","conv_bc"} of one
    layer.  Returns (y (B,1,d), the new state); the given state is not
    written."""
    bsz = x.shape[0]
    di = p["w_x"].shape[1]
    nh = p["A_log"].shape[0]
    hp = di // nh
    g = cfg.ssm_groups

    xt = x[:, 0]
    z = xt @ p["w_z"]
    xin = xt @ p["w_x"]
    bc = xt @ p["w_bc"]
    dt_raw = (xt @ p["w_dt"]).float()

    # conv windows: the state holds the previous (K-1) raw inputs
    win_x = torch.cat([state["conv_x"], xin[:, None, :]], dim=1)
    win_bc = torch.cat([state["conv_bc"], bc[:, None, :]], dim=1)
    xc = F.silu(torch.einsum("bkc,kc->bc", win_x, p["conv_x"]) + p["conv_x_b"])
    bcc = F.silu(torch.einsum("bkc,kc->bc", win_bc, p["conv_bc"]) + p["conv_bc_b"])
    b_t, c_t = _split_bc(bcc, g, cfg.ssm_state)

    dt = F.softplus(dt_raw + p["dt_bias"])                    # (B,nh)
    a = -torch.exp(p["A_log"])
    da_t = torch.exp(dt * a)                                  # (B,nh)
    xh = xc.reshape(bsz, nh, hp).float()
    rep = nh // g
    b_h = torch.repeat_interleave(b_t, rep, dim=1).float()   # (B,nh,n)
    c_h = torch.repeat_interleave(c_t, rep, dim=1).float()

    ssm = state["ssm"] * da_t[..., None, None] + (
        dt[..., None, None] * xh[..., :, None] * b_h[..., None, :])
    y = torch.einsum("bhpn,bhn->bhp", ssm, c_h) + xh * p["D"][None, :, None]
    y = _gated_norm(y.reshape(bsz, 1, di).to(x.dtype), z[:, None], p["gate_norm"])
    out = y @ p["w_out"]
    return out, {"ssm": ssm, "conv_x": win_x[:, 1:], "conv_bc": win_bc[:, 1:]}


# ---------------------------------------------------------------------------
# Mamba2 LM (embed → stacked blocks → head)
# ---------------------------------------------------------------------------

def init_layer(init: L.Init, cfg) -> dict:
    """One pre-norm Mamba layer (stacked when ``init`` is)."""
    return {"norm": L.init_norm(init, cfg, cfg.d_model), "block": init_mamba_block(init, cfg)}


def init(generator, cfg, device=None) -> dict:
    """Params with the layers stacked (n_layers, ...), on ``device`` (None:
    the card; "meta": shapes and dtypes only), drawn from ``generator`` (a
    ``torch.Generator`` on that device, or an int seed)."""
    init_ = L.Init.on(generator, device)
    return {
        "embed": L.init_embedding(init_, cfg),
        "layers": init_layer(init_.stacked(cfg.n_layers), cfg),
        "final_norm": L.init_norm(init_, cfg, cfg.d_model),
    }


def layer(lp, h, cfg, state=None):
    """One pre-norm residual Mamba layer over the sequence (``state``
    None) or one token (``state`` the layer's decode state); returns
    (h, carry or new state)."""
    x = L.apply_norm(lp["norm"], h, cfg)
    if state is None:
        y, carry = mamba_block(lp["block"], x, cfg)
    else:
        y, carry = mamba_step(lp["block"], x, cfg, state)
    return h + y, carry


def forward(params, tokens, cfg, positions=None):
    """tokens (B, S) → logits (B, S, V) f32."""
    del positions
    x = L.embed(params["embed"], tokens, cfg)

    def body(h, lp):
        return layer(lp, h, cfg)[0]

    step = L.remat(body, cfg)
    for i in range(cfg.n_layers):
        x = step(x, L.unit(params["layers"], i))
    x = L.apply_norm(params["final_norm"], x, cfg)
    return L.unembed(params["embed"], x, cfg)


def loss_fn(params, batch, cfg):
    logits = forward(params, batch["tokens"], cfg)
    return L.cross_entropy(logits, batch["labels"])


def init_decode_cache(cfg, batch: int, s_max: int, dtype=None, device=None) -> dict:
    del s_max, dtype
    return {"state": init_ssm_state(cfg, batch, cfg.n_layers, device=device),
            "len": torch.zeros((), dtype=torch.int32)}


def stack_states(states: list) -> dict:
    """Per-layer decode states as one state stacked (n_layers, ...)."""
    return {k: torch.stack([st[k] for st in states]) for k in ("ssm", "conv_x", "conv_bc")}


def prefill_states(stacked, h, cfg, n: int):
    """``n`` stacked Mamba layers over the sequence; (h, their decode
    states stacked)."""
    def body(hh, lp):
        hh, (st, (cx, cbc)) = layer(lp, hh, cfg)
        return hh, st, cx, cbc

    step = L.remat(body, cfg)
    states = []
    for i in range(n):
        h, st, cx, cbc = step(h, L.unit(stacked, i))
        states.append({"ssm": st, "conv_x": cx, "conv_bc": cbc})
    return h, stack_states(states)


def decode_states(stacked, states, h, cfg, n: int):
    """``n`` stacked Mamba layers over one token; (h, the new states
    stacked)."""
    new = []
    for i in range(n):
        h, st = layer(L.unit(stacked, i), h, cfg, L.unit(states, i))
        new.append(st)
    return h, stack_states(new)


def prefill(params, tokens, cfg, positions=None, s_max: int | None = None):
    """Forward pass that also returns the decode-ready recurrent state:
    (last-token logits (B, V), cache)."""
    del positions, s_max
    s = tokens.shape[1]
    x = L.embed(params["embed"], tokens, cfg)
    x, states = prefill_states(params["layers"], x, cfg, cfg.n_layers)
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x[:, -1:], cfg)[:, 0]
    return logits, {"state": states, "len": torch.tensor(s, dtype=torch.int32)}


def decode_step(params, cache, token, cfg):
    """One new token (B, 1) → (logits (B, V), cache).  The given cache is
    not written."""
    x = L.embed(params["embed"], token, cfg)
    x, states = decode_states(params["layers"], cache["state"], x, cfg, cfg.n_layers)
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg)[:, 0]
    return logits, {"state": states,
                    "len": torch.tensor(int(cache["len"]) + 1, dtype=torch.int32)}
