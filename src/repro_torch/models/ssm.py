"""Recurrent mixers (port of ``repro/models/ssm.py``): Mamba (selective
SSM), and the xLSTM pair (mLSTM with matrix memory, sLSTM with scalar
memory and exponential gating).

Each mixer exposes three entry points, as attention.py does:

* ``*_forward(x, p, cfg)``            — full sequence
* ``*_prefill(x, p, cfg)``            — full sequence + final state (cache)
* ``*_decode(x, p, cfg, cache)``      — one step against the cached state

The decode state is O(1) in sequence length, so a CHECKPOINT's context
does not grow with the request.  The reference's ``lax.scan`` over time
becomes a Python loop over time steps that runs only the recurrence; what
does not depend on the carried state (input casts, gate transforms,
Mamba's discretisation) is computed for the whole sequence or chunk
before the loop, elementwise as the reference computes it per step.
Every state leaf is f32 whatever the model dtype, and the xLSTM
stabilisers ``m`` start at -1e30.  The reference's ``hint`` sharding
annotations do nothing on one device; in the sharded train step's context
Mamba computes its block of the inner channels where the reference's
``inner`` rule splits them over 'model' (``mamba_prefill``), and the
xLSTM mixers compute whole, as the reference's DP-only recurrence does.

Rounding follows the reference op by op in bf16, where its prefill and
decode differ on purpose: Mamba's prefill casts the x_proj output to f32
before the dt_proj product and sums the conv taps in the model dtype;
its decode runs the dt_proj product in the model dtype and the conv as a
dot.  ``F.softplus`` (which returns x above 20) stands in for
``jax.nn.softplus`` (``logaddexp(x, 0)``): in f32 the two agree within an
ulp, and every softplus here is in f32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.distributed.context import tp_split
from repro_torch.models.layers import normal_leaf, reduce_over, stacked

Params = dict

# Mamba's prefill runs its projections, conv and scan one chunk of this
# many tokens at a time (one chunk of S when S is not a multiple), so no
# (S, d_inner) tensor is ever materialised; the carry between chunks is
# (ssm state, conv tail), exactly the decode state.
SCAN_CHUNK = 128
M_INIT = -1e30
# the floor of the xLSTM normalisers, a CPU scalar that ``torch.maximum``
# takes beside tensors on any device: like ``jnp.maximum`` (and unlike
# ``torch.clamp``) it splits the gradient evenly on a tie, and sLSTM's
# normaliser is exactly 1 after its first step
_ONE = torch.tensor(1.0)


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., K) @ (K, N) as one 2-D product.  ``torch.matmul`` folds the
    leading dims only when their strides are those of a contiguous
    tensor, literally; a time-major view of a batch of one is not, and
    would run as a batched product that reads ``w`` once per row."""
    return (a.reshape(-1, a.shape[-1]) @ w).unflatten(0, a.shape[:-1])


def _seq_scan(step_fn, state, xs):
    """Run ``step_fn(state, x_t) -> (state, y_t)`` over the leading (time)
    dim of every tensor in the tuple ``xs``; returns (state, stacked ys).
    The reference scans in chunks of ``SCAN_CHUNK`` only so that its
    backward pass keeps chunk-boundary states; forward, that is this one
    loop."""
    ys = []
    for t in range(xs[0].shape[0]):
        state, y = step_fn(state, tuple(x[t] for x in xs))
        ys.append(y)
    return state, torch.stack(ys)


def _full(n: Optional[int], shape, value: float, dtype, device):
    return torch.full(stacked(n, shape), value, dtype=dtype, device=device)


def _log_sigmoid(f_pre: torch.Tensor) -> torch.Tensor:
    return -F.softplus(-f_pre)


# ==========================================================================
# Mamba (selective state-space)
# ==========================================================================
def _dt_rank(cfg: ArchConfig) -> int:
    return max(1, cfg.d_model // 64)


def init_mamba(cfg: ArchConfig, gen: torch.Generator, n: Optional[int],
               dtype, device) -> Params:
    """The reference's shapes and constants; ``A_log`` and ``D`` are f32
    in every dtype."""
    d, di, ds, dc = (cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state,
                     cfg.mamba_d_conv)
    dtr = _dt_rank(cfg)
    # numpy's f32 log on the host gives the reference's bits on every
    # device (torch.log(7.) lies one ulp from XLA's)
    a_log = torch.from_numpy(np.log(np.arange(1, ds + 1, dtype=np.float32)))
    a_log = a_log.to(device).expand(di, ds)
    return {
        "w_in": normal_leaf(gen, n, (d, 2 * di), d ** -0.5, dtype, device),
        "conv_w": normal_leaf(gen, n, (dc, di), dc ** -0.5, dtype, device),
        "x_proj": normal_leaf(gen, n, (di, dtr + 2 * ds), di ** -0.5, dtype,
                              device),
        "dt_proj": normal_leaf(gen, n, (dtr, di), dtr ** -0.5, dtype, device),
        "dt_bias": _full(n, (di,), -4.6, dtype, device),  # softplus^-1(0.01)
        "A_log": a_log.expand(stacked(n, (di, ds))).contiguous(),
        "D": _full(n, (di,), 1.0, torch.float32, device),
        "w_out": normal_leaf(gen, n, (di, d), di ** -0.5, dtype, device),
    }


def mamba_forward(x: torch.Tensor, p: Params, cfg: ArchConfig) -> torch.Tensor:
    return mamba_prefill(x, p, cfg)[0]


def mamba_prefill(x: torch.Tensor, p: Params, cfg: ArchConfig
                  ) -> Tuple[torch.Tensor, Params]:
    """x: (B,S,D).  The in-projection, causal conv, gate projections,
    selective scan, gating and out-projection run one chunk at a time,
    carrying (ssm state, conv tail); the tail holds the last d_conv - 1
    pre-conv inputs in x's dtype.

    With the inner channels split over 'model' every per-channel leaf
    (``conv_w``, ``dt_proj``, ``dt_bias``, ``A_log``, ``D``) holds this
    process's channels, and so do the conv, the scan and the states;
    ``x_proj`` and ``w_out`` hold its rows, their partial sums reduced
    over 'model' (``x_proj``'s before dt, B and C).  ``w_in`` holds u and
    z side by side in one leaf, so a block of its columns would not be
    one channel block of each: the step hands it over whole, and the
    process takes its channels of u and of z."""
    b, s_len, _ = x.shape
    di, ds, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    dtr = _dt_rank(cfg)
    w_in = p["w_in"]
    # reference ssm.py:104-105: the carries hinted "batch", "inner"
    inner = tp_split("inner", di)
    if inner is not None:
        lo, di = inner.block(di)
        z0 = cfg.mamba_d_inner + lo
        w_in = torch.cat([w_in[:, lo:lo + di], w_in[:, z0:z0 + di]], dim=1)
    a = -torch.exp(p["A_log"])                               # (Di, ds)
    dt_proj = p["dt_proj"].float()
    dt_bias = p["dt_bias"].float()
    chunk = SCAN_CHUNK if s_len % SCAN_CHUNK == 0 else s_len

    s = torch.zeros((b, di, ds), dtype=torch.float32, device=x.device)
    tail = torch.zeros((dc - 1, b, di), dtype=x.dtype, device=x.device)
    outs = []
    for x_chunk in x.transpose(0, 1).split(chunk):           # (chunk,B,D)
        u_pre, z = _mm(x_chunk, w_in).chunk(2, dim=-1)       # (chunk,B,Di)
        # causal depthwise conv across the chunk boundary via the tail,
        # oldest tap first, summed in x's dtype (never F.conv1d: cuDNN
        # may round f32 convolutions to TF32)
        u_ext = torch.cat([tail, u_pre])
        u = sum(u_ext[i:i + chunk] * p["conv_w"][i] for i in range(dc))
        u = F.silu(u)
        tail = u_ext[chunk:]
        proj = reduce_over(_mm(u, p["x_proj"]), inner).float()
        dt = F.softplus(_mm(proj[..., :dtr], dt_proj) + dt_bias)
        uf = u.float()
        # the step's decay and input, for every step of the chunk
        da = torch.exp(dt[..., None] * a)                    # (chunk,B,Di,ds)
        dbu = (dt * uf)[..., None] * proj[..., None, dtr:dtr + ds]
        states = []
        for t in range(x_chunk.shape[0]):
            s = da[t] * s + dbu[t]
            states.append(s)
        y = torch.einsum("tbis,tbs->tbi", torch.stack(states),
                         proj[..., dtr + ds:]) + uf * p["D"]
        outs.append(_mm(y.to(x.dtype) * F.silu(z), p["w_out"]))
    # reference ssm.py:145: hint(out, "batch", None, None)
    out = reduce_over(torch.cat(outs), inner).transpose(0, 1)
    return out, {"ssm": s, "conv": tail.transpose(0, 1)}


def mamba_decode(x: torch.Tensor, p: Params, cfg: ArchConfig, cache: Params
                 ) -> Tuple[torch.Tensor, Params]:
    """x: (B,1,D); cache: ``ssm`` (B,Di,ds) f32, ``conv`` (B,dc-1,Di)."""
    di, ds = cfg.mamba_d_inner, cfg.mamba_d_state
    dtr = _dt_rank(cfg)
    xz = (x @ p["w_in"])[:, 0]                               # (B, 2Di)
    u_new, z = xz[:, :di], xz[:, di:]
    # conv over the (dc-1) cached inputs + current, as a dot: products
    # and sum in f32, rounded once
    window = torch.cat([cache["conv"], u_new[:, None]], dim=1)  # (B,dc,Di)
    u = (window.float() * p["conv_w"].float()).sum(dim=1).to(x.dtype)
    u = F.silu(u)
    proj = u @ p["x_proj"]
    dt_in, b_t, c_t = proj[:, :dtr], proj[:, dtr:dtr + ds], proj[:, dtr + ds:]
    dt = F.softplus(dt_in @ p["dt_proj"] + p["dt_bias"].float())
    a = -torch.exp(p["A_log"])
    da = torch.exp(dt[..., None] * a)
    uf = u.float()
    s = da * cache["ssm"] + (dt * uf)[..., None] * b_t.float()[:, None, :]
    y = torch.einsum("bis,bs->bi", s, c_t.float()) + uf * p["D"]
    y = (y.to(x.dtype) * F.silu(z))[:, None]                 # (B,1,Di)
    return y @ p["w_out"], {"ssm": s, "conv": window[:, 1:]}


# ==========================================================================
# mLSTM (xLSTM matrix-memory cell)
# ==========================================================================
def init_mlstm(cfg: ArchConfig, gen: torch.Generator, n: Optional[int],
               dtype, device) -> Params:
    """The input and forget gates' ``w_i``, ``w_f``, ``b_i`` and ``b_f``
    are f32 in every dtype."""
    d, h = cfg.d_model, cfg.n_heads
    dp = int(cfg.lstm_proj_factor * d)
    std_d, std_p = d ** -0.5, dp ** -0.5
    return {
        "w_up": normal_leaf(gen, n, (d, 2 * dp), std_d, dtype, device),
        "wq": normal_leaf(gen, n, (dp, dp), std_p, dtype, device),
        "wk": normal_leaf(gen, n, (dp, dp), std_p, dtype, device),
        "wv": normal_leaf(gen, n, (dp, dp), std_p, dtype, device),
        "w_i": normal_leaf(gen, n, (d, h), std_d, torch.float32, device),
        "w_f": normal_leaf(gen, n, (d, h), std_d, torch.float32, device),
        "b_i": _full(n, (h,), 0.0, torch.float32, device),
        "b_f": _full(n, (h,), 3.0, torch.float32, device),  # forget bias
        "w_down": normal_leaf(gen, n, (dp, d), std_p, dtype, device),
    }


def _mlstm_inputs(x: torch.Tensor, p: Params, cfg: ArchConfig):
    """The step inputs for every position: q, k, v (B,S,H,dh) in f32 as
    the step casts them, the input gate's pre-activation and the forget
    gate's log sigmoid (B,S,H), and z (B,S,dp)."""
    h = cfg.n_heads
    dp = int(cfg.lstm_proj_factor * cfg.d_model)
    dh = dp // h
    xm, z = (x @ p["w_up"]).chunk(2, dim=-1)
    q = (xm @ p["wq"]).unflatten(-1, (h, dh))
    k = (xm @ p["wk"]).unflatten(-1, (h, dh))
    v = (xm @ p["wv"]).unflatten(-1, (h, dh))
    # the scale rounded to k's dtype first, as the reference multiplies in
    # that dtype (a host float: no device copy in the step)
    k = k * torch.tensor(dh ** -0.5, dtype=k.dtype).item()
    xf = x.float()
    i_pre = xf @ p["w_i"] + p["b_i"]
    logf = _log_sigmoid(xf @ p["w_f"] + p["b_f"])
    return q.float(), k.float(), v.float(), i_pre, logf, z


def _mlstm_step(state, xs):
    """Exponentially-gated matrix-memory update (stabilised); all f32."""
    c, n, m = state                       # (B,H,dk,dv), (B,H,dk), (B,H)
    qf, kf, vf, i_pre, logf = xs          # (B,H,dh) x3, (B,H) x2
    logf_m = logf + m
    m_new = torch.maximum(logf_m, i_pre)
    i_g = torch.exp(i_pre - m_new)[..., None]
    f_g = torch.exp(logf_m - m_new)[..., None]
    c = f_g[..., None] * c + i_g[..., None] * (kf[..., :, None]
                                              * vf[..., None, :])
    n = f_g * n + i_g * kf
    num = (qf[..., None, :] @ c)[..., 0, :]                  # (B,H,dv)
    den = (n[..., None, :] @ qf[..., :, None])[..., 0, 0]    # (B,H)
    den = torch.maximum(torch.abs(den), _ONE)
    return (c, n, m_new), num / den[..., None]


def _mlstm_out(h_seq: torch.Tensor, z: torch.Tensor, p: Params,
               x: torch.Tensor) -> torch.Tensor:
    """(B,S,H,dh) f32 cell outputs → the block output (B,S,D)."""
    b, s = x.shape[:2]
    y = h_seq.reshape(b, s, -1).to(x.dtype) * F.silu(z)
    return _mm(y, p["w_down"])


def _mlstm_state(state) -> Params:
    return {"C": state[0], "n": state[1], "m": state[2]}


def mlstm_prefill(x: torch.Tensor, p: Params, cfg: ArchConfig
                  ) -> Tuple[torch.Tensor, Params]:
    b = x.shape[0]
    hh = cfg.n_heads
    dh = int(cfg.lstm_proj_factor * cfg.d_model) // hh
    *xs, z = _mlstm_inputs(x, p, cfg)
    f32 = dict(dtype=torch.float32, device=x.device)
    state = (torch.zeros((b, hh, dh, dh), **f32),
             torch.zeros((b, hh, dh), **f32),
             torch.full((b, hh), M_INIT, **f32))
    state, hs = _seq_scan(_mlstm_step, state,
                          tuple(t.transpose(0, 1) for t in xs))
    return _mlstm_out(hs.transpose(0, 1), z, p, x), _mlstm_state(state)


def mlstm_forward(x: torch.Tensor, p: Params, cfg: ArchConfig) -> torch.Tensor:
    return mlstm_prefill(x, p, cfg)[0]


def mlstm_decode(x: torch.Tensor, p: Params, cfg: ArchConfig, cache: Params
                 ) -> Tuple[torch.Tensor, Params]:
    *xs, z = _mlstm_inputs(x, p, cfg)
    state, h_t = _mlstm_step((cache["C"], cache["n"], cache["m"]),
                             tuple(t[:, 0] for t in xs))
    return _mlstm_out(h_t[:, None], z, p, x), _mlstm_state(state)


# ==========================================================================
# sLSTM (xLSTM scalar-memory cell with exponential gating)
# ==========================================================================
def init_slstm(cfg: ArchConfig, gen: torch.Generator, n: Optional[int],
               dtype, device) -> Params:
    """The recurrent ``r_zifo`` and the bias ``b_zifo`` are f32 in every
    dtype."""
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    return {
        "w_zifo": normal_leaf(gen, n, (d, 4 * d), d ** -0.5, dtype, device),
        "r_zifo": normal_leaf(gen, n, (h, dh, 4 * dh), dh ** -0.5,
                              torch.float32, device),
        "b_zifo": _full(n, (4 * d,), 0.0, torch.float32, device),
        "w_out": normal_leaf(gen, n, (d, d), d ** -0.5, dtype, device),
    }


def _slstm_step(r_zifo: torch.Tensor, state, x_pre: torch.Tensor):
    """state: (c, n, hprev, m) each (B,H,dh) f32; x_pre: (B,H,4·dh) f32,
    the gates laid out per head, split into z, i, f, o along the last
    dim."""
    c, n, hp, m = state
    # recurrent (block-diagonal per head) contribution
    rec = (hp.transpose(0, 1) @ r_zifo).transpose(0, 1)     # (B,H,4dh)
    z_pre, i_pre, f_pre, o_pre = (x_pre + rec).chunk(4, dim=-1)
    logf_m = _log_sigmoid(f_pre) + m
    m_new = torch.maximum(logf_m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(logf_m - m_new)
    c = f_g * c + i_g * torch.tanh(z_pre)
    n = f_g * n + i_g
    h_new = torch.sigmoid(o_pre) * c / torch.maximum(n, _ONE)
    return (c, n, h_new, m_new), h_new


def _slstm_x_pre(x: torch.Tensor, p: Params, cfg: ArchConfig) -> torch.Tensor:
    """(B,S,D) → the input's gate pre-activations (B,S,H,4·dh), summed
    with the bias in x's dtype and then cast to f32, as the step does."""
    h = cfg.n_heads
    x_pre = x @ p["w_zifo"] + p["b_zifo"].to(x.dtype)
    return x_pre.float().unflatten(-1, (h, 4 * cfg.d_model // h))


def _slstm_state(state) -> Params:
    return {"c": state[0], "n": state[1], "h": state[2], "m": state[3]}


def slstm_prefill(x: torch.Tensor, p: Params, cfg: ArchConfig
                  ) -> Tuple[torch.Tensor, Params]:
    b, s, d = x.shape
    h, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    zeros = lambda: torch.zeros((b, h, dh), dtype=torch.float32,
                                device=x.device)
    state = (zeros(), zeros(), zeros(),
             torch.full((b, h, dh), M_INIT, dtype=torch.float32,
                        device=x.device))
    state, hs = _seq_scan(
        lambda st, xs: _slstm_step(p["r_zifo"], st, xs[0]), state,
        (_slstm_x_pre(x, p, cfg).transpose(0, 1),))
    out = _mm(hs.transpose(0, 1).reshape(b, s, d).to(x.dtype), p["w_out"])
    return out, _slstm_state(state)


def slstm_forward(x: torch.Tensor, p: Params, cfg: ArchConfig) -> torch.Tensor:
    return slstm_prefill(x, p, cfg)[0]


def slstm_decode(x: torch.Tensor, p: Params, cfg: ArchConfig, cache: Params
                 ) -> Tuple[torch.Tensor, Params]:
    b, _, d = x.shape
    state, h_t = _slstm_step(p["r_zifo"], (cache["c"], cache["n"],
                                           cache["h"], cache["m"]),
                             _slstm_x_pre(x, p, cfg)[:, 0])
    out = h_t.reshape(b, 1, d).to(x.dtype) @ p["w_out"]
    return out, _slstm_state(state)
