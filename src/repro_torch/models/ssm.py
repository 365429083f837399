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
Where autograd records, the scans run as the reference's scan of chunks
of ``SCAN_CHUNK`` steps, each chunk rematerialised (``checkpoint``), so
the backward keeps the chunk-boundary states and one chunk's steps at a
time, not every step's; under ``no_grad`` the loop is the same, less the
checkpoints.  Inside the dry-run's counting (``launch/op_count.py``)
each loop runs its first and last turns and the ones between once,
counted as many times as they run (``op_count.counted_loop``).
Every state leaf is f32 whatever the model dtype, and the xLSTM
stabilisers ``m`` start at -1e30.  The reference's ``hint`` sharding
annotations do nothing on one device; in the sharded train step's and
serving step's contexts Mamba computes its block of the inner channels
where the reference's ``inner`` rule splits them (``mamba_prefill``,
``mamba_decode``; over 'model', or for ``long_500k`` over every axis), and
the xLSTM mixers compute whole, as the reference's DP-only recurrence
does.

Rounding follows the reference op by op in bf16, where its prefill and
decode differ on purpose: Mamba's prefill casts the x_proj output to f32
before the dt_proj product and sums the conv taps in the model dtype;
its decode runs the dt_proj product in the model dtype and the conv as a
dot.  ``F.softplus`` (which returns x above 20) stands in for
``jax.nn.softplus`` (``logaddexp(x, 0)``): in f32 the two agree within an
ulp, and every softplus here is in f32.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ArchConfig
from repro_torch.distributed.context import current, tp_split, use_ctx
from repro_torch.launch import op_count
from repro_torch.models.layers import leaf, normal_leaf, reduce_over, stacked

Params = dict

# the scans' chunk, the reference's: Mamba's prefill runs its projections,
# conv and scan one chunk of this many tokens at a time (one chunk of S
# when S is not a multiple), so no (S, d_inner) tensor is ever
# materialised, its carry between chunks (ssm state, conv tail) exactly the
# decode state; where autograd records, every scan rematerialises each
# chunk (``_seq_scan``, ``mamba_prefill``)
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


def _checkpointed(body, params, carry, xs):
    """``body(params, carry, xs)`` under a non-reentrant ``checkpoint``,
    its tensors passed flat, so the checkpoint keeps them and no tuple
    of them.  The recompute may run on another thread (the device's
    backward thread): it enters the sharding context its forward saw."""
    ctx, n_p, n_c = current(), len(params), len(carry)

    def run(*flat):
        with use_ctx(ctx):
            return body(flat[:n_p], flat[n_p:n_p + n_c], flat[n_p + n_c:])
    return checkpoint(run, *params, *carry, *xs, use_reentrant=False,
                      preserve_rng_state=False)


def _loop(body, params, carry, xs, step: int, remat: bool = False):
    """``carry, y = body(params, carry, x_turn)`` over the turns of
    ``step`` rows of the tensors ``xs`` (dim 0; a turn of one row, the
    row itself) in order, each under ``_checkpointed`` with ``remat``:
    (carry, the ys stacked, or with ``step`` > 1 concatenated).  Inside
    the dry-run's counting the turns between the first and the last run
    once, counted as many times as they are (``op_count.counted_loop``)."""
    run = functools.partial(_checkpointed, body) if remat else body
    counter = op_count.loop_counter()
    if counter is not None and xs[0].shape[0] > 2 * step:
        return op_count.counted_loop(counter, run, params, carry, xs, step)
    ys = []
    for x_t in zip(*(x.unbind(0) if step == 1 else x.split(step)
                     for x in xs)):
        carry, y = run(params, carry, x_t)
        ys.append(y)
    return carry, torch.stack(ys) if step == 1 else torch.cat(ys)


def _steps(step_fn, params, state, xs):
    """``step_fn(params, state, x_t) -> (state, y_t)`` over the leading
    (time) dim of every tensor in the tuple ``xs``; (state, stacked ys)."""
    return _loop(step_fn, params, state, xs, 1)


def _seq_scan(step_fn, params, state, xs):
    """:func:`_steps` as the reference's ``_chunked_seq_scan``: where
    autograd records and S is a multiple of ``SCAN_CHUNK`` and more than
    one chunk, chunk by chunk, the state carried between them, each chunk
    rematerialised, so the backward pass keeps chunk-boundary states
    rather than every step's; otherwise one chunk of S."""
    s_len = xs[0].shape[0]
    chunk = SCAN_CHUNK if s_len % SCAN_CHUNK == 0 else s_len
    if chunk == s_len or not torch.is_grad_enabled():
        return _steps(step_fn, params, state, xs)
    return _loop(functools.partial(_steps, step_fn), params, state, xs,
                 chunk, remat=True)


def _full(n: Optional[int], shape, value: float, dtype, device):
    return leaf(torch.full(stacked(n, shape), value, dtype=dtype,
                           device=device))


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
        "A_log": leaf(a_log.expand(stacked(n, (di, ds))).contiguous()),
        "D": _full(n, (di,), 1.0, torch.float32, device),
        "w_out": normal_leaf(gen, n, (di, d), di ** -0.5, dtype, device),
    }


def mamba_forward(x: torch.Tensor, p: Params, cfg: ArchConfig) -> torch.Tensor:
    return mamba_prefill(x, p, cfg)[0]


def _inner_block(p: Params, cfg: ArchConfig):
    """(p, inner, di): the leaves at this process's block of the inner
    channels where the rules split them (``inner``, a ``Split``), and its
    width.  A per-channel leaf arrives as this process's 'model' shard,
    or whole where the rules split over several axes (``long_500k``) and
    is cut to the block; ``x_proj`` and ``w_out`` hold its rows.
    ``w_in`` holds u and z side by side in one leaf, so a block of its
    columns would not be one channel block of each: it arrives whole, and
    the process takes its channels of u and of z."""
    di = cfg.mamba_d_inner
    # reference ssm.py:104-105: the carries hinted "batch", "inner"
    inner = tp_split("inner", di)
    if inner is None:
        return p, None, di
    lo, n = inner.block(di)

    def cut(w, dim):
        return w.narrow(dim, lo, n) if w.shape[dim] == di else w
    w_in = p["w_in"]
    return {**p, "w_in": torch.cat([w_in[:, lo:lo + n],
                                    w_in[:, di + lo:di + lo + n]], dim=1),
            "conv_w": cut(p["conv_w"], 1), "x_proj": cut(p["x_proj"], 0),
            "dt_proj": cut(p["dt_proj"], 1), "dt_bias": cut(p["dt_bias"], 0),
            "A_log": cut(p["A_log"], 0), "D": cut(p["D"], 0),
            "w_out": cut(p["w_out"], 0)}, inner, n


def _mamba_step(_, carry, xs):
    """One step of the selective scan; the new state is also its output."""
    s = xs[0] * carry[0] + xs[1]
    return (s,), s


def _mamba_chunk(dims, inner, params, carry, xs):
    """One chunk (chunk,B,D) of ``mamba_prefill``: (carry, its output)."""
    dtr, ds, dc = dims
    w_in, conv_w, x_proj, dt_proj, dt_bias, a, d_skip, w_out = params
    s, tail = carry
    x_chunk, = xs
    chunk = x_chunk.shape[0]
    u_pre, z = _mm(x_chunk, w_in).chunk(2, dim=-1)           # (chunk,B,Di)
    # causal depthwise conv across the chunk boundary via the tail, oldest
    # tap first, summed in x's dtype (never F.conv1d: cuDNN may round f32
    # convolutions to TF32)
    u_ext = torch.cat([tail, u_pre])
    u = sum(u_ext[i:i + chunk] * conv_w[i] for i in range(dc))
    u = F.silu(u)
    tail = u_ext[chunk:]
    proj = reduce_over(_mm(u, x_proj), inner).float()
    dt = F.softplus(_mm(proj[..., :dtr], dt_proj) + dt_bias)
    uf = u.float()
    # the step's decay and input, for every step of the chunk
    da = torch.exp(dt[..., None] * a)                        # (chunk,B,Di,ds)
    dbu = (dt * uf)[..., None] * proj[..., None, dtr:dtr + ds]
    (s,), states = _steps(_mamba_step, (), (s,), (da, dbu))
    y = torch.einsum("tbis,tbs->tbi", states,
                     proj[..., dtr + ds:]) + uf * d_skip
    return (s, tail), _mm(y.to(x_chunk.dtype) * F.silu(z), w_out)


def mamba_prefill(x: torch.Tensor, p: Params, cfg: ArchConfig
                  ) -> Tuple[torch.Tensor, Params]:
    """x: (B,S,D).  The in-projection, causal conv, gate projections,
    selective scan, gating and out-projection run one chunk at a time,
    carrying (ssm state, conv tail); the tail holds the last d_conv - 1
    pre-conv inputs in x's dtype.  Where autograd records and there is
    more than one chunk, each chunk is rematerialised, as the reference's
    ``jax.checkpoint(inner)``.

    With the inner channels split (``_inner_block``) every per-channel
    leaf holds this process's channels, and so do the conv, the scan and
    the states; ``x_proj`` and ``w_out`` hold its rows, their partial sums
    reduced over the split's axes (``x_proj``'s before dt, B and C)."""
    b, s_len, _ = x.shape
    ds, dc = cfg.mamba_d_state, cfg.mamba_d_conv
    p, inner, di = _inner_block(p, cfg)
    chunk = SCAN_CHUNK if s_len % SCAN_CHUNK == 0 else s_len
    params = (p["w_in"], p["conv_w"], p["x_proj"], p["dt_proj"].float(),
              p["dt_bias"].float(), -torch.exp(p["A_log"]), p["D"],
              p["w_out"])
    carry = (torch.zeros((b, di, ds), dtype=torch.float32, device=x.device),
             torch.zeros((dc - 1, b, di), dtype=x.dtype, device=x.device))
    (s, tail), out = _loop(
        functools.partial(_mamba_chunk, (_dt_rank(cfg), ds, dc), inner),
        params, carry, (x.transpose(0, 1),), chunk,      # chunks (chunk,B,D)
        remat=torch.is_grad_enabled() and s_len > chunk)
    # reference ssm.py:145: hint(out, "batch", None, None)
    out = reduce_over(out, inner).transpose(0, 1)
    return out, {"ssm": s, "conv": tail.transpose(0, 1)}


def mamba_decode(x: torch.Tensor, p: Params, cfg: ArchConfig, cache: Params
                 ) -> Tuple[torch.Tensor, Params]:
    """x: (B,1,D); cache: ``ssm`` (B,Di,ds) f32, ``conv`` (B,dc-1,Di), of
    this process's block of the channels where they are split
    (``_inner_block``; the projections' partial sums reduced as in
    ``mamba_prefill``)."""
    ds = cfg.mamba_d_state
    dtr = _dt_rank(cfg)
    p, inner, di = _inner_block(p, cfg)
    xz = (x @ p["w_in"])[:, 0]                               # (B, 2Di)
    u_new, z = xz[:, :di], xz[:, di:]
    # conv over the (dc-1) cached inputs + current, as a dot: products
    # and sum in f32, rounded once
    window = torch.cat([cache["conv"], u_new[:, None]], dim=1)  # (B,dc,Di)
    u = (window.float() * p["conv_w"].float()).sum(dim=1).to(x.dtype)
    u = F.silu(u)
    proj = reduce_over(u @ p["x_proj"], inner)
    dt_in, b_t, c_t = proj[:, :dtr], proj[:, dtr:dtr + ds], proj[:, dtr + ds:]
    dt = F.softplus(dt_in @ p["dt_proj"] + p["dt_bias"].float())
    a = -torch.exp(p["A_log"])
    da = torch.exp(dt[..., None] * a)
    uf = u.float()
    s = da * cache["ssm"] + (dt * uf)[..., None] * b_t.float()[:, None, :]
    y = torch.einsum("bis,bs->bi", s, c_t.float()) + uf * p["D"]
    y = (y.to(x.dtype) * F.silu(z))[:, None]                 # (B,1,Di)
    return (reduce_over(y @ p["w_out"], inner),
            {"ssm": s, "conv": window[:, 1:]})


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
    state, hs = _seq_scan(lambda _, st, x_t: _mlstm_step(st, x_t), (),
                          state, tuple(t.transpose(0, 1) for t in xs))
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
        lambda r, st, x_t: _slstm_step(r[0], st, x_t[0]), (p["r_zifo"],),
        state, (_slstm_x_pre(x, p, cfg).transpose(0, 1),))
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
