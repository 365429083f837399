"""Per-architecture sharding rules: parameters, optimizer state, inputs,
and KV/SSM caches, for any (arch × shape × mesh) cell (port of
``repro/distributed/sharding.py``; the rule logic is the reference's, line
for line).

Strategy:

* **Params / optimizer moments** — FSDP over ``('pod','data')`` on the
  d_model-like dim × tensor parallel over ``'model'`` on heads / d_ff /
  vocab / experts / inner dims.
* **Attention activations** — query-head axis over ``'model'`` when the
  head count divides; otherwise the *query-sequence* axis is
  model-sharded instead (Megatron-SP-style).
* **Decode caches** — batch over ``('pod','data')``; KV sequence over
  ``'model'``; ``long_500k`` (batch=1) shards the KV sequence over *all*
  axes and SSM inner dims over ``('data','model')``.

Every rule degrades to replication when a dim does not divide, so the same
builder serves a 2-process mesh and the 512-device production mesh.  A
mesh here is anything with ``axis_names`` and ``devices.shape`` (a shape
is enough: the rules run at production sizes with no process).  Specs are
``PartitionSpec`` tuples; :func:`placements` gives a spec's DTensor
placements, the counterpart of the reference's ``as_shardings``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.configs import ArchConfig, Shape
from repro_torch.distributed.context import P, placements  # noqa: F401

FSDP_AXES = ("pod", "data")
TP = "model"


def axes_in(mesh, names) -> Tuple[str, ...]:
    return tuple(n for n in names if n in mesh.axis_names)


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = dict(zip(mesh.axis_names, mesh.devices.shape))
    k = 1
    for a in axes:
        k *= shape[a]
    return k


def _maybe(mesh, axes, dim: int):
    """axes if they evenly divide dim else None (replicate)."""
    if axes is None:
        return None
    if isinstance(axes, (list, tuple)) and len(axes) == 0:
        return None
    if dim % axis_size(mesh, axes) == 0:
        if isinstance(axes, (list, tuple)) and len(axes) == 1:
            return axes[0]
        return axes
    return None


def _best_join(mesh, dim: int, *axis_groups):
    """First axis combination that divides ``dim`` (progressive fallback)."""
    for grp in axis_groups:
        grp = tuple(a for a in grp if a in mesh.axis_names)
        if not grp:
            continue
        if dim % axis_size(mesh, grp) == 0:
            return grp if len(grp) > 1 else grp[0]
    return None


# ==========================================================================
# Logical rules per cell (consumed by distributed.context.hint)
# ==========================================================================
def logical_rules(cfg: ArchConfig, shape: Shape, mesh) -> Dict[str, Any]:
    fsdp = axes_in(mesh, FSDP_AXES)
    heads_divide = cfg.n_heads % axis_size(mesh, TP) == 0
    rules: Dict[str, Any] = {
        "batch": fsdp,
        "experts": TP,
        "ff": TP,
        "vocab": TP,
        "inner": TP,
    }
    rules["embed"] = None
    if shape.name == "long_500k":
        rules["batch"] = None
        rules["kv_seq"] = tuple(fsdp) + (TP,)
        rules["inner"] = tuple(fsdp) + (TP,)
        rules["heads"] = None
        rules["qseq"] = None
    elif shape.kind == "decode":
        rules["kv_seq"] = TP
        rules["heads"] = None
        rules["qseq"] = None
    else:  # train / prefill
        rules["kv_seq"] = None
        if heads_divide:
            rules["heads"] = TP
            rules["qseq"] = None
        else:
            rules["heads"] = None
            rules["qseq"] = TP      # sequence-parallel attention
    return rules


# ==========================================================================
# Parameter specs
# ==========================================================================
def _param_spec(path: str, shape: Tuple[int, ...], cfg: ArchConfig,
                mesh) -> P:
    fsdp = axes_in(mesh, FSDP_AXES)
    in_slots = "slots/" in path
    base_shape = shape[1:] if in_slots else shape

    def out(*axes):
        axes = tuple(axes)
        assert len(axes) == len(base_shape), (path, base_shape, axes)
        checked = tuple(_maybe(mesh, a, d) for a, d in zip(axes, base_shape))
        return P(*(((None,) + checked) if in_slots else checked))

    leaf = path.split("/")[-1]
    if path.endswith("embed/table"):
        return out(TP, fsdp)
    if path.endswith("lm_head/w"):
        return out(fsdp, TP)
    if path.endswith("img_proj/w"):
        return out(None, fsdp)
    if "norm" in leaf or leaf in ("scale", "bias") or "norm1" in path \
            or "norm2" in path or "final_norm" in path:
        return out(*([None] * len(base_shape)))
    # ---- mixer / ffn weights ----
    # fsdp axes live on *contraction* dims only; TP on heads / d_ff /
    # experts / inner dims.
    if leaf in ("wq", "wk", "wv"):
        if len(base_shape) == 3:        # attention (D, H, Dh)
            return out(fsdp, TP, None)
        return out(fsdp, TP)            # mLSTM projections (dp, dp)
    if leaf == "wo":                    # (H, Dh, D): contraction = (H, Dh)
        return out(TP, fsdp, None)
    if leaf in ("bq", "bk", "bv"):
        return out(TP, None)
    if leaf in ("q_norm", "k_norm"):
        return out(None)
    if leaf in ("w_in", "w_gate"):
        if len(base_shape) == 3:        # MoE (E, D, F)
            return out(TP, fsdp, None)
        return out(fsdp, TP)
    if leaf == "w_out":
        if len(base_shape) == 3:        # MoE (E, F, D): gathered in
            return out(TP, None, fsdp)  # moe_sharded (explicit gather)
        if "mixer/" in path:
            # mamba out-projection: TP only (state_specs' ZeRO split
            # recovers the memory for the moments)
            return out(TP, None)
        return out(TP, fsdp)            # dense MLP out-projection
    if leaf == "router":
        return out(fsdp, None)
    # mamba
    if leaf == "conv_w":
        return out(None, TP)
    if leaf == "x_proj":
        return out(TP, None)
    if leaf == "dt_proj":
        return out(None, TP)
    if leaf in ("dt_bias", "D"):
        return out(TP)
    if leaf == "A_log":
        return out(TP, None)
    # xlstm — projections stay TP; per-step weights (r_zifo) replicate so
    # no collective sits inside the timestep loop.
    if leaf == "w_up":
        return out(fsdp, TP)
    if leaf == "w_down":
        return out(fsdp, None)
    if leaf in ("w_i", "w_f"):
        return out(fsdp, None)
    if leaf in ("b_i", "b_f"):
        return out(None)
    if leaf == "w_zifo":
        return out(fsdp, TP)
    if leaf == "r_zifo":
        return out(None, None, None)
    if leaf == "b_zifo":
        return out(None)
    # fallback: replicate
    return out(*([None] * len(base_shape)))


def param_specs(params_shape, cfg: ArchConfig, mesh):
    """Nested dict of PartitionSpec matching a params tree whose leaves
    have a ``shape`` (tensors, meta tensors, ``jax.ShapeDtypeStruct``)."""
    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in tree.items()}
        return _param_spec(prefix[:-1], tuple(tree.shape), cfg, mesh)
    return walk(params_shape)


def map2(fn, shapes, specs):
    """``fn(shape_leaf, spec)`` over two trees of the same nesting."""
    if isinstance(shapes, dict):
        return {k: map2(fn, v, specs[k]) for k, v in shapes.items()}
    return fn(shapes, specs)


def state_specs(p_shape, p_specs, mesh):
    """ZeRO-style moment sharding: wherever a param spec carries no fsdp
    axis (e.g. TP-only out-projections), the optimizer moments still take
    fsdp on the first divisible replicated dim — moments are only touched
    by the elementwise update, so the compute-layout constraints that
    forced TP-only params don't apply to them."""
    fsdp = axes_in(mesh, FSDP_AXES)

    def one(sd, spec):
        axes = list(spec)
        used = set()
        for a in axes:
            if a is None:
                continue
            used.update((a,) if isinstance(a, str) else a)
        if not fsdp or any(f in used for f in fsdp):
            return spec
        # place fsdp on the largest divisible unsharded dim
        shape = tuple(sd.shape)
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in order:
            if axes[i] is None and shape[i] % axis_size(mesh, fsdp) == 0:
                axes[i] = fsdp if len(fsdp) > 1 else fsdp[0]
                return P(*axes)
        return spec

    return map2(one, p_shape, p_specs)


def opt_specs(opt_shape, p_specs, p_shape=None, mesh=None):
    """Optimizer state: moments shard like params (plus the ZeRO split
    when shapes+mesh are provided); scalars replicate."""
    m_specs = p_specs
    if p_shape is not None and mesh is not None:
        m_specs = state_specs(p_shape, p_specs, mesh)
    return {
        "m": m_specs,
        "v": m_specs,
        "step": P(),
        **({"err": m_specs} if "err" in opt_shape else {}),
    }


# ==========================================================================
# Input / cache specs
# ==========================================================================
def batch_specs(cfg: ArchConfig, shape: Shape, mesh) -> Dict[str, P]:
    fsdp = axes_in(mesh, FSDP_AXES)
    b = shape.global_batch
    dp = _maybe(mesh, fsdp, b)
    out = {}
    if cfg.embedding_inputs:
        out["frames"] = P(dp, None, None)
    else:
        out["tokens"] = P(dp, None)
    if shape.kind == "train":
        out["labels"] = P(dp, None)
    if cfg.img_tokens:
        out["img_embeds"] = P(dp, None, None)
    return out


def _cache_slot_spec(mixer: str, cfg: ArchConfig, shape: Shape, mesh):
    fsdp = axes_in(mesh, FSDP_AXES)
    b = shape.global_batch
    long_ctx = shape.name == "long_500k"
    dp = _maybe(mesh, fsdp, b)
    seq_axes = (tuple(fsdp) + (TP,)) if long_ctx else TP

    if mixer == "attn":
        # (periods, B, T, Hkv, Dh): batch over fsdp, seq over model
        kv = P(None, dp, _maybe(mesh, seq_axes, shape.seq_len), None, None)
        return {"k": kv, "v": kv}
    if mixer == "cross_attn":
        kv = P(None, dp, _maybe(mesh, TP, cfg.img_tokens), None, None)
        return {"k": kv, "v": kv}
    inner_axes = (tuple(fsdp) + (TP,)) if long_ctx else TP
    if mixer == "mamba":
        di = cfg.mamba_d_inner
        ia = _maybe(mesh, inner_axes, di)
        return {"ssm": P(None, dp, ia, None), "conv": P(None, dp, None, ia)}
    if mixer == "mlstm":
        # DP-only recurrent state
        return {"C": P(None, dp, None, None, None),
                "n": P(None, dp, None, None),
                "m": P(None, dp, None)}
    if mixer == "slstm":
        leaf = P(None, dp, None, None)
        return {"c": leaf, "n": leaf, "h": leaf, "m": leaf}
    raise ValueError(mixer)


def cache_specs(cfg: ArchConfig, shape: Shape, mesh):
    return {f"slot{i}": _cache_slot_spec(m, cfg, shape, mesh)
            for i, (m, _) in enumerate(cfg.block_pattern)}


def param_placements(params_shape, cfg: ArchConfig, mesh):
    """``param_specs`` as DTensor placements: a nested dict of lists."""
    return map2(lambda _, s: placements(s, mesh), params_shape,
                param_specs(params_shape, cfg, mesh))
