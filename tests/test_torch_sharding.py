"""The port's sharding rules (``repro_torch.distributed``) against the
reference's, in-process with no process group: shape-only meshes at
production sizes, the ten archs at full config.  Then the torch twins of
the 7 tests of tests/test_sharding.py, and ``elastic.plan`` against the
reference's."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from repro import configs as jconfigs
from repro.distributed import elastic as jelastic
from repro.distributed import sharding as jshd
from repro.models import transformer as jtransformer
from repro.training import TrainConfig as JTrainConfig
from repro.training import init_train_state as j_init_train_state
from repro_torch import configs
from repro_torch.configs import SHAPES
from repro_torch.distributed import elastic
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import (ShapeMesh, current, hint,
                                             use_rules)
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import transformer
from repro_torch.params import params_from_numpy
from repro_torch.training import TrainConfig, init_opt_state, init_train_state

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "1x8": ((1, 8), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
CELLS = [(a, m) for a in jconfigs.ARCH_NAMES for m in MESHES]


def _mesh(name):
    return ShapeMesh(*MESHES[name])


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch):
    """The reference's parameter shapes at full config (no arrays)."""
    cfg = jconfigs.get_config(arch)
    return jax.eval_shape(
        lambda k: jtransformer.init_params(k, cfg, jnp.float32),
        jax.random.PRNGKey(0))


def _flat(tree, prefix=""):
    """(path, leaf) pairs of a nested dict whose leaves are specs."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k],
                                                        f"{prefix}/{k}")]
    return [(prefix, tuple(tree))]


def _same(port, ref):
    assert _flat(port) == _flat(ref)


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_param_state_opt_specs_match_reference(arch, mesh):
    m = _mesh(mesh)
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    shapes = _jax_shapes(arch)
    ps, jps = shd.param_specs(shapes, cfg, m), jshd.param_specs(shapes, jcfg,
                                                                 m)
    _same(ps, jps)
    _same(shd.state_specs(shapes, ps, m), jshd.state_specs(shapes, jps, m))
    for keys in (("m", "v", "step"), ("m", "v", "step", "err")):
        opt = dict.fromkeys(keys)
        _same(shd.opt_specs(opt, ps, shapes, m),
              jshd.opt_specs(opt, jps, shapes, m))
        _same(shd.opt_specs(opt, ps), jshd.opt_specs(opt, jps))


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_rules_batch_and_cache_specs_match_reference(arch, mesh):
    m = _mesh(mesh)
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for name, shape in SHAPES.items():
        jshape = jconfigs.SHAPES[name]
        assert shd.logical_rules(cfg, shape, m) == \
            jshd.logical_rules(jcfg, jshape, m)
        _same(shd.batch_specs(cfg, shape, m), jshd.batch_specs(jcfg, jshape,
                                                                m))
        _same(shd.cache_specs(cfg, shape, m), jshd.cache_specs(jcfg, jshape,
                                                                m))


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_placements_shard_exactly_what_the_spec_shards(arch, mesh):
    """Each parameter's and moment's placements shard dimension d over
    mesh axis a exactly where the (divisibility-guarded) spec does, so no
    leaf is sharded where the reference replicates it, nor unevenly."""
    m = _mesh(mesh)
    cfg = configs.get_config(arch)
    shapes = _jax_shapes(arch)
    ps = shd.param_specs(shapes, cfg, m)
    leaves = dict(_flat(jax.tree.map(lambda s: tuple(s.shape), shapes)))
    for specs in (ps, shd.state_specs(shapes, ps, m)):
        for path, spec in _flat(specs):
            pl = shd.placements(shd.P(*spec), m)
            for i, a in enumerate(m.axis_names):
                want = [d for d, ax in enumerate(spec) if ax is not None and
                        a in ((ax,) if isinstance(ax, str) else ax)]
                got = [pl[i].dim] if pl[i].is_shard() else []
                assert got == want, (path, spec, pl)
            for d, ax in enumerate(spec):
                if ax is not None:
                    assert leaves[path][d] % shd.axis_size(m, ax) == 0


def test_placements_refuse_axes_out_of_mesh_order():
    m = _mesh("2x16x16")
    assert [str(p) for p in shd.placements(
        shd.P(("pod", "data"), "model"), m)] == ["S(0)", "S(0)", "S(1)"]
    with pytest.raises(ValueError):
        shd.placements(shd.P(("data", "pod"), None), m)


# --------------------------------------------------------------------------
# tests/test_sharding.py's seven, on the port
# --------------------------------------------------------------------------
def test_param_specs_cover_every_leaf():
    m = _mesh("1x1")
    for arch in configs.ARCH_NAMES:
        cfg = configs.get_tiny_config(arch)
        params = transformer.init_params(cfg, generator=torch.Generator(),
                                         dtype=torch.float32, device="meta")
        specs = shd.param_specs(params, cfg, m)
        flat = transformer.tree_leaves(params)
        flat_specs = [s for _, s in _flat(specs)]
        assert len(flat) == len(flat_specs)
        for x, sp in zip(flat, flat_specs):
            assert len(sp) == x.dim(), (arch, x.shape, sp)


def test_divisibility_fallback():
    # _maybe returns None when the dim does not divide
    assert shd._maybe(_mesh("1x1"), "model", 7) == "model"
    assert shd._maybe(_mesh("1x8"), "model", 5) is None
    assert shd._maybe(_mesh("2x4"), ("data",), 6) == "data"


def test_logical_rules_head_vs_seq_sharding():
    """deepseek (56 heads) must fall back to sequence-parallel attention;
    qwen3 (32 heads) shards heads — on a 16-way model axis."""
    fm = _mesh("16x16")
    ds = shd.logical_rules(configs.get_config("deepseek-coder-33b"),
                           SHAPES["train_4k"], fm)
    q3 = shd.logical_rules(configs.get_config("qwen3-8b"),
                           SHAPES["train_4k"], fm)
    assert ds["heads"] is None and ds["qseq"] == "model"
    assert q3["heads"] == "model" and q3["qseq"] is None


def test_decode_rules_shard_kv_seq():
    fm = _mesh("2x16x16")
    r = shd.logical_rules(configs.get_config("qwen3-8b"),
                          SHAPES["decode_32k"], fm)
    assert r["kv_seq"] == "model"
    assert r["batch"] == ("pod", "data")
    r500 = shd.logical_rules(configs.get_config("jamba-1.5-large-398b"),
                             SHAPES["long_500k"], fm)
    assert r500["batch"] is None
    assert set(r500["kv_seq"]) == {"pod", "data", "model"}


def test_hint_noop_outside_context():
    x = torch.ones((4, 4))
    assert hint(x, "batch", None) is x


def test_hint_divisibility_guard():
    """On a (1, 1) mesh of a gloo world of one (as the reference's 1x1
    mesh): a DTensor keeps its shape and takes the rules' placements; the
    context is gone after the block."""
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    with use_rules(mesh, {"batch": "data"}):
        x = distribute_tensor(torch.ones((3, 4)), mesh.device_mesh,
                              [Replicate()] * 2)
        y = hint(x, "batch", None)   # 3 % 1 == 0 on 1x1 mesh: fine
        assert isinstance(y, DTensor) and y.shape == x.shape
        assert [str(p) for p in y.placements] == ["S(0)", "R"]
    assert current() is None


def test_production_mesh_needs_its_process_count():
    """As JAX without 256 or 512 devices, the production meshes refuse a
    world of another size (here a gloo world of one)."""
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"needs {n} processes"):
            make_production_mesh(multi_pod=multi_pod, device="cpu")


def test_cache_specs_structure_matches_cache():
    m = _mesh("1x1")
    for arch in ("olmo-1b", "jamba-1.5-large-398b", "xlstm-350m"):
        cfg = configs.get_tiny_config(arch)
        spec = shd.cache_specs(cfg, SHAPES["decode_32k"], m)
        cache = transformer.cache_spec(cfg, 4, 64)
        assert set(spec.keys()) == set(cache.keys())
        for slot in cache:
            assert set(spec[slot].keys()) == set(cache[slot].keys())


# --------------------------------------------------------------------------
# elastic.plan
# --------------------------------------------------------------------------
@pytest.mark.parametrize("pair", [("2x4", "1x1"), ("16x16", "2x16x16"),
                                  ("1x1", "1x8")])
@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-moe-30b-a3b"])
def test_plan_matches_reference(arch, pair):
    """``ReshardPlan`` field for field, at the reference's 16 GiB, from the
    same weights; the port's also from meta tensors (shapes alone)."""
    src, dst = (_mesh(n) for n in pair)
    jcfg, cfg = jconfigs.get_tiny_config(arch), configs.get_tiny_config(arch)
    jp, jo = j_init_train_state(jax.random.PRNGKey(0), jcfg,
                                JTrainConfig(remat="none"))
    p = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    state = {"params": p, "opt": init_opt_state(p, TrainConfig().opt)}
    hbm = 16 * 1024 ** 3
    ref = jelastic.plan({"params": jp, "opt": jo}, jcfg, src, dst,
                        hbm_bytes=hbm)
    got = elastic.plan(state, cfg, src, dst, hbm_bytes=hbm)
    assert vars(got) == vars(ref)
    meta = dict(zip(("params", "opt"), init_train_state(
        cfg, TrainConfig(), generator=torch.Generator(), device="meta")))
    assert vars(elastic.plan(meta, cfg, src, dst, hbm_bytes=hbm)) == vars(ref)
    # the port's default is one H100's 80 GB
    assert elastic.plan(meta, cfg, src, dst).fits == \
        (got.bytes_per_device_to <= 80e9)
