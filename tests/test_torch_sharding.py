"""PyTorch port, the layout registry, the plans and the placement rules
against the JAX package's, on the CPU.

The JAX process has one device, so the reference's rules are read on
``jax.sharding.AbstractMesh`` meshes and the port's on ``launch/mesh.Mesh``
grids of the same sizes: (1, 1), (1, 2), (1, 4), (2, 2) and (4, 2) over
("data", "model"). Every placement is compared term for term, a
PartitionSpec's entries against the port's tuple (a one-name tuple is the
name, as PartitionSpec writes it). The serve states are the reference's
own, shapes only (``jax.eval_shape`` of its prefill): every leaf of each
assigned arch (reduced), at batch sizes 1 to 4, under the three GSPMD
layouts and the auto rule (``layout=None``).
"""
import dataclasses
import functools
import re
import warnings

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.core import layouts as jlayouts
from repro.models import model as JM
from repro.runtime import sharding as jsharding
from repro_torch import configs as tconfigs
from repro_torch.core import layouts as tlayouts
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.runtime import sharding as tsharding
import _torch_threads  # noqa: F401,E402  (one torch thread a process)

MESHES = [(1, 1), (1, 2), (1, 4), (2, 2), (4, 2)]
GSPMD = ("head", "coplace", "interleave")


def _meshes(shape):
    return (AbstractMesh(shape, ("data", "model")),
            tmesh.Mesh(sizes=shape, coords=(0, 0)))


def _norm(entry):
    if isinstance(entry, tuple):
        return entry[0] if len(entry) == 1 else entry
    return entry


def _spec(s):
    """A PartitionSpec or a port placement as a comparable tuple."""
    return tuple(_norm(a) for a in s)


# ---------------------------------------------------------------------------
# the registry and the plans
# ---------------------------------------------------------------------------


def test_registry_names_aliases_and_errors():
    assert tlayouts.available_layouts() == jlayouts.available_layouts()
    for name in jlayouts.available_layouts():
        assert tlayouts.resolve_layout(name) == jlayouts.resolve_layout(name)
        assert tlayouts.get_layout(name).name == jlayouts.get_layout(name).name
        assert tlayouts.get_layout(name).shards_pages == jlayouts.get_layout(name).shards_pages
    for alias in (None, "auto"):
        for lib in (tlayouts, jlayouts):
            lib._warned_aliases.discard(alias)
            with pytest.warns(DeprecationWarning, match="deprecated alias"):
                assert lib.resolve_layout(alias) == "default"
            with warnings.catch_warnings():
                warnings.simplefilter("error")  # one-shot: silent the second time
                assert lib.resolve_layout(alias) == "default"
        assert tlayouts.get_layout(alias).name == "default"
    msgs = []
    for lib in (tlayouts, jlayouts):
        with pytest.raises(ValueError) as e:
            lib.resolve_layout("nope")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "registered layouts" in msgs[0]


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_plans_equal_the_reference(shape):
    cfg_j = jconfigs.reduced(jconfigs.get_arch("llama3-8b"))
    cfg_t = tconfigs.reduced(tconfigs.get_arch("llama3-8b"))
    jm, tm = _meshes(shape)
    for name in GSPMD + ("default",):
        jp = jlayouts.get_layout(name).plan(cfg_j, jm)
        tp = tlayouts.get_layout(name).plan(cfg_t, tm)
        for f in ("layout", "capacity_quantum", "shard_state", "balance_shards",
                  "page_stripe_shards"):
            assert getattr(tp, f) == getattr(jp, f), (name, f)
        assert tp.mesh is tm
        assert tp.round_capacity(61) == jp.round_capacity(61)


def test_plan_mesh_validation_and_default_mesh():
    """interleave needs a 'data' axis, every GSPMD layout a 'model' axis, with
    the reference's messages; without a mesh the plan takes the one-rank
    mesh (the reference's default mesh over its one device)."""
    cfg_j = jconfigs.reduced(jconfigs.get_arch("smollm-360m"))
    cfg_t = tconfigs.reduced(tconfigs.get_arch("smollm-360m"))
    for axes, names in ((("model",), ("interleave",)), (("data",), GSPMD)):
        jm = AbstractMesh((2,), axes)
        tm = tmesh.Mesh(sizes=(2,), coords=(0,), groups=(None,), axis_names=axes)
        for name in names:
            msgs = []
            for lib, cfg, m in ((tlayouts, cfg_t, tm), (jlayouts, cfg_j, jm)):
                with pytest.raises(ValueError) as e:
                    lib.get_layout(name).plan(cfg, m)
                msgs.append(str(e.value))
            assert msgs[0] == msgs[1], msgs
    for name in GSPMD:
        plan = tlayouts.get_layout(name).plan(cfg_t)
        assert plan.mesh.shape == {"data": 1, "model": 1} and plan.mesh.backend is None
    with pytest.raises(ValueError, match="coplace_shmap"):
        tlayouts.get_layout("coplace", 2)


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_params(name, full=False):
    """(config, JAX parameter shapes) of an arch, reduced unless ``full``;
    traced once per module."""
    cfg = jconfigs.get_arch(name) if full else jconfigs.reduced(jconfigs.get_arch(name))
    return cfg, jax.eval_shape(lambda k: JM.init_params(cfg, k), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _jax_states(name):
    """(config, parameter shapes, {batch size: serve state shapes}) of a
    reduced arch, traced once per module."""
    cfg, ps = _jax_params(name)
    out = {}
    for b in (1, 2, 3, 4):
        probe = (jax.ShapeDtypeStruct((b, 8, cfg.d_model), jnp.float32)
                 if cfg.embed_frontend_stub else jax.ShapeDtypeStruct((b, 8), jnp.int32))
        st = jax.eval_shape(lambda p, x: JM.prefill(cfg, p, x, capacity=64), ps, probe)[1]
        st["length"] = jax.ShapeDtypeStruct((b,), jnp.int32)
        out[b] = st
    return cfg, ps, out


@pytest.mark.parametrize("name", jconfigs.ASSIGNED)
def test_state_placements_equal_the_reference(name):
    """Every leaf of the reduced serve state, each layout (and the auto
    rule), each mesh, batch sizes 1-4: the port's placement equals the
    reference's, term for term."""
    cfg, _, states = _jax_states(name)
    for shape in MESHES:
        jm, tm = _meshes(shape)
        for b, st in states.items():
            flat = jax.tree_util.tree_flatten_with_path(st)[0]
            leaves = [(jax.tree_util.keystr(p), tuple(x.shape)) for p, x in flat]
            for layout in (None,) + GSPMD:
                want = jax.tree_util.tree_leaves(
                    jsharding.state_shardings(cfg, jm, st, layout=layout, batch_size=b),
                    is_leaf=lambda x: hasattr(x, "spec"))
                got = tsharding.leaf_shardings(tm, leaves, layout=layout, batch_size=b)
                assert len(got) == len(want)
                for (path, _), g, w in zip(leaves, got, want):
                    assert _spec(g) == _spec(w.spec), (shape, b, layout, path)


def test_port_state_placements_equal_the_reference():
    """The port's own serve state (one list of layers) under
    ``state_shardings``: each leaf placed as the reference places the same
    leaf of its layer-stacked state (the stacked dim dropped)."""
    jcfg, _, states = _jax_states("smollm-360m")
    tcfg = tconfigs.reduced(tconfigs.get_arch("smollm-360m"))
    for shape in MESHES:
        jm, tm = _meshes(shape)
        for b in (2, 3):
            tstate = TM.empty_serve_state(tcfg, b, capacity=64, dtype=torch.float32,
                                          device="meta")
            for layout in GSPMD:
                want = {re.sub(r"^\['blocks'\]\['pos\d+'\]", "", jax.tree_util.keystr(p)):
                        s.spec for p, s in jax.tree_util.tree_flatten_with_path(
                            jsharding.state_shardings(jcfg, jm, states[b], layout=layout,
                                                      batch_size=b))[0]}
                got = dict(tsharding.state_shardings(tcfg, tm, tstate, layout=layout,
                                                     batch_size=b))
                assert got.pop("['length']") == ()
                assert len(got) == tcfg.num_layers * (len(want) - 1)
                for path, spec in got.items():
                    key = re.sub(r"^\['layers'\]\[\d+\]", "", path)
                    assert _spec(spec) == _spec(want[key])[1:], (layout, path)


@pytest.mark.parametrize("mode", ["serve", "train", "opt"])
def test_param_placements_equal_the_reference(mode):
    """``param_shardings`` in each mode, every leaf of each assigned arch
    (reduced, and qwen2-72b at full size, where FSDP turns on), each mesh."""
    cases = [(n, False, tconfigs.reduced(tconfigs.get_arch(n))) for n in jconfigs.ASSIGNED]
    cases.append(("qwen2-72b", True, tconfigs.get_arch("qwen2-72b")))
    for name, full, tcfg in cases:
        jcfg, ps = _jax_params(name, full)
        for shape in MESHES:
            jm, tm = _meshes(shape)
            want = jax.tree_util.tree_leaves(jsharding.param_shardings(jcfg, jm, ps, mode),
                                             is_leaf=lambda x: hasattr(x, "spec"))
            got = jax.tree_util.tree_leaves(
                tsharding.param_shardings(tcfg, tm, ps, mode),
                is_leaf=lambda x: isinstance(x, tuple))
            assert [_spec(g) for g in got] == [_spec(w.spec) for w in want], \
                (jcfg.name, shape)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_batch_sharding_equals_the_reference(shape):
    jm, tm = _meshes(shape)
    for b in range(1, 9):
        assert _spec(tsharding.batch_sharding(tm, b)) == _spec(
            jsharding.batch_sharding(jm, b).spec)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_local_blocks_tile_the_leaf(shape):
    """Every rank's ``local_block`` of a leaf, put back at its bounds, gives
    the whole leaf; each element lies in exactly as many tiles as the ranks
    that replicate it."""
    data, model = shape
    x = torch.arange(8 * 4 * 8 * 8 * 2, dtype=torch.float32).reshape(8, 4, 8, 8, 2)
    specs = [(("data",), "model", None, None, None), (None, None, "model", "data", None),
             (None, "model"), (("data", "model"),), ("model", None, "data"), ()]
    for spec in specs:
        back = torch.zeros_like(x)
        seen = torch.zeros_like(x)
        for d in range(data):
            for m in range(model):
                mesh = tmesh.Mesh(sizes=shape, coords=(d, m))
                tile = tsharding.local_block(x, spec, mesh)
                bounds = tsharding.block_bounds(x.shape, spec, mesh)
                idx = tuple(slice(a, b) for a, b in bounds)
                assert tile.shape == back[idx].shape
                back[idx] = tile
                seen[idx] += 1
        assert torch.equal(back, x), spec
        tree = tsharding.local_tree({"a": x, "b": [x]}, {"a": spec, "b": [spec]}, mesh)
        assert torch.equal(tree["b"][0], tsharding.local_block(x, spec, mesh))
        used = 1
        for a in spec:
            for ax in ((a,) if isinstance(a, str) else (a or ())):
                used *= shape[("data", "model").index(ax)]
        assert (seen == data * model // used).all(), spec
    with pytest.raises(ValueError, match="divide"):
        tsharding.block_bounds((3, 4), ("model",), tmesh.Mesh(sizes=(1, 2), coords=(0, 1)))


def test_placed_blocks_follow_the_placement():
    """A GSPMD layout placed on a rank allocates exactly its tiles, with the
    empty values, and its placement is the reference's rule."""
    cfg = tconfigs.reduced(tconfigs.get_arch("llama3-8b"), num_heads=8, num_kv_heads=4)
    spec = TT.attn_spec(cfg)
    for layout, shape, coords in (("head", (1, 2), (0, 1)), ("coplace", (1, 4), (0, 2)),
                                  ("interleave", (2, 2), (1, 0))):
        mesh = tmesh.Mesh(sizes=shape, coords=coords)
        placed = tlayouts.get_layout(layout).placed(mesh, batch=3, capacity=64)
        paged, stream = placed.empty_decode_state(spec, 3, 64, dtype=torch.float32,
                                                  device="cpu")
        place = placed.place(spec)
        for key, c in (("paged", paged), ("stream", stream)):
            for f in dataclasses.fields(c):
                t = getattr(c, f.name)
                bounds = place.bounds[(key, f.name)]
                assert t.shape == tuple(b - a for a, b in bounds), (layout, f.name)
        assert paged.k_pages.shape == {"head": (3, 1, 8, 8, 32), "coplace": (3, 2, 2, 8, 32),
                                       "interleave": (3, 2, 4, 4, 32)}[layout]
        assert bool((paged.page_start == -1).all()) and bool((stream.pos == -1).all())
        assert bool((paged.tau_min == float("inf")).all())
    with pytest.raises(ValueError, match="placed for"):
        placed.empty_decode_state(spec, 2, 64, dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_coplace_shmap_on_a_mesh_equals_the_reference(shape):
    """coplace_shmap given a mesh: its plan (capacity quantum, balance and
    stripe counts, the mesh) and every serve-state leaf's placement of each
    assigned arch at batch sizes 1-4 equal the reference's layout on the
    same mesh; each rank's block of the pages is its stripe of the striped
    order (slot j of rank r's block holds logical page j·M + r) and a
    prefilled batch-1 state packed into it holds exactly those pages;
    ``shards`` must be 1 or M."""
    cfg_j = jconfigs.reduced(jconfigs.get_arch("llama3-8b"))
    cfg_t = tconfigs.reduced(tconfigs.get_arch("llama3-8b"))
    jm, tm = _meshes(shape)
    m = shape[1]
    jp = jlayouts.get_layout("coplace_shmap").plan(cfg_j, jm)
    tp = tlayouts.get_layout("coplace_shmap", m, mesh=tm).plan(cfg_t, tm)
    for f in ("layout", "capacity_quantum", "shard_state", "balance_shards",
              "page_stripe_shards"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert tp.mesh is tm and tp.page_stripe_shards == m
    for name in ("llama3-8b", "gemma3-1b", "zamba2-2.7b"):
        cfg, _, states = _jax_states(name)
        for b, st in states.items():
            flat = jax.tree_util.tree_flatten_with_path(st)[0]
            leaves = [(jax.tree_util.keystr(p), tuple(x.shape)) for p, x in flat]
            want = jax.tree_util.tree_leaves(
                jsharding.state_shardings(cfg, jm, st, layout="coplace_shmap", batch_size=b),
                is_leaf=lambda x: hasattr(x, "spec"))
            got = tsharding.leaf_shardings(tm, leaves, layout="coplace_shmap", batch_size=b)
            for (path, _), g, w in zip(leaves, got, want):
                assert _spec(g) == _spec(w.spec), (name, b, path)
    cfg = tconfigs.reduced(tconfigs.get_arch("llama3-8b"), num_heads=8, num_kv_heads=4)
    spec = TT.attn_spec(cfg)
    k = torch.randn(1, 40, spec.n_kv, spec.head_dim, generator=torch.Generator().manual_seed(1))
    for r in range(m):
        mesh = tmesh.Mesh(sizes=shape, coords=(0, r))
        placed = tlayouts.get_layout("coplace_shmap", mesh=mesh).placed(mesh, batch=2,
                                                                        capacity=64)
        place = placed.place(spec)
        assert place.stripes == m and place.minus_one and place.partials == (m > 1)
        assert place.block_pages("paged", "k_pages") == ((r, m) if m > 1 else (0, 1))
        paged, stream = placed.empty_decode_state(spec, 2, 64, dtype=torch.float32,
                                                  device="cpu")
        big = {"paged": paged, "stream": stream}
        placed.pack_slot(spec, big, placed.prefill(spec, k, k, 40, 64), 0)
        starts = paged.page_start[0, 0]
        pages = torch.arange(r, 64 // 8, m)
        assert torch.equal(starts, torch.where(pages * 8 < 40, pages * 8, -1).int())
    for shards in {2, m + 1} - {1, m}:
        with pytest.raises(ValueError, match=f"1 or {m}, got {shards}"):
            tlayouts.get_layout("coplace_shmap", shards, mesh=tm)
