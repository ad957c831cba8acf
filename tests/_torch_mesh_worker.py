"""One rank of a GSPMD-layout run of the PyTorch port, on the CPU over gloo.

``tests/test_torch_layouts.py`` starts as many processes as its largest
mesh has ranks:

    python tests/_torch_mesh_worker.py JOB RANK

JOB is a pickle of the meshes to run, each with its world size, its
'model' axis size, its FileStore path and its cases. Each process takes
every mesh in turn: as rank RANK of that mesh's own process group where
RANK is below its world size, and sits it out otherwise. Each case names
a config, the parameters (the JAX package's tree as numpy arrays, bridged
by ``models/convert.params_from_numpy``), a layout, the engine's options
(speculative decode, tiered residency and rebalancing among them) and the
requests (a tiered one may force a request's pages cold at a selection
boundary), or a single-step check of the sharded attention bodies (decode,
chunk, speculative verify and its commit) against the default body (under
``coplace_shmap``, the one-card body over as many page stripes as the
mesh's 'model' axis has ranks), or of
one layer of another kind on the rank's blocks: a full cache (a window
layer, or H²EAL off: decode and chunk) or a recurrent mixer (a chunk
resumed and a decode step, the whole block with its FFN) against the
default's on the whole state. The process writes its results, by mesh, to
JOB.RANK. This module imports no JAX: the port's ranks run without it.
"""
import dataclasses
import os
import pickle
import sys

import torch

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import cache as cachelib  # noqa: E402
from repro_torch.core import hybrid_attention as hattn  # noqa: E402
from repro_torch.core import layouts as layoutlib  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.runtime import sharding  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402


def config(name, overrides, h2=()):
    cfg = tconfigs.reduced(tconfigs.get_arch(name), **dict(overrides))
    if h2:
        cfg = dataclasses.replace(cfg, h2eal=dataclasses.replace(cfg.h2eal, **dict(h2)))
    return cfg


def serve(eng, requests, force_after=None):
    """Serve ``requests`` a poll at a time; with ``force_after``, every
    spillable page of the first decoding slot with more than a share window
    to go is forced cold at its selection boundary once that many decode
    steps have run (``Engine.tier_force_spill``). Returns the completions
    and the (uid, pages) forced, or None."""
    for r in requests:
        eng.submit(r)
    forced, w = None, eng.share_window
    while eng.busy():
        b = eng.batch
        if forced is None and force_after is not None and \
                eng.stats.decode_steps >= force_after:
            due = [i for i in range(b.max_batch)
                   if b.active[i] and b.phase[i] % w == 0 and b.remaining[i] > w]
            if due:
                uid = int(b.uid[due[0]])
                forced = (uid, eng.tier_force_spill(uid))
        eng.poll()
    eng.finalize()
    return dict(eng.completions), forced


def run_engine(case, mesh):
    """The case's engine on this rank (``mesh`` None: the one-card engine of
    the case's options): its tokens, its step captures before and after the
    run, its stats, the (src, dst, far pages of src) of each migration and
    the request forced cold."""
    cfg = config(case["arch"], case["overrides"], case.get("h2", ()))
    params = params_from_numpy(cfg, case["params"], "cpu")
    eng = Engine(cfg, params, layout=case["layout"], mesh=mesh, device="cpu",
                 **case["engine"])
    moves, migrate = [], eng._migrate_slot

    def logged(src, dst):
        far = 0 if eng._tier is None else sum(k[0] == src for k in eng._tier.far)
        moves.append((src, dst, far))
        migrate(src, dst)
    eng._migrate_slot = logged
    before = eng.jit_cache_sizes()
    comps, forced = serve(eng, [Request(**r) for r in case["requests"]],
                          case.get("force_after"))
    return {"tokens": {u: c.tokens for u, c in comps.items()},
            "captures": (before, eng.jit_cache_sizes()),
            "stats": dataclasses.asdict(eng.stats), "moves": moves, "forced": forced,
            "far_bytes": (0, 0) if eng._tier is None else (eng._tier.h2d_bytes,
                                                           eng._tier.d2h_bytes)}


def _fields(c):
    return {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}


def _block(state, place, mesh):
    """This rank's blocks of a whole layer state {"paged", "stream"}."""
    return {key: type(c)(**{f: sharding.local_block(t, place.specs[(key, f)],
                                                    mesh).clone()
                            for f, t in _fields(c).items()})
            for key, c in state.items()}


def _clone(state):
    return {key: type(c)(**{f: t.clone() for f, t in _fields(c).items()})
            for key, c in state.items()}


def _state_diff(block, full, place, mesh):
    """The largest difference of the rank's blocks from its tiles of the
    full state, per field (equal values, infinities too, differ by 0), and
    of the importance relative to its magnitude (at least 1)."""
    out = {}
    for key, c in block.items():
        for f, t in _fields(c).items():
            want = sharding.local_block(getattr(full[key], f), place.specs[(key, f)], mesh)
            diff = (t.double() - want.double()).abs().nan_to_num(nan=float("inf"))
            if f == "importance":
                diff = diff / want.double().abs().clamp(min=1.0)
            out[f"{key}.{f}"] = float(torch.where(t == want, 0.0, diff).max())
    return out


def run_steps(case, mesh):
    """One layer's decode steps (select, then reuse), a chunk step, a
    speculative verify of 4 tokens and the commit of its accepted prefix on
    the rank's blocks, beside the default body on the whole state (under
    ``coplace_shmap`` the one-card body over the rank's stripe count, on
    the whole state striped as it is), from one seeded state: each output's
    largest difference from the reference's, and the blocks' from the tiles
    of the reference's state."""
    cfg = config(case["arch"], case["overrides"])
    spec = T.attn_spec(cfg)
    b, cap, cch = case["batch"], case["capacity"], case["chunk"]
    placed = layoutlib.get_layout(case["layout"], mesh=mesh).placed(mesh, batch=b,
                                                                    capacity=cap)
    place = placed.place(spec)
    ref = (layoutlib.get_layout(case["layout"], placed.shards)
           if case["layout"] == layoutlib.LAYOUT_COPLACE_SHMAP else layoutlib.DEFAULT)
    g = torch.Generator().manual_seed(case["seed"])
    rnd = lambda *s: torch.randn(*s, generator=g)
    hkv, hq, d = spec.n_kv, spec.n_q, spec.head_dim
    # the whole state: slot i prefilled to its own length, then packed
    full = dict(zip(("paged", "stream"), hattn.empty_decode_state(
        spec, b, cap, dtype=torch.float32, device="cpu")))
    lengths = case["lengths"]
    for i, n in enumerate(lengths):
        small = ref.prefill(spec, rnd(1, n, hkv, d), rnd(1, n, hkv, d), n, cap)
        for key in full:
            for f, t in _fields(full[key]).items():
                t[i].copy_(getattr(small[key], f)[0])
    block = _block(full, place, mesh)
    length = torch.tensor(lengths, dtype=torch.int32)
    active = torch.tensor(case["active"])
    out = {"steps": []}
    for do_select, need in ((True, torch.tensor(case["need"])), (False, None)):
        q, k, v = rnd(b, hq, d), rnd(b, hkv, d), rnd(b, hkv, d)
        want, full = ref.decode(spec, full, q, k, v, length, do_select=do_select,
                                active=active, need_select=need)
        got, block = placed.decode(spec, block, q, k, v, length, do_select=do_select,
                                   active=active, need_select=need)
        out["steps"].append({"out": float((got - want).abs().max()),
                             "state": _state_diff(block, full, place, mesh)})
        length = torch.where(active, length + 1, length)
    q, k, v = rnd(b, cch, hq, d), rnd(b, cch, hkv, d), rnd(b, cch, hkv, d)
    clen = torch.tensor(case["chunk_len"], dtype=torch.int32)
    want, full = ref.prefill_chunk(spec, _clone(full), q, k, v, length, clen, clen > 0)
    got, block = placed.prefill_chunk(spec, block, q, k, v, length, clen, clen > 0)
    out["chunk"] = {"out": float((got - want).abs().max()),
                    "state": _state_diff(block, full, place, mesh)}
    length = length + clen
    kk = 4
    q, k, v = rnd(b, kk, hq, d), rnd(b, kk, hkv, d), rnd(b, kk, hkv, d)
    need = torch.tensor(case["need"])
    want, full = ref.verify_chunk(spec, full, q, k, v, length, active=active,
                                  need_select=need)
    got, block = placed.verify_chunk(spec, block, q, k, v, length, active=active,
                                     need_select=need)
    out["verify"] = {"out": float((got - want).abs().max()),
                     "state": _state_diff(block, full, place, mesh)}
    accepted = torch.tensor([3, 1, 4][:b], dtype=torch.int32)
    full = ref.verify_append(spec, full, k, v, length, accepted, active=active)
    block = placed.verify_append(spec, block, k, v, length, accepted, active=active)
    out["commit"] = {"out": 0.0, "state": _state_diff(block, full, place, mesh)}
    return out


def _diff(got, want) -> float:
    return float((got - want).abs().max())


def run_full_steps(case, mesh):
    """A full-cache layer (``case["pos"]``: a window layer, or any layer with
    H²EAL off) on the rank's block: a decode step and a chunk step against
    the default body on the whole seeded cache."""
    cfg = config(case["arch"], case["overrides"], case.get("h2", ()))
    spec = T.attn_spec(cfg, case["pos"])
    assert spec.full_cache
    b, cap, cch = case["batch"], case["capacity"], case["chunk"]
    placed = layoutlib.get_layout(case["layout"], mesh=mesh).placed(mesh, batch=b,
                                                                    capacity=cap)
    place = placed.place(spec)
    g = torch.Generator().manual_seed(case["seed"])
    rnd = lambda *s: torch.randn(*s, generator=g)
    hkv, hq, d = spec.n_kv, spec.n_q, spec.head_dim
    length = torch.tensor(case["lengths"], dtype=torch.int32)
    full = {"full": cachelib.make_full_cache(b, hkv, cap, d, dtype=torch.float32,
                                             device="cpu")}
    keep = (torch.arange(cap) < length[:, None])[:, None, :, None]
    full["full"].k.copy_(torch.where(keep, rnd(b, hkv, cap, d), 0.0))
    full["full"].v.copy_(torch.where(keep, rnd(b, hkv, cap, d), 0.0))
    block = _block(full, place, mesh)
    active = torch.tensor(case["active"])
    q, k, v = rnd(b, hq, d), rnd(b, hkv, d), rnd(b, hkv, d)
    want, full["full"] = layoutlib.DEFAULT.full_decode(spec, full["full"], q, k, v, length,
                                                       active)
    got, block["full"] = placed.full_decode(spec, block["full"], q, k, v, length, active)
    out = {"steps": [{"out": _diff(got, want), "state": _state_diff(block, full, place,
                                                                    mesh)}]}
    length = torch.where(active, length + 1, length)
    q, k, v = rnd(b, cch, hq, d), rnd(b, cch, hkv, d), rnd(b, cch, hkv, d)
    clen = torch.tensor(case["chunk_len"], dtype=torch.int32)
    want, full["full"] = layoutlib.DEFAULT.full_chunk(spec, full["full"], q, k, v, length,
                                                      clen, clen > 0)
    got, block["full"] = placed.full_chunk(spec, block["full"], q, k, v, length, clen,
                                           clen > 0)
    out["chunk"] = {"out": _diff(got, want), "state": _state_diff(block, full, place, mesh)}
    return out


# f32's unit roundoff; gamma(n) bounds the relative error of an f32 sum of n
# products in any order (Higham, Accuracy and Stability, Lemma 3.1)
U32 = 2.0 ** -24


def _gamma(n: int) -> float:
    return n * U32 / (1 - n * U32)


def _rows_bound(cfg, mixer, h, steps: int, whole) -> dict:
    """Per state field, how far a recurrent state computed on a rank's rows
    may lie from the same rows computed with the whole batch. Only the
    mixer's projections over d (products over another row count) may round
    otherwise: two f32 orders of one sum of d products differ by at most
    2 gamma(d) sum_i |h_i W_ij| <= 2 gamma(d) m, m the largest such sum over
    the mixer's (d, n) weights and the rows of ``h``. To first order a state
    value is a sum over the carried state and at most ``steps`` positions
    of products of a perturbed projection's image, through maps of slope at
    most 1.1 (silu, softplus, the stabilised exponential gates, decays
    <= 1, the conv's taps), with factors no larger than the field's
    magnitude: within 2 x 2 gamma(d) m (steps + 1) max(1, max|field|)."""
    d = cfg.d_model
    ws = [w for w in mixer.values() if w.dim() == 2 and w.shape[0] == d]
    m = max(float((h.abs().reshape(-1, d).double() @ w.abs().double()).max()) for w in ws)
    per = 4 * _gamma(d) * m * (steps + 1)
    return {f"{key}.{f}": per * max(1.0, float(t.double().abs().nan_to_num(
        posinf=0.0, neginf=0.0).max())) for key, c in whole.items()
        for f, t in _fields(c).items()}


def _rows_of(state, b0, b1):
    return {key: type(c)(**{f: t[b0:b1].clone() for f, t in _fields(c).items()})
            for key, c in state.items()}


def _exact(block, rows) -> dict:
    """The largest difference of the rank's blocks from the same rows
    stepped by the default body alone (equal values, infinities too, 0)."""
    return {f"{key}.{f}": float(torch.where(t == getattr(rows[key], f), 0.0,
                                            (t.double() - getattr(rows[key], f).double())
                                            .abs().nan_to_num(nan=float("inf"))).max())
            for key, c in block.items() for f, t in _fields(c).items()}


def run_recurrent_steps(case, mesh):
    """A recurrent block (``case["pos"]``) on the rank's rows: a chunk resumed
    from a seeded state and a decode step, against the default's on the
    whole state: the outputs within the steps' tolerance, the rank's rows of
    the state within ``_rows_bound`` of the whole state's (a projection over
    fewer rows may round otherwise on some CPUs) and equal, bit for bit, to
    the default body's stepping those rows alone."""
    cfg = config(case["arch"], case["overrides"], case.get("h2", ()))
    pos, b, cch = case["pos"], case["batch"], case["chunk"]
    rspec = T.layer_spec(cfg, pos)
    assert isinstance(rspec, cachelib.RecurrentSpec)
    placed = layoutlib.get_layout(case["layout"], mesh=mesh).placed(
        mesh, batch=b, capacity=case["capacity"])
    place = placed.place(rspec)
    b0, b1 = next(iter(place.bounds.values()))[0]
    g = torch.Generator().manual_seed(case["seed"])
    p = M.init_params(cfg, generator=g, device="cpu")["layers"][pos]
    rnd = lambda *s: torch.randn(*s, generator=g)
    full = T.empty_block_cache(cfg, pos, b, case["capacity"], dtype=torch.float32,
                               device="cpu")
    # a seeded state: one chunk of every slot from the empty state
    start = torch.zeros(b, dtype=torch.int32)
    clen0 = torch.full((b,), cch, dtype=torch.int32)
    T.block_prefill_chunk(cfg, pos, p, None, rnd(b, cch, cfg.d_model), None, full,
                          start=start, chunk_len=clen0, active=clen0 > 0)
    block = _block(full, place, mesh)
    rows = _rows_of(full, b0, b1)
    norm = lambda x: T.rms_norm(x, p["ln1"], cfg.norm_eps)
    mixer = p[T._RECURRENT[cfg.mixer_for_layer(pos)].pkey]

    def result(got, want, steps, x):
        return {"out": _diff(got, want), "state": _state_diff(block, full, place, mesh),
                "state_rows": _exact(block, rows),
                "state_bound": _rows_bound(cfg, mixer, norm(x[b0:b1]), steps, full)}

    x = rnd(b, cch, cfg.d_model)
    clen = torch.tensor(case["chunk_len"], dtype=torch.int32)
    kw = dict(start=start + cch, chunk_len=clen, active=clen > 0)
    want, _ = T.block_prefill_chunk(cfg, pos, p, None, x, None, full, **kw)
    got, _ = T.block_prefill_chunk(cfg, pos, p, None, x, None, block, layout=placed, **kw)
    T.block_prefill_chunk(cfg, pos, p, None, x[b0:b1], None, rows,
                          **{k: v[b0:b1] for k, v in kw.items()})
    out = {"chunk": result(got, want, cch, x)}
    x = rnd(b, cfg.d_model)
    active = torch.tensor(case["active"])
    kw = dict(length=start + cch + clen, do_select=False, active=active)
    want, _ = T.block_decode(cfg, pos, p, None, x, None, full, **kw)
    got, _ = T.block_decode(cfg, pos, p, None, x, None, block, layout=placed, **kw)
    T.block_decode(cfg, pos, p, None, x[b0:b1], None, rows,
                   **{k: (v[b0:b1] if isinstance(v, torch.Tensor) else v)
                      for k, v in kw.items()})
    out["steps"] = [result(got, want, 1, x)]
    return out


RUNS = {"engine": run_engine, "steps": run_steps, "full_steps": run_full_steps,
        "recurrent_steps": run_recurrent_steps}


def run_mesh(job, rank: int) -> dict:
    """Every case of one mesh, as rank ``rank`` of its process group."""
    meshlib.init_distributed("gloo", store_path=job["store"], rank=rank,
                             world_size=job["world"])
    try:
        mesh = meshlib.make_local_mesh(model=job["model"])
        results = {}
        for name, case in job["cases"].items():
            results[name] = RUNS[case["kind"]](case, mesh)
    finally:
        torch.distributed.destroy_process_group()
    return {"mesh": (mesh.sizes, mesh.coords), "results": results}


def main(job_path: str, rank: int) -> None:
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    out = {key: run_mesh(m, rank) for key, m in job["meshes"].items()
           if rank < m["world"]}
    with open(f"{job_path}.{rank}", "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
