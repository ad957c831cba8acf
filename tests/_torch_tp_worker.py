"""One rank of a tensor-parallel run of the PyTorch port, on the CPU over gloo.

``tests/test_torch_tensor_parallel.py`` starts as many processes as its
largest mesh has ranks:

    python tests/_torch_tp_worker.py JOB RANK

JOB is a pickle of the meshes to run, each with its world size, its
'model' axis size, its FileStore path and its cases. Each process takes
every mesh in turn, as rank RANK of that mesh's own process group where
RANK is below its world size (it sits the mesh out otherwise). A case is
lockstep ``generate(mesh=...)`` of a layout, steps of the sharded train
step (``runtime/train.jit_train_step``), or the training CLI's runs over
the mesh's ranks. The parameters are the JAX package's tree as numpy
arrays, bridged by ``models/convert.params_from_numpy``. The process
writes its results, by mesh, to JOB.RANK. This module imports no JAX.
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
from repro_torch.core.tree import leaves, leaves_with_paths  # noqa: E402
from repro_torch.data import lm_batch  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import sharding  # noqa: E402
from repro_torch.runtime import train as train_rt  # noqa: E402


def config(case):
    """The case's reduced config; ``factor``, where given, the MoE's
    capacity factor."""
    cfg = tconfigs.reduced(tconfigs.get_arch(case["arch"]), **dict(case["overrides"]))
    if case.get("factor") is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=case["factor"]))
    return cfg


def run_generate(case, mesh):
    """``generate(mesh=...)``: tokens, the last logits and the rank's
    parameter bytes; for ``coplace_shmap`` also the one-card layout's over
    as many page stripes as 'model' has ranks."""
    cfg = config(case)
    params = params_from_numpy(cfg, case["params"], "cpu")
    kw = dict(gen=case["gen"], capacity=case["capacity"], layout=case["layout"],
              h2eal=case.get("h2eal", True), device="cpu")
    prompts = torch.as_tensor(case["prompts"])
    toks, stats = launch_serve.generate(cfg, params, prompts, mesh=mesh, **kw)
    out = {"tokens": toks.numpy(), "last_logits": stats["last_logits"].numpy(),
           "param_bytes": stats["param_bytes"]}
    if case["layout"] == "coplace_shmap":
        toks, stats = launch_serve.generate(cfg, params, prompts,
                                            shards=mesh.shape["model"], **kw)
        out["one_card"] = (toks.numpy(), stats["last_logits"].numpy())
    return out


def run_train(case, mesh):
    """``steps`` sharded train steps on the global batches of ``lm_batch``:
    each step's metrics, the whole parameters after them (gathered), each
    leaf's placement, and the rank's own copy of every leaf that 'model'
    does not cut."""
    cfg = config(case)
    whole = params_from_numpy(cfg, case["params"], "cpu")
    tcfg = train_rt.TrainConfig(**case["kw"])
    threshold = sharding.FSDP_BYTES_THRESHOLD
    if case.get("fsdp"):
        sharding.FSDP_BYTES_THRESHOLD = 0  # the reference's rule, forced on
    try:
        specs = train_rt.train_shardings(cfg, mesh, whole)["params"]
        step = train_rt.jit_train_step(cfg, tcfg, mesh, whole, None, case["batch"])
        params, opt = train_rt.place_train_state(cfg, mesh, whole, adamw.init_state(whole))
        metrics = []
        for i in range(case["steps"]):
            batch = lm_batch(i, batch=case["batch"], seq=case["seq"], vocab=cfg.vocab_size)
            params, opt, m = step(params, opt, batch, i)
            metrics.append({k: float(v) for k, v in m.items()})
        gathered = sharding.gather_tree(params, specs, mesh)
    finally:
        sharding.FSDP_BYTES_THRESHOLD = threshold
    flat_specs = sharding.spec_leaves(whole, specs)
    own = {path: (x.numpy(), "data" in sharding._cut_axes(s, mesh))
           for (path, x), s in zip(leaves_with_paths(params), flat_specs)
           if "model" not in sharding._cut_axes(s, mesh)}
    return {"metrics": metrics, "params": [x.numpy() for x in leaves(gathered)],
            "specs": flat_specs, "own": own}


def run_cli(case, mesh):
    """The training CLI over this mesh's ranks: an uninterrupted run; a run
    crashed and resumed to its end; a run crashed twice (it is resumed on
    one rank by the test). Returns the final losses of the finished runs."""
    del mesh
    base = case["argv"]
    out = {"full": train_cli.main(base + ["--ckpt-dir", case["dirs"]["full"]])}
    for name, crashes in (("resumed", (case["crash"][0],)), ("elastic", case["crash"])):
        for at in crashes:
            try:
                train_cli.main(base + ["--ckpt-dir", case["dirs"][name], "--crash-at",
                                       str(at)])
                raise AssertionError(f"the run did not crash at {at}")
            except RuntimeError as e:
                if "injected crash" not in str(e):
                    raise
        if name == "resumed":
            out[name] = train_cli.main(base + ["--ckpt-dir", case["dirs"][name]])
    return out


RUNS = {"generate": run_generate, "train": run_train, "cli": run_cli}


def run_mesh(job, rank: int) -> dict:
    """Every case of one mesh, as rank ``rank`` of its process group."""
    meshlib.init_distributed("gloo", store_path=job["store"], rank=rank,
                             world_size=job["world"])
    try:
        mesh = meshlib.make_local_mesh(model=job["model"])
        results = {name: RUNS[case["kind"]](case, mesh) for name, case in job["cases"].items()}
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
