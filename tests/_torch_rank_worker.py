"""Rank processes for the port's multi-device tests, on the CPU over gloo.

``launch(world, scenarios, tmp_path, **args)`` starts ``world`` processes
of this file (one per rank, one thread each, through the port's
``launch_local``: a free localhost port) and waits for them under a
timeout; any rank that fails or outlives it fails
the call and the others are killed. Each rank joins the job
(``init_distributed(device="cpu")``), runs the named scenarios of
:data:`SCENARIOS` in order (several per spawn: a process start costs
seconds) and saves ``{scenario: result}`` to ``rank<r>.pt``, which
``launch`` returns per rank. A scenario is ``fn(args, out_dir) -> result``
with ``args`` the keyword arguments of ``launch`` (``torch.save``-able).
"""

from __future__ import annotations

import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240.0


def launch(world: int, scenarios, tmp_path, timeout: float = TIMEOUT, **args) -> list:
    """Run ``scenarios`` in ``world`` rank processes; returns each rank's
    ``{scenario: result}``."""
    import torch

    from stmgcn_tpu_torch.parallel.mesh import launch_local

    out = os.path.join(str(tmp_path), f"ranks-{time.monotonic_ns()}")
    os.makedirs(out)
    torch.save(args, os.path.join(out, "args.pt"))
    _, problem = launch_local([sys.executable, __file__, out, ",".join(scenarios)], world,
                              env={"OMP_NUM_THREADS": "1", "PYTHONPATH": _REPO},
                              log_dir=out, timeout=timeout)
    if problem is not None:
        logs = "".join(
            f"--- rank {r} ---\n" + open(os.path.join(out, f"rank{r}.log")).read()[-6000:]
            for r in range(world))
        raise AssertionError(f"{problem}:\n{logs}")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


# -- scenarios ---------------------------------------------------------------

def tiny_config(out_dir, dp=1, branch=1, **train):
    """The default preset shrunk for the CPU: a 3x3 city, one 8-wide LSTM
    layer, batch 4, one epoch; ``train`` fields override."""
    from stmgcn_tpu_torch.config import MeshConfig, preset

    cfg = preset("default")
    cfg.data.rows, cfg.data.n_timesteps = 3, 24 * 7 + 42  # train 29: a padded tail
    cfg.model.lstm_hidden_dim = cfg.model.gcn_hidden_dim = 8
    cfg.model.lstm_num_layers = 1
    cfg.train.batch_size, cfg.train.epochs, cfg.train.out_dir = 4, 1, str(out_dir)
    for k, v in train.items():
        setattr(cfg.train, k, v)
    cfg.mesh = MeshConfig(dp=dp, branch=branch)
    return cfg


def _state(trainer) -> dict:
    """The trainer's whole (mesh-free) parameters, gathered on a branch mesh."""
    from stmgcn_tpu_torch.models.params import from_jax_params

    params, _ = trainer.state_trees()
    return from_jax_params(params, trainer.model.m_graphs)


def train_tiny(args, out_dir):
    """``tiny_config`` at the args' mesh: history and final parameters."""
    from stmgcn_tpu_torch.experiment import build_trainer

    import torch

    cfg = tiny_config(out_dir, args.get("dp", 1), args.get("branch", 1),
                      **args.get("train", {}))
    t = build_trainer(cfg, device="cpu", verbose=False,
                      initial_state=args.get("tiny_initial_state", args.get("initial_state")))
    history = t.train()
    # the clip's global squared norm of the last step's gradients, against
    # the gathered whole gradient's
    grads = [p.grad for p in t.optimizer.params]
    norm_sq = float(t.optimizer.sync.norm_sq(grads)) if t.optimizer.sync else None
    whole = t.placement.state_gather(dict(zip(t._param_names, grads))) if t.mesh else {}
    return {"history": history, "state": _state(t), "path": t.train_path,
            "norm_sq": norm_sq,
            "norm_sq_whole": float(sum(torch.sum(g * g) for g in whole.values()))}


def composed(args, out_dir):
    """``composed_config(args["preset"])`` at the args' ``dp`` (the preset's
    by default) on this job's mesh, trained: its path, history and final
    parameters."""
    from stmgcn_tpu_torch.experiment import build_trainer
    from stmgcn_tpu_torch.parallel import composed_config

    cfg = composed_config(args["preset"])
    cfg.train.out_dir = out_dir
    cfg.mesh.dp = args.get("dp", cfg.mesh.dp)
    t = build_trainer(cfg, device="cpu", initial_state=args.get("initial_state"),
                      verbose=False)
    history = t.train()
    return {"history": history, "state": _state(t), "path": t.train_path}


def mesh_info(args, out_dir):
    """The mesh of ``args["mesh"]`` (dp, branch) on this job: shape, this
    rank's coordinates and its axis lines."""
    from stmgcn_tpu_torch.config import MeshConfig
    from stmgcn_tpu_torch.parallel import mesh_from_config

    mesh = mesh_from_config(MeshConfig(*args["mesh"]), device="cpu")
    return {"shape": mesh.shape, "coords": mesh.coords, "lines": mesh.lines,
            "rank": mesh.rank, "backend": mesh.backend}


def _problem(args):
    """A small model's seeded weights, supports and batch (numpy, from
    ``args["seed"]``), as ``tests/test_parallel.py``'s ``setup_problem``."""
    import numpy as np

    rng = np.random.default_rng(args.get("seed", 0))
    n, b, m, t = args.get("N", 9), args.get("B", 8), args.get("M", 3), 5
    sup = (rng.standard_normal((m, 3, n, n)) * 0.2).astype(np.float32)
    x = rng.standard_normal((b, t, n, 1)).astype(np.float32)
    y = (rng.standard_normal((b, n, 1)) * 0.1).astype(np.float32)
    return sup, x, y


def _model(args, placement=None):
    import torch

    from stmgcn_tpu_torch.models import STMGCN

    return STMGCN(m_graphs=args.get("M", 3), n_supports=3, seq_len=5, input_dim=1,
                  lstm_hidden_dim=8, lstm_num_layers=2, gcn_hidden_dim=8, device="cpu",
                  generator=torch.Generator().manual_seed(3), placement=placement)


def forward(args, out_dir):
    """This rank's slice of the model on its rows, the whole batch's output
    gathered over ``dp``; and with ``args["grads"]`` a loss's gradients,
    gathered mesh-free, under the real fusion and under a summing one."""
    import torch

    from stmgcn_tpu_torch.config import MeshConfig
    from stmgcn_tpu_torch.parallel import MeshPlacement, mesh_from_config
    from stmgcn_tpu_torch.parallel.collectives import BranchFusion
    from stmgcn_tpu_torch.utils import comm

    mesh = mesh_from_config(MeshConfig(*args["mesh"]), device="cpu")
    pl = MeshPlacement(mesh)
    sup, x, y = _problem(args)
    model = _model(args, pl)
    sup_l = torch.from_numpy(pl.put(sup, "supports"))
    x_l, y_l = torch.from_numpy(pl.put(x, "x")), torch.from_numpy(pl.put(y, "y"))
    out = {"pred": comm.all_gather(model(sup_l, x_l).detach(), "dp", mesh)}
    if not args.get("grads"):
        return out

    def grads():
        model.zero_grad()
        mask = torch.ones(x.shape[0])
        from stmgcn_tpu_torch.train.step import masked_loss

        masked_loss("mse", model(sup_l, x_l), y_l, mask, rows=pl.rows(x.shape[0])).backward()
        local = {k: p.grad.clone() for k, p in model.named_parameters()}
        local = {k: comm.all_reduce(g, "dp", mesh) for k, g in local.items()}
        return pl.state_gather(local)

    out["grads"] = grads()
    identity = BranchFusion.backward
    try:  # the summing backward a distributed-autograd all-reduce would give
        BranchFusion.backward = staticmethod(
            lambda ctx, g: (comm.all_reduce(g, "branch", mesh), None))
        out["grads_summing"] = grads()
    finally:
        BranchFusion.backward = identity
    return out


def _wire_meta(t, cfg) -> dict:
    """The wire models' inputs of trainer ``t``: the halo plan's extents
    (``banded_meta``) and the float32 parameter bytes."""
    from stmgcn_tpu_torch.analysis.spmd_check import param_bytes
    from stmgcn_tpu_torch.parallel import banded_meta

    return dict(banded_meta(t, cfg), param_bytes=param_bytes(t.model))


def step_report(args, out_dir):
    """One training step of ``tiny_config`` at the args' mesh under
    ``step_comm_report``, its manifest check, and the same step with an
    undeclared all-gather over ``dp`` added; the reports and the wire
    models' inputs."""
    from stmgcn_tpu_torch.experiment import build_trainer
    from stmgcn_tpu_torch.parallel import check_executed, manifest_for_config
    from stmgcn_tpu_torch.utils import comm, step_comm_report

    cfg = tiny_config(out_dir, args.get("dp", 1), args.get("branch", 1),
                      **args.get("train", {}))
    t = build_trainer(cfg, device="cpu", verbose=False)
    batch = next(iter(t.batches("train")))
    report = step_comm_report(t.train_batch, batch)
    manifest = manifest_for_config(cfg)

    def leaky(b):
        loss = t.train_batch(b)
        comm.all_gather(loss.reshape(1), "dp", t.mesh, what="leak")
        return loss

    leak = step_comm_report(leaky, batch)
    return {"report": {k: v for k, v in report.items() if k != "result"},
            "leak": {k: v for k, v in leak.items() if k != "result"},
            "meta": _wire_meta(t, cfg),
            "problems": check_executed(manifest, report),
            "leak_problems": check_executed(manifest, leak),
            "dp_only_problems": check_executed(
                manifest_for_config(tiny_config(out_dir, 2, 1)), report),
            "numel": sum(p.numel() for p in t.model.parameters()),
            "rows": t._rows, "nodes": t.dataset.n_nodes,
            "gcn": cfg.model.gcn_hidden_dim, "loss": float(report["result"])}


def _digest(trainer) -> str:
    import hashlib

    h = hashlib.sha256()
    for name, tensor in sorted(trainer.model.state_dict().items()):
        h.update(name.encode())
        h.update(tensor.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def restore(args, out_dir):
    """The lead trains ``tiny_config`` at dp=2 writing checkpoints into its
    own directory; a fresh trainer on every rank, the others pointed at an
    empty directory, resumes from the lead's file; then a corrupt lead
    file: what each rank raised."""
    import os

    from stmgcn_tpu_torch.experiment import build_trainer

    rank = int(os.environ["RANK"])
    lead_dir = os.path.join(out_dir, "lead")
    cfg = tiny_config(lead_dir, 2, 1)
    t = build_trainer(cfg, device="cpu", verbose=False)
    t.train()
    trained = _digest(t)
    mine = lead_dir if rank == 0 else os.path.join(out_dir, f"empty{rank}")
    fresh = build_trainer(tiny_config(mine, 2, 1, epochs=2), device="cpu", verbose=False)
    meta = fresh.restore_auto()
    out = {"trained": trained, "restored": _digest(fresh), "epoch": meta["epoch"],
           "global_step": fresh.global_step, "history": fresh.train()}
    if rank == 0:
        with open(os.path.join(lead_dir, "best.ckpt"), "r+b") as f:
            f.seek(40)
            f.write(b"\xff\xfe\xfd\xfc")
    try:
        fresh.restore(os.path.join(lead_dir, "best.ckpt"))
        out["corrupt"] = None
    except Exception as e:  # noqa: BLE001 — the test reads what each rank raised
        out["corrupt"] = f"{type(e).__name__}: {e}"
    return out


#: the preemption drill: the rank that receives SIGTERM, and the global step
#: after which it does
PREEMPT_RANK, PREEMPT_STEP = 4, 3


def _preempted(cfg, kill: bool) -> dict:
    """Train ``cfg``; with ``kill`` this process sends itself SIGTERM at the
    first safe point after global step ``PREEMPT_STEP``. Returns what
    ``train`` raised, the trainer's cursor and the wall-clock times of the
    signal and the raise."""
    import signal

    from stmgcn_tpu_torch.experiment import build_trainer
    from stmgcn_tpu_torch.resilience import Preempted

    t = build_trainer(cfg, device="cpu", verbose=False)
    out = {"sent": None, "raised": None}
    if kill:
        after = t._after_train_batch

        def signalled():
            if out["sent"] is None and t.global_step >= PREEMPT_STEP:
                out["sent"] = time.time()
                os.kill(os.getpid(), signal.SIGTERM)
            after()

        t._after_train_batch = signalled
    try:
        t.train()
    except Preempted as e:
        out["raised"] = f"Preempted: {e}"
    out["at"], out["global_step"], out["epoch"] = time.time(), t.global_step, t.epoch
    return out


def _read_back(path: str, out_dir: str) -> dict:
    """``path`` restored into a fresh single-device trainer: its cursor and
    whole parameters."""
    from stmgcn_tpu_torch.experiment import build_trainer

    fresh = build_trainer(tiny_config(out_dir, epochs=2, steps_per_superstep=1),
                          device="cpu", verbose=False)
    meta = fresh.restore(path)
    return {"global_step": fresh.global_step, "epoch": meta["epoch"],
            "mesh": meta.get("mesh"), "state": _state(fresh)}


def preempt(args, out_dir):
    """SIGTERM to rank ``PREEMPT_RANK`` (not the lead) of a dp=2 x branch=3
    job of ``tiny_config`` (two epochs, one step a block) after global step
    ``PREEMPT_STEP``: what each rank raised, where and when. The lead then
    runs the single-device twin preempted the same way and reads both
    emergency ``latest.ckpt`` files back on one device."""
    rank = int(os.environ["RANK"])
    cfg = tiny_config(os.path.join(out_dir, "mesh"), 2, 3, epochs=2, steps_per_superstep=1)
    out = _preempted(cfg, kill=rank == PREEMPT_RANK)
    if rank == 0:
        twin_dir = os.path.join(out_dir, "twin")
        out["twin"] = _preempted(tiny_config(twin_dir, epochs=2, steps_per_superstep=1),
                                 kill=True)
        out["mesh_ckpt"] = _read_back(os.path.join(out_dir, "mesh", "latest.ckpt"),
                                      os.path.join(out_dir, "read-mesh"))
        out["twin_ckpt"] = _read_back(os.path.join(twin_dir, "latest.ckpt"),
                                      os.path.join(out_dir, "read-twin"))
    return out


# -- the region axis ---------------------------------------------------------

def _region_mesh(args, key="region"):
    from stmgcn_tpu_torch.config import MeshConfig
    from stmgcn_tpu_torch.parallel import mesh_from_config

    return mesh_from_config(MeshConfig(region=args[key]), device="cpu")


def region_config(args, out_dir):
    """``args["cfg"]`` (an ``ExperimentConfig`` dict) with ``out_dir``."""
    from stmgcn_tpu_torch.config import ExperimentConfig

    cfg = ExperimentConfig.from_dict(args["cfg"])
    cfg.train.out_dir = str(out_dir)
    return cfg


def region_train(args, out_dir):
    """``args["cfg"]`` trained on this job's region mesh from
    ``args["region_initial_state"]``: history, final parameters, routing,
    the node padding, ``test()``'s metrics of the lead's ``best.ckpt`` and
    its path."""
    from stmgcn_tpu_torch.experiment import build_trainer

    t = build_trainer(region_config(args, out_dir), device="cpu", verbose=False,
                      initial_state=args.get("region_initial_state"))
    history = t.train()
    return {"history": history, "state": _state(t), "path": t.train_path,
            "modes": t.model.support_modes, "node_pads": t._node_pads,
            "layout": t.layout, "test": t.test(modes=("test",))["test"], "best": t.best_path}


def hetero_region_train(args, out_dir):
    """:func:`region_train` of ``args["hetero_cfg"]`` (a heterogeneous
    city set) from ``args["hetero_initial_state"]``."""
    return region_train({**args, "cfg": args["hetero_cfg"],
                         "region_initial_state": args.get("hetero_initial_state")}, out_dir)


def banded_region_train(args, out_dir):
    """:func:`region_train` of ``args["banded_cfg"]`` (a node-padded
    config whose grid branch routes to the halo plan) from
    ``args["banded_initial_state"]``."""
    return region_train({**args, "cfg": args["banded_cfg"],
                         "region_initial_state": args.get("banded_initial_state")}, out_dir)


def region_step(args, out_dir):
    """One training step of ``args["step_cfg"]`` on this job's region mesh
    under ``step_comm_report``: the report, its check against the config's
    manifest (banded as routed), the wire models' inputs, the parameter
    count and the routing."""
    from stmgcn_tpu_torch.config import ExperimentConfig
    from stmgcn_tpu_torch.experiment import build_trainer
    from stmgcn_tpu_torch.parallel import check_executed, manifest_for_config
    from stmgcn_tpu_torch.utils import step_comm_report

    cfg = ExperimentConfig.from_dict(args["step_cfg"])
    cfg.train.out_dir = str(out_dir)
    t = build_trainer(cfg, device="cpu", verbose=False)
    report = step_comm_report(t.train_batch, next(iter(t.batches("train"))))
    banded = "banded" in t.model.support_modes
    halos = [s.halo for s in t.supports if hasattr(s, "halo")] if banded else []
    return {"report": {k: v for k, v in report.items() if k != "result"},
            "problems": check_executed(manifest_for_config(cfg, banded=banded), report),
            "meta": _wire_meta(t, cfg),
            "numel": sum(p.numel() for p in t.model.parameters()),
            "modes": t.model.support_modes, "halos": halos, "nodes": t._nodes(0),
            "path": t.train_path}


def region_preempt(args, out_dir):
    """SIGTERM to rank ``PREEMPT_RANK`` (not the lead) of a region mesh
    training ``args["cfg"]`` for two epochs one step a block: what each
    rank raised, where; the lead reads its emergency file back."""
    rank = int(os.environ["RANK"])
    cfg = region_config(args, os.path.join(out_dir, "mesh"))
    cfg.train.epochs, cfg.train.steps_per_superstep = 2, 1
    out = _preempted(cfg, kill=rank == PREEMPT_RANK)
    if rank == 0:
        from stmgcn_tpu_torch.train.checkpoint import load_checkpoint

        meta = load_checkpoint(os.path.join(out_dir, "mesh", "latest.ckpt"),
                               load_opt_state=False)[0]
        out["ckpt"] = {"global_step": meta["global_step"], "mesh": meta.get("mesh")}
    return out


def halo_apply(args, out_dir):
    """``halo_exchange`` and ``sharded_banded_apply`` on this rank's shard
    of ``args["strips"]`` and node rows of ``args["x"]`` (region mesh
    ``args["region"]``): the exchanged block, the product, and the
    gradient of ``sum(product * args["cot"])`` w.r.t. the rank's rows."""
    import torch

    from stmgcn_tpu_torch.parallel import halo_exchange, sharded_banded_apply

    mesh = _region_mesh(args)
    j, halo = mesh.coords["region"], args["halo"]
    strips = torch.from_numpy(args["strips"])
    nl = strips.shape[2]
    x = torch.from_numpy(args["x"][:, j * nl:(j + 1) * nl]).requires_grad_()
    block = halo_exchange(x.detach().transpose(0, 1).contiguous(), halo, mesh)
    out = sharded_banded_apply(strips[j], x, halo, mesh)
    cot = torch.from_numpy(args["cot"][:, :, j * nl:(j + 1) * nl])
    (out * cot).sum().backward()
    return {"block": block, "out": out.detach(), "grad": x.grad}


def dense_region_conv(args, out_dir):
    """A ``ChebGraphConv`` of ``args["W"]``, ``args["b"]`` on this rank's
    row strip of ``args["sup"]`` (region mesh ``args["region"]``): its
    output rows, and the gradients of ``sum(out * args["cot"])`` w.r.t.
    the rank's signal rows and (this rank's share of) the parameters."""
    import torch

    from stmgcn_tpu_torch.ops.chebconv import ChebGraphConv

    mesh = _region_mesh(args)
    sup, x_all = args["sup"], args["x"]
    k, n = sup.shape[0], sup.shape[-1]
    nl = n // mesh.region
    rows = slice(mesh.coords["region"] * nl, (mesh.coords["region"] + 1) * nl)
    conv = ChebGraphConv(k, x_all.shape[-1], args["W"].shape[-1], device="cpu")
    conv.load_state_dict({"W": torch.from_numpy(args["W"]), "b": torch.from_numpy(args["b"])})
    conv.region_mesh = mesh
    x = torch.from_numpy(x_all[:, rows]).requires_grad_()
    out = conv(torch.from_numpy(sup[:, rows]), x)
    (out * torch.from_numpy(args["cot"][:, rows])).sum().backward()
    return {"out": out.detach(), "dx": x.grad, "dW": conv.W.grad, "db": conv.b.grad}


def mixed_model(args, out_dir):
    """A (banded, dense, dense) ``STMGCN`` of ``args["state"]`` over
    ``args["sup"]`` on this region mesh: its prediction rows for
    ``args["mixed_x"]``, and (this rank's share of) the gradients of
    ``sum(pred * args["mixed_cot"])``."""
    import numpy as np
    import torch

    from stmgcn_tpu_torch.models import STMGCN
    from stmgcn_tpu_torch.parallel import MeshPlacement, banded_decompose

    mesh = _region_mesh(args)
    pl = MeshPlacement(mesh)
    sup, x, cot = args["sup"], args["mixed_x"], args["mixed_cot"]
    model = STMGCN(m_graphs=sup.shape[0], n_supports=sup.shape[1], seq_len=x.shape[1],
                   input_dim=1, lstm_hidden_dim=8, lstm_num_layers=2, gcn_hidden_dim=8,
                   support_modes=("banded",) + ("dense",) * (sup.shape[0] - 1), device="cpu",
                   placement=pl)
    model.load_state_dict(args["state"])
    routed = (banded_decompose(sup[0], mesh.region),) + tuple(sup[1:])
    placed = tuple(s.to("cpu") if hasattr(s, "halo") else torch.from_numpy(np.ascontiguousarray(s))
                   for s in pl.put(routed, "supports"))
    pred = model(placed, torch.from_numpy(np.ascontiguousarray(pl.put(x, "x"))))
    (pred * torch.from_numpy(np.ascontiguousarray(pl.put(cot, "y")))).sum().backward()
    return {"pred": pred.detach(), "grads": {k: p.grad for k, p in model.named_parameters()},
            "modes": model.support_modes, "layout": model.loop_layout}


def grad_sync_order(args, out_dir):
    """C4: ``GradSync.reduce`` over a dp mesh of ``args["dp"]`` ranks, rank
    r holding partial ``perm[r]`` of ``args["partials"]`` (two gradient
    tensors), for every permutation in ``args["perms"]``: the reduced
    gradients, and the bucket's bytes."""
    import torch

    from stmgcn_tpu_torch.config import MeshConfig
    from stmgcn_tpu_torch.parallel import GradSync, mesh_from_config
    from stmgcn_tpu_torch.utils import comm, step_comm_report

    mesh = mesh_from_config(MeshConfig(dp=args["dp"]), device="cpu")
    parts = args["partials"]
    cut = parts.shape[1] // 2
    outs, report = [], None
    for perm in args["perms"]:
        mine = torch.from_numpy(parts[perm[mesh.rank]].copy())
        grads = [mine[:cut].clone(), mine[cut:].clone().reshape(-1, 1)]
        sync = GradSync(mesh, grads, [False, False])
        report = step_comm_report(sync.reduce, grads)
        outs.append(torch.cat([g.reshape(-1) for g in grads]))
    return {"outs": outs, "bytes": report["what"]["all-reduce/dp/grads"]["bytes"],
            "backend": mesh.backend, "collectives": list(comm.COLLECTIVES)}


# -- block-CSR strips and the region x branch composition -----------------------

def _mesh3(dp=1, region=1, branch=1):
    from stmgcn_tpu_torch.config import MeshConfig
    from stmgcn_tpu_torch.parallel import mesh_from_config

    return mesh_from_config(MeshConfig(dp=dp, region=region, branch=branch), device="cpu")


def sparse_apply(args, out_dir):
    """``sharded_spmm_apply`` on a dp=2 x region=4 mesh: this rank's strip
    of ``args["sp_mats"]`` against its batch and node rows of
    ``args["sp_x"]``; the product ``(K, b, n_local, F)`` and the gradient
    of ``sum(product * args["sp_cot"])`` w.r.t. the rank's rows."""
    import torch

    from stmgcn_tpu_torch.parallel import MeshPlacement, sharded_from_dense, sharded_spmm_apply

    mesh = _mesh3(dp=2, region=4)
    pl = MeshPlacement(mesh)
    mats, x_all = args["sp_mats"], args["sp_x"]
    strip = sharded_from_dense(mats, 4).shard(mesh.coords["region"])
    x = torch.from_numpy(pl.put(x_all, "y")).requires_grad_()  # (b, n_local, F)
    b, nl, f = x.shape
    out = sharded_spmm_apply(strip, x.transpose(0, 1).reshape(nl, b * f), mesh)
    out = out.reshape(-1, nl, b, f).transpose(1, 2)  # (K, b, n_local, F)
    cot = args["sp_cot"][:, pl.rows(x_all.shape[0])][:, :, pl.nodes(x_all.shape[1])]
    (out * torch.from_numpy(cot.copy())).sum().backward()
    return {"out": out.detach(), "grad": x.grad, "coords": mesh.coords}


def tiled_apply(args, out_dir):
    """``sharded_gathered_tiles_apply`` of this rank's shard of
    ``args["plan"]``'s branch 0 split over region=8: its output rows and
    the gradient of ``sum(out * args["tile_cot"])`` w.r.t. its signal
    rows (the permuted signal ``args["tile_x"]``)."""
    import torch

    from stmgcn_tpu_torch.ops.tiling import shard_tiled_plan, sharded_gathered_tiles_apply

    mesh = _mesh3(region=8)
    j = mesh.coords["region"]
    sharded = shard_tiled_plan(args["plan"][0], 8)
    mine = sharded.shard(j)
    rows = mine.block_rows_local * mine.tile
    x = torch.from_numpy(args["tile_x"][j * rows:(j + 1) * rows].copy()).requires_grad_()
    out = sharded_gathered_tiles_apply(mine, x, mesh)
    cot = torch.from_numpy(args["tile_cot"][:, j * rows:(j + 1) * rows].copy())
    (out * cot).sum().backward()
    return {"out": out.detach(), "grad": x.grad, "halo": sharded.halo,
            "halo_t": sharded.halo_t, "r_loc": sharded.block_rows_local}


def sparse_mesh_train(args, out_dir):
    """``args["sp_cfg"]`` (block-CSR supports, dp=2 x region=4) trained
    from ``args["sp_initial_state"]``: history, final parameters, routing,
    layout and the rank's strip form."""
    from stmgcn_tpu_torch.experiment import build_trainer

    cfg = region_config({"cfg": args["sp_cfg"]}, out_dir)
    t = build_trainer(cfg, device="cpu", verbose=False,
                      initial_state=args.get("sp_initial_state"))
    history = t.train()
    return {"history": history, "state": _state(t), "modes": t.model.branch_modes(),
            "layout": t.layout, "strip": type(t.supports).__name__,
            "branch_stacked": t.supports.branch_stacked}


def branch_parity(args, out_dir):
    """``tests/test_branch_banded.py``'s ``TestBranchStackedParity`` on a
    dp=2 x region=2 x branch=2 mesh, for each mode of ``args["bp_modes"]``:
    the model of ``args["bp_state"]`` over the branch-stacked strips of
    ``args["bp_dense"][mode]``, its forward (gathered to the whole batch)
    and three training steps' losses (Adam 1e-2, L2 1e-4)."""
    import numpy as np
    import torch

    from stmgcn_tpu_torch.models import STMGCN
    from stmgcn_tpu_torch.parallel import (GradSync, MeshPlacement, branch_stack,
                                           branch_stack_sparse, replica_sum)
    from stmgcn_tpu_torch.parallel.placement import sharded_names
    from stmgcn_tpu_torch.train.step import make_optimizer, train_step
    from stmgcn_tpu_torch.utils import comm

    mesh = _mesh3(dp=2, region=2, branch=2)
    pl = MeshPlacement(mesh)
    x, y = args["bp_x"], args["bp_y"]
    b, t, n, _ = x.shape
    out = {}
    for mode in args["bp_modes"]:
        dense = args["bp_dense"][mode]
        m, k = dense.shape[:2]
        model = STMGCN(m_graphs=m, n_supports=k, seq_len=t, input_dim=1, lstm_hidden_dim=8,
                       lstm_num_layers=2, gcn_hidden_dim=8, support_modes=(mode,) * m,
                       device="cpu", placement=pl, loop_layout=False)
        model.load_state_dict(pl.state_slice(args["bp_state"]))
        host = branch_stack(list(dense), 2) if mode == "banded" else branch_stack_sparse(dense, 2)
        sup = pl.put(host, "supports").to("cpu")
        x_l = torch.from_numpy(np.ascontiguousarray(pl.put(x, "x")))
        y_l = torch.from_numpy(np.ascontiguousarray(pl.put(y, "y")))
        with torch.no_grad():
            pred = model(sup, x_l)
        pred = comm.all_gather(pred.contiguous(), "region", mesh, dim=pred.dim() - 2)
        pred = comm.all_gather(pred, "dp", mesh)
        opt = make_optimizer(model.parameters(), 1e-2, 1e-4)
        names = [name for name, _ in model.named_parameters()]
        opt.sync = GradSync(mesh, opt.params, sharded_names(names, mesh.branch))
        mask = torch.ones(b, n)
        losses = []
        for _ in range(3):
            loss = train_step(model, opt, sup, x_l, y_l, mask, rows=pl.rows(b),
                              nodes=pl.nodes(n))
            losses.append(float(replica_sum(loss.reshape(1), mesh)[0]))
        out[mode] = {"pred": pred, "losses": losses, "modes": model.branch_modes(),
                     "stacked": host.branch_stacked,
                     "wh_0": model.branches.cg_lstm.lstm.wh_0.shape}
    return out


def branch_region_train(args, out_dir):
    """The composed ``bandedbranch`` on this dp=2 x region=2 x branch=2 job,
    for each route of ``args["br_routes"]``: ``"synthetic"`` (the preset's
    own graphs: ``auto`` falls back to dense), ``"banded"`` (banded city
    adjacencies: branch-stacked strips) and ``"sparse"`` (block-CSR strips,
    branch-stacked), each from ``args["br_initial_state"]``: routing,
    history, final parameters, the lead's ``best.ckpt`` and one step's
    collectives against the manifest."""
    from stmgcn_tpu_torch.experiment import build_trainer
    from stmgcn_tpu_torch.parallel import banded_dataset, check_executed, composed_config
    from stmgcn_tpu_torch.parallel import manifest_for_config
    from stmgcn_tpu_torch.utils import step_comm_report

    out = {}
    for route in args["br_routes"]:
        cfg = composed_config("bandedbranch")
        cfg.train.out_dir = os.path.join(out_dir, route)
        cfg.train.epochs = 1
        cfg.model.sparse = route == "sparse"
        data = None if route == "synthetic" else banded_dataset(cfg)
        t = build_trainer(cfg, device="cpu", verbose=False, dataset=data,
                          initial_state=args.get("br_initial_state"))
        report = step_comm_report(t.train_batch, next(iter(t.batches("train"))))
        t = build_trainer(cfg, device="cpu", verbose=False, dataset=data,
                          initial_state=args.get("br_initial_state"))
        history = t.train()
        banded = "banded" in t.model.branch_modes()
        out[route] = {"history": history, "state": _state(t), "modes": t.model.branch_modes(),
                      "branch_stacked": getattr(t.supports, "branch_stacked", None),
                      "layout": t.layout, "path": t.train_path, "best": t.best_path,
                      "coords": t.mesh.coords,
                      "report": {k: v for k, v in report.items() if k != "result"},
                      "problems": check_executed(manifest_for_config(cfg, banded=banded),
                                                 report)}
    return out


# -- the opt-in features on a mesh ----------------------------------------------

#: each opt-in feature run: ``guarded`` (fp32, blocks of 2, window-free
#: resident so that a mesh takes the twin's blocks): the divergence guard
#: (skip), health at every dispatch, the index sanitizers and a fault plan
#: that poisons step POISON_STEP and drops step DROP_STEP; ``rounded``
#: (bf16): stochastic rounding and debug_nans
FEATURE_RUNS = {
    "guarded": dict(steps_per_superstep=2, divergence_guard=True, checks="index"),
    "rounded": dict(precision="bf16", sr_seed=7),
}
POISON_STEP, DROP_STEP = 2, 5
#: the NaN drill: a NaN written into this node's normalized series at the
#: target of training sample NAN_SAMPLE (region=8 pads the 3x3 city to 16
#: rows, two a rank: node 5 lives on rank 2 alone)
NAN_NODE, NAN_SAMPLE = 5, 10


def feature_config(out_dir, mesh, run, **train):
    """``tiny_config`` on ``mesh`` (dp, region, branch) with the features
    of ``FEATURE_RUNS[run]`` (and ``train``), resident and window-free."""
    dp, region, branch = mesh
    cfg = tiny_config(out_dir, dp, branch, window_free=True, data_placement="resident",
                      **{**FEATURE_RUNS.get(run, {}), **train})
    cfg.mesh.region = region
    if run == "guarded":
        cfg.health.enabled, cfg.health.every_k = True, 1
    return cfg


def feature_run(mesh, out_dir, run, initial_state=None) -> dict:
    """One ``FEATURE_RUNS`` run of ``tiny_config`` on ``mesh`` (``(1, 1,
    1)``: the one-device twin): history, per-dispatch losses, health rows,
    the guard's trips, whether it wrote health records and (the lead) the
    lines of ``health.jsonl``, and the final whole parameters."""
    import numpy as np

    from stmgcn_tpu_torch.experiment import build_trainer
    from stmgcn_tpu_torch.resilience import FaultPlan, FaultSpec

    cfg = feature_config(out_dir, mesh, run)
    plan = (FaultPlan(FaultSpec("poison", epoch=1, step=POISON_STEP),
                      FaultSpec("drop", epoch=1, step=DROP_STEP)) if run == "guarded" else None)
    t = build_trainer(cfg, device="cpu", verbose=False, fault_plan=plan,
                      debug_nans=run == "rounded", initial_state=initial_state)
    rec = {"losses": [], "rows": [], "trips": []}
    dispatch, emit = t._dispatch, t._health_emit

    def recorded(*a, **k):
        losses, stats = dispatch(*a, **k)
        rec["losses"].append(list(losses))
        return losses, stats

    def emitted(stats, cities=None):
        rec["rows"].append(np.array(stats))
        emit(stats, cities)

    t._dispatch, t._health_emit = recorded, emitted
    if t._guard is not None:
        trip = t._guard.trip

        def tripped(loss, epoch, step):
            rec["trips"].append((epoch, step))
            trip(loss, epoch, step)

        t._guard.trip = tripped
    rec["history"] = t.train()
    path = t._health_out_path()
    rec["health_lines"] = (sum(1 for _ in open(path))
                           if t.is_lead and os.path.exists(path) else None)
    rec.update(state=_state(t), path=t.train_path, lead=t.is_lead,
               wrote=t._health_writer is not None)
    return rec


def nan_drill(mesh, out_dir, initial_state=None) -> dict:
    """``tiny_config`` on ``mesh`` with a NaN in node ``NAN_NODE``'s
    series, under ``checks="nan"`` and then ``debug_nans``: what each run
    raised, at which step and when."""
    from stmgcn_tpu_torch.experiment import build_dataset, build_trainer

    out = {}
    for kind in ("checks", "debug_nans"):
        cfg = feature_config(os.path.join(out_dir, kind), mesh, None,
                             checks="nan" if kind == "checks" else None)
        ds = build_dataset(cfg)
        ds.series(0)[int(ds.mode_targets("train")[NAN_SAMPLE]), NAN_NODE, 0] = float("nan")
        t = build_trainer(cfg, device="cpu", verbose=False, dataset=ds,
                          debug_nans=kind == "debug_nans", initial_state=initial_state)
        try:
            t.train()
            raised = None
        except (RuntimeError, FloatingPointError) as e:  # CheckError is a RuntimeError
            raised = f"{type(e).__name__}: {e}"
        out[kind] = {"raised": raised, "at": time.time(), "global_step": t.global_step}
    return out


def features(args, out_dir):
    """The ``FEATURE_RUNS`` on this job's mesh ``args["feat_mesh"]`` from
    ``args["feat_init"]``; the SR noise of the first step (the rank's
    stacked leaves) from the rounded trainer; with ``args["feat_nan"]``
    the NaN drill."""
    from stmgcn_tpu_torch.experiment import build_trainer
    from stmgcn_tpu_torch.train.step import sr_shadow

    mesh, init = args["feat_mesh"], args.get("feat_init")
    out = {run: feature_run(mesh, os.path.join(out_dir, run), run, init)
           for run in FEATURE_RUNS}
    t = build_trainer(feature_config(os.path.join(out_dir, "sr"), mesh, "rounded"),
                      device="cpu", verbose=False, initial_state=init)
    t._sr_gen.manual_seed(t._sr_seed(0))
    out["shadow"] = {k: v.detach() for k, v in sr_shadow(t.model, t._sr_gen).items()}
    out["branches"] = t._branches()
    if args.get("feat_nan"):
        out["nan"] = nan_drill(mesh, os.path.join(out_dir, "nan"), init)
    return out


def feature_step(args, out_dir):
    """One guarded step (``_train_one``: the guard's agreed flag, a health
    row, the ``nan`` sanitizers' agreed word) of ``feature_config`` at
    dp=2 x branch=3 under ``step_comm_report``: the report, its check
    against the config's manifest and against the plain config's, and the
    counts the bytes follow from."""
    from stmgcn_tpu_torch.experiment import build_trainer
    from stmgcn_tpu_torch.parallel import check_executed, manifest_for_config
    from stmgcn_tpu_torch.utils import step_comm_report

    cfg = feature_config(out_dir, (2, 1, 3), "guarded", checks="nan")
    t = build_trainer(cfg, device="cpu", verbose=False)
    report = step_comm_report(t._train_one, next(iter(t.batches("train"))))
    return {"report": {k: v for k, v in report.items() if k != "result"},
            "problems": check_executed(manifest_for_config(cfg), report),
            "plain_problems": check_executed(manifest_for_config(tiny_config(out_dir, 2, 3)),
                                             report),
            "numel": sum(p.numel() for p in t.model.parameters()),
            "members": sum(len(g) for _, g in t._health_groups),
            "fusion": (cfg.train.batch_size // 2) * t.dataset.n_nodes * cfg.model.gcn_hidden_dim
            * 4}


# -- C5: a failed checkpoint write on a mesh ------------------------------------

#: the write fault drill's own limit (seconds): a rank still in the scenario
#: then (a peer waiting in a collective the lead never reached) ends its
#: process, which fails the spawn at once instead of at ``TIMEOUT``
WRITE_FAULT_LIMIT = 60.0


def _watchdog(what: str, limit: float):
    """A daemon timer that ends this process (exit 3) after ``limit``
    seconds, naming ``what``; ``cancel()`` it when the work is done."""
    import threading

    def expire():
        print(f"rank {os.environ.get('RANK')}: {what} outlived its {limit:.0f} s "
              f"({_WATCHDOG_AT.get('case')}): a rank hangs", flush=True)
        os._exit(3)

    timer = threading.Timer(limit, expire)
    timer.daemon = True
    timer.start()
    return timer


_WATCHDOG_AT: dict = {}


def _files(out_dir: str) -> dict:
    """``{name: bytes}`` of the checkpoint files in ``out_dir``."""
    return {name: open(os.path.join(out_dir, name), "rb").read()
            for name in sorted(os.listdir(out_dir)) if name.endswith((".ckpt", ".prev"))}


def write_fault(args, out_dir):
    """C5 on this job's mesh ``args["wf_mesh"]`` (dp, branch): ``tiny_config``
    under the port's write drill (``resilience.faults``: ``latest.ckpt``
    every WRITE_DRILL_EVERY steps, the lead's first write torn), with
    synchronous and with asynchronous checkpoints: what each rank raised
    (``raised_record``) and at which global step. Then, with no fault and top-k snapshots on, each mode twice from
    ``args["wf_init"]``: as shipped, and with the write agreement
    (``Trainer._agree_write``) patched out, the trainer before C5's repair:
    the lead's files, the final parameters, the ``what`` tags of the
    collectives each run moved, and the collectives of one ``latest`` save
    (sync) or one flush (async) against the checkpoint manifest. Bounded by
    WRITE_FAULT_LIMIT."""
    import shutil

    from stmgcn_tpu_torch.experiment import build_trainer
    from stmgcn_tpu_torch.parallel import check_executed, manifest_for_config
    from stmgcn_tpu_torch.resilience.faults import (
        WRITE_DRILL_EVERY,
        raised_record,
        write_drill_plan,
    )
    from stmgcn_tpu_torch.train.trainer import Trainer
    from stmgcn_tpu_torch.utils import comm, step_comm_report

    dp, branch = args["wf_mesh"]
    watchdog = _watchdog("write_fault", WRITE_FAULT_LIMIT)
    out = {}
    try:
        for mode in ("sync", "async"):
            _WATCHDOG_AT["case"] = f"torn {mode}"
            cfg = tiny_config(os.path.join(out_dir, f"torn-{mode}"), dp, branch,
                              checkpoint_every_steps=WRITE_DRILL_EVERY,
                              async_checkpoint=mode == "async")
            t = build_trainer(cfg, device="cpu", verbose=False, fault_plan=write_drill_plan(),
                              initial_state=args.get("wf_init"))
            try:
                t.train()
                raised = None
            except Exception as e:  # noqa: BLE001 — the test reads what each rank raised
                raised = raised_record(e)
            out[f"torn-{mode}"] = {"raised": raised, "global_step": t.global_step,
                                   "at": time.time()}
            print(f"rank {os.environ['RANK']}: torn {mode}: {raised} at global step "
                  f"{t.global_step}", flush=True)
        agree = Trainer._agree_write
        for mode in ("sync", "async"):
            for form in ("agreed", "unagreed"):
                _WATCHDOG_AT["case"] = f"clean {mode} {form}"
                # one directory for both forms (the meta's best-k list holds
                # paths), emptied by the lead, which alone writes there
                run_dir = os.path.join(out_dir, f"clean-{mode}")
                if os.environ["RANK"] == "0":
                    shutil.rmtree(run_dir, ignore_errors=True)
                cfg = tiny_config(run_dir, dp, branch, epochs=2, top_k=2,
                                  checkpoint_every_steps=WRITE_DRILL_EVERY,
                                  async_checkpoint=mode == "async")
                if form == "unagreed":  # the lead's outcome raises on the lead alone
                    Trainer._agree_write = _unagreed
                try:
                    t = build_trainer(cfg, device="cpu", verbose=False,
                                      initial_state=args.get("wf_init"))
                    comm.STATS.reset()
                    history = t.train()
                    tags = comm.collective_stats()["what"]
                    # the agreement's point: each write (sync), each flush (async)
                    report = (step_comm_report(t._save, t.latest_path) if mode == "sync"
                              else step_comm_report(t.flush_checkpoints))
                finally:
                    Trainer._agree_write = agree
                manifest = manifest_for_config(cfg, program="checkpoint")
                out[f"clean-{mode}-{form}"] = {
                    "history": history, "state": _state(t),
                    "files": _files(run_dir) if t.is_lead else {},
                    "what": tags, "report": report["what"],
                    "problems": check_executed(manifest, report)}
    finally:
        watchdog.cancel()
    return out


def _unagreed(self, error) -> None:
    """``Trainer._agree_write`` before C5's repair: a failure raises where
    it happened, nothing moves."""
    if error is not None:
        raise error


def check_write_fault(results: list, mode: str) -> None:
    """C5's drill of :func:`write_fault` in ``mode`` on every rank of a
    spawn, held to ``resilience.faults.write_drill_problems``: the lead
    raised its own error and every other rank the same type and cause, at
    the lead's global step, under a message naming the lead."""
    from stmgcn_tpu_torch.resilience.faults import write_drill_problems

    runs = [res["write_fault"][f"torn-{mode}"] for res in results]
    assert write_drill_problems(runs, mode) == [], runs


def check_clean_writes(results: list, mode: str) -> None:
    """:func:`write_fault`'s runs with no fault in ``mode``: on every rank
    the run with the write agreement equals the run without it (the
    trainer before C5's repair) in its losses, final parameters and the
    lead's checkpoint bytes, and moved no other collective than the
    agreement's ``broadcast/world/checkpoint``: two calls of 9 bytes (an
    int64 length and the status byte) at each agreement point (beside a
    branch mesh's gather of a save), which keep to the checkpoint
    manifest."""
    import torch

    for rank, res in enumerate(results):
        agreed, before = (res["write_fault"][f"clean-{mode}-{form}"]
                          for form in ("agreed", "unagreed"))
        assert agreed["history"] == before["history"], rank
        for name, value in agreed["state"].items():
            assert torch.equal(value, before["state"][name]), (rank, name)
        assert agreed["files"].keys() == before["files"].keys(), rank
        assert all(agreed["files"][n] == before["files"][n] for n in agreed["files"]), rank
        if rank == 0:
            assert {"best.ckpt", "latest.ckpt"} <= set(agreed["files"])
        else:
            assert not agreed["files"]
        tag = "broadcast/world/checkpoint"
        changed = {k for k in set(agreed["what"]) | set(before["what"])
                   if agreed["what"].get(k) != before["what"].get(k)}
        assert changed == {tag} and tag not in before["what"], (rank, changed)
        new = {k: v for k, v in agreed["report"].items() if before["report"].get(k) != v}
        assert new == {tag: {"calls": 2, "bytes": 9}}, (rank, agreed["report"])
        assert agreed["problems"] == [], (rank, agreed["problems"])


def feature_twins(root, init, nan: bool = False) -> dict:
    """The one-device twins of :func:`features` (in the test's process)."""
    from stmgcn_tpu_torch.experiment import build_trainer
    from stmgcn_tpu_torch.train.step import sr_shadow

    root, mesh = str(root), (1, 1, 1)
    out = {run: feature_run(mesh, os.path.join(root, run), run, init) for run in FEATURE_RUNS}
    t = build_trainer(feature_config(os.path.join(root, "sr"), mesh, "rounded"),
                      device="cpu", verbose=False, initial_state=init)
    t._sr_gen.manual_seed(t._sr_seed(0))
    out["shadow"] = {k: v.detach() for k, v in sr_shadow(t.model, t._sr_gen).items()}
    if nan:
        out["nan"] = nan_drill(mesh, os.path.join(root, "nan"), init)
    out["init"] = init if init is not None else dict(t.model.state_dict())
    return out


def check_run(got: dict, twin: dict, loss_rtol: float, params: dict,
              init: dict | None = None) -> None:
    """A mesh rank's feature run against its twin: the path, every
    dispatch's losses (non-finite where the twin's are), the epoch
    history and the final whole parameters: elementwise at ``params``, or
    with ``init`` (the initial state; a bf16 run, whose sums in another
    order flip roundings that Adam's normalized step amplifies at
    near-zero gradients) each tensor's update normwise, ``|p - p_twin| <=
    params["rtol"] |p_twin - p_init|`` (``tests/test_torch_bf16_train.py``'s
    rule)."""
    import numpy as np

    assert got["path"] == twin["path"]
    assert [len(x) for x in got["losses"]] == [len(x) for x in twin["losses"]]
    np.testing.assert_allclose(np.concatenate(got["losses"]), np.concatenate(twin["losses"]),
                               rtol=loss_rtol, equal_nan=True)
    for mode in ("train", "validate"):
        np.testing.assert_allclose(got["history"][mode], twin["history"][mode], rtol=loss_rtol)
    for name, value in got["state"].items():
        want = twin["state"][name]
        if init is None:
            np.testing.assert_allclose(value.numpy(), want.numpy(), **params, err_msg=name)
        else:
            assert (value - want).norm() <= params["rtol"] * (want - init[name]).norm(), name


def check_health(got: dict, twin: dict, loss_rtol: float, norm_rtol: float) -> None:
    """A mesh rank's health rows against the twin's: the losses at
    ``loss_rtol``, the norms at ``norm_rtol``, the counts exactly; the lead
    alone wrote ``health.jsonl``, as many lines as the twin's."""
    import numpy as np

    from stmgcn_tpu_torch.train.step import HEALTH_COLUMNS

    assert len(got["rows"]) == len(twin["rows"]) > 0
    counts = [HEALTH_COLUMNS.index(c) for c in ("nonfinite_grads", "nonfinite_loss")]
    norms = [i for i in range(1, twin["rows"][0].shape[1]) if i not in counts]
    for a, b in zip(got["rows"], twin["rows"]):
        np.testing.assert_allclose(a[:, 0], b[:, 0], rtol=loss_rtol)
        np.testing.assert_allclose(a[:, norms], b[:, norms], rtol=norm_rtol)
        np.testing.assert_array_equal(a[:, counts], b[:, counts])
    assert got["wrote"] == got["lead"] and twin["wrote"]
    assert got["health_lines"] == (twin["health_lines"] if got["lead"] else None)


def main(out: str, names: str) -> None:
    import torch

    torch.set_num_threads(1)
    from stmgcn_tpu_torch.parallel import init_distributed

    init_distributed(device="cpu", init_method="env://", timeout=TIMEOUT)
    args = torch.load(os.path.join(out, "args.pt"), weights_only=False)
    rank = int(os.environ["RANK"])
    results = {}
    for name in names.split(","):
        results[name] = globals()[name](args, os.path.join(out, name))
    torch.save(results, os.path.join(out, f"rank{rank}.pt"))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
