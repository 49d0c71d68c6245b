"""Multi-rank jobs for the port's distribution tests: gloo ranks spawned on
the CPU, each running one function of this module.

The functions live here, not in a test file, because a spawned rank
imports the module that holds its function: this one imports torch and
the port only (no JAX), so a rank starts in about a second.  Inputs and
results travel as ``torch.save`` files in a work directory; rank 0 writes
the results, which every rank gathers first.
"""

from __future__ import annotations

import os
import socket
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, fn, world, store, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, *args, timeout: float = 300):
    """Run ``fn(rank, *args)`` in ``world`` spawned gloo ranks (a file
    store: no port to race for); raise the first rank's exception, or
    ``TimeoutError`` (the ranks killed)."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_entry, args=(fn, world, os.path.join(tmp, "store"), args),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"{fn.__name__} did not finish in {timeout} s")


def _gather(obj):
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


class _Replicated(torch.autograd.Function):
    """Identity on a tensor every rank holds alike; the gradient is the sum
    of the ranks' gradients, so each rank sees the whole gradient."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


class _Slots(torch.autograd.Function):
    """Every rank's ``y`` in slot ``rank`` of a stack all ranks hold; the
    gradient of a slot goes back to its rank."""

    @staticmethod
    def forward(ctx, y):
        out = y.new_zeros((dist.get_world_size(),) + y.shape)
        out[dist.get_rank()] = y
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return g[dist.get_rank()].clone()


def halo_job(rank, work):
    """halo_exchange over the world (even and uneven rows) against slices
    of one tensor, forward and backward, and a float64 gradcheck of the
    whole exchange."""
    from refid_tpu_torch.parallel.spatial import halo_exchange, row_split
    world = dist.get_world_size()
    res = {}
    g = torch.Generator().manual_seed(0)
    for rows, above, below in ((12, 2, 1), (9, 1, 2)):
        x = torch.randn(2, 3, rows, 5, generator=g, dtype=torch.float64)
        v = torch.randn(2, 3, rows + world * (above + below), 5, generator=g,
                        dtype=torch.float64)
        splits = row_split(rows, world) if rows % world == 0 else [(0, 3), (3, 5), (5, 7), (7, 9)]
        start, stop = splits[rank]
        local = x[..., start:stop, :].clone().requires_grad_(True)
        y = halo_exchange(local, above, below, None if world == 1 else dist.group.WORLD)
        offset = sum(b - a + above + below for a, b in splits[:rank])
        y.backward(v[..., offset:offset + y.shape[-2], :])
        res[(rows, above, below)] = {"x": x, "v": v, "ranks": _gather(
            (splits[rank], y.detach(), local.grad))}

    x = torch.randn(1, 2, 4 * world, 3, generator=g, dtype=torch.float64, requires_grad=True)

    def exchange(x):
        local = _Replicated.apply(x)[..., 4 * rank:4 * rank + 4, :]
        return _Slots.apply(halo_exchange(local, 1, 2, dist.group.WORLD))

    res["gradcheck"] = torch.autograd.gradcheck(exchange, (x,), eps=1e-6, atol=1e-8)
    if rank == 0:
        torch.save(res, os.path.join(work, "halo.pt"))


def _flagship(cfg_kw, state):
    from refid_tpu_torch.models.convert import load_state
    from refid_tpu_torch.models.refid import FinalBidirectionAttenfusion, RefidConfig
    net = FinalBidirectionAttenfusion(RefidConfig(**cfg_kw))
    load_state(net, state)
    return net


def _sharded_step(net, mesh, x, ev, gt, block):
    """The sharded forward (gathered) and the gradient of the mean
    Charbonnier loss (the Trainer's ``sharded_loss``), summed over the
    spatial group."""
    from refid_tpu_torch.parallel.spatial import SpatialPlan, spatial_scope
    from refid_tpu_torch.train.losses import charbonnier_loss
    from refid_tpu_torch.train.trainer import sharded_loss
    plan = SpatialPlan(mesh, x.shape[-2], block)
    net.zero_grad(set_to_none=True)
    with spatial_scope(plan):
        out = net(plan.shard(x), plan.shard(ev))
        sharded_loss(charbonnier_loss, out, plan.shard(gt), plan).backward()
    grads = {}
    for k, p in net.named_parameters():
        grad = p.grad if p.grad is not None else torch.zeros_like(p)
        if mesh.spatial_group is not None:
            dist.all_reduce(grad, group=mesh.spatial_group)
        grads[k] = grad
    return plan.gather(out.detach()), grads, (plan.exchanges, plan.reductions)


def spatial_job(rank, work):
    """The flagship on row shards: forward and gradients at S = 4 (H 32 and
    the uneven H 40, remat 'all' and 'stage_outputs'), at data 2 x spatial
    2, the mesh layouts, and ``BlurVFIPipeline(mesh=)``."""
    from refid_tpu_torch import BlurVFIPipeline, RefidConfig
    from refid_tpu_torch.parallel import make_mesh
    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    mesh4 = make_mesh(data=1, spatial=4)
    mesh22 = make_mesh(data=2, spatial=2)
    res = {"layout": _gather([(m.data, m.spatial, m.data_index, m.spatial_index)
                              for m in (mesh4, mesh22)])}
    block = 2 ** inp["cfg"]["num_encoders"]
    for name, mesh, h, remat in (("s4_h32", mesh4, 32, None), ("s4_h40", mesh4, 40, None),
                                 ("s4_h40_all", mesh4, 40, "all"),
                                 ("s4_h40_stage", mesh4, 40, "stage_outputs"),
                                 ("d2s2_h32", mesh22, 32, None)):
        kw = dict(inp["cfg"], remat=remat is not None, remat_policy=remat or "all")
        net = _flagship(kw, inp["state"])
        x, ev, gt = (inp[k][h] for k in ("x", "ev", "gt"))
        res[name] = _sharded_step(net, mesh, x, ev, gt, block)

    cfg = RefidConfig(**inp["pipe_cfg"])
    pipe = BlurVFIPipeline(inp["pipe_state"], cfg, m=2, n=1, mesh=mesh4, device="cpu")
    res["pipeline"] = pipe(*inp["request"])
    res["pipeline_plan"] = (pipe.last_plan.rows, pipe.last_plan.exchanges,
                            pipe.last_plan.exchange_bytes, pipe.last_plan.allreduce_bytes)
    if rank == 0:
        torch.save(res, os.path.join(work, "spatial.pt"))


def mesh_job(rank, work):
    """make_mesh's groups at 2 x 2 (a sum over each group), replicate from
    rank 0, and a Trainer step at data 2 with a parameter the loss never
    reaches."""
    from refid_tpu_torch.parallel import make_mesh, replicate
    from refid_tpu_torch.train.trainer import Trainer
    mesh = make_mesh(data=2, spatial=2)
    one = torch.tensor([float(rank)])
    sums = []
    for group in (mesh.spatial_group, mesh.data_group):
        t = one.clone()
        dist.all_reduce(t, group=group)
        sums.append(float(t))
    state = {"w": torch.full((3,), float(rank)), "nested": [torch.arange(4) * (rank + 1)]}
    replicate(state)
    res = {"mesh": (mesh.data, mesh.spatial, mesh.data_index, mesh.spatial_index, sums),
           "replicated": (state["w"].tolist(), state["nested"][0].tolist())}

    inp = torch.load(os.path.join(work, "dead.pt"), weights_only=False)
    model = DeadHead()
    model.load_state_dict(inp["state"])
    trainer = Trainer(model, mse, inp["train_opt"], 10, mesh=make_mesh(data=4, spatial=1))
    x, y = inp["x"][rank::4], inp["y"][rank::4]
    metrics = trainer.train_step(x, None, y)
    res["trained"] = ({k: v.clone() for k, v in model.state_dict().items()},
                      float(metrics["loss"]), float(metrics["grad_norm"]))
    res = _gather(res)
    if rank == 0:
        torch.save(res, os.path.join(work, "mesh.pt"))


def world_one_job(rank, work):
    """A world of one: ``replicate`` broadcasts and the Trainer all-reduces
    (counted), and its step on the batch is the plain step's."""
    from refid_tpu_torch.parallel import make_mesh, replicate
    from refid_tpu_torch.train.trainer import Trainer
    calls = {"broadcast": 0, "all_reduce": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    dist.broadcast = counted("broadcast", dist.broadcast)
    dist.all_reduce = counted("all_reduce", dist.all_reduce)
    inp = torch.load(os.path.join(work, "dead.pt"), weights_only=False)
    model = DeadHead()
    model.load_state_dict(inp["state"])
    trainer = Trainer(model, mse, inp["train_opt"], 10, mesh=make_mesh())
    replicate([model, trainer.optimizer.state_dict()["state"]])
    metrics = trainer.train_step(inp["x"], None, inp["y"])
    torch.save({"calls": calls, "reduces": trainer.mesh is not None,
                "trained": ({k: v.clone() for k, v in model.state_dict().items()},
                            float(metrics["loss"]), float(metrics["grad_norm"]))},
               os.path.join(work, "world_one.pt"))


class DeadHead(torch.nn.Module):
    """``model(x, voxel)`` with a parameter the loss never reaches."""

    def __init__(self):
        super().__init__()
        self.used = torch.nn.Linear(4, 2)
        self.dead = torch.nn.Linear(4, 2)

    def forward(self, x, voxel):
        return self.used(x)


def mse(pred, gt):
    return ((pred - gt) ** 2).mean()


def _registry_net(name, opt, state):
    from refid_tpu_torch.core.registry import ARCHS
    from refid_tpu_torch.models import archs  # noqa: F401 (registers the archs)
    from refid_tpu_torch.models.convert import load_state
    net = ARCHS.get(name)(opt)
    load_state(net, state)
    return net


def lineage_job(rank, work):
    """Every ablation lineage (and the DCN) on row shards: the forward
    (gathered) and the gradients of the mean Charbonnier loss, summed over
    the group, at S = 4; each case's net from the port's registry."""
    from refid_tpu_torch.parallel import make_mesh
    inp = torch.load(os.path.join(work, "lineages.pt"), weights_only=False)
    mesh = make_mesh(data=1, spatial=dist.get_world_size())
    res = {}
    for key, (name, opt, state) in inp["cases"].items():
        net = _registry_net(name, opt, state)
        x, ev, gt = inp["data"]
        res[key] = _sharded_step(net, mesh, x, ev, gt, net.row_block)
    if rank == 0:
        torch.save(res, os.path.join(work, "lineages_out.pt"))


def int8_job(rank, work):
    """int8 on row shards at S = 4: single int8 convs (dynamic and static),
    the toy blurry-VFI pipeline through ``BlurVFIPipeline(mesh=)`` in every
    mode ("static" calibrated on the shards), in float and in int8 True with
    mkldnn's convs on and off, and EVHINet's 25 sites in True and
    "static"."""
    from refid_tpu_torch import BlurVFIPipeline, RefidConfig
    from refid_tpu_torch.models.evhinet import EVHINet
    from refid_tpu_torch.parallel import make_mesh
    from refid_tpu_torch.parallel.spatial import SpatialPlan, spatial_scope
    from refid_tpu_torch.serve import quant
    from refid_tpu_torch.serve.quant import QuantState, calibration_stats
    inp = torch.load(os.path.join(work, "int8.pt"), weights_only=False)
    mesh = make_mesh(data=1, spatial=dist.get_world_size())
    res = {}
    for mode in (True, "scale0", "static"):
        pipe = BlurVFIPipeline(inp["state"], RefidConfig(**inp["cfg"]), m=2, n=1, int8=mode,
                               mesh=mesh, device="cpu")
        if mode == "static":
            pipe.calibrate(*inp["request"])
        out = pipe(*inp["request"])
        plan = pipe.last_plan
        res[mode] = (out, pipe.served.raw_amax, pipe.served.rms, plan.exchanges, plan.reductions)
    for mode, mkldnn in ((False, True), (False, False), (True, False)):
        with torch.backends.mkldnn.flags(enabled=mkldnn):
            pipe = BlurVFIPipeline(inp["state"], RefidConfig(**inp["cfg"]), m=2, n=1, int8=mode,
                                   mesh=mesh, device="cpu")
            res[("mkldnn", mkldnn, mode)] = pipe(*inp["request"])
    x, convs = inp["sites"]
    plan = SpatialPlan(mesh, x.shape[-2], 4)
    with torch.no_grad(), spatial_scope(plan):
        for key, (conv, scale) in convs.items():
            q = None if scale is None else QuantState("static", amax=[scale * 127.0])
            res[key] = plan.gather(quant.conv_int8(conv, plan.shard(x), conv.stride[0],
                                                   conv.padding[0], slope=0.1, q=q))
    net = EVHINet(wf=inp["wf"])
    net.load_state_dict(inp["evhinet_state"])
    x, ev = inp["evhinet_input"]
    plan = SpatialPlan(mesh, x.shape[-2], net.row_block)
    with torch.no_grad(), spatial_scope(plan):
        calib = QuantState("calib")
        net(plan.shard(x), plan.shard(ev), calib)
        amax, rms = calibration_stats(calib)
        for mode, q in (("evhinet_True", QuantState(True)),
                        ("evhinet_static", QuantState("static", amax=amax))):
            res[mode] = (plan.gather(net(plan.shard(x), plan.shard(ev), q)), amax, rms,
                         q.sites)
    if rank == 0:
        torch.save(res, os.path.join(work, "int8_out.pt"))


def single_task_job(rank, work):
    """EVHINet's task on row shards at S = 4: a whole prediction and a tiled
    one (``val.crop_size``), then one training step per ``pixel_opt`` through
    ``task.train_step`` (its reduced, clipped gradients); and the TV loss
    of a ``(b, t, c, h, w)`` stack on row shards (the Trainer's
    ``sharded_loss``), a rank's share and gradient."""
    from refid_tpu_torch.parallel import make_mesh
    from refid_tpu_torch.parallel.spatial import SpatialPlan, spatial_scope
    from refid_tpu_torch.tasks import build_task
    from refid_tpu_torch.train.losses import weighted_tv_loss
    from refid_tpu_torch.train.trainer import sharded_loss
    inp = torch.load(os.path.join(work, "single.pt"), weights_only=False)
    mesh = make_mesh(data=1, spatial=dist.get_world_size())
    res = {}
    for key, opt in inp["opts"].items():
        task = build_task(opt, "cpu", mesh)
        task.net.load_state_dict(inp["state"])
        lq, voxel, gt = inp["batch"]
        if key == "predict":
            res[key] = (task.predict(lq, voxel), task._predict_item(lq[0], voxel[0]).numpy())
            continue
        if key == "predict_short_tiles":
            try:
                task._predict_item(lq[0], voxel[0])
                res[key] = None
            except ValueError as e:
                res[key] = str(e)
            continue
        task.setup_train_state()
        metrics = task.train_step({"lq": lq, "voxel": voxel, "gt": gt})
        res[key] = ({k: p.grad.clone() for k, p in task.net.named_parameters()},
                    float(metrics["loss"]), float(metrics["grad_norm"]))
    pred, weight = inp["tv"]
    plan = SpatialPlan(mesh, pred.shape[-2], 2)
    local = plan.shard(pred).clone().requires_grad_(True)
    with spatial_scope(plan):
        share = sharded_loss(weighted_tv_loss, local, plan.shard(weight), plan)
        share.backward()
    res["tv_stack"] = _gather((float(share.detach()), local.grad))
    if rank == 0:
        torch.save(res, os.path.join(work, "single_out.pt"))
