"""The data axis of refid_tpu_torch (parallel/mesh.py, the sampler, the Trainer's
reduction and cli.train over several processes) against refid_tpu and the
single-process run: gloo ranks on the CPU.

The multi-process training runs are tests/test_multihost.py's for the port:
2 processes at batch 1 (``--num-processes``, and torchrun's environment at
data 1 x spatial 2) must end with the parameters of 1 process at batch 2,
within its tolerance (atol 5e-6, rtol 1e-5)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from refid_tpu.data.loader import EnlargedIndexSampler as JaxSampler
from refid_tpu_torch.cli import train as train_cli
from refid_tpu_torch.core.config import parse_options
from refid_tpu_torch.data.loader import EnlargedIndexSampler
from refid_tpu_torch.parallel.mesh import Mesh, init_distributed, mesh_layout
from refid_tpu_torch.tasks import build_task
from refid_tpu_torch.train.trainer import Trainer
from tests import torch_dist
from tests.synthetic_data import make_gopro_tree

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_OPT = {"optim_g": {"type": "AdamW", "lr": 2.0e-3, "weight_decay": 1.0e-4,
                         "betas": [0.9, 0.99]},
             "scheduler": {"type": "TrueCosineAnnealingLR", "T_max": 100, "eta_min": 1.0e-7},
             "warmup_iter": -1, "grad_clip_norm": 0.01}
DEAD = "encoders_backward.1.down.weight"     # the parameter the loss never reaches


@pytest.mark.parametrize("ratio,shards,seed", [(4, 2, 7), (3, 3, 1), (1, 4, 0)])
def test_sampler_shards_equal_jax_and_default_to_the_data_axis(ratio, shards, seed):
    for index in range(shards):
        want = JaxSampler(5, ratio, shuffle=True, num_shards=shards, shard_index=index,
                          seed=seed).epoch_indices(2)
        got = EnlargedIndexSampler(5, ratio, shuffle=True, num_shards=shards,
                                   shard_index=index, seed=seed).epoch_indices(2)
        np.testing.assert_array_equal(got, want)
        for spatial in (1, 2):       # every rank of data group `index` draws its shard
            for s in range(spatial):
                mesh = Mesh(data=shards, spatial=spatial, data_index=index, spatial_index=s)
                np.testing.assert_array_equal(
                    EnlargedIndexSampler(5, ratio, seed=seed, mesh=mesh).epoch_indices(2), want)


@pytest.mark.parametrize("world,data,spatial,want", [
    (4, -1, 2, (2, 2, [[0, 1], [2, 3]], [[0, 2], [1, 3]])),
    (4, 1, 4, (1, 4, [[0, 1, 2, 3]], [[0], [1], [2], [3]])),
    (6, 3, 2, (3, 2, [[0, 1], [2, 3], [4, 5]], [[0, 2, 4], [1, 3, 5]])),
    (1, -1, 1, (1, 1, [[0]], [[0]]))])
def test_mesh_layout_puts_spatial_neighbours_together(world, data, spatial, want):
    assert mesh_layout(world, data, spatial) == want


@pytest.mark.parametrize("world,data,spatial", [(4, 3, 1), (4, -1, 3), (2, 2, 2), (4, 1, 0)])
def test_mesh_layout_raises_on_a_world_it_does_not_fill(world, data, spatial):
    with pytest.raises(ValueError):
        mesh_layout(world, data, spatial)


def test_init_distributed_does_nothing_for_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    init_distributed(None, 1, 0)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        init_distributed(None, 2, None)


def test_make_mesh_replicate_and_a_step_with_a_dead_parameter(tmp_path):
    """make_mesh at 2 x 2 (each group summed), replicate from rank 0, and one
    Trainer step at data 4 with a parameter the loss never reaches: the
    single-process step on the global batch, the dead weight decayed."""
    torch.manual_seed(0)
    model = torch_dist.DeadHead()
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(8, 4).astype(np.float32))
    y = torch.from_numpy(rng.randn(8, 2).astype(np.float32))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    torch.save({"state": state, "train_opt": TRAIN_OPT, "x": x, "y": y}, tmp_path / "dead.pt")
    torch_dist.run_ranks(torch_dist.mesh_job, 4, str(tmp_path))
    ranks = torch.load(tmp_path / "mesh.pt", weights_only=False)

    assert [r["mesh"][:4] for r in ranks] == [(2, 2, k // 2, k % 2) for k in range(4)]
    # spatial groups {0,1} {2,3}; data groups {0,2} {1,3}
    assert [r["mesh"][4] for r in ranks] == [[1.0, 2.0], [1.0, 4.0], [5.0, 2.0], [5.0, 4.0]]
    assert all(r["replicated"] == ([0.0] * 3, [0, 1, 2, 3]) for r in ranks)

    trainer = Trainer(model, torch_dist.mse, TRAIN_OPT, 10)
    metrics = trainer.train_step(x, None, y)
    for params, loss, norm in (r["trained"] for r in ranks):
        for k, v in model.state_dict().items():
            torch.testing.assert_close(params[k], v, atol=5e-6, rtol=1e-5)
        assert loss == pytest.approx(float(metrics["loss"]), rel=1e-6)
        assert norm == pytest.approx(float(metrics["grad_norm"]), rel=1e-5)
    assert not torch.equal(model.dead.weight, state["dead.weight"])   # decayed


def test_a_world_of_one_runs_the_collectives(tmp_path):
    """With a process group of one rank, replicate broadcasts and the
    Trainer all-reduces its gradients and loss (one collective each a
    dtype, as at any world size); the step is bit-equal to the plain one."""
    torch.manual_seed(0)
    model = torch_dist.DeadHead()
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(4, 4).astype(np.float32))
    y = torch.from_numpy(rng.randn(4, 2).astype(np.float32))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    torch.save({"state": state, "train_opt": TRAIN_OPT, "x": x, "y": y}, tmp_path / "dead.pt")
    torch_dist.run_ranks(torch_dist.world_one_job, 1, str(tmp_path))
    res = torch.load(tmp_path / "world_one.pt", weights_only=False)
    assert res["reduces"] and res["calls"] == {"broadcast": 1, "all_reduce": 1}

    trainer = Trainer(model, torch_dist.mse, TRAIN_OPT, 10)
    assert trainer.mesh is None
    metrics = trainer.train_step(x, None, y)
    params, loss, norm = res["trained"]
    for k, v in model.state_dict().items():
        assert torch.equal(params[k], v)
    assert (loss, norm) == (float(metrics["loss"]), float(metrics["grad_norm"]))


# --- cli.train over several processes ----------------------------------------

def _write_cfg(tmp_path, root, name, batch, spatial=1):
    """tests/test_multihost.py's toy recipe (augmentation off, so items do
    not depend on the process topology)."""
    cfg = {
        "name": name, "model_type": "TwoImageEventRecurrentRestorationModel",
        "scale": 1, "num_gpu": 1, "manual_seed": 10,
        "mesh": {"spatial": spatial},
        "datasets": {"train": {
            "name": "synth-train", "type": "GoProEventRecurrentDataset", "dataroot": root,
            "num_end_interpolation": 2, "num_inter_interpolation": 1, "norm_voxel": True,
            "one_voxel_flag": True, "return_deblur_voxel": True,
            "io_backend": {"type": "disk"}, "gt_size": None, "use_hflip": False,
            "use_rot": False, "use_shuffle": True, "num_worker_per_gpu": 1,
            "batch_size_per_gpu": batch, "dataset_enlarge_ratio": 4,
            "video_list": ["VID_A", "VID_B"]}},
        "network_g": {"type": "FinalBidirectionAttenfusion", "img_chn": 8, "ev_chn": 2,
                      "num_encoders": 2, "base_num_channels": 4, "num_block": 1,
                      "num_residual_blocks": 1},
        "path": {"pretrain_network_g": None, "strict_load_g": True, "resume_state": None},
        "train": dict(TRAIN_OPT, total_iter=4, pixel_opt={
            "type": "CharbonnierLoss", "loss_weight": 1.0, "reduction": "mean"}),
        "logger": {"print_freq": 1, "save_checkpoint_freq": 0, "use_tb_logger": False},
    }
    path = tmp_path / f"{name}.yml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


_DRIVER = """
import sys, torch
torch.set_num_threads(1)
from refid_tpu_torch.cli.train import main
task = main(sys.argv[2:])
if torch.distributed.get_rank() == 0:
    torch.save({k: v.detach() for k, v in task.net.state_dict().items()}, sys.argv[1])
torch.distributed.destroy_process_group()
"""


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gopro"))
    make_gopro_tree(root, m=2, n=1, videos=("VID_A", "VID_B"))
    return root


@pytest.fixture(scope="module")
def one_process(data_root, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("one")
    opt = parse_options(_write_cfg(tmp, data_root, "one", 2), is_train=True, root=str(tmp))
    task = train_cli.train(opt, "cpu")
    fresh = build_task(opt, "cpu")
    fresh.init_params(opt["manual_seed"])
    return ({k: v.detach().clone() for k, v in task.net.state_dict().items()},
            fresh.net.state_dict()[DEAD])


@pytest.mark.parametrize("launch,spatial", [("flags", 1), ("torchrun", 2)])
def test_two_process_training_matches_one_process(data_root, one_process, tmp_path,
                                                  launch, spatial):
    """Data 2 launched with --coordinator / --num-processes / --process-id,
    and data 1 x spatial 2 launched with torchrun's environment."""
    cfg = _write_cfg(tmp_path, data_root, f"two_{launch}", 1, spatial)
    out = str(tmp_path / "params.pt")
    port = torch_dist.free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
                   OMP_NUM_THREADS="1")
        args = [sys.executable, "-c", _DRIVER, out, "-opt", cfg, "--root", str(tmp_path),
                "--device", "cpu"]
        if launch == "flags":
            args += ["--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
                     "--process-id", str(rank)]
        else:
            env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(args, env=env, cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log.decode(errors="replace")[-4000:]
    got = torch.load(out, weights_only=True)
    want, dead_init = one_process
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=5e-6, rtol=1e-5, msg=k)
    assert not torch.equal(got[DEAD], dead_init)      # zero gradient, weight decay only
