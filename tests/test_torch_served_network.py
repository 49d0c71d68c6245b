"""The one inference call of every network (``serve/network.py``): which
calls serve channels_last and which run int8, for the VFI pipelines and for
every network through a task (CPU, f32, toy shapes)."""

import numpy as np
import pytest
import torch

from refid_tpu_torch import BlurVFIPipeline, RefidConfig
from refid_tpu_torch.models import FinalBidirectionAttenfusion
from refid_tpu_torch.parallel.mesh import Mesh
from refid_tpu_torch.serve.network import ServedNetwork
from refid_tpu_torch.tasks import build_task

torch.set_num_threads(1)

M, N = 2, 1
TOY = dict(img_chn=8, num_encoders=2, base_num_channels=8, num_residual_blocks=1)
NETS = {
    "refid": ("TestTwoImageEventRecurrentRestorationModel",
              {"type": "FinalBidirectionAttenfusion", "ev_chn": 2, **TOY}),
    "evhinet": ("TestImageEventRestorationModel",
                {"type": "SingleMultiConnectEVHINet", "in_chn": 3, "ev_chn": 6, "wf": 8,
                 "depth": 3}),
    "efnet": ("TestImageEventRestorationModel",
              {"type": "EFNet", "in_chn": 3, "ev_chn": 6, "wf": 16, "depth": 3,
               "num_heads": [1, 2, 4], "ffn_expansion_factor": 4,
               "fuse_before_downsample": True, "relu_slope": 0.2}),
    "restormer": ("TestImageEventRestorationModel",
                  {"type": "Restormer", "inp_channels": 9, "dim": 8, "num_blocks": [1, 1, 1, 1],
                   "num_refinement_blocks": 1}),
    "uformer": ("TestImageEventRestorationModel",
                {"type": "Uformer", "dd_in": 9, "embed_dim": 8, "win_size": 2,
                 "depths": [1, 1, 1, 1, 2, 1, 1, 1, 1], "num_heads": [1] * 9}),
}
CL = torch.channels_last


def _vfi(int8=False, mesh=None):
    """A toy blur pipeline's network and one request to it (None on a
    spatial mesh, which needs a process group to call)."""
    rng = np.random.RandomState(1)
    h, w, n = 16, 24, 600
    request = (rng.rand(h, w, 3).astype(np.float32), rng.rand(h, w, 3).astype(np.float32),
               np.stack([np.sort(rng.rand(n)), rng.randint(0, w, n), rng.randint(0, h, n),
                         rng.choice([-1., 1.], n)], 1).astype(np.float32))
    torch.manual_seed(3)
    model = FinalBidirectionAttenfusion(RefidConfig(**TOY))
    pipe = BlurVFIPipeline(model, model.cfg, m=M, n=N, int8=int8, mesh=mesh, device="cpu")
    if int8 == "static":
        pipe.calibrate(*request)
    return pipe.served, None if mesh else (lambda: pipe(*request))


def _task(net, int8=False, h=16, w=24):
    """A task's network and one prediction of an ``h`` x ``w`` frame."""
    model_type, net_opt = NETS[net]
    task = build_task({"name": "t", "model_type": model_type, "is_train": False,
                       "network_g": dict(net_opt), "val": {"int8": int8} if int8 else {}},
                      "cpu")
    rng = np.random.RandomState(2)
    if net == "refid":
        lq, vox = rng.rand(1, h, w, TOY["img_chn"]), rng.randn(1, 2 * M + N, h, w, 2)
    else:
        lq, vox = rng.rand(1, h, w, 3), rng.randn(1, h, w, 6)
    return task.served, lambda: task.predict_tensor(lq.astype(np.float32),
                                                    vox.astype(np.float32))


CASES = {
    "vfi-float-unsplit": (lambda: _vfi(), True, False),
    "vfi-int8-dynamic": (lambda: _vfi(True), False, True),
    "vfi-int8-scale0": (lambda: _vfi("scale0"), False, True),
    "vfi-int8-static": (lambda: _vfi("static"), False, True),
    "vfi-spatial-mesh": (lambda: _vfi(mesh=Mesh(1, 2, 0, 0)), False, False),
    "task-refid": (lambda: _task("refid"), False, False),
    "task-evhinet": (lambda: _task("evhinet"), False, False),
    "task-efnet": (lambda: _task("efnet"), False, False),
    "task-restormer": (lambda: _task("restormer"), False, False),
    "task-uformer": (lambda: _task("uformer"), False, False),
    "task-int8-whole-blocks": (lambda: _task("refid", True), False, True),
    "task-int8-other-sides": (lambda: _task("refid", True, 12, 20), False, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_the_call_decides_format_and_int8(case):
    """The network's weights and each call's input are channels_last exactly
    where the call is float, unsplit and packed NHWC; a call runs int8 in
    the pipelines' int8 modes and in a task's only on whole ``int8_side``
    blocks."""
    build, channels_last, int8 = CASES[case]
    served, call = build()
    assert isinstance(served, ServedNetwork) and served.channels_last == channels_last
    fmt = CL if channels_last else torch.contiguous_format
    weights = [p for p in served.net.parameters() if p.dim() == 4]
    assert weights and all(p.is_contiguous(memory_format=fmt) for p in weights)
    if call is None:
        return
    seen = []
    handle = served.net.register_forward_pre_hook(
        lambda module, args: seen.append((args[0].is_contiguous(memory_format=CL),
                                          args[0].is_contiguous(), args[2] is not None)))
    try:
        call()
    finally:
        handle.remove()
    assert seen == [(channels_last, not channels_last, int8)]
