"""BS-ERGB sharp-VFI dataset (mirrors ``refid_tpu/data/datasets/bsergb.py``;
upstream ``image_sharp_npy_dataset.py``).

Splits are named ``3_TRAINING`` / ``2_VALIDATION`` / ``1_TEST``; frames
live in ``<split>/<video>/images`` (the trailing frame dropped: a video has
one more image than event windows), events in ``<split>/<video>/events``.
Without ``video_list`` every video of the split is read."""

import os

from refid_tpu_torch.core.registry import DATASETS
from refid_tpu_torch.data.datasets.base import RecurrentEventDataset, recursive_glob

__all__ = ["BsergbSharpEventRecurrentDataset"]


@DATASETS.register("BsergbSharpEventRecurrentDataset")
class BsergbSharpEventRecurrentDataset(RecurrentEventDataset):
    layout = "gopro"      # flat npz fields, no x/y swap
    kind = "sharp"
    bidir = False

    _SPLITS = {"train": "3_TRAINING", "val": "2_VALIDATION", "test": "1_TEST"}

    def __init__(self, opt, device="cuda"):
        # the phase's on-disk split, before the base indexes the videos
        self._bsergb_split = self._SPLITS.get(opt["phase"], "1_TEST")
        super().__init__(opt, device)

    def _video_list(self):
        videos = self.opt.get("video_list")
        if videos:
            return list(videos)
        return sorted(os.listdir(os.path.join(self.dataroot, self._bsergb_split)))

    def _index_video(self, video):
        n = self.n
        vdir = os.path.join(self.dataroot, self._bsergb_split, video)
        frames = sorted(recursive_glob(os.path.join(vdir, "images"), ".png"))
        if not frames:
            return
        frames = frames[:-1]
        event_frames = sorted(recursive_glob(os.path.join(vdir, "events"), ".npz"))
        set_len = n + 2
        n_sets = (len(frames) - set_len) // (n + 1) + 1
        for i in range(max(n_sets, 0)):
            group = [os.path.join(vdir, "images", f)
                     for f in frames[(n + 1) * i:(n + 1) * i + set_len]]
            evs = [os.path.join(vdir, "events", f)
                   for f in event_frames[(n + 1) * i:(n + 1) * i + set_len - 1]]
            self.lq_paths.append([group[0], group[-1]])
            self.gt_paths.append(group[1:-1])
            self.event_paths.append(evs)
