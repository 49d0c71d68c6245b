"""Recurrent restoration tasks, training half (the registrations of
``refid_tpu/tasks/recurrent.py``): blur-VFI and sharp-VFI.  Their
validation (deblur / interpolation metric split, tiling) comes with the
eval slice and raises until then."""

from __future__ import annotations

from refid_tpu_torch.core.registry import MODELS
from refid_tpu_torch.tasks.base import RestorationTaskBase

__all__ = ["TwoImageEventRecurrentRestorationTask",
           "TwoSharpImageEventRecurrentRestorationTask", "VALIDATION_NOT_PORTED"]

VALIDATION_NOT_PORTED = (
    "validation (PSNR / SSIM, tiling) is not ported yet: it comes with the "
    "port's eval slice (ROADMAP queue 1, item 9)")


class _RecurrentTaskBase(RestorationTaskBase):
    def validate(self, *args, **kwargs):
        raise NotImplementedError(VALIDATION_NOT_PORTED)


@MODELS.register("TwoImageEventRecurrentRestorationModel")
@MODELS.register("TestTwoImageEventRecurrentRestorationModel")
class TwoImageEventRecurrentRestorationTask(_RecurrentTaskBase):
    """Blur VFI: two blurred frames + events -> 2m+n sharp frames."""


@MODELS.register("TwoSharpImageEventRecurrentRestorationModel")
@MODELS.register("TestTwoSharpImageEventRecurrentRestorationModel")
class TwoSharpImageEventRecurrentRestorationTask(_RecurrentTaskBase):
    """Sharp VFI: two sharp frames + events -> n middle frames."""
