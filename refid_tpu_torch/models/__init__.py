from refid_tpu_torch.models.refid import FinalBidirectionAttenfusion, RefidConfig

__all__ = ["FinalBidirectionAttenfusion", "RefidConfig"]
