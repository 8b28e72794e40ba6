from repro_torch.kernels.roi_gather.ops import roi_gather, roi_gather_ref

__all__ = ["roi_gather", "roi_gather_ref"]
