from ethzasl_brisk_tpu_torch.parallel.frames import FramePipeline

__all__ = ["FramePipeline"]
