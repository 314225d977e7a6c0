from ethzasl_brisk_tpu_torch.parallel.frames import AstFramePipeline, FramePipeline

__all__ = ["AstFramePipeline", "FramePipeline"]
