from ethzasl_brisk_tpu_torch.parallel.frames import (
    AstFramePipeline,
    FramePipeline,
    init_process_group,
    make_mesh,
    sharded_knn_match,
)

__all__ = ["AstFramePipeline", "FramePipeline", "init_process_group", "make_mesh",
           "sharded_knn_match"]
