from ethzasl_brisk_tpu_torch.ba.se3 import (
    se3_exp,
    se3_log,
    so3_exp,
    so3_log,
)
from ethzasl_brisk_tpu_torch.ba.window import (
    BaProblem,
    robust_cost,
    solve_window_ba,
    solve_window_ba_lm,
    solve_window_ba_trimmed,
)

__all__ = [
    "BaProblem",
    "robust_cost",
    "se3_exp",
    "se3_log",
    "so3_exp",
    "so3_log",
    "solve_window_ba",
    "solve_window_ba_lm",
    "solve_window_ba_trimmed",
]
