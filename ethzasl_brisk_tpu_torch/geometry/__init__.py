from ethzasl_brisk_tpu_torch.geometry.cameras import (
    EquidistantDistortion,
    NoDistortion,
    PinholeCamera,
    RadialTangentialDistortion,
)

__all__ = [
    "EquidistantDistortion",
    "NoDistortion",
    "PinholeCamera",
    "RadialTangentialDistortion",
]
