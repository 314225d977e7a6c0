from ethzasl_brisk_tpu_torch.vo.frontend import (
    VoConfig,
    VoFrontend,
    normalize_exposure_u8,
)

__all__ = ["VoConfig", "VoFrontend", "normalize_exposure_u8"]
