"""Configuration and device helpers of the port."""
from ttsx_torch.core.config import (AcousticConfig, RefinerConfig, S4Config,
                                    TTSXConfig, VocoderConfig, from_dict,
                                    to_dict, tts_cfg, zoo_cfg)
from ttsx_torch.core.device import resolve_device, set_f32_numerics

__all__ = ["AcousticConfig", "RefinerConfig", "S4Config", "TTSXConfig",
           "VocoderConfig", "from_dict", "to_dict", "tts_cfg", "zoo_cfg",
           "resolve_device", "set_f32_numerics"]
