from .fused import Halos, exchange_halos, fused_wave_step  # noqa: F401
from .ops import wave_step  # noqa: F401
