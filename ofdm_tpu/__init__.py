"""ofdm_tpu — a batched OFDM transceiver framework in JAX for NVIDIA GPUs.

A from-scratch rebuild of the capabilities of the reference Rust ``ofdm``
crate (jkelleyrtp/ofdm), designed for accelerators rather than ported:
batched tensor pipelines, matmul DFTs, fused demodulation, and mesh-sharded
scaling.

Public API mirrors the reference's three entry points
(``encode!``/``channel!``/``decode!``) plus the batched production paths.
"""

from .config import DEFAULT_CONFIG, FrameConfig
from .obs.analysis import Analysis
from .phy.channel import channel
from .phy.modulation import Modulation
from .phy.rx import (DecodeError, decode, decode_aligned, decode_frame,
                     decode_frame_planar, planar_input_format,
                     planar_stream_format, sync_offset)
from .phy.streaming import decode_burst, decode_continuous, decode_regular
from .phy.tx import (encode, encode_hamming, encode_payload, frame_len,
                     n_data_blocks)

__version__ = "0.1.0"

__all__ = [
    "Analysis",
    "DEFAULT_CONFIG",
    "DecodeError",
    "FrameConfig",
    "Modulation",
    "channel",
    "decode",
    "decode_aligned",
    "decode_burst",
    "decode_continuous",
    "decode_frame",
    "decode_frame_planar",
    "planar_input_format",
    "planar_stream_format",
    "decode_regular",
    "encode",
    "encode_hamming",
    "encode_payload",
    "frame_len",
    "n_data_blocks",
    "sync_offset",
]
