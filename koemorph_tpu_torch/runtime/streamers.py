"""Blendshape output: JSON over UDP, OSC 1.0, or a JSONL file.

- udp: JSON ``{"timestamp": t, "blendshapes": [52 floats]}``
- osc: one message at ``osc_address`` carrying 52 float32 arguments
- file: one JSON object per line, the udp schema
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Optional

import numpy as np

__all__ = ["BlendshapeStreamer", "encode_osc_message"]


def _osc_pad(b: bytes) -> bytes:
    """Zero-pad to a 4-byte boundary (OSC strings are 32-bit aligned)."""
    return b + b"\x00" * (4 - len(b) % 4 if len(b) % 4 else 4)


def encode_osc_message(address: str, values: list[float]) -> bytes:
    """Minimal OSC 1.0 message: address, float32 typetags, big-endian args."""
    out = _osc_pad(address.encode("utf-8"))
    out += _osc_pad(("," + "f" * len(values)).encode("ascii"))
    for v in values:
        out += struct.pack(">f", float(v))
    return out


class BlendshapeStreamer:
    """Streams 52-coefficient frames via UDP / OSC / JSONL file."""

    def __init__(self, output_mode: str = "udp", host: str = "127.0.0.1",
                 port: int = 9001, osc_address: str = "/blendshapes",
                 output_file: Optional[str] = None):
        self.output_mode = output_mode
        self.host = host
        self.port = port
        self.osc_address = osc_address
        self.frames_sent = 0
        if output_mode in ("udp", "osc"):
            self.socket = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        elif output_mode == "file":
            if not output_file:
                raise ValueError("output_file required for file mode")
            self.file_handle = open(output_file, "w")
        else:
            raise ValueError(f"Unknown output mode: {output_mode}")

    def send(self, blendshapes: np.ndarray, timestamp: float) -> None:
        values = np.asarray(blendshapes, np.float32).reshape(-1).tolist()
        if self.output_mode == "osc":
            self.socket.sendto(encode_osc_message(self.osc_address, values),
                               (self.host, self.port))
        else:
            payload = json.dumps({"timestamp": timestamp,
                                  "blendshapes": values})
            if self.output_mode == "udp":
                self.socket.sendto(payload.encode("utf-8"),
                                   (self.host, self.port))
            else:
                self.file_handle.write(payload + "\n")
                self.file_handle.flush()
        self.frames_sent += 1

    def close(self) -> None:
        if hasattr(self, "socket"):
            self.socket.close()
        if hasattr(self, "file_handle"):
            self.file_handle.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
