"""Input types for shape inference (copy of
`deeplearning4j_tpu/nn/conf/input_type.py`; same JSON form).

Convolutional data layout is NHWC, as in the reference; RNN input is
[batch, time, features].
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

__all__ = ["InputType"]


@dataclass(frozen=True)
class InputType:
    kind: str  # "ff" | "rnn" | "cnn" | "cnn_flat" | "cnn1d"
    size: int = 0                      # ff: feature count; rnn: features per step
    timesteps: Optional[int] = None    # rnn/cnn1d: series length (None = variable)
    height: int = 0
    width: int = 0
    channels: int = 0

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType(kind="ff", size=int(size))

    @staticmethod
    def recurrent(size: int, timesteps: Optional[int] = None) -> "InputType":
        return InputType(kind="rnn", size=int(size),
                         timesteps=None if timesteps is None else int(timesteps))

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType(kind="cnn", height=int(height), width=int(width),
                         channels=int(channels))

    @staticmethod
    def convolutional_flat(height: int, width: int, channels: int) -> "InputType":
        return InputType(kind="cnn_flat", height=int(height), width=int(width),
                         channels=int(channels),
                         size=int(height) * int(width) * int(channels))

    @staticmethod
    def convolutional1d(size: int, timesteps: Optional[int] = None) -> "InputType":
        return InputType(kind="cnn1d", size=int(size),
                         timesteps=None if timesteps is None else int(timesteps))

    def flat_size(self) -> int:
        if self.kind == "ff":
            return self.size
        if self.kind in ("cnn", "cnn_flat"):
            return self.height * self.width * self.channels
        if self.kind in ("rnn", "cnn1d"):
            return self.size
        raise ValueError(f"no flat size for {self}")

    def to_dict(self):
        return {"kind": self.kind, "size": self.size, "timesteps": self.timesteps,
                "height": self.height, "width": self.width, "channels": self.channels}

    @staticmethod
    def from_dict(d) -> "InputType":
        return InputType(**d)
