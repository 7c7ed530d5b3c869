"""InputType: symbolic activation shapes for config-time inference
(counterpart of ``deeplearning4j_tpu/nn/conf/inputs.py``, same kinds
and the same JSON form). Convolutional types are NHWC, as in the JAX
package."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["InputType"]


@dataclasses.dataclass(frozen=True)
class InputType:
    kind: str                       # 'ff' | 'rnn' | 'cnn' | 'cnnflat' | 'cnn3d'
    size: Optional[int] = None      # ff/rnn feature size
    timesteps: Optional[int] = None
    height: Optional[int] = None
    width: Optional[int] = None
    channels: Optional[int] = None
    depth: Optional[int] = None     # cnn3d

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType("ff", size=int(size))

    @staticmethod
    def recurrent(size: int, timesteps: Optional[int] = None) -> "InputType":
        return InputType("rnn", size=int(size),
                         timesteps=None if timesteps is None else int(timesteps))

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType("cnn", height=int(height), width=int(width),
                         channels=int(channels))

    @staticmethod
    def convolutional_flat(height: int, width: int,
                           channels: int) -> "InputType":
        return InputType("cnnflat", height=int(height), width=int(width),
                         channels=int(channels))

    @staticmethod
    def convolutional3d(depth: int, height: int, width: int,
                        channels: int) -> "InputType":
        return InputType("cnn3d", depth=int(depth), height=int(height),
                         width=int(width), channels=int(channels))

    def flat_size(self) -> int:
        if self.kind in ("ff", "rnn"):
            return self.size
        if self.kind in ("cnn", "cnnflat"):
            return self.height * self.width * self.channels
        if self.kind == "cnn3d":
            return self.depth * self.height * self.width * self.channels
        raise ValueError(self.kind)

    def array_shape(self, batch: int = -1) -> Tuple[int, ...]:
        """Concrete array shape (batch leading; NHWC for conv; NTC for
        rnn)."""
        if self.kind == "ff":
            return (batch, self.size)
        if self.kind == "rnn":
            return (batch, self.timesteps or -1, self.size)
        if self.kind == "cnn":
            return (batch, self.height, self.width, self.channels)
        if self.kind == "cnnflat":
            return (batch, self.height * self.width * self.channels)
        if self.kind == "cnn3d":
            return (batch, self.depth, self.height, self.width,
                    self.channels)
        raise ValueError(self.kind)

    def to_dict(self) -> dict:
        d = {"kind": self.kind}
        for f in ("size", "timesteps", "height", "width", "channels",
                  "depth"):
            v = getattr(self, f)
            if v is not None:
                d[f] = v
        return d

    @staticmethod
    def from_dict(d: dict) -> "InputType":
        return InputType(**d)

    def __repr__(self):
        if self.kind == "ff":
            return f"InputType.ff({self.size})"
        if self.kind == "rnn":
            return f"InputType.rnn({self.size}, t={self.timesteps})"
        if self.kind == "cnn":
            return f"InputType.cnn({self.height}x{self.width}x{self.channels})"
        if self.kind == "cnnflat":
            return (f"InputType.cnnflat({self.height}x{self.width}"
                    f"x{self.channels})")
        return f"InputType({self.to_dict()})"
