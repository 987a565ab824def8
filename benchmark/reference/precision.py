"""The products of the references, in the precision a run asks for.

``fp32`` is the reference itself: float32 products with TF32 off (on the
card a float32 product may otherwise run in TF32). ``fp8`` is the control
of a bfloat16 configuration, the next precision below it, held where the
configuration holds bfloat16: every product's operands and result, and the
values the layers hand on (the normalised states, the activations, the
attention probabilities: ``act``), rounded to float8 e4m3 with one scale a
tensor (its largest magnitude at e4m3's largest, 448). The sums, the norms'
statistics, the softmax and the loss stay float32, as the configuration
keeps them.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 under one per-tensor scale, back in float32;
    the scale held out of the gradient, as an fp8 product's is."""
    amax = x.detach().abs().amax().clamp(min=1e-12)
    scale = E4M3_MAX / amax
    q = (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
    return x + (q - x).detach()  # the rounded value, the gradient of x


class Precision:
    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name
        no_tf32()

    def _cast(self, x: torch.Tensor) -> torch.Tensor:
        return fp8(x) if self.name == "fp8" else x

    def act(self, x):
        """A value the configuration holds in its compute type."""
        return self._cast(x)

    def linear(self, x, w, b=None):
        y = self._cast(x) @ self._cast(w).t()
        return self._cast(y if b is None else y + b)

    def matmul(self, a, b):
        return self._cast(self._cast(a) @ self._cast(b))
