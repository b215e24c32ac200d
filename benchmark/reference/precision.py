"""The precision a run of the reference computes in.

``op`` rounds the operands of every product and convolution; ``act``
rounds the activations handed from one op to the next.  The reference is
float32 in both, with TF32 off.  The control, the reference put in the
program's place one precision step below the configuration's bfloat16,
takes its products in float8 (e4m3, each operand scaled by its own amax, as
an fp8 training recipe scales them) and keeps bfloat16 activations.
"""
from __future__ import annotations

import torch

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, in ``x``'s
    dtype; the gradient passes straight through."""
    with torch.no_grad():
        scale = x.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
        q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q.to(x.dtype) - x).detach()


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x + (x.detach().to(torch.bfloat16).to(x.dtype) - x.detach())


class Precision:
    """``name``: "f32" (the reference), "fp8" (the control)."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def op(self, x: torch.Tensor) -> torch.Tensor:
        return fp8_round(x) if self.name == "fp8" else x

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return bf16_round(x) if self.name == "fp8" else x


F32 = Precision("f32")
