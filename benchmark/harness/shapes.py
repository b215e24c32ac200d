"""The sizes a cell's step works on, from its configuration and traffic."""
from __future__ import annotations


def encoder_stages(model: dict, batch: int) -> list[dict]:
    """Per encoder stage: its width ``C``, its Blocks ``depth`` and the
    ``rows`` a Block works on (the visible sites of the batch: N x K x p^2
    at that stage's patch side p)."""
    grid = model["img_size"] // model["patch_size"]
    stride = model["patch_size"] // 2 ** (len(model["depths"]) - 1)
    visible = int(grid * grid * (1 - model["mask_ratio"]))
    side = model["img_size"] // stride // grid
    out = []
    for i, (depth, c) in enumerate(zip(model["depths"], model["dims"])):
        p = side >> i
        out.append({"C": c, "depth": depth, "rows": batch * visible * p * p})
    return out
