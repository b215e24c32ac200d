"""The cell's inputs, made from the seed.

:func:`device_pool` is the benchmark's copy of the program's
``bench_batch`` (the synthetic MMEarth batch its benchmark trains on: i.i.d.
standard normals for the continuous modalities, categorical maps with -1 for
no data, one-hot biome and eco-region, NHWC, no transform), drawn on the
device from one generator instead of numpy on the host, so that set-up
stays short.
"""
from __future__ import annotations

import torch

# (modality, channels) of the continuous pixel maps, in the batch's order
CONTINUOUS = (("sentinel2", 12), ("sentinel1", 8), ("aster", 2), ("canopy_height_eth", 2))
# (modality, low, high) of the categorical maps: labels in [low, high), -1 = no data
CATEGORICAL = (("dynamic_world", -1, 9), ("esa_worldcover", -1, 11))
IMAGE_CONTINUOUS = (("era5", 12), ("lat", 2), ("lon", 2), ("month", 2))
ONE_HOT = (("biome", 14), ("eco_region", 846))


def device_batch(n: int, tile: int, g: torch.Generator, device) -> dict[str, torch.Tensor]:
    out = {}
    for name, c in CONTINUOUS:
        out[name] = torch.randn(n, tile, tile, c, generator=g, device=device)
    for name, lo, hi in CATEGORICAL:
        out[name] = torch.randint(lo, hi, (n, tile, tile, 1), generator=g, device=device,
                                  dtype=torch.int32)
    for name, c in IMAGE_CONTINUOUS:
        out[name] = torch.randn(n, c, generator=g, device=device)
    for name, c in ONE_HOT:
        idx = torch.randint(0, c, (n,), generator=g, device=device)
        out[name] = torch.nn.functional.one_hot(idx, c).to(torch.int32)
    order = ("sentinel2", "sentinel1", "aster", "canopy_height_eth", "dynamic_world",
             "esa_worldcover", "era5", "lat", "lon", "month", "biome", "eco_region")
    return {k: out[k] for k in order}


def device_pool(batches: int, n: int, tile: int, seed: int, device) -> list[dict]:
    """``batches`` distinct batches of ``n`` samples of ``tile`` px."""
    g = torch.Generator(device=device).manual_seed((seed * 7919 + 17) % 2 ** 63)
    return [device_batch(n, tile, g, device) for _ in range(batches)]
