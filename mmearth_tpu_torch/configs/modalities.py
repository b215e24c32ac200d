"""Modality registry for the MMEarth dataset (the port's own copy of
``mmearth_tpu/configs/modalities.py``; the port imports nothing of the JAX
package).

Typed re-statement of the reference's module-level config dicts
(upstream MODALITIES.py:37-189).  Every modality is described by a single
frozen record carrying its full band list, no-data value, task family and
whether it is pixel-wise; the classic dict views (``INP_MODALITIES`` etc.) are
derived from the registry so downstream code can keep the reference's API.
"""
from __future__ import annotations

import dataclasses
import math
import os
from pathlib import Path
from typing import Mapping, Sequence

# Task families (reference: MODALITIES.py:163-180).
REGRESSION_MAP = "regression_map"  # continuous, pixel-wise
REGRESSION = "regression"  # continuous, image-level
SEGMENTATION = "segmentation"  # categorical, pixel-wise
CLASSIFICATION = "classification"  # categorical, image-level


@dataclasses.dataclass(frozen=True)
class ModalitySpec:
    """Static description of one MMEarth modality."""

    name: str
    bands: tuple[str, ...]
    task: str
    no_data: float
    pixel_wise: bool
    # Number of prediction channels/classes the FCMAE head emits for this
    # modality (reference: fcmae.py:70-91).  ``None`` means "number of selected
    # bands" (continuous modalities).
    num_classes: int | None = None


def _spec(name, bands, task, no_data, pixel_wise, num_classes=None):
    return ModalitySpec(name, tuple(bands), task, no_data, pixel_wise, num_classes)


_S2_BANDS = ("B1", "B2", "B3", "B4", "B5", "B6", "B7", "B8A", "B8", "B9", "B10", "B11", "B12")
_S1_BANDS = ("asc_VV", "asc_VH", "asc_HH", "asc_HV", "desc_VV", "desc_VH", "desc_HH", "desc_HV")
_ERA5_BANDS = tuple(
    f"{period}_{stat}"
    for period in ("prev_month", "curr_month", "year")
    for stat in ("avg_temp", "min_temp", "max_temp", "total_precip")
)

# Ground-truth registry (full band lists: reference MODALITIES.py:109-161;
# no-data values: :37-53; task map: :163-180; pixel-wise list: :182-189).
REGISTRY: Mapping[str, ModalitySpec] = {
    s.name: s
    for s in (
        _spec("sentinel2", _S2_BANDS, REGRESSION_MAP, 0, True),
        _spec("sentinel1", _S1_BANDS, REGRESSION_MAP, -math.inf, True),
        _spec("aster", ("elevation", "slope"), REGRESSION_MAP, -math.inf, True),
        _spec("era5", _ERA5_BANDS, REGRESSION, math.nan, False),
        _spec("dynamic_world", ("landcover",), SEGMENTATION, 0, True, num_classes=9),
        _spec("canopy_height_eth", ("height", "std"), REGRESSION_MAP, 255, True),
        _spec("lat", ("sin", "cos"), REGRESSION, -math.inf, False),
        _spec("lon", ("sin", "cos"), REGRESSION, -math.inf, False),
        _spec("biome", ("biome",), CLASSIFICATION, 255, False, num_classes=14),
        _spec("eco_region", ("eco_region",), CLASSIFICATION, 65535, False, num_classes=846),
        _spec("month", ("sin_month", "cos_month"), REGRESSION, -math.inf, False),
        _spec("esa_worldcover", ("map",), SEGMENTATION, 0, True, num_classes=11),
    )
}

# ---------------------------------------------------------------------------
# Derived classic views, API-compatible with the reference module.
# ---------------------------------------------------------------------------
NO_DATA_VAL: dict[str, float] = {k: v.no_data for k, v in REGISTRY.items()}
MODALITY_TASK: dict[str, str] = {k: v.task for k, v in REGISTRY.items()}
PIXEL_WISE_MODALITIES: list[str] = [
    "sentinel2", "sentinel1", "aster", "canopy_height_eth", "esa_worldcover", "dynamic_world",
]

# Default training configurations (reference MODALITIES.py:56-106).  "all"
# selects every band in MODALITIES_FULL for that modality.
_S2_TRAIN_BANDS = ["B1", "B2", "B3", "B4", "B5", "B6", "B7", "B8A", "B8", "B9", "B11", "B12"]

INP_MODALITIES: dict[str, list[str] | str] = {"sentinel2": list(_S2_TRAIN_BANDS)}

OUT_MODALITIES: dict[str, list[str] | str] = {
    "sentinel2": list(_S2_TRAIN_BANDS),
    "sentinel1": "all",
    "aster": "all",
    "era5": "all",
    "dynamic_world": "all",
    "canopy_height_eth": "all",
    "lat": "all",
    "lon": "all",
    "biome": "all",
    "eco_region": "all",
    "month": "all",
    "esa_worldcover": "all",
}

# Modalities whose loss family is image-level (reference fcmae.py:143, 259, 278).
IMAGE_LEVEL_MODALITIES = ("biome", "eco_region", "lat", "lon", "month", "era5")
# Continuous pixel-wise modalities whose NaNs are zeroed on input
# (reference fcmae.py:445-449).
CONTINUOUS_PIXEL_MODALITIES = ("sentinel2", "sentinel1", "aster", "canopy_height_eth")
CATEGORICAL_PIXEL_MODALITIES = ("dynamic_world", "esa_worldcover")


def mmearth_dir() -> Path:
    """Dataset root; overridable via $MMEARTH_DIR (reference MODALITIES.py:31-35)."""
    return Path(os.environ.get("MMEARTH_DIR", "/projects/dereeco/data/global-lr/data_1M_130_new/"))


def resolve_bands(modalities: Mapping[str, Sequence[str] | str]) -> dict[str, list[str]]:
    """Expand "all" markers into explicit band lists."""
    out = {}
    for name, bands in modalities.items():
        spec = REGISTRY[name]
        out[name] = list(spec.bands) if bands == "all" else list(bands)
    return out


def band_indices(modalities: Mapping[str, Sequence[str] | str]) -> dict[str, list[int]]:
    """Indices of the selected bands inside the full per-modality band list
    (reference mmearth_dataset.py:71-77)."""
    out = {}
    for name, bands in resolve_bands(modalities).items():
        full = REGISTRY[name].bands
        out[name] = [full.index(b) for b in bands]
    return out


def out_channels(out_modalities: Mapping[str, Sequence[str] | str]) -> dict[str, int]:
    """Per-modality prediction channel counts (reference fcmae.py:70-91)."""
    chans = {}
    for name, bands in out_modalities.items():
        spec = REGISTRY[name]
        if spec.num_classes is not None:
            chans[name] = spec.num_classes
        elif bands == "all":
            chans[name] = len(spec.bands)
        else:
            chans[name] = len(bands)
    return chans



RGB_MODALITIES: dict[str, list[str] | str] = {"sentinel2": ["B2", "B3", "B4"]}


def modality_preset(name: str) -> dict:
    """Named modality configurations for the packing CLIs."""
    return {
        "default": {**INP_MODALITIES, **OUT_MODALITIES},
        "rgb": RGB_MODALITIES,
        "inp_only": INP_MODALITIES,
    }[name]
