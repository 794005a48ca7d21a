from .config import Config, MODEL_DEFAULTS, make_config
from .device import resolve_device
from .types import (
    SparseCOO,
    from_edges,
    from_scipy,
    pad_to_multiple,
    padded_rows_from_lists,
    to_scipy,
    transpose_coo,
    with_new_vals,
)

__all__ = [
    "Config",
    "MODEL_DEFAULTS",
    "make_config",
    "resolve_device",
    "SparseCOO",
    "from_edges",
    "from_scipy",
    "pad_to_multiple",
    "padded_rows_from_lists",
    "to_scipy",
    "transpose_coo",
    "with_new_vals",
]
