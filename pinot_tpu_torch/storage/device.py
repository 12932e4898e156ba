"""Device storage constants: padding and the device value space.

Columns reach the card as padded (S, L) blocks built by
engine/params.py BatchContext. Raw columns keep a narrow device dtype;
DOUBLE is float32 on the card, the same value space as the JAX package
(whose TPU has no native f64), so both engines aggregate the same values.
"""

from __future__ import annotations

import numpy as np

from pinot_tpu_torch.common.datatypes import DataType

PAD_MULTIPLE = 1024

RAW_DEVICE_DTYPES = {
    DataType.INT: np.int32,
    DataType.LONG: np.int64,
    DataType.FLOAT: np.float32,
    DataType.DOUBLE: np.float32,
    DataType.BIG_DECIMAL: np.float32,
    DataType.BOOLEAN: np.int32,
    DataType.TIMESTAMP: np.int64,
}


def padded_len(n: int, multiple: int = PAD_MULTIPLE) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)
