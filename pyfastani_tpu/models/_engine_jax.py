"""Device (JAX) query engine.

Query-time device work lives in `parallel.sharded` (one fused program
per dispatch); this module keeps the device-side *ingest* path -- the
chunked long-sequence winnow for device-resident pipelines
(bitwise identical to the host C/NumPy winnow).
"""

from __future__ import annotations

import numpy as np

from ..ops import fragments as frag_ops

__all__ = ["winnow_sequence_device"]

def winnow_sequence_device(data: np.ndarray, params) -> tuple:
    """Device equivalent of `np_engine.winnow_sequence` (bitwise identical)."""
    k, w = params.kmer_size, params.window_size
    n = int(data.shape[0])
    if n - k + 1 < 1 or n - k + 1 - w + 1 < 1:
        return (np.zeros(0, np.uint32), np.zeros(0, np.int32))
    return frag_ops.winnow_long_sequence(data, k, w, params.alphabet_size != 4)
