"""Window functions (NumPy constants).

Copy of ``acoustic_image_generation_tpu/dsp/windows.py``: the symmetric
Tukey window the frontend folds into its DFT bases.
"""

from __future__ import annotations

import numpy as np


def tukey(m: int, alpha: float = 0.5) -> np.ndarray:
    """Symmetric Tukey (tapered cosine) window of length ``m``.

    Matches ``scipy.signal.windows.tukey(m, alpha, sym=True)``.
    """
    if m == 1:
        return np.ones(1)
    if alpha <= 0:
        return np.ones(m)
    if alpha >= 1.0:
        alpha = 1.0

    n = np.arange(0, m)
    width = int(np.floor(alpha * (m - 1) / 2.0))
    n1 = n[0 : width + 1]
    n2 = n[width + 1 : m - width - 1]
    n3 = n[m - width - 1 :]

    w1 = 0.5 * (1 + np.cos(np.pi * (-1 + 2.0 * n1 / alpha / (m - 1))))
    w2 = np.ones(n2.shape[0])
    w3 = 0.5 * (1 + np.cos(np.pi * (-2.0 / alpha + 1 + 2.0 * n3 / alpha / (m - 1))))

    return np.concatenate((w1, w2, w3))
