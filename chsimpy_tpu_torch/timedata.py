"""Per-step time-series store.

Same 9-column layout as ``chsimpy_tpu/timedata.py``:
[it, E, E2, SA, domtime, Ra, L2, PS, delt].  Rows are produced on the
device in chunk-sized blocks by the stepper and appended here in blocks.
"""

from __future__ import annotations

import numpy as np

COLUMNS = ('it', 'E', 'E2', 'SA', 'domtime', 'Ra', 'L2', 'PS', 'delt')


class TimeData:
    def __init__(self):
        self._blocks = []
        self._data = np.empty(shape=(0, 9))
        self._dirty = False

    def insert(self, it, delt, E, E2, SA, domtime, Ra, L2, PS):
        row = np.array([[it, E, E2, SA, domtime, Ra, L2, PS, delt]],
                       dtype=np.float64)
        if np.any(np.isnan(row)):
            raise FloatingPointError("NaN in timedata row")
        self._blocks.append(row)
        self._dirty = True

    def insert_block(self, rows: np.ndarray):
        """Append a (k, 9) block of rows produced by a device chunk."""
        if rows.size == 0:
            return
        if rows.ndim != 2 or rows.shape[1] != 9:
            raise ValueError(f"timedata block must be (k, 9), "
                             f"got {rows.shape}")
        if np.any(np.isnan(rows)):
            raise FloatingPointError("NaN in timedata block")
        self._blocks.append(np.asarray(rows, dtype=np.float64))
        self._dirty = True

    def data(self) -> np.ndarray:
        if self._dirty:
            self._data = np.concatenate([self._data] + self._blocks, axis=0)
            self._blocks = []
            self._dirty = False
        return self._data

    def __len__(self):
        return self.data().shape[0]

    @property
    def it_range(self):
        return self.data()[:, 0]

    @property
    def E(self):
        return self.data()[:, 1]

    @property
    def E2(self):
        return self.data()[:, 2]

    @property
    def SA(self):
        return self.data()[:, 3]

    @property
    def domtime(self):
        return self.data()[:, 4]

    @property
    def Ra(self):
        return self.data()[:, 5]

    @property
    def L2(self):
        return self.data()[:, 6]

    @property
    def PS(self):
        return self.data()[:, 7]

    @property
    def delt(self):
        return self.data()[:, 8]
