# Frozen copy of heligym_tpu_torch/ops/lookup.py for the benchmark's plain reference;
# it imports nothing of the port and is not edited with it.
"""JSBSim-style clamped linear-interpolation tables over torch tensors.

Same semantics as the JAX package's `ops/lookup.py`: a stateless bracket
search, and the reference's 1-D high-end clamp bug (it returns the last KEY,
not the last value) reproduced for behavioural parity.
"""
from __future__ import annotations

import numpy as np
import torch


class Table:
    """Dense (nRows+1, nCols+1) table; row 0 holds column keys, column 0 holds
    row keys, cell [0,0] unused. Fill with `<<`."""

    def __init__(self, n_rows: int = 1, n_cols: int = 1):
        assert isinstance(n_rows, int) and isinstance(n_cols, int)
        assert n_rows > 0 and n_cols > 0
        self._n_rows, self._n_cols = n_rows, n_cols
        if n_cols == 1:
            self._row_counter, self._col_counter = 1, 0
        else:
            self._row_counter, self._col_counter = 0, 1
        self._data = np.zeros((n_rows + 1, n_cols + 1), dtype=np.float32)

    def __lshift__(self, value):
        assert self._row_counter <= self._n_rows, "table overfull"
        self._data[self._row_counter][self._col_counter] = np.float32(value)
        if self._col_counter >= self._n_cols:
            self._col_counter = 0
            self._row_counter += 1
        else:
            self._col_counter += 1
        return self

    @property
    def data(self) -> torch.Tensor:
        return torch.from_numpy(self._data.copy())


def _bracket(keys, key, n):
    """Smallest index r in [2, n] (into the padded table) with keys[r] >= key;
    `keys` is the padded column/row whose entries 1..n are real."""
    idx = (keys[1:] < key.unsqueeze(-1)).sum(-1) + 1
    return idx.clamp(2, n)


def table_lookup_1d(data, key):
    key = torch.as_tensor(key, dtype=torch.float32)
    n = data.shape[0] - 1
    r = _bracket(data[:, 0], key, n)
    keys_col, vals_col = data[:, 0], data[:, 1]
    d_r0, d_r1 = keys_col[r], keys_col[r - 1]
    v_r0, v_r1 = vals_col[r], vals_col[r - 1]
    span = d_r0 - d_r1
    factor = torch.where(span != 0.0,
                         (key - d_r1) / torch.where(span != 0.0, span, 1.0), 1.0)
    factor = torch.clamp(factor, max=1.0)
    value = factor * (v_r0 - v_r1) + v_r1
    # Reference edge handling, including the high-end bug where the last KEY
    # (column 0) is returned instead of the last value.
    value = torch.where(key <= data[1, 0], data[1, 1], value)
    value = torch.where(key >= data[n, 0], data[n, 0], value)
    return value


def table_lookup_2d(data, row_key, col_key):
    row_key = torch.as_tensor(row_key, dtype=torch.float32)
    col_key = torch.as_tensor(col_key, dtype=torch.float32)
    n_rows, n_cols = data.shape[0] - 1, data.shape[1] - 1
    r = _bracket(data[:, 0], row_key, n_rows)
    c = _bracket(data[0, :], col_key, n_cols)
    rk0, rk1 = data[r, 0], data[r - 1, 0]
    ck0, ck1 = data[0, c], data[0, c - 1]
    r_factor = torch.clamp((row_key - rk1) / (rk0 - rk1), 0.0, 1.0)
    c_factor = torch.clamp((col_key - ck1) / (ck0 - ck1), 0.0, 1.0)
    d_rc, d_rc1 = data[r, c], data[r, c - 1]
    d_r1c, d_r1c1 = data[r - 1, c], data[r - 1, c - 1]
    col1 = r_factor * (d_rc1 - d_r1c1) + d_r1c1
    col2 = r_factor * (d_rc - d_r1c) + d_r1c
    return col1 + c_factor * (col2 - col1)
