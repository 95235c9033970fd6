# Frozen copy of heligym_tpu_torch/ops/dryden.py for the benchmark's plain reference;
# it imports nothing of the port and is not edited with it.
"""Dryden turbulence wind model (MIL-HDBK-1797) as plain functions on tensors.

The white-noise input `eta` is an explicit argument: callers draw it from a
`torch.Generator`, and parity tests inject recorded or numpy-made noise
through the same seam. The three altitude regimes are evaluated branchlessly
and selected with `torch.where`. The turbulence azimuth is consumed only
through its cosine and sine, which `_cos_sin_atan2` computes algebraically,
as the JAX package does.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .constants import D2R, EPS, SQRT_3, TWO_D_PI
from .mathx import cdiv, rdiv
from .lookup import Table
from .state import WindState


def _tep_table() -> Table:
    """Turbulence Exceedence Probability table."""
    t = Table(7, 12)
    t << 500.0 << 1750.0 << 3750.0 << 7500.0 << 15000.0 << 25000.0 << 35000.0 << 45000.0 << 55000.0 << 65000.0 << 75000.0 << 80000.0 \
      << 1 << 3.2 << 2.2 << 1.5 << 0.0 << 0.0 << 0.0 << 0.0 << 0.0 << 0.0 << 0.0 << 0.0 << 0.0 \
      << 2 << 4.2 << 3.6 << 3.3 << 1.6 << 0.0 << 0.0 << 0.0 << 0.0 << 0.0 << 0.0 << 0.0 << 0.0 \
      << 3 << 6.6 << 6.9 << 7.4 << 6.7 << 4.6 << 2.7 << 0.4 << 0.0 << 0.0 << 0.0 << 0.0 << 0.0 \
      << 4 << 8.6 << 9.6 << 10.6 << 10.1 << 8.0 << 6.6 << 5.0 << 4.2 << 2.7 << 0.0 << 0.0 << 0.0 \
      << 5 << 11.8 << 13.0 << 16.0 << 15.1 << 11.6 << 9.7 << 8.1 << 8.2 << 7.9 << 4.9 << 3.2 << 2.1 \
      << 6 << 15.6 << 17.6 << 23.0 << 23.6 << 22.1 << 20.0 << 16.0 << 15.1 << 12.1 << 7.9 << 6.2 << 5.1 \
      << 7 << 18.7 << 21.5 << 28.4 << 30.2 << 30.7 << 31.0 << 25.2 << 23.1 << 17.5 << 10.7 << 8.4 << 7.2
    return t


_TEP_DATA = np.asarray(_tep_table()._data)


@dataclasses.dataclass(frozen=True)
class WindParams:
    """Static wind/turbulence configuration (from the model's ENV block)."""
    turbulence_level: int
    wind_dir_rad: float
    wind_speed: float
    mean_ned: tuple            # (3,) mean NED wind [ft/s]

    @classmethod
    def from_env(cls, env) -> "WindParams":
        wd = env.WIND_DIR * D2R
        mean = env.WIND_SPD * np.array(
            [np.cos(wd), np.sin(wd), 0.0], dtype=np.float32)
        return cls(turbulence_level=int(env.TURB_LVL), wind_dir_rad=float(wd),
                   wind_speed=float(env.WIND_SPD),
                   mean_ned=tuple(float(x) for x in mean))


def mean_wind(wp: WindParams, device=None) -> torch.Tensor:
    return torch.tensor(wp.mean_ned, dtype=torch.float32, device=device)


def tep_static_row(level: int):
    """The TEP lookup's static part for one turbulence level: the row blend
    factor and the 12 column keys and the two bracketing rows' values, all as
    Python floats (float32 values)."""
    data = _TEP_DATA.astype(np.float32)
    n_rows = data.shape[0] - 1
    r = int(np.clip(np.searchsorted(data[1:, 0], np.float32(level)) + 1, 2, n_rows))
    rk0, rk1 = data[r, 0], data[r - 1, 0]
    r_factor = float(np.clip((np.float32(level) - rk1) / (rk0 - rk1), 0.0, 1.0))
    col_keys = [float(x) for x in data[0, 1:]]          # 12 static keys
    row_a = [float(x) for x in data[r - 1, 1:]]          # row r-1 values
    row_b = [float(x) for x in data[r, 1:]]              # row r values
    return r_factor, col_keys, row_a, row_b


@functools.lru_cache(maxsize=None)
def _tep_row_tensors(level: int, device):
    r_factor, col_keys, row_a, row_b = tep_static_row(level)
    return (r_factor,) + tuple(torch.tensor(v, dtype=torch.float32, device=device)
                               for v in (col_keys, row_a, row_b))


def _tep_lookup_static_row(level: int, col_key):
    """TEP lookup specialised for the static turbulence level: the row
    bracket and row blend factor are constants, and only the column is
    looked up per env. Value-identical to `table_lookup_2d(_TEP_DATA, level,
    col_key)` (same entries, same float32 expression order)."""
    r_factor, keys_t, row_a, row_b = _tep_row_tensors(level, col_key.device)
    n_cols = keys_t.shape[0]
    # dynamic column bracket: first padded index with key >= col_key, in [2, n]
    idx = 1 + (keys_t < col_key.unsqueeze(-1)).sum(-1)
    c = idx.clamp(2, n_cols)

    def pick(vals, j):
        return vals[j - 1]

    ck0, ck1 = pick(keys_t, c), pick(keys_t, c - 1)
    c_factor = torch.clamp((col_key - ck1) / (ck0 - ck1), 0.0, 1.0)
    a0, a1 = pick(row_a, c - 1), pick(row_a, c)     # data[r-1, c-1], data[r-1, c]
    b0, b1 = pick(row_b, c - 1), pick(row_b, c)     # data[r,   c-1], data[r,   c]
    col1 = r_factor * (b0 - a0) + a0
    col2 = r_factor * (b1 - a1) + a1
    return col1 + c_factor * (col2 - col1)


def _cos_sin_atan2(y, x):
    """(cos, sin) of atan2(y, x) in closed algebraic form (x/r, y/r): the
    azimuth is only ever consumed through cos/sin. atan2(0, 0) = 0 maps to
    (1, 0), matching cos/sin of the reference value."""
    r = torch.sqrt(x * x + y * y)
    safe = torch.where(r == 0.0, 1.0, r)
    return (torch.where(r == 0.0, 1.0, x / safe),
            torch.where(r == 0.0, 0.0, y / safe))


def turbulence_params(wp: WindParams, h_gr, vel_inf_n, vel_inf_e):
    """Scale lengths, sigmas and turbulence azimuth (as cos/sin) for the three
    MIL-HDBK-1797 altitude regimes, selected branchlessly."""
    w20 = wp.turbulence_level / 7.0 * 88.61
    tep = _tep_lookup_static_row(wp.turbulence_level, h_gr)

    # Low altitude (h <= 1000 ft).
    hg_lo = torch.clamp(h_gr, min=10.0)
    base_lo = 0.177 + 0.000823 * hg_lo
    lu_lo = hg_lo / (base_lo ** 1.2)
    lw_lo = 0.5 * hg_lo
    sw_lo = 0.1 * w20
    su_lo = rdiv(sw_lo, base_lo ** 0.4)
    azc_lo = float(np.cos(np.float32(wp.wind_dir_rad)))
    azs_lo = float(np.sin(np.float32(wp.wind_dir_rad)))

    # High altitude (h >= 2000 ft).
    lu_hi = torch.full_like(h_gr, 1750.0)
    azc_hi, azs_hi = _cos_sin_atan2(vel_inf_e, vel_inf_n)

    # Medium altitude: interpolation between the two regimes.
    r = cdiv(h_gr - 1000.0, 1000.0)
    lu_mid = 1000.0 + r * 750.0
    s_mid = 0.1 * w20 + r * (tep - 0.1 * w20)
    m0, m1, _ = wp.mean_ned          # static floats
    azc_mid, azs_mid = _cos_sin_atan2(vel_inf_e * r + m1 * (1.0 - r),
                                      vel_inf_n * r + m0 * (1.0 - r))

    low = h_gr <= 1000.0
    high = h_gr >= 2000.0
    lu = torch.where(low, lu_lo, torch.where(high, lu_hi, lu_mid))
    lv = 0.5 * lu
    lw = torch.where(low, lw_lo, torch.where(high, 0.5 * lu_hi, lu_mid))
    su = torch.where(low, su_lo, torch.where(high, tep, s_mid))
    sv = su
    sw = torch.where(low, sw_lo, torch.where(high, tep, s_mid))
    az_cos = torch.where(low, azc_lo, torch.where(high, azc_hi, azc_mid))
    az_sin = torch.where(low, azs_lo, torch.where(high, azs_hi, azs_mid))
    return lu, lv, lw, su, sv, sw, az_cos, az_sin


def wind_dynamics(wp: WindParams, state: WindState, action4, eta3):
    """Dryden filter ODE right-hand side + wind observation.

    `action4` = (ned_vel_n, ned_vel_e, ned_vel_d, h_gr) tuple; `eta3` = white
    noise 3-tuple (already scaled by 1/sqrt(dt)). Returns
    (dots: WindState, wind_ned: 3-tuple).
    """
    m0, m1, m2 = (float(np.float32(x)) for x in wp.mean_ned)
    vi_n, vi_e, vi_d = action4[0] + m0, action4[1] + m1, action4[2] + m2
    vel_inf = torch.sqrt(vi_n * vi_n + vi_e * vi_e + vi_d * vi_d)
    h_gr = action4[3]
    lu, lv, lw, su, sv, sw, az_cos, az_sin = turbulence_params(wp, h_gr, vi_n, vi_e)
    t_u = lu / (vel_inf + EPS)
    t_v = lv / (vel_inf + EPS)
    t_w = lw / (vel_inf + EPS)

    usdot = 1.0 / t_u * (eta3[0] - state.us)
    vs0dot = 1.0 / (4.0 * (t_v * t_v)) * (eta3[1] - state.vs1) - 1.0 / t_v * state.vs0
    ws0dot = 1.0 / (4.0 * (t_w * t_w)) * (eta3[2] - state.ws1) - 1.0 / t_w * state.ws0
    dots = WindState(us=usdot, vs0=vs0dot, vs1=state.vs0,
                     ws0=ws0dot, ws1=state.ws0)

    k_u = su * torch.sqrt(TWO_D_PI * t_u)
    k_v = sv * torch.sqrt(TWO_D_PI * t_v)
    k_w = sw * torch.sqrt(TWO_D_PI * t_w)
    u_turb = k_u * state.us
    v_turb = k_v * (state.vs1 + 2.0 * SQRT_3 * state.vs0)
    w_turb = k_w * (state.ws1 + 2.0 * SQRT_3 * state.ws0)
    c, s = az_cos, az_sin
    wind_ned = (m0 + (c * u_turb - s * v_turb),
                m1 + (s * u_turb + c * v_turb),
                m2 + w_turb)
    return dots, wind_ned
