# Frozen copy of heligym_tpu_torch/models/schema.py for the benchmark's plain reference;
# it imports nothing of the port and is not edited with it.
"""Parameter schema: YAML -> frozen parameter objects with derived quantities.

A copy of the JAX package's `models/schema.py` (the port imports nothing of
that package): the derived rotor/inertia quantities are computed once on the
host in float64 Python arithmetic, term for term as the reference does, and
stored as plain Python floats. The gear leg positions and the inertia inverse
are float32, as the reference computes them. Every physics function narrows a
parameter to float32 at its point of use.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

_F = float


@dataclasses.dataclass(frozen=True)
class EnvPhysics:
    """Atmosphere / terrain-extent / mean-wind parameters (aw109.yaml ENV block)."""
    R: _F
    T0: _F
    LAPSE: _F
    HTS: _F
    RO_SEA: _F
    GRAV: _F
    MAX_GR_ALT: _F
    NS_MAX: _F
    EW_MAX: _F
    WIND_DIR: _F        # [deg]
    WIND_SPD: _F        # [ft/s]
    TURB_LVL: int
    HMAP_PATH: str
    NMAP_PATH: str


@dataclasses.dataclass(frozen=True)
class MainRotor:
    FS: _F; WL: _F; IS: _F; E: _F; IB: _F; R: _F; A: _F; RPM: _F
    CD0: _F; B: _F; C: _F; TWST: _F; K1: _F
    # derived (helicopter_dynamics.py:110-111,130-142)
    H: _F = 0.0; D: _F = 0.0
    OMEGA: _F = 0.0; V_TIP: _F = 0.0; FR: _F = 0.0; SOL: _F = 0.0
    A_SIGMA: _F = 0.0; GAM_OM16_DRO: _F = 0.0
    DL_DB1: _F = 0.0; DL_DA1_DRO: _F = 0.0; COEF_TH: _F = 0.0


@dataclasses.dataclass(frozen=True)
class TailRotor:
    FS: _F; WL: _F; R: _F; A: _F; C: _F; RPM: _F; CD0: _F; TWST: _F; B: _F
    # derived (helicopter_dynamics.py:120-121,144-148)
    H: _F = 0.0; D: _F = 0.0
    OMEGA: _F = 0.0; FR: _F = 0.0; V_TIP: _F = 0.0; SOL: _F = 0.0
    COEF_TH: _F = 0.0


@dataclasses.dataclass(frozen=True)
class Fuselage:
    FS: _F; WL: _F; XUU: _F; YVV: _F; ZWW: _F; COR: _F
    H: _F = 0.0; D: _F = 0.0


@dataclasses.dataclass(frozen=True)
class HorizontalTail:
    FS: _F; WL: _F; ZUU: _F; ZUW: _F; ZMAX: _F
    H: _F = 0.0; D: _F = 0.0


@dataclasses.dataclass(frozen=True)
class VerticalTail:
    FS: _F; WL: _F; YUU: _F; YUV: _F; YMAX: _F
    H: _F = 0.0; D: _F = 0.0


@dataclasses.dataclass(frozen=True)
class Wing:
    FS: _F; WL: _F; ZUU: _F; ZUW: _F; ZMAX: _F; B: _F
    H: _F = 0.0; D: _F = 0.0


@dataclasses.dataclass(frozen=True)
class LandingGear:
    K: _F; C: _F; BL_MN: _F; FS_MN: _F; FS_N: _F; WL: _F
    # leg positions wrt CG, body frame [ft]; rows: nose, right-main, left-main
    # (helicopter_dynamics.py:123-126)
    LOC: Tuple[Tuple[_F, _F, _F], ...] = ()


@dataclasses.dataclass(frozen=True)
class HeliBody:
    HP_LOSS: _F; VTRANS: _F; FS_CG: _F; WL_CG: _F; WT: _F
    IX: _F; IY: _F; IZ: _F; IXZ: _F
    COL_OS: _F; COL_L: _F; COL_H: _F
    LON_L: _F; LON_H: _F
    LAT_L: _F; LAT_H: _F
    PED_OS: _F; PED_L: _F; PED_H: _F
    # derived
    M: _F = 0.0
    # inertia tensor and its inverse, float32 exactly as the reference builds
    # them (helicopter_dynamics.py:151-154); stored row-major as tuples.
    I: Tuple[Tuple[_F, _F, _F], ...] = ()
    IINV: Tuple[Tuple[_F, _F, _F], ...] = ()


@dataclasses.dataclass(frozen=True)
class HeliParams:
    """Full static parameter set for one helicopter model."""
    name: str
    ENV: EnvPhysics
    HELI: HeliBody
    MR: MainRotor
    TR: TailRotor
    FUS: Fuselage
    HT: HorizontalTail
    VT: VerticalTail
    WN: Wing
    LG: LandingGear


def _arm(component_wl, component_fs, wl_cg, fs_cg):
    """Waterline/fuselage-station offsets (inches) -> H, D arms in feet."""
    return (component_wl - wl_cg) / 12.0, (component_fs - fs_cg) / 12.0


def precalculate(raw: dict, name: str = "aw109") -> HeliParams:
    """Build a HeliParams from the raw YAML dict, deriving all coefficients.

    Mirrors helicopter_dynamics.py:107-154 term for term; arithmetic runs in
    float64 Python (the reference likewise computes python-float parameters and
    only narrows to float32 at the point of use, numpy 2.x weak promotion).
    """
    env_raw = dict(raw["ENV"])
    heli_raw = dict(raw["HELI"])
    mr_raw = dict(heli_raw.pop("MR"))
    tr_raw = dict(heli_raw.pop("TR"))
    fus_raw = dict(heli_raw.pop("FUS"))
    ht_raw = dict(heli_raw.pop("HT"))
    vt_raw = dict(heli_raw.pop("VT"))
    wn_raw = dict(heli_raw.pop("WN"))
    lg_raw = dict(heli_raw.pop("LG"))

    env = EnvPhysics(
        R=float(env_raw["R"]), T0=float(env_raw["T0"]), LAPSE=float(env_raw["LAPSE"]),
        HTS=float(env_raw["HTS"]), RO_SEA=float(env_raw["RO_SEA"]), GRAV=float(env_raw["GRAV"]),
        MAX_GR_ALT=float(env_raw["MAX_GR_ALT"]), NS_MAX=float(env_raw["NS_MAX"]),
        EW_MAX=float(env_raw["EW_MAX"]), WIND_DIR=float(env_raw["WIND_DIR"]),
        WIND_SPD=float(env_raw["WIND_SPD"]), TURB_LVL=int(env_raw["TURB_LVL"]),
        HMAP_PATH=str(env_raw["HMAP_PATH"]), NMAP_PATH=str(env_raw["NMAP_PATH"]),
    )

    fs_cg, wl_cg = float(heli_raw["FS_CG"]), float(heli_raw["WL_CG"])

    # --- main rotor -----------------------------------------------------
    mr_h, mr_d = _arm(mr_raw["WL"], mr_raw["FS"], wl_cg, fs_cg)
    omega = mr_raw["RPM"] * 2.0 * math.pi / 60.0
    v_tip = mr_raw["R"] * omega
    mr = MainRotor(
        **{k: float(v) for k, v in mr_raw.items()},
        H=mr_h, D=mr_d, OMEGA=omega, V_TIP=v_tip,
        FR=mr_raw["CD0"] * mr_raw["R"] * mr_raw["B"] * mr_raw["C"],
        SOL=mr_raw["B"] * mr_raw["C"] / (mr_raw["R"] * math.pi),
        A_SIGMA=mr_raw["A"] * (mr_raw["B"] * mr_raw["C"] / (mr_raw["R"] * math.pi)),
        GAM_OM16_DRO=(mr_raw["A"] * mr_raw["C"] * mr_raw["R"] ** 4 / mr_raw["IB"]
                      * omega / 16.0 * (1.0 + 8.0 / 3.0 * mr_raw["E"] / mr_raw["R"])),
        DL_DB1=mr_raw["B"] / 2.0 * (1.5 * mr_raw["IB"] * mr_raw["E"] / mr_raw["R"] * omega ** 2),
        DL_DA1_DRO=0.5 * mr_raw["A"] * mr_raw["B"] * mr_raw["C"] * mr_raw["R"] * v_tip ** 2 * mr_raw["E"] / 6.0,
        COEF_TH=0.25 * v_tip * mr_raw["R"] * mr_raw["A"] * mr_raw["B"] * mr_raw["C"],
    )

    # --- tail rotor -----------------------------------------------------
    tr_h, tr_d = _arm(tr_raw["WL"], tr_raw["FS"], wl_cg, fs_cg)
    tr_omega = tr_raw["RPM"] * 2.0 * math.pi / 60.0
    tr_v_tip = tr_raw["R"] * tr_omega
    tr = TailRotor(
        **{k: float(v) for k, v in tr_raw.items()},
        H=tr_h, D=tr_d, OMEGA=tr_omega, V_TIP=tr_v_tip,
        FR=tr_raw["CD0"] * tr_raw["R"] * tr_raw["B"] * tr_raw["C"],
        SOL=tr_raw["B"] * tr_raw["C"] / (tr_raw["R"] * math.pi),
        COEF_TH=0.25 * tr_v_tip * tr_raw["R"] * tr_raw["A"] * tr_raw["B"] * tr_raw["C"],
    )

    # --- aero surfaces --------------------------------------------------
    fus_h, fus_d = _arm(fus_raw["WL"], fus_raw["FS"], wl_cg, fs_cg)
    fus = Fuselage(**{k: float(v) for k, v in fus_raw.items()}, H=fus_h, D=fus_d)
    ht_h, ht_d = _arm(ht_raw["WL"], ht_raw["FS"], wl_cg, fs_cg)
    ht = HorizontalTail(**{k: float(v) for k, v in ht_raw.items()}, H=ht_h, D=ht_d)
    vt_h, vt_d = _arm(vt_raw["WL"], vt_raw["FS"], wl_cg, fs_cg)
    vt = VerticalTail(**{k: float(v) for k, v in vt_raw.items()}, H=vt_h, D=vt_d)
    wn_h, wn_d = _arm(wn_raw["WL"], wn_raw["FS"], wl_cg, fs_cg)
    wn = Wing(**{k: float(v) for k, v in wn_raw.items()}, H=wn_h, D=wn_d)

    # --- landing gear ---------------------------------------------------
    # Leg positions computed in float32 like the reference (lines 123-126).
    n_loc = -np.array([lg_raw["FS_N"] - fs_cg, 0.0, lg_raw["WL"] - wl_cg], dtype=np.float32) / 12
    r_loc = -np.array([lg_raw["FS_MN"] - fs_cg, -lg_raw["BL_MN"], lg_raw["WL"] - wl_cg], dtype=np.float32) / 12
    l_loc = -np.array([lg_raw["FS_MN"] - fs_cg, lg_raw["BL_MN"], lg_raw["WL"] - wl_cg], dtype=np.float32) / 12
    lg = LandingGear(
        **{k: float(v) for k, v in lg_raw.items()},
        LOC=tuple(tuple(float(x) for x in leg) for leg in (n_loc, r_loc, l_loc)),
    )

    # --- body -----------------------------------------------------------
    ix, iy, iz, ixz = (float(heli_raw[k]) for k in ("IX", "IY", "IZ", "IXZ"))
    inertia = np.array([[ix, 0.0, -ixz], [0.0, iy, 0.0], [-ixz, 0.0, iz]], dtype=np.float32)
    iinv = np.linalg.inv(inertia)  # float32 inverse, as the reference (line 154)
    heli = HeliBody(
        **{k: float(v) for k, v in heli_raw.items()},
        M=float(heli_raw["WT"]) / env.GRAV,
        I=tuple(tuple(float(x) for x in row) for row in inertia),
        IINV=tuple(tuple(float(x) for x in row) for row in iinv),
    )

    return HeliParams(name=name, ENV=env, HELI=heli, MR=mr, TR=tr,
                      FUS=fus, HT=ht, VT=vt, WN=wn, LG=lg)
