// fused_step.cu — whole env transitions on Hopper (sm_90a): one launch runs
// one step (fused_step_kernel) or T steps (fused_rollout_kernel) of every env.
//
// Replaces the TPU kernel heligym_tpu/ops/pallas/fused_step.py::_kernel
// (launched by build_fused_core, pl.pallas_call at :201).
//
// What it computes, per env: Dryden wind RK4 with the reference's aliased k4,
// helicopter RK4 (4x heli_dynamics: rotor, tail rotor, fuselage, empennage,
// gear, atmosphere, kinematics), pi_bound on 7 angles, the task reward and
// in-tolerance flag (hover, forward, turning, slalom, landing, oblique; for a
// MixedTask each env evaluates the one sub-task its task id names), the
// step/success counters, done/truncated/failed at the post-step terrain
// height, the collect rows, and the auto-reset select. The terrain gather
// (committed position for the physics, post-step position for the crash
// test) happens here, from the packed (H*W, 3) texel table; the TPU kernel had
// to leave it to XLA and pipeline its flags one step late.
//
// What bounds it on the H100: on paper, bytes. One env-step reads 4 actions,
// 3 noise values and two 12-byte texel rows and writes the 39-row collect
// block (when collected); the 63-row carry is read and written once per
// launch, and the 61 state rows of the init block are read only in lanes
// whose episode ended. Some 4k float operations per env-step sit far below
// the card's ~20 flop/byte balance. In fact, latency: a few thousand envs
// give each SM sub-partition at most one warp, whose RK4 stages are one long
// serial dependency chain.
// What the design does about it:
//   * the constant table and the task table travel by value in the kernel's
//     parameter block (a __grid_constant__ struct), so every constant is an
//     operand from the constant bank, not a global load on the chain;
//   * fused_rollout_kernel keeps the carry in registers for T steps: one
//     launch, one carry load and one carry store per rollout;
//   * the RK4 stages run as loops, so the kernel holds one copy of
//     heli_dynamics and of wind_dynamics, not four: half the code of the
//     fully inlined form, which one warp per scheduler streams every step;
//   * one thread per env, in small blocks (the block size is a launch
//     argument: 32, 64 or 128 threads), so that a few thousand envs spread
//     over many SMs (4096 envs in 64-thread blocks: 64 SMs);
//   * envs are contiguous within a row of every block, so neighbouring
//     threads load and store neighbouring addresses.
//
// Numerics: compiled with -fmad=false and without --use_fast_math. FMA
// contraction changes rounding and drifts the chaotic dynamics away from the
// plain version; fast math would break the x != x non-finite test. Every
// Python-float constant subexpression of the JAX code is folded on the host,
// in float64 with the JAX grouping, into the constant table below; a division
// by a constant is a multiply by its float32 reciprocal, as XLA and PyTorch's
// CUDA kernels compute it. No double arithmetic here. Both launch forms run
// the same float operations in the same order, so their outputs are
// bit-identical to each other and to the plain version.
//
// Row maps (envs contiguous within a row):
//   carry (63, B): 0-17 heli (HELI_STATE_FIELDS) | 18-22 wind | 23-39 obs |
//                  40-57 dots | 58-60 wind_ned | 61 steps | 62 successed_steps
//   init  (62, B): rows 0-60 of the carry of a fresh episode | 61 task id
//                  (a small integer, exact in f32)
//   collect (T, 39, B): 0 reward | 1 done | 2 truncated | 3 failed |
//                  4-20 obs after auto-reset | 21 in-tolerance flag |
//                  22-38 obs before auto-reset (the value bootstrap's input)
//   act (T, B, 4) row-major, or one (B, 4) held for every step (stride 0);
//   eta (T, 3, B) already scaled by 1/sqrt(dt).
//   tasks (n_tasks, 8), n_tasks <= kMaxTasks: kind | 5 targets folded on the
//                  host (see task_reward) | 2 pad.
#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

// The constant table's layout; heligym_tpu_torch/ops/cuda/fused_step.py
// CONST_NAMES lists the same names in the same order.
enum Const {
  K_D2R,
  K_COL_OS, K_COL_SPAN, K_COL_MID, K_LON_SPAN, K_LON_MID, K_LAT_SPAN, K_LAT_MID,
  K_PED_OS, K_PED_SPAN, K_PED_MID,
  K_WT, K_T0, K_LAPSE, K_INV_T0, K_RHO_EXP, K_RO_SEA,
  K_PI, K_TWO_PI, K_EPS, K_P3, K_BIG,
  K_MR_GAM_OM16_DRO, K_MR_KC_NUM, K_MR_K1, K_MR_OMEGA, K_MR_DL_DA1_DRO,
  K_MR_DL_DB1, K_MR_IS, K_MR_WB_C1, K_MR_TW075, K_MR_INV_VTIP, K_MR_TW05,
  K_MR_COEF_TH, K_MR_VIDOT_C, K_MR_R, K_MR_FR4, K_MR_VTIP, K_MR_VTIP2,
  K_MR_INV_OMEGA, K_MR_INV_ASIGMA, K_MR_2_VTIP, K_VTRANS, K_MR_H, K_MR_D,
  K_MR_INV_R,
  K_TR_D, K_TR_H, K_TR_WB_C1, K_TR_TW075, K_TR_INV_VTIP, K_TR_TW05,
  K_TR_COEF_TH, K_TR_VIDOT_C, K_TR_R2, K_TR_OMEGA,
  K_FUS_HARM, K_FUS_DARM, K_FUS_COR, K_FUS_XUU, K_FUS_YVV, K_FUS_ZWW, K_FUS_H,
  K_HT_HARM, K_HT_DARM, K_HT_D, K_HT_ZMAX, K_HT_ZUU, K_HT_ZUW,
  K_VT_D, K_VT_H, K_VT_YMAX, K_VT_YUU, K_VT_YUV,
  K_WL_CG12, K_LG_C, K_LG_K,
  K_LG_LOC_00, K_LG_LOC_01, K_LG_LOC_02, K_LG_LOC_10, K_LG_LOC_11, K_LG_LOC_12,
  K_LG_LOC_20, K_LG_LOC_21, K_LG_LOC_22,
  K_HP_LOSS_FT, K_INV_M,
  K_I_00, K_I_01, K_I_02, K_I_10, K_I_11, K_I_12, K_I_20, K_I_21, K_I_22,
  K_IINV_00, K_IINV_01, K_IINV_02, K_IINV_10, K_IINV_11, K_IINV_12,
  K_IINV_20, K_IINV_21, K_IINV_22,
  K_INV_550,
  K_HALF_DT, K_DT, K_RK4_C,
  K_WM0, K_WM1, K_WM2,
  K_TEP_RF,
  K_TEP_KEY_0, K_TEP_KEY_1, K_TEP_KEY_2, K_TEP_KEY_3, K_TEP_KEY_4, K_TEP_KEY_5,
  K_TEP_KEY_6, K_TEP_KEY_7, K_TEP_KEY_8, K_TEP_KEY_9, K_TEP_KEY_10, K_TEP_KEY_11,
  K_TEP_A_0, K_TEP_A_1, K_TEP_A_2, K_TEP_A_3, K_TEP_A_4, K_TEP_A_5,
  K_TEP_A_6, K_TEP_A_7, K_TEP_A_8, K_TEP_A_9, K_TEP_A_10, K_TEP_A_11,
  K_TEP_B_0, K_TEP_B_1, K_TEP_B_2, K_TEP_B_3, K_TEP_B_4, K_TEP_B_5,
  K_TEP_B_6, K_TEP_B_7, K_TEP_B_8, K_TEP_B_9, K_TEP_B_10, K_TEP_B_11,
  K_TB_A, K_TB_B, K_P12, K_P04, K_SW_LO, K_AZC_LO, K_AZS_LO, K_INV_1000,
  K_TWO_D_PI, K_TWO_SQRT3,
  K_NORM_T, K_NORM_T2, K_INV_NORM_X, K_INV_NORM_V, K_INV_NORM_A, K_THIRD,
  K_TIME_UP_STEPS, K_SUCC_REQ, K_VTIP005, K_ANG60, K_NS_HALF, K_EW_HALF,
  K_INV_XSCALE, K_INV_YSCALE, K_HALF_H, K_HALF_W, K_HM1,
  K_COUNT
};

// Task kinds, the first column of the task table;
// heligym_tpu_torch/ops/cuda/fused_step.py TASK_KINDS lists the same names in
// the same order.
enum TaskKind {
  T_NONE, T_HOVER, T_FORWARD, T_TURNING, T_SLALOM, T_LANDING, T_OBLIQUE,
  T_KIND_COUNT
};

namespace {

constexpr int kTaskStride = 8;
constexpr int kMaxTasks = 8;
constexpr int kTaskIdRow = 61;
constexpr int kStateRows = 61;
constexpr int kSteps = 61;
constexpr int kSucc = 62;
constexpr int kObs0 = 23;
constexpr int kCollectRows = 39;
constexpr int kMaxThreads = 128;

// The parameter block of both kernels, passed by value (708 + 256 bytes of
// tables, well inside the 4 KB of kernel parameters).
struct Params {
  float c[K_COUNT];                        // the constant table
  float tasks[kMaxTasks * kTaskStride];    // the task table, zero-padded
};
struct Args {
  Params p;
  const float* carry_in;
  float* carry_out;
  const float* init;
  const float* act;
  long long act_stride;                    // floats between two steps' actions
  const float* eta;
  const float* texels;
  float* collect;                          // null: nothing collected
  int n, steps, auto_reset, map_h, map_w, n_tasks, select_by_id;
};

struct Heli {
  float vi_mr, vi_tr, psi_mr, psi_tr, b0, b1, u, v, w, p, q, r, phi, theta,
      psi, x, y, z;
};
struct Wind {
  float us, vs0, vs1, ws0, ws1;
};

// NaN-propagating max/min/clip (jnp.maximum / jnp.clip semantics; fmaxf
// would drop a NaN).
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}
__device__ __forceinline__ float clip_nan(float x, float lo, float hi) {
  return min_nan(max_nan(x, lo), hi);
}
__device__ __forceinline__ float sgn(float x) {
  return (float)((x > 0.0f) - (x < 0.0f));
}
__device__ __forceinline__ bool non_finite(const float* C, float x) {
  return (x != x) || (fabsf(x) > C[K_BIG]);
}
// Floored modulo (numpy's %, torch.remainder) of x by a positive b.
__device__ __forceinline__ float pi_bound(const float* C, float x) {
  float m = fmodf(x + C[K_PI], C[K_TWO_PI]);
  if (m != 0.0f && (m < 0.0f) != (C[K_TWO_PI] < 0.0f)) m = m + C[K_TWO_PI];
  return m - C[K_PI];
}

// Terrain height under (x, y) from the packed texel table (ops/terrain.py
// ground_height: clip, then floor; the y-clamp uses the map's row count;
// the interpolation factors use the edge-decremented indices).
__device__ __forceinline__ float ground_height(const float* C,
                                              const float* __restrict__ texels,
                                              int h, int w, float x, float y) {
  float x_loc = x * C[K_INV_XSCALE] + C[K_HALF_H];
  float y_loc = y * C[K_INV_YSCALE] + C[K_HALF_W];
  x_loc = clip_nan(x_loc, 0.0f, C[K_HM1]);
  y_loc = clip_nan(y_loc, 0.0f, C[K_HM1]);
  int xi = (x_loc == x_loc) ? (int)floorf(x_loc) : 0;
  int yi = (y_loc == y_loc) ? (int)floorf(y_loc) : 0;
  const float* t = texels + 3 * ((long long)yi * w + xi);
  float middle = t[0], north = t[1], east = t[2];
  if (xi == h - 1) xi = h - 2;
  if (yi == w - 1) yi = w - 2;
  return middle + (north - middle) * (x_loc - (float)xi) +
         (east - middle) * (y_loc - (float)yi);
}

__device__ __forceinline__ void matvec(const float m[3][3], const float v[3],
                                       float out[3]) {
  for (int i = 0; i < 3; ++i)
    out[i] = m[i][0] * v[0] + m[i][1] * v[1] + m[i][2] * v[2];
}
__device__ __forceinline__ void cross(const float a[3], const float b[3],
                                      float out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// ops/eom.py::heli_dynamics. `obs` is the 17-dim observation.
__device__ __forceinline__ void heli_dynamics(const float* C, const Heli& s,
                                              const float act[4],
                                              const float wind[3], float h_ground,
                                              Heli& d, float obs[17]) {
  // control mapping (eom.py control_inputs)
  const float coll = C[K_D2R] * (C[K_COL_OS] + 0.5f * act[0] * C[K_COL_SPAN] + C[K_COL_MID]);
  const float lon = C[K_D2R] * (0.5f * act[1] * C[K_LON_SPAN] + C[K_LON_MID]);
  const float lat = C[K_D2R] * (0.5f * act[2] * C[K_LAT_SPAN] + C[K_LAT_MID]);
  const float pedal = C[K_D2R] * (C[K_PED_OS] + 0.5f * act[3] * C[K_PED_SPAN] + C[K_PED_MID]);

  // kinematics
  const float s0 = sinf(s.phi), s1 = sinf(s.theta), s2 = sinf(s.psi);
  const float c0 = cosf(s.phi), c1 = cosf(s.theta), c2 = cosf(s.psi);
  const float e2b[3][3] = {
      {c1 * c2, c1 * s2, -s1},
      {s0 * s1 * c2 - c0 * s2, s0 * s1 * s2 + c0 * c2, s0 * c1},
      {c0 * s1 * c2 + s0 * s2, c0 * s1 * s2 - s0 * c2, c0 * c1}};
  const float b2e[3][3] = {{e2b[0][0], e2b[1][0], e2b[2][0]},
                           {e2b[0][1], e2b[1][1], e2b[2][1]},
                           {e2b[0][2], e2b[1][2], e2b[2][2]}};
  const float uvw[3] = {s.u, s.v, s.w};
  const float pqr[3] = {s.p, s.q, s.r};
  const float phi_dot = s.p + (s0 * s1 / c1) * s.q + (c0 * s1 / c1) * s.r;
  const float theta_dot = c0 * s.q + (-s0) * s.r;
  const float psi_dot = (s0 / c1) * s.q + (c0 / c1) * s.r;
  float ned_vel[3], wind_body[3];
  matvec(b2e, uvw, ned_vel);
  matvec(e2b, wind, wind_body);
  const float ua = s.u - wind_body[0], va = s.v - wind_body[1],
              wa = s.w - wind_body[2];

  const float power_climb = C[K_WT] * (-ned_vel[2]);
  // atmosphere
  const float temp = C[K_T0] - C[K_LAPSE] * (-s.z);
  const float rho = C[K_RO_SEA] * powf(temp * C[K_INV_T0], C[K_RHO_EXP]);

  // ---- main rotor (ops/rotor.py main_rotor)
  const float gam = rho * C[K_MR_GAM_OM16_DRO];
  const float kc = C[K_MR_KC_NUM] / gam + C[K_MR_K1];
  const float om_g = C[K_MR_OMEGA] / gam;
  const float itb2_om = C[K_MR_OMEGA] / (1.0f + om_g * om_g);
  const float itb = itb2_om * C[K_MR_OMEGA] / gam;
  const float dl_da1 = rho * C[K_MR_DL_DA1_DRO];
  const float mr_vadv2 = ua * ua + va * va;
  const float wr = wa + (s.b0 - C[K_MR_IS]) * ua - s.b1 * va;
  const float wb = wr + C[K_MR_WB_C1] * (coll + C[K_MR_TW075]) +
                   mr_vadv2 * C[K_MR_INV_VTIP] * (coll + C[K_MR_TW05]);
  const float mr_thrust = (wb - s.vi_mr) * (rho * C[K_MR_COEF_TH]);
  const float mr_wv = wr - s.vi_mr;
  d.vi_mr = C[K_MR_VIDOT_C] *
            (mr_thrust / (C[K_TWO_PI] * rho * C[K_MR_R] * C[K_MR_R]) -
             s.vi_mr * sqrtf(mr_vadv2 + mr_wv * mr_wv));
  const float induced_power = mr_thrust * (s.vi_mr - wr);
  const float profile_power = 0.5f * rho * C[K_MR_FR4] * C[K_MR_VTIP] *
                              (C[K_MR_VTIP2] + 3.0f * mr_vadv2);
  const float power_mr = induced_power + profile_power;
  const float torque = power_mr * C[K_MR_INV_OMEGA];
  float ct = mr_thrust / (rho * C[K_PI] * C[K_MR_R] * C[K_MR_R] * C[K_MR_VTIP] *
                          C[K_MR_VTIP]);
  ct = max_nan(ct, 0.0f);
  const float db1dv = C[K_MR_2_VTIP] * ((8.0f * ct) * C[K_MR_INV_ASIGMA] + sqrtf(0.5f * ct));
  const float da1du = -db1dv;
  const float wake = (fabsf(ua) > C[K_VTRANS]) ? 1.0f : 0.0f;
  const float a_sum = s.b1 - lat + kc * s.b0 + db1dv * va * (1.0f + wake);
  const float b_sum = s.b0 + lon - kc * s.b1 + da1du * ua * (1.0f + 2.0f * wake);
  d.b0 = -itb * b_sum - itb2_om * a_sum - s.q;
  d.b1 = -itb * a_sum + itb2_om * b_sum - s.p;
  d.psi_mr = C[K_MR_OMEGA];
  const float mr_x = -mr_thrust * (s.b0 - C[K_MR_IS]);
  const float mr_y = mr_thrust * s.b1;
  const float mr_z = -mr_thrust;
  const float mr_l = mr_y * C[K_MR_H] + C[K_MR_DL_DB1] * s.b1 +
                     dl_da1 * (s.b0 + lon - C[K_MR_K1] * s.b1);
  const float mr_m = mr_z * C[K_MR_D] - mr_x * C[K_MR_H] + C[K_MR_DL_DB1] * s.b0 +
                     dl_da1 * (-s.b1 + lat - C[K_MR_K1] * s.b0);
  const float mr_n = torque;

  // ---- tail rotor (ops/rotor.py tail_rotor)
  const float wq = wa + s.q * C[K_TR_D];
  const float tr_vadv2 = wq * wq + ua * ua;
  const float vr = -(va - s.r * C[K_TR_D] + s.p * C[K_TR_H]);
  const float vb = vr + C[K_TR_WB_C1] * (pedal + C[K_TR_TW075]) +
                   tr_vadv2 * C[K_TR_INV_VTIP] * (pedal + C[K_TR_TW05]);
  const float tr_thrust = (vb - s.vi_tr) * rho * C[K_TR_COEF_TH];
  const float tr_wv = vr - s.vi_tr;
  d.vi_tr = C[K_TR_VIDOT_C] * (tr_thrust / (C[K_TWO_PI] * rho * C[K_TR_R2]) -
                               s.vi_tr * sqrtf(tr_vadv2 + tr_wv * tr_wv));
  d.vi_tr = d.vi_tr * 0.5f;
  d.psi_tr = C[K_TR_OMEGA];
  const float power_tr = tr_thrust * (s.vi_tr - vr);
  const float tr_y = tr_thrust;
  const float tr_l = tr_y * C[K_TR_H];
  const float tr_n = -tr_y * C[K_TR_D];

  // ---- fuselage (ops/aero.py fuselage)
  float wa_fus = wa - s.vi_mr;
  wa_fus = wa_fus + ((wa_fus > 0.0f) ? C[K_EPS] : 0.0f);
  const float denom = (wa_fus == 0.0f) ? -C[K_EPS] : -wa_fus;
  float d_fw = (ua / denom * C[K_FUS_HARM]) - C[K_FUS_DARM];
  d_fw = d_fw * C[K_FUS_COR];
  const float rho_half = 0.5f * rho;
  const float fus_x = rho_half * C[K_FUS_XUU] * fabsf(ua) * ua;
  const float fus_y = rho_half * C[K_FUS_YVV] * fabsf(va) * va;
  const float fus_z = rho_half * C[K_FUS_ZWW] * fabsf(wa_fus) * wa_fus;
  const float fus_l = fus_y * C[K_FUS_H];
  const float fus_m = fus_z * d_fw - fus_x * C[K_FUS_H];
  const float power_fus = -fus_x * ua - fus_y * va - fus_z * wa_fus;

  // ---- horizontal tail (ops/aero.py horizontal_tail)
  const float v_dw = max_nan(s.vi_mr - wa, C[K_EPS]);
  const float d_dw = (ua / v_dw * C[K_HT_HARM]) - C[K_HT_DARM];
  const float eps_ht = (d_dw > 0.0f && d_dw < C[K_MR_R])
                           ? 2.0f * (1.0f - d_dw * C[K_MR_INV_R]) : 0.0f;
  const float wa_ht = wa - eps_ht * s.vi_mr + C[K_HT_D] * s.q;
  const float vta_ht = sqrtf(ua * ua + va * va + wa_ht * wa_ht);
  const float ht_stall = 0.5f * rho * C[K_HT_ZMAX] * fabsf(vta_ht) * wa_ht;
  const float ht_lin = 0.5f * rho * (C[K_HT_ZUU] * fabsf(ua) * ua +
                                     C[K_HT_ZUW] * fabsf(ua) * wa_ht);
  const float ht_z = (fabsf(wa_ht) > C[K_P3] * fabsf(ua)) ? ht_stall : ht_lin;
  const float ht_m = ht_z * C[K_HT_D];

  // ---- vertical tail (ops/aero.py vertical_tail)
  const float va_vt = va + s.vi_tr - C[K_VT_D] * s.r;
  const float vta_vt = sqrtf(ua * ua + va_vt * va_vt);
  const float vt_stall = 0.5f * rho * C[K_VT_YMAX] * fabsf(vta_vt) * va_vt;
  const float vt_lin = 0.5f * rho * (C[K_VT_YUU] * fabsf(ua) * ua +
                                     C[K_VT_YUV] * fabsf(ua) * va_vt);
  const float vt_y = (fabsf(va_vt) > C[K_P3] * fabsf(ua)) ? vt_stall : vt_lin;
  const float vt_l = vt_y * C[K_VT_H];
  const float vt_n = -vt_y * C[K_VT_D];

  // ---- landing gear (ops/gear.py; moment against the running force total)
  const float touch_alt = h_ground + C[K_WL_CG12];
  float f_lg[3] = {0.0f, 0.0f, 0.0f}, m_lg[3] = {0.0f, 0.0f, 0.0f};
  for (int leg = 0; leg < 3; ++leg) {
    const float pos[3] = {C[K_LG_LOC_00 + 3 * leg], C[K_LG_LOC_00 + 3 * leg + 1],
                          C[K_LG_LOC_00 + 3 * leg + 2]};
    float dd[3], cr[3], dv[3];
    matvec(b2e, pos, dd);
    const float pos_z = s.z + dd[2];
    cross(pqr, pos, cr);
    matvec(b2e, cr, dv);
    const float vel_z = ned_vel[2] + dv[2];
    const bool contact = (-pos_z) - touch_alt < 0.0f;
    const float cxdot = C[K_LG_C] * vel_z;
    const float kx = C[K_LG_K] * (pos_z + h_ground);
    const float f_ned[3] = {0.0f, 0.0f, -(cxdot + kx) + C[K_EPS]};
    float f_body[3], m_leg[3];
    matvec(e2b, f_ned, f_body);
    for (int i = 0; i < 3; ++i) f_lg[i] = f_lg[i] + (contact ? f_body[i] : 0.0f);
    cross(pos, f_lg, m_leg);
    for (int i = 0; i < 3; ++i) m_lg[i] = m_lg[i] + (contact ? m_leg[i] : 0.0f);
  }

  // ---- sums in the reference's order (eom.py; the wing term is absent)
  const float power_extra_mr = power_climb + power_fus;
  const float mr_n_tot = mr_n + power_extra_mr * C[K_MR_INV_OMEGA];
  const float power_total = power_mr + power_tr + power_extra_mr + C[K_HP_LOSS_FT];
  const float wt_vec[3] = {0.0f, 0.0f, C[K_WT]};
  float f_grav[3];
  matvec(e2b, wt_vec, f_grav);
  const float force[3] = {
      mr_x + 0.0f + fus_x + 0.0f + 0.0f + f_grav[0] + f_lg[0],
      mr_y + tr_y + fus_y + 0.0f + vt_y + f_grav[1] + f_lg[1],
      mr_z + 0.0f + fus_z + ht_z + 0.0f + f_grav[2] + f_lg[2]};
  const float moment[3] = {
      mr_l + tr_l + fus_l + 0.0f + vt_l + m_lg[0],
      mr_m + 0.0f + fus_m + ht_m + 0.0f + m_lg[1],
      mr_n_tot + tr_n + 0.0f + 0.0f + vt_n + m_lg[2]};
  float wxv[3], i_pqr[3], wxiw[3], mom[3], pqr_dot[3];
  cross(pqr, uvw, wxv);
  d.u = force[0] * C[K_INV_M] - wxv[0];
  d.v = force[1] * C[K_INV_M] - wxv[1];
  d.w = force[2] * C[K_INV_M] - wxv[2];
  const float inertia[3][3] = {{C[K_I_00], C[K_I_01], C[K_I_02]},
                               {C[K_I_10], C[K_I_11], C[K_I_12]},
                               {C[K_I_20], C[K_I_21], C[K_I_22]}};
  const float iinv[3][3] = {{C[K_IINV_00], C[K_IINV_01], C[K_IINV_02]},
                            {C[K_IINV_10], C[K_IINV_11], C[K_IINV_12]},
                            {C[K_IINV_20], C[K_IINV_21], C[K_IINV_22]}};
  matvec(inertia, pqr, i_pqr);
  cross(pqr, i_pqr, wxiw);
  for (int i = 0; i < 3; ++i) mom[i] = moment[i] - wxiw[i];
  matvec(iinv, mom, pqr_dot);
  d.p = pqr_dot[0];
  d.q = pqr_dot[1];
  d.r = pqr_dot[2];
  d.phi = phi_dot;
  d.theta = theta_dot;
  d.psi = psi_dot;
  d.x = ned_vel[0];
  d.y = ned_vel[1];
  d.z = ned_vel[2];

  obs[0] = power_total * C[K_INV_550];
  obs[1] = ua; obs[2] = va; obs[3] = wa;
  obs[4] = ned_vel[0]; obs[5] = ned_vel[1]; obs[6] = ned_vel[2];
  obs[7] = s.phi; obs[8] = s.theta; obs[9] = s.psi;
  obs[10] = s.p; obs[11] = s.q; obs[12] = s.r;
  obs[13] = s.x; obs[14] = s.y; obs[15] = -s.z;
  obs[16] = -s.z - h_ground;
}

// The TEP table lookup at the static turbulence level (dryden.py
// _tep_lookup_static_row): dynamic column bracket, blend of the two rows.
__device__ __forceinline__ float tep_lookup(const float* C, float col_key) {
  int idx = 1;
  for (int k = 0; k < 12; ++k) idx += (C[K_TEP_KEY_0 + k] < col_key) ? 1 : 0;
  const int c = idx < 2 ? 2 : (idx > 12 ? 12 : idx);
  const float ck0 = C[K_TEP_KEY_0 + c - 1], ck1 = C[K_TEP_KEY_0 + c - 2];
  const float c_factor = clip_nan((col_key - ck1) / (ck0 - ck1), 0.0f, 1.0f);
  const float a0 = C[K_TEP_A_0 + c - 2], a1 = C[K_TEP_A_0 + c - 1];
  const float b0 = C[K_TEP_B_0 + c - 2], b1 = C[K_TEP_B_0 + c - 1];
  const float col1 = C[K_TEP_RF] * (b0 - a0) + a0;
  const float col2 = C[K_TEP_RF] * (b1 - a1) + a1;
  return col1 + c_factor * (col2 - col1);
}

__device__ __forceinline__ void cos_sin_atan2(float y, float x, float& c, float& s) {
  const float r = sqrtf(x * x + y * y);
  const float safe = (r == 0.0f) ? 1.0f : r;
  c = (r == 0.0f) ? 1.0f : x / safe;
  s = (r == 0.0f) ? 0.0f : y / safe;
}

// ops/dryden.py::wind_dynamics. `wa` = (ned_vel_n, ned_vel_e, ned_vel_d, h_gr).
__device__ __forceinline__ void wind_dynamics(const float* C, const Wind& st,
                                              const float wa[4], const float eta[3],
                                              Wind& d, float wind_ned[3]) {
  const float vi_n = wa[0] + C[K_WM0], vi_e = wa[1] + C[K_WM1],
              vi_d = wa[2] + C[K_WM2];
  const float vel_inf = sqrtf(vi_n * vi_n + vi_e * vi_e + vi_d * vi_d);
  const float h = wa[3];
  // turbulence_params
  const float tep = tep_lookup(C, h);
  const float hg_lo = max_nan(h, 10.0f);
  const float base_lo = C[K_TB_A] + C[K_TB_B] * hg_lo;
  const float lu_lo = hg_lo / powf(base_lo, C[K_P12]);
  const float lw_lo = 0.5f * hg_lo;
  const float su_lo = C[K_SW_LO] / powf(base_lo, C[K_P04]);
  float azc_hi, azs_hi, azc_mid, azs_mid;
  cos_sin_atan2(vi_e, vi_n, azc_hi, azs_hi);
  const float r = (h - 1000.0f) * C[K_INV_1000];
  const float lu_mid = 1000.0f + r * 750.0f;
  const float s_mid = C[K_SW_LO] + r * (tep - C[K_SW_LO]);
  cos_sin_atan2(vi_e * r + C[K_WM1] * (1.0f - r), vi_n * r + C[K_WM0] * (1.0f - r),
                azc_mid, azs_mid);
  const bool low = h <= 1000.0f, high = h >= 2000.0f;
  const float lu = low ? lu_lo : (high ? 1750.0f : lu_mid);
  const float lv = 0.5f * lu;
  const float lw = low ? lw_lo : (high ? 875.0f : lu_mid);
  const float su = low ? su_lo : (high ? tep : s_mid);
  const float sv = su;
  const float sw = low ? C[K_SW_LO] : (high ? tep : s_mid);
  const float az_c = low ? C[K_AZC_LO] : (high ? azc_hi : azc_mid);
  const float az_s = low ? C[K_AZS_LO] : (high ? azs_hi : azs_mid);

  const float t_u = lu / (vel_inf + C[K_EPS]);
  const float t_v = lv / (vel_inf + C[K_EPS]);
  const float t_w = lw / (vel_inf + C[K_EPS]);
  d.us = 1.0f / t_u * (eta[0] - st.us);
  d.vs0 = 1.0f / (4.0f * (t_v * t_v)) * (eta[1] - st.vs1) - 1.0f / t_v * st.vs0;
  d.ws0 = 1.0f / (4.0f * (t_w * t_w)) * (eta[2] - st.ws1) - 1.0f / t_w * st.ws0;
  d.vs1 = st.vs0;
  d.ws1 = st.ws0;
  const float k_u = su * sqrtf(C[K_TWO_D_PI] * t_u);
  const float k_v = sv * sqrtf(C[K_TWO_D_PI] * t_v);
  const float k_w = sw * sqrtf(C[K_TWO_D_PI] * t_w);
  const float u_turb = k_u * st.us;
  const float v_turb = k_v * (st.vs1 + C[K_TWO_SQRT3] * st.vs0);
  const float w_turb = k_w * (st.ws1 + C[K_TWO_SQRT3] * st.ws0);
  wind_ned[0] = C[K_WM0] + (az_c * u_turb - az_s * v_turb);
  wind_ned[1] = C[K_WM1] + (az_s * u_turb + az_c * v_turb);
  wind_ned[2] = C[K_WM2] + w_turb;
}

__device__ __forceinline__ Wind wind_add(const Wind& s, const Wind& d, float h) {
  return {s.us + d.us * h, s.vs0 + d.vs0 * h, s.vs1 + d.vs1 * h,
          s.ws0 + d.ws0 * h, s.ws1 + d.ws1 * h};
}

#define HELI_FIELDS(X) X(vi_mr) X(vi_tr) X(psi_mr) X(psi_tr) X(b0) X(b1) X(u) \
  X(v) X(w) X(p) X(q) X(r) X(phi) X(theta) X(psi) X(x) X(y) X(z)

__device__ __forceinline__ Heli heli_add(const Heli& s, const Heli& d, float h) {
  Heli o;
#define ADD(f) o.f = s.f + d.f * h;
  HELI_FIELDS(ADD)
#undef ADD
  return o;
}

__device__ __forceinline__ float k4only(float s, float d, float c) {
  return s + (((d + d * 2.0f) + d * 2.0f) + d) * c;
}

// One tracked quantity of a task reward: quadratic final term, derivative-
// based terminal term, max-combined (envs/tasks.py _tracked).
__device__ __forceinline__ float tracked(float err, float rate, float& fin) {
  fin = -(err * err);
  return max_nan(fin, -(sgn(err) * rate));
}

// envs/tasks.py: the reward and in-tolerance flag of one task from the
// post-step state `s` and the k4 derivatives `d`. `P` is the task's row of
// the task table: kind, then its targets as Task.folded() gives them
//   hover:   north, east, down position over norm.x
//   forward: speed over norm.v, down position over norm.x
//   turning: yaw rate, speed over norm.v, down position over norm.x
//   slalom:  amplitude, 2 pi / wavelength, their f32 product, speed over
//            norm.v, down position over norm.x
//   landing: pad north, pad east, desired sink over norm.v, touch_alt + 5,
//            1 if touch_alt is set
//   oblique: north and east velocity over norm.v, down position over norm.x
// A MixedTask lane evaluates only its own sub-task; the JAX package evaluates
// all of them and selects, which gives the same value per lane.
// `row` points into the parameter block (constant bank).
__device__ __forceinline__ void task_reward(const float* C, const float* row,
                                            const Heli& s, const Heli& d,
                                            float& reward, bool& succ) {
  const float P[6] = {row[0], row[1], row[2], row[3], row[4], row[5]};
  const int kind = (int)P[0];
  if (kind <= T_NONE || kind >= T_KIND_COUNT) {
    reward = 0.0f;
    succ = false;
    return;
  }
  // body rates (every task; turning offsets the yaw rate by its target)
  const float pn = s.p * C[K_NORM_T], qn = s.q * C[K_NORM_T];
  const float rn = (s.r - (kind == T_TURNING ? P[1] : 0.0f)) * C[K_NORM_T];
  const float pdn = d.p * C[K_NORM_T2], qdn = d.q * C[K_NORM_T2],
              rdn = d.r * C[K_NORM_T2];
  const float pqr_final = -((pn * pn + qn * qn) + rn * rn);
  const float pqr_terminal = -((sgn(pn) * pdn + sgn(qn) * qdn) + sgn(rn) * rdn);
  const float pqr_reward = max_nan(pqr_final, pqr_terminal);
  const float zdn = d.z * C[K_INV_NORM_V];

  switch (kind) {
    case T_HOVER: {
      const float en = s.x * C[K_INV_NORM_X] - P[1];
      const float ee = s.y * C[K_INV_NORM_X] - P[2];
      const float ed = s.z * C[K_INV_NORM_X] - P[3];
      const float xyz_final = -((en * en + ee * ee) + ed * ed);
      const float xdn = d.x * C[K_INV_NORM_V], ydn = d.y * C[K_INV_NORM_V];
      const float xyz_terminal = -((sgn(en) * xdn + sgn(ee) * ydn) + sgn(ed) * zdn);
      const float xyz_reward = max_nan(xyz_final, xyz_terminal);
      reward = (pqr_reward + xyz_reward) * 0.5f;
      succ = (pqr_final > -1.0f) && (xyz_final > -1.0f);
      return;
    }
    case T_FORWARD:
    case T_TURNING: {
      const bool turning = kind == T_TURNING;
      const float vel_target = turning ? P[2] : P[1];
      const float dwn_target = turning ? P[3] : P[2];
      const float vel = sqrtf((s.u * s.u + s.v * s.v) + s.w * s.w);
      const float rate = (s.u * d.u + s.v * d.v) + s.w * d.w;
      const float den = turning ? max_nan(vel, 1e-3f) : vel;
      const float veldot = (rate / den) * C[K_INV_NORM_A];
      float vel_final, dwn_final;
      const float vel_reward = tracked(vel * C[K_INV_NORM_V] - vel_target, veldot, vel_final);
      const float dwn_reward = tracked(s.z * C[K_INV_NORM_X] - dwn_target, zdn, dwn_final);
      reward = ((pqr_reward + vel_reward) + dwn_reward) * C[K_THIRD];
      succ = (pqr_final > -1.0f) && (vel_final > -1.0f) && (dwn_final > -1.0f);
      return;
    }
    case T_SLALOM: {
      const float arg = P[2] * s.x;
      const float y_ref = P[1] * sinf(arg);
      const float ydot_ref = P[3] * cosf(arg) * d.x;
      float track_final, vel_final, dwn_final;
      const float track_reward = tracked((s.y - y_ref) * C[K_INV_NORM_X],
                                         (d.y - ydot_ref) * C[K_INV_NORM_V],
                                         track_final);
      const float vel_reward = tracked(d.x * C[K_INV_NORM_V] - P[4],
                                       d.u * C[K_INV_NORM_A], vel_final);
      const float dwn_reward = tracked(s.z * C[K_INV_NORM_X] - P[5], zdn, dwn_final);
      reward = (((pqr_reward + track_reward) + vel_reward) + dwn_reward) * 0.25f;
      succ = (pqr_final > -1.0f) && (track_final > -1.0f) &&
             (vel_final > -1.0f) && (dwn_final > -1.0f);
      return;
    }
    case T_LANDING: {
      const float en = (s.x - P[1]) * C[K_INV_NORM_X];
      const float ee = (s.y - P[2]) * C[K_INV_NORM_X];
      const float pad_final = -(en * en + ee * ee);
      const float pad_terminal = -((sgn(en) * d.x + sgn(ee) * d.y) * C[K_INV_NORM_V]);
      const float pad_reward = max_nan(pad_final, pad_terminal);
      const float sink_err = zdn - P[3];
      const float sink_reward = -(sink_err * sink_err);
      reward = ((pqr_reward + pad_reward) + sink_reward) * C[K_THIRD];
      const float speed2 = (s.u * s.u + s.v * s.v) + s.w * s.w;
      succ = (speed2 < 4.0f) && (fabsf(s.phi) < 0.15f) && (fabsf(s.theta) < 0.15f) &&
             (pad_final > -1.0f);
      if (P[5] != 0.0f) succ = succ && ((-s.z) < P[4]);
      return;
    }
    case T_OBLIQUE: {
      // body-to-earth rows 0 and 1 of the DCM at the post-step angles
      // (ops/kinematics.py euler_to_rotmat, transposed)
      const float s0 = sinf(s.phi), s1 = sinf(s.theta), s2 = sinf(s.psi);
      const float c0 = cosf(s.phi), c1 = cosf(s.theta), c2 = cosf(s.psi);
      const float acc_n = (c1 * c2) * d.u + (s0 * s1 * c2 - c0 * s2) * d.v +
                          (c0 * s1 * c2 + s0 * s2) * d.w;
      const float acc_e = (c1 * s2) * d.u + (s0 * s1 * s2 + c0 * c2) * d.v +
                          (c0 * s1 * s2 - s0 * c2) * d.w;
      const float an = acc_n * C[K_INV_NORM_A], ae = acc_e * C[K_INV_NORM_A];
      const float en = d.x * C[K_INV_NORM_V] - P[1];
      const float ee = d.y * C[K_INV_NORM_V] - P[2];
      const float vel_final = -(en * en + ee * ee);
      const float vel_terminal = -(sgn(en) * an + sgn(ee) * ae);
      const float vel_reward = max_nan(vel_final, vel_terminal);
      float dwn_final;
      const float dwn_reward = tracked(s.z * C[K_INV_NORM_X] - P[3], zdn, dwn_final);
      reward = ((pqr_reward + vel_reward) + dwn_reward) * C[K_THIRD];
      succ = (pqr_final > -1.0f) && (vel_final > -1.0f) && (dwn_final > -1.0f);
      return;
    }
  }
}

// One env transition. `st` holds the env's 61 state rows (rows 0-22 and the
// four obs rows the wind reads are read; all 61 are written), `steps` and
// `succ` its counters; `col` is this env's column of this step's collect
// block, or null. Both kernels run exactly this function.
__device__ __forceinline__ void env_step(const Args& A, int i, int task,
                                         const float a[4], const float e[3],
                                         float st[kStateRows], float& steps,
                                         float& succ, float* col) {
  const float* C = A.p.c;
  const long long B = A.n;
  Heli hs;
  {
    int row = 0;
#define GET(f) hs.f = st[row++];
    HELI_FIELDS(GET)
#undef GET
  }
  const Wind ws = {st[18], st[19], st[20], st[21], st[22]};
  const float wind_act[4] = {st[kObs0 + 4], st[kObs0 + 5], st[kObs0 + 6],
                             st[kObs0 + 16]};

  // ---- Dryden wind RK4 with the aliased k4 (integrator.py rk4_k4only).
  // The four stages run as a loop, so the kernel holds one copy of their
  // code; stage 0 takes the committed state itself.
  Wind k = ws;
  float wind_ned[3];
#pragma unroll 1
  for (int stage = 0; stage < 4; ++stage) {
    const Wind in = stage == 0 ? ws
                               : wind_add(ws, k, stage == 3 ? C[K_DT] : C[K_HALF_DT]);
    wind_dynamics(C, in, wind_act, e, k, wind_ned);
  }
  Wind wn;
  wn.us = k4only(ws.us, k.us, C[K_RK4_C]);
  wn.vs0 = k4only(ws.vs0, k.vs0, C[K_RK4_C]);
  wn.vs1 = k4only(ws.vs1, k.vs1, C[K_RK4_C]);
  wn.ws0 = k4only(ws.ws0, k.ws0, C[K_RK4_C]);
  wn.ws1 = k4only(ws.ws1, k.ws1, C[K_RK4_C]);

  // ---- helicopter RK4 at the committed terrain height (integrator.py rk4)
  const float h_ground = ground_height(C, A.texels, A.map_h, A.map_w, hs.x, hs.y);
  // The stages run as a loop (one copy of heli_dynamics' code); `sum`
  // accumulates ((k1 + 2 k2) + 2 k3) + k4 in the reference's order and
  // `k4` ends as the last stage's derivatives.
  Heli k4 = hs, sum = hs;
  float obs[17];
#pragma unroll 1
  for (int stage = 0; stage < 4; ++stage) {
    const Heli in = stage == 0 ? hs
                               : heli_add(hs, k4, stage == 3 ? C[K_DT] : C[K_HALF_DT]);
    heli_dynamics(C, in, a, wind_ned, h_ground, k4, obs);
#define ACC(f) \
    sum.f = stage == 0 ? k4.f : (stage == 3 ? sum.f + k4.f : sum.f + k4.f * 2.0f);
    HELI_FIELDS(ACC)
#undef ACC
  }
  Heli hn;
#define COMBINE(f) hn.f = hs.f + sum.f * C[K_RK4_C];
  HELI_FIELDS(COMBINE)
#undef COMBINE
  hn.psi_mr = pi_bound(C, hn.psi_mr);
  hn.psi_tr = pi_bound(C, hn.psi_tr);
  hn.b0 = pi_bound(C, hn.b0);
  hn.b1 = pi_bound(C, hn.b1);
  hn.phi = pi_bound(C, hn.phi);
  hn.theta = pi_bound(C, hn.theta);
  hn.psi = pi_bound(C, hn.psi);

  // ---- task reward and in-tolerance flag (envs/tasks.py)
  float reward = 0.0f;
  bool succ_step = false;
  if (task >= 0) {
    task_reward(C, A.p.tasks + kTaskStride * task, hn, k4, reward, succ_step);
  }

  // ---- counters (success counted before this step's flag is added)
  const bool f_succ = succ >= C[K_SUCC_REQ];
  const float steps1 = steps + 1.0f;
  const bool time_up = steps1 >= C[K_TIME_UP_STEPS];
  const float succ1 = succ + (succ_step ? 1.0f : 0.0f);

  // ---- termination at the post-step terrain height (env.py is_failed)
  const float h_post = ground_height(C, A.texels, A.map_h, A.map_w, hn.x, hn.y);
  const float touch = h_post + C[K_WL_CG12];
  const bool cond1 = (-hn.z) - touch < 0.0f;
  const bool cond234 = (k4.z > C[K_VTIP005]) || (hn.phi > C[K_ANG60]) ||
                       (hn.theta > C[K_ANG60]);
  const bool cond5 = (fabsf(hn.x) > C[K_NS_HALF]) || (fabsf(hn.y) > C[K_EW_HALF]) ||
                     ((-hn.z) > touch + 10000.0f);
  const bool bad = non_finite(C, reward) || non_finite(C, hn.z) || non_finite(C, hn.u);
  const bool failed = (cond1 && cond234) || cond5 || bad;
  const bool done = failed || f_succ;
  const bool ended = A.auto_reset && (done || time_up);

  // ---- new state rows, then the auto-reset select
  {
    int row = 0;
#define PUT(f) st[row++] = hn.f;
    HELI_FIELDS(PUT)
#undef PUT
    st[18] = wn.us; st[19] = wn.vs0; st[20] = wn.vs1; st[21] = wn.ws0; st[22] = wn.ws1;
    for (int j = 0; j < 17; ++j) st[kObs0 + j] = obs[j];
    row = 40;
#define PUTD(f) st[row++] = k4.f;
    HELI_FIELDS(PUTD)
#undef PUTD
    st[58] = wind_ned[0]; st[59] = wind_ned[1]; st[60] = wind_ned[2];
  }
  if (ended) {
    for (int j = 0; j < kStateRows; ++j) st[j] = A.init[j * B + i];
  }
  if (col != nullptr) {
    col[0 * B] = reward;
    col[1 * B] = done ? 1.0f : 0.0f;
    col[2 * B] = time_up ? 1.0f : 0.0f;
    col[3 * B] = failed ? 1.0f : 0.0f;
    for (int j = 0; j < 17; ++j) col[(4 + j) * B] = st[kObs0 + j];
    col[21 * B] = succ_step ? 1.0f : 0.0f;
    for (int j = 0; j < 17; ++j) col[(22 + j) * B] = obs[j];
  }
  steps = ended ? 0.0f : steps1;
  succ = ended ? 0.0f : succ1;
}

// One thread per env: load its carry, run `n_steps` (>= 1) transitions with
// the state in registers, store the carry.
__device__ __forceinline__ void run(const Args& A, int n_steps) {
  const long long env = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= A.n) return;
  const int i = (int)env;
  const long long B = A.n;

  // ---- this env's task (fixed for the launch)
  int task = 0;
  if (A.select_by_id) {
    const float tid_f = A.init[kTaskIdRow * B + i];
    task = (tid_f >= 0.0f && tid_f < (float)A.n_tasks) ? (int)tid_f : -1;
  }

  // ---- load the committed state: the rows a step reads; the first step
  // writes every row
  float st[kStateRows];
  for (int j = 0; j < 23; ++j) st[j] = A.carry_in[j * B + i];
  st[kObs0 + 4] = A.carry_in[(kObs0 + 4) * B + i];
  st[kObs0 + 5] = A.carry_in[(kObs0 + 5) * B + i];
  st[kObs0 + 6] = A.carry_in[(kObs0 + 6) * B + i];
  st[kObs0 + 16] = A.carry_in[(kObs0 + 16) * B + i];
  float steps = A.carry_in[kSteps * B + i];
  float succ = A.carry_in[kSucc * B + i];

  int t = 0;
  do {
    const float* act = A.act + t * A.act_stride + 4 * (long long)i;
    const float a[4] = {act[0], act[1], act[2], act[3]};
    const float* eta = A.eta + (long long)t * 3 * B + i;
    const float e[3] = {eta[0], eta[B], eta[2 * B]};
    float* col = A.collect != nullptr
                     ? A.collect + (long long)t * kCollectRows * B + i : nullptr;
    env_step(A, i, task, a, e, st, steps, succ, col);
  } while (++t < n_steps);

  for (int j = 0; j < kStateRows; ++j) A.carry_out[j * B + i] = st[j];
  A.carry_out[kSteps * B + i] = steps;
  A.carry_out[kSucc * B + i] = succ;
}

__global__ void __launch_bounds__(kMaxThreads)
fused_step_kernel(const __grid_constant__ Args A) {
  run(A, 1);
}

__global__ void __launch_bounds__(kMaxThreads)
fused_rollout_kernel(const __grid_constant__ Args A) {
  run(A, A.steps);
}

int launch(Args& a, const float* consts, const float* tasks, int block,
           bool one_step, void* stream) {
  if (a.n < 1 || a.steps < 1 || a.n_tasks < 1 || a.n_tasks > kMaxTasks ||
      (block != 32 && block != 64 && block != 128))
    return (int)cudaErrorInvalidValue;
  memcpy(a.p.c, consts, sizeof(a.p.c));
  memset(a.p.tasks, 0, sizeof(a.p.tasks));
  memcpy(a.p.tasks, tasks, sizeof(float) * kTaskStride * a.n_tasks);
  const unsigned grid = (unsigned)((a.n + block - 1) / block);
  cudaStream_t s = (cudaStream_t)stream;
  if (one_step) fused_step_kernel<<<grid, block, 0, s>>>(a);
  else fused_rollout_kernel<<<grid, block, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes). `consts` (K_COUNT floats) and `tasks`
// (n_tasks x kTaskStride floats) are HOST pointers: their values travel in
// the launch's parameter block. `carry_out` may alias `carry_in`: each env's
// column is read before it is written. `collect` may be null. `block` is
// the block size: 32, 64 or 128 threads. Each returns the cudaError_t of its launch (cudaErrorInvalidValue for
// arguments it does not take).

// One transition: act (B, 4), eta (3, B), collect (39, B).
extern "C" int heligym_fused_step(const float* carry_in, float* carry_out,
                                  const float* init, const float* act,
                                  const float* eta, const float* texels,
                                  const float* consts, const float* tasks,
                                  float* collect, int num_envs, int auto_reset,
                                  int map_h, int map_w, int n_tasks,
                                  int select_by_id, int block, void* stream) {
  Args a;
  a.carry_in = carry_in; a.carry_out = carry_out; a.init = init; a.act = act;
  a.act_stride = 0; a.eta = eta; a.texels = texels; a.collect = collect;
  a.n = num_envs; a.steps = 1; a.auto_reset = auto_reset; a.map_h = map_h;
  a.map_w = map_w; a.n_tasks = n_tasks; a.select_by_id = select_by_id;
  return launch(a, consts, tasks, block, true, stream);
}

// `steps` transitions in one launch: act (steps, B, 4) with act_stride 4 B,
// or one (B, 4) held with act_stride 0; eta (steps, 3, B); collect
// (steps, 39, B).
extern "C" int heligym_fused_rollout(const float* carry_in, float* carry_out,
                                     const float* init, const float* act,
                                     long long act_stride, const float* eta,
                                     const float* texels, const float* consts,
                                     const float* tasks, float* collect,
                                     int num_envs, int steps, int auto_reset,
                                     int map_h, int map_w, int n_tasks,
                                     int select_by_id, int block,
                                     void* stream) {
  Args a;
  a.carry_in = carry_in; a.carry_out = carry_out; a.init = init; a.act = act;
  a.act_stride = act_stride; a.eta = eta; a.texels = texels; a.collect = collect;
  a.n = num_envs; a.steps = steps; a.auto_reset = auto_reset; a.map_h = map_h;
  a.map_w = map_w; a.n_tasks = n_tasks; a.select_by_id = select_by_id;
  return launch(a, consts, tasks, block, false, stream);
}

extern "C" int heligym_fused_step_const_count() { return K_COUNT; }
extern "C" int heligym_fused_step_task_kind_count() { return T_KIND_COUNT; }
extern "C" int heligym_fused_step_task_stride() { return kTaskStride; }
extern "C" int heligym_fused_step_max_tasks() { return kMaxTasks; }
extern "C" int heligym_fused_step_param_bytes() { return (int)sizeof(Params); }
