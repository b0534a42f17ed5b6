// C entry points of the fused whole-IPM solve K3 (the kernel and its
// design notes are in ipm_lanes.cuh; the instances are compiled in
// ipm_lanes_{flagship,hull,pf,low_level,acados}_{float,double}.cu).

#include "ipm_lanes.cuh"

namespace {

using nmpc::ipm::FusedArgs;
using nmpc::ipm::kMaxIdx;
using nmpc::ipm::launch;
using nmpc::ipm::scratch_per_stage;

// the instantiated structures: the flagship usv_guidance_ca1, the hull
// usv_pf_ca, and the hull family's models with no h rows: usv_pf,
// usv_low_level with usv_position_control, usv_acados
enum class Structure { kNone, kFlagship, kHull, kPf, kLowLevel, kAcados };

Structure structure_of(int nx, int nu, int nbu, int nbx, int nhh, int ns) {
  if (nx == 8 && nu == 1 && nbu == 1 && nbx == 0 && nhh == 0 && ns == 8)
    return Structure::kFlagship;
  if (nu != 2 || nbu != 2 || nbx != 5) return Structure::kNone;
  if (nx == 14 && nhh == 4 && ns == 0) return Structure::kHull;
  if (nhh != 0 || ns != 0) return Structure::kNone;
  if (nx == 14) return Structure::kPf;
  if (nx == 8) return Structure::kLowLevel;
  if (nx == 5) return Structure::kAcados;
  return Structure::kNone;
}

template <typename T>
int run(Structure st, int N, int L, int iters, double tau, double sigma,
        double mu0, const int* idxbu, int nbu, const int* idxbx, int nbx,
        void* const* ptrs, cudaStream_t stream) {
  FusedArgs<T> a;
  const T* const* in = reinterpret_cast<const T* const*>(ptrs);
  a.A = in[0]; a.B = in[1]; a.c = in[2]; a.qx = in[3]; a.qu = in[4];
  a.dx0 = in[5]; a.ub_lo = in[6]; a.ub_hi = in[7]; a.xb_lo = in[8];
  a.xb_hi = in[9]; a.Ch = in[10]; a.hh_lo = in[11]; a.hh_hi = in[12];
  a.Cs = in[13]; a.hofs = in[14]; a.slh = in[15]; a.suh = in[16];
  a.Qc = in[17]; a.QN = in[18]; a.Sc = in[19]; a.Rc = in[20];
  a.zl = in[21]; a.Zl = in[22]; a.zu = in[23]; a.Zu = in[24];
  a.lsh = in[25]; a.ush = in[26];
  T* const* out = reinterpret_cast<T* const*>(ptrs);
  a.dx = out[27]; a.du = out[28]; a.gap_o = out[29]; a.eq_o = out[30];
  a.scratch = out[31];
  for (int j = 0; j < kMaxIdx; ++j) {
    a.idxbu[j] = j < nbu ? idxbu[j] : 0;
    a.idxbx[j] = j < nbx ? idxbx[j] : 0;
  }
  a.N = N;
  a.L = L;
  a.iters = iters;
  a.tau = static_cast<T>(tau);
  a.sigma = static_cast<T>(sigma);
  a.mu0 = static_cast<T>(mu0);
  a.gap_floor = static_cast<T>(sizeof(T) == 8 ? 1e-13 : 3e-7);
  switch (st) {
    case Structure::kFlagship:
      return launch<T, NMPC_FLAGSHIP>(a, stream);
    case Structure::kHull:
      return launch<T, NMPC_HULL>(a, stream);
    case Structure::kPf:
      return launch<T, NMPC_PF>(a, stream);
    case Structure::kLowLevel:
      return launch<T, NMPC_LOW_LEVEL>(a, stream);
    default:
      return launch<T, NMPC_ACADOS>(a, stream);
  }
}

}  // namespace

// Scratch values per lane of the instance for this structure and horizon
// (cb, K, k of every stage; the wrapper allocates slots * L values), or -1
// if there is none.
extern "C" long long nmpc_fused_ipm_scratch(int nx, int nu, int nbu, int nbx,
                                            int nhh, int ns, int N) {
  switch (structure_of(nx, nu, nbu, nbx, nhh, ns)) {
    case Structure::kFlagship:
      return static_cast<long long>(N) * scratch_per_stage<8, 1>();
    case Structure::kHull:
    case Structure::kPf:
      return static_cast<long long>(N) * scratch_per_stage<14, 2>();
    case Structure::kLowLevel:
      return static_cast<long long>(N) * scratch_per_stage<8, 2>();
    case Structure::kAcados:
      return static_cast<long long>(N) * scratch_per_stage<5, 2>();
    default:
      return -1;
  }
}

// ptrs: the 32 device pointers in FusedArgs order (A, B, c, qx, qu, dx0,
// ub_lo, ub_hi, xb_lo, xb_hi, Ch, hh_lo, hh_hi, Cs, hofs, slh, suh, Qc, QN,
// Sc, Rc, zl, Zl, zu, Zu, lsh, ush, dx, du, gap, eq_res, scratch).
// idxbu / idxbx: host arrays of nbu / nbx indices.  Returns
// cudaGetLastError() after the launch (0 = success, or the error of
// raising the kernel's shared-memory limit), -1 for a structure with no
// instance, -2 for an empty problem or an index out of range, -3 for a
// horizon whose per-lane state does not fit a block's shared memory.
extern "C" int nmpc_fused_ipm_lanes(int is_double, int nx, int nu, int nbu,
                                    int nbx, int nhh, int ns, int N, int L,
                                    int iters, double tau, double sigma,
                                    double mu0, const int* idxbu,
                                    const int* idxbx, void* const* ptrs,
                                    void* stream) {
  const Structure st = structure_of(nx, nu, nbu, nbx, nhh, ns);
  if (st == Structure::kNone) return -1;
  if (N < 1 || L < 1 || iters < 0 || nbu > kMaxIdx || nbx > kMaxIdx)
    return -2;
  for (int j = 0; j < nbu; ++j)
    if (idxbu[j] < 0 || idxbu[j] >= nu) return -2;
  for (int j = 0; j < nbx; ++j)
    if (idxbx[j] < 0 || idxbx[j] >= nx) return -2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return run<double>(st, N, L, iters, tau, sigma, mu0, idxbu, nbu, idxbx,
                       nbx, ptrs, s);
  return run<float>(st, N, L, iters, tau, sigma, mu0, idxbu, nbu, idxbx, nbx,
                    ptrs, s);
}
