// C entry points of the fused whole-IPM solve K3 (the kernel and its
// design notes are in ipm_lanes.cuh; the instances, one per structure of
// NMPC_K3_STRUCTURES and type, are compiled in
// ipm_lanes_<structure>_{float,double}.cu).

#include "ipm_lanes.cuh"

namespace {

using nmpc::ipm::FusedArgs;
using nmpc::ipm::kMaxIdx;
using nmpc::ipm::launch;
using nmpc::ipm::scratch_per_stage;

// the structure (nx, nu, nbu, nbx, nHh, nS) of an instance
struct Structure {
  int nx, nu, nbu, nbx, nhh, ns;
};

template <int NX, int NU, int NBU, int NBX, int NHH, int NS>
bool is(const Structure& s) {
  return s.nx == NX && s.nu == NU && s.nbu == NBU && s.nbx == NBX &&
         s.nhh == NHH && s.ns == NS;
}

template <int NX, int NU, int NBU, int NBX, int NHH, int NS>
long long scratch_of(int N) {
  return static_cast<long long>(N) * scratch_per_stage<NX, NU>();
}

bool known(const Structure& s) {
#define NMPC_K3_KNOWN(S) \
  if (is<S>(s)) return true;
  NMPC_K3_STRUCTURES(NMPC_K3_KNOWN)
#undef NMPC_K3_KNOWN
  return false;
}

template <typename T>
int run(const Structure& st, int N, int L, int iters, double tau,
        double sigma, double mu0, const int* idxbu, int nbu,
        const int* idxbx, int nbx, void* const* ptrs, cudaStream_t stream) {
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
#define NMPC_K3_RUN(S) \
  if (is<S>(st)) return launch<T, S>(a, stream);
  NMPC_K3_STRUCTURES(NMPC_K3_RUN)
#undef NMPC_K3_RUN
  return -1;
}

}  // namespace

// Scratch values per lane of the instance for this structure and horizon
// (cb, K, k of every stage; the wrapper allocates slots * L values), or -1
// if there is none.
extern "C" long long nmpc_fused_ipm_scratch(int nx, int nu, int nbu, int nbx,
                                            int nhh, int ns, int N) {
  const Structure st{nx, nu, nbu, nbx, nhh, ns};
#define NMPC_K3_SCRATCH(S) \
  if (is<S>(st)) return scratch_of<S>(N);
  NMPC_K3_STRUCTURES(NMPC_K3_SCRATCH)
#undef NMPC_K3_SCRATCH
  return -1;
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
  const Structure st{nx, nu, nbu, nbx, nhh, ns};
  if (!known(st)) return -1;
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
