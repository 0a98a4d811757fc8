// K7x ffd_card_scan: the column-sharded FFD scan of one problem across the
// cards of one host, one rank a card.
//
// Replaces, as K7 (ffd_sharded_scan.cu) does on one card,
// karpenter_tpu/solver/ffd.py:1372 `_solve_ffd_resident_impl` and :1446
// `_solve_ffd_delta_resident_impl` under `shard_map`
// (karpenter_tpu/parallel/mesh.py:92, :110, :203, :235) — the reference's
// multi-device path, its column axes O and PT split over the devices of a
// mesh.  It computes exactly what K7 computes, and rank r plays block r's
// part: rank r's thread block runs on card r, reads only card r's shard of
// the catalog, of the resident mask table and of the seed's column words,
// and keeps its own replica of the group-scan carry there; rank 0 writes
// the caller's flat row and pool budgets, the others a scratch replica on
// their own cards.  The reference's collectives (max, shard 0's leading
// block, an integer sum) are exchanges between the ranks' kernels over
// NVLink, inside the scan (ffd_xcard.cuh holds the protocol): plain stores
// into every peer's inbox, a system-scope release of a 64-bit sequence
// number, acquire spins on the rank's own card, a bounded wait that traps.
// Max and integer sums are exact in any order, so the result equals the
// plain version bit for bit.  (NCCL outside the kernel would cut the
// G-step scan into G launches with host-issued collectives between them:
// the shape the reference records as ~100x slower,
// karpenter_tpu/parallel/mesh.py:9-12.)
//
// These are the `scan_kernel<TOPO, false, GANG, SEED, XCARD>` instances
// of ffd_scan_common.cuh: one scan body, the transport chosen at compile
// time.  The same instances also launch as one cooperative grid of S
// blocks on one card (`rehearse`), each block a rank and every inbox in
// that card's memory, with K7's stacked [S, ...] layout: a check of the
// exchange code on one card, never a path of the solver.  What bounds it
// on the H100: latency, as K7 — a chain of G steps with block barriers
// inside each, now with one or two exchange round trips over NVLink per
// step besides; the catalog work per card shrinks by S.
#include "ffd_scan_common.cuh"

#define CARD_NPTRS (SCAN_NPTRS + 2 * XMAXR)
#define CARD_NDIMS (SCAN_NDIMS + 4)

// the runtime's current device set to `device` for a scope (the caller
// also makes it current on its side; this keeps the launch right either
// way)
struct DeviceScope {
  int prev = -1;
  cudaError_t err;
  explicit DeviceScope(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// Plain-C entry point body.  ptrs: SCAN_NPTRS device addresses in
// scan_parse's order (K7's, with mask_bits this rank's mask table [C, W],
// mask_rows the [G] row ids, xslot this rank's [N*ZC + 4G] scratch, row0
// this rank's flat row, xrow 0 — in the rehearsal K7's stacked layout
// and its xrow), then XMAXR inbox addresses ([S][2][XCH] ints on rank r's
// card) and XMAXR flag addresses ([S] u64 on rank r's card, zeroed once
// when allocated, never again), 0 past S.  dims: SCAN_NDIMS (O, PT and W
// one shard's, S the ranks), then rank, launch (the host's counter, >= 1,
// one per launch, never reused with the same inboxes), rehearse (0: this
// rank's block on this card; 1: a cooperative grid of S blocks on one
// card, rank 0 given) and the device.  Returns 0, a CUDA error code
// (cudaGetLastError after the launch, or the cooperative launch's
// refusal), or a negative argument error.  Does not synchronise.
template <bool TOPO, bool GANG, bool SEED>
int card_entry(const unsigned long long* ptrs, int nptrs, const int* dims,
               int ndims, void* stream) {
  if (nptrs != CARD_NPTRS || ndims != CARD_NDIMS) return -1;
  ScanArgs a = {};
  scan_parse(ptrs, dims, a);
  int rc = scan_check<TOPO, false, GANG, SEED, XCARD>(a);
  if (rc != 0) return rc;
  const int rank = dims[SCAN_NDIMS], launch = dims[SCAN_NDIMS + 1];
  const int rehearse = dims[SCAN_NDIMS + 2], device = dims[SCAN_NDIMS + 3];
  if (a.S > XMAXR || launch < 1 || (rehearse != 0 && rehearse != 1) ||
      device < 0)
    return -2;
  if (rehearse ? (rank != 0 || (a.S > 1 && !a.xrow))
               : (rank < 0 || rank >= a.S || a.xrow))
    return -2;
  a.xc.rank = rank;
  a.xc.S = a.S;
  a.xc.launch = (unsigned)launch;
  for (int r = 0; r < XMAXR; ++r) {
    a.xc.inbox[r] = (int*)ptrs[SCAN_NPTRS + r];
    a.xc.flags[r] = (unsigned long long*)ptrs[SCAN_NPTRS + XMAXR + r];
    if ((r < a.S) != (a.xc.inbox[r] && a.xc.flags[r])) return -2;
  }
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  auto kern = scan_kernel<TOPO, false, GANG, SEED, XCARD>;
  const size_t smem = scan_smem<TOPO, false>(a);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) {
    if (rehearse) {
      void* args[] = {&a};
      err = cudaLaunchCooperativeKernel((void*)kern, dim3(a.S), dim3(NT),
                                        args, smem, (cudaStream_t)stream);
    } else {
      kern<<<1, NT, smem, (cudaStream_t)stream>>>(a);
    }
  }
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// light and heavy steps (the reference's resident program, with_gang 0)
extern "C" int ffd_card_scan(const unsigned long long* ptrs, int nptrs,
                             const int* dims, int ndims, void* stream) {
  return card_entry<true, false, false>(ptrs, nptrs, dims, ndims, stream);
}

// with the gang fill (with_gang 1)
extern "C" int ffd_card_gang_scan(const unsigned long long* ptrs, int nptrs,
                                  const int* dims, int ndims, void* stream) {
  return card_entry<true, true, false>(ptrs, nptrs, dims, ndims, stream);
}

// the seeded instance (the delta resident program: light only, from the
// seed arrays; seed_colmask is this rank's [A, W] words)
extern "C" int ffd_card_delta_scan(const unsigned long long* ptrs, int nptrs,
                                   const int* dims, int ndims,
                                   void* stream) {
  return card_entry<false, false, true>(ptrs, nptrs, dims, ndims, stream);
}

template <bool TOPO, bool GANG, bool SEED>
int card_occupancy(const ScanArgs& a) {
  auto kern = scan_kernel<TOPO, false, GANG, SEED, XCARD>;
  const size_t smem = scan_smem<TOPO, false>(a);
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT,
                                                        smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return err == cudaSuccess ? per_sm * sms : -1000 - (int)err;
}

// How many blocks of one launch's shape the card `dims[SCAN_NDIMS]` holds
// at once (blocks an SM x SMs; 0 = a rank's block does not fit): `dims` as
// the entry points take them (only N, PT, ZC, P, D, W and S matter) and
// the device, `ptrs` unused, and in the stream's place the instance (0
// ffd_card_scan, 1 the gang instance, 2 the seeded one).  Returns the
// count (>= 0), -2 for dims out of range, or -1000 - a CUDA error code.
// Launches nothing.
extern "C" int ffd_card_occupancy(const unsigned long long* ptrs, int nptrs,
                                  const int* dims, int ndims,
                                  void* variant) {
  (void)ptrs;
  (void)nptrs;
  if (ndims != SCAN_NDIMS + 1) return -2;
  ScanArgs a = {};
  a.N = dims[2];
  a.PT = dims[4];
  a.ZC = dims[5];
  a.P = dims[6];
  a.D = dims[7];
  a.W = dims[8];
  a.S = dims[15];
  const int device = dims[SCAN_NDIMS];
  if (a.N < 1 || a.PT < 0 || a.ZC < 1 || a.ZC > MAXZC || a.P < 1 ||
      a.P > MAXP || a.D < 1 || a.W < 0 || a.S < 1 || a.S > XMAXR ||
      device < 0)
    return -2;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return -1000 - (int)scope.err;
  switch ((int)(size_t)variant) {
    case 0: return card_occupancy<true, false, false>(a);
    case 1: return card_occupancy<true, true, false>(a);
    case 2: return card_occupancy<false, false, true>(a);
    default: return -2;
  }
}

// Peer access for every ordered pair of the cards `dims` (device ids,
// ndims of them): cudaDeviceEnablePeerAccess on each, an access already
// on counting as success.  Returns 0 or the first CUDA error (a pair the
// hardware cannot join: cudaErrorPeerAccessUnsupported).  `ptrs` and
// `stream` unused.
extern "C" int ffd_card_peer(const unsigned long long* ptrs, int nptrs,
                             const int* dims, int ndims, void* stream) {
  (void)ptrs;
  (void)nptrs;
  (void)stream;
  if (ndims < 1 || ndims > XMAXR) return -2;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  for (int i = 0; err == cudaSuccess && i < ndims; ++i) {
    err = cudaSetDevice(dims[i]);
    for (int j = 0; err == cudaSuccess && j < ndims; ++j) {
      if (dims[j] == dims[i]) continue;
      err = cudaDeviceEnablePeerAccess(dims[j], 0);
      if (err == cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();  // clear it: already on is what we want
        err = cudaSuccess;
      }
    }
  }
  cudaSetDevice(prev);
  return (int)err;
}
