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
// their own cards.  The reference's collectives (max, an integer sum) are
// exchanges between the ranks' kernels over NVLink, inside the scan
// (ffd_xcard.cuh holds the protocol): each value one 64-bit word, tagged
// with its round, stored into every peer's inbox; each rank polls its own
// inbox until the tags are the round's; a bounded wait that traps.  Its
// all_gather of shard 0's leading block of grid-slot domains is a copy
// each card holds beside its catalog shard.  Max and integer sums are
// exact in any order, so the result equals the plain version bit for bit.
// (NCCL outside the kernel would cut the G-step scan into G launches with
// host-issued collectives between them: the shape the reference records
// as ~100x slower, karpenter_tpu/parallel/mesh.py:9-12.)
//
// These are the `scan_kernel<TOPO, false, GANG, SEED, XCARD>` instances
// of ffd_scan_common.cuh: one scan body, the transport chosen at compile
// time.  A launch across cards is one call, `ffd_card_launch`: for every
// rank it orders the rank's stream after the last launch and card 0's
// upload, copies card 0's problem rows to the rank's replica over NVLink
// and launches the rank's block, then ties every card back into card 0's
// stream.  The same instances also launch as one cooperative grid of S
// blocks on one card (`rehearse`), each block a rank and every inbox in
// that card's memory, with K7's stacked [S, ...] layout: a check of the
// exchange code on one card, never a path of the solver.  What bounds it
// on the H100: latency, as K7 — a chain of G steps with block barriers
// inside each, now with one or two exchange round trips over NVLink per
// step besides; the catalog work per card shrinks by S.
#include "ffd_scan_common.cuh"

#define CARD_NPTRS (SCAN_NPTRS + XMAXR + 1)
#define CARD_NDIMS (SCAN_NDIMS + 3)
// ffd_card_launch's arguments: two header pointers and three header dims,
// then for each rank three pointers and its CARD_NPTRS, and its
// CARD_NDIMS
#define LAUNCH_RANK_PTRS (3 + CARD_NPTRS)

// the runtime's current device set to `device` for a scope
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

// Plain-C entry point body: one rank's launch.  ptrs: SCAN_NPTRS device
// addresses in scan_parse's order (K7's, with mask_bits this rank's mask
// table [C, W], mask_rows the [G] row ids, xslot this rank's [N*ZC + 4G]
// scratch, row0 this rank's flat row, xrow 0 — in the rehearsal K7's
// stacked layout and its xrow), then XMAXR inbox addresses ([S][2][XCH]
// 64-bit words and the round count, zeroed when allocated, on rank r's
// card; 0 past S) and this card's copy of shard 0's leading grid-slot ids
// ([2 ZC] int; 0 in the rehearsal).  dims: SCAN_NDIMS (O, PT and W one
// shard's, S the ranks), then rank, rehearse (0: this rank's block on
// this card; 1: a cooperative grid of S blocks on one card, rank 0 given)
// and the device.  Returns 0, a CUDA error code (cudaGetLastError after
// the launch, or the cooperative launch's refusal), or a negative
// argument error.  Does not synchronise.
template <bool TOPO, bool GANG, bool SEED>
int card_entry(const unsigned long long* ptrs, int nptrs, const int* dims,
               int ndims, void* stream) {
  if (nptrs != CARD_NPTRS || ndims != CARD_NDIMS) return -1;
  ScanArgs a = {};
  scan_parse(ptrs, dims, a);
  int rc = scan_check<TOPO, false, GANG, SEED, XCARD>(a);
  if (rc != 0) return rc;
  const int rank = dims[SCAN_NDIMS], rehearse = dims[SCAN_NDIMS + 1];
  const int device = dims[SCAN_NDIMS + 2];
  if (a.S > XMAXR || (rehearse != 0 && rehearse != 1) || device < 0)
    return -2;
  if (rehearse ? (rank != 0 || (a.S > 1 && !a.xrow))
               : (rank < 0 || rank >= a.S || a.xrow))
    return -2;
  a.xc.rank = rank;
  a.xc.S = a.S;
  for (int r = 0; r < XMAXR; ++r) {
    a.xc.inbox[r] = (unsigned long long*)ptrs[SCAN_NPTRS + r];
    if ((r < a.S) != (a.xc.inbox[r] != nullptr)) return -2;
  }
  a.slot_ids = (const int*)ptrs[SCAN_NPTRS + XMAXR];
  if ((a.slot_ids == nullptr) != (rehearse == 1)) return -2;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  auto kern = scan_instance<TOPO, false, GANG, SEED, XCARD>(a);
  const size_t smem = scan_smem<TOPO, false>(a);
  cudaError_t err = allow_smem((const void*)kern, smem);
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

typedef int (*CardEntry)(const unsigned long long*, int, const int*, int,
                         void*);

// One launch of K7x across S cards, every rank, in one call.  ptrs: the
// upload buffer's address on card 0 (where the problem rows begin), the
// "ready" event (card 0's), then for each rank r: its stream, its "done"
// event, its replica of the upload buffer (0 for rank 0), and its
// CARD_NPTRS (card_entry's; its problem rows inside its replica).  dims:
// S, the instance (0 ffd_card_scan, 1 the gang instance, 2 the seeded
// one), the upload's bytes, then each rank's CARD_NDIMS (rank r, not
// rehearsed, its device).  In order:
//   * card 0's stream waits on every card's "done" event of the last
//     launch, copies the upload buffer (this launch's, uploaded before
//     on that stream) into every other rank's replica
//     (cudaMemcpyPeerAsync) and records "ready": every copy is queued
//     before any rank's block, so none waits behind a rank that spins;
//   * every other rank's stream waits on "ready";
//   * every rank launches its block on its stream (every rank before
//     anything waits: each spins on its peers from its first round);
//   * each card records its "done" event, and card 0's stream waits on
//     the others', so what follows on card 0 (pulling rank 0's flat row,
//     the next upload) follows every rank.
// Returns 0, the first CUDA error or card_entry's code.  `stream` unused.
extern "C" int ffd_card_launch(const unsigned long long* ptrs, int nptrs,
                               const int* dims, int ndims, void* stream) {
  (void)stream;
  if (ndims < 3) return -1;
  const int S = dims[0], inst = dims[1], bytes = dims[2];
  if (S < 1 || S > XMAXR || inst < 0 || inst > 2 || bytes < 0) return -2;
  if (nptrs != 2 + S * LAUNCH_RANK_PTRS || ndims != 3 + S * CARD_NDIMS)
    return -1;
  CardEntry entry = &card_entry<false, false, true>;
  if (inst == 0) entry = &card_entry<true, false, false>;
  if (inst == 1) entry = &card_entry<true, true, false>;
  const auto rp = [&](int r) { return ptrs + 2 + r * LAUNCH_RANK_PTRS; };
  const auto rd = [&](int r) { return dims + 3 + r * CARD_NDIMS; };
  const auto dev = [&](int r) { return rd(r)[SCAN_NDIMS + 2]; };
  const auto st = [&](int r) { return (cudaStream_t)rp(r)[0]; };
  const auto done = [&](int r) { return (cudaEvent_t)rp(r)[1]; };
  const cudaEvent_t ready = (cudaEvent_t)ptrs[1];
  cudaError_t err;
  {
    // every copy on card 0's stream, before any rank's block: a peer copy
    // on card r's legacy default stream (PyTorch's default stream) waits
    // behind the work of card 0's blocking streams, where rank 0 spins,
    // so a copy on the rank's own stream would never run (peer_order.py)
    DeviceScope on(dev(0));
    err = on.err;
    for (int q = 0; err == cudaSuccess && q < S; ++q)
      err = cudaStreamWaitEvent(st(0), done(q), 0);
    for (int r = 1; err == cudaSuccess && bytes > 0 && r < S; ++r)
      err = cudaMemcpyPeerAsync((void*)rp(r)[2], dev(r), (void*)ptrs[0],
                                dev(0), (size_t)bytes, st(0));
    if (err == cudaSuccess) err = cudaEventRecord(ready, st(0));
  }
  for (int r = 1; err == cudaSuccess && r < S; ++r) {
    DeviceScope on(dev(r));
    err = on.err;
    if (err == cudaSuccess) err = cudaStreamWaitEvent(st(r), ready, 0);
  }
  for (int r = 0; err == cudaSuccess && r < S; ++r) {
    const int rc = entry(rp(r) + 3, CARD_NPTRS, rd(r), CARD_NDIMS,
                         (void*)st(r));
    if (rc != 0) return rc;
  }
  for (int r = 0; err == cudaSuccess && r < S; ++r) {
    DeviceScope on(dev(r));
    err = on.err;
    if (err == cudaSuccess) err = cudaEventRecord(done(r), st(r));
  }
  if (err == cudaSuccess) {
    DeviceScope on(dev(0));
    err = on.err;
    for (int r = 1; err == cudaSuccess && r < S; ++r)
      err = cudaStreamWaitEvent(st(0), done(r), 0);
  }
  return (int)err;
}

// `ndims` events (cudaEventDisableTiming), event i on card dims[i], their
// handles written to ptrs[i] (a caller's array).  Returns 0 or the first
// CUDA error.  `stream` unused.
extern "C" int ffd_card_events(const unsigned long long* ptrs, int nptrs,
                               const int* dims, int ndims, void* stream) {
  (void)stream;
  if (nptrs != ndims || ndims < 1) return -2;
  unsigned long long* out = const_cast<unsigned long long*>(ptrs);
  cudaError_t err = cudaSuccess;
  for (int i = 0; err == cudaSuccess && i < ndims; ++i) {
    DeviceScope on(dims[i]);
    err = on.err;
    cudaEvent_t e = nullptr;
    if (err == cudaSuccess)
      err = cudaEventCreateWithFlags(&e, cudaEventDisableTiming);
    out[i] = (unsigned long long)e;
  }
  return (int)err;
}

template <bool TOPO, bool GANG, bool SEED>
int card_occupancy(const ScanArgs& a) {
  auto kern = scan_instance<TOPO, false, GANG, SEED, XCARD>(a);
  const size_t smem = scan_smem<TOPO, false>(a);
  int per_sm = 0, dev = 0, sms = 0;
  // raised only, through the launches' own record (allow_smem): setting
  // the attribute here could lower it under what a launch already took
  cudaError_t err = allow_smem((const void*)kern, smem);
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
