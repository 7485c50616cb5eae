// Host-side suffix-array construction: a from-scratch SA-IS implementation.
//
// Plays the role the libsais C kernel plays in the reference (called from the
// Writer's dump path, reference: src/lib.rs:24-40 -> libsais.c:6597), but is
// an independent implementation of the textbook SA-IS algorithm (Nong, Zhang
// & Chan 2009): type classification, LMS bucketing, two induced sorting
// sweeps, substring naming, and recursion on the reduced string.
//
// Performance architecture (decisions measured on this repo's bench corpus;
// numbers in ARCHITECTURE.md):
//
// - Level 0 (byte strings) runs DIRECTLY on the caller's uint8 text with a
//   virtual sentinel and sign-marked suffix types (entry v>0 = L-type
//   position v-1, v<0 = S-type position -v-1, 0 = empty), inducing straight
//   into the caller's sa_out.  No 4n int32 symbol copy exists at this level,
//   so the induced-sort inner loops' random reads touch the n-byte text
//   instead of a 4n array — at reference chunk sizes (256-512 MiB) that
//   footprint difference decides cache/TLB behavior.
// - Recursion levels use the symbol-typed path with the suffix type folded
//   into the top bit of the symbol array, instantiated for BOTH uint16 and
//   int32 symbols: reduced strings whose alphabet fits 15 bits (common —
//   natural-language LMS vocabularies are small) run on half the bytes.
// - Every big working array is allocated untouched and madvise'd
//   MADV_HUGEPAGE before first touch: the hot loops are random accesses
//   over multi-hundred-MB arrays, where 4 KiB pages make every access a
//   TLB miss as well as a cache miss.
// - The induced-sort loops software-prefetch the data-dependent symbol
//   reads PFD iterations ahead.  (A second-stage prefetch of the scatter
//   TARGET was tried and measured ~10% SLOWER: the speculative bucket
//   recompute costs more than the write-miss it hides.)
// - LMS-substring naming compares lengths first, then memcmp (vectorized),
//   instead of a per-byte scalar walk.
//
// Comparison convention: a virtual sentinel smaller than any byte (the int
// path realizes it as rank 0 after a +1 shift), so a proper prefix sorts
// before any extension — matching the reference reader's raw byte compare
// (src/lib.rs:224-228).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#if defined(__linux__)
#include <sys/mman.h>
#endif

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

using i32 = int32_t;
using u16 = uint16_t;

constexpr i32 PFD = 64;  // prefetch lead for data-dependent reads

// Phase timing to stderr when PSS_SA_PROFILE is set (diagnostic only).
bool sa_profile() {
  static const bool on = std::getenv("PSS_SA_PROFILE") != nullptr;
  return on;
}

double sa_now() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

struct SaPhase {
  const char* name;
  int level;
  double t0;
  SaPhase(const char* name, int level)
      : name(name), level(level), t0(sa_profile() ? sa_now() : 0.0) {}
  ~SaPhase() {
    if (sa_profile())
      fprintf(stderr, "[sa l%d] %-12s %7.2fs\n", level, name, sa_now() - t0);
  }
};

// Ask the kernel for 2 MiB pages over [p, p+bytes) (no-op off Linux or when
// THP is disabled).  Must run BEFORE first touch to take effect at fault.
void advise_huge(void* p, size_t bytes) {
#if defined(__linux__) && defined(MADV_HUGEPAGE)
  constexpr uintptr_t HP = 2u << 20;
  uintptr_t a = reinterpret_cast<uintptr_t>(p);
  uintptr_t lo = (a + HP - 1) & ~(HP - 1);
  uintptr_t hi = (a + bytes) & ~(HP - 1);
  if (hi > lo) madvise(reinterpret_cast<void*>(lo), hi - lo, MADV_HUGEPAGE);
#else
  (void)p;
  (void)bytes;
#endif
}

// Untouched-until-used allocation so advise_huge lands before first fault
// (std::vector value-initializes, faulting every page as 4 KiB first).
//
// Freed blocks go to a thread-local exact-size pool: a Writer worker
// builds many same-shaped chunks back to back, and the recursion's big
// transient buffers repeat their sizes every chunk — reuse turns a few
// hundred MB of huge-page refaults per chunk into no-ops.  The pool is
// bounded and dies with the thread (Writer pool workers are per-build).
// All Buf objects are function-scoped, so every Buf destructor runs before
// thread exit and the pool's own destructor (which frees the retained
// blocks) is the last pool access — no thread_local ordering hazards.
struct BufPool {
  struct Entry {
    size_t bytes;
    void* p;
  };
  static constexpr size_t kCap = 2u << 30;  // 2 GiB retained max
  std::vector<Entry> entries;
  size_t bytes = 0;
  ~BufPool() {
    for (auto& e : entries) std::free(e.p);
  }
};

struct Buf {
  static thread_local BufPool pool;

  void* p = nullptr;
  size_t bytes_ = 0;
  explicit Buf(size_t bytes) : bytes_(bytes) {
    for (size_t i = 0; i < pool.entries.size(); ++i) {
      if (pool.entries[i].bytes == bytes) {
        p = pool.entries[i].p;
        pool.bytes -= bytes;
        pool.entries.erase(pool.entries.begin() + i);
        return;
      }
    }
    p = std::malloc(bytes);
    if (p != nullptr) advise_huge(p, bytes);
  }
  ~Buf() {
    if (p == nullptr) return;
    if (bytes_ >= (1u << 16) && pool.bytes + bytes_ <= BufPool::kCap) {
      pool.entries.push_back({bytes_, p});
      pool.bytes += bytes_;
      return;
    }
    std::free(p);
  }
  Buf(const Buf&) = delete;
  Buf& operator=(const Buf&) = delete;
  template <typename T>
  T* as() const {
    return static_cast<T*>(p);
  }
};
thread_local BufPool Buf::pool;

// bkt[c] = start (end=false) or one-past-end (end=true) of symbol c's bucket.
void bucket_bounds(const i32* cnt, i32* bkt, i32 K, bool end) {
  i32 sum = 0;
  for (i32 c = 0; c < K; ++c) {
    sum += cnt[c];
    bkt[c] = end ? sum : sum - cnt[c];
  }
}

// ---------------------------------------------------------------------------
// Symbol-typed recursion path (SymT = uint16 or int32).
//
// The suffix type bit is folded into the symbol array itself (st[i] = sym |
// TBIT for S-type), so the induction inner loops touch ONE random location
// per element.  sa[] entries: position values >= 0, -1 = empty.
// ---------------------------------------------------------------------------

template <typename SymT>
struct SymTraits;

template <>
struct SymTraits<i32> {
  static constexpr i32 TBIT = 1 << 30;
  static constexpr i32 SMASK = TBIT - 1;
};

template <>
struct SymTraits<u16> {
  static constexpr u16 TBIT = 1u << 15;
  static constexpr u16 SMASK = TBIT - 1;
};

// The two canonical induction sweeps: L-types left-to-right from bucket
// heads, then S-types right-to-left from bucket tails.  These are the two
// hottest loops of the whole build.
template <typename SymT>
void induce_t(const SymT* st, i32* sa, const std::vector<i32>& cnt,
              std::vector<i32>& bkt, i32 n, i32 K) {
  constexpr auto TBIT = SymTraits<SymT>::TBIT;
  constexpr auto SMASK = SymTraits<SymT>::SMASK;
  bucket_bounds(cnt.data(), bkt.data(), K, false);
  for (i32 i = 0; i < n; ++i) {
    if (i + PFD < n) {
      i32 jp = sa[i + PFD];
      if (jp > 0) __builtin_prefetch(&st[jp - 1]);
    }
    i32 j = sa[i];
    if (j > 0) {
      SymT v = st[j - 1];
      if (!(v & TBIT)) sa[bkt[v]++] = j - 1;
    }
  }
  bucket_bounds(cnt.data(), bkt.data(), K, true);
  for (i32 i = n - 1; i >= 0; --i) {
    if (i - PFD >= 0) {
      i32 jp = sa[i - PFD];
      if (jp > 0) __builtin_prefetch(&st[jp - 1]);
    }
    i32 j = sa[i];
    if (j > 0) {
      SymT v = st[j - 1];
      if (v & TBIT) sa[--bkt[v & SMASK]] = j - 1;
    }
  }
}

template <typename SymT>
void sais_rec(SymT* st, i32* sa, i32 n, i32 K, i32* lms_buf, i32* park,
              int level = 1);

// ---------------------------------------------------------------------------
// Fused-naming first induction.
//
// The reference kernel's biggest structural advantage (measured -1.4 s/chunk,
// ARCHITECTURE.md) is that its partial induced sort carries LMS-substring
// DISTINCTNESS through the sweeps (libsais.c:2105-2136, renumber :3853), so
// naming is a renumber pass and the substring memcmp never runs.  This is an
// independent implementation of that idea in this file's conventions:
//
// - A global group counter d increments at every pop of a "starts a new
//   group" entry.  Entries with equal induced-so-far prefixes share a group.
// - Each scatter marks its child as a group start iff the target bucket's
//   last-write d (dnL/dnS, sentinel -1 so every region's first write is
//   marked) differs from the current d.
// - Mark sense per sweep: marks written by the L-sweep mean "differs from
//   the previous (lower) slot"; marks written by the S-sweep mean "differs
//   from the next (higher) slot".  The L-to-R sweep therefore consumes all
//   marks PRE-pop; the R-to-L sweep consumes S marks pre-pop and L marks
//   POST-pop (instead of the marker-shift pass the reference uses).
// - The mark chain never records the S-region -> L-region crossing inside a
//   bucket, so the R-to-L sweep forces a boundary at each bucket's topmost
//   L slot (sound: an equal-LMS-substring group has identical internal
//   types, so its chain never spans that junction).
// - After both sweeps, a single ascending walk compacts the sorted LMS
//   positions AND names them: a group boundary is pending iff any mark (or
//   any L entry — a bucket change) was seen since the previous LMS.  At
//   each boundary, one memcmp against the previous GROUP LEADER (excluding
//   the terminal LMS symbol, as in the unfused path — it heads the next
//   substring) merges adjacent groups that differ only terminally,
//   preserving the ~4x smaller reduced alphabet at O(#groups) memcmp cost
//   instead of O(m).
//
// The mark lives in bit 30 of the entry magnitude, so the fused path
// requires n <= 2^30 - 1; larger inputs take the unfused path below.
// ---------------------------------------------------------------------------

constexpr i32 MB30 = 1 << 30;   // group-start mark bit (inside magnitude)
constexpr i32 MSK30 = MB30 - 1;


// Level-0 PARTIAL first induction over u8 text — the reference kernel's
// structural trick (libsais.c partial sorting scans, :2105-2136), built
// independently on this file's region taxonomy.  Every position belongs to
// one of four per-symbol categories from its (type, predecessor-type) pair:
//
//   LL: L-type, L predecessor — popped by the L-sweep (induces further L)
//   SL: L-type, S predecessor — popped by the S-sweep (seeds S induction)
//   SS: S-type, S predecessor — popped by the S-sweep (induces further S)
//   OUT: LMS (S-type, L predecessor) — popped by NOTHING; these are the
//        product.  The S-sweep routes them into per-symbol output regions,
//        so the sorted LMS list is compacted as a side effect and the
//        compact pass disappears.
//
// The sweeps scan only the producing regions (LL+seeds, then SS+SL) —
// about half the slot traffic of the classical full sweeps — and entries
// need no sign/type encoding (the scanned region implies the type), so an
// entry is just `position | group-mark` (bit 30; see the fused-naming
// block comment above for the d-counter group scheme).  Seeds share the
// OUT regions: they are consumed by the L-sweep before the S-sweep
// overwrites those slots with the real output.
//
// Region layout per symbol c (within one n-slot array): LL | SL | SS | OUT,
// buckets ascending; total is exactly n.  Predecessor type of position 0
// is defined S (position 0 never induces, so the choice only affects which
// dead region holds it).
struct PartialRegions {
  i32 ll_lo[256], sl_lo[256], ss_lo[256], out_lo[256];
  i32 sl_hi[256], ss_hi[256], out_hi[256];
};

// (symbol, category) histogram from the type bitmask (bit i = S-type).
void hist4_u8(const uint8_t* data, i32 n, const uint64_t* types, i32* h4) {
  std::fill(h4, h4 + 1024, 0);
  i32 words = (n + 63) / 64;
  for (i32 b = 0; b < words; ++b) {
    uint64_t s = types[b];
    // bit k = type of position-1 (S?); pred of position 0 is S.
    uint64_t sp = (s << 1) | (b > 0 ? types[b - 1] >> 63 : 1);
    const uint8_t* dp = data + 64 * static_cast<size_t>(b);
    i32 lim = n - 64 * b < 64 ? n - 64 * b : 64;
    for (i32 k = 0; k < lim; ++k) {
      unsigned si = (s >> k) & 1, pi = (sp >> k) & 1;
      h4[4 * dp[k] + 2 * si + (si ^ pi)]++;
    }
  }
}

void partial_regions(const i32* h4, PartialRegions* R) {
  i32 sum = 0;
  for (i32 c = 0; c < 256; ++c) {
    R->ll_lo[c] = sum;
    sum += h4[4 * c + 0];
    R->sl_lo[c] = sum;
    sum += h4[4 * c + 1];
    R->sl_hi[c] = sum;
    R->ss_lo[c] = sum;
    sum += h4[4 * c + 2];
    R->ss_hi[c] = sum;
    R->out_lo[c] = sum;
    sum += h4[4 * c + 3];
    R->out_hi[c] = sum;
  }
}

// Both partial sweeps.  On entry sa's OUT regions hold the LMS seeds
// (ascending, each bucket's first seed marked); on return the OUT regions
// hold the sorted, group-marked LMS positions.
void partial_induce_u8(const uint8_t* data, i32* sa, i32 n,
                       const PartialRegions* R) {
  i32 llh[256], slh[256];
  i32 dnLL[256], dnSL[256];
  for (i32 c = 0; c < 256; ++c) {
    llh[c] = R->ll_lo[c];
    slh[c] = R->sl_lo[c];
    dnLL[c] = dnSL[c] = -1;
  }
  i32 d = 0;
  // Bootstrap: the virtual sentinel's predecessor n-1 is L; route it by
  // its own predecessor's type and mark it (it is the smallest L suffix of
  // its bucket, so it heads its subregion).
  {
    uint8_t c0 = data[n - 1];
    if (data[n - 2] >= data[n - 1])
      sa[llh[c0]++] = (n - 1) | MB30;
    else
      sa[slh[c0]++] = (n - 1) | MB30;
  }
  // L-sweep: per bucket ascending, pop the (growing) LL region, then the
  // seeds parked in OUT.  All marks here read "differs from the slot
  // below", so d consumes them pre-pop.
  for (i32 c = 0; c < 256; ++c) {
    for (i32 pass = 0; pass < 2; ++pass) {
      i32 i = pass == 0 ? R->ll_lo[c] : R->out_lo[c];
      i32 end = pass == 0 ? llh[c] : R->out_hi[c];  // llh[c] re-read below
      bool isL = pass == 0;
      for (; i < end; ++i, end = pass == 0 ? llh[c] : end) {
        if (i + PFD < n) {
          i32 w = sa[i + PFD] & MSK30;
          __builtin_prefetch(&data[w > 0 ? w - 1 : 0]);
        }
        i32 v = sa[i];
        d += (v >> 30) & 1;
        i32 p = v & MSK30;
        if (p == 0) continue;
        uint8_t cc = data[p], b = data[p - 1];
        if (b > cc || (b == cc && isL)) {
          i32 q = p - 1;
          i32 mk;
          if (q >= 1 && data[q - 1] >= data[q]) {  // child's pred is L
            mk = dnLL[b] != d ? MB30 : 0;
            dnLL[b] = d;
            sa[llh[b]++] = q | mk;
          } else {
            mk = dnSL[b] != d ? MB30 : 0;
            dnSL[b] = d;
            sa[slh[b]++] = q | mk;
          }
        }
      }
    }
  }
  // S-sweep: per bucket descending, pop the (growing, tail-filled) SS
  // region, then the SL region filled by the L-sweep.  SS marks read
  // "differs from the slot above" (pre-pop); SL marks were written
  // ascending ("differs from below") so they are consumed post-pop, with a
  // forced boundary on entry to each SL region (the S-to-L junction is
  // never recorded by the mark chain; sound because an equal-substring
  // group never spans it).
  i32 ssh[256], outh[256];
  i32 dnSS[256], dnOut[256];
  for (i32 c = 0; c < 256; ++c) {
    ssh[c] = R->ss_hi[c];
    outh[c] = R->out_hi[c];
    dnSS[c] = dnOut[c] = -1;
  }
  for (i32 c = 255; c >= 0; --c) {
    // SS region, descending from the top; ssh[c] falls as children arrive.
    for (i32 i = R->ss_hi[c] - 1; i >= ssh[c]; --i) {
      if (i - PFD >= 0) {
        i32 w = sa[i - PFD] & MSK30;
        __builtin_prefetch(&data[w > 0 ? w - 1 : 0]);
      }
      i32 v = sa[i];
      d += (v >> 30) & 1;  // pre-pop
      i32 p = v & MSK30;
      if (p == 0) continue;
      uint8_t cc = data[p], b = data[p - 1];
      if (b < cc || b == cc) {  // child is S (popped type is S)
        i32 q = p - 1;
        i32 mk;
        if (q == 0 || data[q - 1] <= data[q]) {  // child's pred is S
          mk = dnSS[b] != d ? MB30 : 0;
          dnSS[b] = d;
          sa[--ssh[b]] = q | mk;
        } else {  // child is LMS: route to the output region
          mk = dnOut[b] != d ? MB30 : 0;
          dnOut[b] = d;
          sa[--outh[b]] = q | mk;
        }
      }
    }
    // SL region, descending over its filled extent.
    if (slh[c] > R->sl_lo[c]) ++d;  // forced junction boundary
    for (i32 i = slh[c] - 1; i >= R->sl_lo[c]; --i) {
      if (i - PFD >= 0) {
        i32 w = sa[i - PFD] & MSK30;
        __builtin_prefetch(&data[w > 0 ? w - 1 : 0]);
      }
      i32 v = sa[i];
      i32 p = v & MSK30;
      if (p != 0) {
        uint8_t cc = data[p], b = data[p - 1];
        if (b < cc) {  // child is S (popped type is L: ties stay L)
          i32 q = p - 1;
          i32 mk;
          if (q == 0 || data[q - 1] <= data[q]) {
            mk = dnSS[b] != d ? MB30 : 0;
            dnSS[b] = d;
            sa[--ssh[b]] = q | mk;
          } else {
            mk = dnOut[b] != d ? MB30 : 0;
            dnOut[b] = d;
            sa[--outh[b]] = q | mk;
          }
        }
      }
      d += (v >> 30) & 1;  // post-pop
    }
  }
}

// Renumber the OUT regions (ascending = globally sorted LMS order):
// compact positions into sa[0..m) and park names at park[pos/2].  One
// memcmp per group boundary merges adjacent groups equal up to (but
// excluding) the terminal symbol — reproducing the unfused naming's
// reduced alphabet at O(#groups) cost.  Returns the name count.
i32 partial_renumber_u8(const uint8_t* data, i32* sa, i32 n,
                        const PartialRegions* R, const uint64_t* types,
                        i32* park) {
  // Terminal-excluded substring length, computed lazily at each group
  // boundary (rare: #groups, not m): distance to the next LMS position,
  // found from the type bitmask as the next set bit of s & ~(s << 1).
  auto lms_len = [&](i32 e) -> i32 {
    i32 b = (e + 1) >> 6;
    i32 words = (n + 63) / 64;
    uint64_t s = types[b], sp = (s << 1) | (b > 0 ? types[b - 1] >> 63 : 1);
    uint64_t lm = s & ~sp & ~((e + 1) & 63 ? (1ull << ((e + 1) & 63)) - 1 : 0);
    while (!lm) {
      if (++b >= words) return n - e;  // text-final LMS: full tail
      s = types[b];
      sp = (s << 1) | (types[b - 1] >> 63);
      lm = s & ~sp;
    }
    return 64 * b + __builtin_ctzll(lm) - e;
  };
  i32 q = 0, name = 0;
  bool pending = true;
  i32 prev_leader = -1, prev_len = -1;
  for (i32 c = 0; c < 256; ++c) {
    for (i32 i = R->out_lo[c]; i < R->out_hi[c]; ++i) {
      if (i + 8 < n) {
        i32 w = sa[i + 8] & MSK30;
        __builtin_prefetch(&park[w >> 1], 1);
      }
      i32 v = sa[i];
      i32 e = v & MSK30;
      if (pending) {
        i32 len = lms_len(e);
        if (!(prev_leader >= 0 && len == prev_len &&
              std::memcmp(data + e, data + prev_leader,
                          static_cast<size_t>(len)) == 0))
          ++name;
        prev_leader = e;
        prev_len = len;
        pending = false;
      }
      park[e >> 1] = name - 1;
      sa[q++] = e;
      pending = (v & MB30) != 0;
    }
  }
  return name;
}

// Recursion-level partial induction (see the level-0 partial block
// comment for the taxonomy and region layout).  SymT = u16 or i32 symbols
// with the type bit folded into st, so category tests are direct bit reads
// of two adjacent symbols.  scratch must hold 15K i32: seven K-sized
// region-offset arrays followed by four interleaved (head, last-write-d)
// pair arrays of 2K each (the interleave keeps each random per-write
// access to one cache line at recursion-level alphabet sizes).
template <typename SymT>
struct PartialRegionsT {
  i32 *ll_lo, *sl_lo, *sl_hi, *ss_lo, *ss_hi, *out_lo, *out_hi;
  i32 *llp, *slp, *ssp, *outp;  // interleaved (head, dn) pairs
  explicit PartialRegionsT(i32* scratch, i32 K) {
    ll_lo = scratch;
    sl_lo = ll_lo + K;
    sl_hi = sl_lo + K;
    ss_lo = sl_hi + K;
    ss_hi = ss_lo + K;
    out_lo = ss_hi + K;
    out_hi = out_lo + K;
    llp = out_hi + K;
    slp = llp + 2 * static_cast<size_t>(K);
    ssp = slp + 2 * static_cast<size_t>(K);
    outp = ssp + 2 * static_cast<size_t>(K);
  }
};

template <typename SymT>
void partial_setup_t(const SymT* st, i32 n, i32 K,
                     PartialRegionsT<SymT>* R) {
  constexpr auto TBIT = SymTraits<SymT>::TBIT;
  constexpr auto SMASK = SymTraits<SymT>::SMASK;
  // (symbol, category) histogram -> region bounds.  Reuses the pair arrays
  // as the 4K-counter block before they become heads.
  i32* h4 = R->llp;  // 4K slots
  std::fill(h4, h4 + 4 * static_cast<size_t>(K), 0);
  {
    unsigned pi = 1;  // pred of position 0 is S
    for (i32 i = 0; i < n; ++i) {
      SymT v = st[i];
      unsigned si = (v & TBIT) ? 1u : 0u;
      h4[4 * static_cast<size_t>(v & SMASK) + 2 * si + (si ^ pi)]++;
      pi = si;
    }
  }
  i32 sum = 0;
  for (i32 c = 0; c < K; ++c) {
    R->ll_lo[c] = sum;
    sum += h4[4 * static_cast<size_t>(c) + 0];
    R->sl_lo[c] = sum;
    sum += h4[4 * static_cast<size_t>(c) + 1];
    R->sl_hi[c] = sum;
    R->ss_lo[c] = sum;
    sum += h4[4 * static_cast<size_t>(c) + 2];
    R->ss_hi[c] = sum;
    R->out_lo[c] = sum;
    sum += h4[4 * static_cast<size_t>(c) + 3];
    R->out_hi[c] = sum;
  }
}

template <typename SymT>
void partial_induce_t(const SymT* st, i32* sa, i32 n, i32 K,
                      PartialRegionsT<SymT>* R) {
  constexpr auto TBIT = SymTraits<SymT>::TBIT;
  i32* llp = R->llp;
  i32* slp = R->slp;
  for (i32 c = 0; c < K; ++c) {
    llp[2 * c] = R->ll_lo[c];
    llp[2 * c + 1] = -1;
    slp[2 * c] = R->sl_lo[c];
    slp[2 * c + 1] = -1;
  }
  i32 d = 0;
  // L-sweep (no bootstrap: the appended sentinel is itself an LMS seed).
  for (i32 c = 0; c < K; ++c) {
    for (i32 pass = 0; pass < 2; ++pass) {
      i32 i = pass == 0 ? R->ll_lo[c] : R->out_lo[c];
      bool isL = pass == 0;
      for (i32 end = pass == 0 ? llp[2 * c] : R->out_hi[c]; i < end;
           ++i, end = pass == 0 ? llp[2 * c] : end) {
        if (i + PFD < n) {
          i32 w = sa[i + PFD] & MSK30;
          __builtin_prefetch(&st[w > 0 ? w - 1 : 0]);
        }
        i32 v = sa[i];
        d += (v >> 30) & 1;
        i32 p = v & MSK30;
        if (p == 0) continue;
        SymT sq = st[p - 1];
        bool childL = !(sq & TBIT);
        if (!isL) {
          // Seed pops: p is LMS, its predecessor is L by definition.
          childL = true;
        }
        if (childL) {
          i32 q = p - 1;
          size_t b = static_cast<size_t>(sq) & SymTraits<SymT>::SMASK;
          bool predL = q >= 1 && !(st[q - 1] & TBIT);
          i32* pr = predL ? &llp[2 * b] : &slp[2 * b];
          i32 mk = pr[1] != d ? MB30 : 0;
          pr[1] = d;
          sa[pr[0]++] = q | mk;
        }
      }
    }
  }
  // S-sweep.
  i32* ssp = R->ssp;
  i32* outp = R->outp;
  for (i32 c = 0; c < K; ++c) {
    ssp[2 * c] = R->ss_hi[c];
    ssp[2 * c + 1] = -1;
    outp[2 * c] = R->out_hi[c];
    outp[2 * c + 1] = -1;
  }
  for (i32 c = K - 1; c >= 0; --c) {
    for (i32 i = R->ss_hi[c] - 1; i >= ssp[2 * c]; --i) {
      if (i - PFD >= 0) {
        i32 w = sa[i - PFD] & MSK30;
        __builtin_prefetch(&st[w > 0 ? w - 1 : 0]);
      }
      i32 v = sa[i];
      d += (v >> 30) & 1;  // pre-pop
      i32 p = v & MSK30;
      if (p == 0) continue;
      SymT sq = st[p - 1];
      if (sq & TBIT) {  // child is S
        i32 q = p - 1;
        size_t b = static_cast<size_t>(sq) & SymTraits<SymT>::SMASK;
        bool predS = q == 0 || (st[q - 1] & TBIT);
        i32* pr = predS ? &ssp[2 * b] : &outp[2 * b];
        i32 mk = pr[1] != d ? MB30 : 0;
        pr[1] = d;
        sa[--pr[0]] = q | mk;
      }
    }
    if (slp[2 * c] > R->sl_lo[c]) ++d;  // forced junction boundary
    for (i32 i = slp[2 * c] - 1; i >= R->sl_lo[c]; --i) {
      if (i - PFD >= 0) {
        i32 w = sa[i - PFD] & MSK30;
        __builtin_prefetch(&st[w > 0 ? w - 1 : 0]);
      }
      i32 v = sa[i];
      i32 p = v & MSK30;
      if (p != 0) {
        SymT sq = st[p - 1];
        if (sq & TBIT) {
          i32 q = p - 1;
          size_t b = static_cast<size_t>(sq) & SymTraits<SymT>::SMASK;
          bool predS = q == 0 || (st[q - 1] & TBIT);
          i32* pr = predS ? &ssp[2 * b] : &outp[2 * b];
          i32 mk = pr[1] != d ? MB30 : 0;
          pr[1] = d;
          sa[--pr[0]] = q | mk;
        }
      }
      d += (v >> 30) & 1;  // post-pop
    }
  }
}

// Renumber the OUT regions at a recursion level (see partial_renumber_u8).
// Equality memcmps the raw symbol words, folded type bits included — sound
// because equal substrings have equal internal types.
template <typename SymT>
i32 partial_renumber_t(const SymT* st, i32* sa, i32 n, i32 K,
                       const PartialRegionsT<SymT>* R, i32* park) {
  constexpr auto TBIT = SymTraits<SymT>::TBIT;
  // Terminal-excluded substring length, found by a local forward scan for
  // the next LMS (average gap is small; runs only at group boundaries, and
  // the scanned symbols are the ones the boundary memcmp touches anyway).
  auto lms_len = [&](i32 e) -> i32 {
    i32 j = e + 1;
    while (j < n && !((st[j] & TBIT) && !(st[j - 1] & TBIT))) ++j;
    return j - e;
  };
  i32 q = 0, name = 0;
  bool pending = true;
  i32 prev_leader = -1, prev_len = -1;
  for (i32 c = 0; c < K; ++c) {
    for (i32 i = R->out_lo[c]; i < R->out_hi[c]; ++i) {
      if (i + 8 < n) {
        i32 w = sa[i + 8] & MSK30;
        __builtin_prefetch(&park[w >> 1], 1);
        __builtin_prefetch(&st[w]);
      }
      i32 v = sa[i];
      i32 e = v & MSK30;
      if (pending) {
        i32 len = lms_len(e);
        if (!(prev_leader >= 0 && len == prev_len &&
              std::memcmp(st + e, st + prev_leader,
                          static_cast<size_t>(len) * sizeof(SymT)) == 0))
          ++name;
        prev_leader = e;
        prev_len = len;
        pending = false;
      }
      park[e >> 1] = name - 1;
      sa[q++] = e;
      pending = (v & MB30) != 0;
    }
  }
  return name;
}

// Recurse on the reduced string of m LMS names parked ascending in the
// non-negative slots of park[0..park_n): pick the narrowest symbol width
// the alphabet fits, +1-shift with an appended 0 sentinel (uniform — an
// extra sentinel after an already-sentineled string changes nothing, and
// the byte level's virtual-sentinel reduction REQUIRES one), and leave the
// reduced SA in sa1[0..m+1) (slot 0 = the appended sentinel's position).
void solve_reduced(const i32* park, i32 park_n, i32* sa1, i32 m, i32 name,
                   i32* park_pass, int level) {
  Buf lms_rec(sizeof(i32) * (static_cast<size_t>(m) + 3));
  if (name + 2 <= static_cast<i32>(SymTraits<u16>::TBIT)) {
    Buf s1(sizeof(u16) * (static_cast<size_t>(m) + 1));
    u16* s = s1.as<u16>();
    i32 k = 0;
    for (i32 i = 0; i < park_n; ++i)
      if (park[i] >= 0) s[k++] = static_cast<u16>(park[i] + 1);
    s[m] = 0;
    sais_rec<u16>(s, sa1, m + 1, name + 1, lms_rec.as<i32>(), park_pass,
                  level);
  } else {
    Buf s1(sizeof(i32) * (static_cast<size_t>(m) + 1));
    i32* s = s1.as<i32>();
    i32 k = 0;
    for (i32 i = 0; i < park_n; ++i)
      if (park[i] >= 0) s[k++] = park[i] + 1;
    s[m] = 0;
    sais_rec<i32>(s, sa1, m + 1, name + 1, lms_rec.as<i32>(), park_pass,
                  level);
  }
}

// Fused-path variant of solve_reduced: names live at park[pos/2] and are
// gathered through lms[] (ascending text order, so the park reads are
// near-sequential), instead of scanning the whole park region for
// non-negative slots.
void solve_reduced_park(i32* park, const i32* lms, i32* sa1, i32 m,
                        i32 name, int level) {
  // park's names are consumed into s1 here, so the same buffer is passed
  // down for the deeper levels' renumber scratch (one top-level
  // allocation serves the whole recursion: sizes only shrink).
  Buf lms_rec(sizeof(i32) * (static_cast<size_t>(m) + 3));
  if (name + 2 <= static_cast<i32>(SymTraits<u16>::TBIT)) {
    Buf s1(sizeof(u16) * (static_cast<size_t>(m) + 1));
    u16* s = s1.as<u16>();
    for (i32 i = 0; i < m; ++i)
      s[i] = static_cast<u16>(park[lms[i] >> 1] + 1);
    s[m] = 0;
    sais_rec<u16>(s, sa1, m + 1, name + 1, lms_rec.as<i32>(), park, level);
  } else {
    Buf s1(sizeof(i32) * (static_cast<size_t>(m) + 1));
    i32* s = s1.as<i32>();
    for (i32 i = 0; i < m; ++i) s[i] = park[lms[i] >> 1] + 1;
    s[m] = 0;
    sais_rec<i32>(s, sa1, m + 1, name + 1, lms_rec.as<i32>(), park, level);
  }
}

// SA-IS over an integer string st[0..n) with values in [0, K) whose last
// symbol is a unique smallest sentinel.  st is MUTATED (type bits folded
// in).  lms_buf must hold at least n/2 + 2 i32.
template <typename SymT>
void sais_rec(SymT* st, i32* sa, i32 n, i32 K, i32* lms_buf, i32* park,
              int level) {
  constexpr auto TBIT = SymTraits<SymT>::TBIT;
  constexpr auto SMASK = SymTraits<SymT>::SMASK;
  if (n == 1) {
    sa[0] = 0;
    return;
  }
  SaPhase ph_all("rec-total", level);

  // Type pass (right-to-left), folding the S bit into st in place.
  {
    SaPhase ph("r-typescan", level);
    st[n - 1] = static_cast<SymT>(st[n - 1] | TBIT);
    for (i32 i = n - 2; i >= 0; --i) {
      SymT a = st[i], b = st[i + 1];
      if (a < (b & SMASK) || (a == (b & SMASK) && (b & TBIT)))
        st[i] = static_cast<SymT>(a | TBIT);
    }
  }

  std::vector<i32> cnt(K, 0), bkt(K);
  for (i32 i = 0; i < n; ++i) cnt[st[i] & SMASK]++;

  // Stage 1 + 2.  The fused path (n small enough for the bit-30 group
  // marks) carries naming through the first induction; the unfused path is
  // the original compact + park-lengths + memcmp naming.
  i32* lms = lms_buf;
  i32 m = 0;
  for (i32 i = 1; i < n; ++i)
    if ((st[i] & TBIT) && !(st[i - 1] & TBIT)) lms[m++] = i;

  // The partial path needs 15K i32 of per-symbol scratch; at the deep
  // recursion levels the reduced alphabet approaches n (nearly-distinct
  // names) and that O(K) overhead swamps the sweep savings, so those
  // levels take the classical path — the same space-ratio dispatch the
  // reference kernel makes with its 6k/4k/2k/1k bucket variants
  // (libsais.c:3806-3850).
  i32 name = 0;
  if (n <= MSK30 && K <= (n >> 3)) {
    Buf scratch_b(sizeof(i32) * 15 * static_cast<size_t>(K));
    PartialRegionsT<SymT> R(scratch_b.as<i32>(), K);
    {
      SaPhase ph("r-hist", level);
      partial_setup_t<SymT>(st, n, K, &R);
    }
    {
      SaPhase ph("r-seed1", level);
      // Seeds into the OUT regions ascending, each bucket's first seed
      // marked (one group per bucket: single-symbol prefixes).  outp's
      // head slots serve as the fill pointers; partial_induce_t re-inits
      // them before the S-sweep.
      i32* sh = R.outp;
      for (i32 c = 0; c < K; ++c) sh[2 * c] = R.out_lo[c];
      for (i32 i = 0; i < m; ++i) {
        i32 p = lms[i];
        size_t c = static_cast<size_t>(st[p]) & SMASK;
        sa[sh[2 * c]] = p | (sh[2 * c] == R.out_lo[c] ? MB30 : 0);
        sh[2 * c]++;
      }
    }
    {
      SaPhase ph("r-induce1", level);
      partial_induce_t<SymT>(st, sa, n, K, &R);
    }
    Buf park_b(park ? 0 : sizeof(i32) * (static_cast<size_t>(n) / 2 + 1));
    i32* pk = park ? park : park_b.as<i32>();
    {
      SaPhase ph("r-naming", level);
      name = partial_renumber_t<SymT>(st, sa, n, K, &R, pk);
    }
    if (sa_profile())
      fprintf(stderr, "[sa l%d] n=%d m=%d name=%d K=%d sym=%zub partial\n",
              level, n, m, name, K, sizeof(SymT));
    if (name < m) {
      solve_reduced_park(pk, lms, sa, m, name, level + 1);
      Buf sorted_b(sizeof(i32) * static_cast<size_t>(m));
      i32* sorted = sorted_b.as<i32>();
      for (i32 i = 0; i < m; ++i) sorted[i] = lms[sa[i + 1]];
      std::copy(sorted, sorted + m, lms);
    } else {
      std::copy(sa, sa + m, lms);
    }
  } else {
  {
    SaPhase ph("r-seed1", level);
    std::fill(sa, sa + n, -1);
    bucket_bounds(cnt.data(), bkt.data(), K, true);
    for (i32 i = m - 1; i >= 0; --i) {
      sa[--bkt[st[lms[i]] & SMASK]] = lms[i];
    }
  }
  {
    SaPhase ph("r-induce1", level);
    induce_t<SymT>(st, sa, cnt, bkt, n, K);
  }

  // Compact the sorted LMS positions to the front.
  i32 q = 0;
  for (i32 i = 0; i < n; ++i) {
    if (i + PFD < n) {
      i32 pp = sa[i + PFD];
      if (pp > 0) __builtin_prefetch(&st[pp - 1]);
    }
    i32 p = sa[i];
    if (p > 0 && (st[p] & TBIT) && !(st[p - 1] & TBIT)) sa[q++] = p;
  }

  // Stage 2: name LMS substrings (equal substrings share a name); names
  // are parked at sa[m + pos/2], valid because LMS positions are >= 2
  // apart.  Lengths EXCLUDE the terminal LMS symbol (it heads the next
  // substring and is covered by the next name — see the byte-level naming
  // for the full argument); equality = equal length + memcmp over the RAW
  // symbol words.  Comparing the folded type bits too is sound: equal
  // substrings terminated at an LMS have identical internal types (the
  // type recurrence runs right-to-left inside the compared span seeded by
  // the boundary's L-before-S shape).  memcmp vectorizes where the
  // per-symbol walk with LMS-boundary checks could not.
  std::fill(sa + m, sa + n, -1);
  for (i32 i = 0; i < m; ++i) {
    i32 p = lms[i];
    i32 len = (i + 1 < m ? lms[i + 1] : n) - p;
    sa[m + p / 2] = len;
  }
  {
    SaPhase ph("r-naming", level);
    i32 prev = -1, prev_len = 0;
    for (i32 i = 0; i < m; ++i) {
      if (i + 8 < m) {
        i32 pp = sa[i + 8];
        __builtin_prefetch(&sa[m + pp / 2], 1);
        __builtin_prefetch(&st[pp]);
      }
      i32 pos = sa[i];
      i32 len = sa[m + pos / 2];
      bool differs =
          prev < 0 || len != prev_len ||
          std::memcmp(st + pos, st + prev,
                      static_cast<size_t>(len) * sizeof(SymT)) != 0;
      if (differs) {
        ++name;
        prev = pos;
        prev_len = len;
      }
      sa[m + pos / 2] = name - 1;
    }
  }
  if (sa_profile())
    fprintf(stderr, "[sa l%d] n=%d m=%d name=%d K=%d sym=%zub\n", level, n, m,
            name, K, sizeof(SymT));

  if (name < m) {
    // Ties remain: recurse on the reduced string of LMS names at the
    // narrowest symbol width that fits; reduced SA comes back in
    // sa[0..m+1), ranks at slots 1..m (slot 0 = appended sentinel).
    solve_reduced(sa + m, n - m, sa, m, name, park, level + 1);
    Buf sorted_b(sizeof(i32) * static_cast<size_t>(m));
    i32* sorted = sorted_b.as<i32>();
    for (i32 i = 0; i < m; ++i) sorted[i] = lms[sa[i + 1]];
    std::copy(sorted, sorted + m, lms);
  }
  // (name == m: sa[0..m) is already the sorted LMS suffix order.)
  else {
    std::copy(sa, sa + m, lms);
  }
  }

  // Stage 3: scatter sorted LMS suffixes to bucket tails, final induction.
  {
    SaPhase ph("r-seed3", level);
    std::fill(sa, sa + n, -1);
    bucket_bounds(cnt.data(), bkt.data(), K, true);
    for (i32 i = m - 1; i >= 0; --i) {
      i32 p = lms[i];
      sa[--bkt[st[p] & SMASK]] = p;
    }
  }
  {
    SaPhase ph("r-induce3", level);
    induce_t<SymT>(st, sa, cnt, bkt, n, K);
  }
}

// ---------------------------------------------------------------------------
// Level 0: byte strings, no symbol copy, sign-marked types.
//
// sa[] entry encoding: 0 = empty; v > 0 = position v-1 known L-type;
// v < 0 = position -v-1 known S-type.  Types are derived on the fly from
// adjacent text bytes plus the popped entry's own sign:
//   L(p-1)  <=>  data[p-1] > data[p]  ||  (data[p-1] == data[p] && L(p))
// so each pop costs ONE random text access (two adjacent bytes).  LMS seeds
// left stale in the S region are provably overwritten before the right-to-
// left sweep reads their slot (each S slot's writer pops at an index above
// the slot), so no clearing pass is needed between the sweeps.
// ---------------------------------------------------------------------------

// The two induction sweeps over u8 text.  sa holds seeds (negative, S-type);
// on return every suffix is placed, sign-marked.
void induce_u8(const uint8_t* data, i32* sa, i32 n, i32* bkt,
               const i32* cnt) {
  // L-sweep, left to right from bucket heads.  The virtual sentinel's
  // predecessor n-1 is always L (it precedes the smallest suffix).
  bucket_bounds(cnt, bkt, 256, false);
  sa[bkt[data[n - 1]]++] = n;  // +(n-1+1)
  for (i32 i = 0; i < n; ++i) {
    if (i + PFD < n) {
      i32 w = sa[i + PFD];
      if (w != 0) {
        i32 q = (w < 0 ? -w : w) - 1;
        if (q > 0) __builtin_prefetch(&data[q - 1]);
      }
    }
    i32 v = sa[i];
    if (v == 0) continue;
    i32 p = (v < 0 ? -v : v) - 1;
    if (p == 0) continue;
    uint8_t c = data[p], b = data[p - 1];
    if (b > c || (b == c && v > 0)) sa[bkt[b]++] = p;  // push p-1 as L
  }
  // S-sweep, right to left from bucket tails.
  bucket_bounds(cnt, bkt, 256, true);
  for (i32 i = n - 1; i >= 0; --i) {
    if (i - PFD >= 0) {
      i32 w = sa[i - PFD];
      if (w != 0) {
        i32 q = (w < 0 ? -w : w) - 1;
        if (q > 0) __builtin_prefetch(&data[q - 1]);
      }
    }
    i32 v = sa[i];
    if (v == 0) continue;
    i32 p = (v < 0 ? -v : v) - 1;
    if (p == 0) continue;
    uint8_t c = data[p], b = data[p - 1];
    if (b < c || (b == c && v < 0)) sa[--bkt[b]] = -p;  // push p-1 as S
  }
}

// SA-IS over bytes; writes the final SA (positions, sign-stripped) into sa.
void sais_u8(const uint8_t* data, i32* sa, i32 n) {
  if (n == 1) {
    sa[0] = 0;
    return;
  }
  std::vector<i32> cnt(256, 0), bkt(256);
  {
    SaPhase ph("count", 0);
    for (i32 i = 0; i < n; ++i) cnt[data[i]]++;
  }

  // Type scan (right to left), collecting LMS positions in text order
  // (m <= n/2: consecutive LMS are >= 2 apart) and the S-type bitmask
  // (bit i set = position i is S-type; consumed by the partial-sort
  // histogram below).  The big scratch buffers are cached per thread: a
  // Writer worker builds many chunks back to back, and refaulting a
  // quarter-gigabyte of huge pages per chunk costs a measurable fraction
  // of the build (freed at thread exit).
  struct Scratch {
    void* lms = nullptr;
    void* types = nullptr;
    void* park = nullptr;
    size_t lms_sz = 0, types_sz = 0, park_sz = 0;
    static void* grow(void** slot, size_t* sz, size_t bytes) {
      if (bytes > *sz) {
        std::free(*slot);
        *slot = std::malloc(bytes);
        if (*slot != nullptr) advise_huge(*slot, bytes);
        *sz = bytes;
      }
      return *slot;
    }
    i32* get_lms(size_t b) { return static_cast<i32*>(grow(&lms, &lms_sz, b)); }
    uint64_t* get_types(size_t b) {
      return static_cast<uint64_t*>(grow(&types, &types_sz, b));
    }
    i32* get_park(size_t b) {
      return static_cast<i32*>(grow(&park, &park_sz, b));
    }
    ~Scratch() {
      std::free(lms);
      std::free(types);
      std::free(park);
    }
  };
  static thread_local Scratch scratch;
  i32* lms = scratch.get_lms(sizeof(i32) * (static_cast<size_t>(n) / 2 + 1));
  i32 m = 0;
  const i32 words = (n + 63) / 64;
  uint64_t* types =
      scratch.get_types(sizeof(uint64_t) * (static_cast<size_t>(words) + 1));
#if defined(__AVX2__)
  if (n >= 256) {
    // Vectorized two-pass variant.  Pass 1 (right to left) computes the
    // S-type bitmask 64 positions at a time: with lt/eq compare masks of
    // adjacent bytes, S satisfies s_i = lt_i | (eq_i & s_{i+1}); bit 63 is
    // seeded from the inter-block carry and the rest closes in log2(64)
    // shift-and-mask steps (eq runs propagate the first non-equal verdict).
    // Pass 2 (left to right) extracts LMS positions from s & ~(s << 1).
    SaPhase ph("typescan", 0);
    // Scalar head: the last (partial) word, positions [64*(words-1), n).
    bool carry;  // after each word: S-type of that word's position 0
    {
      const i32 base = 64 * (words - 1);
      uint64_t w = 0;  // type(n-1) = L vs the sentinel: bit stays 0
      bool s_next = false;
      for (i32 i = n - 2; i >= base; --i) {
        bool s_cur =
            data[i] < data[i + 1] || (data[i] == data[i + 1] && s_next);
        if (s_cur) w |= 1ull << (i & 63);
        s_next = s_cur;
      }
      types[words - 1] = w;
      carry = s_next;  // == S(base); n >= 256 guarantees base > 0
    }
    for (i32 b = (words - 1) - 1; b >= 0; --b) {
      const uint8_t* p = data + 64 * static_cast<size_t>(b);
      uint64_t lt, eq;
      {
        __m256i a0 = _mm256_loadu_si256(reinterpret_cast<const __m256i*>(p));
        __m256i b0 =
            _mm256_loadu_si256(reinterpret_cast<const __m256i*>(p + 1));
        __m256i a1 =
            _mm256_loadu_si256(reinterpret_cast<const __m256i*>(p + 32));
        __m256i b1 =
            _mm256_loadu_si256(reinterpret_cast<const __m256i*>(p + 33));
        uint32_t eq0 = _mm256_movemask_epi8(_mm256_cmpeq_epi8(a0, b0));
        uint32_t eq1 = _mm256_movemask_epi8(_mm256_cmpeq_epi8(a1, b1));
        uint32_t le0 = _mm256_movemask_epi8(
            _mm256_cmpeq_epi8(_mm256_max_epu8(a0, b0), b0));
        uint32_t le1 = _mm256_movemask_epi8(
            _mm256_cmpeq_epi8(_mm256_max_epu8(a1, b1), b1));
        eq = (static_cast<uint64_t>(eq1) << 32) | eq0;
        uint64_t le = (static_cast<uint64_t>(le1) << 32) | le0;
        lt = le & ~eq;
      }
      // Seed bit 63 exactly: s63 = lt63 | (eq63 & carry).
      uint64_t s = lt;
      if (carry) s |= eq & 0x8000000000000000ull;
      uint64_t e = eq & ~0x8000000000000000ull;  // bit 63 resolved above
      for (int k = 1; k < 64; k <<= 1) {
        s |= e & (s >> k);
        e &= e >> k;
      }
      types[b] = s;
      carry = (s & 1) != 0;
    }
    // Pass 2: LMS = S with an L predecessor; position 0 is never LMS.
    for (i32 b = 0; b < words; ++b) {
      uint64_t s = types[b];
      uint64_t prev =
          (s << 1) | (b > 0 ? (types[b - 1] >> 63) : 1);  // bit i = s_{i-1}
      uint64_t lm = s & ~prev;
      while (lm) {
        i32 bit = __builtin_ctzll(lm);
        lm &= lm - 1;
        lms[m++] = 64 * b + bit;
      }
    }
  } else
#endif
  {
    SaPhase ph("typescan", 0);
    std::memset(types, 0, sizeof(uint64_t) * (static_cast<size_t>(words)));
    bool s_next = false;  // type of i+1; type(n-1) = L vs the sentinel
    for (i32 i = n - 2; i >= 0; --i) {
      bool s_cur =
          data[i] < data[i + 1] || (data[i] == data[i + 1] && s_next);
      if (s_cur) types[i >> 6] |= 1ull << (i & 63);
      if (s_next && !s_cur) lms[m++] = i + 1;
      s_next = s_cur;
    }
    std::reverse(lms, lms + m);
  }

  // Stage 1 + 2.  Partial-sort path (group marks in bit 30, see the
  // fused-naming and partial-induction block comments) when n fits;
  // unfused classical path otherwise.
  if (n <= MSK30 && n >= 2) {
    PartialRegions R;
    {
      SaPhase ph("hist4", 0);
      i32 h4[1024];
      hist4_u8(data, n, types, h4);
      partial_regions(h4, &R);
    }
    {
      SaPhase ph("seed1", 0);
      i32 seedh[256];
      std::copy(R.out_lo, R.out_lo + 256, seedh);
      for (i32 i = 0; i < m; ++i) {
        i32 p = lms[i];
        uint8_t c = data[p];
        sa[seedh[c]] = p | (seedh[c] == R.out_lo[c] ? MB30 : 0);
        seedh[c]++;
      }
    }
    {
      SaPhase ph("induce1", 0);
      partial_induce_u8(data, sa, n, &R);
    }
    i32* park =
        scratch.get_park(sizeof(i32) * (static_cast<size_t>(n) / 2 + 1));
    i32 name;
    {
      SaPhase ph("walk", 0);
      name = partial_renumber_u8(data, sa, n, &R, types, park);
    }
    if (sa_profile())
      fprintf(stderr, "[sa l0] n=%d m=%d name=%d partial\n", n, m, name);
    if (name < m) {
      {
        SaPhase ph("recurse", 0);
        solve_reduced_park(park, lms, sa, m, name, 1);
      }
      Buf sorted_b(sizeof(i32) * static_cast<size_t>(m));
      i32* sorted = sorted_b.as<i32>();
      for (i32 i = 0; i < m; ++i) sorted[i] = lms[sa[i + 1]];
      std::copy(sorted, sorted + m, lms);
    } else {
      std::copy(sa, sa + m, lms);
    }
    // Stage 3: scatter sorted LMS to bucket tails, final induction.
    {
      SaPhase ph("seed3", 0);
      std::fill(sa, sa + n, 0);
      bucket_bounds(cnt.data(), bkt.data(), 256, true);
      for (i32 i = m - 1; i >= 0; --i) {
        i32 p = lms[i];
        sa[--bkt[data[p]]] = -(p + 1);
      }
    }
    {
      SaPhase ph("induce3", 0);
      induce_u8(data, sa, n, bkt.data(), cnt.data());
    }
    // Strip the sign/offset encoding: |v| - 1.
    for (i32 i = 0; i < n; ++i) {
      i32 v = sa[i];
      sa[i] = (v < 0 ? -v : v) - 1;
    }
    return;
  }

  // ----- unfused path (n too large for bit-30 marks) -----
  {
    SaPhase ph("seed1", 0);
    std::fill(sa, sa + n, 0);
    bucket_bounds(cnt.data(), bkt.data(), 256, true);
    for (i32 i = m - 1; i >= 0; --i) {
      i32 p = lms[i];
      sa[--bkt[data[p]]] = -(p + 1);
    }
  }
  {
    SaPhase ph("induce1", 0);
    induce_u8(data, sa, n, bkt.data(), cnt.data());
  }

  // Compact sorted LMS positions to the front.  LMS(p) <=> entry is S-typed
  // and data[p-1] > data[p] (equal bytes would make p-1 S too).
  i32 q = 0;
  {
    SaPhase ph("compact", 0);
    for (i32 i = 0; i < n; ++i) {
      if (i + PFD < n) {
        i32 w = sa[i + PFD];
        if (w < 0) __builtin_prefetch(&data[-w - 2]);
      }
      i32 v = sa[i];
      if (v < 0) {
        i32 p = -v - 1;
        if (p > 0 && data[p - 1] > data[p]) sa[q++] = p;
      }
    }
  }
  // q == m by construction.

  // Stage 2: name LMS substrings.  Equality compares up to but EXCLUDING
  // the terminal LMS symbol: that symbol heads the NEXT LMS substring, so
  // the next name in the reduced sequence covers it — merging here shrinks
  // the reduced alphabet ~4x on natural text (and the text-final
  // substring, whose reduced suffix is a proper prefix of any same-named
  // interior one's, sorts first under the prefix-first convention exactly
  // as the virtual sentinel dictates).  Lengths are parked at sa[m + p/2]
  // (LMS positions are >= 2 apart), then overwritten by names; equal
  // length + memcmp replaces the per-byte walk.
  {
    SaPhase ph("parklen", 0);
    std::fill(sa + m, sa + n, -1);
    for (i32 i = 0; i < m; ++i) {
      i32 p = lms[i];
      i32 len = (i + 1 < m ? lms[i + 1] : n) - p;
      sa[m + p / 2] = len;
    }
  }
  i32 name = 0;
  {
    SaPhase ph("naming", 0);
    i32 prev = -1, prev_len = 0;
    for (i32 i = 0; i < m; ++i) {
      if (i + 8 < m) {
        i32 pp = sa[i + 8];
        __builtin_prefetch(&sa[m + pp / 2], 1);
        __builtin_prefetch(&data[pp]);
      }
      i32 pos = sa[i];
      i32 len = sa[m + pos / 2];
      bool differs =
          prev < 0 || len != prev_len ||
          std::memcmp(data + pos, data + prev, static_cast<size_t>(len)) != 0;
      if (differs) {
        ++name;
        prev = pos;
        prev_len = len;
      }
      sa[m + pos / 2] = name - 1;
    }
  }
  if (sa_profile())
    fprintf(stderr, "[sa l0] n=%d m=%d name=%d\n", n, m, name);

  if (name < m) {
    // Recurse on the reduced string of LMS names; the reduced SA comes
    // back in sa[0..m+1), ranks at slots 1..m.  Map back via lms[].
    {
      SaPhase ph("recurse", 0);
      solve_reduced(sa + m, n - m, sa, m, name, nullptr, 1);
    }
    Buf sorted_b(sizeof(i32) * static_cast<size_t>(m));
    i32* sorted = sorted_b.as<i32>();
    for (i32 i = 0; i < m; ++i) sorted[i] = lms[sa[i + 1]];
    std::copy(sorted, sorted + m, lms);
  }
  // (name == m: sa[0..m) is already the sorted LMS order.)
  else {
    std::copy(sa, sa + m, lms);
  }

  // Stage 3: scatter sorted LMS to bucket tails, final induction.
  {
    SaPhase ph("seed3", 0);
    std::fill(sa, sa + n, 0);
    bucket_bounds(cnt.data(), bkt.data(), 256, true);
    for (i32 i = m - 1; i >= 0; --i) {
      i32 p = lms[i];
      sa[--bkt[data[p]]] = -(p + 1);
    }
  }
  {
    SaPhase ph("induce3", 0);
    induce_u8(data, sa, n, bkt.data(), cnt.data());
  }
  // Strip the sign/offset encoding: |v| - 1.
  for (i32 i = 0; i < n; ++i) {
    i32 v = sa[i];
    sa[i] = (v < 0 ? -v : v) - 1;
  }
}

}  // namespace

extern "C" {

// Suffix array of a byte string; returns 0 on success.  sa_out must hold n
// int32 slots.  Convention: prefix-before-extension (see header comment).
i32 pss_build_sa_u8(const uint8_t* data, i32 n, i32* sa_out) {
  if (n < 0) return -1;
  if (n == 0) return 0;
  advise_huge(sa_out, static_cast<size_t>(n) * sizeof(i32));
  sais_u8(data, sa_out, n);
  return 0;
}

// Suffix array of an int32 string with values in [0, k) — the analogue of
// the reference kernel's integer-alphabet entry point (libsais_int,
// reference src/libsais/libsais.c:6612-6625).  Returns 0 on success.
i32 pss_build_sa_i32(const i32* data, i32 n, i32 k, i32* sa_out) {
  if (n < 0 || k <= 0 || k > 0x3FFFFFFE) return -1;
  if (n == 0) return 0;
  Buf st_b(sizeof(i32) * (static_cast<size_t>(n) + 1));
  i32* st = st_b.as<i32>();
  for (i32 i = 0; i < n; ++i) {
    if (data[i] < 0 || data[i] >= k) return -2;
    st[i] = data[i] + 1;
  }
  st[n] = 0;
  Buf sa_b(sizeof(i32) * (static_cast<size_t>(n) + 1));
  Buf lms_b(sizeof(i32) * (static_cast<size_t>(n) + 2));
  i32* sa = sa_b.as<i32>();
  sais_rec<i32>(st, sa, n + 1, k + 1, lms_b.as<i32>(), nullptr, 1);
  // sa[0] is the sentinel position n; the rest is the text's SA.
  std::memcpy(sa_out, sa + 1, static_cast<size_t>(n) * sizeof(i32));
  return 0;
}

// Inverse BWT under the libsais convention (see ops/bwt.py for the
// derivation; behavioral parity with libsais_unbwt, reference
// src/libsais/libsais.c:7551-7638): u is the BWT column with the sentinel
// row removed, primary_index its removed position.  Sequential LF walk —
// exactly the pointer-chase the device cannot vectorize, so it lives here.
i32 pss_unbwt(const uint8_t* u, i32 n, i32 primary_index, uint8_t* out) {
  if (n < 0 || primary_index < 1 || primary_index > n) return -1;
  if (n == 0) return 0;
  std::vector<i32> lf(static_cast<size_t>(n));
  i32 counts[256] = {0};
  for (i32 i = 0; i < n; ++i) counts[u[i]]++;
  i32 starts[256];
  i32 sum = 1;  // row 0 belongs to the sentinel
  for (i32 c = 0; c < 256; ++c) {
    starts[c] = sum;
    sum += counts[c];
  }
  for (i32 i = 0; i < n; ++i) lf[i] = starts[u[i]]++;
  i32 p = 0;
  for (i32 i = n - 1; i >= 0; --i) {
    i32 m = p < primary_index ? p : p - 1;
    out[i] = u[m];
    p = lf[m];
  }
  return p == primary_index ? 0 : -2;
}

// Batched lower/upper-bound probe over a host-resident (text, SA) chunk —
// the host twin of the device probe (ops/search.py), used by the Reader's
// big-batch extraction route where reading hit positions back over a slow
// host<->device link would cost more than recomputing bounds host-side.
// Mirrors the reference Reader's per-chunk binary searches
// (src/lib.rs:212-252) but over in-RAM arrays and a whole pattern batch.
// pats is [B, stride] zero-padded row-major; writes lo_out/cnt_out [B].
i32 pss_probe_batch(const uint8_t* data, i32 n, const i32* sa,
                      const uint8_t* pats, const i32* lens, i32 stride,
                      i32 B, i32* lo_out, i32* cnt_out) {
  if (n < 0 || B < 0 || stride < 0) return -1;
  for (i32 b = 0; b < B; ++b) {
    const uint8_t* P = pats + static_cast<size_t>(b) * stride;
    i32 L = lens[b];
    if (L > stride) return -2;
    // Lower bound: first slot whose suffix is >= P, where a suffix that
    // starts with P compares equal (reference src/lib.rs:219-228).
    i32 lo = 0, hi = n;
    while (lo < hi) {
      i32 mid = lo + (hi - lo) / 2;
      i32 pos = sa[mid];
      i32 avail = n - pos;
      i32 k = avail < L ? avail : L;
      int c = std::memcmp(data + pos, P, static_cast<size_t>(k));
      bool less = c < 0 || (c == 0 && avail < L);
      if (less)
        lo = mid + 1;
      else
        hi = mid;
    }
    i32 lower = lo;
    // Upper bound: first slot whose suffix is > P and not prefixed by it.
    hi = n;
    while (lo < hi) {
      i32 mid = lo + (hi - lo) / 2;
      i32 pos = sa[mid];
      i32 avail = n - pos;
      i32 k = avail < L ? avail : L;
      int c = std::memcmp(data + pos, P, static_cast<size_t>(k));
      if (c > 0)
        hi = mid;
      else
        lo = mid + 1;
    }
    lo_out[b] = lower;
    cnt_out[b] = lo - lower;
  }
  return 0;
}

// Newline-position scan used by index load (vectorizable memchr analogue).
// Writes at most cap positions; returns the total newline count.
i32 pss_find_newlines(const uint8_t* data, i32 n, i32* out, i32 cap) {
  i32 count = 0;
  for (i32 i = 0; i < n; ++i) {
    if (data[i] == 0x0A) {
      if (count < cap) out[count] = i;
      ++count;
    }
  }
  return count;
}
}

namespace {

// The container's mmap'd suffix-array views are 4-byte unaligned (each SA
// record starts right after an arbitrary-length text block); read through
// memcpy so the access is well-defined (compiles to a plain mov on x86).
static inline i32 ld32u(const i32* p) {
  i32 v;
  std::memcpy(&v, p, sizeof(v));
  return v;
}

// One (chunk, pattern) lower/upper-bound pair.  Same comparison convention
// as pss_probe_batch (mirroring the reference Reader's binary searches,
// src/lib.rs:212-252) plus the upper-bound seeding the reference applies
// with its left_anchor reuse (src/lib.rs:235-252): every lower-bound
// iteration that observed a suffix STRICTLY greater than the pattern is a
// valid right edge for the upper-bound search, so a miss finishes after one
// bisection and a hit's second bisection spans only the candidate range.
static inline void probe_one(const uint8_t* data, i32 n, const i32* sa,
                             const uint8_t* P, i32 L, i32* lo_out,
                             i32* cnt_out) {
  i32 lo = 0, hi = n, ub_hi = n;
  while (lo < hi) {
    i32 mid = lo + (hi - lo) / 2;
    i32 pos = ld32u(sa + mid);
    i32 avail = n - pos;
    i32 k = avail < L ? avail : L;
    int c = std::memcmp(data + pos, P, static_cast<size_t>(k));
    if (c < 0 || (c == 0 && avail < L)) {
      lo = mid + 1;
    } else {
      hi = mid;
      if (c > 0) ub_hi = mid;
    }
  }
  i32 lower = lo;
  hi = ub_hi;
  while (lo < hi) {
    i32 mid = lo + (hi - lo) / 2;
    i32 pos = ld32u(sa + mid);
    i32 avail = n - pos;
    i32 k = avail < L ? avail : L;
    int c = std::memcmp(data + pos, P, static_cast<size_t>(k));
    if (c > 0)
      hi = mid;
    else
      lo = mid + 1;
  }
  *lo_out = lower;
  *cnt_out = lo - lower;
}

// Run `work(unit)` over [0, units) on up to nthreads threads.  Units are
// handed out in contiguous blocks (locality: consecutive units share a
// chunk's text/SA working set); small workloads run inline — a thread spawn
// costs ~20 us, which would dominate single-query latency.
template <typename F>
static void run_units(int64_t units, i32 nthreads, int64_t block, F work) {
  int T = nthreads;
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (hw > 0 && T > hw) T = hw;
  if (T > units) T = static_cast<int>(units);
  if (T <= 1 || units <= block) {
    for (int64_t u = 0; u < units; ++u) work(u);
    return;
  }
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t u0 = next.fetch_add(block, std::memory_order_relaxed);
      if (u0 >= units) return;
      int64_t u1 = u0 + block < units ? u0 + block : units;
      for (int64_t u = u0; u < u1; ++u) work(u);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(static_cast<size_t>(T) - 1);
  for (int t = 1; t < T; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Batched probe over MANY host-resident chunks at once: the serving twin of
// the reference Reader's rayon fan-out (src/lib.rs:207-252), one call for
// the whole (chunk x pattern) grid.  datas/ns/sas describe nchunks chunks
// (SA pointers may be 4-byte unaligned mmap views); pats is [B, stride]
// zero-padded row-major.  Writes lo_out/cnt_out as [nchunks, B] row-major.
// nthreads > 1 fans (chunk, pattern) blocks across a transient pool; pass 1
// for latency-bound single queries.
i32 pss_probe_multi(i32 nchunks, const uint8_t* const* datas, const i32* ns,
                      const i32* const* sas, const uint8_t* pats,
                      const i32* lens, i32 stride, i32 B, i32* lo_out,
                      i32* cnt_out, i32 nthreads) {
  if (nchunks < 0 || B < 0 || stride < 0) return -1;
  for (i32 b = 0; b < B; ++b)
    if (lens[b] > stride || lens[b] < 0) return -2;
  int64_t units = static_cast<int64_t>(nchunks) * B;
  // Coarse fixed blocks: a round-5 A/B tried fine blocks so a single
  // query's nchunks cells would split across cores, and measured the
  // OPPOSITE (miss p50 46 -> 97 us at 63 chunks): thread spawn + wakeup
  // dwarfs the ~60 us of probe work, so small calls stay inline
  // (run_units runs units <= block on the calling thread).
  int64_t block = 256;
  run_units(units, nthreads, block, [&](int64_t u) {
    i32 c = static_cast<i32>(u / B);
    i32 b = static_cast<i32>(u % B);
    probe_one(datas[c], ns[c], sas[c], pats + static_cast<size_t>(b) * stride,
              lens[b], lo_out + u, cnt_out + u);
  });
  return 0;
}

// Resolve probe hits to DEDUPLICATED line spans, in global container
// coordinates.  For each (chunk, pattern) cell of lo/cnt ([nchunks, B]
// row-major, as produced by pss_probe_multi): gather the SA slice, walk
// each hit to its line start (backward memrchr — the reference's FinderRev,
// src/lib.rs:262-270), dedup by line-start offset (the reference's AHashSet
// on start offsets, src/lib.rs:271-277), and emit (start, end) pairs with
// text_offs[c] added so every span indexes one flat file buffer.  Spans for
// cell u are written at spans_out[2*out_base[u]] ascending; out_cnt[u] gets
// the deduplicated span count (<= cnt[u], so out_base = exclusive prefix
// sums of cnt always fits).  A chunk whose text lacks a trailing newline
// truncates its final line's last byte (reference quirk, src/lib.rs:268-270).
i32 pss_extract_spans(i32 nchunks, const uint8_t* const* datas,
                        const i32* ns, const i32* const* sas,
                        const int64_t* text_offs, const i32* lo,
                        const i32* cnt, i32 B, const int64_t* out_base,
                        int64_t* spans_out, i32* out_cnt, i32 nthreads) {
  if (nchunks < 0 || B < 0) return -1;
  int64_t units = static_cast<int64_t>(nchunks) * B;
  // Thread by hit VOLUME, not unit count: a single frequent pattern is few
  // units but much work, while a light batch isn't worth two thread spawns
  // (~20 us each).  block=1 keeps both cores busy across skewed cells.
  int64_t total_hits = 0;
  for (int64_t u = 0; u < units; ++u)
    if (cnt[u] > 0) total_hits += cnt[u];
  i32 T = total_hits >= 2048 ? nthreads : 1;
  int64_t block = units > 1024 ? 16 : 1;
  std::atomic<i32> rc(0);
  run_units(units, T, block, [&](int64_t u) {
    i32 c = static_cast<i32>(u / B);
    const uint8_t* d = datas[c];
    i32 n = ns[c];
    const i32* sa = sas[c];
    i32 l = lo[u], k = cnt[u];
    if (k <= 0 || n <= 0) {
      out_cnt[u] = 0;
      return;
    }
    if (l < 0 || l > n - k) {  // defensive: corrupt bounds -> no hits
      out_cnt[u] = 0;
      rc.store(1, std::memory_order_relaxed);
      return;
    }
    std::vector<i32> starts;
    starts.reserve(static_cast<size_t>(k));
    for (i32 i = 0; i < k; ++i) {
      if (i + 16 < k) {
        // Two-stage lookahead: fetch the SA entry far out, and the text
        // around an already-fetched entry nearer in — the memrchr walk's
        // first touches are the dominant misses of this loop.
        __builtin_prefetch(sa + l + i + 16);
        i32 pp = ld32u(sa + l + i + 8);
        if (pp > 0 && pp < n) __builtin_prefetch(d + pp - 1);
      }
      i32 pos = ld32u(sa + l + i);
      if (pos < 0 || pos >= n) {
        rc.store(1, std::memory_order_relaxed);
        continue;
      }
      const void* p = pos > 0 ? memrchr(d, '\n', static_cast<size_t>(pos))
                              : nullptr;
      starts.push_back(
          p ? static_cast<i32>(static_cast<const uint8_t*>(p) - d) + 1 : 0);
    }
    std::sort(starts.begin(), starts.end());
    starts.erase(std::unique(starts.begin(), starts.end()), starts.end());
    int64_t* out = spans_out + 2 * out_base[u];
    int64_t off = text_offs[c];
    i32 m = 0;
    for (size_t si = 0; si < starts.size(); ++si) {
      if (si + 8 < starts.size()) __builtin_prefetch(d + starts[si + 8]);
      i32 s = starts[si];
      const void* q = memchr(d + s, '\n', static_cast<size_t>(n - s));
      i32 e = q ? static_cast<i32>(static_cast<const uint8_t*>(q) - d)
                : n - 1;
      out[2 * m] = off + s;
      out[2 * m + 1] = off + e;
      ++m;
    }
    out_cnt[u] = m;
  });
  return rc.load() ? -3 : 0;
}
}
