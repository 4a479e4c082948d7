// Native host-side runtime for sprintz_jax: emission planner and header
// walk. These are the only intrinsically sequential, per-block host loops
// in the framework (stream-order bookkeeping); the data path runs on the accelerator.
//
// Semantics mirror sprintz_jax/planner.py:build_plan and
// sprintz_jax/decoder.py:walk_headers exactly (shared test suite), which
// in turn replicate the reference encoder's consumption order
// (sprintz_delta_rle.cpp:214-312).

#include <cstdint>
#include <cstring>

#include <algorithm>
#include <array>
#include <atomic>
#include <thread>
#include <vector>

#if defined(__BMI2__) || defined(__AVX2__) || defined(__SSE2__)
#include <immintrin.h>
#endif

namespace {

constexpr int kBlockSz = 8;
constexpr int kGroupSzBlocks = 2;
constexpr int kMaxRunNblocks = 0x7fff;

constexpr int8_t kKindData = 0;
constexpr int8_t kKindRun = 1;
constexpr int8_t kKindRun0 = 2;

inline void cpu_pause() {
#if defined(__SSE2__)
  _mm_pause();
#endif
}

#if defined(__AVX2__)
// Byte masks for the branchless gather: mask[w] keeps the first w of 64
// bytes. Rows load a full vector, AND with mask[w], store full width —
// no per-row branches or variable-length memcpy/memset pairs.
const auto kByteMask = [] {
  std::array<std::array<uint8_t, 64>, 65> m{};
  for (int w = 0; w <= 64; ++w)
    for (int i = 0; i < 64; ++i) m[(size_t)w][(size_t)i] = i < w ? 0xFF : 0;
  return m;
}();
#endif

// Copy one rowmajor block (kBlockSz rows of w valid bytes, maxb stride,
// zero tails). Branchless masked-vector path when the over-read past
// the last row stays inside the buffer; scalar fallback otherwise.
inline void copy_block_rows(const uint8_t* buf, int64_t buf_len,
                            int64_t off, int64_t w, uint8_t* d,
                            int64_t maxb) {
  const uint8_t* s = buf + off;
#if defined(__AVX2__)
  if (maxb == 32 && off + (kBlockSz - 1) * w + 32 <= buf_len) {
    const __m256i m =
        _mm256_loadu_si256((const __m256i*)kByteMask[(size_t)w].data());
    // (non-temporal stores A/B'd here: 2.37 -> 1.91 GB/s fused on the
    // 64 MiB u8 stream — the dense buffer is re-read soon by the
    // param-prep pass, so cache-bypassing writes lose)
    for (int r = 0; r < kBlockSz; ++r)
      _mm256_storeu_si256(
          (__m256i*)(d + r * 32),
          _mm256_and_si256(
              _mm256_loadu_si256((const __m256i*)(s + r * w)), m));
    return;
  }
  if (maxb == 64 && off + (kBlockSz - 1) * w + 64 <= buf_len) {
    const __m256i m0 =
        _mm256_loadu_si256((const __m256i*)kByteMask[(size_t)w].data());
    const __m256i m1 = _mm256_loadu_si256(
        (const __m256i*)(kByteMask[(size_t)w].data() + 32));
    for (int r = 0; r < kBlockSz; ++r) {
      _mm256_storeu_si256(
          (__m256i*)(d + r * 64),
          _mm256_and_si256(
              _mm256_loadu_si256((const __m256i*)(s + r * w)), m0));
      _mm256_storeu_si256(
          (__m256i*)(d + r * 64 + 32),
          _mm256_and_si256(
              _mm256_loadu_si256((const __m256i*)(s + r * w + 32)), m1));
    }
    return;
  }
  if (maxb == 16 && off + (kBlockSz - 1) * w + 16 <= buf_len) {
    const __m128i m =
        _mm_loadu_si128((const __m128i*)kByteMask[(size_t)w].data());
    for (int r = 0; r < kBlockSz; ++r)
      _mm_storeu_si128(
          (__m128i*)(d + r * 16),
          _mm_and_si128(_mm_loadu_si128((const __m128i*)(s + r * w)), m));
    return;
  }
  if (maxb == 8 && off + (kBlockSz - 1) * w + 8 <= buf_len) {
    uint64_t m;
    memcpy(&m, kByteMask[(size_t)w].data(), 8);
    for (int r = 0; r < kBlockSz; ++r) {
      uint64_t v;
      memcpy(&v, s + r * w, 8);
      v &= m;
      memcpy(d + r * 8, &v, 8);
    }
    return;
  }
#endif
  for (int r = 0; r < kBlockSz; ++r) {
    memcpy(d + r * maxb, s + r * w, (size_t)w);
    memset(d + r * maxb + w, 0, (size_t)(maxb - w));
  }
}

}  // namespace

extern "C" {

// Derive the slot event sequence from per-block zero flags.
// kinds_out/values_out must hold >= 2 * nb_max + kGroupSzBlocks entries.
// out_meta: [nslots, ngroups, consumed_blocks, remaining_elems]
int64_t sprintz_build_plan(
    const uint8_t* zero_flags, int64_t n_elems, int32_t ndims,
    int32_t run_cmp_allows_equal,
    int8_t* kinds_out, int32_t* values_out, int64_t* out_meta) {
  const int64_t block_elems = (int64_t)kBlockSz * ndims;
  const int64_t group_sz = block_elems * kGroupSzBlocks;
  const int64_t last_start = n_elems - group_sz;

  int64_t nslots = 0;
  int64_t i = 0;
  int32_t run = 0;
  bool finished = false;

  while (i <= last_start && !finished) {
    int b = 0;
    while (b < kGroupSzBlocks) {
      const int64_t bidx = i / block_elems;
      const bool z = zero_flags[bidx] != 0;
      for (;;) {  // just_read_block
        if (z && run < kMaxRunNblocks) {
          run++;
          i += block_elems;
          const bool more =
              run_cmp_allows_equal ? (i <= last_start) : (i < last_start);
          if (more) break;  // read next block, same group position
          kinds_out[nslots] = kKindRun;
          values_out[nslots++] = run;
          run = 0;
          b++;
          while (b < kGroupSzBlocks) {
            kinds_out[nslots] = kKindRun0;
            values_out[nslots++] = 0;
            b++;
          }
          finished = true;
          break;
        }
        if (run > 0) {
          kinds_out[nslots] = kKindRun;
          values_out[nslots++] = run;
          run = 0;
          b++;
          if (b == kGroupSzBlocks) {
            b = 0;
            continue;  // same block becomes next group's first slot
          }
          if (z) continue;  // run cap hit on a zero block
        }
        kinds_out[nslots] = kKindData;
        values_out[nslots++] = (int32_t)bidx;
        i += block_elems;
        b++;
        break;
      }
      if (finished) break;
    }
  }

  out_meta[0] = nslots;
  out_meta[1] = nslots / kGroupSzBlocks;
  out_meta[2] = i / block_elems;
  out_meta[3] = n_elems - i;
  return nslots;
}

// Walk group headers to index payloads and runs.
// widths_out: ndata_max * ndims; offsets_out/out_rows_out: ndata_max.
// out_meta: [ndata, total_rows, tail_offset]
// Bounds-checked: buf_len is the real buffer length (the caller may pad
// one extra readable byte beyond it for the 2-byte field loads); returns
// -1 if the declared structure would read past buf_len — the stream is
// truncated or its metadata lies (the format carries no checksums, so
// this is the only defense; cf. format.h:47-62 which trusts blindly).
static int64_t sprintz_walk_impl(
    const uint8_t* buf, int64_t buf_len, int64_t start, int64_t ngroups,
    int32_t ndims, int32_t elem_sz, int32_t lowdim,
    uint8_t* widths_out, int64_t* offsets_out, int64_t* out_rows_out,
    int64_t* out_meta, int32_t* rb_out,
    std::atomic<int64_t>* published) {
  const int hdr_bits = elem_sz == 1 ? 3 : 4;
  const int elem_bits = 8 * elem_sz;
  const int64_t total_header_bits =
      (int64_t)ndims * hdr_bits * kGroupSzBlocks;
  const int64_t total_header_bytes = (total_header_bits + 7) / 8;

  int64_t pos = start;
  int64_t row = 0;
  int64_t ndata = 0;

#if defined(__BMI2__)
  // Vectorized width extraction: when ndims % 8 == 0 each block's
  // fields start byte-aligned, and PDEP expands 8 packed 3/4-bit
  // fields into 8 bytes in one instruction. The elem_bits-1 ->
  // elem_bits promotion and the width sum run as SWAR on the same u64
  // (promoted bytes stay <= 16, so the multiply-sum cannot carry;
  // cross-byte shift leakage dies in the 0x01 masks). The 4-byte loads
  // may read 1 byte past the last header byte — covered by the
  // caller's one-pad-byte guarantee past buf_len.
  const bool fast8 = (ndims % 8 == 0);
#endif

  for (int64_t g = 0; g < ngroups; g++) {
    if (pos + total_header_bytes > buf_len) return -1;
    // the group advance is a serial pointer chase (pos depends on the
    // parsed widths), which defeats hardware prefetch across the
    // ~0.3 KB group stride; software-prefetch ahead (measured: u8 d64
    // walk 3.5 -> 5.4 GB/s on the 64 MiB stream)
    __builtin_prefetch(buf + pos + 512);
    __builtin_prefetch(buf + pos + 1024);
    const uint8_t* hdr = buf + pos;
    pos += total_header_bytes;
    int64_t bitpos = 0;
    for (int b = 0; b < kGroupSzBlocks; b++) {
      int64_t wsum = 0;
      uint8_t* wrow = widths_out + ndata * ndims;
#if defined(__BMI2__)
      if (fast8) {
        const uint8_t* hb = hdr + (bitpos >> 3);
        if (hdr_bits == 3) {
          for (int k = 0; k < ndims / 8; k++) {
            uint32_t bits;
            memcpy(&bits, hb + 3 * k, 4);
            uint64_t w = _pdep_u64(bits, 0x0707070707070707ULL);
            w += w & (w >> 1) & (w >> 2) & 0x0101010101010101ULL;
            memcpy(wrow + 8 * k, &w, 8);
            wsum += (int64_t)((w * 0x0101010101010101ULL) >> 56);
          }
        } else {
          for (int k = 0; k < ndims / 8; k++) {
            uint32_t bits;
            memcpy(&bits, hb + 4 * k, 4);
            uint64_t w = _pdep_u64(bits, 0x0F0F0F0F0F0F0F0FULL);
            w += w & (w >> 1) & (w >> 2) & (w >> 3) & 0x0101010101010101ULL;
            memcpy(wrow + 8 * k, &w, 8);
            wsum += (int64_t)((w * 0x0101010101010101ULL) >> 56);
          }
        }
      } else
#endif
      {
        for (int d = 0; d < ndims; d++) {
          const int64_t bp = bitpos + (int64_t)d * hdr_bits;
          // fields never span more than 2 bytes (3/4-bit fields); the
          // caller guarantees one readable pad byte past buf_len
          const uint32_t two =
              (uint32_t)hdr[bp >> 3] | ((uint32_t)hdr[(bp >> 3) + 1] << 8);
          int32_t h = (two >> (bp & 7)) & ((1u << hdr_bits) - 1);
          if (h == elem_bits - 1) h = elem_bits;
          wrow[d] = (uint8_t)h;
          wsum += h;
        }
      }
      bitpos += (int64_t)ndims * hdr_bits;
      if (wsum == 0) {
        if (pos >= buf_len) return -1;
        const uint8_t low = buf[pos++];
        int32_t length = low & 0x7f;
        if (low & 0x80) {
          if (pos >= buf_len) return -1;
          length |= (int32_t)buf[pos++] << 7;
        }
        row += (int64_t)length * kBlockSz;
        continue;
      }
      offsets_out[ndata] = pos;
      out_rows_out[ndata] = row;
      if (lowdim) {
        pos += wsum;  // 8 * w bits == w bytes per dim
      } else {
        pos += (int64_t)kBlockSz * ((wsum + 7) / 8);
      }
      if (pos > buf_len) return -1;
      if (rb_out) rb_out[ndata] = (int32_t)((wsum + 7) / 8);
      ndata++;
      if (published)
        published->store(ndata, std::memory_order_release);
      row += kBlockSz;
    }
  }

  out_meta[0] = ndata;
  out_meta[1] = row;
  out_meta[2] = pos;
  return ndata;
}

int64_t sprintz_walk_headers(
    const uint8_t* buf, int64_t buf_len, int64_t start, int64_t ngroups,
    int32_t ndims, int32_t elem_sz, int32_t lowdim,
    uint8_t* widths_out, int64_t* offsets_out, int64_t* out_rows_out,
    int64_t* out_meta) {
  return sprintz_walk_impl(buf, buf_len, start, ngroups, ndims, elem_sz,
                           lowdim, widths_out, offsets_out, out_rows_out,
                           out_meta, nullptr, nullptr);
}

// Segment-parallel header walk: segment s covers groups
// [s*every_groups, ...) starting at byte_offsets[s] (from a checkpoint
// sidecar) with first output row row_offsets[s]. Segments walk on
// std::threads into per-segment scratch, then compact in stream order —
// the host-stage parallelization of the north-star decode plan.
// Outputs as sprintz_walk_headers (capacities 2*ngroups).
// Returns ndata, -1 on overrun, -2 if a segment's row count contradicts
// the sidecar (corrupt/mismatched sidecar).
int64_t sprintz_walk_headers_parallel(
    const uint8_t* buf, int64_t buf_len, const int64_t* byte_offsets,
    const int64_t* row_offsets, int64_t nseg, int64_t every_groups,
    int64_t ngroups, int32_t ndims, int32_t elem_sz, int32_t lowdim,
    uint8_t* widths_out, int64_t* offsets_out, int64_t* out_rows_out,
    int64_t* out_meta) {
  const int64_t cap_seg = 2 * every_groups;
  std::vector<uint8_t> w_s((size_t)(nseg * cap_seg) * ndims);
  std::vector<int64_t> o_s((size_t)(nseg * cap_seg));
  std::vector<int64_t> r_s((size_t)(nseg * cap_seg));
  std::vector<int64_t> nd(nseg), rows(nseg), tails(nseg);
  std::atomic<bool> bad{false};
  int nthreads = (int)std::min<int64_t>(
      std::max<int64_t>(nseg / 8, 1),
      std::max(1u, std::thread::hardware_concurrency()));
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t s = lo; s < hi && !bad.load(std::memory_order_relaxed);
         ++s) {
      const int64_t g0 = s * every_groups;
      const int64_t g1 = std::min(g0 + every_groups, ngroups);
      int64_t meta[3];
      const int64_t n = sprintz_walk_headers(
          buf, buf_len, byte_offsets[s], g1 - g0, ndims, elem_sz, lowdim,
          w_s.data() + (size_t)(s * cap_seg) * ndims,
          o_s.data() + s * cap_seg, r_s.data() + s * cap_seg, meta);
      if (n < 0) {
        bad.store(true, std::memory_order_relaxed);
        return;
      }
      nd[s] = n;
      rows[s] = meta[1];
      tails[s] = meta[2];
    }
  };
  if (nthreads <= 1) {
    work(0, nseg);
  } else {
    std::vector<std::thread> ts;
    const int64_t per = (nseg + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
      const int64_t lo = t * per, hi = std::min(nseg, lo + per);
      if (lo >= hi) break;
      ts.emplace_back(work, lo, hi);
    }
    for (auto& th : ts) th.join();
  }
  if (bad.load()) return -1;
  for (int64_t s = 0; s + 1 < nseg; ++s)
    if (row_offsets[s] + rows[s] != row_offsets[s + 1]) return -2;
  std::vector<int64_t> starts(nseg + 1);
  starts[0] = 0;
  for (int64_t s = 0; s < nseg; ++s) starts[s + 1] = starts[s] + nd[s];
  auto compact = [&](int64_t lo, int64_t hi) {
    for (int64_t s = lo; s < hi; ++s) {
      const int64_t base = starts[s];
      memcpy(widths_out + (size_t)base * ndims,
             w_s.data() + (size_t)(s * cap_seg) * ndims,
             (size_t)nd[s] * ndims);
      for (int64_t i = 0; i < nd[s]; ++i) {
        offsets_out[base + i] = o_s[s * cap_seg + i];
        out_rows_out[base + i] = r_s[s * cap_seg + i] + row_offsets[s];
      }
    }
  };
  if (nthreads <= 1) {
    compact(0, nseg);
  } else {
    std::vector<std::thread> ts;
    const int64_t per = (nseg + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
      const int64_t lo = t * per, hi = std::min(nseg, lo + per);
      if (lo >= hi) break;
      ts.emplace_back(compact, lo, hi);
    }
    for (auto& th : ts) th.join();
  }
  out_meta[0] = starts[nseg];
  out_meta[1] = row_offsets[nseg - 1] + rows[nseg - 1];
  out_meta[2] = tails[nseg - 1];
  return starts[nseg];
}

// ---------------------------------------------------------------------
// Entropy stage: chunked canonical Huffman (the paper's +Huf role,
// communicate/method.tex:300-303 — the reference pipes through Huff0 on
// the CPU; in-repo entropy.cpp is an empty stub). Table construction
// stays in Python (O(alphabet) work); these are the per-byte hot loops.

// Gather packed payload rows into the dense per-block decode buffer
// (decoder.gather_payloads hot path — numpy's per-element fancy
// indexing measured ~0.1 GB/s; this is a bounds-checked memcpy per
// row, threaded over units). Returns 0, or -1 on out-of-range units
// (truncated/corrupt stream).
// Specialized block gather: block i = kBlockSz rows of rb[i] bytes at
// offsets[i], landing at out[i * kBlockSz * maxb + r * maxb]. Computes
// unit indices inline — the generic-unit path spent as long building
// its numpy src/dst/len arrays (3 x 8 x ndata int64 = ~3x the payload
// bytes) as copying. Threaded over blocks. Returns 0 / -1 on overrun.
int64_t sprintz_gather_blocks(
    const uint8_t* buf, int64_t buf_len,
    const int64_t* offsets, const int64_t* rb, int64_t ndata,
    int64_t maxb, uint8_t* out, int64_t out_len) {
  for (int64_t i = 0; i < ndata; ++i) {
    if (rb[i] < 0 || rb[i] > maxb || offsets[i] < 0 ||
        offsets[i] + kBlockSz * rb[i] > buf_len ||
        (i + 1) * kBlockSz * maxb > out_len)
      return -1;
  }
  int nthreads = (int)std::min<int64_t>(
      std::max<int64_t>(ndata / 4096, 1),
      std::max(1u, std::thread::hardware_concurrency()));
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      // callers pass an UNINITIALIZED buffer: copy_block_rows zeroes
      // only the row tails (np.zeros would memset a second time)
      copy_block_rows(buf, buf_len, offsets[i], rb[i],
                      out + i * kBlockSz * maxb, maxb);
    }
  };
  if (nthreads <= 1) {
    work(0, ndata);
    return 0;
  }
  std::vector<std::thread> ts;
  int64_t per = (ndata + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * per, hi = std::min(ndata, lo + per);
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& th : ts) th.join();
  return 0;
}

// Fused, OVERLAPPED header walk + payload gather (rowmajor streams).
// The walker (calling thread) runs the serial header walk, publishing
// indexed blocks through an atomic counter; worker threads trail it,
// masked-copying payload rows into the dense buffer while the walked
// bytes are still cache-hot — wall ~ max(walk, gather) instead of the
// sum (the host half of the composed single-chip decode pipeline,
// VERDICT r4 item 5).
// maxb is the caller's dense row stride GUESS (bucketed from a sampled
// prefix). Returns ndata; -1 on a corrupt/truncated stream (as the
// plain walk); -3 if some block's row bytes exceed maxb or dense_len
// is short — the caller re-runs with the next bucket.
int64_t sprintz_walk_gather(
    const uint8_t* buf, int64_t buf_len, int64_t start, int64_t ngroups,
    int32_t ndims, int32_t elem_sz, int64_t maxb,
    uint8_t* widths_out, int64_t* offsets_out, int64_t* out_rows_out,
    uint8_t* dense_out, int64_t dense_len, int64_t* out_meta) {
  const int64_t cap = 2 * std::max<int64_t>(ngroups, 1);
  std::vector<int32_t> rb((size_t)cap);
  std::atomic<int64_t> published{0};  // blocks indexed so far
  std::atomic<int64_t> cursor{0};     // next block index to claim
  std::atomic<bool> done{false}, overflow{false};

  const int nworkers = (int)std::min<int64_t>(
      std::max(1, (int)std::thread::hardware_concurrency() - 1),
      std::max<int64_t>(ngroups / 512, 1));

  auto worker = [&]() {
    constexpr int64_t kBatch = 128;
    for (;;) {
      const int64_t lo = cursor.fetch_add(kBatch,
                                          std::memory_order_relaxed);
      int64_t avail = published.load(std::memory_order_acquire);
      while (avail <= lo) {
        if (done.load(std::memory_order_acquire)) {
          if (published.load(std::memory_order_acquire) <= lo) return;
        }
        cpu_pause();
        avail = published.load(std::memory_order_acquire);
      }
      const int64_t hi = lo + kBatch;
      for (int64_t i = lo; i < hi; ++i) {
        while (i >= avail) {
          if (done.load(std::memory_order_acquire)) {
            avail = published.load(std::memory_order_acquire);
            if (i >= avail) return;  // stream ended mid-batch
            break;
          }
          cpu_pause();
          avail = published.load(std::memory_order_acquire);
        }
        const int64_t w = rb[(size_t)i];
        if (w > maxb || (i + 1) * kBlockSz * maxb > dense_len) {
          overflow.store(true, std::memory_order_relaxed);
          return;
        }
        copy_block_rows(buf, buf_len, offsets_out[i], w,
                        dense_out + i * kBlockSz * maxb, maxb);
      }
    }
  };

  std::vector<std::thread> ts;
  for (int t = 0; t < nworkers; ++t) ts.emplace_back(worker);
  const int64_t n = sprintz_walk_impl(
      buf, buf_len, start, ngroups, ndims, elem_sz, /*lowdim=*/0,
      widths_out, offsets_out, out_rows_out, out_meta, rb.data(),
      &published);
  done.store(true, std::memory_order_release);
  // the walk outruns the gather (~5.4 vs ~4 GB/s measured): once it
  // has published everything, this thread's core would idle while the
  // workers drain the backlog — join the gather as worker nworkers+1
  if (n >= 0) worker();
  for (auto& th : ts) th.join();
  if (n < 0) return n;
  if (overflow.load()) return -3;
  return n;
}

// Lowdim twin: block i = ndims sections of widths[i*ndims + d] bytes
// each (a lowdim dim field is exactly its width in bytes), landing at
// out[(i * ndims + d) * eb].
int64_t sprintz_gather_dims(
    const uint8_t* buf, int64_t buf_len,
    const int64_t* offsets, const int32_t* widths, int64_t ndata,
    int32_t ndims, int64_t eb, uint8_t* out, int64_t out_len) {
  for (int64_t i = 0; i < ndata; ++i) {
    int64_t tot = 0;
    for (int32_t d = 0; d < ndims; ++d) {
      int32_t w = widths[i * ndims + d];
      if (w < 0 || w > eb) return -1;
      tot += w;
    }
    if (offsets[i] < 0 || offsets[i] + tot > buf_len ||
        (i + 1) * ndims * eb > out_len)
      return -1;
  }
  int nthreads = (int)std::min<int64_t>(
      std::max<int64_t>(ndata / 4096, 1),
      std::max(1u, std::thread::hardware_concurrency()));
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* s = buf + offsets[i];
      uint8_t* d = out + i * ndims * eb;
      for (int32_t k = 0; k < ndims; ++k) {
        int32_t w = widths[i * ndims + k];
        memcpy(d + k * eb, s, (size_t)w);
        memset(d + k * eb + w, 0, (size_t)(eb - w));
        s += w;
      }
    }
  };
  if (nthreads <= 1) {
    work(0, ndata);
    return 0;
  }
  std::vector<std::thread> ts;
  int64_t per = (ndata + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * per, hi = std::min(ndata, lo + per);
    if (lo >= hi) break;
    ts.emplace_back(work, lo, hi);
  }
  for (auto& th : ts) th.join();
  return 0;
}

int64_t sprintz_gather_units(
    const uint8_t* buf, int64_t buf_len,
    const int64_t* src, const int64_t* dst, const int64_t* len,
    int64_t n_units, uint8_t* out, int64_t out_len) {
  for (int64_t i = 0; i < n_units; ++i) {
    if (len[i] < 0 || src[i] < 0 || src[i] + len[i] > buf_len ||
        dst[i] < 0 || dst[i] + len[i] > out_len)
      return -1;
  }
  int nthreads = (int)std::min<int64_t>(
      std::max<int64_t>(n_units / 65536, 1),
      std::max(1u, std::thread::hardware_concurrency()));
  if (nthreads <= 1) {
    for (int64_t i = 0; i < n_units; ++i)
      memcpy(out + dst[i], buf + src[i], (size_t)len[i]);
    return 0;
  }
  std::vector<std::thread> ts;
  int64_t per = (n_units + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * per, hi = std::min(n_units, lo + per);
    if (lo >= hi) break;
    ts.emplace_back([=]() {
      for (int64_t i = lo; i < hi; ++i)
        memcpy(out + dst[i], buf + src[i], (size_t)len[i]);
    });
  }
  for (auto& th : ts) th.join();
  return 0;
}

// Byte histogram (np.bincount round-trips through int64; this is the
// table-build hot loop). 4 sub-counters break the store-to-load
// dependency chain on repeated symbols.
void sprintz_histogram(const uint8_t* data, int64_t n, int64_t* counts) {
  int64_t c[4][256] = {};
  int64_t i = 0;
  for (; i + 4 <= n; i += 4) {
    c[0][data[i]]++;
    c[1][data[i + 1]]++;
    c[2][data[i + 2]]++;
    c[3][data[i + 3]]++;
  }
  for (; i < n; i++) c[0][data[i]]++;
  for (int s = 0; s < 256; s++)
    counts[s] = c[0][s] + c[1][s] + c[2][s] + c[3][s];
}

// Encode n symbols into per-chunk bit-packed payloads (LSB-first, same
// layout as the numpy emitter in sprintz_jax/entropy/huffman.py).
// codes/lengths: canonical LSB-first per symbol. sizes_out: nchunks u32
// payload byte counts. Returns total payload bytes, or -1 if out_cap hit.
int64_t sprintz_huff_encode(
    const uint8_t* data, int64_t n, int64_t chunk_symbols,
    const uint32_t* codes, const uint8_t* lengths,
    uint8_t* out, int64_t out_cap, uint32_t* sizes_out) {
  const int64_t nchunks = n > 0 ? (n + chunk_symbols - 1) / chunk_symbols : 1;
  int64_t pos = 0;
  for (int64_t c = 0; c < nchunks; c++) {
    const int64_t lo = c * chunk_symbols;
    const int64_t hi = lo + chunk_symbols < n ? lo + chunk_symbols : n;
    uint64_t acc = 0;
    int nbits = 0;
    const int64_t start = pos;
    for (int64_t i = lo; i < hi; i++) {
      const uint8_t s = data[i];
      acc |= (uint64_t)codes[s] << nbits;
      nbits += lengths[s];
      // word-at-a-time flush: max 12 bits/symbol keeps acc < 2^44
      if (nbits >= 32) {
        if (pos + 4 > out_cap) return -1;
        memcpy(out + pos, &acc, 4);
        pos += 4;
        acc >>= 32;
        nbits -= 32;
      }
    }
    while (nbits > 0) {
      if (pos >= out_cap) return -1;
      out[pos++] = (uint8_t)acc;
      acc >>= 8;
      nbits -= 8;
    }
    sizes_out[c] = (uint32_t)(pos - start);
  }
  return pos;
}

namespace {

// one thread's worth of chunk decodes; returns false on corrupt input
bool huff_decode_range(
    const uint8_t* buf, const int64_t* offsets, const uint32_t* sizes,
    int64_t c_begin, int64_t c_end, int64_t chunk_symbols, int64_t n,
    const uint8_t* sym_lut, const uint8_t* len_lut, uint8_t* out) {
  for (int64_t c = c_begin; c < c_end; c++) {
    const uint8_t* p = buf + offsets[c];
    const int64_t nbytes = sizes[c];
    const int64_t lo = c * chunk_symbols;
    const int64_t hi = lo + chunk_symbols < n ? lo + chunk_symbols : n;
    uint64_t acc = 0;
    int nbits = 0;
    int64_t bpos = 0;
    for (int64_t i = lo; i < hi; i++) {
      // word-at-a-time refill (keeps >= 32 bits buffered in the fast path)
      if (nbits < 12) {
        if (bpos + 4 <= nbytes) {
          uint32_t w;
          memcpy(&w, p + bpos, 4);
          acc |= (uint64_t)w << nbits;
          bpos += 4;
          nbits += 32;
        } else {
          while (nbits < 12 && bpos < nbytes) {
            acc |= (uint64_t)p[bpos++] << nbits;
            nbits += 8;
          }
        }
      }
      const uint32_t peek = (uint32_t)(acc & 0xfff);
      out[i] = sym_lut[peek];
      const int L = len_lut[peek];
      acc >>= L;
      nbits -= L;
      if (nbits < 0) return false;  // corrupt: code ran past the payload
    }
  }
  return true;
}

}  // namespace

// Table-driven decode of nchunks payloads back into symbols, threaded
// over independent chunk ranges (each chunk's output region is fixed:
// chunk_symbols symbols).
// sym_lut/len_lut: 4096-entry (12-bit LSB-first peek) tables.
// offsets: absolute byte offset of each chunk payload in buf.
int64_t sprintz_huff_decode(
    const uint8_t* buf, const int64_t* offsets, const uint32_t* sizes,
    int64_t nchunks, int64_t chunk_symbols, int64_t n,
    const uint8_t* sym_lut, const uint8_t* len_lut, uint8_t* out) {
  int nthreads = (int)std::thread::hardware_concurrency();
  nthreads = std::max(1, std::min({nthreads, 16, (int)(nchunks / 4)}));
  if (nthreads <= 1 || n < (1 << 20)) {
    return huff_decode_range(buf, offsets, sizes, 0, nchunks,
                             chunk_symbols, n, sym_lut, len_lut, out)
               ? n
               : -1;
  }
  std::vector<std::thread> threads;
  std::vector<char> ok(nthreads, 1);
  const int64_t per = (nchunks + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; t++) {
    const int64_t c0 = t * per;
    const int64_t c1 = std::min(nchunks, c0 + per);
    if (c0 >= c1) break;
    threads.emplace_back([=, &ok] {
      ok[t] = huff_decode_range(buf, offsets, sizes, c0, c1,
                                chunk_symbols, n, sym_lut, len_lut, out);
    });
  }
  for (auto& th : threads) th.join();
  for (int t = 0; t < nthreads; t++)
    if (!ok[t]) return -1;
  return n;
}

}  // extern "C"

// Assemble the final byte stream from an emission plan and per-block
// device outputs. Mirrors sprintz_jax/encoder.py:assemble_stream (shared
// tests assert byte equality). Returns total bytes written, or -1 if
// out_cap would be exceeded.
//
// Two-pass design so emission parallelizes: pass 1 computes every
// group's byte size (cheap prefix bookkeeping, like build_plan), pass 2
// emits groups into their now-known disjoint output ranges, threaded
// over group ranges. Groups — not slots — are the parallel unit because
// the two blocks of a group share header BYTES (their 3/4-bit fields
// are bit-packed back to back, format §2.2), so per-slot threads would
// race on the boundary byte.
extern "C" int64_t sprintz_assemble_stream(
    const int8_t* kinds, const int32_t* values, int64_t nslots,
    int64_t ngroups, int64_t remaining_elems,
    const int32_t* widths,   // (nb, ndims) per-block field widths
    const uint8_t* hdrvals,  // (nb, ndims) stored header fields
    const uint8_t* dense,    // (nb, 8, maxb) rowmajor | (nb, ndims, maxb) lowdim
    int64_t maxb, int32_t ndims, int32_t elem_sz, int32_t lowdim,
    const uint8_t* tail, int64_t tail_nbytes,
    uint8_t* out, int64_t out_cap,
    const int32_t* wsums) {  // optional (nb,) per-block width sums:
                             // the device encode pass already computed
                             // them; skips the O(nslots*ndims) resum
  const int hdr_bits = elem_sz == 1 ? 3 : 4;
  const int64_t total_header_bytes =
      ((int64_t)ndims * hdr_bits * kGroupSzBlocks + 7) / 8;

  if (out_cap < 8) return -1;
  // metadata {u32 ngroups, u16 remaining, u16 ndims} LE
  out[0] = (uint8_t)(ngroups);
  out[1] = (uint8_t)(ngroups >> 8);
  out[2] = (uint8_t)(ngroups >> 16);
  out[3] = (uint8_t)(ngroups >> 24);
  out[4] = (uint8_t)(remaining_elems);
  out[5] = (uint8_t)(remaining_elems >> 8);
  out[6] = (uint8_t)(ndims);
  out[7] = (uint8_t)(ndims >> 8);

  // ---- pass 1: per-slot payload sizes -> per-group output offsets
  const int64_t ng = (nslots + kGroupSzBlocks - 1) / kGroupSzBlocks;
  std::vector<int64_t> slot_size(nslots);
  for (int64_t s = 0; s < nslots; s++) {
    const int8_t kind = kinds[s];
    if (kind == kKindData) {
      int64_t wsum;
      if (wsums) {
        wsum = wsums[values[s]];
      } else {
        const int32_t* w = widths + (int64_t)values[s] * ndims;
        wsum = 0;
        for (int d = 0; d < ndims; d++) wsum += w[d];
      }
      slot_size[s] = lowdim ? wsum : (int64_t)kBlockSz * ((wsum + 7) / 8);
    } else if (kind == kKindRun) {
      slot_size[s] = values[s] > 0x7f ? 2 : 1;
    } else {  // kKindRun0 padding byte
      slot_size[s] = 1;
    }
  }
  std::vector<int64_t> group_off(ng + 1);
  int64_t pos = 8;
  for (int64_t g = 0; g < ng; g++) {
    group_off[g] = pos;
    pos += total_header_bytes;
    const int64_t s1 = std::min(nslots, (g + 1) * kGroupSzBlocks);
    for (int64_t s = g * kGroupSzBlocks; s < s1; s++) pos += slot_size[s];
  }
  group_off[ng] = pos;
  if (pos + tail_nbytes > out_cap) return -1;

  // ---- pass 2: emit groups into their disjoint ranges
  auto emit_groups = [&](int64_t g0, int64_t g1) {
    // Rows may be emitted with fixed-size 16-byte stores (compiled to
    // two 8-byte movs) when the whole block plus the overhang stays
    // inside THIS thread's disjoint [group_off[g0], group_off[g1])
    // range — the slack is overwritten by the next sequential write.
    const int64_t region_end = group_off[g1];
    for (int64_t g = g0; g < g1; g++) {
      // header region: streaming LSB-first bit writer (word-at-a-time
      // flush) — run slots contribute ndims zero fields
      uint8_t* hd = out + group_off[g];
      const int64_t s1 = std::min(nslots, (g + 1) * kGroupSzBlocks);
      {
        uint64_t acc = 0;
        int nbits = 0;
        int64_t hp = 0;
        for (int64_t s = g * kGroupSzBlocks; s < s1; s++) {
          if (kinds[s] == kKindData) {
            const uint8_t* hv = hdrvals + (int64_t)values[s] * ndims;
            for (int d = 0; d < ndims; d++) {
              acc |= (uint64_t)hv[d] << nbits;
              nbits += hdr_bits;
              if (nbits >= 32) {
                memcpy(hd + hp, &acc, 4);
                hp += 4;
                acc >>= 32;
                nbits -= 32;
              }
            }
          } else {  // run/run0: zero header fields just advance the bitpos
            int64_t z = (int64_t)ndims * hdr_bits;
            while (z > 0) {
              const int take = (int)std::min<int64_t>(z, 32 - nbits);
              nbits += take;
              z -= take;
              if (nbits >= 32) {
                memcpy(hd + hp, &acc, 4);
                hp += 4;
                acc >>= 32;
                nbits -= 32;
              }
            }
          }
        }
        while (nbits > 0) {  // partial-group headers are still full-width
          hd[hp++] = (uint8_t)acc;
          acc >>= 8;
          nbits -= 8;
        }
        if (hp < total_header_bytes)  // defensive: partial group
          memset(hd + hp, 0, total_header_bytes - hp);
      }
      int64_t p = group_off[g] + total_header_bytes;
      for (int64_t s = g * kGroupSzBlocks; s < s1; s++) {
        const int8_t kind = kinds[s];
        if (kind == kKindData) {
          const int64_t b = values[s];
          const int32_t* w = widths + b * ndims;
          if (lowdim) {
            const uint8_t* src = dense + b * ndims * maxb;
            for (int d = 0; d < ndims; d++) {
              memcpy(out + p, src + (int64_t)d * maxb, w[d]);
              p += w[d];
            }
          } else {
            const int64_t rb = slot_size[s] / kBlockSz;
            const uint8_t* src = dense + b * kBlockSz * maxb;
            // fixed-size reads of K bytes from a row start stay inside
            // dense iff K <= maxb (the next row begins there)
            if (rb <= 16 && maxb >= 16
                && p + kBlockSz * rb + 16 <= region_end) {
              for (int r = 0; r < kBlockSz; r++) {
                memcpy(out + p, src + (int64_t)r * maxb, 16);
                p += rb;
              }
            } else if (rb <= 48 && maxb >= 48
                       && p + kBlockSz * rb + 48 <= region_end) {
              for (int r = 0; r < kBlockSz; r++) {
                memcpy(out + p, src + (int64_t)r * maxb, 48);
                p += rb;
              }
            } else {
              for (int r = 0; r < kBlockSz; r++) {
                memcpy(out + p, src + (int64_t)r * maxb, rb);
                p += rb;
              }
            }
          }
        } else if (kind == kKindRun) {
          const int32_t run = values[s];
          if (run > 0x7f) {
            out[p++] = (uint8_t)((run & 0x7f) | 0x80);
            out[p++] = (uint8_t)(run >> 7);
          } else {
            out[p++] = (uint8_t)(run & 0x7f);
          }
        } else {  // kKindRun0 padding byte
          out[p++] = 0;
        }
      }
    }
  };

  int nthreads = (int)std::thread::hardware_concurrency();
  nthreads = std::max(1, std::min({nthreads, 16, (int)(ng / 64)}));
  if (nthreads <= 1 || pos < (1 << 19)) {
    emit_groups(0, ng);
  } else {
    std::vector<std::thread> threads;
    const int64_t per = (ng + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; t++) {
      const int64_t g0 = t * per;
      const int64_t g1 = std::min(ng, g0 + per);
      if (g0 >= g1) break;
      threads.emplace_back([&emit_groups, g0, g1] { emit_groups(g0, g1); });
    }
    for (auto& th : threads) th.join();
  }

  memcpy(out + pos, tail, tail_nbytes);
  return pos + tail_nbytes;
}
