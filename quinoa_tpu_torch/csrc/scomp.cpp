// Host code of the rngtest batteries' scomp_ family (the reference's
// TestU01 scomp_LempelZiv and scomp_LinearComp, src/RNGTest/Crush.cpp:747,
// 765): the LZ78 phrase count and the Berlekamp-Massey linear complexity
// profile of a bit stream.  Both are sequential over the stream, so they
// run on the host; rngtest/scomp.py builds this file with the host C++
// compiler and loads it through ctypes (a plain C interface).
//
// Bit streams are packed MSB-first in bytes (numpy.packbits' layout).

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// LZ78 phrase count: parse the stream into the incremental dictionary
// and return the number of phrases, counting a trailing incomplete
// phrase.  Trie children are a flat 2-ary array indexed by node id.
int64_t qsc_lz78_phrases(const uint8_t* bytes, int64_t nbits) {
  std::vector<int32_t> child;
  child.reserve(1 << 20);
  child.push_back(-1);  // root, bit 0
  child.push_back(-1);  // root, bit 1
  int64_t phrases = 0;
  int32_t cur = 0;
  bool in_phrase = false;
  for (int64_t i = 0; i < nbits; ++i) {
    const int bit = (bytes[i >> 3] >> (7 - (i & 7))) & 1;
    const int64_t slot = static_cast<int64_t>(cur) * 2 + bit;
    const int32_t nxt = child[slot];
    if (nxt >= 0) {
      cur = nxt;
      in_phrase = true;
    } else {
      // new phrase: add a node, restart at the root
      const int32_t id = static_cast<int32_t>(child.size() / 2);
      child[slot] = id;
      child.push_back(-1);
      child.push_back(-1);
      ++phrases;
      cur = 0;
      in_phrase = false;
    }
  }
  return phrases + (in_phrase ? 1 : 0);
}

// Berlekamp-Massey over GF(2) on 64-bit words: synthesize an LFSR of the
// stream, write the size of every jump of the linear
// complexity profile into jump_sizes (up to cap), and return the number
// of jumps (the final complexity in *final_L).  The discrepancy at step t
// is the parity of the connection polynomial C (bit i = c_i) ANDed with
// the reversed stream from bit nbits-1-t, a word at a time.
int64_t qsc_berlekamp_massey(const uint8_t* bytes, int64_t nbits,
                             int32_t* jump_sizes, int64_t cap,
                             int64_t* final_L) {
  const int64_t nw = (nbits + 64) / 64 + 2;
  std::vector<uint64_t> srev(nw, 0), C(nw, 0), B(nw, 0), T(nw, 0);
  for (int64_t i = 0; i < nbits; ++i) {
    const int bit = (bytes[i >> 3] >> (7 - (i & 7))) & 1;
    const int64_t j = nbits - 1 - i;  // reversed index
    if (bit) srev[j >> 6] |= (1ULL << (j & 63));
  }
  auto window64 = [&](int64_t p) -> uint64_t {
    const int64_t w = p >> 6, b = p & 63;
    uint64_t x = srev[w] >> b;
    if (b) x |= srev[w + 1] << (64 - b);
    return x;
  };
  C[0] = 1;
  B[0] = 1;
  int64_t L = 0, m = -1, njumps = 0;
  int64_t bwords = 1;  // words holding B's nonzero coefficients
  for (int64_t t = 0; t < nbits; ++t) {
    // d = parity(sum_{i=0..L} c_i s_{t-i}); C is zero above bit L
    const int64_t o = nbits - 1 - t;
    const int64_t wmax = (L >> 6) + 1;
    uint64_t acc = 0;
    for (int64_t w = 0; w < wmax; ++w) acc ^= C[w] & window64(o + 64 * w);
    if (!__builtin_parityll(acc)) continue;
    const int64_t shift = t - m;
    const int64_t ws = shift >> 6, bs = shift & 63;
    const bool jump = 2 * L <= t;
    if (jump) {
      // T <- old C (degree <= L), zero-padded over B's old extent
      const int64_t cw = (L >> 6) + 1;
      std::copy(C.begin(), C.begin() + cw, T.begin());
      if (bwords > cw) std::fill(T.begin() + cw, T.begin() + bwords, 0);
    }
    // C ^= B << shift (B's degree <= L, so at most bwords words).  As in
    // quinoa_tpu's qn_berlekamp_massey, the bits of B's top word that the
    // shift carries into the word above are not added: the port keeps
    // that package's profiles, and so its LinearComp p-values
    for (int64_t w = bwords - 1; w >= 0; --w) {
      uint64_t v = B[w] << bs;
      if (bs && w) v |= B[w - 1] >> (64 - bs);
      if (w + ws < nw) C[w + ws] ^= v;
    }
    if (jump) {
      const int64_t newL = t + 1 - L;
      if (njumps < cap) jump_sizes[njumps] = static_cast<int32_t>(newL - L);
      ++njumps;
      std::swap(B, T);
      bwords = (L >> 6) + 1;  // B's degree = old L
      m = t;
      L = newL;
    }
  }
  *final_L = L;
  return njumps;
}

}  // extern "C"
